"""Infinite-horizon Riccati cache and its exact rho sensitivities
(counterpart of tinympc_julia_tpu/ops/riccati.py).

Same semantics as the JAX package, including the reference's double rho
fold: ``precompute_cache`` takes the once-folded diagonals of
``Problem.Q``/``Problem.R`` and adds rho a second time inside.  The exact
d/drho sensitivities come from forward-mode AD (``torch.autograd.forward_ad``)
through the data-dependent fixed-point loop, as ``jax.jacfwd`` does through
its ``while_loop``: the tangent runs the same iterations as the primal.

``solve_lqr`` and the two ``compute_sensitivity_*`` functions are the Julia
helper's LQR and its d/drho, with a single rho fold (the JAX package's
API-parity functions of the same names).
"""
from __future__ import annotations

import torch
import torch.autograd.forward_ad as fwAD

from ..types import Cache
from ..utils.precision import full_fp32_matmul


def riccati_fixed_point(A, B, Q1_diag, R1_diag, rho, *, max_iter: int = 1000,
                        tol: float = 1e-5, K0=None, P0=None):
    """Iterate ``K = (R1 + B'PB)^-1 B'PA; P = Q1 + A'P(A - BK)`` from K=0,
    P = rho*I, and stop when ``max|K - K_prev| < tol``.  Returns the last
    computed (Kinf, Pinf); on the converged step the new iterate is not
    committed as the "previous" one, exactly the reference's loop."""
    nx, nu = A.shape[0], B.shape[1]
    R1 = torch.diag(R1_diag)
    Q1 = torch.diag(Q1_diag)
    K_prev = torch.zeros((nu, nx), dtype=A.dtype, device=A.device) \
        if K0 is None else K0
    P_prev = rho * torch.eye(nx, dtype=A.dtype, device=A.device) \
        if P0 is None else P0
    K, P = K_prev, P_prev
    for _ in range(max_iter):
        BtP = B.T @ P_prev
        K = torch.linalg.solve(R1 + BtP @ B, BtP @ A)
        P = Q1 + A.T @ P_prev @ (A - B @ K)
        if bool(torch.max(torch.abs(K - K_prev)) < tol):
            break
        K_prev, P_prev = K, P
    return K, P


def _cache_terms(A, B, Q_work_diag, R_work_diag, rho, *, max_iter=1000,
                 tol=1e-5):
    """(Kinf, Pinf, Quu_inv, AmBKt) from the once-folded work diagonals;
    adds the second rho fold internally."""
    Q1d = Q_work_diag + rho
    R1d = R_work_diag + rho
    Kinf, Pinf = riccati_fixed_point(A, B, Q1d, R1d, rho, max_iter=max_iter,
                                     tol=tol)
    Quu_inv = torch.linalg.inv(torch.diag(R1d) + B.T @ Pinf @ B)
    AmBKt = (A - B @ Kinf).T
    return tuple(row_major(t) for t in (Kinf, Pinf, Quu_inv, AmBKt))


def row_major(t):
    """``t`` with row-major strides, so that a consumer reads it as it lies
    (LAPACK returns Kinf and Quu_inv column-major, and AmBKt is a transposed
    view).  Unlike ``contiguous()`` this also restrides a (1, n) row, which
    a checkpoint or a numpy copy gives back row-strided: a matvec's BLAS
    path, and so its last bit, follows the strides."""
    return t.clone(memory_format=torch.contiguous_format)


@full_fp32_matmul()
def precompute_cache(A, B, Q_work_diag, R_work_diag, rho, *,
                     max_iter: int = 1000, tol: float = 1e-5,
                     compute_sensitivity: bool = True) -> Cache:
    """Build the Cache on the device and in the dtype of ``A``.

    The user cost is held fixed while differentiating (the folded
    diagonals are ``user + rho``), so the sensitivities are d/drho of both
    folds, as in the JAX package."""
    rho = torch.as_tensor(rho, dtype=A.dtype, device=A.device)
    Q_user = Q_work_diag - rho
    R_user = R_work_diag - rho

    def terms(r):
        return _cache_terms(A, B, Q_user + r, R_user + r, r,
                            max_iter=max_iter, tol=tol)

    Kinf, Pinf, Quu_inv, AmBKt = terms(rho)
    if compute_sensitivity:
        with fwAD.dual_level():
            dual = fwAD.make_dual(rho, torch.ones_like(rho))
            dK, dP, dC1, dC2 = (fwAD.unpack_dual(t).tangent
                                for t in terms(dual))
    else:
        dK, dP, dC1, dC2 = (torch.zeros_like(t)
                            for t in (Kinf, Pinf, Quu_inv, AmBKt))
    return Cache(rho=rho, Kinf=Kinf, Pinf=Pinf, Quu_inv=Quu_inv,
                 AmBKt=AmBKt, C1=Quu_inv, C2=AmBKt, dKinf_drho=dK,
                 dPinf_drho=dP, dC1_drho=dC1, dC2_drho=dC2)


@full_fp32_matmul()
def solve_lqr(A, B, Q, R, rho, *, max_iter: int = 5000, tol: float = 1e-10,
              reg: float = 1e-8):
    """The Julia helper's infinite-horizon LQR with a SINGLE rho fold
    (``Q + rho I``, ``R + rho I``), unlike the cache's double fold.  ``Q``
    and ``R`` may be matrices or diagonals; ``A`` gives the dtype and the
    device.  Iterates ``K = (R_rho + B'PB + reg I)^-1 B'PA`` and stops when
    the Frobenius norm of the step in K is below ``tol``, checked from the
    second iteration on.  Returns (K, P, C1, C2) with C1 = inv(R_rho +
    B'PB) (no ``reg``) and C2 = (A - BK)'."""
    A = torch.as_tensor(A)
    dt, dev = A.dtype, A.device
    B, Q, R = (torch.as_tensor(m, dtype=dt, device=dev) for m in (B, Q, R))
    if Q.ndim == 1:
        Q = torch.diag(Q)
    if R.ndim == 1:
        R = torch.diag(R)
    nx, nu = A.shape[0], B.shape[1]
    Q_rho = Q + rho * torch.eye(nx, dtype=dt, device=dev)
    R_rho = R + rho * torch.eye(nu, dtype=dt, device=dev)
    regI = reg * torch.eye(nu, dtype=dt, device=dev)
    K_prev = torch.zeros((nu, nx), dtype=dt, device=dev)
    P = Q_rho
    for i in range(max_iter):
        K = torch.linalg.solve(R_rho + B.T @ P @ B + regI, B.T @ P @ A)
        P = Q_rho + A.T @ P @ (A - B @ K)
        if i > 0 and bool(torch.linalg.norm(K - K_prev) < tol):
            break
        K_prev = K
    C1 = torch.linalg.inv(R_rho + B.T @ P @ B)
    C2 = (A - B @ K).T
    return K, P, C1, C2


@full_fp32_matmul()
def compute_sensitivity_autograd(A, B, Q, R, rho):
    """Exact d/drho of ``solve_lqr``'s (K, P, C1, C2) by forward-mode AD
    through its loop.  Returns (dK, dP, dC1, dC2)."""
    A = torch.as_tensor(A)
    rho = torch.as_tensor(rho, dtype=A.dtype, device=A.device)
    with fwAD.dual_level():
        dual = fwAD.make_dual(rho, torch.ones_like(rho))
        return tuple(fwAD.unpack_dual(t).tangent
                     for t in solve_lqr(A, B, Q, R, dual))


def compute_sensitivity_fd(A, B, Q, R, rho, h: float = 1e-6):
    """Forward differences of ``solve_lqr``, the Julia recipe:
    (f(rho + h) - f(rho)) / h.  Returns (dK, dP, dC1, dC2)."""
    t0 = solve_lqr(A, B, Q, R, rho)
    t1 = solve_lqr(A, B, Q, R, rho + h)
    return tuple((b - a) / h for a, b in zip(t0, t1))
