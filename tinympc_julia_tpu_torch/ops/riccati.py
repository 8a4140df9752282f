"""Infinite-horizon Riccati cache and its exact rho sensitivities
(counterpart of tinympc_julia_tpu/ops/riccati.py).

Same semantics as the JAX package, including the reference's double rho
fold: ``precompute_cache`` takes the once-folded diagonals of
``Problem.Q``/``Problem.R`` and adds rho a second time inside.  The exact
d/drho sensitivities come from forward-mode AD (``torch.autograd.forward_ad``)
through the data-dependent fixed-point loop, as ``jax.jacfwd`` does through
its ``while_loop``: the tangent runs the same iterations as the primal.
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
    # row-major, so that a consumer reads them as they lie (LAPACK returns
    # Kinf and Quu_inv column-major, and AmBKt is a transposed view)
    return tuple(t.contiguous() for t in (Kinf, Pinf, Quu_inv, AmBKt))


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
