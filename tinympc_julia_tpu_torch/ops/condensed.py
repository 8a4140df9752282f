"""Condensed-iteration formulation, fixed-rho half (counterpart of
tinympc_julia_tpu/ops/condensed.py).

With the Riccati gains frozen, both ADMM sweeps over the horizon are affine
in the iterate, so they condense into two dense maps built once at setup:

    [u; x] = T1 @ [d; x0; 1]                 (forward rollout)
    d'     = T2 @ [znew; vnew; y'; g'; 1]    (backward recursion)

and the rest of an iteration (slack clip, dual ascent, residuals) is
elementwise.  ``build_condensed`` builds T1, T2 and the iteration-fused map
T12 in float64 on the host (numpy), then casts them to the problem's dtype
and device.  ``solve_condensed`` runs the T1/T2 two-matmul form in eager
PyTorch: it is the oracle that kernel K1's plain version
(ops/cuda/condensed_kernel.py) is held against.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..types import Cache, ConeSet, Problem, Settings


# method="auto" uses the condensed solve while its maps fit this memory
# budget (the JAX package's bound, kept so both packages dispatch alike;
# where the crossover lies on the GPU is not measured yet).
AUTO_CONDENSED_BUDGET_BYTES = 256 * 2**20


def condensed_footprint_bytes(nx, nu, N, *, itemsize=4,
                              adaptive=False) -> int:
    """Approximate memory of the condensed iteration maps."""
    su = (N - 1) * nu
    sw = su + N * nx
    t1 = sw * (su + nx + 1)
    t2 = su * (2 * sw + 1)
    t12 = sw * (sw + 1)
    if adaptive:  # Taylor stacks: (order+1)=3 T1 blocks, 4 T2 corners
        return (3 * t1 + 4 * t2 + 3 * t12) * itemsize
    return (t1 + t2 + t12) * itemsize


def auto_uses_condensed(nx, nu, N, *, adaptive=False) -> bool:
    """The method="auto" dispatch rule (api.solve_batch)."""
    return (condensed_footprint_bytes(nx, nu, N, adaptive=adaptive)
            <= AUTO_CONDENSED_BUDGET_BYTES)


# Beyond the full-condensation budget the JAX package drops to a chunked
# horizon path (one reusable C-stage chunk map); its budget helpers are kept
# here for the "auto" dispatch, the chunked solve itself is not ported yet.
CHUNK_BUDGET_BYTES = 32 * 2**20
CHUNK_TARGET = 128  # preferred chunk size


def chunk_footprint_bytes(nx, nu, C, *, itemsize=4) -> int:
    suc = C * nu
    t1c = (suc + (C + 1) * nx) * (suc + nx + 1)
    return (t1c + C * nx * nx + (C * nx) ** 2) * itemsize


def auto_chunk_size(nx, nu, N):
    """Pick the chunk size for the chunked horizon path: the divisor of
    N-1 nearest CHUNK_TARGET whose maps fit CHUNK_BUDGET_BYTES; None when
    no divisor >= 2 fits (then "auto" falls back to the sequential scan)."""
    best = None
    for C in range(2, N):
        if (N - 1) % C:
            continue
        if chunk_footprint_bytes(nx, nu, C) > CHUNK_BUDGET_BYTES:
            continue
        if best is None or abs(C - CHUNK_TARGET) < abs(best - CHUNK_TARGET):
            best = C
    return best


class CondensedMaps(NamedTuple):
    """Dense iteration maps (su = (N-1)*nu, sx = N*nx, sw = su + sx).

      T1:  (sw, su + nx + 1)           [d; x0; 1] -> [u; x]
      T2:  (su, su + sx + su + sx + 1) [znew; vnew; y'; g'; 1] -> d'
      T12: (sw, sw + 1)                [znew - y; vnew - g; 1] -> [u; x]
           minus the x0/const rollout: the iteration-fused map
           T1[:, :su] @ T2r, which kernel K1 applies once per iteration.
    """
    T1: torch.Tensor
    T2: torch.Tensor
    T12: torch.Tensor


def _t1_numpy(A, B, f, K, N):
    """T1 (float64 numpy) as a function of the LQR gain K.

    Rollout:  x_0 = x0;  x_{i+1} = M x_i + f - B d_i;  u_i = -K x_i - d_i
    with M = A - B K (forward_pass, admm.cpp:25-35).

    Accepts optional leading batch axes on every argument (numpy matmul
    broadcasting) — the grouped builders reuse this directly.
    """
    nx, nu = B.shape[-2], B.shape[-1]
    su, sx = (N - 1) * nu, N * nx
    bsh = B.shape[:-2]

    M = A - B @ K  # closed-loop matrix
    fcol = f[..., :, None]  # (..., nx, 1)

    # x_i = M^i x0 + sum_{j<i} M^(i-1-j) (f - B d_j)
    powers = [np.broadcast_to(np.eye(nx), bsh + (nx, nx))]
    for _ in range(N):
        powers.append(M @ powers[-1])

    # x rows: (sx, su) in d, (sx, nx) in x0, (sx, 1) const
    X_d = np.zeros(bsh + (sx, su))
    X_x0 = np.zeros(bsh + (sx, nx))
    X_c = np.zeros(bsh + (sx, 1))
    for i in range(N):
        X_x0[..., i * nx:(i + 1) * nx, :] = powers[i]
        for j in range(i):
            X_d[..., i * nx:(i + 1) * nx, j * nu:(j + 1) * nu] = \
                -(powers[i - 1 - j] @ B)
            X_c[..., i * nx:(i + 1) * nx, :] += powers[i - 1 - j] @ fcol
    # u rows: u_i = -K x_i - d_i (i = 0..N-2)
    U_d = np.zeros(bsh + (su, su))
    U_x0 = np.zeros(bsh + (su, nx))
    U_c = np.zeros(bsh + (su, 1))
    for i in range(N - 1):
        r0, r1 = i * nu, (i + 1) * nu
        U_d[..., r0:r1, :] = -(K @ X_d[..., i * nx:(i + 1) * nx, :])
        U_d[..., r0:r1, r0:r1] -= np.eye(nu)
        U_x0[..., r0:r1, :] = -(K @ X_x0[..., i * nx:(i + 1) * nx, :])
        U_c[..., r0:r1, :] = -(K @ X_c[..., i * nx:(i + 1) * nx, :])

    # input vector layout: [d (su); x0 (nx); 1] — the rollout depends only on
    # d, x0 and the constant term.
    in1 = su + nx + 1
    T1 = np.zeros(bsh + (su + sx, in1))
    T1[..., :su, :su] = U_d
    T1[..., :su, su:su + nx] = U_x0
    T1[..., :su, -1:] = U_c
    T1[..., su:, :su] = X_d
    T1[..., su:, su:su + nx] = X_x0
    T1[..., su:, -1:] = X_c
    return T1


def _t2_numpy(B, Qd, Rd, Xref, Uref, K, Quu, Am, Pinf, rho, N):
    """T2 (float64 numpy), parameterized by the quantities that move under
    adaptive-rho: the explicit rho folding + Pinf (update_linear_cost,
    admm.cpp:75-83) and the gain K (backward_pass_grad, admm.cpp:13-20).
    Quu/Am stay setup-time constants — the reference Taylor-updates C1/C2 but
    keeps using the stale Quu_inv/AmBKt (the dead-write quirk,
    rho_benchmark.cpp:199-212).

      r_i = rref_i - rho (znew_i - y'_i)
      q_i = qref_i - rho (vnew_i - g'_i)
      p_{N-1} = pNref - rho (vnew_{N-1} - g'_{N-1})
      p_i = Am p_{i+1} + (q_i - K^T r_i)
      d'_i = Quu (B^T p_{i+1} + r_i)

    Accepts optional leading batch axes (rho then has shape bsh) — the
    grouped builders reuse this directly.
    """
    nx, nu = B.shape[-2], B.shape[-1]
    su, sx = (N - 1) * nu, N * nx
    bsh = B.shape[:-2]
    rho_s = np.asarray(rho)[..., None, None]  # (..., 1, 1)
    BT = np.swapaxes(B, -1, -2)
    KT = np.swapaxes(K, -1, -2)
    PinfT = np.swapaxes(Pinf, -1, -2)

    rref = (-(Uref * Rd[..., None, :])).reshape(bsh + (su, 1))
    qref = (-(Xref * Qd[..., None, :])).reshape(bsh + (sx, 1))
    pNref = -(PinfT @ Xref[..., -1, :, None])  # (..., nx, 1)

    # Build p_i as affine in [znew; vnew; y'; g'; 1]
    in2 = su + sx + su + sx + 1
    iz, iv, iy, ig = 0, su, su + sx, su + sx + su

    def r_row(i):
        """r_i as (..., nu, in2) affine map."""
        R = np.zeros(bsh + (nu, in2))
        r0 = i * nu
        R[..., :, iz + r0:iz + r0 + nu] = -rho_s * np.eye(nu)
        R[..., :, iy + r0:iy + r0 + nu] = rho_s * np.eye(nu)
        R[..., :, -1:] = rref[..., r0:r0 + nu, :]
        return R

    def q_row(i):
        Q = np.zeros(bsh + (nx, in2))
        r0 = i * nx
        Q[..., :, iv + r0:iv + r0 + nx] = -rho_s * np.eye(nx)
        Q[..., :, ig + r0:ig + r0 + nx] = rho_s * np.eye(nx)
        Q[..., :, -1:] = qref[..., r0:r0 + nx, :]
        return Q

    pN = np.zeros(bsh + (nx, in2))
    r0 = (N - 1) * nx
    pN[..., :, iv + r0:iv + r0 + nx] = -rho_s * np.eye(nx)
    pN[..., :, ig + r0:ig + r0 + nx] = rho_s * np.eye(nx)
    pN[..., :, -1:] = pNref

    T2 = np.zeros(bsh + (su, in2))
    p_next = pN
    for i in range(N - 2, -1, -1):
        ri = r_row(i)
        d_i = Quu @ (BT @ p_next + ri)
        T2[..., i * nu:(i + 1) * nu, :] = d_i
        p_next = q_row(i) + Am @ p_next - KT @ ri
    return T2


def _np64(t) -> np.ndarray:
    return t.detach().to("cpu", torch.float64).numpy()


def build_condensed(problem: Problem, cache: Cache) -> CondensedMaps:
    """Build T1/T2/T12 in float64 on the host, then cast them to the
    problem's dtype and device."""
    N = problem.N
    A, B, f = _np64(problem.A), _np64(problem.B), _np64(problem.f)
    K, Quu = _np64(cache.Kinf), _np64(cache.Quu_inv)
    Am, Pinf, rho = _np64(cache.AmBKt), _np64(cache.Pinf), _np64(cache.rho)
    Qd, Rd = _np64(problem.Q), _np64(problem.R)
    Xref, Uref = _np64(problem.Xref), _np64(problem.Uref)

    T1 = _t1_numpy(A, B, f, K, N)
    T2 = _t2_numpy(B, Qd, Rd, Xref, Uref, K, Quu, Am, Pinf, rho, N)
    # iteration-fused map: the backward map substituted into the next
    # forward map, on the reduced-dual columns [znew - y; vnew - g; 1]
    su, sx = (N - 1) * problem.nu, N * problem.nx
    T2r = np.concatenate([T2[..., :, :su + sx], T2[..., :, -1:]], axis=-1)
    T12 = T1[..., :, :su] @ T2r

    def cast(m):
        return torch.as_tensor(m, dtype=problem.dtype, device=problem.device)

    return CondensedMaps(T1=cast(T1), T2=cast(T2), T12=cast(T12))


def halfspace_rows(Alin, blin) -> torch.Tensor:
    """The packed rows (m, 2*dim + 1) of per-stage halfspaces a.w <= b:
    ``[a, a / max(||a||^2, 1e-30), b]``, computed in float64 and cast to
    ``Alin``'s dtype.  Both the condensed solve and kernel K1 (and its plain
    version) project with these rows, so kernel and plain start from the
    same data."""
    A = torch.as_tensor(Alin).to(torch.float64)
    b = torch.as_tensor(blin, device=A.device).to(torch.float64)
    if A.ndim != 2 or b.shape != (A.shape[0],):
        raise ValueError(f"halfspaces need Alin (m, dim) and blin (m,); got "
                         f"{tuple(A.shape)} and {tuple(b.shape)}")
    inv_sq = 1.0 / torch.clamp_min((A * A).sum(-1), 1e-30)
    rows = torch.cat([A, A * inv_sq[:, None], b[:, None]], dim=1)
    return rows.to(torch.as_tensor(Alin).dtype)


def _halfspaces_stacked(w, rows, n_stages, dim):
    """Cyclic halfspace projections on a stacked (n_stages*dim, B) array:
    per stage k and row j in order, w_k -= max(a_j.w_k - b_j, 0) a_j/||a_j||^2
    (ops/projections.py semantics).  ``rows`` is ``halfspace_rows``'s
    packing; the inner product is summed in index order, as kernel K1 sums
    it."""
    if rows.shape[0] == 0:
        return w
    B = w.shape[1]
    w3 = w.reshape(n_stages, dim, B)
    for row in rows:
        a, a_scaled, b = row[:dim], row[dim:2 * dim], row[2 * dim]
        dot = w3[:, 0] * a[0]
        for d in range(1, dim):
            dot = dot + w3[:, d] * a[d]
        viol = torch.clamp_min(dot - b, 0.0)
        w3 = w3 - viol[:, None, :] * a_scaled[None, :, None]
    return w3.reshape(n_stages * dim, B)


def _sqrt_rn(x):
    """Square root rounded to nearest, as kernel K1's ``__fsqrt_rn``: the
    CPU's vectorised float32 sqrt is off by an ulp at times, so float32 goes
    through float64, whose second rounding lands on the nearest float."""
    if x.dtype == torch.float32:
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def _cones_stacked(w, cones: ConeSet, n_stages, dim):
    """Scaled-SOC projections (``projections._project_soc_scaled``) of every
    stage of a stacked (n_stages*dim, B) array, cone by cone; the norm's
    squares are summed in index order, as kernel K1 sums them."""
    if cones.num_cones == 0:
        return w
    B = w.shape[1]
    w3 = w.reshape(n_stages, dim, B).clone()
    for k, (start, cdim) in enumerate(zip(cones.starts, cones.dims)):
        seg = w3[:, start:start + cdim, :]          # (n_stages, cdim, B)
        vpart = seg[:, :-1, :]
        s = seg[:, -1, :]
        mu = cones.mus[k]
        sq = vpart[:, 0] * vpart[:, 0]
        for d in range(1, cdim - 1):
            sq = sq + vpart[:, d] * vpart[:, d]
        a = _sqrt_rn(sq)
        u0 = s * mu
        factor = (a + u0) / (2.0 * torch.clamp_min(a, 1e-30))
        proj = torch.cat([factor[:, None, :] * vpart,
                          (factor * (a / mu))[:, None, :]], dim=1)
        below = (a <= -u0)[:, None, :]
        inside = (a <= u0)[:, None, :]
        w3[:, start:start + cdim, :] = torch.where(
            below, torch.zeros_like(seg), torch.where(inside, seg, proj))
    return w3.reshape(n_stages * dim, B)


class CondensedCarry(NamedTuple):
    """Warm-start carry of the condensed solver, stacked (dim, B) layout."""
    d: torch.Tensor  # (su, B)
    y: torch.Tensor  # (su, B)
    g: torch.Tensor  # (sx, B)
    v: torch.Tensor  # (sx, B)
    z: torch.Tensor  # (su, B)


def solve_condensed(problem: Problem, cache: Cache, settings: Settings, x0s,
                    maps: CondensedMaps | None = None, *,
                    warm: CondensedCarry | None = None,
                    return_carry: bool = False):
    """Batched solve through the T1/T2 maps.  ``x0s`` is (B, nx).

    Returns (xs (B, N, nx), us (B, N-1, nu), iters (B,), solved (B,)), plus
    the carry when ``return_carry=True`` (pass it back as ``warm=``: the
    continuation equals one long solve lane for lane).  The solutions are
    the slack iterates, as in the reference.  Box, linear and cone
    constraints, composed box -> linear -> SOC; fixed rho only (adaptive rho
    is ROADMAP.md queue 1, item 10)."""
    s = settings
    if s.adaptive_rho:
        raise NotImplementedError(
            "adaptive rho on the condensed path is not ported yet "
            "(ROADMAP.md queue 1, item 10)")
    if maps is None:
        maps = build_condensed(problem, cache)
    nx, nu, N = problem.nx, problem.nu, problem.N
    su, sx = (N - 1) * nu, N * nx
    B = x0s.shape[0]
    dtype, dev = x0s.dtype, x0s.device
    rho = cache.rho.to(dtype)
    umin, umax = problem.u_min.reshape(su, 1), problem.u_max.reshape(su, 1)
    xmin, xmax = problem.x_min.reshape(sx, 1), problem.x_max.reshape(sx, 1)
    pri_tol = torch.tensor(s.abs_pri_tol, dtype=dtype, device=dev)
    dua_tol = torch.tensor(s.abs_dua_tol, dtype=dtype, device=dev)
    alpha = s.relaxation_alpha
    ct = s.check_termination
    lin_u = halfspace_rows(problem.Alin_u, problem.blin_u) \
        if s.en_input_linear else None
    lin_x = halfspace_rows(problem.Alin_x, problem.blin_x) \
        if s.en_state_linear else None

    T1, T2 = maps.T1, maps.T2
    # the duals enter T2 only through rho (y - znew) and rho (g - vnew), so
    # its y/g blocks are exact negations of the z/v blocks
    T2r = torch.cat([T2[:, :su + sx], T2[:, -1:]], dim=1)
    x0T = x0s.T
    ones = torch.ones((1, B), dtype=dtype, device=dev)

    if warm is None:
        zu = torch.zeros((su, B), dtype=dtype, device=dev)
        zx = torch.zeros((sx, B), dtype=dtype, device=dev)
        warm = CondensedCarry(d=zu, y=zu, g=zx, v=zx, z=zu)
    d, y, g, v, z = warm
    out_x = torch.zeros((sx, B), dtype=dtype, device=dev)
    out_u = torch.zeros((su, B), dtype=dtype, device=dev)
    out_it = torch.full((B,), s.max_iter, dtype=torch.int32, device=dev)
    out_solved = torch.zeros((B,), dtype=torch.int32, device=dev)
    conv = torch.zeros((B,), dtype=torch.bool, device=dev)

    for i in range(s.max_iter):
        ux = T1 @ torch.cat([d, x0T, ones], dim=0)
        u, x = ux[:su], ux[su:]
        if alpha != 1.0:
            u_hat = alpha * u + (1.0 - alpha) * z
            x_hat = alpha * x + (1.0 - alpha) * v
        else:
            u_hat, x_hat = u, x
        znew = u_hat + y
        if s.en_input_bound:
            znew = torch.clamp(znew, umin, umax)
        vnew = x_hat + g
        if s.en_state_bound:
            vnew = torch.clamp(vnew, xmin, xmax)
        if lin_u is not None:
            znew = _halfspaces_stacked(znew, lin_u, N - 1, nu)
        if lin_x is not None:
            vnew = _halfspaces_stacked(vnew, lin_x, N, nx)
        if s.en_input_soc:
            znew = _cones_stacked(znew, problem.cones_u, N - 1, nu)
        if s.en_state_soc:
            vnew = _cones_stacked(vnew, problem.cones_x, N, nx)

        # lanes converged in an earlier iteration are frozen entirely
        y = torch.where(conv, y, y + u_hat - znew)
        g = torch.where(conv, g, g + x_hat - vnew)

        ps = torch.amax(torch.abs(x - vnew), dim=0)
        pi = torch.amax(torch.abs(u - znew), dim=0)
        ds = torch.amax(torch.abs(v - vnew), dim=0) * rho
        di = torch.amax(torch.abs(z - znew), dim=0) * rho
        ok = (ps < pri_tol) & (pi < pri_tol) & (ds < dua_tol) & (di < dua_tol)
        if ct <= 0 or (i + 1) % ct != 0:
            ok = torch.zeros_like(ok)
        newly = ok & ~conv

        out_x = torch.where(newly, vnew, out_x)
        out_u = torch.where(newly, znew, out_u)
        out_it = torch.where(newly, i + 1, out_it)
        out_solved = torch.where(newly, 1, out_solved)
        conv = conv | newly

        # v/z/d do not advance on (or after) a lane's converging iteration:
        # the reference returns before the slack copy and backward pass
        v = torch.where(conv, v, vnew)
        z = torch.where(conv, z, znew)
        d_new = T2r @ torch.cat([znew - y, vnew - g, ones], dim=0)
        d = torch.where(conv, d, d_new)
        if bool(conv.all()):
            break

    # unconverged lanes report their last slack iterates
    out_x = torch.where(conv, out_x, v)
    out_u = torch.where(conv, out_u, z)
    xs = out_x.T.reshape(B, N, nx)
    us = out_u.T.reshape(B, N - 1, nu)
    out = (xs, us, out_it, out_solved)
    if return_carry:
        return out + (CondensedCarry(d=d, y=y, g=g, v=v, z=z),)
    return out
