"""Condensed-iteration formulation (counterpart of
tinympc_julia_tpu/ops/condensed.py), for one problem shared by the batch
or, with a leading group axis on the problem, the cache and the maps, for G
distinct problems with L lanes each.

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

Per-lane adaptive rho rides Taylor-expanded maps (``build_condensed_taylor``):
the reference's first-order cache update K(rho) = K0 + drho dK, P(rho) = P0 +
drho dP makes T1 a polynomial in drho = rho - rho0 (kept to ``order``) and T2
exactly bilinear in the pre- and post-update drho.  ``solve_condensed_adaptive``
applies them in eager PyTorch and is the oracle of kernel K2's plain version
(ops/cuda/adaptive_kernel.py).

The solve loops are written once for any leading axes: iterates are
``(..., dim, L)``, per-lane vectors ``(..., L)``, and per-problem data
(bounds, rho, cone coefficients, halfspace rows) ``(..., rows)``.  The
grouped solves (``solve_condensed_grouped``,
``solve_condensed_adaptive_grouped``) run them with one leading group axis
(batched matmuls) until every lane of every group has latched; a latched
lane is frozen, so a lane's result does not depend on the other groups.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..types import Cache, ConeSet, Problem, Settings
from ..utils.precision import full_fp32_matmul
from . import rho as rho_mod


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


# Beyond the full-condensation budget "auto" drops to the chunked horizon
# path (ops/scans.py: one reusable C-stage chunk map), sized here.
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
    problem's dtype and device.  ``problem``/``cache`` may carry a leading
    group axis (``types.stack_instances``); the maps then gain it too."""
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
    same data.  Leading group axes on both arguments are kept:
    (G, m, dim), (G, m) -> (G, m, 2*dim + 1)."""
    A = torch.as_tensor(Alin).to(torch.float64)
    b = torch.as_tensor(blin, device=A.device).to(torch.float64)
    if A.ndim < 2 or b.shape != A.shape[:-1]:
        raise ValueError(f"halfspaces need Alin (..., m, dim) and blin "
                         f"(..., m); got {tuple(A.shape)} and "
                         f"{tuple(b.shape)}")
    inv_sq = 1.0 / torch.clamp_min((A * A).sum(-1), 1e-30)
    rows = torch.cat([A, A * inv_sq[..., None], b[..., None]], dim=-1)
    return rows.to(torch.as_tensor(Alin).dtype)


def _halfspaces_stacked(w, rows, n_stages, dim):
    """Cyclic halfspace projections on a stacked (..., n_stages*dim, B)
    array: per stage k and row j in order, w_k -= max(a_j.w_k - b_j, 0)
    a_j/||a_j||^2 (ops/projections.py semantics).  ``rows`` is
    ``halfspace_rows``'s packing, shared (m, 2*dim + 1) or with ``w``'s
    leading axes; the inner product is summed in index order, as kernel K1
    sums it."""
    if rows.shape[-2] == 0:
        return w
    lead, B = w.shape[:-2], w.shape[-1]
    w3 = w.reshape(lead + (n_stages, dim, B))
    for j in range(rows.shape[-2]):
        row = rows[..., j, :]
        a = row[..., :dim, None, None]           # (..., dim, 1, 1)
        a_scaled = row[..., None, dim:2 * dim, None]
        b = row[..., 2 * dim, None, None]
        dot = w3[..., 0, :] * a[..., 0, :, :]
        for d in range(1, dim):
            dot = dot + w3[..., d, :] * a[..., d, :, :]
        viol = torch.clamp_min(dot - b, 0.0)
        w3 = w3 - viol[..., None, :] * a_scaled
    return w3.reshape(lead + (n_stages * dim, B))


def _sqrt_rn(x):
    """Square root rounded to nearest, as kernel K1's ``__fsqrt_rn``: the
    CPU's vectorised float32 sqrt is off by an ulp at times, so float32 goes
    through float64, whose second rounding lands on the nearest float."""
    if x.dtype == torch.float32:
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def _cones_stacked(w, cones: ConeSet, n_stages, dim):
    """Scaled-SOC projections (``projections._project_soc_scaled``) of every
    stage of a stacked (..., n_stages*dim, B) array, cone by cone; the
    coefficients ``cones.mus`` are shared (C,) or carry ``w``'s leading
    axes; the norm's squares are summed in index order, as kernel K1 sums
    them."""
    if cones.num_cones == 0:
        return w
    lead, B = w.shape[:-2], w.shape[-1]
    w3 = w.reshape(lead + (n_stages, dim, B)).clone()
    for k, (start, cdim) in enumerate(zip(cones.starts, cones.dims)):
        seg = w3[..., start:start + cdim, :]        # (..., n_stages, cdim, B)
        vpart = seg[..., :-1, :]
        s = seg[..., -1, :]
        mu = cones.mus[..., k, None, None]
        sq = vpart[..., 0, :] * vpart[..., 0, :]
        for d in range(1, cdim - 1):
            sq = sq + vpart[..., d, :] * vpart[..., d, :]
        a = _sqrt_rn(sq)
        u0 = s * mu
        factor = (a + u0) / (2.0 * torch.clamp_min(a, 1e-30))
        proj = torch.cat([factor[..., None, :] * vpart,
                          (factor * (a / mu))[..., None, :]], dim=-2)
        below = (a <= -u0)[..., None, :]
        inside = (a <= u0)[..., None, :]
        w3[..., start:start + cdim, :] = torch.where(
            below, torch.zeros_like(seg), torch.where(inside, seg, proj))
    return w3.reshape(lead + (n_stages * dim, B))


def _slack_update(problem: Problem, settings: Settings):
    """``slacks(u, x, z, v, y, g) -> (u_hat, x_hat, znew, vnew)`` on the
    stacked (..., dim, B) layout: over-relaxation against the previous
    slacks, then the dual shift and the projections box -> linear -> SOC.
    The leading axes are the problem's group axes."""
    s = settings
    nx, nu, N = problem.nx, problem.nu, problem.N
    su, sx = (N - 1) * nu, N * nx
    lead = problem.A.shape[:-2]
    umin, umax = (b.reshape(lead + (su, 1))
                  for b in (problem.u_min, problem.u_max))
    xmin, xmax = (b.reshape(lead + (sx, 1))
                  for b in (problem.x_min, problem.x_max))
    alpha = s.relaxation_alpha
    lin_u = halfspace_rows(problem.Alin_u, problem.blin_u) \
        if s.en_input_linear else None
    lin_x = halfspace_rows(problem.Alin_x, problem.blin_x) \
        if s.en_state_linear else None

    def slacks(u, x, z, v, y, g):
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
        return u_hat, x_hat, znew, vnew

    return slacks


class CondensedCarry(NamedTuple):
    """Warm-start carry of the condensed solver, stacked (dim, B) layout."""
    d: torch.Tensor  # (su, B)
    y: torch.Tensor  # (su, B)
    g: torch.Tensor  # (sx, B)
    v: torch.Tensor  # (sx, B)
    z: torch.Tensor  # (su, B)


def _zero_carry(lead, su, sx, L, dtype, dev):
    zu = torch.zeros(lead + (su, L), dtype=dtype, device=dev)
    zx = torch.zeros(lead + (sx, L), dtype=dtype, device=dev)
    return zu, zx


@full_fp32_matmul()
def _solve_condensed_impl(problem, cache, settings, x0s, maps, warm,
                          d_ref=None):
    """The fixed-rho condensed loop on x0s (..., L, nx), the leading axes
    being those of the problem, the cache and the maps.  ``d_ref``
    (``ref_backward_const``, (..., su)) is added to the backward product:
    maps built with zero references then solve for moving ones.  Returns
    (xs, us, iters, solved, carry)."""
    s = settings
    nx, nu, N = problem.nx, problem.nu, problem.N
    su, sx = (N - 1) * nu, N * nx
    lead, L = x0s.shape[:-2], x0s.shape[-2]
    dtype, dev = x0s.dtype, x0s.device
    rho = cache.rho.to(dtype)[..., None]
    pri_tol = torch.tensor(s.abs_pri_tol, dtype=dtype, device=dev)
    dua_tol = torch.tensor(s.abs_dua_tol, dtype=dtype, device=dev)
    ct = s.check_termination
    slacks = _slack_update(problem, s)

    T1, T2 = maps.T1, maps.T2
    # the duals enter T2 only through rho (y - znew) and rho (g - vnew), so
    # its y/g blocks are exact negations of the z/v blocks
    T2r = torch.cat([T2[..., :su + sx], T2[..., -1:]], dim=-1)
    x0T = x0s.transpose(-1, -2)
    ones = torch.ones(lead + (1, L), dtype=dtype, device=dev)

    if warm is None:
        zu, zx = _zero_carry(lead, su, sx, L, dtype, dev)
        warm = CondensedCarry(d=zu, y=zu, g=zx, v=zx, z=zu)
    d, y, g, v, z = warm
    out_x = torch.zeros(lead + (sx, L), dtype=dtype, device=dev)
    out_u = torch.zeros(lead + (su, L), dtype=dtype, device=dev)
    out_it = torch.full(lead + (L,), s.max_iter, dtype=torch.int32,
                        device=dev)
    out_solved = torch.zeros(lead + (L,), dtype=torch.int32, device=dev)
    conv = torch.zeros(lead + (L,), dtype=torch.bool, device=dev)

    def amax(t):
        return torch.amax(torch.abs(t), dim=-2)

    for i in range(s.max_iter):
        ux = T1 @ torch.cat([d, x0T, ones], dim=-2)
        u, x = ux[..., :su, :], ux[..., su:, :]
        u_hat, x_hat, znew, vnew = slacks(u, x, z, v, y, g)

        # lanes converged in an earlier iteration are frozen entirely
        frozen = conv[..., None, :]
        y = torch.where(frozen, y, y + u_hat - znew)
        g = torch.where(frozen, g, g + x_hat - vnew)

        ps, pi = amax(x - vnew), amax(u - znew)
        ds, di = amax(v - vnew) * rho, amax(z - znew) * rho
        ok = (ps < pri_tol) & (pi < pri_tol) & (ds < dua_tol) & (di < dua_tol)
        if ct <= 0 or (i + 1) % ct != 0:
            ok = torch.zeros_like(ok)
        newly = ok & ~conv

        out_x = torch.where(newly[..., None, :], vnew, out_x)
        out_u = torch.where(newly[..., None, :], znew, out_u)
        out_it = torch.where(newly, i + 1, out_it)
        out_solved = torch.where(newly, 1, out_solved)
        conv = conv | newly

        # v/z/d do not advance on (or after) a lane's converging iteration:
        # the reference returns before the slack copy and backward pass
        frozen = conv[..., None, :]
        v = torch.where(frozen, v, vnew)
        z = torch.where(frozen, z, znew)
        d_new = T2r @ torch.cat([znew - y, vnew - g, ones], dim=-2)
        if d_ref is not None:
            d_new = d_new + d_ref[..., None]
        d = torch.where(frozen, d, d_new)
        if bool(conv.all()):
            break

    # unconverged lanes report their last slack iterates
    out_x = torch.where(conv[..., None, :], out_x, v)
    out_u = torch.where(conv[..., None, :], out_u, z)
    xs = out_x.transpose(-1, -2).reshape(lead + (L, N, nx))
    us = out_u.transpose(-1, -2).reshape(lead + (L, N - 1, nu))
    return xs, us, out_it, out_solved, CondensedCarry(d=d, y=y, g=g, v=v, z=z)


@full_fp32_matmul()
def ref_backward_const(problem: Problem, cache: Cache, Xref=None, Uref=None):
    """The reference trajectories' contribution to the condensed backward
    map: d_ref (su,), the backward recursion of (qref, rref, pNref) alone.

    The references enter the condensed iteration only through this constant
    (they are linear in q, r and p_N), so references that move from step to
    step (the rocket's) need this small recursion and no rebuild of the
    maps: build the maps with zero references and add d_ref to the T2
    product (``_solve_condensed_impl``'s ``d_ref``)."""
    Xref = problem.Xref if Xref is None else Xref
    Uref = problem.Uref if Uref is None else Uref
    rref = -(Uref * problem.R)
    qref = -(Xref * problem.Q)
    p_next = -(cache.Pinf.T @ Xref[-1])
    BT, Quu, Am, KT = problem.B.T, cache.Quu_inv, cache.AmBKt, cache.Kinf.T
    ds = [None] * (problem.N - 1)
    for i in range(problem.N - 2, -1, -1):
        ds[i] = Quu @ (BT @ p_next + rref[i])
        p_next = qref[i] + Am @ p_next - KT @ rref[i]
    return torch.stack(ds).reshape(-1)


def _check_shared(problem, x0s, what):
    if problem.A.ndim != 2 or x0s.ndim != 2:
        raise ValueError(f"{what} takes one shared problem and x0s (B, nx); "
                         f"got A {tuple(problem.A.shape)}, x0s "
                         f"{tuple(x0s.shape)} (the grouped solves take a "
                         "leading group axis)")


def _check_grouped(problems, x0s, what):
    if problems.A.ndim != 3 or x0s.ndim != 3 \
            or x0s.shape[0] != problems.A.shape[0]:
        raise ValueError(f"{what} takes G-stacked problems and x0s (G, L, "
                         f"nx); got A {tuple(problems.A.shape)}, x0s "
                         f"{tuple(x0s.shape)}")


def solve_condensed(problem: Problem, cache: Cache, settings: Settings, x0s,
                    maps: CondensedMaps | None = None, *,
                    warm: CondensedCarry | None = None,
                    return_carry: bool = False):
    """Batched solve through the T1/T2 maps.  ``x0s`` is (B, nx).

    Returns (xs (B, N, nx), us (B, N-1, nu), iters (B,), solved (B,)), plus
    the carry when ``return_carry=True`` (pass it back as ``warm=``: the
    continuation equals one long solve lane for lane).  The solutions are
    the slack iterates, as in the reference.  Box, linear and cone
    constraints, composed box -> linear -> SOC; fixed rho
    (``solve_condensed_adaptive`` is the adaptive-rho solve)."""
    if settings.adaptive_rho:
        raise ValueError("solve_condensed is the fixed-rho solve; adaptive "
                         "rho runs through solve_condensed_adaptive")
    _check_shared(problem, x0s, "solve_condensed")
    if maps is None:
        maps = build_condensed(problem, cache)
    out = _solve_condensed_impl(problem, cache, settings, x0s, maps, warm)
    return out if return_carry else out[:4]


def solve_condensed_grouped(problems: Problem, caches: Cache,
                            settings: Settings, x0s,
                            maps: CondensedMaps | None = None, *,
                            warm: CondensedCarry | None = None,
                            return_carry: bool = False):
    """G distinct problems on the condensed path: ``problems``/``caches``
    carry a leading group axis (``types.stack_instances``) and ``x0s`` is
    (G, L, nx), L initial states per group.  Per-lane semantics are those of
    solving each group alone.

    Returns (xs (G, L, N, nx), us (G, L, N-1, nu), iters (G, L), solved
    (G, L)), plus the carry of (G, dim, L) arrays when
    ``return_carry=True``."""
    if settings.adaptive_rho:
        raise ValueError("solve_condensed_grouped is the fixed-rho solve; "
                         "adaptive rho runs through "
                         "solve_condensed_adaptive_grouped")
    _check_grouped(problems, x0s, "solve_condensed_grouped")
    if maps is None:
        maps = build_condensed(problems, caches)
    out = _solve_condensed_impl(problems, caches, settings, x0s, maps, warm)
    return out if return_carry else out[:4]


# ---------------------------------------------------------------------------
# Per-lane adaptive rho: Taylor-expanded maps and their solve
# ---------------------------------------------------------------------------

def _t1_taylor_numpy(A, B, f, K0, dK, N, order):
    """Taylor coefficients (in drho = rho - rho0) of T1 under the reference's
    linearised cache K(rho) = K0 + drho * dK.

    T1's entries are polynomials of degree <= N in drho (powers of the
    closed-loop matrix M(rho) = A - B K(rho)); the coefficients up to
    ``order`` are computed exactly, by carrying truncated coefficient lists
    through the power recursion (no finite differencing).  Returns
    (order+1, su+sx, in1), float64 numpy; leading batch axes on the
    arguments come out ahead of the order axis."""
    nx, nu = B.shape[-2], B.shape[-1]
    su, sx = (N - 1) * nu, N * nx
    in1 = su + nx + 1
    o = order
    bsh = B.shape[:-2]

    def pmul(Pa, Pb):
        """Truncated product of matrix-coefficient lists."""
        out = []
        for k in range(o + 1):
            acc = Pa[0] @ Pb[k]
            for i in range(1, k + 1):
                acc = acc + Pa[i] @ Pb[k - i]
            out.append(acc)
        return out

    zM = np.zeros(bsh + (nx, nx))
    Mc = [A - B @ K0, -(B @ dK)] + [zM] * (o - 1)
    Kc = [K0, dK] + [np.zeros_like(K0)] * (o - 1)
    fcol = f[..., :, None]

    # pw[i]: coefficient list of M(rho)^i; cs[i]: that of
    # sum_{j<i} M^(i-1-j) f (the affine term)
    pw = [[np.broadcast_to(np.eye(nx), bsh + (nx, nx))] + [zM] * o]
    cs = [[np.zeros(bsh + (nx, 1)) for _ in range(o + 1)]]
    for _ in range(N - 1):
        pw.append(pmul(Mc, pw[-1]))
        nc = pmul(Mc, cs[-1])
        nc[0] = nc[0] + fcol
        cs.append(nc)

    # per-stage x-row blocks as coefficient lists of (..., nx, in1)
    Xrows = []
    for i in range(N):
        row = []
        for k in range(o + 1):
            Rk = np.zeros(bsh + (nx, in1))
            for j in range(i):
                Rk[..., :, j * nu:(j + 1) * nu] = -(pw[i - 1 - j][k] @ B)
            Rk[..., :, su:su + nx] = pw[i][k]
            Rk[..., :, -1:] = cs[i][k]
            row.append(Rk)
        Xrows.append(row)

    T1s = []
    for k in range(o + 1):
        T1k = np.zeros(bsh + (su + sx, in1))
        for i in range(N - 1):
            Uk = -(Kc[0] @ Xrows[i][k])
            for a in range(1, k + 1):
                Uk = Uk - Kc[a] @ Xrows[i][k - a]
            if k == 0:
                Uk[..., :, i * nu:(i + 1) * nu] -= np.eye(nu)
            T1k[..., i * nu:(i + 1) * nu, :] = Uk
        for i in range(N):
            T1k[..., su + i * nx:su + (i + 1) * nx, :] = Xrows[i][k]
        T1s.append(T1k)
    return np.stack(T1s, axis=-3)


class CondensedTaylorMaps(NamedTuple):
    """Taylor-expanded condensed maps for per-lane adaptive rho.

    T1s: (order+1, su+sx, in1), the Taylor coefficients of T1 in drho.
    T2s: (4, su, in2).  T2 is exactly bilinear in (rho_rq, rho_K): the cost
         fold's rho and Pinf enter r/q/p_N affinely, with the rho from
         before a same-iteration update, while K enters the backward
         recursion linearly with the rho after it; Quu/AmBKt stay constant
         (the reference's dead-write quirk).  Stored as [T2_00, dT2/drho_rq,
         dT2/drho_K, cross], identified exactly from 4 corner evaluations.
    rho0: the expansion centre (the setup rho), 0-d.

    With a leading group axis (G-stacked problems): (G, order+1, ...),
    (G, 4, ...), (G,).
    """
    T1s: torch.Tensor
    T2s: torch.Tensor
    rho0: torch.Tensor


def build_condensed_taylor(problem: Problem, cache: Cache,
                           order: int = 2) -> CondensedTaylorMaps:
    """Build the Taylor-expanded maps in float64 on the host, then cast them
    to the problem's dtype and device.  Like ``build_condensed`` it keeps a
    leading group axis of ``problem``/``cache``."""
    if order < 1:
        raise ValueError("order must be >= 1")
    N = problem.N
    A, B, f = _np64(problem.A), _np64(problem.B), _np64(problem.f)
    K0, dK = _np64(cache.Kinf), _np64(cache.dKinf_drho)
    P0, dP = _np64(cache.Pinf), _np64(cache.dPinf_drho)
    Quu, Am, rho0 = (_np64(cache.Quu_inv), _np64(cache.AmBKt),
                     _np64(cache.rho))
    Qd, Rd = _np64(problem.Q), _np64(problem.R)
    Xref, Uref = _np64(problem.Xref), _np64(problem.Uref)

    T1s = _t1_taylor_numpy(A, B, f, K0, dK, N, order)

    def t2(drq, drk):
        return _t2_numpy(B, Qd, Rd, Xref, Uref, K0 + drk * dK, Quu, Am,
                         P0 + drq * dP, rho0 + drq, N)

    T00 = t2(0.0, 0.0)
    Ta = t2(1.0, 0.0) - T00
    Tb = t2(0.0, 1.0) - T00
    Tab = t2(1.0, 1.0) - T00 - Ta - Tb
    T2s = np.stack([T00, Ta, Tb, Tab], axis=-3)

    def cast(m):
        return torch.as_tensor(m, dtype=problem.dtype, device=problem.device)

    return CondensedTaylorMaps(T1s=cast(T1s), T2s=cast(T2s), rho0=cast(rho0))


def _osqp_residuals_stacked(x, u, z, v, y, g, problem: Problem, cache: Cache,
                            drho, N):
    """Per-lane OSQP-form residuals on the stacked (..., dim, B) layout: the
    values of ``rho.osqp_residuals`` for each lane, with the per-lane Taylor
    terminal cost Pinf + drho * dPinf.  The leading axes are the problem's
    group axes.  Returns four (..., B) vectors."""
    nx, nu = problem.nx, problem.nu
    lead, Bsz = x.shape[:-2], x.shape[-1]
    x3, v3, g3 = (t.reshape(lead + (N, nx, Bsz)) for t in (x, v, g))
    u3, z3, y3 = (t.reshape(lead + (N - 1, nu, Bsz)) for t in (u, z, y))
    A, Bm = problem.A, problem.B
    Qd, Rd = problem.Q[..., None, :, None], problem.R[..., None, :, None]
    head = (Ellipsis, slice(None, -1), slice(None), slice(None))
    tail = (Ellipsis, slice(1, None), slice(None), slice(None))

    def amax(t):
        return torch.amax(torch.abs(t), dim=(-3, -2))

    dyn = (torch.einsum("...ij,...njb->...nib", A, x3[head])
           + torch.einsum("...ij,...njb->...nib", Bm, u3) - x3[tail])
    ax_inf = torch.maximum(amax(u3), amax(dyn))
    z_inf = torch.maximum(amax(z3), amax(v3[tail]))
    pri_res = torch.maximum(amax(u3 - z3), amax(dyn - v3[tail]))
    pri_norm = torch.maximum(ax_inf, z_inf)

    xN = x3[..., -1, :, :]
    PxN = cache.Pinf @ xN + drho[..., None, :] * (cache.dPinf_drho @ xN)
    Px_states = torch.cat([x3[head] * Qd, PxN[..., None, :, :]], dim=-3)
    Px_inputs = u3 * Rd
    q_states = x3 * Qd
    q_inputs = u3 * Rd

    aty_states = torch.zeros_like(x3)
    aty_states[head] += torch.einsum("...ji,...njb->...nib", A, g3[tail])
    aty_states[tail] -= g3[tail]
    aty_inputs = torch.einsum("...ji,...njb->...nib", Bm, g3[tail]) + y3

    r_ds = Px_states + q_states + aty_states
    r_di = Px_inputs + q_inputs + aty_inputs
    dual_res = torch.maximum(amax(r_ds), amax(r_di))
    px_inf = torch.maximum(amax(Px_states), amax(Px_inputs))
    aty_inf = torch.maximum(amax(aty_states), amax(aty_inputs))
    q_inf = torch.maximum(amax(q_states), amax(q_inputs))
    dual_norm = torch.maximum(torch.maximum(px_inf, aty_inf), q_inf)
    return pri_res, dual_res, pri_norm, dual_norm


class AdaptiveCondensedCarry(NamedTuple):
    """Warm-start carry of the adaptive-rho condensed solve: the fixed-rho
    carry and the rho each lane ended on."""
    d: torch.Tensor    # (su, B)
    y: torch.Tensor    # (su, B)
    g: torch.Tensor    # (sx, B)
    v: torch.Tensor    # (sx, B)
    z: torch.Tensor    # (su, B)
    rho: torch.Tensor  # (B,)


@full_fp32_matmul()
def _solve_condensed_adaptive_impl(problem, cache, settings, x0s, maps, warm):
    """The adaptive-rho condensed loop on x0s (..., L, nx), the leading axes
    being those of the problem, the cache and the Taylor maps.  Returns (xs,
    us, iters, solved, carry)."""
    s = settings
    if s.adaptive_rho_controller not in ("osqp", "termination"):
        raise ValueError("adaptive_rho_controller must be 'osqp' or "
                         f"'termination', got {s.adaptive_rho_controller!r}")
    nx, nu, N = problem.nx, problem.nu, problem.N
    su, sx = (N - 1) * nu, N * nx
    lead, L = x0s.shape[:-2], x0s.shape[-2]
    dtype, dev = x0s.dtype, x0s.device
    order = maps.T1s.shape[-3] - 1
    T1stk = maps.T1s.reshape(lead + ((order + 1) * (su + sx), -1))
    # reduced backward blocks: the y/g columns are exact negations of the
    # z/v ones in every Taylor coefficient block
    T2stk = torch.cat([maps.T2s[..., :su + sx], maps.T2s[..., -1:]],
                      dim=-1).reshape(lead + (4 * su, -1))
    rho0 = maps.rho0.to(dtype)[..., None]
    pri_tol = torch.tensor(s.abs_pri_tol, dtype=dtype, device=dev)
    dua_tol = torch.tensor(s.abs_dua_tol, dtype=dtype, device=dev)
    ct = s.check_termination
    slacks = _slack_update(problem, s)
    x0T = x0s.transpose(-1, -2)
    ones = torch.ones(lead + (1, L), dtype=dtype, device=dev)

    if warm is None:
        zu, zx = _zero_carry(lead, su, sx, L, dtype, dev)
        warm = AdaptiveCondensedCarry(
            d=zu, y=zu, g=zx, v=zx, z=zu,
            rho=cache.rho.to(dtype)[..., None].expand(lead + (L,)).clone())
    d, y, g, v, z, rho_b = warm
    out_x = torch.zeros(lead + (sx, L), dtype=dtype, device=dev)
    out_u = torch.zeros(lead + (su, L), dtype=dtype, device=dev)
    out_it = torch.full(lead + (L,), s.max_iter, dtype=torch.int32,
                        device=dev)
    out_solved = torch.zeros(lead + (L,), dtype=torch.int32, device=dev)
    conv = torch.zeros(lead + (L,), dtype=torch.bool, device=dev)

    def amax(t):
        return torch.amax(torch.abs(t), dim=-2)

    for i in range(s.max_iter):
        drho = rho_b - rho0
        R1 = (T1stk @ torch.cat([d, x0T, ones], dim=-2)).reshape(
            lead + (order + 1, su + sx, L))
        ux = R1[..., order, :, :]
        for k in range(order - 1, -1, -1):  # Horner in drho
            ux = ux * drho[..., None, :] + R1[..., k, :, :]
        u, x = ux[..., :su, :], ux[..., su:, :]
        u_hat, x_hat, znew, vnew = slacks(u, x, z, v, y, g)

        frozen = conv[..., None, :]
        y = torch.where(frozen, y, y + u_hat - znew)
        g = torch.where(frozen, g, g + x_hat - vnew)

        # rho adaptation; converged lanes keep their rho
        rho_new = rho_b
        if i > 0 and i % rho_mod.RHO_INTERVAL == 0:
            if s.adaptive_rho_controller == "termination":
                # v/z are the previous slacks, as the single-instance
                # path's predict_rho_termination reads them
                pri = torch.maximum(amax(x - vnew), amax(u - znew))
                dua = rho_b * torch.maximum(amax(v - vnew), amax(z - znew))
                newr = rho_mod.termination_controller(pri, dua, rho_b, s,
                                                      rho_center=rho0)
            else:
                newr = rho_mod.predict_rho(
                    *_osqp_residuals_stacked(x, u, znew, vnew, y, g, problem,
                                             cache, drho, N), rho_b, s)
            rho_new = torch.where(conv, rho_b, newr)
        drho_new = rho_new - rho0

        # the cache is updated before the check: duals scale by the new rho
        ps, pi = amax(x - vnew), amax(u - znew)
        ds, di = amax(v - vnew) * rho_new, amax(z - znew) * rho_new
        ok = (ps < pri_tol) & (pi < pri_tol) & (ds < dua_tol) & (di < dua_tol)
        if ct <= 0 or (i + 1) % ct != 0:
            ok = torch.zeros_like(ok)
        newly = ok & ~conv

        out_x = torch.where(newly[..., None, :], vnew, out_x)
        out_u = torch.where(newly[..., None, :], znew, out_u)
        out_it = torch.where(newly, i + 1, out_it)
        out_solved = torch.where(newly, 1, out_solved)
        conv = conv | newly

        frozen = conv[..., None, :]
        v = torch.where(frozen, v, vnew)
        z = torch.where(frozen, z, znew)
        # backward map: r/q/p_N were folded with the pre-update rho (drho),
        # the gain K carries the post-update rho (drho_new)
        R2 = (T2stk @ torch.cat([znew - y, vnew - g, ones], dim=-2)).reshape(
            lead + (4, su, L))
        d_new = (R2[..., 0, :, :] + drho[..., None, :] * R2[..., 1, :, :]
                 + drho_new[..., None, :] * R2[..., 2, :, :]
                 + (drho * drho_new)[..., None, :] * R2[..., 3, :, :])
        d = torch.where(frozen, d, d_new)
        rho_b = rho_new
        if bool(conv.all()):
            break

    out_x = torch.where(conv[..., None, :], out_x, v)
    out_u = torch.where(conv[..., None, :], out_u, z)
    xs = out_x.transpose(-1, -2).reshape(lead + (L, N, nx))
    us = out_u.transpose(-1, -2).reshape(lead + (L, N - 1, nu))
    return xs, us, out_it, out_solved, AdaptiveCondensedCarry(
        d=d, y=y, g=g, v=v, z=z, rho=rho_b)


def solve_condensed_adaptive(problem: Problem, cache: Cache,
                             settings: Settings, x0s,
                             maps: CondensedTaylorMaps | None = None, *,
                             order: int = 2,
                             warm: AdaptiveCondensedCarry | None = None,
                             return_carry: bool = False):
    """Batched condensed solve with per-lane adaptive rho.

    The reference's Taylor cache updates become the Taylor-expanded maps,
    applied as shared stacked matmuls and combined with per-lane powers of
    drho: ux = sum_k drho^k (T1_k @ vec1) by Horner, and the exact bilinear
    d' = (T2_00 + drq T2_rq + drK T2_K + drq drK T2_x) @ vec2.  The rho
    prediction (every 5th iteration, never on the call's iteration 0: a
    warm continuation restarts the counter) is exact per lane.  T2 is exact;
    T1 is truncated at ``order``, the only approximation on this path.

    Returns (xs, us, iters, solved), plus the carry with the per-lane final
    rho when ``return_carry=True``."""
    _check_shared(problem, x0s, "solve_condensed_adaptive")
    if maps is None:
        maps = build_condensed_taylor(problem, cache, order=order)
    out = _solve_condensed_adaptive_impl(problem, cache, settings, x0s, maps,
                                         warm)
    return out if return_carry else out[:4]


def solve_condensed_adaptive_grouped(problems: Problem, caches: Cache,
                                     settings: Settings, x0s,
                                     maps: CondensedTaylorMaps | None = None,
                                     *, order: int = 2,
                                     warm: AdaptiveCondensedCarry | None = None,
                                     return_carry: bool = False):
    """G distinct problems with per-lane adaptive rho on the condensed path:
    the grouped form of ``solve_condensed_adaptive`` (layout as
    ``solve_condensed_grouped``; the carry's rho is (G, L))."""
    _check_grouped(problems, x0s, "solve_condensed_adaptive_grouped")
    if maps is None:
        maps = build_condensed_taylor(problems, caches, order=order)
    out = _solve_condensed_adaptive_impl(problems, caches, settings, x0s,
                                         maps, warm)
    return out if return_carry else out[:4]
