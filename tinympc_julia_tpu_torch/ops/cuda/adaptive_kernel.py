"""Kernel K2: the condensed ADMM solve with per-lane adaptive rho, fused
(counterpart of tinympc_julia_tpu/ops/pallas/adaptive_kernel.py).

``make_condensed_adaptive_fused_solver`` returns ``solve_fn(tmaps, u_min,
u_max, x_min, x_max, x0s[, warm]) -> (x, u, iters, solved, rho[, carry])``.
On CUDA tensors it launches the hand-written kernel
``csrc/condensed_adaptive.cu`` (``condensed_adaptive_cuda``) or raises; on
CPU tensors it runs the kernel's plain PyTorch version
(``condensed_adaptive_reference``).  There is no fallback from one to the
other.

Per-lane semantics are those of the Pallas kernel and of
``ops.condensed.solve_condensed_adaptive``:

* forward map: the T1 Taylor blocks applied to ``[d; x0; 1]`` and combined
  by Horner in ``drho = rho_lane - rho0``;
* backward map: the 4 exactly-bilinear T2 blocks applied to ``[znew - y;
  vnew - g; 1]``, the cost fold at the drho from before this iteration's
  rho update and the gain at the drho after it;
* rho prediction on every 5th iteration of the call (never its iteration 0,
  so a warm continuation's first iteration never updates rho, and a 30 + 50
  chain is not an 80-iteration solve): the reference's OSQP-form controller
  or the termination-residual controller with its deadband, step cap and
  Taylor trust clip; a converged lane keeps its rho;
* residual checks on the last iteration of each ``check_termination`` group,
  the dual residuals scaled by the post-update rho; converged lanes latch
  and freeze; the output latches the converging slacks while the carry's
  v/z and d freeze one iterate earlier;
* projections box -> per-stage halfspaces (cyclic) -> per-stage scaled SOCs,
  shared with kernel K1;
* group grid (``num_groups=G``): G distinct problems of L lanes each in one
  launch, the Taylor maps, rho0, the bounds, the plant data of the OSQP-form
  controller and the constraint data carrying a leading group axis (or
  staying shared), lanes in the flat order ``g*L + l``; rho stays per lane.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from .. import not_ported
from ..condensed import (CondensedTaylorMaps, _cones_stacked,
                         _halfspaces_stacked, _osqp_residuals_stacked,
                         _sqrt_rn)
from ..rho import EPS, RHO_INTERVAL, TERM_DEADBAND, TERM_MAX_STEP
from ...utils.precision import full_fp32_matmul
from ._build import load_library
from .condensed_kernel import (MAX_STAGE, MAX_TILE, SMEM_PER_BLOCK,
                               FusedConstraints, _check_constraints,
                               _check_cuda_inputs, _check_grouped_shape,
                               _dims, _flat_x0, _grouped_view,
                               _no_constraints, _ptr, _side_args,
                               _state_free, _FLT, _INT, _PTR, _SIDE,
                               fused_constraints)

MAX_ORDER = 3  # the kernel is built for T1 Taylor orders 1 to 3
# output rows a thread accumulates at once (csrc/condensed_adaptive.cu
# kRowBlock); the transposed maps' rows are padded to a multiple of it
K2_ROW_BLOCK = 32


def _padded(rows: int) -> int:
    return -(-rows // K2_ROW_BLOCK) * K2_ROW_BLOCK


class AdaptiveFusedCarry(NamedTuple):
    """Warm-start carry of the adaptive fused solve, stacked (dim, B)
    layout: the condensed solve's ``AdaptiveCondensedCarry`` with the
    per-lane rho as a (1, B) row."""
    d: torch.Tensor    # (su, B)
    y: torch.Tensor    # (su, B)
    g: torch.Tensor    # (sx, B), zeros without a state-side constraint
    v: torch.Tensor    # (sx, B)
    z: torch.Tensor    # (su, B)
    rho: torch.Tensor  # (1, B)


class AdaptivePlant(NamedTuple):
    """What the OSQP-form rho controller reads of the problem and its cache,
    on the solve's device and in its dtype (field names as in ``Problem``
    and ``Cache``, so ``condensed._osqp_residuals_stacked`` takes it for
    both).  Every field may carry a leading group axis."""
    A: torch.Tensor           # (nx, nx)
    B: torch.Tensor           # (nx, nu)
    Q: torch.Tensor           # (nx,) rho-folded cost diagonals
    R: torch.Tensor           # (nu,)
    Pinf: torch.Tensor        # (nx, nx)
    dPinf_drho: torch.Tensor  # (nx, nx)

    @property
    def nx(self) -> int:
        return self.B.shape[-2]

    @property
    def nu(self) -> int:
        return self.B.shape[-1]


def _lane_floats(nx, nu, N) -> int:
    """Shared-memory floats of one lane: vec1 = [d; x0; 1] and the iterate
    with the constant 1 behind it."""
    su, _, sw = _dims(nx, nu, N)
    return (su + nx + 1) + (sw + 1)


def _map_floats(nx, nu, N, order) -> int:
    """Floats of both transposed, row-padded Taylor maps."""
    su, _, sw = _dims(nx, nu, N)
    return ((su + nx + 1) * (order + 1) * _padded(sw)
            + (sw + 1) * 4 * _padded(su))


def adaptive_tile_plan(nx: int, nu: int, N: int, order: int, batch: int,
                       n_sm: int) -> tuple[int, bool]:
    """(lanes per block, whether the Taylor maps are staged in shared
    memory).

    The maps join the lanes' vectors in shared memory where a warp's worth
    of lanes still fits beside them, and are read from global memory (L2)
    otherwise.  A batch too small to give every one of the ``n_sm``
    multiprocessors a full block gets smaller blocks, down to one warp."""
    lane = 4 * _lane_floats(nx, nu, N)
    maps = 4 * _map_floats(nx, nu, N, order)
    resident = maps + 32 * lane <= SMEM_PER_BLOCK
    avail = SMEM_PER_BLOCK - (maps if resident else 0)
    tile = min(MAX_TILE, avail // lane // 32 * 32)
    if tile < 32:
        raise ValueError(f"adaptive fused kernel: a problem of width "
                         f"{_dims(nx, nu, N)[2]} leaves no room for a warp "
                         "of lanes in shared memory")
    while tile > 32 and -(-batch // tile) < n_sm:
        tile //= 2
    return tile, resident


_PLANT_SHAPES = lambda nx, nu: ((nx, nx), (nx, nu), (nx,), (nu,), (nx, nx),
                                (nx, nx))


def _validate(tmaps, bounds, x0s, warm, plant, nx, nu, N, warm_start, cons,
              controller, G):
    """Shape and device checks shared by kernel and plain version; returns
    (flat x0s, lanes per group, every tensor the solve reads)."""
    su, sx, sw = _dims(nx, nu, N)
    if G < 1:
        raise ValueError(f"num_groups must be >= 1 (got {G})")
    x0, L = _flat_x0(x0s, G, nx)
    B = G * L
    if controller not in ("osqp", "termination"):
        raise ValueError("controller must be 'osqp' or 'termination', got "
                         f"{controller!r}")
    grouped = tmaps.T1s.ndim == 4
    if tmaps.T1s.ndim not in (3, 4) \
            or tuple(tmaps.T1s.shape[-2:]) != (sw, su + nx + 1) \
            or (grouped and tmaps.T1s.shape[0] != G):
        raise ValueError(f"T1s must be (order+1, {sw}, {su + nx + 1}), or "
                         f"that behind a leading group axis of {G}; got "
                         f"{tuple(tmaps.T1s.shape)}")
    if tmaps.T1s.shape[-3] < 2:
        raise ValueError("T1s needs at least the order-1 Taylor block")
    lead = (G,) if grouped else ()
    if tuple(tmaps.T2s.shape) != lead + (4, su, 2 * sw + 1):
        raise ValueError(f"T2s must be {lead + (4, su, 2 * sw + 1)}; got "
                         f"{tuple(tmaps.T2s.shape)}")
    if tuple(tmaps.rho0.shape) != lead:
        raise ValueError(f"rho0 must be {lead}; got "
                         f"{tuple(tmaps.rho0.shape)}")
    for b, n in zip(bounds, (su, su, sx, sx)):
        if b.numel() not in (n, G * n):
            raise ValueError(f"a bound has {b.numel()} entries, expected {n} "
                             f"or {G} x {n}")
    if warm_start and warm is None:
        raise ValueError("warm_start solver needs the warm carry")
    if not warm_start and warm is not None:
        raise ValueError("pass warm only to a warm_start=True solver")
    tensors = [tmaps.T1s, tmaps.T2s, tmaps.rho0, *bounds, x0]
    if controller == "osqp":
        if plant is None:
            raise ValueError("the OSQP-form controller needs the plant data")
        flags = [_check_grouped_shape(t, shape, G, "a plant array")
                 for t, shape in zip(plant, _PLANT_SHAPES(nx, nu))]
        if len(set(flags)) != 1:
            raise ValueError("the plant arrays must all be shared or all "
                             "carry the group axis")
        tensors += list(plant)
    tensors += _check_constraints(cons, G, nx, nu)
    if warm is not None:
        for w, n in zip(warm, (su, su, sx, sx, su, 1)):
            if tuple(w.shape) != (n, B):
                raise ValueError(f"warm carry array {tuple(w.shape)}, "
                                 f"expected ({n}, {B})")
        tensors += list(warm)
    for t in tensors:
        if t.device != x0s.device:
            raise ValueError(f"all inputs must be on {x0s.device}; got one "
                             f"on {t.device}")
    return x0, L, tensors


@full_fp32_matmul()
def condensed_adaptive_reference(tmaps: CondensedTaylorMaps, u_min, u_max,
                                 x_min, x_max, x0s, warm=None, *,
                                 plant: AdaptivePlant | None, nx, nu, N,
                                 max_iter, abs_pri_tol, abs_dua_tol,
                                 en_state_bound, en_input_bound,
                                 relaxation_alpha, adaptive_rho_min,
                                 adaptive_rho_max, adaptive_rho_clipping,
                                 check_termination, controller, taylor_trust,
                                 warm_start, carry_out,
                                 constraints: FusedConstraints | None = None,
                                 num_groups: int = 1):
    """Plain PyTorch version of kernel K2: the same computation in the same
    order, on the whole batch at once (a lane's result does not depend on
    which lanes share its tile).  Any float dtype and device; ``plant``
    (needed by the OSQP-form controller only) and ``constraints`` in the
    same dtype.  Returns (x (B, N, nx), u (B, N-1, nu), iters (B,), solved
    (B,), rho (B,)[, AdaptiveFusedCarry]).

    With ``num_groups=G`` the Taylor maps (and their rho0), the bounds, the
    plant and the constraint data may carry a leading group axis, ``x0s``
    is (G, L, nx) or flat, and the iterates run as (G, dim, L) with batched
    matmuls; results and carries keep the flat lane order g*L + l."""
    cons = constraints or _no_constraints(x0s)
    G = num_groups
    x0, L, _ = _validate(tmaps, (u_min, u_max, x_min, x_max), x0s, warm,
                         plant, nx, nu, N, warm_start, cons, controller, G)
    su, sx, sw = _dims(nx, nu, N)
    ct = check_termination
    dt, dev = x0s.dtype, x0s.device
    B = G * L
    osqp = controller == "osqp"
    # one shared problem runs on (dim, B) arrays; anything grouped on
    # (G, dim, L) arrays with the shared data broadcasting
    flat = (G == 1 and tmaps.T1s.ndim == 3
            and all(r is None or r.ndim == 2
                    for r in (cons.lin_u, cons.lin_x))
            and cons.cones_u.mus.ndim == 1 and cons.cones_x.mus.ndim == 1
            and (not osqp or plant.A.ndim == 2))
    lead = () if flat else (G,)
    if not flat:
        x0 = x0.reshape(G, L, nx)
        if warm is not None:
            warm = AdaptiveFusedCarry(
                *(w.reshape(-1, G, L).permute(1, 0, 2) for w in warm))
    ord1 = tmaps.T1s.shape[-3]
    T1stk = tmaps.T1s.reshape(tmaps.T1s.shape[:-3] + (ord1 * sw, su + nx + 1))
    T2stk = torch.cat([tmaps.T2s[..., :sw], tmaps.T2s[..., -1:]], dim=-1)
    T2stk = T2stk.reshape(T2stk.shape[:-3] + (4 * su, sw + 1))
    rho0 = tmaps.rho0.to(dt)
    if rho0.ndim:
        rho0 = rho0[:, None]  # against the per-lane (G, L) vectors
    Gb = 1 if flat else G
    umin, umax = _grouped_view(u_min, Gb, su), _grouped_view(u_max, Gb, su)
    xmin, xmax = _grouped_view(x_min, Gb, sx), _grouped_view(x_max, Gb, sx)
    pri_tol = torch.tensor(abs_pri_tol, dtype=dt, device=dev)
    dua_tol = torch.tensor(abs_dua_tol, dtype=dt, device=dev)
    alpha = relaxation_alpha
    state_free = _state_free(en_state_bound, cons)
    x0T = x0.transpose(-1, -2)
    ones = torch.ones(lead + (1, L), dtype=dt, device=dev)

    def project(w, rows, cones, n_stages, dim):
        if rows is not None:
            w = _halfspaces_stacked(w, rows, n_stages, dim)
        return _cones_stacked(w, cones, n_stages, dim)

    def zeros(rows):
        return torch.zeros(lead + (rows, L), dtype=dt, device=dev)

    def amax(t):
        return torch.amax(torch.abs(t), dim=-2)

    if warm_start:
        d, y, g, v, z = (w.clone() for w in warm[:5])
        rho_b = warm.rho.reshape(lead + (L,)).clone()
    else:
        d, y, z, g, v = zeros(su), zeros(su), zeros(su), zeros(sx), zeros(sx)
        rho_b = rho0.expand(lead + (L,)).clone()
    if state_free:
        g = zeros(sx)
    vco, zco = v.clone(), z.clone()
    conv = torch.zeros(lead + (L,), dtype=torch.bool, device=dev)
    iters = torch.full(lead + (L,), max_iter, dtype=torch.int32, device=dev)
    solved = torch.zeros(lead + (L,), dtype=torch.int32, device=dev)

    for i in range(max_iter):
        check = (i + 1) % ct == 0
        drho = rho_b - rho0
        R1 = (T1stk @ torch.cat([d, x0T, ones], dim=-2)).reshape(
            lead + (ord1, sw, L))
        ux = R1[..., ord1 - 1, :, :]
        for k in range(ord1 - 2, -1, -1):  # Horner in drho
            ux = ux * drho[..., None, :] + R1[..., k, :, :]
        u, x = ux[..., :su, :], ux[..., su:, :]
        if alpha != 1.0:
            u_hat = alpha * u + (1.0 - alpha) * z
            x_hat = alpha * x + (1.0 - alpha) * v
        else:
            u_hat, x_hat = u, x
        znew = u_hat + y
        if en_input_bound:
            znew = torch.minimum(umax, torch.maximum(umin, znew))
        znew = project(znew, cons.lin_u, cons.cones_u, N - 1, nu)
        if state_free:
            vnew = x_hat  # no state projection and g == 0
        else:
            vnew = x_hat + g
            if en_state_bound:
                vnew = torch.minimum(xmax, torch.maximum(xmin, vnew))
            vnew = project(vnew, cons.lin_x, cons.cones_x, N, nx)
        prev = conv
        pm = prev[..., None, :]
        y = torch.where(pm, y, y + u_hat - znew)
        if not state_free:
            g = torch.where(pm, g, g + x_hat - vnew)

        ps, pi = amax(x - vnew), amax(u - znew)
        ds, di = amax(v - vnew), amax(z - znew)  # before their rho scaling

        rho_new = rho_b
        if i > 0 and i % RHO_INTERVAL == 0:
            if osqp:
                pri_r, dua_r, pri_n, dua_n = _osqp_residuals_stacked(
                    x, u, znew, vnew, y, g, plant, plant, drho, N)
                pred = rho_b * _sqrt_rn((pri_r / (pri_n + EPS))
                                        / (dua_r / (dua_n + EPS) + EPS))
            else:
                # v/z are the previous slacks, read before their commit
                ratio = ((torch.maximum(ps, pi) / pri_tol)
                         / (rho_b * torch.maximum(ds, di) / dua_tol + EPS))
                factor = torch.clamp(_sqrt_rn(ratio), 1.0 / TERM_MAX_STEP,
                                     TERM_MAX_STEP)
                move = ((factor > TERM_DEADBAND)
                        | (factor < 1.0 / TERM_DEADBAND))
                pred = torch.where(move, rho_b * factor, rho_b)
            if adaptive_rho_clipping:
                pred = torch.clamp(pred, adaptive_rho_min, adaptive_rho_max)
            if not osqp and math.isfinite(taylor_trust):
                pred = torch.minimum(rho0 + taylor_trust, torch.maximum(
                    rho0 - taylor_trust, pred))
            rho_new = torch.where(prev, rho_b, pred)  # converged lanes keep
        drho_new = rho_new - rho0

        conv_all = prev
        if check:  # the duals scale by the post-update rho
            ok = ((ps < pri_tol) & (pi < pri_tol) & (ds * rho_new < dua_tol)
                  & (di * rho_new < dua_tol))
            newly = ok & ~prev
            iters = torch.where(newly, i + 1, iters)
            solved = torch.where(newly, 1, solved)
            conv_all = prev | newly
        # outputs take vnew/znew on the converging iteration, then freeze;
        # the carry's v/z and d freeze before it
        v, z = torch.where(pm, v, vnew), torch.where(pm, z, znew)
        cm = conv_all[..., None, :]
        if carry_out:
            vco = torch.where(cm, vco, vnew)
            zco = torch.where(cm, zco, znew)
        vec2 = torch.cat([znew - y, vnew if state_free else vnew - g, ones],
                         dim=-2)
        R2 = (T2stk @ vec2).reshape(lead + (4, su, L))
        d_new = (R2[..., 0, :, :] + drho[..., None, :] * R2[..., 1, :, :]
                 + drho_new[..., None, :] * R2[..., 2, :, :]
                 + (drho * drho_new)[..., None, :] * R2[..., 3, :, :])
        d = torch.where(cm, d, d_new)
        rho_b = rho_new
        conv = conv_all
        if check and bool(conv.all()):
            break

    def lanes(t):
        """(G, dim, L) -> (dim, G*L), the flat lane order."""
        return t if flat else t.permute(1, 0, 2).reshape(-1, B)

    rho_out = rho_b.reshape(B)
    out = (v.transpose(-1, -2).reshape(B, N, nx),
           z.transpose(-1, -2).reshape(B, N - 1, nu), iters.reshape(B),
           solved.reshape(B), rho_out)
    if carry_out:
        return out + (AdaptiveFusedCarry(
            *(lanes(t) for t in (d, y, g, vco, zco)),
            rho_out.reshape(1, B)),)
    return out


_ARGTYPES = ([_PTR] * 32 + [_INT] * 8 + [_FLT] * 9 + [_INT] * 16
             + _SIDE + _SIDE + [_PTR])


@functools.cache
def _kernel_fn():
    fn = load_library("condensed_adaptive").lib.tinympc_condensed_adaptive
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def map_layout(tmaps: CondensedTaylorMaps, su, sw):
    """Kernel-side layouts of the Taylor maps, made at every launch:
    transposed, rows padded to a multiple of K2_ROW_BLOCK, the blocks of one
    input column side by side; a leading group axis is kept."""
    swp, sup = _padded(sw), _padded(su)
    T1s, T2s = tmaps.T1s, tmaps.T2s
    lead = T1s.shape[:-3]
    f32 = dict(dtype=torch.float32, device=T1s.device)
    t1t = torch.zeros(lead + (T1s.shape[-1], T1s.shape[-3], swp), **f32)
    t1t[..., :sw] = T1s.movedim(-1, -3)
    t2r = torch.cat([T2s[..., :sw], T2s[..., -1:]], dim=-1)
    t2t = torch.zeros(lead + (sw + 1, 4, sup), **f32)
    t2t[..., :su] = t2r.movedim(-1, -3)
    return t1t, t2t


def condensed_adaptive_cuda(tmaps: CondensedTaylorMaps, u_min, u_max, x_min,
                            x_max, x0s, warm=None, *,
                            plant: AdaptivePlant | None, nx, nu, N, max_iter,
                            abs_pri_tol, abs_dua_tol, en_state_bound,
                            en_input_bound, relaxation_alpha,
                            adaptive_rho_min, adaptive_rho_max,
                            adaptive_rho_clipping, check_termination,
                            controller, taylor_trust, warm_start, carry_out,
                            constraints: FusedConstraints | None = None,
                            num_groups: int = 1):
    """Launch kernel K2 (csrc/condensed_adaptive.cu) on CUDA tensors; the
    arguments and results are those of ``condensed_adaptive_reference``.
    Raises on CPU tensors, on any dtype but float32, on non-contiguous
    inputs, on a Taylor order above MAX_ORDER, on stages wider than
    MAX_STAGE where the kernel holds one per thread (a projected side; both
    sides under the OSQP-form controller), and when the build or the launch
    fails.  Counts every launch in ``.launches`` and those over more than
    one group in ``.grouped_launches``."""
    cons = constraints or _no_constraints(x0s)
    G = num_groups
    x0, L, tensors = _validate(tmaps, (u_min, u_max, x_min, x_max), x0s, warm,
                               plant, nx, nu, N, warm_start, cons, controller,
                               G)
    _check_cuda_inputs(tensors, 2, "the adaptive fused kernel")
    su, sx, sw = _dims(nx, nu, N)
    B = G * L
    if B == 0:
        raise ValueError("empty batch")
    order = tmaps.T1s.shape[-3] - 1
    if order > MAX_ORDER:
        raise ValueError(f"the adaptive fused kernel takes Taylor orders up "
                         f"to {MAX_ORDER}; got {order}")
    osqp = controller == "osqp"
    if osqp and max(nx, nu) > MAX_STAGE:
        raise ValueError(f"the OSQP-form controller of the adaptive fused "
                         f"kernel takes stages of at most {MAX_STAGE} "
                         f"entries; got nx={nx}, nu={nu}")
    dev = x0s.device
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    tile, resident = adaptive_tile_plan(nx, nu, N, order, B, n_sm)
    swp, sup = _padded(sw), _padded(su)
    smem = 4 * (tile * _lane_floats(nx, nu, N)
                + (_map_floats(nx, nu, N, order) if resident else 0))
    state_free = _state_free(en_state_bound, cons)
    side_u = _side_args(cons.lin_u, cons.cones_u, nu, "input")
    side_x = _side_args(cons.lin_x, cons.cones_x, nx, "state")

    f32 = dict(dtype=torch.float32, device=dev)
    t1t, t2t = map_layout(tmaps, su, sw)
    # the expansion centre and the trust clip's bounds in the plain
    # version's float32 arithmetic: one per group on the device, or for a
    # single group by value (read on the host; its kernel variant keeps them
    # out of its registers)
    trust = math.isfinite(taylor_trust)
    tr = float(taylor_trust) if trust else 0.0
    rho0 = trust_lo = trust_hi = None
    one = (0.0, 0.0, 0.0)
    if G > 1:
        rho0 = tmaps.rho0.reshape(-1).expand(G).contiguous()
        trust_lo, trust_hi = rho0 - tr, rho0 + tr
    else:
        r0 = np.float32(float(tmaps.rho0))
        one = (float(r0), float(r0 - np.float32(tr)),
               float(r0 + np.float32(tr)))
    xout = torch.empty((sx, B), **f32)
    uout = torch.empty((su, B), **f32)
    iters = torch.empty((B,), dtype=torch.int32, device=dev)
    solved = torch.empty((B,), dtype=torch.int32, device=dev)
    rho = torch.empty((B,), **f32)
    y = torch.empty((su, B), **f32)
    if state_free:  # the kernel never touches g; the carry reports zeros
        g = torch.zeros((sx, B), **f32) if carry_out else None
    else:
        g = torch.empty((sx, B), **f32)
    d_out = torch.empty((su, B), **f32) if carry_out else None
    vco = torch.empty((sx, B), **f32) if carry_out else None
    zco = torch.empty((su, B), **f32) if carry_out else None
    w = warm if warm is not None else AdaptiveFusedCarry(*[None] * 6)
    pl = plant if osqp else AdaptivePlant(*[None] * 6)

    fn = _kernel_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(_ptr(t1t), _ptr(t2t), _ptr(rho0), _ptr(trust_lo),
                 _ptr(trust_hi), _ptr(u_min), _ptr(u_max), _ptr(x_min),
                 _ptr(x_max), _ptr(x0), _ptr(w.d), _ptr(w.y),
                 None if state_free else _ptr(w.g), _ptr(w.v), _ptr(w.z),
                 _ptr(w.rho), _ptr(xout), _ptr(uout), _ptr(iters),
                 _ptr(solved), _ptr(rho), _ptr(y),
                 None if state_free else _ptr(g), _ptr(d_out), _ptr(vco),
                 _ptr(zco), _ptr(pl.A), _ptr(pl.B), _ptr(pl.Q), _ptr(pl.R),
                 _ptr(pl.Pinf), _ptr(pl.dPinf_drho),
                 nx, nu, N, G, L, order, max_iter, check_termination,
                 relaxation_alpha, 1.0 - relaxation_alpha, abs_pri_tol,
                 abs_dua_tol, adaptive_rho_min, adaptive_rho_max, *one,
                 int(osqp), int(adaptive_rho_clipping), int(trust),
                 int(en_input_bound), int(en_state_bound), int(warm_start),
                 int(carry_out), tile, int(resident), swp, sup, smem,
                 int(tmaps.T1s.ndim == 4),
                 int(osqp and pl.A.ndim == 3),
                 int(G > 1 and u_min.numel() == G * su),
                 int(G > 1 and x_min.numel() == G * sx),
                 *side_u, *side_x, stream)
    if err != 0:
        raise RuntimeError(f"condensed_adaptive kernel launch failed: CUDA "
                           f"error {err}")
    condensed_adaptive_cuda.launches += 1
    if G > 1:
        condensed_adaptive_cuda.grouped_launches += 1
    out = (xout.T.reshape(B, N, nx), uout.T.reshape(B, N - 1, nu), iters,
           solved, rho)
    if carry_out:
        return out + (AdaptiveFusedCarry(d_out, y, g, vco, zco,
                                         rho.reshape(1, B)),)
    return out


condensed_adaptive_cuda.launches = 0
condensed_adaptive_cuda.grouped_launches = 0


def condensed_adaptive(tmaps, u_min, u_max, x_min, x_max, x0s, warm=None,
                       **kw):
    """The kernel on CUDA tensors, its plain version on CPU tensors;
    arguments and results as ``condensed_adaptive_reference``."""
    if x0s.device.type == "cuda":
        fn = condensed_adaptive_cuda
    elif x0s.device.type == "cpu":
        fn = condensed_adaptive_reference
    else:
        raise ValueError(f"no fused solver for device {x0s.device}")
    return fn(tmaps, u_min, u_max, x_min, x_max, x0s, warm, **kw)


def make_condensed_adaptive_fused_solver(
        A, B, Qdiag, Rdiag, Pinf, dPinf, N, *,
        max_iter: int = 100,
        abs_pri_tol: float = 1e-3, abs_dua_tol: float = 1e-3,
        en_state_bound: bool = False, en_input_bound: bool = True,
        relaxation_alpha: float = 1.0,
        adaptive_rho_min: float = 1.0, adaptive_rho_max: float = 100.0,
        adaptive_rho_clipping: bool = True,
        check_termination: int = 1,
        controller: str = "osqp", taylor_trust: float = float("inf"),
        soc_u: tuple = (), soc_x: tuple = (), lin_u=None, lin_x=None,
        warm_start: bool = False, carry_out: bool = False,
        precision: str = "highest", num_groups: int = 1):
    """Build ``solve_fn(tmaps, u_min, u_max, x_min, x_max, x0s[, warm]) ->
    (x (B, N, nx), u (B, N-1, nu), iters (B,), solved (B,), rho (B,)[,
    carry])`` with per-lane adaptive rho.

    ``A``, ``B``, ``Qdiag``, ``Rdiag`` (the rho-folded diagonals), ``Pinf``
    and ``dPinf`` are the problem and cache data shared by the batch (numpy
    arrays or tensors); the OSQP-form controller reads them, and they are
    moved to the solve's device at its first call there, like the constraint
    options (those of ``make_condensed_fused_solver``).  ``tmaps`` is a
    ``CondensedTaylorMaps``; bounds are stacked or horizon-major.

    With ``num_groups=G`` the launch solves G distinct problems: the plant
    data, ``tmaps`` (``build_condensed_taylor`` on G-stacked problems), the
    bounds and the constraint data may carry a leading group axis, and
    ``x0s`` is (G, L, nx) (or flat, lane = g*L + l).  The trust clip is
    around each group's own rho0; results and carries keep the flat lane
    order.

    ``controller`` is "osqp" (the reference's OSQP-form residual controller)
    or "termination" (``ops.rho.termination_controller``), which
    ``taylor_trust`` also clips to rho0 +- trust.  ``check_termination=k``
    evaluates residuals only on every k-th iteration; ``max_iter`` must be a
    multiple of lcm(k, 5), as in the JAX package.  With ``warm_start=True``
    the extra ``warm`` argument is an ``AdaptiveFusedCarry`` from a
    ``carry_out=True`` solve; the continuation restarts the iteration
    counter, so its first iteration never updates rho.

    Reduced-precision matmuls (``precision``) are not ported (no caller
    uses them: the rho prediction would read the residuals of an
    approximate rollout) and raise ``NotImplementedError``."""
    ct = check_termination
    if ct < 1:
        raise ValueError("check_termination must be >= 1 on the fused "
                         f"adaptive kernel (got {ct})")
    if controller not in ("osqp", "termination"):
        raise ValueError("controller must be 'osqp' or 'termination', got "
                         f"{controller!r}")
    step = math.lcm(RHO_INTERVAL, ct)
    if max_iter % step != 0:
        raise ValueError(
            f"max_iter must be a multiple of lcm(check_termination, "
            f"{RHO_INTERVAL}) = {step} (got {max_iter})")
    if precision != "highest":
        raise not_ported("reduced-precision matmuls in the adaptive fused "
                         "kernel", "ROADMAP.md queue 2, K2's precision "
                         "argument")
    if num_groups < 1:
        raise ValueError(f"num_groups must be >= 1 (got {num_groups})")
    nx, nu = np.shape(B)[-2:]
    kw = dict(nx=nx, nu=nu, N=N, max_iter=max_iter, abs_pri_tol=abs_pri_tol,
              abs_dua_tol=abs_dua_tol, en_state_bound=en_state_bound,
              en_input_bound=en_input_bound,
              relaxation_alpha=relaxation_alpha,
              adaptive_rho_min=adaptive_rho_min,
              adaptive_rho_max=adaptive_rho_max,
              adaptive_rho_clipping=adaptive_rho_clipping,
              check_termination=ct, controller=controller,
              taylor_trust=taylor_trust, warm_start=warm_start,
              carry_out=carry_out, num_groups=num_groups)

    on_device = {}  # (device, dtype) -> (AdaptivePlant, FusedConstraints)

    def solve_fn(tmaps, u_min, u_max, x_min, x_max, x0s, warm=None):
        key = (x0s.device, x0s.dtype)
        if key not in on_device:
            plant = AdaptivePlant(*(
                (a if isinstance(a, torch.Tensor) else torch.tensor(
                    np.asarray(a))).to(x0s.device, x0s.dtype).contiguous()
                for a in (A, B, Qdiag, Rdiag, Pinf, dPinf)))
            on_device[key] = (plant, fused_constraints(
                soc_u, soc_x, lin_u, lin_x, nx=nx, nu=nu, dtype=x0s.dtype,
                device=x0s.device, num_groups=num_groups))
        plant, constraints = on_device[key]
        return condensed_adaptive(tmaps, u_min, u_max, x_min, x_max, x0s,
                                  warm, plant=plant, constraints=constraints,
                                  **kw)

    return solve_fn
