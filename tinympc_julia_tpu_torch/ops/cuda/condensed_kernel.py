"""Kernel K1: the fixed-rho condensed ADMM solve, fused, with its box,
linear and cone projections (K1e) (counterpart of
tinympc_julia_tpu/ops/pallas/condensed_kernel.py).

``make_condensed_fused_solver`` returns ``solve_fn(maps, rho, u_min, u_max,
x_min, x_max, x0s[, warm])``.  On CUDA tensors it launches the hand-written
kernel ``csrc/condensed_fused.cu`` (``condensed_fused_cuda``) or raises; on
CPU tensors it runs the kernel's plain PyTorch version
(``condensed_fused_reference``).  There is no fallback from one to the other.

Per-lane semantics are those of the Pallas kernel: one fused matmul per
iteration ``ux = T12w @ w2 + uxc``; a cold iteration 0 that is the pure
rollout; slack projections box -> per-stage halfspaces (cyclic) -> per-stage
scaled SOCs; residual checks on the last iteration of each
``check_termination`` group; converged lanes latch and freeze; the warm
carry ``FusedCarry(w2, y, g, v, z)`` makes a chained solve equal one long
solve.  Tolerances, rho, alpha and the constraint data are run-time
arguments of the kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ...types import ConeSet
from ..condensed import (CondensedMaps, _cones_stacked, _halfspaces_stacked,
                         halfspace_rows)
from ._build import load_library


class FusedCarry(NamedTuple):
    """Warm-start carry of the fused solve, stacked (dim, B) layout.
    ``w2 = [znew - y; vnew - g]`` is the fused matmul's input, so a
    continuation replays the same matmul as the uninterrupted solve."""
    w2: torch.Tensor  # (su + sx, B)
    y: torch.Tensor   # (su, B)
    g: torch.Tensor   # (sx, B), zeros without a state bound
    v: torch.Tensor   # (sx, B)
    z: torch.Tensor   # (su, B)


class FusedConstraints(NamedTuple):
    """The linear and cone constraint data of one fused solve, on the solve's
    device and in its dtype: halfspace rows packed by
    ``condensed.halfspace_rows`` (None where the family is off) and a cone
    set per side.  Kernel and plain version read the same tensors."""
    lin_u: torch.Tensor | None  # (m_u, 2*nu + 1)
    lin_x: torch.Tensor | None  # (m_x, 2*nx + 1)
    cones_u: ConeSet
    cones_x: ConeSet


# The launch layout is decided here and passed to the kernel, which checks
# it: shared memory one block may use on sm_90 (opt-in maximum, bytes), the
# row padding of the transposed T12 (a multiple of the kernel's output-row
# register block, csrc/condensed_fused.cu kRowBlock) and the largest tile.
# The projections hold one stage of a side in a per-thread buffer of
# MAX_STAGE floats (kMaxStage) and take at most MAX_CONES cones a side
# (kMaxCones).
SMEM_PER_BLOCK = 232448
ROW_BLOCK = 8
MAX_TILE = 128
MAX_STAGE = 12
MAX_CONES = 8


def cone_spec(cones: ConeSet) -> tuple:
    """ConeSet -> the factory's ``(start, dim, mu)`` tuples; ``mu`` stays a
    0-d tensor on the problem's device (no host round trip)."""
    return tuple((int(st), int(dm), cones.mus[k])
                 for k, (st, dm) in enumerate(zip(cones.starts, cones.dims)))


def problem_constraint_kw(problem, settings) -> dict:
    """The constraint kwargs of ``make_condensed_fused_solver`` from a
    Problem and Settings (``()``/None for the families that are off)."""
    p, s = problem, settings
    return dict(
        soc_u=cone_spec(p.cones_u) if s.en_input_soc else (),
        soc_x=cone_spec(p.cones_x) if s.en_state_soc else (),
        lin_u=(p.Alin_u, p.blin_u) if s.en_input_linear else None,
        lin_x=(p.Alin_x, p.blin_x) if s.en_state_linear else None)


def fused_constraints(soc_u=(), soc_x=(), lin_u=None, lin_x=None, *, nx,
                      nu, dtype, device) -> FusedConstraints:
    """The factory's constraint options as tensors on ``device``: the
    halfspace rows packed in float64 then cast to ``dtype``, the cone
    coefficients stacked.  A family given with no rows is left out."""
    def cones(spec, n):
        spec = tuple(spec)
        for st, dm, _ in spec:
            if st < 0 or dm < 2 or st + dm > n:
                raise ValueError(f"cone [{st}, {st + dm}) does not fit a "
                                 f"stage vector of {n}")
        if not spec:
            return ConeSet.empty(dtype, device)
        mus = torch.stack([torch.as_tensor(mu).to(device, torch.float64)
                           .reshape(()) for _, _, mu in spec])
        return ConeSet(mus=mus.to(dtype), starts=tuple(int(c[0]) for c in
                                                       spec),
                       dims=tuple(int(c[1]) for c in spec))

    def rows(lin, n):
        if lin is None:
            return None
        A = torch.as_tensor(lin[0]).to(device, torch.float64)
        b = torch.as_tensor(lin[1]).to(device, torch.float64)
        if A.ndim != 2 or A.shape[1] != n:
            raise ValueError(f"Alin must be (m, {n}); got {tuple(A.shape)}")
        if A.shape[0] == 0:
            return None
        return halfspace_rows(A, b).to(dtype)

    return FusedConstraints(lin_u=rows(lin_u, nu), lin_x=rows(lin_x, nx),
                            cones_u=cones(soc_u, nu), cones_x=cones(soc_x, nx))


def _state_free(en_state_bound, cons: FusedConstraints) -> bool:
    """No state-side constraint at all: the state dual stays 0, vnew =
    x_hat (the Pallas kernel's rule)."""
    return (not en_state_bound
            and (cons.lin_x is None or cons.lin_x.shape[0] == 0)
            and cons.cones_x.num_cones == 0)


def _padded_rows(sw: int) -> int:
    return -(-sw // ROW_BLOCK) * ROW_BLOCK


def _smem_bytes(sw: int, tile: int, resident: bool) -> int:
    """Dynamic shared memory of one block: two w2 buffers of sw floats per
    lane, and the padded T12 where it is resident."""
    return 4 * (2 * sw * tile + (sw * _padded_rows(sw) if resident else 0))


def fused_tile_plan(nx: int, nu: int, N: int) -> tuple[int, bool]:
    """(lanes per block, whether T12 is staged in shared memory).

    T12 joins the lanes' w2 buffers in shared memory where a warp's worth of
    lanes still fits beside it, and is read from global memory (L2)
    otherwise."""
    sw = (N - 1) * nu + N * nx
    resident = _smem_bytes(sw, 32, True) <= SMEM_PER_BLOCK
    avail = SMEM_PER_BLOCK - (_smem_bytes(sw, 0, True) if resident else 0)
    tile = min(MAX_TILE, avail // _smem_bytes(sw, 1, False) // 32 * 32)
    if tile < 32:
        raise ValueError(f"fused kernel: a map of width {sw} leaves no room "
                         "for a warp of lanes in shared memory")
    return tile, resident


def _dims(nx, nu, N):
    su, sx = (N - 1) * nu, N * nx
    return su, sx, su + sx


def _validate(maps, bounds, x0s, warm, nx, nu, N, warm_start, cons):
    su, sx, sw = _dims(nx, nu, N)
    if x0s.ndim != 2 or x0s.shape[1] != nx:
        raise ValueError(f"x0s must be (B, {nx}); got {tuple(x0s.shape)}")
    B = x0s.shape[0]
    if tuple(maps.T12.shape) != (sw, sw + 1):
        raise ValueError(f"T12 must be ({sw}, {sw + 1}); got "
                         f"{tuple(maps.T12.shape)}")
    if tuple(maps.T1.shape) != (sw, su + nx + 1):
        raise ValueError(f"T1 must be ({sw}, {su + nx + 1}); got "
                         f"{tuple(maps.T1.shape)}")
    for b, n in zip(bounds, (su, su, sx, sx)):
        if b.numel() != n:
            raise ValueError(f"a bound has {b.numel()} entries, expected {n}")
    if warm_start and warm is None:
        raise ValueError("warm_start solver needs the warm carry")
    if not warm_start and warm is not None:
        raise ValueError("pass warm only to a warm_start=True solver")
    tensors = [maps.T12, maps.T1, *bounds, x0s]
    for rows, n in ((cons.lin_u, nu), (cons.lin_x, nx)):
        if rows is not None:
            if rows.ndim != 2 or rows.shape[1] != 2 * n + 1:
                raise ValueError(f"halfspace rows must be (m, {2 * n + 1}); "
                                 f"got {tuple(rows.shape)}")
            tensors.append(rows)
    tensors += [cons.cones_u.mus, cons.cones_x.mus]
    if warm is not None:
        for w, n in zip(warm, (sw, su, sx, sx, su)):
            if tuple(w.shape) != (n, B):
                raise ValueError(f"warm carry array {tuple(w.shape)}, "
                                 f"expected ({n}, {B})")
        tensors += list(warm)
    for t in tensors:
        if t.device != x0s.device:
            raise ValueError(f"all inputs must be on {x0s.device}; got one "
                             f"on {t.device}")
    return tensors


def _no_constraints(x0s) -> FusedConstraints:
    empty = ConeSet.empty(x0s.dtype, x0s.device)
    return FusedConstraints(None, None, empty, empty)


def condensed_fused_reference(maps: CondensedMaps, rho, u_min, u_max, x_min,
                              x_max, x0s, warm=None, *, nx, nu, N, max_iter,
                              abs_pri_tol, abs_dua_tol, en_state_bound,
                              en_input_bound, relaxation_alpha,
                              check_termination, warm_start, carry_out,
                              constraints: FusedConstraints | None = None):
    """Plain PyTorch version of kernel K1: the same computation in the same
    order, on the whole batch at once (a lane's result does not depend on
    which lanes share its tile).  Any float dtype and device;
    ``constraints`` (``fused_constraints``) in the same dtype."""
    cons = constraints or _no_constraints(x0s)
    _validate(maps, (u_min, u_max, x_min, x_max), x0s, warm, nx, nu, N,
              warm_start, cons)
    su, sx, sw = _dims(nx, nu, N)
    ct = check_termination
    dt, dev = x0s.dtype, x0s.device
    B = x0s.shape[0]
    T12w, T12c = maps.T12[:, :sw], maps.T12[:, sw:]
    Tx0, T1c = maps.T1[:, su:su + nx], maps.T1[:, -1:]
    umin, umax = u_min.reshape(su, 1), u_max.reshape(su, 1)
    xmin, xmax = x_min.reshape(sx, 1), x_max.reshape(sx, 1)
    rho = torch.as_tensor(rho, dtype=dt, device=dev)
    pri_tol = torch.tensor(abs_pri_tol, dtype=dt, device=dev)
    dua_tol = torch.tensor(abs_dua_tol, dtype=dt, device=dev)
    alpha = relaxation_alpha
    state_free = _state_free(en_state_bound, cons)

    def project(w, rows, cones, n_stages, dim):
        if rows is not None:
            w = _halfspaces_stacked(w, rows, n_stages, dim)
        return _cones_stacked(w, cones, n_stages, dim)

    uxc = Tx0 @ x0s.T + T1c
    if warm_start:
        w2, y, g, v, z = (w.clone() for w in warm)
    else:
        w2 = torch.zeros((sw, B), dtype=dt, device=dev)
        y = torch.zeros((su, B), dtype=dt, device=dev)
        g = torch.zeros((sx, B), dtype=dt, device=dev)
        v = torch.zeros((sx, B), dtype=dt, device=dev)
        z = torch.zeros((su, B), dtype=dt, device=dev)
    if state_free:
        g = torch.zeros((sx, B), dtype=dt, device=dev)
    vco, zco = v.clone(), z.clone()
    conv = torch.zeros((B,), dtype=torch.bool, device=dev)
    iters = torch.full((B,), max_iter, dtype=torch.int32, device=dev)
    solved = torch.zeros((B,), dtype=torch.int32, device=dev)

    def one_iter(i, ux, check):
        nonlocal w2, y, g, v, z, vco, zco, conv, iters, solved
        u, x = ux[:su], ux[su:]
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
        y = torch.where(prev, y, y + u_hat - znew)
        if not state_free:
            g = torch.where(prev, g, g + x_hat - vnew)
        conv_all = prev
        if check:
            ps = torch.amax(torch.abs(x - vnew), dim=0)
            pi = torch.amax(torch.abs(u - znew), dim=0)
            ds = torch.amax(torch.abs(v - vnew), dim=0) * rho
            di = torch.amax(torch.abs(z - znew), dim=0) * rho
            ok = ((ps < pri_tol) & (pi < pri_tol) & (ds < dua_tol)
                  & (di < dua_tol))
            newly = ok & ~prev
            iters = torch.where(newly, i + 1, iters)
            solved = torch.where(newly, 1, solved)
            conv_all = prev | newly
        # outputs take vnew/znew on the converging iteration, then freeze;
        # the carry's v/z and w2 freeze before it
        v, z = torch.where(prev, v, vnew), torch.where(prev, z, znew)
        if carry_out:
            vco = torch.where(conv_all, vco, vnew)
            zco = torch.where(conv_all, zco, znew)
        w2_new = torch.cat([znew - y, vnew if state_free else vnew - g])
        w2 = torch.where(conv_all, w2, w2_new)
        conv = conv_all
        return check and bool(conv.all())

    i = 0
    if not warm_start:
        done = one_iter(0, uxc, ct == 1)
        uxc = uxc + T12c
        i = 1
    else:
        uxc = uxc + T12c
        done = False
    while i < max_iter and not done:
        done = one_iter(i, T12w @ w2 + uxc, (i + 1) % ct == 0)
        i += 1

    out = (v.T.reshape(B, N, nx), z.T.reshape(B, N - 1, nu), iters, solved)
    if carry_out:
        return out + (FusedCarry(w2, y, g, vco, zco),)
    return out


_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_FLT = ctypes.c_float
_IPTR = ctypes.POINTER(ctypes.c_int)
# one side's constraints: halfspace rows (device), their count, the cones'
# (start, dim) pairs (host), the cones' mu (device), the cone count
_SIDE = [_PTR, _INT, _IPTR, _PTR, _INT]
_ARGTYPES = ([_PTR] * 24 + [_INT] * 6 + [_FLT] * 5 + [_INT] * 8
             + _SIDE + _SIDE + [_PTR])


@functools.cache
def _kernel_fn():
    fn = load_library("condensed_fused").lib.tinympc_condensed_fused
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _ptr(t):
    return None if t is None else t.data_ptr()


def _side_args(rows, cones: ConeSet, dim: int, side: str) -> list:
    """The five C arguments of one side's constraints (``_SIDE``)."""
    n_lin = 0 if rows is None else int(rows.shape[0])
    n_soc = cones.num_cones
    if (n_lin or n_soc) and dim > MAX_STAGE:
        raise ValueError(f"the fused kernel projects stages of at most "
                         f"{MAX_STAGE} entries; the {side} side has {dim} "
                         "(ROADMAP.md queue 2, K1e stage width)")
    if n_soc > MAX_CONES:
        raise ValueError(f"the fused kernel takes at most {MAX_CONES} cones "
                         f"a side; the {side} side has {n_soc}")
    spec = (ctypes.c_int * max(2 * n_soc, 1))(
        *(v for c in zip(cones.starts, cones.dims) for v in c))
    return [_ptr(rows), n_lin, spec, _ptr(cones.mus) if n_soc else None,
            n_soc]


def condensed_fused_cuda(maps: CondensedMaps, rho, u_min, u_max, x_min,
                         x_max, x0s, warm=None, *, nx, nu, N, max_iter,
                         abs_pri_tol, abs_dua_tol, en_state_bound,
                         en_input_bound, relaxation_alpha, check_termination,
                         warm_start, carry_out,
                         constraints: FusedConstraints | None = None):
    """Launch kernel K1 (csrc/condensed_fused.cu) on CUDA tensors; the
    arguments and results are those of ``condensed_fused_reference``.
    Raises on CPU tensors, on any dtype but float32, on non-contiguous
    inputs, on a projected stage wider than MAX_STAGE, and when the build
    or the launch fails.  Counts every launch in ``.launches`` and those
    that run linear or cone projections (K1e) also in
    ``.projected_launches``."""
    cons = constraints or _no_constraints(x0s)
    tensors = _validate(maps, (u_min, u_max, x_min, x_max), x0s, warm, nx,
                        nu, N, warm_start, cons)
    for t in tensors:
        if not t.is_cuda:
            raise ValueError("condensed_fused_cuda takes CUDA tensors only")
        if t.dtype != torch.float32:
            raise TypeError(f"the fused kernel is float32; got {t.dtype}")
    for t in tensors[2:]:
        if not t.is_contiguous():
            raise ValueError("bounds, x0s and the warm carry must be "
                             "contiguous")
    su, sx, sw = _dims(nx, nu, N)
    B = x0s.shape[0]
    if B == 0:
        raise ValueError("empty batch")
    dev = x0s.device
    tile, resident = fused_tile_plan(nx, nu, N)
    swp = _padded_rows(sw)
    state_free = _state_free(en_state_bound, cons)
    side_u = _side_args(cons.lin_u, cons.cones_u, nu, "input")
    side_x = _side_args(cons.lin_x, cons.cones_x, nx, "state")

    f32 = dict(dtype=torch.float32, device=dev)
    # kernel-side layouts of the maps: T12w transposed with its rows padded,
    # and the rollout/constant columns as contiguous vectors
    t12t = torch.zeros((sw, swp), **f32)
    t12t[:, :sw] = maps.T12[:, :sw].T
    t12c = maps.T12[:, sw].contiguous()
    tx0 = maps.T1[:, su:su + nx].contiguous()
    t1c = maps.T1[:, -1].contiguous()
    xout = torch.empty((sx, B), **f32)
    uout = torch.empty((su, B), **f32)
    iters = torch.empty((B,), dtype=torch.int32, device=dev)
    solved = torch.empty((B,), dtype=torch.int32, device=dev)
    y = torch.empty((su, B), **f32)
    if state_free:  # the kernel never touches g; the carry reports zeros
        g = torch.zeros((sx, B), **f32) if carry_out else None
    else:
        g = torch.empty((sx, B), **f32)
    uxc = torch.empty((sw, B), **f32)
    w2o = torch.empty((sw, B), **f32) if carry_out else None
    vco = torch.empty((sx, B), **f32) if carry_out else None
    zco = torch.empty((su, B), **f32) if carry_out else None
    w = warm if warm is not None else FusedCarry(None, None, None, None, None)

    fn = _kernel_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(_ptr(t12t), _ptr(t12c), _ptr(tx0), _ptr(t1c),
                 _ptr(u_min), _ptr(u_max), _ptr(x_min), _ptr(x_max),
                 _ptr(x0s), _ptr(w.w2), _ptr(w.y),
                 None if state_free else _ptr(w.g), _ptr(w.v), _ptr(w.z),
                 _ptr(xout), _ptr(uout), _ptr(iters), _ptr(solved),
                 _ptr(y), None if state_free else _ptr(g), _ptr(uxc),
                 _ptr(w2o), _ptr(vco), _ptr(zco),
                 nx, nu, N, B, max_iter, check_termination,
                 float(rho), relaxation_alpha, 1.0 - relaxation_alpha,
                 abs_pri_tol, abs_dua_tol, int(en_input_bound),
                 int(en_state_bound), int(warm_start), int(carry_out),
                 tile, int(resident), swp,
                 _smem_bytes(sw, tile, resident), *side_u, *side_x, stream)
    if err != 0:
        raise RuntimeError(f"condensed_fused kernel launch failed: CUDA "
                           f"error {err}")
    condensed_fused_cuda.launches += 1
    if side_u[1] or side_u[4] or side_x[1] or side_x[4]:
        condensed_fused_cuda.projected_launches += 1
    out = (xout.T.reshape(B, N, nx), uout.T.reshape(B, N - 1, nu), iters,
           solved)
    if carry_out:
        return out + (FusedCarry(w2o, y, g, vco, zco),)
    return out


condensed_fused_cuda.launches = 0
condensed_fused_cuda.projected_launches = 0


def make_condensed_fused_solver(nx: int, nu: int, N: int, *,
                                max_iter: int = 100,
                                abs_pri_tol: float = 1e-3,
                                abs_dua_tol: float = 1e-3,
                                en_state_bound: bool = False,
                                en_input_bound: bool = True,
                                relaxation_alpha: float = 1.0,
                                check_termination: int = 1,
                                warm_start: bool = False,
                                carry_out: bool = False,
                                precision: str = "highest",
                                bf16_head_iters: int = 0,
                                num_groups: int = 1,
                                soc_u: tuple = (), soc_x: tuple = (),
                                lin_u=None, lin_x=None):
    """Build ``solve_fn(maps, rho, u_min, u_max, x_min, x_max, x0s[, warm])
    -> (x (B, N, nx), u (B, N-1, nu), iters (B,), solved (B,)[, carry])``.

    Bounds are stacked ((N-1)*nu,)/(N*nx,) or horizon-major, shared by the
    batch; ``x0s`` is (B, nx); ``rho`` is a float or a 0-d tensor.  With
    ``warm_start=True`` the extra ``warm`` argument is a FusedCarry; with
    ``carry_out=True`` the result gains one.  ``check_termination=k``
    evaluates residuals only on every k-th iteration and must divide
    ``max_iter``.

    Constraints beyond the box, in the JAX factory's form, composed box ->
    linear -> SOC on every stage: ``soc_u``/``soc_x`` tuples of ``(start,
    dim, mu)`` scaled SOCs (``mu`` a float or 0-d tensor), ``lin_u``/
    ``lin_x`` ``(Alin (m, dim), blin (m,))`` cyclic halfspaces.  They are
    moved to the solve's device at its first call on that device.  The
    reduced-precision head and the group grid are not ported yet and raise
    ``NotImplementedError`` (ROADMAP.md queue 2, K1c, K1d)."""
    ct = check_termination
    if ct < 1 or max_iter % ct != 0:
        raise ValueError(
            "check_termination must be >= 1 and divide max_iter on the fused "
            f"kernel (got check_termination={ct}, max_iter={max_iter})")
    if precision != "highest" or bf16_head_iters:
        raise NotImplementedError(
            "reduced-precision matmuls and bf16_head_iters are not ported "
            "yet (ROADMAP.md queue 2, K1c)")
    if num_groups != 1:
        raise NotImplementedError(
            "num_groups > 1 is not ported yet (ROADMAP.md queue 2, K1d)")
    kw = dict(nx=nx, nu=nu, N=N, max_iter=max_iter, abs_pri_tol=abs_pri_tol,
              abs_dua_tol=abs_dua_tol, en_state_bound=en_state_bound,
              en_input_bound=en_input_bound,
              relaxation_alpha=relaxation_alpha, check_termination=ct,
              warm_start=warm_start, carry_out=carry_out)

    constraints = {}  # (device, dtype) -> FusedConstraints

    def solve_fn(maps, rho, u_min, u_max, x_min, x_max, x0s, warm=None):
        if x0s.device.type == "cuda":
            fn = condensed_fused_cuda
        elif x0s.device.type == "cpu":
            fn = condensed_fused_reference
        else:
            raise ValueError(f"no fused solver for device {x0s.device}")
        key = (x0s.device, x0s.dtype)
        if key not in constraints:
            constraints[key] = fused_constraints(
                soc_u, soc_x, lin_u, lin_x, nx=nx, nu=nu, dtype=x0s.dtype,
                device=x0s.device)
        return fn(maps, rho, u_min, u_max, x_min, x_max, x0s, warm,
                  constraints=constraints[key], **kw)

    return solve_fn
