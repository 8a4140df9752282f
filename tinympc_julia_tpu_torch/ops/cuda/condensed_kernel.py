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

Group grid (``num_groups=G``): G distinct problems of L lanes each in one
launch.  Maps, rho, bounds, cone coefficients and halfspace rows may carry a
leading group axis (or stay shared); the constraint structure is the same
for every group; lanes keep the flat order ``g*L + l``.

Reduced precision (``precision="default"``, ``bf16_head_iters=k0``): the
product ``T12w @ w2`` of a reduced iteration is one bf16 pass, both operands
rounded to bf16 (round to nearest even) and the products summed on the
tensor cores in k16 steps (``mma_product``: the plain version follows the
tensor cores' arithmetic, so kernel and plain version agree to the bit);
everything else stays fp32.  The first k0 iterations are
reduced and check only on iteration k0 - 1; with ``precision="default"``
every iteration is reduced.  An iteration that runs the residual check always computes its
product in full precision, so a lane never latches on the residuals of an
approximate rollout.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ...types import ConeSet
from ...utils.precision import full_fp32_matmul
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
    set per side (``mus`` (C,), or (G, C) per group).  Kernel and plain
    version read the same tensors."""
    lin_u: torch.Tensor | None  # (m_u, 2*nu + 1), or (G, m_u, 2*nu + 1)
    lin_x: torch.Tensor | None  # (m_x, 2*nx + 1), or (G, m_x, 2*nx + 1)
    cones_u: ConeSet
    cones_x: ConeSet


# The launch layout is decided here and passed to the kernel, which checks
# it (csrc/condensed_fused.cu): shared memory one block may use on sm_90
# (opt-in maximum, bytes); tiles of 32 lanes (kTile) on 256 threads
# (kThreads, eight a lane); 16 thread rows (kRowGroups) of 8, 20 or 32 rows
# each (the kernel's instances: the cartpole's and the rocket's maps take
# 8, the quadrotor's 20), a wider map in passes of 16 RPT rows; a ring of 6
# fp32 slabs of 8 map rows of a pass (kStages, kSlabK) or 4 bf16 slabs of 16
# map columns (kStagesLo, kSlabKLo) whose rows are padded by 8 (kPadLo); the
# bf16 map's k padded to a multiple of 32.  MAX_TILE is the adaptive kernel's largest tile.  The
# projections hold one stage of a side in a per-thread buffer of MAX_STAGE
# floats (kMaxStage) and take at most MAX_CONES cones a side (kMaxCones).
SMEM_PER_BLOCK = 232448
MAX_TILE = 128
TILE = 32
THREADS = 256
TILE_ROW_GROUPS = 16
TILE_RPTS = (8, 20, 32)
SLAB_K = 8
STAGES = 6
SLAB_K_LO = 16
STAGES_LO = 4
KP_ALIGN = 32
PAD_LO = 8
MMA_N = 8
MAX_STAGE = 12
MAX_CONES = 8


class TilePlan(NamedTuple):
    """The launch layout of one K1 launch."""
    tile: int           # lanes per block
    threads: int        # threads per block
    resident: bool      # T12 staged whole in shared memory (else streamed)
    state_shared: bool  # the lanes' solver state in shared memory
    rows: int           # padded rows of the transposed map (swp)
    kp: int             # padded k of the bf16 map of reduced iterations
    smem: int           # dynamic shared memory of one block, bytes
    passes: int = 1     # passes of rows / passes map rows (the product's
                        # 16 thread rows x the rows a thread)

    @property
    def rpt(self) -> int:
        """Rows a thread of the product (the kernel's instance)."""
        return self.rows // (self.passes * TILE_ROW_GROUPS)


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16 (round to nearest even) and back: the
    operand rounding of a reduced-precision product, as the kernel's
    ``__float2bfloat16_rn``."""
    return t.bfloat16().to(t.dtype)


# The H100 tensor cores' sum of one k16 step of mma.sync.m16n8k16 (bf16 in,
# fp32 out, from zero): the 16 exact products are aligned to the largest of
# their unnormalised exponents ea + ew (ea = floor(log2 |a|)), each is
# truncated toward zero to MMA_FRAC_BITS bits below that exponent, the
# truncated terms are summed exactly, and the sum is truncated to fp32.
MMA_K = 16
MMA_FRAC_BITS = 25
MMA_CHUNK = 1 << 25  # broadcast terms one step of mma_product holds at once


def _exponent(t: torch.Tensor) -> torch.Tensor:
    """floor(log2 |t|) of a float64 tensor as int32; -2^20 where t is 0 (a
    zero never sets a step's alignment)."""
    _, e = torch.frexp(t)
    return torch.where(t != 0, e - 1, -(1 << 20))


def _pow2(n: torch.Tensor) -> torch.Tensor:
    """2^n exactly, float64, for integers -1022 <= n <= 1023."""
    return ((n.long() + 1023) << 52).view(torch.float64)


def _float32_toward_zero(s: torch.Tensor) -> torch.Tensor:
    """float64 -> float32, rounded toward zero."""
    f = s.float()
    over = f.double().abs() > s.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def mma_product(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` (``a`` (..., M, K), ``w`` (..., K, L), bf16 values) as
    kernel K1's reduced iterations compute it on the tensor cores: k in
    steps of MMA_K, each step's sum as one mma.sync computes it (above), the
    steps added in k order in IEEE fp32 from 0.  Float32 result; the
    broadcast terms are made MMA_CHUNK at a time, in slices of L."""
    K = a.shape[-1]
    pad = -K % MMA_K
    a = torch.nn.functional.pad(a, (0, pad)).double()
    w = torch.nn.functional.pad(w, (0, 0, 0, pad)).double()
    ea, ew = _exponent(a), _exponent(w)
    lead = torch.broadcast_shapes(a.shape[:-2], w.shape[:-2])
    M, L = a.shape[-2], w.shape[-1]
    out = torch.zeros(lead + (M, L), dtype=torch.float32, device=a.device)
    step = max(1, MMA_CHUNK // (M * MMA_K * lead.numel()))
    for l0 in range(0, L, step):
        c = slice(l0, l0 + step)
        for k0 in range(0, K + pad, MMA_K):
            k = slice(k0, k0 + MMA_K)
            # the step's alignment; an all-zero step sums to 0
            ulp = _pow2((ea[..., :, k, None] + ew[..., None, k, c]).amax(
                dim=-2, keepdim=True).clamp_(min=-900) - MMA_FRAC_BITS)
            terms = torch.div(a[..., :, k, None] * w[..., None, k, c], ulp,
                              rounding_mode="trunc")
            s = terms.sum(dim=-2) * ulp.squeeze(-2)
            out[..., c] += _float32_toward_zero(s)
    return out


def cone_spec(cones: ConeSet) -> tuple:
    """ConeSet -> the factory's ``(start, dim, mu)`` tuples; ``mu`` stays a
    tensor on the problem's device (no host round trip): 0-d, or (G,) for a
    G-stacked cone set."""
    return tuple((int(st), int(dm), cones.mus[..., k])
                 for k, (st, dm) in enumerate(zip(cones.starts, cones.dims)))


def problem_constraint_kw(problem, settings) -> dict:
    """The constraint kwargs of ``make_condensed_fused_solver`` from a
    Problem (one, or G stacked) and Settings (``()``/None for the families
    that are off)."""
    p, s = problem, settings
    return dict(
        soc_u=cone_spec(p.cones_u) if s.en_input_soc else (),
        soc_x=cone_spec(p.cones_x) if s.en_state_soc else (),
        lin_u=(p.Alin_u, p.blin_u) if s.en_input_linear else None,
        lin_x=(p.Alin_x, p.blin_x) if s.en_state_linear else None)


def fused_constraints(soc_u=(), soc_x=(), lin_u=None, lin_x=None, *, nx,
                      nu, dtype, device, num_groups: int = 1
                      ) -> FusedConstraints:
    """The factory's constraint options as tensors on ``device``: the
    halfspace rows packed in float64 then cast to ``dtype``, the cone
    coefficients stacked.  A family given with no rows is left out.  The
    structure is shared by the groups; a cone's ``mu`` may be a scalar or
    (G,) values and a halfspace family's ``Alin``/``blin`` may carry a
    leading group axis: the data then comes out per group."""
    G = num_groups

    def cones(spec, n):
        spec = tuple(spec)
        for st, dm, _ in spec:
            if st < 0 or dm < 2 or st + dm > n:
                raise ValueError(f"cone [{st}, {st + dm}) does not fit a "
                                 f"stage vector of {n}")
        if not spec:
            return ConeSet.empty(dtype, device)
        mus = [torch.as_tensor(mu).to(device, torch.float64).reshape(-1)
               for _, _, mu in spec]
        for m in mus:
            if m.numel() not in (1, G):
                raise ValueError(f"soc mu: expected a scalar or ({G},) "
                                 f"per-group values, got {m.numel()}")
        if all(m.numel() == 1 for m in mus):
            stacked = torch.cat(mus)
        else:
            stacked = torch.stack([m.expand(G) for m in mus], dim=1)
        return ConeSet(mus=stacked.to(dtype),
                       starts=tuple(int(c[0]) for c in spec),
                       dims=tuple(int(c[1]) for c in spec))

    def rows(lin, n):
        if lin is None:
            return None
        A = torch.as_tensor(lin[0]).to(device, torch.float64)
        b = torch.as_tensor(lin[1]).to(device, torch.float64)
        if A.ndim not in (2, 3) or A.shape[-1] != n:
            raise ValueError(f"Alin must be (m, {n}) or ({G}, m, {n}); got "
                             f"{tuple(A.shape)}")
        if A.shape[-2] == 0:
            return None
        if A.ndim == 3 or b.ndim == 2:
            m = A.shape[-2]
            A = A.expand(G, m, n) if A.ndim == 2 else A
            b = b.expand(G, m) if b.ndim == 1 else b
            if A.shape[0] != G or tuple(b.shape) != (G, m):
                raise ValueError(f"Alin/blin: the leading group axis must "
                                 f"be {G}; got {tuple(A.shape)} and "
                                 f"{tuple(b.shape)}")
        return halfspace_rows(A, b).to(dtype).contiguous()

    return FusedConstraints(lin_u=rows(lin_u, nu), lin_x=rows(lin_x, nx),
                            cones_u=cones(soc_u, nu), cones_x=cones(soc_x, nx))


def _state_free(en_state_bound, cons: FusedConstraints) -> bool:
    """No state-side constraint at all: the state dual stays 0, vnew =
    x_hat (the Pallas kernel's rule).  Decided from the structure, so once
    for all groups."""
    return (not en_state_bound
            and (cons.lin_x is None or cons.lin_x.shape[-2] == 0)
            and cons.cones_x.num_cones == 0)


def _up16(n: int) -> int:
    return -(-n // 16) * 16


def state_floats(nx: int, nu: int, N: int, state_free: bool) -> int:
    """Floats of one lane's solver state: uxc (sw), y and z (su each), v
    (sx) and, with a state constraint, g (sx)."""
    su, sx = (N - 1) * nu, N * nx
    return su + sx + 2 * su + (1 if state_free else 2) * sx


def ring_bytes(width: int, reduced: bool) -> int:
    """The slab ring of a streamed product of ``width`` rows at once
    (csrc/tile_gemm.cuh): STAGES fp32 slabs of SLAB_K k-rows, or with
    reduced iterations the larger of that and STAGES_LO bf16 slabs of
    SLAB_K_LO columns (rows padded by PAD_LO)."""
    ring = 4 * STAGES * SLAB_K * width
    if reduced:
        ring = max(ring, 2 * STAGES_LO * width * (SLAB_K_LO + PAD_LO))
    return ring


def tile_smem(sw: int, rows: int, kp: int, state: int, resident: bool,
              reduced: bool, passes: int = 1) -> int:
    """One block's shared memory (csrc/condensed_fused.cu tile_layout): the
    tile's w2 (sw x 32 floats), the latch flags, the residual partials of
    the lanes' threads, the lanes' solver state (``state`` floats a lane,
    0 where it stays in global memory), the map (resident: fp32, and bf16
    with reduced iterations; streamed: the slab ring of one pass of
    rows / passes rows), the bf16 w2 of reduced iterations ([lane][k], rows
    padded)."""
    n = (_up16(4 * sw * TILE) + _up16(4 * (TILE + 1)) + _up16(16 * THREADS)
         + _up16(4 * state * TILE))
    if resident:
        n += _up16(4 * sw * rows)
        if reduced:
            n += _up16(2 * rows * (kp + PAD_LO))
    else:
        n += _up16(ring_bytes(rows // passes, reduced))
    if reduced:
        n += _up16(2 * TILE * (kp + PAD_LO))
    return n


def fused_tile_plan(nx: int, nu: int, N: int, reduced: bool = False,
                    state_free: bool = True) -> TilePlan:
    """The layout of a launch at this shape (``reduced``: with
    reduced-precision iterations; ``state_free``: no state-side
    constraint, so no state dual).  The rows a thread: the instance that
    covers the map in the fewest passes of 16 RPT rows, padding it the
    least; where no layout of it fits, the next.  Within one: the lanes'
    solver state in
    shared memory where it fits, then T12 resident where it fits beside it
    and streamed in slabs otherwise."""
    sw = (N - 1) * nu + N * nx
    kp = -(-sw // KP_ALIGN) * KP_ALIGN
    state = state_floats(nx, nu, N, state_free)

    def passes(rpt):
        return -(-sw // (TILE_ROW_GROUPS * rpt))

    for rpt in sorted(TILE_RPTS, key=lambda r: (passes(r), passes(r) * r)):
        rows = passes(rpt) * TILE_ROW_GROUPS * rpt
        for shared in (True, False):
            for resident in (True, False):
                smem = tile_smem(sw, rows, kp, state if shared else 0,
                                 resident, reduced, passes(rpt))
                if smem <= SMEM_PER_BLOCK:
                    return TilePlan(TILE, THREADS, resident, shared, rows,
                                    kp, smem, passes(rpt))
    raise ValueError(f"fused kernel: a map of width {sw} leaves no room for "
                     "a tile of lanes in shared memory")


def tile_iterations(counts: torch.Tensor, tile: int, groups: int = 1) -> int:
    """Iterations summed over a launch's tiles (``tile`` lanes of one group,
    a block each) from the lanes' iteration counts: a tile runs until its
    last lane latches."""
    per = counts.reshape(groups, -1)
    per = torch.nn.functional.pad(per, (0, -per.shape[1] % tile))
    return int(per.reshape(groups, -1, tile).amax(dim=2).sum())


def _dims(nx, nu, N):
    su, sx = (N - 1) * nu, N * nx
    return su, sx, su + sx


def _flat_x0(x0s, G, nx):
    """x0s (G, L, nx) or flat (G*L, nx) -> ((G*L, nx), L)."""
    if x0s.ndim == 3:
        if x0s.shape[0] != G or x0s.shape[2] != nx:
            raise ValueError(f"grouped x0s must be ({G}, L, {nx}); got "
                             f"{tuple(x0s.shape)}")
        return x0s.reshape(G * x0s.shape[1], nx), x0s.shape[1]
    if x0s.ndim != 2 or x0s.shape[1] != nx:
        raise ValueError(f"x0s must be (B, {nx}); got {tuple(x0s.shape)}")
    if x0s.shape[0] % G != 0:
        raise ValueError(f"a flat batch of {x0s.shape[0]} lanes does not "
                         f"divide into {G} groups")
    return x0s, x0s.shape[0] // G


def _check_grouped_shape(t, shape, G, what):
    """``t`` is ``shape`` (shared) or ``(G,) + shape``; returns whether it
    carries the group axis."""
    if tuple(t.shape) == shape:
        return False
    if tuple(t.shape) == (G,) + shape:
        return True
    raise ValueError(f"{what} must be {shape} or {(G,) + shape}; got "
                     f"{tuple(t.shape)}")


def _check_constraints(cons, G, nx, nu):
    """The constraint tensors, checked against the group count."""
    tensors = []
    for rows, n in ((cons.lin_u, nu), (cons.lin_x, nx)):
        if rows is not None:
            if rows.ndim not in (2, 3) or rows.shape[-1] != 2 * n + 1 \
                    or (rows.ndim == 3 and rows.shape[0] != G):
                raise ValueError(f"halfspace rows must be (m, {2 * n + 1}) "
                                 f"or ({G}, m, {2 * n + 1}); got "
                                 f"{tuple(rows.shape)}")
            tensors.append(rows)
    for c in (cons.cones_u, cons.cones_x):
        if c.mus.ndim == 2 and c.mus.shape[0] != G:
            raise ValueError(f"cone coefficients must be (C,) or ({G}, C); "
                             f"got {tuple(c.mus.shape)}")
        tensors.append(c.mus)
    return tensors


def _validate(maps, rho, bounds, x0s, warm, nx, nu, N, warm_start, cons, G):
    """Shape and device checks shared by kernel and plain version; returns
    (flat x0s, lanes per group, every tensor the solve reads)."""
    su, sx, sw = _dims(nx, nu, N)
    if G < 1:
        raise ValueError(f"num_groups must be >= 1 (got {G})")
    x0, L = _flat_x0(x0s, G, nx)
    B = G * L
    _check_grouped_shape(maps.T12, (sw, sw + 1), G, "T12")
    _check_grouped_shape(maps.T1, (sw, su + nx + 1), G, "T1")
    if maps.T12.ndim != maps.T1.ndim:
        raise ValueError("T12 and T1 must both be shared or both grouped")
    for b, n in zip(bounds, (su, su, sx, sx)):
        if b.numel() not in (n, G * n):
            raise ValueError(f"a bound has {b.numel()} entries, expected {n} "
                             f"or {G} x {n}")
    if isinstance(rho, torch.Tensor) and rho.numel() not in (1, G):
        raise ValueError(f"rho must be a scalar or ({G},); got "
                         f"{tuple(rho.shape)}")
    if warm_start and warm is None:
        raise ValueError("warm_start solver needs the warm carry")
    if not warm_start and warm is not None:
        raise ValueError("pass warm only to a warm_start=True solver")
    tensors = [maps.T12, maps.T1, *bounds, x0]
    if isinstance(rho, torch.Tensor):
        tensors.append(rho)
    tensors += _check_constraints(cons, G, nx, nu)
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
    return x0, L, tensors


def _no_constraints(x0s) -> FusedConstraints:
    empty = ConeSet.empty(x0s.dtype, x0s.device)
    return FusedConstraints(None, None, empty, empty)


def _check_precision(precision, bf16_head_iters, max_iter, ct):
    if precision not in ("highest", "default"):
        raise ValueError("precision must be 'highest' or 'default' (one "
                         f"bf16 pass), got {precision!r}")
    k0 = int(bf16_head_iters)
    if k0 and (k0 < ct or k0 % ct != 0 or k0 >= max_iter):
        raise ValueError(
            f"bf16_head_iters={k0} must be a nonzero multiple of "
            f"check_termination={ct} below max_iter={max_iter}")
    return k0


def _grouped_view(t, G, rows):
    """A bound of ``rows`` entries, shared or per group, as (rows, 1) or
    (G, rows, 1)."""
    return t.reshape(G, rows, 1) if t.numel() == G * rows and G > 1 \
        else t.reshape(rows, 1)


@full_fp32_matmul()
def condensed_fused_reference(maps: CondensedMaps, rho, u_min, u_max, x_min,
                              x_max, x0s, warm=None, *, nx, nu, N, max_iter,
                              abs_pri_tol, abs_dua_tol, en_state_bound,
                              en_input_bound, relaxation_alpha,
                              check_termination, warm_start, carry_out,
                              constraints: FusedConstraints | None = None,
                              num_groups: int = 1, precision: str = "highest",
                              bf16_head_iters: int = 0):
    """Plain PyTorch version of kernel K1: the same computation in the same
    order, on the whole batch at once (a lane's result does not depend on
    which lanes share its tile).  Any float dtype and device;
    ``constraints`` (``fused_constraints``) in the same dtype.

    With ``num_groups=G`` the maps, ``rho``, the bounds and the constraint
    data may carry a leading group axis, ``x0s`` is (G, L, nx) or flat, and
    the iterates run as (G, dim, L) with batched matmuls; results and
    carries keep the flat lane order g*L + l.  The reduced product of
    ``precision``/``bf16_head_iters`` is ``mma_product(bf16_round(T12w),
    bf16_round(w2))``, fp32 sums in any working dtype."""
    cons = constraints or _no_constraints(x0s)
    G = num_groups
    ct = check_termination
    k0 = _check_precision(precision, bf16_head_iters, max_iter, ct)
    lo_all = precision == "default"
    x0, L, _ = _validate(maps, rho, (u_min, u_max, x_min, x_max), x0s, warm,
                         nx, nu, N, warm_start, cons, G)
    su, sx, sw = _dims(nx, nu, N)
    dt, dev = x0s.dtype, x0s.device
    B = G * L
    rho = torch.as_tensor(rho, dtype=dt, device=dev)
    # one shared problem runs on (dim, B) arrays; anything grouped on
    # (G, dim, L) arrays with the shared data broadcasting
    flat = (G == 1 and maps.T12.ndim == 2 and rho.ndim == 0
            and all(r is None or r.ndim == 2
                    for r in (cons.lin_u, cons.lin_x))
            and cons.cones_u.mus.ndim == 1 and cons.cones_x.mus.ndim == 1)
    lead = () if flat else (G,)
    if not flat:
        x0 = x0.reshape(G, L, nx)
        rho = rho.reshape(-1, 1) if rho.numel() > 1 else rho.reshape(())
        if warm is not None:
            warm = [w.reshape(-1, G, L).permute(1, 0, 2) for w in warm]
    T12w, T12c = maps.T12[..., :sw], maps.T12[..., sw:]
    Tx0, T1c = maps.T1[..., su:su + nx], maps.T1[..., -1:]
    Gb = 1 if flat else G
    umin, umax = _grouped_view(u_min, Gb, su), _grouped_view(u_max, Gb, su)
    xmin, xmax = _grouped_view(x_min, Gb, sx), _grouped_view(x_max, Gb, sx)
    pri_tol = torch.tensor(abs_pri_tol, dtype=dt, device=dev)
    dua_tol = torch.tensor(abs_dua_tol, dtype=dt, device=dev)
    alpha = relaxation_alpha
    state_free = _state_free(en_state_bound, cons)
    T12w_lo = bf16_round(T12w) if (k0 or lo_all) else None

    def project(w, rows, cones, n_stages, dim):
        if rows is not None:
            w = _halfspaces_stacked(w, rows, n_stages, dim)
        return _cones_stacked(w, cones, n_stages, dim)

    def zeros(rows):
        return torch.zeros(lead + (rows, L), dtype=dt, device=dev)

    def amax(t):
        return torch.amax(torch.abs(t), dim=-2)

    uxc = Tx0 @ x0.transpose(-1, -2) + T1c
    if warm_start:
        w2, y, g, v, z = (w.clone() for w in warm)
    else:
        w2, y, g, v, z = zeros(sw), zeros(su), zeros(sx), zeros(sx), zeros(su)
    if state_free:
        g = zeros(sx)
    vco, zco = v.clone(), z.clone()
    conv = torch.zeros(lead + (L,), dtype=torch.bool, device=dev)
    iters = torch.full(lead + (L,), max_iter, dtype=torch.int32, device=dev)
    solved = torch.zeros(lead + (L,), dtype=torch.int32, device=dev)

    def one_iter(i, ux, check):
        nonlocal w2, y, g, v, z, vco, zco, conv, iters, solved
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
        conv_all = prev
        if check:
            ps, pi = amax(x - vnew), amax(u - znew)
            ds, di = amax(v - vnew) * rho, amax(z - znew) * rho
            ok = ((ps < pri_tol) & (pi < pri_tol) & (ds < dua_tol)
                  & (di < dua_tol))
            newly = ok & ~prev
            iters = torch.where(newly, i + 1, iters)
            solved = torch.where(newly, 1, solved)
            conv_all = prev | newly
        # outputs take vnew/znew on the converging iteration, then freeze;
        # the carry's v/z and w2 freeze before it
        v, z = torch.where(pm, v, vnew), torch.where(pm, z, znew)
        cm = conv_all[..., None, :]
        if carry_out:
            vco = torch.where(cm, vco, vnew)
            zco = torch.where(cm, zco, znew)
        w2_new = torch.cat([znew - y, vnew if state_free else vnew - g],
                           dim=-2)
        w2 = torch.where(cm, w2, w2_new)
        conv = conv_all
        return check and bool(conv.all())

    def checks(i):
        """The head checks on its last iteration only, the rest on the last
        iteration of each ct group."""
        return i == k0 - 1 if i < k0 else (i + 1) % ct == 0

    i = 0
    if not warm_start:
        done = one_iter(0, uxc, checks(0))
        uxc = uxc + T12c
        i = 1
    else:
        uxc = uxc + T12c
        done = False
    while i < max_iter and not done:
        check = checks(i)
        # a checking iteration's product is never reduced
        if (i < k0 or lo_all) and not check:
            ux = mma_product(T12w_lo, bf16_round(w2)).to(dt) + uxc
        else:
            ux = T12w @ w2 + uxc
        done = one_iter(i, ux, check)
        i += 1

    def lanes(t):
        """(G, dim, L) -> (dim, G*L), the flat lane order."""
        return t if flat else t.permute(1, 0, 2).reshape(-1, B)

    out = (v.transpose(-1, -2).reshape(B, N, nx),
           z.transpose(-1, -2).reshape(B, N - 1, nu), iters.reshape(B),
           solved.reshape(B))
    if carry_out:
        return out + (FusedCarry(*(lanes(t) for t in (w2, y, g, vco, zco))),)
    return out


_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_FLT = ctypes.c_float
_IPTR = ctypes.POINTER(ctypes.c_int)
# one side's constraints: halfspace rows (device), their count, the cones'
# (start, dim) pairs (host), the cones' mu (device), the cone count, and
# whether the rows and the mus carry a leading group axis
_SIDE = [_PTR, _INT, _IPTR, _PTR, _INT, _INT, _INT]
_ARGTYPES = ([_PTR] * 27 + [_INT] * 9 + [_FLT] * 4 + [_INT] * 14
             + _SIDE + _SIDE + [_PTR])


@functools.cache
def _kernel_fn():
    fn = load_library("condensed_fused").lib.tinympc_condensed_fused
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _ptr(t):
    return None if t is None else t.data_ptr()


def map_layout(maps: CondensedMaps, nx, su, sw, reduced: bool,
               plan: TilePlan):
    """Kernel-side layouts of the maps, made at every launch: T12w
    transposed with its rows zero-padded to ``plan.rows``, T12w itself in
    real bf16 (round to nearest even), row-major and zero-padded to
    (``plan.rows``, ``plan.kp``), where the launch has reduced iterations
    (else None), the rollout and constant columns as contiguous vectors; a
    leading group axis is kept."""
    lead = maps.T12.shape[:-2]
    dev = maps.T12.device
    t12t = torch.zeros(lead + (sw, plan.rows), dtype=torch.float32,
                       device=dev)
    t12t[..., :sw] = maps.T12[..., :sw].transpose(-1, -2)
    lo = None
    if reduced:
        lo = torch.zeros(lead + (plan.rows, plan.kp), dtype=torch.bfloat16,
                         device=dev)
        lo[..., :sw, :sw] = maps.T12[..., :sw]
    return (t12t, lo, maps.T12[..., sw].contiguous(),
            maps.T1[..., su:su + nx].contiguous(),
            maps.T1[..., -1].contiguous())


def _side_args(rows, cones: ConeSet, dim: int, side: str) -> list:
    """The seven C arguments of one side's constraints (``_SIDE``)."""
    n_lin = 0 if rows is None else int(rows.shape[-2])
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
            n_soc, int(rows is not None and rows.ndim == 3),
            int(cones.mus.ndim == 2)]


def _check_cuda_inputs(tensors, first_contiguous, what):
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{what} takes CUDA tensors only")
        if t.dtype != torch.float32:
            raise TypeError(f"{what} is float32; got {t.dtype}")
    for t in tensors[first_contiguous:]:
        if not t.is_contiguous():
            raise ValueError("bounds, x0s, rho, the constraint data and the "
                             "warm carry must be contiguous")


def condensed_fused_cuda(maps: CondensedMaps, rho, u_min, u_max, x_min,
                         x_max, x0s, warm=None, *, nx, nu, N, max_iter,
                         abs_pri_tol, abs_dua_tol, en_state_bound,
                         en_input_bound, relaxation_alpha, check_termination,
                         warm_start, carry_out,
                         constraints: FusedConstraints | None = None,
                         num_groups: int = 1, precision: str = "highest",
                         bf16_head_iters: int = 0):
    """Launch kernel K1 (csrc/condensed_fused.cu) on CUDA tensors; the
    arguments and results are those of ``condensed_fused_reference``.
    Raises on CPU tensors, on any dtype but float32, on non-contiguous
    inputs, on a projected stage wider than MAX_STAGE, and when the build
    or the launch fails.

    The maps' kernel-side layouts (and, for reduced iterations, the bf16
    T12) are made at every launch.
    Counts every launch in ``.launches``; those that run linear or cone
    projections (K1e) also in ``.projected_launches``, those over more than
    one group (K1d) in ``.grouped_launches`` and those with reduced
    iterations (K1c) in ``.reduced_launches``."""
    cons = constraints or _no_constraints(x0s)
    G = num_groups
    ct = check_termination
    k0 = _check_precision(precision, bf16_head_iters, max_iter, ct)
    lo_all = precision == "default"
    x0, L, tensors = _validate(maps, rho, (u_min, u_max, x_min, x_max), x0s,
                               warm, nx, nu, N, warm_start, cons, G)
    _check_cuda_inputs(tensors, 2, "the fused kernel")
    su, sx, sw = _dims(nx, nu, N)
    B = G * L
    if B == 0:
        raise ValueError("empty batch")
    dev = x0s.device
    reduced = bool(k0 or lo_all)
    state_free = _state_free(en_state_bound, cons)
    plan = fused_tile_plan(nx, nu, N, reduced, state_free)
    side_u = _side_args(cons.lin_u, cons.cones_u, nu, "input")
    side_x = _side_args(cons.lin_x, cons.cones_x, nx, "state")

    f32 = dict(dtype=torch.float32, device=dev)
    t12t, t12lo, t12c, tx0, t1c = map_layout(maps, nx, su, sw, reduced,
                                             plan)
    rho_t = torch.as_tensor(rho, **f32).reshape(-1).contiguous()
    xout = torch.empty((sx, B), **f32)
    uout = torch.empty((su, B), **f32)
    iters = torch.empty((B,), dtype=torch.int32, device=dev)
    solved = torch.empty((B,), dtype=torch.int32, device=dev)
    y = torch.empty((su, B), **f32)
    if state_free:  # the kernel never touches g; the carry reports zeros
        g = torch.zeros((sx, B), **f32) if carry_out else None
    else:
        g = torch.empty((sx, B), **f32)
    # the rollout constant's scratch, where the state is not in shared memory
    uxc = None if plan.state_shared else torch.empty((sw, B), **f32)
    w2o = torch.empty((sw, B), **f32) if carry_out else None
    # the sums of all but the last pass of a wide map's product
    park = torch.empty((sw, B), **f32) if plan.passes > 1 else None
    vco = torch.empty((sx, B), **f32) if carry_out else None
    zco = torch.empty((su, B), **f32) if carry_out else None
    w = warm if warm is not None else FusedCarry(None, None, None, None, None)

    fn = _kernel_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(_ptr(t12t), _ptr(t12lo), _ptr(t12c), _ptr(tx0), _ptr(t1c),
                 _ptr(rho_t), _ptr(u_min), _ptr(u_max), _ptr(x_min),
                 _ptr(x_max), _ptr(x0), _ptr(w.w2), _ptr(w.y),
                 None if state_free else _ptr(w.g), _ptr(w.v), _ptr(w.z),
                 _ptr(xout), _ptr(uout), _ptr(iters), _ptr(solved),
                 _ptr(y), None if state_free else _ptr(g), _ptr(uxc),
                 _ptr(w2o), _ptr(vco), _ptr(zco), _ptr(park),
                 nx, nu, N, G, L, max_iter, ct, k0, int(lo_all),
                 relaxation_alpha, 1.0 - relaxation_alpha,
                 abs_pri_tol, abs_dua_tol, int(en_input_bound),
                 int(en_state_bound), int(warm_start), int(carry_out),
                 int(plan.state_shared), int(plan.resident), plan.rpt,
                 plan.rows, plan.kp, plan.smem,
                 int(maps.T12.ndim == 3), int(rho_t.numel() > 1),
                 int(G > 1 and u_min.numel() == G * su),
                 int(G > 1 and x_min.numel() == G * sx),
                 *side_u, *side_x, stream)
    if err != 0:
        raise RuntimeError(f"condensed_fused kernel launch failed: CUDA "
                           f"error {err}")
    condensed_fused_cuda.launches += 1
    if side_u[1] or side_u[4] or side_x[1] or side_x[4]:
        condensed_fused_cuda.projected_launches += 1
    if G > 1:
        condensed_fused_cuda.grouped_launches += 1
    if reduced:
        condensed_fused_cuda.reduced_launches += 1
    out = (xout.T.reshape(B, N, nx), uout.T.reshape(B, N - 1, nu), iters,
           solved)
    if carry_out:
        return out + (FusedCarry(w2o, y, g, vco, zco),)
    return out


condensed_fused_cuda.launches = 0
condensed_fused_cuda.projected_launches = 0
condensed_fused_cuda.grouped_launches = 0
condensed_fused_cuda.reduced_launches = 0


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

    With ``num_groups=G`` the launch solves G distinct problems: ``maps``
    carry a leading group axis (``build_condensed`` on G-stacked problems),
    ``rho`` is (G,), the bounds may gain a leading G axis and ``x0s`` is
    (G, L, nx) (or flat, lane = g*L + l).  Results and carries keep the
    flat lane order, B = G*L.

    Constraints beyond the box, in the JAX factory's form, composed box ->
    linear -> SOC on every stage: ``soc_u``/``soc_x`` tuples of ``(start,
    dim, mu)`` scaled SOCs (``mu`` a float, a 0-d tensor, or (G,) per-group
    values), ``lin_u``/``lin_x`` ``(Alin (m, dim), blin (m,))`` cyclic
    halfspaces (either with a leading G axis for per-group rows).  They are
    moved to the solve's device at its first call on that device.

    ``precision="default"`` computes ``T12w @ w2`` as one bf16 pass (both
    operands rounded to bf16, products summed in fp32) on every iteration;
    ``bf16_head_iters=k0`` does so on iterations 0..k0-1 only, which skip
    the residual check except on iteration k0-1, and continues at
    ``precision`` with the ``check_termination`` cadence and cumulative
    iteration counts: a (k0, check_termination=k0, "default", carry out)
    solve chained into a warm one.  In either mode an iteration that runs
    the check computes its product in full precision."""
    ct = check_termination
    if ct < 1 or max_iter % ct != 0:
        raise ValueError(
            "check_termination must be >= 1 and divide max_iter on the fused "
            f"kernel (got check_termination={ct}, max_iter={max_iter})")
    k0 = _check_precision(precision, bf16_head_iters, max_iter, ct)
    if num_groups < 1:
        raise ValueError(f"num_groups must be >= 1 (got {num_groups})")
    kw = dict(nx=nx, nu=nu, N=N, max_iter=max_iter, abs_pri_tol=abs_pri_tol,
              abs_dua_tol=abs_dua_tol, en_state_bound=en_state_bound,
              en_input_bound=en_input_bound,
              relaxation_alpha=relaxation_alpha, check_termination=ct,
              warm_start=warm_start, carry_out=carry_out,
              num_groups=num_groups, precision=precision,
              bf16_head_iters=k0)

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
                device=x0s.device, num_groups=num_groups)
        return fn(maps, rho, u_min, u_max, x_min, x_max, x0s, warm,
                  constraints=constraints[key], **kw)

    return solve_fn
