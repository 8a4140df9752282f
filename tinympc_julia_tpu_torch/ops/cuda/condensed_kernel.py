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
# bf16 map's k padded to a multiple of 32.  MAX_TILE is the adaptive
# kernel's largest tile.  Where a tile's w2 leaves no room, a thread block
# cluster of CLUSTER_SIZES blocks shares the tile, each block a slice of
# whole stages (CLUSTER_RPT rows a thread, its rows of w2 in its own shared
# memory, CLUSTER_META bytes for the cluster's residual maxima and its
# input's addresses); where even a cluster of 8's slices leave no room,
# tiles whose w2 lives in global memory and streams beside the map
# (W2_GLOBAL_RPT rows a thread), whose shared memory does not grow with the
# map's width.  The projections work on a stage of any width and take any
# number of cones.
SMEM_PER_BLOCK = 232448
MAX_TILE = 128
TILE = 32
THREADS = 256
TILE_ROW_GROUPS = 16
TILE_RPTS = (8, 20, 32)
W2_GLOBAL_RPT = 32
CLUSTER_RPT = 32
CLUSTER_SIZES = (2, 3, 4, 5, 6, 7, 8)
CLUSTER_META = 3 * 16 * 32 + 2 * 256
# The SMs an NVIDIA H100 80GB HBM3 keeps busy with clusters of each size at
# one block an SM (cudaOccupancyMaxActiveClusters x the size; a cluster's
# blocks share a GPC): what the plan weighs a cluster size by off the card
# (the CPU plan tests); a launch asks the card's occupancy API instead
# (``card_busy_sms``)
CLUSTER_SMS = {2: 132, 3: 117, 4: 120, 5: 110, 6: 102, 7: 105, 8: 120}
# the width (rows of w2) from which K1 takes the cluster layout even where
# w2 fits in shared memory with 2 lanes a thread: the quadrotor's N = 57,
# where the cluster first beat those plans on the card (PERF.md section 6,
# R11); the 4-lane layout in passes (``four_lane_tile_plan``) beat the
# cluster at every width it takes where the launch's tiles keep the card
# busy (the quadrotor's N = 56-81 at 96-512 tiles: 1.23-1.94x), and lost to
# it where they leave half the SMs idle (``few_tiles``; N = 57-60 at 32-64
# tiles: 1.48-1.51x; a cluster of 3 at N = 64-81: 1.81-2.25x at 32 tiles,
# 0.96-1.19x at 64: PERF.md section 6, R18), so from here it takes only
# launches of the former
CLUSTER_FROM_WIDTH = 908
# The 4-lane layout (ROADMAP R5, R18): a plan of tiles of 32 lanes that
# streams its map at 20 or 32 rows a thread takes 10 rows x 4 lanes a
# thread in the fp32 product (TilePlan.lanes), in passes of W = 16 x
# LANES4_RPT = 320 rows, the map laid out pass by pass (``pass_rows``,
# ``_pass_major``), slabs of 16 k-rows of a pass by the bulk copy engine
# with no block barrier a slab, and a checking iteration's box residuals
# and updates in one pass (csrc/condensed_fused.cu); in one pass it beat 2
# lanes a thread at a continuation's 192 tiles and a bulk launch's 1,536,
# in passes at every width measured, at 32-512 tiles, also where 2 lanes
# take fewer passes (one of 512 rows at sw 321-512, two of 512 at sw
# 641-907: PERF.md section 6), so against 2 lanes it depends neither on
# the batch nor on the passes (against the cluster: CLUSTER_FROM_WIDTH).
LANES4_RPT = 20
# static shared memory of a kernel whose ring the bulk copy engine fills
# (csrc/tile_gemm.cuh RingBars, rounded up to 16 bytes): the dynamic
# shared memory such a launch may take is SMEM_PER_BLOCK less it
RING_BARS_BYTES = 112
# The warp layout (ROADMAP R3, csrc/condensed_fused.cu): a map of at most
# WARP_ROWS rows, fp32, box constraints only, of at most WARP_MAX_GROUPS
# groups, takes lane groups of WARP_LANES lanes owned by warps, up to
# MAX_WARPS a block beside the group's map and bounds in shared memory
# (WARP_STATIC_BYTES of static shared memory), each thread of the product
# 8 rows x 4 lanes, the lanes' w2 and state in the warp's own slice of
# shared memory; a warp takes its next lane group from its group's queue.
# MAX_WARPS keeps the instance's registers within 255 a thread (12 or 16
# warps a block spilled: PERF.md section 6).  MIN_WARPS: the fewest warps
# a block for which the plan takes it.
WARP_LANES = 8
WARP_ROWS = 128
MAX_WARPS = 8
MIN_WARPS = 4
WARP_MAX_GROUPS = 1024
WARP_STATIC_BYTES = 16
SLAB_K = 8
STAGES = 6
SLAB_K_LO = 16
STAGES_LO = 4
KP_ALIGN = 32
PAD_LO = 8
MMA_N = 8


class TilePlan(NamedTuple):
    """The launch layout of one K1 launch."""
    tile: int           # lanes per block
    threads: int        # threads per block
    resident: bool      # T12 staged whole in shared memory (else streamed)
    state_shared: bool  # the lanes' solver state in shared memory
    rows: int           # padded rows of the transposed map (swp)
    kp: int             # padded k of the bf16 map of reduced iterations
    smem: int           # dynamic shared memory of one block, bytes
    passes: int = 1     # a block's passes of rows / (cluster x passes) map
                        # rows (the product's 16 thread rows x the rows a
                        # thread)
    w2_global: bool = False  # the tiles' w2 in global memory, streamed
                             # beside the map
    cluster: int = 1    # blocks a tile (a thread block cluster where > 1)
    stages: tuple = ()  # cluster + 1 bounds: block c owns stages
                        # [stages[c], stages[c + 1]) of the N - 1 input
                        # stages then the N state stages
    lanes: int = 2      # lanes a thread of the fp32 product (2 rpt / lanes
                        # rows); 4: the 4-lane layout (LANES4_RPT), or
                        # the warp layout's 8 rows x 4 lanes
    warps: int = 0      # the warp layout: the most warps a block (lane
                        # groups of ``tile`` lanes, a warp each); 0: tiles

    @property
    def rpt(self) -> int:
        """Rows a thread of the product (the kernel's instance)."""
        if self.bulk_ring:  # its last pass padded only to a thread's rows
            return LANES4_RPT
        return self.rows // (self.cluster * self.passes * TILE_ROW_GROUPS)

    @property
    def width(self) -> int:
        """Rows of a pass of the product (the threads' rows at once)."""
        return TILE_ROW_GROUPS * self.rpt

    @property
    def slab_k(self) -> int:
        """k-rows of a slab of the fp32 product's ring (16 in 3 slots on a
        cluster or with more than 2 lanes a thread, else 8 in 6)."""
        return 16 if self.cluster > 1 or self.lanes > 2 else 8

    @property
    def bulk_ring(self) -> bool:
        """The fp32 product's ring filled by the bulk copy engine with no
        block barrier a slab (the 4-lane layout's)."""
        return self.lanes == 4 and not self.warps


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


def ring_bytes(width: int, reduced: bool, w_lanes: int = 0) -> int:
    """The slab ring of a streamed product of ``width`` rows at once
    (csrc/tile_gemm.cuh): STAGES fp32 slabs of SLAB_K k-rows, or with
    reduced iterations the larger of that and STAGES_LO bf16 slabs of
    SLAB_K_LO columns (rows padded by PAD_LO); each slab with the k-rows of
    ``w_lanes`` lanes of the product's input beside it where that streams
    too."""
    ring = 4 * STAGES * SLAB_K * (width + w_lanes)
    if reduced:
        ring = max(ring, 2 * STAGES_LO * (width + w_lanes)
                   * (SLAB_K_LO + PAD_LO))
    return ring


def bulk_rows(v: int, rows: int) -> int:
    """The padded rows of a map that the bulk copy engine streams in one
    pass (csrc/tile_gemm.cuh bulk_rows): ``v`` valid rows rounded
    up to a multiple of a thread's ``rows`` (its last rows read inside the
    slab's row), then of 4 (16-byte rows)."""
    return -(-(-(-v // rows) * rows) // 4) * 4


def pass_rows(v: int, rows: int, width: int | None = None) -> int:
    """The padded rows of a map of ``v`` valid rows laid out pass by pass
    (csrc/tile_gemm.cuh pass_rows): every pass but the last
    ``width`` rows, the last its valid rows padded (``bulk_rows``); one
    pass where ``width`` is None."""
    full = 0 if width is None else (-(-v // width) - 1) * width
    return full + bulk_rows(v - full, rows)


def _pass_major(m: torch.Tensor, width: int, ld: int) -> torch.Tensor:
    """A transposed map (..., K, v) laid out pass by pass, (..., K x ld):
    pass p's [k][row] block of its rows [p width, (p + 1) width) after the
    earlier passes', every pass but the last ``width`` rows wide, the last
    the rest of the ``ld`` padded rows (``pass_rows``); padding zero."""
    K, v = m.shape[-2:]
    out = m.new_zeros(m.shape[:-2] + (K * ld,))
    off = 0
    for a in range(0, v, width):
        b = min(v, a + width)
        rows = width if b < v else ld - a
        out.narrow(-1, off, K * rows).unflatten(-1, (K, rows))[
            ..., :b - a] = m[..., a:b]
        off += K * rows
    return out


def tile_smem(sw: int, rows: int, kp: int, state: int, resident: bool,
              reduced: bool, passes: int = 1,
              w2_global: bool = False, width: int | None = None) -> int:
    """One block's shared memory (csrc/condensed_fused.cu tile_layout): the
    tile's w2 (sw x 32 floats; none where it lives in global memory), the
    latch flags, the residual partials of the lanes' threads, the lanes'
    solver state (``state`` floats a lane, 0 where it stays in global
    memory), the map (resident: fp32, and bf16 with reduced iterations;
    streamed: the slab ring of one pass of ``width`` rows, by default rows
    / passes, with the tile's w2 rows beside each slab where w2 is
    global), the bf16 w2 of reduced iterations ([lane][k], rows padded;
    global with w2)."""
    n = ((0 if w2_global else _up16(4 * sw * TILE)) + _up16(4 * (TILE + 1))
         + _up16(16 * THREADS) + _up16(4 * state * TILE))
    if resident:
        n += _up16(4 * sw * rows)
        if reduced:
            n += _up16(2 * rows * (kp + PAD_LO))
    else:
        n += _up16(ring_bytes(width or rows // passes, reduced,
                              TILE if w2_global else 0))
    if reduced and not w2_global:
        n += _up16(2 * TILE * (kp + PAD_LO))
    return n


def stage_slices(nx: int, nu: int, N: int, blocks: int) -> tuple | None:
    """The stage bounds of a cluster of ``blocks``: block c owns stages
    [b[c], b[c + 1]) of the N - 1 input stages then the N state stages
    (nu and nx rows each), whole stages, each block at least one, the rows
    as even as the stages allow.  None where there are fewer stages than
    blocks."""
    widths = [nu] * (N - 1) + [nx] * N
    if len(widths) < blocks:
        return None
    starts = [0]
    for w in widths:
        starts.append(starts[-1] + w)
    sw = starts[-1]
    bounds = [0]
    for c in range(1, blocks):
        lo, hi = bounds[-1] + 1, len(widths) - (blocks - c)
        best = min(range(lo, hi + 1),
                   key=lambda b: (abs(starts[b] - c * sw / blocks), b))
        bounds.append(best)
    bounds.append(len(widths))
    return tuple(bounds)


def slice_rows(nx: int, nu: int, N: int, stages: tuple) -> list:
    """Each block's (first row, end row) of a cluster's stage bounds."""
    def row(s):
        return s * nu if s <= N - 1 else (N - 1) * nu + (s - N + 1) * nx
    return [(row(a), row(b)) for a, b in zip(stages[:-1], stages[1:])]


# What a pass of at most 4 warps' rows costs beside a full one: a pass's
# warps past its rows idle, and one busy warp a scheduler hides less of
# its loads' latency than two (fitted to launches measured on an H100,
# PERF.md section 6: K1, its map by the bulk copy engine, and K2; one
# value for both would move the cluster size of hundreds of widths off
# the one measured there)
HALF_PASS = 0.75
K2_HALF_PASS = 0.5


def pass_cost(rows: int, half: float = HALF_PASS) -> float:
    """What a block's passes of W = 16 CLUSTER_RPT rows over ``rows`` rows
    cost, in full passes: a last pass of at most 4 warps' rows (W / 2)
    costs ``half`` (its warps on 4 schedulers, warp w on w % 4), a longer
    one a full pass."""
    W = TILE_ROW_GROUPS * CLUSTER_RPT
    full, rest = divmod(rows, W)
    return full + (0.0 if rest == 0 else half if rest <= W // 2 else 1.0)


def cluster_smem(rows: int, reduced: bool) -> int:
    """One cluster block's shared memory (csrc/condensed_fused.cu
    tile_layout, In::kCluster): its ``rows`` rows of w2, the latch flags,
    the residual partials, the cluster's meta, the slab ring of CLUSTER_RPT
    x 16 rows with the tile's w2 rows beside each slab (the bf16 w2 of
    reduced iterations lives in global memory)."""
    W = TILE_ROW_GROUPS * CLUSTER_RPT
    return (_up16(4 * rows * TILE) + _up16(4 * (TILE + 1))
            + _up16(16 * THREADS) + CLUSTER_META
            + _up16(ring_bytes(W, reduced, TILE)))


def cluster_tile_plan(nx: int, nu: int, N: int, reduced: bool = False,
                      blocks: int | None = None,
                      busy_sms=None) -> TilePlan | None:
    """The cluster layout at this shape: ``blocks`` blocks a tile of 32
    lanes (default: of CLUSTER_SIZES whose slices fit, the one whose
    blocks' passes cost the card least, ``pass_cost`` x blocks over the SMs
    its clusters keep busy at once, then the smallest), each a slice of
    whole stages with its rows of w2 in its shared memory; its product in
    passes of W = 16 CLUSTER_RPT rows over its slice (a pass's rows past
    the slice are skipped); the state in global memory.  ``busy_sms(plan)``
    gives a candidate's busy SMs (a launch's: ``card_busy_sms``; default
    the CLUSTER_SMS table); a size the card cannot hold is passed over.
    None where the slices do not fit (or, for ``blocks``, do not exist)."""
    sw = (N - 1) * nu + N * nx
    kp = -(-sw // KP_ALIGN) * KP_ALIGN
    W = TILE_ROW_GROUPS * CLUSTER_RPT
    plans = []
    for C in ((blocks,) if blocks else CLUSTER_SIZES):
        stages = stage_slices(nx, nu, N, C)
        if stages is None:
            continue
        rows = max(b - a for a, b in slice_rows(nx, nu, N, stages))
        smem = cluster_smem(rows, reduced)
        if smem <= SMEM_PER_BLOCK:
            npass = -(-rows // W)
            plan = TilePlan(TILE, THREADS, False, False, C * npass * W, kp,
                            smem, npass, False, C, stages)
            sms = busy_sms(plan) if busy_sms else CLUSTER_SMS[C]
            if sms:
                plans.append((pass_cost(rows) * C / sms, C, plan))
    return min(plans, default=(None, None, None))[2]


def global_tile_plan(nx: int, nu: int, N: int,
                     reduced: bool = False) -> TilePlan:
    """The layout with the tiles' w2 in global memory, streamed beside the
    map (W2_GLOBAL_RPT rows a thread, the state in global memory): its
    shared memory does not depend on the width, so it holds any (a launch
    needs (sw, B) floats of global memory for w2)."""
    sw = (N - 1) * nu + N * nx
    kp = -(-sw // KP_ALIGN) * KP_ALIGN
    npass = -(-sw // (TILE_ROW_GROUPS * W2_GLOBAL_RPT))
    rows = npass * TILE_ROW_GROUPS * W2_GLOBAL_RPT
    smem = tile_smem(sw, rows, kp, 0, False, reduced, npass, True)
    assert smem <= SMEM_PER_BLOCK  # independent of sw
    return TilePlan(TILE, THREADS, False, False, rows, kp, smem, npass, True)


def shared_tile_plan(nx: int, nu: int, N: int, reduced: bool = False,
                     state_free: bool = True) -> TilePlan | None:
    """The layout with the tile's w2 in one block's shared memory (None
    where it does not fit): the rows a thread, the instance that covers the
    map in the fewest passes of 16 RPT rows, padding it the least; where no
    layout of it fits, the next.  Within one: the lanes' solver state in
    shared memory where it fits, then T12 resident where it fits beside it
    and streamed in slabs otherwise."""
    sw = (N - 1) * nu + N * nx
    kp = -(-sw // KP_ALIGN) * KP_ALIGN
    state = state_floats(nx, nu, N, state_free)

    def passes(rpt):
        return -(-sw // (TILE_ROW_GROUPS * rpt))

    for rpt in sorted(TILE_RPTS, key=lambda r: (passes(r), passes(r) * r)):
        npass = passes(rpt)
        rows = npass * TILE_ROW_GROUPS * rpt
        for shared in (True, False):
            for resident in (True, False):
                smem = tile_smem(sw, rows, kp, state if shared else 0,
                                 resident, reduced, npass)
                if smem <= SMEM_PER_BLOCK:
                    return TilePlan(TILE, THREADS, resident, shared, rows,
                                    kp, smem, npass)
    return None


def warp_smem(sw: int, state: int, warps: int) -> int:
    """One warp-layout block's shared memory (csrc/condensed_fused.cu
    warp_smem): the map (sw x WARP_ROWS floats), the box bounds (2 sw
    floats, whole 16-byte pieces), then each warp's w2 (WARP_ROWS x
    WARP_LANES floats) and its lanes' solver state (``state`` floats a
    lane)."""
    return 4 * (sw * WARP_ROWS + -(-2 * sw // 4) * 4
                + warps * WARP_LANES * (WARP_ROWS + state))


def warp_tile_plan(nx: int, nu: int, N: int,
                   state_free: bool = True) -> TilePlan | None:
    """The warp layout at this shape: lane groups of WARP_LANES lanes, a
    warp each, as many warps a block (up to MAX_WARPS) as fit beside the
    resident map, the lanes' w2 and state in shared memory (with room for
    the carry a lane of a launch with a carry out stages there: 2 sw floats
    more a lane), one pass of WARP_ROWS rows.  For fp32 launches with box
    constraints only; None where the map is wider than WARP_ROWS or fewer
    than MIN_WARPS warps fit."""
    sw = (N - 1) * nu + N * nx
    if sw > WARP_ROWS:
        return None
    state = state_floats(nx, nu, N, state_free) + 2 * sw
    cap = SMEM_PER_BLOCK - WARP_STATIC_BYTES
    warps = min(MAX_WARPS, (cap - warp_smem(sw, state, 0))
                // (4 * WARP_LANES * (WARP_ROWS + state)))
    if warps < MIN_WARPS:
        return None
    kp = -(-sw // KP_ALIGN) * KP_ALIGN
    return TilePlan(WARP_LANES, 32 * warps, True, True, WARP_ROWS, kp,
                    warp_smem(sw, state, warps), lanes=4, warps=warps)


def four_lane_tile_plan(nx: int, nu: int, N: int, reduced: bool = False,
                        state_free: bool = True) -> TilePlan | None:
    """The 4-lane layout at this shape, where the plan of tiles of 32 lanes
    with w2 in shared memory (``shared_tile_plan``) streams its map at 20
    or 32 rows a thread: 10 rows x 4 lanes a thread in the fp32 product,
    ceil(sw / 320) passes of 320 rows, the map laid out pass by pass with
    the last pass's rows padded to a thread's (``pass_rows``), the ring
    filled by the bulk copy engine (its slots one pass wide), the lanes'
    state in shared memory where it fits, and room left for the ring's
    barriers (RING_BARS_BYTES).  None where that plan is another or the
    layout does not fit."""
    sw = (N - 1) * nu + N * nx
    two = shared_tile_plan(nx, nu, N, reduced, state_free)
    if two is None or two.resident or two.rpt not in (LANES4_RPT, 32):
        return None
    W = TILE_ROW_GROUPS * LANES4_RPT
    npass = -(-sw // W)
    rows = pass_rows(sw, 2 * LANES4_RPT // 4, W)
    state = state_floats(nx, nu, N, state_free)
    for shared in (True, False):
        smem = tile_smem(sw, rows, two.kp, state if shared else 0, False,
                         reduced, npass, width=W)
        if smem <= SMEM_PER_BLOCK - RING_BARS_BYTES:
            return TilePlan(TILE, THREADS, False, shared, rows, two.kp,
                            smem, npass, lanes=4)
    return None


def few_tiles(tiles: int, sms: int) -> bool:
    """Whether a launch of ``tiles`` tiles of 32 lanes, a block each,
    leaves half or more of the card's ``sms`` SMs idle (2 x ``tiles`` <=
    ``sms``), so that a cluster of 2 blocks a tile runs on SMs that the
    tiles would leave idle."""
    return 2 * tiles <= sms


def fused_tile_plan(nx: int, nu: int, N: int, reduced: bool = False,
                    state_free: bool = True, busy_sms=None,
                    projected: bool = False, groups: int = 1,
                    tiles: int | None = None,
                    sms: int | None = None) -> TilePlan:
    """The layout of a launch at this shape (``reduced``: with
    reduced-precision iterations; ``state_free``: no state-side
    constraint, so no state dual; ``busy_sms``: as ``cluster_tile_plan``'s;
    ``projected``: with halfspaces or cones; ``groups``: G) and batch
    (``tiles``: the launch's tiles of 32 lanes, G x ceil(L / 32); None: a
    batch that fills the card; ``sms``: the card's SMs, needed with
    ``tiles``).  An fp32
    launch with box constraints only whose map has at most WARP_ROWS rows,
    of at most WARP_MAX_GROUPS groups, takes the warp layout
    (``warp_tile_plan``: lane groups of 8 lanes, a warp each, a queue of
    lane groups a group), at every batch; reduced iterations (K1c: phase
    6's staged pipeline, ``phase1_bf16``), projections (K1e: the rocket)
    and every wider map keep the tiles.
    Where tiles of 32 lanes with w2 in shared memory stream the map
    (``four_lane_tile_plan``), 4 lanes a thread in passes of 320 rows (the
    4-lane layout), from CLUSTER_FROM_WIDTH only for a launch whose tiles
    keep the card busy (not ``few_tiles``); else below CLUSTER_FROM_WIDTH,
    tiles of 32 lanes with w2 in shared memory and 2 lanes a thread
    (``shared_tile_plan``) where that fits; from there, or
    where w2 does not fit, the tile split over a thread block cluster
    (``cluster_tile_plan``; every width of the JAX package's condensed
    budget); where even a cluster of 8's slices do not fit, w2 in global
    memory (``global_tile_plan``), so every width has a plan."""
    if tiles is not None and sms is None:
        raise ValueError("a plan for a batch (tiles) needs the card's SMs")
    sw = (N - 1) * nu + N * nx
    if not reduced and not projected and groups <= WARP_MAX_GROUPS:
        plan = warp_tile_plan(nx, nu, N, state_free)
        if plan is not None:
            return plan
    plan = None
    if sw < CLUSTER_FROM_WIDTH or tiles is None \
            or not few_tiles(tiles, sms):
        plan = four_lane_tile_plan(nx, nu, N, reduced, state_free)
    if plan is None and sw < CLUSTER_FROM_WIDTH:
        plan = shared_tile_plan(nx, nu, N, reduced, state_free)
    if plan is None:
        plan = cluster_tile_plan(nx, nu, N, reduced, busy_sms=busy_sms)
    return plan if plan is not None else global_tile_plan(nx, nu, N, reduced)


def constraint_bytes(cons: FusedConstraints, nx: int, nu: int) -> int:
    """Bytes of a block's copy of one group's constraint data in shared
    memory (csrc/projections.cuh constraint_bytes): both sides' cone
    pairs and mu, then their halfspace rows."""
    nc = cons.cones_u.num_cones + cons.cones_x.num_cones
    nl = sum(int(rows.shape[-2]) * (2 * n + 1)
             for rows, n in ((cons.lin_u, nu), (cons.lin_x, nx))
             if rows is not None)
    return (_up16(8 * nc) + _up16(4 * nc) if nc else 0) + _up16(4 * nl)


def launch_smem(plan: TilePlan, dim_x: int, dim_u: int,
                data: int = 0) -> tuple[int, bool]:
    """A launch's shared memory and whether its projected stages are
    projected there: each thread's own buffer of the widest projected
    side's stage (``dim_x``, ``dim_u``: the stage widths of the projected
    sides, 0 for a side without halfspaces or cones) after the plan's
    layout, where that fits; else the stages are projected in the lanes'
    rows of a global scratch.  The constraint data (``data`` bytes,
    ``constraint_bytes``) follows where it fits; the kernel reads the device
    arrays where the launch leaves it no room."""
    cap = SMEM_PER_BLOCK - (RING_BARS_BYTES if plan.bulk_ring else 0)
    stage = 4 * THREADS * max(dim_x, dim_u)
    kept = stage > 0 and plan.smem + stage <= cap
    smem = plan.smem + (stage if kept else 0)
    if smem + data <= cap:
        smem += data
    return smem, kept


def tile_iterations(counts: torch.Tensor, tile: int, groups: int = 1) -> int:
    """Iterations summed over a launch's tiles (``tile`` lanes of one group,
    a block each; the warp layout's lane groups) from the lanes' iteration
    counts: a tile runs until its last lane latches."""
    return int(_tile_counts(counts, tile, groups).sum())


def _tile_counts(counts, tile, groups):
    """(groups, tiles) iterations of each tile (its slowest lane)."""
    per = counts.reshape(groups, -1)
    per = torch.nn.functional.pad(per, (0, -per.shape[1] % tile))
    return per.reshape(groups, -1, tile).amax(dim=2)


def launch_warps(plan: TilePlan, per_group: int, sms: int,
                 per_sm: int = 1) -> tuple[int, int]:
    """(blocks a group X, warps a block) of a warp-layout launch whose
    groups have ``per_group`` lane groups each, on a card of ``sms`` SMs
    holding ``per_sm`` blocks of ``plan.warps`` warps each
    (csrc/condensed_fused.cu launch_warps): as many blocks a group as the
    card holds at once, no more than a group's lane groups, each of at
    most ``plan.warps`` warps and no more than a group's lane groups share
    out over its blocks."""
    blocks = min(per_group, max(per_sm, 1) * sms)
    return blocks, min(plan.warps, -(-per_group // blocks))


def queue_iterations(counts: torch.Tensor, groups: int, blocks: int,
                     warps: int, slots: int | None = None,
                     lanes: int = WARP_LANES) -> int:
    """A model of the warp layout's queues: the iterations of the launch's
    critical path from the lanes' iteration counts, a lane group's time its
    slowest lane's count.  The grid is ``blocks`` blocks a group of
    ``warps`` warps, started group by group as ``slots`` block slots free
    (default: all at once); a block's warps each take a ticket of its
    group as it starts, stage the map (one iteration, where a warp got a
    ticket) and take the next as they free; a block ends with its last
    warp."""
    import heapq
    per = _tile_counts(counts, lanes, groups)
    per_g = per.shape[1]
    per = per.tolist()
    order = [(g, x) for g in range(groups) for x in range(blocks)]
    nxt = [0] * groups
    live = {}
    events = []
    end = 0
    started = 0

    def take(g):
        if nxt[g] >= per_g:
            return None
        nxt[g] += 1
        return per[g][nxt[g] - 1]

    def start(t):
        """The next block takes the slot freed at t."""
        nonlocal started, end
        while started < len(order):
            b = started
            started += 1
            got = [c for c in (take(order[b][0]) for _ in range(warps))
                   if c is not None]
            if got:
                live[b] = len(got)
                for c in got:
                    heapq.heappush(events, (t + 1 + c, b))
                return
            end = max(end, t)

    for _ in range(min(slots or len(order), len(order))):
        start(0)
    while events:
        t, b = heapq.heappop(events)
        c = take(order[b][0])
        if c is not None:
            heapq.heappush(events, (t + c, b))
            continue
        end = max(end, t)
        live[b] -= 1
        if live[b] == 0:
            start(t)
    return int(end)


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
# one side's constraints: halfspace rows (device), their count, the cones'
# (start, dim) pairs (device), the cones' mu (device), the cone count, and
# whether the rows and the mus carry a leading group axis
_SIDE = [_PTR, _INT, _PTR, _PTR, _INT, _INT, _INT]
_ARGTYPES = ([_PTR] * 30 + [_INT] * 9 + [_FLT] * 4 + [_INT] * 8 + [_PTR]
             + [_INT] * 10 + _SIDE + _SIDE + [_PTR])


@functools.cache
def _kernel_fn():
    fn = load_library("condensed_fused").lib.tinympc_condensed_fused
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def stage_bounds_arg(stages: tuple):
    """A cluster's stage bounds as the C entry points read them (a host
    int array; None without a cluster)."""
    return (ctypes.c_int * len(stages))(*stages) if stages else None


def tile_occupancy(plan: TilePlan, proj_u: bool = False,
                   proj_x: bool = False, smem: int | None = None) -> int:
    """Blocks an SM of the plan's instance (the occupancy API), or for a
    cluster plan the clusters the card holds at once; builds the kernel.
    Raises on a CUDA error."""
    fn = load_library("condensed_fused").lib.tinympc_condensed_fused_occupancy
    fn.argtypes = [_INT] * 8
    n = fn(plan.rpt, plan.lanes, int(plan.w2_global), plan.cluster,
           int(proj_u), int(proj_x), plan.smem if smem is None else smem,
           plan.warps)
    if n < 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {-n}")
    return n


@functools.cache
def _card_sms(device: torch.device) -> int:
    """The SMs of the card ``device`` is on."""
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.cache
def card_busy_sms(plan: TilePlan) -> int:
    """The SMs a cluster plan's clusters keep busy at once on the current
    card: the occupancy API's clusters at once x the blocks a cluster
    (builds the kernel)."""
    return tile_occupancy(plan) * plan.cluster


def _ptr(t):
    return None if t is None else t.data_ptr()


def map_layout(maps: CondensedMaps, nx, su, sw, reduced: bool,
               plan: TilePlan):
    """Kernel-side layouts of the maps (``launch_layout``): T12w
    transposed with its rows zero-padded to ``plan.rows``, T12w itself in
    real bf16 (round to nearest even), row-major and zero-padded to
    (``plan.rows``, ``plan.kp``), where the launch has reduced iterations
    (else None), the rollout and constant columns as contiguous vectors; a
    leading group axis is kept.  A cluster plan lays the rows out block by
    block: block c's rows from row c x rows / cluster, each block's padded
    to its passes.  A 4-lane plan (``plan.bulk_ring``) lays the transposed
    map out pass by pass (``_pass_major``: passes of ``plan.width`` rows,
    (sw x ``plan.rows``,)), so that a slab of a pass is one bulk copy; its
    bf16 map stays row-major."""
    lead = maps.T12.shape[:-2]
    dev = maps.T12.device
    dst = src = slice(0, sw)
    if plan.cluster > 1:
        N = (sw - su) // nx
        nu = su // (N - 1)
        per = plan.rows // plan.cluster
        spans = slice_rows(nx, nu, N, plan.stages)
        src = torch.cat([torch.arange(a, b) for a, b in spans]).to(dev)
        dst = torch.cat([torch.arange(c * per, c * per + b - a)
                         for c, (a, b) in enumerate(spans)]).to(dev)
    if plan.bulk_ring:
        t12t = _pass_major(maps.T12[..., :sw].transpose(-1, -2).float(),
                           plan.width, plan.rows)
    else:
        t12t = torch.zeros(lead + (sw, plan.rows), dtype=torch.float32,
                           device=dev)
        t12t[..., dst] = maps.T12[..., :sw].transpose(-1, -2)[
            ..., src].float()
    lo = None
    if reduced:
        lo = torch.zeros(lead + (plan.rows, plan.kp), dtype=torch.bfloat16,
                         device=dev)
        lo[..., dst, :sw] = maps.T12[..., src, :sw].to(torch.bfloat16)
    return (t12t, lo, maps.T12[..., sw].contiguous(),
            maps.T1[..., su:su + nx].contiguous(),
            maps.T1[..., -1].contiguous())


def launch_layout(maps: CondensedMaps, nx: int, nu: int, N: int,
                  reduced: bool, state_free: bool, projected: bool,
                  groups: int, tiles: int | None = None,
                  sms: int | None = None):
    """A launch's plan (``fused_tile_plan``, cluster sizes from the card)
    and its maps' kernel-side layouts (``map_layout``): what
    ``condensed_fused_cuda`` makes at a launch unless it is given them."""
    su, sw = (N - 1) * nu, (N - 1) * nu + N * nx
    plan = fused_tile_plan(nx, nu, N, reduced, state_free,
                           busy_sms=card_busy_sms, projected=projected,
                           groups=groups, tiles=tiles, sms=sms)
    return plan, map_layout(maps, nx, su, sw, reduced, plan)


class LastLayout:
    """The launch plans (``fused_tile_plan``) and the maps' kernel-side
    layouts (``map_layout``) of the maps last given, kept with their
    tensors and versions (an in-place change or other maps make them
    anew): a plan by ``launch_layout``'s arguments and the plan function
    itself (a plan forced in its place too), a layout by its plan, so that
    a loop of launches on the same maps plans and lays them out once, and
    launches of other batches on the same plan share its layout: what a
    solver of ``make_condensed_fused_solver`` hands its launches
    (``layout=``)."""

    def __init__(self):
        self.maps, self.plans, self.layouts = None, {}, {}

    def __call__(self, maps: CondensedMaps, nx, nu, N, reduced, state_free,
                 projected, groups, tiles=None, sms=None):
        versions = (maps.T12._version, maps.T1._version)
        m = self.maps
        if m is None or m[0] is not maps.T12 or m[1] is not maps.T1 \
                or m[2] != versions:
            self.maps, self.plans, self.layouts = (
                (maps.T12, maps.T1, versions), {}, {})
        key = (nx, nu, N, reduced, state_free, projected, groups, tiles, sms,
               fused_tile_plan)
        plan = self.plans.get(key)
        if plan is None:
            plan = self.plans[key] = fused_tile_plan(
                nx, nu, N, reduced, state_free, busy_sms=card_busy_sms,
                projected=projected, groups=groups, tiles=tiles, sms=sms)
        lkey = (plan, nx, nu, N, reduced)
        out = self.layouts.get(lkey)
        if out is None:
            out = self.layouts[lkey] = (plan, map_layout(
                maps, nx, (N - 1) * nu, (N - 1) * nu + N * nx, reduced,
                plan))
        return out


@functools.lru_cache(maxsize=64)
def cone_pairs(starts: tuple, dims: tuple, device) -> torch.Tensor:
    """The cones' (start, dim) pairs as the kernels read them: an (n, 2)
    int32 tensor on ``device``, made once per cone structure."""
    return torch.tensor([v for c in zip(starts, dims) for v in c],
                        dtype=torch.int32, device=device).reshape(-1, 2)


def _side_args(rows, cones: ConeSet, dim: int, side: str) -> list:
    """The seven C arguments of one side's constraints (``_SIDE``): a stage
    of any width and any number of cones, each within the stage."""
    n_lin = 0 if rows is None else int(rows.shape[-2])
    n_soc = cones.num_cones
    for st, dm in zip(cones.starts, cones.dims):
        if st < 0 or dm < 2 or st + dm > dim:
            raise ValueError(f"the {side} side's cone [{st}, {st + dm}) "
                             f"does not fit a stage of {dim}")
    pairs = cone_pairs(tuple(cones.starts), tuple(cones.dims),
                       cones.mus.device) if n_soc else None
    return [_ptr(rows), n_lin, _ptr(pairs), _ptr(cones.mus) if n_soc else None,
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
                         bf16_head_iters: int = 0, layout=None):
    """Launch kernel K1 (csrc/condensed_fused.cu) on CUDA tensors; the
    arguments and results are those of ``condensed_fused_reference``.
    Raises on CPU tensors, on any dtype but float32, on non-contiguous
    inputs, and when the build or the launch fails.

    The plan and the maps' kernel-side layouts (and, for reduced
    iterations, the bf16 T12) come from ``layout`` (a function of
    ``launch_layout``'s arguments, by default ``launch_layout`` itself:
    made at the launch; ``make_condensed_fused_solver`` keeps the last).
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
    side_u = _side_args(cons.lin_u, cons.cones_u, nu, "input")
    side_x = _side_args(cons.lin_x, cons.cones_x, nx, "state")
    proj_u, proj_x = bool(side_u[1] or side_u[4]), bool(side_x[1] or side_x[4])
    projected = proj_u or proj_x
    plan, (t12t, t12lo, t12c, tx0, t1c) = (layout or launch_layout)(
        maps, nx, nu, N, reduced, state_free, projected, G,
        G * -(-L // TILE), _card_sms(dev))

    f32 = dict(dtype=torch.float32, device=dev)
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
    smem, stage_shared = launch_smem(plan, nx if proj_x else 0,
                                     nu if proj_u else 0,
                                     constraint_bytes(cons, nx, nu))
    # the projected stages' global scratch where their buffers leave no
    # room in shared memory
    wsc = (torch.empty((sw, B), **f32) if projected and not stage_shared
           else None)
    # the tiles' w2 (and its bf16 rounding, also a cluster's) where it
    # lives in global memory: each tile its own columns
    w2g = w2hg = None
    ldg = G * -(-L // plan.tile) * plan.tile
    if plan.w2_global:
        w2g = torch.empty((sw, ldg), **f32)
    if reduced and (plan.w2_global or plan.cluster > 1):
        w2hg = torch.empty((ldg, plan.kp), dtype=torch.bfloat16, device=dev)
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
                 _ptr(w2o), _ptr(vco), _ptr(zco), _ptr(park), _ptr(wsc),
                 _ptr(w2g), _ptr(w2hg),
                 nx, nu, N, G, L, max_iter, ct, k0, int(lo_all),
                 relaxation_alpha, 1.0 - relaxation_alpha,
                 abs_pri_tol, abs_dua_tol, int(en_input_bound),
                 int(en_state_bound), int(warm_start), int(carry_out),
                 int(plan.state_shared), int(plan.resident),
                 int(plan.w2_global), plan.cluster,
                 stage_bounds_arg(plan.stages), plan.rpt, plan.lanes,
                 plan.warps, plan.rows, plan.kp,
                 smem,
                 int(maps.T12.ndim == 3), int(rho_t.numel() > 1),
                 int(G > 1 and u_min.numel() == G * su),
                 int(G > 1 and x_min.numel() == G * sx),
                 *side_u, *side_x, stream)
    if err != 0:
        raise RuntimeError(f"condensed_fused kernel launch failed: CUDA "
                           f"error {err}")
    condensed_fused_cuda.launches += 1
    if projected:
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
    layout = LastLayout()

    def solve_fn(maps, rho, u_min, u_max, x_min, x_max, x0s, warm=None):
        if x0s.device.type == "cuda":
            fn = functools.partial(condensed_fused_cuda, layout=layout)
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
