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
  staying shared), lanes in the flat order ``g*L + l``; rho stays per lane;
* reduced precision (``precision="default"``): an iteration that neither
  checks nor predicts rho computes both products in one bf16 pass, both
  operands rounded to bf16 and the products summed on the tensor cores in
  k16 steps (``mma_product``, so kernel and plain version agree to the
  bit); an iteration that checks or predicts rho computes in full
  precision, so no lane latches on, and no rho is predicted from, the
  residuals of an approximate rollout.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ..condensed import (CondensedTaylorMaps, _cones_stacked,
                         _halfspaces_stacked, _osqp_residuals_stacked,
                         _sqrt_rn)
from ..rho import EPS, RHO_INTERVAL, TERM_DEADBAND, TERM_MAX_STEP
from ...utils.precision import full_fp32_matmul
from ._build import load_library
from .condensed_kernel import (CLUSTER_META, CLUSTER_SIZES, K2_HALF_PASS,
                               CLUSTER_SMS, KP_ALIGN, RING_BARS_BYTES,
                               SMEM_PER_BLOCK, THREADS,
                               TILE, FusedConstraints,
                               _check_constraints, _pass_major,
                               _check_cuda_inputs, _check_grouped_shape,
                               _dims, _flat_x0, _grouped_view,
                               _no_constraints, _ptr, _side_args,
                               _state_free, _up16, _FLT, _INT, _PTR, _SIDE,
                               bf16_round, constraint_bytes,
                               fused_constraints, mma_product,
                               pass_cost, pass_rows, ring_bytes,
                               slice_rows,
                               stage_bounds_arg, stage_slices)
from .condensed_kernel import _check_precision as _check_k1_precision

# The launch layout is decided here and passed to the kernel, which checks
# it (csrc/condensed_adaptive.cu): K1's tiles of 32 lanes on 256 threads
# (TILE, THREADS), or 16 lanes where the iterates of 32 leave no room beside
# a wide map's slab ring; the products' 512 / tile thread rows cover W =
# 512 RPT / tile rows at once, RPT one of the kernel's instances for that
# tile; a wider product runs in passes.  Where even 16 lanes' iterates
# leave no room, tiles of 32 lanes keep them in global memory and stream
# them beside the maps (K2_GLOBAL_RPT rows a thread): that layout's shared
# memory does not depend on the width.  Before that, a thread block cluster
# shares a tile of 32 lanes (K1's CLUSTER_SIZES; passes of 512 rows, the
# 4 sums of an interleaved backward row in one thread's rows), each block
# a slice of whole stages of ux and of the input stages of d.  A launch of
# few tiles takes the continuation layout (K2_CONT_RPT, below).
K2_RPTS = {32: (8, 20), 16: (8,)}
K2_GLOBAL_RPT = 20
K2_CLUSTER_RPT = 32  # K1's CLUSTER_RPT
# the width (rows of ux) from which K2 takes the cluster layout even where
# its iterates fit in shared memory: the quadrotor's N = 57, the first
# width past the 4-lane layout in passes in fp32, where a cluster of 2
# beat the tiles of 32 on 2 lanes a thread (at N = 57 and 60, 128 and 512
# tiles) as it beat the tiles of 16 from N = 76 on the card (PERF.md
# section 6, R11, R17)
K2_CLUSTER_FROM_WIDTH = 908
# The bulk-ring layouts (ROADMAP R5, R6, R17): 4 lanes a thread in the fp32
# products (csrc/condensed_adaptive.cu K2Product), each map laid out pass
# by pass, a pass's [k][row] block with its rows padded only to a thread's
# rows (``bulk_ld``), so that a slab of 16 k-rows of a pass is one copy of
# the bulk copy engine, with no block barrier a slab.  A launch whose tiles
# of 32 lanes would leave half the card's SMs idle (a continuation's slots)
# takes the continuation layout: tiles of 16 lanes, twice the blocks, each
# product one pass of K2_CONT_RPT x 32 = 512 rows over the map's valid rows
# (8 rows x 4 lanes a thread).  A batch that fills the card takes the
# 4-lane layout: tiles of 32 lanes, passes of K2_LANES4_RPT x 16 = 320 rows
# (10 rows x 4 lanes a thread) in the forward product and of 384 in the
# backward (12 x 4, whose interleaved outputs take 4 rows each).
K2_CONT_RPT = 16
K2_LANES4_RPT = 20


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


class AdaptivePlan(NamedTuple):
    """The launch layout of one K2 launch."""
    tile: int           # lanes per block
    threads: int        # threads per block
    rpt: int            # rows a thread of the products (the instance)
    passes1: int        # passes of the forward product (each T1 block)
    passes2: int        # passes of the backward product (the T2 stack)
    resident: bool      # the maps staged whole in shared memory
    state_shared: bool  # the lanes' duals and slacks in shared memory
    kp1: int            # padded k of the bf16 T1 blocks (reduced only)
    kp2: int            # padded k of the bf16 T2 stack
    smem: int           # dynamic shared memory of one block, bytes
    iterates_global: bool = False  # vec1 and ux in global memory, streamed
                                   # beside the maps
    cluster: int = 1    # blocks a tile (a thread block cluster where > 1)
    stages: tuple = ()  # cluster + 1 bounds: block c owns stages [stages[c],
                        # stages[c + 1]) of the N - 1 input stages then the
                        # N state stages (its rows of ux)
    ustages: tuple = ()  # ... and input stages [ustages[c], ustages[c +
                         # 1]) (its rows of d)
    ld: tuple = ()      # the bulk-ring layouts' (ld1, ld2): the maps'
                        # rows, pass by pass, each pass's padded to a
                        # thread's rows (``bulk_ld``)
    lanes: int = 2      # lanes a thread of the fp32 products (2 rpt / lanes
                        # rows; csrc/condensed_adaptive.cu K2Product): 4 in
                        # the bulk-ring layouts, 8 on a cluster

    @property
    def width(self) -> int:
        """Rows the products cover at once."""
        return self.rpt * 2 * self.threads // self.tile

    @property
    def width2(self) -> int:
        """Rows the backward product covers at once: the forward's at its
        own rows a thread, whole outputs of 4 interleaved rows
        (csrc/condensed_adaptive.cu K2Product::kRows2; 384 on the 4-lane
        layout, else the forward's)."""
        rows = 2 * self.rpt // self.lanes
        return self.width // rows * (-(-rows // 4) * 4)

    @property
    def ring_rows(self) -> int:
        """Rows of a slot of the fp32 products' ring: the products' rows at
        once, or on the bulk-ring layouts the widest pass a slot takes (a
        backward pass of 384 rows where the backward takes more than one,
        else its one pass's padded rows where they are more than the
        forward's 320)."""
        if not self.bulk_ring:
            return self.width
        return max(self.width,
                   self.width2 if self.passes2 > 1 else self.ld2)

    @property
    def slab_k(self) -> int:
        """k-rows of a slab of the fp32 products' ring (16 in 3 slots where
        a thread takes more than 2 lanes, else 8 in 6)."""
        return 16 if self.lanes > 2 else 8

    @property
    def bulk_ring(self) -> bool:
        """The fp32 products' ring filled by the bulk copy engine, with no
        block barrier a slab (the bulk-ring layouts')."""
        return self.lanes == 4

    @property
    def ld1(self) -> int:
        """Padded rows of each transposed T1 block (every block's; on the
        bulk-ring layouts its passes' together)."""
        return self.ld[0] if self.ld else (self.cluster * self.passes1
                                           * self.width)

    @property
    def ld2(self) -> int:
        """Padded rows of the transposed, interleaved T2 stack."""
        return self.ld[1] if self.ld else (self.cluster * self.passes2
                                           * self.width)


def adaptive_smem(nx: int, nu: int, N: int, order: int, tile: int, rpt: int,
                  passes1: int, passes2: int, resident: bool,
                  state_shared: bool, reduced: bool,
                  state_free: bool, iterates_global: bool = False,
                  ring_rows: int | None = None) -> int:
    """One block's shared memory (csrc/condensed_adaptive.cu k2_layout):
    vec1 and ux/vec2 of the tile's lanes (none where they live in global
    memory), the latch flags, the lanes' rho twice, the elementwise
    partials (12 floats a thread), the duals and slacks where resident, the
    maps (resident: fp32 and, with reduced iterations, bf16 with rows padded
    by 8; streamed: the slab ring of ``ring_rows`` rows a slab, default the
    products' rows at once (``AdaptivePlan.ring_rows``), each slab with the
    tile's rows of the product's input beside it where the iterates are
    global), the bf16 product input of reduced iterations (global with the
    iterates)."""
    su, sx, sw = _dims(nx, nu, N)
    in1, ord1 = su + nx + 1, order + 1
    W = rpt * 2 * THREADS // tile
    ld1, ld2 = passes1 * W, passes2 * W
    kp1, kp2 = _kp(in1), _kp(sw + 1)
    state = (2 * su + (1 if state_free else 2) * sx) if state_shared else 0
    wg = iterates_global
    n = ((0 if wg else _up16(4 * in1 * tile) + _up16(4 * (sw + 1) * tile))
         + _up16(4 * (tile + 1)) + _up16(8 * tile) + _up16(48 * THREADS)
         + _up16(4 * state * tile))
    if resident:
        n += _up16(4 * ord1 * in1 * ld1) + _up16(4 * (sw + 1) * ld2)
        if reduced:
            n += (_up16(2 * ord1 * ld1 * (kp1 + 8))
                  + _up16(2 * ld2 * (kp2 + 8)))
    else:
        n += _up16(ring_bytes(ring_rows or W, reduced, tile if wg else 0))
    if reduced and not wg:
        n += _up16(2 * tile * (max(kp1, kp2) + 8))
    return n


def launch_smem(plan: AdaptivePlan, sw: int, carry_out: bool,
                data: int = 0) -> tuple[int, bool]:
    """A launch's shared memory and whether it stages the lanes' carry
    slacks: the plan's layout, then, for a bulk-ring launch with a carry
    out, the tile's staged carry slacks (csrc/condensed_adaptive.cu
    carry_stage_bytes: sw rows of the tile's lanes; a checking iteration's
    box step then takes one pass and writes each lane's slack there, and a
    lane's is written out where it latches) where they fit, then the
    constraint data (``data`` bytes, ``constraint_bytes``) where it fits;
    the room for the ring's barriers stays free (RING_BARS_BYTES).  The
    kernel stages wherever the shared memory holds the slacks (as here)."""
    cap = SMEM_PER_BLOCK - (RING_BARS_BYTES if plan.bulk_ring else 0)
    stage = (_up16(4 * sw * plan.tile) if carry_out and plan.bulk_ring
             else 0)
    smem = plan.smem + (stage if plan.smem + stage <= cap else 0)
    if smem + data <= cap:
        smem += data
    return smem, stage > 0 and smem >= plan.smem + stage


def _kp(k: int) -> int:
    return -(-k // KP_ALIGN) * KP_ALIGN


def bulk_ld(su: int, sw: int, rpt: int,
            width: int | None = None) -> tuple[int, int]:
    """A bulk-ring layout's (ld1, ld2) at ``rpt`` rows a thread of the
    products: the forward map's sw rows at the 2 rpt / 4 rows of a thread
    of 4 lanes, the backward stack's 4 su at that rounded up to whole
    outputs of 4 rows (K2Product::kRows2), each in passes (``pass_rows``)
    of ``width`` rows (the forward product's rows at once; the backward's
    at its own rows a thread) or, where None, in one pass."""
    rows = rpt // 2
    rows2 = -(-rows // 4) * 4
    width2 = None if width is None else width // rows * rows2
    return (pass_rows(sw, rows, width), pass_rows(4 * su, rows2, width2))


def cluster_rows(nx: int, nu: int, N: int, stages: tuple,
                 ustages: tuple) -> tuple[int, int, int, int]:
    """A cluster's most rows a block owns: of ux and of d (the products'
    outputs), and of vec1 and ux / vec2 as it keeps them (the last block
    also x0's and the 1s)."""
    spans = slice_rows(nx, nu, N, stages)
    last = len(spans) - 1
    rows = max(b - a for a, b in spans)
    drows = max((b - a) * nu for a, b in zip(ustages[:-1], ustages[1:]))
    keep1 = max((b - a) * nu + (nx + 1 if c == last else 0)
                for c, (a, b) in enumerate(zip(ustages[:-1], ustages[1:])))
    keep2 = max(b - a + (1 if c == last else 0)
                for c, (a, b) in enumerate(spans))
    return rows, drows, keep1, keep2


def cluster_adaptive_smem(keep1: int, keep2: int, reduced: bool) -> int:
    """One cluster block's shared memory (csrc/condensed_adaptive.cu
    k2_layout, In::kCluster): its rows of vec1 and of ux / vec2, the latch
    flags, the lanes' rho twice, the elementwise partials, the cluster's
    meta, the slab ring with the tile's input rows beside each slab (the
    bf16 product input of reduced iterations lives in global memory)."""
    W = K2_CLUSTER_RPT * 2 * THREADS // TILE
    return (_up16(4 * keep1 * TILE) + _up16(4 * keep2 * TILE)
            + _up16(4 * (TILE + 1)) + _up16(8 * TILE) + _up16(48 * THREADS)
            + CLUSTER_META + _up16(ring_bytes(W, reduced, TILE)))


def cluster_adaptive_plan(nx: int, nu: int, N: int, order: int,
                          reduced: bool = False,
                          blocks: int | None = None,
                          busy_sms=None) -> AdaptivePlan | None:
    """The cluster layout at this shape: ``blocks`` blocks a tile of 32
    lanes (default: of CLUSTER_SIZES whose slices fit, the one whose
    blocks' passes of the o + 1 forward blocks and the backward stack cost
    the card least, K1's ``pass_cost`` x blocks over the SMs its clusters
    keep busy at once, then the smallest), block c the rows of ux of whole
    stages and the d rows of whole input stages, each in its shared memory
    beside its ring, K2_CLUSTER_RPT rows a thread; the state in global
    memory.  ``busy_sms(plan)`` gives a candidate's busy SMs (a launch's:
    ``card_busy_sms``; default K1's CLUSTER_SMS table); a size the card
    cannot hold is passed over.  None where the slices do not fit (or, for
    ``blocks``, do not exist)."""
    su, sx, sw = _dims(nx, nu, N)
    in1 = su + nx + 1
    W = K2_CLUSTER_RPT * 2 * THREADS // TILE
    plans = []
    for C in ((blocks,) if blocks else CLUSTER_SIZES):
        stages = stage_slices(nx, nu, N, C)
        if stages is None or N - 1 < C:
            continue
        ustages = tuple(round(c * (N - 1) / C) for c in range(C + 1))
        rows, drows, keep1, keep2 = cluster_rows(nx, nu, N, stages, ustages)
        smem = cluster_adaptive_smem(keep1, keep2, reduced)
        if smem <= SMEM_PER_BLOCK:
            plan = AdaptivePlan(
                TILE, THREADS, K2_CLUSTER_RPT, -(-rows // W),
                -(-4 * drows // W), False, False, _kp(in1), _kp(sw + 1),
                smem, False, C, stages, ustages, lanes=8)
            sms = busy_sms(plan) if busy_sms else CLUSTER_SMS[C]
            if sms:
                cost = ((order + 1) * pass_cost(rows, K2_HALF_PASS)
                        + pass_cost(4 * drows, K2_HALF_PASS)) * C / sms
                plans.append((cost, C, plan))
    return min(plans, default=(None, None, None))[2]


def continuation_adaptive_plan(nx: int, nu: int, N: int, order: int,
                               reduced: bool = False,
                               state_free: bool = True) -> AdaptivePlan | None:
    """The continuation layout at this shape: tiles of 16 lanes, each
    product one pass of K2_CONT_RPT x 32 rows (its slabs carrying only the
    map's valid rows, its maps' rows padded to a multiple of a thread's 8),
    the maps streamed, the lanes' duals and slacks in shared memory where
    they fit.  None where a product needs more than one pass or the layout
    does not fit."""
    su, sx, sw = _dims(nx, nu, N)
    tile, rpt = TILE // 2, K2_CONT_RPT
    W = rpt * 2 * THREADS // tile
    ld = bulk_ld(su, sw, rpt)
    if max(ld) > W:
        return None
    for shared in (True, False):
        smem = adaptive_smem(nx, nu, N, order, tile, rpt, 1, 1, False,
                             shared, reduced, state_free)
        if smem <= SMEM_PER_BLOCK - RING_BARS_BYTES:
            return AdaptivePlan(tile, THREADS, rpt, 1, 1, False, shared,
                                _kp(su + nx + 1), _kp(sw + 1), smem, ld=ld,
                                lanes=4)
    return None


def four_lane_adaptive_plan(nx: int, nu: int, N: int, order: int,
                            reduced: bool = False,
                            state_free: bool = True) -> AdaptivePlan | None:
    """The 4-lane layout at this shape, where the plan of tiles of 32 lanes
    (``shared_adaptive_plan``) streams its maps at K2_LANES4_RPT rows a
    thread: 4 lanes a thread in the fp32 products, passes of 10 rows x 32
    = 320 rows in the forward and 12 x 32 = 384 in the backward, the maps
    laid out pass by pass with each pass's rows padded to a thread's
    (``bulk_ld``), the ring filled by the bulk copy engine, its slots as
    wide as the widest pass (``AdaptivePlan.ring_rows``), the lanes' duals
    and slacks in shared memory where they fit, and room left for the
    ring's barriers (RING_BARS_BYTES).  None where that plan is another or
    the layout does not fit (from the quadrotor's N = 57 in fp32, sw 908:
    vec1, ux and a ring of 384-row slots)."""
    su, sx, sw = _dims(nx, nu, N)
    two = shared_adaptive_plan(nx, nu, N, order, reduced, state_free)
    if two is None or two.tile != TILE or two.rpt != K2_LANES4_RPT \
            or two.resident:
        return None
    W = two.width
    ld = bulk_ld(su, sw, K2_LANES4_RPT, W)
    plan = AdaptivePlan(TILE, THREADS, K2_LANES4_RPT, -(-sw // W), 1, False,
                        True, _kp(su + nx + 1), _kp(sw + 1), 0, ld=ld,
                        lanes=4)
    plan = plan._replace(passes2=-(-4 * su // plan.width2))
    for shared in (True, False):
        smem = adaptive_smem(nx, nu, N, order, TILE, plan.rpt, plan.passes1,
                             plan.passes2, False, shared, reduced,
                             state_free, ring_rows=plan.ring_rows)
        if smem <= SMEM_PER_BLOCK - RING_BARS_BYTES:
            return plan._replace(state_shared=shared, smem=smem)
    return None


def shared_adaptive_plan(nx: int, nu: int, N: int, order: int,
                         reduced: bool = False,
                         state_free: bool = True) -> AdaptivePlan | None:
    """The layout with the tile's iterates in one block's shared memory
    (None where none fits), 2 lanes a thread in the fp32 products (where
    its tiles of 32 stream their maps at 20 rows a thread, the 4-lane
    layout takes it over where that fits: ``four_lane_adaptive_plan``).
    Tiles of 32 lanes (a launch of
    few tiles takes the continuation layout instead:
    ``adaptive_tile_plan``; tiles of 16 in this layout's passes of 256
    rows lost there, PERF.md section 6);
    tiles of 16 where the iterates of 32 lanes leave no room beside a
    wide map's slab ring.  The rows a thread: the instance that covers the
    two products in the fewest passes (each costs a slab stream), padding
    them the least.  Within it the lanes' duals and slacks in shared memory
    where they fit, then the maps resident where they fit beside them and
    streamed through the slab ring otherwise."""
    su, sx, sw = _dims(nx, nu, N)
    in1, ord1 = su + nx + 1, order + 1

    def cost(tile, rpt):
        W = rpt * 2 * THREADS // tile
        p1, p2 = -(-sw // W), -(-4 * su // W)
        return (p1 + p2, ord1 * in1 * p1 * W + (sw + 1) * p2 * W, p1, p2)

    for tile in (TILE, TILE // 2):
        for rpt in sorted(K2_RPTS[tile], key=lambda r: cost(tile, r)):
            _, _, p1, p2 = cost(tile, rpt)
            for shared in (True, False):
                for resident in (True, False):
                    smem = adaptive_smem(nx, nu, N, order, tile, rpt, p1, p2,
                                         resident, shared, reduced,
                                         state_free)
                    if smem <= SMEM_PER_BLOCK:
                        return AdaptivePlan(tile, THREADS, rpt, p1, p2,
                                            resident, shared, _kp(in1),
                                            _kp(sw + 1), smem)
    return None


def global_adaptive_plan(nx: int, nu: int, N: int, order: int,
                         reduced: bool = False,
                         state_free: bool = True) -> AdaptivePlan:
    """Tiles of 32 lanes whose iterates live in global memory and stream
    beside the maps (K2_GLOBAL_RPT rows a thread): that layout's shared
    memory does not depend on the width, so it holds any (a launch needs
    (in1 + sw + 1, B) floats of global memory for the iterates)."""
    su, sx, sw = _dims(nx, nu, N)
    in1 = su + nx + 1
    W = K2_GLOBAL_RPT * 2 * THREADS // TILE
    p1, p2 = -(-sw // W), -(-4 * su // W)
    smem = adaptive_smem(nx, nu, N, order, TILE, K2_GLOBAL_RPT, p1, p2,
                         False, False, reduced, state_free, True)
    assert smem <= SMEM_PER_BLOCK  # independent of sw
    return AdaptivePlan(TILE, THREADS, K2_GLOBAL_RPT, p1, p2, False, False,
                        _kp(in1), _kp(sw + 1), smem, True)


def adaptive_tile_plan(nx: int, nu: int, N: int, order: int,
                       reduced: bool = False, state_free: bool = True,
                       busy_sms=None, tiles: int | None = None,
                       sms: int | None = None) -> AdaptivePlan:
    """The layout of a launch at this shape (``reduced``: with
    reduced-precision iterations; ``state_free``: no state dual;
    ``busy_sms``: as ``cluster_adaptive_plan``'s) and batch (``tiles``: the
    launch's tiles of 32 lanes, G x ceil(L / 32); None: a batch that fills
    the card; ``sms``: the card's SMs, needed with ``tiles``).  Below
    K2_CLUSTER_FROM_WIDTH rows, the iterates in shared memory
    (``shared_adaptive_plan``) where they fit, and there, for a launch
    whose tiles of 32 would leave half the SMs idle (2 x ``tiles`` <=
    ``sms``) and stream their maps, the continuation layout
    (``continuation_adaptive_plan``) where its products take one pass and
    the tiles of 32 would take K2_LANES4_RPT rows a thread (it won at
    every such width measured, down to sw 105: PERF.md section 6; a map
    narrow enough for 8 rows a thread keeps its tiles); at any other batch, where the tiles of 32 stream their
    maps at 20 rows a thread, the 4-lane layout in one pass or more
    (``four_lane_adaptive_plan``: in one pass it beat the continuation
    layout from 72 tiles of 32 on, and 2 lanes a thread at every batch
    measured; in passes: PERF.md section 6);
    from K2_CLUSTER_FROM_WIDTH, or where the iterates do not fit, the tile
    of 32 split over a thread block cluster (``cluster_adaptive_plan``:
    every width of the JAX package's condensed budget); where even a
    cluster of 8's slices do not fit, the iterates in global memory
    (``global_adaptive_plan``), so every width has a plan."""
    if tiles is not None and sms is None:
        raise ValueError("a plan for a batch (tiles) needs the card's SMs")
    sw = _dims(nx, nu, N)[2]
    plan = (shared_adaptive_plan(nx, nu, N, order, reduced, state_free)
            if sw < K2_CLUSTER_FROM_WIDTH else None)
    if plan is not None and plan.tile == TILE and not plan.resident:
        cont = None
        if tiles is not None and 2 * tiles <= sms \
                and plan.rpt == K2_LANES4_RPT:
            cont = continuation_adaptive_plan(nx, nu, N, order, reduced,
                                              state_free)
        plan = cont or four_lane_adaptive_plan(nx, nu, N, order, reduced,
                                               state_free) or plan
    if plan is None:
        plan = cluster_adaptive_plan(nx, nu, N, order, reduced,
                                     busy_sms=busy_sms)
    return (plan if plan is not None
            else global_adaptive_plan(nx, nu, N, order, reduced, state_free))


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


def _check_precision(precision) -> bool:
    """Whether ``precision`` asks for reduced-precision products."""
    _check_k1_precision(precision, 0, 1, 1)
    return precision == "default"


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
                                 num_groups: int = 1,
                                 precision: str = "highest"):
    """Plain PyTorch version of kernel K2: the same computation in the same
    order, on the whole batch at once (a lane's result does not depend on
    which lanes share its tile).  Any float dtype and device; ``plant``
    (needed by the OSQP-form controller only) and ``constraints`` in the
    same dtype.  Returns (x (B, N, nx), u (B, N-1, nu), iters (B,), solved
    (B,), rho (B,)[, AdaptiveFusedCarry]).

    With ``num_groups=G`` the Taylor maps (and their rho0), the bounds, the
    plant and the constraint data may carry a leading group axis, ``x0s``
    is (G, L, nx) or flat, and the iterates run as (G, dim, L) with batched
    matmuls; results and carries keep the flat lane order g*L + l.  The
    reduced products of ``precision="default"`` are ``mma_product`` of the
    bf16-rounded stacked maps and operands, fp32 sums in any working
    dtype."""
    cons = constraints or _no_constraints(x0s)
    G = num_groups
    lo_all = _check_precision(precision)
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
    if lo_all:
        T1lo, T2lo = bf16_round(T1stk), bf16_round(T2stk)

    def product(maps, maps_lo, vec, lo):
        return (mma_product(maps_lo, bf16_round(vec)).to(dt) if lo
                else maps @ vec)

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
        update = i > 0 and i % RHO_INTERVAL == 0
        # an iteration that checks or predicts rho computes in fp32
        lo = lo_all and not check and not update
        drho = rho_b - rho0
        R1 = product(T1stk, T1lo if lo else None,
                     torch.cat([d, x0T, ones], dim=-2), lo).reshape(
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
        if update:
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
        R2 = product(T2stk, T2lo if lo else None, vec2, lo).reshape(
            lead + (4, su, L))
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


_ARGTYPES = ([_PTR] * 40 + [_INT] * 9 + [_FLT] * 9 + [_INT] * 10
             + [_PTR] * 2 + [_INT] * 13 + _SIDE + _SIDE + [_PTR])


@functools.cache
def _kernel_fn():
    fn = load_library("condensed_adaptive").lib.tinympc_condensed_adaptive
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def adaptive_occupancy(plan: AdaptivePlan, proj_u: bool = False,
                       proj_x: bool = False) -> int:
    """Blocks an SM of the plan's instance (the occupancy API), or for a
    cluster plan the clusters the card holds at once; builds the kernel.
    Raises on a CUDA error."""
    fn = load_library(
        "condensed_adaptive").lib.tinympc_condensed_adaptive_occupancy
    fn.argtypes = [_INT] * 8
    n = fn(plan.tile, plan.rpt, plan.lanes, int(plan.iterates_global),
           plan.cluster, int(proj_u), int(proj_x), plan.smem)
    if n < 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {-n}")
    return n


@functools.cache
def card_busy_sms(plan: AdaptivePlan) -> int:
    """The SMs a cluster plan's clusters keep busy at once on the current
    card: the occupancy API's clusters at once x the blocks a cluster
    (builds the kernel)."""
    return adaptive_occupancy(plan) * plan.cluster


def _row_layout(plan: AdaptivePlan, nx: int, nu: int, N: int, device):
    """Where each block's output rows sit in the padded maps: (destination,
    source) row indices of the forward map's ux rows and of the backward
    stack's interleaved d rows; slices of the first sw / 4 su rows without
    a cluster."""
    su, sw = (N - 1) * nu, (N - 1) * nu + N * nx
    if plan.cluster == 1:
        return ((slice(0, sw), slice(0, sw)),
                (slice(0, 4 * su), slice(0, 4 * su)))
    per1, per2 = plan.ld1 // plan.cluster, plan.ld2 // plan.cluster

    def index(spans, per):
        src = torch.cat([torch.arange(a, b) for a, b in spans])
        dst = torch.cat([torch.arange(c * per, c * per + b - a)
                         for c, (a, b) in enumerate(spans)])
        return dst.to(device), src.to(device)

    dspans = [(4 * a * nu, 4 * b * nu)
              for a, b in zip(plan.ustages[:-1], plan.ustages[1:])]
    return (index(slice_rows(nx, nu, N, plan.stages), per1),
            index(dspans, per2))


def map_layout(tmaps: CondensedTaylorMaps, su, sw, plan: AdaptivePlan,
               reduced: bool):
    """Kernel-side layouts of the Taylor maps (kept by ``LastLayout``), a
    leading group axis kept: each T1 block transposed, (o+1, in1,
    ``plan.ld1``); the four T2 blocks (their sw + 1 read columns)
    transposed and stacked with rows interleaved, row 4 r + c of the stack
    being row r of block c, (sw + 1, ``plan.ld2``); rows zero-padded.  A
    bulk-ring plan lays each out pass by pass (``_pass_major``: passes of
    ``plan.width`` rows of each T1 block, (o+1, in1 x ld1), and of
    ``plan.width2`` of the stack, ((sw + 1) x ld2,)), so that a slab of a
    pass is one bulk copy.  With reduced iterations also both in real bf16
    (round to nearest even), row-major and zero-padded to (o+1, ld1, kp1)
    and (ld2, kp2), else None.  A cluster plan lays each map's rows out
    block by block: block c's output rows from row c x ld / cluster,
    padded to its passes."""
    T1s, T2s = tmaps.T1s, tmaps.T2s
    lead = T1s.shape[:-3]
    ord1, in1 = T1s.shape[-3], T1s.shape[-1]
    nx = in1 - su - 1
    N = (sw - su) // nx
    (d1, s1), (d2, s2) = _row_layout(plan, nx, su // max(N - 1, 1), N,
                                     T1s.device)
    f32 = dict(dtype=torch.float32, device=T1s.device)
    # (..., 4, su, sw + 1) -> rows 4 r + c
    t2s = torch.cat([T2s[..., :sw], T2s[..., -1:]], dim=-1).transpose(-3, -2)
    t2s = t2s.reshape(lead + (4 * su, sw + 1))
    if plan.bulk_ring:
        t1t = _pass_major(T1s.transpose(-1, -2).float(), plan.width,
                          plan.ld1)
        t2t = _pass_major(t2s.transpose(-1, -2).float(), plan.width2,
                          plan.ld2)
    else:
        t1t = torch.zeros(lead + (ord1, in1, plan.ld1), **f32)
        t1t[..., d1] = T1s.transpose(-1, -2)[..., s1].float()
        t2t = torch.zeros(lead + (sw + 1, plan.ld2), **f32)
        t2t[..., d2] = t2s.transpose(-1, -2)[..., s2].float()
    if not reduced:
        return t1t, t2t, None, None
    bf = dict(dtype=torch.bfloat16, device=T1s.device)
    t1a = torch.zeros(lead + (ord1, plan.ld1, plan.kp1), **bf)
    t1a[..., d1, :in1] = T1s[..., s1, :].to(torch.bfloat16)
    t2a = torch.zeros(lead + (plan.ld2, plan.kp2), **bf)
    t2a[..., d2, :sw + 1] = t2s[..., s2, :].to(torch.bfloat16)
    return t1t, t2t, t1a, t2a


class LastLayout:
    """The launch plans (``adaptive_tile_plan``) and the maps' kernel-side
    layouts (``map_layout``) of the Taylor maps last given, kept with their
    tensors and versions (an in-place change or other maps make them
    anew): a plan by the plan function's arguments and the function itself
    (a plan forced in its place too), a layout by what it depends on (the
    plan's padded rows, its cluster's slices, the bf16 maps' k), so that a
    loop of launches on the same maps plans and lays them out once, and a
    pipeline's bulk launch and continuation, which take two plans, once
    each.  Called with the plan function's arguments; returns (plan,
    map_layout's four tensors).  ``condensed_adaptive_cuda`` keeps one for
    the maps last given to it (``LAST_LAYOUT``), a solver of
    ``make_condensed_adaptive_fused_solver`` its own."""

    def __init__(self):
        self.maps, self.plans, self.layouts = None, {}, {}

    def __call__(self, tmaps: CondensedTaylorMaps, nx, nu, N, order,
                 reduced, state_free, **kw):
        T1s, T2s = tmaps.T1s, tmaps.T2s
        versions = (T1s._version, T2s._version)
        m = self.maps
        if m is None or m[0] is not T1s or m[1] is not T2s \
                or m[2] != versions:
            self.maps, self.plans, self.layouts = (T1s, T2s, versions), {}, {}
        key = ((nx, nu, N, order, reduced, state_free),
               tuple(sorted(kw.items())), adaptive_tile_plan)
        plan = self.plans.get(key)
        if plan is None:
            plan = self.plans[key] = adaptive_tile_plan(
                nx, nu, N, order, reduced, state_free, **kw)
        lkey = (plan.ld1, plan.ld2, plan.cluster, plan.stages,
                plan.ustages, plan.kp1, plan.kp2, reduced)
        maps = self.layouts.get(lkey)
        if maps is None:
            maps = self.layouts[lkey] = map_layout(
                tmaps, T2s.shape[-2], T1s.shape[-2], plan, reduced)
        return plan, maps


LAST_LAYOUT = LastLayout()


def condensed_adaptive_cuda(tmaps: CondensedTaylorMaps, u_min, u_max, x_min,
                            x_max, x0s, warm=None, *,
                            plant: AdaptivePlant | None, nx, nu, N, max_iter,
                            abs_pri_tol, abs_dua_tol, en_state_bound,
                            en_input_bound, relaxation_alpha,
                            adaptive_rho_min, adaptive_rho_max,
                            adaptive_rho_clipping, check_termination,
                            controller, taylor_trust, warm_start, carry_out,
                            constraints: FusedConstraints | None = None,
                            num_groups: int = 1, precision: str = "highest",
                            layout: LastLayout | None = None):
    """Launch kernel K2 (csrc/condensed_adaptive.cu) on CUDA tensors; the
    arguments and results are those of ``condensed_adaptive_reference``.
    Raises on CPU tensors, on any dtype but float32, on non-contiguous
    inputs, and when the build or the launch fails.  The plan and the maps'
    kernel-side layouts come from ``layout`` (default ``LAST_LAYOUT``: kept
    for the maps last given).  Counts every launch in
    ``.launches``, those over more than one group in ``.grouped_launches``,
    those with reduced-precision iterations in ``.reduced_launches`` and
    warm ones (continuations) in ``.warm_launches``."""
    cons = constraints or _no_constraints(x0s)
    G = num_groups
    lo_all = _check_precision(precision)
    x0, L, tensors = _validate(tmaps, (u_min, u_max, x_min, x_max), x0s, warm,
                               plant, nx, nu, N, warm_start, cons, controller,
                               G)
    _check_cuda_inputs(tensors, 2, "the adaptive fused kernel")
    su, sx, sw = _dims(nx, nu, N)
    B = G * L
    if B == 0:
        raise ValueError("empty batch")
    order = tmaps.T1s.shape[-3] - 1
    osqp = controller == "osqp"
    dev = x0s.device
    state_free = _state_free(en_state_bound, cons)
    plan, (t1t, t2t, t1a, t2a) = (layout or LAST_LAYOUT)(
        tmaps, nx, nu, N, order, lo_all, state_free, busy_sms=card_busy_sms,
        tiles=G * -(-L // TILE),
        sms=torch.cuda.get_device_properties(dev).multi_processor_count)
    side_u = _side_args(cons.lin_u, cons.cones_u, nu, "input")
    side_x = _side_args(cons.lin_x, cons.cones_x, nx, "state")

    f32 = dict(dtype=torch.float32, device=dev)
    # the expansion centre and the trust clip's bounds in the plain
    # version's float32 arithmetic: one per group on the device, or for a
    # single group by value (read on the host)
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
    # the new slacks (projected stages, the OSQP-form residuals) and duals
    # (the OSQP-form residuals)
    projected = bool(side_u[1] or side_u[4] or side_x[1] or side_x[4])
    wsc = torch.empty((sw, B), **f32) if projected or osqp else None
    dsc = torch.empty((sw, B), **f32) if osqp else None
    # the staged carry slacks and one group's constraint data in shared
    # memory after the plan's layout, each where it fits
    smem, _ = launch_smem(plan, sw, carry_out,
                          constraint_bytes(cons, nx, nu))
    # the tiles' iterates where they live in global memory: each tile its
    # own columns
    vecg = uxg = w2hg = None
    # a cluster's copy of ux for the OSQP-form residuals, which read the
    # next stage's rows
    uxo = (torch.empty((sw, B), **f32) if osqp and plan.cluster > 1
           else None)
    ldg = G * -(-L // plan.tile) * plan.tile
    if plan.iterates_global:
        vecg = torch.empty((su + nx + 1, ldg), **f32)
        uxg = torch.empty((sw + 1, ldg), **f32)
    if lo_all and (plan.iterates_global or plan.cluster > 1):
        w2hg = torch.empty((ldg, max(plan.kp1, plan.kp2)),
                           dtype=torch.bfloat16, device=dev)

    fn = _kernel_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(_ptr(t1t), _ptr(t2t), _ptr(t1a), _ptr(t2a), _ptr(rho0),
                 _ptr(trust_lo), _ptr(trust_hi), _ptr(u_min), _ptr(u_max),
                 _ptr(x_min), _ptr(x_max), _ptr(x0), _ptr(w.d), _ptr(w.y),
                 None if state_free else _ptr(w.g), _ptr(w.v), _ptr(w.z),
                 _ptr(w.rho), _ptr(xout), _ptr(uout), _ptr(iters),
                 _ptr(solved), _ptr(rho), _ptr(y),
                 None if state_free else _ptr(g), _ptr(d_out), _ptr(vco),
                 _ptr(zco), _ptr(pl.A), _ptr(pl.B), _ptr(pl.Q), _ptr(pl.R),
                 _ptr(pl.Pinf), _ptr(pl.dPinf_drho), _ptr(wsc), _ptr(dsc),
                 _ptr(vecg), _ptr(uxg), _ptr(w2hg), _ptr(uxo),
                 nx, nu, N, G, L, order, max_iter, check_termination,
                 int(lo_all), relaxation_alpha, 1.0 - relaxation_alpha,
                 abs_pri_tol, abs_dua_tol, adaptive_rho_min,
                 adaptive_rho_max, *one, int(osqp),
                 int(adaptive_rho_clipping), int(trust),
                 int(en_input_bound), int(en_state_bound), int(warm_start),
                 int(carry_out), plan.tile, int(plan.iterates_global),
                 plan.cluster, stage_bounds_arg(plan.stages),
                 stage_bounds_arg(plan.ustages), plan.rpt, plan.lanes,
                 plan.passes1,
                 plan.passes2, plan.kp1, plan.kp2, int(plan.resident),
                 int(plan.state_shared), smem,
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
    if lo_all:
        condensed_adaptive_cuda.reduced_launches += 1
    if warm_start:
        condensed_adaptive_cuda.warm_launches += 1
    out = (xout.T.reshape(B, N, nx), uout.T.reshape(B, N - 1, nu), iters,
           solved, rho)
    if carry_out:
        return out + (AdaptiveFusedCarry(d_out, y, g, vco, zco,
                                         rho.reshape(1, B)),)
    return out


condensed_adaptive_cuda.launches = 0
condensed_adaptive_cuda.grouped_launches = 0
condensed_adaptive_cuda.reduced_launches = 0
condensed_adaptive_cuda.warm_launches = 0


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

    ``precision="default"`` computes both products of an iteration that
    neither checks nor predicts rho as one bf16 pass (both operands rounded
    to bf16, the products summed on the tensor cores); an iteration that
    checks or predicts rho computes in full precision, so with
    ``check_termination=1`` it equals ``"highest"``.  Any other name
    raises ``ValueError``."""
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
    _check_precision(precision)
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
              carry_out=carry_out, num_groups=num_groups,
              precision=precision)

    on_device = {}  # (device, dtype) -> (AdaptivePlant, FusedConstraints)
    layout = LastLayout()

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
        fn = (functools.partial(condensed_adaptive_cuda, layout=layout)
              if x0s.device.type == "cuda" else condensed_adaptive)
        return fn(tmaps, u_min, u_max, x_min, x_max, x0s, warm, plant=plant,
                  constraints=constraints, **kw)

    return solve_fn
