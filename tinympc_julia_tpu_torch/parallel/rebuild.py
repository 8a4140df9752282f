"""The bucketed exact-rebuild adaptive-rho pipeline (counterpart of
tinympc_julia_tpu/parallel/rebuild.py): the fast path for a mis-set rho0.

The standard path's ``adaptive_rho_rebuild`` re-runs the Riccati fixed point
inside the solve loop at every rho update (``ops/rho.rebuild_update``); it
rescues a rho0 that is off by orders of magnitude, one lane at a time.  Here
the adaptation is a pair of phases over fixed caches built at setup:

  setup    G log-spaced bucket rhos spanning [adaptive_rho_min,
           adaptive_rho_max]; each bucket's cache rebuilt exactly (a
           cold-started ``rebuild_update``: the cache setup would build at
           that rho, the linear costs still folded at rho0, as the standard
           rebuild path keeps them), and grouped condensed maps over them.
  phase 1  ``phase1_iters`` fixed-rho0 iterations on kernel K1 with its
           carry.
  predict  one condensed iteration from the carry gives each lane's
           termination residuals; rho* = rho0 sqrt((pri/pri_tol) /
           (dua/dua_tol)), clipped, then snapped to the nearest bucket in
           log space.
  phase 2  the unconverged lanes, compacted per bucket into fixed slots,
           continue warm (scaled duals kept) on K1's group grid (K1d), each
           bucket on its own maps.

Nothing in the solve waits for the host on the card: the compaction is a
cumsum and a scatter, the merge an index copy into a dump row.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..ops import rho as rho_mod
from ..ops.condensed import CondensedMaps, _slack_update, build_condensed
from ..ops.cuda.condensed_kernel import (FusedCarry, fused_constraints,
                                         make_condensed_fused_solver,
                                         problem_constraint_kw)
from ..types import Cache, Problem, Settings, stack_instances
from ..utils.precision import full_fp32_matmul


class BucketedRebuildPipeline(NamedTuple):
    """The pipeline and its configuration."""
    solve: Callable          # (x0s (B, nx), lane_mask=None) -> see below
    bucket_rhos: tuple       # the G bucket centres
    phase1_iters: int
    phase2_iters: int
    straggler_slots: int     # phase-2 slots a bucket


def compact_members(member: torch.Tensor, slots: int):
    """Per-group compaction into a fixed number of slots, with no host sync.

    ``member`` is a (G, M) bool matrix of group membership.  Returns
    (idx (G, slots) int64 member positions in order, index-0 fill;
    counts (G,) int64; valid (G*slots,) slot-validity mask; overflow (G,)
    int32 counts of members beyond ``slots``).  Callers must drop what
    invalid slots produce: their index-0 fill re-selects position 0.

    A cumsum gives each member its slot and one scatter writes the
    positions; non-members and members past ``slots`` land in a dump column
    that is cut off, so no ``nonzero`` (a host sync) is needed."""
    G, M = member.shape
    dev = member.device
    slot = torch.cumsum(member.to(torch.int64), dim=1) - 1
    target = torch.where(member & (slot < slots), slot, slots)
    pos = torch.arange(M, device=dev).expand(G, M)
    idx = torch.zeros((G, slots + 1), dtype=torch.int64, device=dev)
    idx.scatter_(1, target, pos)
    counts = member.sum(dim=1)
    valid = (torch.arange(slots, device=dev)[None, :]
             < counts[:, None]).reshape(-1)
    overflow = torch.clamp(counts - slots, min=0).to(torch.int32)
    return idx[:, :slots], counts, valid, overflow


def merge_lanes(a1: torch.Tensor, a2: torch.Tensor, dest: torch.Tensor):
    """``a1`` (B, ...) with row ``dest[k]`` replaced by ``a2[k]``; a ``dest``
    of B (an invalid slot) lands in a dump row that is cut off."""
    B = a1.shape[0]
    ext = torch.cat([a1, a1[:1]], dim=0)
    return ext.index_copy(0, dest, a2)[:B]


def default_bucket_rhos(rho_min: float, rho_max: float,
                        per_decade: float = 0.5) -> tuple:
    """Log-spaced bucket centres covering [rho_min, rho_max] at
    ``per_decade`` buckets a decade (0.5 by default: iteration counts are
    flat across about three decades of rho around the optimum, so a
    quantisation error of up to one decade stays inside the flat region,
    and every extra bucket costs phase-2 pad slots)."""
    lo, hi = np.log10(rho_min), np.log10(rho_max)
    n = max(2, int(np.ceil((hi - lo) * per_decade)) + 1)
    return tuple(float(r) for r in np.logspace(lo, hi, n))


def rebuild_bucket_caches(problem: Problem, cache: Cache,
                          bucket_rhos: Sequence[float]) -> Cache:
    """Exact per-bucket caches, stacked along a leading G axis: each a
    cold-started ``ops.rho.rebuild_update`` at the bucket rho, which equals
    ``precompute_cache`` at that rho.  The problem, with its linear costs
    folded at rho0, stays shared (the standard rebuild path's semantics)."""
    with full_fp32_matmul():
        return stack_instances([
            rho_mod.rebuild_update(cache, problem, r, warm=False)
            for r in bucket_rhos])


@full_fp32_matmul()
def predict_rho_bucketed(problem: Problem, settings: Settings,
                         maps: CondensedMaps, carry: FusedCarry, x0s, rho0,
                         bucket_rhos):
    """Per-lane rho prediction and its log-space bucket from a phase-1
    ``FusedCarry``: one condensed iteration (in full fp32; the slack update
    over-relaxes and projects box -> halfspaces -> cones as the condensed
    solve does) reproduces the iterates the in-loop controller would see,
    then rho* = rho0 sqrt((pri/pri_tol) / (dua/dua_tol + EPS)), the
    termination controller's estimate without its step cap or deadband,
    clipped to [adaptive_rho_min, adaptive_rho_max].  The nearest bucket is
    taken in log space, the first of two at equal distance.  Returns
    (bucket (B,) int64, rho_pred (B,))."""
    s, p = settings, problem
    nx, su = p.nx, (p.N - 1) * p.nu
    sw = su + p.N * nx
    dt, dev = x0s.dtype, x0s.device
    T12, T1 = maps.T12, maps.T1
    ux = (T12[:, :sw] @ carry.w2 + T12[:, -1:]
          + T1[:, su:su + nx] @ x0s.T + T1[:, -1:])
    u, x = ux[:su], ux[su:]
    _, _, znew, vnew = _slack_update(p, s)(u, x, carry.z, carry.v, carry.y,
                                           carry.g)

    def amax(t):
        return torch.amax(torch.abs(t), dim=0)

    def const(v):
        return torch.tensor(v, dtype=dt, device=dev)

    rho0 = torch.as_tensor(rho0, dtype=dt, device=dev)
    pri = torch.maximum(amax(x - vnew), amax(u - znew))
    dua = rho0 * torch.maximum(amax(carry.v - vnew), amax(carry.z - znew))
    ratio = ((pri / const(s.abs_pri_tol))
             / (dua / const(s.abs_dua_tol) + const(rho_mod.EPS)))
    rho_pred = torch.clamp(rho0 * torch.sqrt(ratio),
                           const(s.adaptive_rho_min),
                           const(s.adaptive_rho_max))
    centers = torch.log(torch.tensor(bucket_rhos, dtype=dt, device=dev))
    bucket = torch.argmin(
        torch.abs(torch.log(rho_pred)[:, None] - centers[None, :]), dim=1)
    return bucket, rho_pred


def bucket_maps(problem: Problem, cache: Cache,
                bucket_rhos) -> CondensedMaps:
    """The grouped condensed maps of the exact bucket caches (the shared
    problem stacked G times): the set-up cost of the pipeline, kept by the
    API between calls."""
    bcaches = rebuild_bucket_caches(problem, cache, bucket_rhos)
    return build_condensed(stack_instances([problem] * len(bucket_rhos)),
                           bcaches)


def make_bucketed_rebuild(problem: Problem, cache: Cache,
                          settings: Settings, *,
                          bucket_rhos: Optional[Sequence[float]] = None,
                          phase1_iters: int = 50,
                          straggler_slots: int = 512,
                          phase2_iters: int = 500,
                          phase1_bf16: bool = False,
                          phase2_bf16_iters: int = 0,
                          maps: Optional[CondensedMaps] = None,
                          bmaps: Optional[CondensedMaps] = None,
                          fused: Optional[Callable] = None
                          ) -> BucketedRebuildPipeline:
    """Build the bucketed rebuild pipeline (module docstring).

    ``settings``: tolerances, constraint flags, ``check_termination`` and
    over-relaxation of a fixed-rho solve, and [adaptive_rho_min,
    adaptive_rho_max] as the bucket span (``bucket_rhos`` overrides the
    log-spaced default); the ``adaptive_rho`` flags are ignored, this is
    the rebuild path.  ``phase1_iters``, ``phase2_iters`` and
    ``phase2_bf16_iters`` must be multiples of ``check_termination``.
    ``maps`` (the problem's ``build_condensed``) and ``bmaps`` (the
    bucket maps of ``bucket_maps``) may be passed in when they are at hand;
    otherwise they are built here.  ``fused`` replaces kernel K1's entry
    point in every phase by a function with ``condensed_fused_reference``'s
    signature (measurements pass the plain version).

    Returns a ``BucketedRebuildPipeline`` whose ``solve(x0s (B, nx),
    lane_mask=None)`` gives

        (xs (B, N, nx), us (B, N-1, nu), iters (B,), solved (B,),
         rho (B,), overflow (G,))

    per lane: ``rho`` is the bucket a lane finished on (rho0 where phase 1
    converged it, or where its bucket overflowed), ``overflow[g]`` counts
    the lanes predicted into bucket g beyond its ``straggler_slots`` slots:
    they keep their unconverged phase-1 result.  ``lane_mask`` (B,) bool
    marks the lanes that may take phase-2 slots.

    Precision staging: ``phase1_bf16`` runs phase 1 at K1c's
    ``precision="default"``; ``phase2_bf16_iters = k2`` runs phase 2 as two
    launches, k2 iterations at ``"default"`` with their carry, then
    ``phase2_iters`` in fp32 warm from it (so a lane latched in the first
    keeps that result).  An iteration that runs the residual check always
    computes in fp32, so a lane never latches on an approximate rollout; at
    ``check_termination=1`` every iteration checks and both options compute
    exactly the fp32 pipeline."""
    s, p = settings, problem
    nx, nu, N = p.nx, p.nu, p.N
    ct = s.check_termination
    if ct < 1:
        raise ValueError("the bucketed rebuild pipeline needs "
                         f"check_termination >= 1 (got {ct})")
    k2 = int(phase2_bf16_iters)
    for what, iters in (("phase1_iters", phase1_iters),
                        ("phase2_iters", phase2_iters),
                        ("phase2_bf16_iters", k2)):
        if iters % ct != 0:
            raise ValueError(f"{what}={iters} must be a multiple of "
                             f"check_termination={ct}")
    if bucket_rhos is None:
        bucket_rhos = default_bucket_rhos(float(s.adaptive_rho_min),
                                          float(s.adaptive_rho_max))
    bucket_rhos = tuple(float(r) for r in bucket_rhos)
    G = len(bucket_rhos)
    L2 = int(straggler_slots)
    if L2 < 1:
        raise ValueError(f"straggler_slots must be >= 1 (got {L2})")
    if maps is None:
        maps = build_condensed(p, cache)
    if bmaps is None:
        bmaps = bucket_maps(p, cache, bucket_rhos)
    rho0 = float(cache.rho)

    base = dict(abs_pri_tol=float(s.abs_pri_tol),
                abs_dua_tol=float(s.abs_dua_tol),
                en_state_bound=s.en_state_bound,
                en_input_bound=s.en_input_bound,
                relaxation_alpha=s.relaxation_alpha, check_termination=ct)
    spec = problem_constraint_kw(p, s)

    def phase(**kw):
        kw = base | kw
        if fused is None:
            return make_condensed_fused_solver(nx, nu, N, **kw, **spec)
        kw = dict(warm_start=False, carry_out=False) | kw
        cons = fused_constraints(**spec, nx=nx, nu=nu, dtype=p.dtype,
                                 device=p.device,
                                 num_groups=kw.get("num_groups", 1))
        return functools.partial(fused, nx=nx, nu=nu, N=N,
                                 constraints=cons, **kw)

    fn1 = phase(max_iter=phase1_iters, carry_out=True,
                precision="default" if phase1_bf16 else "highest")
    fn2a = phase(max_iter=k2, warm_start=True, carry_out=True, num_groups=G,
                 precision="default") if k2 else None
    fn2 = phase(max_iter=phase2_iters, warm_start=True, num_groups=G)
    bounds = (p.u_min, p.u_max, p.x_min, p.x_max)
    brho = torch.tensor(bucket_rhos, dtype=torch.float32, device=p.device)

    def solve(x0s, lane_mask=None):
        x0s = torch.as_tensor(x0s, device=p.device).to(p.dtype).contiguous()
        B = x0s.shape[0]
        xs1, us1, it1, ok1, carry = fn1(maps, rho0, *bounds, x0s)
        unconv = ok1 == 0
        if lane_mask is not None:
            unconv = unconv & torch.as_tensor(lane_mask, device=p.device)
        bucket, _ = predict_rho_bucketed(p, s, maps, carry, x0s, rho0,
                                         bucket_rhos)

        # per-bucket compaction into fixed slots (lane order kept within a
        # bucket); a pad slot gets a zero carry and a zero x0 instead of
        # lane 0's, so a tile of pads exits at its first check
        m = unconv[None, :] & (bucket[None, :]
                               == torch.arange(G, device=p.device)[:, None])
        idx, _, valid, overflow = compact_members(m, L2)
        gidx = idx.reshape(-1)                                  # (G*L2,)

        def gather(a):
            return torch.where(valid[None, :], a[:, gidx], 0.0).contiguous()

        warm = FusedCarry(*(gather(w) for w in carry))
        x0s2 = torch.where(valid[:, None], x0s[gidx], 0.0).contiguous()
        if k2:
            xs2a, us2a, it2a, ok2a, warm = fn2a(bmaps, brho, *bounds, x0s2,
                                                warm)
            xs2, us2, it2b, ok2b = fn2(bmaps, brho, *bounds, x0s2, warm)
            done = ok2a == 1
            xs2 = torch.where(done[:, None, None], xs2a, xs2)
            us2 = torch.where(done[:, None, None], us2a, us2)
            it2 = torch.where(done, it2a, k2 + it2b)
            ok2 = torch.maximum(ok2a, ok2b)
        else:
            xs2, us2, it2, ok2 = fn2(bmaps, brho, *bounds, x0s2, warm)

        # scatter the phase-2 results back, invalid slots to the dump row
        dest = torch.where(valid, gidx, B)
        lane_rho = torch.full((B,), rho0, dtype=torch.float32,
                              device=p.device)
        return (merge_lanes(xs1, xs2, dest), merge_lanes(us1, us2, dest),
                merge_lanes(it1, phase1_iters + it2, dest),
                merge_lanes(ok1, ok2, dest),
                merge_lanes(lane_rho, brho.repeat_interleave(L2), dest),
                overflow)

    return BucketedRebuildPipeline(solve=solve, bucket_rhos=bucket_rhos,
                                   phase1_iters=phase1_iters,
                                   phase2_iters=phase2_iters,
                                   straggler_slots=L2)
