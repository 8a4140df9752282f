"""The straggler pipelines: the three-phase one of the headline workload
(the ``_pipeline`` that bench.py builds inline around the JAX fused kernel)
and the two-phase one of the adaptive-rho workload.

  phase 0  cold pass over every lane, ``check_termination`` = its whole
           budget (one end check), carry out;
  phase 1  warm polish of every lane from that carry (ct = 4), carry out;
  phase 2  the lanes still unconverged are compacted into a fixed number of
           straggler slots (index-0 fill) and continue warm from their
           carry (exact continuation, ct = 4).

All three phases run kernel K1 in full fp32 by default.  The JAX headline's
staging (bench.py's ``_pipeline``) is an option, ``STAGED``: phase 0 at
``precision="default"`` (reduced-precision products, its one end check in
fp32) and a 96-iteration reduced head in phase 2.  A lane only ever latches
on a full-precision rollout and residual.  Nothing in the pipeline waits for
the host: the compaction is a cumsum and a scatter.

``two_phase_adaptive_solve`` is the pipeline kernel K2's carry exists for: a
bulk pass with per-lane adaptive rho, the same compaction, and a warm
continuation of the stragglers on the same kernel, each from its own rho.
``requantized_adaptive_solve`` is the JAX adaptive headline row's form of it
(the ``pipeline`` that bench.py's ``quadrotor_adaptive`` row builds inline):
the same bulk pass, then each straggler's settled rho snapped onto exact
bucket caches and the stragglers continued at fixed rho on K1's group grid.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import torch

from ..ops.cuda.adaptive_kernel import AdaptiveFusedCarry, condensed_adaptive
from ..ops.cuda.condensed_kernel import (FusedCarry,
                                         make_condensed_fused_solver)
from ..ops.rho import RHO_INTERVAL
from .rebuild import bucket_maps, compact_members
from .rebuild import merge_lanes as _merge

# The headline workload's settings (bench.py's _pipeline): box-bounded
# inputs, no state bound, tolerance 1e-3, over-relaxation 1.7, residual
# checks every 4 iterations in the warm phases.
BUDGETS = (56, 36, 324)
CHECK_TERMINATION = 4
RELAXATION_ALPHA = 1.7
TOL = 1e-3
# bench.py's staging of the headline: a reduced phase 0, a 96-iteration
# reduced head in phase 2
STAGED = dict(phase0_bf16=True, phase2_bf16_head=96)


class PipelineResult(NamedTuple):
    xs: torch.Tensor       # (B, N, nx) phase-1 solutions, phase-2 ones merged
    us: torch.Tensor       # (B, N-1, nu)
    iters1: torch.Tensor   # (B,) phase-1 iteration counts
    solved1: torch.Tensor  # (B,) max(ok0, ok1)
    idx: torch.Tensor      # (slots,) lanes continued in phase 2
    iters2: torch.Tensor   # (slots,)
    solved2: torch.Tensor  # (slots,)
    unconv: torch.Tensor   # (B,) lanes unconverged after phase 1
    valid: torch.Tensor    # (slots,) slots that hold a real straggler

    def converged(self) -> torch.Tensor:
        """Number of lanes converged by the end of phase 2."""
        return self.solved1.sum() + (self.solved2 * self.valid).sum()

    def lane_results(self):
        """(xs, us, final iteration count, solved) per lane, each valid
        phase-2 slot's count added to its lane's phase-1 count."""
        it, ok = self.iters1.clone(), self.solved1.clone()
        lanes = self.idx[self.valid]
        it[lanes] += self.iters2[self.valid]
        ok[lanes] = self.solved2[self.valid]
        return self.xs, self.us, it, ok

    def total_iters(self, phase0_iters: int) -> torch.Tensor:
        """ADMM iterations run: phase 0's full budget on every lane, the
        phase-1 counts, and the phase-2 counts of valid slots."""
        return (phase0_iters * self.iters1.numel() + self.iters1.sum()
                + (self.iters2 * self.valid).sum())


def three_phase_solve(maps, rho, u_min, u_max, x_min, x_max, x0s, *, nx, nu,
                      N, straggler_slots: int, budgets=BUDGETS,
                      phase0_bf16: bool = False, phase2_bf16_head: int = 0,
                      fused: Optional[Callable] = None) -> PipelineResult:
    """Run the pipeline on ``x0s`` (B, nx); arguments as for the fused
    solver (``rho`` a float).  Lanes that overflow ``straggler_slots`` keep
    their phase-1 result.

    ``budgets`` are the phases' iteration budgets; only the CPU test against
    the JAX pipeline shortens phase 0, to bound the Pallas kernel's
    interpret-mode compile.  ``phase0_bf16`` runs phase 0 at
    ``precision="default"`` and ``phase2_bf16_head`` gives phase 2 a head of
    that many reduced iterations (``STAGED`` holds the JAX headline's
    values); the checking iterations stay fp32.  ``fused`` replaces the
    solver of each phase by a function with ``condensed_fused_reference``'s
    signature; measurements pass the plain version to time the same
    pipeline without the kernel."""
    kw = dict(nx=nx, nu=nu, N=N, abs_pri_tol=TOL, abs_dua_tol=TOL,
              en_input_bound=True, en_state_bound=False,
              relaxation_alpha=RELAXATION_ALPHA)

    def phase(**phase_kw):
        if fused is None:
            return make_condensed_fused_solver(**kw, **phase_kw)
        return functools.partial(fused, **kw, **phase_kw)

    m0, m1, m2 = budgets
    ct = CHECK_TERMINATION
    fn0 = phase(max_iter=m0, check_termination=m0, warm_start=False,
                carry_out=True,
                precision="default" if phase0_bf16 else "highest")
    fn1 = phase(max_iter=m1, check_termination=ct, warm_start=True,
                carry_out=True)
    fn2 = phase(max_iter=m2, check_termination=ct, warm_start=True,
                carry_out=False, bf16_head_iters=phase2_bf16_head)
    bounds = (u_min, u_max, x_min, x_max)
    B = x0s.shape[0]

    _, _, _, ok0, carry0 = fn0(maps, rho, *bounds, x0s)
    xs1, us1, it1, ok1p, carry = fn1(maps, rho, *bounds, x0s, carry0)
    ok1 = torch.maximum(ok0, ok1p)
    unconv = ok1 == 0
    idx, _, valid, _ = compact_members(unconv[None, :], straggler_slots)
    idx = idx[0]
    warm = FusedCarry(*(w[:, idx].contiguous() for w in carry))
    xs2, us2, it2, ok2 = fn2(maps, rho, *bounds, x0s[idx].contiguous(), warm)

    # merge: valid slots overwrite their lane, invalid ones go to a dump row
    dest = torch.where(valid, idx, B)
    merge = functools.partial(_merge, dest=dest)
    return PipelineResult(xs=merge(xs1, xs2), us=merge(us1, us2), iters1=it1,
                          solved1=ok1, idx=idx, iters2=it2, solved2=ok2,
                          unconv=unconv, valid=valid)


# The adaptive-rho workload's settings (bench.py's quadrotor_adaptive row,
# phase 1): box-bounded inputs, no state bound, tolerance 1e-3, the
# termination-residual controller floored at the setup rho (a decay below it
# re-enters the Taylor maps' plateau), capped at 1e3 and held within the
# Taylor trust radius 2 of the setup rho.
ADAPTIVE_BUDGETS = (150, 2500)
ADAPTIVE_CONTROLLER = "termination"
ADAPTIVE_TAYLOR_TRUST = 2.0
ADAPTIVE_RHO_MAX = 1e3


class AdaptivePipelineResult(NamedTuple):
    xs: torch.Tensor        # (B, N, nx) bulk pass, the stragglers' merged
    us: torch.Tensor        # (B, N-1, nu)
    iters: torch.Tensor     # (B,) bulk count, plus the continuation's
    solved: torch.Tensor    # (B,)
    rho: torch.Tensor       # (B,) the rho each lane ended on
    unconv: torch.Tensor    # (B,) lanes unconverged after the bulk pass
    overflow: torch.Tensor  # int32 stragglers beyond the slots: 0-d, or
    #                         (G,) a bucket for the requantized pipeline


def _adaptive_kw(tmaps, nx, nu, N) -> dict:
    """The adaptive row's K2 settings (the constants above)."""
    return dict(plant=None, nx=nx, nu=nu, N=N, abs_pri_tol=TOL,
                abs_dua_tol=TOL, en_input_bound=True, en_state_bound=False,
                relaxation_alpha=1.0, adaptive_rho_min=float(tmaps.rho0),
                adaptive_rho_max=ADAPTIVE_RHO_MAX, adaptive_rho_clipping=True,
                check_termination=1, controller=ADAPTIVE_CONTROLLER,
                taylor_trust=ADAPTIVE_TAYLOR_TRUST)


def two_phase_adaptive_solve(tmaps, u_min, u_max, x_min, x_max, x0s, *, nx,
                             nu, N, straggler_slots: int,
                             budgets=ADAPTIVE_BUDGETS,
                             fused: Optional[Callable] = None
                             ) -> AdaptivePipelineResult:
    """Bulk pass of ``budgets[0]`` iterations with per-lane adaptive rho and
    its carry; the unconverged lanes compacted into ``straggler_slots``
    slots (index-0 fill, no host sync); up to ``budgets[1]`` more iterations
    warm from each straggler's carry and rho; the results merged back.
    ``tmaps`` is the problem's ``CondensedTaylorMaps``; ``x0s`` is (B, nx).
    Stragglers that overflow the slots keep their bulk-pass result and are
    counted in ``overflow``.

    The continuation restarts the rho-update counter, so the pipeline is
    not one long solve; it is held against the same two calls of the plain
    version.  ``fused`` replaces ``condensed_adaptive`` (the kernel on CUDA
    tensors) by a function of the same signature; measurements pass
    ``condensed_adaptive_reference`` to time the pipeline without the
    kernel."""
    for m in budgets:
        if m % RHO_INTERVAL != 0:
            raise ValueError(f"the adaptive pipeline's budgets must be "
                             f"multiples of {RHO_INTERVAL}; got {budgets}")
    solve = fused or condensed_adaptive
    kw = _adaptive_kw(tmaps, nx, nu, N)
    bounds = (u_min, u_max, x_min, x_max)
    B = x0s.shape[0]
    m1, m2 = budgets

    xs1, us1, it1, ok1, rho1, carry = solve(
        tmaps, *bounds, x0s, None, max_iter=m1, warm_start=False,
        carry_out=True, **kw)
    unconv = ok1 == 0
    idx, _, valid, overflow = compact_members(unconv[None, :],
                                              straggler_slots)
    idx = idx[0]
    warm = AdaptiveFusedCarry(*(w[:, idx].contiguous() for w in carry))
    xs2, us2, it2, ok2, rho2 = solve(
        tmaps, *bounds, x0s[idx].contiguous(), warm, max_iter=m2,
        warm_start=True, carry_out=False, **kw)

    # merge: valid slots overwrite their lane, invalid ones go to a dump row
    dest = torch.where(valid, idx, B)
    merge = functools.partial(_merge, dest=dest)
    return AdaptivePipelineResult(
        xs=merge(xs1, xs2), us=merge(us1, us2), iters=merge(it1, m1 + it2),
        solved=merge(ok1, ok2), rho=merge(rho1, rho2), unconv=unconv,
        overflow=overflow[0])


# The requantized continuation of the adaptive row (bench.py's
# quadrotor_adaptive): exact bucket caches at rho0 + {0, 1, 2}, the trust
# window of the bulk pass's controller, and a 256-iteration reduced head.
REQUANT_OFFSETS = (0.0, 1.0, 2.0)
REQUANT_HEAD = 256


def requantized_buckets(problem, cache, offsets=REQUANT_OFFSETS):
    """(bucket rhos, their grouped condensed maps) for
    ``requantized_adaptive_solve``: exact caches at rho0 + each offset,
    built once per problem."""
    rhos = tuple(float(cache.rho) + d for d in offsets)
    return rhos, bucket_maps(problem, cache, rhos)


def requantized_adaptive_solve(tmaps, bmaps, bucket_rhos, u_min, u_max,
                               x_min, x_max, x0s, *, nx, nu, N,
                               straggler_slots: int,
                               budgets=ADAPTIVE_BUDGETS,
                               bf16_head_iters: int = REQUANT_HEAD,
                               fused_adaptive: Optional[Callable] = None,
                               fused: Optional[Callable] = None
                               ) -> AdaptivePipelineResult:
    """The adaptive pipeline with a fixed-rho continuation.

    The bulk pass is ``two_phase_adaptive_solve``'s (kernel K2, ``budgets[0]``
    iterations, carry out).  Each straggler's carried rho is snapped onto
    the nearest of ``bucket_rhos`` in linear distance; the stragglers are
    compacted per bucket into ``straggler_slots`` slots (a pad slot gets a
    zero carry and a zero x0, so a tile of pads exits at its first check);
    the adaptive carry becomes K1's (``w2 = [z - y; v - g]``, then y, g, v,
    z); and they continue warm for up to ``budgets[1]`` iterations on K1's
    group grid (K1d), bucket g on ``bmaps[g]`` at its exact rho, the first
    ``bf16_head_iters`` of them reduced (K1c's head: it checks only on its
    last iteration, in fp32).  ``tmaps`` is the problem's
    ``CondensedTaylorMaps``; ``bucket_rhos`` and ``bmaps`` come from
    ``requantized_buckets``.  Lanes beyond a bucket's slots keep their bulk
    result and are counted in ``overflow`` (G,).

    ``fused_adaptive`` replaces ``condensed_adaptive`` and ``fused`` K1's
    entry point by functions of the same signatures; measurements pass the
    plain versions to time the pipeline without the kernels."""
    for m in budgets:
        if m % RHO_INTERVAL != 0:
            raise ValueError(f"the adaptive pipeline's budgets must be "
                             f"multiples of {RHO_INTERVAL}; got {budgets}")
    solve = fused_adaptive or condensed_adaptive
    m1, m2 = budgets
    G = len(bucket_rhos)
    L2 = int(straggler_slots)
    kw2 = dict(nx=nx, nu=nu, N=N, max_iter=m2, abs_pri_tol=TOL,
               abs_dua_tol=TOL, en_input_bound=True, en_state_bound=False,
               relaxation_alpha=1.0, check_termination=1, warm_start=True,
               carry_out=False, num_groups=G, bf16_head_iters=bf16_head_iters)
    fn2 = (make_condensed_fused_solver(**kw2) if fused is None
           else functools.partial(fused, **kw2))
    bounds = (u_min, u_max, x_min, x_max)
    B = x0s.shape[0]
    dev = x0s.device

    xs1, us1, it1, ok1, rho1, carry = solve(
        tmaps, *bounds, x0s, None, max_iter=m1, warm_start=False,
        carry_out=True, **_adaptive_kw(tmaps, nx, nu, N))
    unconv = ok1 == 0
    brho = torch.tensor(bucket_rhos, dtype=torch.float32, device=dev)
    bucket = torch.argmin(torch.abs(carry.rho[0][:, None] - brho[None, :]),
                          dim=1)
    m = unconv[None, :] & (bucket[None, :]
                           == torch.arange(G, device=dev)[:, None])
    idx, _, valid, overflow = compact_members(m, L2)
    gidx = idx.reshape(-1)

    def gather(a):
        return torch.where(valid[None, :], a[:, gidx], 0.0).contiguous()

    w2 = torch.cat([carry.z - carry.y, carry.v - carry.g], dim=0)
    warm = FusedCarry(gather(w2), gather(carry.y), gather(carry.g),
                      gather(carry.v), gather(carry.z))
    x0s2 = torch.where(valid[:, None], x0s[gidx], 0.0).contiguous()
    xs2, us2, it2, ok2 = fn2(bmaps, brho, *bounds, x0s2, warm)

    dest = torch.where(valid, gidx, B)
    merge = functools.partial(_merge, dest=dest)
    return AdaptivePipelineResult(
        xs=merge(xs1, xs2), us=merge(us1, us2), iters=merge(it1, m1 + it2),
        solved=merge(ok1, ok2),
        rho=merge(rho1, brho.repeat_interleave(L2).to(rho1.dtype)),
        unconv=unconv, overflow=overflow)
