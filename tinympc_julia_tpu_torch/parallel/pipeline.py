"""The three-phase straggler pipeline of the headline workload (the
``_pipeline`` that bench.py builds inline around the JAX fused kernel).

  phase 0  cold pass over every lane, ``check_termination`` = its whole
           budget (one end check), carry out;
  phase 1  warm polish of every lane from that carry (ct = 4), carry out;
  phase 2  the lanes still unconverged are compacted into a fixed number of
           straggler slots (index-0 fill) and continue warm from their
           carry (exact continuation, ct = 4).

All three phases run kernel K1 in full fp32.  Nothing in the pipeline waits
for the host: the compaction is a cumsum and a scatter.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import torch

from ..ops.cuda.condensed_kernel import (FusedCarry,
                                         make_condensed_fused_solver)
from .rebuild import compact_members

# The headline workload's settings (bench.py's _pipeline): box-bounded
# inputs, no state bound, tolerance 1e-3, over-relaxation 1.7, residual
# checks every 4 iterations in the warm phases.
BUDGETS = (56, 36, 324)
CHECK_TERMINATION = 4
RELAXATION_ALPHA = 1.7
TOL = 1e-3


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

    def total_iters(self, phase0_iters: int) -> torch.Tensor:
        """ADMM iterations run: phase 0's full budget on every lane, the
        phase-1 counts, and the phase-2 counts of valid slots."""
        return (phase0_iters * self.iters1.numel() + self.iters1.sum()
                + (self.iters2 * self.valid).sum())


def three_phase_solve(maps, rho, u_min, u_max, x_min, x_max, x0s, *, nx, nu,
                      N, straggler_slots: int, budgets=BUDGETS,
                      fused: Optional[Callable] = None) -> PipelineResult:
    """Run the pipeline on ``x0s`` (B, nx); arguments as for the fused
    solver (``rho`` a float).  Lanes that overflow ``straggler_slots`` keep
    their phase-1 result.

    ``budgets`` are the phases' iteration budgets; only the CPU test against
    the JAX pipeline shortens phase 0, to bound the Pallas kernel's
    interpret-mode compile.  ``fused`` replaces the solver of each phase by
    a function with ``condensed_fused_reference``'s signature; measurements
    pass the plain version to time the same pipeline without the kernel."""
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
                carry_out=True)
    fn1 = phase(max_iter=m1, check_termination=ct, warm_start=True,
                carry_out=True)
    fn2 = phase(max_iter=m2, check_termination=ct, warm_start=True,
                carry_out=False)
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

    def merge(a1, a2):
        ext = torch.cat([a1, a1[:1]], dim=0)
        return ext.index_copy(0, dest, a2)[:B]

    return PipelineResult(xs=merge(xs1, xs2), us=merge(us1, us2), iters1=it1,
                          solved1=ok1, idx=idx, iters2=it2, solved2=ok2,
                          unconv=unconv, valid=valid)
