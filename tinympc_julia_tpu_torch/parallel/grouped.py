"""Grouped batch solving: G distinct problems x L lanes each (counterpart of
tinympc_julia_tpu/parallel/grouped.py), the domain-randomised sweep.

``GroupedBatchSolver`` takes G-stacked Problems and Caches
(``types.stack_instances``) and (G, L, nx) initial states and returns
(G, L)-shaped solutions, with the method ladder of
``TinyMPCSolver.solve_batch``:

  * "standard"   the masked batched ADMM of parallel/batch.py, the problems
                 expanded per lane (any constraints, reference-ordered);
  * "condensed"  the grouped condensed maps (ops/condensed.py), one batched
                 matmul per iteration; adaptive rho rides the grouped Taylor
                 maps;
  * "fused"      kernel K1 (K2 with adaptive rho) on its group grid
                 (ops/cuda; float32);
  * "auto"       condensed while the G maps fit the memory budget, else
                 standard.

Per-lane semantics of every method are those of solving each group alone.
The fused kernels mask a ragged last tile, so lanes are never padded to a
tile and there is no tile argument; tolerances, rho, bounds and constraint
data reach the kernels at run time, so no kernel is cached per settings.
"""
from __future__ import annotations

import functools
import inspect
import math
import warnings
from typing import Optional

import numpy as np
import torch

from ..ops import condensed as cnd
from ..ops.cuda.adaptive_kernel import (AdaptiveFusedCarry, AdaptivePlant,
                                        make_condensed_adaptive_fused_solver)
from ..ops.cuda.condensed_kernel import (FusedCarry, fused_constraints,
                                         make_condensed_fused_solver,
                                         problem_constraint_kw)
from ..ops.rho import RHO_INTERVAL
from ..types import (Cache, Problem, Settings, expand_lanes, init_state,
                     stack_instances)
from . import batch as batch_mod
from .rebuild import compact_members

__all__ = ["GroupedBatchSolver", "expand_lanes", "stack_instances"]

# Below this many full-precision iterations after a reduced-precision phase,
# a problem with cone or halfspace constraints may stop converging: the bar
# the JAX package found on its hardware, kept as the warning's threshold
# (where it lies on the GPU is not measured).
SHORT_TAIL = 48


def _warn_short_highest_tail(settings, tail: int):
    if tail < SHORT_TAIL and (settings.en_input_soc or settings.en_state_soc
                              or settings.en_input_linear
                              or settings.en_state_linear):
        warnings.warn(
            f"bf16 staging leaves only {tail} full-precision iterations on "
            "a SOC/halfspace-constrained problem, fewer than the "
            f"{SHORT_TAIL} below which convergence may collapse; shrink the "
            "bf16 head or raise the iteration budget", stacklevel=3)


class GroupedBatchSolver:
    """Batched solves over G distinct problems x L lanes each.

    ``problems``/``caches`` carry a leading group axis on every tensor
    (``stack_instances`` of per-instance ``make_problem``/
    ``precompute_cache`` results); they name the device and the dtype."""

    def __init__(self, problems: Problem, caches: Cache,
                 settings: Optional[Settings] = None):
        if problems.A.ndim != 3:
            raise ValueError("problems must carry a leading group axis; "
                             "stack per-instance Problems with "
                             "stack_instances()")
        self.problems = problems
        self.caches = caches
        self.settings = settings if settings is not None else Settings()
        self.num_groups = problems.A.shape[0]
        self._maps = None
        self._taylor_maps = None
        # per-group straggler-slot overflow counts of the last
        # solve_batch(pipeline=...) call (None before any)
        self.last_overflow = None

    @property
    def nx(self) -> int:
        return self.problems.nx

    @property
    def nu(self) -> int:
        return self.problems.nu

    @property
    def N(self) -> int:
        return self.problems.N

    def maps(self):
        """The G-stacked condensed maps, built at first use."""
        if self._maps is None:
            self._maps = cnd.build_condensed(self.problems, self.caches)
        return self._maps

    def taylor_maps(self):
        """The G-stacked Taylor-expanded maps, built at first use."""
        if self._taylor_maps is None:
            self._taylor_maps = cnd.build_condensed_taylor(self.problems,
                                                           self.caches)
        return self._taylor_maps

    # -- solve ---------------------------------------------------------------

    def solve_batch(self, x0s, *, method: str = "auto", pipeline=None):
        """x0s: (G, L, nx) per-group initial states.  Returns tensors on the
        problems' device: (states (G, L, N, nx), controls (G, L, N-1, nu),
        iters (G, L), solved (G, L)).

        ``pipeline=(phase1_iters, straggler_slots, phase2_iters)`` routes
        the fused method through the two-phase straggler pipeline
        (``make_fused_pipeline``); a dict reaches every option of it, e.g.
        ``pipeline=dict(phase1_iters=100, straggler_slots=256,
        phase2_iters=1500, phase0_bf16_iters=128, phase2_bf16_head=512)``.
        A group with more unconverged lanes than ``straggler_slots`` leaves
        the overflow in its phase-1 state; the per-group overflow counts of
        the last pipeline solve are kept in ``self.last_overflow`` (a
        UserWarning fires when any is nonzero; reading them is the call's
        one host sync)."""
        p, s = self.problems, self.settings
        x0s = torch.as_tensor(np.asarray(x0s) if not isinstance(
            x0s, torch.Tensor) else x0s).to(p.device, p.dtype)
        if x0s.ndim != 3 or x0s.shape[0] != self.num_groups:
            raise ValueError(f"x0s must be (G={self.num_groups}, L, nx); got "
                             f"{tuple(x0s.shape)}")
        if s.adaptive_rho and s.adaptive_rho_rebuild and method != "standard":
            raise ValueError(
                "adaptive_rho_rebuild on the grouped condensed/fused paths "
                "is not supported (the Taylor maps would go stale); use "
                "method='standard'")
        if method == "auto":
            # per-group maps: the footprint scales with G
            fp = cnd.condensed_footprint_bytes(
                self.nx, self.nu, self.N,
                adaptive=s.adaptive_rho) * self.num_groups
            method = ("condensed" if fp <= cnd.AUTO_CONDENSED_BUDGET_BYTES
                      else "standard")
        if method == "fused":
            if pipeline is None:
                return self._solve_fused(x0s)
            if isinstance(pipeline, dict):
                pkw = dict(pipeline)
                slots = pkw.get(
                    "straggler_slots",
                    inspect.signature(self.make_fused_pipeline)
                    .parameters["straggler_slots"].default)
            else:
                mi1, slots, mi2 = pipeline
                pkw = dict(phase1_iters=mi1, straggler_slots=slots,
                           phase2_iters=mi2)
            fn = self.make_fused_pipeline(lanes=int(x0s.shape[1]), **pkw)
            *out, overflow = fn(x0s)
            self.last_overflow = overflow.cpu().numpy()
            if self.last_overflow.any():
                warnings.warn(
                    f"fused pipeline straggler_slots={slots} too small: "
                    f"per-group overflow {self.last_overflow.tolist()} "
                    "lanes kept their unconverged phase-1 state",
                    stacklevel=2)
            return tuple(out)
        if pipeline is not None:
            raise ValueError("pipeline= is only available with "
                             "method='fused'")
        if method == "condensed":
            if s.adaptive_rho:
                return cnd.solve_condensed_adaptive_grouped(
                    p, self.caches, s, x0s, self.taylor_maps())
            return cnd.solve_condensed_grouped(p, self.caches, s, x0s,
                                               self.maps())
        if method == "standard":
            G, L = x0s.shape[0], x0s.shape[1]
            st = batch_mod.set_x0_batch(
                batch_mod.broadcast_state(
                    init_state(self.nx, self.nu, self.N, dtype=p.dtype,
                               device=p.device), G * L),
                x0s.reshape(G * L, self.nx))
            _, _, sol = batch_mod.solve_batch(
                expand_lanes(p, L), expand_lanes(self.caches, L), s, st,
                problem_batched=True, cache_batched=True)
            return (sol.x.reshape(G, L, self.N, self.nx),
                    sol.u.reshape(G, L, self.N - 1, self.nu),
                    sol.iter.reshape(G, L), sol.solved.reshape(G, L))
        raise ValueError(f"unknown method: {method}")

    def _fused_constraint_spec(self) -> dict:
        """The constraint kwargs of the fused kernels' factories.  The
        structure (cone starts and dims, halfspace row counts) is shared by
        the groups by construction; the data (cone mus (G,), halfspace rows
        (G, m, dim)) may differ per group and rides the kernels' group
        grid."""
        return problem_constraint_kw(self.problems, self.settings)

    def _constraints_on_device(self):
        """The constraint spec as the tensors a kernel entry point takes."""
        p = self.problems
        return fused_constraints(**self._fused_constraint_spec(), nx=self.nx,
                                 nu=self.nu, dtype=p.dtype, device=p.device,
                                 num_groups=self.num_groups)

    def _fused_kernel(self, max_iter, fused=None, **extra):
        """One grouped fixed-rho fused solver (kernel K1); ``fused`` takes
        the place of the kernel's entry point (``make_fused_pipeline``)."""
        s = self.settings
        kwargs = dict(
            max_iter=max_iter, abs_pri_tol=float(s.abs_pri_tol),
            abs_dua_tol=float(s.abs_dua_tol),
            en_state_bound=s.en_state_bound, en_input_bound=s.en_input_bound,
            relaxation_alpha=s.relaxation_alpha,
            check_termination=s.check_termination,
            num_groups=self.num_groups)
        kwargs.update(extra)
        if fused is None:
            return make_condensed_fused_solver(
                self.nx, self.nu, self.N, **kwargs,
                **self._fused_constraint_spec())
        kwargs = dict(warm_start=False, carry_out=False) | kwargs
        return functools.partial(
            fused, nx=self.nx, nu=self.nu, N=self.N,
            constraints=self._constraints_on_device(), **kwargs)

    def _adaptive_fused_kernel(self, max_iter, fused=None, **extra):
        """One grouped adaptive-rho fused solver (kernel K2), with the full
        constraint stack; ``fused`` as in ``_fused_kernel``."""
        s, p, c = self.settings, self.problems, self.caches
        plant = (p.A, p.B, p.Q, p.R, c.Pinf, c.dPinf_drho)
        kwargs = dict(
            max_iter=max_iter, abs_pri_tol=float(s.abs_pri_tol),
            abs_dua_tol=float(s.abs_dua_tol),
            en_state_bound=s.en_state_bound, en_input_bound=s.en_input_bound,
            relaxation_alpha=s.relaxation_alpha,
            adaptive_rho_min=float(s.adaptive_rho_min),
            adaptive_rho_max=float(s.adaptive_rho_max),
            adaptive_rho_clipping=s.adaptive_rho_enable_clipping,
            check_termination=s.check_termination,
            controller=s.adaptive_rho_controller,
            taylor_trust=float(s.adaptive_rho_taylor_trust),
            num_groups=self.num_groups, **extra)
        if fused is None:
            return make_condensed_adaptive_fused_solver(
                *plant, self.N, **kwargs, **self._fused_constraint_spec())
        kwargs = dict(warm_start=False, carry_out=False) | kwargs
        return functools.partial(
            fused, plant=AdaptivePlant(*plant), nx=self.nx, nu=self.nu,
            N=self.N, constraints=self._constraints_on_device(), **kwargs)

    def _check_fused_settings(self):
        s = self.settings
        ct = s.check_termination
        if ct < 1 or s.max_iter % ct != 0:
            raise ValueError(
                "the fused path needs check_termination >= 1 dividing "
                f"max_iter (got {ct} / {s.max_iter})")
        if s.adaptive_rho:
            step = math.lcm(RHO_INTERVAL, ct)
            if s.max_iter % step != 0:
                raise ValueError(
                    "the fused adaptive path needs max_iter divisible by "
                    f"lcm(check_termination, {RHO_INTERVAL}) = {step} (the "
                    f"rho update interval; got max_iter={s.max_iter})")
        self._check_fused_dtype()

    def _check_fused_dtype(self):
        if self.problems.dtype != torch.float32:
            raise TypeError("the fused path is float32: build the problems "
                            "with dtype=torch.float32")

    def _bounds(self):
        p = self.problems
        return p.u_min, p.u_max, p.x_min, p.x_max

    def _solve_fused(self, x0s):
        """One launch of the grouped kernel over (G, L) lanes; box bounds,
        cone mus and halfspace rows may differ per group.  With adaptive rho
        kernel K2 runs per-lane rho on the per-group Taylor maps."""
        s = self.settings
        G, L = int(x0s.shape[0]), int(x0s.shape[1])
        self._check_fused_settings()
        if s.adaptive_rho:
            if s.bf16_head_iters:
                raise ValueError("bf16_head_iters is fixed-rho only (the rho "
                                 "prediction would read bf16-noise residuals)")
            fn = self._adaptive_fused_kernel(s.max_iter)
            xs, us, iters, solved, _ = fn(self.taylor_maps(), *self._bounds(),
                                          x0s)
        else:
            extra = {}
            if s.bf16_head_iters:
                _warn_short_highest_tail(s, s.max_iter - s.bf16_head_iters)
                extra["bf16_head_iters"] = s.bf16_head_iters
            fn = self._fused_kernel(s.max_iter, **extra)
            xs, us, iters, solved = fn(self.maps(), self.caches.rho,
                                       *self._bounds(), x0s)
        return (xs.reshape(G, L, self.N, self.nx),
                us.reshape(G, L, self.N - 1, self.nu), iters.reshape(G, L),
                solved.reshape(G, L))

    def make_fused_pipeline(self, *, phase1_iters: int = 100,
                            straggler_slots: int = 256,
                            phase2_iters: int = 300, lanes: int,
                            valid_lanes: Optional[int] = None,
                            phase0_bf16_iters: int = 0,
                            phase2_bf16_head: int = 0,
                            fused=None):
        """The two-phase grouped fused solve, free of host syncs.

        A block of the kernel runs until its slowest lane has latched, so
        one long solve re-runs converged lanes' warps for the stragglers'
        sake.  The pipeline does a bulk pass of ``phase1_iters``, compacts
        each group's unconverged lanes into ``straggler_slots`` per-group
        slots (per-group compaction keeps every lane with its group's maps)
        and continues them warm from their phase-1 carry for up to
        ``phase2_iters`` more: an exact continuation, so per-lane results
        equal a single solve of phase1 + phase2 iterations.

        Returns ``pipeline(x0s) -> (xs, us, iters, solved, overflow)`` over
        (G, lanes, nx) float32 x0s, with outputs on the device in the shapes
        and semantics of ``solve_batch`` (a phase-2 lane's count is
        phase1_iters plus its continuation's).  Where a group has more than
        ``straggler_slots`` stragglers the overflow keeps its unconverged
        phase-1 state, and ``overflow`` is the per-group (G,) int32 count of
        such lanes.

        ``valid_lanes`` (default: all) marks only the first ``valid_lanes``
        lanes of each group as real, for callers that pad: lanes beyond it
        are never given a phase-2 slot.

        ``phase0_bf16_iters`` (fixed rho only) prepends a bulk phase of that
        many reduced-precision iterations (``precision="default"``) at the
        settings' check cadence; lanes that latch there keep their phase-0
        result.  ``phase2_bf16_head`` (fixed rho only) gives the straggler
        continuation an in-kernel reduced-precision head of that many
        iterations (``bf16_head_iters``).  Both trade the bit-exact
        equivalence with one long full-precision solve for cheaper
        iterations; a lane still only ever latches on a full-precision
        rollout and residual.

        ``fused`` replaces the solver of each phase, as in
        ``parallel.pipeline``, by a function with the signature of
        ``condensed_fused_reference`` (``condensed_adaptive_reference`` with
        adaptive rho); measurements pass that plain version to time the
        same pipeline without the kernel."""
        s = self.settings
        self._check_fused_dtype()
        G, L, nx = self.num_groups, int(lanes), self.nx
        L2 = int(straggler_slots)
        # the budgets are phase1/phase2_iters; s.max_iter plays no part
        ct = s.check_termination
        if ct < 1:
            raise ValueError("the fused pipeline needs "
                             f"check_termination >= 1 (got {ct})")
        for what, iters in (("phase1_iters", phase1_iters),
                            ("phase2_iters", phase2_iters)):
            if iters % ct != 0:
                raise ValueError(
                    f"{what}={iters} must be a multiple of "
                    f"check_termination={ct} (the exact-continuation "
                    "guarantee needs phase boundaries on check iterations)")
        if L2 < 1:
            raise ValueError(f"straggler_slots={L2} must be >= 1")
        Lv = L if valid_lanes is None else int(valid_lanes)
        if not 0 < Lv <= L:
            raise ValueError(f"valid_lanes={Lv} must be in (0, lanes={L}]")
        k0 = int(phase0_bf16_iters)
        k2 = int(phase2_bf16_head)
        adaptive = s.adaptive_rho
        if (k0 or k2) and adaptive:
            raise ValueError("phase0_bf16_iters/phase2_bf16_head are "
                             "fixed-rho only (the rho prediction would read "
                             "bf16-noise residuals)")
        if k0 % ct != 0:
            raise ValueError(f"phase0_bf16_iters={k0} must be a multiple of "
                             f"check_termination={ct}")
        if k2 and (k2 % ct != 0 or k2 >= phase2_iters):
            raise ValueError(
                f"phase2_bf16_head={k2} must be a multiple of "
                f"check_termination={ct} below phase2_iters={phase2_iters}")
        if k2:
            _warn_short_highest_tail(s, phase2_iters - k2)
        if adaptive:
            step = math.lcm(RHO_INTERVAL, ct)
            for what, iters in (("phase1_iters", phase1_iters),
                                ("phase2_iters", phase2_iters)):
                if iters % step != 0:
                    raise ValueError(
                        f"{what}={iters} must be a multiple of "
                        f"lcm(check_termination, {RHO_INTERVAL}) = {step} "
                        "with adaptive rho")
            fn1 = self._adaptive_fused_kernel(phase1_iters, fused,
                                              carry_out=True)
            fn2 = self._adaptive_fused_kernel(phase2_iters, fused,
                                              warm_start=True)
            head = (self.taylor_maps(),)
            carry_cls = AdaptiveFusedCarry
        else:
            fn0 = None
            if k0:
                # phase 0 keeps the settings' check cadence, so a lane that
                # is done inside the reduced budget latches there
                fn0 = self._fused_kernel(k0, fused, carry_out=True,
                                         precision="default")
            fn1 = self._fused_kernel(phase1_iters, fused,
                                     warm_start=bool(k0), carry_out=True)
            extra2 = dict(bf16_head_iters=k2) if k2 else {}
            fn2 = self._fused_kernel(phase2_iters, fused, warm_start=True,
                                     **extra2)
            head = (self.maps(), self.caches.rho)
            carry_cls = FusedCarry
        bounds = self._bounds()
        dev = self.problems.device
        group_base = (torch.arange(G, device=dev) * L)[:, None]
        real = (torch.arange(L, device=dev) < Lv)[None, :]
        N, nu = self.N, self.nu

        def pipeline(x0s):
            x0s = x0s.to(torch.float32).reshape(G * L, nx)
            if adaptive:
                xs1, us1, it1, ok1, _, carry = fn1(*head, *bounds, x0s)
            elif k0:
                xs0, us0, it0, ok0, carry0 = fn0(*head, *bounds, x0s)
                xs1, us1, it1, ok1, carry = fn1(*head, *bounds, x0s, carry0)
                # lanes latched in the reduced phase keep what they latched
                done0 = ok0 == 1
                xs1 = torch.where(done0[:, None, None], xs0, xs1)
                us1 = torch.where(done0[:, None, None], us0, us1)
                it1 = torch.where(done0, it0, k0 + it1)
                ok1 = torch.maximum(ok0, ok1)
            else:
                xs1, us1, it1, ok1, carry = fn1(*head, *bounds, x0s)
            unconv = (ok1 == 0).reshape(G, L)
            if Lv < L:  # pad lanes are not real work
                unconv = unconv & real
            idx, _, valid, overflow = compact_members(unconv, L2)
            gidx = (idx + group_base).reshape(-1)
            warm = carry_cls(*(w[:, gidx].contiguous() for w in carry))
            x0s2 = x0s[gidx].contiguous()
            xs2, us2, it2, ok2 = fn2(*head, *bounds, x0s2, warm)[:4]
            # a slot past its group's straggler count re-selected the group's
            # lane 0: its result goes to a dump row that is cut off
            dest = torch.where(valid, gidx, G * L)

            def merge(a1, a2):
                ext = torch.cat([a1, a1[:1]], dim=0)
                return ext.index_copy(0, dest, a2)[:G * L]

            return (merge(xs1, xs2).reshape(G, L, N, nx),
                    merge(us1, us2).reshape(G, L, N - 1, nu),
                    merge(it1, k0 + phase1_iters + it2).reshape(G, L),
                    merge(ok1, ok2).reshape(G, L), overflow)

        return pipeline
