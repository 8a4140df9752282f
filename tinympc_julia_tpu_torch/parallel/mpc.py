"""Closed-loop MPC over a batch of plants, the whole control loop (re-plan,
apply, simulate) on the problem's device (counterpart of
tinympc_julia_tpu/parallel/mpc.py).

Per control step: a batched warm-started ADMM solve, the first control of
each plan, and the plant update ``x' = A x + B u + f`` (the plant is the
problem's own model).  Three loops, as in the JAX package:

* ``run_mpc_loop``: the reference-ordered batched solve
  (parallel/batch.py) with the solver workspace persisting from step to
  step, any constraints, adaptive rho, float64 if wanted;
* ``run_mpc_loop_condensed``: the condensed solve with its carry passed
  from step to step; the maps are built once with zero references, which
  re-enter every step through ``condensed.ref_backward_const``;
* ``make_fused_mpc_loop`` / ``run_mpc_loop_fused``: every solve one launch
  of kernel K1 (ops/cuda/condensed_kernel.py), chained through its
  ``FusedCarry``: the serving configuration.  Nothing in that loop waits
  for the host: no value is read back between the first launch and the
  last, and the per-step results go into preallocated (B, n_steps, ...)
  tensors.

The JAX loops are ``lax.scan`` programs; these are Python loops that enqueue
one step after another.  Every loop runs its fp32 matmuls in full fp32 (TF32
off) and puts the flag back when it ends.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import torch

from ..ops import condensed as cond
from ..ops.cuda.condensed_kernel import make_condensed_fused_solver
from ..types import Cache, Problem, Settings, State, init_state
from ..utils.precision import full_fp32_matmul
from . import batch as batch_mod


class MPCLoopResult(NamedTuple):
    xs: torch.Tensor      # (B, n_steps, nx)  plant states visited
    us: torch.Tensor      # (B, n_steps, nu)  first controls applied
    iters: torch.Tensor   # (B, n_steps)      ADMM iterations per solve
    solved: torch.Tensor  # (B, n_steps)
    state: State          # final warm-started solver workspace (B, ...)
    cache: Cache          # final cache (per-instance under adaptive rho)


class CondensedMPCLoopResult(NamedTuple):
    xs: torch.Tensor      # (B, n_steps, nx)
    us: torch.Tensor      # (B, n_steps, nu)
    iters: torch.Tensor   # (B, n_steps)
    solved: torch.Tensor  # (B, n_steps)


def _plant_step(problem: Problem, x, u0):
    return x @ problem.A.T + u0 @ problem.B.T + problem.f


def _outputs(B, n_steps, nx, nu, dtype, dev):
    """Preallocated per-step results (xs, us, iters, solved)."""
    return (torch.empty((B, n_steps, nx), dtype=dtype, device=dev),
            torch.empty((B, n_steps, nu), dtype=dtype, device=dev),
            torch.empty((B, n_steps), dtype=torch.int32, device=dev),
            torch.empty((B, n_steps), dtype=torch.int32, device=dev))


def _schedule(problem, n_steps, Xrefs, Urefs, dtype, dev):
    """The per-step references as tensors ((n_steps, N, nx), (n_steps, N-1,
    nu)); zeros for a missing ``Urefs``; (None, None) without a schedule."""
    if Xrefs is None:
        return None, None
    Xrefs = torch.as_tensor(Xrefs).to(dev, dtype)
    if Urefs is None:
        Urefs = torch.zeros((n_steps, problem.N - 1, problem.nu),
                            dtype=dtype, device=dev)
    else:
        Urefs = torch.as_tensor(Urefs).to(dev, dtype)
    return Xrefs, Urefs


def run_mpc_loop(problem: Problem, cache: Cache, settings: Settings, x0s,
                 n_steps: int, *, Xrefs=None, Urefs=None,
                 horizon_parallel: bool = False) -> MPCLoopResult:
    """Batched closed-loop MPC for ``n_steps`` steps on the reference-ordered
    path.

    ``x0s``: (B, nx) initial plant states.  ``Xrefs``/``Urefs`` optionally
    give a per-step reference schedule ((n_steps, N, nx)/(n_steps, N-1, nu),
    shared by the batch: the rocket's moving reference).  The solver
    workspace persists across steps (the reference's warm start); under
    adaptive rho a shared cache becomes per-instance and is carried too.
    ``horizon_parallel`` runs the horizon recursions as associative scans
    (ops/scans.py)."""
    B = x0s.shape[0]
    nx, nu, N = problem.nx, problem.nu, problem.N
    dtype, dev = x0s.dtype, x0s.device
    state = batch_mod.broadcast_state(
        init_state(nx, nu, N, device=dev, dtype=dtype), B)
    cache_batched = settings.adaptive_rho
    if cache_batched:
        cache = batch_mod.broadcast_state(cache, B)
    Xrefs, Urefs = _schedule(problem, n_steps, Xrefs, Urefs, dtype, dev)
    xs, us, iters, solved = _outputs(B, n_steps, nx, nu, dtype, dev)

    x = x0s
    with full_fp32_matmul():
        for t in range(n_steps):
            prob = problem
            if Xrefs is not None:
                prob = problem.replace(Xref=Xrefs[t], Uref=Urefs[t])
            state = batch_mod.set_x0_batch(state, x)
            state, cache, sol = batch_mod.solve_batch(
                prob, cache, settings, state, cache_batched=cache_batched,
                horizon_parallel=horizon_parallel)
            u0 = sol.u[:, 0, :]
            xs[:, t], us[:, t] = x, u0
            iters[:, t], solved[:, t] = sol.iter, sol.solved
            x = _plant_step(problem, x, u0)
    return MPCLoopResult(xs=xs, us=us, iters=iters, solved=solved,
                         state=state, cache=cache)


def run_mpc_loop_condensed(problem: Problem, cache: Cache, settings: Settings,
                           x0s, n_steps: int, *, Xrefs=None, Urefs=None
                           ) -> CondensedMPCLoopResult:
    """Batched closed-loop MPC on the condensed path.

    The contract of ``run_mpc_loop`` (warm-started solves, optional per-step
    reference schedules), each solve through the condensed maps, which are
    built once for zero references; the references re-enter each step
    through ``ref_backward_const``, so nothing is rebuilt inside the loop.
    The carry starts at zeros and passes from step to step.  Condensed
    scope: fixed rho, one shared problem."""
    if settings.adaptive_rho:
        raise ValueError("the condensed MPC loop is fixed-rho; adaptive rho "
                         "runs through run_mpc_loop")
    B = x0s.shape[0]
    nx, nu, N = problem.nx, problem.nu, problem.N
    su, sx = (N - 1) * nu, N * nx
    dtype, dev = x0s.dtype, x0s.device
    maps = cond.build_condensed(
        problem.replace(Xref=torch.zeros_like(problem.Xref),
                        Uref=torch.zeros_like(problem.Uref)), cache)
    Xrefs, Urefs = _schedule(problem, n_steps, Xrefs, Urefs, dtype, dev)
    xs, us, iters, solved = _outputs(B, n_steps, nx, nu, dtype, dev)
    zu = torch.zeros((su, B), dtype=dtype, device=dev)
    zx = torch.zeros((sx, B), dtype=dtype, device=dev)
    warm = cond.CondensedCarry(d=zu, y=zu, g=zx, v=zx, z=zu)
    d_ref = cond.ref_backward_const(problem, cache)

    x = x0s
    with full_fp32_matmul():
        for t in range(n_steps):
            if Xrefs is not None:
                d_ref = cond.ref_backward_const(problem, cache, Xrefs[t],
                                                Urefs[t])
            _, us_plan, it, ok, warm = cond._solve_condensed_impl(
                problem, cache, settings, x, maps, warm, d_ref=d_ref)
            u0 = us_plan[:, 0, :]
            xs[:, t], us[:, t], iters[:, t], solved[:, t] = x, u0, it, ok
            x = _plant_step(problem, x, u0)
    return CondensedMPCLoopResult(xs=xs, us=us, iters=iters, solved=solved)


def make_fused_mpc_loop(problem: Problem, cache: Cache, settings: Settings,
                        n_steps: int, *, fused: Optional[Callable] = None):
    """Build a closed-loop MPC runner with every solve inside the fused
    condensed kernel K1, chained across control steps through the kernel's
    warm-start carry: ``n_steps`` launches, no host read between them.

    Scope: box constraints, fixed rho, fixed references (baked into the
    maps), the problem's dtype and device (float32 on the card).  The carry
    semantics are those of ``run_mpc_loop_condensed``.  Step 0 is a cold
    launch (d = 0); later steps are warm launches from the previous step's
    ``FusedCarry``.  The two entries differ (w2 = 0 is not d = 0 once
    references are baked into the maps), so the first step stands apart.

    Returns ``loop_fn(x0s (B, nx)) -> CondensedMPCLoopResult``; hold onto it:
    the maps are built here, once.  ``fused`` replaces the solver of every
    step by a function with ``condensed_fused_reference``'s signature;
    tests and measurements pass the plain version to run the same loop
    without the kernel."""
    s = settings
    if (s.adaptive_rho or s.en_input_soc or s.en_state_soc
            or s.en_input_linear or s.en_state_linear):
        raise ValueError("fused MPC loop supports box constraints and fixed "
                         "rho; use run_mpc_loop / run_mpc_loop_condensed")
    if s.check_termination < 1:
        raise ValueError(
            "check_termination=0 (never check) is not supported by the fused "
            "loop; use run_mpc_loop_condensed")
    if s.max_iter % s.check_termination != 0:
        raise ValueError(
            "the fused loop needs check_termination to divide max_iter "
            f"(got {s.check_termination} / {s.max_iter})")
    nx, nu, N = problem.nx, problem.nu, problem.N
    dtype, dev = problem.dtype, problem.device

    maps = cond.build_condensed(problem, cache)
    kw = dict(nx=nx, nu=nu, N=N, max_iter=s.max_iter,
              abs_pri_tol=s.abs_pri_tol, abs_dua_tol=s.abs_dua_tol,
              en_state_bound=s.en_state_bound,
              en_input_bound=s.en_input_bound,
              relaxation_alpha=s.relaxation_alpha,
              check_termination=s.check_termination, carry_out=True)
    if fused is None:
        fn_cold = make_condensed_fused_solver(warm_start=False, **kw)
        fn_warm = make_condensed_fused_solver(warm_start=True, **kw)
    else:
        fn_cold = functools.partial(fused, warm_start=False, **kw)
        fn_warm = functools.partial(fused, warm_start=True, **kw)
    args = (maps, cache.rho, problem.u_min, problem.u_max, problem.x_min,
            problem.x_max)

    def loop_fn(x0s) -> CondensedMPCLoopResult:
        x = torch.as_tensor(x0s).to(dev, dtype).contiguous()
        B = x.shape[0]
        xs, us, iters, solved = _outputs(B, n_steps, nx, nu, dtype, dev)
        warm = None
        with full_fp32_matmul():
            for t in range(n_steps):
                fn = fn_cold if t == 0 else fn_warm
                _, us_plan, it, ok, warm = fn(*args, x, warm)
                u0 = us_plan[:, 0, :]
                xs[:, t], us[:, t], iters[:, t], solved[:, t] = x, u0, it, ok
                x = _plant_step(problem, x, u0)
        return CondensedMPCLoopResult(xs=xs, us=us, iters=iters,
                                      solved=solved)

    return loop_fn


def run_mpc_loop_fused(problem: Problem, cache: Cache, settings: Settings,
                       x0s, n_steps: int, *,
                       fused: Optional[Callable] = None
                       ) -> CondensedMPCLoopResult:
    """One-shot wrapper over ``make_fused_mpc_loop`` (it builds the maps at
    every call; hold the factory's ``loop_fn`` when calling repeatedly)."""
    return make_fused_mpc_loop(problem, cache, settings, n_steps,
                               fused=fused)(x0s)
