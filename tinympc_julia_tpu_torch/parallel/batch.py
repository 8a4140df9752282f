"""Batched solving on the reference-ordered path (counterpart of
tinympc_julia_tpu/parallel/batch.py).

Two loop strategies:

* ``solve_batch``: the ADMM iteration of ops/admm.py run on a leading batch
  axis, with explicit per-instance masking: a converged instance freezes (so
  its result equals solving it alone, the reference's early return), and
  the loop stops when every instance has converged or ``max_iter`` is hit.
* ``solve_vmap``: a plain loop over the instances through ``admm.solve``,
  the cross-check of the tests.

``problem``/``cache`` may be shared or carry a leading per-instance axis;
say which with ``problem_batched``/``cache_batched``.  This is the
``standard`` method of the solvers: any constraints, float64 if wanted, one
host read of the convergence count per iteration.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..ops import admm
from ..types import (Cache, Problem, Settings, Solution, State,
                     index_instance, map_tensors, stack_instances)
from ..utils.precision import full_fp32_matmul


def broadcast_state(tree, batch: int):
    """Tile a single-instance workspace (or cache) to a leading batch
    axis."""
    return map_tensors(lambda a: a.expand((batch,) + a.shape).clone(), tree)


def set_x0_batch(state: State, x0s) -> State:
    """Set per-instance initial states; ``x0s`` has shape (B, nx)."""
    x = state.x.clone()
    x[:, 0, :] = x0s
    return state.replace(x=x)


def _check_batched(tree, batched: bool, probe, ndim: int, what: str):
    has = probe.ndim == ndim + 1
    if probe.ndim not in (ndim, ndim + 1) or has != batched:
        raise ValueError(f"{what}_batched={batched} but {what} arrays are "
                         f"{'per-instance' if has else 'shared'} "
                         f"({tuple(probe.shape)})")


@full_fp32_matmul()
def solve_batch(problem: Problem, cache: Cache, settings: Settings,
                state: State, *, horizon_parallel: bool = False,
                problem_batched: bool = False, cache_batched: bool = False,
                unconverged_count_fn=None, chunk_maps=None
                ) -> Tuple[State, Cache, Solution]:
    """Batched ADMM with per-instance freezing and a whole-batch stop.
    ``state`` is a batched workspace (``broadcast_state``, ``set_x0_batch``).

    ``unconverged_count_fn`` (optional) maps the bool vector of instances
    still running to the count the loop stops on; a layer that spreads the
    batch over several devices puts its sum across them here.

    With adaptive rho the instances' rhos diverge, so a shared cache is
    promoted to per-instance; the returned cache is then batched.
    ``chunk_maps`` and ``horizon_parallel`` select the long-horizon forms of
    the horizon recursions (ops/scans.py)."""
    admm.check_chunk_maps(settings, chunk_maps)
    _check_batched(problem, problem_batched, problem.A, 2, "problem")
    _check_batched(cache, cache_batched, cache.Kinf, 2, "cache")
    batch = state.x.shape[0]
    dev = state.x.device
    if settings.adaptive_rho and not cache_batched:
        cache = broadcast_state(cache, batch)
        cache_batched = True

    state = state.replace(
        status=torch.full((batch,), admm.TINY_UNSOLVED, dtype=torch.int32,
                          device=dev),
        iter=torch.zeros((batch,), dtype=torch.int32, device=dev))
    converged = torch.zeros((batch,), dtype=torch.bool, device=dev)
    count = unconverged_count_fn or torch.sum
    i = 0
    while i < settings.max_iter and int(count(~converged)) > 0:
        new_st, new_ca, new_conv = admm.batched_body(
            problem, settings, state, cache, i,
            horizon_parallel=horizon_parallel, chunk_maps=chunk_maps)
        # freeze the instances that had converged before this iteration
        if cache_batched:
            cache = admm.select_instances(converged, cache, new_ca)
        state = admm.select_instances(converged, state, new_st)
        converged = converged | new_conv
        i += 1

    solution = Solution(iter=state.iter, solved=converged.to(torch.int32),
                        x=state.vnew, u=state.znew)
    return state, cache, solution


def solve_vmap(problem: Problem, cache: Cache, settings: Settings,
               state: State, *, horizon_parallel: bool = False,
               problem_batched: bool = False, cache_batched: bool = False
               ) -> Tuple[State, Cache, Solution]:
    """One ``admm.solve`` per instance, stacked: the cross-check of
    ``solve_batch``."""
    outs = []
    for b in range(state.x.shape[0]):
        outs.append(admm.solve(
            index_instance(problem, b) if problem_batched else problem,
            index_instance(cache, b) if cache_batched else cache,
            settings, index_instance(state, b),
            horizon_parallel=horizon_parallel))
    states, caches, sols = zip(*outs)
    return (stack_instances(states), stack_instances(caches),
            stack_instances(sols))
