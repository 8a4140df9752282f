"""Sharded solving over the ranks of a mesh, with the convergence vote
(counterpart of tinympc_julia_tpu/parallel/sharded.py).

MPC instances are independent, so the batch splits cleanly into rank blocks
(parallel/mesh.py).  The one place the ranks must agree is the stop of the
batched loop: with the vote, each iteration's count of running instances is
summed over the ranks (``all_reduce``, the JAX package's ``lax.psum``), so
every rank runs the same number of iterations and calls the collective the
same number of times.  Without it, each rank loops alone.  Vote or not,
every call starts with one ``all_gather`` of the ranks' block sizes (the
JAX package's solve without the vote communicates not at all), so that
blocks of unequal size raise on every rank instead of leaving one rank
waiting in a collective.  The collectives reduce host tensors, so the
group's backend is gloo, which also lets several ranks share one card.
``map_shards`` runs a lane-local function, such as a straggler pipeline,
on a rank's block, as ``shard_map`` does in the JAX package's mesh
pipelines; it calls no collective.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.distributed as dist

from ..types import Cache, Problem, Settings, Solution, State
from . import batch as batch_mod
from .mesh import (BATCH_AXIS, Mesh, batch_sharding, check_divisible,
                   leading_size, replicated)


def block_sizes(mesh: Mesh, b: int) -> list:
    """Every rank's block size, gathered on every rank (one ``all_gather``,
    run by ``solve_sharded`` on every call, vote or not)."""
    if mesh.group is None:
        return [b]
    mine = torch.tensor([b], dtype=torch.int64)
    sizes = [torch.empty_like(mine) for _ in range(mesh.world)]
    dist.all_gather(sizes, mine, group=mesh.group)
    return [int(s) for s in sizes]


def running_vote(mesh: Mesh) -> Callable:
    """The ``unconverged_count_fn`` of the vote: the block's running count
    summed over the mesh's ranks, as a host tensor (the loop reads the
    count on the host each iteration anyway)."""

    def count(running):
        n = running.sum().to(device="cpu", dtype=torch.int64)
        dist.all_reduce(n, op=dist.ReduceOp.SUM, group=mesh.group)
        return n

    return count


def solve_sharded(problem: Problem, cache: Cache, settings: Settings,
                  state: State, mesh: Mesh, *,
                  axis_name: str = BATCH_AXIS,
                  vote: bool = True,
                  horizon_parallel: bool = False,
                  problem_batched: bool = False,
                  cache_batched: bool = False
                  ) -> Tuple[State, Cache, Solution]:
    """Solve this rank's block ``state`` (``shard_state`` of the global
    batch) with the batched loop of ``parallel.batch.solve_batch``.

    ``problem``/``cache`` are global: whole on every rank, or with
    ``*_batched`` per instance over the global batch, of which the rank
    takes its block.  Returns the rank's blocks on its device, no gather:
    the state and solution, and the cache (per instance for the block where
    it was batched or ``settings.adaptive_rho`` makes it so).

    Blocks of unequal size, which no global batch the mesh divides can
    give, raise the same ``ValueError`` on every rank before the loop."""
    sizes = block_sizes(mesh, state.x.shape[0])
    B = sum(sizes)
    check_divisible(B, mesh.world)
    if len(set(sizes)) != 1:
        raise ValueError(f"rank blocks of unequal sizes {sizes}")
    split = batch_sharding(mesh, axis_name)
    whole = replicated(mesh)
    for tree, batched, what in ((problem, problem_batched, "problem"),
                                (cache, cache_batched, "cache")):
        if batched and leading_size(tree) != B:
            raise ValueError(f"{what}_batched: {leading_size(tree)} "
                             f"instances for a global batch of {B}")
    problem = (split if problem_batched else whole).local(problem)
    cache = (split if cache_batched else whole).local(cache)
    state = whole.local(state)
    count = running_vote(mesh) if vote and mesh.group is not None else None
    return batch_mod.solve_batch(
        problem, cache, settings, state, horizon_parallel=horizon_parallel,
        problem_batched=problem_batched, cache_batched=cache_batched,
        unconverged_count_fn=count)


def jit_solve_sharded(problem: Problem, cache: Cache, settings: Settings,
                      state: State, mesh: Mesh, **kw):
    """``solve_sharded`` under the JAX package's name for its compiled
    form; eager PyTorch has nothing to compile."""
    return solve_sharded(problem, cache, settings, state, mesh, **kw)


def map_shards(fn: Callable, mesh: Mesh, x0s: torch.Tensor):
    """``fn`` on this rank's block of the global lanes ``x0s`` (B, ...), on
    the mesh's device: ``shard_map(fn, in_specs=P(axis))`` over a
    lane-local function.  Returns the rank's outputs."""
    return fn(batch_sharding(mesh).local(x0s))
