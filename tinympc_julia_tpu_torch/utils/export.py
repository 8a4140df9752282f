"""Ahead-of-time export of a solve (counterpart of
tinympc_julia_tpu/utils/export.py).

``export_solve`` traces the single-instance solve (``ops/admm.solve``) or
the batched one (``parallel/batch.solve_batch``) with its settings baked in,
through ``torch.export``, and serialises the program to bytes;
``load_solve`` gives back a callable ``(problem, cache, state) -> (state,
cache, solution)`` that runs the whole solve as one exported graph, on the
device the export was made on.

The eager solves loop in Python on a convergence flag read on the host,
which ``torch.export`` cannot trace.  Here the same iteration runs as a
``while_loop`` over a tensor counter and a tensor flag: the converged branch (no backward pass) and the check and
rho-update gates are selects, and the batched form freezes converged lanes
with ``admm.select_instances``, as the JAX package's vmapped while_loop
does.  Each stage update is the eager one (ops/admm.py, ops/rho.py), so a
loaded program gives the eager solve's iterates.  With
``adaptive_rho_rebuild`` the exact rebuild's Riccati fixed point is a
second ``while_loop`` inside the first (``_rebuild``): to the bit on one
instance, to rounding on a batch, whose instances run one batched fixed
point where the eager loop runs one each.

Problem, Cache, State, Solution and ConeSet travel as registered pytree
nodes; a ConeSet's ``starts``/``dims`` are its node's JSON context, not
leaves.
"""
from __future__ import annotations

import dataclasses
import io
import json

import torch
import torch.utils._pytree as pytree

from ..ops import admm
from ..ops import rho as rho_mod
from ..parallel.batch import broadcast_state
from ..types import (Cache, ConeSet, Problem, Settings, Solution, State,
                     map_tensors)
from .precision import full_fp32_matmul

_STATE = tuple(f.name for f in dataclasses.fields(State))
_CACHE = tuple(f.name for f in dataclasses.fields(Cache))
_RESIDUALS = ("primal_residual_state", "primal_residual_input",
              "dual_residual_state", "dual_residual_input")


def _register_pytrees():
    """Register the port's dataclasses with torch's pytree.  Keys are
    mapping keys: torch's guard code rewrites attribute paths by string
    substitution, which breaks on field names that extend others (``A``,
    ``Alin_x``)."""
    for cls in (Problem, Cache, State, Solution):
        names = tuple(f.name for f in dataclasses.fields(cls))
        pytree.register_pytree_node(
            cls,
            lambda o, names=names: ([getattr(o, n) for n in names], None),
            lambda leaves, _, cls=cls, names=names: cls(**dict(zip(names,
                                                                   leaves))),
            serialized_type_name=f"tinympc_julia_tpu_torch.{cls.__name__}",
            to_dumpable_context=lambda _: "null",
            from_dumpable_context=lambda _: None,
            flatten_with_keys_fn=lambda o, names=names: (
                [(pytree.MappingKey(n), getattr(o, n)) for n in names], None))
    pytree.register_pytree_node(
        ConeSet,
        lambda c: ([c.mus], (c.starts, c.dims)),
        lambda leaves, ctx: ConeSet(mus=leaves[0], starts=ctx[0],
                                    dims=ctx[1]),
        serialized_type_name="tinympc_julia_tpu_torch.ConeSet",
        to_dumpable_context=lambda ctx: json.dumps([list(ctx[0]),
                                                    list(ctx[1])]),
        from_dumpable_context=lambda s: tuple(tuple(v)
                                              for v in json.loads(s)),
        flatten_with_keys_fn=lambda c: ([(pytree.MappingKey("mus"), c.mus)],
                                        (c.starts, c.dims)))


_register_pytrees()


def _pack(state, cache, converged, i):
    return (tuple(getattr(state, n) for n in _STATE)
            + tuple(getattr(cache, n) for n in _CACHE) + (converged, i))


def _like(t, like):
    """A fresh copy of ``t`` with the strides of ``like``: a while_loop's
    body must return new tensors strided as its inputs, and a (1, n) tensor
    may come strided either way."""
    return torch.empty_strided(like.shape, like.stride(), dtype=like.dtype,
                               device=like.device).copy_(t)


def _unpack(flat):
    ns = len(_STATE)
    return (State(**dict(zip(_STATE, flat[:ns]))),
            Cache(**dict(zip(_CACHE, flat[ns:ns + len(_CACHE)]))),
            flat[-2], flat[-1])


def _rebuild(problem: Problem, cache: Cache, new_rho, move, *,
             max_iter: int = 1000, tol: float = 1e-5) -> Cache:
    """``rho.rebuild_update`` (warm, the eager defaults) of the instances
    that ``move`` selects, as a ``while_loop``: the Riccati fixed point of
    every moving instance runs in one batched loop, each instance stopping
    at its own step (one that does not move starts stopped), and ends where
    the eager loop ends.  ``new_rho``/``move`` are 0-d for one instance,
    (B,) beside a per-instance cache.  The loop carries the problem's
    matrices itself: torch's export refuses a nested loop that reaches
    them through closures."""
    from torch._higher_order_ops.while_loop import while_loop

    def ex(m):  # a per-instance mask against (..., r, c) tensors
        return m[..., None, None]

    def amax(t):
        return t.abs().amax(dim=(-2, -1))

    # two adds, as the setup folds them (rho.rebuild_update)
    Q1d = problem.Q - problem.rho_setup + new_rho[..., None] \
        + new_rho[..., None]
    R1d = problem.R - problem.rho_setup + new_rho[..., None] \
        + new_rho[..., None]

    def cond_fn(A, B, Q1d, R1d, Kp, Pp, K, P, i, done):
        return (i < max_iter) & (~done).any()

    def body_fn(A, B, Q1d, R1d, Kp, Pp, K, P, i, done):
        BtP = B.T @ Pp
        Kn = torch.linalg.solve(torch.diag_embed(R1d) + BtP @ B, BtP @ A)
        Pn = torch.diag_embed(Q1d) + A.T @ Pp @ (A - B @ Kn)
        stop = amax(Kn - Kp) < tol
        run = ~done
        # the last step's (K, P) is the result; the previous iterate
        # advances only on a step that does not stop (riccati_fixed_point)
        out = (A, B, Q1d, R1d,
               torch.where(ex(run & ~stop), Kn, Kp),
               torch.where(ex(run & ~stop), Pn, Pp),
               torch.where(ex(run), Kn, K), torch.where(ex(run), Pn, P),
               i + 1, done | stop)
        return tuple(_like(t, f) for t, f in zip(out, (A, B, Q1d, R1d, Kp,
                                                       Pp, K, P, i, done)))

    K0, P0 = cache.Kinf, cache.Pinf
    out = while_loop(cond_fn, body_fn, (
        problem.A.clone(), problem.B.clone(), Q1d, R1d, K0.clone(),
        P0.clone(), K0.clone(), P0.clone(),
        torch.zeros((), dtype=torch.int64, device=K0.device), ~move))
    A, B, K, P = problem.A, problem.B, out[6], out[7]
    Quu_inv = torch.linalg.inv(torch.diag_embed(R1d)
                               + B.transpose(-1, -2) @ P @ B)
    AmBKt = (A - B @ K).transpose(-1, -2)
    new = cache.replace(rho=new_rho, Kinf=K, Pinf=P, Quu_inv=Quu_inv,
                        AmBKt=AmBKt, C1=Quu_inv, C2=AmBKt)
    return map_tensors(
        lambda a, b: _like(torch.where(move.reshape(move.shape + (1,) * (
            a.ndim - move.ndim)), a, b), b), new, cache)


def _traced_loop(problem: Problem, settings: Settings, state: State,
                 cache: Cache, *, batched: bool, horizon_parallel: bool):
    """The ADMM loop as a ``while_loop`` (see the module docstring).
    Returns the final (state, cache, converged)."""
    from torch._higher_order_ops.while_loop import while_loop

    forward, backward = admm._passes(problem, horizon_parallel, None)
    dt, dev = state.x.dtype, state.x.device
    pri_tol = torch.tensor(settings.abs_pri_tol, dtype=dt, device=dev)
    dua_tol = torch.tensor(settings.abs_dua_tol, dtype=dt, device=dev)
    ct = settings.check_termination

    def cond_fn(*flat):
        converged, i = flat[-2], flat[-1]
        running = ~converged
        return (i < settings.max_iter) & (running.any() if batched
                                          else running)

    def body_fn(*flat):
        st0, ca0, converged0, i = _unpack(flat)
        st = forward(st0, ca0)
        st = admm.update_slack(st, problem, settings)
        st = admm.update_dual(st, settings)
        st = admm.update_linear_cost(st, problem, ca0)
        st = st.replace(iter=st.iter + 1)
        ca = ca0
        if settings.adaptive_rho:
            update = (i > 0) & (i % rho_mod.RHO_INTERVAL == 0)
            if settings.adaptive_rho_rebuild:
                new_rho = rho_mod._predicted_rho(st, ca, problem, settings)
                ca = _rebuild(problem, ca, new_rho,
                              update & (new_rho != ca.rho))
            else:
                ca = map_tensors(
                    lambda a, b: torch.where(update, a, b),
                    rho_mod.adapt_rho(st, ca, problem, settings), ca)
        if ct > 0:
            check = (i + 1) % ct == 0
            res = admm.compute_residuals(st, ca)
            st = st.replace(**{n: torch.where(check, v, getattr(st, n))
                               for n, v in zip(_RESIDUALS, res)})
            pri_s, pri_i, dua_s, dua_i = res
            conv = check & ((pri_s < pri_tol) & (pri_i < pri_tol)
                            & (dua_s < dua_tol) & (dua_i < dua_tol))
        else:
            conv = torch.zeros_like(converged0)
        st = st.replace(status=torch.where(
            conv, torch.full_like(st.status, admm.TINY_SOLVED), st.status))
        # the converging iteration runs no backward pass and leaves v/z as
        # they were
        st = admm.select_instances(
            conv, st, backward(st.replace(v=st.vnew, z=st.znew), ca))
        if batched:  # freeze the lanes that had converged before
            st = admm.select_instances(converged0, st0, st)
            if settings.adaptive_rho:
                ca = admm.select_instances(converged0, ca0, ca)
            conv = converged0 | conv
        return tuple(_like(t, f)
                     for t, f in zip(_pack(st, ca, conv, i + 1), flat))

    lanes = (state.x.shape[0],) if batched else ()
    state = state.replace(
        status=torch.full(lanes, admm.TINY_UNSOLVED, dtype=torch.int32,
                          device=dev),
        iter=torch.zeros(lanes, dtype=torch.int32, device=dev))
    if batched and settings.adaptive_rho and cache.Kinf.ndim == 2:
        cache = broadcast_state(cache, lanes[0])
    out = while_loop(cond_fn, body_fn, _pack(
        state, cache, torch.zeros(lanes, dtype=torch.bool, device=dev),
        torch.zeros((), dtype=torch.int64, device=dev)))
    st, ca, converged, _ = _unpack(out)
    return st, ca, converged


class _Solve(torch.nn.Module):
    def __init__(self, settings, batched, horizon_parallel):
        super().__init__()
        self.settings = settings
        self.batched = batched
        self.horizon_parallel = horizon_parallel

    def forward(self, problem, cache, state):
        st, ca, converged = _traced_loop(
            problem, self.settings, state, cache, batched=self.batched,
            horizon_parallel=self.horizon_parallel)
        return st, ca, Solution(iter=st.iter, solved=converged.to(torch.int32),
                                x=st.vnew, u=st.znew)


@full_fp32_matmul()
def export_solve(problem: Problem, cache: Cache, settings: Settings,
                 state: State, *, horizon_parallel: bool = False,
                 batched: bool = False) -> bytes:
    """Serialise the solve specialised to these shapes and settings.

    ``batched=False`` exports ``admm.solve`` on one instance;
    ``batched=True`` exports ``batch.solve_batch`` on a batched ``state``
    (``batch.broadcast_state``, ``set_x0_batch``) with a shared problem and
    a shared or per-lane cache.  The program runs on the device of the
    given tensors."""
    with torch.no_grad():
        ep = torch.export.export(_Solve(settings, batched, horizon_parallel),
                                 (problem, cache, state))
    # the example inputs would be pickled beside the program
    ep.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def load_solve(blob: bytes):
    """The exported solve of ``export_solve``: a callable
    ``(problem, cache, state) -> (state, cache, solution)``."""
    module = torch.export.load(io.BytesIO(blob)).module()

    @full_fp32_matmul()
    def call(problem, cache, state):
        with torch.no_grad():
            return module(problem, cache, state)

    return call
