"""The reference-ordered ADMM solve of one instance (counterpart of
tinympc_julia_tpu/ops/admm.py).

Update ordering reproduces the reference exactly, quirks included:
  * iteration 0 runs the slack, dual and linear-cost updates on the initial
    trajectory before the first backward pass;
  * the solution is the slack iterates vnew/znew;
  * on the converging iteration v, z, p and d are not advanced (the
    reference returns before the slack copy and the backward pass);
  * residuals are stored only on check iterations;
  * with adaptive rho, the cache is updated every 5th iteration (never on
    iteration 0) before that iteration's residual check;
  * p_N uses Pinf.T @ Xref[-1].

This is the single-instance oracle the batched paths are held against, not a
hot path: the outer loop and the horizon recursions are Python loops over
small tensors, and the loop reads its convergence flag on the host once per
iteration.  For long horizons the recursions run chunked or as associative
scans (ops/scans.py).

Every stage update also runs with a leading batch axis on the state, and on
the problem or the cache where they differ per instance (their tensors
broadcast); ``batched_body`` is one masked iteration of a whole batch, the
loop body of parallel/batch.py.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..types import Cache, Problem, Settings, Solution, State, map_tensors
from ..utils.precision import full_fp32_matmul
from . import projections, scans
from . import rho as rho_mod

TINY_SOLVED = 1
TINY_UNSOLVED = 11


def _mv(M, v):
    """M @ v on the trailing axes, any leading batch axes on either."""
    if M.ndim == 2 and v.ndim == 1:
        return M @ v
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def _ex(t, n):
    """``t`` with n trailing axes of 1 (a 0-d tensor stays as it is), so a
    per-instance scalar multiplies a per-instance array."""
    return t.reshape(t.shape + (1,) * n) if t.ndim else t


# ---------------------------------------------------------------------------
# Stage updates (one ADMM iteration's building blocks)
# ---------------------------------------------------------------------------

def forward_pass(state: State, problem: Problem, cache: Cache) -> State:
    """LQR-feedback rollout: u_i = -Kinf x_i - d_i;
    x_{i+1} = A x_i + B u_i + f."""
    A, B, f, K = problem.A, problem.B, problem.f, cache.Kinf
    xs = [state.x[..., 0, :]]
    us = []
    for i in range(state.d.shape[-2]):
        u_i = -_mv(K, xs[-1]) - state.d[..., i, :]
        us.append(u_i)
        xs.append(_mv(A, xs[-1]) + _mv(B, u_i) + f)
    return state.replace(x=torch.stack(xs, dim=-2),
                         u=torch.stack(us, dim=-2))


def _relaxed(settings: Settings, state: State):
    """Over-relaxed iterates u_hat/x_hat (alpha = 1 gives the reference's
    plain u/x; z/v are the previous slack iterates)."""
    a = settings.relaxation_alpha
    if a == 1.0:
        return state.u, state.x
    return a * state.u + (1.0 - a) * state.z, a * state.x + (1.0 - a) * state.v


def update_slack(state: State, problem: Problem, settings: Settings) -> State:
    """znew = u_hat + y, vnew = x_hat + g, then box -> linear -> SOC."""
    u_hat, x_hat = _relaxed(settings, state)
    znew = u_hat + state.y
    vnew = x_hat + state.g
    if settings.en_input_bound:
        znew = projections.project_box(znew, problem.u_min, problem.u_max)
    if settings.en_state_bound:
        vnew = projections.project_box(vnew, problem.x_min, problem.x_max)
    if settings.en_input_linear:
        znew = projections.project_halfspaces(znew, problem.Alin_u,
                                              problem.blin_u)
    if settings.en_state_linear:
        vnew = projections.project_halfspaces(vnew, problem.Alin_x,
                                              problem.blin_x)
    if settings.en_input_soc:
        znew = projections.project_cones(znew, problem.cones_u)
    if settings.en_state_soc:
        vnew = projections.project_cones(vnew, problem.cones_x)
    return state.replace(znew=znew, vnew=vnew)


def update_dual(state: State, settings: Settings = None) -> State:
    """Dual ascent: y += u_hat - znew;  g += x_hat - vnew."""
    if settings is None or settings.relaxation_alpha == 1.0:
        u_hat, x_hat = state.u, state.x
    else:
        u_hat, x_hat = _relaxed(settings, state)
    return state.replace(y=state.y + u_hat - state.znew,
                         g=state.g + x_hat - state.vnew)


def update_linear_cost(state: State, problem: Problem, cache: Cache) -> State:
    """r, q and p_N.  p_N = -(Pinf.T @ Xref_N) - rho (vnew_N - g_N): the
    reference's row product Xref^T . Pinf, kept transposed for iterate
    parity (Pinf is symmetric only up to roundoff)."""
    rho = cache.rho
    r = (-(problem.Uref * problem.R[..., None, :])
         - _ex(rho, 2) * (state.znew - state.y))
    q = (-(problem.Xref * problem.Q[..., None, :])
         - _ex(rho, 2) * (state.vnew - state.g))
    p_N = (-_mv(cache.Pinf.transpose(-1, -2), problem.Xref[..., -1, :])
           - _ex(rho, 1) * (state.vnew[..., -1, :] - state.g[..., -1, :]))
    p = torch.cat([state.p[..., :-1, :], p_N[..., None, :]], dim=-2)
    return state.replace(r=r, q=q, p=p)


def backward_pass(state: State, problem: Problem, cache: Cache, *,
                  horizon_parallel: bool = False) -> State:
    """Linear-term Riccati backward recursion:
        d_i = Quu_inv (B^T p_{i+1} + r_i)
        p_i = q_i + AmBKt p_{i+1} - Kinf^T r_i
    ``horizon_parallel`` runs it as an associative scan (ops/scans.py).
    """
    if horizon_parallel:
        return scans.backward_pass_assoc(state, problem, cache)
    BT, Quu_inv, AmBKt, KT = (problem.B.transpose(-1, -2), cache.Quu_inv,
                              cache.AmBKt, cache.Kinf.transpose(-1, -2))
    n = state.r.shape[-2]
    p_last = state.p[..., -1, :]
    p_next = p_last
    ds, ps = [None] * n, [None] * n
    for i in range(n - 1, -1, -1):
        r_i = state.r[..., i, :]
        ds[i] = _mv(Quu_inv, _mv(BT, p_next) + r_i)
        p_next = state.q[..., i, :] + _mv(AmBKt, p_next) - _mv(KT, r_i)
        ps[i] = p_next
    return state.replace(d=torch.stack(ds, dim=-2),
                         p=torch.stack(ps + [p_last], dim=-2))


def compute_residuals(state: State, cache: Cache):
    """The four infinity-norm residuals of the termination check."""
    def amax(t):
        return t.abs().amax(dim=(-2, -1))

    pri_state = amax(state.x - state.vnew)
    dua_state = amax(state.v - state.vnew) * cache.rho
    pri_input = amax(state.u - state.znew)
    dua_input = amax(state.z - state.znew) * cache.rho
    return pri_state, pri_input, dua_state, dua_input


# ---------------------------------------------------------------------------
# The solve loop
# ---------------------------------------------------------------------------

def check_chunk_maps(settings: Settings, chunk_maps) -> None:
    """The chunk maps bake the setup-time gains (Kinf, Quu_inv, AmBKt);
    adaptive rho moves them every few iterations, so the chunked recursions
    would run a stale gain: refused."""
    if chunk_maps is not None and settings.adaptive_rho:
        raise ValueError("chunk_maps are incompatible with adaptive_rho "
                         "(the maps bake the setup-time gains); use the "
                         "standard path")


def _passes(problem: Problem, horizon_parallel: bool, chunk_maps):
    """(forward, backward) pass functions of ``(state, cache)``: chunked
    with ``chunk_maps``, else associative scans with ``horizon_parallel``,
    else the sequential recursions."""
    if chunk_maps is not None:
        return (lambda st, ca: scans.forward_pass_chunked(st, problem, ca,
                                                          chunk_maps),
                lambda st, ca: scans.backward_pass_chunked(st, problem, ca,
                                                           chunk_maps))
    fwd = scans.forward_pass_assoc if horizon_parallel else forward_pass
    return (lambda st, ca: fwd(st, problem, ca),
            lambda st, ca: backward_pass(st, problem, ca,
                                         horizon_parallel=horizon_parallel))


def make_loop_fns(problem: Problem, settings: Settings, *,
                  horizon_parallel: bool = False, dtype=None,
                  chunk_maps=None):
    """(cond_fn, body_fn) of the ADMM loop over the carry
    ``(state, cache, z_prev, v_prev, converged, i)``; ``converged`` is a
    Python bool and ``i`` a Python int.  ``chunk_maps``
    (``scans.ChunkMaps``) runs the horizon recursions chunked, the
    long-horizon path; ``horizon_parallel`` runs them as associative scans
    (same values up to float reassociation)."""
    check_chunk_maps(settings, chunk_maps)
    forward, backward = _passes(problem, horizon_parallel, chunk_maps)
    dtype = dtype or problem.dtype
    pri_tol = torch.tensor(settings.abs_pri_tol, dtype=dtype,
                           device=problem.device)
    dua_tol = torch.tensor(settings.abs_dua_tol, dtype=dtype,
                           device=problem.device)
    ct = settings.check_termination

    def cond_fn(carry):
        *_, converged, i = carry
        return i < settings.max_iter and not converged

    def body_fn(carry):
        st, ca, z_prev, v_prev, _, i = carry
        st = forward(st, ca)
        st = update_slack(st, problem, settings)
        st = update_dual(st, settings)
        st = update_linear_cost(st, problem, ca)
        st = st.replace(iter=st.iter + 1)
        # the reference gates on the 0-based loop counter, and updates the
        # cache before the residual check: the dual residuals below scale
        # by the new rho
        if settings.adaptive_rho and i > 0 and i % rho_mod.RHO_INTERVAL == 0:
            adapt = (rho_mod.adapt_rho_rebuild if settings.adaptive_rho_rebuild
                     else rho_mod.adapt_rho)
            ca = adapt(st, ca, problem, settings)
        z_prev, v_prev = st.znew, st.vnew

        # termination check only on iterations where iter % ct == 0;
        # residuals are stored only then
        converged = False
        if ct > 0 and (i + 1) % ct == 0:
            pri_s, pri_i, dua_s, dua_i = compute_residuals(st, ca)
            st = st.replace(primal_residual_state=pri_s,
                            primal_residual_input=pri_i,
                            dual_residual_state=dua_s,
                            dual_residual_input=dua_i)
            converged = bool((pri_s < pri_tol) & (pri_i < pri_tol)
                             & (dua_s < dua_tol) & (dua_i < dua_tol))
        if converged:
            # the reference returns before the slack copy and the backward
            # pass: v/z/p/d stay as they were
            st = st.replace(status=torch.full_like(st.status, TINY_SOLVED))
        else:
            st = backward(st.replace(v=st.vnew, z=st.znew), ca)
        return (st, ca, z_prev, v_prev, converged, i + 1)

    return cond_fn, body_fn


def batched_body(problem: Problem, settings: Settings, state: State,
                 cache: Cache, i: int, *, horizon_parallel: bool = False,
                 chunk_maps=None):
    """One ADMM iteration of a whole batch: ``body_fn`` with a leading batch
    axis on the state (and on the problem or cache where they differ per
    instance), the branch on convergence replaced by a per-instance select.
    Returns (state, cache, converged (B,) bool); the caller freezes the
    instances that had converged before."""
    forward, backward = _passes(problem, horizon_parallel, chunk_maps)
    dtype, dev = state.x.dtype, state.x.device
    pri_tol = torch.tensor(settings.abs_pri_tol, dtype=dtype, device=dev)
    dua_tol = torch.tensor(settings.abs_dua_tol, dtype=dtype, device=dev)
    ct = settings.check_termination
    batch = state.x.shape[0]
    st = forward(state, cache)
    st = update_slack(st, problem, settings)
    st = update_dual(st, settings)
    st = update_linear_cost(st, problem, cache)
    st = st.replace(iter=st.iter + 1)
    ca = cache
    if settings.adaptive_rho and i > 0 and i % rho_mod.RHO_INTERVAL == 0:
        adapt = (rho_mod.adapt_rho_rebuild_batched
                 if settings.adaptive_rho_rebuild else rho_mod.adapt_rho)
        ca = adapt(st, ca, problem, settings)
    converged = torch.zeros((batch,), dtype=torch.bool, device=dev)
    if ct > 0 and (i + 1) % ct == 0:
        pri_s, pri_i, dua_s, dua_i = compute_residuals(st, ca)
        st = st.replace(primal_residual_state=pri_s,
                        primal_residual_input=pri_i,
                        dual_residual_state=dua_s, dual_residual_input=dua_i)
        converged = ((pri_s < pri_tol) & (pri_i < pri_tol)
                     & (dua_s < dua_tol) & (dua_i < dua_tol))
    st = st.replace(status=torch.where(
        converged, torch.full_like(st.status, TINY_SOLVED), st.status))
    st_next = backward(st.replace(v=st.vnew, z=st.znew), ca)
    return select_instances(converged, st, st_next), ca, converged


def select_instances(pred, on_true, on_false):
    """Per-instance select between two batched dataclasses of tensors;
    ``pred`` is (B,) bool."""
    return map_tensors(lambda a, b: torch.where(_ex(pred, a.ndim - 1), a, b),
                       on_true, on_false)


def init_carry(state: State, cache: Cache):
    """Initial loop carry (the solve's preamble)."""
    state = state.replace(status=torch.full_like(state.status, TINY_UNSOLVED),
                          iter=torch.zeros_like(state.iter))
    return (state, cache, state.znew, state.vnew, False, 0)


def finalize(carry) -> Tuple[State, Cache, Solution]:
    state, cache, _, _, converged, _ = carry
    solution = Solution(
        iter=state.iter.clone(),
        solved=torch.tensor(int(converged), dtype=torch.int32,
                            device=state.iter.device),
        x=state.vnew, u=state.znew)
    return state, cache, solution


def solve_impl(problem: Problem, cache: Cache, settings: Settings,
               state: State, *, horizon_parallel: bool = False,
               chunk_maps=None) -> Tuple[State, Cache, Solution]:
    cond_fn, body_fn = make_loop_fns(problem, settings,
                                     horizon_parallel=horizon_parallel,
                                     dtype=state.x.dtype,
                                     chunk_maps=chunk_maps)
    carry = init_carry(state, cache)
    while cond_fn(carry):
        carry = body_fn(carry)
    return finalize(carry)


@full_fp32_matmul()
def solve(problem: Problem, cache: Cache, settings: Settings, state: State,
          *, horizon_parallel: bool = False, chunk_maps=None
          ) -> Tuple[State, Cache, Solution]:
    """One full ADMM solve.  Pure: returns the advanced (state, cache) and
    the Solution; the caller persists state and cache for warm starts."""
    return solve_impl(problem, cache, settings, state,
                      horizon_parallel=horizon_parallel,
                      chunk_maps=chunk_maps)
