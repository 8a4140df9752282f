"""Adaptive rho: OSQP-form residuals, the rho prediction and the cache update
(counterpart of tinympc_julia_tpu/ops/rho.py).

The reference materialises the stacked OSQP problem (a dense constraint
matrix and cost of the decision size) every 5 iterations; every quantity it
derives from them is block-structured, so the residuals here are computed
matrix-free, stage by stage, on the (N, nx)/(N-1, nu) trajectory arrays.

Block structure (format_matrices of the reference's rho_benchmark.cpp):
  decision vec  [x_0; u_0; x_1; u_1; ...; x_{N-1}]
  constraint rows: (N-1) input-identity rows  [u_i]      with dual y_i
                 + (N-1) dynamics rows        [A B -I]   with dual g_{i+1}
  z vector      [z_i (inputs); v_{i+1} (states)]
  P blocks      diag(Q) per state (Pinf terminal), diag(R) per input
  q vector      [Q*x_i ; R*u_i]   (zero-reference form)
"""
from __future__ import annotations

import torch

from ..types import Cache, Problem, Settings, State
from ..utils.precision import full_fp32_matmul
from . import riccati

EPS = 1e-10
RHO_INTERVAL = 5  # iterations between rho updates (the reference's gate)

# Termination-residual controller (extension): updates smaller than the
# deadband factor are skipped, and one update moves rho by at most the step
# cap (OSQP's anti-oscillation mechanism).
TERM_DEADBAND = 5.0
TERM_MAX_STEP = 10.0


def osqp_residuals(state: State, cache: Cache, problem: Problem):
    """(pri_res, dual_res, pri_norm, dual_norm): the infinity norms of the
    reference's compute_residuals, from the current iterates (x, u, vnew,
    znew, g, y) as the solve loop holds them.  A leading batch axis on the
    state (and on the problem or cache) gives one value per instance."""
    x, u = state.x, state.u           # (..., N, nx), (..., N-1, nu)
    v, z = state.vnew, state.znew
    g, y = state.g, state.y
    A, B = problem.A, problem.B
    Qd, Rd = problem.Q[..., None, :], problem.R[..., None, :]
    head, tail = (Ellipsis, slice(None, -1), slice(None)), \
        (Ellipsis, slice(1, None), slice(None))

    def amax(t):
        return t.abs().amax(dim=(-2, -1))

    # primal: A x against z.  Input rows u_i; dynamics rows
    # A x_i + B u_i - x_{i+1}
    dyn = (x[head] @ A.transpose(-1, -2) + u @ B.transpose(-1, -2)
           - x[tail])
    ax_inf = torch.maximum(amax(u), amax(dyn))
    z_inf = torch.maximum(amax(z), amax(v[tail]))
    pri_res = torch.maximum(amax(u - z), amax(dyn - v[tail]))
    pri_norm = torch.maximum(ax_inf, z_inf)

    # dual: P x + q + A^T y
    PxN = (cache.Pinf @ x[..., -1, :, None]).squeeze(-1)
    Px_states = torch.cat([x[head] * Qd, PxN[..., None, :]], dim=-2)
    Px_inputs = u * Rd
    q_states = x * Qd
    q_inputs = u * Rd
    # A^T y: state x_j gets A^T g_{j+1} [j <= N-2] - g_j [j >= 1];
    #        input u_j gets B^T g_{j+1} + y_j
    aty_states = torch.zeros_like(x)
    aty_states[head] += g[tail] @ A
    aty_states[tail] -= g[tail]
    aty_inputs = g[tail] @ B + y

    r_dual_states = Px_states + q_states + aty_states
    # R*u enters twice (P x and q), as in the reference
    r_dual_inputs = Px_inputs + q_inputs + aty_inputs
    dual_res = torch.maximum(amax(r_dual_states), amax(r_dual_inputs))
    px_inf = torch.maximum(amax(Px_states), amax(Px_inputs))
    aty_inf = torch.maximum(amax(aty_states), amax(aty_inputs))
    q_inf = torch.maximum(amax(q_states), amax(q_inputs))
    dual_norm = torch.maximum(torch.maximum(px_inf, aty_inf), q_inf)
    return pri_res, dual_res, pri_norm, dual_norm


def predict_rho(pri_res, dual_res, pri_norm, dual_norm, current_rho,
                settings: Settings):
    """new_rho = rho * sqrt(normalized_pri / normalized_dual), optionally
    clipped.  Scalars or per-lane vectors."""
    normalized_pri = pri_res / (pri_norm + EPS)
    normalized_dual = dual_res / (dual_norm + EPS)
    ratio = normalized_pri / (normalized_dual + EPS)
    new_rho = current_rho * torch.sqrt(ratio)
    if settings.adaptive_rho_enable_clipping:
        new_rho = torch.clamp(new_rho, settings.adaptive_rho_min,
                              settings.adaptive_rho_max)
    return new_rho


def taylor_update(cache: Cache, new_rho) -> Cache:
    """First-order cache update in rho.  Parity quirk: it updates
    Kinf/Pinf/C1/C2 but not Quu_inv/AmBKt, exactly like the reference."""
    delta = new_rho - cache.rho
    if delta.ndim:  # per-instance caches
        delta = delta[..., None, None]
    return cache.replace(
        rho=new_rho,
        Kinf=cache.Kinf + delta * cache.dKinf_drho,
        Pinf=cache.Pinf + delta * cache.dPinf_drho,
        C1=cache.C1 + delta * cache.dC1_drho,
        C2=cache.C2 + delta * cache.dC2_drho)


def termination_controller(pri, dual, rho, settings: Settings, *,
                           rho_center=None):
    """The extension controller shared by every path: predict rho from the
    solver's own termination residuals, each normalised by its tolerance:

        ratio   = (pri / abs_pri_tol) / (dual / abs_dua_tol)
        new_rho = rho * sqrt(ratio)          (clipped like predict_rho)

    ``pri``/``dual``/``rho`` are 0-d tensors (single-instance path) or
    per-lane vectors (condensed path).  ``rho_center`` (the expansion centre
    of the sensitivities) switches on the ``adaptive_rho_taylor_trust`` clip,
    which has the last word."""
    ratio = (pri / settings.abs_pri_tol) / (dual / settings.abs_dua_tol + EPS)
    factor = torch.clamp(torch.sqrt(ratio), 1.0 / TERM_MAX_STEP,
                         TERM_MAX_STEP)
    move = (factor > TERM_DEADBAND) | (factor < 1.0 / TERM_DEADBAND)
    new_rho = torch.where(move, rho * factor, rho)
    if settings.adaptive_rho_enable_clipping:
        new_rho = torch.clamp(new_rho, settings.adaptive_rho_min,
                              settings.adaptive_rho_max)
    if rho_center is not None:
        trust = settings.adaptive_rho_taylor_trust
        center = torch.as_tensor(rho_center, dtype=new_rho.dtype,
                                 device=new_rho.device)
        new_rho = torch.clamp(new_rho, center - trust, center + trust)
    return new_rho


def predict_rho_termination(state: State, cache: Cache, settings: Settings,
                            rho_center=None):
    """``termination_controller`` on the single-instance workspace."""
    rho = cache.rho

    def amax(t):
        return t.abs().amax(dim=(-2, -1))

    pri = torch.maximum(amax(state.x - state.vnew),
                        amax(state.u - state.znew))
    dual = rho * torch.maximum(amax(state.v - state.vnew),
                               amax(state.z - state.znew))
    return termination_controller(pri, dual, rho, settings,
                                  rho_center=rho_center)


def _predicted_rho(state: State, cache: Cache, problem: Problem,
                   settings: Settings):
    if settings.adaptive_rho_controller == "termination":
        return predict_rho_termination(state, cache, settings,
                                       rho_center=problem.rho_setup)
    if settings.adaptive_rho_controller != "osqp":
        raise ValueError("adaptive_rho_controller must be 'osqp' or "
                         f"'termination', got "
                         f"{settings.adaptive_rho_controller!r}")
    return predict_rho(*osqp_residuals(state, cache, problem), cache.rho,
                       settings)


def adapt_rho(state: State, cache: Cache, problem: Problem,
              settings: Settings) -> Cache:
    """One adaptive-rho step: residuals -> predicted rho -> Taylor update."""
    return taylor_update(cache, _predicted_rho(state, cache, problem,
                                               settings))


@full_fp32_matmul()
def rebuild_update(cache: Cache, problem: Problem, new_rho, *,
                   max_iter: int = 1000, tol: float = 1e-5,
                   warm: bool = True) -> Cache:
    """Exact cache update at ``new_rho`` (the extension behind
    ``Settings.adaptive_rho_rebuild``): re-runs the Riccati fixed point with
    the setup's double rho fold (user cost ``problem.Q - problem.rho_setup``
    plus ``new_rho`` twice), and unlike the Taylor update also refreshes
    ``Quu_inv``/``AmBKt`` and keeps C1/C2 in step.  The sensitivities stay
    those of the setup point.

    ``warm=True`` starts the fixed point from the current (Kinf, Pinf);
    ``warm=False`` cold-starts from P = rho*I like the setup, so the rebuilt
    terms equal ``precompute_cache`` at ``new_rho``."""
    new_rho = torch.as_tensor(new_rho, dtype=cache.Kinf.dtype,
                              device=cache.Kinf.device)
    # two adds, as the setup folds them (make_problem, then _cache_terms):
    # not Q_user + 2*rho
    Q1d = problem.Q - problem.rho_setup + new_rho + new_rho
    R1d = problem.R - problem.rho_setup + new_rho + new_rho
    A, B = problem.A, problem.B
    Kinf, Pinf = riccati.riccati_fixed_point(
        A, B, Q1d, R1d, new_rho, max_iter=max_iter, tol=tol,
        K0=cache.Kinf if warm else None, P0=cache.Pinf if warm else None)
    Kinf, Pinf, Quu_inv, AmBKt = (riccati.row_major(t) for t in (
        Kinf, Pinf, torch.linalg.inv(torch.diag(R1d) + B.T @ Pinf @ B),
        (A - B @ Kinf).T))
    return cache.replace(rho=new_rho, Kinf=Kinf, Pinf=Pinf, Quu_inv=Quu_inv,
                         AmBKt=AmBKt, C1=Quu_inv, C2=AmBKt)


def adapt_rho_rebuild(state: State, cache: Cache, problem: Problem,
                      settings: Settings) -> Cache:
    """One adaptive-rho step with the exact rebuild; a prediction that
    leaves rho unchanged (deadband, clip saturation) skips the fixed
    point."""
    new_rho = _predicted_rho(state, cache, problem, settings)
    if bool(new_rho != cache.rho):
        return rebuild_update(cache, problem, new_rho)
    return cache


def adapt_rho_rebuild_batched(state: State, cache: Cache, problem: Problem,
                              settings: Settings) -> Cache:
    """``adapt_rho_rebuild`` on a batch of instances with per-instance
    caches: the fixed point's trip count depends on the data, so each
    instance whose prediction moved runs its own."""
    from ..types import index_instance, stack_instances
    new_rho = _predicted_rho(state, cache, problem, settings)
    moved = (new_rho != cache.rho).tolist()
    shared_problem = problem.A.ndim == 2
    out = []
    for b, m in enumerate(moved):
        ca_b = index_instance(cache, b)
        if m:
            pr_b = problem if shared_problem else index_instance(problem, b)
            ca_b = rebuild_update(ca_b, pr_b, new_rho[b])
        out.append(ca_b)
    return stack_instances(out)
