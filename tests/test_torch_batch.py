"""The port's parallel/batch.py (the masked batched reference-ordered loop)
and ``TinyMPCSolver.solve_batch(method="standard")`` vs the JAX package, in
float64: iterates within 1e-9, per-instance iteration counts equal."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tinympc_julia_tpu as J
import tinympc_julia_tpu_torch as P
from tinympc_julia_tpu.models import cartpole
from tinympc_julia_tpu.parallel import batch as JB
from tinympc_julia_tpu_torch.ops.scans import build_chunk_maps
from tinympc_julia_tpu_torch.parallel import batch as PB

from torch_port_common import (CPU, cartpole_setup, grouped_cartpoles,
                               jax_arrays, settings_pair, x0_batch)

F64 = jnp.float64
ATOL = 1e-9


def _states(B, x0, N, nx=4, nu=1):
    js = JB.set_x0_batch(JB.broadcast_state(J.init_state(nx, nu, N, F64), B),
                         jnp.asarray(x0))
    ps = PB.set_x0_batch(PB.broadcast_state(
        P.init_state(nx, nu, N, device=CPU), B), torch.as_tensor(x0))
    return js, ps


def _same(jout, pout, *, cache=False):
    jst, jca, jsol = jout
    pst, pca, psol = pout
    np.testing.assert_array_equal(psol.iter.numpy(), np.asarray(jsol.iter))
    np.testing.assert_array_equal(psol.solved.numpy(),
                                  np.asarray(jsol.solved))
    for k in ("x", "u"):
        np.testing.assert_allclose(getattr(psol, k).numpy(),
                                   np.asarray(getattr(jsol, k)), atol=ATOL,
                                   rtol=0, err_msg=k)
    for k, v in jax_arrays(jst).items():
        np.testing.assert_allclose(getattr(pst, k).numpy(), v, atol=ATOL,
                                   rtol=0, err_msg=f"state.{k}")
    if cache:
        for k in ("rho", "Kinf", "Pinf"):
            np.testing.assert_allclose(getattr(pca, k).numpy(),
                                       np.asarray(getattr(jca, k)),
                                       atol=ATOL, rtol=0, err_msg=k)


CASES = {
    "input_bound": dict(max_iter=150, en_state_bound=False),
    "relaxed_ct4": dict(max_iter=160, en_state_bound=False,
                        relaxation_alpha=1.7, check_termination=4),
    "mixed_convergence": dict(max_iter=25, en_state_bound=False),
}


@pytest.mark.parametrize("name", list(CASES))
def test_shared_problem_matches_jax(name):
    (jp, jc, _), (pp, pc, _) = cartpole_setup(F64)
    js, ps = settings_pair(**CASES[name])
    x0 = x0_batch(12, 3, scale=0.8)
    jst, pst = _states(12, x0, cartpole.HORIZON)
    jout = JB.solve_batch(jp, jc, js, jst)
    pout = PB.solve_batch(pp, pc, ps, pst)
    _same(jout, pout)
    if name == "mixed_convergence":
        solved = pout[2].solved.numpy()
        assert 0 < solved.sum() < solved.size  # some froze, some ran out


def test_state_bounded_problem_matches_jax():
    (jp, jc, _), (pp, pc, _) = cartpole_setup(F64, state_bound=True)
    js, ps = settings_pair(max_iter=120)
    x0 = x0_batch(8, 5, scale=0.8)
    jst, pst = _states(8, x0, cartpole.HORIZON)
    _same(JB.solve_batch(jp, jc, js, jst), PB.solve_batch(pp, pc, ps, pst))


@pytest.mark.parametrize("state_bound", [False, True])
def test_batched_problems_match_jax(state_bound):
    """Per-instance problems and caches (problem_batched, cache_batched)."""
    N = 8
    (jps, jcs), (pps, pcs) = grouped_cartpoles(6, F64, N=N,
                                               state_bound=state_bound)
    js, ps = settings_pair(max_iter=120, en_state_bound=state_bound)
    x0 = x0_batch(6, 11, scale=0.6)
    jst, pst = _states(6, x0, N)
    kw = dict(problem_batched=True, cache_batched=True)
    _same(JB.solve_batch(jps, jcs, js, jst, **kw),
          PB.solve_batch(pps, pcs, ps, pst, **kw), cache=True)


@pytest.mark.parametrize("controller", ["osqp", "termination"])
def test_adaptive_rho_promotes_the_cache_and_matches_jax(controller):
    """A shared cache becomes per-instance under adaptive rho; every
    instance's rho and Taylor-updated terms match.  The trust radius keeps
    the first-order cache near its expansion point (far from it an
    instance's iterates grow to 1e6, where 1e-9 absolute means nothing)."""
    (jp, jc, _), (pp, pc, _) = cartpole_setup(F64)
    js, ps = settings_pair(max_iter=60, en_state_bound=False,
                           adaptive_rho=True, adaptive_rho_min=0.2,
                           adaptive_rho_max=20.0,
                           adaptive_rho_taylor_trust=0.6,
                           adaptive_rho_controller=controller)
    x0 = x0_batch(6, 13, scale=0.8)
    jst, pst = _states(6, x0, cartpole.HORIZON)
    jout = JB.solve_batch(jp, jc, js, jst)
    pout = PB.solve_batch(pp, pc, ps, pst)
    _same(jout, pout, cache=True)
    assert pout[1].rho.shape == (6,)
    assert len(set(np.round(pout[1].rho.numpy(), 9))) > 1  # rhos diverged


def test_adaptive_rho_rebuild_matches_jax():
    (jp, jc, _), (pp, pc, _) = cartpole_setup(F64)
    js, ps = settings_pair(max_iter=12, en_state_bound=False,
                           adaptive_rho=True, adaptive_rho_rebuild=True,
                           adaptive_rho_min=0.2, adaptive_rho_max=20.0)
    x0 = x0_batch(3, 14, scale=0.8)
    jst, pst = _states(3, x0, cartpole.HORIZON)
    jout = JB.solve_batch(jp, jc, js, jst)
    pout = PB.solve_batch(pp, pc, ps, pst)
    np.testing.assert_array_equal(pout[2].iter.numpy(),
                                  np.asarray(jout[2].iter))
    np.testing.assert_allclose(pout[1].rho.numpy(), np.asarray(jout[1].rho),
                               atol=1e-8, rtol=0)
    np.testing.assert_allclose(pout[2].u.numpy(), np.asarray(jout[2].u),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("batched", [False, True])
def test_solve_vmap_equals_solve_batch(batched):
    N = 8
    if batched:
        _, (pp, pc) = grouped_cartpoles(5, F64, N=N)
    else:
        _, (pp, pc, _) = cartpole_setup(F64)
        N = cartpole.HORIZON
    ps = P.Settings(max_iter=60, en_state_bound=False)
    x0 = x0_batch(5, 17, scale=0.6)
    st = PB.set_x0_batch(PB.broadcast_state(
        P.init_state(4, 1, N, device=CPU), 5), torch.as_tensor(x0))
    kw = dict(problem_batched=batched, cache_batched=batched)
    a = PB.solve_batch(pp, pc, ps, st, **kw)
    b = PB.solve_vmap(pp, pc, ps, st, **kw)
    assert torch.equal(a[2].iter, b[2].iter)
    assert torch.equal(a[2].solved, b[2].solved)
    torch.testing.assert_close(a[2].u, b[2].u, atol=1e-12, rtol=0)
    torch.testing.assert_close(a[0].d, b[0].d, atol=1e-12, rtol=0)


def test_unconverged_count_hook_and_flag_checks():
    _, (pp, pc, _) = cartpole_setup(F64)
    ps = P.Settings(max_iter=40, en_state_bound=False)
    st = PB.set_x0_batch(PB.broadcast_state(
        P.init_state(4, 1, cartpole.HORIZON, device=CPU), 4),
        torch.as_tensor(x0_batch(4, 19)))
    seen = []

    def count(running):
        seen.append(int(running.sum()))
        return running.sum()

    out = PB.solve_batch(pp, pc, ps, st, unconverged_count_fn=count)
    ref = PB.solve_batch(pp, pc, ps, st)
    assert torch.equal(out[2].iter, ref[2].iter)
    assert seen[0] == 4 and seen == sorted(seen, reverse=True)
    with pytest.raises(ValueError, match="problem_batched"):
        PB.solve_batch(pp, pc, ps, st, problem_batched=True)
    # the long-horizon forms of the recursions (ops/scans.py): the same
    # counts; chunk maps with adaptive rho are refused
    hp = PB.solve_batch(pp, pc, ps, st, horizon_parallel=True)
    assert torch.equal(hp[2].iter, ref[2].iter)
    with pytest.raises(ValueError, match="adaptive_rho"):
        PB.solve_batch(pp, pc, ps.replace(adaptive_rho=True), st,
                       chunk_maps=build_chunk_maps(pp, pc, 19))


def _api_pair(**settings):
    N = cartpole.HORIZON
    pair = (J.TinyMPCSolver(), P.TinyMPCSolver(dtype=torch.float64,
                                               device=CPU))
    for s in pair:
        s.setup(cartpole.A, cartpole.B, None, np.diag(cartpole.Q_DIAG),
                np.diag(cartpole.R_DIAG), cartpole.RHO, 4, 1, N,
                max_iter=30)
        s.set_bound_constraints(np.full((4, N), -1e17), np.full((4, N), 1e17),
                                np.full((1, N - 1), -5.0),
                                np.full((1, N - 1), 5.0))
        s.update_settings(en_state_bound=False, **settings)
    return pair


@pytest.mark.parametrize("settings", [dict(), dict(adaptive_rho=True)],
                         ids=["fixed", "adaptive"])
def test_api_standard_cold_and_warm_match_jax(settings):
    """``solve_batch(method="standard")``: a cold call, then a warm one from
    its carry with moved initial states (the reference's persisted
    workspace: the loop restarts from the carried iterates)."""
    js, ps = _api_pair(**settings)
    x0 = x0_batch(6, 23, scale=0.8)
    j1 = js.solve_batch(x0, method="standard", return_carry=True)
    p1 = ps.solve_batch(x0, method="standard", return_carry=True)
    x1 = x0 + 0.05
    j2 = js.solve_batch(x1, method="standard", warm=j1[4])
    p2 = ps.solve_batch(x1, method="standard", warm=p1[4])
    for j, p in ((j1, p1), (j2, p2)):
        np.testing.assert_array_equal(p[2].numpy(), j[2])
        np.testing.assert_array_equal(p[3].numpy(), j[3])
        np.testing.assert_allclose(p[0].numpy(), j[0], atol=ATOL, rtol=0)
        np.testing.assert_allclose(p[1].numpy(), j[1], atol=ATOL, rtol=0)
    assert p1[4].method == "standard" and p1[4].batch == 6
    cold = ps.solve_batch(x1, method="standard")
    assert not torch.equal(cold[2], p2[2])  # the warm start changed the run
    with pytest.raises(ValueError, match="warm carry is for"):
        ps.solve_batch(x1, method="condensed", warm=p1[4])
