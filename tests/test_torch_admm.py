"""The port's single-instance solve (ops/admm.py, TinyMPCSolver.solve) in
float64 on the CPU: against the compiled-reference fixtures in
tests/golden/*.npz at the tolerances of tests/test_parity_golden.py
(adaptive rho included), and against the JAX package's admm.solve on the
rocket lander with both cones and on the quadrotor with adaptive rho,
iterate by iterate."""
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tinympc_julia_tpu as J
import tinympc_julia_tpu_torch as P
from tinympc_julia_tpu.models import rocket as jrocket
from tinympc_julia_tpu.ops import admm as jadmm
from tinympc_julia_tpu_torch import types as PT
from tinympc_julia_tpu_torch.models import cartpole, quadrotor, rocket
from tinympc_julia_tpu_torch.ops import admm

from torch_port_common import CPU, jax_arrays, port_copies, rocket_setup

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
F64 = torch.float64


def load(name):
    return np.load(os.path.join(GOLDEN, name + ".npz"))


def make_cartpole(max_iter=10, **kw):
    s = P.TinyMPCSolver(dtype=F64, device=CPU)
    s.setup(cartpole.A, cartpole.B, None, np.diag(cartpole.Q_DIAG),
            np.diag(cartpole.R_DIAG), 1.0, 4, 1, 20, max_iter=max_iter, **kw)
    return s


def test_cartpole_one_solve():
    g = load("cartpole_one_solve")
    s = make_cartpole(max_iter=10)
    s.set_x0([0.5, 0.0, 0.0, 0.0])
    assert s.solve() == 1 - int(g["solve_solved"][0, 0])
    assert int(s.solution.iter) == int(g["solve_iter"][0, 0])
    assert int(s.solution.solved) == int(g["solve_solved"][0, 0])
    sol = s.get_solution()
    np.testing.assert_allclose(sol.states, g["solve_x"], atol=1e-9)
    np.testing.assert_allclose(sol.controls, g["solve_u"], atol=1e-9)
    np.testing.assert_allclose(float(s.state.primal_residual_state),
                               g["solve_pri_state"][0, 0], atol=1e-9)
    np.testing.assert_allclose(float(s.state.dual_residual_input),
                               g["solve_dua_input"][0, 0], atol=1e-9)


@pytest.mark.parametrize("k", range(1, 11))
def test_cartpole_iterates(k):
    """Per-iteration parity: fresh solver, zero tolerances, max_iter = k."""
    g = load("cartpole_iterates")
    s = make_cartpole(max_iter=k, abs_pri_tol=0.0, abs_dua_tol=0.0)
    s.set_x0([0.5, 0.0, 0.0, 0.0])
    assert s.solve() == 1
    assert int(s.solution.iter) == k
    sol = s.get_solution()
    np.testing.assert_allclose(sol.states, g[f"k{k}_x"], atol=1e-9)
    np.testing.assert_allclose(sol.controls, g[f"k{k}_u"], atol=1e-9)


def test_cartpole_mpc_closed_loop():
    """Warm-started closed loop with box constraints: per-step states,
    controls and iteration counts track the reference (1e-6), and the last
    solve's slack iterates too."""
    g = load("cartpole_mpc")
    s = make_cartpole(max_iter=100)
    x_min = np.full((4, 20), -1e17)
    x_max = np.full((4, 20), 1e17)
    x_min[0, :] = -2.0
    x_max[0, :] = 2.0
    s.set_bound_constraints(x_min, x_max, np.full((1, 19), -5.0),
                            np.full((1, 19), 5.0))
    x = np.array([0.0, 0.0, 0.1, 0.0])
    for t in range(g["mpc_us"].shape[1]):
        s.set_x0(x)
        s.solve()
        u = s.get_solution().controls[:, 0]
        np.testing.assert_allclose(x, g["mpc_xs"][:, t], atol=1e-6,
                                   err_msg=f"state diverged at step {t}")
        np.testing.assert_allclose(u, g["mpc_us"][:, t], atol=1e-6,
                                   err_msg=f"control diverged at step {t}")
        assert int(s.solution.iter) == int(g["mpc_iters"][0, t]), t
        x = cartpole.simulate(x, u)
    sol = s.get_solution()
    np.testing.assert_allclose(sol.states, g["mpc_final_vnew"], atol=1e-6)
    np.testing.assert_allclose(sol.controls, g["mpc_final_znew"], atol=1e-6)


def test_quadrotor_hover():
    g = load("quadrotor_hover")
    s = P.TinyMPCSolver(dtype=F64, device=CPU)
    s.setup(quadrotor.A, quadrotor.B, None, np.diag(quadrotor.Q_DIAG),
            np.diag(quadrotor.R_DIAG), 5.0, 12, 4, 20, max_iter=500)
    s.set_bound_constraints(np.full((12, 20), -1e17), np.full((12, 20), 1e17),
                            np.full((4, 19), -0.5), np.full((4, 19), 0.5))
    s.update_settings(en_state_bound=False)
    s.set_x0(np.array([0.1, -0.2, 0.3, 0.05, -0.05, 0.1, 0.2, -0.1, 0.15,
                       0.0, 0.0, 0.0]))
    s.solve()
    assert int(s.solution.iter) == int(g["solve_iter"][0, 0])
    assert int(s.solution.solved) == int(g["solve_solved"][0, 0])
    sol = s.get_solution()
    np.testing.assert_allclose(sol.states, g["solve_x"], atol=1e-7)
    np.testing.assert_allclose(sol.controls, g["solve_u"], atol=1e-7)


def test_cartpole_tracking():
    g = load("cartpole_tracking")
    s = make_cartpole(max_iter=200)
    N = 20
    Xref = np.zeros((4, N))
    Uref = np.zeros((1, N - 1))
    for i in range(N):
        Xref[0, i] = 0.5 * np.sin(0.1 * i)
        Xref[2, i] = 0.05 * np.cos(0.2 * i)
    for i in range(N - 1):
        Uref[0, i] = 0.01 * i
    s.set_x_ref(Xref)
    s.set_u_ref(Uref)
    s.set_x0([0.3, 0.0, -0.05, 0.0])
    s.solve()
    assert int(s.solution.iter) == int(g["solve_iter"][0, 0])
    sol = s.get_solution()
    np.testing.assert_allclose(sol.states, g["solve_x"], atol=1e-8)
    np.testing.assert_allclose(sol.controls, g["solve_u"], atol=1e-8)


QUAD_X0 = np.array([0.1, -0.2, 0.3, 0.05, -0.05, 0.1, 0.2, -0.1, 0.15, 0.0,
                    0.0, 0.0])


def test_quadrotor_adaptive_golden():
    """Adaptive rho with the finite-difference sensitivities the reference
    binary used: the same iteration count, final rho within 1e-9, the final
    Kinf and the solution within 1e-6."""
    g = load("quadrotor_adaptive")
    sens = load("quadrotor_sensitivities")
    s = P.TinyMPCSolver(dtype=F64, device=CPU)
    s.setup(quadrotor.A, quadrotor.B, None, np.diag(quadrotor.Q_DIAG),
            np.diag(quadrotor.R_DIAG), 5.0, 12, 4, 20, max_iter=500,
            adaptive_rho=True, adaptive_rho_min=0.1, adaptive_rho_max=10.0)
    s.set_bound_constraints(np.full((12, 20), -1e17), np.full((12, 20), 1e17),
                            np.full((4, 19), -0.5), np.full((4, 19), 0.5))
    s.update_settings(en_state_bound=False, adaptive_rho=True)
    s.cache = s.cache.replace(
        dKinf_drho=torch.as_tensor(sens["dKinf"], dtype=F64),
        dPinf_drho=torch.as_tensor(sens["dPinf"], dtype=F64),
        dC1_drho=torch.as_tensor(sens["dC1"], dtype=F64),
        dC2_drho=torch.as_tensor(sens["dC2"], dtype=F64))
    s.set_x0(QUAD_X0)
    s.solve()
    assert int(s.solution.iter) == int(g["solve_iter"][0, 0])
    assert int(s.solution.iter) > 5  # rho was updated at least once
    np.testing.assert_allclose(float(s.cache.rho), g["final_rho"][0, 0],
                               atol=1e-9)
    assert float(s.cache.rho) != 5.0
    np.testing.assert_allclose(s.cache.Kinf.numpy(), g["final_Kinf"],
                               atol=1e-6)
    sol = s.get_solution()
    np.testing.assert_allclose(sol.states, g["solve_x"], atol=1e-6)
    np.testing.assert_allclose(sol.controls, g["solve_u"], atol=1e-6)


def _quad_pair(x0, **settings):
    """JAX and port (problem, cache, settings, state) for the quadrotor with
    |u| <= 0.5 and adaptive rho."""
    jp = J.make_problem(jnp.asarray(quadrotor.A), jnp.asarray(quadrotor.B),
                        jnp.asarray(np.diag(quadrotor.Q_DIAG)),
                        jnp.asarray(np.diag(quadrotor.R_DIAG)), 5.0, 20,
                        u_min=-0.5, u_max=0.5)
    jc = J.precompute_cache(jp.A, jp.B, jp.Q, jp.R,
                            jnp.asarray(5.0, jnp.float64))
    pp, pc = port_copies(jp, jc, jnp.float64)
    kw = dict(en_state_bound=False, en_input_bound=True, adaptive_rho=True,
              adaptive_rho_min=0.1, adaptive_rho_max=10.0)
    kw.update(settings)
    js = J.init_state(12, 4, 20, jnp.float64)
    js = js.replace(x=js.x.at[0].set(jnp.asarray(x0)))
    ps = PT.init_state(12, 4, 20, device=CPU)
    x = ps.x.clone()
    x[0] = torch.as_tensor(x0)
    return ((jp, jc, J.Settings(**kw), js),
            (pp, pc, PT.Settings(**kw), ps.replace(x=x)))


# the termination controller moves rho only past its deadband: tolerances a
# hundred apart make the primal check lag, so rho rises at the first update
TERMINATION = dict(adaptive_rho_controller="termination", abs_pri_tol=1e-4,
                   abs_dua_tol=1e-2)


@pytest.mark.parametrize("settings", [
    dict(), TERMINATION, dict(TERMINATION, adaptive_rho_taylor_trust=2.0)],
    ids=["osqp", "termination", "termination-trust2"])
@pytest.mark.parametrize("k", [5, 6, 11, 40, 500])
def test_adaptive_iterates_match_jax(settings, k):
    """Both controllers on the quadrotor: the workspace, the solution and
    the Taylor-updated cache after k iterations (5: no update yet; 6: just
    after the first; 500 runs to convergence, or with the OSQP-form
    controller, which only lets rho decay here, to the budget's end) within
    1e-9 of the JAX solve, with the same iteration count."""
    (jp, jc, js, jst), (pp, pc, ps, pst) = _quad_pair(
        QUAD_X0, max_iter=k, **settings)
    jst, jca, jsol = jadmm.solve(jp, jc, js, jst)
    pst, pca, psol = admm.solve(pp, pc, ps, pst)
    assert int(psol.iter) == int(jsol.iter)
    assert int(psol.solved) == int(jsol.solved)
    np.testing.assert_allclose(float(pca.rho), float(jca.rho), atol=1e-9)
    assert (float(pca.rho) != 5.0) == (k > 5)
    for name in ("Kinf", "Pinf", "C1", "C2", "Quu_inv", "AmBKt"):
        np.testing.assert_allclose(getattr(pca, name).numpy(),
                                   np.asarray(getattr(jca, name)), atol=1e-9,
                                   err_msg=name)
    _assert_states_close(pst, jst, 1e-9)


def test_adaptive_rebuild_matches_jax():
    """``adaptive_rho_rebuild``: the exact Riccati rebuild at each update, on
    a mis-set rho0; same iteration count and final rho as the JAX solve."""
    (jp, jc, js, jst), (pp, pc, ps, pst) = _quad_pair(
        QUAD_X0, max_iter=60, adaptive_rho_rebuild=True,
        adaptive_rho_controller="termination", adaptive_rho_max=100.0)
    jst, jca, jsol = jadmm.solve(jp, jc, js, jst)
    pst, pca, psol = admm.solve(pp, pc, ps, pst)
    assert int(psol.iter) == int(jsol.iter)
    np.testing.assert_allclose(float(pca.rho), float(jca.rho), rtol=1e-9)
    np.testing.assert_allclose(pca.Kinf.numpy(), np.asarray(jca.Kinf),
                               atol=1e-7)
    np.testing.assert_allclose(psol.u.numpy(), np.asarray(jsol.u), atol=1e-7)


def _rocket_pair(**settings):
    """JAX and port (problem, cache, settings, state) for the rocket with its
    box and both cones, x0 = 1.1 X_INIT."""
    (jp, jc, _), (pp, pc, _) = rocket_setup(jnp.float64)
    kw = dict(abs_pri_tol=2e-3, abs_dua_tol=1e-3, en_state_bound=True,
              en_input_bound=True, en_input_soc=True, en_state_soc=True)
    kw.update(settings)
    x0 = rocket.X_INIT * 1.1
    js = J.init_state(6, 3, rocket.HORIZON, jnp.float64)
    js = js.replace(x=js.x.at[0].set(jnp.asarray(x0)))
    ps = PT.init_state(6, 3, rocket.HORIZON, device=CPU)
    x = ps.x.clone()
    x[0] = torch.as_tensor(x0)
    return ((jp, jc, J.Settings(**kw), js),
            (pp, pc, PT.Settings(**kw), ps.replace(x=x)))


def _assert_states_close(pst, jst, atol):
    for name, want in jax_arrays(jst).items():
        np.testing.assert_allclose(getattr(pst, name).numpy(), want,
                                   atol=atol, err_msg=name)


@pytest.mark.parametrize("k", [1, 2, 3, 5, 8, 20, 200])
def test_rocket_iterates_match_jax(k):
    """Both cones and the box, affine gravity: the whole workspace and the
    solution after k iterations (max_iter = k; 200 runs to convergence)
    within 1e-9 of the JAX solve, with the same iteration count."""
    (jp, jc, js, jst), (pp, pc, ps, pst) = _rocket_pair(max_iter=k)
    jst, _, jsol = jadmm.solve(jp, jc, js, jst)
    pst, _, psol = admm.solve(pp, pc, ps, pst)
    assert int(psol.iter) == int(jsol.iter)
    assert int(psol.solved) == int(jsol.solved)
    np.testing.assert_allclose(psol.x.numpy(), np.asarray(jsol.x), atol=1e-9)
    np.testing.assert_allclose(psol.u.numpy(), np.asarray(jsol.u), atol=1e-9)
    _assert_states_close(pst, jst, 1e-9)


@pytest.mark.parametrize("settings", [
    dict(relaxation_alpha=1.6), dict(check_termination=3),
    dict(check_termination=0, max_iter=25)],
    ids=["alpha1.6", "ct3", "ct0"])
def test_rocket_settings_match_jax(settings):
    """Over-relaxation, residuals stored only on check iterations, and no
    termination check: the same workspace as the JAX solve (1e-9)."""
    (jp, jc, js, jst), (pp, pc, ps, pst) = _rocket_pair(
        **dict(dict(max_iter=200), **settings))
    jst, _, jsol = jadmm.solve(jp, jc, js, jst)
    pst, _, psol = admm.solve(pp, pc, ps, pst)
    assert int(psol.iter) == int(jsol.iter)
    _assert_states_close(pst, jst, 1e-9)


def test_warm_start_persists_across_solves():
    """The API persists the workspace: a second solve from a new x0 starts
    from the first one's iterates, as the JAX API's does."""
    jsv = jrocket.make_solver(dtype=jnp.float64)
    psv = rocket.make_solver(dtype=F64, device=CPU)
    x = rocket.X_INIT * 1.1
    for k in range(3):
        Xref, Uref = rocket.reference_trajectory(k)
        for s in (jsv, psv):
            s.set_x0(x)
            s.set_x_ref(Xref)
            s.set_u_ref(Uref)
            s.solve()
        assert int(psv.solution.iter) == int(jsv.solution.iter)
        _assert_states_close(psv.state, jsv.state, 1e-9)
        x = rocket.simulate(x, jsv.get_solution().controls[:, 0])
