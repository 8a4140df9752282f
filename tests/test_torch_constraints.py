"""The port's constraint stack vs the JAX package: the converters carrying
cone sets and halfspace rows, the API's linear/cone/equality setters, the
condensed solve with halfspaces and cones (float64), the rocket closed loop
through solve(), and constraint changes between two fused solves."""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tinympc_julia_tpu as J
import tinympc_julia_tpu_torch as P
from tinympc_julia_tpu.models import rocket as jrocket
from tinympc_julia_tpu.ops.condensed import (build_condensed as jax_build,
                                             solve_condensed as jax_solve)
from tinympc_julia_tpu_torch.models import cartpole, rocket
from tinympc_julia_tpu_torch.ops import condensed as C
from tinympc_julia_tpu_torch.utils import convert

from torch_port_common import (CPU, jax_arrays, rocket_setup, rocket_x0,
                               x0_batch)

F64 = jnp.float64
A_LIN = np.array([[1.0, 1.0, 0.0, 0.0], [0.0, 0.0, 1.0, 0.5]])
B_LIN = np.array([1.0, 0.8])


def test_convert_carries_cones_and_halfspaces():
    """A JAX problem with two input cones, one state cone and halfspace
    rows on both sides converts field for field."""
    cones_u = J.ConeSet(mus=jnp.asarray([0.25, 0.7]), starts=(0, 1),
                        dims=(3, 2))
    cones_x = J.ConeSet(mus=jnp.asarray([0.5]), starts=(1,), dims=(3,))
    rng = np.random.default_rng(3)
    jp = J.make_problem(jnp.asarray(rocket.A), jnp.asarray(rocket.B),
                        jnp.asarray(np.diag(rocket.Q_DIAG)),
                        jnp.asarray(np.diag(rocket.R_DIAG)), 1.0, 10,
                        Alin_x=jnp.asarray(rng.normal(size=(2, 6))),
                        blin_x=jnp.asarray(rng.normal(size=2)),
                        Alin_u=jnp.asarray(rng.normal(size=(1, 3))),
                        blin_u=jnp.asarray([4.0]), cones_u=cones_u,
                        cones_x=cones_x)
    pp = convert.problem_from_numpy(jax_arrays(jp), dtype=torch.float64,
                                    device=CPU)
    for f in dataclasses.fields(jp):
        want, got = getattr(jp, f.name), getattr(pp, f.name)
        if f.name.startswith("cones_"):
            assert (got.starts, got.dims) == (want.starts, want.dims), f.name
            np.testing.assert_array_equal(got.mus.numpy(),
                                          np.asarray(want.mus))
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=f.name)
    back = convert.to_numpy(pp)
    assert back["cones_u"]["starts"] == (0, 1)
    with pytest.raises(KeyError):
        d = jax_arrays(jp)
        del d["cones_x"]
        convert.problem_from_numpy(d, dtype=torch.float64, device=CPU)


def _pair(model_jax, model_port, **kw):
    return (model_jax.make_solver(dtype=F64, **kw),
            model_port.make_solver(dtype=torch.float64, device=CPU, **kw))


def _same_problem(js, ps):
    for f in dataclasses.fields(js.problem):
        want, got = getattr(js.problem, f.name), getattr(ps.problem, f.name)
        if f.name.startswith("cones_"):
            assert (got.starts, got.dims) == (want.starts, want.dims)
            np.testing.assert_array_equal(got.mus.numpy(),
                                          np.asarray(want.mus))
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=f.name)
    for f in ("en_state_bound", "en_input_bound", "en_state_soc",
              "en_input_soc", "en_state_linear", "en_input_linear"):
        assert getattr(ps.settings, f) == getattr(js.settings, f), f


@pytest.mark.parametrize("call", [
    lambda s: s.set_linear_constraints(np.ones((2, 6)), [1.0, 2.0],
                                       np.zeros((0, 3)), []),
    lambda s: s.set_linear_constraints(np.zeros((0, 6)), [],
                                       [[0.0, 0.0, 1.0]], [60.0]),
    lambda s: s.set_cone_constraints([0, 1], [3, 2], [0.3, 0.6], [], [], []),
    lambda s: s.set_cone_constraints([], [], [], [0], [3], [0.4]),
    lambda s: s.set_equality_constraints([[1.0, 0, 0, 0, 0, 0]], [0.5]),
    lambda s: s.set_equality_constraints(np.eye(6)[:2], [0.1, 0.2],
                                         [[1.0, 0.0, 0.0]], [0.0]),
], ids=["linear-x", "linear-u", "cones-u", "cones-x", "equality-x",
        "equality-xu"])
def test_setters_match_jax(call):
    """Each setter leaves the same problem data and the same flags as the
    JAX API's (flags switch on only for families with rows or cones;
    equalities become inequality pairs)."""
    js, ps = _pair(jrocket, rocket)
    for s in (js, ps):
        call(s)
    _same_problem(js, ps)


def test_setters_refuse_bad_data():
    s = rocket.make_solver(dtype=torch.float64, device=CPU)
    with pytest.raises(ValueError, match="does not fit"):
        s.set_cone_constraints([2], [3], [0.5], [], [], [])
    with pytest.raises(ValueError, match="bound"):
        s.set_linear_constraints(np.ones((2, 6)), [1.0], np.zeros((0, 3)),
                                 [])


def _rocket_lin_u(jp, pp):
    A, b = np.array([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0]]), np.array([60.0, 1.0])
    return (jp.replace(Alin_u=jnp.asarray(A), blin_u=jnp.asarray(b)),
            pp.replace(Alin_u=torch.as_tensor(A), blin_u=torch.as_tensor(b)))


@pytest.mark.parametrize("case", ["rocket-cones", "rocket-cones-lin-u-alpha",
                                  "cartpole-halfspaces"])
def test_solve_condensed_matches_jax(case):
    """float64: identical per-lane iteration counts on every lane and 1e-8
    on the solutions, with halfspaces and cones after the box."""
    if case.startswith("rocket"):
        (jp, jc, jm), (pp, pc, pm) = rocket_setup(F64)
        x0 = rocket_x0(64)
        kw = dict(abs_pri_tol=2e-3, abs_dua_tol=1e-3, en_state_bound=True,
                  en_input_bound=True, en_input_soc=True, en_state_soc=True,
                  max_iter=200)
        if case == "rocket-cones-lin-u-alpha":
            jp, pp = _rocket_lin_u(jp, pp)
            kw.update(en_input_linear=True, relaxation_alpha=1.5,
                      check_termination=2)
    else:
        jp = J.make_problem(jnp.asarray(cartpole.A), jnp.asarray(cartpole.B),
                            jnp.asarray(np.diag(cartpole.Q_DIAG)),
                            jnp.asarray(np.diag(cartpole.R_DIAG)), 1.0, 20,
                            u_min=-5.0, u_max=5.0, Alin_x=jnp.asarray(A_LIN),
                            blin_x=jnp.asarray(B_LIN))
        jc = J.precompute_cache(jp.A, jp.B, jp.Q, jp.R, jnp.asarray(1.0))
        jm = jax_build(jp, jc)
        pp = convert.problem_from_numpy(jax_arrays(jp), dtype=torch.float64,
                                        device=CPU)
        pc = convert.cache_from_numpy(jax_arrays(jc), dtype=torch.float64,
                                      device=CPU)
        pm = convert.maps_from_numpy(jax_arrays(jm), dtype=torch.float64,
                                     device=CPU)
        x0 = x0_batch(64, 4)
        kw = dict(en_state_bound=False, en_input_bound=True,
                  en_state_linear=True, max_iter=150)
    jx, ju, jit, jok = jax_solve(jp, jc, J.Settings(**kw), jnp.asarray(x0),
                                 jm)[:4]
    px, pu, pit, pok = C.solve_condensed(pp, pc, C.Settings(**kw),
                                         torch.as_tensor(x0), pm)
    assert int(pok.sum()) > 32
    np.testing.assert_array_equal(pit.numpy(), np.asarray(jit))
    np.testing.assert_array_equal(pok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(pu.numpy(), np.asarray(ju), atol=1e-8)
    np.testing.assert_allclose(px.numpy(), np.asarray(jx), atol=1e-8)


def test_api_condensed_with_cones_matches_jax():
    js, ps = _pair(jrocket, rocket, max_iter=150)
    Xref, Uref = rocket.reference_trajectory(0)
    for s in (js, ps):
        s.set_x_ref(Xref)
        s.set_u_ref(Uref)
    x0 = rocket_x0(32, seed=5)
    j = js.solve_batch(x0, method="condensed")
    p = ps.solve_batch(x0, method="condensed")
    np.testing.assert_array_equal(p[2].numpy(), j[2])
    np.testing.assert_allclose(p[1].numpy(), j[1], atol=1e-8)


def test_rocket_closed_loop_matches_jax():
    """10 steps of the rocket example's loop (moving reference, both cones,
    gravity) through solve(): the same iteration counts and controls within
    1e-9 on every step."""
    js, ps = _pair(jrocket, rocket)
    xj = xp = rocket.X_INIT * 1.1
    for k in range(10):
        Xref, Uref = rocket.reference_trajectory(k)
        for s, x in ((js, xj), (ps, xp)):
            s.set_x0(x)
            s.set_x_ref(Xref)
            s.set_u_ref(Uref)
            assert s.solve() == 0
        uj = js.get_solution().controls[:, 0]
        up = ps.get_solution().controls[:, 0]
        assert int(ps.solution.iter) == int(js.solution.iter), k
        np.testing.assert_allclose(up, uj, atol=1e-9, err_msg=f"step {k}")
        assert np.linalg.norm(up[:2]) <= rocket.MU_INPUT * up[2] + 1e-6
        xj, xp = rocket.simulate(xj, uj), rocket.simulate(xp, up)


def test_fused_solve_sees_a_cone_change_between_calls():
    """Change the cones between two solve_batch(method="fused") calls: the
    second call solves with the new data (it equals a fresh solver set up
    with the new cones, and differs from the first call)."""
    def solver():
        s = rocket.make_solver(dtype=torch.float32, device=CPU, max_iter=80)
        Xref, Uref = rocket.reference_trajectory(0)
        s.set_x_ref(Xref)
        s.set_u_ref(Uref)
        return s

    x0 = rocket_x0(48, seed=6)
    s = solver()
    first = s.solve_batch(x0, method="fused")
    s.set_cone_constraints([0], [3], [0.1], [0], [3], [0.5])
    second = s.solve_batch(x0, method="fused")
    fresh = solver()
    fresh.set_cone_constraints([0], [3], [0.1], [0], [3], [0.5])
    want = fresh.solve_batch(x0, method="fused")
    for a, b in zip(second, want):
        assert torch.equal(a, b)
    assert not torch.equal(second[1], first[1])
    us = second[1][second[3] == 1]
    assert int((second[3] == 1).sum()) > 24
    assert (torch.linalg.vector_norm(us[..., :2], dim=-1)
            <= 0.1 * us[..., 2] + 5e-3).all()
