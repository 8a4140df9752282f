"""The port's grouped condensed path (G distinct problems x L lanes): the
batched map builders and ``solve_condensed[_adaptive]_grouped`` vs the JAX
package in float64.  Maps within 1e-12; iterates within 1e-9 with equal
per-lane iteration counts."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tinympc_julia_tpu_torch as P
from tinympc_julia_tpu.ops import condensed as JC
from tinympc_julia_tpu_torch.ops import condensed as C
from tinympc_julia_tpu_torch.parallel import batch as PB
from tinympc_julia_tpu_torch.types import (expand_lanes, index_instance,
                                           stack_instances)
from tinympc_julia_tpu_torch.utils import convert

from torch_port_common import (CPU, grouped_cartpoles, grouped_rockets,
                               jax_arrays, settings_pair)

F64 = jnp.float64
ATOL = 1e-9
N = 8


def _x0(G, L, seed, scale=0.6, nx=4):
    return np.random.default_rng(seed).uniform(-scale, scale, size=(G, L, nx))


def _same(jout, pout, atol=ATOL):
    np.testing.assert_array_equal(pout[2].numpy(), np.asarray(jout[2]))
    np.testing.assert_array_equal(pout[3].numpy(), np.asarray(jout[3]))
    np.testing.assert_allclose(pout[0].numpy(), np.asarray(jout[0]),
                               atol=atol, rtol=0)
    np.testing.assert_allclose(pout[1].numpy(), np.asarray(jout[1]),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("state_bound", [False, True])
def test_batched_builders_match_per_group_and_jax(state_bound):
    G = 3
    (jps, jcs), (pps, pcs) = grouped_cartpoles(G, F64, N=N,
                                               state_bound=state_bound)
    jm, jt = JC.build_condensed(jps, jcs), JC.build_condensed_taylor(jps, jcs)
    pm, pt = C.build_condensed(pps, pcs), C.build_condensed_taylor(pps, pcs)
    for k in ("T1", "T2", "T12"):
        np.testing.assert_allclose(getattr(pm, k).numpy(),
                                   np.asarray(getattr(jm, k)), atol=1e-12,
                                   rtol=0, err_msg=k)
    for k in ("T1s", "T2s", "rho0"):
        np.testing.assert_allclose(getattr(pt, k).numpy(),
                                   np.asarray(getattr(jt, k)), atol=1e-12,
                                   rtol=0, err_msg=k)
    assert pt.T1s.shape[:2] == (G, 3) and pt.T2s.shape[:2] == (G, 4)
    assert pt.rho0.shape == (G,)
    for g in range(G):
        pg, cg = index_instance(pps, g), index_instance(pcs, g)
        mg, tg = C.build_condensed(pg, cg), C.build_condensed_taylor(pg, cg)
        for k in ("T1", "T2", "T12"):
            torch.testing.assert_close(getattr(pm, k)[g], getattr(mg, k),
                                       atol=1e-13, rtol=0)
        for k in ("T1s", "T2s", "rho0"):
            torch.testing.assert_close(getattr(pt, k)[g], getattr(tg, k),
                                       atol=1e-13, rtol=0)


def test_batched_taylor_order_3_matches_jax():
    (jps, jcs), (pps, pcs) = grouped_cartpoles(2, F64, N=6)
    jt = JC.build_condensed_taylor(jps, jcs, order=3)
    pt = C.build_condensed_taylor(pps, pcs, order=3)
    np.testing.assert_allclose(pt.T1s.numpy(), np.asarray(jt.T1s),
                               atol=1e-12, rtol=0)


def test_converters_carry_the_group_axis():
    (jps, jcs), (pps, pcs) = grouped_rockets(3, F64)
    assert pps.A.shape == (3, 6, 6) and pps.cones_u.mus.shape == (3, 1)
    assert pps.cones_x.starts == (0,) and pps.nx == 6 and pps.N == 10
    jm = JC.build_condensed(jps, jcs)
    jt = JC.build_condensed_taylor(jps, jcs)
    pm = convert.maps_from_numpy(jax_arrays(jm), dtype=torch.float64,
                                 device=CPU)
    pt = convert.taylor_maps_from_numpy(jax_arrays(jt), dtype=torch.float64,
                                        device=CPU)
    assert pm.T12.shape == (3, 87, 88) and pt.rho0.shape == (3,)
    back = convert.to_numpy(pps)
    np.testing.assert_array_equal(back["cones_u"]["mus"],
                                  np.asarray(jps.cones_u.mus))


SOLVES = {
    "ct1": (dict(max_iter=120, en_state_bound=False), False),
    "relaxed_ct4": (dict(max_iter=120, en_state_bound=False,
                         relaxation_alpha=1.7, check_termination=4), False),
    "state_bound": (dict(max_iter=140, en_state_bound=True), True),
    "mixed_convergence": (dict(max_iter=20, en_state_bound=False), False),
}


@pytest.mark.parametrize("name", list(SOLVES))
def test_grouped_solve_matches_jax(name):
    kw, sb = SOLVES[name]
    G, L = 3, 8
    (jps, jcs), (pps, pcs) = grouped_cartpoles(G, F64, N=N, state_bound=sb)
    js, ps = settings_pair(**kw)
    x0 = _x0(G, L, 31)
    jout = JC.solve_condensed_grouped(jps, jcs, js, jnp.asarray(x0),
                                      return_carry=True)
    pout = C.solve_condensed_grouped(pps, pcs, ps, torch.as_tensor(x0),
                                     return_carry=True)
    _same(jout, pout)
    assert pout[0].shape == (G, L, N, 4) and pout[2].shape == (G, L)
    for k, v in jax_arrays(jout[4]).items():
        np.testing.assert_allclose(getattr(pout[4], k).numpy(), v, atol=ATOL,
                                   rtol=0, err_msg=k)
    if name == "mixed_convergence":
        solved = pout[3].numpy()
        assert 0 < solved.sum() < solved.size


def test_grouped_rocket_with_per_group_cones_matches_jax():
    G, L = 3, 6
    (jps, jcs), (pps, pcs) = grouped_rockets(G, F64)
    js, ps = settings_pair(max_iter=100, abs_pri_tol=2e-3, abs_dua_tol=1e-3,
                           en_state_bound=True, en_input_bound=True,
                           en_input_soc=True, en_state_soc=True)
    from tinympc_julia_tpu.models import rocket
    x0 = rocket.X_INIT[None, None, :] * np.random.default_rng(6).uniform(
        0.9, 1.1, size=(G, L, 1))
    jout = JC.solve_condensed_grouped(jps, jcs, js, jnp.asarray(x0))
    pout = C.solve_condensed_grouped(pps, pcs, ps, torch.as_tensor(x0))
    _same(jout, pout)
    assert int(pout[3].sum()) > 0
    assert len({int(i) for i in pout[2][:, 0]}) > 1  # the groups differ


@pytest.mark.parametrize("controller", ["osqp", "termination"])
def test_grouped_adaptive_solve_matches_jax(controller):
    G, L = 3, 6
    (jps, jcs), (pps, pcs) = grouped_cartpoles(G, F64, N=N)
    js, ps = settings_pair(max_iter=100, en_state_bound=False,
                           adaptive_rho=True, adaptive_rho_min=0.3,
                           adaptive_rho_max=8.0,
                           adaptive_rho_taylor_trust=0.5,
                           adaptive_rho_controller=controller)
    x0 = _x0(G, L, 37)
    jout = JC.solve_condensed_adaptive_grouped(jps, jcs, js, jnp.asarray(x0),
                                               return_carry=True)
    pout = C.solve_condensed_adaptive_grouped(pps, pcs, ps,
                                              torch.as_tensor(x0),
                                              return_carry=True)
    _same(jout, pout)
    np.testing.assert_allclose(pout[4].rho.numpy(), np.asarray(jout[4].rho),
                               atol=ATOL, rtol=0)
    assert pout[4].rho.shape == (G, L)
    rho0 = pcs.rho[:, None].expand(G, L)
    assert bool((pout[4].rho != rho0).any())  # some lane moved its rho


def test_grouped_adaptive_state_bound_matches_jax():
    G, L = 2, 6
    (jps, jcs), (pps, pcs) = grouped_cartpoles(G, F64, N=N, state_bound=True)
    js, ps = settings_pair(max_iter=80, en_state_bound=True,
                           adaptive_rho=True, adaptive_rho_min=0.3,
                           adaptive_rho_max=8.0)
    x0 = _x0(G, L, 41)
    _same(JC.solve_condensed_adaptive_grouped(jps, jcs, js, jnp.asarray(x0)),
          C.solve_condensed_adaptive_grouped(pps, pcs, ps,
                                             torch.as_tensor(x0)))


def test_grouped_solve_matches_the_standard_method():
    """Against the port's own masked batched loop with per-lane problems:
    equal counts, iterates within 1e-9."""
    G, L = 3, 5
    _, (pps, pcs) = grouped_cartpoles(G, F64, N=N)
    ps = P.Settings(max_iter=120, en_state_bound=False)
    x0 = torch.as_tensor(_x0(G, L, 43))
    xs, us, iters, solved = C.solve_condensed_grouped(pps, pcs, ps, x0)
    st = PB.set_x0_batch(PB.broadcast_state(
        P.init_state(4, 1, N, device=CPU), G * L), x0.reshape(G * L, 4))
    _, _, sol = PB.solve_batch(expand_lanes(pps, L), expand_lanes(pcs, L), ps,
                               st, problem_batched=True, cache_batched=True)
    assert torch.equal(iters.reshape(-1), sol.iter)
    assert torch.equal(solved.reshape(-1), sol.solved)
    torch.testing.assert_close(us.reshape(G * L, N - 1, 1), sol.u, atol=ATOL,
                               rtol=0)
    torch.testing.assert_close(xs.reshape(G * L, N, 4), sol.x, atol=ATOL,
                               rtol=0)
    assert int(solved.sum()) > 0


@pytest.mark.parametrize("adaptive", [False, True])
def test_single_group_equals_the_shared_solve(adaptive):
    _, (pps, pcs) = grouped_cartpoles(1, F64, N=N, seed=3)
    ps = P.Settings(max_iter=100, en_state_bound=False, adaptive_rho=adaptive,
                    adaptive_rho_min=0.3, adaptive_rho_max=8.0)
    x0 = torch.as_tensor(_x0(1, 12, 47))
    grouped, shared = ((C.solve_condensed_adaptive_grouped,
                        C.solve_condensed_adaptive) if adaptive else
                       (C.solve_condensed_grouped, C.solve_condensed))
    g = grouped(pps, pcs, ps, x0)
    s = shared(index_instance(pps, 0), index_instance(pcs, 0), ps, x0[0])
    assert torch.equal(g[2][0], s[2])
    torch.testing.assert_close(g[1][0], s[1], atol=1e-12, rtol=0)


def test_a_lane_does_not_depend_on_the_other_groups():
    """Per-lane freezing: solving groups (0, 1, 2) together gives group 1
    what solving (1,) alone gives it, although the joint loop runs on for
    the slowest group."""
    _, (pps, pcs) = grouped_cartpoles(3, F64, N=N)
    ps = P.Settings(max_iter=120, en_state_bound=False)
    x0 = torch.as_tensor(_x0(3, 6, 53))
    x0[1] *= 0.05  # group 1 converges long before the others
    joint = C.solve_condensed_grouped(pps, pcs, ps, x0)
    alone = C.solve_condensed_grouped(
        stack_instances([index_instance(pps, 1)]),
        stack_instances([index_instance(pcs, 1)]), ps, x0[1:2])
    assert int(joint[2][1].max()) < int(joint[2].max())
    for j, a in zip(joint, alone):
        assert torch.equal(j[1], a[0])


@pytest.mark.parametrize("adaptive", [False, True])
def test_warm_chain_is_exact(adaptive):
    """A 20-iteration grouped solve and its continuation equal one long
    solve (fixed rho), and the JAX chain with adaptive rho (a continuation
    restarts the rho-update counter)."""
    G, L = 3, 4
    (jps, jcs), (pps, pcs) = grouped_cartpoles(G, F64, N=N)
    kw = dict(en_state_bound=False, adaptive_rho=adaptive,
              adaptive_rho_min=0.3, adaptive_rho_max=8.0)
    x0 = _x0(G, L, 59)
    solve = (C.solve_condensed_adaptive_grouped if adaptive
             else C.solve_condensed_grouped)
    jsolve = (JC.solve_condensed_adaptive_grouped if adaptive
              else JC.solve_condensed_grouped)
    js20, ps20 = settings_pair(max_iter=20, **kw)
    js60, ps60 = settings_pair(max_iter=60, **kw)
    x0t = torch.as_tensor(x0)
    first = solve(pps, pcs, ps20, x0t, return_carry=True)
    second = solve(pps, pcs, ps60, x0t, warm=first[4])
    jfirst = jsolve(jps, jcs, js20, jnp.asarray(x0), return_carry=True)
    jsecond = jsolve(jps, jcs, js60, jnp.asarray(x0), warm=jfirst[4])
    _same(jsecond, second)
    if not adaptive:
        _, ps80 = settings_pair(max_iter=80, **kw)
        long = solve(pps, pcs, ps80, x0t)
        cont = long[2] > 20
        assert torch.equal(second[2][cont], (long[2] - 20)[cont])
        torch.testing.assert_close(second[1][cont], long[1][cont],
                                   atol=1e-11, rtol=0)


def test_shape_checks():
    _, (pps, pcs) = grouped_cartpoles(2, F64, N=N)
    ps = P.Settings(max_iter=5, en_state_bound=False)
    with pytest.raises(ValueError, match="G-stacked"):
        C.solve_condensed_grouped(pps, pcs, ps, torch.zeros((3, 4, 4),
                                                            dtype=torch.float64))
    with pytest.raises(ValueError, match="shared problem"):
        C.solve_condensed(pps, pcs, ps, torch.zeros((4, 4),
                                                    dtype=torch.float64))
    with pytest.raises(ValueError, match="cone structure"):
        a = P.ConeSet(mus=torch.ones(1), starts=(0,), dims=(3,))
        b = P.ConeSet(mus=torch.ones(1), starts=(1,), dims=(3,))
        p0 = index_instance(pps, 0)
        stack_instances([p0.replace(cones_x=a), p0.replace(cones_x=b)])
