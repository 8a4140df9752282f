"""The adaptive half of the port's ops/condensed.py against the JAX package,
in float64 on the CPU: the Taylor-expanded maps, the stacked OSQP-form
residuals, and ``solve_condensed_adaptive`` lane by lane (equal iteration
counts, rho and iterates within 1e-9), cold and warm, with both rho
controllers."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tinympc_julia_tpu as J
from tinympc_julia_tpu.models import cartpole, quadrotor
from tinympc_julia_tpu.ops import condensed as JC
from tinympc_julia_tpu_torch import types as PT
from tinympc_julia_tpu_torch.ops import condensed as C
from tinympc_julia_tpu_torch.utils import convert

from torch_port_common import (CART_X_BOUND, CPU, jax_arrays, taylor_setup,
                               x0_batch)

F64 = jnp.float64
PLANTS = {"cartpole": dict(model=cartpole, rho=1.0, ub=5.0),
          "quadrotor": dict(model=quadrotor, rho=5.0, ub=0.5)}
CARRY = C.AdaptiveCondensedCarry._fields


@pytest.mark.parametrize("plant", list(PLANTS))
def test_taylor_maps_match_jax(plant):
    """The port builds the maps with its own copy of the host-side numpy
    routines: T1s, T2s and rho0 within 1e-12 of the JAX package's, order 2."""
    (_, _, jt), (pp, pc, _) = taylor_setup(dtype=F64, **PLANTS[plant])
    pt = C.build_condensed_taylor(pp, pc, order=2)
    assert pt.T1s.shape[0] == 3 and pt.T2s.shape[0] == 4
    np.testing.assert_allclose(pt.T1s.numpy(), np.asarray(jt.T1s), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(pt.T2s.numpy(), np.asarray(jt.T2s), rtol=1e-12,
                               atol=1e-12)
    assert float(pt.rho0) == float(jt.rho0)
    # coefficient 0 is the fixed map
    assert torch.equal(pt.T1s[0], C.build_condensed(pp, pc).T1)


def test_taylor_order_is_checked_and_kept():
    (_, _, _), (pp, pc, _) = taylor_setup(dtype=F64, **PLANTS["cartpole"])
    with pytest.raises(ValueError, match="order"):
        C.build_condensed_taylor(pp, pc, order=0)
    (jp, jc, _), _ = taylor_setup(dtype=F64, **PLANTS["cartpole"])
    j3 = JC.build_condensed_taylor(jp, jc, order=3)
    p3 = C.build_condensed_taylor(pp, pc, order=3)
    np.testing.assert_allclose(p3.T1s.numpy(), np.asarray(j3.T1s), rtol=0,
                               atol=1e-12)


def test_osqp_residuals_stacked_match_jax():
    (jp, jc, _), (pp, pc, _) = taylor_setup(dtype=F64, **PLANTS["quadrotor"])
    N, nx, nu, B = 20, 12, 4, 7
    rng = np.random.default_rng(3)
    stk = [rng.normal(size=(rows, B)) for rows in
           (N * nx, (N - 1) * nu, (N - 1) * nu, N * nx, (N - 1) * nu, N * nx)]
    drho = rng.uniform(-2.0, 2.0, size=B)
    want = JC._osqp_residuals_stacked(*(jnp.asarray(a) for a in stk), jp, jc,
                                      jnp.asarray(drho), N)
    got = C._osqp_residuals_stacked(*(torch.as_tensor(a) for a in stk), pp,
                                    pc, torch.as_tensor(drho), N)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12)


def _settings(**kw):
    base = dict(en_state_bound=False, en_input_bound=True, adaptive_rho=True)
    base.update(kw)
    return J.Settings(**base), PT.Settings(**base)


CASES = {
    "cartpole-osqp": ("cartpole", None, dict(
        max_iter=200, adaptive_rho_min=0.5, adaptive_rho_max=5.0)),
    "cartpole-osqp-state-bound-ct5-alpha": ("cartpole", CART_X_BOUND, dict(
        max_iter=200, adaptive_rho_min=0.5, adaptive_rho_max=5.0,
        en_state_bound=True, check_termination=5, relaxation_alpha=1.5)),
    "cartpole-osqp-unclipped": ("cartpole", None, dict(
        max_iter=100, adaptive_rho_enable_clipping=False)),
    "quadrotor-termination-trust2": ("quadrotor", None, dict(
        max_iter=150, adaptive_rho_controller="termination",
        adaptive_rho_taylor_trust=2.0, adaptive_rho_min=5.0,
        adaptive_rho_max=1e3, abs_pri_tol=1e-4, abs_dua_tol=1e-2)),
    "quadrotor-termination-wide": ("quadrotor", None, dict(
        max_iter=100, adaptive_rho_controller="termination",
        adaptive_rho_min=0.1, adaptive_rho_max=10.0, abs_pri_tol=1e-4,
        abs_dua_tol=1e-2)),
}


def _x0(plant, B, seed):
    return x0_batch(B, seed, scale=0.5 if plant == "cartpole" else 0.3,
                    nx=4 if plant == "cartpole" else 12)


def _assert_same(p_out, j_out, atol=1e-9):
    np.testing.assert_array_equal(p_out[2].numpy(), np.asarray(j_out[2]))
    np.testing.assert_array_equal(p_out[3].numpy(), np.asarray(j_out[3]))
    np.testing.assert_allclose(p_out[0].numpy(), np.asarray(j_out[0]),
                               atol=atol)
    np.testing.assert_allclose(p_out[1].numpy(), np.asarray(j_out[1]),
                               atol=atol)
    for k in CARRY:
        np.testing.assert_allclose(getattr(p_out[4], k).numpy(),
                                   np.asarray(getattr(j_out[4], k)),
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_solve_condensed_adaptive_matches_jax(case):
    """B = 24 lanes: equal per-lane iteration counts and solved flags; the
    solutions, the per-lane rho and the rest of the carry within 1e-9."""
    plant, xb, kw = CASES[case]
    (jp, jc, jt), (pp, pc, pt) = taylor_setup(dtype=F64, state_bound=xb,
                                              **PLANTS[plant])
    js, ps = _settings(**kw)
    x0 = _x0(plant, 24, 11)
    j = JC.solve_condensed_adaptive(jp, jc, js, jnp.asarray(x0), jt,
                                    return_carry=True)
    p = C.solve_condensed_adaptive(pp, pc, ps, torch.as_tensor(x0), pt,
                                   return_carry=True)
    _assert_same(p, j)
    rho = p[4].rho.numpy()
    assert (rho != float(pt.rho0)).any()  # some lane adapted
    if "trust2" in case:
        assert rho.min() >= 5.0 and rho.max() <= 7.0
    assert len(C.solve_condensed_adaptive(pp, pc, ps, torch.as_tensor(x0),
                                          pt)) == 4


@pytest.mark.parametrize("case", ["cartpole-osqp",
                                  "quadrotor-termination-trust2"])
def test_warm_continuation_matches_jax(case):
    """30 iterations with the carry, then 50 warm from it: both calls equal
    the JAX package's.  The continuation restarts the iteration counter, so
    its first update comes at its own iteration 5: the chain is not the
    80-iteration solve."""
    plant, xb, kw = CASES[case]
    (jp, jc, jt), (pp, pc, pt) = taylor_setup(dtype=F64, state_bound=xb,
                                              **PLANTS[plant])
    x0 = _x0(plant, 24, 12)
    js1, ps1 = _settings(**dict(kw, max_iter=30))
    js2, ps2 = _settings(**dict(kw, max_iter=50))
    j1 = JC.solve_condensed_adaptive(jp, jc, js1, jnp.asarray(x0), jt,
                                     return_carry=True)
    j2 = JC.solve_condensed_adaptive(jp, jc, js2, jnp.asarray(x0), jt,
                                     warm=j1[4], return_carry=True)
    p1 = C.solve_condensed_adaptive(pp, pc, ps1, torch.as_tensor(x0), pt,
                                    return_carry=True)
    p2 = C.solve_condensed_adaptive(pp, pc, ps2, torch.as_tensor(x0), pt,
                                    warm=p1[4], return_carry=True)
    _assert_same(p1, j1)
    _assert_same(p2, j2)
    # the JAX carry, carried across by the converter, continues the same way
    warm = convert.carry_from_numpy(jax_arrays(j1[4]), dtype=torch.float64,
                                    device=CPU)
    assert isinstance(warm, C.AdaptiveCondensedCarry)
    p2b = C.solve_condensed_adaptive(pp, pc, ps2, torch.as_tensor(x0), pt,
                                     warm=warm, return_carry=True)
    _assert_same(p2b, j2)


def test_chain_is_not_one_long_solve():
    """7 + 13 iterations against 20: the chain updates rho at its calls'
    own iterations 5 (the solve's 5, 12 and 17), the long solve at 5, 10
    and 15, so the lanes end on other rhos."""
    _, _, kw = CASES["cartpole-osqp-unclipped"]
    (_, _, _), (pp, pc, pt) = taylor_setup(dtype=F64, **PLANTS["cartpole"])
    x0 = torch.as_tensor(_x0("cartpole", 24, 12))
    ps = {k: _settings(**dict(kw, max_iter=k))[1] for k in (7, 13, 20)}
    p1 = C.solve_condensed_adaptive(pp, pc, ps[7], x0, pt, return_carry=True)
    p2 = C.solve_condensed_adaptive(pp, pc, ps[13], x0, pt, warm=p1[4],
                                    return_carry=True)
    one = C.solve_condensed_adaptive(pp, pc, ps[20], x0, pt,
                                     return_carry=True)
    open_ = (one[3] == 0) & (p1[3] == 0) & (p2[3] == 0)
    assert bool(open_.any())
    assert not torch.allclose(p2[4].rho[open_], one[4].rho[open_], rtol=1e-6)


@pytest.mark.parametrize("controller", ["osqp", "termination"])
def test_pinned_rho_reduces_to_the_fixed_solve(controller):
    """Clipping to [rho0, rho0] pins every lane's rho: drho = 0, so the
    Taylor maps are the fixed maps and the solve is ``solve_condensed``."""
    (_, _, _), (pp, pc, pt) = taylor_setup(dtype=F64, **PLANTS["cartpole"])
    kw = dict(max_iter=150, en_state_bound=False, en_input_bound=True)
    x0 = torch.as_tensor(_x0("cartpole", 32, 13))
    a = C.solve_condensed_adaptive(
        pp, pc, PT.Settings(adaptive_rho=True, adaptive_rho_min=1.0,
                            adaptive_rho_max=1.0,
                            adaptive_rho_controller=controller, **kw), x0, pt,
        return_carry=True)
    f = C.solve_condensed(pp, pc, PT.Settings(**kw), x0, return_carry=True)
    assert torch.equal(a[2], f[2]) and torch.equal(a[3], f[3])
    assert bool((a[4].rho == 1.0).all())
    np.testing.assert_allclose(a[1].numpy(), f[1].numpy(), atol=1e-12)
    np.testing.assert_allclose(a[4].d.numpy(), f[4].d.numpy(), atol=1e-10)


def test_unknown_controller_raises():
    (_, _, _), (pp, pc, pt) = taylor_setup(dtype=F64, **PLANTS["cartpole"])
    with pytest.raises(ValueError, match="adaptive_rho_controller"):
        C.solve_condensed_adaptive(
            pp, pc, PT.Settings(adaptive_rho=True,
                                adaptive_rho_controller="bogus"),
            torch.zeros((2, 4), dtype=torch.float64), pt)
