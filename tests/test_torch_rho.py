"""The port's adaptive-rho functions (ops/rho.py) against the JAX package's,
in float64 on the CPU: the same workspace, made with numpy from a seed, goes
through both, and the results agree within 1e-12."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tinympc_julia_tpu as J
from tinympc_julia_tpu.models import quadrotor
from tinympc_julia_tpu.ops import rho as jrho
from tinympc_julia_tpu_torch import precompute_cache
from tinympc_julia_tpu_torch import types as PT
from tinympc_julia_tpu_torch.ops import rho

from torch_port_common import CPU, port_copies

F64 = jnp.float64
N = 10
STATE_FIELDS = (("x", (N, 12)), ("u", (N - 1, 4)), ("v", (N, 12)),
                ("vnew", (N, 12)), ("z", (N - 1, 4)), ("znew", (N - 1, 4)),
                ("g", (N, 12)), ("y", (N - 1, 4)))


def _quad(rho0=5.0):
    jp = J.make_problem(jnp.asarray(quadrotor.A), jnp.asarray(quadrotor.B),
                        jnp.asarray(np.diag(quadrotor.Q_DIAG)),
                        jnp.asarray(np.diag(quadrotor.R_DIAG)), rho0, N,
                        u_min=-0.5, u_max=0.5)
    jc = J.precompute_cache(jp.A, jp.B, jp.Q, jp.R, jnp.asarray(rho0, F64))
    return (jp, jc), port_copies(jp, jc, F64)


def _states(seed, scale=1.0):
    """A random workspace on both sides; the slacks sit close to the
    iterates, as they do in a solve."""
    rng = np.random.default_rng(seed)
    f = {k: rng.normal(size=shape) for k, shape in STATE_FIELDS}
    for k, near in (("vnew", "x"), ("v", "x"), ("znew", "u"), ("z", "u")):
        f[k] = f[near] + scale * 1e-2 * rng.normal(size=f[k].shape)
    jst = J.init_state(12, 4, N, F64).replace(
        **{k: jnp.asarray(v) for k, v in f.items()})
    pst = PT.init_state(12, 4, N, device=CPU).replace(
        **{k: torch.as_tensor(v) for k, v in f.items()})
    return jst, pst


def _settings(**kw):
    return J.Settings(**kw), PT.Settings(**kw)


def _assert_cache_close(pc, jc, atol=1e-12):
    for k in ("rho", "Kinf", "Pinf", "Quu_inv", "AmBKt", "C1", "C2",
              "dKinf_drho", "dPinf_drho", "dC1_drho", "dC2_drho"):
        np.testing.assert_allclose(getattr(pc, k).numpy(),
                                   np.asarray(getattr(jc, k)), rtol=1e-12,
                                   atol=atol, err_msg=k)


def test_constants_match():
    assert (rho.EPS, rho.TERM_DEADBAND, rho.TERM_MAX_STEP) == (
        jrho.EPS, jrho.TERM_DEADBAND, jrho.TERM_MAX_STEP)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_osqp_residuals_match_jax(seed):
    (jp, jc), (pp, pc) = _quad()
    jst, pst = _states(seed)
    want = jrho.osqp_residuals(jst, jc, jp)
    got = rho.osqp_residuals(pst, pc, pp)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12)


def test_osqp_dual_residual_counts_the_input_cost_twice():
    """With x = g = y = 0 the dual residual is max |2 R u|: R u enters once
    through P x and once through q, as in the reference."""
    (_, _), (pp, pc) = _quad()
    z = PT.init_state(12, 4, N, device=CPU)
    u = torch.full((N - 1, 4), 0.25, dtype=torch.float64)
    _, dual_res, _, _ = rho.osqp_residuals(z.replace(u=u), pc, pp)
    assert float(dual_res) == pytest.approx(2 * 0.25 * float(pp.R.max()),
                                            rel=1e-12)


@pytest.mark.parametrize("clip", [True, False])
def test_predict_rho_matches_jax(clip):
    js, ps = _settings(adaptive_rho_enable_clipping=clip,
                       adaptive_rho_min=2.0, adaptive_rho_max=6.0)
    rng = np.random.default_rng(3)
    r = rng.uniform(1e-4, 10.0, size=(4, 64))
    cur = rng.uniform(1.0, 8.0, size=64)
    want = jrho.predict_rho(*(jnp.asarray(a) for a in r), jnp.asarray(cur),
                            js, F64)
    got = rho.predict_rho(*(torch.as_tensor(a) for a in r),
                          torch.as_tensor(cur), ps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)
    assert clip == bool((got.numpy().max() <= 6.0)
                        and (got.numpy().min() >= 2.0))


def test_taylor_update_matches_jax_and_keeps_the_stale_terms():
    (_, jc), (_, pc) = _quad()
    jn = jrho.taylor_update(jc, jnp.asarray(6.25, F64))
    pn = rho.taylor_update(pc, torch.tensor(6.25, dtype=torch.float64))
    _assert_cache_close(pn, jn)
    # the reference's quirk: Quu_inv/AmBKt are not updated, C1/C2 are
    assert torch.equal(pn.Quu_inv, pc.Quu_inv)
    assert torch.equal(pn.AmBKt, pc.AmBKt)
    assert not torch.equal(pn.C1, pc.C1) and not torch.equal(pn.Kinf, pc.Kinf)


@pytest.mark.parametrize("kw,center", [
    (dict(), None),
    (dict(adaptive_rho_enable_clipping=False), None),
    (dict(adaptive_rho_min=5.0, adaptive_rho_max=1e3,
          adaptive_rho_taylor_trust=2.0), 5.0),
    (dict(adaptive_rho_min=0.1, adaptive_rho_max=10.0,
          adaptive_rho_taylor_trust=0.5, abs_pri_tol=2e-3), 5.0),
], ids=["default", "no-clip", "bench-row", "tight-trust"])
def test_termination_controller_matches_jax(kw, center):
    """Per-lane vectors that land on every branch: inside the deadband (rho
    kept), beyond it both ways, beyond the step cap, into the clip and into
    the trust clip."""
    js, ps = _settings(**kw)
    rng = np.random.default_rng(4)
    pri = 10.0 ** rng.uniform(-6, 1, size=256)
    dual = 10.0 ** rng.uniform(-6, 1, size=256)
    dual[:8] = 0.0  # a vanished dual residual: the eps guard
    cur = rng.uniform(4.0, 7.0, size=256)
    want = jrho.termination_controller(
        jnp.asarray(pri), jnp.asarray(dual), jnp.asarray(cur), js, F64,
        rho_center=None if center is None else jnp.asarray(center, F64))
    got = rho.termination_controller(
        torch.as_tensor(pri), torch.as_tensor(dual), torch.as_tensor(cur), ps,
        rho_center=center)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)
    kept = got.numpy() == cur
    assert 0 < kept.sum() < 256  # the deadband holds some lanes, not all


@pytest.mark.parametrize("controller", ["osqp", "termination"])
@pytest.mark.parametrize("seed", [5, 6])
def test_adapt_rho_matches_jax(controller, seed):
    (jp, jc), (pp, pc) = _quad()
    js, ps = _settings(adaptive_rho=True, adaptive_rho_controller=controller,
                       adaptive_rho_min=0.1, adaptive_rho_max=10.0,
                       adaptive_rho_taylor_trust=2.0)
    jst, pst = _states(seed, scale=10.0 if seed == 6 else 1.0)
    jn = jrho.adapt_rho(jst, jc, jp, js)
    pn = rho.adapt_rho(pst, pc, pp, ps)
    _assert_cache_close(pn, jn)
    if controller == "termination":
        want = jrho.predict_rho_termination(jst, jc, js, F64,
                                            rho_center=jp.rho_setup)
        got = rho.predict_rho_termination(pst, pc, ps,
                                          rho_center=pp.rho_setup)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-12)
        assert abs(float(got) - 5.0) <= 2.0 + 1e-12


def test_unknown_controller_raises():
    (_, _), (pp, pc) = _quad()
    _, pst = _states(0)
    with pytest.raises(ValueError, match="adaptive_rho_controller"):
        rho.adapt_rho(pst, pc, pp,
                      PT.Settings(adaptive_rho_controller="bogus"))


def test_rebuild_update_equals_precompute_at_the_new_rho():
    """The semantics tests/test_rho_rebuild.py pins for the JAX package: a
    cold rebuild equals ``precompute_cache`` at the new rho (same double
    fold, same fixed point), C1/C2 follow the fresh terms, the
    sensitivities stay; a warm rebuild reaches the same fixed point within
    the stop tolerance; and both equal the JAX rebuild."""
    (jp, jc), (pp, pc) = _quad()
    new = 17.0
    cold = rho.rebuild_update(pc, pp, new, warm=False)
    warm = rho.rebuild_update(pc, pp, new, warm=True)
    ref = precompute_cache(pp.A, pp.B, pp.Q - pp.rho_setup + new,
                           pp.R - pp.rho_setup + new,
                           torch.tensor(new, dtype=torch.float64))
    for k in ("Kinf", "Pinf", "Quu_inv", "AmBKt"):
        np.testing.assert_allclose(getattr(cold, k).numpy(),
                                   getattr(ref, k).numpy(), rtol=0,
                                   atol=1e-12, err_msg=k)
    assert torch.equal(cold.C1, cold.Quu_inv)
    assert torch.equal(cold.C2, cold.AmBKt)
    assert torch.equal(cold.dKinf_drho, pc.dKinf_drho)
    np.testing.assert_allclose(warm.Kinf.numpy(), cold.Kinf.numpy(), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(warm.Pinf.numpy(), cold.Pinf.numpy(),
                               rtol=1e-4, atol=1e-6)
    for w, got in ((False, cold), (True, warm)):
        _assert_cache_close(got, jrho.rebuild_update(jc, jp, new, warm=w),
                            atol=1e-10)


def test_rebuild_at_the_setup_rho_reproduces_the_setup_cache():
    (_, _), (pp, _) = _quad()
    pc = precompute_cache(pp.A, pp.B, pp.Q, pp.R, pp.rho_setup)
    again = rho.rebuild_update(pc, pp, 5.0, warm=False)
    for k in ("Kinf", "Pinf", "Quu_inv", "AmBKt"):
        np.testing.assert_allclose(getattr(again, k).numpy(),
                                   getattr(pc, k).numpy(), rtol=1e-13,
                                   atol=1e-13, err_msg=k)


def test_adapt_rho_rebuild_matches_jax_and_skips_an_unchanged_rho():
    (jp, jc), (pp, pc) = _quad()
    js, ps = _settings(adaptive_rho=True, adaptive_rho_rebuild=True,
                       adaptive_rho_min=0.1, adaptive_rho_max=100.0)
    jst, pst = _states(6, scale=10.0)
    pn = rho.adapt_rho_rebuild(pst, pc, pp, ps)
    assert float(pn.rho) != 5.0
    _assert_cache_close(pn, jrho.adapt_rho_rebuild(jst, jc, jp, js),
                        atol=1e-10)
    pinned = ps.replace(adaptive_rho_min=5.0, adaptive_rho_max=5.0)
    assert rho.adapt_rho_rebuild(pst, pc, pp, pinned) is pc
