"""The port's TinyMPCSolver vs the JAX package's."""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tinympc_julia_tpu as J
import tinympc_julia_tpu_torch as P
from tinympc_julia_tpu.models import cartpole

from torch_port_common import CPU, x0_batch

N = cartpole.HORIZON


def _setup(solver, horizon=N, **settings):
    solver.setup(cartpole.A, cartpole.B, None, np.diag(cartpole.Q_DIAG),
                 np.diag(cartpole.R_DIAG), cartpole.RHO, 4, 1, horizon)
    solver.set_bound_constraints(np.full((4, horizon), -1e17),
                                 np.full((4, horizon), 1e17),
                                 np.full((1, horizon - 1), -5.0),
                                 np.full((1, horizon - 1), 5.0))
    solver.update_settings(**settings)
    return solver


def _pair(jdtype, tdtype, **settings):
    js = _setup(J.TinyMPCSolver(dtype=jdtype), **settings)
    ps = _setup(P.TinyMPCSolver(dtype=tdtype, device="cpu"), **settings)
    return js, ps


def test_solve_batch_fused_matches_jax_with_padding():
    """B = 37, which the JAX side pads to its tile and the port runs as given
    (a ragged last tile for the kernel); f32: the same per-lane
    iteration counts and solutions within 1e-5.  Both solve with the JAX
    side's f32 cache (two f32 Riccati runs differ in the last bits, and the
    solutions amplify that beyond the kernel comparison's tolerance)."""
    js, ps = _pair(jnp.float32, torch.float32, relaxation_alpha=1.7,
                   check_termination=4, max_iter=200)
    c = js.cache
    ps.set_cache_terms(*(np.asarray(t) for t in (c.Kinf, c.Pinf, c.Quu_inv,
                                                 c.AmBKt)))
    x0 = x0_batch(37, 21).astype(np.float32)
    jx, ju, jit, jok = js.solve_batch(x0, method="fused")
    px, pu, pit, pok = ps.solve_batch(x0, method="fused")
    assert pu.shape == (37, N - 1, 1) and px.shape == (37, N, 4)
    assert int(pok.sum()) > 30
    np.testing.assert_array_equal(pit.numpy(), jit)
    np.testing.assert_array_equal(pok.numpy(), jok)
    np.testing.assert_allclose(pu.numpy(), ju, atol=1e-5)
    np.testing.assert_allclose(px.numpy(), jx, atol=1e-5)


@pytest.mark.parametrize("method", ["condensed", "auto"])
def test_solve_batch_condensed_matches_jax(method):
    """f64: exact per-lane iteration counts, solutions within 1e-9."""
    js, ps = _pair(jnp.float64, torch.float64, max_iter=150)
    x0 = x0_batch(48, 22, scale=1.0)
    jx, ju, jit, jok = js.solve_batch(x0, method=method)
    px, pu, pit, pok = ps.solve_batch(x0, method=method)
    np.testing.assert_array_equal(pit.numpy(), jit)
    np.testing.assert_array_equal(pok.numpy(), jok)
    np.testing.assert_allclose(pu.numpy(), ju, atol=1e-9)


@pytest.mark.parametrize("method,dtype", [("fused", torch.float32),
                                          ("condensed", torch.float64)])
def test_warm_chain_equals_one_long_solve(method, dtype):
    """return_carry / warm= continues exactly: 40 + 120 iterations equal one
    160-iteration solve lane for lane."""
    ps = _setup(P.TinyMPCSolver(dtype=dtype, device=CPU),
                relaxation_alpha=1.7, max_iter=160)
    x0 = x0_batch(40, 23)
    _, u_one, it_one, ok_one = ps.solve_batch(x0, method=method)
    ps.update_settings(max_iter=40)
    _, u1, it1, ok1, carry = ps.solve_batch(x0, method=method,
                                            return_carry=True)
    assert carry.batch == 40
    assert all(t.shape[-1] == 40 for t in carry.data)
    ps.update_settings(max_iter=120)
    _, u2, it2, ok2 = ps.solve_batch(x0, method=method, warm=carry)
    done = ok1 == 1
    assert bool(done.any()) and bool((~done & (ok2 == 1)).any())
    assert torch.equal(torch.where(done, it1, 40 + it2), it_one)
    assert torch.equal(torch.where(done[:, None, None], u1, u2), u_one)
    with pytest.raises(ValueError, match="lanes"):
        ps.solve_batch(x0[:5], method=method, warm=carry)


def test_set_cache_terms_and_refs_rebuild_the_maps():
    js, ps = _pair(jnp.float64, torch.float64, max_iter=100)
    rng = np.random.default_rng(24)
    x_ref = rng.normal(scale=0.1, size=(4, N))
    u_ref = rng.normal(scale=0.1, size=(1, N - 1))
    K = np.asarray(js.cache.Kinf) * 1.01
    for s in (js, ps):
        s.set_x_ref(x_ref)
        s.set_u_ref(u_ref)
        s.set_cache_terms(K, np.asarray(js.cache.Pinf),
                          np.asarray(js.cache.Quu_inv),
                          np.asarray(js.cache.AmBKt))
    x0 = x0_batch(16, 25)
    j = js.solve_batch(x0, method="condensed")
    p = ps.solve_batch(x0, method="condensed")
    np.testing.assert_array_equal(p[2].numpy(), j[2])
    np.testing.assert_allclose(p[1].numpy(), j[1], atol=1e-9)


ADAPTIVE = dict(adaptive_rho=True, adaptive_rho_min=0.5,
                adaptive_rho_max=5.0, en_state_bound=False)


@pytest.mark.parametrize("method,controller", [
    ("condensed", "osqp"), ("auto", "osqp"), ("condensed", "termination")])
def test_solve_batch_adaptive_condensed_matches_jax(method, controller):
    """f64, per-lane adaptive rho on the Taylor-expanded maps: exact
    per-lane iteration counts, solutions within 1e-9; then a warm
    continuation from the carry, which holds the per-lane rho."""
    kw = dict(ADAPTIVE, adaptive_rho_controller=controller, max_iter=60)
    if controller == "termination":
        kw.update(adaptive_rho_taylor_trust=2.0, abs_pri_tol=1e-4,
                  abs_dua_tol=1e-2)
    js, ps = _pair(jnp.float64, torch.float64, **kw)
    x0 = x0_batch(24, 26)
    j = js.solve_batch(x0, method=method, return_carry=True)
    p = ps.solve_batch(x0, method=method, return_carry=True)
    assert p[4].method == "condensed" and p[4].batch == 24
    rho = p[4].data.rho.numpy()
    np.testing.assert_allclose(rho, np.asarray(j[4].data.rho), atol=1e-9)
    assert (rho != cartpole.RHO).any()
    j2 = js.solve_batch(x0, method=method, warm=j[4])
    p2 = ps.solve_batch(x0, method=method, warm=p[4])
    assert 0 < int(p[3].sum()) < 24
    for a, b in ((p, j), (p2, j2)):
        np.testing.assert_array_equal(a[2].numpy(), b[2])
        np.testing.assert_array_equal(a[3].numpy(), b[3])
        np.testing.assert_allclose(a[1].numpy(), b[1], atol=1e-9)
        np.testing.assert_allclose(a[0].numpy(), b[0], atol=1e-9)


def test_solve_batch_adaptive_fused_matches_jax():
    """f32, B = 24 (the JAX side pads to its tile): the port's fused path on
    the CPU (kernel K2's plain version) against the JAX API's Pallas kernel,
    cold with the carry and then warm from it.  Both solve with the JAX
    side's f32 cache and sensitivities."""
    js, ps = _pair(jnp.float32, torch.float32, max_iter=30, **ADAPTIVE)
    ps.cache = ps.cache.replace(**{
        f.name: torch.tensor(np.asarray(getattr(js.cache, f.name)))
        for f in dataclasses.fields(ps.cache)})
    x0 = x0_batch(24, 27).astype(np.float32)
    j = js.solve_batch(x0, method="fused", return_carry=True)
    p = ps.solve_batch(x0, method="fused", return_carry=True)
    assert len(p) == 5 and p[4].method == "fused"
    assert p[4].data.rho.shape == (1, 24)
    np.testing.assert_array_equal(p[2].numpy(), j[2])
    np.testing.assert_array_equal(p[3].numpy(), j[3])
    np.testing.assert_allclose(p[4].data.rho.numpy()[0],
                               np.asarray(j[4].data.rho)[0, :24], rtol=1e-4)
    for s in (js, ps):
        s.update_settings(max_iter=200)
    j2 = js.solve_batch(x0, method="fused", warm=j[4])
    p2 = ps.solve_batch(x0, method="fused", warm=p[4])
    both = (p2[3].numpy() == 1) & (j2[3] == 1)
    assert both.sum() >= 12
    same = p2[2].numpy()[both] == j2[2][both]
    assert same.mean() >= 0.95
    np.testing.assert_allclose(p2[1].numpy()[both][same], j2[1][both][same],
                               atol=1e-4, rtol=1e-4)


def test_adaptive_dispatch_follows_the_jax_package():
    """Adaptive rho never takes the chunked recursions, and ``auto`` sizes
    the Taylor-expanded maps: at N = 800 the fixed maps fit the budget, the
    Taylor ones do not, so adaptive ``auto`` leaves the condensed path for
    the standard one (and returns no condensed carry), while ``solve`` runs
    the sequential recursions."""
    from tinympc_julia_tpu.ops import condensed as JC
    from tinympc_julia_tpu_torch.ops import condensed as PC
    for adaptive in (False, True):
        assert (PC.auto_uses_condensed(4, 1, 800, adaptive=adaptive)
                == JC.auto_uses_condensed(4, 1, 800, adaptive=adaptive)
                == (not adaptive))
    s = _setup(P.TinyMPCSolver(dtype=torch.float64, device=CPU), horizon=800,
               adaptive_rho=True, max_iter=6)
    out = s.solve_batch(np.zeros((2, 4)), method="auto", return_carry=True)
    assert out[4].method == "standard" and out[2].tolist() == [1, 1]
    s.set_x0([2.0, 0.0, 0.3, 0.0])
    assert s.solve() == 1 and int(s.solution.iter) == 6
    assert float(s.cache.rho) != cartpole.RHO  # updated at iteration 5


def test_adaptive_refusals_match_the_jax_package():
    x0 = np.zeros((2, 4))
    for settings, method in (
            (dict(adaptive_rho_rebuild=True), "condensed"),
            (dict(adaptive_rho_rebuild=True), "fused"),
            (dict(bf16_head_iters=5, max_iter=100), "fused"),
            (dict(max_iter=52), "fused"),
            (dict(check_termination=2, max_iter=14), "fused")):
        kw = dict(ADAPTIVE, max_iter=50)
        kw.update(settings)
        js, ps = _pair(jnp.float32, torch.float32, **kw)
        for s in (js, ps):
            with pytest.raises(ValueError):
                s.solve_batch(x0.astype(np.float32), method=method)


def test_references_rebuild_the_taylor_maps():
    js, ps = _pair(jnp.float64, torch.float64, max_iter=40, **ADAPTIVE)
    x0 = x0_batch(8, 28)
    first = ps.solve_batch(x0, method="condensed")
    x_ref = np.random.default_rng(29).normal(scale=0.2, size=(4, N))
    for s in (js, ps):
        s.set_x_ref(x_ref)
    j = js.solve_batch(x0, method="condensed")
    p = ps.solve_batch(x0, method="condensed")
    assert not torch.allclose(p[1], first[1], atol=1e-3)
    np.testing.assert_array_equal(p[2].numpy(), j[2])
    np.testing.assert_allclose(p[1].numpy(), j[1], atol=1e-9)


def test_compute_sensitivity_autograd_matches_jax():
    """The solver's LQR sensitivities from its setup data: numpy arrays
    within 1e-9 (relative to the largest entry) of the JAX solver's."""
    js = _setup(J.TinyMPCSolver(dtype=jnp.float64))
    ps = _setup(P.TinyMPCSolver(dtype=torch.float64, device=CPU))
    for a, b in zip(ps.compute_sensitivity_autograd(),
                    js.compute_sensitivity_autograd()):
        assert isinstance(a, np.ndarray) and a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-9 * max(1.0, np.abs(b).max())


@pytest.mark.parametrize("verbose", [False, True], ids=["short", "verbose"])
def test_print_problem_data_matches_jax(capsys, verbose):
    """The same lines as the JAX solver's, before and after a solve."""
    js = _setup(J.TinyMPCSolver(dtype=jnp.float64))
    ps = _setup(P.TinyMPCSolver(dtype=torch.float64, device=CPU))
    texts = []
    for s in (js, ps):
        s.print_problem_data(verbose=verbose)
        s.set_x0([0.5, 0.0, 0.1, 0.0])
        s.solve()
        s.print_problem_data(verbose=verbose)
        texts.append(capsys.readouterr().out)
    assert texts[1] == texts[0]
    assert ("Cache Kinf" in texts[1]) == verbose


def test_top_level_names_cover_the_jax_package():
    """Every public name of the JAX package is public in the port."""
    missing = sorted(set(J.__all__) - set(P.__all__))
    assert not missing, missing
    assert all(hasattr(P, name) for name in P.__all__)
    assert P.scans.__name__.endswith("ops.scans")


def test_solver_checks_its_inputs():
    s = P.TinyMPCSolver(dtype=torch.float64, device=CPU)
    with pytest.raises(RuntimeError, match="not setup"):
        s.solve_batch(np.zeros((2, 4)))
    _setup(s)
    with pytest.raises(TypeError, match="float32"):
        s.solve_batch(np.zeros((2, 4)), method="fused")
    with pytest.raises(TypeError, match="unknown setting"):
        s.update_settings(bogus=1)
    with pytest.raises(ValueError, match="x_ref"):
        s.set_x_ref(np.zeros((3, N)))
    with pytest.raises(RuntimeError, match="No solution"):
        s.get_solution()


def test_fused_bf16_head_runs_and_matches_jax():
    """``Settings.bf16_head_iters`` reaches kernel K1's head: off the TPU
    the JAX head is fp32, so with the port's rounding on the two agree to
    the bf16 noise the tail then removes (equal verdicts, 5e-3 on the
    controls), and the head's cumulative counts never fall below it."""
    js, ps = _pair(jnp.float32, torch.float32, max_iter=80,
                   check_termination=4, bf16_head_iters=8,
                   relaxation_alpha=1.7)
    x0 = x0_batch(32, 31).astype(np.float32)
    j = js.solve_batch(x0, method="fused")
    p = ps.solve_batch(x0, method="fused")
    assert int(p[2].min()) >= 8 and int(p[3].sum()) > 16
    np.testing.assert_array_equal(p[3].numpy(), j[3])
    both = j[3] == 1
    np.testing.assert_allclose(p[1].numpy()[both], j[1][both], atol=5e-3)
    nohead = ps
    nohead.update_settings(bf16_head_iters=0)
    q = nohead.solve_batch(x0, method="fused")
    assert not torch.equal(q[1], p[1])  # the head's rounding was on
