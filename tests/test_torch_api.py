"""The port's TinyMPCSolver vs the JAX package's, and its unported surface."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tinympc_julia_tpu as J
import tinympc_julia_tpu_torch as P
from tinympc_julia_tpu.models import cartpole

from torch_port_common import CPU, x0_batch

N = cartpole.HORIZON


def _setup(solver, **settings):
    solver.setup(cartpole.A, cartpole.B, None, np.diag(cartpole.Q_DIAG),
                 np.diag(cartpole.R_DIAG), cartpole.RHO, 4, 1, N)
    solver.set_bound_constraints(np.full((4, N), -1e17),
                                 np.full((4, N), 1e17),
                                 np.full((1, N - 1), -5.0),
                                 np.full((1, N - 1), 5.0))
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


@pytest.mark.parametrize("call", [
    lambda s: s.solve_batch(np.zeros((2, 4)), method="standard"),
    lambda s: s.solve_batch(np.zeros((2, 4)), method="chunked"),
    lambda s: (s.update_settings(adaptive_rho=True),
               s.solve_batch(np.zeros((2, 4)), method="fused")),
    lambda s: (s.update_settings(bf16_head_iters=4, check_termination=4,
                                 max_iter=40),
               s.solve_batch(np.zeros((2, 4)), method="fused")),
    lambda s: s.solve_batch_rebuild_adaptive(np.zeros((2, 4))),
    lambda s: s.compute_sensitivity_autograd(),
    lambda s: s.codegen("out"),
    lambda s: s.save("x"),
], ids=["standard", "chunked", "adaptive-rho", "bf16-head", "rebuild",
        "sensitivity", "codegen", "save"])
def test_unported_surface_raises(call):
    s = _setup(P.TinyMPCSolver(dtype=torch.float32, device=CPU))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        call(s)


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
