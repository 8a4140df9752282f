"""The port's ops/condensed.py (fixed-rho half) vs the JAX package, float64."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tinympc_julia_tpu as J
from tinympc_julia_tpu.models import cartpole
from tinympc_julia_tpu.ops.condensed import (auto_chunk_size,
                                             auto_uses_condensed,
                                             build_condensed as jax_build,
                                             solve_condensed as jax_solve)
from tinympc_julia_tpu_torch.ops import condensed as C
from tinympc_julia_tpu_torch.utils import convert

from torch_port_common import CPU, cartpole_setup, jax_arrays, x0_batch

F64 = jnp.float64


def test_build_condensed_matches_jax():
    """T1, T2 and T12 from the port's own copy of the host builders, on a
    problem with an affine term and references: 1e-12."""
    rng = np.random.default_rng(7)
    N = cartpole.HORIZON
    jp = J.make_problem(jnp.asarray(cartpole.A), jnp.asarray(cartpole.B),
                        jnp.asarray(np.diag(cartpole.Q_DIAG)),
                        jnp.asarray(np.diag(cartpole.R_DIAG)), 1.0, N,
                        f=jnp.asarray(rng.normal(scale=0.01, size=4)),
                        Xref=jnp.asarray(rng.normal(size=(N, 4))),
                        Uref=jnp.asarray(rng.normal(size=(N - 1, 1))))
    jc = J.precompute_cache(jp.A, jp.B, jp.Q, jp.R, jnp.asarray(1.0, F64))
    jm = jax_build(jp, jc)
    pp = convert.problem_from_numpy(jax_arrays(jp), dtype=torch.float64,
                                    device=CPU)
    pc = convert.cache_from_numpy(jax_arrays(jc), dtype=torch.float64,
                                  device=CPU)
    pm = C.build_condensed(pp, pc)
    for k in ("T1", "T2", "T12"):
        np.testing.assert_allclose(getattr(pm, k).numpy(),
                                   np.asarray(getattr(jm, k)), atol=1e-12,
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("nx,nu,N", [(4, 1, 20), (12, 4, 20), (4, 1, 600),
                                     (2, 1, 2000)])
def test_budget_helpers_match_jax(nx, nu, N):
    assert C.auto_uses_condensed(nx, nu, N) == auto_uses_condensed(nx, nu, N)
    assert C.auto_chunk_size(nx, nu, N) == auto_chunk_size(nx, nu, N)


SETTINGS = {
    "ct1": dict(max_iter=120, en_state_bound=False, relaxation_alpha=1.7),
    "ct4": dict(max_iter=120, en_state_bound=False, relaxation_alpha=1.7,
                check_termination=4),
    "state_bound": dict(max_iter=160, en_state_bound=True),
}


@pytest.mark.parametrize("name", list(SETTINGS))
def test_solve_condensed_matches_jax(name):
    """Identical per-lane iteration counts on every lane; solutions and the
    carry within 1e-9."""
    kw = SETTINGS[name]
    (jp, jc, jm), (pp, pc, pm) = cartpole_setup(
        F64, state_bound=kw["en_state_bound"])
    x0 = x0_batch(64, 11, scale=1.5)
    js = J.Settings(en_input_bound=True, **kw)
    ps = C.Settings(en_input_bound=True, **kw)
    a = jax_solve(jp, jc, js, jnp.asarray(x0), jm, return_carry=True)
    b = C.solve_condensed(pp, pc, ps, torch.as_tensor(x0), pm,
                          return_carry=True)
    np.testing.assert_array_equal(b[2].numpy(), np.asarray(a[2]))
    np.testing.assert_array_equal(b[3].numpy(), np.asarray(a[3]))
    assert 0 < int(b[3].sum())
    for i in (0, 1):
        np.testing.assert_allclose(b[i].numpy(), np.asarray(a[i]), atol=1e-9)
    for k in C.CondensedCarry._fields:
        np.testing.assert_allclose(getattr(b[4], k).numpy(),
                                   np.asarray(getattr(a[4], k)), atol=1e-9,
                                   err_msg=k)


def test_solve_condensed_warm_chain_matches_jax():
    """A 30-iteration solve continued warm for 50 more: same per-lane counts
    as the JAX chain, and the chain equals the port's own 80-iteration
    solve."""
    (jp, jc, jm), (pp, pc, pm) = cartpole_setup(F64)
    x0 = x0_batch(64, 12)
    kw = dict(en_state_bound=False, en_input_bound=True)
    j1 = jax_solve(jp, jc, J.Settings(max_iter=30, **kw), jnp.asarray(x0),
                   jm, return_carry=True)
    j2 = jax_solve(jp, jc, J.Settings(max_iter=50, **kw), jnp.asarray(x0),
                   jm, warm=j1[4])
    x0t = torch.as_tensor(x0)
    p1 = C.solve_condensed(pp, pc, C.Settings(max_iter=30, **kw), x0t, pm,
                           return_carry=True)
    p2 = C.solve_condensed(pp, pc, C.Settings(max_iter=50, **kw), x0t, pm,
                           warm=p1[4])
    for a, b in ((j1, p1), (j2, p2)):
        np.testing.assert_array_equal(b[2].numpy(), np.asarray(a[2]))
        np.testing.assert_allclose(b[1].numpy(), np.asarray(a[1]), atol=1e-9)
    one = C.solve_condensed(pp, pc, C.Settings(max_iter=80, **kw), x0t, pm)
    done = p1[3] == 1
    assert bool(done.any()) and bool((~done & (p2[3] == 1)).any())
    np.testing.assert_array_equal(
        torch.where(done, p1[2], 30 + p2[2]).numpy(), one[2].numpy())
    np.testing.assert_allclose(
        torch.where(done[:, None, None], p1[1], p2[1]).numpy(),
        one[1].numpy(), atol=1e-12)


def test_solve_condensed_rejects_unported_settings():
    (_, _, _), (pp, pc, pm) = cartpole_setup(F64)
    x0 = torch.zeros((2, 4), dtype=torch.float64)
    # adaptive rho needs the Taylor-expanded maps: the fixed-rho solve
    # refuses it, as the JAX package's does
    with pytest.raises(ValueError, match="solve_condensed_adaptive"):
        C.solve_condensed(pp, pc, C.Settings(adaptive_rho=True), x0, pm)
