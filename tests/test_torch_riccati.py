"""The port's ops/riccati.py vs the JAX package and the reference fixtures."""
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tinympc_julia_tpu as J
import tinympc_julia_tpu_torch as P
from tinympc_julia_tpu.models import cartpole, quadrotor

from torch_port_common import CPU

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
TERMS = ("Kinf", "Pinf", "Quu_inv", "AmBKt", "C1", "C2")
SENS = ("dKinf_drho", "dPinf_drho", "dC1_drho", "dC2_drho")


def _caches(model):
    args = (model.A, model.B, np.diag(model.Q_DIAG), np.diag(model.R_DIAG))
    N = model.HORIZON
    jp = J.make_problem(*(jnp.asarray(a, jnp.float64) for a in args),
                        model.RHO, N)
    jc = J.precompute_cache(jp.A, jp.B, jp.Q, jp.R,
                            jnp.asarray(model.RHO, jnp.float64))
    pp = P.make_problem(*args, model.RHO, N, device=CPU, dtype=torch.float64)
    pc = P.precompute_cache(pp.A, pp.B, pp.Q, pp.R, pp.rho_setup)
    return jc, pc


@pytest.fixture(scope="module", params=[cartpole, quadrotor],
                ids=["cartpole", "quadrotor"])
def caches(request):
    return request.param, _caches(request.param)


def test_cache_terms_match_jax(caches):
    """Same fixed point and stop rule, two LAPACK builds: 1e-10."""
    _, (jc, pc) = caches
    for k in TERMS:
        np.testing.assert_allclose(getattr(pc, k).numpy(),
                                   np.asarray(getattr(jc, k)), atol=1e-10,
                                   rtol=0, err_msg=k)
    assert float(pc.rho) == float(jc.rho)


def test_sensitivities_match_jax(caches):
    """Forward-mode AD through the fixed-point loop vs jax.jacfwd: 1e-8."""
    _, (jc, pc) = caches
    for k in SENS:
        np.testing.assert_allclose(getattr(pc, k).numpy(),
                                   np.asarray(getattr(jc, k)), atol=1e-8,
                                   rtol=0, err_msg=k)
        assert np.abs(getattr(pc, k).numpy()).max() > 0, k


# tolerances of tests/test_parity_golden.py::TestCacheParity
GOLDEN_TOL = {
    cartpole: ("cartpole_one_solve",
               dict(Kinf=1e-8, Pinf=1e-7, Quu_inv=1e-10, AmBKt=1e-8)),
    quadrotor: ("quadrotor_hover",
                dict(Kinf=1e-7, Pinf=1e-5, Quu_inv=1e-10, AmBKt=1e-7)),
}


def test_cache_matches_reference_fixture(caches):
    model, (_, pc) = caches
    name, tols = GOLDEN_TOL[model]
    g = np.load(os.path.join(GOLDEN, name + ".npz"))
    for k, tol in tols.items():
        np.testing.assert_allclose(getattr(pc, k).numpy(), g["cache_" + k],
                                   atol=tol, err_msg=k)


def test_cache_without_sensitivities_is_zero():
    pp = P.make_problem(cartpole.A, cartpole.B, np.diag(cartpole.Q_DIAG),
                        np.diag(cartpole.R_DIAG), 1.0, 20, device=CPU)
    pc = P.precompute_cache(pp.A, pp.B, pp.Q, pp.R, pp.rho_setup,
                            compute_sensitivity=False)
    assert all(float(getattr(pc, k).abs().max()) == 0.0 for k in SENS)


# -- the Julia-style LQR and its rho sensitivities ---------------------------

def _lqr_args(model):
    return (model.A, model.B, np.diag(model.Q_DIAG), np.diag(model.R_DIAG))


def _close(port, ref, tol, what):
    """max |port - ref| <= tol times the larger of 1 and ref's largest
    entry (P and its derivative reach 1e3-1e4)."""
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape, what
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(port - ref).max())
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} x {scale:.3e}"


@pytest.mark.parametrize("model", [cartpole, quadrotor],
                         ids=["cartpole", "quadrotor"])
def test_solve_lqr_matches_jax(model):
    """One rho fold, the reg term, the Frobenius stop: 1e-12 (relative to
    the largest entry) of the JAX helper's (K, P, C1, C2), float64."""
    args = _lqr_args(model)
    j = J.solve_lqr(*(jnp.asarray(a, jnp.float64) for a in args), model.RHO)
    p = P.solve_lqr(*(torch.as_tensor(a, dtype=torch.float64) for a in args),
                    model.RHO)
    for name, a, b in zip(("K", "P", "C1", "C2"), p, j):
        _close(a.numpy(), b, 1e-12, name)
    # the diagonals give the same fixed point as the matrices
    d = P.solve_lqr(torch.as_tensor(model.A), torch.as_tensor(model.B),
                    torch.as_tensor(model.Q_DIAG),
                    torch.as_tensor(model.R_DIAG), model.RHO)
    for a, b in zip(d, p):
        assert torch.equal(a, b)


@pytest.mark.parametrize("model", [cartpole, quadrotor],
                         ids=["cartpole", "quadrotor"])
def test_lqr_sensitivities_match_jax(model):
    """Forward-mode AD through the LQR loop against jax.jacfwd (1e-9), and
    the finite differences against the JAX ones (1e-6: the step h = 1e-6
    magnifies the two LAPACK builds' last-bit differences), each relative
    to the largest entry; the exact and the finite-difference derivatives
    agree to the differences' own error."""
    args = _lqr_args(model)
    jargs = [jnp.asarray(a, jnp.float64) for a in args]
    targs = [torch.as_tensor(a, dtype=torch.float64) for a in args]
    names = ("dK", "dP", "dC1", "dC2")
    ad = P.compute_sensitivity_autograd(*targs, model.RHO)
    for name, a, b in zip(names, ad,
                          J.compute_sensitivity_autograd(*jargs, model.RHO)):
        _close(a.numpy(), b, 1e-9, name)
        assert np.abs(a.numpy()).max() > 0, name
    fd = P.compute_sensitivity_fd(*targs, model.RHO)
    for name, a, b in zip(names, fd,
                          J.compute_sensitivity_fd(*jargs, model.RHO)):
        _close(a.numpy(), b, 1e-6, name)
    for name, a, b in zip(names, fd, ad):
        _close(a.numpy(), b.numpy(), 1e-4, name)


def test_cache_sensitivities_match_reference_fixture():
    """The quadrotor cache's exact sensitivities at rho 5 against the
    finite differences the reference binary used
    (golden/quadrotor_sensitivities.npz), at the bars of
    tests/test_sensitivity.py: rtol 2e-3, atol 2e-4."""
    pc = _caches(quadrotor)[1]
    g = np.load(os.path.join(GOLDEN, "quadrotor_sensitivities.npz"))
    for k, gk in zip(SENS, ("dKinf", "dPinf", "dC1", "dC2")):
        np.testing.assert_allclose(getattr(pc, k).numpy(), g[gk], rtol=2e-3,
                                   atol=2e-4, err_msg=k)
