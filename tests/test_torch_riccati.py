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
