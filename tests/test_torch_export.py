"""The port's ahead-of-time export (utils/export.py): the single and the
batched solve exported through torch.export, saved to bytes, loaded and
called, against the eager ``admm.solve`` / ``batch.solve_batch`` and the
JAX package's exported solve on the same problem, cache and state (the JAX
side's carried into the port through utils/convert), float64.  Bars: equal
per-lane iteration counts and flags, controls and states within 1e-12."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tinympc_julia_tpu as J
from tinympc_julia_tpu.parallel import batch as jbatch
from tinympc_julia_tpu.utils import export as jexport
from tinympc_julia_tpu_torch.ops import admm
from tinympc_julia_tpu_torch.parallel import batch as pbatch
from tinympc_julia_tpu_torch.types import Settings
from tinympc_julia_tpu_torch.utils import convert
from tinympc_julia_tpu_torch.utils import export as pexport

from torch_port_common import (CPU, cartpole_setup, jax_arrays, rocket_setup,
                               rocket_x0)

F64 = jnp.float64
B = 4
CASES = {
    "cartpole": dict(max_iter=100, relaxation_alpha=1.6,
                     check_termination=2, en_state_bound=False),
    "rocket-cones": dict(max_iter=80, abs_pri_tol=2e-3, en_state_soc=True,
                         en_input_soc=True),
    "adaptive-osqp": dict(max_iter=60, adaptive_rho=True,
                          adaptive_rho_min=0.5, adaptive_rho_max=5.0,
                          en_state_bound=False),
    "adaptive-termination-trust": dict(
        max_iter=60, adaptive_rho=True, adaptive_rho_min=0.5,
        adaptive_rho_max=5.0, adaptive_rho_controller="termination",
        adaptive_rho_taylor_trust=2.0, en_state_bound=False),
    "adaptive-rebuild": dict(
        max_iter=60, adaptive_rho=True, adaptive_rho_min=0.5,
        adaptive_rho_max=5.0, adaptive_rho_controller="termination",
        adaptive_rho_rebuild=True, en_state_bound=False),
}


def _case(name, batched):
    """(JAX problem, cache, settings, state) and the port's copies."""
    if name.startswith("rocket"):
        (jp, jc, _), (pp, pc, _) = rocket_setup(F64)
        x0s = rocket_x0(B)
    else:
        (jp, jc, _), (pp, pc, _) = cartpole_setup(F64)
        x0s = np.random.default_rng(5).uniform(-0.8, 0.8, size=(B, 4))
    js = J.Settings(**CASES[name])
    ps = Settings(**CASES[name])
    nx, nu, N = jp.nx, jp.nu, jp.N
    jst = J.init_state(nx, nu, N, F64)
    if batched:
        jst = jbatch.set_x0_batch(jbatch.broadcast_state(jst, B),
                                  jnp.asarray(x0s))
    else:
        jst = jst.replace(x=jst.x.at[0].set(jnp.asarray(x0s[0])))
    pst = convert.state_from_numpy(jax_arrays(jst), dtype=torch.float64,
                                   device=CPU)
    return (jp, jc, js, jst), (pp, pc, ps, pst)


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
@pytest.mark.parametrize("name", list(CASES))
def test_exported_solve_matches_eager_and_jax(name, batched):
    (jp, jc, js, jst), (pp, pc, ps, pst) = _case(name, batched)
    blob = pexport.export_solve(pp, pc, ps, pst, batched=batched)
    assert isinstance(blob, bytes) and blob
    st, ca, sol = pexport.load_solve(blob)(pp, pc, pst)
    eager = (pbatch.solve_batch if batched else admm.solve)(pp, pc, ps, pst)
    jfn = jexport.load_solve(jexport.export_solve(jp, jc, js, jst,
                                                  batched=batched))
    _, _, jsol = jfn(jp, jc, jst)
    for ref, what in ((eager[2], "eager"), (None, "jax")):
        it = ref.iter.numpy() if ref is not None else np.asarray(jsol.iter)
        ok = ref.solved.numpy() if ref is not None else np.asarray(jsol.solved)
        np.testing.assert_array_equal(sol.iter.numpy(), it, err_msg=what)
        np.testing.assert_array_equal(sol.solved.numpy(), ok, err_msg=what)
        for k in ("x", "u"):
            r = (getattr(ref, k).numpy() if ref is not None
                 else np.asarray(getattr(jsol, k)))
            np.testing.assert_allclose(getattr(sol, k).numpy(), r,
                                       atol=1e-12, rtol=0,
                                       err_msg=f"{what} {k}")
    # the exported program runs the eager iteration: the same bits, except
    # where a batch's exact rebuilds run as one batched fixed point (the
    # eager loop runs one an instance): there to 1e-12, relative on the
    # linear terms p (entries up to ~1e3)
    exact = not (batched and ps.adaptive_rho_rebuild)
    for f in ("x", "u", "y", "g", "d", "p", "status", "iter"):
        a, b = getattr(st, f), getattr(eager[0], f)
        assert (torch.equal(a, b) if exact
                else torch.allclose(a, b, rtol=1e-12, atol=1e-12)), f
    assert (torch.equal(ca.rho, eager[1].rho) if exact
            else torch.allclose(ca.rho, eager[1].rho, rtol=1e-12,
                                atol=1e-12))
    if batched:
        assert sol.iter.shape == (B,)
    if ps.adaptive_rho:
        assert bool((ca.rho != pc.rho).any()), "rho never moved"


def test_exported_solve_with_horizon_parallel():
    """``horizon_parallel=True`` exports the associative-scan recursions:
    the eager solve with the same flag, to the bit."""
    _, (pp, pc, ps, pst) = _case("cartpole", False)
    fn = pexport.load_solve(pexport.export_solve(pp, pc, ps, pst,
                                                 horizon_parallel=True))
    out = fn(pp, pc, pst)
    eager = admm.solve(pp, pc, ps, pst, horizon_parallel=True)
    assert int(out[2].iter) == int(eager[2].iter)
    assert torch.equal(out[2].u, eager[2].u)
