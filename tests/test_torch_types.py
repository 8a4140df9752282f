"""The port's types.py and package surface vs the JAX package."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tinympc_julia_tpu as J
import tinympc_julia_tpu_torch as P
from tinympc_julia_tpu.models import cartpole, quadrotor

from torch_port_common import CPU, jax_arrays

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_loads_neither_jax_nor_flax():
    code = ("import sys, tinympc_julia_tpu_torch, "
            "tinympc_julia_tpu_torch.parallel, tinympc_julia_tpu_torch.utils; "
            "bad = [m for m in ('jax', 'flax') if m in sys.modules]; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("model,kw", [
    (cartpole, {}),
    (cartpole, dict(u_min=-5.0, u_max=5.0)),
    (quadrotor, dict(u_min=-0.5, u_max=0.5, f=np.arange(12) * 0.01,
                     Xref=np.full((20, 12), 0.3))),
], ids=["cartpole", "cartpole-box", "quadrotor-f-xref"])
def test_make_problem_matches_jax(model, kw):
    """Field by field equal in float64: the single rho fold, the +-inf fill
    of bounds not given, broadcasting of scalar bounds."""
    N = model.HORIZON
    args = (model.A, model.B, np.diag(model.Q_DIAG), np.diag(model.R_DIAG),
            model.RHO, N)
    jp = J.make_problem(*(jnp.asarray(a, jnp.float64) for a in args[:4]),
                        *args[4:], **{k: jnp.asarray(v) for k, v in
                                      kw.items()})
    pp = P.make_problem(*args, device=CPU, dtype=torch.float64, **kw)
    want = jax_arrays(jp)
    got = {f.name: getattr(pp, f.name) for f in dataclasses.fields(pp)}
    assert set(got) == set(want)
    for k, v in want.items():
        if k in ("cones_x", "cones_u"):
            assert got[k].num_cones == 0 and v["starts"] == (), k
            continue
        assert got[k].dtype == torch.float64, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    assert (pp.nx, pp.nu, pp.N) == (jp.nx, jp.nu, jp.N)


def test_settings_match_jax_defaults():
    js, ps = J.default_settings(), P.default_settings()
    names = [f.name for f in dataclasses.fields(ps)]
    assert names == [f.name for f in dataclasses.fields(js)]
    for n in names:
        assert getattr(ps, n) == getattr(js, n), n
    assert P.settings_bake_key(ps.replace(max_iter=7)) != \
        P.settings_bake_key(ps)


def test_make_problem_copies_its_inputs():
    A = np.array(cartpole.A)
    pp = P.make_problem(A, cartpole.B, np.diag(cartpole.Q_DIAG),
                        np.diag(cartpole.R_DIAG), 1.0, 20, device=CPU)
    A[0, 0] = 99.0
    assert float(pp.A[0, 0]) == 1.0
    assert all(t.is_contiguous() for t in (pp.x_min, pp.u_max, pp.Xref))


def test_convert_round_trip():
    """to_numpy and the *_from_numpy converters carry a Problem, a Cache and
    a carry across unchanged."""
    from tinympc_julia_tpu_torch.ops.cuda.condensed_kernel import FusedCarry
    from tinympc_julia_tpu_torch.utils import convert
    pp = P.make_problem(cartpole.A, cartpole.B, np.diag(cartpole.Q_DIAG),
                        np.diag(cartpole.R_DIAG), 1.0, 20, u_min=-5.0,
                        u_max=5.0, device=CPU)
    pc = P.precompute_cache(pp.A, pp.B, pp.Q, pp.R, pp.rho_setup,
                            compute_sensitivity=False)
    carry = FusedCarry(*(torch.randn(n, 3) for n in (99, 19, 80, 80, 19)))
    for obj, back in ((pp, convert.problem_from_numpy),
                      (pc, convert.cache_from_numpy),
                      (carry, convert.carry_from_numpy)):
        d = convert.to_numpy(obj)
        again = convert.to_numpy(back(d, dtype=torch.float64, device=CPU))
        assert set(again) == set(d)
        for k in d:
            if isinstance(d[k], dict):  # a cone set
                assert again[k]["starts"] == d[k]["starts"], k
                assert again[k]["dims"] == d[k]["dims"], k
                np.testing.assert_array_equal(again[k]["mus"], d[k]["mus"])
            else:
                np.testing.assert_array_equal(again[k], d[k], err_msg=k)
