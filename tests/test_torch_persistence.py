"""The port's checkpoints (utils/checkpoint.py, TinyMPCSolver.save/load):
the round trips of tests/test_persistence.py on the port, the file format
against the JAX package's, loads across the two packages, and the settings
the JAX file drops."""
import json
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tinympc_julia_tpu as J
import tinympc_julia_tpu_torch as P
from tinympc_julia_tpu.models import cartpole
from tinympc_julia_tpu_torch.models import cartpole as pcartpole
from tinympc_julia_tpu_torch.models import rocket as procket

from torch_port_common import CPU

X0 = np.array([0.0, 0.0, 0.1, 0.0])
# the five settings the JAX package's file drops, at other than default
DROPPED = dict(relaxation_alpha=1.7, adaptive_rho_taylor_trust=2.0,
               adaptive_rho_rebuild=True,
               adaptive_rho_controller="termination", bf16_head_iters=16)


def _steps(solvers, x, n):
    """``n`` closed-loop steps of every solver from ``x``, the plant driven
    by the first one's control; returns the last x, each step's controls and
    counts per solver."""
    us = [[] for _ in solvers]
    its = [[] for _ in solvers]
    for _ in range(n):
        for k, s in enumerate(solvers):
            s.set_x0(x)
            s.solve()
            us[k].append(np.asarray(s.get_solution().controls))
            its[k].append(int(s.solution.iter))
        x = cartpole.simulate(x, us[0][-1][:, 0])
    return x, us, its


def _assert_same(us, its, atol):
    for k in range(1, len(us)):
        assert its[k] == its[0]
        for a, b in zip(us[k], us[0]):
            np.testing.assert_allclose(a, b, atol=atol, rtol=0)


@pytest.mark.parametrize("settings", [{}, dict(
    relaxation_alpha=1.7, adaptive_rho=True, adaptive_rho_min=0.5,
    adaptive_rho_max=5.0, adaptive_rho_controller="termination",
    adaptive_rho_taylor_trust=2.0)], ids=["defaults", "alpha-taylor-trust"])
def test_roundtrip_mid_loop(tmp_path, settings):
    """Save mid closed loop, load, continue: the same controls to the bit
    and the same counts (tests/test_persistence.py's round trip, also with
    a non-default relaxation_alpha and Taylor trust region)."""
    s = pcartpole.make_solver(device=CPU, max_iter=100, constrained=True)
    s.update_settings(**settings)
    x, _, _ = _steps([s], X0, 10)
    path = os.path.join(str(tmp_path), "ckpt.npz")
    s.save(path)
    s2 = P.TinyMPCSolver.load(path, device=CPU)
    assert s2.settings == s.settings
    _, us, its = _steps([s, s2], x, 10)
    _assert_same(us, its, atol=0)


def test_roundtrip_with_constraints(tmp_path):
    """Cones and halfspaces survive the round trip (the cone structure is
    metadata)."""
    s = procket.make_solver(device=CPU)
    s.set_linear_constraints(np.array([[1.0, 0, 0, 0, 0, 0]]),
                             np.array([5.0]), np.zeros((0, 3)), np.zeros(0))
    s.set_x0(procket.X_INIT)
    path = os.path.join(str(tmp_path), "rocket.npz")
    s.save(path)
    s2 = P.TinyMPCSolver.load(path, device=CPU)
    assert s2.problem.cones_u.starts == (0,)
    assert s2.problem.cones_u.dims == (3,)
    assert s2.settings.en_input_soc and s2.settings.en_state_linear
    s.solve()
    s2.solve()
    np.testing.assert_array_equal(s2.get_solution().controls,
                                  s.get_solution().controls)
    assert int(s2.solution.iter) == int(s.solution.iter)


def test_unsetup_save_raises(tmp_path):
    with pytest.raises(RuntimeError, match="not setup"):
        P.TinyMPCSolver(device=CPU).save(os.path.join(str(tmp_path), "x.npz"))


def test_file_format_matches_jax(tmp_path):
    """The same keys, shapes and dtypes as the JAX package's file of the
    same solver, and the same metadata apart from the five settings the
    port adds."""
    js = J.TinyMPCSolver(dtype=jnp.float64)
    ps = P.TinyMPCSolver(dtype=torch.float64, device=CPU)
    for s in (js, ps):
        s.setup(cartpole.A, cartpole.B, None, np.diag(cartpole.Q_DIAG),
                np.diag(cartpole.R_DIAG), 1.0, 4, 1, 20, max_iter=50)
        s.set_cone_constraints([], [], [], [0], [3], [0.5])
        s.set_x0(X0)
        s.solve()
    jpath, ppath = (os.path.join(str(tmp_path), n) for n in ("j.npz", "p.npz"))
    js.save(jpath)
    ps.save(ppath)
    with np.load(jpath) as jd, np.load(ppath) as pd:
        assert sorted(pd.files) == sorted(jd.files)
        for k in set(jd.files) - {"__meta__"}:
            assert pd[k].dtype == jd[k].dtype, k
            assert pd[k].shape == jd[k].shape, k
            if k.startswith("problem_"):
                np.testing.assert_array_equal(pd[k], jd[k], err_msg=k)
        jm, pm = json.loads(str(jd["__meta__"])), json.loads(str(pd["__meta__"]))
    assert set(pm["settings"]) - set(jm["settings"]) == set(DROPPED)
    for k, v in jm["settings"].items():
        assert pm["settings"][k] == v, k
    for k in ("version", "dtype", "cones_x", "cones_u", "user"):
        assert pm[k] == jm[k], k


def test_jax_saved_loads_into_the_port(tmp_path):
    """A JAX checkpoint taken mid closed loop loads into the port, and both
    continuations agree: equal counts, controls within 1e-12."""
    js = cartpole.make_solver(max_iter=100, constrained=True)
    x, _, _ = _steps([js], X0, 10)
    path = os.path.join(str(tmp_path), "jax.npz")
    js.save(path)
    ps = P.TinyMPCSolver.load(path, device=CPU)
    assert ps.dtype == torch.float64
    _, us, its = _steps([js, ps], x, 10)
    _assert_same(us, its, atol=1e-12)


def test_port_saved_loads_into_jax(tmp_path):
    """The other way: a port checkpoint, with its five extra settings at
    their defaults, loads into the JAX package and the continuations
    agree: equal counts, controls within 1e-12."""
    ps = pcartpole.make_solver(device=CPU, max_iter=100, constrained=True)
    x, _, _ = _steps([ps], X0, 10)
    path = os.path.join(str(tmp_path), "port.npz")
    ps.save(path)
    js = J.TinyMPCSolver.load(path)
    assert js.settings.max_iter == 100 and js.settings.en_state_bound
    _, us, its = _steps([ps, js], x, 10)
    _assert_same(us, its, atol=1e-12)


def test_port_keeps_the_settings_the_jax_file_drops(tmp_path):
    """All five settings the JAX writer leaves out come back from the
    port's file; the JAX package's file of the same solver brings them back
    at their defaults, in the port as in the JAX package."""
    ps = pcartpole.make_solver(device=CPU, max_iter=96)
    ps.update_settings(**DROPPED)
    js = cartpole.make_solver(max_iter=96)
    js.update_settings(**DROPPED)
    ppath, jpath = (os.path.join(str(tmp_path), n) for n in ("p.npz", "j.npz"))
    ps.save(ppath)
    js.save(jpath)
    back = P.TinyMPCSolver.load(ppath, device=CPU).settings
    assert {k: getattr(back, k) for k in DROPPED} == DROPPED
    assert back == ps.settings
    defaults = P.Settings()
    from_jax = P.TinyMPCSolver.load(jpath, device=CPU).settings
    jax_back = J.TinyMPCSolver.load(jpath).settings
    for k in DROPPED:
        assert getattr(from_jax, k) == getattr(defaults, k), k
        assert getattr(jax_back, k) == getattr(from_jax, k), k
    # the JAX package reads the port's file with all five
    jax_from_port = J.TinyMPCSolver.load(ppath).settings
    assert {k: getattr(jax_from_port, k) for k in DROPPED} == DROPPED


def test_load_rebuilds_the_maps_and_float32(tmp_path):
    """A float32 solver's checkpoint comes back in float32, without maps;
    its first condensed batch builds them and equals the saved solver's."""
    s = pcartpole.make_solver(device=CPU, dtype=torch.float32,
                              constrained=True)
    x0s = np.random.default_rng(3).uniform(-0.5, 0.5, (16, 4))
    ref = s.solve_batch(x0s, method="condensed")
    path = os.path.join(str(tmp_path), "f32.npz")
    s.save(path)
    s2 = P.TinyMPCSolver.load(path, device=CPU)
    assert s2.dtype == torch.float32 and s2._condensed_maps is None
    out = s2.solve_batch(x0s, method="condensed")
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert s2.problem.A.dtype == torch.float32
    assert s2.state.iter.dtype == torch.int32
