"""The port's examples (tinympc_julia_tpu_torch/examples/) on the CPU, in
the quick configurations of tests/test_examples.py, each with its
assertion there and held against the JAX example run in this process at
the same arguments.  Printed output: the same text, and every number to
within one unit of its last printed digit (the modules underneath agree
far closer: 1e-9 for ``solve()`` in float64, equal counts and 1e-4 for the
float32 batched paths), except the rocket's count of plant-level cone
violations, which counts controls that the cone projection leaves on the
cone's boundary, where the last bit decides, and the sweep's device count
and timing.  The codegen examples write the JAX examples' projects byte
for byte; the swing-up writes the JAX example's trajectories within the
float32 batched paths' 1e-4."""
import importlib
import importlib.util
import pathlib
import re
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"
NUMBER = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?")


def _port(name):
    return importlib.import_module(f"tinympc_julia_tpu_torch.examples.{name}")


def _jax(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _unit(token):
    """One unit of a printed number's last digit."""
    mant, _, exp = token.partition("e")
    decimals = len(mant.partition(".")[2])
    return 10.0 ** (int(exp or 0) - decimals)


def _same_output(ours, theirs, skip=()):
    """The same lines with the same text, and every number within one unit
    of the JAX example's last printed digit; lines that start with a
    prefix in ``skip`` are left out."""
    keep = [[ln for ln in out.splitlines() if not ln.startswith(skip)]
            for out in (ours, theirs)]
    assert len(keep[0]) == len(keep[1]), (ours, theirs)
    for a, b in zip(*keep):
        assert NUMBER.sub("#", a) == NUMBER.sub("#", b), (a, b)
        for x, y in zip(NUMBER.findall(a), NUMBER.findall(b)):
            assert abs(float(x) - float(y)) <= _unit(y) * (1 + 1e-9), (a, b)


def test_cartpole_one_solve(capsys):
    _jax("cartpole_one_solve.py").main()
    theirs = capsys.readouterr().out
    _port("cartpole_one_solve").main(device="cpu")
    ours = capsys.readouterr().out
    assert "[" in ours  # prints the controls array
    _same_output(ours, theirs)


def test_cartpole_mpc(capsys):
    _jax("cartpole_mpc.py").main(nsteps=8)
    theirs = capsys.readouterr().out
    x = _port("cartpole_mpc").main(nsteps=8, device="cpu")
    assert np.all(np.isfinite(x))
    _same_output(capsys.readouterr().out, theirs)


def test_cartpole_constrained(capsys):
    _jax("cartpole_constrained.py").main(nsteps=8)
    theirs = capsys.readouterr().out
    max_u, _ = _port("cartpole_constrained").main(nsteps=8, device="cpu")
    assert max_u <= 5.0 + 1e-9
    _same_output(capsys.readouterr().out, theirs)


def test_cartpole_gain_scheduled(capsys):
    _jax("cartpole_gain_scheduled.py").main(nsteps=8, plot=False)
    theirs = capsys.readouterr().out
    traj = _port("cartpole_gain_scheduled").main(nsteps=8, plot=False,
                                                 device="cpu")
    assert traj.shape == (8, 4)
    _same_output(capsys.readouterr().out, theirs)


def _same_tree(ours, theirs, rtol=1e-9):
    """The same files under both directories with the same text, and
    every number within ``rtol`` of the JAX project's (relative to the
    larger of 1 and its magnitude): the emitter writes the same bytes from
    the same state (tests/test_torch_codegen.py), but each package computes
    its own float64 cache and sensitivities, which differ in the last
    digits."""
    files = sorted(f.relative_to(theirs) for f in theirs.rglob("*")
                   if f.is_file())
    assert files == sorted(f.relative_to(ours) for f in ours.rglob("*")
                           if f.is_file())
    for f in files:
        a, b = (ours / f).read_text(), (theirs / f).read_text()
        assert NUMBER.sub("#", a) == NUMBER.sub("#", b), f
        x, y = (np.array(NUMBER.findall(t), dtype=float) for t in (a, b))
        np.testing.assert_array_less(
            np.abs(x - y), rtol * np.maximum(1.0, np.abs(y)) + 1e-300,
            err_msg=str(f))


def _same_project(tmp_path, name):
    """The codegen example writes the JAX example's project
    (``_same_tree``)."""
    _jax(f"{name}.py").main(out_dir=str(tmp_path / "jax"))
    _port(name).main(out_dir=str(tmp_path / "port"), device="cpu")
    assert (tmp_path / "port" / "src" / "tiny_data.cpp").exists()
    _same_tree(tmp_path / "port", tmp_path / "jax")


def test_cartpole_codegen(tmp_path):
    _same_project(tmp_path, "cartpole_codegen")


def test_quadrotor_hover_codegen(tmp_path):
    _same_project(tmp_path, "quadrotor_hover_codegen")


def test_misset_rho_recovery(capsys):
    _jax("misset_rho_recovery.py").main(B=8)
    theirs = capsys.readouterr().out
    _port("misset_rho_recovery").main(B=8, device="cpu")
    ours = capsys.readouterr().out
    assert "adaptive (rebuild)" in ours
    _same_output(ours, theirs)


def test_rocket_landing(capsys):
    _jax("rocket_landing.py").main()
    theirs = capsys.readouterr().out
    _port("rocket_landing").main(device="cpu")
    ours = capsys.readouterr().out
    assert "Final position" in ours
    _same_output(ours, theirs, skip=("Plant-level violations",))


SOLVED = re.compile(r"^solved (\d+)/(\d+) in ")


def test_batched_scenario_sweep(capsys):
    """The sweep's solved count and iteration line are the JAX example's
    (its mesh has conftest's 8 virtual devices, the port's a world of one;
    the timing is left out)."""
    _jax("batched_scenario_sweep.py").main(B=64)
    theirs = capsys.readouterr().out
    sol, _ = _port("batched_scenario_sweep").main(B=64, device="cpu")
    ours = capsys.readouterr().out
    assert tuple(sol.u.shape) == (64, 19, 4)
    solved = [[SOLVED.match(ln).groups() for ln in out.splitlines()
               if SOLVED.match(ln)] for out in (ours, theirs)]
    assert solved[0] == solved[1] and len(solved[0]) == 1
    _same_output(*("\n".join(ln for ln in out.splitlines()
                             if ln.startswith("iterations:"))
                   for out in (ours, theirs)))


def _close(ours, theirs, rtol, what):
    """Within ``rtol`` of the JAX array, relative to the larger of 1 and
    its magnitude (the swing-up's controls reach ~90)."""
    err = np.abs(ours - theirs) / np.maximum(1.0, np.abs(theirs))
    assert float(err.max()) <= rtol, (what, float(err.max()))


def test_cartpole_swingup_animation(tmp_path, monkeypatch, capsys):
    """The batched swing-up (a cost regime picked per lane, the angle wrap,
    the stability count) against the JAX example's ``lax.scan``, in quick
    mode (60 closed-loop steps; the modules read the globals at call
    time): ``main`` prints the same lines and writes the same
    stabilisation steps (none within 60 steps, as in JAX), and its
    float32 states and controls within 1e-4; the same loop in float64
    within 1e-9.  float32 rounding differs between the packages and the
    plant is unstable, so the float32 trajectories differ by up to ~3e-5;
    in float64 by ~1e-14."""
    monkeypatch.setattr(sys, "argv", ["cartpole_swingup_animation.py",
                                      "--no-gif"])
    jmod = _jax("cartpole_swingup_animation.py")
    mod = _port("cartpole_swingup_animation")
    for m in (jmod, mod):
        monkeypatch.setattr(m, "MAX_STEPS", 60)
        monkeypatch.setattr(m, "STABLE_STEPS", 10)
    runs = []
    for name, run in (("jax", jmod.main),
                      ("port", lambda: mod.main(device="cpu"))):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        run()
        runs.append((capsys.readouterr().out,
                     dict(np.load(tmp_path / name / "cartpole_swingup.npz"))))
    (jax_out, theirs), (port_out, ours) = runs
    assert ours["states"].shape == (mod.ATTEMPTS, 60, 4)
    _same_output(port_out, jax_out)
    np.testing.assert_array_equal(ours["stable_at"], theirs["stable_at"])
    assert int(ours["best"]) == int(theirs["best"])
    for k in ("states", "controls"):
        _close(ours[k], theirs[k], 1e-4, k)
    import jax.numpy as jnp
    got = mod.swingup_batch(torch.device("cpu"), torch.float64)
    want = jmod.swingup_batch(jnp.float64)
    for k, a, b in zip(("states", "controls"), got, want):
        _close(a, b, 1e-9, f"float64 {k}")
    np.testing.assert_array_equal(got[2], want[2])
