"""The port's C++ emitter (codegen/emitter.py, TinyMPCSolver.codegen and
codegen_with_sensitivity) against the JAX package's: the five files byte
for byte from the same state (carried across through a JAX checkpoint, so
both hold the same bits), and, where g++ exists, the compiled project
against the port's ``solve()``."""
import filecmp
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

import tinympc_julia_tpu_torch as P
from tinympc_julia_tpu.models import cartpole, rocket
from tinympc_julia_tpu_torch.models import cartpole as pcartpole

from torch_port_common import CPU

GXX = shutil.which("g++")
FILES = ("CMakeLists.txt", "src/tiny_data.cpp", "src/tiny_main.cpp",
         "tinympc/tiny_data.hpp", "tinympc/tinympc_solver.hpp")


def _carried(tmp_path, js):
    """The port's solver holding the JAX solver's state, bit for bit."""
    path = os.path.join(str(tmp_path), "carry.npz")
    js.save(path)
    return P.TinyMPCSolver.load(path, device=CPU)


def _assert_same_files(a, b):
    for rel in FILES:
        assert filecmp.cmp(os.path.join(a, rel), os.path.join(b, rel),
                           shallow=False), rel
    assert os.path.isdir(os.path.join(b, "build"))


def _adaptive_jax():
    js = cartpole.make_solver(max_iter=60, adaptive_rho=True,
                              adaptive_rho_min=0.5, adaptive_rho_max=5.0)
    js.set_bound_constraints(np.full((4, 20), -1e17), np.full((4, 20), 1e17),
                             np.full((1, 19), -1.0), np.full((1, 19), 1.0))
    js.update_settings(en_state_bound=False, adaptive_rho=True)
    js.set_x0([1.2, -0.3, 0.2, 0.1])
    return js


@pytest.mark.parametrize("plant", ["cartpole", "rocket"])
def test_emitted_files_equal_the_jax_emitter(tmp_path, plant):
    """A warm cartpole (after a solve) and the rocket with its cones, an
    affine f, references and one state halfspace."""
    if plant == "cartpole":
        js = cartpole.make_solver(max_iter=50, constrained=True)
        js.set_x0([0.5, 0.0, 0.0, 0.0])
        js.solve()
    else:
        js = rocket.make_solver(max_iter=80)
        js.set_linear_constraints(np.array([[1.0, 0, 0, 0, 0, 0]]),
                                  np.array([5.0]), np.zeros((0, 3)),
                                  np.zeros(0))
        js.set_x0(rocket.X_INIT)
        Xref, Uref = rocket.reference_trajectory(0)
        js.set_x_ref(Xref)
        js.set_u_ref(Uref)
    ps = _carried(tmp_path, js)
    jout, pout = (os.path.join(str(tmp_path), n, "a", "b") for n in "jp")
    js.codegen(jout)
    assert ps.codegen(pout) == 0
    _assert_same_files(jout, pout)


def test_emitted_files_with_sensitivity_equal_the_jax_emitter(tmp_path):
    """codegen_with_sensitivity with adaptive rho: the given matrices go
    into the cache and the project (TINY_HAS_SENSITIVITY 1), as in the JAX
    package; the port drops its Taylor maps, which bake them."""
    js = _adaptive_jax()
    ps = _carried(tmp_path, js)
    ps._taylor_maps()
    sens = js.compute_sensitivity_autograd()
    jout, pout = (os.path.join(str(tmp_path), n) for n in "jp")
    js.codegen_with_sensitivity(jout, *sens)
    assert ps.codegen_with_sensitivity(pout, *sens) == 0
    _assert_same_files(jout, pout)
    assert ps._condensed_taylor_maps is None
    assert torch.equal(ps.cache.dKinf_drho, torch.tensor(sens[0]))
    header = open(os.path.join(pout, "tinympc", "tiny_data.hpp")).read()
    assert "#define TINY_HAS_SENSITIVITY 1" in header


def test_sensitivity_is_ignored_without_adaptive_rho(tmp_path):
    ps = pcartpole.make_solver(device=CPU)
    before = ps.cache.dKinf_drho.clone()
    zeros = [np.zeros((1, 4)), np.zeros((4, 4)), np.zeros((1, 1)),
             np.zeros((4, 4))]
    ps.codegen_with_sensitivity(os.path.join(str(tmp_path), "o"), *zeros)
    assert torch.equal(ps.cache.dKinf_drho, before)
    data = open(os.path.join(str(tmp_path), "o", "src",
                             "tiny_data.cpp")).read()
    assert "g_dKinf" not in data


def _build_and_run(out):
    exe = os.path.join(out, "build", "tiny_mpc_example")
    subprocess.run(
        [GXX, "-O2", "-std=c++17", "-I", os.path.join(out, "tinympc"),
         os.path.join(out, "src", "tiny_data.cpp"),
         os.path.join(out, "src", "tiny_main.cpp"), "-o", exe],
        check=True, capture_output=True)
    lines = subprocess.run([exe], check=True, capture_output=True,
                           text=True).stdout.strip().splitlines()
    head = lines[0].split()
    u = np.array([[float(v) for v in ln.split()] for ln in lines[1:]])
    return int(head[3]), int(head[5]), u


@pytest.mark.skipif(GXX is None, reason="no C++ compiler")
@pytest.mark.parametrize("adaptive", [False, True],
                         ids=["cartpole", "adaptive"])
def test_compiled_project_matches_the_port(tmp_path, adaptive):
    """The emitted project, compiled and run, against the port's solve()
    from the same baked state: equal count and flag, controls within
    1e-9."""
    if adaptive:
        ps = _carried(tmp_path, _adaptive_jax())
    else:
        ps = pcartpole.make_solver(device=CPU, max_iter=50)
        ps.set_x0([0.5, 0.0, 0.0, 0.0])
    out = os.path.join(str(tmp_path), "out")
    ps.codegen(out)
    it, solved, u = _build_and_run(out)
    ps.solve()
    assert it == int(ps.solution.iter)
    assert solved == int(ps.solution.solved)
    np.testing.assert_allclose(u, ps.get_solution().controls.T, atol=1e-9,
                               rtol=0)
