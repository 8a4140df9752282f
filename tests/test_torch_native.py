"""The port's ctypes binding of the native runtime (native.py): it builds
the tracked C++ source into build/torch_native/ and its ``codegen`` symbol
emits the port's emitter's files byte for byte (both take their templates
from the tracked native/codegen_templates.inc, so this holds the two data
sources, C++ and Python, to each other); one native solve against the
port's ``solve()``."""
import filecmp
import os
import shutil

import numpy as np
import pytest

from tinympc_julia_tpu_torch import native
from tinympc_julia_tpu_torch.models import cartpole

from torch_port_common import CPU

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no C++ compiler")
FILES = ("tinympc/tiny_data.hpp", "src/tiny_main.cpp", "CMakeLists.txt",
         "tinympc/tinympc_solver.hpp", "src/tiny_data.cpp")


@pytest.fixture(scope="module")
def solver():
    s = native.NativeSolver()
    yield s
    s.cleanup()


def _setup_native(ns, ps):
    """The native solver on the port solver's problem, bounds, settings and
    cache (so that both bake the same bits)."""
    ns.setup(cartpole.A, cartpole.B, None, np.diag(cartpole.Q_DIAG),
             np.diag(cartpole.R_DIAG), 1.0, 4, 1, 20, max_iter=50,
             en_state_bound=False, en_input_bound=False)
    p = ps.problem
    ns.set_bound_constraints(*(np.clip(t.cpu().numpy().T, -1e30, 1e30)
                               for t in (p.x_min, p.x_max, p.u_min,
                                         p.u_max)))
    ns.update_settings(max_iter=50,
                       en_state_bound=bool(ps.settings.en_state_bound),
                       en_input_bound=bool(ps.settings.en_input_bound))
    c = ps.cache
    ns.set_cache_terms(*(t.cpu().numpy() for t in (c.Kinf, c.Pinf,
                                                   c.Quu_inv, c.AmBKt)))
    ns.set_x0([0.5, 0.0, 0.0, 0.0])


def test_library_builds_outside_the_source_tree():
    path = native.build_library()
    assert path.parent == native.BUILD_DIR and path.exists()
    assert native.build_library() == path  # built once, then found
    assert not any(n.endswith(".so") and n != "libtinympc_native.so"
                   for n in os.listdir(native.NATIVE_DIR))


def test_codegen_symbol_matches_the_port_emitter(solver, tmp_path):
    ps = cartpole.make_solver(device=CPU, max_iter=50, constrained=True)
    ps.set_x0([0.5, 0.0, 0.0, 0.0])
    out_py = os.path.join(str(tmp_path), "py")
    ps.codegen(out_py)
    _setup_native(solver, ps)
    out_c = os.path.join(str(tmp_path), "c")
    assert solver.codegen(out_c) == 0
    for rel in FILES:
        assert filecmp.cmp(os.path.join(out_py, rel), os.path.join(out_c, rel),
                           shallow=False), rel


def test_native_solve_matches_the_port(solver):
    """One cartpole solve from the same cache: equal residual check, controls
    within 1e-9 of the port's solve()."""
    ps = cartpole.make_solver(device=CPU, max_iter=50, constrained=True)
    ps.set_x0([0.5, 0.0, 0.0, 0.0])
    _setup_native(solver, ps)
    status = solver.solve()
    ps_status = ps.solve()
    assert status == ps_status
    _, controls = solver.get_solution()
    np.testing.assert_allclose(controls, ps.get_solution().controls,
                               atol=1e-9, rtol=0)
