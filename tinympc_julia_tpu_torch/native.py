"""ctypes binding to the native runtime (native/tinympc_native.cpp), the
counterpart of tinympc_julia_tpu/native.py.

``build_library`` compiles the tracked C++ source with ``g++`` into
``build/torch_native/`` at the root of the checkout (git-ignored), named by a
digest of the source, its included templates and the flags; several
processes may build at once, each into its own temporary file that replaces
the target.  It never writes into ``native/`` and never regenerates
``native/codegen_templates.inc``: the tracked file is used as it is (the
JAX package's generator imports its emitter; the port's tests hold the
library's ``codegen`` against the port's emitter byte for byte).

``NativeSolver`` wraps the C ABI (one process-global solver, as in the
reference bindings); ``load_library()`` gives the raw ctypes handle.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parents[1] / "native"
BUILD_DIR = NATIVE_DIR.parent / "build" / "torch_native"
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-shared"]

_D = ctypes.POINTER(ctypes.c_double)
_I = ctypes.POINTER(ctypes.c_int)


def build_library() -> Path:
    """Compile the native library if no build of the current sources exists;
    returns its path.  Raises where there is no ``g++``."""
    src = NATIVE_DIR / "tinympc_native.cpp"
    inc = NATIVE_DIR / "codegen_templates.inc"
    digest = hashlib.sha1(src.read_bytes() + inc.read_bytes()
                          + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libtinympc_native-{digest}.so"
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native library is built with "
                           "the system C++ compiler")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True, cwd=NATIVE_DIR)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {src.name}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.cache
def load_library(path: Optional[str] = None) -> ctypes.CDLL:
    """The native library (built by ``build_library`` unless ``path`` names
    one), its functions' argument and result types declared."""
    lib = ctypes.CDLL(path or str(build_library()))

    lib.setup_solver.restype = ctypes.c_int
    lib.setup_solver.argtypes = [
        _D, ctypes.c_int, ctypes.c_int, _D, ctypes.c_int, ctypes.c_int,
        _D, ctypes.c_int, ctypes.c_int, _D, ctypes.c_int, ctypes.c_int,
        _D, ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int]
    for name in ("set_x0", "set_x_ref", "set_u_ref"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [_D, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.solve_mpc.restype = ctypes.c_int
    lib.solve_mpc.argtypes = [ctypes.c_int]
    for name in ("get_states", "get_controls"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [_D, _I, _I]
    lib.cleanup_solver.restype = None
    lib.cleanup_solver.argtypes = []
    lib.update_settings.restype = ctypes.c_int
    lib.update_settings.argtypes = [
        ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ctypes.c_int, ctypes.c_int]
    lib.set_bound_constraints.restype = ctypes.c_int
    lib.set_bound_constraints.argtypes = [
        _D, ctypes.c_int, ctypes.c_int] * 4 + [ctypes.c_int]
    lib.set_linear_constraints.restype = ctypes.c_int
    lib.set_linear_constraints.argtypes = [
        _D, ctypes.c_int, ctypes.c_int, _D, ctypes.c_int,
        _D, ctypes.c_int, ctypes.c_int, _D, ctypes.c_int, ctypes.c_int]
    lib.set_cone_constraints.restype = ctypes.c_int
    lib.set_cone_constraints.argtypes = [
        _I, ctypes.c_int, _I, ctypes.c_int, _D, ctypes.c_int,
        _I, ctypes.c_int, _I, ctypes.c_int, _D, ctypes.c_int, ctypes.c_int]
    lib.set_cache_terms.restype = ctypes.c_int
    lib.set_cache_terms.argtypes = [
        _D, ctypes.c_int, ctypes.c_int] * 4 + [ctypes.c_int]
    lib.set_sensitivity_terms.restype = ctypes.c_int
    lib.set_sensitivity_terms.argtypes = [
        _D, ctypes.c_int, ctypes.c_int] * 4 + [ctypes.c_int]
    lib.codegen.restype = ctypes.c_int
    lib.codegen.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.codegen_with_sensitivity.restype = ctypes.c_int
    lib.codegen_with_sensitivity.argtypes = [
        ctypes.c_char_p] + [_D, ctypes.c_int, ctypes.c_int] * 4 + [
        ctypes.c_int]
    lib.print_problem_data.restype = ctypes.c_int
    lib.print_problem_data.argtypes = [ctypes.c_int]
    lib.get_residuals.restype = ctypes.c_int
    lib.get_residuals.argtypes = [_D, _D, _D, _D]

    return lib


def _colmajor(a) -> np.ndarray:
    return np.asfortranarray(np.asarray(a, dtype=np.float64))


def _dp(a):
    return a.ctypes.data_as(_D)


class NativeSolver:
    """Python wrapper over the native C ABI (process-global instance, like
    the reference's singleton)."""

    def __init__(self, lib_path: Optional[str] = None):
        self.lib = load_library(lib_path)
        self.nx = self.nu = self.N = 0

    def setup(self, A, B, f, Q, R, rho, nx, nu, N, *, verbose=False, **kw):
        A = _colmajor(A)
        Bm = _colmajor(B)
        fv = _colmajor(np.reshape(np.zeros(nx) if f is None else f, (nx, 1)))
        Q = _colmajor(Q)
        R = _colmajor(R)
        st = self.lib.setup_solver(
            _dp(A), nx, nx, _dp(Bm), nx, nu, _dp(fv), nx, 1,
            _dp(Q), nx, nx, _dp(R), nu, nu, float(rho), nx, nu, N,
            int(verbose))
        if st != 0:
            raise RuntimeError(f"setup_solver failed: {st}")
        self.nx, self.nu, self.N = nx, nu, N
        if kw:
            self.update_settings(**kw)
        return st

    def update_settings(self, abs_pri_tol=1e-3, abs_dua_tol=1e-3,
                        max_iter=100, check_termination=1,
                        en_state_bound=False, en_input_bound=False,
                        en_state_soc=False, en_input_soc=False,
                        en_state_linear=False, en_input_linear=False,
                        adaptive_rho=False, adaptive_rho_min=0.1,
                        adaptive_rho_max=10.0,
                        adaptive_rho_enable_clipping=True, verbose=False):
        return self.lib.update_settings(
            float(abs_pri_tol), float(abs_dua_tol), int(max_iter),
            int(check_termination), int(en_state_bound), int(en_input_bound),
            int(en_state_soc), int(en_input_soc), int(en_state_linear),
            int(en_input_linear), int(adaptive_rho), float(adaptive_rho_min),
            float(adaptive_rho_max), int(adaptive_rho_enable_clipping),
            int(verbose))

    def set_x0(self, x0):
        x0 = _colmajor(np.reshape(x0, (self.nx, 1)))
        return self.lib.set_x0(_dp(x0), self.nx, 1, 0)

    def set_x_ref(self, x_ref):
        x_ref = _colmajor(x_ref)
        return self.lib.set_x_ref(_dp(x_ref), self.nx, self.N, 0)

    def set_u_ref(self, u_ref):
        u_ref = _colmajor(u_ref)
        return self.lib.set_u_ref(_dp(u_ref), self.nu, self.N - 1, 0)

    def set_bound_constraints(self, x_min, x_max, u_min, u_max):
        ms = [_colmajor(m) for m in (x_min, x_max, u_min, u_max)]
        return self.lib.set_bound_constraints(
            _dp(ms[0]), self.nx, self.N, _dp(ms[1]), self.nx, self.N,
            _dp(ms[2]), self.nu, self.N - 1, _dp(ms[3]), self.nu, self.N - 1,
            0)

    def set_cone_constraints(self, Acu, qcu, cu, Acx, qcx, cx):
        ai = lambda a: np.ascontiguousarray(a, dtype=np.int32)
        ad = lambda a: np.ascontiguousarray(a, dtype=np.float64)
        Acu, qcu, Acx, qcx = ai(Acu), ai(qcu), ai(Acx), ai(qcx)
        cu, cx = ad(cu), ad(cx)
        ip = lambda a: a.ctypes.data_as(_I)
        return self.lib.set_cone_constraints(
            ip(Acu), len(Acu), ip(qcu), len(qcu), _dp(cu), len(cu),
            ip(Acx), len(Acx), ip(qcx), len(qcx), _dp(cx), len(cx), 0)

    def set_linear_constraints(self, Alin_x, blin_x, Alin_u, blin_u):
        Ax = _colmajor(np.reshape(Alin_x, (-1, self.nx)))
        Au = _colmajor(np.reshape(Alin_u, (-1, self.nu)))
        bx = np.ascontiguousarray(blin_x, dtype=np.float64)
        bu = np.ascontiguousarray(blin_u, dtype=np.float64)
        return self.lib.set_linear_constraints(
            _dp(Ax), Ax.shape[0], self.nx, _dp(bx), len(bx),
            _dp(Au), Au.shape[0], self.nu, _dp(bu), len(bu), 0)

    def set_cache_terms(self, Kinf, Pinf, Quu_inv, AmBKt):
        ms = [_colmajor(m) for m in (Kinf, Pinf, Quu_inv, AmBKt)]
        return self.lib.set_cache_terms(
            _dp(ms[0]), self.nu, self.nx, _dp(ms[1]), self.nx, self.nx,
            _dp(ms[2]), self.nu, self.nu, _dp(ms[3]), self.nx, self.nx, 0)

    def set_sensitivity_terms(self, dK, dP, dC1, dC2):
        ms = [_colmajor(m) for m in (dK, dP, dC1, dC2)]
        return self.lib.set_sensitivity_terms(
            _dp(ms[0]), self.nu, self.nx, _dp(ms[1]), self.nx, self.nx,
            _dp(ms[2]), self.nu, self.nu, _dp(ms[3]), self.nx, self.nx, 0)

    def codegen(self, output_dir, *, verbose=False):
        return self.lib.codegen(os.fsencode(output_dir), int(verbose))

    def codegen_with_sensitivity(self, output_dir, dK, dP, dC1, dC2, *,
                                 verbose=False):
        ms = [_colmajor(m) for m in (dK, dP, dC1, dC2)]
        return self.lib.codegen_with_sensitivity(
            os.fsencode(output_dir),
            _dp(ms[0]), self.nu, self.nx, _dp(ms[1]), self.nx, self.nx,
            _dp(ms[2]), self.nu, self.nu, _dp(ms[3]), self.nx, self.nx,
            int(verbose))

    def solve(self, *, verbose=False):
        return self.lib.solve_mpc(int(verbose))

    def get_solution(self):
        states = np.zeros((self.nx, self.N), order="F")
        controls = np.zeros((self.nu, self.N - 1), order="F")
        r = ctypes.c_int()
        c = ctypes.c_int()
        self.lib.get_states(_dp(states), ctypes.byref(r), ctypes.byref(c))
        self.lib.get_controls(_dp(controls), ctypes.byref(r), ctypes.byref(c))
        return states, controls

    def get_residuals(self):
        vals = [ctypes.c_double() for _ in range(4)]
        self.lib.get_residuals(*[ctypes.byref(v) for v in vals])
        return tuple(v.value for v in vals)

    def cleanup(self):
        self.lib.cleanup_solver()
