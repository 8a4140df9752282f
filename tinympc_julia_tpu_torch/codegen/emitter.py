"""Standalone C++ project emitter (counterpart of
tinympc_julia_tpu/codegen/emitter.py, whose output it reproduces byte for
byte).

The emitted project is a single dependency-free header-only solver plus
the solver's state baked as C arrays at full precision.  Every tensor is
read through ``.detach().cpu().numpy()``, so a solver resident on the card
emits the same files as one on the CPU.

The four templates (the data header, the example main, the CMake file and
the solver header) are read from the tracked native/codegen_templates.inc,
the text the native library (native.py) compiles in and emits from its own
state: one copy of the templates for both emitters.

Emitted layout:
    out/
      CMakeLists.txt
      src/tiny_data.cpp     -- all solver state as static arrays + init
      src/tiny_main.cpp     -- example main calling tiny_solve
      tinympc/tiny_data.hpp -- dims/macros + struct decls + extern solver
      tinympc/tinympc_solver.hpp
"""
from __future__ import annotations

import functools
import os
import re
from pathlib import Path

import numpy as np

TEMPLATES_INC = (Path(__file__).resolve().parents[2] / "native"
                 / "codegen_templates.inc")


@functools.cache
def templates() -> dict:
    """The templates by their C names (``kHeaderTemplate``,
    ``kMainTemplate``, ``kCMakeTemplate``, ``kSolverTemplate``): the raw
    string literals of ``TEMPLATES_INC``."""
    text = TEMPLATES_INC.read_text(encoding="utf-8")
    return dict(re.findall(
        r'static const char (\w+)\[\] = R"TINYTPL\((.*?)\)TINYTPL";', text,
        re.S))


def _np(t) -> np.ndarray:
    """A tensor's values as a numpy array on the host."""
    return t.detach().cpu().numpy()


def _fmt(v) -> str:
    return f"{float(v):.17g}"


def _array_literal(name, arr, indent="    "):
    """Emit `static const tiny_float name[..][..] = {...};` at %.17g."""
    arr = np.asarray(arr, dtype=float)
    dims = "".join(f"[{d}]" for d in arr.shape)
    lines = [f"static const tiny_float {name}{dims} = "]

    def emit(a):
        if a.ndim == 1:
            return "{" + ", ".join(_fmt(v) for v in a) + "}"
        return "{\n" + ",\n".join(indent + emit(row) for row in a) + "}"

    lines[-1] += emit(arr) + ";"
    return "\n".join(lines)


def _int_array_literal(name, arr):
    arr = np.asarray(arr, dtype=int)
    return (f"static const int {name}[{arr.shape[0]}] = "
            + "{" + ", ".join(str(int(v)) for v in arr) + "};")


def _copy2d(dst, src, rows, cols, lines):
    lines.append(f"  for (int i = 0; i < {rows}; ++i)")
    lines.append(f"    for (int j = 0; j < {cols}; ++j)")
    lines.append(f"      {dst}[i][j] = {src}[i][j];")


def _copy1d(dst, src, n, lines):
    lines.append(f"  for (int j = 0; j < {n}; ++j) {dst}[j] = {src}[j];")


def generate_header(nx, nu, N, n_lin_x, n_lin_u, n_cone_x, n_cone_u,
                    has_sensitivity) -> str:
    return (templates()["kHeaderTemplate"]
            .replace("@NX@", str(nx)).replace("@NU@", str(nu))
            .replace("@NH@", str(N))
            .replace("@NLINX@", str(n_lin_x)).replace("@NLINU@", str(n_lin_u))
            .replace("@NCONEX@", str(n_cone_x))
            .replace("@NCONEU@", str(n_cone_u))
            .replace("@HASSENS@", "1" if has_sensitivity else "0"))


def generate_data_source(solver) -> str:
    """Bake the current solver state (cache + settings + workspace iterates,
    like codegen_data_source, codegen.cpp:158-370) into src/tiny_data.cpp."""
    p = solver.problem
    c = solver.cache
    st = solver.state
    s = solver.settings
    has_sens = bool(s.adaptive_rho)

    parts = ['#include "tiny_data.hpp"\n']
    A = _np(p.A)
    emit = parts.append
    emit(_array_literal("g_Adyn", A))
    emit(_array_literal("g_Bdyn", _np(p.B)))
    emit(_array_literal("g_fdyn", _np(p.f)))
    emit(_array_literal("g_Q", _np(p.Q)))
    emit(_array_literal("g_R", _np(p.R)))
    emit(_array_literal("g_Kinf", _np(c.Kinf)))
    emit(_array_literal("g_Pinf", _np(c.Pinf)))
    emit(_array_literal("g_Quu_inv", _np(c.Quu_inv)))
    emit(_array_literal("g_AmBKt", _np(c.AmBKt)))
    if has_sens:
        emit(_array_literal("g_dKinf", _np(c.dKinf_drho)))
        emit(_array_literal("g_dPinf", _np(c.dPinf_drho)))
        emit(_array_literal("g_dC1", _np(c.dC1_drho)))
        emit(_array_literal("g_dC2", _np(c.dC2_drho)))
    big = 1e30
    clip = lambda a: np.clip(_np(a).astype(float), -big, big)
    emit(_array_literal("g_x_min", clip(p.x_min)))
    emit(_array_literal("g_x_max", clip(p.x_max)))
    emit(_array_literal("g_u_min", clip(p.u_min)))
    emit(_array_literal("g_u_max", clip(p.u_max)))
    emit(_array_literal("g_Xref", _np(p.Xref)))
    emit(_array_literal("g_Uref", _np(p.Uref)))
    # Warm-start iterates — the reference bakes the live workspace
    # (codegen.cpp:212-258), preserving warm starts across codegen.
    for name in ("x", "u", "q", "r", "p", "d", "v", "vnew", "z", "znew",
                 "g", "y"):
        emit(_array_literal(f"g_ws_{name}", _np(getattr(st, name))))
    n_lin_x = int(p.Alin_x.shape[0])
    n_lin_u = int(p.Alin_u.shape[0])
    if n_lin_x:
        emit(_array_literal("g_Alin_x", _np(p.Alin_x)))
        emit(_array_literal("g_blin_x", _np(p.blin_x)))
    if n_lin_u:
        emit(_array_literal("g_Alin_u", _np(p.Alin_u)))
        emit(_array_literal("g_blin_u", _np(p.blin_u)))
    if p.cones_x.num_cones:
        emit(_int_array_literal("g_cone_x_start", p.cones_x.starts))
        emit(_int_array_literal("g_cone_x_dim", p.cones_x.dims))
        emit(_array_literal("g_cone_x_mu", _np(p.cones_x.mus)))
    if p.cones_u.num_cones:
        emit(_int_array_literal("g_cone_u_start", p.cones_u.starts))
        emit(_int_array_literal("g_cone_u_dim", p.cones_u.dims))
        emit(_array_literal("g_cone_u_mu", _np(p.cones_u.mus)))

    lines = ["", "TinySolver tiny_solver;", "",
             "static int init_solver() {",
             f"  tiny_solver.cache.rho = {_fmt(_np(c.rho))};"]
    nx, nu, N = p.nx, p.nu, p.N
    _copy2d("tiny_solver.cache.Kinf", "g_Kinf", nu, nx, lines)
    _copy2d("tiny_solver.cache.Pinf", "g_Pinf", nx, nx, lines)
    _copy2d("tiny_solver.cache.Quu_inv", "g_Quu_inv", nu, nu, lines)
    _copy2d("tiny_solver.cache.AmBKt", "g_AmBKt", nx, nx, lines)
    if has_sens:
        _copy2d("tiny_solver.cache.dKinf_drho", "g_dKinf", nu, nx, lines)
        _copy2d("tiny_solver.cache.dPinf_drho", "g_dPinf", nx, nx, lines)
        _copy2d("tiny_solver.cache.dC1_drho", "g_dC1", nu, nu, lines)
        _copy2d("tiny_solver.cache.dC2_drho", "g_dC2", nx, nx, lines)
    w = "tiny_solver.work"
    _copy1d(f"{w}.Q", "g_Q", nx, lines)
    _copy1d(f"{w}.R", "g_R", nu, lines)
    _copy2d(f"{w}.Adyn", "g_Adyn", nx, nx, lines)
    _copy2d(f"{w}.Bdyn", "g_Bdyn", nx, nu, lines)
    _copy1d(f"{w}.fdyn", "g_fdyn", nx, lines)
    for nm, rows, cols in (("x_min", N, nx), ("x_max", N, nx),
                           ("u_min", N - 1, nu), ("u_max", N - 1, nu),
                           ("Xref", N, nx), ("Uref", N - 1, nu)):
        _copy2d(f"{w}.{nm}", f"g_{nm}", rows, cols, lines)
    for nm in ("x", "q", "p", "v", "vnew", "g"):
        _copy2d(f"{w}.{nm}", f"g_ws_{nm}", N, nx, lines)
    for nm in ("u", "r", "d", "z", "znew", "y"):
        _copy2d(f"{w}.{nm}", f"g_ws_{nm}", N - 1, nu, lines)
    if n_lin_x:
        _copy2d(f"{w}.Alin_x", "g_Alin_x", n_lin_x, nx, lines)
        _copy1d(f"{w}.blin_x", "g_blin_x", n_lin_x, lines)
    if n_lin_u:
        _copy2d(f"{w}.Alin_u", "g_Alin_u", n_lin_u, nu, lines)
        _copy1d(f"{w}.blin_u", "g_blin_u", n_lin_u, lines)
    if p.cones_x.num_cones:
        k = p.cones_x.num_cones
        _copy1d(f"{w}.cone_x_start", "g_cone_x_start", k, lines)
        _copy1d(f"{w}.cone_x_dim", "g_cone_x_dim", k, lines)
        _copy1d(f"{w}.cone_x_mu", "g_cone_x_mu", k, lines)
    if p.cones_u.num_cones:
        k = p.cones_u.num_cones
        _copy1d(f"{w}.cone_u_start", "g_cone_u_start", k, lines)
        _copy1d(f"{w}.cone_u_dim", "g_cone_u_dim", k, lines)
        _copy1d(f"{w}.cone_u_mu", "g_cone_u_mu", k, lines)

    se = "tiny_solver.settings"
    lines += [
        f"  {se}.abs_pri_tol = {_fmt(s.abs_pri_tol)};",
        f"  {se}.abs_dua_tol = {_fmt(s.abs_dua_tol)};",
        f"  {se}.max_iter = {int(s.max_iter)};",
        f"  {se}.check_termination = {int(s.check_termination)};",
        f"  {se}.en_state_bound = {int(s.en_state_bound)};",
        f"  {se}.en_input_bound = {int(s.en_input_bound)};",
        f"  {se}.en_state_soc = {int(s.en_state_soc)};",
        f"  {se}.en_input_soc = {int(s.en_input_soc)};",
        f"  {se}.en_state_linear = {int(s.en_state_linear)};",
        f"  {se}.en_input_linear = {int(s.en_input_linear)};",
        f"  {se}.adaptive_rho = {int(s.adaptive_rho)};",
        f"  {se}.adaptive_rho_min = {_fmt(s.adaptive_rho_min)};",
        f"  {se}.adaptive_rho_max = {_fmt(s.adaptive_rho_max)};",
        f"  {se}.adaptive_rho_enable_clipping = "
        f"{int(s.adaptive_rho_enable_clipping)};",
        "  return 0;",
        "}",
        "",
        "static const int g_initialized = init_solver();",
    ]
    parts.append("\n".join(lines))
    return "\n\n".join(parts) + "\n"


def codegen(solver, output_dir: str, *, verbose: bool = False) -> None:
    """Emit the standalone project from a TinyMPCSolver instance."""
    p = solver.problem
    os.makedirs(output_dir, exist_ok=True)
    os.makedirs(os.path.join(output_dir, "src"), exist_ok=True)
    os.makedirs(os.path.join(output_dir, "tinympc"), exist_ok=True)
    os.makedirs(os.path.join(output_dir, "build"), exist_ok=True)

    header = generate_header(
        p.nx, p.nu, p.N,
        int(p.Alin_x.shape[0]), int(p.Alin_u.shape[0]),
        p.cones_x.num_cones, p.cones_u.num_cones,
        bool(solver.settings.adaptive_rho))
    files = {
        os.path.join("tinympc", "tiny_data.hpp"): header,
        os.path.join("src", "tiny_data.cpp"): generate_data_source(solver),
        os.path.join("src", "tiny_main.cpp"): templates()["kMainTemplate"],
        "CMakeLists.txt": templates()["kCMakeTemplate"],
        os.path.join("tinympc", "tinympc_solver.hpp"):
            templates()["kSolverTemplate"],
    }
    for rel, text in files.items():
        with open(os.path.join(output_dir, rel), "w", encoding="utf-8") as f:
            f.write(text)
    if verbose:
        print(f"Code generation completed successfully in: {output_dir}")
