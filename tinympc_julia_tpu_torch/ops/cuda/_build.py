"""Build the port's CUDA sources with nvcc at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles to ``build/torch_kernels/<name>-<digest>.so``
at the root of the checkout (``build/`` is git-ignored), for ``sm_90a``, with a
plain C interface: no PyTorch headers, so a build takes seconds.  The digest
of the source and of the headers beside it (``csrc/*.cuh``) names the
library, so an edited source is rebuilt and an unchanged one is loaded as it
is.  ``load_libraries`` builds several sources at once, one nvcc each.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import NamedTuple

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


class BuiltLibrary(NamedTuple):
    lib: ctypes.CDLL
    path: Path
    seconds: float  # wall time of the nvcc run; 0.0 when loaded as built
    log: str        # nvcc's output (ptxas register and shared-memory usage)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "tinympc_julia_tpu_torch are built on a machine with "
                       "the CUDA toolkit")


@functools.cache
def load_library(name: str) -> BuiltLibrary:
    """Build (if needed) and load ``csrc/<name>.cu``; raises on failure."""
    src = CSRC_DIR / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha1(src.read_bytes() + headers
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{name}-{digest}.so"
    seconds, log = 0.0, ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{log}")
        os.replace(tmp, out)
    return BuiltLibrary(ctypes.CDLL(str(out)), out, seconds, log)


def load_libraries(names) -> list[BuiltLibrary]:
    """``load_library`` of every name, the builds running side by side (the
    threads only wait for their nvcc)."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return list(pool.map(load_library, names))


class KernelUsage(NamedTuple):
    registers: int
    stack_bytes: int
    spill_stores: int
    spill_loads: int


def ptxas_usage(log: str) -> dict:
    """Each kernel's registers, stack frame and spill bytes, by mangled name,
    from ``-Xptxas -v`` output (``BuiltLibrary.log``; empty when the library
    was loaded as built)."""
    out, name, frame = {}, None, (0, 0, 0)
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?([\w$]+)'?", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            frame = tuple(int(x) for x in m.groups())
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            out[name] = KernelUsage(int(m.group(1)), *frame)
            frame = (0, 0, 0)
    return out
