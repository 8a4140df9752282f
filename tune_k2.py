#!/usr/bin/env python3
"""Sweep kernel K2's row block at the quadrotor shape on one NVIDIA GPU.

    python3 tune_k2.py [--rows 8 16 32]

Builds ``csrc/condensed_adaptive.cu`` once per row block (``-DTINYMPC_K2_ROWS``,
the builds side by side, into ``build/tune_k2/``), and times with CUDA events
(median of 3 after a warm-up) the two launches of the adaptive pipeline's
shape: the bulk pass (16,384 quadrotor lanes, 150 iterations, termination
controller floored at rho0 with trust 2, carry out) and the warm
continuation of its stragglers (2,048 slots, up to 2,500 iterations), beside
the plain version's bulk pass.  Every build's results must equal the first
build's bit for bit (an accumulator sums in index order whatever the block).
Prints one line per build and the same numbers as one JSON object.
"""
import argparse
import ctypes
import json
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch


def median_ms(fn, reps=3):
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return float(np.median(ts))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, nargs="+", default=[8, 16, 32])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tune_k2: torch.cuda.is_available() is false; this "
                         "script needs an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card {card}", flush=True)

    from tinympc_julia_tpu_torch.models import quadrotor
    from tinympc_julia_tpu_torch.ops.condensed import build_condensed_taylor
    from tinympc_julia_tpu_torch.ops.cuda import _build
    from tinympc_julia_tpu_torch.ops.cuda import adaptive_kernel as K2
    from tinympc_julia_tpu_torch.parallel.rebuild import compact_members

    out_dir = _build.BUILD_DIR.parent / "tune_k2"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = _build.CSRC_DIR / "condensed_adaptive.cu"

    def build(rows):
        so = out_dir / f"condensed_adaptive_rows{rows}.so"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, f"-DTINYMPC_K2_ROWS={rows}",
             "-o", str(so), str(src)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"tune_k2: nvcc failed for {rows} rows:\n"
                             f"{proc.stdout}{proc.stderr}")
        regs = sorted({int(l.split("Used ")[1].split()[0])
                       for l in (proc.stdout + proc.stderr).splitlines()
                       if "Used " in l})
        return so, time.perf_counter() - t0, regs

    with ThreadPoolExecutor(max_workers=len(args.rows)) as pool:
        builds = list(pool.map(build, args.rows))

    dev = torch.device("cuda")
    solver = quadrotor.make_solver(dtype=torch.float32, device="cuda")
    p = solver.problem
    tmaps = build_condensed_taylor(p, solver.cache)
    x0 = torch.as_tensor(np.random.default_rng(1).uniform(
        -0.3, 0.3, size=(16384, 12)), dtype=torch.float32, device=dev)
    bounds = (p.u_min, p.u_max, p.x_min, p.x_max)
    kw = dict(plant=None, nx=12, nu=4, N=p.N, abs_pri_tol=1e-3,
              abs_dua_tol=1e-3, en_state_bound=False, en_input_bound=True,
              relaxation_alpha=1.0, adaptive_rho_clipping=True,
              check_termination=1, controller="termination",
              adaptive_rho_min=quadrotor.RHO, adaptive_rho_max=1e3,
              taylor_trust=2.0)
    bulk_kw = dict(max_iter=150, warm_start=False, carry_out=True, **kw)
    plain_ms = median_ms(lambda: K2.condensed_adaptive_reference(
        tmaps, *bounds, x0, None, **bulk_kw))
    print(f"plain version, bulk pass: {plain_ms:.3f} ms", flush=True)

    results, first = [], None
    for rows, (so, secs, regs) in zip(args.rows, builds):
        fn = ctypes.CDLL(str(so)).tinympc_condensed_adaptive
        fn.argtypes = K2._ARGTYPES
        fn.restype = ctypes.c_int
        K2._kernel_fn = lambda fn=fn: fn  # the wrapper launches this build
        K2.K2_ROW_BLOCK = rows

        def bulk():
            return K2.condensed_adaptive_cuda(tmaps, *bounds, x0, None,
                                              **bulk_kw)

        res = bulk()
        idx = compact_members((res[3] == 0)[None, :], 2048)[0][0]
        warm = K2.AdaptiveFusedCarry(*(w[:, idx].contiguous()
                                       for w in res[5]))
        x0s = x0[idx].contiguous()

        def continuation():
            return K2.condensed_adaptive_cuda(
                tmaps, *bounds, x0s, warm, max_iter=2500, warm_start=True,
                carry_out=False, **kw)

        res2 = continuation()
        torch.cuda.synchronize()
        first = first or (res, res2)
        same = (all(torch.equal(a, b) for a, b in zip(res[:5], first[0][:5]))
                and all(torch.equal(a, b) for a, b in zip(res2, first[1])))
        if not same:
            raise SystemExit(f"tune_k2: the {rows}-row build's results "
                             "differ from the first build's")
        r = dict(rows=rows, nvcc_s=secs, registers=regs,
                 bulk_ms=median_ms(bulk),
                 continuation_ms=median_ms(continuation))
        print(f"{rows:2d} rows: nvcc {secs:.0f} s, registers {regs}; bulk "
              f"pass {r['bulk_ms']:.3f} ms, continuation "
              f"{r['continuation_ms']:.3f} ms; equal to the first build "
              f"bit for bit", flush=True)
        results.append(r)
    print(json.dumps(dict(card=card, plain_bulk_ms=plain_ms,
                          builds=results)))


if __name__ == "__main__":
    main()
