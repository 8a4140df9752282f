#!/usr/bin/env python3
"""Where the headline pipeline's time goes on one NVIDIA GPU.

    python3 profile_pipeline.py [--reps 3]

Runs the port's three-phase pipeline (65,536 cartpole lanes, 8,192
straggler slots, all fp32) under ``torch.profiler`` after one warm-up, and
prints, one line each:
  * the card's name and power limit;
  * setup on the host clock: CUDA initialisation, the Riccati cache with its
    sensitivities, and the condensed maps;
  * the phases' iteration statistics (phase-1 mean count, stragglers,
    phase-2 mean and max over valid slots);
  * per phase, the median device time of its K1 launch;
  * over the profiled reps: K1's device time, that of every other device
    kernel (compaction, gathers, merges), the wall time, and the device's
    idle share (1 - union of device-kernel intervals / wall).
The last line is the same numbers as one JSON object.
"""
import argparse
import json
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType

B_MAIN = 65536
SLOTS = 8192
KERNEL = "condensed_fused_kernel"


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_pipeline: torch.cuda.is_available() is "
                         "false; this script needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card {card}", flush=True)

    from tinympc_julia_tpu_torch import make_problem
    from tinympc_julia_tpu_torch.models import cartpole
    from tinympc_julia_tpu_torch.ops.condensed import build_condensed
    from tinympc_julia_tpu_torch.ops.riccati import precompute_cache
    from tinympc_julia_tpu_torch.parallel.pipeline import three_phase_solve

    dev = torch.device("cuda")
    N = cartpole.HORIZON
    t0 = time.perf_counter()
    torch.zeros(1, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    p = make_problem(cartpole.A, cartpole.B, np.diag(cartpole.Q_DIAG),
                     np.diag(cartpole.R_DIAG), cartpole.RHO, N, u_min=-5.0,
                     u_max=5.0, dtype=torch.float32, device=dev)
    c = precompute_cache(p.A, p.B, p.Q, p.R, p.rho_setup)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    maps = build_condensed(p, c)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    print(f"setup (host clock): CUDA init {t1 - t0:.3f} s, make_problem + "
          f"precompute_cache {t2 - t1:.3f} s, build_condensed "
          f"{t3 - t2:.3f} s", flush=True)

    x0 = torch.as_tensor(np.random.default_rng(0).uniform(
        -0.5, 0.5, size=(B_MAIN, 4)), dtype=torch.float32, device=dev)
    pipe = (maps, float(c.rho), p.u_min, p.u_max, p.x_min, p.x_max, x0)

    def run():
        return three_phase_solve(*pipe, nx=4, nu=1, N=N,
                                 straggler_slots=SLOTS)

    res = run()  # warm-up: builds and loads the kernel
    torch.cuda.synchronize()
    valid = res.valid
    it2 = res.iters2[valid].float()
    stats = dict(phase1_mean_iters=res.iters1.float().mean().item(),
                 stragglers=int(res.unconv.sum()),
                 phase2_mean_iters=it2.mean().item() if it2.numel() else 0.0,
                 phase2_max_iters=int(it2.max()) if it2.numel() else 0,
                 converged=int(res.converged()))
    print(f"iterations: {stats}", flush=True)

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        for _ in range(args.reps):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - w0) * 1e3
    dev_events = sorted((e for e in prof.events()
                         if e.device_type == DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
    if not dev_events:
        raise SystemExit("profile_pipeline: the profiler recorded no device "
                         "kernels")
    k1 = [e for e in dev_events if KERNEL in e.name]
    if len(k1) != 3 * args.reps:
        raise SystemExit(f"profile_pipeline: {len(k1)} K1 launches traced, "
                         f"expected {3 * args.reps}")
    phase_ms = [float(np.median([k1[3 * r + ph].time_range.elapsed_us()
                                 for r in range(args.reps)])) / 1e3
                for ph in range(3)]
    k1_ms = sum(e.time_range.elapsed_us() for e in k1) / 1e3
    other_ms = sum(e.time_range.elapsed_us() for e in dev_events
                   if KERNEL not in e.name) / 1e3
    busy_us, end = 0.0, -np.inf
    for e in dev_events:  # union of the device intervals
        s, f = e.time_range.start, e.time_range.end
        if f > end:
            busy_us += f - max(s, end)
            end = f
    idle = 1.0 - busy_us / 1e3 / wall_ms
    print(f"K1 per phase (median device ms over {args.reps}): phase 0 "
          f"{phase_ms[0]:.3f}, phase 1 {phase_ms[1]:.3f}, phase 2 "
          f"{phase_ms[2]:.3f}", flush=True)
    print(f"{args.reps} pipelines: K1 {k1_ms:.3f} ms device, other kernels "
          f"{other_ms:.3f} ms ({len(dev_events) - len(k1)} launches), K1 "
          f"share {k1_ms / (k1_ms + other_ms):.4f}; wall {wall_ms:.3f} ms, "
          f"device idle share {idle:.4f}", flush=True)
    print(json.dumps(dict(card=card, setup_s=dict(
        cuda_init=t1 - t0, cache=t2 - t1, maps=t3 - t2), **stats,
        phase_ms=phase_ms, reps=args.reps, k1_ms=k1_ms, other_ms=other_ms,
        wall_ms=wall_ms, idle_share=idle)))


if __name__ == "__main__":
    main()
