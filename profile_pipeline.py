#!/usr/bin/env python3
"""Where the port's pipelines spend their time on one NVIDIA GPU.

    python3 profile_pipeline.py [--workload cartpole|rocket|adaptive|
                                 sweep_quadrotor|sweep_rocket|mpc_loop|
                                 fused_stage|all] [--reps 3]

Runs each chosen workload under ``torch.profiler`` after one warm-up:
  * ``cartpole``: the three-phase pipeline (65,536 cartpole lanes, 8,192
    straggler slots, all fp32), three launches of kernel K1;
  * ``rocket``: the rocket chain through the API (65,536 lanes, box and
    both cones, a 24-iteration cold ``solve_batch(method="fused")`` with its
    carry, then 48 warm), two launches of K1 with its projections;
  * ``adaptive``: the two-phase adaptive-rho pipeline (16,384 quadrotor
    lanes, termination controller floored at rho0 with trust 2, 150
    iterations, 2,048 straggler slots, up to 2,500 warm), two launches of
    kernel K2 (the bulk launch and the warm continuation), with the tiles
    each launch runs and K2's tile iterations against the lanes' own; and
    its group grid beside it (``adaptive_grid``: 8 randomised quadrotors x
    512 lanes through ``GroupedBatchSolver.solve_batch(method="fused")``,
    150 iterations, one launch);
  * ``sweep_quadrotor``: the randomised quadrotor sweep through
    ``GroupedBatchSolver.make_fused_pipeline`` (models/sweeps.py: 64 plants x
    1,024 lanes, 128 reduced-precision + 32 fp32 iterations, 256 slots a
    group, 1,500 more with a 512-iteration reduced head), three launches of
    K1 on its group grid; its unstaged form (160 + 1,500 fp32, two launches)
    is profiled beside it;
  * ``sweep_rocket``: the rocket sweep with per-group cone coefficients (16
    cone pairs x 2,048 lanes, 24 + 48 iterations, 256 slots, 400 more),
    three launches of K1 with its projections on the group grid, and its
    unstaged form (two launches);
  * ``mpc_loop``: the fused closed-loop MPC of parallel/mpc.py (8,192
    cartpole plants x 100 control steps, alpha 1.7, 100 iterations a step),
    100 launches of K1 chained through its carry, the plant step and the
    per-launch map layouts between them;
  * ``fused_stage``: kernel K3's two full-width solves through
    ``make_fused_solver``, each its own workload: ``fused_stage_cartpole``
    (65,536 lanes, 100 iterations) and ``fused_stage_quadrotor`` (16,384
    lanes, rho 5, 500 iterations), one launch a solve.
It prints, one line each:
  * the card's name and power limit;
  * per workload, setup on the host clock (the Riccati cache with its
    sensitivities, the condensed maps) and the iteration statistics;
  * the host's enqueue time of a run (host clock from the call to its
    return, no synchronisation inside; median of 3);
  * per launch of the pipeline, the median device time of its kernel;
  * over the profiled reps: the kernel's device time, that of every other
    device kernel (compaction, gathers, merges), the device launches a run,
    the kernel's share of device time, the wall time, and the device's idle
    share (1 - union of device-kernel intervals / wall).
The last line is the same numbers as one JSON object.
"""
import argparse
import json
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType

F32 = torch.float32
# K1's device symbols: condensed_fused_kernel<...> (tiles of lanes) and
# condensed_fused_warp_kernel<...> (the warp layout of the narrow maps)
K1_KERNEL = "condensed_fused_"


def cartpole_workload(dev):
    from tinympc_julia_tpu_torch import make_problem
    from tinympc_julia_tpu_torch.models import cartpole
    from tinympc_julia_tpu_torch.ops.condensed import build_condensed
    from tinympc_julia_tpu_torch.ops.riccati import precompute_cache
    from tinympc_julia_tpu_torch.parallel.pipeline import three_phase_solve

    N = cartpole.HORIZON
    t0 = time.perf_counter()
    p = make_problem(cartpole.A, cartpole.B, np.diag(cartpole.Q_DIAG),
                     np.diag(cartpole.R_DIAG), cartpole.RHO, N, u_min=-5.0,
                     u_max=5.0, dtype=F32, device=dev)
    c = precompute_cache(p.A, p.B, p.Q, p.R, p.rho_setup)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    maps = build_condensed(p, c)
    torch.cuda.synchronize()
    setup = dict(cache=t1 - t0, maps=time.perf_counter() - t1)
    x0 = torch.as_tensor(np.random.default_rng(0).uniform(
        -0.5, 0.5, size=(65536, 4)), dtype=F32, device=dev)

    def run():
        return three_phase_solve(maps, float(c.rho), p.u_min, p.u_max,
                                 p.x_min, p.x_max, x0, nx=4, nu=1, N=N,
                                 straggler_slots=8192)

    def stats(res):
        it2 = res.iters2[res.valid].float()
        return dict(phase1_mean_iters=res.iters1.float().mean().item(),
                    stragglers=int(res.unconv.sum()),
                    phase2_mean_iters=it2.mean().item() if it2.numel() else 0,
                    phase2_max_iters=int(it2.max()) if it2.numel() else 0,
                    converged=int(res.converged()))

    return K1_KERNEL, 3, setup, run, stats


def rocket_workload(dev):
    from tinympc_julia_tpu_torch.models import rocket

    t0 = time.perf_counter()
    solver = rocket.make_solver(dtype=F32, device="cuda")
    Xref, Uref = rocket.reference_trajectory(0)
    solver.set_x_ref(Xref)
    solver.set_u_ref(Uref)
    torch.cuda.synchronize()
    setup = dict(cache=time.perf_counter() - t0, maps=None)
    x0 = torch.as_tensor(
        rocket.X_INIT[None, :]
        * np.random.default_rng(2).uniform(0.9, 1.1, size=(65536, 1)),
        dtype=F32, device=dev)

    def run():
        solver.update_settings(max_iter=24)
        x0_, u0, it0, ok0, carry = solver.solve_batch(
            x0, method="fused", return_carry=True)
        solver.update_settings(max_iter=48)
        x1, u1, it1, ok1 = solver.solve_batch(x0, method="fused", warm=carry)
        done = ok0 == 1
        return (torch.where(done[:, None, None], u0, u1),
                torch.where(done, it0, 24 + it1), torch.maximum(ok0, ok1))

    def stats(res):
        return dict(mean_iters=res[1].float().mean().item(),
                    max_iters=int(res[1].max()), converged=int(res[2].sum()))

    return K1_KERNEL, 2, setup, run, stats


def adaptive_workload(dev):
    from tinympc_julia_tpu_torch.models import quadrotor
    from tinympc_julia_tpu_torch.ops.condensed import build_condensed_taylor
    from tinympc_julia_tpu_torch.ops.cuda.adaptive_kernel import (
        adaptive_tile_plan)
    from tinympc_julia_tpu_torch.ops.cuda.condensed_kernel import (
        tile_iterations)
    from tinympc_julia_tpu_torch.parallel.pipeline import (
        ADAPTIVE_BUDGETS, two_phase_adaptive_solve)

    t0 = time.perf_counter()
    solver = quadrotor.make_solver(dtype=F32, device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    p = solver.problem
    tmaps = build_condensed_taylor(p, solver.cache)
    torch.cuda.synchronize()
    setup = dict(cache=t1 - t0, maps=time.perf_counter() - t1)
    x0 = torch.as_tensor(np.random.default_rng(1).uniform(
        -0.3, 0.3, size=(16384, 12)), dtype=F32, device=dev)

    def run():
        return two_phase_adaptive_solve(
            tmaps, p.u_min, p.u_max, p.x_min, p.x_max, x0, nx=12, nu=4,
            N=p.N, straggler_slots=2048)

    m1 = ADAPTIVE_BUDGETS[0]
    tile = adaptive_tile_plan(12, 4, p.N, 2).tile

    def stats(res):
        # the bulk launch's lanes ran min(count, m1); the continuation's
        # slots hold the stragglers in lane order (its fill slots, which
        # repeat lane 0, are left out of its tile iterations)
        bulk = res.iters.clamp(max=m1)
        cont = res.iters[res.unconv] - m1
        n_bulk = tile_iterations(bulk, tile)
        n_cont = tile_iterations(cont, tile)
        return dict(stragglers=int(res.unconv.sum()),
                    overflow=int(res.overflow),
                    mean_iters=res.iters.float().mean().item(),
                    max_iters=int(res.iters.max()),
                    converged=int(res.solved.sum()),
                    rho_span=[res.rho.min().item(), res.rho.max().item()],
                    tile=tile, tile_iterations=dict(bulk=n_bulk,
                                                    continuation=n_cont),
                    tile_over_lane_iterations=dict(
                        bulk=tile * n_bulk / int(bulk.sum()),
                        continuation=tile * n_cont
                        / max(1, int(cont.sum()))))

    return "condensed_adaptive_kernel", 2, setup, run, stats


def adaptive_grid_workload(dev):
    from tinympc_julia_tpu_torch import Settings, make_problem
    from tinympc_julia_tpu_torch.models import quadrotor
    from tinympc_julia_tpu_torch.ops.cuda.condensed_kernel import (
        TILE, tile_iterations)
    from tinympc_julia_tpu_torch.ops.riccati import precompute_cache
    from tinympc_julia_tpu_torch.parallel.grouped import GroupedBatchSolver
    from tinympc_julia_tpu_torch.types import stack_instances

    G, L = 8, 512
    rng = np.random.default_rng(11)
    t0 = time.perf_counter()
    ps, cs = [], []
    for _ in range(G):
        ub = rng.uniform(0.4, 0.6)
        pg = make_problem(
            quadrotor.A + rng.normal(scale=2e-3, size=(12, 12)),
            quadrotor.B * rng.uniform(0.9, 1.1),
            np.diag(quadrotor.Q_DIAG * rng.uniform(0.8, 1.25, size=12)),
            np.diag(quadrotor.R_DIAG), quadrotor.RHO * rng.uniform(0.8, 1.2),
            quadrotor.HORIZON, u_min=-ub, u_max=ub, dtype=F32, device=dev)
        ps.append(pg)
        cs.append(precompute_cache(pg.A, pg.B, pg.Q, pg.R, pg.rho_setup))
    gs = GroupedBatchSolver(stack_instances(ps), stack_instances(cs), Settings(
        max_iter=150, en_state_bound=False, adaptive_rho=True,
        adaptive_rho_controller="termination", adaptive_rho_taylor_trust=2.0,
        adaptive_rho_min=quadrotor.RHO * 0.8, adaptive_rho_max=1e3))
    torch.cuda.synchronize()
    setup = dict(cache=time.perf_counter() - t0, maps=None)
    x0 = torch.as_tensor(np.random.default_rng(12).uniform(
        -0.3, 0.3, size=(G, L, 12)), dtype=F32, device=dev)

    def stats(res):
        it = res[2].reshape(-1)
        n_tile = tile_iterations(it, TILE, G)
        return dict(mean_iters=it.float().mean().item(),
                    max_iters=int(it.max()), converged=int(res[3].sum()),
                    tile=TILE, tile_iterations=n_tile,
                    tile_over_lane_iterations=TILE * n_tile / int(it.sum()))

    return ("condensed_adaptive_kernel", 1, setup,
            lambda: gs.solve_batch(x0, method="fused"), stats)


def sweep_workload(build, staged):
    """One of the grouped sweeps of models/sweeps.py, with its
    reduced-precision phases (``staged``) or without them at the same total
    budget."""
    def workload(dev):
        from tinympc_julia_tpu_torch.models import sweeps
        gs, x0s, pkw, cache_s = getattr(sweeps, build)(device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gs.maps()
        torch.cuda.synchronize()
        setup = dict(cache=cache_s, maps=time.perf_counter() - t0)
        if not staged:
            pkw = sweeps.unstaged(pkw)
        pipe = gs.make_fused_pipeline(lanes=x0s.shape[1], **pkw)

        def stats(res):
            _, _, iters, solved, overflow = res
            return dict(pipeline=pkw, mean_iters=iters.float().mean().item(),
                        max_iters=int(iters.max()),
                        converged=int(solved.sum()), lanes=solved.numel(),
                        overflow=int(overflow.sum()))

        return (K1_KERNEL, 3 if "phase0_bf16_iters" in pkw
                else 2, setup, lambda: pipe(x0s), stats)

    return workload


def _plant(mod, ub, dev):
    from tinympc_julia_tpu_torch import make_problem
    from tinympc_julia_tpu_torch.ops.riccati import precompute_cache
    p = make_problem(mod.A, mod.B, np.diag(mod.Q_DIAG), np.diag(mod.R_DIAG),
                     mod.RHO, mod.HORIZON, u_min=-ub, u_max=ub, dtype=F32,
                     device=dev)
    return p, precompute_cache(p.A, p.B, p.Q, p.R, p.rho_setup)


def mpc_loop_workload(dev):
    from tinympc_julia_tpu_torch import Settings
    from tinympc_julia_tpu_torch.models import cartpole
    from tinympc_julia_tpu_torch.parallel.mpc import make_fused_mpc_loop

    steps = 100
    t0 = time.perf_counter()
    p, c = _plant(cartpole, 5.0, dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    loop = make_fused_mpc_loop(
        p, c, Settings(max_iter=100, en_state_bound=False,
                       relaxation_alpha=1.7), steps)
    torch.cuda.synchronize()
    setup = dict(cache=t1 - t0, maps=time.perf_counter() - t1)
    x0 = torch.as_tensor(np.random.default_rng(3).uniform(
        -0.5, 0.5, size=(8192, 4)), dtype=F32, device=dev)

    def stats(res):
        it = res.iters.float()
        return dict(steps=res.iters.numel(),
                    solved_share=res.solved.float().mean().item(),
                    mean_iters=it.mean().item(),
                    mean_iters_step0=it[:, 0].mean().item(),
                    mean_iters_last_step=it[:, -1].mean().item(),
                    max_iters_after_step0=int(res.iters[:, 1:].max()))

    return K1_KERNEL, steps, setup, lambda: loop(x0), stats


def fused_stage_workload(name):
    """K3's full-width solve ``name`` (cartpole or quadrotor), one launch a
    run."""
    def workload(dev):
        from tinympc_julia_tpu_torch.models import cartpole, quadrotor
        from tinympc_julia_tpu_torch.ops.cuda.fused import make_fused_solver
        mod, ub, B, seed, scale, budget = dict(
            cartpole=(cartpole, 5.0, 65536, 0, 0.5, 100),
            quadrotor=(quadrotor, quadrotor.U_HOVER_BOUND, 16384, 1, 0.3,
                       500))[name]
        t0 = time.perf_counter()
        p, c = _plant(mod, ub, dev)
        x0 = torch.as_tensor(np.random.default_rng(seed).uniform(
            -scale, scale, size=(B, p.nx)), dtype=F32, device=dev)
        args = (p.A, p.B, p.f, p.Q, p.R, c.rho, c.Kinf, c.Quu_inv, c.AmBKt,
                c.Pinf, p.x_min, p.x_max, p.u_min, p.u_max, p.Xref, p.Uref,
                x0)
        solve = make_fused_solver(p.nx, p.nu, p.N, max_iter=budget)
        torch.cuda.synchronize()
        setup = dict(cache=time.perf_counter() - t0, maps=None)

        def stats(res):
            return dict(mean_iters=res[2].float().mean().item(),
                        max_iters=int(res[2].max()),
                        converged=int(res[3].sum()), lanes=res[3].numel())

        return "fused_stage_kernel", 1, setup, lambda: solve(*args), stats

    return workload


WORKLOADS = dict(
    cartpole=cartpole_workload, rocket=rocket_workload,
    adaptive=adaptive_workload, adaptive_grid=adaptive_grid_workload,
    sweep_quadrotor=sweep_workload("randomized_quadrotor_sweep", True),
    sweep_quadrotor_unstaged=sweep_workload("randomized_quadrotor_sweep",
                                            False),
    sweep_rocket=sweep_workload("rocket_cone_sweep", True),
    sweep_rocket_unstaged=sweep_workload("rocket_cone_sweep", False),
    mpc_loop=mpc_loop_workload,
    fused_stage_cartpole=fused_stage_workload("cartpole"),
    fused_stage_quadrotor=fused_stage_workload("quadrotor"))


def trace(name, kernel, per_run, run, reps):
    """Profile ``reps`` runs; the kernel's device time per launch of the
    pipeline, its share of device time, and the device's idle share."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - w0) * 1e3
    dev_events = sorted((e for e in prof.events()
                         if e.device_type == DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
    if not dev_events:
        raise SystemExit("profile_pipeline: the profiler recorded no device "
                         "kernels")
    ours = [e for e in dev_events if kernel in e.name]
    if len(ours) != per_run * reps:
        raise SystemExit(f"profile_pipeline: {name}: {len(ours)} launches of "
                         f"{kernel} traced, expected {per_run * reps}")
    launch_ms = [float(np.median([ours[per_run * r + k].time_range.elapsed_us()
                                  for r in range(reps)])) / 1e3
                 for k in range(per_run)]
    kernel_ms = sum(e.time_range.elapsed_us() for e in ours) / 1e3
    other_ms = sum(e.time_range.elapsed_us() for e in dev_events
                   if kernel not in e.name) / 1e3
    busy_us, end = 0.0, -np.inf
    for e in dev_events:  # union of the device intervals
        s, f = e.time_range.start, e.time_range.end
        if f > end:
            busy_us += f - max(s, end)
            end = f
    idle = 1.0 - busy_us / 1e3 / wall_ms
    print(f"{name}: {kernel} per launch (median device ms over {reps}): "
          + ", ".join(f"{t:.3f}" for t in launch_ms), flush=True)
    print(f"{name}: {reps} runs: kernel {kernel_ms:.3f} ms device, other "
          f"kernels {other_ms:.3f} ms ({len(dev_events) - len(ours)} "
          f"launches), {len(dev_events) / reps:g} device launches a run, "
          f"kernel share {kernel_ms / (kernel_ms + other_ms):.4f}; "
          f"wall {wall_ms:.3f} ms, device idle share {idle:.4f}", flush=True)
    return dict(launch_ms=launch_ms, kernel_ms=kernel_ms, other_ms=other_ms,
                launches_per_run=len(dev_events) / reps, wall_ms=wall_ms,
                idle_share=idle)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="all",
                    choices=["cartpole", "rocket", "adaptive",
                             "sweep_quadrotor", "sweep_rocket", "mpc_loop",
                             "fused_stage", "all"])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_pipeline: torch.cuda.is_available() is "
                         "false; this script needs an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card {card}", flush=True)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    torch.zeros(1, device=dev)
    torch.cuda.synchronize()
    print(f"CUDA init (host clock) {time.perf_counter() - t0:.3f} s",
          flush=True)

    out = dict(card=card, reps=args.reps)
    names = list(WORKLOADS) if args.workload == "all" else [
        n for n in WORKLOADS if n.startswith(args.workload)]
    for name in names:
        kernel, per_run, setup, run, stats = WORKLOADS[name](dev)
        print(f"{name}: setup (host clock, seconds) {setup}", flush=True)
        res = run()  # warm-up: builds and loads the kernel
        torch.cuda.synchronize()
        st = stats(res)
        print(f"{name}: iterations {st}", flush=True)
        enqueue = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            enqueue.append(1e3 * (time.perf_counter() - t0))
            torch.cuda.synchronize()
        enq_ms = float(np.median(enqueue))
        print(f"{name}: the host enqueues a run in {enq_ms:.3f} ms (median "
              f"of 3)", flush=True)
        out[name] = dict(setup_s=setup, **st, enqueue_ms=enq_ms,
                         **trace(name, kernel, per_run, run, args.reps))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
