#!/usr/bin/env python3
"""The flagship: a 64k-instance randomized quadrotor scenario sweep,
batch-sharded over the ranks of the mesh (one rank a card; a world of one
without a process group) with the convergence vote.  No reference analog:
the reference is single-threaded."""
import time

import numpy as np
import torch

from tinympc_julia_tpu_torch import (Settings, init_state, make_problem,
                                     precompute_cache)
from tinympc_julia_tpu_torch.models import quadrotor
from tinympc_julia_tpu_torch.parallel import (broadcast_state, make_mesh,
                                              set_x0_batch, shard_state,
                                              solve_sharded)
from tinympc_julia_tpu_torch.utils.profiling import solve_stats


def scenario(B, device, dtype=torch.float32):
    """(problem, cache, settings, global batched workspace) of the sweep:
    the quadrotor at |u| <= 0.5, max_iter 500, x0 ~ U(-0.3, 0.3) from seed
    0; every rank builds the same one."""
    p = make_problem(quadrotor.A, quadrotor.B, np.diag(quadrotor.Q_DIAG),
                     np.diag(quadrotor.R_DIAG), quadrotor.RHO,
                     quadrotor.HORIZON, u_min=-0.5, u_max=0.5, dtype=dtype,
                     device=device)
    c = precompute_cache(p.A, p.B, p.Q, p.R, p.rho_setup)
    s = Settings(max_iter=500, en_state_bound=False, en_input_bound=True)
    rng = np.random.default_rng(0)
    x0s = torch.as_tensor(rng.uniform(-0.3, 0.3, size=(B, 12)), dtype=dtype,
                          device=device)
    st = set_x0_batch(broadcast_state(
        init_state(12, 4, quadrotor.HORIZON, dtype=dtype, device=device), B),
        x0s)
    return p, c, s, st


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(B=65536, device="cuda"):
    mesh = make_mesh(device=device)
    n_dev = mesh.shape["batch"]
    B = (B // n_dev) * n_dev
    print(f"devices: {n_dev}, batch: {B}")

    p, c, s, st = scenario(B, mesh.device)
    st = shard_state(st, mesh)

    # warm-up (the JAX example's compile)
    _, _, sol = solve_sharded(p, c, s, st, mesh, vote=True)
    _sync(mesh.device)

    t0 = time.perf_counter()
    _, _, sol = solve_sharded(p, c, s, st, mesh, vote=True)
    _sync(mesh.device)
    dt = time.perf_counter() - t0

    stats = solve_stats(sol)
    print(f"solved {stats['converged']}/{B} in {dt:.3f}s "
          f"({stats['converged'] / dt:.0f} converged solves/s)")
    print(f"iterations: mean {stats['iter_mean']:.1f} "
          f"p99 {stats['iter_p99']:.0f} max {stats['iter_max']}")
    return sol, dt


if __name__ == "__main__":
    main()
