"""The two grouped sweep workloads (G distinct problems x L lanes), drawn as
the JAX package's bench rows draw them (bench.py ``bench_randomized_sweep``
and ``bench_rocket_sweep``: same seeds, same order of draws), so both
packages solve the same instances.

  * the randomised quadrotor sweep: G = 64 perturbed plants, costs and input
    bounds x L = 1,024 initial states, seed 4, tolerance 1e-3,
    over-relaxation 1.7, residual checks every 4 iterations;
  * the rocket sweep with per-group cone coefficients: G = 16 pairs of thrust
    and glide-slope cones x L = 2,048 initial states, seed 6, tolerances
    2e-3/1e-3, box and both cones.

Each builder returns ``(solver, x0s, pipeline_kw, setup_seconds)``: a
``GroupedBatchSolver`` on ``device``, the (G, L, nx) float32 initial states
there, the bench row's ``make_fused_pipeline`` options (without ``lanes``)
and the host-clock seconds the G ``precompute_cache`` calls took.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..ops.riccati import precompute_cache
from ..parallel.grouped import GroupedBatchSolver
from ..types import ConeSet, Settings, make_problem, stack_instances
from . import quadrotor, rocket

QUADROTOR_PIPELINE = dict(phase0_bf16_iters=128, phase1_iters=32,
                          straggler_slots=256, phase2_iters=1500,
                          phase2_bf16_head=512)
ROCKET_PIPELINE = dict(phase0_bf16_iters=24, phase1_iters=48,
                       straggler_slots=256, phase2_iters=400)


def unstaged(pipeline_kw: dict) -> dict:
    """The same pipeline without its reduced-precision phases and with the
    same total budget: phase 0's iterations join phase 1."""
    kw = dict(pipeline_kw)
    kw["phase1_iters"] += kw.pop("phase0_bf16_iters", 0)
    kw.pop("phase2_bf16_head", None)
    return kw


def _caches(problems, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    caches = [precompute_cache(p.A, p.B, p.Q, p.R, p.rho_setup)
              for p in problems]
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return caches, time.perf_counter() - t0


def randomized_quadrotor_sweep(*, device, G: int = 64, L: int = 1024,
                               seed: int = 4):
    f32 = torch.float32
    N = quadrotor.HORIZON
    rng = np.random.default_rng(seed)
    probs = []
    for _ in range(G):
        A = quadrotor.A + rng.normal(scale=2e-3, size=(12, 12))
        Bm = quadrotor.B * rng.uniform(0.9, 1.1)
        Qd = quadrotor.Q_DIAG * rng.uniform(0.8, 1.25, size=12)
        Rd = quadrotor.R_DIAG * rng.uniform(0.8, 1.25, size=4)
        ub = rng.uniform(0.4, 0.6)
        probs.append(make_problem(A, Bm, np.diag(Qd), np.diag(Rd),
                                  quadrotor.RHO, N, u_min=-ub, u_max=ub,
                                  dtype=f32, device=device))
    caches, seconds = _caches(probs, device)
    solver = GroupedBatchSolver(
        stack_instances(probs), stack_instances(caches),
        Settings(max_iter=300, en_state_bound=False, en_input_bound=True,
                 relaxation_alpha=1.7, check_termination=4))
    x0s = torch.as_tensor(rng.uniform(-0.25, 0.25, size=(G, L, 12)),
                          dtype=f32, device=device)
    return solver, x0s, dict(QUADROTOR_PIPELINE), seconds


def rocket_cone_sweep(*, device, G: int = 16, L: int = 2048, seed: int = 6):
    f32 = torch.float32
    N = rocket.HORIZON
    rng = np.random.default_rng(seed)
    xb = rocket.bounds()
    Xref, Uref = rocket.reference_trajectory(0)
    probs = []
    for _ in range(G):
        mu_u = float(rng.uniform(0.15, 0.35))
        mu_x = float(rng.uniform(0.4, 0.6))

        def cone(mu):
            return ConeSet(mus=torch.tensor([mu], dtype=f32, device=device),
                           starts=(0,), dims=(3,))

        probs.append(make_problem(
            rocket.A, rocket.B, np.diag(rocket.Q_DIAG),
            np.diag(rocket.R_DIAG), rocket.RHO, N, f=rocket.F,
            x_min=xb[0].T, x_max=xb[1].T, u_min=-10.0, u_max=105.0,
            Xref=Xref.T, Uref=Uref.T, cones_u=cone(mu_u), cones_x=cone(mu_x),
            dtype=f32, device=device))
    caches, seconds = _caches(probs, device)
    solver = GroupedBatchSolver(
        stack_instances(probs), stack_instances(caches),
        Settings(max_iter=100, abs_pri_tol=2e-3, abs_dua_tol=1e-3,
                 en_state_bound=True, en_input_bound=True, en_input_soc=True,
                 en_state_soc=True))
    x0s = torch.as_tensor(
        rocket.X_INIT[None, None, :] * rng.uniform(0.9, 1.1, size=(G, L, 1)),
        dtype=f32, device=device)
    return solver, x0s, dict(ROCKET_PIPELINE), seconds
