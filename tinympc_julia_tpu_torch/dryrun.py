"""Dry-run entry points of the port (counterpart of the JAX package's
``__graft_entry__.py``).

- ``entry(device)``: the batched quadrotor solve and its example arguments
  (B = 64, N = 20, float32), the quickest check that a device runs the
  port.
- ``dryrun_multichip(n, *, device, full=False)``: ``n`` ranks in a gloo
  group, each running the JAX dry run's three legs on its block of the
  lanes, each held bit for bit against the same block run alone in the
  rank's own process (the same shapes, so the same reductions), and legs 2
  and 3 also against the same pipeline on kernel K1's plain version
  (``condensed_fused_reference``) at the kernel-vs-plain bar: equal
  iteration counts on >= 99% of lanes, controls and states within 1e-4
  on the lanes with equal counts that both solved:
    1. ``solve_sharded`` of the quadrotor batch, with the vote and without;
    2. a kernel-K1 straggler pipeline through ``map_shards``, each rank
       compacting its own stragglers into its share of the slots, with
       stragglers left by its first phase;
    3. the bucketed rebuild of the mis-set cartpole through
       ``map_shards``, with rho moved off rho0.
  ``full=False`` takes the JAX dry run's small shapes (leg 2 is the K1
  two-phase chain of ``tests/test_mesh_pipeline.py``, 32 lanes a rank,
  20 + 40 iterations); ``full=True`` the card's: the 65,536 quadrotor lanes
  of ``examples/batched_scenario_sweep.py``, the headline three-phase
  pipeline (``parallel.three_phase_solve``, 65,536 lanes, 8,192 slots
  split over the ranks) and the mis-set cartpole rebuild at 4,096 lanes.
- ``run_ranks(n, job, ...)``: the spawner under it.  Every rank is a
  subprocess ``python -m tinympc_julia_tpu_torch.dryrun --rank r ...`` that
  joins the group, builds the mesh, calls ``job(mesh, full)`` and saves
  the arrays it returns to ``rank{r}.npz``.  A rank's failure or the
  timeout kills every rank and raises in the caller.

Every rank of a run on ``"cuda"`` takes the card ``cuda:{rank %
device_count}``; on one card the ranks share it (gloo, since NCCL takes
one rank a device).

    python -m tinympc_julia_tpu_torch.dryrun [--n 2] [--device cuda] [--full]
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import functools
import importlib
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
LEGS_JOB = "tinympc_julia_tpu_torch.dryrun:legs"
HEADLINE_SLOTS = 8192  # the three-phase pipeline's slots over all ranks


def _quad_setup(B, N, max_iter, device, dtype=torch.float32):
    """The quadrotor batch of the JAX dry run and the flagship example:
    |u| <= 0.5, tolerance 1e-3, x0 ~ U(-0.3, 0.3) from seed 0."""
    from . import Settings, init_state, make_problem, precompute_cache
    from .models import quadrotor
    from .parallel import broadcast_state, set_x0_batch

    p = make_problem(quadrotor.A, quadrotor.B, np.diag(quadrotor.Q_DIAG),
                     np.diag(quadrotor.R_DIAG), quadrotor.RHO, N,
                     u_min=-0.5, u_max=0.5, dtype=dtype, device=device)
    c = precompute_cache(p.A, p.B, p.Q, p.R, p.rho_setup)
    s = Settings(max_iter=max_iter, en_state_bound=False, en_input_bound=True,
                 abs_pri_tol=1e-3, abs_dua_tol=1e-3)
    x0s = torch.as_tensor(np.random.default_rng(0).uniform(
        -0.3, 0.3, size=(B, 12)), dtype=dtype, device=device)
    st = set_x0_batch(broadcast_state(
        init_state(12, 4, N, dtype=dtype, device=device), B), x0s)
    return p, c, s, st


def entry(device):
    """(fn, example_args): the batched quadrotor solve at B = 64, N = 20 in
    float32 on ``device``; ``fn(problem, cache, state)`` gives the
    controls, iteration counts and solved flags."""
    from .parallel.batch import solve_batch

    p, c, s, st = _quad_setup(64, 20, 50, device)

    def step(problem, cache, state):
        _, _, solution = solve_batch(problem, cache, s, state)
        return solution.u, solution.iter, solution.solved

    return step, (p, c, st)


def _check(cond, msg):
    if not cond:
        raise RuntimeError(f"dryrun: {msg}")


def _fields(out) -> dict:
    """The named tensors of a NamedTuple, dataclass, dict or tuple."""
    if hasattr(out, "_asdict"):
        return out._asdict()
    if dataclasses.is_dataclass(out):
        return {f.name: getattr(out, f.name)
                for f in dataclasses.fields(out)}
    if isinstance(out, dict):
        return out
    return {f"out{k}": v for k, v in enumerate(out)}


def check_bit_equal(name, got, want):
    """Every tensor of ``got`` equals ``want``'s to the bit (a Solution,
    NamedTuple, dict or tuple of tensors)."""
    got, want = _fields(got), _fields(want)
    for key, a in got.items():
        b = want[key]
        _check(a.shape == b.shape and a.dtype == b.dtype
               and torch.equal(a, b), f"{name}: {key} differs")


PLAIN_ITERS_AGREE = 0.99  # the kernel-vs-plain bar of chip_smoke.py
PLAIN_ATOL = 1e-4


def check_plain_agreement(name, got, want):
    """Per-lane results ``(xs, us, iters, solved)`` of a pipeline on kernel
    K1 against the same pipeline on its plain version: equal counts on >=
    99% of lanes (fp32 sums in another order may move a lane that sits on
    the tolerance by one check interval), states and controls within 1e-4
    on the lanes with equal counts that both solved.  Returns (share of
    equal counts, max |diff|)."""
    (xk, uk, ik, sk), (xp, up, ip, sp) = got, want
    same = ik == ip
    share = float(same.double().mean())
    both = same & (sk == 1) & (sp == 1)
    err = 0.0
    if bool(both.any()):
        err = max(float((uk - up).abs()[both].max()),
                  float((xk - xp).abs()[both].max()))
    _check(share >= PLAIN_ITERS_AGREE and err <= PLAIN_ATOL
           and bool(torch.isfinite(uk).all() and torch.isfinite(xk).all()),
           f"{name}: against the plain version, counts equal on {share:.4f} "
           f"of lanes, max |diff| {err:.3e}")
    return share, err


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _launch_counts():
    from .ops.cuda.condensed_kernel import condensed_fused_cuda as k1
    return dict(k1=k1.launches, k1d=k1.grouped_launches)


def _zero_launch_counts():
    from .ops.cuda.condensed_kernel import condensed_fused_cuda as k1
    k1.launches = k1.grouped_launches = 0


def leg_sharded(mesh, full):
    """Leg 1: ``solve_sharded`` with and without the vote against
    ``solve_batch`` of the rank's block; at the small shapes also against
    the whole batch, at the JAX dry run's bar (equal counts, controls
    within 3e-6: batch shapes differ, and so do fp32 reductions)."""
    from .parallel import shard_state, solve_sharded
    from .parallel.batch import solve_batch

    B, N, max_iter = (65536, 20, 500) if full else (2 * mesh.world, 6, 50)
    p, c, s, st = _quad_setup(B, N, max_iter, mesh.device)
    block = shard_state(st, mesh)
    out, sols = {}, {}
    for vote in (1, 0):
        t0 = time.perf_counter()
        _, _, sols[vote] = solve_sharded(p, c, s, block, mesh,
                                         vote=bool(vote))
        _sync(mesh.device)
        out[f"l1_seconds_vote{vote}"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, _, ref = solve_batch(p, c, s, block)
    _sync(mesh.device)
    out["l1_seconds_local"] = time.perf_counter() - t0
    for vote, sol in sols.items():
        check_bit_equal(f"leg 1 rank {mesh.rank} vote={vote}", sol, ref)
    if not full:
        _, _, whole = solve_batch(p, c, s, st)
        b = B // mesh.world
        lo = mesh.rank * b
        _check(torch.equal(whole.iter[lo:lo + b], ref.iter)
               and torch.equal(whole.solved[lo:lo + b], ref.solved)
               and float((whole.u[lo:lo + b] - ref.u).abs().max()) <= 3e-6,
               f"leg 1 rank {mesh.rank}: the block against the whole batch")
    out.update(l1_iter=ref.iter, l1_solved=ref.solved, l1_u=ref.u)
    print(f"rank {mesh.rank}/{mesh.world} leg 1: solve_sharded of "
          f"{block.x.shape[0]} of {B} quadrotor lanes (N {N}, max_iter "
          f"{max_iter}) equal to solve_batch of the block bit for bit, vote "
          f"on and off; {int(ref.solved.sum())} solved, iterations max "
          f"{int(ref.iter.max())}; wall {out['l1_seconds_vote1']:.3f} s "
          f"(vote), {out['l1_seconds_vote0']:.3f} s (no vote), "
          f"{out['l1_seconds_local']:.3f} s (local)", flush=True)
    return out


def _cartpole(rho, device, **kw):
    from . import make_problem, precompute_cache
    from .models import cartpole
    p = make_problem(cartpole.A, cartpole.B, np.diag(cartpole.Q_DIAG),
                     np.diag(cartpole.R_DIAG), rho, cartpole.HORIZON,
                     u_min=-5.0, u_max=5.0, dtype=torch.float32,
                     device=device, **kw)
    return p, precompute_cache(p.A, p.B, p.Q, p.R, p.rho_setup)


def two_phase_chain(maps, rho, bounds, x0s, *, slots, fused=None):
    """The K1 two-phase straggler chain of the JAX mesh pipeline
    (``tests/test_mesh_pipeline.py``) on the cartpole: a cold pass of 20
    iterations with its carry, the unconverged lanes compacted into
    ``slots`` slots, a warm continuation of up to 40 from their carry
    (alpha 1.7, residual checks every 4 iterations).  ``fused`` replaces
    K1's entry point, as in ``three_phase_solve``; the result is a
    ``PipelineResult`` (phase 1 has no phase 0 before it)."""
    from .ops.cuda.condensed_kernel import (FusedCarry,
                                            make_condensed_fused_solver)
    from .parallel.pipeline import PipelineResult
    from .parallel.rebuild import compact_members, merge_lanes

    kw = dict(nx=4, nu=1, N=20, abs_pri_tol=1e-3, abs_dua_tol=1e-3,
              en_input_bound=True, en_state_bound=False,
              relaxation_alpha=1.7, check_termination=4)

    def phase(**phase_kw):
        if fused is None:
            return make_condensed_fused_solver(**kw, **phase_kw)
        return functools.partial(fused, **kw, **phase_kw)

    fn1 = phase(max_iter=20, warm_start=False, carry_out=True)
    fn2 = phase(max_iter=40, warm_start=True, carry_out=False)
    xs1, us1, it1, ok1, carry = fn1(maps, rho, *bounds, x0s)
    unconv = ok1 == 0
    idx, _, valid, _ = compact_members(unconv[None, :], slots)
    idx = idx[0]
    warm = FusedCarry(*(w[:, idx].contiguous() for w in carry))
    xs2, us2, it2, ok2 = fn2(maps, rho, *bounds, x0s[idx].contiguous(), warm)
    merge = functools.partial(merge_lanes,
                              dest=torch.where(valid, idx, x0s.shape[0]))
    return PipelineResult(xs=merge(xs1, xs2), us=merge(us1, us2), iters1=it1,
                          solved1=ok1, idx=idx, iters2=it2, solved2=ok2,
                          unconv=unconv, valid=valid)


def leg_pipeline(mesh, full):
    """Leg 2: the straggler pipeline through ``map_shards`` against the
    same pipeline on the rank's block, and against it on the plain K1."""
    from .ops.condensed import build_condensed
    from .ops.cuda.condensed_kernel import condensed_fused_reference
    from .parallel import map_shards, three_phase_solve

    B = 65536 if full else 32 * mesh.world
    p, c = _cartpole(1.0, mesh.device)
    maps = build_condensed(p, c)
    bounds = (p.u_min, p.u_max, p.x_min, p.x_max)
    x0s = torch.as_tensor(np.random.default_rng(0).uniform(
        -0.5, 0.5, size=(B, 4)), dtype=torch.float32, device=mesh.device)
    if full:
        slots = HEADLINE_SLOTS // mesh.world
        fn = functools.partial(three_phase_solve, maps, float(c.rho),
                               *bounds, nx=4, nu=1, N=20,
                               straggler_slots=slots)
    else:
        slots = B // mesh.world
        fn = functools.partial(two_phase_chain, maps, float(c.rho), bounds,
                               slots=slots)
    _zero_launch_counts()
    t0 = time.perf_counter()
    got = map_shards(fn, mesh, x0s)
    _sync(mesh.device)
    seconds = time.perf_counter() - t0
    launches = _launch_counts()
    b = B // mesh.world
    block = x0s[mesh.rank * b:(mesh.rank + 1) * b].contiguous()
    check_bit_equal(f"leg 2 rank {mesh.rank}", got, fn(block))
    share, err = check_plain_agreement(
        f"leg 2 rank {mesh.rank}", got.lane_results(),
        fn(block, fused=condensed_fused_reference).lane_results())
    n_strag = int(got.unconv.sum())
    _check(n_strag > 0, f"leg 2 rank {mesh.rank}: phase 1 left no "
           "stragglers")
    conv = int(got.converged())
    print(f"rank {mesh.rank}/{mesh.world} leg 2: "
          f"{'three-phase pipeline' if full else 'two-phase K1 chain'} "
          f"through map_shards on {b} of {B} cartpole lanes, {slots} slots, "
          f"equal to the rank's own run bit for bit, and to the plain K1's "
          f"with counts equal on {share:.4f} of lanes, max |diff| {err:.3e}; "
          f"{n_strag} stragglers, {conv} converged; wall {seconds:.3f} s; "
          f"K1 launches {launches['k1']}", flush=True)
    return {**{f"l2_{k}": v for k, v in got._asdict().items()},
            "l2_seconds": seconds, "l2_k1_launches": launches["k1"],
            "l2_plain_share": share, "l2_plain_err": err}


def leg_rebuild(mesh, full):
    """Leg 3: the bucketed rebuild of the mis-set cartpole (rho0 = 0.01,
    |x_0| <= 2) through ``map_shards`` against the rank's own run."""
    from . import Settings
    from .ops.cuda.condensed_kernel import condensed_fused_reference
    from .parallel import make_bucketed_rebuild, map_shards

    rho0 = 0.01
    N = 20
    xb = np.tile([2.0, 1e17, 1e17, 1e17], (N, 1))
    p, c = _cartpole(rho0, mesh.device, x_min=-xb, x_max=xb)
    if full:
        b, span, p1, p2 = 4096 // mesh.world, (1e-4, 1e4), 50, 450
    else:
        b, span, p1, p2 = 16, (1e-3, 1e3), 20, 180
    s = Settings(max_iter=p1 + p2, en_state_bound=True, en_input_bound=True,
                 adaptive_rho_min=span[0], adaptive_rho_max=span[1])
    pkw = dict(phase1_iters=p1, straggler_slots=b, phase2_iters=p2)
    pipe = make_bucketed_rebuild(p, c, s, **pkw)
    plain = make_bucketed_rebuild(p, c, s, fused=condensed_fused_reference,
                                  **pkw)
    B = b * mesh.world
    x0s = torch.as_tensor(np.random.default_rng(5).uniform(
        -1, 1, size=(B, 4)) * np.array([1.8, 1.0, 0.4, 0.5]),
        dtype=torch.float32, device=mesh.device)
    _zero_launch_counts()
    t0 = time.perf_counter()
    got = map_shards(pipe.solve, mesh, x0s)
    _sync(mesh.device)
    seconds = time.perf_counter() - t0
    launches = _launch_counts()
    block = x0s[mesh.rank * b:(mesh.rank + 1) * b].contiguous()
    check_bit_equal(f"leg 3 rank {mesh.rank}", got, pipe.solve(block))
    want = plain.solve(block)
    share, err = check_plain_agreement(f"leg 3 rank {mesh.rank}", got[:4],
                                       want[:4])
    same = got[2] == want[2]
    rho_share = float((got[4] == want[4])[same].double().mean())
    _check(rho_share >= PLAIN_ITERS_AGREE and torch.equal(got[5], want[5]),
           f"leg 3 rank {mesh.rank}: against the plain version, lane rho "
           f"equal on {rho_share:.4f} of lanes with equal counts, overflow "
           f"{got[5].tolist()} against {want[5].tolist()}")
    n_ok = int(got[3].sum())
    rho = got[4]
    _check(n_ok > 0 and float(rho.max()) > rho0,
           f"leg 3 rank {mesh.rank}: {n_ok} converged, rho max "
           f"{float(rho.max())}")
    print(f"rank {mesh.rank}/{mesh.world} leg 3: bucketed rebuild through "
          f"map_shards on {b} of {B} mis-set cartpole lanes ({p1} + {p2} "
          f"iterations, {len(pipe.bucket_rhos)} buckets of {b} slots), equal "
          f"to the rank's own run bit for bit, and to the plain K1's with "
          f"counts equal on {share:.4f} of lanes, max |diff| {err:.3e}; "
          f"{n_ok} converged, rho span "
          f"[{float(rho.min()):.3g}, {float(rho.max()):.3g}]; wall "
          f"{seconds:.3f} s; K1 launches {launches['k1']}, of which K1d "
          f"{launches['k1d']}", flush=True)
    names = ("xs", "us", "iters", "solved", "rho", "overflow")
    return {**{f"l3_{k}": v for k, v in zip(names, got)},
            "l3_seconds": seconds, "l3_k1_launches": launches["k1"],
            "l3_k1d_launches": launches["k1d"], "l3_plain_share": share,
            "l3_plain_err": err}


def legs(mesh, full):
    """The dry run's job: legs 1-3 on this rank."""
    out = {}
    for leg in (leg_sharded, leg_pipeline, leg_rebuild):
        out.update(leg(mesh, full))
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tail(path: Path, n: int = 40) -> str:
    if not path.exists():
        return ""
    return "\n".join(path.read_text(errors="replace").splitlines()[-n:])


def run_ranks(n: int, job: str, *, device, full: bool = False,
              out_dir=None, timeout: float = 600.0, path=()) -> list:
    """Run ``job`` ("module:function", called as ``function(mesh, full)``
    and returning a dict of tensors or arrays) on ``n`` gloo ranks, each a
    subprocess on ``device``; ``path`` holds more entries for the ranks'
    ``sys.path``.  Returns the ranks' ``.npz`` paths, in rank order, in
    ``out_dir`` (a new temporary directory by default) beside each rank's
    log ``rank{r}.log``.  Any rank's failure, or ``timeout`` seconds
    passing, kills every rank and raises ``RuntimeError`` with the logs."""
    out = Path(out_dir or tempfile.mkdtemp(prefix="tinympc_dryrun_"))
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT), *map(str, path)]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    port = _free_port()
    logs = [out / f"rank{r}.log" for r in range(n)]
    procs = []
    failure = None
    try:
        for r in range(n):
            cmd = [sys.executable, "-m", "tinympc_julia_tpu_torch.dryrun",
                   "--rank", str(r), "--world", str(n), "--port", str(port),
                   "--device", str(device), "--out", str(out), "--job", job,
                   "--timeout", str(timeout)] + (["--full"] if full else [])
            with open(logs[r], "w") as log:
                procs.append(subprocess.Popen(
                    cmd, stdout=log, stderr=subprocess.STDOUT, env=env))
        deadline = time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in procs]
            bad = [r for r, code in enumerate(codes) if code not in (None, 0)]
            if bad:
                failure = f"rank {bad[0]} exited with {codes[bad[0]]}"
                break
            if all(code == 0 for code in codes):
                break
            if time.monotonic() > deadline:
                failure = f"timed out after {timeout} s"
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    if failure is not None:
        raise RuntimeError(f"run_ranks({n}, {job!r}): {failure}\n" + "\n".join(
            f"--- rank {r} ---\n{_tail(log)}" for r, log in enumerate(logs)))
    return [out / f"rank{r}.npz" for r in range(n)]


def dryrun_multichip(n: int, *, device, full: bool = False, out_dir=None,
                     timeout: float = 900.0) -> list:
    """Run the dry run's legs on ``n`` ranks (module docstring); prints
    every rank's report and returns the ranks' ``.npz`` paths."""
    paths = run_ranks(n, LEGS_JOB, device=device, full=full,
                      out_dir=out_dir, timeout=timeout)
    for npz in paths:
        print(_tail(npz.with_suffix(".log")), flush=True)
    return paths


def _rank_main(a) -> None:
    import torch.distributed as dist

    from .parallel import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{a.port}",
        world_size=a.world, rank=a.rank,
        timeout=datetime.timedelta(seconds=a.timeout))
    try:
        mesh = make_mesh(a.world, device=a.device)
        module, name = a.job.split(":")
        out = getattr(importlib.import_module(module), name)(mesh, a.full)
        np.savez(Path(a.out) / f"rank{a.rank}.npz", **{
            k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
            for k, v in out.items()})
    finally:
        dist.destroy_process_group()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=2, help="ranks of the dry run")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    ap.add_argument("--job", default=LEGS_JOB, help=argparse.SUPPRESS)
    ap.add_argument("--timeout", type=float, default=900.0,
                    help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.rank is not None:
        _rank_main(a)
        return
    fn, args = entry(a.device)
    u, iters, solved = fn(*args)
    print(f"entry: ok, u {tuple(u.shape)}, {int(solved.sum())}/"
          f"{solved.numel()} solved, iterations max {int(iters.max())}")
    dryrun_multichip(a.n, device=a.device, full=a.full, timeout=a.timeout)


if __name__ == "__main__":
    main()
