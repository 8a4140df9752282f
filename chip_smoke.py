#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (one line each; any failure exits non-zero):
  1. environment: torch and CUDA versions, the card's name and power limit;
     TF32 off, so every fp32 matmul of the plain versions is full fp32;
  2. build: nvcc compiles kernel K1 (csrc/condensed_fused.cu) into
     build/torch_kernels/;
  3. kernel vs plain at the cartpole shape (B = 4096): (a) cold, ct=1,
     alpha=1.7, no state bound; (b) ct=4; (c) the generic path with the
     constrained cartpole's state bound |x0| <= 2; (d) a 30 + 50 warm chain
     that must equal the kernel's own 80-iteration solve bit for bit;
  4. kernel vs plain at the quadrotor shape (B = 512), where T12 does not
     fit in shared memory;
  5. the main path through the API: TinyMPCSolver on "cuda",
     solve_batch(method="fused") at B = 65,536 and a return_carry/warm chain;
  6. the headline three-phase pipeline at B = 65,536 with 8,192 straggler
     slots, all fp32: convergence; the merged per-lane results (phase-2
     slots folded back into their lanes) and one phase-0 launch with its
     carry, each against the plain version; kernel vs plain times;
then the kernels' JSON line, the card's name and power limit, and the
result line.  Kernel launches are counted over phases 5 and 6 (their first,
untimed runs).  The agreement bar of every kernel-vs-plain comparison:
identical per-lane iteration counts on >= 99% of lanes (fp32 sums in another
order may move a lane that sits on the tolerance by one check interval) and
1e-4 on the controls and states of lanes with equal counts that both
solved, and on the carry, where there is one, of lanes with equal counts.
"""
import json
import subprocess
import time

import numpy as np
import torch

B_MAIN = 65536
SLOTS = 8192
B_CHECK = 4096
B_QUAD = 512
ITERS_AGREE = 0.99
ATOL = 1e-4


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def event_ms(fn):
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def paired_ms(f_kernel, f_plain, reps=5):
    """Median ms of each over ``reps`` turns after one warm-up each, the
    order alternating (plain, kernel, kernel, plain, ...)."""
    f_plain()
    f_kernel()
    tk, tp = [], []
    for r in range(reps):
        if r % 2 == 0:
            tp.append(event_ms(f_plain))
            tk.append(event_ms(f_kernel))
        else:
            tk.append(event_ms(f_kernel))
            tp.append(event_ms(f_plain))
    return float(np.median(tk)), float(np.median(tp))


def agreement(name, out_k, out_p, min_solved=None):
    """Per-lane agreement of kernel and plain results; returns max |diff|.
    At least ``min_solved`` lanes (default half the batch) must solve."""
    xk, uk, ik, sk = out_k[:4]
    xp, up, ip, sp = out_p[:4]
    B = ik.numel()
    min_solved = B // 2 if min_solved is None else min_solved
    same = ik == ip
    frac = same.float().mean().item()
    both = same & (sk == 1) & (sp == 1)
    err = 0.0
    if bool(both.any()):
        err = max((uk - up).abs()[both].max().item(),
                  (xk - xp).abs()[both].max().item())
    nk, npl = int(sk.sum()), int(sp.sum())
    print(f"{name}: iteration counts equal on {int(same.sum())}/{B} lanes "
          f"({frac:.4f}); solved kernel {nk}, plain {npl}; max |diff| on "
          f"equal solved lanes {err:.3e}", flush=True)
    check(frac >= ITERS_AGREE, f"{name}: counts agree on {frac:.4f} < "
          f"{ITERS_AGREE}")
    check(err <= ATOL, f"{name}: max |diff| {err:.3e} > {ATOL}")
    check(nk >= min_solved, f"{name}: only {nk}/{B} lanes solved")
    check(bool(torch.isfinite(uk).all()) and bool(torch.isfinite(xk).all()),
          f"{name}: non-finite kernel output")
    return err


def carry_agreement(name, same, carry_k, carry_p):
    """Max |diff| of the carries' fields on lanes with equal counts."""
    err = max((a - b)[:, same].abs().max().item()
              for a, b in zip(carry_k, carry_p))
    print(f"{name}: carry max |diff| on {int(same.sum())} lanes with equal "
          f"counts {err:.3e}", flush=True)
    check(err <= ATOL, f"{name}: carry max |diff| {err:.3e} > {ATOL}")
    return err


def pipeline_lanes(res):
    """(xs, us, final iteration count, solved) per lane of a pipeline
    result, with each valid phase-2 slot merged back into its lane."""
    it, ok = res.iters1.clone(), res.solved1.clone()
    lanes = res.idx[res.valid]
    it[lanes] += res.iters2[res.valid]
    ok[lanes] = res.solved2[res.valid]
    return res.xs, res.us, it, ok


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi()
    print(f"phase 1 env: torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} device(s), "
          f"card {card}", flush=True)

    from tinympc_julia_tpu_torch import TinyMPCSolver, make_problem
    from tinympc_julia_tpu_torch.models import cartpole, quadrotor
    from tinympc_julia_tpu_torch.ops.condensed import build_condensed
    from tinympc_julia_tpu_torch.ops.cuda._build import load_library
    from tinympc_julia_tpu_torch.ops.cuda.condensed_kernel import (
        condensed_fused_cuda, condensed_fused_reference, fused_tile_plan)
    from tinympc_julia_tpu_torch.ops.riccati import precompute_cache
    from tinympc_julia_tpu_torch.parallel.pipeline import three_phase_solve

    t0 = time.perf_counter()
    built = load_library("condensed_fused")
    ptxas = " | ".join(l.strip() for l in built.log.splitlines()
                       if "registers" in l or "spill" in l)
    print(f"phase 2 build: {built.path.name} in {built.seconds:.1f} s of nvcc "
          f"({time.perf_counter() - t0:.1f} s with loading); ptxas: {ptxas}",
          flush=True)

    dev = torch.device("cuda")
    f32 = torch.float32
    N = cartpole.HORIZON

    def plant(mod, ub, rho, x_bound=None):
        kw = {}
        if x_bound is not None:
            xb = np.tile(x_bound, (N, 1))
            kw = dict(x_min=-xb, x_max=xb)
        p = make_problem(mod.A, mod.B, np.diag(mod.Q_DIAG),
                         np.diag(mod.R_DIAG), rho, N, u_min=-ub, u_max=ub,
                         dtype=f32, device=dev, **kw)
        c = precompute_cache(p.A, p.B, p.Q, p.R, p.rho_setup)
        return p, c, build_condensed(p, c)

    def run_both(p, c, maps, x0s, warm=None, **kw):
        args = (maps, float(c.rho), p.u_min, p.u_max, p.x_min, p.x_max, x0s,
                warm)
        full = dict(nx=p.nx, nu=p.nu, N=N, abs_pri_tol=1e-3,
                    abs_dua_tol=1e-3, en_input_bound=True,
                    relaxation_alpha=1.7, warm_start=warm is not None,
                    carry_out=False)
        full.update(kw)
        return (condensed_fused_cuda(*args, **full),
                condensed_fused_reference(*args, **full))

    # -- phase 3: kernel vs plain at the cartpole shape ---------------------
    rng = np.random.default_rng(0)
    x0_check = torch.as_tensor(rng.uniform(-0.5, 0.5, size=(B_CHECK, 4)),
                               dtype=f32, device=dev)
    p, c, maps = plant(cartpole, 5.0, cartpole.RHO)
    p_c, c_c, maps_c = plant(cartpole, 5.0, cartpole.RHO,
                             x_bound=np.array([2.0, 1e17, 1e17, 1e17]))
    errs = []
    cases = (("a cold ct=1 alpha=1.7", p, c, maps, 1, False),
             ("b cold ct=4", p, c, maps, 4, False),
             ("c generic g path |x0|<=2", p_c, c_c, maps_c, 4, True))
    for name, pp, cc, mm, ct, sb in cases:
        out_k, out_p = run_both(pp, cc, mm, x0_check, max_iter=400,
                                check_termination=ct, en_state_bound=sb)
        errs.append(agreement(f"phase 3{name}", out_k, out_p))
    chain_kw = dict(check_termination=1, en_state_bound=False)
    args = (maps, float(c.rho), p.u_min, p.u_max, p.x_min, p.x_max, x0_check)
    base = dict(nx=4, nu=1, N=N, abs_pri_tol=1e-3, abs_dua_tol=1e-3,
                en_input_bound=True, relaxation_alpha=1.7, **chain_kw)
    one = condensed_fused_cuda(*args, max_iter=80, warm_start=False,
                               carry_out=False, **base)
    xa, ua, ia, sa, carry = condensed_fused_cuda(
        *args, max_iter=30, warm_start=False, carry_out=True, **base)
    xb, ub, ib, sb_, = condensed_fused_cuda(
        *args, carry, max_iter=50, warm_start=True, carry_out=False, **base)
    done_a = (sa == 1)
    chain_it = torch.where(done_a, ia, 30 + ib)
    chain_ok = torch.maximum(sa, sb_)
    chain_u = torch.where(done_a[:, None, None], ua, ub)
    chain_x = torch.where(done_a[:, None, None], xa, xb)
    exact = (torch.equal(chain_it, one[2]) and torch.equal(chain_ok, one[3])
             and torch.equal(chain_u, one[1]) and torch.equal(chain_x, one[0]))
    print(f"phase 3d warm chain 30+50 vs one-shot 80: bit-exact {exact} "
          f"({int(done_a.sum())} lanes done in the first 30, "
          f"{int(one[3].sum())}/{B_CHECK} solved)", flush=True)
    check(exact, "the kernel's 30+50 warm chain differs from its 80-iteration "
          "solve")

    # -- phase 4: the quadrotor shape (T12 read from global memory) ---------
    qN = quadrotor.HORIZON
    assert qN == N
    pq, cq, mq = plant(quadrotor, quadrotor.U_HOVER_BOUND, quadrotor.RHO)
    tile_q, resident_q = fused_tile_plan(12, 4, qN)
    x0_q = torch.as_tensor(np.random.default_rng(1).uniform(
        -0.3, 0.3, size=(B_QUAD, 12)), dtype=f32, device=dev)
    out_k, out_p = run_both(pq, cq, mq, x0_q, max_iter=1000,
                            check_termination=4, en_state_bound=False)
    errs.append(agreement(
        f"phase 4 quadrotor (sw=316, tile {tile_q}, T12 in shared "
        f"memory: {resident_q})", out_k, out_p))

    # -- phase 5: the main path through the API -----------------------------
    condensed_fused_cuda.launches = 0
    x0_main = torch.as_tensor(
        np.random.default_rng(0).uniform(-0.5, 0.5, size=(B_MAIN, 4)),
        dtype=f32, device=dev)
    solver = TinyMPCSolver(dtype=f32, device="cuda")
    solver.setup(cartpole.A, cartpole.B, None, np.diag(cartpole.Q_DIAG),
                 np.diag(cartpole.R_DIAG), cartpole.RHO, 4, 1, N)
    solver.set_bound_constraints(np.full((4, N), -1e17),
                                 np.full((4, N), 1e17),
                                 np.full((1, N - 1), -5.0),
                                 np.full((1, N - 1), 5.0))
    solver.update_settings(relaxation_alpha=1.7, check_termination=4,
                           max_iter=400)
    xs, us, it, ok = solver.solve_batch(x0_main, method="fused")
    torch.cuda.synchronize()
    n_api = int(ok.sum())
    check(tuple(us.shape) == (B_MAIN, N - 1, 1), f"controls {us.shape}")
    check(bool(torch.isfinite(us).all()) and bool(torch.isfinite(xs).all()),
          "non-finite API solutions")
    check(float(us.abs().max()) <= 5.0 + 1e-5, "|u| beyond its bound")
    solver.update_settings(max_iter=200)
    r1 = solver.solve_batch(x0_main, method="fused", return_carry=True)
    r2 = solver.solve_batch(x0_main, method="fused", warm=r1[4])
    d1 = r1[3] == 1
    ch_it = torch.where(d1, r1[2], 200 + r2[2])
    ch_u = torch.where(d1[:, None, None], r1[1], r2[1])
    api_exact = torch.equal(ch_it, it) and torch.equal(ch_u, us)
    print(f"phase 5 API solve_batch(method='fused') B={B_MAIN}: {n_api} "
          f"converged ({100.0 * n_api / B_MAIN:.2f}%), mean iterations "
          f"{it.float().mean().item():.1f}; 200+200 warm chain equals the "
          f"400-iteration solve: {api_exact}", flush=True)
    check(n_api > B_MAIN // 2, f"API solve converged {n_api}/{B_MAIN}")
    check(condensed_fused_cuda.launches == 3, "the API's three fused solves "
          f"launched K1 {condensed_fused_cuda.launches} times, not 3")
    check(api_exact, "API warm chain differs from the one-shot solve")

    # -- phase 6: the headline three-phase pipeline --------------------------
    pipe_args = (maps, float(c.rho), p.u_min, p.u_max, p.x_min, p.x_max,
                 x0_main)
    pkw = dict(nx=4, nu=1, N=N, straggler_slots=SLOTS)
    res = three_phase_solve(*pipe_args, **pkw)
    torch.cuda.synchronize()
    launches = condensed_fused_cuda.launches
    check(launches >= 6, f"kernel K1 launched {launches} times on the main "
          "path (expected >= 6: 3 API solves and 3 pipeline phases)")
    n_conv = int(res.converged())
    n_strag = int(res.unconv.sum())
    total_iters = int(res.total_iters(56))
    res_p = three_phase_solve(*pipe_args, fused=condensed_fused_reference,
                              **pkw)
    n_conv_p = int(res_p.converged())
    same1 = (res.iters1 == res_p.iters1).float().mean().item()
    check(n_conv >= 0.99 * B_MAIN, f"pipeline converged {n_conv}/{B_MAIN}")
    check(abs(n_conv - n_conv_p) <= 0.01 * B_MAIN,
          f"pipeline converged {n_conv} with the kernel, {n_conv_p} plain")
    check(same1 >= ITERS_AGREE, f"phase-1 counts agree on {same1:.4f} only")
    errs.append(agreement("phase 6 pipeline, merged per-lane results vs "
                          "plain", pipeline_lanes(res), pipeline_lanes(res_p)))

    k0 = dict(nx=4, nu=1, N=N, max_iter=56, abs_pri_tol=1e-3,
              abs_dua_tol=1e-3, en_state_bound=False, en_input_bound=True,
              relaxation_alpha=1.7, check_termination=56, warm_start=False,
              carry_out=True)
    out_k = condensed_fused_cuda(*pipe_args, **k0)
    out_p = condensed_fused_reference(*pipe_args, **k0)
    errs.append(agreement("phase 6 phase-0 launch (cold, 56 iterations) vs "
                          "plain", out_k, out_p, min_solved=0))
    errs.append(carry_agreement("phase 6 phase-0 launch", out_k[2] == out_p[2],
                                out_k[4], out_p[4]))

    t_pipe, t_pipe_p = paired_ms(
        lambda: three_phase_solve(*pipe_args, **pkw),
        lambda: three_phase_solve(*pipe_args, fused=condensed_fused_reference,
                                  **pkw))
    t_k1, t_k1_p = paired_ms(
        lambda: condensed_fused_cuda(*pipe_args, **k0),
        lambda: condensed_fused_reference(*pipe_args, **k0))
    print(f"phase 6 pipeline B={B_MAIN}, {SLOTS} slots, fp32 56/36/324: "
          f"{n_conv} converged ({100.0 * n_conv / B_MAIN:.2f}%; plain "
          f"{n_conv_p}), {n_strag} stragglers, {total_iters} ADMM "
          f"iterations; phase-1 counts equal on {same1:.4f} of lanes; "
          f"median of 5: kernel {t_pipe:.3f} ms, plain {t_pipe_p:.3f} ms -> "
          f"{n_conv / (t_pipe * 1e-3):.0f} solves/s on {card}; one K1 "
          f"launch (phase-0 shape) {t_k1:.3f} ms, plain {t_k1_p:.3f} ms",
          flush=True)

    print(json.dumps({"kernels": [{
        "name": "condensed_fused (K1)", "route": "cuda",
        "source": "tinympc_julia_tpu_torch/csrc/condensed_fused.cu",
        "replaces": "tinympc_julia_tpu/ops/pallas/condensed_kernel.py:232",
        "launches": launches, "max_abs_err": max(errs), "ms": t_k1,
        "plain_ms": t_k1_p}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
