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
  7. K1's linear and cone projections (K1e) vs plain at B = 4096: (a) the
     rocket (box on u and x, thrust and glide-slope cones), cold, 72
     iterations with its carry; (b) the kernel's rocket 24 + 48 warm chain,
     which must equal its 72-iteration solve bit for bit; (c) the cartpole
     with two state halfspaces and no state box, 150 iterations; with the
     cones (within 5e-3) or halfspaces checked on every solved lane;
  8. the rocket main path through the API: rocket.make_solver on "cuda" in
     fp32 at B = 65,536, solve_batch(method="fused") for 24 iterations with
     its carry, then 48 warm; convergence, the merged per-lane results
     against the same chain on the plain version, the chain's time and one
     cold 72-iteration launch's, kernel vs plain;
  9. the single-instance solve() on the card: a 20-step float64 rocket
     closed loop against the same loop on the CPU (controls within 1e-6);
then the kernels' JSON line, the card's name and power limit, and the
result line.  K1's launches are counted over phases 5 and 6, K1e's (the
launches that run projections) over phase 8, each from 0 just before the
phase and on its first, untimed runs.  The agreement bar of every
kernel-vs-plain comparison: identical per-lane iteration counts on >= 99%
of lanes (fp32 sums in another order may move a lane that sits on the
tolerance by one check interval) and 1e-4 on the controls and states of
lanes with equal counts that both solved, and on the carry, where there is
one, of lanes with equal counts.
"""
import functools
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
CONE_TOL = 5e-3
LOOP_STEPS = 20
LOOP_ATOL = 1e-6


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


def cone_violation(xs, us, mu_x, mu_u, solved):
    """Largest excess of ||w[0:2]|| over mu * w[2] at any stage of a solved
    lane, over the state and the input cones."""
    ok = solved == 1
    ex = [(torch.linalg.vector_norm(w[ok][..., :2], dim=-1)
           - mu * w[ok][..., 2]).max().item()
          for w, mu in ((xs, mu_x), (us, mu_u)) if bool(ok.any())]
    return max(ex, default=0.0)


def rocket_chain(f, head=24, tail=48):
    """The rocket's 24-iteration cold solve with its carry, then a 48-
    iteration warm continuation; (xs, us, merged count, solved) per lane.
    ``f(max_iter, warm_start, carry_out, warm)`` runs one solve."""
    x0, u0, it0, ok0, carry = f(head, False, True, None)
    x1, u1, it1, ok1 = f(tail, True, False, carry)
    done = (ok0 == 1)
    return (torch.where(done[:, None, None], x0, x1),
            torch.where(done[:, None, None], u0, u1),
            torch.where(done, it0, head + it1), torch.maximum(ok0, ok1))


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
    from tinympc_julia_tpu_torch.models import cartpole, quadrotor, rocket
    from tinympc_julia_tpu_torch.ops.condensed import build_condensed
    from tinympc_julia_tpu_torch.ops.cuda._build import load_library
    from tinympc_julia_tpu_torch.ops.cuda.condensed_kernel import (
        condensed_fused_cuda, condensed_fused_reference, fused_constraints,
        fused_tile_plan, problem_constraint_kw)
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

    # -- phase 7: K1e, the projections, kernel vs plain ---------------------
    rN = rocket.HORIZON
    r_solver = rocket.make_solver(dtype=f32, device="cuda")
    Xref, Uref = rocket.reference_trajectory(0)
    r_solver.set_x_ref(Xref)
    r_solver.set_u_ref(Uref)
    rp, rc, rs = r_solver.problem, r_solver.cache, r_solver.settings
    r_maps = build_condensed(rp, rc)
    r_cons = fused_constraints(**problem_constraint_kw(rp, rs), nx=6, nu=3,
                               dtype=f32, device=dev)
    r_args = (r_maps, float(rc.rho), rp.u_min, rp.u_max, rp.x_min, rp.x_max)
    r_kw = dict(nx=6, nu=3, N=rN, abs_pri_tol=rs.abs_pri_tol,
                abs_dua_tol=rs.abs_dua_tol, en_state_bound=True,
                en_input_bound=True, relaxation_alpha=1.0,
                check_termination=1, constraints=r_cons)
    mu_x, mu_u = rocket.MU_STATE, rocket.MU_INPUT

    def rocket_x0(B):
        return torch.as_tensor(
            rocket.X_INIT[None, :]
            * np.random.default_rng(2).uniform(0.9, 1.1, size=(B, 1)),
            dtype=f32, device=dev)

    def rocket_solve(fn, x0s, max_iter, warm_start, carry_out, warm):
        return fn(*r_args, x0s, warm, max_iter=max_iter,
                  warm_start=warm_start, carry_out=carry_out, **r_kw)

    x0_r = rocket_x0(B_CHECK)
    e_errs = []
    out_k = rocket_solve(condensed_fused_cuda, x0_r, 72, False, True, None)
    out_p = rocket_solve(condensed_fused_reference, x0_r, 72, False, True,
                         None)
    e_errs.append(agreement("phase 7a rocket cold 72 (box + 2 cones)", out_k,
                            out_p))
    e_errs.append(carry_agreement("phase 7a rocket", out_k[2] == out_p[2],
                                  out_k[4], out_p[4]))
    viol = cone_violation(out_k[0], out_k[1], mu_x, mu_u, out_k[3])
    print(f"phase 7a rocket: largest cone excess on solved lanes "
          f"{viol:.3e} (bar {CONE_TOL})", flush=True)
    check(viol <= CONE_TOL, f"phase 7a: cone excess {viol:.3e}")
    xc, uc, itc, okc = rocket_chain(
        functools.partial(rocket_solve, condensed_fused_cuda, x0_r))
    exact = (torch.equal(itc, out_k[2]) and torch.equal(okc, out_k[3])
             and torch.equal(uc, out_k[1]) and torch.equal(xc, out_k[0]))
    print(f"phase 7b rocket warm chain 24+48 vs one-shot 72: bit-exact "
          f"{exact} ({int(okc.sum())}/{B_CHECK} solved)", flush=True)
    check(exact, "the kernel's rocket 24+48 chain differs from its "
          "72-iteration solve")

    A_lin = np.array([[1.0, 1.0, 0.0, 0.0], [0.0, 0.0, 1.0, 0.5]])
    b_lin = np.array([1.0, 0.8])
    h_cons = fused_constraints(lin_x=(A_lin, b_lin), nx=4, nu=1, dtype=f32,
                               device=dev)
    h_args = (maps, float(c.rho), p.u_min, p.u_max, p.x_min, p.x_max,
              x0_check, None)
    h_kw = dict(nx=4, nu=1, N=N, max_iter=150, abs_pri_tol=1e-3,
                abs_dua_tol=1e-3, en_state_bound=False, en_input_bound=True,
                relaxation_alpha=1.0, check_termination=1, warm_start=False,
                carry_out=True, constraints=h_cons)
    out_k = condensed_fused_cuda(*h_args, **h_kw)
    out_p = condensed_fused_reference(*h_args, **h_kw)
    e_errs.append(agreement("phase 7c cartpole 2 state halfspaces, no state "
                            "box", out_k, out_p))
    e_errs.append(carry_agreement("phase 7c cartpole", out_k[2] == out_p[2],
                                  out_k[4], out_p[4]))
    ok = out_k[3] == 1
    h_ex = (out_k[0][ok] @ torch.as_tensor(A_lin.T, dtype=f32, device=dev)
            - torch.as_tensor(b_lin, dtype=f32, device=dev)).max().item()
    print(f"phase 7c cartpole: largest halfspace excess on solved lanes "
          f"{h_ex:.3e} (bar {CONE_TOL})", flush=True)
    check(h_ex <= CONE_TOL, f"phase 7c: halfspace excess {h_ex:.3e}")

    # -- phase 8: the rocket main path through the API -----------------------
    x0_rm = rocket_x0(B_MAIN)
    condensed_fused_cuda.launches = 0
    condensed_fused_cuda.projected_launches = 0

    def api_solve(max_iter, warm_start, carry_out, warm):
        r_solver.update_settings(max_iter=max_iter)
        out = r_solver.solve_batch(x0_rm, method="fused", warm=warm,
                                   return_carry=carry_out)
        return out[:4] + ((out[4],) if carry_out else ())

    xs_a, us_a, it_a, ok_a = rocket_chain(api_solve)
    torch.cuda.synchronize()
    e_launches = condensed_fused_cuda.projected_launches
    check(e_launches == 2, f"the rocket API chain launched K1e {e_launches} "
          "times, not 2")
    n_rock = int(ok_a.sum())
    check(tuple(us_a.shape) == (B_MAIN, rN - 1, 3), f"controls {us_a.shape}")
    check(bool(torch.isfinite(us_a).all())
          and bool(torch.isfinite(xs_a).all()), "non-finite rocket solutions")
    check(n_rock >= 0.99 * B_MAIN, f"rocket chain converged {n_rock}/"
          f"{B_MAIN}")
    plain_chain = functools.partial(rocket_solve, condensed_fused_reference,
                                    x0_rm)
    kernel_chain = functools.partial(rocket_solve, condensed_fused_cuda,
                                     x0_rm)
    res_p = rocket_chain(plain_chain)
    e_errs.append(agreement("phase 8 rocket API chain 24+48, merged per-lane "
                            "results vs plain", (xs_a, us_a, it_a, ok_a),
                            res_p, min_solved=int(0.99 * B_MAIN)))
    viol = cone_violation(xs_a, us_a, mu_x, mu_u, ok_a)
    check(viol <= CONE_TOL, f"phase 8: cone excess {viol:.3e}")
    t_chain, t_chain_p = paired_ms(lambda: rocket_chain(kernel_chain),
                                   lambda: rocket_chain(plain_chain))
    cold = dict(max_iter=72, warm_start=False, carry_out=False)
    t_e, t_e_p = paired_ms(
        lambda: kernel_chain(warm=None, **cold),
        lambda: plain_chain(warm=None, **cold))
    # per-iteration cost of the projections: every lane runs all 72
    # iterations (one check, at the end), with and without the cones
    full = dict(r_kw, max_iter=72, check_termination=72, warm_start=False,
                carry_out=False)
    t_cones, t_box = paired_ms(
        lambda: condensed_fused_cuda(*r_args, x0_rm, None, **full),
        lambda: condensed_fused_cuda(*r_args, x0_rm, None,
                                     **dict(full, constraints=None)))
    print(f"phase 8 rocket API chain B={B_MAIN}, fp32 24+48: {n_rock} "
          f"converged ({100.0 * n_rock / B_MAIN:.2f}%), mean iterations "
          f"{it_a.float().mean().item():.2f}, largest cone excess "
          f"{viol:.3e}; median of 5: chain kernel {t_chain:.3f} ms, plain "
          f"{t_chain_p:.3f} ms -> {n_rock / (t_chain * 1e-3):.0f} solves/s "
          f"on {card}; one cold 72-iteration launch {t_e:.3f} ms, plain "
          f"{t_e_p:.3f} ms; 72 iterations on every lane: with the cones "
          f"{t_cones:.3f} ms, box only {t_box:.3f} ms "
          f"({t_cones / t_box:.3f}x per iteration)", flush=True)

    # -- phase 9: the single-instance solve() on the card, float64 -----------
    loops = [rocket.make_solver(dtype=torch.float64, device=d)
             for d in ("cuda", "cpu")]
    xs_loop = [rocket.X_INIT * 1.1, rocket.X_INIT * 1.1]
    its, du = [], 0.0
    t0 = time.perf_counter()
    for k in range(LOOP_STEPS):
        Xref, Uref = rocket.reference_trajectory(k)
        us_k = []
        for j, sv in enumerate(loops):
            sv.set_x0(xs_loop[j])
            sv.set_x_ref(Xref)
            sv.set_u_ref(Uref)
            sv.solve()
            us_k.append(sv.get_solution().controls[:, 0])
            xs_loop[j] = rocket.simulate(xs_loop[j], us_k[-1])
        its.append((int(loops[0].solution.iter), int(loops[1].solution.iter)))
        du = max(du, float(np.abs(us_k[0] - us_k[1]).max()))
    same_its = all(a == b for a, b in its)
    print(f"phase 9 solve() closed loop, {LOOP_STEPS} rocket steps in float64 "
          f"on the card vs the CPU ({time.perf_counter() - t0:.1f} s): "
          f"iterations per step (card, cpu) {its}; equal on every step "
          f"{same_its}; max |diff| of the controls {du:.3e}", flush=True)
    check(loops[0].state.x.is_cuda, "the card's solver state is not on the "
          "card")
    check(du <= LOOP_ATOL, f"phase 9: controls differ by {du:.3e}")

    print(json.dumps({"kernels": [{
        "name": "condensed_fused (K1), box path", "route": "cuda",
        "source": "tinympc_julia_tpu_torch/csrc/condensed_fused.cu",
        "replaces": "tinympc_julia_tpu/ops/pallas/condensed_kernel.py:232",
        "launches": launches, "max_abs_err": max(errs), "ms": t_k1,
        "plain_ms": t_k1_p}, {
        "name": "condensed_fused projections (K1e), constrained path",
        "route": "cuda",
        "source": "tinympc_julia_tpu_torch/csrc/condensed_fused.cu",
        "replaces": "tinympc_julia_tpu/ops/pallas/condensed_kernel.py:127",
        "launches": e_launches, "max_abs_err": max(e_errs), "ms": t_e,
        "plain_ms": t_e_p}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
