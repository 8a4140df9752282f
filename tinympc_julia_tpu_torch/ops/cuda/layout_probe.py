"""Timing probes of kernels K1's and K2's wide-map layouts and of K3's far
layout on one NVIDIA GPU (not run by the tests or by chip_smoke.py):

    python -m tinympc_julia_tpu_torch.ops.cuda.layout_probe [wide|cluster|far]

``wide`` times the layouts the plans take at the wide maps of
chip_smoke.py's phases 34a, 34d and 35a, each beside its product
yardstick; ``cluster`` times the cluster layouts against the layouts they
replace at those shapes and at the switch's widths (ROADMAP R11), each
held bit for bit against the plan's launch; ``far`` times K3's far layout
at chip_smoke.py's phase 37b shapes beside its bounds, and against the near
layout where both run.  All print only.
``product_yardstick`` is also chip_smoke.py's yardstick."""
from __future__ import annotations

import argparse
import functools

import numpy as np
import torch

from ...utils.precision import full_fp32_matmul


def event_ms(fn):
    """One call of ``fn`` timed with CUDA events, ms."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def quad_problem(horizon, dev, x_bound=None):
    """The quadrotor at ``horizon`` (|u| <= 0.5, and |x| <= ``x_bound``
    where given) on ``dev`` in float32: (problem, cache)."""
    from tinympc_julia_tpu_torch import make_problem
    from tinympc_julia_tpu_torch.models import quadrotor
    from tinympc_julia_tpu_torch.ops.riccati import precompute_cache
    kw = {}
    if x_bound is not None:
        kw = dict(x_min=np.full((horizon, 12), -x_bound),
                  x_max=np.full((horizon, 12), x_bound))
    p = make_problem(quadrotor.A, quadrotor.B, np.diag(quadrotor.Q_DIAG),
                     np.diag(quadrotor.R_DIAG), quadrotor.RHO, horizon,
                     u_min=-0.5, u_max=0.5, dtype=torch.float32, device=dev,
                     **kw)
    return p, precompute_cache(p.A, p.B, p.Q, p.R, p.rho_setup)


def product_yardstick(shapes, lanes, tile_iters, tiles):
    """One iteration's products over the whole batch, each one torch.matmul
    in full fp32 ((rows, k) @ (k, ``lanes``) for each (rows, k) of
    ``shapes``; median of 3 CUDA-event timings after a warm-up), times the
    iterations the launch's tiles ran on average (``tile_iters`` summed
    over ``tiles``): what the products alone take on cuBLAS.  A yardstick
    only; the port never calls it."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    mats = [(torch.randn(r, k, device="cuda", generator=gen),
             torch.randn(k, lanes, device="cuda", generator=gen))
            for r, k in shapes]

    def run():
        for a, b in mats:
            torch.matmul(a, b)

    with full_fp32_matmul():
        run()
        t = float(np.median([event_ms(run) for _ in range(3)]))
    return t * tile_iters / tiles


def wide_layout_probe(reps=3):
    """The wide-map layouts of K1 and K2 timed alone at the shapes of
    phases 34a, 34d and 35a (CUDA events, median of ``reps`` after a
    warm-up), each with its plan, its blocks an SM or clusters at once
    from the occupancy API, and its product yardstick.  Returns {label:
    ms}."""
    from tinympc_julia_tpu_torch.ops.condensed import (build_condensed,
                                                       build_condensed_taylor)
    from tinympc_julia_tpu_torch.ops.cuda import adaptive_kernel as K2
    from tinympc_julia_tpu_torch.ops.cuda import condensed_kernel as K
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}

    def timed(label, f, plan, occ, tiles, tile_iters, shapes, lanes):
        f()
        t = float(np.median([event_ms(f) for _ in range(reps)]))
        y = product_yardstick(shapes, lanes, tile_iters, tiles)
        print(f"wide probe {label}: {t:.3f} ms; product yardstick "
              f"{y:.3f} ms; {tile_iters} tile iterations over {tiles} "
              f"tiles; blocks an SM {occ}; {plan}", flush=True)
        out[label] = t

    x_gen = np.random.default_rng(34)
    for N_, B, iters in ((150, 8192, 100), (387, 4096, 50)):
        p, c = quad_problem(N_, dev)
        m = build_condensed(p, c)
        sw = m.T12.shape[0]
        x0 = torch.as_tensor(x_gen.uniform(-0.3, 0.3, (B, 12)),
                             dtype=torch.float32, device=dev)
        kw = dict(nx=12, nu=4, N=N_, max_iter=iters, abs_pri_tol=1e-3,
                  abs_dua_tol=1e-3, en_state_bound=False,
                  en_input_bound=True, relaxation_alpha=1.7,
                  check_termination=1, warm_start=False, carry_out=False)
        f = functools.partial(K.condensed_fused_cuda, m, float(c.rho),
                              p.u_min, p.u_max, p.x_min, p.x_max, x0, None,
                              **kw)
        plan = K.fused_tile_plan(12, 4, N_, busy_sms=K.card_busy_sms)
        res = f()
        tiles = -(-B // K.TILE)
        occ = K.tile_occupancy(plan)
        timed(f"K1 N={N_} B={B} {iters} iterations", f, plan,
              f"{occ} (clusters at once)" if plan.cluster > 1 else occ,
              tiles,
              K.tile_iterations(res[2], K.TILE), [(sw, sw)], B)
        del m, f, res
    for N_ in (150, 213):
        p, c = quad_problem(N_, dev)
        tm = build_condensed_taylor(p, c)
        sw, su = tm.T1s.shape[-2], 4 * (N_ - 1)
        x0 = torch.as_tensor(x_gen.uniform(-0.3, 0.3, (2048, 12)),
                             dtype=torch.float32, device=dev)
        kw = dict(plant=None, nx=12, nu=4, N=N_, max_iter=150,
                  abs_pri_tol=1e-3, abs_dua_tol=1e-3, en_state_bound=False,
                  en_input_bound=True, relaxation_alpha=1.0,
                  adaptive_rho_min=5.0, adaptive_rho_max=1e3,
                  adaptive_rho_clipping=True, check_termination=1,
                  controller="termination", taylor_trust=2.0,
                  warm_start=False, carry_out=False)
        f = functools.partial(K2.condensed_adaptive_cuda, tm, p.u_min,
                              p.u_max, p.x_min, p.x_max, x0, None, **kw)
        plan = K2.adaptive_tile_plan(12, 4, N_, 2, busy_sms=K2.card_busy_sms)
        res = f()
        occ = K2.adaptive_occupancy(plan)
        timed(f"K2 N={N_} B=2048 150 iterations", f, plan,
              f"{occ} (clusters at once)" if plan.cluster > 1 else occ,
              -(-2048 // plan.tile), K.tile_iterations(res[2], plan.tile),
              [(3 * sw, su + 13), (4 * su, sw + 1)], 2048)
        del tm, f, res
    print(f"wide probe: {sms} SMs", flush=True)
    return out


def cluster_probe(reps=3):
    """The cluster layouts of K1 and K2 beside the layouts they replace, in
    one process: each launch timed alone (CUDA events, median of ``reps``
    after a warm-up) and held bit for bit against the same launch on
    another layout.  K1 at the wide maps of phases 34a and 34d on the
    plan's cluster and on other cluster sizes, against w2 in global memory
    (fp32 and reduced); at N = 57, 75, 90, 99 the cluster and w2 in
    shared memory; K2 the same at phase 35a's N = 150 and 213 and at N =
    20, 76, 90, 133 against its iterates in shared memory.  Each line
    names the plan, its blocks an SM or clusters at once (the occupancy
    API).  Prints only; what the R11 switch and PERF.md's predictions are
    checked against."""
    from unittest import mock
    from tinympc_julia_tpu_torch.ops.condensed import (build_condensed,
                                                       build_condensed_taylor)
    from tinympc_julia_tpu_torch.ops.cuda import adaptive_kernel as K2
    from tinympc_julia_tpu_torch.ops.cuda import condensed_kernel as K
    dev = torch.device("cuda")
    x_gen = np.random.default_rng(34)

    def x0s(B):
        return torch.as_tensor(x_gen.uniform(-0.3, 0.3, (B, 12)),
                               dtype=torch.float32, device=dev)

    def time_plan(mod, name, plan, f):
        with mock.patch.object(mod, name, lambda *a, **k: plan):
            out = f()
            torch.cuda.synchronize()
            t = float(np.median([event_ms(f) for _ in range(reps)]))
        return out, t

    def describe(plan, occ):
        if plan.cluster > 1:
            return (f"cluster {plan.cluster} x {plan.rpt} rows a thread, "
                    f"{plan.smem} B, {occ} clusters at once")
        return f"{plan}, {occ} blocks an SM"

    def k1_case(N_, B, iters, kw, others):
        p, c = quad_problem(N_, dev)
        m = build_condensed(p, c)
        full = dict(nx=12, nu=4, N=N_, max_iter=iters, abs_pri_tol=1e-3,
                    abs_dua_tol=1e-3, en_state_bound=False,
                    en_input_bound=True, relaxation_alpha=1.7,
                    check_termination=1, warm_start=False, carry_out=False)
        full.update(kw)
        f = functools.partial(K.condensed_fused_cuda, m, float(c.rho),
                              p.u_min, p.u_max, p.x_min, p.x_max, x0s(B),
                              None, **full)
        reduced = bool(kw)
        plan = K.fused_tile_plan(12, 4, N_, reduced,
                                 busy_sms=K.card_busy_sms)
        base, t0 = time_plan(K, "fused_tile_plan", plan, f)
        print(f"cluster probe K1 N={N_} B={B} {iters} iterations {kw}: plan "
              f"{t0:.3f} ms ({describe(plan, K.tile_occupancy(plan))})",
              flush=True)
        for label, other in others:
            if other is None:
                continue
            out, t = time_plan(K, "fused_tile_plan", other, f)
            exact = all(torch.equal(a, b) for a, b in zip(out, base))
            print(f"cluster probe K1 N={N_}: {label} {t:.3f} ms, bit-equal "
                  f"{exact} ({describe(other, K.tile_occupancy(other))})",
                  flush=True)
        del m, f

    def k2_case(N_, B, kw, others):
        p, c = quad_problem(N_, dev)
        tm = build_condensed_taylor(p, c)
        full = dict(plant=None, nx=12, nu=4, N=N_, max_iter=150,
                    abs_pri_tol=1e-3, abs_dua_tol=1e-3,
                    en_state_bound=False, en_input_bound=True,
                    relaxation_alpha=1.0, adaptive_rho_min=5.0,
                    adaptive_rho_max=1e3, adaptive_rho_clipping=True,
                    check_termination=1, controller="termination",
                    taylor_trust=2.0, warm_start=False, carry_out=False)
        full.update(kw)
        f = functools.partial(K2.condensed_adaptive_cuda, tm, p.u_min,
                              p.u_max, p.x_min, p.x_max, x0s(B), None,
                              **full)
        reduced = bool(kw)
        plan = K2.adaptive_tile_plan(12, 4, N_, 2, reduced,
                                     busy_sms=K2.card_busy_sms)
        base, t0 = time_plan(K2, "adaptive_tile_plan", plan, f)
        print(f"cluster probe K2 N={N_} B={B} {kw}: plan {t0:.3f} ms "
              f"({describe(plan, K2.adaptive_occupancy(plan))})", flush=True)
        for label, other in others:
            if other is None:
                continue
            out, t = time_plan(K2, "adaptive_tile_plan", other, f)
            exact = all(torch.equal(a, b) for a, b in zip(out, base))
            print(f"cluster probe K2 N={N_}: {label} {t:.3f} ms, bit-equal "
                  f"{exact} ({describe(other, K2.adaptive_occupancy(other))})",
                  flush=True)
        del tm, f

    # the clusters the card holds at once for each size, at one block an SM
    for C in K.CLUSTER_SIZES:
        pl = K.cluster_tile_plan(12, 4, 150, blocks=C)
        if pl is not None:
            print(f"cluster probe: a cluster of {C} blocks of {pl.smem} B: "
                  f"{K.tile_occupancy(pl)} at once", flush=True)
    lo = dict(precision="default", check_termination=5)
    for N_, B, iters, alt in ((150, 8192, 100, (4, 6, 8)),
                              (387, 4096, 50, (8,))):
        k1_case(N_, B, iters, {},
                [("w2 in global memory", K.global_tile_plan(12, 4, N_))]
                + [(f"cluster of {C}", K.cluster_tile_plan(12, 4, N_,
                                                            blocks=C))
                   for C in alt])
    k1_case(150, 2048, 20, lo, [("w2 in global memory", K.global_tile_plan(12, 4, 150, True))])
    for N_ in (57, 75, 90, 99):
        k1_case(N_, 8192, 100, {},
                [("the cluster", K.cluster_tile_plan(12, 4, N_)),
                 ("w2 in shared memory", K.shared_tile_plan(12, 4, N_))])
    for N_, alt in ((150, (4, 6, 8)), (213, (8,))):
        k2_case(N_, 2048, {},
                [("iterates in global memory", K2.global_adaptive_plan(12, 4, N_, 2))]
                + [(f"cluster of {C}", K2.cluster_adaptive_plan(
                    12, 4, N_, 2, blocks=C)) for C in alt])
    k2_case(150, 2048, lo, [("iterates in global memory",
                             K2.global_adaptive_plan(12, 4, 150, 2, True))])
    for N_ in (20, 76, 90, 133):
        k2_case(N_, 2048, {},
                [("the cluster", K2.cluster_adaptive_plan(12, 4, N_, 2)),
                 ("iterates in shared memory", K2.shared_adaptive_plan(
                     12, 4, N_, 2))]
                + [(f"cluster of {C}", K2.cluster_adaptive_plan(
                    12, 4, N_, 2, blocks=C)) for C in (2, 4) if N_ > 20])


def slot_makespan(iters, slots):
    """Iterations the busiest lane slot runs when ``slots`` slots take the
    lanes in order, each next lane going to the slot that frees first (the
    kernel's lane queue, every iteration of equal cost)."""
    import heapq
    its = [int(v) for v in iters.tolist()]
    heap = its[:slots]
    heapq.heapify(heap)
    for v in its[slots:]:
        heapq.heappush(heap, heapq.heappop(heap) + v)
    return max(heap)


def far_layout_probe(reps=3, N_far=300, B=16384, iters=100):
    """K3's far layout (the workspace in global memory) at chip_smoke.py's
    phase 37b shapes: each K3 instance's registers and spills (``-Xptxas
    -v``, when this process builds the library), each plan with its blocks
    and warps an SM (the occupancy API) and the grid's lane slots; the far
    launch at the quadrotor's N = ``N_far`` (free and |x| <= 2, ``B`` lanes,
    ``iters`` iterations, phase 37b's x0) timed alone (CUDA events, median
    of ``reps`` after a warm-up) beside its FLOP bound (67 TFLOP/s), its
    workspace-stream floor (each lane-iteration's ``lane_floats`` read once
    and written once at 3.35 TB/s) and its busiest slot's iterations; and
    at N = 173 with |x| <= 2 the near layout and the far one forced, timed
    the same way and held bit for bit.  Returns {label: ms}."""
    from unittest import mock
    from tinympc_julia_tpu_torch.ops.cuda import fused as K3
    from tinympc_julia_tpu_torch.ops.cuda._build import (load_library,
                                                         ptxas_usage)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    built = load_library("fused_stage")
    for mangled, use in ptxas_usage(built.log).items():
        print(f"far probe ptxas: {K3.variant_label(mangled)}: "
              f"{use.registers} registers, {use.spill_stores} / "
              f"{use.spill_loads} bytes spill stores / loads, "
              f"{use.stack_bytes} bytes stack", flush=True)
    out = {}

    def far_plan(N_, box, lanes=B):
        """The far layout at this shape as a launch takes it, forced where
        the near one fits (a tree without ``launch_plan``: the layout
        without a ring)."""
        if hasattr(K3, "launch_plan"):
            return K3.launch_plan(12, 4, N_, box, lanes, dev, far=True)
        plan = K3.fused_stage_plan(12, 4, N_, box, lanes, sms)
        if plan.workspace_global:
            return plan
        return plan._replace(smem=4 * K3.stage_floats(12, 4, N_, box),
                             workspace_global=True)

    def run(label, N_, box, plan, B=B):
        p, c = quad_problem(N_, dev, 2.0 if box else None)
        x0 = torch.as_tensor(np.random.default_rng(40).uniform(
            -0.3, 0.3, size=(B, 12)), dtype=torch.float32, device=dev)
        full = dict(nx=12, nu=4, N=N_, max_iter=iters, abs_pri_tol=1e-3,
                    abs_dua_tol=1e-3, en_state_bound=box,
                    en_input_bound=True, check_termination=1)
        f = functools.partial(K3.fused_cuda, p.A, p.B, p.f, p.Q, p.R, c.rho,
                              c.Kinf, c.Quu_inv, c.AmBKt, c.Pinf, p.x_min,
                              p.x_max, p.u_min, p.u_max, p.Xref, p.Uref, x0,
                              **full)
        with mock.patch.object(K3, "fused_stage_plan", lambda *a, **k: plan):
            res = f()
            torch.cuda.synchronize()
            t = float(np.median([event_ms(f) for _ in range(reps)]))
        occ = K3.stage_occupancy(plan, 12, 4, box)
        slots = min(-(-B // plan.tile), max(occ["blocks_per_sm"], 1) * sms) \
            * plan.tile
        lane_it = float(res[2].double().sum())
        flops = (N_ - 1) * (4 * 144 + 8 * 48 + 2 * 16) * lane_it
        floor = lane_it * 2 * K3.lane_floats(12, 4, N_, box) * 4 / 3.35e12
        span = slot_makespan(res[2], slots)
        print(f"far probe {label}: {t:.3f} ms; {lane_it:.0f} lane-iterations"
              f" (max {int(res[2].max())}, {int((res[3] == 1).sum())} of {B}"
              f" solved); busiest slot {span} iterations, "
              f"{1e3 * t / (span * (2 * N_ - 1)):.3f} us a stage step; FLOP "
              f"bound {1e3 * flops / 67e12:.3f} ms, stream floor "
              f"{1e3 * floor:.3f} ms; {plan}; {occ}, {slots} lane slots",
              flush=True)
        out[label] = t
        return res

    for box in (False, True):
        run(f"N={N_far} {'|x| <= 2' if box else 'free'} far", N_far, box,
            far_plan(N_far, box))
    # a light load: a lane's stage step with few lanes in flight
    run(f"N={N_far} free far, B=1024", N_far, False,
        far_plan(N_far, False, 1024), 1024)
    near_plan = K3.fused_stage_plan(12, 4, 173, True, B, sms)
    assert not near_plan.workspace_global
    near = run("N=173 |x| <= 2 near", 173, True, near_plan)
    far = run("N=173 |x| <= 2 far (forced)", 173, True, far_plan(173, True))
    print(f"far probe N=173: far bit-equal to near "
          f"{all(torch.equal(a, b) for a, b in zip(near, far))}", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("probe", nargs="?", choices=("wide", "cluster", "far"),
                    default="cluster")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("layout_probe: needs an NVIDIA GPU")
    dict(wide=wide_layout_probe, cluster=cluster_probe,
         far=far_layout_probe)[args.probe]()


if __name__ == "__main__":
    main()
