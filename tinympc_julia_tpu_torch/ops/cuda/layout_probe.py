"""Timing probes of kernels K1's and K2's wide-map layouts and of K3's far
layout on one NVIDIA GPU (not run by the tests or by chip_smoke.py):

    python -m tinympc_julia_tpu_torch.ops.cuda.layout_probe \
        [wide|cluster|far|stage]

``wide`` times the layouts the plans take at the wide maps of
chip_smoke.py's phases 34a, 34d and 35a, each beside its product
yardstick; ``cluster`` times the cluster layouts against the layouts they
replace at those shapes and at the switch's widths (ROADMAP R11), each
held bit for bit against the plan's launch; ``far`` times K3's far layout
at chip_smoke.py's phase 37b shapes beside its bounds, and against the near
layout where both run; ``stage`` splits K1e's projected stage pass (ROADMAP
R13) and K2's OSQP-form controller (R14) off the rest of their launches.
All print only.
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


def chain_plant(n=10, dt=0.5):
    """The 20-state chain of chip_smoke.py's phases 35-37 and of the
    ``stage`` probe: ``n`` unit masses in a line, unit springs between
    neighbours and to the two walls, the n - 1 inputs the tensions between
    neighbours; state (positions, velocities), zero-order hold at ``dt``.
    Returns (A (2n, 2n), B (2n, n - 1))."""
    from scipy.linalg import expm
    lap = 2 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)
    tension = np.eye(n, n - 1) - np.eye(n, n - 1, k=-1)
    m = np.zeros((3 * n - 1, 3 * n - 1))
    m[:n, n:2 * n] = np.eye(n)
    m[n:2 * n, :n] = -lap
    m[n:2 * n, 2 * n:] = tension
    e = expm(m * dt)
    return e[:2 * n, :2 * n], e[:2 * n, 2 * n:]


def digest(out) -> str:
    """The first 12 hex digits of the sha1 of a launch's results (every
    tensor's bytes in order): launches of two trees compare bit for bit."""
    import hashlib
    h = hashlib.sha1()
    for t in out:
        if isinstance(t, torch.Tensor):
            h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:12]


def stage_probe(reps=3):
    """K1e's projected stage pass split off the rest of its launches (ROADMAP
    R13), and K2's OSQP-form controller off the termination one (R14), at
    tolerances 0 so that no lane latches and every lane runs every
    iteration (CUDA events, median of ``reps`` after a warm-up, each with
    the digest of its results):

    * phase 36's launch (the 20-state chain, N = 20, B = 16,384, 200
      iterations, 10 state cones and 4 halfspace rows, the state box) and
      the rocket's cold 72-iteration launch at B = 65,536 (phase 8), each
      checking every iteration (ct = 1) and once at the end (ct =
      max_iter), each with its constraints and with ``constraints=None``
      (the box alone);
    * the K1 instances' registers and spill bytes (``-Xptxas -v``, when this
      process builds the library) and each launch's blocks an SM and shared
      memory;
    * K2 on phase 35b's chain (B = 4,096, 150 iterations) and at phase 35a's
      N = 90 (B = 2,048, 150 iterations, the cluster) under the OSQP-form
      and the termination controller.  Returns {label: ms}."""
    from tinympc_julia_tpu_torch import make_problem
    from tinympc_julia_tpu_torch.models import quadrotor, rocket
    from tinympc_julia_tpu_torch.ops.condensed import (build_condensed,
                                                       build_condensed_taylor)
    from tinympc_julia_tpu_torch.ops.cuda import adaptive_kernel as K2
    from tinympc_julia_tpu_torch.ops.cuda import condensed_kernel as K
    from tinympc_julia_tpu_torch.ops.cuda._build import (kernel_label,
                                                         load_libraries,
                                                         ptxas_usage)
    from tinympc_julia_tpu_torch.ops.riccati import precompute_cache
    dev, f32 = torch.device("cuda"), torch.float32
    for built in load_libraries(["condensed_fused", "condensed_adaptive"]):
        for mangled, use in sorted(ptxas_usage(built.log).items()):
            print(f"stage probe ptxas: {kernel_label(mangled)}: "
                  f"{use.registers} registers, {use.spill_stores} / "
                  f"{use.spill_loads} bytes spill stores / loads, "
                  f"{use.stack_bytes} bytes stack", flush=True)
    out = {}

    def timed(label, f, extra=""):
        res = f()
        torch.cuda.synchronize()
        t = float(np.median([event_ms(f) for _ in range(reps)]))
        print(f"stage probe {label}: {t:.3f} ms, digest {digest(res)}, "
              f"{int(res[2].double().sum())} lane-iterations{extra}",
              flush=True)
        out[label] = t
        return t

    def k1_split(name, maps, rho, p, x0, iters, cons, kw):
        nx, nu, N = p.nx, p.nu, p.N
        full = dict(nx=nx, nu=nu, N=N, max_iter=iters, abs_pri_tol=0.0,
                    abs_dua_tol=0.0, en_input_bound=True,
                    relaxation_alpha=1.0, warm_start=False, carry_out=False,
                    **kw)
        state_free = K._state_free(full["en_state_bound"], cons)
        plan = K.fused_tile_plan(nx, nu, N, state_free=state_free,
                                 busy_sms=K.card_busy_sms)
        proj_u = cons.lin_u is not None or cons.cones_u.num_cones > 0
        proj_x = cons.lin_x is not None or cons.cones_x.num_cones > 0
        dims = (nx if proj_x else 0, nu if proj_u else 0)
        # a parent tree without the staged constraint data takes the cones'
        # count in its place
        smem, shared = K.launch_smem(
            plan, *dims, K.constraint_bytes(cons, nx, nu)
            if hasattr(K, "constraint_bytes") else
            cons.cones_u.num_cones + cons.cones_x.num_cones)
        occ = K.tile_occupancy(plan, proj_u, proj_x, smem)
        print(f"stage probe {name}: plan {plan}; projected launch "
              f"{smem} B of shared memory, stage buffers in shared memory "
              f"{shared}, {occ} blocks an SM; box-only launch {plan.smem} "
              f"B, {K.tile_occupancy(plan)} blocks an SM", flush=True)
        args = (maps, rho, p.u_min.reshape(-1), p.u_max.reshape(-1),
                p.x_min.reshape(-1), p.x_max.reshape(-1), x0, None)
        t = {}
        for ct in (1, iters):
            for tag, c in (("", cons), (" box only", None)):
                f = functools.partial(K.condensed_fused_cuda, *args,
                                      check_termination=ct, constraints=c,
                                      **full)
                t[f"ct={ct}{tag}"] = timed(f"{name} ct={ct}{tag}", f)
        twice = t["ct=1"] - t["ct=1 box only"]
        once = t[f"ct={iters}"] - t[f"ct={iters} box only"]
        print(f"stage probe {name} split: the projections {twice:.3f} ms at "
              f"ct=1 ({twice / iters * 1e3:.2f} us an iteration), "
              f"{once:.3f} ms at ct={iters} ({once / iters * 1e3:.2f} us); "
              f"cones over box {t['ct=1'] / t['ct=1 box only']:.3f}x at "
              f"ct=1, {t[f'ct={iters}'] / t[f'ct={iters} box only']:.3f}x "
              f"at ct={iters}", flush=True)

    # phase 36: the chain, a state stage of 20 with 10 cones, 4 halfspaces
    A, Bm = chain_plant()
    xb = 3.0
    p = make_problem(A, Bm, np.eye(20), np.eye(9), 1.0, 20, u_min=-1.0,
                     u_max=1.0, x_min=np.full((20, 20), -xb),
                     x_max=np.full((20, 20), xb), dtype=f32, device=dev)
    c = precompute_cache(p.A, p.B, p.Q, p.R, p.rho_setup)
    rng = np.random.default_rng(11)
    cons = K.fused_constraints(
        soc_x=tuple((2 * j, 2, 0.5) for j in range(10)),
        lin_x=(rng.normal(size=(4, 20)), np.full(4, 5.0)), nx=20, nu=9,
        dtype=f32, device=dev)
    x0 = torch.as_tensor(0.5 * np.random.default_rng(38).standard_normal(
        (16384, 20)), dtype=f32, device=dev)
    k1_split("phase 36 chain N=20 B=16384", build_condensed(p, c),
             float(c.rho), p, x0, 200, cons, dict(en_state_bound=True))
    # phase 8: the rocket's cold launch
    from tinympc_julia_tpu_torch.ops.cuda.condensed_kernel import \
        problem_constraint_kw
    solver = rocket.make_solver(dtype=f32, device=dev)
    Xref, Uref = rocket.reference_trajectory(0)
    solver.set_x_ref(Xref)
    solver.set_u_ref(Uref)
    rp, rc, rs = solver.problem, solver.cache, solver.settings
    r_cons = K.fused_constraints(**problem_constraint_kw(rp, rs), nx=6,
                                 nu=3, dtype=f32, device=dev)
    x0 = torch.as_tensor(rocket.X_INIT[None, :] * np.random.default_rng(
        2).uniform(0.9, 1.1, size=(65536, 1)), dtype=f32, device=dev)
    k1_split("phase 8 rocket cold B=65536", build_condensed(rp, rc),
             float(rc.rho), rp, x0, 72, r_cons, dict(en_state_bound=True))

    # K2: the OSQP-form controller against the termination one
    def k2_split(name, p, c, x0, kw):
        tm = build_condensed_taylor(p, c)
        plant = K2.AdaptivePlant(p.A, p.B, p.Q, p.R, c.Pinf, c.dPinf_drho)
        base = dict(nx=p.nx, nu=p.nu, N=p.N, max_iter=150, abs_pri_tol=0.0,
                    abs_dua_tol=0.0, en_state_bound=False,
                    en_input_bound=True, relaxation_alpha=1.0,
                    adaptive_rho_clipping=True, check_termination=1,
                    taylor_trust=float("inf"), warm_start=False,
                    carry_out=False)
        base.update(kw)
        plan = K2.adaptive_tile_plan(p.nx, p.nu, p.N, 2,
                                     busy_sms=K2.card_busy_sms)
        t = {}
        for ctl in ("osqp", "termination"):
            f = functools.partial(K2.condensed_adaptive_cuda, tm, p.u_min,
                                  p.u_max, p.x_min, p.x_max, x0, None,
                                  plant=plant if ctl == "osqp" else None,
                                  controller=ctl, **base)
            t[ctl] = timed(f"{name} {ctl}", f)
        print(f"stage probe {name} split: the OSQP-form controller "
              f"{t['osqp'] - t['termination']:.3f} ms over the termination "
              f"one ({t['osqp'] / t['termination']:.3f}x); {plan}",
              flush=True)

    p = make_problem(A, Bm, np.eye(20), np.eye(9), 1.0, 20, u_min=-1.0,
                     u_max=1.0, dtype=f32, device=dev)
    c = precompute_cache(p.A, p.B, p.Q, p.R, p.rho_setup)
    x0 = torch.as_tensor(0.5 * np.random.default_rng(37).standard_normal(
        (4096, 20)), dtype=f32, device=dev)
    k2_split("phase 35b K2 chain N=20 B=4096", p, c, x0,
             dict(adaptive_rho_min=0.2, adaptive_rho_max=5.0))
    p = make_problem(quadrotor.A, quadrotor.B, np.diag(quadrotor.Q_DIAG),
                     np.diag(quadrotor.R_DIAG), quadrotor.RHO, 90,
                     u_min=-0.5, u_max=0.5, dtype=f32, device=dev)
    c = precompute_cache(p.A, p.B, p.Q, p.R, p.rho_setup)
    x0 = torch.as_tensor(np.random.default_rng(39).uniform(
        -0.3, 0.3, size=(2048, 12)), dtype=f32, device=dev)
    k2_split("phase 35a K2 quadrotor N=90 B=2048", p, c, x0,
             dict(adaptive_rho_min=3.0, adaptive_rho_max=1e3,
                  taylor_trust=2.0))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("probe", nargs="?", choices=("wide", "cluster", "far", "stage"),
                    default="cluster")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("layout_probe: needs an NVIDIA GPU")
    dict(wide=wide_layout_probe, cluster=cluster_probe,
         far=far_layout_probe, stage=stage_probe)[args.probe]()


if __name__ == "__main__":
    main()
