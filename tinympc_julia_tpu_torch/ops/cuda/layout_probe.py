"""Timing probes of kernels K1's and K2's wide-map layouts and of K3's far
layout on one NVIDIA GPU (not run by the tests or by chip_smoke.py):

    python -m tinympc_julia_tpu_torch.ops.cuda.layout_probe \
        [wide|cluster|far|stage|sections [--cartpole|--k2|--k1]|
         switch [--k2|--k1]|narrow|rows [--k1]|order]

``wide`` times the layouts the plans take at the wide maps of
chip_smoke.py's phases 34a, 34d and 35a, each beside its product
yardstick; ``cluster`` times the cluster layouts against the layouts they
replace at those shapes and at the switch's widths (ROADMAP R11), each
held bit for bit against the plan's launch; ``far`` times K3's far layout
at chip_smoke.py's phase 37b shapes beside its bounds, and against the near
layout where both run; ``stage`` splits K1e's projected stage pass (ROADMAP
R13) and K2's OSQP-form controller (R14) off the rest of their launches;
``sections`` splits a tile iteration of K1 and K2 between the product, its
ring, the elementwise step and the rest (ROADMAP R6, R5) on a probe build
with clock64() counters, at the continuations of the adaptive quadrotor
(with ``--cartpole``: at the cartpole's narrow-map launches,
``cartpole_cases``, each also on tiles of 32 forced; with ``--k2``: K2's
launches alone).  ``switch`` times the batch-aware plans' layouts on each
side of their switches (ROADMAP R5, R6); ``narrow`` K1's warp layout against tiles of 32 forced at the
cartpole's launches (ROADMAP R3); ``rows [--k1]`` times K2's (K1's)
launches of chip_smoke.py's kernels line on their plans with each one's
digest, so that runs of two trees in turns compare times and bits
(ROADMAP R17); ``order`` whether K1's differences from its plain version
at a wide map are the plain product's sum order (``order_probe``).
All print only.  ``product_yardstick`` is also
chip_smoke.py's yardstick, ``same_bits`` its comparison of layouts."""
from __future__ import annotations

import argparse
import contextlib
import ctypes
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


def quad_problem(horizon, dev, x_bound=None, dtype=torch.float32):
    """The quadrotor at ``horizon`` (|u| <= 0.5, and |x| <= ``x_bound``
    where given) on ``dev`` in ``dtype``: (problem, cache)."""
    from tinympc_julia_tpu_torch import make_problem
    from tinympc_julia_tpu_torch.models import quadrotor
    from tinympc_julia_tpu_torch.ops.riccati import precompute_cache
    kw = {}
    if x_bound is not None:
        kw = dict(x_min=np.full((horizon, 12), -x_bound),
                  x_max=np.full((horizon, 12), x_bound))
    p = make_problem(quadrotor.A, quadrotor.B, np.diag(quadrotor.Q_DIAG),
                     np.diag(quadrotor.R_DIAG), quadrotor.RHO, horizon,
                     u_min=-0.5, u_max=0.5, dtype=dtype, device=dev, **kw)
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
        the near one fits."""
        return K3.launch_plan(12, 4, N_, box, lanes, dev, far=True)

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
        smem, shared = K.launch_smem(plan, *dims,
                                     K.constraint_bytes(cons, nx, nu))
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


SECTION_NAMES = ("product", "ring waits", "bf16 product", "bf16 ring waits",
                 "epilogue", "elementwise step", "maxima and latch",
                 "maxima barrier", "rho prediction", "product barrier",
                 "other")


def continuation_cases(dev):
    """The launches of the adaptive quadrotor's continuations, from phase
    24's inputs (chip_smoke.py): K2's bulk pass (16,384 lanes, 150
    iterations, carry out), K2's warm continuation (its stragglers
    compacted into 2,048 slots, up to 2,500 iterations), the requantized
    K1d launch with K1c's 256-iteration head (3 buckets x 2,048 slots) and
    a bulk-sized K1d launch (the 3 buckets' maps cold over 3 x 16,384
    lanes, 150 iterations).  Returns {name: (module, wrapper's partial)}."""
    from tinympc_julia_tpu_torch import make_problem
    from tinympc_julia_tpu_torch.models import quadrotor
    from tinympc_julia_tpu_torch.ops.condensed import build_condensed_taylor
    from tinympc_julia_tpu_torch.ops.cuda import adaptive_kernel as K2
    from tinympc_julia_tpu_torch.ops.cuda import condensed_kernel as K
    from tinympc_julia_tpu_torch.ops.riccati import precompute_cache
    from tinympc_julia_tpu_torch.parallel.pipeline import (
        ADAPTIVE_BUDGETS, REQUANT_HEAD, requantized_buckets)
    from tinympc_julia_tpu_torch.parallel.rebuild import compact_members
    f32, qN, B, slots = torch.float32, quadrotor.HORIZON, 16384, 2048
    qp = make_problem(quadrotor.A, quadrotor.B, np.diag(quadrotor.Q_DIAG),
                      np.diag(quadrotor.R_DIAG), quadrotor.RHO, qN,
                      u_min=-quadrotor.U_HOVER_BOUND,
                      u_max=quadrotor.U_HOVER_BOUND, dtype=f32, device=dev)
    qc = precompute_cache(qp.A, qp.B, qp.Q, qp.R, qp.rho_setup)
    tqa = build_condensed_taylor(qp, qc)
    x0 = torch.as_tensor(np.random.default_rng(1).uniform(
        -0.3, 0.3, size=(B, 12)), dtype=f32, device=dev)
    rhos, bmaps = requantized_buckets(qp, qc)
    G = len(rhos)
    bounds = (qp.u_min, qp.u_max, qp.x_min, qp.x_max)
    bulk_kw = dict(plant=None, nx=12, nu=4, N=qN, max_iter=ADAPTIVE_BUDGETS[0],
                   abs_pri_tol=1e-3, abs_dua_tol=1e-3, en_state_bound=False,
                   en_input_bound=True, relaxation_alpha=1.0,
                   adaptive_rho_min=quadrotor.RHO, adaptive_rho_max=1e3,
                   adaptive_rho_clipping=True, check_termination=1,
                   controller="termination", taylor_trust=2.0,
                   warm_start=False, carry_out=True)
    bulk = functools.partial(K2.condensed_adaptive_cuda, tqa, *bounds, x0,
                             None, **bulk_kw)
    _, _, _, ok, _, carry = bulk()
    unconv = ok == 0
    idx = compact_members(unconv[None, :], slots)[0][0]
    cont = functools.partial(
        K2.condensed_adaptive_cuda, tqa, *bounds, x0[idx].contiguous(),
        K2.AdaptiveFusedCarry(*(w[:, idx].contiguous() for w in carry)),
        **dict(bulk_kw, max_iter=ADAPTIVE_BUDGETS[1], warm_start=True,
               carry_out=False))
    brho = torch.tensor(rhos, dtype=f32, device=dev)
    snap = torch.argmin(torch.abs(carry.rho[0][:, None] - brho[None, :]),
                        dim=1)
    m = unconv[None, :] & (snap[None, :] == torch.arange(G, device=dev)[
        :, None])
    gidx, _, valid, _ = compact_members(m, slots)
    gidx = gidx.reshape(-1)

    def gather(a):
        return torch.where(valid[None, :], a[:, gidx], 0.0).contiguous()

    w2 = torch.cat([carry.z - carry.y, carry.v - carry.g], dim=0)
    warm = K.FusedCarry(gather(w2), gather(carry.y), gather(carry.g),
                        gather(carry.v), gather(carry.z))
    x0s2 = torch.where(valid[:, None], x0[gidx], 0.0).contiguous()
    k1_kw = dict(nx=12, nu=4, N=qN, abs_pri_tol=1e-3, abs_dua_tol=1e-3,
                 en_state_bound=False, en_input_bound=True,
                 relaxation_alpha=1.0, check_termination=1, carry_out=False,
                 num_groups=G)
    requant = functools.partial(
        K.condensed_fused_cuda, bmaps, brho, *bounds, x0s2, warm,
        max_iter=ADAPTIVE_BUDGETS[1], warm_start=True,
        bf16_head_iters=REQUANT_HEAD, **k1_kw)
    x0g = torch.as_tensor(np.random.default_rng(2).uniform(
        -0.3, 0.3, size=(G * B, 12)), dtype=f32, device=dev)
    k1d_bulk = functools.partial(
        K.condensed_fused_cuda, bmaps, brho, *bounds, x0g, None,
        max_iter=150, warm_start=False, **k1_kw)
    return {"K2 bulk (16,384 lanes, 150 iterations)": (K2, bulk),
            "K2 continuation (2,048 slots)": (K2, cont),
            "K1d + K1c head requantized continuation (3 x 2,048 slots)":
                (K, requant),
            "K1d bulk-sized (3 x 16,384 lanes cold, 150 iterations)":
                (K, k1d_bulk)}


def cartpole_problem(dev, rho=None, x_bound=None):
    """The cartpole (|u| <= 5, and |x| <= ``x_bound`` where given) at its
    horizon on ``dev`` in float32: (problem, cache, maps)."""
    from tinympc_julia_tpu_torch import make_problem
    from tinympc_julia_tpu_torch.models import cartpole
    from tinympc_julia_tpu_torch.ops.condensed import build_condensed
    from tinympc_julia_tpu_torch.ops.riccati import precompute_cache
    N, kw = cartpole.HORIZON, {}
    if x_bound is not None:
        xb = np.tile(x_bound, (N, 1))
        kw = dict(x_min=-xb, x_max=xb)
    p = make_problem(cartpole.A, cartpole.B, np.diag(cartpole.Q_DIAG),
                     np.diag(cartpole.R_DIAG),
                     cartpole.RHO if rho is None else rho, N, u_min=-5.0,
                     u_max=5.0, dtype=torch.float32, device=dev, **kw)
    c = precompute_cache(p.A, p.B, p.Q, p.R, p.rho_setup)
    return p, c, build_condensed(p, c)


def mpc_launch(dev, B=8192, step=1, seed=3):
    """The warm K1 launch of step ``step`` of chip_smoke.py's phase 20 (the
    fused MPC loop: the cartpole, alpha 1.7, 100 iterations, ct 1, the
    carry out) on its first ``B`` plants, its earlier steps run on the
    kernel: the wrapper's partial."""
    from tinympc_julia_tpu_torch.ops.cuda import condensed_kernel as K
    from tinympc_julia_tpu_torch.parallel.mpc import _plant_step
    from tinympc_julia_tpu_torch.utils.precision import full_fp32_matmul
    p, c, maps = cartpole_problem(dev)
    x = torch.as_tensor(np.random.default_rng(seed).uniform(
        -0.5, 0.5, size=(8192, 4))[:B], dtype=torch.float32, device=dev)
    args = (maps, c.rho, p.u_min, p.u_max, p.x_min, p.x_max)
    kw = dict(nx=4, nu=1, N=p.N, max_iter=100, abs_pri_tol=1e-3,
              abs_dua_tol=1e-3, en_state_bound=False, en_input_bound=True,
              relaxation_alpha=1.7, check_termination=1, carry_out=True)
    warm = None
    with full_fp32_matmul():
        for t in range(step):
            _, us, _, _, warm = K.condensed_fused_cuda(
                *args, x, warm, warm_start=t > 0, **kw)
            x = _plant_step(p, x, us[:, 0, :]).contiguous()
    return functools.partial(K.condensed_fused_cuda, *args, x, warm,
                             warm_start=True, **kw)


def misset_launch(dev, slots=4096):
    """chip_smoke.py's phase 22 phase-2 launch: the mis-set cartpole (rho0
    0.01, |x_0| <= 2, seed 5), K1d over 5 buckets of ``slots`` slots warm
    from the kernel's 50-iteration phase 1, compacted as the pipeline does
    (a pad slot: zero carry, zero x0), up to 450 iterations: the
    wrapper's partial and the slots' validity."""
    from tinympc_julia_tpu_torch import Settings
    from tinympc_julia_tpu_torch.ops.cuda import condensed_kernel as K
    from tinympc_julia_tpu_torch.parallel.rebuild import (
        bucket_maps, compact_members, default_bucket_rhos,
        predict_rho_bucketed)
    p, c, maps = cartpole_problem(dev, 0.01, np.array([2.0, 1e17, 1e17,
                                                       1e17]))
    span = (1e-4, 1e4)
    s = Settings(max_iter=500, en_state_bound=True, en_input_bound=True,
                 adaptive_rho_min=span[0], adaptive_rho_max=span[1])
    x0 = torch.as_tensor(np.random.default_rng(5).uniform(
        -1, 1, size=(4096, 4)) * np.array([1.8, 1.0, 0.4, 0.5]),
        dtype=torch.float32, device=dev)
    rhos = default_bucket_rhos(*span)
    G = len(rhos)
    bmaps = bucket_maps(p, c, rhos)
    fargs = (maps, float(c.rho), p.u_min, p.u_max, p.x_min, p.x_max, x0)
    fn1 = K.make_condensed_fused_solver(
        4, 1, p.N, max_iter=50, carry_out=True, en_state_bound=True,
        en_input_bound=True)
    _, _, _, ok1, carry = fn1(*fargs)
    bucket, _ = predict_rho_bucketed(p, s, maps, carry, x0, float(c.rho),
                                     rhos)
    m = (ok1 == 0)[None, :] & (bucket[None, :] == torch.arange(
        G, device=dev)[:, None])
    idx, _, valid, _ = compact_members(m, slots)
    gidx = idx.reshape(-1)
    warm = K.FusedCarry(*(torch.where(valid[None, :], w[:, gidx], 0.0)
                          .contiguous() for w in carry))
    x0s2 = torch.where(valid[:, None], x0[gidx], 0.0).contiguous()
    brho = torch.tensor(rhos, dtype=torch.float32, device=dev)
    return functools.partial(
        K.condensed_fused_cuda, bmaps, brho, p.u_min, p.u_max, p.x_min,
        p.x_max, x0s2, warm, nx=4, nu=1, N=p.N, max_iter=450,
        abs_pri_tol=1e-3, abs_dua_tol=1e-3, en_state_bound=True,
        en_input_bound=True, relaxation_alpha=1.0, check_termination=1,
        warm_start=True, carry_out=False, num_groups=G), valid


def cartpole_cases(dev):
    """K1's launches on the cartpole's narrow map (sw 99) with
    chip_smoke.py's inputs: (a) phase 20's warm launch (8,192 plants,
    step 1 from step 0's carry, 100 iterations, alpha 1.7, ct 1, the carry
    out), (b) a late step of the same loop (step 50), (c) phase 22's
    phase-2 K1d launch (5 x 4,096 slots), (d) phase 6's cold phase-0 launch
    (65,536 lanes, 56 iterations, one check), the control.  Returns {name:
    (module, wrapper's partial)}."""
    from tinympc_julia_tpu_torch.ops.cuda import condensed_kernel as K
    p, c, maps = cartpole_problem(dev)
    x0 = torch.as_tensor(np.random.default_rng(0).uniform(
        -0.5, 0.5, size=(65536, 4)), dtype=torch.float32, device=dev)
    cold = functools.partial(
        K.condensed_fused_cuda, maps, float(c.rho), p.u_min, p.u_max,
        p.x_min, p.x_max, x0, None, nx=4, nu=1, N=p.N, max_iter=56,
        abs_pri_tol=1e-3, abs_dua_tol=1e-3, en_state_bound=False,
        en_input_bound=True, relaxation_alpha=1.7, check_termination=56,
        warm_start=False, carry_out=True)
    return {"(a) K1b MPC loop step 1 (8,192 plants)": (K, mpc_launch(dev)),
            "(b) K1b MPC loop step 50 (8,192 plants)":
                (K, mpc_launch(dev, step=50)),
            "(c) K1d mis-set cartpole phase 2 (5 x 4,096 slots)":
                (K, misset_launch(dev)[0]),
            "(d) K1 cold phase 0 (65,536 lanes, 56 iterations)": (K, cold)}


def narrow_cases(dev):
    """The warp layout's batch range on the cartpole: ``cartpole_cases``
    and cold and warm launches (100 iterations, ct 1, alpha 1.7, the carry
    out; warm: the MPC loop's step 1) at B = 1,024, 8,192 and 65,536, and
    a grouped cold launch over the 5 bucket maps of phase 22 at 4,096
    lanes each (20,480), with |x| <= 2: [(label, wrapper's partial,
    state_free)]."""
    from tinympc_julia_tpu_torch.ops.cuda import condensed_kernel as K
    from tinympc_julia_tpu_torch.parallel.rebuild import (
        bucket_maps, default_bucket_rhos)
    out = [(k, f, not k.startswith("(c)"))
           for k, (_, f) in cartpole_cases(dev).items()]
    p, c, maps = cartpole_problem(dev)
    kw = dict(nx=4, nu=1, N=p.N, max_iter=100, abs_pri_tol=1e-3,
              abs_dua_tol=1e-3, en_state_bound=False, en_input_bound=True,
              relaxation_alpha=1.7, check_termination=1, carry_out=True)
    for B in (1024, 8192, 65536):
        x0 = torch.as_tensor(np.random.default_rng(0).uniform(
            -0.5, 0.5, size=(B, 4)), dtype=torch.float32, device=dev)
        out.append((f"cold B={B}", functools.partial(
            K.condensed_fused_cuda, maps, float(c.rho), p.u_min, p.u_max,
            p.x_min, p.x_max, x0, None, warm_start=False, **kw), True))
        if B < 8192:
            out.append((f"warm B={B} (MPC step 1)", mpc_launch(dev, B),
                        True))
    pb, cb, _ = cartpole_problem(dev, 0.01, np.array([2.0, 1e17, 1e17,
                                                      1e17]))
    rhos = default_bucket_rhos(1e-4, 1e4)
    x0 = torch.as_tensor(np.random.default_rng(5).uniform(
        -1, 1, size=(len(rhos), 4096, 4)) * np.array([1.8, 1.0, 0.4, 0.5]),
        dtype=torch.float32, device=dev)
    out.append(("grouped cold 5 x 4,096, |x| <= 2", functools.partial(
        K.condensed_fused_cuda, bucket_maps(pb, cb, rhos),
        torch.tensor(rhos, dtype=torch.float32, device=dev), pb.u_min,
        pb.u_max, pb.x_min, pb.x_max, x0, None,
        **dict(kw, en_state_bound=True, relaxation_alpha=1.0,
               max_iter=450), warm_start=False, num_groups=len(rhos)),
        False))
    return out


def narrow_probe(reps=5):
    """The warp layout against tiles of 32 lanes forced (``narrow_cases``),
    in turns (warp, tiles, tiles, warp, ...: CUDA events, median of
    ``reps`` each after a warm-up), bit for bit, with the lanes' mean and
    largest counts, the lane groups' and tiles' iterations and the queue
    model's critical path; the build's ptxas lines first.  Prints only;
    returns {label: (warp ms, tiles ms)}."""
    from unittest import mock
    from tinympc_julia_tpu_torch.ops.cuda import condensed_kernel as K
    from tinympc_julia_tpu_torch.ops.cuda._build import (kernel_label,
                                                         load_library,
                                                         ptxas_usage)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    built = load_library("condensed_fused")
    print(f"narrow probe: {built.path.name} built in {built.seconds:.1f} s",
          flush=True)
    for mangled, use in sorted(ptxas_usage(built.log).items()):
        label = kernel_label(mangled)
        if "false, false" in label or "warp" in label:
            print(f"narrow probe ptxas: {label}: {use.registers} registers, "
                  f"{use.spill_stores} / {use.spill_loads} bytes spill "
                  "stores / loads", flush=True)
    out = {}
    for label, f, free in narrow_cases(dev):
        warp = K.warp_tile_plan(4, 1, 20, free)
        tiles = K.shared_tile_plan(4, 1, 20, False, free)

        def run(plan):
            with mock.patch.object(K, "fused_tile_plan",
                                   lambda *a, **k: plan):
                return f()
        rw, rt = run(warp), run(tiles)
        torch.cuda.synchronize()
        same = same_bits(rw, rt)
        diff = ""
        if not same:
            bad = (rw[2] != rt[2]) | (rw[3] != rt[3]) | (
                rw[1] != rt[1]).flatten(1).any(1) | (
                rw[0] != rt[0]).flatten(1).any(1)
            diff = (f" ({int(bad.sum())} lanes differ, first "
                    f"{bad.nonzero()[:4].flatten().tolist()}, largest x "
                    f"difference {float((rw[0] - rt[0]).abs().max()):.3e})")
        tw, tt = [], []
        for r in range(reps):
            if r % 2 == 0:
                tw.append(event_ms(lambda: run(warp)))
                tt.append(event_ms(lambda: run(tiles)))
            else:
                tt.append(event_ms(lambda: run(tiles)))
                tw.append(event_ms(lambda: run(warp)))
        t_w, t_t = float(np.median(tw)), float(np.median(tt))
        counts = rw[2]
        G = f.keywords.get("num_groups", 1)
        groups = K.tile_iterations(counts, K.WARP_LANES, G)
        n_tiles = K.tile_iterations(counts, K.TILE, G)
        per = -(-(counts.numel() // G) // K.WARP_LANES)
        lg = G * per
        blocks, warps = K.launch_warps(warp, per, sms, K.tile_occupancy(warp))
        state = K.state_floats(4, 1, 20, free) + (
            2 * 99 if f.keywords.get("carry_out") else 0)
        slots = sms * K.tile_occupancy(warp._replace(warps=warps),
                                       smem=K.warp_smem(99, state, warps))
        crit = K.queue_iterations(counts, G, blocks, warps, slots)
        print(f"narrow probe {label}: warp layout {t_w:.3f} ms, tiles of "
              f"32 forced {t_t:.3f} ms ({t_t / t_w:.3f}x), median of "
              f"{reps} in turns; bit-equal {same}{diff}; lanes' mean count "
              f"{counts.float().mean().item():.2f}, largest "
              f"{int(counts.max())}; lane-group iterations {groups} "
              f"({lg} groups, {blocks} blocks a group x {warps} warps, "
              f"{slots} at once, the queue model's critical path {crit}), "
              f"tile iterations {n_tiles}; "
              f"{t_w * 1e3 / max(crit, 1):.2f} us a critical-path "
              f"iteration", flush=True)
        out[label] = (t_w, t_t)
    return out


def _flat(out):
    """A launch's result tensors in order (a carry's fields included)."""
    for t in out:
        if isinstance(t, torch.Tensor):
            yield t
        elif t is not None:
            yield from _flat(t)


def _same(x, y) -> bool:
    """Equal tensors, a NaN equal to a NaN in the same place."""
    if torch.equal(x, y):
        return True
    return (x.shape == y.shape and x.dtype == y.dtype
            and x.is_floating_point()
            and bool(((x == y) | (torch.isnan(x) & torch.isnan(y))).all()))


def same_bits(a, b) -> bool:
    """Whether two launches' results, carries included, are the same bits
    (also chip_smoke.py's and the CUDA tests' comparison of layouts; a
    lane that diverged holds NaN in the same places in both)."""
    fa, fb = list(_flat(a)), list(_flat(b))
    return len(fa) == len(fb) and all(_same(x, y) for x, y in zip(fa, fb))


def section_split(lib, blocks):
    """The section sums of a probe build's last launch (csrc/sections.cuh):
    an (n blocks, sections + 1) array, the last column each block's tile
    iterations; zeroes them on the card."""
    fn = lib.tinympc_sections
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    n = len(SECTION_NAMES)
    buf = (ctypes.c_ulonglong * ((n + 1) * blocks))()
    got = fn(ctypes.addressof(buf), blocks)
    if got != n:
        raise RuntimeError(f"tinympc_sections returned {got}")
    return np.frombuffer(buf, dtype=np.uint64).reshape(blocks, n + 1)


SASS_LABELS = ("condensed_adaptive_kernel<16, 16, kShared, false, false, 4>",
               "condensed_adaptive_kernel<20, 32, kShared, false, false, 2>",
               "condensed_adaptive_kernel<20, 32, kShared, false, false, 4>",
               "condensed_fused_kernel<20, kShared, false, false, 2>",
               "condensed_fused_kernel<20, kShared, false, false, 4>")


def dump_sass(built, labels, out_dir):
    """The SASS of the kernels of ``built`` whose label is one of
    ``labels``, from ``cuobjdump -sass`` of the whole library split at its
    function headers (so a library loaded as built, without its ptxas log,
    serves too), a file each under ``out_dir``."""
    import re
    import shutil
    import subprocess
    from pathlib import Path
    from tinympc_julia_tpu_torch.ops.cuda._build import kernel_label
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    sass = subprocess.run([tool, "-sass", str(built.path)],
                          capture_output=True, text=True).stdout
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        label = kernel_label(part.split("\n", 1)[0].strip())
        if label in labels:
            path = out_dir / (re.sub(r"\W+", "_", label).strip("_")
                              + ".sass")
            path.write_text(part)
            print(f"sections SASS of {label}: {path}", flush=True)


def sections_probe(reps=3, cases=None, plans=None, sass_dir=None):
    """How a tile iteration of K1 and K2 splits between its sections
    (ROADMAP R6's first step): the K1 and K2 instances built again with
    csrc/sections.cuh's clock64() counters (``-DTINYMPC_SECTIONS``; the
    shipped libraries stay as they are, and both builds' ptxas lines are
    printed), each launch of ``continuation_cases`` run once on the
    counters: each section's cycles a tile iteration, summed over the
    launch's blocks and over its slowest block (the most tile iterations,
    the continuation's critical path), and their shares; beside it the
    launch on the shipped build (CUDA events, median of ``reps`` after a
    warm-up) and its one timing on the probe build.  ``plans``: {case:
    [(label, plan)]} further layouts of a case, forced (a plan of the
    case's module's plan function); ``sass_dir``: where the SASS of the
    shipped SASS_LABELS kernels goes (``dump_sass``).  Prints only; returns
    {label: ms}."""
    from unittest import mock
    from tinympc_julia_tpu_torch.ops.cuda import adaptive_kernel as K2
    from tinympc_julia_tpu_torch.ops.cuda import condensed_kernel as K
    from tinympc_julia_tpu_torch.ops.cuda._build import (kernel_label,
                                                         load_libraries,
                                                         ptxas_usage)
    dev = torch.device("cuda")
    cases = cases if cases is not None else continuation_cases(dev)
    lib_of = {K: "condensed_fused", K2: "condensed_adaptive"}
    names = [lib_of[m] for m in (K, K2)
             if any(mod is m for mod, _ in cases.values())]
    probe = {}
    for defines in ((), ("TINYMPC_SECTIONS",)):
        tag = "probe" if defines else "shipped"
        for name, built in zip(names, load_libraries(names, defines)):
            probe[(name, tag)] = built
            print(f"sections ptxas {tag} {name}: built in "
                  f"{built.seconds:.1f} s", flush=True)
            for mangled, use in sorted(ptxas_usage(built.log).items()):
                print(f"sections ptxas {tag}: {kernel_label(mangled)}: "
                      f"{use.registers} registers, {use.spill_stores} / "
                      f"{use.spill_loads} bytes spill stores / loads",
                      flush=True)
            if sass_dir and not defines:
                dump_sass(built, SASS_LABELS, sass_dir)
    fns = {}
    for mod, name in lib_of.items():
        if name not in names:
            continue
        fn = getattr(probe[(name, "probe")].lib, f"tinympc_{name}")
        fn.argtypes = mod._ARGTYPES
        fn.restype = ctypes.c_int
        fns[mod] = (fn, probe[(name, "probe")].lib)
    plan_fn = {K: "fused_tile_plan", K2: "adaptive_tile_plan"}
    out = {}
    for case, (mod, f) in cases.items():
        for label, plan in [("plan", None)] + list((plans or {}).get(case, ())):
            patch = (mock.patch.object(mod, plan_fn[mod],
                                       lambda *a, **k: plan)
                     if plan is not None else contextlib.nullcontext())
            with patch:
                res = f()
                torch.cuda.synchronize()
                t = float(np.median([event_ms(f) for _ in range(reps)]))
                fn, lib = fns[mod]
                section_split(lib, 4096)  # zeroes the counters
                with mock.patch.object(mod, "_kernel_fn", lambda: fn):
                    t_probe = event_ms(f)
                split = section_split(lib, 4096)
            if plan is None:
                base = res
            same = same_bits(res, base)
            used = split[split[:, -1] > 0]
            its = used[:, -1].astype(np.float64)
            cyc = used[:, :-1].astype(np.float64)
            slow = int(np.argmax(its))
            whole = cyc.sum(0) / its.sum()
            worst = cyc[slow] / its[slow]
            tot = cyc[slow].sum()
            share = ", ".join(f"{n} {100 * w / whole.sum():.1f}%"
                              for n, w in zip(SECTION_NAMES, whole) if w)
            share_w = ", ".join(f"{n} {w:.0f}" for n, w in
                                zip(SECTION_NAMES, worst) if w)
            print(f"sections {case} [{label}]: shipped {t:.3f} ms (median of "
                  f"{reps}), probe build {t_probe:.3f} ms; bit-equal to the "
                  f"plan's {same}; {len(used)} "
                  f"blocks, {int(its.sum())} tile iterations (slowest block "
                  f"{int(its[slow])}); cycles a tile iteration over all "
                  f"blocks {whole.sum():.0f}: {share}; the slowest block "
                  f"{worst.sum():.0f} cycles a tile iteration ({share_w}), "
                  f"{tot / max(t_probe, 1e-9) / 1e3:.0f} cycles a us of the "
                  f"probe launch", flush=True)
            out[f"{case} [{label}]"] = t
    return out


def multi_pass_cases(dev):
    """K2's launches whose maps take more than one pass, as chip_smoke.py
    drives them: phase 35b (the 20-state chain, N = 20, the OSQP-form
    controller with rho in [0.2, 5], 4,096 lanes, 150 iterations, no
    carry) and phase 11w (the adaptive pipeline's bulk pass at the
    quadrotor's N = 40: 16,384 lanes, 150 iterations, the termination
    controller floored at rho0 = 5 with trust 2, the carry out).  Returns
    {name: (module, wrapper's partial, the 2-lane plan)}."""
    from tinympc_julia_tpu_torch import make_problem
    from tinympc_julia_tpu_torch.ops.condensed import build_condensed_taylor
    from tinympc_julia_tpu_torch.ops.cuda import adaptive_kernel as K2
    from tinympc_julia_tpu_torch.ops.riccati import precompute_cache
    f32 = torch.float32
    A, Bm = chain_plant()
    p = make_problem(A, Bm, np.eye(20), np.eye(9), 1.0, 20, u_min=-1.0,
                     u_max=1.0, dtype=f32, device=dev)
    c = precompute_cache(p.A, p.B, p.Q, p.R, p.rho_setup)
    x0 = torch.as_tensor(0.5 * np.random.default_rng(37).standard_normal(
        (4096, 20)), dtype=f32, device=dev)
    chain = functools.partial(
        K2.condensed_adaptive_cuda, build_condensed_taylor(p, c), p.u_min,
        p.u_max, p.x_min, p.x_max, x0, None,
        plant=K2.AdaptivePlant(p.A, p.B, p.Q, p.R, c.Pinf, c.dPinf_drho),
        nx=20, nu=9, N=20, max_iter=150, abs_pri_tol=1e-3, abs_dua_tol=1e-3,
        en_state_bound=False, en_input_bound=True, relaxation_alpha=1.0,
        adaptive_rho_min=0.2, adaptive_rho_max=5.0,
        adaptive_rho_clipping=True, check_termination=1, controller="osqp",
        taylor_trust=float("inf"), warm_start=False, carry_out=False)
    q, qc, tq, x0q = quad_wide_case(dev)
    wide = functools.partial(K2.condensed_adaptive_cuda, tq, q.u_min,
                             q.u_max, q.x_min, q.x_max, x0q, None,
                             **quad_wide_kw(q))
    return {"K2 chain OSQP-form (phase 35b, 4,096 lanes, 150 iterations)":
            (K2, chain, K2.shared_adaptive_plan(20, 9, 20, 2)),
            "K2 quadrotor N=40 bulk (phase 11w, 16,384 lanes, 150 "
            "iterations)": (K2, wide, K2.shared_adaptive_plan(12, 4, 40, 2))}


def quad_wide_case(dev, N=40, B=16384):
    """Phase 11w's inputs: the quadrotor at horizon ``N`` (|u| <= its
    hover bound), its Taylor maps, ``B`` initial states uniform in
    [-0.3, 0.3] (seed 1, phase 11's): (problem, cache, maps, x0)."""
    from tinympc_julia_tpu_torch import make_problem
    from tinympc_julia_tpu_torch.models import quadrotor
    from tinympc_julia_tpu_torch.ops.condensed import build_condensed_taylor
    from tinympc_julia_tpu_torch.ops.riccati import precompute_cache
    f32 = torch.float32
    p = make_problem(quadrotor.A, quadrotor.B, np.diag(quadrotor.Q_DIAG),
                     np.diag(quadrotor.R_DIAG), quadrotor.RHO, N,
                     u_min=-quadrotor.U_HOVER_BOUND,
                     u_max=quadrotor.U_HOVER_BOUND, dtype=f32, device=dev)
    c = precompute_cache(p.A, p.B, p.Q, p.R, p.rho_setup)
    x0 = torch.as_tensor(np.random.default_rng(1).uniform(
        -0.3, 0.3, size=(B, 12)), dtype=f32, device=dev)
    return p, c, build_condensed_taylor(p, c), x0


def quad_wide_kw(p, **kw):
    """The adaptive pipeline's bulk-pass settings (phase 11's) at ``p``'s
    horizon: 150 iterations, the termination controller floored at rho0 =
    5 with trust 2, the carry out."""
    from tinympc_julia_tpu_torch.models import quadrotor
    base = dict(plant=None, nx=12, nu=4, N=p.N, max_iter=150,
                abs_pri_tol=1e-3, abs_dua_tol=1e-3, en_state_bound=False,
                en_input_bound=True, relaxation_alpha=1.0,
                adaptive_rho_min=quadrotor.RHO, adaptive_rho_max=1e3,
                adaptive_rho_clipping=True, check_termination=1,
                controller="termination", taylor_trust=2.0,
                warm_start=False, carry_out=True)
    base.update(kw)
    return base


def quad_k1_case(dev, N=40, B=16384):
    """Phase 4w's inputs: the quadrotor at horizon ``N`` (|u| <= its hover
    bound), its condensed maps, ``B`` initial states uniform in [-0.3, 0.3]
    (seed 1, phase 11's): (problem, cache, maps, x0)."""
    from tinympc_julia_tpu_torch import make_problem
    from tinympc_julia_tpu_torch.models import quadrotor
    from tinympc_julia_tpu_torch.ops.condensed import build_condensed
    from tinympc_julia_tpu_torch.ops.riccati import precompute_cache
    f32 = torch.float32
    p = make_problem(quadrotor.A, quadrotor.B, np.diag(quadrotor.Q_DIAG),
                     np.diag(quadrotor.R_DIAG), quadrotor.RHO, N,
                     u_min=-quadrotor.U_HOVER_BOUND,
                     u_max=quadrotor.U_HOVER_BOUND, dtype=f32, device=dev)
    c = precompute_cache(p.A, p.B, p.Q, p.R, p.rho_setup)
    x0 = torch.as_tensor(np.random.default_rng(1).uniform(
        -0.3, 0.3, size=(B, 12)), dtype=f32, device=dev)
    return p, c, build_condensed(p, c), x0


def quad_k1_kw(p, **kw):
    """Phase 4w's K1 settings at ``p``'s horizon: 150 iterations, alpha
    1.7, a check every 4, cold, the carry out."""
    base = dict(nx=12, nu=4, N=p.N, max_iter=150, abs_pri_tol=1e-3,
                abs_dua_tol=1e-3, en_state_bound=False, en_input_bound=True,
                relaxation_alpha=1.7, check_termination=4, warm_start=False,
                carry_out=True)
    base.update(kw)
    return base


def chain36_case(dev, B=16384):
    """Phase 36's launch: the 20-state chain at N = 20 with |u| <= 1 and
    |x| <= 3, a state stage of 20 entries with 10 cones of dim 2 (mu 0.5)
    and 4 halfspace rows (seed 11), ``B`` initial states (seed 38), 200
    iterations, alpha 1, a check every iteration, cold, no carry: (the
    wrapper's arguments, its settings with the constraints, the box-only
    settings: the same launch at tolerances 0 without the cones and
    halfspaces, every lane its 200 iterations)."""
    from tinympc_julia_tpu_torch import make_problem
    from tinympc_julia_tpu_torch.ops.condensed import build_condensed
    from tinympc_julia_tpu_torch.ops.cuda import condensed_kernel as K
    from tinympc_julia_tpu_torch.ops.riccati import precompute_cache
    f32, N = torch.float32, 20
    A, Bm = chain_plant()
    p = make_problem(A, Bm, np.eye(20), np.eye(9), 1.0, N, u_min=-1.0,
                     u_max=1.0, x_min=np.full((N, 20), -3.0),
                     x_max=np.full((N, 20), 3.0), dtype=f32, device=dev)
    c = precompute_cache(p.A, p.B, p.Q, p.R, p.rho_setup)
    rng = np.random.default_rng(11)
    cons = K.fused_constraints(
        soc_x=tuple((2 * j, 2, 0.5) for j in range(10)),
        lin_x=(rng.normal(size=(4, 20)), np.full(4, 5.0)), nx=20, nu=9,
        dtype=f32, device=dev)
    x0 = torch.as_tensor(0.5 * np.random.default_rng(38).standard_normal(
        (B, 20)), dtype=f32, device=dev)
    args = (build_condensed(p, c), float(c.rho), p.u_min.reshape(-1),
            p.u_max.reshape(-1), p.x_min.reshape(-1), p.x_max.reshape(-1),
            x0, None)
    full = dict(nx=20, nu=9, N=N, max_iter=200, abs_pri_tol=1e-3,
                abs_dua_tol=1e-3, en_state_bound=True, en_input_bound=True,
                relaxation_alpha=1.0, check_termination=1, warm_start=False,
                carry_out=False, constraints=cons)
    box = dict(full, abs_pri_tol=0.0, abs_dua_tol=0.0, constraints=None)
    return args, full, box


def k1_multi_pass_cases(dev):
    """K1's launches whose map takes more than one pass, as chip_smoke.py
    drives them: phase 4w (the quadrotor at N = 40, 16,384 lanes, 150
    iterations, ``quad_k1_kw``) and phase 36's box-only launch (the
    20-state chain, 16,384 lanes, 200 iterations at tolerances 0,
    ``chain36_case``).  Returns {name: (module, wrapper's partial, the
    2-lane plan)}."""
    from tinympc_julia_tpu_torch.ops.cuda import condensed_kernel as K
    p, c, m, x0 = quad_k1_case(dev)
    quad = functools.partial(K.condensed_fused_cuda, m, float(c.rho),
                             p.u_min, p.u_max, p.x_min, p.x_max, x0, None,
                             **quad_k1_kw(p))
    args, _, box = chain36_case(dev)
    chain = functools.partial(K.condensed_fused_cuda, *args, **box)
    return {"K1 quadrotor N=40 (phase 4w, 16,384 lanes, 150 iterations)":
            (K, quad, K.shared_tile_plan(12, 4, 40)),
            "K1 chain box only (phase 36, 16,384 lanes, 200 iterations)":
            (K, chain, K.shared_tile_plan(20, 9, 20, state_free=False))}


def sections_main(sass_dir=None, k2_only=False, k1_only=False):
    """``sections_probe`` at the continuations' shapes and at K2's
    launches in passes (``multi_pass_cases``), each launch also on the
    other layouts that could take it (forced, held bit for bit against
    the plan's): K2's bulk launch with 2 lanes a thread (the layout before
    the 4-lane one) and on the continuation layout (why the plan takes the
    batch), and without its carry out (so on the 4-lane layout with the
    one-pass box step; with 2 lanes, the two passes); K2's continuation on
    tiles of 32 (the layout before the batch-aware plan); phase 35b's and
    11w's launches with 2 lanes a thread (the layout before the 4-lane one
    in passes); K1d's launches with 2 lanes a thread (the layout before
    the 4-lane one); K1's launches in passes (``k1_multi_pass_cases``:
    phase 4w's and phase 36's box-only launch) with 2 lanes a thread (the
    layout before the 4-lane one in passes).  With ``k2_only``, K2's
    launches alone (K1 is neither built nor run); with ``k1_only``, K1's
    alone (K2 runs once to make the continuations' inputs)."""
    from tinympc_julia_tpu_torch.ops.cuda import adaptive_kernel as K2
    from tinympc_julia_tpu_torch.ops.cuda import condensed_kernel as K
    dev = torch.device("cuda")
    cases = continuation_cases(dev)
    names = list(cases)
    bulk = cases[names[0]][1]
    free = "K2 bulk, no carry out (16,384 lanes, 150 iterations)"
    wide = multi_pass_cases(dev) if not k1_only else {}
    wide1 = k1_multi_pass_cases(dev) if not k2_only else {}
    cases = {names[0]: cases[names[0]],
             free: (K2, functools.partial(bulk.func, *bulk.args, **dict(
                 bulk.keywords, carry_out=False))),
             names[1]: cases[names[1]],
             **{n: (m, f) for n, (m, f, _) in wide.items()},
             **{n: cases[n] for n in names[2:]},
             **{n: (m, f) for n, (m, f, _) in wide1.items()}}
    if k2_only or k1_only:
        cases = {n: c for n, c in cases.items() if (c[0] is K2) == k2_only}
    two = K2.shared_adaptive_plan(12, 4, 20, 2)
    k1_shared = [K.shared_tile_plan(12, 4, 20, red) for red in (False, True)]
    return sections_probe(sass_dir=sass_dir, cases=cases, plans={
        names[0]: [("tiles of 32, 2 lanes (the parent's)", two),
                   ("tiles of 16, the continuation layout",
                    K2.continuation_adaptive_plan(12, 4, 20, 2))],
        free: [("tiles of 32, 2 lanes (the parent's)", two)],
        names[1]: [("tiles of 32, 2 lanes (the parent's)", two),
                   ("tiles of 32, 4 lanes",
                    K2.four_lane_adaptive_plan(12, 4, 20, 2))],
        **{n: [("tiles of 32, 2 lanes (the parent's)", plan)]
           for n, (_, _, plan) in {**wide, **wide1}.items()},
        names[2]: [("2 lanes a thread (the parent's)", k1_shared[1])],
        names[3]: [("2 lanes a thread (the parent's)", k1_shared[0])]})


def sections_cartpole():
    """``sections_probe`` at the cartpole's launches (``cartpole_cases``),
    each on the plan's layout and on tiles of 32 lanes forced (the layout
    before the warp layout), held bit for bit."""
    from tinympc_julia_tpu_torch.ops.cuda import condensed_kernel as K
    cases = cartpole_cases(torch.device("cuda"))
    return sections_probe(cases=cases, plans={
        name: [("tiles of 32 (the parent's)", K.shared_tile_plan(
            4, 1, 20, False, not name.startswith("(c)")))]
        for name in cases})


def _sw(nx, nu, N):
    return (N - 1) * nu + N * nx


def switch_cases(dev, sms, k2_only=False, k1_only=False):
    """The shapes on each side of the batch-aware plans' switches, cold
    launches of 300 (K2) and 150 (K1) iterations checking every one:
    [(label, module, wrapper's partial, sw, the plan's layout, the layouts
    to force: [(name, plan)])], the plan's layout first where it is one.

    * K2's continuation layout (tiles of 16, one pass of 512 rows) against
      tiles of 32 with 4 lanes a thread (where their maps stream in one
      pass of 320 rows) and with 2: at 64 tiles, the quadrotor at N = 9
      (sw 140, the narrowest whose maps stream), 12 (188), 16 (252), 17
      (268), 20 (316) and 32 (508), the cartpole at N = 52 (259), 80 (399)
      and 102 (509), the rocket with its cones at N = 12 (105, the
      narrowest streamed), 27 (240), 29 (258) and 43 (384); the quadrotor
      at N = 20 at 4, 66, 67, 72, 80, 96, 112, 128, 256 and 512 tiles (67:
      twice 67 blocks exceed ``sms``, the card's SMs; 512: the bulk pass's
      16,384 lanes) and on the group grid of chip_smoke.py's phase 15b
      (``grid_case``: 8 groups x 512 lanes, 128 tiles).
    * K2's 4-lane layout in passes (320 rows in the forward product, 384
      in the backward) against 2 lanes a thread and, from sw 892, the
      cluster, at 128 and 512 tiles: the quadrotor at N = 21 (sw 332), 30
      (476), 40 (636), 50 (796), 56 (892, the widest the layout takes), 57
      (908, the first it does not: 2 lanes against the cluster) and 60
      (956), and the 20-state chain under phase 35b's OSQP-form controller
      (571; rho in [0.2, 5], no carry).
    * K1's 4-lane layout (10 rows x 4 lanes a thread) against 2 lanes, at
      64 and 2,048 tiles: the quadrotor at N = 9 (sw 140) and 20 (316), the
      cartpole at N = 28 (139) and 64 (319), the rocket with its cones at
      N = 16 (141) and 35 (312); the cartpole at N = 64 with a 32-iteration
      reduced head.
    * K1's 4-lane layout in passes of 320 rows against 2 lanes a thread
      (one pass of 512 rows up to sw 512, two of 320 to 640, two of 512
      beyond) and, from sw 892 and at 64 tiles, the cluster, at 64 (phase
      4b's 2,048 lanes), 128 and 512 tiles, alpha 1.7, a check every 4:
      the quadrotor at N = 21 (sw 332), 30 (476), 40 (636), 50 (796), 56
      (892), 57 (908, the first width of the 2-lane plans' cluster), 60
      (956), 64 (1,020), 70 (1,116), 75 (1,196) and 81 (1,292, the widest
      the 4-lane layout takes), the rocket with its cones at N = 40 (357),
      and phase 36's 20-state chain with its cones and halfspaces (571;
      ``chain36_case``, 200 iterations); the quadrotor at N = 57, 64 and
      81 also at 32 and 96 tiles, with the cluster (``few_tiles``: the
      batch from which the 4-lane layout takes the card from the
      cluster).

    With ``k2_only``, K2's cases alone; with ``k1_only``, K1's."""
    from tinympc_julia_tpu_torch import make_problem
    from tinympc_julia_tpu_torch.models import cartpole, quadrotor, rocket
    from tinympc_julia_tpu_torch.ops.condensed import (build_condensed,
                                                       build_condensed_taylor)
    from tinympc_julia_tpu_torch.ops.cuda import adaptive_kernel as K2
    from tinympc_julia_tpu_torch.ops.cuda import condensed_kernel as K
    from tinympc_julia_tpu_torch.ops.riccati import precompute_cache
    f32 = torch.float32
    models = dict(quadrotor=(quadrotor, 0.5, 0.3), cartpole=(cartpole, 5.0,
                                                             0.5))
    wide_from = 892  # sw from which the cluster stands beside 2 lanes

    @functools.cache
    def problem(name, N):
        """(problem, cache, constraints, x0 of 65,536 lanes)."""
        if name == "chain":
            A, Bm = chain_plant()
            p = make_problem(A, Bm, np.eye(20), np.eye(9), 1.0, N,
                             u_min=-1.0, u_max=1.0, dtype=f32, device=dev)
            c = precompute_cache(p.A, p.B, p.Q, p.R, p.rho_setup)
            x0 = 0.5 * np.random.default_rng(37).standard_normal((65536, 20))
            return p, c, None, torch.as_tensor(x0, dtype=f32, device=dev)
        if name == "rocket":
            solver = rocket.make_solver(N=N, dtype=f32, device=dev)
            Xref, Uref = rocket.reference_trajectory(0, N=N)
            solver.set_x_ref(Xref)
            solver.set_u_ref(Uref)
            p, c = solver.problem, solver.cache
            cons = K.fused_constraints(
                **K.problem_constraint_kw(p, solver.settings), nx=6, nu=3,
                dtype=f32, device=dev)
            x0 = rocket.X_INIT[None, :] * np.random.default_rng(2).uniform(
                0.9, 1.1, size=(65536, 1))
        else:
            m, ub, scale = models[name]
            p = make_problem(m.A, m.B, np.diag(m.Q_DIAG), np.diag(m.R_DIAG),
                             m.RHO, N, u_min=-ub, u_max=ub, dtype=f32,
                             device=dev)
            c = precompute_cache(p.A, p.B, p.Q, p.R, p.rho_setup)
            cons = None
            x0 = np.random.default_rng(3).uniform(-scale, scale,
                                                  size=(65536, p.nx))
        return p, c, cons, torch.as_tensor(x0, dtype=f32, device=dev)

    def bounds(p):
        return (p.u_min.reshape(-1), p.u_max.reshape(-1),
                p.x_min.reshape(-1), p.x_max.reshape(-1))

    cases = []
    k2_shapes = [("quadrotor", n, 64) for n in (9, 12, 16, 17, 20, 32)] + [
        ("cartpole", n, 64) for n in (52, 80, 102)] + [
        ("rocket", n, 64) for n in (12, 27, 29, 43)] + [
        ("quadrotor", 20, t) for t in (4, 66, 67, 72, 80, 96, 112, 128, 256,
                                       512)] + [
        (name, n, t) for name, n in [("quadrotor", n) for n in (
            21, 30, 40, 50, 56, 57, 60)] + [("chain", 20)]
        for t in (128, 512)]
    for name, N, tiles in ([] if k1_only else k2_shapes):
        p, c, cons, x0 = problem(name, N)
        nx, nu = p.nx, p.nu
        kw = dict(plant=None, nx=nx, nu=nu, N=N, max_iter=300,
                  abs_pri_tol=1e-3, abs_dua_tol=1e-3,
                  en_state_bound=cons is not None, en_input_bound=True,
                  relaxation_alpha=1.0, adaptive_rho_min=float(c.rho),
                  adaptive_rho_max=1e3, adaptive_rho_clipping=True,
                  check_termination=1, controller="termination",
                  taylor_trust=2.0, warm_start=False, carry_out=True,
                  constraints=cons)
        if name == "chain":  # phase 35b's controller
            kw.update(plant=K2.AdaptivePlant(p.A, p.B, p.Q, p.R, c.Pinf,
                                             c.dPinf_drho),
                      max_iter=150, adaptive_rho_min=0.2,
                      adaptive_rho_max=5.0, controller="osqp",
                      taylor_trust=float("inf"), carry_out=False)
        f = functools.partial(K2.condensed_adaptive_cuda,
                              build_condensed_taylor(p, c), *bounds(p),
                              x0[:32 * tiles].contiguous(), None, **kw)
        free = cons is None
        plan = K2.adaptive_tile_plan(nx, nu, N, 2, False, free, tiles=tiles,
                                     sms=sms)
        cases.append((f"K2 {name} N={N} {tiles} tiles", K2, f,
                      _sw(nx, nu, N), plan, k2_layouts(
                          nx, nu, N, free, plan,
                          cluster=_sw(nx, nu, N) >= wide_from)))
    if not k1_only:
        f, plan = grid_case(dev, sms)
        cases.append(("K2 quadrotor grid 8 x 512 (128 tiles)", K2, f,
                      _sw(12, 4, 20), plan,
                      k2_layouts(12, 4, 20, True, plan)))
    if k2_only:
        return cases
    k1_shapes = [(m, n, t, 0) for m, n in (("quadrotor", 9),
                                           ("quadrotor", 20),
                                           ("cartpole", 28), ("cartpole", 64),
                                           ("rocket", 16), ("rocket", 35))
                 for t in (64, 2048)] + [("cartpole", 64, 2048, 32)]
    for name, N, tiles, head in k1_shapes:
        p, c, cons, x0 = problem(name, N)
        nx, nu = p.nx, p.nu
        kw = dict(nx=nx, nu=nu, N=N, max_iter=150, abs_pri_tol=1e-3,
                  abs_dua_tol=1e-3, en_state_bound=cons is not None,
                  en_input_bound=True, relaxation_alpha=1.0,
                  check_termination=1, warm_start=False, carry_out=True,
                  constraints=cons, bf16_head_iters=head)
        f = functools.partial(K.condensed_fused_cuda, build_condensed(p, c),
                              float(c.rho), *bounds(p),
                              x0[:32 * tiles].contiguous(), None, **kw)
        two = K.shared_tile_plan(nx, nu, N, head > 0, cons is None)
        cases.append((f"K1 {name} N={N} {tiles} tiles"
                      + (f" head {head}" if head else ""), K, f,
                      _sw(nx, nu, N),
                      K.fused_tile_plan(nx, nu, N, head > 0, cons is None),
                      [("4 lanes a thread", K.four_lane_tile_plan(
                          nx, nu, N, head > 0, cons is None)),
                       ("2 lanes a thread", two)]))
    chain = chain36_case(dev, 512 * 32)
    for name, N, tiles in [(m, n, t) for m, n in [("quadrotor", n) for n in (
            21, 30, 40, 50, 56, 57, 60, 64, 70, 75, 81)]
            + [("rocket", 40), ("chain", 20)] for t in (64, 128, 512)] + [
            ("quadrotor", n, t) for n in (57, 64, 81) for t in (32, 96)]:
        if name == "chain":
            nx, nu, free = 20, 9, False
            args, kw, _ = chain
            args = args[:6] + (args[6][:32 * tiles].contiguous(), None)
        else:
            p, c, cons, x0 = problem(name, N)
            nx, nu, free = p.nx, p.nu, cons is None
            args = (build_condensed(p, c), float(c.rho), *bounds(p),
                    x0[:32 * tiles].contiguous(), None)
            kw = dict(nx=nx, nu=nu, N=N, max_iter=150, abs_pri_tol=1e-3,
                      abs_dua_tol=1e-3, en_state_bound=not free,
                      en_input_bound=True, relaxation_alpha=1.7,
                      check_termination=4, warm_start=False, carry_out=True,
                      constraints=cons)
        f = functools.partial(K.condensed_fused_cuda, *args, **kw)
        plan = K.fused_tile_plan(nx, nu, N, False, free,
                                 busy_sms=K.card_busy_sms,
                                 projected=not free, tiles=tiles, sms=sms)
        cases.append((f"K1 {name} N={N} {tiles} tiles", K, f,
                      _sw(nx, nu, N), plan, k1_layouts(
                          nx, nu, N, free, plan,
                          cluster=_sw(nx, nu, N) >= wide_from or (
                              tiles < 128 and name != "rocket"))))
    return cases


def k1_layouts(nx, nu, N, state_free, plan, cluster=False):
    """K1's layouts of a streamed fp32 shape that the switches weigh, the
    plan's first: tiles of 32 with 4 lanes a thread and with 2 (each where
    it exists) and, with ``cluster``, the cluster the card's occupancy
    picks, as [(name, plan)]."""
    from tinympc_julia_tpu_torch.ops.cuda import condensed_kernel as K
    out = [("4 lanes a thread", K.four_lane_tile_plan(nx, nu, N, False,
                                                      state_free)),
           ("2 lanes a thread", K.shared_tile_plan(nx, nu, N, False,
                                                   state_free))]
    if cluster:
        c = K.cluster_tile_plan(nx, nu, N, busy_sms=K.card_busy_sms)
        out.append((f"a cluster of {c.cluster}", c))
    return sorted([o for o in out if o[1] is not None],
                  key=lambda o: o[1] != plan)


def k2_layouts(nx, nu, N, state_free, plan, cluster=False):
    """K2's layouts of a streamed shape that the switches weigh, the plan's
    first: the continuation layout, tiles of 32 with 4 lanes a thread and
    with 2 (each where it exists) and, with ``cluster``, the cluster the
    card's occupancy picks, as [(name, plan)]."""
    from tinympc_julia_tpu_torch.ops.cuda import adaptive_kernel as K2
    out = [("tiles of 16, continuation", K2.continuation_adaptive_plan(
               nx, nu, N, 2, False, state_free)),
           ("tiles of 32, 4 lanes", K2.four_lane_adaptive_plan(
               nx, nu, N, 2, False, state_free)),
           ("tiles of 32, 2 lanes", K2.shared_adaptive_plan(
               nx, nu, N, 2, False, state_free))]
    if cluster:
        c = K2.cluster_adaptive_plan(nx, nu, N, 2,
                                     busy_sms=K2.card_busy_sms)
        out.append((f"a cluster of {c.cluster}", c))
    return sorted([o for o in out if o[1] is not None],
                  key=lambda o: o[1] != plan)


def grid_case(dev, sms):
    """K2's group grid as chip_smoke.py's phase 15b launches it: 8
    randomised quadrotors (dynamics, input gain, costs, rho, |u| bound in
    [0.4, 0.6], seed 11) x 512 lanes (seed 12), the termination
    controller with trust 2 around each group's rho0, 150 iterations,
    the carry out: (the wrapper's partial, the plan)."""
    from tinympc_julia_tpu_torch import make_problem
    from tinympc_julia_tpu_torch.models import quadrotor
    from tinympc_julia_tpu_torch.ops.condensed import build_condensed_taylor
    from tinympc_julia_tpu_torch.ops.cuda import adaptive_kernel as K2
    from tinympc_julia_tpu_torch.ops.riccati import precompute_cache
    from tinympc_julia_tpu_torch.types import stack_instances
    G, L, N, nx = 8, 512, 20, 12
    rng = np.random.default_rng(11)
    ps, cs = [], []
    for _ in range(G):
        ub = rng.uniform(0.4, 0.6)
        p = make_problem(
            quadrotor.A + rng.normal(scale=2e-3, size=(nx, nx)),
            quadrotor.B * rng.uniform(0.9, 1.1),
            np.diag(quadrotor.Q_DIAG * rng.uniform(0.8, 1.25, size=nx)),
            np.diag(quadrotor.R_DIAG), quadrotor.RHO * rng.uniform(0.8, 1.2),
            N, u_min=-ub, u_max=ub, dtype=torch.float32, device=dev)
        ps.append(p)
        cs.append(precompute_cache(p.A, p.B, p.Q, p.R, p.rho_setup))
    P, C = stack_instances(ps), stack_instances(cs)
    x0 = torch.as_tensor(np.random.default_rng(12).uniform(
        -0.3, 0.3, size=(G, L, nx)), dtype=torch.float32, device=dev)
    kw = dict(plant=None, nx=nx, nu=4, N=N, max_iter=150, abs_pri_tol=1e-3,
              abs_dua_tol=1e-3, en_state_bound=False, en_input_bound=True,
              relaxation_alpha=1.0, adaptive_rho_min=quadrotor.RHO * 0.8,
              adaptive_rho_max=1e3, adaptive_rho_clipping=True,
              check_termination=1, controller="termination",
              taylor_trust=2.0, warm_start=False, carry_out=True,
              num_groups=G)
    f = functools.partial(K2.condensed_adaptive_cuda,
                          build_condensed_taylor(P, C), P.u_min, P.u_max,
                          P.x_min, P.x_max, x0, None, **kw)
    return f, K2.adaptive_tile_plan(nx, 4, N, 2, tiles=G * L // 32, sms=sms)


def switch_probe(reps=3, k2_only=False, k1_only=False):
    """The batch-aware plans' switches (``switch_cases``) measured on each
    side: each case on each of its layouts, forced, held bit for bit
    against the first (the plan's), with its time (CUDA events, median of
    ``reps`` after a warm-up), its tile iterations and the SM-us a tile
    iteration (the time x the blocks at once, at most the SMs, over the
    tile iterations), and which layout the plan takes.  Prints only;
    returns {label: ms}."""
    from unittest import mock
    from tinympc_julia_tpu_torch.ops.cuda import adaptive_kernel as K2
    from tinympc_julia_tpu_torch.ops.cuda._build import load_libraries
    from tinympc_julia_tpu_torch.ops.cuda.condensed_kernel import \
        tile_iterations
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    names = (([] if k1_only else ["condensed_adaptive"])
             + ([] if k2_only else ["condensed_fused"]))
    for built in load_libraries(names):
        print(f"switch probe: {built.path.name} built in "
              f"{built.seconds:.1f} s", flush=True)
    out = {}
    for label, mod, f, sw, taken, layouts in switch_cases(dev, sms, k2_only,
                                                          k1_only):
        name = "adaptive_tile_plan" if mod is K2 else "fused_tile_plan"
        base, times = None, []
        for lname, plan in layouts:
            with mock.patch.object(mod, name, lambda *a, **k: plan):
                res = f()
                torch.cuda.synchronize()
                t = float(np.median([event_ms(f) for _ in range(reps)]))
            base = res if base is None else base
            same = same_bits(res, base)
            its = tile_iterations(res[2], plan.tile)
            blocks = -(-res[2].numel() // plan.tile) * plan.cluster
            times.append(t)
            mark = " (the plan's)" if plan == taken else ""
            print(f"switch probe {label} (sw {sw}) [{lname}{mark}]: "
                  f"{t:.3f} ms (median of {reps}); bit-equal to the first "
                  f"{same}; {its} tile iterations of {blocks} blocks, "
                  f"{t * 1e3 * min(blocks, sms) / its:.2f} SM-us a tile "
                  f"iteration", flush=True)
            out[f"{label} [{lname}]"] = t
        for (lname, _), t in zip(layouts[1:], times[1:]):
            print(f"switch probe {label}: {lname} / {layouts[0][0]} "
                  f"{t / times[0]:.3f}", flush=True)
    return out


def rows_probe(reps=5, k1=False):
    """K2's launches of chip_smoke.py's kernels line on the plans the tree
    takes: the adaptive bulk pass (16,384 lanes) and its continuation
    (2,048 slots), the group grid of phase 15b, phase 35b's chain and phase
    11w's bulk pass at N = 40 (``continuation_cases``, ``grid_case``,
    ``multi_pass_cases``); with ``k1`` K1's instead (the cartpole's
    launches of phases 6, 20 and 22, ``cartpole_cases``, the requantized
    and bulk-sized K1d launches of ``continuation_cases``, and phase 4w's
    and phase 36's box-only launch, ``k1_multi_pass_cases``);
    each timed (CUDA events, median of ``reps`` after a warm-up) with its
    digest, so that two trees, each with this file, run in turns compare
    bit for bit.  Prints only; returns {name: ms}."""
    from tinympc_julia_tpu_torch.ops.cuda import adaptive_kernel as K2
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cases = {n: f for n, (m, f) in continuation_cases(dev).items()
             if (m is K2) != k1}
    if k1:
        cases.update({n: f for n, (_, f) in cartpole_cases(dev).items()})
        cases.update({n: f for n, (_, f, _) in
                      k1_multi_pass_cases(dev).items()})
    else:
        cases["K2 group grid 8 x 512 (phase 15b)"] = grid_case(dev, sms)[0]
        cases.update({n: f for n, (_, f, _) in
                      multi_pass_cases(dev).items()})
    out = {}
    for name, f in cases.items():
        res = f()
        torch.cuda.synchronize()
        t = float(np.median([event_ms(f) for _ in range(reps)]))
        print(f"rows probe {name}: {t:.3f} ms (median of {reps}), digest "
              f"(the carry included) {digest(list(_flat(res)))}",
              flush=True)
        out[name] = t
    return out


def order_probe(B=2048):
    """Whether a K1 launch's differences from its plain version are the
    plain product's sum order (ROADMAP §3): the quadrotor at N = 40 (sw
    636, where cuBLAS need not sum in index order) with |x| <= 2 and
    without, and at N = 20 (where it does) with |x| <= 2, 200 iterations,
    alpha 1.7, a check every iteration, ``B`` lanes (seed 33), the carry
    out: the plan's launch against 2 lanes a thread, w2 in global memory
    and a cluster of 2, forced (every one sums in index order: the same
    bits), and the lanes whose counts or flags differ between the kernel,
    the plain version in fp32 and the plain version in float64 (solved
    lanes among them).  Prints only."""
    from unittest import mock
    from tinympc_julia_tpu_torch.ops.condensed import build_condensed
    from tinympc_julia_tpu_torch.ops.cuda import condensed_kernel as K
    dev = torch.device("cuda")

    def differ(a, b):
        d = (a[2] != b[2]) | (a[3] != b[3])
        return int(d.sum()), int((d & (a[3] == 1) & (b[3] == 1)).sum())

    for N, box in ((40, 2.0), (40, None), (20, 2.0)):
        p, c = quad_problem(N, dev, box)
        p64, c64 = quad_problem(N, dev, box, torch.float64)
        x0 = torch.as_tensor(np.random.default_rng(33).uniform(
            -0.3, 0.3, size=(B, 12)), dtype=torch.float32, device=dev)
        kw = dict(nx=12, nu=4, N=N, max_iter=200, abs_pri_tol=1e-3,
                  abs_dua_tol=1e-3, en_state_bound=box is not None,
                  en_input_bound=True, relaxation_alpha=1.7,
                  check_termination=1, warm_start=False, carry_out=True)
        args = (build_condensed(p, c), float(c.rho), p.u_min, p.u_max,
                p.x_min, p.x_max, x0, None)
        k = K.condensed_fused_cuda(*args, **kw)
        same = []
        for plan in (K.shared_tile_plan(12, 4, N, False, box is None),
                     K.global_tile_plan(12, 4, N),
                     K.cluster_tile_plan(12, 4, N, blocks=2)):
            with mock.patch.object(K, "fused_tile_plan",
                                   lambda *a, **k_: plan):
                same.append(same_bits(K.condensed_fused_cuda(*args, **kw),
                                      k))
        r32 = K.condensed_fused_reference(*args, **kw)
        r64 = K.condensed_fused_reference(
            build_condensed(p64, c64), float(c64.rho), p64.u_min, p64.u_max,
            p64.x_min, p64.x_max, x0.double(), None, **kw)
        print(f"order probe quadrotor N={N} |x| <= {box}, {B} lanes: 2 "
              f"lanes, w2 in global memory, a cluster of 2 bit-equal to "
              f"the plan's {same}; lanes whose counts or flags differ "
              f"(solved on both among them): kernel / plain fp32 "
              f"{differ(k, r32)}, kernel / plain float64 {differ(k, r64)}, "
              f"plain fp32 / plain float64 {differ(r32, r64)}; solved "
              f"{int(k[3].sum())}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("probe", nargs="?",
                    choices=("wide", "cluster", "far", "stage", "sections",
                             "switch", "narrow", "rows", "order"),
                    default="cluster")
    ap.add_argument("--cartpole", action="store_true",
                    help="sections: the cartpole's launches (cartpole_cases) "
                         "instead of the continuations")
    ap.add_argument("--sass", metavar="DIR",
                    help="sections: write the SASS of the continuation "
                         "layouts' kernels under DIR")
    ap.add_argument("--k2", action="store_true",
                    help="sections, switch: K2's launches alone")
    ap.add_argument("--k1", action="store_true",
                    help="rows: K1's launches instead of K2's; sections, "
                         "switch: K1's launches alone")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("layout_probe: needs an NVIDIA GPU")
    if args.probe == "sections":
        (sections_cartpole() if args.cartpole
         else sections_main(args.sass, args.k2, args.k1))
        return
    if args.probe == "switch":
        switch_probe(k2_only=args.k2, k1_only=args.k1)
        return
    if args.probe == "rows":
        rows_probe(k1=args.k1)
        return
    dict(wide=wide_layout_probe, cluster=cluster_probe,
         far=far_layout_probe, stage=stage_probe,
         narrow=narrow_probe, order=order_probe)[args.probe]()


if __name__ == "__main__":
    main()
