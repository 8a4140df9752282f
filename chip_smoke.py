#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (one line each; any failure exits non-zero):
  1. environment: torch and CUDA versions, the card's name and power limit;
     TF32 allowed process-wide, as a caller may set it: the port pins full
     fp32 in every fp32 path (the plain versions included), so every
     comparison below also shows that the pin holds;
  2. build: nvcc compiles kernels K1 (csrc/condensed_fused.cu), K2
     (csrc/condensed_adaptive.cu, in two translation units) and K3
     (csrc/fused_stage.cu), side by side, into build/torch_kernels/, with
     each file's registers and the variants that spill, and each K3
     variant's registers and spill bytes;
  3. kernel vs plain at the cartpole shape (B = 4096): (a) cold, ct=1,
     alpha=1.7, no state bound; (b) ct=4; (c) the generic path with the
     constrained cartpole's state bound |x0| <= 2; (d) a 30 + 50 warm chain
     that must equal the kernel's own 80-iteration solve bit for bit;
  4. kernel vs plain at the quadrotor shape (B = 512), where T12 does not
     fit in shared memory; (b) K1's wide maps, the quadrotor at N = 40 and
     57 (sw 636 and 908, wider than the 16 RPT rows the product's threads
     cover at once: the product in passes), B = 2,048, fp32 (400
     iterations, timed beside its plain version with its tile iterations)
     and precision="default" (24 iterations), each with its plan (the
     layout it takes, passes, lanes and rows a thread, residency,
     shared-memory bytes);
  5. the main path through the API: TinyMPCSolver on "cuda",
     solve_batch(method="fused") at B = 65,536 and a return_carry/warm chain;
  6. the headline three-phase pipeline at B = 65,536 with 8,192 straggler
     slots, all fp32: convergence; the merged per-lane results (phase-2
     slots folded back into their lanes) and one phase-0 launch with its
     carry, each against the plain version; kernel vs plain times; then the
     staged headline (parallel.pipeline.STAGED, bench.py's staging: phase 0
     at "default" with its one end check in fp32, a 96-iteration reduced
     head in phase 2): convergence (>= 99%), the merged results against its
     plain version, kernel vs plain times and staged vs fp32 times;
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
 10. kernel K2 (per-lane adaptive rho) vs plain at B = 4096: (a) the
     cartpole, OSQP-form controller, rho0 = 1 clipped to [0.5, 5], 200
     iterations cold with its carry; (b) the same with the cart position
     held to |x_0| <= 0.5, so the state dual and the A^T g terms of the
     prediction are live; (c) a 30 + 50 warm chain against the plain
     version's chain (the continuation restarts the rho-update counter, so
     the chain is not an 80-iteration solve); (d) the rocket with its box and
     both cones, termination controller; (e) the quadrotor shape (B = 512),
     where the Taylor maps are streamed through shared memory, termination
     controller with trust 2, with its plan; (f) Taylor order 4 (the
     cartpole); (g) precision="default" at ct = 5 (the cartpole: the
     products of the iterations that neither check nor predict rho on the
     tensor cores, against the plain version's emulation of them), and at
     ct = 1 equal to "highest" bit for bit; (h) the quadrotor at N = 80
     (sw 1,276: tiles of 16 lanes, the products in passes), held to K1's
     bar, the lanes both solved (cuBLAS need not sum in index order at
     1,277 columns);
 11. the adaptive main path through the API at the quadrotor's full width:
     quadrotor.make_solver on "cuda" in fp32, B = 16,384, x0 ~ U(-0.3, 0.3)
     from seed 1, |u| <= 0.5, the termination controller floored at rho0 = 5,
     capped at 1e3, trust 2: solve_batch(method="fused") for 150 iterations
     with its carry, then parallel.two_phase_adaptive_solve with 2,048
     straggler slots and a 2,500-iteration warm continuation; convergence,
     stragglers, slot overflow and the rho span, each against the plain
     pipeline; kernel vs plain times of the bulk launch (median of 5) and
     the pipeline (median of 3); the continuation launch alone (the bulk
     pass's stragglers compacted into the 2,048 slots, warm from the
     kernel's carry, up to 2,500 iterations) against its plain version on
     the same inputs, timed (median of 3; the plain version once); for the
     bulk and the continuation launch the tile size, K2's tile iterations
     against the lanes' own and the bound;
 12. the adaptive single-instance solve() on the card: the quadrotor case of
     tests/golden/quadrotor_adaptive.npz in float64 (OSQP-form controller,
     the reference binary's finite-difference sensitivities) against the
     same solve on the CPU and the reference binary's record (the same
     iteration count, rho within 1e-9, controls within 1e-6);
 13. K1's group grid (K1d) vs plain, G problems x L lanes with per-group
     maps, rho and bounds: (a) cartpole G = 8 x L = 512, T12 staged per
     block; (b) the same with per-group state bounds (the generic path);
     (c) the rocket G = 4 x L = 1,000 (a ragged last tile in every group)
     with per-group cone coefficients; (d) quadrotor G = 4 x L = 128, the
     maps streamed through shared memory in slabs; (e) the kernel's 30 + 50
     warm chain against its 80-iteration solve, bit for bit;
 14. K1's reduced-precision product and head (K1c) vs plain, cartpole G = 8
     x L = 512: (a) a 16-iteration head inside a 96-iteration launch, and the
     same launch against the kernel's own (16, ct = 16, "default") launch
     chained into a warm fp32 launch, bit for bit; (b) precision="default"
     on the whole launch; (c) the quadrotor shape (the bf16 map streamed,
     the product on the tensor cores); (d) the latch recheck: every lane
     latched inside a reduced phase passes the tolerance when its latching
     iteration is recomputed in fp32 by the plain version from its carry;
 15. K2's group grid vs plain: (a) cartpole G = 8 x L = 512, OSQP-form
     controller, per-group plant data and rho0; (b) quadrotor G = 8 x L =
     512 (full width), termination controller with trust 2 around each
     group's rho0, 150 iterations with the carry, timed, with its tile
     iterations; then through
     GroupedBatchSolver (adaptive solve_batch(method="fused") and its
     two-phase pipeline with 256 slots a group and 500 more iterations);
 16. the randomised quadrotor sweep at full width through
     GroupedBatchSolver.make_fused_pipeline, drawn as the JAX package's
     bench row draws it (models/sweeps.py: G = 64 x L = 1,024, seed 4, 128
     reduced + 32 fp32 iterations, 256 slots a group, 1,500 more with a
     512-iteration reduced head): convergence (>= 99%), per-group overflow,
     the merged results against the same pipeline on the plain versions,
     the kernel's time (median of 3) beside the plain version's (one
     timing: its reduced phases take tens of seconds), solves/s; the
     unstaged pipeline (160 fp32 + 1,500 fp32) against its plain version
     at the tight bar and timed once; one launch of each bulk phase (K1d:
     160 fp32 iterations; K1c: 128 reduced ones) timed beside its plain
     version, with the tile iterations it ran; as a yardstick only (not the same
     function), the same products alone: 160 cuBLAS torch.bmm of the 64
     maps by (316 x 1,024) iterates; the kernel-side layouts of the 64
     maps, which every launch makes anew, timed on their own;
 17. the rocket sweep with per-group cone coefficients (G = 16 x L = 2,048,
     seed 6, 24 "default" + 48 fp32 iterations, 256 slots, 400 more): the
     same checks, and the cones within 5e-3 on every solved lane;
 18. kernel K3 (the per-stage fused ADMM) vs plain: the cartpole shape
     (4,093 of the 4,096 lanes of phase 3, a ragged last tile; |u| <= 5, 100
     iterations) at (a) ct = 1, (b) ct = 4, (c) with the cart position held
     to |x_0| <= 0.3 and initial velocities doubled, so that the state box
     binds; (d) the quadrotor shape (B = 512, |u| <= 0.5, rho 5, 500
     iterations); (e) rho as a float and no input bound (|u| <= 0.5 then
     left), 30 iterations; (f) the quadrotor at ct = 4, 302 iterations;
     each with its lane group, tile and the warps an SM holds;
 19. K3's path at full width through make_fused_solver: the cartpole
     headline batch (the 65,536 lanes of phase 6, tol 1e-3, 100 iterations)
     and the quadrotor (the 16,384 lanes of phase 11, fixed rho 5, 500
     iterations): one launch each, convergence, the results against the
     plain version, paired times; beside each, K1 on the same problem with
     alpha 1, ct 1 and the same budget: the share of lanes on which the two
     kernels' iteration counts agree (both are the same ADMM; >= 99%) and
     their paired times; beside K3's bound, an estimate of its
     dependent-chain floor: the slowest lane's iterations x (N - 1) stages
     x the fmaf chain of a stage, nx + nu deep forward (K x_k, then B u_k)
     and nx deep backward (AmBKt p_{k+1}; r_k, K' r_k and d_k are off the
     chain), at an assumed 4 cycles an fmaf and the card's largest SM clock
     (adds, shuffles and loads left out, so the true chain is longer);
 20. the fused MPC loop at full width through make_fused_mpc_loop: the
     cartpole plant, |u| <= 5, alpha 1.7, 100 iterations a step, 8,192
     plants drawn U(-0.5, 0.5) from seed 3, 100 control steps, every solve a
     K1 launch chained through its carry (100 launches counted): share of
     (plant, step) solved >= 99%; per-(plant, step) iteration counts and
     applied controls against the same loop on K1's plain version; paired
     times (the plain loop timed once), closed-loop steps/s, the host's
     enqueue time of a loop; one warm launch at the loop's shape timed
     beside its plain version, and the map layouts (made once for a
     solver's maps) on their own; the warm launch on K1's warp layout (the
     plan's at the cartpole's narrow map) against tiles of 32 lanes forced,
     bit for bit, timed in turns, with its lane groups' iterations and the
     queue model's critical path against the lanes' own;
 21. the two other loops on the card in float64: run_mpc_loop (2 cartpole
     plants x 25 steps; the adaptive-rho case, 10 steps) against the same
     loop on the CPU (equal iteration counts, controls within 1e-6, equal
     final rhos), and run_mpc_loop_condensed with the rocket's moving
     references (15 steps) against run_mpc_loop (equal counts, 1e-9);
 22. the bucketed exact-rebuild pipeline (parallel.rebuild) on the mis-set
     cartpole of the JAX bench row misset_rho_adaptive: B = 4,096, rho0 =
     0.01, |u| <= 5, |x_0| <= 2, x0 from seed 5, buckets over [1e-4, 1e4]
     (5), 50 fixed-rho0 iterations on K1, the rho prediction, 450 more on
     K1d over 5 x 4,096 slots (pad slots zero-filled): convergence (>= 95%
     and more than the control), mean iterations, rho span and overflow; the
     merged per-lane results against the same pipeline on the plain version;
     pipeline kernel vs plain (median of 3) beside the fixed-rho0 control
     (K1, 500 iterations); the phase-2 launch alone vs plain, with its tile
     iterations and its tiles of pad slots only (on the warp layout: its
     lane groups' iterations, the queue model's critical path and the live
     slots by bucket, and the launch against tiles of 32 forced, bit for
     bit, timed in turns); the standard per-update
     rebuild (adaptive_rho_rebuild on the standard path, a Riccati fixed
     point per lane update) on 16 lanes as a quality reference;
 23. the same on the mis-set quadrotor (misset_rho_quadrotor): rho0 =
     0.05, |u| <= 0.5, seed 1, buckets over [1e-3, 1e3] (4), phase 2 on K1d
     over 4 x 4,096 slots with the map streamed; no standard reference;
 24. the requantized adaptive continuation (the JAX quadrotor_adaptive
     row's phase 2, parallel.pipeline.requantized_adaptive_solve) on phase
     11's 16,384 lanes: K2's bulk pass, each straggler's rho snapped onto
     exact caches at rho0 + {0, 1, 2}, 2,048 slots a bucket, K1d with a
     256-iteration reduced head (K1c) for up to 2,500 iterations: >= 99%
     converged, the merged results against the plain pipeline, times
     (median of 3) beside phase 11's two-phase pipeline and the same
     pipeline without the head; the continuations alone from one bulk carry:
     K2's and the requantized launch with and without its head;
 25. the long horizon in float64: the cartpole at N = 1,537, whose condensed
     maps exceed the 256 MiB budget, so solve() and solve_batch("auto")
     take the chunked recursions (chunks of 128 stages): card against CPU
     (equal counts, controls within 1e-9), and on the card the associative
     scans and the chunked path against the sequential recursions;
 26. checkpoint: float64 constrained cartpoles on the card (defaults, and
     relaxation_alpha=1.7) run 10 closed-loop solve() steps, are saved and
     loaded onto the card, and both run 10 more: equal counts and controls
     bit for bit; phase 5's float32 cartpole the same, then
     solve_batch(method="fused") at B = 65,536 on the saved and the loaded
     solver (K1 from maps built after the load): equal outputs bit for bit,
     both timed (median of 3); file size, save and load seconds;
 27. export: utils.export of the single solve (cartpole, float64) and of
     the batched solve (cartpole, B = 4,096, float32), made, loaded and
     called on the card, against the eager admm.solve / batch.solve_batch:
     equal per-lane counts, controls within 1e-12 and 1e-5; the loaded
     program's time beside the eager call's (median of 5, CUDA events);
 28. the LQR sensitivities (compute_sensitivity_autograd and _fd) of the
     cartpole and the quadrotor in float64, card against CPU: within 1e-9
     and 1e-6 of the largest entry;
 29. utils.profiling.trace around one fused solve_batch (B = 65,536): the
     Chrome trace must hold K1's kernel among its device events (one, the
     launch counter's one); solve_stats of the result;
 30. codegen of phase 26's float64 solver (resident on the card), compiled
     with g++ and run: its count and controls (1e-9) against the port's
     solve(); native.NativeSolver (native/tinympc_native.cpp built with
     g++) on the port's cartpole cache: status and controls (1e-9) against
     the port's; a missing g++ fails the phase;
 31. the flagship example, examples.batched_scenario_sweep.main(B=65,536,
     device="cuda"): 65,536 quadrotor lanes (nx 12, nu 4, N 20, fp32, |u|
     <= 0.5, max_iter 500) through solve_sharded in a one-rank gloo group,
     so that the vote's all_reduce runs every iteration; equal to
     solve_batch on the same batch bit for bit; 256 of its lanes against
     solve_batch on the CPU (equal counts and flags on every lane, |du|
     <= 1e-5, the bar of tests/test_torch_condensed_kernel.py for fp32
     results of two implementations); at least
     97.5% of the lanes solved (64,272 on the H100); the solved count, the
     iteration statistics and the timed solve's wall time;
 32. dryrun.dryrun_multichip(2, device="cuda", full=True): two gloo ranks
     sharing cuda:0 (NCCL takes one rank a device), each holding its block
     bit for bit against the same block run in its own process: leg 1
     phase 31's batch, 32,768 lanes a rank, vote on and off; leg 2 the
     headline three-phase pipeline of phase 6 through map_shards, 65,536
     lanes, 4,096 slots a rank (K1 launched in every rank); leg 3 the
     mis-set cartpole rebuild of phase 22 at 4,096 lanes, 2,048 a rank
     (K1d launched in every rank, rho moved); legs 2 and 3 also against
     the same pipeline on the plain K1 (condensed_fused_reference) in the
     rank, at the kernel-vs-plain bar below, with lane rho and overflow
     as in phase 22 for leg 3; converged counts and each leg's wall time
     a rank;
 33. the nine other examples' main(device="cuda") in the quick arguments
     of tests/test_examples.py, each with its CPU test's assertion (the
     swing-up with --no-gif, the codegen projects into a temporary
     directory), each timed;
 34. K1 at maps wider than a tile's w2 in shared memory leaves room for,
     on its cluster layout (a tile split over a thread block cluster, its
     size weighed by the SMs the card's occupancy API says each size
     keeps busy, printed beside the CPU tests' table), each against its
     plain version and beside a product yardstick, each printing its plan
     (the cluster, the launch's blocks, how many run at once on how many
     SMs): (a) the quadrotor at N = 150 (sw 2,396), B = 8,192, 100
     iterations, alpha 1.7, ct 1, |u| <= 0.5, also forced onto w2 in
     global memory (the layout past a cluster of 8's slices) against its
     plain version and bit-equal to the cluster, and the widest map
     whose w2 fits in shared memory (N = 99) on its plan (the cluster)
     and forced onto w2 in shared memory, bit-equal, both timed; (b) the
     same with a 32-iteration bf16
     head (K1c); (c) the group grid (K1d) on 8
     quadrotors randomised as models/sweeps.py draws them (seed 4), built
     at N = 150, x 1,024 lanes; (d) the quadrotor at N = 387 (sw 6,188,
     the JAX package's condensed budget), B = 4,096, 50 iterations; (e)
     the carry chain (K1b), two launches of 50
     equal to one of 100 bit for bit and against the plain chain;
 35. K2 on its cluster layout (the quadrotor at N = 150 and 213, B =
     2,048, 150 iterations, the termination controller, rho0 5, trust 2;
     plan and yardstick printed as in 34) and its OSQP-form controller on
     the 20-state chain (10 unit
     masses on unit springs, nx 20, nu 9, N = 20, B = 4,096, 150
     iterations; the 4-lane layout in 2 + 2 passes, also against 2 lanes a
     thread forced, bit-equal, timed in turns), each against its plain
     version, rho included; at N =
     150 the launch also forced onto the iterates in global memory (the
     layout past a cluster of 8's slices) against its plain version and
     bit-equal to the cluster; at N = 213 the lanes with equal counts that
     did not solve, the kernel's and the fp32 plain version's distance
     from the plain version in float64; at N = 90 the plan's cluster and
     the tiles of 16 lanes in shared memory (both products in passes)
     forced on the same launch, fp32, precision='default' at ct 5 and the
     OSQP-form controller (rho in [3, 7]), bit-equal, both timed, the
     cluster's OSQP-form launch also against its plain version (one timed
     run) with its bound;
 11w. (run after 35) the adaptive pipeline's bulk pass at the
     quadrotor's N = 40 (sw 636): K2 at B = 16,384, 150 iterations, the
     termination controller floored at rho0 = 5 with trust 2, the carry
     out, on the 4-lane layout in 2 + 2 passes, against its plain version
     and against 2 lanes a thread forced (bit-equal, timed in turns), with
     its bound;
 4w. (run after 11w) K1 at the quadrotor's N = 40 (sw 636) at full batch:
     B = 16,384, fp32, |u| <= 0.5, alpha 1.7, ct 4, 150 iterations, cold,
     the carry out, on the 4-lane layout in 2 passes of 320 rows, against
     its plain version and against 2 lanes a thread forced (bit-equal,
     timed in turns), with its plan, its tile iterations against the
     lanes' own and its bound;
 36. K1e on the chain: a state stage of 20 entries with 10 cones of dim 2
     (mu 0.5), 4 halfspace rows and the state box, B = 16,384, 200
     iterations (the lanes do not converge: every lane compared), the
     stages projected in each thread's buffer in shared memory, forced
     into the global scratch, and forced onto a cluster of 2 blocks (each
     projecting its own stages), bit-equal, all timed; the launch and its
     box-only launch (tolerances 0) on the plan's 4-lane layout in 2
     passes against 2 lanes a thread forced, bit-equal, timed in turns;
 37. K3's wide variant on the chain (lane groups of 8, B = 16,384, 200
     iterations) and its far layout (the lanes' records in global memory,
     streamed through each lane group's ring) on the quadrotor at N = 300
     without and with |x| <= 2 (B = 16,384, 100 iterations), each against
     its plain version, each plan with its blocks an SM, registers, local
     (spill) bytes and lane slots, the far rows with their workspace
     stream floor beside the FLOP bound (also in the kernels line); and
     the far layout forced at N = 173 with |x| <= 2, bit-equal to the
     near one, both timed;
     phases 34-37 hold each case to the bar below, counted on every lane
     with equal counts and flags (solved or not; K2's values on those
     that solved, the max over all of them printed beside it), and print
     the kernel's
     median of 3 after a warm-up, the plain version's (its one comparison
     run where it takes seconds), the launches of the first run and the
     bound;
then the kernels' JSON line, the card's name and power limit, and the
result line.  K1's launches are counted over phases 5 and 6, K1e's (the
launches that run projections) over phase 8, K2's over phase 11 (its warm
continuation's, K2's warm launches, over the same phase), K1d's (the
launches over more than one group) and K1c's (those with reduced iterations)
over the first runs of the two sweeps in phases 16 and 17, the K2 grid's over
the GroupedBatchSolver calls of phase 15, K3's over the two full-width
solves of phase 19, the carry chain's (K1 launched warm from a carry) over
the MPC loop of phase 20, the rebuild's K1d rows over the first pipeline
run of phases 22 and 23 and the requantized continuation's over the first
run of phase 24, each from 0 just before the phase
and on its first, untimed runs; phase 32's ranks count K1 and K1d in their
own processes from 0 just before legs 2 and 3 and report the counts.  The
times of phases 31-33 are wall times of host-bound launch loops (two ranks
on one card in phase 32), not scaling numbers.  The agreement bar
of every kernel-vs-plain comparison: identical per-lane iteration counts on
>= 99% of lanes (fp32 sums in another order may move a lane that sits on the
tolerance by one check interval) and 1e-4 on the controls and states of
lanes with equal counts that both solved, and on the carry, where there is
one, of lanes with equal counts; for K2 the states, controls and carry of
every lane with equal counts (a carry entry relative to the larger of 1 and
its magnitude) and the lane's final rho within rtol 1e-4.  Every comparison
also prints how many lanes differ at all (count, flag, a state, a control
or rho not the same bits).

A launch or a pipeline with reduced-precision iterations (phases 4b, 6
staged, 10g, 14a-c, 16 and 17 staged, 16 K1c) is held to the same bar: both sides round
to bf16 exactly and the plain version sums the products as the tensor cores
do (``mma_product``), so a kernel whose reduced product were wrong (no
rounding, a truncation, the fp32 map) would move the lanes' counts and fail
it.

Each kernel's ``bound_ms`` is the least time the card could take for the
timed launch: the larger of its operations (the matvecs' multiply-adds on
the iterations its lanes really ran) over the H100's 67 TFLOP/s fp32 rate
(for the reduced-precision launch: the reduced products its lanes ran,
counted from their iteration counts and the check interval, over the data
sheet's 989 TFLOP/s dense bf16 tensor-core rate, and the fp32 products of
their checking iterations over the fp32 rate) and its bytes (each input read once, each output written
once) over 3.35 TB/s; for K3 the operations are the per-stage products,
(N-1)(4 nx^2 + 8 nx nu + 2 nu^2) a lane-iteration.  ``library_ms`` is null: no
single PyTorch call computes an ADMM solve.
"""
import functools
import json
import math
import subprocess
import time
from pathlib import Path

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
G_CHECK, L_CHECK = 8, 512  # the grouped kernel-vs-plain cases
L_ROCKET, L_QUAD = 1000, 128
B_ADAPT = 16384
SLOTS_ADAPT = 2048
B_WIDE = 2048  # lanes of K1's wide-map checks (the quadrotor at N = 40, 57)
RHO_RTOL = 1e-4
RHO_ATOL64 = 1e-9
DEEP_REPS = 3  # timed turns of the pipelines that take seconds a run
# phase 31's lanes held against the CPU, at the port's bar for fp32
# results of two implementations (tests/test_torch_condensed_kernel.py)
SWEEP_CPU_LANES = 256
SWEEP_DU_CPU = 1e-5
SWEEP_SOLVED = 0.975  # phase 31's floor; the H100 solved 64,272 of 65,536
PEAK_FP32 = 67e12    # H100 SXM, fp32 outside the tensor cores, FLOP/s
PEAK_BF16 = 989e12   # H100 SXM, dense bf16 in the tensor cores, FLOP/s
PEAK_BYTES = 3.35e12  # H100 SXM, HBM3, bytes/s


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


SLOW_PLAIN_MS = 1000.0  # a plain version this slow is timed once


class PhaseClock:
    """Prints each phase's wall seconds (host clock) when the next begins."""

    def __init__(self):
        self.name, self.t = None, time.perf_counter()

    def mark(self, name=None):
        now = time.perf_counter()
        if self.name is not None:
            print(f"phase {self.name} wall {now - self.t:.1f} s", flush=True)
        self.name, self.t = name, now


WALL = PhaseClock()


def timed_once(fn):
    """``fn()`` and its ms, one CUDA-event timing (a plain version that
    takes seconds: its comparison run is its one timing)."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def paired_ms(f_kernel, f_plain, reps=5, plain_reps=None):
    """Median ms of each over ``reps`` turns after one warm-up each, the
    order alternating (plain, kernel, kernel, plain, ...).  With
    ``plain_reps`` (a plain version that takes seconds, run by the caller
    just before) the plain version gets no warm-up and only the first
    ``plain_reps`` turns (0: none, the caller timed it: its plain time is
    NaN).  A plain version whose warm-up takes over SLOW_PLAIN_MS is timed
    once, by that run (printed as one timing)."""
    n_plain = reps if plain_reps is None else plain_reps
    if plain_reps is None:
        t_first = event_ms(f_plain)
        if t_first > SLOW_PLAIN_MS:
            f_kernel()
            tk = [event_ms(f_kernel) for _ in range(reps)]
            print(f"(the plain version above {SLOW_PLAIN_MS:.0f} ms: one "
                  f"timing, {t_first:.3f} ms)", flush=True)
            return float(np.median(tk)), t_first
    f_kernel()
    tk, tp = [], []
    for r in range(reps):
        if r % 2 == 0 and r < n_plain:
            tp.append(event_ms(f_plain))
        tk.append(event_ms(f_kernel))
        if r % 2 == 1 and r < n_plain:
            tp.append(event_ms(f_plain))
    return float(np.median(tk)), float(np.median(tp)) if tp else math.nan


def forced(mod, name, plan, f):
    """``f`` with ``mod``'s wrapper made to launch ``plan``."""
    from unittest import mock

    def run():
        with mock.patch.object(mod, name, lambda *a, **k: plan):
            return f()
    return run


def describe_plan(plan):
    """A K1 or K2 plan's layout as phases 4, 10e, 11, 20, 22 and 24 print
    it (a plan of one block a tile, or K1's warp layout)."""
    if getattr(plan, "warps", 0):
        return (f"the warp layout: lane groups of {plan.tile} lanes, a warp "
                f"each, up to {plan.warps} warps a block taking lane groups "
                f"from the launch's queue, 8 rows x {plan.lanes} lanes a "
                f"thread in the fp32 product, the map resident, "
                f"{plan.smem} bytes of shared memory")
    passes = (plan.passes if hasattr(plan, "passes")
              else f"{plan.passes1} + {plan.passes2}")
    ring = ("by the bulk copy engine, no block barrier a slab"
            if plan.bulk_ring else "by cp.async, a block barrier a slab")
    return (f"tiles of {plan.tile} lanes, {plan.cluster} block(s) a tile, "
            f"{plan.lanes} lanes x {2 * plan.rpt // plan.lanes} rows a "
            f"thread in the fp32 product, slabs of {plan.slab_k} k-rows "
            f"{ring}, {passes} passes, {plan.smem} bytes of shared memory")


def iteration_report(counts, plan, groups, sms, sw, state):
    """A K1 launch's iterations as phases 20 and 22 print them: the lanes'
    mean and largest counts; the tiles' (or lane groups') iterations, each
    its slowest lane's count, against the lanes' own; with the warp layout
    (a map of ``sw`` rows, ``state`` floats a lane, its staged carry
    included) its blocks a group,
    warps a block and blocks at once (the occupancy API) and the queue
    model's critical path (``queue_iterations``), beside what tiles of 32
    lanes run."""
    from tinympc_julia_tpu_torch.ops.cuda.condensed_kernel import (
        TILE, launch_warps, queue_iterations, tile_iterations,
        tile_occupancy, warp_smem)
    own = int(counts.sum())
    out = (f"lanes' mean count {counts.float().mean().item():.2f}, largest "
           f"{int(counts.max())}")
    t32 = tile_iterations(counts, TILE, groups)
    if not getattr(plan, "warps", 0):
        return (f"{out}; {t32} tile iterations, {TILE * t32 / own:.3f} x "
                "the lanes' own")
    per = -(-(counts.numel() // groups) // plan.tile)
    blocks, warps = launch_warps(plan, per, sms, tile_occupancy(plan))
    slots = sms * tile_occupancy(plan._replace(warps=warps),
                                 smem=warp_smem(sw, state, warps))
    n_lg = tile_iterations(counts, plan.tile, groups)
    crit = queue_iterations(counts, groups, blocks, warps, slots)
    return (f"{out}; {groups * per} lane groups of {plan.tile} ran {n_lg} "
            f"iterations ({plan.tile * n_lg / own:.3f} x the lanes' own) on "
            f"{blocks} blocks a group x {warps} warps, {slots} blocks at "
            f"once, the queue model's critical path {crit} iterations; "
            f"tiles of 32 would run {t32} ({TILE * t32 / own:.3f} x)")


def lanes_differ(out_k, out_p):
    """Lanes whose count, flag, states or controls (and rho, for K2) are not
    the same bits on both sides."""
    B = out_k[2].numel()
    d = (out_k[2] != out_p[2]) | (out_k[3] != out_p[3])
    for j in (0, 1):
        d |= (out_k[j] != out_p[j]).reshape(B, -1).any(dim=1)
    if len(out_k) > 4 and torch.is_tensor(out_k[4]):
        d |= out_k[4] != out_p[4]
    return int(d.sum())


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
          f"equal solved lanes {err:.3e}; lanes that differ at all "
          f"{lanes_differ(out_k, out_p)}", flush=True)
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


def adaptive_agreement(name, out_k, out_p, min_solved=None):
    """Per-lane agreement of K2 and its plain version: (x, u, iters, solved,
    rho[, carry]).  Returns the max |diff| of x and u and of the carry's d,
    y, g, v, z, each carry entry's taken relative to the larger of 1 and
    its magnitude (the duals are not of order 1), on lanes with equal
    counts; rho is held to RHO_RTOL there."""
    ik, sk, rk = out_k[2:5]
    ip, sp, rp = out_p[2:5]
    B = ik.numel()
    min_solved = B // 2 if min_solved is None else min_solved
    same = (ik == ip) & (sk == sp)
    frac = same.float().mean().item()
    err = max((out_k[j] - out_p[j])[same].abs().max().item() for j in (0, 1))
    if len(out_k) > 5:
        err = max([err] + [
            ((a - b).abs() / b.abs().clamp(min=1.0))[:, same].max().item()
            for a, b in zip(out_k[5][:5], out_p[5][:5])])
    rho_err = ((rk - rp).abs() / rp)[same].max().item()
    nk, npl = int(sk.sum()), int(sp.sum())
    print(f"{name}: iteration counts equal on {int(same.sum())}/{B} lanes "
          f"({frac:.4f}); solved kernel {nk}, plain {npl}; on lanes with "
          f"equal counts max |diff| {err:.3e}, rho rel. diff {rho_err:.3e}; "
          f"rho span [{rk.min().item():.4g}, {rk.max().item():.4g}]; lanes "
          f"that differ at all {lanes_differ(out_k, out_p)}", flush=True)
    check(frac >= ITERS_AGREE, f"{name}: counts agree on {frac:.4f} < "
          f"{ITERS_AGREE}")
    check(err <= ATOL, f"{name}: max |diff| {err:.3e} > {ATOL}")
    check(rho_err <= RHO_RTOL, f"{name}: rho differs by {rho_err:.3e}")
    check(nk >= min_solved, f"{name}: only {nk}/{B} lanes solved")
    check(all(bool(torch.isfinite(t).all()) for t in out_k[:2]),
          f"{name}: non-finite kernel output")
    return err


def tensor_bytes(*items):
    """Bytes of every tensor in ``items`` (tuples are walked, None skipped)."""
    n = 0
    for t in items:
        if isinstance(t, tuple):
            n += tensor_bytes(*t)
        elif t is not None:
            n += t.numel() * t.element_size()
    return n


def bound(flops, nbytes):
    """(least ms the card could take, what bounds it)."""
    t_ops, t_bytes = flops / PEAK_FP32, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def cone_violation(xs, us, mu_x, mu_u, solved):
    """Largest excess of ||w[0:2]|| over mu * w[2] at any stage of a solved
    lane, over the state and the input cones; a coefficient is a float or
    per-lane values (B, 1)."""
    ok = solved == 1
    ex = [(torch.linalg.vector_norm(w[ok][..., :2], dim=-1)
           - (mu[ok] if torch.is_tensor(mu) else mu) * w[ok][..., 2])
          .max().item()
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


def earlier_phases(card):
    """Phases 2-12: the cartpole, rocket and adaptive quadrotor paths; the
    rows of K1, K1e and K2 for the kernels line."""
    from tinympc_julia_tpu_torch import TinyMPCSolver, make_problem
    from tinympc_julia_tpu_torch.models import cartpole, quadrotor, rocket
    from tinympc_julia_tpu_torch.ops.condensed import (
        build_condensed, build_condensed_taylor)
    from tinympc_julia_tpu_torch.ops.cuda import adaptive_kernel as K2
    from tinympc_julia_tpu_torch.ops.cuda.adaptive_kernel import (
        AdaptiveFusedCarry, AdaptivePlant, adaptive_tile_plan,
        condensed_adaptive_cuda, condensed_adaptive_reference,
        shared_adaptive_plan)
    from tinympc_julia_tpu_torch.ops.cuda.condensed_kernel import (
        card_busy_sms, condensed_fused_cuda, condensed_fused_reference,
        fused_constraints, fused_tile_plan, problem_constraint_kw,
        tile_iterations)
    from tinympc_julia_tpu_torch.ops.cuda.layout_probe import (
        product_yardstick, same_bits)
    from tinympc_julia_tpu_torch.ops.riccati import precompute_cache
    from tinympc_julia_tpu_torch.parallel.pipeline import (
        ADAPTIVE_BUDGETS, STAGED, three_phase_solve, two_phase_adaptive_solve)
    from tinympc_julia_tpu_torch.parallel.rebuild import compact_members

    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
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
    WALL.mark("3")
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
    WALL.mark("4")
    qN = quadrotor.HORIZON
    assert qN == N
    pq, cq, mq = plant(quadrotor, quadrotor.U_HOVER_BOUND, quadrotor.RHO)
    plan_q = fused_tile_plan(12, 4, qN)
    x0_q = torch.as_tensor(np.random.default_rng(1).uniform(
        -0.3, 0.3, size=(B_QUAD, 12)), dtype=f32, device=dev)
    out_k, out_p = run_both(pq, cq, mq, x0_q, max_iter=1000,
                            check_termination=4, en_state_bound=False)
    errs.append(agreement(
        f"phase 4 quadrotor (sw=316, {describe_plan(plan_q)}, T12 in "
        f"shared memory: {plan_q.resident})", out_k, out_p))

    # -- phase 4b: K1's wide maps, the product in passes ---------------------
    WALL.mark("4b")
    for Nw in (40, 57):
        pw = make_problem(quadrotor.A, quadrotor.B,
                          np.diag(quadrotor.Q_DIAG), np.diag(quadrotor.R_DIAG),
                          quadrotor.RHO, Nw, u_min=-quadrotor.U_HOVER_BOUND,
                          u_max=quadrotor.U_HOVER_BOUND, dtype=f32,
                          device=dev)
        cw = precompute_cache(pw.A, pw.B, pw.Q, pw.R, pw.rho_setup)
        mw = build_condensed(pw, cw)
        sw_w = mw.T12.shape[0]
        x0_w = torch.as_tensor(np.random.default_rng(2).uniform(
            -0.3, 0.3, size=(B_WIDE, 12)), dtype=f32, device=dev)
        args_w = (mw, float(cw.rho), pw.u_min, pw.u_max, pw.x_min, pw.x_max,
                  x0_w, None)
        for mode, kw in (("fp32", dict(max_iter=400)),
                         ("precision='default'",
                          dict(max_iter=24, precision="default"))):
            full = dict(nx=12, nu=4, N=Nw, abs_pri_tol=1e-3,
                        abs_dua_tol=1e-3, en_input_bound=True,
                        relaxation_alpha=1.7, warm_start=False,
                        carry_out=False, check_termination=4,
                        en_state_bound=False, **kw)
            reduced = "precision" in kw
            n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
            plan_w = fused_tile_plan(12, 4, Nw, reduced,
                                     busy_sms=card_busy_sms,
                                     tiles=-(-B_WIDE // 32), sms=n_sm)
            f_k = functools.partial(condensed_fused_cuda, *args_w, **full)
            f_p = functools.partial(condensed_fused_reference, *args_w,
                                    **full)
            out_k, out_p = f_k(), f_p()
            kind = ("a cluster" if plan_w.cluster > 1 else
                    "the 4-lane layout" if plan_w.lanes == 4 else
                    "2 lanes a thread")
            errs.append(agreement(
                f"phase 4b K1 wide map, quadrotor N={Nw} (sw={sw_w}), {mode}, "
                f"{kw['max_iter']} iterations, B={B_WIDE}: the plan takes "
                f"{kind}, {plan_w.cluster} block(s) a tile, {plan_w.passes} "
                f"passes a block of {plan_w.width} rows ({plan_w.lanes} "
                f"lanes x {2 * plan_w.rpt // plan_w.lanes} rows a thread, "
                f"{plan_w.rows // plan_w.cluster} padded rows a block), T12 "
                f"{'resident' if plan_w.resident else 'streamed'}, state in "
                f"{'shared' if plan_w.state_shared else 'global'} memory, "
                f"{plan_w.smem} bytes of shared memory", out_k, out_p,
                min_solved=0 if reduced else None))
            if reduced:
                continue
            t_w, t_w_p = paired_ms(f_k, f_p, reps=3)
            n_it = int(out_k[2].sum())
            b_w = bound(2.0 * sw_w * sw_w * (n_it - B_WIDE)
                        + 2.0 * sw_w * 12 * B_WIDE,
                        tensor_bytes(mw.T12, mw.T1, *args_w[2:7], out_k))
            n_tile = tile_iterations(out_k[2], 32)
            # one SM a block
            busy = min(n_sm, -(-B_WIDE // 32) * plan_w.cluster)
            print(f"phase 4b K1 wide map sw={sw_w}, fp32 launch: kernel "
                  f"{t_w:.3f} ms, plain {t_w_p:.3f} ms (median of 3), bound "
                  f"{b_w[0]:.4f} ms by {b_w[1]}; {n_tile} tile iterations, "
                  f"{32 * n_tile / n_it:.3f} x the lanes' own, "
                  f"{1e3 * t_w * busy / n_tile:.3f} SM-us each on the "
                  f"{busy} busy SMs", flush=True)

    # -- phase 5: the main path through the API -----------------------------
    WALL.mark("5")
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
    WALL.mark("6")
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
                          "plain", res.lane_results(), res_p.lane_results()))

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

    sw_c = maps.T12.shape[0]
    k1_bound = bound(
        2.0 * sw_c * sw_c * (int(out_k[2].sum()) - B_MAIN)  # no matvec at i=0
        + 2.0 * sw_c * 4 * B_MAIN,
        tensor_bytes(maps.T12, maps.T1, *pipe_args[2:], out_k))
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
    # the staged headline (bench.py's _pipeline): phase 0 at "default" with
    # its one end check in fp32, a 96-iteration reduced head in phase 2
    res_s = three_phase_solve(*pipe_args, **pkw, **STAGED)
    torch.cuda.synchronize()
    res_sp = three_phase_solve(*pipe_args, fused=condensed_fused_reference,
                               **pkw, **STAGED)
    n_st, n_st_p = int(res_s.converged()), int(res_sp.converged())
    check(n_st >= 0.99 * B_MAIN, f"staged pipeline converged {n_st}/{B_MAIN}")
    check(abs(n_st - n_st_p) <= 0.01 * B_MAIN,
          f"staged pipeline converged {n_st} with the kernel, {n_st_p} plain")
    errs.append(agreement("phase 6 staged pipeline, merged per-lane results "
                          "vs plain", res_s.lane_results(),
                          res_sp.lane_results()))
    t_st, t_st_p = paired_ms(
        lambda: three_phase_solve(*pipe_args, **pkw, **STAGED),
        lambda: three_phase_solve(*pipe_args, fused=condensed_fused_reference,
                                  **pkw, **STAGED))
    t_st2, t_fp2 = paired_ms(
        lambda: three_phase_solve(*pipe_args, **pkw, **STAGED),
        lambda: three_phase_solve(*pipe_args, **pkw))
    print(f"phase 6 staged pipeline {STAGED}: {n_st} converged "
          f"({100.0 * n_st / B_MAIN:.2f}%; plain {n_st_p}), "
          f"{int(res_s.unconv.sum())} stragglers; median of 5: kernel "
          f"{t_st:.3f} ms, plain {t_st_p:.3f} ms -> "
          f"{n_st / (t_st * 1e-3):.0f} solves/s; paired with the fp32 "
          f"pipeline: staged {t_st2:.3f} ms, fp32 {t_fp2:.3f} ms on {card}",
          flush=True)

    # -- phase 7: K1e, the projections, kernel vs plain ---------------------
    WALL.mark("7")
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
    WALL.mark("8")
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
    out_e = kernel_chain(warm=None, **cold)
    sw_r = r_maps.T12.shape[0]
    k1e_bound = bound(
        2.0 * sw_r * sw_r * (int(out_e[2].sum()) - B_MAIN)
        + 2.0 * sw_r * 6 * B_MAIN,
        tensor_bytes(r_maps.T12, r_maps.T1, *r_args[2:], x0_rm, r_cons.lin_u,
                     r_cons.lin_x, r_cons.cones_u.mus, r_cons.cones_x.mus,
                     out_e))
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
    # ... and checking every iteration as the API does (ct = 1), at
    # tolerances 0 so that every lane still runs all 72
    full1 = dict(full, check_termination=1, abs_pri_tol=0.0,
                 abs_dua_tol=0.0)
    t_cones1, t_box1 = paired_ms(
        lambda: condensed_fused_cuda(*r_args, x0_rm, None, **full1),
        lambda: condensed_fused_cuda(*r_args, x0_rm, None,
                                     **dict(full1, constraints=None)))
    print(f"phase 8 rocket API chain B={B_MAIN}, fp32 24+48: {n_rock} "
          f"converged ({100.0 * n_rock / B_MAIN:.2f}%), mean iterations "
          f"{it_a.float().mean().item():.2f}, largest cone excess "
          f"{viol:.3e}; median of 5: chain kernel {t_chain:.3f} ms, plain "
          f"{t_chain_p:.3f} ms -> {n_rock / (t_chain * 1e-3):.0f} solves/s "
          f"on {card}; one cold 72-iteration launch {t_e:.3f} ms, plain "
          f"{t_e_p:.3f} ms; 72 iterations on every lane: with the cones "
          f"{t_cones:.3f} ms, box only {t_box:.3f} ms "
          f"({t_cones / t_box:.3f}x per iteration); checking every "
          f"iteration (ct=1, tolerances 0): with the cones {t_cones1:.3f} "
          f"ms, box only {t_box1:.3f} ms ({t_cones1 / t_box1:.3f}x)",
          flush=True)

    # -- phase 9: the single-instance solve() on the card, float64 -----------
    WALL.mark("9")
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

    # -- phase 10: K2, per-lane adaptive rho, kernel vs plain ---------------
    WALL.mark("10")
    def k2_kw(pp, cc, **kw):
        full = dict(plant=AdaptivePlant(pp.A, pp.B, pp.Q, pp.R, cc.Pinf,
                                        cc.dPinf_drho),
                    nx=pp.nx, nu=pp.nu, N=pp.N, max_iter=200,
                    abs_pri_tol=1e-3, abs_dua_tol=1e-3, en_state_bound=False,
                    en_input_bound=True, relaxation_alpha=1.0,
                    adaptive_rho_min=0.5, adaptive_rho_max=5.0,
                    adaptive_rho_clipping=True, check_termination=1,
                    controller="osqp", taylor_trust=float("inf"),
                    warm_start=False, carry_out=True)
        full.update(kw)
        return full

    def k2_both(pp, cc, tmaps, x0s, warm=(None, None), **kw):
        """K2 and its plain version on the same inputs; ``warm`` is the pair
        of carries (kernel's, plain's) of an earlier call."""
        full = k2_kw(pp, cc, warm_start=warm[0] is not None, **kw)
        args = (tmaps, pp.u_min, pp.u_max, pp.x_min, pp.x_max, x0s)
        return (condensed_adaptive_cuda(*args, warm[0], **full),
                condensed_adaptive_reference(*args, warm[1], **full))

    a_errs = []
    pa, ca, _ = plant(cartpole, 5.0, 1.0)
    ta = build_condensed_taylor(pa, ca)
    out_k, out_p = k2_both(pa, ca, ta, x0_check)
    a_errs.append(adaptive_agreement(
        "phase 10a cartpole, OSQP-form controller, rho in [0.5, 5]", out_k,
        out_p))
    check(bool((out_k[4] != 1.0).any()), "phase 10a: no lane moved its rho")
    pb, cb, _ = plant(cartpole, 5.0, 1.0,
                      x_bound=np.array([0.5, 1e17, 1e17, 1e17]))
    x0_b = x0_check * torch.tensor([0.9, 3.0, 0.8, 1.0], device=dev)
    out_k, out_p = k2_both(pb, cb, build_condensed_taylor(pb, cb), x0_b,
                           en_state_bound=True)
    a_errs.append(adaptive_agreement(
        "phase 10b cartpole |x_0| <= 0.5, generic g path", out_k, out_p))
    g_max = out_k[5].g.abs().max().item()
    print(f"phase 10b: largest state dual {g_max:.3e}", flush=True)
    check(g_max > 0.0, "phase 10b: the state dual never left 0")
    h_k, h_p = k2_both(pa, ca, ta, x0_check, max_iter=30)
    a_errs.append(adaptive_agreement("phase 10c chain, first 30", h_k, h_p,
                                     min_solved=0))
    t_k, t_p = k2_both(pa, ca, ta, x0_check, warm=(h_k[5], h_p[5]),
                       max_iter=50)
    a_errs.append(adaptive_agreement("phase 10c chain, 50 warm", t_k, t_p,
                                     min_solved=0))
    rt = build_condensed_taylor(rp, rc)
    out_k, out_p = k2_both(rp, rc, rt, x0_r, controller="termination",
                           en_state_bound=True, abs_pri_tol=rs.abs_pri_tol,
                           abs_dua_tol=rs.abs_dua_tol, adaptive_rho_min=1.0,
                           adaptive_rho_max=100.0, max_iter=100,
                           constraints=r_cons)
    a_errs.append(adaptive_agreement(
        "phase 10d rocket (box + 2 cones), termination controller", out_k,
        out_p))
    viol = cone_violation(out_k[0], out_k[1], mu_x, mu_u, out_k[3])
    check(viol <= CONE_TOL, f"phase 10d: cone excess {viol:.3e}")
    quad_kw = dict(controller="termination", taylor_trust=2.0,
                   adaptive_rho_min=quadrotor.RHO, adaptive_rho_max=1e3)
    tq = build_condensed_taylor(pq, cq)
    out_k, out_p = k2_both(pq, cq, tq, x0_q, max_iter=300, **quad_kw)
    plan_10e = adaptive_tile_plan(12, 4, qN, 2, tiles=-(-B_QUAD // 32),
                                  sms=n_sm)
    a_errs.append(adaptive_agreement(
        f"phase 10e quadrotor (sw=316, {describe_plan(plan_10e)}, maps "
        f"{'resident' if plan_10e.resident else 'streamed'}), termination "
        "controller, "
        "trust 2", out_k, out_p))
    # any Taylor order; the reduced-precision products
    t4 = build_condensed_taylor(pa, ca, order=4)
    out_k, out_p = k2_both(pa, ca, t4, x0_check)
    a_errs.append(adaptive_agreement(
        "phase 10f cartpole, Taylor order 4 (five T1 blocks in turn), "
        "OSQP-form controller", out_k, out_p))
    n_red = condensed_adaptive_cuda.reduced_launches
    out_k, out_p = k2_both(pa, ca, ta, x0_check, check_termination=5,
                           precision="default")
    check(condensed_adaptive_cuda.reduced_launches == n_red + 1,
          "phase 10g: the launch ran no reduced iterations")
    a_errs.append(adaptive_agreement(
        "phase 10g cartpole, precision='default' at ct=5 (the products of "
        "the iterations that neither check nor predict rho on the tensor "
        "cores, 121 of 200)", out_k, out_p, min_solved=0))
    # the quadrotor at N = 80: the iterates of 32 lanes leave no room beside
    # the slab ring, so tiles of 16 lanes
    pw = make_problem(quadrotor.A, quadrotor.B, np.diag(quadrotor.Q_DIAG),
                      np.diag(quadrotor.R_DIAG), quadrotor.RHO, 80,
                      u_min=-quadrotor.U_HOVER_BOUND,
                      u_max=quadrotor.U_HOVER_BOUND, dtype=f32, device=dev)
    cw = precompute_cache(pw.A, pw.B, pw.Q, pw.R, pw.rho_setup)
    plan_w = adaptive_tile_plan(12, 4, 80, 2)
    out_k, out_p = k2_both(pw, cw, build_condensed_taylor(pw, cw), x0_q,
                           max_iter=300, **quad_kw)
    a_errs.append(agreement(
        f"phase 10h quadrotor N=80 (sw=1276, tiles of {plan_w.tile} lanes "
        f"on {plan_w.cluster} block(s), "
        f"{plan_w.rpt} rows a thread in {plan_w.passes1} + "
        f"{plan_w.passes2} passes, {plan_w.smem} bytes of shared memory), "
        "termination controller, trust 2", out_k, out_p))
    hi_k, _ = k2_both(pa, ca, ta, x0_check)
    lo_k = condensed_adaptive_cuda(ta, pa.u_min, pa.u_max, pa.x_min,
                                   pa.x_max, x0_check, None, **dict(
                                       k2_kw(pa, ca), precision="default"))
    same_ct1 = all(torch.equal(a, b) for a, b in zip(
        hi_k[:5] + tuple(hi_k[5]), lo_k[:5] + tuple(lo_k[5])))
    print(f"phase 10g precision='default' at ct=1 equals 'highest' bit for "
          f"bit: {same_ct1}", flush=True)
    check(same_ct1, "phase 10g: precision='default' at ct=1 differs from "
          "'highest'")

    # -- phase 11: the adaptive main path at the quadrotor's full width ------
    WALL.mark("11")
    x0_a = torch.as_tensor(np.random.default_rng(1).uniform(
        -0.3, 0.3, size=(B_ADAPT, 12)), dtype=f32, device=dev)
    q_solver = quadrotor.make_solver(dtype=f32, device="cuda")
    q_solver.update_settings(
        adaptive_rho=True, adaptive_rho_controller="termination",
        adaptive_rho_taylor_trust=2.0, adaptive_rho_min=quadrotor.RHO,
        adaptive_rho_max=1e3, max_iter=150)
    condensed_adaptive_cuda.launches = 0
    condensed_adaptive_cuda.warm_launches = 0
    xs, us, it, ok, carry = q_solver.solve_batch(x0_a, method="fused",
                                                 return_carry=True)
    torch.cuda.synchronize()
    check(tuple(us.shape) == (B_ADAPT, qN - 1, 4), f"controls {us.shape}")
    check(bool(torch.isfinite(us).all()) and bool(torch.isfinite(xs).all()),
          "non-finite adaptive API solutions")
    check(float(us.abs().max()) <= quadrotor.U_HOVER_BOUND + 1e-5,
          "|u| beyond its bound")
    qp, qc = q_solver.problem, q_solver.cache
    tqa = build_condensed_taylor(qp, qc)
    bulk_args = (tqa, qp.u_min, qp.u_max, qp.x_min, qp.x_max, x0_a, None)
    bulk_kw = dict(plant=None, nx=12, nu=4, N=qN, max_iter=150,
                   abs_pri_tol=1e-3, abs_dua_tol=1e-3, en_state_bound=False,
                   en_input_bound=True, relaxation_alpha=1.0,
                   adaptive_rho_clipping=True, check_termination=1,
                   warm_start=False, carry_out=True, **quad_kw)
    bulk_p = condensed_adaptive_reference(*bulk_args, **bulk_kw)
    a_errs.append(adaptive_agreement(
        "phase 11 API solve_batch(method='fused'), adaptive, 150 iterations "
        "vs plain", (xs, us, it, ok, carry.data.rho[0], carry.data), bulk_p,
        min_solved=0))
    pipe_a = bulk_args[:6]
    akw = dict(nx=12, nu=4, N=qN, straggler_slots=SLOTS_ADAPT)
    res_a = two_phase_adaptive_solve(*pipe_a, **akw)
    torch.cuda.synchronize()
    a_launches = condensed_adaptive_cuda.launches
    c_launches = condensed_adaptive_cuda.warm_launches
    check(a_launches == 3 and c_launches == 1,
          f"the adaptive main path launched K2 {a_launches} times, not 3 (one "
          f"API solve, two pipeline phases), {c_launches} of them warm, not "
          "1 (the continuation)")
    res_ap = two_phase_adaptive_solve(*pipe_a,
                                      fused=condensed_adaptive_reference,
                                      **akw)
    n_a, n_ap = int(res_a.solved.sum()), int(res_ap.solved.sum())
    check(abs(n_a - n_ap) <= 0.01 * B_ADAPT,
          f"adaptive pipeline converged {n_a} with the kernel, {n_ap} plain")
    check(bool(torch.isfinite(res_a.us).all())
          and bool(torch.isfinite(res_a.xs).all()),
          "non-finite adaptive pipeline solutions")
    a_errs.append(adaptive_agreement(
        "phase 11 two-phase adaptive pipeline, merged per-lane results vs "
        "plain", (res_a.xs, res_a.us, res_a.iters, res_a.solved, res_a.rho),
        (res_ap.xs, res_ap.us, res_ap.iters, res_ap.solved, res_ap.rho),
        min_solved=0))
    t_ap, t_ap_p = paired_ms(
        lambda: two_phase_adaptive_solve(*pipe_a, **akw),
        lambda: two_phase_adaptive_solve(
            *pipe_a, fused=condensed_adaptive_reference, **akw),
        reps=DEEP_REPS)
    t_k2, t_k2_p = paired_ms(
        lambda: condensed_adaptive_cuda(*bulk_args, **bulk_kw),
        lambda: condensed_adaptive_reference(*bulk_args, **bulk_kw))
    # the bulk launch's plan from its batch (the 4-lane layout), and the
    # layout it replaced (2 lanes a thread) forced beside it: the same bits
    # as that and as the plain version, timed in turns
    plan_a = adaptive_tile_plan(12, 4, qN, 2, tiles=-(-B_ADAPT // 32),
                                sms=n_sm)
    f_bk = functools.partial(condensed_adaptive_cuda, *bulk_args, **bulk_kw)
    f_bo = forced(K2, "adaptive_tile_plan",
                  shared_adaptive_plan(12, 4, qN, 2), f_bk)
    out_b = f_bk()
    same_b, same_bp = same_bits(out_b, f_bo()), same_bits(out_b, bulk_p)
    print(f"phase 11 bulk plan: {describe_plan(plan_a)}; 2 lanes a thread "
          f"forced (the layout before it) bit-equal {same_b}, the plain "
          f"version bit-equal {same_bp} (lanes that differ "
          f"{lanes_differ(out_b, bulk_p)})", flush=True)
    check(same_b and same_bp, "phase 11: the bulk launch differs from its "
          "layout of 2 lanes a thread or from the plain version")
    t_b, t_bo = paired_ms(f_bk, f_bo, reps=4)
    ord1, sw_q, in1_q = tqa.T1s.shape
    su_q = tqa.T2s.shape[1]
    k2_flops = 2.0 * (ord1 * sw_q * in1_q + 4 * su_q * (sw_q + 1))
    k2_bound = bound(
        k2_flops * int(it.sum()),
        tensor_bytes(tqa.T1s, tqa.T2s[:, :, :sw_q], tqa.T2s[:, :, -1:],
                     *bulk_args[1:6], xs, us, it, ok, tuple(carry.data)))
    n_tile_b = tile_iterations(it, plan_a.tile)
    # the continuation launch alone: the bulk pass's stragglers compacted
    # into the slots as the pipeline does, warm from the kernel's carry,
    # both sides on the same inputs
    idx, _, _, _ = compact_members((ok == 0)[None, :], SLOTS_ADAPT)
    idx = idx[0]
    cont_args = (tqa, qp.u_min, qp.u_max, qp.x_min, qp.x_max,
                 x0_a[idx].contiguous(), AdaptiveFusedCarry(
                     *(w[:, idx].contiguous() for w in carry.data)))
    cont_kw = dict(bulk_kw, max_iter=ADAPTIVE_BUDGETS[1], warm_start=True,
                   carry_out=False)
    f_ck = functools.partial(condensed_adaptive_cuda, *cont_args, **cont_kw)
    f_cp = functools.partial(condensed_adaptive_reference, *cont_args,
                             **cont_kw)
    cont_k = f_ck()
    cont_p = f_cp()
    a_errs.append(adaptive_agreement(
        f"phase 11 continuation launch ({SLOTS_ADAPT} slots warm from the "
        f"bulk pass's carry, up to {ADAPTIVE_BUDGETS[1]} iterations) vs "
        "plain", cont_k, cont_p, min_solved=0))
    # the continuation's plan from its batch, and the layout of tiles of 32
    # it replaced forced beside it: the same bits, timed in turns
    plan_c = adaptive_tile_plan(12, 4, qN, 2, tiles=-(-SLOTS_ADAPT // 32),
                                sms=n_sm)
    f_co = forced(K2, "adaptive_tile_plan",
                  shared_adaptive_plan(12, 4, qN, 2), f_ck)
    same_c = same_bits(cont_k, f_co())
    print(f"phase 11 continuation plan: {describe_plan(plan_c)}; tiles of "
          f"32 forced (the layout before the batch-aware plan) bit-equal "
          f"{same_c}", flush=True)
    check(same_c, "phase 11: the continuation differs from its tiles of 32")
    t_c, t_c_p = paired_ms(f_ck, f_cp, reps=3, plain_reps=1)
    t_c, t_co = paired_ms(f_ck, f_co, reps=4)
    n_tile_c = tile_iterations(cont_k[2], plan_c.tile)
    y_c = product_yardstick([(ord1 * sw_q, in1_q), (4 * su_q, sw_q + 1)],
                            SLOTS_ADAPT, n_tile_c,
                            -(-SLOTS_ADAPT // plan_c.tile))
    k2c_bound = bound(
        k2_flops * int(cont_k[2].sum()),
        tensor_bytes(tqa.T1s, tqa.T2s[:, :, :sw_q], tqa.T2s[:, :, -1:],
                     *cont_args[1:], cont_k))
    print(f"phase 11 K2 bulk launch: {describe_plan(plan_a)}; "
          f"{n_tile_b} tile iterations, "
          f"{plan_a.tile * n_tile_b / int(it.sum()):.3f} x the lanes' own, "
          f"{1e3 * t_k2 * n_sm / n_tile_b:.3f} SM-us each; {t_b:.3f} ms "
          f"(median of 4, in turns with 2 lanes a thread forced: "
          f"{t_bo:.3f} ms, {t_bo / t_b:.3f}x, "
          f"{1e3 * t_bo * n_sm / n_tile_b:.3f} SM-us a tile iteration); "
          f"bound {k2_bound[0]:.4f} ms by {k2_bound[1]}", flush=True)
    n_cont = -(-SLOTS_ADAPT // plan_c.tile)
    print(f"phase 11 K2 continuation launch: {describe_plan(plan_c)}; mean "
          f"iterations {cont_k[2].float().mean().item():.1f}, largest "
          f"{int(cont_k[2].max())}; {n_tile_c} tile iterations ({n_cont} "
          f"tiles on {min(n_cont, n_sm)} of {n_sm} SMs), "
          f"{plan_c.tile * n_tile_c / max(1, int(cont_k[2].sum())):.3f} x "
          f"the lanes' own, {1e3 * t_c / int(cont_k[2].max()):.3f} us an "
          f"iteration of the slowest tile, "
          f"{1e3 * t_c * min(n_cont, n_sm) / n_tile_c:.3f} SM-us a tile "
          f"iteration; kernel {t_c:.3f} ms (median of 4, in turns with the "
          f"tiles of 32 forced: {t_co:.3f} ms, {t_co / t_c:.3f}x), plain "
          f"{t_c_p:.3f} ms (one timing), bound {k2c_bound[0]:.4f} ms by "
          f"{k2c_bound[1]}; product yardstick (one cuBLAS fp32 matmul an "
          f"iteration x the tile iterations) {y_c:.3f} ms", flush=True)
    n_strag = int(res_a.unconv.sum())
    print(f"phase 11 adaptive pipeline B={B_ADAPT}, {SLOTS_ADAPT} slots, "
          f"fp32 150 + 2500: {int(ok.sum())} converged in the bulk pass, "
          f"{n_strag} stragglers, slot overflow {int(res_a.overflow)}, "
          f"{n_a} converged in all ({100.0 * n_a / B_ADAPT:.2f}%; plain "
          f"{n_ap}), mean iterations {res_a.iters.float().mean().item():.1f} "
          f"(largest {int(res_a.iters.max())}), rho span "
          f"[{res_a.rho.min().item():.4g}, {res_a.rho.max().item():.4g}]; "
          f"median of {DEEP_REPS}: pipeline kernel {t_ap:.3f} ms, plain "
          f"{t_ap_p:.3f} ms -> {n_a / (t_ap * 1e-3):.0f} solves/s on {card}; "
          f"one K2 launch (bulk pass, 150 iterations, carry out), median of "
          f"5: {t_k2:.3f} ms, plain {t_k2_p:.3f} ms", flush=True)

    # -- phase 12: the adaptive single-instance solve(), float64 -------------
    WALL.mark("12")
    x0_1 = np.array([0.1, -0.2, 0.3, 0.05, -0.05, 0.1, 0.2, -0.1, 0.15, 0.0,
                     0.0, 0.0])
    golden = Path(__file__).resolve().parent / "tests" / "golden"
    oracle = np.load(golden / "quadrotor_adaptive.npz")
    sens = np.load(golden / "quadrotor_sensitivities.npz")
    singles = []
    t0 = time.perf_counter()
    for d in ("cuda", "cpu"):
        sv = quadrotor.make_solver(dtype=torch.float64, device=d,
                                   adaptive_rho=True, adaptive_rho_min=0.1,
                                   adaptive_rho_max=10.0)
        # the finite-difference sensitivities the reference binary used
        sv.cache = sv.cache.replace(**{
            f"d{k}_drho": torch.as_tensor(sens[f"d{k}"], dtype=torch.float64,
                                          device=d)
            for k in ("Kinf", "Pinf", "C1", "C2")})
        sv.set_x0(x0_1)
        sv.solve()
        singles.append(sv)
    s_card, s_cpu = singles
    it12 = (int(s_card.solution.iter), int(s_cpu.solution.iter))
    rho12 = (float(s_card.cache.rho), float(s_cpu.cache.rho))
    du12 = float(np.abs(s_card.get_solution().controls
                        - s_cpu.get_solution().controls).max())
    it_ref = int(oracle["solve_iter"][0, 0])
    rho_ref = float(oracle["final_rho"][0, 0])
    du_ref = float(np.abs(s_card.get_solution().controls
                          - oracle["solve_u"]).max())
    print(f"phase 12 adaptive solve(), the golden quadrotor case in float64 "
          f"on the card vs the CPU ({time.perf_counter() - t0:.1f} s): "
          f"iterations (card, cpu, reference binary) {it12 + (it_ref,)}, "
          f"final rho {rho12 + (rho_ref,)}, max |diff| of the controls card "
          f"vs cpu {du12:.3e}, card vs reference binary {du_ref:.3e}",
          flush=True)
    check(s_card.state.x.is_cuda and s_card.cache.rho.is_cuda,
          "the card's adaptive solver state is not on the card")
    check(it12[0] == it12[1] == it_ref and it_ref > 5,
          f"phase 12: iterations {it12}, reference binary {it_ref}")
    check(abs(rho12[0] - rho_ref) <= RHO_ATOL64 and du_ref <= LOOP_ATOL,
          f"phase 12: rho {rho12[0]} and controls ({du_ref:.3e}) against the "
          f"reference binary's {rho_ref}")
    check(rho12[0] != quadrotor.RHO, "phase 12: rho never moved")
    check(abs(rho12[0] - rho12[1]) <= RHO_ATOL64,
          f"phase 12: rho differs, {rho12}")
    check(du12 <= LOOP_ATOL, f"phase 12: controls differ by {du12:.3e}")

    no_library = None  # no single PyTorch call computes an ADMM solve
    return [{
        "name": "condensed_fused (K1), box path", "route": "cuda",
        "source": "tinympc_julia_tpu_torch/csrc/condensed_fused.cu",
        "replaces": "tinympc_julia_tpu/ops/pallas/condensed_kernel.py:232",
        "launches": launches, "max_abs_err": max(errs), "ms": t_k1,
        "plain_ms": t_k1_p, "bound_ms": k1_bound[0], "bound_by": k1_bound[1],
        "library_ms": no_library}, {
        "name": "condensed_fused projections (K1e), constrained path",
        "route": "cuda",
        "source": "tinympc_julia_tpu_torch/csrc/condensed_fused.cu",
        "replaces": "tinympc_julia_tpu/ops/pallas/condensed_kernel.py:127",
        "launches": e_launches, "max_abs_err": max(e_errs), "ms": t_e,
        "plain_ms": t_e_p, "bound_ms": k1e_bound[0],
        "bound_by": k1e_bound[1], "library_ms": no_library}, {
        "name": "condensed_adaptive (K2), per-lane adaptive rho",
        "route": "cuda",
        "source": "tinympc_julia_tpu_torch/csrc/condensed_adaptive.cu",
        "replaces": "tinympc_julia_tpu/ops/pallas/adaptive_kernel.py:106",
        "launches": a_launches, "max_abs_err": max(a_errs), "ms": t_k2,
        "plain_ms": t_k2_p, "bound_ms": k2_bound[0],
        "bound_by": k2_bound[1], "library_ms": no_library}, {
        "name": "condensed_adaptive (K2), the adaptive pipeline's warm "
                "continuation (2,048 slots, up to 2,500 iterations)",
        "route": "cuda",
        "source": "tinympc_julia_tpu_torch/csrc/condensed_adaptive.cu",
        "replaces": "tinympc_julia_tpu/ops/pallas/adaptive_kernel.py:106",
        "launches": c_launches, "max_abs_err": max(a_errs), "ms": t_c,
        "plain_ms": t_c_p, "bound_ms": k2c_bound[0],
        "bound_by": k2c_bound[1], "library_ms": no_library}]


def flat_lanes(out):
    """(G, L, ...) pipeline outputs as flat lanes for ``agreement``."""
    return tuple(t.reshape((-1,) + t.shape[2:]) for t in out[:4])


def grouped_phases(card):
    """Phases 13-17: the group grid of K1 and K2, K1's reduced-precision
    head, and the two grouped sweeps; the rows of K1d, K1c and K2's grid for
    the kernels line."""
    from tinympc_julia_tpu_torch import Settings, make_problem
    from tinympc_julia_tpu_torch.models import (cartpole, quadrotor, rocket,
                                                sweeps)
    from tinympc_julia_tpu_torch.ops.condensed import (
        build_condensed, build_condensed_taylor)
    from tinympc_julia_tpu_torch.ops.cuda import adaptive_kernel as K2
    from tinympc_julia_tpu_torch.ops.cuda.adaptive_kernel import (
        AdaptivePlant, adaptive_tile_plan, condensed_adaptive_cuda,
        condensed_adaptive_reference, shared_adaptive_plan)
    from tinympc_julia_tpu_torch.ops.cuda.condensed_kernel import (
        condensed_fused_cuda, condensed_fused_reference, fused_constraints,
        fused_tile_plan, map_layout, problem_constraint_kw, tile_iterations)
    from tinympc_julia_tpu_torch.ops.cuda.layout_probe import same_bits
    from tinympc_julia_tpu_torch.ops.riccati import precompute_cache
    from tinympc_julia_tpu_torch.parallel.grouped import GroupedBatchSolver
    from tinympc_julia_tpu_torch.types import stack_instances
    from tinympc_julia_tpu_torch.utils.precision import full_fp32_matmul

    dev = torch.device("cuda")
    f32 = torch.float32
    N = cartpole.HORIZON

    def groups(mod, G, ub_range, seed, x_bound=None):
        """G randomised plants (dynamics, input gain, costs, rho, bounds)."""
        rng = np.random.default_rng(seed)
        nx = mod.A.shape[0]
        ps, cs = [], []
        for _ in range(G):
            kw = {}
            if x_bound is not None:
                xb = np.tile(x_bound * rng.uniform(0.8, 1.2), (N, 1))
                kw = dict(x_min=-xb, x_max=xb)
            ub = rng.uniform(*ub_range)
            p = make_problem(
                mod.A + rng.normal(scale=2e-3, size=(nx, nx)),
                mod.B * rng.uniform(0.9, 1.1),
                np.diag(mod.Q_DIAG * rng.uniform(0.8, 1.25, size=nx)),
                np.diag(mod.R_DIAG), mod.RHO * rng.uniform(0.8, 1.2), N,
                u_min=-ub, u_max=ub, dtype=f32, device=dev, **kw)
            ps.append(p)
            cs.append(precompute_cache(p.A, p.B, p.Q, p.R, p.rho_setup))
        return stack_instances(ps), stack_instances(cs)

    def gx0(G, L, nx, seed, scale):
        return torch.as_tensor(np.random.default_rng(seed).uniform(
            -scale, scale, size=(G, L, nx)), dtype=f32, device=dev)

    def k1_kw(P, **kw):
        full = dict(nx=P.nx, nu=P.nu, N=P.N, abs_pri_tol=1e-3,
                    abs_dua_tol=1e-3, en_input_bound=True,
                    en_state_bound=False, relaxation_alpha=1.7,
                    check_termination=4, warm_start=False, carry_out=True,
                    num_groups=P.A.shape[0])
        full.update(kw)
        return full

    def k1_args(P, C, maps, x0s, warm=None):
        return (maps, C.rho, P.u_min, P.u_max, P.x_min, P.x_max, x0s, warm)

    def k1_both(P, C, maps, x0s, **kw):
        args = k1_args(P, C, maps, x0s)
        full = k1_kw(P, **kw)
        return (condensed_fused_cuda(*args, **full),
                condensed_fused_reference(*args, **full))

    def product_counts(counts, ct):
        """(reduced, fp32) T12 products of a cold precision="default" launch
        whose lanes ran ``counts`` iterations: iteration 0 is the rollout
        alone, and of the others those that check ((i + 1) % ct == 0) take
        the fp32 product."""
        n = counts.to(torch.int64)
        n_hi = n // ct - (1 if ct == 1 else 0)
        return int((n - 1 - n_hi).sum()), int(n_hi.sum())

    def bit_equal(out_a, out_b):
        """Lanes on which two results differ in any bit of x, u or count."""
        xa, ua, ia = out_a[:3]
        xb, ub, ib = out_b[:3]
        differ = ((ia != ib) | (xa != xb).flatten(1).any(1)
                  | (ua != ub).flatten(1).any(1))
        return int(differ.sum())

    # -- phase 13: K1d, the group grid, kernel vs plain ---------------------
    WALL.mark("13")
    d_errs = []
    G, L = G_CHECK, L_CHECK
    Pc, Cc = groups(cartpole, G, (3.0, 6.0), 3)
    mc = build_condensed(Pc, Cc)
    x0c = gx0(G, L, 4, 4, 0.5)
    out_k, out_p = k1_both(Pc, Cc, mc, x0c, max_iter=400)
    d_errs.append(agreement(
        f"phase 13a cartpole G={G} x L={L}, per-group maps, rho and input "
        f"bounds ({bit_equal(out_k, out_p)} lanes differ in a bit)", out_k,
        out_p))
    d_errs.append(carry_agreement("phase 13a", out_k[2] == out_p[2],
                                  out_k[4], out_p[4]))
    ub_g = Pc.u_max[:, 0, 0]
    u_g = out_k[1].reshape(G, L, -1).abs().amax(dim=(1, 2))
    check(bool((u_g <= ub_g + 1e-5).all()) and float(ub_g.max() - ub_g.min())
          > 0.5, "phase 13a: a group's controls leave its own bound")
    Pb, Cb = groups(cartpole, G, (3.0, 6.0), 5,
                    x_bound=np.array([2.0, 1e17, 1e17, 1e17]))
    mb = build_condensed(Pb, Cb)
    out_k, out_p = k1_both(Pb, Cb, mb, x0c, max_iter=400, en_state_bound=True,
                           relaxation_alpha=1.0, check_termination=1)
    d_errs.append(agreement(
        f"phase 13b cartpole G={G} x L={L}, per-group state bounds (generic "
        f"path; {bit_equal(out_k, out_p)} lanes differ in a bit)", out_k,
        out_p))
    gs_r, x0_r, _, _ = sweeps.rocket_cone_sweep(device=dev, G=4, L=L_ROCKET)
    Pr, Cr = gs_r.problems, gs_r.caches
    cons_r = fused_constraints(**problem_constraint_kw(Pr, gs_r.settings),
                               nx=6, nu=3, dtype=f32, device=dev,
                               num_groups=4)
    r_kw = dict(max_iter=72, abs_pri_tol=2e-3, abs_dua_tol=1e-3,
                en_state_bound=True, relaxation_alpha=1.0,
                check_termination=1, constraints=cons_r)
    out_k, out_p = k1_both(Pr, Cr, gs_r.maps(), x0_r, **r_kw)
    d_errs.append(agreement(
        f"phase 13c rocket G=4 x L={L_ROCKET} (ragged tiles), per-group cone "
        f"coefficients ({bit_equal(out_k, out_p)} lanes differ in a bit)",
        out_k, out_p))
    mu_x = Pr.cones_x.mus[:, 0].repeat_interleave(L_ROCKET)[:, None]
    mu_u = Pr.cones_u.mus[:, 0].repeat_interleave(L_ROCKET)[:, None]
    viol = cone_violation(out_k[0], out_k[1], mu_x, mu_u, out_k[3])
    print(f"phase 13c rocket: largest cone excess on solved lanes, each "
          f"against its group's coefficient {viol:.3e} (bar {CONE_TOL})",
          flush=True)
    check(viol <= CONE_TOL, f"phase 13c: cone excess {viol:.3e}")
    Pq, Cq = groups(quadrotor, 4, (0.4, 0.6), 7)
    mq = build_condensed(Pq, Cq)
    x0q = gx0(4, L_QUAD, 12, 8, 0.25)
    out_k, out_p = k1_both(Pq, Cq, mq, x0q, max_iter=600)
    d_errs.append(agreement(
        f"phase 13d quadrotor G=4 x L={L_QUAD} (maps through L2; "
        f"{bit_equal(out_k, out_p)} lanes differ in a bit)", out_k, out_p))
    args = k1_args(Pc, Cc, mc, x0c)
    one = condensed_fused_cuda(*args, **k1_kw(Pc, max_iter=80,
                                              check_termination=1))
    a = condensed_fused_cuda(*args, **k1_kw(Pc, max_iter=30,
                                            check_termination=1))
    b = condensed_fused_cuda(*args[:7], a[4], **k1_kw(
        Pc, max_iter=50, check_termination=1, warm_start=True))
    done = a[3] == 1
    exact = (torch.equal(torch.where(done, a[2], 30 + b[2]), one[2])
             and torch.equal(torch.where(done[:, None, None], a[1], b[1]),
                             one[1])
             and all(torch.equal(x[:, ~done], y[:, ~done])
                     for x, y in zip(b[4], one[4])))
    print(f"phase 13e grouped warm chain 30+50 vs one-shot 80: bit-exact "
          f"{exact} ({int(done.sum())} lanes done in the first 30)",
          flush=True)
    check(exact, "the kernel's grouped 30+50 chain differs from its "
          "80-iteration solve")

    # -- phase 14: K1c, the reduced-precision product and head --------------
    WALL.mark("14")
    c_errs = []
    head_kw = dict(max_iter=96, bf16_head_iters=16)
    out_k, out_p = k1_both(Pc, Cc, mc, x0c, **head_kw)
    c_errs.append(agreement(
        f"phase 14a cartpole G={G} x L={L}, 16-iteration bf16 head of 96 "
        f"({bit_equal(out_k, out_p)} lanes differ in a bit)", out_k, out_p))
    c_errs.append(carry_agreement("phase 14a", out_k[2] == out_p[2],
                                  out_k[4], out_p[4]))
    check(int(out_k[2].min()) >= 16, "phase 14a: a count below the head")
    a = condensed_fused_cuda(*args, **k1_kw(
        Pc, max_iter=16, check_termination=16, precision="default"))
    b = condensed_fused_cuda(*args[:7], a[4], **k1_kw(
        Pc, max_iter=80, warm_start=True))
    done = a[3] == 1
    exact = (torch.equal(torch.where(done, a[2], 16 + b[2]), out_k[2])
             and torch.equal(torch.where(done[:, None, None], a[1], b[1]),
                             out_k[1])
             and all(torch.equal(x[:, ~done], y[:, ~done])
                     for x, y in zip(b[4], out_k[4])))
    print(f"phase 14a head in one launch vs the chained (16, ct=16, "
          f"'default') + warm fp32 launches: bit-exact {exact}", flush=True)
    check(exact, "the head differs from the chained launches")
    lo_k, lo_p = k1_both(Pc, Cc, mc, x0c, max_iter=96, precision="default")
    c_errs.append(agreement(
        f"phase 14b precision='default' on all 96 iterations, ct=4 "
        f"({bit_equal(lo_k, lo_p)} lanes differ in a bit)", lo_k, lo_p,
        min_solved=0))
    fp_k = condensed_fused_cuda(*args, **k1_kw(Pc, max_iter=96))
    print(f"phase 14b: solved within 96 iterations: reduced "
          f"{int(lo_k[3].sum())}, fp32 {int(fp_k[3].sum())} of {G * L}",
          flush=True)
    plan_lo = fused_tile_plan(12, 4, N, reduced=True)
    out_k, out_p = k1_both(Pq, Cq, mq, x0q, max_iter=600, bf16_head_iters=64)
    print(f"phase 14c quadrotor shape (tile {plan_lo.tile}, maps in shared "
          f"memory {plan_lo.resident}), 64-iteration head of 600: "
          f"{bit_equal(out_k, out_p)}/{4 * L_QUAD} lanes differ in a bit",
          flush=True)
    c_errs.append(agreement("phase 14c quadrotor head", out_k, out_p))
    # (d) the latch recheck.  The carry froze just before the latching
    # iteration: the plain version recomputes that iteration in fp32 from it
    # and must latch at once.  Its sum runs in another order, which moves a
    # residual by ~1e-6 of itself: the recheck's tolerance is 1.001 x.
    x0e = gx0(G, L, 4, 9, 0.2)
    argse = k1_args(Pc, Cc, mc, x0e)
    for what, kw in (("'default' at ct=4", dict(max_iter=96,
                                                 precision="default")),
                     ("a 32-iteration reduced phase with its end check",
                      dict(max_iter=32, check_termination=32,
                           precision="default")),
                     ("a 32-iteration head", dict(max_iter=64,
                                                  check_termination=32,
                                                  bf16_head_iters=32))):
        k = condensed_fused_cuda(*argse, **k1_kw(Pc, **kw))
        latched = k[3] == 1
        if "head" in what:  # only the lanes latched at the head's end
            latched &= k[2] == 32
        again = condensed_fused_reference(*argse[:7], k[4], **k1_kw(
            Pc, max_iter=1, check_termination=1, warm_start=True,
            carry_out=False, abs_pri_tol=1.001e-3, abs_dua_tol=1.001e-3))
        ok = again[3][latched] == 1
        du = (again[1] - k[1])[latched].abs().max().item()
        print(f"phase 14d latch recheck, {what}: {int(latched.sum())} lanes "
              f"latched in the reduced phase, {int(ok.sum())} pass the fp32 "
              f"recheck, controls within {du:.3e}", flush=True)
        check(int(latched.sum()) > G * L // 50, f"phase 14d {what}: too few "
              "lanes latched to test anything")
        check(bool(ok.all()), f"phase 14d {what}: a lane latched on "
              "residuals that fail in fp32")
        check(du <= ATOL, f"phase 14d {what}: controls differ by {du:.3e}")

    # -- phase 15: K2's group grid ------------------------------------------
    WALL.mark("15")
    g_errs = []

    def k2_both(P, C, tmaps, x0s, **kw):
        full = dict(plant=AdaptivePlant(P.A, P.B, P.Q, P.R, C.Pinf,
                                        C.dPinf_drho),
                    nx=P.nx, nu=P.nu, N=P.N, max_iter=200, abs_pri_tol=1e-3,
                    abs_dua_tol=1e-3, en_state_bound=False,
                    en_input_bound=True, relaxation_alpha=1.0,
                    adaptive_rho_min=0.3, adaptive_rho_max=8.0,
                    adaptive_rho_clipping=True, check_termination=1,
                    controller="osqp", taylor_trust=float("inf"),
                    warm_start=False, carry_out=True,
                    num_groups=P.A.shape[0])
        full.update(kw)
        args = (tmaps, P.u_min, P.u_max, P.x_min, P.x_max, x0s, None)
        return (lambda: condensed_adaptive_cuda(*args, **full),
                lambda: condensed_adaptive_reference(*args, **full))

    f_k, f_p = k2_both(Pc, Cc, build_condensed_taylor(Pc, Cc), x0c)
    out_k = f_k()
    g_errs.append(adaptive_agreement(
        f"phase 15a K2 grid, cartpole G={G} x L={L}, OSQP-form controller, "
        "per-group plant and rho0", out_k, f_p()))
    rho0_l = Cc.rho.repeat_interleave(L)
    check(bool((out_k[4] != rho0_l).any()), "phase 15a: no lane moved its "
          "rho")
    Pa, Ca = groups(quadrotor, G, (0.4, 0.6), 11)
    ta = build_condensed_taylor(Pa, Ca)
    x0a = gx0(G, L, 12, 12, 0.3)
    quad_kw = dict(controller="termination", taylor_trust=2.0, plant=None,
                   adaptive_rho_min=quadrotor.RHO * 0.8,
                   adaptive_rho_max=1e3, max_iter=150)
    f_k, f_p = k2_both(Pa, Ca, ta, x0a, **quad_kw)
    out_k = f_k()
    out_p = f_p()
    g_errs.append(adaptive_agreement(
        f"phase 15b K2 grid, quadrotor G={G} x L={L}, termination "
        "controller, trust 2 around each group's rho0", out_k, out_p,
        min_solved=0))
    # the grid's plan from its batch, and 2 lanes a thread (the layout
    # before it) forced beside it: the same bits, timed in turns
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    plan_g = adaptive_tile_plan(12, 4, N, 2, tiles=G * -(-L // 32), sms=n_sm)
    f_go = forced(K2, "adaptive_tile_plan", shared_adaptive_plan(12, 4, N, 2),
                  f_k)
    same_g, same_gp = same_bits(out_k, f_go()), same_bits(out_k, out_p)
    print(f"phase 15b grid plan: {describe_plan(plan_g)}; 2 lanes a thread "
          f"forced (the layout before it) bit-equal {same_g}, the plain "
          f"version bit-equal {same_gp}", flush=True)
    check(same_g and same_gp, "phase 15b: the grid differs from its layout "
          "of 2 lanes a thread or from the plain version")
    t_g, t_go = paired_ms(f_k, f_go, reps=4)
    off = (out_k[4] - Ca.rho.repeat_interleave(L)).abs().max().item()
    check(off <= 2.0 + 1e-5, f"phase 15b: a lane's rho is {off:.3f} from its "
          "group's rho0, beyond the trust radius")
    ord1, sw_q, in1_q = ta.T1s.shape[1:]
    su_q = ta.T2s.shape[2]
    k2g_bound = bound(
        2.0 * (ord1 * sw_q * in1_q + 4 * su_q * (sw_q + 1))
        * int(out_k[2].sum()),
        tensor_bytes(ta.T1s, ta.T2s[..., :sw_q], ta.T2s[..., -1:], Pa.u_min,
                     Pa.u_max, Pa.x_min, Pa.x_max, x0a, out_k[:5],
                     tuple(out_k[5])))
    t_k2g, t_k2g_p = paired_ms(f_k, f_p)
    n_tile_g = tile_iterations(out_k[2], plan_g.tile, G)
    n_tiles = G * -(-L // plan_g.tile)
    print(f"phase 15b K2 grid launch: {describe_plan(plan_g)} "
          f"({n_tiles} tiles on {n_sm} SMs), "
          f"{n_tile_g} tile iterations, "
          f"{plan_g.tile * n_tile_g / int(out_k[2].sum()):.3f} x the lanes' "
          f"own, {1e3 * t_k2g * min(n_sm, n_tiles) / n_tile_g:.3f} SM-us "
          f"each on the busy SMs; {t_g:.3f} ms (median of 4, in turns with "
          f"2 lanes a thread forced: {t_go:.3f} ms, {t_go / t_g:.3f}x)",
          flush=True)
    condensed_adaptive_cuda.launches = 0
    condensed_adaptive_cuda.grouped_launches = 0
    gs_a = GroupedBatchSolver(Pa, Ca, Settings(
        max_iter=150, en_state_bound=False, adaptive_rho=True,
        adaptive_rho_controller="termination", adaptive_rho_taylor_trust=2.0,
        adaptive_rho_min=quadrotor.RHO * 0.8, adaptive_rho_max=1e3))
    xs_a, us_a, it_a, ok_a = gs_a.solve_batch(x0a, method="fused")
    pipe_a = gs_a.solve_batch(x0a, method="fused", pipeline=(150, 256, 500))
    torch.cuda.synchronize()
    k2g_launches = condensed_adaptive_cuda.grouped_launches
    check(k2g_launches == 3 and condensed_adaptive_cuda.launches == 3,
          f"the grouped adaptive path launched K2's grid {k2g_launches} "
          "times, not 3 (one solve, two pipeline phases)")
    check(torch.equal(it_a.reshape(-1), out_k[2])
          and torch.equal(us_a.reshape(-1, N - 1, 4), out_k[1]),
          "GroupedBatchSolver's adaptive fused solve differs from the "
          "kernel's direct launch")
    n_a = int(pipe_a[3].sum())
    print(f"phase 15b GroupedBatchSolver adaptive, quadrotor G={G} x L={L}: "
          f"fused solve {int(ok_a.sum())} converged in 150 iterations; "
          f"two-phase pipeline (150, 256 slots, 500) {n_a} converged "
          f"({100.0 * n_a / (G * L):.2f}%), overflow "
          f"{gs_a.last_overflow.tolist()}; one K2 grid launch (150 "
          f"iterations, carry out) median of 5: kernel {t_k2g:.3f} ms, plain "
          f"{t_k2g_p:.3f} ms on {card}", flush=True)
    check(n_a >= int(ok_a.sum()), "the adaptive pipeline lost lanes")

    # -- phases 16 and 17: the two sweeps at full width ---------------------
    WALL.mark("16-17")
    d_launches = c_launches = 0
    sweep_rows = {}

    def run_sweep(phase, name, build, cones=False):
        nonlocal d_launches, c_launches
        gs, x0s, pkw, setup_s = build(device=dev)
        G, L = x0s.shape[:2]
        B = G * L
        t0 = time.perf_counter()
        gs.maps()
        torch.cuda.synchronize()
        maps_s = time.perf_counter() - t0
        print(f"phase {phase} {name}: setup on the host clock: {G} "
              f"precompute_cache calls {setup_s:.1f} s, the batched "
              f"build_condensed {maps_s:.2f} s", flush=True)
        staged = gs.make_fused_pipeline(lanes=L, **pkw)
        staged_p = gs.make_fused_pipeline(
            lanes=L, fused=condensed_fused_reference, **pkw)
        ukw = sweeps.unstaged(pkw)
        flat = gs.make_fused_pipeline(lanes=L, **ukw)
        flat_p = gs.make_fused_pipeline(
            lanes=L, fused=condensed_fused_reference, **ukw)
        for attr in ("launches", "grouped_launches", "reduced_launches"):
            setattr(condensed_fused_cuda, attr, 0)
        out = staged(x0s)
        torch.cuda.synchronize()
        check(condensed_fused_cuda.launches == 3
              and condensed_fused_cuda.grouped_launches == 3,
              f"phase {phase}: the staged pipeline launched K1 "
              f"{condensed_fused_cuda.launches} times "
              f"({condensed_fused_cuda.grouped_launches} on the group grid), "
              "not 3")
        d_launches += condensed_fused_cuda.grouped_launches
        c_launches += condensed_fused_cuda.reduced_launches
        xs, us, iters, solved, overflow = out
        n_conv = int(solved.sum())
        check(tuple(us.shape) == (G, L, gs.N - 1, gs.nu), f"controls "
              f"{tuple(us.shape)}")
        check(n_conv >= 0.99 * B, f"phase {phase}: {n_conv}/{B} converged")
        out_sp, t_st_p = timed_once(lambda: staged_p(x0s))
        errs = [agreement(
            f"phase {phase} {name}, staged pipeline vs its plain version",
            flat_lanes(out), flat_lanes(out_sp), min_solved=int(0.99 * B))]
        del out_sp
        out_u = flat(x0s)
        errs.append(agreement(
            f"phase {phase} {name}, unstaged pipeline vs its plain version",
            flat_lanes(out_u), flat_lanes(flat_p(x0s)),
            min_solved=int(0.99 * B)))
        n_conv_u = int(out_u[3].sum())
        extra = ""
        if cones:
            P = gs.problems
            viol = max(cone_violation(
                o[0].reshape(B, gs.N, gs.nx),
                o[1].reshape(B, gs.N - 1, gs.nu),
                P.cones_x.mus[:, 0].repeat_interleave(L)[:, None],
                P.cones_u.mus[:, 0].repeat_interleave(L)[:, None],
                o[3].reshape(B)) for o in (out, out_u))
            check(viol <= CONE_TOL, f"phase {phase}: cone excess {viol:.3e}")
            extra = f", largest cone excess on solved lanes {viol:.3e}"
        # the plain staged pipeline's one timing: its comparison run above
        t_st, _ = paired_ms(lambda: staged(x0s), None, reps=DEEP_REPS,
                            plain_reps=0)
        t_fl, t_fl_p = paired_ms(lambda: flat(x0s), lambda: flat_p(x0s),
                                 reps=1)
        print(f"phase {phase} {name} G={G} x L={L}: staged {pkw}: {n_conv} "
              f"converged ({100.0 * n_conv / B:.2f}%), per-group overflow "
              f"max {int(overflow.max())} (sum {int(overflow.sum())}), mean "
              f"iterations {iters.float().mean().item():.1f}, largest "
              f"{int(iters.max())}{extra}; kernel {t_st:.3f} ms (median "
              f"of {DEEP_REPS}), plain {t_st_p:.3f} ms (one timing) -> "
              f"{n_conv / (t_st * 1e-3):.0f} "
              f"solves/s on {card}; unstaged {ukw}: {n_conv_u} converged, "
              f"mean iterations {out_u[2].float().mean().item():.1f}, one "
              f"timing after a warm-up: kernel {t_fl:.3f} ms, plain "
              f"{t_fl_p:.3f} ms -> {n_conv_u / (t_fl * 1e-3):.0f} solves/s",
              flush=True)
        return gs, x0s, pkw, errs

    gs_q, x0_q, pkw_q, q_errs = run_sweep(
        16, "randomised quadrotor sweep", sweeps.randomized_quadrotor_sweep)
    # one launch of each bulk phase at the sweep's shape, for the kernels line
    Gq, Lq = x0_q.shape[:2]
    Pq, Cq = gs_q.problems, gs_q.caches
    argsq = k1_args(Pq, Cq, gs_q.maps(), x0_q)
    bulk = dict(max_iter=pkw_q["phase0_bf16_iters"] + pkw_q["phase1_iters"])
    lo = dict(max_iter=pkw_q["phase0_bf16_iters"], precision="default")
    sw = gs_q.maps().T12.shape[1]
    timed = {}
    for key, kw in (("K1d", bulk), ("K1c", lo)):
        full = k1_kw(Pq, **kw)
        f_k = functools.partial(condensed_fused_cuda, *argsq, **full)
        f_p = functools.partial(condensed_fused_reference, *argsq, **full)
        out_k = f_k()
        out_p, t_p1 = timed_once(f_p)
        if key == "K1d":
            err = agreement(f"phase 16 {key} bulk launch G={Gq} x L={Lq}, "
                            f"{kw['max_iter']} fp32 iterations vs plain",
                            out_k, out_p, min_solved=0)
            flops = (2.0 * sw * sw * (int(out_k[2].sum()) - Gq * Lq)
                     + 2.0 * sw * 12 * Gq * Lq)
            t_ops = flops / PEAK_FP32
        else:
            err = agreement(f"phase 16 {key} bulk launch G={Gq} x L={Lq}, "
                            f"{kw['max_iter']} reduced iterations vs plain",
                            out_k, out_p, min_solved=0)
            n_lo, n_hi = product_counts(out_k[2], full["check_termination"])
            t_ops = 2.0 * sw * sw * (n_lo / PEAK_BF16 + n_hi / PEAK_FP32)
        t_bytes = tensor_bytes(gs_q.maps().T12, gs_q.maps().T1, Cq.rho,
                               Pq.u_min, Pq.u_max, Pq.x_min, Pq.x_max, x0_q,
                               out_k[:4], tuple(out_k[4])) / PEAK_BYTES
        # K1c's plain version (seconds): its comparison run is its timing
        t_k, t_p = paired_ms(f_k, f_p, reps=3,
                             plain_reps=0 if key == "K1c" else None)
        if key == "K1c":
            t_p = t_p1
        timed[key] = (err, t_k, t_p, 1e3 * max(t_ops, t_bytes),
                      "operations" if t_ops >= t_bytes else "bytes")
        n_tile = tile_iterations(out_k[2], 32, Gq)
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        print(f"phase 16 {key} bulk launch: kernel {t_k:.3f} ms (median of "
              f"3), plain {t_p:.3f} ms "
              f"({'one timing' if key == 'K1c' else 'median of 3'}), bound "
              f"{timed[key][3]:.3f} ms by "
              f"{timed[key][4]}; mean iterations "
              f"{out_k[2].float().mean().item():.1f}; {n_tile} tile "
              f"iterations, {32 * n_tile / int(out_k[2].sum()):.3f} x the "
              f"lanes' own, {1e3 * t_k * n_sm / n_tile:.3f} SM-us each",
              flush=True)
    # a yardstick only, not the same function (library_ms stays null): the
    # products alone, 160 cuBLAS batched fp32 products of the 64 maps by
    # (316 x 1,024) iterates
    T12w = gs_q.maps().T12[..., :sw].contiguous()
    W = torch.randn(Gq, sw, Lq, device=dev)
    with full_fp32_matmul():
        t_bmm = float(np.median([event_ms(
            lambda: [torch.bmm(T12w, W) for _ in range(160)])
            for _ in range(3)]))
    print(f"phase 16 yardstick: the K1d launch's products alone, 160 "
          f"torch.bmm of the {Gq} maps by ({sw} x {Lq}) iterates in fp32, "
          f"median of 3: {t_bmm:.3f} ms ({t_bmm / 160:.3f} ms a product)",
          flush=True)
    # what making the layouts at every launch costs at this shape
    su_q = sw - gs_q.N * gs_q.nx
    t_lay = [float(np.median([event_ms(lambda: map_layout(
        gs_q.maps(), gs_q.nx, su_q, sw, red,
        fused_tile_plan(gs_q.nx, gs_q.nu, gs_q.N, red)))
        for _ in range(5)])) for red in (False, True)]
    print(f"phase 16 kernel-side layouts of the {Gq} maps, made at every "
          f"launch, median of 5: {t_lay[0]:.3f} ms, with the bf16 map "
          f"{t_lay[1]:.3f} ms", flush=True)
    _, _, _, r_errs = run_sweep(17, "rocket sweep with per-group cones",
                                sweeps.rocket_cone_sweep, cones=True)
    check(d_launches == 6 and c_launches == 3,
          f"the sweeps launched K1's group grid {d_launches} times and "
          f"{c_launches} launches with reduced iterations (expected 6 and "
          "3: two of the quadrotor's, the rocket's phase 0)")

    src = "tinympc_julia_tpu_torch/csrc/"
    jax_k1 = "tinympc_julia_tpu/ops/pallas/condensed_kernel.py"
    return [{
        "name": "condensed_fused group grid (K1d), grouped sweeps",
        "route": "cuda", "source": src + "condensed_fused.cu",
        "replaces": jax_k1 + ":540", "launches": d_launches,
        "max_abs_err": max(d_errs + [timed["K1d"][0], q_errs[1], r_errs[1]]),
        "ms": timed["K1d"][1], "plain_ms": timed["K1d"][2],
        "bound_ms": timed["K1d"][3], "bound_by": timed["K1d"][4],
        "library_ms": None}, {
        "name": "condensed_fused reduced-precision product and head (K1c; "
                "bound against the dense bf16 tensor-core rate)",
        "route": "cuda", "source": src + "condensed_fused.cu",
        "replaces": jax_k1 + ":480", "launches": c_launches,
        "max_abs_err": max(c_errs + [timed["K1c"][0], q_errs[0], r_errs[0]]),
        "ms": timed["K1c"][1], "plain_ms": timed["K1c"][2],
        "bound_ms": timed["K1c"][3], "bound_by": timed["K1c"][4],
        "library_ms": None}, {
        "name": "condensed_adaptive group grid (K2 grid), grouped adaptive "
                "solves",
        "route": "cuda", "source": src + "condensed_adaptive.cu",
        "replaces": "tinympc_julia_tpu/ops/pallas/adaptive_kernel.py:475",
        "launches": k2g_launches, "max_abs_err": max(g_errs), "ms": t_k2g,
        "plain_ms": t_k2g_p, "bound_ms": k2g_bound[0],
        "bound_by": k2g_bound[1], "library_ms": None}]


def stage_and_loop_phases(card):
    """Phases 18-21: kernel K3 (the per-stage fused ADMM) against its plain
    version and beside K1, the fused MPC loop chained through K1's carry,
    and the two other MPC loops; the rows of K3 and of K1's carry chain for
    the kernels line."""
    from tinympc_julia_tpu_torch import Settings, make_problem
    from tinympc_julia_tpu_torch.models import cartpole, quadrotor, rocket
    from tinympc_julia_tpu_torch.ops.condensed import build_condensed
    from tinympc_julia_tpu_torch.ops.cuda import condensed_kernel as K
    from tinympc_julia_tpu_torch.ops.cuda.condensed_kernel import (
        condensed_fused_cuda, condensed_fused_reference, fused_tile_plan,
        map_layout, shared_tile_plan)
    from tinympc_julia_tpu_torch.ops.cuda.fused import (
        fused_cuda, fused_reference, fused_stage_plan, make_fused_solver,
        stage_occupancy)
    from tinympc_julia_tpu_torch.ops.cuda.layout_probe import same_bits
    from tinympc_julia_tpu_torch.ops.riccati import precompute_cache
    from tinympc_julia_tpu_torch.parallel import mpc

    dev = torch.device("cuda")
    f32 = torch.float32
    N = cartpole.HORIZON
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def plant(mod, ub, rho, x_bound=None, dtype=f32, device=dev, horizon=N,
              **kw):
        if x_bound is not None:
            xb = np.tile(x_bound, (horizon, 1))
            kw.update(x_min=-xb, x_max=xb)
        p = make_problem(mod.A, mod.B, np.diag(mod.Q_DIAG),
                         np.diag(mod.R_DIAG), rho, horizon, u_min=-ub[0],
                         u_max=ub[1], dtype=dtype, device=device, **kw)
        return p, precompute_cache(p.A, p.B, p.Q, p.R, p.rho_setup)

    def k3_args(p, c, x0s):
        return (p.A, p.B, p.f, p.Q, p.R, c.rho, c.Kinf, c.Quu_inv, c.AmBKt,
                c.Pinf, p.x_min, p.x_max, p.u_min, p.u_max, p.Xref, p.Uref,
                x0s)

    def k3_kw(p, **kw):
        full = dict(nx=p.nx, nu=p.nu, N=p.N, max_iter=100, abs_pri_tol=1e-3,
                    abs_dua_tol=1e-3, en_state_bound=False,
                    en_input_bound=True, check_termination=1)
        full.update(kw)
        return full

    def bit_equal(out_a, out_b):
        return int(sum(torch.equal(a, b) for a, b in zip(out_a, out_b)))

    def draw(B, nx, seed, scale):
        return torch.as_tensor(np.random.default_rng(seed).uniform(
            -scale, scale, size=(B, nx)), dtype=f32, device=dev)

    # -- phase 18: K3 vs plain ------------------------------------------------
    WALL.mark("18")
    errs = []
    x0_check = draw(B_CHECK, 4, 0, 0.5)[:B_CHECK - 3].contiguous()
    p, c = plant(cartpole, (5.0, 5.0), cartpole.RHO)
    p_b, c_b = plant(cartpole, (5.0, 5.0), cartpole.RHO,
                     x_bound=np.array([0.3, 1e17, 1e17, 1e17]))
    x0_fast = x0_check * torch.tensor([0.5, 2.0, 1.0, 1.0], device=dev)
    pq, cq = plant(quadrotor, (quadrotor.U_HOVER_BOUND,) * 2, quadrotor.RHO)
    x0_q = draw(B_QUAD, 12, 1, 0.3)
    p_u, c_u = plant(cartpole, (0.5, 0.5), cartpole.RHO)
    cases = (("a cartpole ct=1", p, c, x0_check, {}),
             ("b cartpole ct=4", p, c, x0_check, dict(check_termination=4)),
             ("c cartpole |x_0| <= 0.3 (state dual live)", p_b, c_b, x0_fast,
              dict(en_state_bound=True)),
             ("d quadrotor, rho 5, 500 iterations", pq, cq, x0_q,
              dict(max_iter=500)),
             ("e cartpole, rho as a float, no input bound", p_u, c_u,
              x0_check, dict(max_iter=30, en_input_bound=False,
                             rho=float(c_u.rho))),
             ("f quadrotor, ct=4, 302 iterations", pq, cq, x0_q,
              dict(max_iter=302, check_termination=4)))
    for name, pp, cc, x0s, kw in cases:
        kw = dict(kw)
        args = k3_args(pp, cc, x0s)
        if "rho" in kw:
            args = args[:5] + (kw.pop("rho"),) + args[6:]
        full = k3_kw(pp, **kw)
        plan = fused_stage_plan(pp.nx, pp.nu, pp.N, full["en_state_bound"],
                                x0s.shape[0], sms)
        occ = stage_occupancy(plan, pp.nx, pp.nu, full["en_state_bound"])
        out_k = fused_cuda(*args, **full)
        out_p = fused_reference(*args, **full)
        torch.cuda.synchronize()
        errs.append(agreement(
            f"phase 18{name}, B={x0s.shape[0]} (lane group {plan.group}, "
            f"tile {plan.tile} lanes = {plan.threads} threads, "
            f"{plan.smem} bytes of shared memory, matrices in "
            f"{'registers' if plan.registers else 'shared memory'}; "
            f"{occ['warps_per_sm']} warps an SM, {occ['registers']} "
            f"registers, {occ['local_bytes']} bytes local; "
            f"{bit_equal(out_k, out_p)} of 4 outputs bit-equal)", out_k,
            out_p))
        check(all(t.is_contiguous() for t in out_k[:2]), f"phase 18{name}: "
              "results not in the returned layout")
        if not full["en_input_bound"]:
            check(float(out_k[1].abs().max()) > 0.5, "phase 18e: |u| never "
                  "leaves the bound it does not hold")
        if full["en_state_bound"]:
            at_bound = (out_k[0][..., 0].abs().amax(dim=1) == 0.3)
            print(f"phase 18c: the bound binds on {int(at_bound.sum())} "
                  f"lanes; largest |x_0| {out_k[0][..., 0].abs().max():.6f}",
                  flush=True)
            check(int(at_bound.sum()) > 0, "phase 18c: the state box never "
                  "binds")
            check(float(out_k[0][..., 0].abs().max()) <= 0.3 + 1e-6,
                  "phase 18c: a state slack outside its box")

    # -- phase 19: K3's path at full width, beside K1 -------------------------
    WALL.mark("19")
    def stage_flops(pp, iters):
        nx, nu = pp.nx, pp.nu
        return ((pp.N - 1) * (4 * nx * nx + 8 * nx * nu + 2 * nu * nu)
                * float(iters.sum()))

    sm_clock_mhz = int(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    fused_cuda.launches = 0
    rows = []
    wide = (("cartpole", p, c, draw(B_MAIN, 4, 0, 0.5), 100),
            ("quadrotor", pq, cq, draw(B_ADAPT, 12, 1, 0.3), 500))
    for name, pp, cc, x0s, budget in wide:
        B = x0s.shape[0]
        solve = make_fused_solver(pp.nx, pp.nu, pp.N, max_iter=budget,
                                  en_state_bound=False)
        args = k3_args(pp, cc, x0s)
        before = fused_cuda.launches
        out = solve(*args)
        torch.cuda.synchronize()
        n_launch = fused_cuda.launches - before
        check(n_launch == 1, f"phase 19 {name}: make_fused_solver launched "
              f"K3 {n_launch} times, not once")
        xs, us, it, ok = out
        check(tuple(us.shape) == (B, pp.N - 1, pp.nu)
              and tuple(xs.shape) == (B, pp.N, pp.nx), f"shapes {us.shape}")
        check(bool(torch.isfinite(us).all())
              and bool(torch.isfinite(xs).all()),
              f"phase 19 {name}: non-finite solutions")
        check(float(us.abs().max()) <= float(pp.u_max.max()) + 1e-5,
              f"phase 19 {name}: |u| beyond its bound")
        full = k3_kw(pp, max_iter=budget)
        out_p = fused_reference(*args, **full)
        err = agreement(f"phase 19 {name} B={B}, K3 through "
                        f"make_fused_solver vs plain", out, out_p)
        # K1 on the same problem: alpha 1, ct 1, the same budget
        maps = build_condensed(pp, cc)
        k1_args = (maps, cc.rho, pp.u_min, pp.u_max, pp.x_min, pp.x_max, x0s,
                   None)
        k1_kw = dict(nx=pp.nx, nu=pp.nu, N=pp.N, max_iter=budget,
                     abs_pri_tol=1e-3, abs_dua_tol=1e-3, en_state_bound=False,
                     en_input_bound=True, relaxation_alpha=1.0,
                     check_termination=1, warm_start=False, carry_out=False)
        out_1 = condensed_fused_cuda(*k1_args, **k1_kw)
        same = (it == out_1[2])
        frac = same.float().mean().item()
        both = same & (ok == 1) & (out_1[3] == 1)
        du = (us - out_1[1]).abs()[both].max().item()
        n3, n1 = int(ok.sum()), int(out_1[3].sum())
        check(frac >= ITERS_AGREE, f"phase 19 {name}: K3 and K1 count alike "
              f"on {frac:.4f} of lanes only")
        check(du <= ATOL, f"phase 19 {name}: K3 and K1 controls differ by "
              f"{du:.3e}")
        check(abs(n3 - n1) <= 0.01 * B, f"phase 19 {name}: K3 solved {n3}, "
              f"K1 {n1}")
        t_k3, t_p = paired_ms(lambda: solve(*args),
                              lambda: fused_reference(*args, **full))
        t_k3b, t_k1 = paired_ms(
            lambda: solve(*args),
            lambda: condensed_fused_cuda(*k1_args, **k1_kw))
        b3 = bound(stage_flops(pp, it), tensor_bytes(*args, out))
        floor = (int(it.max()) * (pp.N - 1) * (2 * pp.nx + pp.nu) * 4
                 / (sm_clock_mhz * 1e6) * 1e3)
        print(f"phase 19 {name} B={B}, tol 1e-3, max_iter {budget}, no "
              f"over-relaxation: K3 solved {n3} ({100.0 * n3 / B:.2f}%), K1 "
              f"(alpha 1, ct 1) {n1}; mean iterations "
              f"{it.float().mean().item():.1f}, largest {int(it.max())}; "
              f"iteration counts K3 vs K1 equal on {frac:.4f} of lanes, "
              f"controls within {du:.3e} on equal solved lanes; median of 5: "
              f"K3 {t_k3:.3f} ms, its plain version {t_p:.3f} ms; K3 "
              f"{t_k3b:.3f} ms beside K1 {t_k1:.3f} ms "
              f"({t_k1 / t_k3b:.1f}x); K3's bound {b3[0]:.4f} ms by {b3[1]}, "
              f"its dependent-chain floor about {floor:.4f} ms (estimate: "
              f"{int(it.max())} iterations of the slowest lane, "
              f"{2 * pp.nx + pp.nu} fmaf a stage at 4 cycles, "
              f"{sm_clock_mhz} MHz) "
              f"-> {n3 / (t_k3 * 1e-3):.0f} solves/s on {card}", flush=True)
        rows.append({
            "name": f"fused_stage (K3), {name} B={B}, max_iter {budget}",
            "route": "cuda",
            "source": "tinympc_julia_tpu_torch/csrc/fused_stage.cu",
            "replaces": "tinympc_julia_tpu/ops/pallas/fused.py:44",
            "launches": n_launch, "max_abs_err": max(errs + [err]),
            "ms": t_k3,
            "plain_ms": t_p, "bound_ms": b3[0], "bound_by": b3[1],
            "library_ms": None})
    check(fused_cuda.launches >= 2, "K3 was not launched on its path")

    # -- phase 20: the fused MPC loop at full width ---------------------------
    WALL.mark("20")
    B_LOOP, STEPS = 8192, 100
    s = Settings(max_iter=100, en_state_bound=False, relaxation_alpha=1.7)
    x0_l = draw(B_LOOP, 4, 3, 0.5)
    loop = mpc.make_fused_mpc_loop(p, c, s, STEPS)
    loop_p = mpc.make_fused_mpc_loop(p, c, s, STEPS,
                                     fused=condensed_fused_reference)
    condensed_fused_cuda.launches = 0
    res = loop(x0_l)
    torch.cuda.synchronize()
    loop_launches = condensed_fused_cuda.launches
    check(loop_launches == STEPS, f"the fused MPC loop launched K1 "
          f"{loop_launches} times, not {STEPS}")
    res_p = loop_p(x0_l)
    check(tuple(res.us.shape) == (B_LOOP, STEPS, 1)
          and tuple(res.xs.shape) == (B_LOOP, STEPS, 4), "loop shapes")
    check(bool(torch.isfinite(res.us).all())
          and bool(torch.isfinite(res.xs).all()), "non-finite loop results")
    share = res.solved.float().mean().item()
    same = (res.iters == res_p.iters)
    frac = same.float().mean().item()
    du = (res.us - res_p.us).abs().max().item()
    dx = (res.xs - res_p.xs).abs().max().item()
    check(share >= 0.99, f"phase 20: {share:.4f} of (plant, step) solved")
    check(frac >= ITERS_AGREE, f"phase 20: counts agree on {frac:.4f}")
    check(du <= ATOL and dx <= ATOL, f"phase 20: controls differ by "
          f"{du:.3e}, states by {dx:.3e}")
    check(float(res.us.abs().max()) <= 5.0 + 1e-5, "phase 20: |u| beyond 5")
    t0 = time.perf_counter()
    loop(x0_l)
    t_enq = time.perf_counter() - t0
    torch.cuda.synchronize()
    # the plain loop (seconds) was run just before: one timing
    t_loop, t_loop_p = paired_ms(lambda: loop(x0_l), lambda: loop_p(x0_l),
                                 plain_reps=1)
    it_step = res.iters.float().mean(dim=0)
    print(f"phase 20 fused MPC loop, {B_LOOP} cartpole plants x {STEPS} "
          f"steps, alpha 1.7, max_iter 100: {loop_launches} K1 launches; "
          f"{100.0 * share:.2f}% of (plant, step) solved (plain "
          f"{100.0 * res_p.solved.float().mean().item():.2f}%); iteration "
          f"counts equal on {frac:.4f}, controls within {du:.3e}, states "
          f"within {dx:.3e} of the plain loop; mean iterations step 0 "
          f"{it_step[0].item():.1f}, step 1 {it_step[1].item():.1f}, last "
          f"{it_step[-1].item():.1f}, all "
          f"{res.iters.float().mean().item():.2f}; final |pole angle| mean {res.xs[:, -1, 2].abs().mean():.2e}; "
          f"median of 5: kernel loop {t_loop:.3f} ms, plain loop "
          f"{t_loop_p:.3f} ms (one timing) -> "
          f"{B_LOOP * STEPS / (t_loop * 1e-3):.0f} "
          f"closed-loop steps/s on {card}; the host enqueues a loop in "
          f"{1e3 * t_enq:.1f} ms", flush=True)
    # one warm launch at the loop's shape: step 1, from step 0's carry
    maps = build_condensed(p, c)
    l_args = (maps, c.rho, p.u_min, p.u_max, p.x_min, p.x_max)
    l_kw = dict(nx=4, nu=1, N=N, max_iter=100, abs_pri_tol=1e-3,
                abs_dua_tol=1e-3, en_state_bound=False, en_input_bound=True,
                relaxation_alpha=1.7, check_termination=1, carry_out=True)
    cold = condensed_fused_cuda(*l_args, x0_l, None, warm_start=False, **l_kw)
    x1 = res.xs[:, 1].contiguous()
    w_k = condensed_fused_cuda(*l_args, x1, cold[4], warm_start=True, **l_kw)
    w_p = condensed_fused_reference(*l_args, x1, cold[4], warm_start=True,
                                    **l_kw)
    b_errs = [agreement("phase 20 one warm K1 launch (step 1 from step 0's "
                        "carry) vs plain", w_k, w_p),
              carry_agreement("phase 20 warm launch", w_k[2] == w_p[2],
                              w_k[4], w_p[4]), du, dx]
    check(torch.equal(w_k[2], res.iters[:, 1]), "phase 20: the warm launch "
          "does not reproduce the loop's step 1")
    sw = maps.T12.shape[0]
    b_bound = bound(2.0 * sw * sw * float(w_k[2].sum())
                    + 2.0 * sw * 4 * B_LOOP,
                    tensor_bytes(maps.T12, maps.T1, *l_args[2:], x1,
                                 tuple(cold[4]), w_k[:4], tuple(w_k[4])))
    f_w = functools.partial(condensed_fused_cuda, *l_args, x1, cold[4],
                            warm_start=True, **l_kw)
    t_w, t_w_p = paired_ms(
        f_w, lambda: condensed_fused_reference(*l_args, x1, cold[4],
                                               warm_start=True, **l_kw))
    plan_w = fused_tile_plan(4, 1, N)
    t_lay = float(np.median([event_ms(lambda: map_layout(
        maps, 4, (N - 1) * 1, sw, False, plan_w)) for _ in range(5)]))
    print(f"phase 20 one warm launch, B={B_LOOP}, mean iterations "
          f"{w_k[2].float().mean().item():.1f}: median of 5: kernel "
          f"{t_w:.3f} ms, plain {t_w_p:.3f} ms, bound {b_bound[0]:.4f} ms by "
          f"{b_bound[1]}; the map layouts, made once for a solver's maps "
          f"(the loop's solvers keep them): {t_lay:.3f} ms", flush=True)
    # the layout the plan takes against tiles of 32 lanes forced, in turns
    t32 = shared_tile_plan(4, 1, N)
    same_w = same_bits(w_k, forced(K, "fused_tile_plan", t32, f_w)())
    check(same_w, "phase 20: the warm launch differs from its tiles of 32")
    t_w2, t_w32 = paired_ms(f_w, forced(K, "fused_tile_plan", t32, f_w),
                            reps=4)
    print(f"phase 20 warm launch layouts: {describe_plan(plan_w)}; "
          f"{iteration_report(w_k[2], plan_w, 1, sms, sw, K.state_floats(4, 1, N, True) + 2 * sw)}; bit-equal to tiles "
          f"of 32 forced {same_w}; median of 4 in turns: the plan's "
          f"{t_w2:.3f} ms, tiles of 32 {t_w32:.3f} ms "
          f"({t_w32 / t_w2:.3f}x)", flush=True)
    rows.append({
        "name": "condensed_fused carry chain (K1b), fused MPC loop: one "
                "warm launch at B=8192",
        "route": "cuda",
        "source": "tinympc_julia_tpu_torch/csrc/condensed_fused.cu",
        "replaces": "tinympc_julia_tpu/ops/pallas/condensed_kernel.py:243",
        "launches": loop_launches, "max_abs_err": max(b_errs), "ms": t_w,
        "plain_ms": t_w_p, "bound_ms": b_bound[0], "bound_by": b_bound[1],
        "library_ms": None})

    # -- phase 21: the two other loops, float64 -------------------------------
    WALL.mark("21")
    f64 = torch.float64
    t0 = time.perf_counter()

    def both_devices(ub, settings, x0, steps):
        out = []
        for d in (dev, torch.device("cpu")):
            pp, cc = plant(cartpole, (ub, ub), 1.0, dtype=f64, device=d)
            out.append(mpc.run_mpc_loop(
                pp, cc, settings, torch.as_tensor(x0, dtype=f64, device=d),
                steps))
        return out

    r_card, r_cpu = both_devices(
        5.0, Settings(max_iter=100, en_state_bound=False),
        [[0.0, 0.0, 0.1, 0.0], [0.5, 0.0, -0.05, 0.0]], 25)
    a_card, a_cpu = both_devices(
        1.0, Settings(max_iter=100, en_state_bound=False, adaptive_rho=True,
                      adaptive_rho_min=0.5, adaptive_rho_max=5.0),
        [[1.0, 0.0, 0.2, 0.0], [-0.5, 0.3, 0.0, 0.0]], 10)
    for what, rc, rh in (("2 cartpole plants x 25 steps", r_card, r_cpu),
                         ("adaptive rho, 10 steps", a_card, a_cpu)):
        eq = torch.equal(rc.iters.cpu(), rh.iters)
        dl = (rc.us.cpu() - rh.us).abs().max().item()
        print(f"phase 21 run_mpc_loop in float64, {what}, card vs CPU: "
              f"iteration counts equal {eq} (total "
              f"{int(rc.iters.sum())}), max |diff| of the controls "
              f"{dl:.3e}", flush=True)
        check(rc.us.is_cuda and rc.state.x.is_cuda, "phase 21: the card's "
              "loop is not on the card")
        check(eq, f"phase 21 {what}: iteration counts differ")
        check(dl <= LOOP_ATOL, f"phase 21 {what}: controls differ by "
              f"{dl:.3e}")
    rho_c, rho_h = a_card.cache.rho.cpu(), a_cpu.cache.rho
    print(f"phase 21 adaptive loop: final rhos card {rho_c.tolist()}, cpu "
          f"{rho_h.tolist()}", flush=True)
    check(tuple(rho_c.shape) == (2,) and bool((rho_c != 1.0).any()),
          "phase 21: the adaptive loop's rho never moved")
    check(float((rho_c - rho_h).abs().max()) <= RHO_ATOL64,
          "phase 21: final rhos differ")
    pr, cr = plant(rocket, (10.0, 105.0), 1.0, dtype=f64, horizon=10,
                   f=rocket.F)
    sr = Settings(max_iter=100, abs_pri_tol=2e-3, en_state_bound=False)
    Xrefs = np.stack([rocket.reference_trajectory(k)[0].T for k in range(15)])
    Urefs = np.stack([rocket.reference_trajectory(k)[1].T for k in range(15)])
    x0_r = torch.as_tensor(rocket.X_INIT[None, :], dtype=f64, device=dev)
    std = mpc.run_mpc_loop(pr, cr, sr, x0_r, 15, Xrefs=Xrefs, Urefs=Urefs)
    cnd = mpc.run_mpc_loop_condensed(pr, cr, sr, x0_r, 15, Xrefs=Xrefs,
                                     Urefs=Urefs)
    eq = torch.equal(std.iters, cnd.iters)
    dl = (std.us - cnd.us).abs().max().item()
    print(f"phase 21 run_mpc_loop_condensed, the rocket's moving references, "
          f"15 steps in float64 on the card vs run_mpc_loop: iteration "
          f"counts equal {eq} ({cnd.iters[0].tolist()}), max |diff| of the "
          f"controls {dl:.3e} ({time.perf_counter() - t0:.1f} s for the "
          f"phase)", flush=True)
    check(cnd.us.is_cuda and eq and dl <= 1e-9 and bool(cnd.solved.all()),
          f"phase 21: the condensed loop differs from run_mpc_loop "
          f"(counts equal {eq}, controls {dl:.3e})")
    return rows


def rebuild_and_horizon_phases(card):
    """Phases 22-25: the bucketed exact-rebuild pipeline on the mis-set
    cartpole and quadrotor, the requantized adaptive continuation, and the
    long-horizon recursions in float64; the rows of the rebuild's and the
    requantized continuation's K1d launches for the kernels line."""
    from tinympc_julia_tpu_torch import Settings, TinyMPCSolver, make_problem
    from tinympc_julia_tpu_torch.models import cartpole, quadrotor
    from tinympc_julia_tpu_torch.ops.condensed import (
        AUTO_CONDENSED_BUDGET_BYTES, auto_chunk_size, auto_uses_condensed,
        build_condensed, build_condensed_taylor)
    from tinympc_julia_tpu_torch.ops.cuda import adaptive_kernel as K2
    from tinympc_julia_tpu_torch.ops.cuda.adaptive_kernel import (
        AdaptiveFusedCarry, adaptive_tile_plan, condensed_adaptive_cuda,
        condensed_adaptive_reference, shared_adaptive_plan)
    from tinympc_julia_tpu_torch.ops.cuda import condensed_kernel as K
    from tinympc_julia_tpu_torch.ops.cuda.condensed_kernel import (
        FusedCarry, condensed_fused_cuda, condensed_fused_reference,
        fused_tile_plan, make_condensed_fused_solver, shared_tile_plan,
        tile_iterations)
    from tinympc_julia_tpu_torch.ops.cuda.layout_probe import (
        product_yardstick, same_bits)
    from tinympc_julia_tpu_torch.ops.riccati import precompute_cache
    from tinympc_julia_tpu_torch.parallel import batch as batch_mod
    from tinympc_julia_tpu_torch.parallel.pipeline import (
        ADAPTIVE_BUDGETS, REQUANT_HEAD, requantized_adaptive_solve,
        requantized_buckets, two_phase_adaptive_solve)
    from tinympc_julia_tpu_torch.parallel.rebuild import (
        bucket_maps, compact_members, default_bucket_rhos,
        make_bucketed_rebuild, predict_rho_bucketed)
    from tinympc_julia_tpu_torch.types import init_state

    dev = torch.device("cuda")
    f32 = torch.float32
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    src = "tinympc_julia_tpu_torch/csrc/condensed_fused.cu"
    jax_k1 = "tinympc_julia_tpu/ops/pallas/condensed_kernel.py"
    rows = []

    def zero_counts():
        for fn in (condensed_fused_cuda, condensed_adaptive_cuda):
            for name in ("launches", "grouped_launches", "reduced_launches"):
                setattr(fn, name, 0)

    def median_ms(fn, reps=DEEP_REPS):
        fn()
        return float(np.median([event_ms(fn) for _ in range(reps)]))

    def launch_bound(sw, nx, counts, head, lanes, *tensors):
        """(ms, by) of a warm K1 launch whose lanes ran ``counts``
        iterations: one T12 product an iteration (the first ``head - 1``
        reduced, at the bf16 rate) and the rollout constant once a lane."""
        n = counts.to(torch.int64)
        n_lo = int(torch.clamp(n, max=max(head - 1, 0)).sum()) if head else 0
        n_hi = int(n.sum()) - n_lo
        t_ops = (2.0 * sw * sw * (n_lo / PEAK_BF16 + n_hi / PEAK_FP32)
                 + 2.0 * sw * nx * lanes / PEAK_FP32)
        t_bytes = tensor_bytes(*tensors) / PEAK_BYTES
        return (1e3 * max(t_ops, t_bytes),
                "operations" if t_ops >= t_bytes else "bytes")

    def rebuild_phase(phase, name, mod, rho0, ub, x_bound, seed, scale, span,
                      ref_lanes):
        N = mod.HORIZON
        kw = {}
        if x_bound is not None:
            xb = np.tile(x_bound, (N, 1))
            kw = dict(x_min=-xb, x_max=xb)
        p = make_problem(mod.A, mod.B, np.diag(mod.Q_DIAG),
                         np.diag(mod.R_DIAG), rho0, N, u_min=-ub, u_max=ub,
                         dtype=f32, device=dev, **kw)
        c = precompute_cache(p.A, p.B, p.Q, p.R, p.rho_setup)
        s = Settings(max_iter=500, en_state_bound=x_bound is not None,
                     en_input_bound=True, adaptive_rho_min=span[0],
                     adaptive_rho_max=span[1])
        B = B_CHECK
        x0 = torch.as_tensor(np.random.default_rng(seed).uniform(
            -1, 1, size=(B, p.nx)) * scale, dtype=f32, device=dev)
        t0 = time.perf_counter()
        maps = build_condensed(p, c)
        rhos = default_bucket_rhos(*span)
        G = len(rhos)
        bmaps = bucket_maps(p, c, rhos)
        torch.cuda.synchronize()
        t_setup = time.perf_counter() - t0
        pkw = dict(phase1_iters=50, straggler_slots=B, phase2_iters=450,
                   maps=maps, bmaps=bmaps)
        pipe = make_bucketed_rebuild(p, c, s, **pkw)
        pipe_p = make_bucketed_rebuild(
            p, c, s, fused=condensed_fused_reference, **pkw)
        zero_counts()
        out = pipe.solve(x0)
        torch.cuda.synchronize()
        n_launch = condensed_fused_cuda.launches
        n_grouped = condensed_fused_cuda.grouped_launches
        check(n_launch == 2 and n_grouped == 1,
              f"phase {phase}: the pipeline launched K1 {n_launch} times, "
              f"{n_grouped} over the buckets (expected 2 and 1)")
        out_p = pipe_p.solve(x0)
        xs, us, it, ok, rho, overflow = out
        n_bkt = int(ok.sum())
        err = agreement(f"phase {phase} {name}: bucketed rebuild, merged "
                        "per-lane results vs the plain pipeline", out[:4],
                        out_p[:4], min_solved=int(0.95 * B))
        same = it == out_p[2]
        rho_same = float((rho == out_p[4])[same].float().mean())
        check(rho_same >= ITERS_AGREE, f"phase {phase}: lane rho equal on "
              f"{rho_same:.4f} of lanes with equal counts")
        check(not bool(overflow.any()) and torch.equal(overflow, out_p[5]),
              f"phase {phase}: overflow {overflow.tolist()}")
        check(bool(torch.isfinite(us).all()) and bool(torch.isfinite(xs).all())
              and float(us.abs().max()) <= ub + 1e-5,
              f"phase {phase}: non-finite controls or |u| beyond {ub}")
        # the fixed-rho0 control: K1, 500 iterations
        fix = make_condensed_fused_solver(
            p.nx, p.nu, N, max_iter=500, en_state_bound=s.en_state_bound,
            en_input_bound=True)
        fargs = (maps, float(c.rho), p.u_min, p.u_max, p.x_min, p.x_max, x0)
        out_f = fix(*fargs)
        n_fix = int(out_f[3].sum())
        check(n_bkt > n_fix and n_bkt >= 0.95 * B,
              f"phase {phase}: the pipeline converged {n_bkt} of {B}, the "
              f"fixed-rho0 control {n_fix}")
        # the plain pipeline ran its comparison just before: one timing
        t_pipe, t_pipe_p = paired_ms(lambda: pipe.solve(x0),
                                     lambda: pipe_p.solve(x0),
                                     reps=DEEP_REPS, plain_reps=1)
        t_fix = median_ms(lambda: fix(*fargs), reps=5)

        # phase 2's launch alone: K1d over the G buckets' slots, warm from
        # the kernel's phase-1 carry, compacted as the pipeline does
        fn1 = make_condensed_fused_solver(
            p.nx, p.nu, N, max_iter=50, carry_out=True,
            en_state_bound=s.en_state_bound, en_input_bound=True)
        _, _, _, ok1, carry = fn1(*fargs)
        bucket, rho_pred = predict_rho_bucketed(p, s, maps, carry, x0,
                                                float(c.rho), rhos)
        m = (ok1 == 0)[None, :] & (bucket[None, :] == torch.arange(
            G, device=dev)[:, None])
        idx, counts, valid, _ = compact_members(m, B)
        gidx = idx.reshape(-1)
        warm = FusedCarry(*(torch.where(valid[None, :], w[:, gidx], 0.0)
                            .contiguous() for w in carry))
        x0s2 = torch.where(valid[:, None], x0[gidx], 0.0).contiguous()
        brho = torch.tensor(rhos, dtype=f32, device=dev)
        args2 = (bmaps, brho, p.u_min, p.u_max, p.x_min, p.x_max, x0s2, warm)
        kw2 = dict(nx=p.nx, nu=p.nu, N=N, max_iter=450, abs_pri_tol=1e-3,
                   abs_dua_tol=1e-3, en_state_bound=s.en_state_bound,
                   en_input_bound=True, relaxation_alpha=1.0,
                   check_termination=1, warm_start=True, carry_out=False,
                   num_groups=G)
        f_k = functools.partial(condensed_fused_cuda, *args2, **kw2)
        f_p = functools.partial(condensed_fused_reference, *args2, **kw2)
        o_k, o_p = f_k(), f_p()
        err2 = agreement(f"phase {phase} phase-2 launch (K1d, {G} buckets x "
                         f"{B} slots, {int(valid.sum())} of them stragglers) "
                         "vs plain", o_k, o_p, min_solved=0)
        t_k, t_p = paired_ms(f_k, f_p)
        sw = bmaps.T12.shape[-2]
        b2 = launch_bound(sw, p.nx, o_k[2], 0, G * B, bmaps.T12, bmaps.T1,
                          brho, p.u_min, p.u_max, p.x_min, p.x_max, x0s2,
                          tuple(warm), o_k)
        n_tile = tile_iterations(o_k[2], 32, G)
        pad_tiles = int((valid.reshape(G, -1, 32).sum(dim=2) == 0).sum())
        plan2 = fused_tile_plan(p.nx, p.nu, N, False, not s.en_state_bound)
        if plan2.warps:  # the warp layout against tiles of 32 forced
            t32 = shared_tile_plan(p.nx, p.nu, N, False,
                                   not s.en_state_bound)
            f_32 = forced(K, "fused_tile_plan", t32, f_k)
            same2 = same_bits(o_k, f_32())
            check(same2, f"phase {phase}: the phase-2 launch differs from "
                  "its tiles of 32")
            t_k2, t_k32 = paired_ms(f_k, f_32, reps=4)
            live = valid.reshape(G, -1).sum(dim=1).tolist()
            print(f"phase {phase} phase-2 launch layouts: "
                  f"{describe_plan(plan2)}; live slots by bucket {live}; "
                  f"{iteration_report(o_k[2], plan2, G, n_sm, sw, K.state_floats(p.nx, p.nu, N, not s.en_state_bound))}; "
                  f"bit-equal "
                  f"to tiles of 32 forced {same2}; median of 4 in turns: "
                  f"the plan's {t_k2:.3f} ms, tiles of 32 {t_k32:.3f} ms "
                  f"({t_k32 / t_k2:.3f}x)", flush=True)
        print(f"phase {phase} {name}, B={B}, rho0 {rho0}, buckets "
              f"{[float(f'{r:.6g}') for r in rhos]}: phase-1 stragglers "
              f"{int((ok1 == 0).sum())} over the buckets "
              f"{counts.tolist()}, predicted rho span "
              f"[{rho_pred.min().item():.4g}, {rho_pred.max().item():.4g}]; "
              f"converged {n_bkt} ({100.0 * n_bkt / B:.2f}%; plain "
              f"{int(out_p[3].sum())}), fixed-rho0 control (K1, 500 "
              f"iterations) {n_fix} ({100.0 * n_fix / B:.2f}%), mean "
              f"iterations {it.float().mean().item():.1f} (control "
              f"{out_f[2].float().mean().item():.1f}), lane rho span "
              f"[{rho.min().item():.4g}, {rho.max().item():.4g}], overflow "
              f"{overflow.tolist()}; set-up (bucket caches and maps) "
              f"{t_setup:.2f} s; pipeline kernel {t_pipe:.3f} ms (median "
              f"of {DEEP_REPS}), plain {t_pipe_p:.3f} ms (one timing) -> "
              f"{n_bkt / (t_pipe * 1e-3):.0f} solves/s; the control "
              f"{t_fix:.3f} ms (median of 5) -> {n_fix / (t_fix * 1e-3):.0f} "
              f"solves/s on {card}", flush=True)
        tiles = ("" if plan2.warps else
                 f"{n_tile} tile iterations ({G * B // 32} tiles, {pad_tiles} "
                 f"of them all pad slots), "
                 f"{32 * n_tile / int(o_k[2].sum()):.3f} x the slots' own, "
                 f"{1e3 * t_k * n_sm / n_tile:.3f} SM-us each; ")
        print(f"phase {phase} phase-2 launch: kernel {t_k:.3f} ms, plain "
              f"{t_p:.3f} ms (median of 5), bound {b2[0]:.4f} ms by {b2[1]}; "
              f"{tiles}largest count {int(o_k[2].max())}", flush=True)
        if ref_lanes:
            # the standard per-update rebuild, a Riccati fixed point per
            # lane update on the host: a quality reference on a few lanes
            sa = Settings(max_iter=500, en_state_bound=s.en_state_bound,
                          en_input_bound=True, adaptive_rho=True,
                          adaptive_rho_controller="termination",
                          adaptive_rho_rebuild=True,
                          adaptive_rho_min=span[0], adaptive_rho_max=span[1])
            st = batch_mod.set_x0_batch(batch_mod.broadcast_state(
                init_state(p.nx, p.nu, N, dtype=f32, device=dev), ref_lanes),
                x0[:ref_lanes])
            t0 = time.perf_counter()
            _, ca, sol = batch_mod.solve_batch(p, c, sa, st)
            t_std = time.perf_counter() - t0
            both = (sol.solved == 1) & (ok[:ref_lanes] == 1)
            du = ((sol.u - us[:ref_lanes]).abs().amax(dim=(1, 2))[both]
                  .max().item() if bool(both.any()) else float("nan"))
            print(f"phase {phase} quality reference, the standard "
                  f"per-update rebuild on the first {ref_lanes} lanes: "
                  f"converged {int(sol.solved.sum())} (the pipeline "
                  f"{int(ok[:ref_lanes].sum())}), mean iterations "
                  f"{sol.iter.float().mean().item():.1f} (the pipeline "
                  f"{it[:ref_lanes].float().mean().item():.1f}), final rho "
                  f"span [{ca.rho.min().item():.4g}, "
                  f"{ca.rho.max().item():.4g}], largest |u| difference from "
                  f"the pipeline on lanes both solved {du:.3e}; "
                  f"{t_std:.1f} s on the host's clock", flush=True)
            check(int(sol.solved.sum()) >= 1, f"phase {phase}: the standard "
                  "rebuild solved no lane")
        rows.append({
            "name": f"condensed_fused group grid (K1d), bucketed rebuild "
                    f"phase 2, {name} {G} buckets x {B} slots",
            "route": "cuda", "source": src, "replaces": jax_k1 + ":540",
            "launches": n_grouped, "max_abs_err": max(err, err2),
            "ms": t_k, "plain_ms": t_p, "bound_ms": b2[0],
            "bound_by": b2[1], "library_ms": None})

    # -- phase 22: the mis-set cartpole (bench.py's misset_rho_adaptive) ------
    WALL.mark("22")
    rebuild_phase(22, "mis-set cartpole", cartpole, 0.01, 5.0,
                  np.array([2.0, 1e17, 1e17, 1e17]), 5,
                  np.array([1.8, 1.0, 0.4, 0.5]), (1e-4, 1e4), 16)
    # -- phase 23: the mis-set quadrotor (bench.py's misset_rho_quadrotor) ----
    WALL.mark("23")
    rebuild_phase(23, "mis-set quadrotor", quadrotor, 0.05,
                  quadrotor.U_HOVER_BOUND, None, 1, 0.3, (1e-3, 1e3), 0)

    # -- phase 24: the requantized adaptive quadrotor ------------------------
    WALL.mark("24")
    qN = quadrotor.HORIZON
    qp = make_problem(quadrotor.A, quadrotor.B, np.diag(quadrotor.Q_DIAG),
                      np.diag(quadrotor.R_DIAG), quadrotor.RHO, qN,
                      u_min=-quadrotor.U_HOVER_BOUND,
                      u_max=quadrotor.U_HOVER_BOUND, dtype=f32, device=dev)
    qc = precompute_cache(qp.A, qp.B, qp.Q, qp.R, qp.rho_setup)
    tqa = build_condensed_taylor(qp, qc)
    x0_a = torch.as_tensor(np.random.default_rng(1).uniform(
        -0.3, 0.3, size=(B_ADAPT, 12)), dtype=f32, device=dev)
    rhos, bmaps = requantized_buckets(qp, qc)
    G = len(rhos)
    bounds = (qp.u_min, qp.u_max, qp.x_min, qp.x_max)
    rargs = (tqa, bmaps, rhos, *bounds, x0_a)
    rkw = dict(nx=12, nu=4, N=qN, straggler_slots=SLOTS_ADAPT)
    plain = dict(fused_adaptive=condensed_adaptive_reference,
                 fused=condensed_fused_reference)
    zero_counts()
    res = requantized_adaptive_solve(*rargs, **rkw)
    torch.cuda.synchronize()
    k2_n = condensed_adaptive_cuda.launches
    k1_n = condensed_fused_cuda.launches
    k1d_n = condensed_fused_cuda.grouped_launches
    k1c_n = condensed_fused_cuda.reduced_launches
    check(k2_n == 1 and k1_n == 1 and k1d_n == 1 and k1c_n == 1,
          f"phase 24: the requantized pipeline launched K2 {k2_n} times and "
          f"K1 {k1_n} ({k1d_n} over buckets, {k1c_n} with a reduced head); "
          "expected 1 each")
    res_p = requantized_adaptive_solve(*rargs, **plain, **rkw)
    out_r = (res.xs, res.us, res.iters, res.solved, res.rho)
    err24 = adaptive_agreement(
        "phase 24 requantized adaptive pipeline, merged per-lane results vs "
        "plain", out_r, (res_p.xs, res_p.us, res_p.iters, res_p.solved,
                         res_p.rho), min_solved=int(0.99 * B_ADAPT))
    n_r = int(res.solved.sum())
    check(n_r >= 0.99 * B_ADAPT and torch.equal(res.overflow, res_p.overflow),
          f"phase 24: {n_r} of {B_ADAPT} converged, overflow "
          f"{res.overflow.tolist()} (plain {res_p.overflow.tolist()})")
    t_r, t_r_p = paired_ms(lambda: requantized_adaptive_solve(*rargs, **rkw),
                           lambda: requantized_adaptive_solve(*rargs, **plain,
                                                              **rkw),
                           reps=DEEP_REPS, plain_reps=1)
    res0 = requantized_adaptive_solve(*rargs, bf16_head_iters=0, **rkw)
    t_r0 = median_ms(lambda: requantized_adaptive_solve(
        *rargs, bf16_head_iters=0, **rkw))
    akw = dict(nx=12, nu=4, N=qN, straggler_slots=SLOTS_ADAPT)
    res2 = two_phase_adaptive_solve(tqa, *bounds, x0_a, **akw)
    t_2 = median_ms(lambda: two_phase_adaptive_solve(tqa, *bounds, x0_a,
                                                     **akw))
    # the continuations alone, from the same bulk carry: K2's (2,048 slots,
    # warm, up to 2,500 iterations) and the requantized K1d launch (3 x
    # 2,048 slots) with and without its reduced head
    bulk_kw = dict(plant=None, nx=12, nu=4, N=qN, max_iter=ADAPTIVE_BUDGETS[0],
                   abs_pri_tol=1e-3, abs_dua_tol=1e-3, en_state_bound=False,
                   en_input_bound=True, relaxation_alpha=1.0,
                   adaptive_rho_min=quadrotor.RHO, adaptive_rho_max=1e3,
                   adaptive_rho_clipping=True, check_termination=1,
                   controller="termination", taylor_trust=2.0,
                   warm_start=False, carry_out=True)
    f_b24 = functools.partial(condensed_adaptive_cuda, tqa, *bounds, x0_a,
                              None, **bulk_kw)
    out_b24 = f_b24()
    _, _, _, ok_b, _, carry = out_b24
    # the pipeline's K2 bulk launch on its plan (the 4-lane layout) and on
    # 2 lanes a thread (the layout before it) forced: the same bits, timed
    # in turns
    plan24a = adaptive_tile_plan(12, 4, qN, 2, tiles=-(-B_ADAPT // 32),
                                 sms=n_sm)
    f_b24o = forced(K2, "adaptive_tile_plan",
                    shared_adaptive_plan(12, 4, qN, 2), f_b24)
    same24a = same_bits(out_b24, f_b24o())
    check(same24a, "phase 24: the K2 bulk launch differs from its layout of "
          "2 lanes a thread")
    t_b24, t_b24o = paired_ms(f_b24, f_b24o, reps=4)
    unconv = ok_b == 0
    idx_c, _, _, _ = compact_members(unconv[None, :], SLOTS_ADAPT)
    idx_c = idx_c[0]
    c_args = (tqa, *bounds, x0_a[idx_c].contiguous(), AdaptiveFusedCarry(
        *(w[:, idx_c].contiguous() for w in carry)))
    c_kw = dict(bulk_kw, max_iter=ADAPTIVE_BUDGETS[1], warm_start=True,
                carry_out=False)
    t_k2c = median_ms(functools.partial(condensed_adaptive_cuda, *c_args,
                                        **c_kw))
    brho = torch.tensor(rhos, dtype=f32, device=dev)
    snap = torch.argmin(torch.abs(carry.rho[0][:, None] - brho[None, :]),
                        dim=1)
    m = unconv[None, :] & (snap[None, :] == torch.arange(G, device=dev)[
        :, None])
    idx, counts, valid, _ = compact_members(m, SLOTS_ADAPT)
    gidx = idx.reshape(-1)

    def gather(a):
        return torch.where(valid[None, :], a[:, gidx], 0.0).contiguous()

    w2 = torch.cat([carry.z - carry.y, carry.v - carry.g], dim=0)
    warm = FusedCarry(gather(w2), gather(carry.y), gather(carry.g),
                      gather(carry.v), gather(carry.z))
    x0s2 = torch.where(valid[:, None], x0_a[gidx], 0.0).contiguous()
    args2 = (bmaps, brho, *bounds, x0s2, warm)
    kw2 = dict(nx=12, nu=4, N=qN, max_iter=ADAPTIVE_BUDGETS[1],
               abs_pri_tol=1e-3, abs_dua_tol=1e-3, en_state_bound=False,
               en_input_bound=True, relaxation_alpha=1.0, check_termination=1,
               warm_start=True, carry_out=False, num_groups=G,
               bf16_head_iters=REQUANT_HEAD)
    f_k = functools.partial(condensed_fused_cuda, *args2, **kw2)
    f_p = functools.partial(condensed_fused_reference, *args2, **kw2)
    o_k, o_p = f_k(), f_p()
    err24b = agreement(f"phase 24 requantized continuation launch (K1d + "
                       f"K1c head, {G} buckets x {SLOTS_ADAPT} slots, "
                       f"{REQUANT_HEAD} reduced iterations) vs plain", o_k,
                       o_p, min_solved=0)
    t_k, t_p = paired_ms(f_k, f_p, reps=3, plain_reps=1)
    # the launch's plan from its batch, and the layout it replaced (2 lanes
    # a thread) forced beside it: the same bits, timed in turns
    plan24 = fused_tile_plan(12, 4, qN, True)
    f_ko = forced(K, "fused_tile_plan", shared_tile_plan(12, 4, qN, True),
                  f_k)
    same24 = same_bits(o_k, f_ko())
    check(same24, "phase 24: the requantized continuation differs from its "
          "layout of 2 lanes a thread")
    t_k, t_ko = paired_ms(f_k, f_ko, reps=4)
    f_k0 = functools.partial(condensed_fused_cuda, *args2,
                             **dict(kw2, bf16_head_iters=0))
    o_k0 = f_k0()
    t_k0 = median_ms(f_k0)
    sw = bmaps.T12.shape[-2]
    b24 = launch_bound(sw, 12, o_k[2], REQUANT_HEAD, G * SLOTS_ADAPT,
                       bmaps.T12, bmaps.T1, brho, *bounds, x0s2, tuple(warm),
                       o_k)
    n_tile = tile_iterations(o_k[2], 32, G)
    n_tile0 = tile_iterations(o_k0[2], 32, G)
    y24 = product_yardstick([(sw, sw)], G * SLOTS_ADAPT, n_tile,
                            G * -(-SLOTS_ADAPT // 32))
    sv = valid.reshape(G, -1)
    slow = [int(o_k[2].reshape(G, -1)[g][sv[g]].max()) if bool(sv[g].any())
            else 0 for g in range(G)]
    rho_all = torch.cat([res.rho[~res.unconv], brho.repeat_interleave(
        SLOTS_ADAPT)[valid]])
    print(f"phase 24 requantized adaptive quadrotor B={B_ADAPT}, "
          f"{SLOTS_ADAPT} slots a bucket, buckets {list(rhos)}: "
          f"{int(res.unconv.sum())} stragglers over the buckets "
          f"{counts.tolist()}, overflow {res.overflow.tolist()}; converged "
          f"{n_r} ({100.0 * n_r / B_ADAPT:.2f}%; plain "
          f"{int(res_p.solved.sum())}; without the head "
          f"{int(res0.solved.sum())}; two-phase K2 pipeline "
          f"{int(res2.solved.sum())}), mean iterations "
          f"{res.iters.float().mean().item():.1f} (without the head "
          f"{res0.iters.float().mean().item():.1f}; two-phase "
          f"{res2.iters.float().mean().item():.1f}), rho span "
          f"[{rho_all.min().item():.4g}, {rho_all.max().item():.4g}]; "
          f"pipeline kernel {t_r:.3f} ms (median of {DEEP_REPS}), plain "
          f"{t_r_p:.3f} ms (one timing) -> {n_r / (t_r * 1e-3):.0f} "
          f"solves/s; without the head {t_r0:.3f} ms; the two-phase K2 "
          f"pipeline (phase 11's) {t_2:.3f} ms (median of {DEEP_REPS}) on "
          f"{card}", flush=True)
    print(f"phase 24 requantized continuation plan: {describe_plan(plan24)};"
          f" 2 lanes a thread forced (the layout before the batch-aware "
          f"plan) bit-equal {same24}", flush=True)
    print(f"phase 24 K2 bulk plan: {describe_plan(plan24a)}; 2 lanes a "
          f"thread forced (the layout before it) bit-equal {same24a}; "
          f"{t_b24:.3f} ms (median of 4, in turns with 2 lanes a thread "
          f"forced: {t_b24o:.3f} ms, {t_b24o / t_b24:.3f}x)", flush=True)
    print(f"phase 24 continuations alone, from the same bulk carry (median "
          f"of {DEEP_REPS}): K2's {t_k2c:.3f} ms; the requantized K1d launch "
          f"with its {REQUANT_HEAD}-iteration head {t_k:.3f} ms (median of "
          f"4, in turns with 2 lanes a thread forced: {t_ko:.3f} ms, "
          f"{t_ko / t_k:.3f}x; plain "
          f"{t_p:.3f} ms, one timing; bound {b24[0]:.4f} ms by {b24[1]}; "
          f"{n_tile} tile iterations over {G * -(-SLOTS_ADAPT // 32)} tiles, "
          f"{1e3 * t_k * n_sm / n_tile:.3f} SM-us each; product yardstick "
          f"(one cuBLAS fp32 matmul an iteration x the tile iterations) "
          f"{y24:.3f} ms; the slowest slot per bucket {slow}), without the head "
          f"{t_k0:.3f} ms ({n_tile0} tile iterations, "
          f"{1e3 * t_k0 * n_sm / n_tile0:.3f} SM-us each)", flush=True)
    rows.append({
        "name": f"condensed_fused group grid with a reduced head (K1d + "
                f"K1c), requantized adaptive continuation {G} buckets x "
                f"{SLOTS_ADAPT} slots (bound: head at the bf16 rate)",
        "route": "cuda", "source": src, "replaces": jax_k1 + ":540",
        "launches": k1d_n, "max_abs_err": max(err24, err24b), "ms": t_k,
        "plain_ms": t_p, "bound_ms": b24[0], "bound_by": b24[1],
        "library_ms": None})

    # -- phase 25: the long horizon, float64, card against CPU ---------------
    WALL.mark("25")
    N_LONG = 1537
    check(not auto_uses_condensed(4, 1, N_LONG)
          and auto_chunk_size(4, 1, N_LONG) is not None,
          "phase 25: N = 1537 does not select the chunked path")
    t0 = time.perf_counter()
    x0s = np.random.default_rng(8).uniform(-0.5, 0.5, size=(4, 4))

    def long_solver(d):
        sv = TinyMPCSolver(dtype=torch.float64, device=d)
        sv.setup(cartpole.A, cartpole.B, None, np.diag(cartpole.Q_DIAG),
                 np.diag(cartpole.R_DIAG), 1.0, 4, 1, N_LONG, max_iter=100)
        sv.set_bound_constraints(np.full((4, N_LONG), -1e17),
                                 np.full((4, N_LONG), 1e17),
                                 np.full((1, N_LONG - 1), -5.0),
                                 np.full((1, N_LONG - 1), 5.0))
        sv.set_x0([1.0, 0.0, 0.2, 0.0])
        return sv

    outs = []
    for d in (dev, torch.device("cpu")):
        sv = long_solver(d)
        sv.solve()
        check(sv._chunk_maps is not None, "phase 25: solve() did not take "
              "the chunked path")
        batch = sv.solve_batch(x0s, method="auto")
        check(sv._condensed_maps is None, "phase 25: auto built the "
              "condensed maps")
        outs.append((int(sv.solution.iter), sv.get_solution().controls,
                     batch[2].cpu(), batch[1].cpu()))
    (i_c, u_c, bi_c, bu_c), (i_h, u_h, bi_h, bu_h) = outs
    du = float(np.abs(u_c - u_h).max())
    dbu = float((bu_c - bu_h).abs().max())
    check(i_c == i_h and torch.equal(bi_c, bi_h) and du <= RHO_ATOL64
          and dbu <= RHO_ATOL64,
          f"phase 25: card and CPU differ (counts {i_c}/{i_h}, "
          f"{bi_c.tolist()}/{bi_h.tolist()}; controls {du:.3e}, {dbu:.3e})")
    assoc = long_solver(dev)
    assoc.horizon_parallel = True
    assoc.solve()
    seq = long_solver(dev)
    seq.solve(chunked=False)
    da = float(np.abs(assoc.get_solution().controls
                      - seq.get_solution().controls).max())
    dc = float(np.abs(u_c - seq.get_solution().controls).max())
    i_a, i_s = int(assoc.solution.iter), int(seq.solution.iter)
    check(assoc._chunk_maps is None and i_a == i_s == i_c
          and da <= RHO_ATOL64 and dc <= RHO_ATOL64,
          f"phase 25: associative {i_a}, sequential {i_s}, chunked {i_c} "
          f"iterations; controls differ by {da:.3e} (associative) and "
          f"{dc:.3e} (chunked)")
    print(f"phase 25 long horizon, cartpole N={N_LONG} in float64 (condensed "
          f"maps over the {AUTO_CONDENSED_BUDGET_BYTES >> 20} MiB budget: "
          f"chunks of "
          f"{auto_chunk_size(4, 1, N_LONG)} stages): solve() chunked, card "
          f"vs CPU: {i_c} / {i_h} iterations, controls within {du:.3e}; "
          f"solve_batch(method='auto') on 4 lanes: counts {bi_c.tolist()} / "
          f"{bi_h.tolist()}, controls within {dbu:.3e}; on the card the "
          f"associative scans {i_a} and the sequential recursions {i_s} "
          f"iterations, controls within {da:.3e} (chunked within {dc:.3e} "
          f"of the sequential); {time.perf_counter() - t0:.1f} s for the "
          f"phase", flush=True)
    return rows


def persistence_phases(card):
    """Phases 26-30: checkpoint, export, sensitivities, profiling, codegen
    and the native runtime on the card."""
    import shutil
    import tempfile

    from tinympc_julia_tpu_torch import (TinyMPCSolver, compute_sensitivity_fd,
                                         compute_sensitivity_autograd)
    from tinympc_julia_tpu_torch import native
    from tinympc_julia_tpu_torch.models import cartpole, quadrotor
    from tinympc_julia_tpu_torch.ops import admm
    from tinympc_julia_tpu_torch.ops.cuda.condensed_kernel import (
        condensed_fused_cuda)
    from tinympc_julia_tpu_torch.ops.riccati import precompute_cache
    from tinympc_julia_tpu_torch.parallel import batch as batch_mod
    from tinympc_julia_tpu_torch.types import Settings, init_state, map_tensors
    from tinympc_julia_tpu_torch.utils import export, profiling

    dev = torch.device("cuda")
    N = cartpole.HORIZON
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))

    def loop(solvers, x, n):
        """n closed-loop solve() steps of every solver from x, the plant
        driven by the first; (last x, controls, counts) per solver."""
        us, its = [[] for _ in solvers], [[] for _ in solvers]
        for _ in range(n):
            for k, sv in enumerate(solvers):
                sv.set_x0(x)
                sv.solve()
                us[k].append(sv.get_solution().controls)
                its[k].append(int(sv.solution.iter))
            x = cartpole.simulate(x, us[0][-1][:, 0])
        return x, us, its

    def round_trip(sv, name):
        """10 steps, save, load onto the card, 10 more steps of both: the
        loaded solver and its file's size and save and load seconds."""
        x, _, _ = loop([sv], np.array([0.0, 0.0, 0.1, 0.0]), 10)
        path = tmp / f"{name}.npz"
        t0 = time.perf_counter()
        sv.save(path)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        sv2 = TinyMPCSolver.load(path, device="cuda")
        t_load = time.perf_counter() - t0
        check(sv2.problem.A.is_cuda and sv2.state.x.is_cuda
              and sv2.settings == sv.settings,
              f"phase 26 {name}: the loaded solver is not the saved one")
        _, us, its = loop([sv, sv2], x, 10)
        same = its[1] == its[0] and all(np.array_equal(a, b)
                                        for a, b in zip(*us))
        print(f"phase 26 checkpoint {name}: 10 + 10 closed-loop solve() "
              f"steps, the loaded solver's counts {its[1]} (saved "
              f"{its[0]}), controls equal bit for bit: {same}; file "
              f"{path.stat().st_size} bytes, save {t_save:.4f} s, load "
              f"{t_load:.4f} s (host clock) on {card}", flush=True)
        check(same, f"phase 26 {name}: the resumed solver differs")
        return sv2

    # -- phase 26: checkpoint ------------------------------------------------
    WALL.mark("26")
    t0 = time.perf_counter()
    cp64 = cartpole.make_solver(device="cuda", dtype=torch.float64,
                                max_iter=100, constrained=True)
    round_trip(cp64, "cartpole float64")
    cp17 = cartpole.make_solver(device="cuda", dtype=torch.float64,
                                max_iter=100, constrained=True)
    cp17.update_settings(relaxation_alpha=1.7)
    round_trip(cp17, "cartpole float64, relaxation_alpha=1.7")
    # the fused path is float32: phase 5's cartpole (|u| <= 5, alpha 1.7,
    # ct 4, 400 iterations), saved after its 10 solve() steps; the loaded
    # solver's K1 launch reads maps built after the load
    f32 = cartpole.make_solver(device="cuda", dtype=torch.float32,
                               max_iter=400)
    f32.set_bound_constraints(np.full((4, N), -1e17), np.full((4, N), 1e17),
                              np.full((1, N - 1), -5.0),
                              np.full((1, N - 1), 5.0))
    f32.update_settings(relaxation_alpha=1.7, check_termination=4)
    f32b = round_trip(f32, "cartpole float32 (phase 5's settings)")
    check(f32b._condensed_maps is None, "phase 26: the load kept maps")
    x0_main = torch.as_tensor(
        np.random.default_rng(0).uniform(-0.5, 0.5, size=(B_MAIN, 4)),
        dtype=torch.float32, device=dev)
    condensed_fused_cuda.launches = 0
    out_a = f32.solve_batch(x0_main, method="fused")
    out_b = f32b.solve_batch(x0_main, method="fused")
    torch.cuda.synchronize()
    n26 = condensed_fused_cuda.launches
    check(n26 == 2, f"phase 26: two fused solves launched K1 {n26} times")
    same26 = all(torch.equal(a, b) for a, b in zip(out_a, out_b))
    t_a, t_b = paired_ms(lambda: f32.solve_batch(x0_main, method="fused"),
                         lambda: f32b.solve_batch(x0_main, method="fused"),
                         reps=3)
    print(f"phase 26 solve_batch(method='fused') B={B_MAIN} on the saved and "
          f"the loaded float32 solver: {int(out_b[3].sum())} converged, "
          f"outputs equal bit for bit: {same26}; K1 launches {n26}; "
          f"{t_a:.3f} ms saved, {t_b:.3f} ms loaded (median of 3, CUDA "
          f"events) on {card}; {time.perf_counter() - t0:.1f} s for the "
          "phase", flush=True)
    check(same26, "phase 26: the loaded solver's fused batch differs")

    # -- phase 27: export ----------------------------------------------------
    WALL.mark("27")
    t0 = time.perf_counter()
    sv = cartpole.make_solver(device="cuda", dtype=torch.float64,
                              max_iter=100, constrained=True)
    sv.set_x0([0.5, 0.0, 0.1, 0.0])
    p64, c64, s64, st64 = sv.problem, sv.cache, sv.settings, sv.state
    t1 = time.perf_counter()
    fn1 = export.load_solve(export.export_solve(p64, c64, s64, st64))
    t_exp1 = time.perf_counter() - t1
    sol_x = fn1(p64, c64, st64)[2]
    sol_e = admm.solve(p64, c64, s64, st64)[2]
    du1 = (sol_x.u - sol_e.u).abs().max().item()
    check(sol_x.u.is_cuda and int(sol_x.iter) == int(sol_e.iter)
          and du1 <= 1e-12, f"phase 27 single: counts {int(sol_x.iter)} / "
          f"{int(sol_e.iter)}, controls {du1:.3e}")
    tx1, te1 = paired_ms(lambda: fn1(p64, c64, st64),
                         lambda: admm.solve(p64, c64, s64, st64))
    B27 = 4096
    p32 = map_tensors(lambda t: t.to(torch.float32), p64)
    c32 = precompute_cache(p32.A, p32.B, p32.Q, p32.R, p32.rho_setup)
    s32 = Settings(max_iter=100, en_state_bound=False, relaxation_alpha=1.6)
    st32 = batch_mod.set_x0_batch(batch_mod.broadcast_state(
        init_state(4, 1, N, dtype=torch.float32, device=dev), B27),
        torch.as_tensor(np.random.default_rng(27).uniform(
            -0.8, 0.8, size=(B27, 4)), dtype=torch.float32, device=dev))
    t1 = time.perf_counter()
    fnb = export.load_solve(export.export_solve(p32, c32, s32, st32,
                                                batched=True))
    t_expb = time.perf_counter() - t1
    sb_x = fnb(p32, c32, st32)[2]
    sb_e = batch_mod.solve_batch(p32, c32, s32, st32)[2]
    dub = (sb_x.u - sb_e.u).abs().max().item()
    same_it = torch.equal(sb_x.iter, sb_e.iter)
    check(sb_x.u.is_cuda and same_it and dub <= 1e-5,
          f"phase 27 batched: counts equal {same_it}, controls {dub:.3e}")
    txb, teb = paired_ms(lambda: fnb(p32, c32, st32),
                         lambda: batch_mod.solve_batch(p32, c32, s32, st32))
    print(f"phase 27 export made and called on the card: single cartpole "
          f"float64 {int(sol_x.iter)} iterations (eager "
          f"{int(sol_e.iter)}), controls within {du1:.3e}; loaded program "
          f"{tx1:.3f} ms, eager admm.solve {te1:.3f} ms; batched B={B27} "
          f"float32 counts equal on every lane: {same_it} (mean "
          f"{sb_x.iter.float().mean().item():.1f}, {int(sb_x.solved.sum())} "
          f"converged), controls within {dub:.3e}; loaded program "
          f"{txb:.3f} ms, eager solve_batch {teb:.3f} ms (median of 5, CUDA "
          f"events); export and load {t_exp1:.1f} s and {t_expb:.1f} s "
          f"(host) on {card}; {time.perf_counter() - t0:.1f} s for the "
          "phase", flush=True)

    # -- phase 28: sensitivities ---------------------------------------------
    WALL.mark("28")
    t0 = time.perf_counter()
    errs28 = []
    for mod in (cartpole, quadrotor):
        args = (mod.A, mod.B, np.diag(mod.Q_DIAG), np.diag(mod.R_DIAG))
        res = []  # (autograd, fd) on the card, then on the CPU
        for d in (dev, torch.device("cpu")):
            t = [torch.as_tensor(a, dtype=torch.float64, device=d)
                 for a in args]
            res.append((compute_sensitivity_autograd(*t, mod.RHO),
                        compute_sensitivity_fd(*t, mod.RHO)))
        for k, (what, tol) in enumerate((("autograd", 1e-9), ("fd", 1e-6))):
            for a, b in zip(res[0][k], res[1][k]):
                check(a.is_cuda, "phase 28: a sensitivity left the card")
                scale = max(1.0, b.abs().max().item())
                err = (a.cpu() - b).abs().max().item() / scale
                errs28.append((mod.__name__.rsplit(".")[-1], what, err))
                check(err <= tol, f"phase 28 {mod.__name__} {what}: card vs "
                      f"CPU {err:.3e} > {tol} (relative to the largest entry)")
    worst = {}
    for m, what, e in errs28:
        worst[(m, what)] = max(worst.get((m, what), 0.0), e)
    print("phase 28 LQR sensitivities in float64, card vs CPU (largest "
          "difference relative to the largest entry): " + ", ".join(
              f"{m} {w} {e:.3e}" for (m, w), e in worst.items())
          + f"; {time.perf_counter() - t0:.1f} s for the phase", flush=True)

    # -- phase 29: profiling -------------------------------------------------
    WALL.mark("29")
    log_dir = tmp / "trace"
    condensed_fused_cuda.launches = 0
    with profiling.trace(str(log_dir)):
        out29 = f32b.solve_batch(x0_main, method="fused")
    n29 = condensed_fused_cuda.launches
    with open(log_dir / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    # K1's symbols: condensed_fused_kernel (tiles of lanes) and
    # condensed_fused_warp_kernel (the warp layout, this cartpole's)
    k1_events = [e for e in events if e.get("cat") == "kernel"
                 and "condensed_fused_" in e.get("name", "")]
    n_dev = sum(1 for e in events if e.get("cat") == "kernel")
    stats = profiling.solve_stats(
        type("Sol", (), dict(iter=out29[2], solved=out29[3]))())
    k1_us = sum(float(e.get("dur", 0.0)) for e in k1_events)
    print(f"phase 29 profiling.trace around solve_batch(method='fused') "
          f"B={B_MAIN}: {len(k1_events)} K1 launches among {n_dev} device "
          f"kernel events in the trace ({k1_us:.1f} us of K1 device time; "
          f"'{k1_events[0]['name'] if k1_events else None}'), the launch "
          f"count {n29}; solve_stats {stats} on {card}", flush=True)
    check(k1_events, "phase 29: no K1 device event in the trace")
    check(n29 == 1 and len(k1_events) == 1, "phase 29: K1 launches "
          f"{n29} counted, {len(k1_events)} traced, not 1")
    check(stats["n"] == B_MAIN and stats["converged"] > B_MAIN // 2,
          f"phase 29: solve_stats {stats}")

    # -- phase 30: codegen and the native runtime ------------------------------
    WALL.mark("30")
    t0 = time.perf_counter()
    gxx = shutil.which("g++")
    check(gxx is not None, "phase 30: no g++")
    out_dir = tmp / "codegen"
    cp64.set_x0([0.5, 0.0, 0.1, 0.0])
    check(cp64.codegen(str(out_dir)) == 0 and cp64.state.x.is_cuda,
          "phase 30: codegen failed")
    exe = out_dir / "build" / "tiny_mpc_example"
    subprocess.run([gxx, "-O2", "-std=c++17", "-I", str(out_dir / "tinympc"),
                    str(out_dir / "src" / "tiny_data.cpp"),
                    str(out_dir / "src" / "tiny_main.cpp"), "-o", str(exe)],
                   check=True, capture_output=True)
    lines = subprocess.run([str(exe)], check=True, capture_output=True,
                           text=True).stdout.strip().splitlines()
    it_c = int(lines[0].split()[3])
    u_c = np.array([[float(v) for v in ln.split()] for ln in lines[1:]])
    cp64.solve()
    u_p = cp64.get_solution().controls.T
    du_c = float(np.abs(u_c - u_p).max())
    check(it_c == int(cp64.solution.iter) and du_c <= 1e-9,
          f"phase 30: the compiled project's {it_c} iterations / controls "
          f"{du_c:.3e} against the port's {int(cp64.solution.iter)}")
    ns = native.NativeSolver()
    ref = cartpole.make_solver(device="cuda", dtype=torch.float64,
                               max_iter=50, constrained=True)
    ref.set_x0([0.5, 0.0, 0.0, 0.0])
    pr, ca = ref.problem, ref.cache
    ns.setup(cartpole.A, cartpole.B, None, np.diag(cartpole.Q_DIAG),
             np.diag(cartpole.R_DIAG), 1.0, 4, 1, N, max_iter=50)
    ns.set_bound_constraints(*(np.clip(t.cpu().numpy().T, -1e30, 1e30)
                               for t in (pr.x_min, pr.x_max, pr.u_min,
                                         pr.u_max)))
    ns.update_settings(max_iter=50, en_state_bound=True, en_input_bound=True)
    ns.set_cache_terms(*(t.cpu().numpy() for t in (ca.Kinf, ca.Pinf,
                                                   ca.Quu_inv, ca.AmBKt)))
    ns.set_x0([0.5, 0.0, 0.0, 0.0])
    st_n = ns.solve()
    _, u_n = ns.get_solution()
    ns.cleanup()
    st_p = ref.solve()
    du_n = float(np.abs(u_n - ref.get_solution().controls).max())
    print(f"phase 30 codegen of the phase-26 float64 solver (resident on the "
          f"card), compiled with g++ and run: {it_c} iterations, controls "
          f"within {du_c:.3e} of the port's solve(); native.NativeSolver "
          f"({native.build_library().name}) status {st_n}, port status "
          f"{st_p}, controls within {du_n:.3e}; "
          f"{time.perf_counter() - t0:.1f} s for the phase (host) on {card}",
          flush=True)
    check(st_n == st_p and du_n <= 1e-9, f"phase 30: native status "
          f"{st_n} / {st_p}, controls {du_n:.3e}")
    shutil.rmtree(tmp)


def sharded_and_example_phases(card):
    """Phases 31-33: the flagship sharded sweep on a world of one, the dry
    run's three legs on two gloo ranks sharing the card, and the other nine
    examples on the card.  Their times are wall times of host-bound launch
    loops (two ranks on one card in phase 32), not scaling numbers."""
    import contextlib
    import io
    import os
    import shutil
    import sys
    import tempfile

    import torch.distributed as dist

    from tinympc_julia_tpu_torch import dryrun
    from tinympc_julia_tpu_torch.examples import batched_scenario_sweep
    from tinympc_julia_tpu_torch.parallel import make_mesh, solve_batch
    from tinympc_julia_tpu_torch.types import map_tensors

    def echoed(fn, *args, **kw):
        """fn's result and what it printed, which is printed too."""
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            result = fn(*args, **kw)
        print(buf.getvalue(), end="", flush=True)
        return result, buf.getvalue()

    # -- phase 31: the flagship sweep, a one-rank gloo group -----------------
    WALL.mark("31")
    # in a group the vote runs: an all_reduce of the running count an
    # iteration, and the all_gather of block sizes before the loop
    t0 = time.perf_counter()
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{dryrun._free_port()}",
        world_size=1, rank=0)
    try:
        check(make_mesh(device="cuda").group is not None,
              "phase 31: the mesh has no process group")
        (sol, dt), _ = echoed(batched_scenario_sweep.main, B=B_MAIN,
                              device="cuda")
    finally:
        dist.destroy_process_group()
    p, c, s, st = batched_scenario_sweep.scenario(B_MAIN, torch.device("cuda"))
    _, _, ref = solve_batch(p, c, s, st)
    torch.cuda.synchronize()
    same = all(torch.equal(getattr(sol, k), getattr(ref, k))
               for k in ("iter", "solved", "x", "u"))
    n_ok = int(sol.solved.sum())
    # a slice of the lanes on the CPU: equal counts and flags on every
    # lane, and controls within the bar of two fp32 implementations (the
    # card's and the CPU's reductions differ in order; the JAX dry run's
    # 3e-6 for a block against the whole batch on one backend does not
    # hold across the two: 4.5e-6 on the H100)
    lanes = torch.arange(0, B_MAIN, B_MAIN // SWEEP_CPU_LANES, device="cuda")
    cpu = torch.device("cpu")
    _, _, ref_cpu = solve_batch(
        map_tensors(lambda a: a.to(cpu), p), map_tensors(lambda a: a.to(cpu), c),
        s, map_tensors(lambda a: a[lanes].to(cpu), st))
    same_cpu = (torch.equal(sol.iter[lanes].cpu(), ref_cpu.iter)
                and torch.equal(sol.solved[lanes].cpu(), ref_cpu.solved))
    du_cpu = float((sol.u[lanes].cpu() - ref_cpu.u).abs().max())
    print(f"phase 31 batched_scenario_sweep.main(B={B_MAIN}) in a one-rank "
          f"gloo group (the vote's all_reduce on): {n_ok}/{B_MAIN} solved, "
          f"iterations mean {float(sol.iter.double().mean()):.1f} max "
          f"{int(sol.iter.max())}; equal to solve_batch on the same batch "
          f"bit for bit: {same}; {SWEEP_CPU_LANES} lanes against the CPU: "
          f"counts and flags equal {same_cpu}, max |du| {du_cpu:.3e}; the "
          f"timed solve_sharded {dt:.3f} s wall (host-bound launch loop), "
          f"{time.perf_counter() - t0:.1f} s for the phase on {card}",
          flush=True)
    check(same, "phase 31: the sharded sweep differs from solve_batch")
    check(same_cpu and du_cpu <= SWEEP_DU_CPU, f"phase 31: {SWEEP_CPU_LANES}"
          f" lanes against the CPU: counts and flags equal {same_cpu}, max "
          f"|du| {du_cpu:.3e} > {SWEEP_DU_CPU}")
    check(n_ok >= SWEEP_SOLVED * B_MAIN, f"phase 31: {n_ok}/{B_MAIN} solved, "
          f"fewer than {SWEEP_SOLVED:.3f} of the lanes")

    # -- phase 32: the dry run's legs on two gloo ranks of the one card -----
    WALL.mark("32")
    t0 = time.perf_counter()
    paths = dryrun.dryrun_multichip(2, device="cuda", full=True,
                                    timeout=480)
    outs = [dict(np.load(path)) for path in paths]
    for r, out in enumerate(outs):
        check(out["l2_k1_launches"] >= 3, f"phase 32 rank {r}: K1 launched "
              f"{out['l2_k1_launches']} times in leg 2")
        check(out["l3_k1d_launches"] >= 1, f"phase 32 rank {r}: K1d "
              f"launched {out['l3_k1d_launches']} times in leg 3")
    conv = [sum(int(o[k].sum()) for o in outs)
            for k in ("l1_solved", "l3_solved")]
    conv2 = sum(int(o["l2_solved1"].sum()
                    + (o["l2_solved2"] * o["l2_valid"]).sum()) for o in outs)
    print(f"phase 32 dryrun_multichip(2, full=True), two gloo ranks on "
          f"cuda:0, every leg bit-equal to the rank's own run: leg 1 "
          f"{conv[0]}/{B_MAIN} "
          f"quadrotor lanes solved, wall "
          f"{[round(float(o['l1_seconds_vote1']), 3) for o in outs]} s "
          f"(vote) {[round(float(o['l1_seconds_vote0']), 3) for o in outs]} "
          f"s (no vote) a rank; leg 2 (three-phase pipeline, 4,096 slots a "
          f"rank) {conv2}/{B_MAIN} converged, wall "
          f"{[round(float(o['l2_seconds']), 3) for o in outs]} s, K1 "
          f"launches {[int(o['l2_k1_launches']) for o in outs]}, against the "
          f"plain K1 counts equal on "
          f"{[round(float(o['l2_plain_share']), 4) for o in outs]} of lanes, "
          f"max |diff| {[float(o['l2_plain_err']) for o in outs]}; leg 3 "
          f"(rebuild, 2,048 lanes a rank) {conv[1]}/4096 converged, wall "
          f"{[round(float(o['l3_seconds']), 3) for o in outs]} s, K1d "
          f"launches {[int(o['l3_k1d_launches']) for o in outs]}, against "
          f"the plain K1 counts equal on "
          f"{[round(float(o['l3_plain_share']), 4) for o in outs]} of lanes, "
          f"max |diff| {[float(o['l3_plain_err']) for o in outs]}; "
          f"{time.perf_counter() - t0:.1f} s for the phase (host) on {card}",
          flush=True)

    # -- phase 33: the other nine examples on the card -----------------------
    WALL.mark("33")
    def example(name):
        return __import__(f"tinympc_julia_tpu_torch.examples.{name}",
                          fromlist=["main"])

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_examples_"))
    cwd, argv = os.getcwd(), sys.argv
    times = {}

    def run(name, **kw):
        t0 = time.perf_counter()
        out = echoed(example(name).main, device="cuda", **kw)
        times[name] = time.perf_counter() - t0
        return out

    _, text = run("cartpole_one_solve")
    check("[" in text, "phase 33: cartpole_one_solve printed no controls")
    x, _ = run("cartpole_mpc", nsteps=8)
    check(bool(np.all(np.isfinite(x))), "phase 33: cartpole_mpc")
    (max_u, _), _ = run("cartpole_constrained", nsteps=8)
    check(max_u <= 5.0 + 1e-9, f"phase 33: cartpole_constrained |u| {max_u}")
    traj, _ = run("cartpole_gain_scheduled", nsteps=8, plot=False)
    check(traj.shape == (8, 4), "phase 33: cartpole_gain_scheduled")
    for name in ("cartpole_codegen", "quadrotor_hover_codegen"):
        run(name, out_dir=str(tmp / name))
        check((tmp / name / "src" / "tiny_data.cpp").exists(),
              f"phase 33: {name} wrote no project")
    _, text = run("misset_rho_recovery", B=8)
    check("adaptive (rebuild)" in text, "phase 33: misset_rho_recovery")
    _, text = run("rocket_landing")
    check("Final position" in text, "phase 33: rocket_landing")
    swing = example("cartpole_swingup_animation")
    max_steps, stable_steps = swing.MAX_STEPS, swing.STABLE_STEPS
    try:
        os.chdir(tmp)
        sys.argv = ["cartpole_swingup_animation.py", "--no-gif"]
        swing.MAX_STEPS, swing.STABLE_STEPS = 60, 10
        run("cartpole_swingup_animation")
        states = np.load(tmp / "cartpole_swingup.npz")["states"]
    finally:
        os.chdir(cwd)
        sys.argv = argv
        swing.MAX_STEPS, swing.STABLE_STEPS = max_steps, stable_steps
    check(states.shape[0] == swing.ATTEMPTS,
          "phase 33: cartpole_swingup_animation")
    shutil.rmtree(tmp)
    print(f"phase 33 the nine other examples on the card, quick arguments, "
          f"each with its CPU test's assertion; wall s (host-bound): "
          f"{ {k: round(v, 3) for k, v in times.items()} } on {card}",
          flush=True)


def lifted_agreement(name, out_k, out_p, rho=False):
    """The lifted shapes' bar, kernel against plain version: equal counts
    and solved flags on >= 99% of lanes, 1e-4 on the states and controls of
    those lanes, solved or not; for K2 (``rho``) on those that solved, with
    the final rho within RHO_RTOL: an unsolved lane's rho path turns on the
    controller's deadband, so two sums in another order part its iterates.
    Returns (max |diff|, lanes solved by the kernel)."""
    same = (out_k[2] == out_p[2]) & (out_k[3] == out_p[3])
    B = same.numel()
    frac = same.float().mean().item()
    every = max(((out_k[j] - out_p[j]).abs()[same].max().item()
                 if bool(same.any()) else 0.0) for j in (0, 1))
    if rho:
        same = same & (out_k[3] == 1)
    err = max(((out_k[j] - out_p[j]).abs()[same].max().item()
               if bool(same.any()) else 0.0) for j in (0, 1))
    rho_err = (((out_k[4] - out_p[4]).abs() / out_p[4])[same].max().item()
               if rho and bool(same.any()) else 0.0)
    nk, npl = int(out_k[3].sum()), int(out_p[3].sum())
    print(f"{name}: solved kernel {nk}/{B}, plain {npl}; counts and flags "
          f"equal on {round(frac * B)}/{B} lanes ({frac:.4f}); max |diff| on "
          f"{int(same.sum())} of them {err:.3e}"
          + (f" (solved), rho rel. diff {rho_err:.3e}; on every lane with "
             f"equal counts {every:.3e}" if rho else "")
          + f"; lanes that differ at all {lanes_differ(out_k, out_p)}",
          flush=True)
    check(frac >= ITERS_AGREE, f"{name}: counts agree on {frac:.4f} < "
          f"{ITERS_AGREE}")
    check(err <= ATOL, f"{name}: max |diff| {err:.3e} > {ATOL}")
    check(rho_err <= RHO_RTOL, f"{name}: rho differs by {rho_err:.3e}")
    check(all(bool(torch.isfinite(t).all()) for t in out_k[:2]),
          f"{name}: non-finite kernel output")
    return err, nk


def lifted_shape_phases(card):
    """Phases 34-37: the shapes the kernels once refused and the JAX
    kernels solve, each kernel against its plain version at the lifted
    layout the plan takes there, with its launches counted on its first
    (untimed) run."""
    from tinympc_julia_tpu_torch import make_problem
    from tinympc_julia_tpu_torch.models import quadrotor
    from tinympc_julia_tpu_torch.ops.condensed import (build_condensed,
                                                       build_condensed_taylor)
    from tinympc_julia_tpu_torch.ops.cuda import adaptive_kernel as K2
    from tinympc_julia_tpu_torch.ops.cuda import condensed_kernel as K
    from tinympc_julia_tpu_torch.ops.cuda import fused as K3
    from tinympc_julia_tpu_torch.ops.cuda.layout_probe import (
        chain36_case, chain_plant, product_yardstick, quad_k1_case,
        quad_k1_kw, quad_wide_case, quad_wide_kw, same_bits)
    from tinympc_julia_tpu_torch.ops.riccati import precompute_cache
    from tinympc_julia_tpu_torch.types import stack_instances
    from unittest import mock

    dev, f32 = torch.device("cuda"), torch.float32
    k1, k2, k3 = (K.condensed_fused_cuda, K2.condensed_adaptive_cuda,
                  K3.fused_cuda)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    t_start = time.perf_counter()

    def quad(horizon, x_bound=None, rng=None):
        A, Bm = quadrotor.A, quadrotor.B
        Qd, Rd, ub = quadrotor.Q_DIAG, quadrotor.R_DIAG, 0.5
        if rng is not None:  # models/sweeps.py's randomised plant
            A = A + rng.normal(scale=2e-3, size=(12, 12))
            Bm = Bm * rng.uniform(0.9, 1.1)
            Qd = Qd * rng.uniform(0.8, 1.25, size=12)
            Rd = Rd * rng.uniform(0.8, 1.25, size=4)
            ub = rng.uniform(0.4, 0.6)
        kw = {}
        if x_bound is not None:
            kw = dict(x_min=np.full((horizon, 12), -x_bound),
                      x_max=np.full((horizon, 12), x_bound))
        p = make_problem(A, Bm, np.diag(Qd), np.diag(Rd), quadrotor.RHO,
                         horizon, u_min=-ub, u_max=ub, dtype=f32,
                         device=dev, **kw)
        return p, precompute_cache(p.A, p.B, p.Q, p.R, p.rho_setup)

    def chain(horizon, x_bound=None):
        A, Bm = chain_plant()
        kw = {}
        if x_bound is not None:
            kw = dict(x_min=np.full((horizon, 20), -x_bound),
                      x_max=np.full((horizon, 20), x_bound))
        p = make_problem(A, Bm, np.eye(20), np.eye(9), 1.0, horizon,
                         u_min=-1.0, u_max=1.0, dtype=f32, device=dev, **kw)
        return p, precompute_cache(p.A, p.B, p.Q, p.R, p.rho_setup)

    def uniform(B, nx, seed, scale):
        return torch.as_tensor(np.random.default_rng(seed).uniform(
            -scale, scale, size=(B, nx)), dtype=f32, device=dev)

    def chain_x0(B, seed):
        return torch.as_tensor(0.5 * np.random.default_rng(seed)
                               .standard_normal((B, 20)), dtype=f32,
                               device=dev)

    def k1_plan(*a):
        """K1's plan as a launch takes it: cluster sizes weighed by the
        card's occupancy API."""
        return K.fused_tile_plan(*a, busy_sms=K.card_busy_sms)

    def k2_plan(*a):
        return K2.adaptive_tile_plan(*a, busy_sms=K2.card_busy_sms)

    def k1_kw(p, **kw):
        base = dict(nx=p.nx, nu=p.nu, N=p.N, max_iter=100, abs_pri_tol=1e-3,
                    abs_dua_tol=1e-3, en_state_bound=False,
                    en_input_bound=True, relaxation_alpha=1.7,
                    check_termination=1, warm_start=False, carry_out=False)
        base.update(kw)
        return base

    def k1_ops(sw, nx, iters, k0=0, ct=1):
        """(fp32, bf16) multiply-adds x 2 of K1 launches whose lanes ran
        ``iters``: one T12 product an iteration after the cold iteration
        0, reduced in the head but for its checking iteration, and the
        rollout of x0."""
        it = iters.double()
        prods = (it - 1).clamp(min=0)
        lo = ((torch.minimum(it, torch.tensor(float(k0), device=it.device))
               - 1).clamp(min=0) - (it >= k0).double()).clamp(min=0) \
            if k0 else torch.zeros_like(it)
        per = 2.0 * sw * sw
        return (per * float((prods - lo).sum()) + 2.0 * sw * nx * it.numel(),
                per * float(lo.sum()))

    def mixed_bound(f32_ops, bf16_ops, nbytes):
        t_ops = f32_ops / PEAK_FP32 + bf16_ops / PEAK_BF16
        t_bytes = nbytes / PEAK_BYTES
        return (1e3 * max(t_ops, t_bytes),
                "operations" if t_ops >= t_bytes else "bytes")

    def run_case(label, f_k, f_p, counter, *, rho=False, slow_plain=False):
        """The kernel's first run (its launches counted), the plain
        version's, the bar, then the kernel's median of 3 after a warm-up
        (CUDA events) and the plain version's median of 3 (or, where it
        takes seconds or over SLOW_PLAIN_MS, its one timed comparison run,
        printed as one timing)."""
        name, attr = counter
        setattr(name, attr, 0)
        out_k = f_k()
        torch.cuda.synchronize()
        launches = getattr(name, attr)
        check(launches >= 1, f"{label}: the kernel was not launched")
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        out_p = f_p()
        t1.record()
        t1.synchronize()
        err, nk = lifted_agreement(label, out_k, out_p, rho)
        if slow_plain or t0.elapsed_time(t1) > SLOW_PLAIN_MS:
            f_k()
            t_k = float(np.median([event_ms(f_k) for _ in range(3)]))
            t_p = t0.elapsed_time(t1)
            print(f"({label}: the plain version timed once, {t_p:.3f} ms)",
                  flush=True)
        else:
            t_k, t_p = paired_ms(f_k, f_p, reps=3)
        return out_k, out_p, err, launches, t_k, t_p

    def row(name, launches, err, t_k, t_p, b, source, replaces, **extra):
        rows.append({
            "name": name, "route": "cuda",
            "source": f"tinympc_julia_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches,
            "max_abs_err": err, "ms": t_k, "plain_ms": t_p,
            "bound_ms": b[0], "bound_by": b[1], "library_ms": None, **extra})

    k1_src, k1_rep = ("condensed_fused.cu",
                      "tinympc_julia_tpu/ops/pallas/condensed_kernel.py:232")
    k2_src, k2_rep = ("condensed_adaptive.cu",
                      "tinympc_julia_tpu/ops/pallas/adaptive_kernel.py:106")
    k3_src, k3_rep = ("fused_stage.cu", "tinympc_julia_tpu/ops/pallas/fused.py:44")

    def layout(plan, lanes=None):
        """K1's or K2's plan as phases 34-35 print it; with ``lanes``, the
        launch's blocks and how many of them (of the card's SMs) run at
        once, from the occupancy API."""
        if plan.cluster > 1:
            where = (f"a cluster of {plan.cluster} blocks a tile, each a "
                     f"slice of whole stages (bounds {list(plan.stages)}) "
                     "with its rows of the input in its shared memory")
        elif getattr(plan, "w2_global", False) or getattr(
                plan, "iterates_global", False):
            where = "the input in global memory"
        else:
            where = "the input in shared memory"
        passes = (plan.passes if hasattr(plan, "passes")
                  else f"{plan.passes1} / {plan.passes2}")
        text = (f"tile {plan.tile} lanes, {plan.rpt} rows a thread, "
                f"{passes} passes a block, {where}, {plan.smem} bytes of "
                "shared memory")
        if lanes is not None:
            occ = (K.tile_occupancy(plan) if hasattr(plan, "passes")
                   else K2.adaptive_occupancy(plan))
            blocks = -(-lanes // plan.tile) * plan.cluster
            at_once = min(blocks, occ * plan.cluster if plan.cluster > 1
                          else occ * sms)
            text += (f"; {blocks} blocks, {at_once} at once on "
                     f"{min(at_once, sms)} of {sms} SMs")
        return text

    def yardstick(label, shapes, lanes, counts, tile):
        """Phase 16's kind of yardstick: the launch's products alone, one
        cuBLAS fp32 matmul an iteration over every lane, times the
        iterations its tiles ran on average (printed; not a kernels-line
        number)."""
        tiles = -(-lanes // tile)
        y = product_yardstick(shapes, lanes, K.tile_iterations(counts, tile),
                              tiles)
        print(f"{label} product yardstick: {y:.3f} ms", flush=True)
        return y

    # -- phase 34: K1 at wide maps --------------------------------------------
    WALL.mark("34")
    # the SMs each cluster size keeps busy on this card (the occupancy API,
    # what a launch weighs the sizes by) beside the CLUSTER_SMS table the
    # CPU plan tests use
    busy = {C: K.card_busy_sms(K.cluster_tile_plan(12, 4, 150, blocks=C))
            for C in K.CLUSTER_SIZES if C >= 3}
    print(f"phase 34 busy SMs by cluster size (quadrotor N=150 slices): "
          f"card {busy}, table "
          f"{ {C: K.CLUSTER_SMS[C] for C in busy} }", flush=True)
    N34, B34 = 150, 8192
    p, c = quad(N34)
    m = build_condensed(p, c)
    sw = m.T12.shape[0]
    x0 = uniform(B34, 12, 34, 0.3)
    args = (m, float(c.rho), p.u_min, p.u_max, p.x_min, p.x_max, x0, None)
    for tag, kw in (("34a K1", {}),
                    ("34b K1c, a 32-iteration bf16 head",
                     dict(bf16_head_iters=32))):
        full = k1_kw(p, **kw)
        plan = k1_plan(12, 4, N34, bool(kw))
        check(plan.cluster > 1, f"phase {tag[:3]}: the plan did not take "
              "a cluster")
        label = (f"phase {tag}, quadrotor N={N34} (sw={sw}), B={B34}, 100 "
                 f"iterations, alpha 1.7, ct 1, |u| <= 0.5: "
                 f"{layout(plan, B34)}")
        out_k, _, err, n_l, t_k, t_p = run_case(
            label, functools.partial(k1, *args, **full),
            functools.partial(K.condensed_fused_reference, *args, **full),
            (k1, "reduced_launches" if kw else "launches"),
            slow_plain=bool(kw))  # the tensor cores' sums take seconds
        if not kw:
            out_34a, plan_34a = out_k, plan
        ops = k1_ops(sw, 12, out_k[2], kw.get("bf16_head_iters", 0))
        b = mixed_bound(*ops, tensor_bytes(m.T12, m.T1, *args[2:7],
                                           out_k[:4]))
        print(f"phase {tag[:3]} timing: kernel {t_k:.3f} ms, plain "
              f"{t_p:.3f} ms, {n_l} launch(es), bound {b[0]:.4f} ms by "
              f"{b[1]}", flush=True)
        yardstick(f"phase {tag[:3]}", [(sw, sw)], B34, out_k[2], 32)
        row(f"condensed_fused (K1{'c' if kw else ''}), quadrotor N={N34} "
            f"(sw {sw}): {layout(plan)}", n_l, err, t_k, t_p, b, k1_src,
            k1_rep)
    # 34a forced onto w2 in global memory, the layout a map takes past a
    # cluster of 8's slices: against the plain version, and bit for bit
    # against the cluster
    full = k1_kw(p)
    g_plan = K.global_tile_plan(12, 4, N34)
    out_k, _, err, n_l, t_k, t_p = run_case(
        f"phase 34a K1 forced onto w2 in global memory, quadrotor N={N34}, "
        f"B={B34}, 100 iterations: {layout(g_plan, B34)}",
        forced(K, "fused_tile_plan", g_plan,
               functools.partial(k1, *args, **full)),
        functools.partial(K.condensed_fused_reference, *args, **full),
        (k1, "launches"))
    exact = same_bits(out_k, out_34a)
    b = bound(k1_ops(sw, 12, out_k[2])[0],
              tensor_bytes(m.T12, m.T1, *args[2:7], out_k[:4]))
    print(f"phase 34a w2 in global memory timing: kernel {t_k:.3f} ms, "
          f"plain {t_p:.3f} ms, {n_l} launch(es), bound {b[0]:.4f} ms by "
          f"{b[1]}; bit-equal to the cluster of {plan_34a.cluster} {exact}",
          flush=True)
    check(exact, "phase 34a: w2 in global memory differs from the cluster")
    row(f"condensed_fused (K1), quadrotor N={N34} (sw {sw}) forced onto "
        f"{layout(g_plan)}", n_l, err, t_k, t_p, b, k1_src, k1_rep)
    del out_34a
    # N = 99 (sw 1,580), the widest map whose w2 fits a block's shared
    # memory, on the cluster layout and forced onto w2 in shared memory (13
    # passes of 128 rows): the same bits, and the two times (where the
    # plan's switch pays, R11)
    p99, c99 = quad(99)
    m99 = build_condensed(p99, c99)
    sw99 = m99.T12.shape[0]
    args99 = (m99, float(c99.rho), p99.u_min, p99.u_max, p99.x_min,
              p99.x_max, x0, None)
    f99 = functools.partial(k1, *args99, **k1_kw(p99))
    plan99 = k1_plan(12, 4, 99)
    s_plan = K.shared_tile_plan(12, 4, 99)
    out_c = f99()
    f99()
    t_c = float(np.median([event_ms(f99) for _ in range(3)]))
    f99s = forced(K, "fused_tile_plan", s_plan, f99)
    out_s = f99s()
    exact = same_bits(out_c, out_s)
    f99s()
    t_s = float(np.median([event_ms(f99s) for _ in range(3)]))
    print(f"phase 34a quadrotor N=99 (sw={sw99}), B={B34}, 100 iterations: "
          f"its plan ({layout(plan99, B34)}) {t_c:.3f} ms; forced onto w2 "
          f"in shared memory ({layout(s_plan, B34)}) {t_s:.3f} ms; "
          f"bit-equal {exact}", flush=True)
    check(plan99.cluster > 1 and s_plan.cluster == 1,
          "phase 34a: N = 99 is not on the cluster layout")
    check(exact, "phase 34a: the two layouts at N = 99 differ")
    del m99, args99, f99

    # 34c: the group grid on G = 8 randomised plants (models/sweeps.py's
    # draws, seed 4) built at N = 150
    G, L = 8, 1024
    rng = np.random.default_rng(4)
    pcs = [quad(N34, rng=rng) for _ in range(G)]
    P = stack_instances([q[0] for q in pcs])
    Cc = stack_instances([q[1] for q in pcs])
    mg = build_condensed(P, Cc)
    x0g = torch.as_tensor(rng.uniform(-0.25, 0.25, size=(G, L, 12)),
                          dtype=f32, device=dev)
    gargs = (mg, Cc.rho, P.u_min, P.u_max, P.x_min, P.x_max, x0g, None)
    gfull = k1_kw(p, check_termination=4)
    plan = k1_plan(12, 4, N34)
    out_k, _, err, n_l, t_k, t_p = run_case(
        f"phase 34c K1d, G={G} randomised quadrotors x L={L}, N={N34}, 100 "
        f"iterations, ct 4: {layout(plan, G * L)}",
        functools.partial(k1, *gargs, num_groups=G, **gfull),
        functools.partial(K.condensed_fused_reference, *gargs, num_groups=G,
                          **gfull), (k1, "grouped_launches"))
    b = bound(k1_ops(sw, 12, out_k[2])[0],
              tensor_bytes(mg.T12, mg.T1, *gargs[1:7], out_k[:4]))
    print(f"phase 34c timing: kernel {t_k:.3f} ms, plain {t_p:.3f} ms, {n_l} "
          f"launch(es), bound {b[0]:.4f} ms by {b[1]}", flush=True)
    yardstick("phase 34c", [(sw, sw)], G * L, out_k[2], 32)
    row(f"condensed_fused group grid (K1d), {G} quadrotors x {L} lanes, "
        f"N={N34}: {layout(plan)}", n_l, err, t_k, t_p, b, k1_src, k1_rep)

    # 34e: the carry chain, two launches of 50 against one of 100
    chain_k = functools.partial(k1, *args[:7])
    one = chain_k(None, **k1_kw(p, max_iter=100))

    def chained(fn):
        a = fn(None, **k1_kw(p, max_iter=50, carry_out=True))
        b2 = fn(a[4], **k1_kw(p, max_iter=50, warm_start=True))
        done = a[3] == 1
        return (torch.where(done[:, None, None], a[0], b2[0]),
                torch.where(done[:, None, None], a[1], b2[1]),
                torch.where(done, a[2], 50 + b2[2]),
                torch.maximum(a[3], b2[3]))

    out_k, _, err, n_l, t_k, t_p = run_case(
        f"phase 34e K1b, quadrotor N={N34}, B={B34}, 50 + 50 chained "
        f"through the carry: {layout(k1_plan(12, 4, N34), B34)}",
        lambda: chained(chain_k),
        lambda: chained(functools.partial(K.condensed_fused_reference,
                                          *args[:7])), (k1, "launches"))
    exact = all(torch.equal(a, b2) for a, b2 in zip(out_k, one))
    print(f"phase 34e chain vs one 100-iteration launch: bit-exact {exact}; "
          f"timing: the two launches {t_k:.3f} ms, plain {t_p:.3f} ms",
          flush=True)
    yardstick("phase 34e", [(sw, sw)], B34, out_k[2], 32)
    check(exact, "phase 34e: the chained launches differ from one launch")
    b = bound(k1_ops(sw, 12, out_k[2])[0] + 2.0 * sw * 12 * B34,
              2 * tensor_bytes(m.T12, m.T1, *args[2:7], out_k[:4]))
    row(f"condensed_fused carry chain (K1b), quadrotor N={N34}, 50 + 50: "
        f"{layout(k1_plan(12, 4, N34))}", n_l, err, t_k, t_p, b,
        k1_src, k1_rep)

    # 34d: the JAX budget's edge, w2 in global memory
    N34d, B34d = 387, 4096
    p, c = quad(N34d)
    m = build_condensed(p, c)
    sw = m.T12.shape[0]
    args = (m, float(c.rho), p.u_min, p.u_max, p.x_min, p.x_max,
            uniform(B34d, 12, 35, 0.3), None)
    full = k1_kw(p, max_iter=50)
    plan = k1_plan(12, 4, N34d)
    check(plan.cluster > 1, "phase 34d: the plan did not take a cluster")
    out_k, _, err, n_l, t_k, t_p = run_case(
        f"phase 34d K1, quadrotor N={N34d} (sw={sw}), B={B34d}, 50 "
        f"iterations: {layout(plan, B34d)}",
        functools.partial(k1, *args, **full),
        functools.partial(K.condensed_fused_reference, *args, **full),
        (k1, "launches"))
    b = bound(k1_ops(sw, 12, out_k[2])[0],
              tensor_bytes(m.T12, m.T1, *args[2:7], out_k[:4]))
    print(f"phase 34d timing: kernel {t_k:.3f} ms, plain {t_p:.3f} ms, {n_l} "
          f"launch(es), bound {b[0]:.4f} ms by {b[1]}", flush=True)
    yardstick("phase 34d", [(sw, sw)], B34d, out_k[2], 32)
    row(f"condensed_fused (K1), quadrotor N={N34d} (sw {sw}): "
        f"{layout(plan)}", n_l, err, t_k, t_p, b, k1_src, k1_rep)
    del m, args
    print(f"phase 34 done {time.perf_counter() - t_start:.0f} s into "
          "phases 34-37", flush=True)

    # -- phase 35: K2 with its tile split over a cluster, its OSQP-form
    WALL.mark("35")
    # controller on a wide stage ---------------------------------------------
    def k2_ops(p, order, iters):
        su, sw = (p.N - 1) * p.nu, p.N * p.nx + (p.N - 1) * p.nu
        in1 = su + p.nx + 1
        per = 2.0 * (order + 1) * sw * in1 + 8.0 * su * (sw + 1)
        return per * float(iters.double().sum())

    for N35 in (150, 213):
        p, c = quad(N35)
        tm = build_condensed_taylor(p, c)
        plan = k2_plan(12, 4, N35, 2)
        check(plan.cluster > 1, f"phase 35a N={N35}: the plan did not "
              "take a cluster")
        args = (tm, p.u_min, p.u_max, p.x_min, p.x_max,
                uniform(2048, 12, 36, 0.3), None)
        full = dict(plant=None, nx=12, nu=4, N=N35, max_iter=150,
                    abs_pri_tol=1e-3, abs_dua_tol=1e-3, en_state_bound=False,
                    en_input_bound=True, relaxation_alpha=1.0,
                    adaptive_rho_min=quadrotor.RHO, adaptive_rho_max=1e3,
                    adaptive_rho_clipping=True, check_termination=1,
                    controller="termination", taylor_trust=2.0,
                    warm_start=False, carry_out=False)
        out_k, out_p, err, n_l, t_k, t_p = run_case(
            f"phase 35a K2, quadrotor N={N35} (sw={tm.T1s.shape[-2]}), "
            f"B=2048, 150 iterations, termination controller, rho0 5, trust "
            f"2: {layout(plan, 2048)}",
            functools.partial(k2, *args, **full),
            functools.partial(K2.condensed_adaptive_reference, *args, **full),
            (k2, "launches"), rho=True)
        b = bound(k2_ops(p, 2, out_k[2]),
                  tensor_bytes(tm.T1s, tm.T2s, *args[1:6], out_k[:5]))
        print(f"phase 35a N={N35} timing: kernel {t_k:.3f} ms, plain "
              f"{t_p:.3f} ms, {n_l} launch(es), bound {b[0]:.4f} ms by "
              f"{b[1]}", flush=True)
        sw35, su35 = tm.T1s.shape[-2], 4 * (N35 - 1)
        yardstick(f"phase 35a N={N35}", [(3 * sw35, su35 + 13),
                                         (4 * su35, sw35 + 1)], 2048,
                  out_k[2], 32)
        row(f"condensed_adaptive (K2), quadrotor N={N35} (sw {sw35}): "
            f"{layout(plan)}", n_l, err, t_k, t_p, b, k2_src, k2_rep)
        if N35 == 150:
            # forced onto the iterates in global memory, the layout past a
            # cluster of 8's slices: against the plain version, and bit for
            # bit against the cluster
            g_plan = K2.global_adaptive_plan(12, 4, N35, 2)
            out_g, _, err, n_l, t_k, t_p = run_case(
                f"phase 35a K2 forced onto the iterates in global memory, "
                f"quadrotor N={N35}, B=2048: {layout(g_plan, 2048)}",
                forced(K2, "adaptive_tile_plan", g_plan,
                       functools.partial(k2, *args, **full)),
                functools.partial(K2.condensed_adaptive_reference, *args,
                                  **full), (k2, "launches"), rho=True)
            exact = same_bits(out_g, out_k)
            b = bound(k2_ops(p, 2, out_g[2]),
                      tensor_bytes(tm.T1s, tm.T2s, *args[1:6], out_g[:5]))
            print(f"phase 35a N={N35} iterates in global memory timing: "
                  f"kernel {t_k:.3f} ms, plain {t_p:.3f} ms, {n_l} "
                  f"launch(es), bound {b[0]:.4f} ms by {b[1]}; bit-equal "
                  f"to the cluster of {plan.cluster} {exact}", flush=True)
            check(exact, "phase 35a: the iterates in global memory differ "
                  "from the cluster")
            row(f"condensed_adaptive (K2), quadrotor N={N35} (sw {sw35}) "
                f"forced onto {layout(g_plan)}", n_l, err, t_k, t_p, b,
                k2_src, k2_rep)
            del out_g
        if N35 == 213:
            # the lanes with equal counts that did not solve, each fp32 run
            # against the plain version in float64 on the same problem
            p64 = make_problem(quadrotor.A, quadrotor.B,
                               np.diag(quadrotor.Q_DIAG),
                               np.diag(quadrotor.R_DIAG), quadrotor.RHO,
                               N35, u_min=-0.5, u_max=0.5,
                               dtype=torch.float64, device=dev)
            c64 = precompute_cache(p64.A, p64.B, p64.Q, p64.R, p64.rho_setup)
            args64 = (build_condensed_taylor(p64, c64), p64.u_min, p64.u_max,
                      p64.x_min, p64.x_max, args[5].double(), None)
            out64 = K2.condensed_adaptive_reference(*args64, **full)
            open_ = ((out_k[2] == out_p[2]) & (out_k[3] == 0)
                     & (out_p[3] == 0))
            d_k, d_p = (max(float((o[j].double() - out64[j]).abs()[open_]
                                  .max()) if bool(open_.any()) else 0.0
                            for j in (0, 1))
                        for o in (out_k, out_p))
            print(f"phase 35a N={N35}: on the {int(open_.sum())} lanes with "
                  f"equal counts that did not solve, max |diff| from the "
                  f"float64 plain version: kernel {d_k:.3e}, fp32 plain "
                  f"{d_p:.3e}; lanes where float64 also has not solved "
                  f"{int((open_ & (out64[3] == 0)).sum())}", flush=True)
            check(d_k <= 2.0 * d_p + ATOL, f"phase 35a N={N35}: the kernel "
                  "strays from float64 further than the fp32 plain version")
            del args64, out64
        del tm, args

    # N = 90 (sw 1,436) on its plan and on the other layout, fp32 and with
    # the reduced products of the iterations that neither check nor predict
    # rho, and under the OSQP-form controller (its residuals read the next
    # stage's rows across the cluster's slices): the cluster against tiles
    # of 16 lanes in shared memory (both products in passes), the same bits
    # whatever order cuBLAS sums in, and the two times (the switch, R11)
    N90 = 90
    p, c = quad(N90)
    tm = build_condensed_taylor(p, c)
    args = (tm, p.u_min, p.u_max, p.x_min, p.x_max,
            uniform(2048, 12, 39, 0.3), None)
    sw = 16 * N90 - 4
    osqp = dict(controller="osqp", adaptive_rho_min=3.0,
                plant=K2.AdaptivePlant(p.A, p.B, p.Q, p.R, c.Pinf,
                                       c.dPinf_drho))
    for tag, kw in (("fp32", {}), ("precision='default' at ct=5",
                                   dict(precision="default",
                                        check_termination=5)),
                    ("the OSQP-form controller, rho in [3, 7]", osqp)):
        lo = "precision" in kw
        c_plan = K2.cluster_adaptive_plan(12, 4, N90, 2, lo)
        s_plan = K2.shared_adaptive_plan(12, 4, N90, 2, lo)
        check(c_plan is not None and s_plan is not None
              and s_plan.tile == 16, "phase 35a: N = 90 lacks a layout")
        f90 = functools.partial(k2, *args, **dict(full, N=N90, **kw))
        times, outs, counts = {}, {}, {}
        for name, pl in (("cluster", c_plan), ("tiles", s_plan)):
            with mock.patch.object(K2, "adaptive_tile_plan",
                                   lambda *a, pl=pl, **k: pl):
                k2.launches = 0
                outs[name] = f90()
                torch.cuda.synchronize()
                counts[name] = k2.launches
                times[name] = float(np.median([event_ms(f90)
                                               for _ in range(3)]))
        torch.cuda.synchronize()
        exact = all(torch.equal(a, b2) for a, b2 in
                    zip(outs["cluster"][:5], outs["tiles"][:5]))
        takes = ("the cluster" if k2_plan(12, 4, N90, 2, lo).cluster > 1
                 else "tiles of 16")
        print(f"phase 35a quadrotor N={N90} (sw={sw}), B=2048, 150 "
              f"iterations, {tag}: the plan takes {takes}; "
              f"cluster ({layout(c_plan, 2048)}) {times['cluster']:.3f} ms "
              f"against tiles of {s_plan.tile} lanes (passes "
              f"{s_plan.passes1} / {s_plan.passes2}) {times['tiles']:.3f} "
              f"ms: bit-equal {exact}, solved "
              f"{int(outs['tiles'][3].sum())}", flush=True)
        check(exact, f"phase 35a N={N90} {tag}: the cluster differs from "
              "the 16-lane tile")
        if kw is osqp:
            # the OSQP-form controller on the cluster beside its plain
            # version (one timed comparison run) and its bound
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            out_p = K2.condensed_adaptive_reference(
                *args, **dict(full, N=N90, **kw))
            t1.record()
            t1.synchronize()
            err, _ = lifted_agreement(
                f"phase 35a N={N90} {tag}, the cluster against the plain "
                "version", outs["cluster"], out_p, rho=True)
            b = bound(k2_ops(p, 2, outs["cluster"][2]),
                      tensor_bytes(tm.T1s, tm.T2s, *args[1:6],
                                   outs["cluster"][:5]))
            print(f"phase 35a N={N90} {tag} timing: kernel on the cluster "
                  f"{times['cluster']:.3f} ms, plain {t0.elapsed_time(t1):.3f}"
                  f" ms, {counts['cluster']} launch(es), bound {b[0]:.4f} ms "
                  f"by {b[1]}", flush=True)
            row(f"condensed_adaptive (K2), OSQP-form controller, quadrotor "
                f"N={N90} (sw {sw}): {layout(c_plan)}", counts["cluster"],
                err, times["cluster"], t0.elapsed_time(t1), b, k2_src,
                k2_rep)
            del out_p
    del tm, args

    p, c = chain(20)
    tm = build_condensed_taylor(p, c)
    args = (tm, p.u_min, p.u_max, p.x_min, p.x_max, chain_x0(4096, 37), None)
    full = dict(plant=K2.AdaptivePlant(p.A, p.B, p.Q, p.R, c.Pinf,
                                       c.dPinf_drho),
                nx=20, nu=9, N=20, max_iter=150, abs_pri_tol=1e-3,
                abs_dua_tol=1e-3, en_state_bound=False, en_input_bound=True,
                relaxation_alpha=1.0, adaptive_rho_min=0.2,
                adaptive_rho_max=5.0, adaptive_rho_clipping=True,
                check_termination=1, controller="osqp",
                taylor_trust=float("inf"), warm_start=False, carry_out=False)
    f_k = functools.partial(k2, *args, **full)
    out_k, _, err, n_l, t_k, t_p = run_case(
        "phase 35b K2's OSQP-form controller, the 20-state chain (nx 20, nu "
        "9), N=20, B=4096, 150 iterations", f_k,
        functools.partial(K2.condensed_adaptive_reference, *args, **full),
        (k2, "launches"), rho=True)
    check(bool((out_k[4] != 1.0).any()), "phase 35b: no lane moved its rho")
    b = bound(k2_ops(p, 2, out_k[2]),
              tensor_bytes(tm.T1s, tm.T2s, *args[1:6], out_k[:5]))
    # the plan's layout (4 lanes a thread in passes) and the one it
    # replaced (2 lanes a thread) forced beside it: the same bits, timed in
    # turns
    plan_b = K2.adaptive_tile_plan(20, 9, 20, 2, tiles=4096 // 32, sms=sms)
    check(plan_b.lanes == 4 and plan_b.passes2 > 1, "phase 35b: the plan "
          "did not take the 4-lane layout in passes")
    f_two = forced(K2, "adaptive_tile_plan",
                   K2.shared_adaptive_plan(20, 9, 20, 2), f_k)
    same_two = same_bits(out_k, f_two())
    check(same_two, "phase 35b: the 4-lane layout differs from 2 lanes a "
          "thread")
    t_4, t_2 = paired_ms(f_k, f_two, reps=4)
    print(f"phase 35b plan: {describe_plan(plan_b)}; 2 lanes a thread "
          f"forced (the layout before it) bit-equal {same_two}; in turns "
          f"(median of 4) {t_4:.3f} ms against 2 lanes {t_2:.3f} ms "
          f"({t_2 / t_4:.3f}x)", flush=True)
    print(f"phase 35b timing: kernel {t_k:.3f} ms, plain {t_p:.3f} ms, {n_l} "
          f"launch(es), bound {b[0]:.4f} ms by {b[1]}", flush=True)
    row("condensed_adaptive (K2), OSQP-form controller on the 20-state chain "
        "(stages of 20 and 9), 4 lanes a thread in 2 + 2 passes", n_l, err,
        t_k, t_p, b, k2_src, k2_rep)

    # -- phase 11w: the adaptive pipeline's bulk pass at the quadrotor's N =
    # 40 (sw 636): K2's 4-lane layout in 2 + 2 passes ---------------------
    WALL.mark("11w")
    qw, _, tw, x0w = quad_wide_case(dev)
    args = (tw, qw.u_min, qw.u_max, qw.x_min, qw.x_max, x0w, None)
    wkw = quad_wide_kw(qw)
    plan_w = K2.adaptive_tile_plan(12, 4, 40, 2, tiles=x0w.shape[0] // 32,
                                   sms=sms)
    check(plan_w.lanes == 4 and plan_w.passes1 > 1, "phase 11w: the plan "
          "did not take the 4-lane layout in passes")
    f_k = functools.partial(k2, *args, **wkw)
    out_k, out_p, err, n_l, t_k, t_p = run_case(
        "phase 11w K2, the adaptive pipeline's bulk pass at the quadrotor's "
        "N=40 (sw 636), B=16384, 150 iterations, carry out", f_k,
        functools.partial(K2.condensed_adaptive_reference, *args, **wkw),
        (k2, "launches"), rho=True)
    f_two = forced(K2, "adaptive_tile_plan",
                   K2.shared_adaptive_plan(12, 4, 40, 2), f_k)
    same_two, same_p = same_bits(out_k, f_two()), same_bits(out_k, out_p)
    check(same_two, "phase 11w: the 4-lane layout differs from 2 lanes a "
          "thread")
    t_4, t_2 = paired_ms(f_k, f_two, reps=4)
    b = bound(k2_ops(qw, 2, out_k[2]),
              tensor_bytes(tw.T1s, tw.T2s, *args[1:6], out_k[:5],
                           tuple(out_k[5])))
    print(f"phase 11w plan: {describe_plan(plan_w)}; 2 lanes a thread "
          f"forced (the layout before it) bit-equal {same_two}, the plain "
          f"version bit-equal {same_p} (lanes that differ "
          f"{lanes_differ(out_k, out_p)}); in turns (median of 4) "
          f"{t_4:.3f} ms against 2 lanes {t_2:.3f} ms ({t_2 / t_4:.3f}x); "
          f"solved {int(out_k[3].sum())} of {x0w.shape[0]}, "
          f"{K.tile_iterations(out_k[2], plan_w.tile)} tile iterations",
          flush=True)
    print(f"phase 11w timing: kernel {t_k:.3f} ms, plain {t_p:.3f} ms, {n_l} "
          f"launch(es), bound {b[0]:.4f} ms by {b[1]}", flush=True)
    row("condensed_adaptive (K2), the adaptive pipeline's bulk pass at the "
        "quadrotor's N=40 (sw 636), 4 lanes a thread in 2 + 2 passes", n_l,
        err, t_k, t_p, b, k2_src, k2_rep)
    del out_k, out_p, tw, args

    # -- phase 4w: K1 at the quadrotor's N = 40 (sw 636) at full batch: the
    # 4-lane layout in 2 passes of 320 rows ---------------------------------
    WALL.mark("4w")
    q4, c4, m4, x04 = quad_k1_case(dev)
    kw4 = quad_k1_kw(q4)
    args = (m4, float(c4.rho), q4.u_min, q4.u_max, q4.x_min, q4.x_max, x04,
            None)
    plan4 = k1_plan(12, 4, 40)
    check(plan4.lanes == 4 and plan4.passes > 1, "phase 4w: the plan did "
          "not take the 4-lane layout in passes")
    f_k = functools.partial(k1, *args, **kw4)
    out_k, out_p, err, n_l, t_k, t_p = run_case(
        "phase 4w K1 at the quadrotor's N=40 (sw 636), B=16384, fp32, |u| "
        "<= 0.5, alpha 1.7, ct 4, 150 iterations, cold, carry out", f_k,
        functools.partial(K.condensed_fused_reference, *args, **kw4),
        (k1, "launches"))
    f_two = forced(K, "fused_tile_plan", K.shared_tile_plan(12, 4, 40), f_k)
    same_two, same_p = same_bits(out_k, f_two()), same_bits(out_k, out_p)
    check(same_two, "phase 4w: the 4-lane layout differs from 2 lanes a "
          "thread")
    t_4, t_2 = paired_ms(f_k, f_two, reps=3)
    n_own = int(out_k[2].sum())
    n_tile = K.tile_iterations(out_k[2], plan4.tile)
    b = bound(k1_ops(636, 12, out_k[2])[0],
              tensor_bytes(m4.T12, m4.T1, *args[2:7], out_k[:4],
                           tuple(out_k[4])))
    print(f"phase 4w plan: {describe_plan(plan4)}; {plan4.passes} passes of "
          f"{plan4.width} rows ({plan4.rows} padded rows, pass by pass), "
          f"{plan4.lanes} lanes x {2 * plan4.rpt // plan4.lanes} rows a "
          f"thread, T12 {'resident' if plan4.resident else 'streamed'}, "
          f"state in {'shared' if plan4.state_shared else 'global'} memory; "
          f"2 lanes a thread forced (the layout before it) bit-equal "
          f"{same_two}, the plain version bit-equal {same_p} (lanes that "
          f"differ {lanes_differ(out_k, out_p)}); in turns (median of 3) "
          f"{t_4:.3f} ms against 2 lanes {t_2:.3f} ms ({t_2 / t_4:.3f}x); "
          f"solved {int(out_k[3].sum())} of {x04.shape[0]}, {n_tile} tile "
          f"iterations against the lanes' own {n_own} "
          f"({32 * n_tile / n_own:.3f} x)", flush=True)
    print(f"phase 4w timing: kernel {t_k:.3f} ms, plain {t_p:.3f} ms, {n_l} "
          f"launch(es), bound {b[0]:.4f} ms by {b[1]} (2 sw^2 FLOP a "
          f"product over {n_own - x04.shape[0]} products, the rollouts, at "
          f"{PEAK_FP32 / 1e12:.0f} TFLOP/s)", flush=True)
    row("condensed_fused (K1), the quadrotor at N=40 (sw 636), B=16384, 150 "
        "iterations: 4 lanes a thread in 2 passes of 320 rows (phase 4w)",
        n_l, err, t_k, t_p, b, k1_src, k1_rep)
    del out_k, out_p, m4, args
    print(f"phase 35 done {time.perf_counter() - t_start:.0f} s into "
          "phases 34-37", flush=True)

    # -- phase 36: K1e, a stage of 20 entries with 10 cones -------------------
    WALL.mark("36")
    args, full, box36 = chain36_case(dev)
    m, cons = args[0], full["constraints"]
    sw = m.T12.shape[0]
    fk = functools.partial(K.condensed_fused_cuda, *args, **full)
    out_k, _, err, n_l, t_k, t_p = run_case(
        f"phase 36 K1e, the 20-state chain N=20 (sw={sw}), B=16384, 200 "
        "iterations: a state stage of 20 entries, 10 cones of dim 2 (mu "
        "0.5), 4 halfspace rows, the state box (the cones keep the lanes "
        "from converging: every lane compared)",
        fk, functools.partial(K.condensed_fused_reference, *args, **full),
        (k1, "projected_launches"), slow_plain=True)
    b = bound(k1_ops(sw, 20, out_k[2])[0],
              tensor_bytes(m.T12, m.T1, *args[2:7], out_k[:4]))
    print(f"phase 36 timing: kernel {t_k:.3f} ms, plain {t_p:.3f} ms, {n_l} "
          f"launch(es), bound {b[0]:.4f} ms by {b[1]}", flush=True)
    smem36, shared36 = K.launch_smem(K.fused_tile_plan(20, 9, 20,
                                                       state_free=False),
                                     20, 0, K.constraint_bytes(cons, 20, 9))
    check(shared36, "phase 36: the stage buffers did not fit")
    # what the projections cost: the same launch at tolerances 0 (every lane
    # runs all 200 iterations, as it does here) checking every iteration
    # and once at the end, with its constraints and with the box alone
    t36 = {}
    for ct in (1, 200):
        for tag, cc in (("", cons), (" box only", None)):
            kw36 = dict(full, check_termination=ct, abs_pri_tol=0.0,
                        abs_dua_tol=0.0, constraints=cc)
            f36 = functools.partial(K.condensed_fused_cuda, *args, **kw36)
            f36()
            t36[f"ct={ct}{tag}"] = float(np.median([event_ms(f36)
                                                    for _ in range(3)]))
    print("phase 36 split (tolerances 0): " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in t36.items())
        + f"; the projections {t36['ct=1'] - t36['ct=1 box only']:.3f} ms "
        f"at ct=1, {t36['ct=200'] - t36['ct=200 box only']:.3f} ms at "
        "ct=200", flush=True)
    # the projected launch and its box-only launch (the split's ct=1 box
    # only) on the plan's 4-lane layout in passes against 2 lanes a thread
    # forced (the layout before it): the same bits, timed in turns
    plan36 = K.fused_tile_plan(20, 9, 20, state_free=False, projected=True)
    check(plan36.lanes == 4 and plan36.passes > 1, "phase 36: the plan did "
          "not take the 4-lane layout in passes")
    two36 = K.shared_tile_plan(20, 9, 20, state_free=False)
    for tag, kw36 in (("projected", full), ("box-only", box36)):
        f4 = functools.partial(K.condensed_fused_cuda, *args, **kw36)
        f2 = forced(K, "fused_tile_plan", two36, f4)
        same = same_bits(f4(), f2())
        check(same, f"phase 36: the {tag} launch on 4 lanes differs from 2 "
              "lanes a thread")
        t_4, t_2 = paired_ms(f4, f2, reps=3)
        print(f"phase 36 {tag} launch: {describe_plan(plan36)}; 2 lanes a "
              f"thread forced bit-equal {same}; in turns (median of 3) "
              f"{t_4:.3f} ms against 2 lanes {t_2:.3f} ms "
              f"({t_2 / t_4:.3f}x)", flush=True)
    row("condensed_fused projections (K1e), a stage of 20 entries with 10 "
        "cones and 4 halfspaces (20-state chain), stage buffers in shared "
        f"memory ({smem36} bytes)", n_l, err, t_k, t_p, b, k1_src,
        "tinympc_julia_tpu/ops/pallas/condensed_kernel.py:127")
    # the same launch with the stages projected in the global scratch (the
    # layout of a stage that leaves no room in shared memory): the same bits
    with mock.patch.object(K, "launch_smem", lambda plan, *d: (plan.smem,
                                                               False)):
        k1.projected_launches = 0
        out_g = fk()
        torch.cuda.synchronize()
        n_g = k1.projected_launches
        exact = same_bits(out_g, out_k)
        fk()
        t_g = float(np.median([event_ms(fk) for _ in range(3)]))
    print(f"phase 36 the same launch with the stages in the global scratch: "
          f"bit-equal {exact}, {n_g} launch(es), {t_g:.3f} ms beside the "
          f"shared buffers' {t_k:.3f} ms", flush=True)
    check(exact and n_g >= 1, "phase 36: the global scratch differs")
    row("condensed_fused projections (K1e), the same with the stages in "
        "the global scratch (forced)", n_g, err, t_g, t_p, b, k1_src,
        "tinympc_julia_tpu/ops/pallas/condensed_kernel.py:127")
    # the same launch on a cluster of 2 blocks (forced), each projecting
    # its own whole stages in its buffers with its group's constraint data
    # in its shared memory: the same bits
    c_plan = K.cluster_tile_plan(20, 9, 20, blocks=2)
    fc = forced(K, "fused_tile_plan", c_plan, fk)
    k1.projected_launches = 0
    out_c = fc()
    torch.cuda.synchronize()
    n_c = k1.projected_launches
    exact = same_bits(out_c, out_k)
    fc()
    t_c = float(np.median([event_ms(fc) for _ in range(3)]))
    print(f"phase 36 the same launch on a cluster of 2 blocks (stage "
          f"bounds {list(c_plan.stages)}, stage buffers in shared memory "
          f"{K.launch_smem(c_plan, 20, 0)[1]}): bit-equal {exact}, "
          f"{n_c} launch(es), {t_c:.3f} ms", flush=True)
    check(exact and n_c >= 1, "phase 36: the cluster differs")
    row("condensed_fused projections (K1e), the same on a cluster of 2 "
        "blocks (forced)", n_c, err, t_c, t_p, b, k1_src,
        "tinympc_julia_tpu/ops/pallas/condensed_kernel.py:127")

    # -- phase 37: K3's wide variant and its far layout -----------------------
    WALL.mark("37")
    def k3_full(p, budget, box):
        return dict(nx=p.nx, nu=p.nu, N=p.N, max_iter=budget,
                    abs_pri_tol=1e-3, abs_dua_tol=1e-3, en_state_bound=box,
                    en_input_bound=True, check_termination=1)

    def k3_args(p, c, x0):
        return (p.A, p.B, p.f, p.Q, p.R, c.rho, c.Kinf, c.Quu_inv, c.AmBKt,
                c.Pinf, p.x_min, p.x_max, p.u_min, p.u_max, p.Xref, p.Uref,
                x0)

    def k3_describe(tag, plan, p, box, lanes):
        """The plan with its blocks and warps an SM, registers and local
        (spill) bytes a thread (the occupancy API) and the grid's lane
        slots."""
        occ = K3.stage_occupancy(plan, p.nx, p.nu, box)
        slots = min(-(-lanes // plan.tile),
                    max(occ["blocks_per_sm"], 1) * sms) * plan.tile
        print(f"phase {tag} plan: {plan}; {occ['blocks_per_sm']} blocks "
              f"({occ['warps_per_sm']} warps) an SM, {occ['registers']} "
              f"registers and {occ['local_bytes']} local (spill) bytes a "
              f"thread, {slots} lane slots", flush=True)

    def stream_floor(p, box, iters):
        """The far layout's least time: each lane-iteration's workspace
        (``lane_floats``) read once and written once at the card's memory
        rate, ms."""
        n = float(iters.double().sum())
        return (1e3 * n * 2 * 4 * K3.lane_floats(p.nx, p.nu, p.N, box)
                / PEAK_BYTES)

    def k3_case(tag, p, c, x0, budget, box):
        full = k3_full(p, budget, box)
        args = k3_args(p, c, x0)
        plan = K3.launch_plan(p.nx, p.nu, p.N, box, x0.shape[0], dev)
        out_k, _, err, n_l, t_k, t_p = run_case(
            f"phase {tag}, B={x0.shape[0]}, {budget} iterations: lane group "
            f"{plan.group}, tile {plan.tile}, matrices in "
            f"{'registers' if plan.registers else 'shared memory'}, "
            f"workspace in "
            f"{'global' if plan.workspace_global else 'shared'} memory, "
            f"{plan.smem} bytes of shared memory",
            functools.partial(k3, *args, **full),
            functools.partial(K3.fused_reference, *args, **full),
            (k3, "launches"), slow_plain=True)
        nx, nu = p.nx, p.nu
        b = bound((p.N - 1) * (4 * nx * nx + 8 * nx * nu + 2 * nu * nu)
                  * float(out_k[2].double().sum()),
                  tensor_bytes(*args, out_k))
        k3_describe(tag[:3], plan, p, box, x0.shape[0])
        floor = stream_floor(p, box, out_k[2]) if plan.workspace_global \
            else None
        print(f"phase {tag[:3]} timing: kernel {t_k:.3f} ms, plain "
              f"{t_p:.3f} ms, {n_l} launch(es), bound {b[0]:.4f} ms by "
              f"{b[1]}"
              + (f", workspace stream floor {floor:.4f} ms"
                 if floor is not None else ""), flush=True)
        return n_l, err, t_k, t_p, b, plan, floor

    p, c = chain(20)
    n_l, err, t_k, t_p, b, plan, _ = k3_case(
        "37a K3 wide variant, the 20-state chain N=20", p, c,
        chain_x0(16384, 39), 200, False)
    check(not plan.registers and plan.group == 8,
          "phase 37a: the plan did not take the wide variant")
    row(f"fused_stage (K3), wide variant (lane group {plan.group}), "
        "20-state chain N=20", n_l, err, t_k, t_p, b, k3_src, k3_rep)
    for box in (False, True):
        p, c = quad(300, x_bound=2.0 if box else None)
        n_l, err, t_k, t_p, b, plan, floor = k3_case(
            f"37b K3 far layout, quadrotor N=300"
            f"{', |x| <= 2' if box else ''}", p, c, uniform(16384, 12, 40, 0.3),
            100, box)
        check(plan.workspace_global and plan.ring >= K3.MIN_RING,
              "phase 37b: the plan did not take the far layout")
        row(f"fused_stage (K3), workspace in global memory (far layout, "
            f"ring of {plan.ring}), quadrotor N=300"
            f"{' with the state box' if box else ''}", n_l, err, t_k, t_p, b,
            k3_src, k3_rep, stream_floor_ms=floor)
    # the far layout against the near one where both run: the widest
    # quadrotor horizon whose workspace fits a warp of lanes with |x| <= 2
    # (N = 173), the far plan forced; the same bits, each timed alone
    p, c = quad(173, x_bound=2.0)
    x0 = uniform(16384, 12, 41, 0.3)
    args, full = k3_args(p, c, x0), k3_full(p, 100, True)
    near_plan = K3.launch_plan(12, 4, 173, True, 16384, dev)
    check(not near_plan.workspace_global, "phase 37b: N = 173 is not near")
    far_plan = K3.launch_plan(12, 4, 173, True, 16384, dev, far=True)
    k3_describe("37b N=173 near", near_plan, p, True, 16384)
    k3_describe("37b N=173 far (forced)", far_plan, p, True, 16384)
    f_near = functools.partial(k3, *args, **full)
    f_far = forced(K3, "fused_stage_plan", far_plan, f_near)
    near, far = f_near(), f_far()
    torch.cuda.synchronize()
    exact = same_bits(near, far)
    t_near = float(np.median([event_ms(f_near) for _ in range(3)]))
    t_far = float(np.median([event_ms(f_far) for _ in range(3)]))
    print(f"phase 37b far layout forced at N=173, |x| <= 2, B=16384: "
          f"bit-equal to the near layout {exact}; near {t_near:.3f} ms, far "
          f"{t_far:.3f} ms (stream floor "
          f"{stream_floor(p, True, near[2]):.4f} ms); solved "
          f"{int(near[3].sum())}, largest |x| "
          f"{float(near[0].abs().max()):.6g}", flush=True)
    check(exact, "phase 37b: the far layout differs from the near one")
    print(f"phases 34-37 took {time.perf_counter() - t_start:.0f} s", flush=True)
    return rows


def build_kernels():
    """Phase 2: the three kernels' sources side by side (one nvcc each, two
    for K2's translation units)."""
    from tinympc_julia_tpu_torch.ops.cuda._build import (kernel_label,
                                                         load_libraries,
                                                         ptxas_usage)
    from tinympc_julia_tpu_torch.ops.cuda.fused import variant_label
    t0 = time.perf_counter()
    libs = load_libraries(["condensed_fused", "condensed_adaptive",
                           "fused_stage"])
    print(f"phase 2 build: {len(libs)} kernels side by side in "
          f"{time.perf_counter() - t0:.1f} s with loading", flush=True)
    for built in libs:
        usage = ptxas_usage(built.log)
        regs = sorted({use.registers for use in usage.values()})
        spills = [fn for fn, use in usage.items()
                  if use.spill_stores or use.spill_loads]
        print(f"phase 2 build: {built.path.name} in {built.seconds:.1f} s "
              f"of nvcc; registers per thread over its variants {regs}, "
              f"variants that spill {len(spills)} {spills}", flush=True)
        k3 = built.path.name.startswith("fused_stage")
        for mangled, use in sorted(usage.items()):
            what = (f"K3 variant {variant_label(mangled)}" if k3
                    else kernel_label(mangled))
            print(f"phase 2 build: {what}: {use.registers} registers, "
                  f"{use.spill_stores} / {use.spill_loads} bytes spill "
                  f"stores / loads, {use.stack_bytes} bytes stack",
                  flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA GPU")
    # a caller's setting that the port must not follow: every fp32 path
    # pins full fp32 matmuls itself (utils/precision.py)
    torch.backends.cuda.matmul.allow_tf32 = True
    card = smi()
    print(f"phase 1 env: torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} device(s), "
          f"card {card}", flush=True)
    t_start = time.perf_counter()
    WALL.mark("2")
    build_kernels()
    rows = earlier_phases(card)
    print(f"phases 2-12 done {time.perf_counter() - t_start:.0f} s after "
          "the start", flush=True)
    rows += grouped_phases(card)
    print(f"phases 13-17 done {time.perf_counter() - t_start:.0f} s after "
          "the start", flush=True)
    rows += stage_and_loop_phases(card)
    print(f"phases 18-21 done {time.perf_counter() - t_start:.0f} s after "
          "the start", flush=True)
    rows += rebuild_and_horizon_phases(card)
    print(f"phases 22-25 done {time.perf_counter() - t_start:.0f} s after "
          "the start", flush=True)
    persistence_phases(card)
    print(f"phases 26-30 done {time.perf_counter() - t_start:.0f} s after "
          "the start", flush=True)
    sharded_and_example_phases(card)
    print(f"phases 31-33 done {time.perf_counter() - t_start:.0f} s after "
          "the start", flush=True)
    rows += lifted_shape_phases(card)
    WALL.mark()
    print(f"all phases done {time.perf_counter() - t_start:.0f} s after the "
          "start", flush=True)
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
