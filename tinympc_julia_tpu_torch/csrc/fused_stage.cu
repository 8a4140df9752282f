// Per-stage (uncondensed) box-constrained ADMM: the whole fresh solve of a
// tile of lanes in one kernel launch (kernel K3 of the port).
//
// Replaces: tinympc_julia_tpu/ops/pallas/fused.py, make_fused_solver (the
//   pl.pallas_call kernel): per iteration the forward rollout
//   u_k = -K x_k - d_k, x_{k+1} = A x_k + B u_k + f, the box slacks, the dual
//   ascent, the linear cost, the four max-abs residuals, the per-lane latch,
//   and the backward recursion d_k = Quu (B' p_{k+1} + r_k),
//   p_k = q_k + AmBKt p_{k+1} - K' r_k.
//
// Per lane and iteration that is (N-1)(4 nx^2 + 8 nx nu + 2 nu^2) FLOPs
// (1,862 at the cartpole, 18,848 at the quadrotor) on matrices of a few
// hundred floats, and device memory is touched only for the inputs and the
// results (but in the far layout, below).  What bounds the kernel is not
// bytes but the chain of small dependent matvecs (two recursions over the
// horizon) of the slowest lanes: a lane that never passes runs every
// iteration, and its warp with it.
//
// What this design does about it:
//  * A lane group of G threads (a template parameter: 1, 2, 4, 8 or 16)
//    serves one lane.  State row j belongs to thread j % G, input row a to
//    thread (a + nx) % G (so at G = 8, 16 the input rows fill the threads the
//    state rows leave idle).  Each thread computes its rows of every small
//    matvec, each output row summed in index order with fmaf on one thread,
//    and the group exchanges a stage vector with width-G shuffles under the
//    group's own mask.  A warp holds 32 / G lanes, so a lane that never
//    passes holds back fewer lanes, and its iteration is about G times
//    shorter in issue slots.
//  * The group meets its four residual maxima by xor shuffles (a max is exact
//    in any order), so all G threads latch, and leave the loop, together.
//    A lane beyond the batch leaves as a whole group before the loop.
//  * What lives across iterations (the slacks v, z, also the outputs; the
//    duals y and, under a state bound, g; the feedforward d) stays in shared
//    memory as [row][lane], each row touched only by the thread that owns it,
//    the lane stride padded so that a warp's accesses fall on 32 banks.
//    Without a state bound g stays 0 and v = x exactly, so g is dropped.
//  * The constants come straight from the caller's tensors: each block builds
//    the per-stage terms in its shared memory (qref = -(Xref*Qd), rref =
//    -(Uref*Rd), the bounds) and each thread keeps its rows of f and pNref =
//    -(Pinf' Xref[N-1]) (index order) in registers; rho is read through its
//    pointer when the caller holds it on the card.  A solve is one launch,
//    and the results are written as (B, N, nx) and (B, N-1, nu), a group's
//    threads on neighbouring floats.
//  * In the variants of a fixed shape (nx, nu template parameters) each
//    thread holds its rows of K, A, B, B', Quu, AmBKt, K' in registers, so no
//    matrix load stands in the chain; the generic variant (any nx, nu up to
//    kGenericDim, rows predicated) reads them from shared memory, rows padded
//    to an odd stride so that a warp's threads read different banks, through
//    a pointer that does not alias the lanes' workspace.
//  * Wider plants (nx or nu beyond kGenericDim) take the wide variant
//    (fused_stage_wide_kernel): lane groups of 8, 16 or 32 threads whose
//    stage vectors live in the group's rows of shared memory instead of
//    every thread's registers, so a thread's rows cost no registers; the
//    matrices in shared memory where they fit, else read from the caller's
//    tensors.
//  * A long horizon: where a warp of lanes' workspace does not fit in
//    shared memory, the far layout (kFar) keeps it in global memory as one
//    record a lane and stage (v, g, z, y, d, record_floats), laid out
//    [warp slot][stage][lane of the warp][record]: one stage of a warp's
//    lanes is one contiguous slab (768 bytes at the quadrotor, 1,152 with
//    a state box), and a warp's whole workspace one run of memory.  Each
//    lane group streams the records of its sweep (the rollout over stages
//    0 .. N-1, the recursion back) through a ring of D of them in shared
//    memory, D - 1 in flight ahead of the dependent chain, and stores its
//    results straight from registers (plain stores, which nothing waits
//    on).  What bounds it then is that stream: a lane-iteration reads its
//    records twice and writes them once, against a floor of lane_floats
//    read once and written once at 3.35 TB/s (12.3 ms free and 27.5 ms
//    with |x| <= 2 at the quadrotor's N = 300 with 16,384 lanes and 100
//    iterations).  The records come in 16-byte cp.async pieces, issued by
//    the group's own threads: they stay in the generic proxy, so the plain
//    stores they read back need no proxy fence, and one bulk copy a record
//    on an mbarrier measured 1.1-1.7x slower (PERF.md).  The per-stage
//    terms stay in shared memory, and go to global memory where they do
//    not fit (the wrapper computes them into a buffer in the kernel's
//    layout).  A layout that spread a warp's rows over the grid's lane
//    slots, one row apart by the whole grid, took 18-21 us a stage step
//    under load against 0.56-0.74 us for this one.
//  * Elementwise arithmetic uses round-to-nearest intrinsics in the plain
//    PyTorch version's order of operations, so nothing is contracted into
//    FMAs behind its back.
//
// Launch contract: blockDim.x = tile * G threads, tile and G chosen by the
// Python wrapper (fused_stage_plan), the ragged last tile masked here; the
// wrapper owns the dynamic shared-memory size, and the entry point refuses a
// layout the kernel would overrun (same layout functions as the kernel).
#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <cstddef>

#include "ptx.cuh"

namespace {

constexpr int kGenericDim = 16;  // widest nx, nu of the generic variant

__host__ __device__ constexpr int odd_stride(int n) { return n | 1; }

// Floats of a block's per-stage terms: qref, rref, u_min, u_max and, under a
// state bound, x_min, x_max.
__host__ __device__ inline int stage_floats(int nx, int nu, int N,
                                            bool state_box) {
  const int sx = N * nx, su = (N - 1) * nu;
  return sx + 3 * su + (state_box ? 2 * sx : 0);
}

// Floats of the matrices in shared memory (generic variant): A, AmBKt (nx x
// nx), B, K' (nx x nu), K, B' (nu x nx), Quu (nu x nu), rows padded to an odd
// stride.
__host__ __device__ inline int matrix_floats(int nx, int nu) {
  const int lx = odd_stride(nx), lu = odd_stride(nu);
  return nx * (2 * lx + 2 * lu) + nu * (2 * lx + lu);
}

// What a lane keeps across iterations: v, z, y, d (and g under a state box).
__host__ __device__ inline int lane_floats(int nx, int nu, int N,
                                           bool state_box) {
  return (state_box ? 2 : 1) * N * nx + 3 * (N - 1) * nu;
}

// Floats of a wide-variant lane's stage vectors in shared memory: x_k, A x_k
// (or AmBKt p_{k+1}) and p_{k+1} (nx each), u_k, s_k and r_k (nu each).
__host__ __device__ inline int vec_floats(int nx, int nu) {
  return 3 * nx + 3 * nu;
}

// The workspace's lane stride: the tile rounded up to be = 32 / G (mod 32),
// so that the G threads of the 32 / G lanes of a warp, each on its own row,
// fall on 32 different banks.
__host__ __device__ inline int lane_stride(int tile, int group) {
  const int lanes_per_warp = 32 / group;
  return tile + ((lanes_per_warp - tile) % 32 + 32) % 32;
}

// The far layout's record of one lane and stage: v, g (under a state box),
// z, y, d, padded to whole 16-byte pieces.
__host__ __device__ inline int record_floats(int nx, int nu, bool state_box) {
  return ((state_box ? 2 : 1) * nx + 3 * nu + 3) / 4 * 4;
}

// The far layout's ring of a lane group in shared memory: ``depth`` records,
// its stride an odd multiple of max(G, 4) floats (any multiple of 4 at G =
// 32), so that the rings of a warp's groups start on banks as far apart as
// 16-byte alignment allows.
__host__ __device__ inline int ring_stride(int nx, int nu, bool state_box,
                                           int depth, int group) {
  const int n = depth * record_floats(nx, nu, state_box);
  if (group >= 32 || n == 0) return n;
  const int q = group < 4 ? 4 : group;
  const int r = (n + q - 1) / q * q;
  return (r / q) % 2 ? r : r + q;
}

// The far layout's deepest ring, in records (all but one in flight).
constexpr int kMaxRing = 8;

// Waits until at most ``n`` of this thread's cp.async groups are pending.
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: tinympc::cp_async_wait<0>(); break;
    case 1: tinympc::cp_async_wait<1>(); break;
    case 2: tinympc::cp_async_wait<2>(); break;
    case 3: tinympc::cp_async_wait<3>(); break;
    case 4: tinympc::cp_async_wait<4>(); break;
    case 5: tinympc::cp_async_wait<5>(); break;
    default: tinympc::cp_async_wait<6>(); break;
  }
}

// The far layout's stream of one lane group's records.  A sweep (the
// rollout over stages 0 .. N-1, the recursion over N-1 .. 0) runs them
// through the group's ring of D slots: step i's record lies in slot i % D,
// and steps i + 1 .. i + D - 1 are in flight while it computes.  The
// group's threads copy a record in 16-byte cp.async pieces.  The stage's
// results go from registers straight to the record (plain stores, which
// nothing waits on), so a slot is free once its step has read it.  A sweep
// starts after the group's __syncwarp, so it reads what the sweep before
// it wrote.
template <int kG>
struct RecordStream {
  static constexpr int kW = 32 / kG;  // lanes a warp
  float* ring;  // the group's D slots of FP floats in shared memory
  float* rec0;  // the lane slot's record of stage 0 in global memory
  int FP, D, N, t;
  unsigned mask;
  int cur = 0;  // the ring slot of the sweep's step

  // the records of lane slot ``slot`` in ``wsg``: [warp slot][stage][lane
  // of the warp][record]
  __device__ RecordStream(float* ring_, float* wsg, int slot, int FP_,
                          int D_, int N_, int t_, unsigned mask_)
      : ring(ring_),
        rec0(wsg ? wsg + (static_cast<size_t>(slot / kW) * N_ * kW +
                          slot % kW) * FP_
                 : nullptr),
        FP(FP_), D(D_), N(N_), t(t_), mask(mask_) {}

  __device__ float* record(int k) const {
    return rec0 + static_cast<size_t>(k) * kW * FP;
  }
  __device__ void fill(int i, int into, bool fwd) {
    if (i < N) {
      const float* src = record(fwd ? i : N - 1 - i);
      float* dst = ring + into * FP;
      for (int c = t; c < FP / 4; c += kG)
        tinympc::cp_async16(dst + 4 * c, src + 4 * c);
    }
    tinympc::cp_async_commit();
  }
  __device__ void begin(bool fwd) {
    __syncwarp(mask);
    for (int i = 0; i < D - 1; ++i) fill(i, i, fwd);
    cur = 0;
  }
  // waits for step i's record, puts step i + D - 1's in flight and returns
  // step i's slot
  __device__ float* step(int i, bool fwd) {
    cp_async_wait_n(D - 2);
    __syncwarp(mask);
    fill(i + D - 1, cur == 0 ? D - 1 : cur - 1, fwd);
    float* const slot = ring + cur * FP;
    cur = cur + 1 == D ? 0 : cur + 1;
    return slot;
  }
};

struct Params {
  const float *A, *B, *f, *Qd, *Rd, *rho_ptr, *K, *Quu, *AmBKt, *Pinf;
  const float *xmin, *xmax, *umin, *umax, *Xref, *Uref, *x0;
  float rho_val;    // rho when rho_ptr is null
  float* xout;      // (B, N, nx): the state slacks v
  float* uout;      // (B, N-1, nu): the input slacks z
  int* iters;       // (B,)
  int* solved;      // (B,)
  float* wsg;       // far layout: the workspace, the grid's lane slots' records
  const float* stg;  // the per-stage terms in global memory (stage_global)
  int nx, nu, N, batch, max_iter, ct, en_input_bound;
  int ring;  // far layout: records a lane group's ring holds
  int stage_global, mats_global;  // per-stage terms / matrices (wide
                                  // variant) in global memory
  float pri_tol, dua_tol;
  int slot;  // the launch's lane queue
};

// Lane queues (next ticket, blocks done), each left at zero by the launch
// that used it; a launch takes the next slot, so launches on other streams
// running at the same time use other queues.
constexpr int kQueueSlots = 64;
__device__ unsigned g_lane_queue[kQueueSlots][2];

// Element e of a stage vector lives in slot e / G of group thread
// (e + off) % G; every thread of the group gets all n of them.
template <int kG, int kR, int kC>
__device__ __forceinline__ void gather(unsigned mask, const float (&own)[kR],
                                       float (&full)[kC], int n, int off) {
#pragma unroll
  for (int e = 0; e < kC; ++e) {
    if (e < n) {
      if constexpr (kG == 1) {
        full[e] = own[e];
      } else {
        full[e] = __shfl_sync(mask, own[e / kG], (e + off) % kG, kG);
      }
    } else {
      full[e] = 0.0f;
    }
  }
}

template <int kG>
__device__ __forceinline__ float group_max(unsigned mask, float v) {
#pragma unroll
  for (int o = kG / 2; o > 0; o /= 2)
    v = fmaxf(v, __shfl_xor_sync(mask, v, o, kG));
  return v;
}

// sum_i coef(i) * x[i] for i < n, in index order on one accumulator.
template <int kC, class Coef>
__device__ __forceinline__ float dot(Coef coef, const float (&x)[kC], int n) {
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < kC; ++i)
    if (i < n) acc = fmaf(coef(i), x[i], acc);
  return acc;
}

// A thread's rows of the matrices, in the variants that keep them in
// registers: kRx state rows (of A, AmBKt, B, K'), kRu input rows (of K, B',
// Quu).
template <int kRx, int kRu, int kCx, int kCu>
struct RowRegs {
  float A[kRx][kCx], Am[kRx][kCx], B[kRx][kCu], Kt[kRx][kCu];
  float K[kRu][kCx], Bt[kRu][kCx], Q[kRu][kCu];
};

// kNx, kNu: the plant's widths, or 0 for the generic variant (any nx, nu up
// to kGenericDim, read from the parameters).  kG: threads a lane.  kRegs:
// the matrices' rows in registers (fixed shapes) or shared memory.
// kStateFree: no state bound, so the state dual is 0 and the state slack
// equals the rollout.  kFar: the workspace in global memory (and the
// per-stage terms where stage_global).
template <int kNx, int kNu, int kG, bool kRegs, bool kStateFree, bool kFar>
__global__ void fused_stage_kernel(const Params p) {
  static_assert(kG == 1 || kG == 2 || kG == 4 || kG == 8 || kG == 16,
                "a lane group is a power of two up to 16 threads");
  static_assert(kNx > 0 || !kRegs, "the generic variant reads shared memory");
  extern __shared__ __align__(16) float smem[];
  constexpr int kCx = kNx > 0 ? kNx : kGenericDim;  // register capacities
  constexpr int kCu = kNu > 0 ? kNu : kGenericDim;
  constexpr int kRx = (kCx + kG - 1) / kG;      // rows a thread owns, at most
  constexpr int kRu = (kCu + kG - 1) / kG;
  const int nx = kNx > 0 ? kNx : p.nx;
  const int nu = kNu > 0 ? kNu : p.nu;
  const int N = p.N, B = p.batch;
  const int sx = N * nx, su = (N - 1) * nu;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int tile = nthreads / kG;
  const int lb = tid / kG, t = tid % kG;  // lane in the block, rank in group
  const int slot = blockIdx.x * tile + lb;  // the group's lane slot
  int lane = slot;  // the group's lane; see the queue below
  const unsigned mask = ((1u << kG) - 1u) << ((tid & 31) & ~(kG - 1));
  // the near layout's workspace row stride: a padded tile
  const int LS = lane_stride(tile, kG);
  // the far layout's ring of each lane group leads the shared memory
  const int RS = kFar ? ring_stride(nx, nu, !kStateFree, p.ring, kG) : 0;
  float* const ring = smem + lb * RS;
  float* const sbase = smem + tile * RS;

  // -- prologue: the block's per-stage terms (and the generic variant's
  // matrices) from the caller's tensors, or the wrapper's per-stage terms
  // in global memory
  const bool stage_far = kFar && p.stage_global;
  float* const qref = stage_far ? const_cast<float*>(p.stg) : sbase;
  float* const rref = qref + sx;
  float* const umin = rref + su;
  float* const umax = umin + su;
  float* const xmin = umax + su;
  float* const xmax = xmin + (kStateFree ? 0 : sx);
  float* const mats = stage_far ? sbase : xmax + (kStateFree ? 0 : sx);
  float* const ws = mats + (kRegs ? 0 : matrix_floats(nx, nu));
  const int lx = odd_stride(nx), lu = odd_stride(nu);
  float* const wA = mats;          // [nx][lx]
  float* const wAm = wA + nx * lx;  // [nx][lx]
  float* const wB = wAm + nx * lx;  // [nx][lu]
  float* const wKt = wB + nx * lu;  // [nx][lu]
  float* const wK = wKt + nx * lu;  // [nu][lx]
  float* const wBt = wK + nu * lx;  // [nu][lx]
  float* const wQ = wBt + nu * lx;  // [nu][lu]
  if (!stage_far) {
    for (int e = tid; e < sx; e += nthreads) {
      qref[e] = -__fmul_rn(p.Xref[e], p.Qd[e % nx]);
      if (!kStateFree) {
        xmin[e] = p.xmin[e];
        xmax[e] = p.xmax[e];
      }
    }
    for (int e = tid; e < su; e += nthreads) {
      rref[e] = -__fmul_rn(p.Uref[e], p.Rd[e % nu]);
      umin[e] = p.umin[e];
      umax[e] = p.umax[e];
    }
  }
  if constexpr (!kRegs) {
    for (int e = tid; e < nx * nx; e += nthreads) {
      wA[(e / nx) * lx + e % nx] = p.A[e];
      wAm[(e / nx) * lx + e % nx] = p.AmBKt[e];
    }
    for (int e = tid; e < nx * nu; e += nthreads) {
      wB[(e / nu) * lu + e % nu] = p.B[e];    // B[j][a]
      wBt[(e % nu) * lx + e / nu] = p.B[e];   // B'[a][j]
      wK[(e / nx) * lx + e % nx] = p.K[e];    // K[a][i]
      wKt[(e % nx) * lu + e / nx] = p.K[e];   // K'[i][a]
    }
    for (int e = tid; e < nu * nu; e += nthreads)
      wQ[(e / nu) * lu + e % nu] = p.Quu[e];
  }
  __syncthreads();
  // read-only views of the matrices for the loop, which the compiler may
  // schedule apart from the workspace's stores
  const float* __restrict__ const sA = wA;
  const float* __restrict__ const sAm = wAm;
  const float* __restrict__ const sB = wB;
  const float* __restrict__ const sKt = wKt;
  const float* __restrict__ const sK = wK;
  const float* __restrict__ const sBt = wBt;
  const float* __restrict__ const sQ = wQ;

  const float rho = p.rho_ptr != nullptr ? *p.rho_ptr : p.rho_val;
  const int a0 = (t - nx % kG + kG) % kG;  // this thread's first input row
  auto xrow = [&](int s) { return s * kG + t; };
  auto urow = [&](int s) { return a0 + s * kG; };

  RowRegs<kRegs ? kRx : 1, kRegs ? kRu : 1, kRegs ? kCx : 1, kRegs ? kCu : 1>
      R;
  if constexpr (kRegs) {
#pragma unroll
    for (int s = 0; s < kRx; ++s) {
      const int j = xrow(s);
      const bool own = j < nx;
#pragma unroll
      for (int i = 0; i < kCx; ++i) {
        R.A[s][i] = own ? p.A[j * nx + i] : 0.0f;
        R.Am[s][i] = own ? p.AmBKt[j * nx + i] : 0.0f;
      }
#pragma unroll
      for (int a = 0; a < kCu; ++a) {
        R.B[s][a] = own ? p.B[j * nu + a] : 0.0f;
        R.Kt[s][a] = own ? p.K[a * nx + j] : 0.0f;
      }
    }
#pragma unroll
    for (int s = 0; s < kRu; ++s) {
      const int a = urow(s);
      const bool own = a < nu;
#pragma unroll
      for (int i = 0; i < kCx; ++i) {
        R.K[s][i] = own ? p.K[a * nx + i] : 0.0f;
        R.Bt[s][i] = own ? p.B[i * nu + a] : 0.0f;
      }
#pragma unroll
      for (int b = 0; b < kCu; ++b) R.Q[s][b] = own ? p.Quu[a * nu + b] : 0.0f;
    }
  }

  // this thread's rows of f and pNref
  float fo[kRx], pNo[kRx];
#pragma unroll
  for (int s = 0; s < kRx; ++s) {
    const int j = xrow(s);
    fo[s] = pNo[s] = 0.0f;
    if (j < nx) {
      fo[s] = p.f[j];
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < kCx; ++i)
        if (i < nx) acc = fmaf(p.Pinf[i * nx + j], p.Xref[(N - 1) * nx + i],
                               acc);
      pNo[s] = -acc;
    }
  }

  // This group's workspace.  Near: row r of an array at [r * LS] of the
  // lane's column in shared memory, read and written in place.  Far: the
  // lane's records in global memory, [warp slot][stage][lane of the warp]
  // [v, g, z, y, d], read through the group's ring (v .. d point into the
  // ring slot of the stage) and written straight to the record (vw .. dw).
  const int xr = (kStateFree ? 1 : 2) * nx;  // a record's state rows
  float* __restrict__ v = kFar ? ring : ws + lb;
  float* __restrict__ g = v + (kFar ? nx : sx * LS);  // unused when kStateFree
  float* __restrict__ z = v + (kFar ? xr : (kStateFree ? 1 : 2) * sx * LS);
  float* __restrict__ y = z + (kFar ? nu : su * LS);
  float* __restrict__ d = y + (kFar ? nu : su * LS);
  float *vw = nullptr, *gw = nullptr, *zw = nullptr, *yw = nullptr,
        *dw = nullptr;
  RecordStream<kG> rs(ring, p.wsg, slot, record_floats(nx, nu, !kStateFree),
                      p.ring, N, t, mask);
  // a far sweep's step i: v .. d at its slot, vw .. dw at its record
  auto sweep_step = [&](int i, bool fwd) {
    v = rs.step(i, fwd);
    g = v + nx;
    z = v + xr;
    y = z + nu;
    d = y + nu;
    vw = rs.record(fwd ? i : N - 1 - i);
    gw = vw + nx;
    zw = vw + xr;
    yw = zw + nu;
    dw = yw + nu;
  };
  // a result's store: in place (near) or to the record (far)
#define K3_PUT(A, r, val) (kFar ? A##w : A)[r] = (val)

  // a fresh solve of ``lane``: its x0 (this thread's rows, and all of it),
  // the workspace zeroed
  float x0o[kRx], x0f[kCx];
  auto start_lane = [&]() {
    const float* x0 = p.x0 + static_cast<size_t>(lane) * nx;
#pragma unroll
    for (int i = 0; i < kCx; ++i) x0f[i] = i < nx ? x0[i] : 0.0f;
#pragma unroll
    for (int s = 0; s < kRx; ++s) x0o[s] = xrow(s) < nx ? x0[xrow(s)] : 0.0f;
    for (int k = 0; k < N; ++k) {
      float* const rk = kFar ? rs.record(k) : nullptr;
#pragma unroll
      for (int s = 0; s < kRx; ++s) {
        const int j = xrow(s);
        if (j < nx) {
          if constexpr (kFar) {
            rk[j] = 0.0f;
            if (!kStateFree) rk[nx + j] = 0.0f;
          } else {
            v[(k * nx + j) * LS] = 0.0f;
            if (!kStateFree) g[(k * nx + j) * LS] = 0.0f;
          }
        }
      }
      if (k == N - 1) break;
#pragma unroll
      for (int s = 0; s < kRu; ++s) {
        const int a = urow(s);
        if (a < nu) {
          if constexpr (kFar) {
            rk[xr + a] = 0.0f;
            rk[xr + nu + a] = 0.0f;
            rk[xr + 2 * nu + a] = 0.0f;
          } else {
            z[(k * nu + a) * LS] = 0.0f;
            y[(k * nu + a) * LS] = 0.0f;
            d[(k * nu + a) * LS] = 0.0f;
          }
        }
      }
    }
  };

  // the results of ``lane``: a latched lane's slacks froze on its
  // converging iteration, a lane that never passed reports its last ones.
  // Row-major (B, N, nx) / (B, N-1, nu): a group's threads write
  // neighbouring floats.
  auto finish_lane = [&](int n_iter, int ok) {
    float* const xl = p.xout + static_cast<size_t>(lane) * sx;
    float* const ul = p.uout + static_cast<size_t>(lane) * su;
    for (int k = 0; k < N; ++k) {
      const float* const rk = kFar ? rs.record(k) : nullptr;
#pragma unroll
      for (int s = 0; s < kRx; ++s) {
        const int j = xrow(s);
        if (j < nx)
          xl[k * nx + j] = kFar ? rk[j] : v[(k * nx + j) * LS];
      }
      if (k == N - 1) break;
#pragma unroll
      for (int s = 0; s < kRu; ++s) {
        const int a = urow(s);
        if (a < nu)
          ul[k * nu + a] = kFar ? rk[xr + a] : z[(k * nu + a) * LS];
      }
    }
    if (t == 0) {
      p.iters[lane] = n_iter;
      p.solved[lane] = ok;
    }
  };

  // The lane queue: the grid's P = gridDim.x * tile groups start on lanes
  // 0 .. P-1 by position; a group whose lane is done takes lane P + its
  // ticket, until none is left.  So no SM idles behind a block that holds
  // a lane which never passes while lanes remain.
  unsigned* const queue = g_lane_queue[p.slot];
  const int P = gridDim.x * tile;
  auto next_lane = [&]() {
    int nxt = 0;
    if (t == 0) nxt = P + static_cast<int>(atomicAdd(queue, 1u));
    if constexpr (kG > 1) nxt = __shfl_sync(mask, nxt, 0, kG);
    lane = nxt;
    if (lane < B) start_lane();
  };
  if (lane < B) start_lane();
  while (lane < B && p.max_iter == 0) {
    finish_lane(0, 0);
    next_lane();
  }

  // the coefficient of row (s, j) or (s, a), column i, of each matrix
#define K3_COEF(REG, SM, LD, s, row) \
  [&](int i) -> float {              \
    if constexpr (kRegs) {           \
      return R.REG[s][i];            \
    } else {                         \
      return SM[(row) * (LD) + i];   \
    }                                \
  }

  // One ADMM iteration of each group's lane a turn: every group runs the
  // same code on its own lane, so a warp's groups stay converged.
  int i = 0;
  while (lane < B) {
    float ps = 0.0f, pi = 0.0f, ds = 0.0f, di = 0.0f;
    float xo[kRx], xf[kCx];
#pragma unroll
    for (int s = 0; s < kRx; ++s) xo[s] = x0o[s];
#pragma unroll
    for (int e = 0; e < kCx; ++e) xf[e] = x0f[e];

    // Forward rollout; the slack, dual and residual updates of a stage run
    // as soon as its x_k (and u_k) exist.
    if constexpr (kFar) rs.begin(true);
    for (int k = 0; k < N; ++k) {
      if constexpr (kFar) sweep_step(k, true);
      // state side of stage k: vn = clip(x + g), g += x - vn (kStateFree:
      // no bound, vn = x)
#pragma unroll
      for (int s = 0; s < kRx; ++s) {
        const int j = xrow(s);
        if (j < nx) {
          const int r = kFar ? j : (k * nx + j) * LS;
          float vn = xo[s];
          if (!kStateFree) {
            const float gj = g[r];
            vn = __fadd_rn(xo[s], gj);
            vn = fminf(xmax[k * nx + j], fmaxf(xmin[k * nx + j], vn));
            K3_PUT(g, r, __fsub_rn(__fadd_rn(gj, xo[s]), vn));
            ps = fmaxf(ps, fabsf(__fsub_rn(xo[s], vn)));
          }
          ds = fmaxf(ds, fabsf(__fsub_rn(v[r], vn)));
          K3_PUT(v, r, vn);
        }
      }
      if (k == N - 1) break;

      // A x_k first: it does not wait for u_k
      float ax[kRx];
#pragma unroll
      for (int s = 0; s < kRx; ++s)
        ax[s] = xrow(s) < nx ? dot(K3_COEF(A, sA, lx, s, xrow(s)), xf, nx)
                             : 0.0f;

      // u_k = -K x_k - d_k; input side: zn = clip(u + y), y += u - zn
      float uo[kRu], uf[kCu];
#pragma unroll
      for (int s = 0; s < kRu; ++s) {
        const int a = urow(s);
        uo[s] = 0.0f;
        if (a < nu) {
          const int r = kFar ? a : (k * nu + a) * LS;
          const float tk = dot(K3_COEF(K, sK, lx, s, a), xf, nx);
          uo[s] = __fsub_rn(-tk, d[r]);
          const float ya = y[r];
          float zn = __fadd_rn(uo[s], ya);
          if (p.en_input_bound)
            zn = fminf(umax[k * nu + a], fmaxf(umin[k * nu + a], zn));
          K3_PUT(y, r, __fsub_rn(__fadd_rn(ya, uo[s]), zn));
          pi = fmaxf(pi, fabsf(__fsub_rn(uo[s], zn)));
          di = fmaxf(di, fabsf(__fsub_rn(z[r], zn)));
          K3_PUT(z, r, zn);
        }
      }
      gather<kG>(mask, uo, uf, nu, nx);

      // x_{k+1} = A x_k + B u_k + f
#pragma unroll
      for (int s = 0; s < kRx; ++s) {
        xo[s] = 0.0f;
        if (xrow(s) < nx) {
          const float bu = dot(K3_COEF(B, sB, lu, s, xrow(s)), uf, nu);
          xo[s] = __fadd_rn(__fadd_rn(ax[s], bu), fo[s]);
        }
      }
      gather<kG>(mask, xo, xf, nx, 0);
    }

    // termination: the dual residuals against the previous slacks, times
    // rho; the group decides on its met maxima, so it leaves together
    ps = group_max<kG>(mask, ps);
    pi = group_max<kG>(mask, pi);
    ds = group_max<kG>(mask, ds);
    di = group_max<kG>(mask, di);
    const bool pass = ps < p.pri_tol && pi < p.pri_tol &&
                      __fmul_rn(ds, rho) < p.dua_tol &&
                      __fmul_rn(di, rho) < p.dua_tol;
    const bool latch = pass && (i + 1) % p.ct == 0;
    if (latch || i + 1 == p.max_iter) {  // latch: v, z hold this iteration's
      finish_lane(latch ? i + 1 : p.max_iter, latch ? 1 : 0);  // slacks
      next_lane();
      i = 0;
      continue;
    }

    // Backward recursion; q_k, r_k recomputed from the slacks and duals.
    if constexpr (kFar) {
      rs.begin(false);
      sweep_step(0, false);
    }
    float po[kRx], pf[kCx];
#pragma unroll
    for (int s = 0; s < kRx; ++s) {
      const int j = xrow(s);
      po[s] = 0.0f;
      if (j < nx) {
        const int r = kFar ? j : ((N - 1) * nx + j) * LS;
        const float w = kStateFree ? v[r] : __fsub_rn(v[r], g[r]);
        po[s] = __fsub_rn(pNo[s], __fmul_rn(rho, w));
      }
    }
    gather<kG>(mask, po, pf, nx, 0);
    for (int k = N - 2; k >= 0; --k) {
      if constexpr (kFar) sweep_step(N - 1 - k, false);
      // AmBKt p_{k+1} first: it does not wait for r_k
      float ap[kRx];
#pragma unroll
      for (int s = 0; s < kRx; ++s)
        ap[s] = xrow(s) < nx ? dot(K3_COEF(Am, sAm, lx, s, xrow(s)), pf, nx)
                             : 0.0f;

      // r_k = rref - rho (z - y); s_k = B' p_{k+1} + r_k
      float ro[kRu], so[kRu], rf[kCu], sf[kCu];
#pragma unroll
      for (int s = 0; s < kRu; ++s) {
        const int a = urow(s);
        ro[s] = so[s] = 0.0f;
        if (a < nu) {
          const int r = kFar ? a : (k * nu + a) * LS;
          ro[s] = __fsub_rn(rref[k * nu + a],
                            __fmul_rn(rho, __fsub_rn(z[r], y[r])));
          so[s] = __fadd_rn(dot(K3_COEF(Bt, sBt, lx, s, a), pf, nx), ro[s]);
        }
      }
      gather<kG>(mask, so, sf, nu, nx);
      gather<kG>(mask, ro, rf, nu, nx);

      // d_k = Quu s_k
#pragma unroll
      for (int s = 0; s < kRu; ++s) {
        const int a = urow(s);
        if (a < nu)
          K3_PUT(d, kFar ? a : (k * nu + a) * LS,
                 dot(K3_COEF(Q, sQ, lu, s, a), sf, nu));
      }

      // p_k = q_k + AmBKt p_{k+1} - K' r_k, q_k = qref - rho (v - g)
#pragma unroll
      for (int s = 0; s < kRx; ++s) {
        const int j = xrow(s);
        po[s] = 0.0f;
        if (j < nx) {
          const float kr = dot(K3_COEF(Kt, sKt, lu, s, j), rf, nu);
          const int r = kFar ? j : (k * nx + j) * LS;
          const float w = kStateFree ? v[r] : __fsub_rn(v[r], g[r]);
          const float q = __fsub_rn(qref[k * nx + j], __fmul_rn(rho, w));
          po[s] = __fsub_rn(__fadd_rn(q, ap[s]), kr);
        }
      }
      gather<kG>(mask, po, pf, nx, 0);
    }
    ++i;
  }
#undef K3_COEF
#undef K3_PUT

  // the last block out resets its queue for the next launch
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    if (atomicAdd(queue + 1, 1u) == gridDim.x - 1) {
      queue[0] = 0u;
      queue[1] = 0u;
    }
  }
}

// The wide variant (nx or nu beyond kGenericDim): a lane group of kG = 8,
// 16 or 32 threads a lane, state row j on thread j % kG and input row a on
// (a + nx) % kG, each output row summed in index order with fmaf by the
// thread that owns it, as in fused_stage_kernel.  The stage vectors a
// thread needs whole (x_k, u_k, p_{k+1}, s_k, r_k) and its rows' partial
// products live in the lane's shared rows (vec_floats) and are exchanged
// under the group's __syncwarp, so the rows a thread owns take no
// registers.  The matrices are in shared memory, rows padded to an odd
// stride, or (mats_global) read from the caller's tensors; the per-stage
// terms and the workspace as in fused_stage_kernel's layouts, chosen at
// run time (p.stage_global, kFar through p.wsg).
struct Mat {  // coefficient (r, c) at a[r * rs + c * cs]
  const float* a;
  int rs, cs;
  __device__ __forceinline__ float operator()(int r, int c) const {
    return a[r * rs + c * cs];
  }
};

template <int kG, bool kStateFree>
__global__ void fused_stage_wide_kernel(const Params p) {
  static_assert(kG == 8 || kG == 16 || kG == 32,
                "a wide lane group is 8, 16 or 32 threads");
  extern __shared__ __align__(16) float smem[];
  const int nx = p.nx, nu = p.nu, N = p.N, B = p.batch;
  const int sx = N * nx, su = (N - 1) * nu;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int tile = nthreads / kG;
  const int lb = tid / kG, t = tid % kG;
  const int slot = blockIdx.x * tile + lb;  // the group's lane slot
  int lane = slot;
  const unsigned mask =
      kG == 32 ? 0xffffffffu
               : ((1u << (kG & 31)) - 1u) << ((tid & 31) & ~(kG - 1));
  const bool far = p.wsg != nullptr;
  const int LS = lane_stride(tile, kG);  // the near layout's row stride
  // the far layout's ring of each lane group leads the shared memory
  const int RS = far ? ring_stride(nx, nu, !kStateFree, p.ring, kG) : 0;
  float* const ring = smem + lb * RS;

  // -- prologue: the per-stage terms, the matrices, the lanes' vectors
  float* sp = smem + tile * RS;
  float* const qref = p.stage_global ? const_cast<float*>(p.stg) : sp;
  float* const rref = qref + sx;
  float* const umin = rref + su;
  float* const umax = umin + su;
  float* const xmin = umax + su;
  float* const xmax = xmin + (kStateFree ? 0 : sx);
  if (!p.stage_global) {
    sp = xmax + (kStateFree ? 0 : sx);
    for (int e = tid; e < sx; e += nthreads) {
      qref[e] = -__fmul_rn(p.Xref[e], p.Qd[e % nx]);
      if (!kStateFree) {
        xmin[e] = p.xmin[e];
        xmax[e] = p.xmax[e];
      }
    }
    for (int e = tid; e < su; e += nthreads) {
      rref[e] = -__fmul_rn(p.Uref[e], p.Rd[e % nu]);
      umin[e] = p.umin[e];
      umax[e] = p.umax[e];
    }
  }
  const int lx = odd_stride(nx), lu = odd_stride(nu);
  Mat mA, mAm, mB, mKt, mK, mBt, mQ;
  if (p.mats_global) {  // the caller's row-major tensors, transposed reads
    mA = {p.A, nx, 1};
    mAm = {p.AmBKt, nx, 1};
    mB = {p.B, nu, 1};
    mKt = {p.K, 1, nx};   // K'[i][a] = K[a][i]
    mK = {p.K, nx, 1};
    mBt = {p.B, 1, nu};   // B'[a][j] = B[j][a]
    mQ = {p.Quu, nu, 1};
  } else {
    float* const wA = sp;
    float* const wAm = wA + nx * lx;
    float* const wB = wAm + nx * lx;
    float* const wKt = wB + nx * lu;
    float* const wK = wKt + nx * lu;
    float* const wBt = wK + nu * lx;
    float* const wQ = wBt + nu * lx;
    sp += matrix_floats(nx, nu);
    for (int e = tid; e < nx * nx; e += nthreads) {
      wA[(e / nx) * lx + e % nx] = p.A[e];
      wAm[(e / nx) * lx + e % nx] = p.AmBKt[e];
    }
    for (int e = tid; e < nx * nu; e += nthreads) {
      wB[(e / nu) * lu + e % nu] = p.B[e];
      wBt[(e % nu) * lx + e / nu] = p.B[e];
      wK[(e / nx) * lx + e % nx] = p.K[e];
      wKt[(e % nx) * lu + e / nx] = p.K[e];
    }
    for (int e = tid; e < nu * nu; e += nthreads)
      wQ[(e / nu) * lu + e % nu] = p.Quu[e];
    mA = {wA, lx, 1};
    mAm = {wAm, lx, 1};
    mB = {wB, lu, 1};
    mKt = {wKt, lu, 1};
    mK = {wK, lx, 1};
    mBt = {wBt, lx, 1};
    mQ = {wQ, lu, 1};
  }
  // this lane's stage vectors
  float* const xf = sp + lb * vec_floats(nx, nu);
  float* const ax = xf + nx;  // A x_k, then AmBKt p_{k+1}, own rows
  float* const pf = ax + nx;
  float* const uf = pf + nx;
  float* const sf = uf + nu;
  float* const rf = sf + nu;
  sp += tile * vec_floats(nx, nu);
  __syncthreads();

  const float rho = p.rho_ptr != nullptr ? *p.rho_ptr : p.rho_val;
  const int a0 = (t - nx % kG + kG) % kG;  // this thread's first input row
  // sum_i m(row, i) * x[i] for i < n, in index order on one accumulator
  auto dot = [&](const Mat& m, int row, const float* x, int n) {
    float acc = 0.0f;
    for (int i = 0; i < n; ++i) acc = fmaf(m(row, i), x[i], acc);
    return acc;
  };

  // this group's workspace, as in fused_stage_kernel: near, row r of an
  // array at [r * LS] in shared memory, read and written in place; far, the
  // lane's records in global memory read through the ring (v .. d) and
  // written straight back (vw .. dw)
  const int xr = (kStateFree ? 1 : 2) * nx;
  float* __restrict__ v = far ? ring : sp + lb;
  float* __restrict__ g = v + (far ? nx : sx * LS);  // unused when kStateFree
  float* __restrict__ z = v + (far ? xr : (kStateFree ? 1 : 2) * sx * LS);
  float* __restrict__ y = z + (far ? nu : su * LS);
  float* __restrict__ d = y + (far ? nu : su * LS);
  float *vw = nullptr, *gw = nullptr, *zw = nullptr, *yw = nullptr,
        *dw = nullptr;
  // the far layout's records, as in fused_stage_kernel
  RecordStream<kG> rs(ring, p.wsg, slot, record_floats(nx, nu, !kStateFree),
                      p.ring, N, t, mask);
  // a far sweep's step i: v .. d at its slot, vw .. dw at its record
  auto sweep_step = [&](int i, bool fwd) {
    v = rs.step(i, fwd);
    g = v + nx;
    z = v + xr;
    y = z + nu;
    d = y + nu;
    vw = rs.record(fwd ? i : N - 1 - i);
    gw = vw + nx;
    zw = vw + xr;
    yw = zw + nu;
    dw = yw + nu;
  };
  // a result's store: in place (near) or to the record (far)
#define K3W_PUT(A, r, val) \
  do {                     \
    if (far)               \
      A##w[r] = (val);     \
    else                   \
      A[r] = (val);        \
  } while (0)

  auto start_lane = [&]() {
    for (int k = 0; k < N; ++k) {
      float* const rk = far ? rs.record(k) : nullptr;
      for (int j = t; j < nx; j += kG) {
        if (far) {
          rk[j] = 0.0f;
          if (!kStateFree) rk[nx + j] = 0.0f;
        } else {
          v[(k * nx + j) * LS] = 0.0f;
          if (!kStateFree) g[(k * nx + j) * LS] = 0.0f;
        }
      }
      if (k == N - 1) break;
      for (int a = a0; a < nu; a += kG) {
        if (far) {
          rk[xr + a] = 0.0f;
          rk[xr + nu + a] = 0.0f;
          rk[xr + 2 * nu + a] = 0.0f;
        } else {
          z[(k * nu + a) * LS] = 0.0f;
          y[(k * nu + a) * LS] = 0.0f;
          d[(k * nu + a) * LS] = 0.0f;
        }
      }
    }
  };
  auto finish_lane = [&](int n_iter, int ok) {
    float* const xl = p.xout + static_cast<size_t>(lane) * sx;
    float* const ul = p.uout + static_cast<size_t>(lane) * su;
    for (int k = 0; k < N; ++k) {
      const float* const rk = far ? rs.record(k) : nullptr;
      for (int j = t; j < nx; j += kG)
        xl[k * nx + j] = far ? rk[j] : v[(k * nx + j) * LS];
      if (k == N - 1) break;
      for (int a = a0; a < nu; a += kG)
        ul[k * nu + a] = far ? rk[xr + a] : z[(k * nu + a) * LS];
    }
    if (t == 0) {
      p.iters[lane] = n_iter;
      p.solved[lane] = ok;
    }
  };

  unsigned* const queue = g_lane_queue[p.slot];
  const int P = gridDim.x * tile;
  auto next_lane = [&]() {
    int nxt = 0;
    if (t == 0) nxt = P + static_cast<int>(atomicAdd(queue, 1u));
    nxt = __shfl_sync(mask, nxt, 0, kG);
    lane = nxt;
    if (lane < B) start_lane();
  };
  if (lane < B) start_lane();
  while (lane < B && p.max_iter == 0) {
    finish_lane(0, 0);
    next_lane();
  }

  int i = 0;
  while (lane < B) {
    float ps = 0.0f, pi = 0.0f, ds = 0.0f, di = 0.0f;
    const float* x0 = p.x0 + static_cast<size_t>(lane) * nx;
    for (int j = t; j < nx; j += kG) xf[j] = x0[j];
    __syncwarp(mask);

    // Forward rollout; the slack, dual and residual updates of a stage run
    // as soon as its x_k (and u_k) exist.
    if (far) rs.begin(true);
    for (int k = 0; k < N; ++k) {
      if (far) sweep_step(k, true);
      for (int j = t; j < nx; j += kG) {
        const int r = far ? j : (k * nx + j) * LS;
        const float xo = xf[j];
        float vn = xo;
        if (!kStateFree) {
          const float gj = g[r];
          vn = __fadd_rn(xo, gj);
          vn = fminf(xmax[k * nx + j], fmaxf(xmin[k * nx + j], vn));
          K3W_PUT(g, r, __fsub_rn(__fadd_rn(gj, xo), vn));
          ps = fmaxf(ps, fabsf(__fsub_rn(xo, vn)));
        }
        ds = fmaxf(ds, fabsf(__fsub_rn(v[r], vn)));
        K3W_PUT(v, r, vn);
      }
      if (k == N - 1) break;
      for (int j = t; j < nx; j += kG) ax[j] = dot(mA, j, xf, nx);
      // u_k = -K x_k - d_k; input side: zn = clip(u + y), y += u - zn
      for (int a = a0; a < nu; a += kG) {
        const int r = far ? a : (k * nu + a) * LS;
        const float tk = dot(mK, a, xf, nx);
        const float uo = __fsub_rn(-tk, d[r]);
        const float ya = y[r];
        float zn = __fadd_rn(uo, ya);
        if (p.en_input_bound)
          zn = fminf(umax[k * nu + a], fmaxf(umin[k * nu + a], zn));
        K3W_PUT(y, r, __fsub_rn(__fadd_rn(ya, uo), zn));
        pi = fmaxf(pi, fabsf(__fsub_rn(uo, zn)));
        di = fmaxf(di, fabsf(__fsub_rn(z[r], zn)));
        K3W_PUT(z, r, zn);
        uf[a] = uo;
      }
      __syncwarp(mask);  // u_k whole; every read of x_k done
      // x_{k+1} = A x_k + B u_k + f
      for (int j = t; j < nx; j += kG)
        xf[j] = __fadd_rn(__fadd_rn(ax[j], dot(mB, j, uf, nu)), p.f[j]);
      __syncwarp(mask);  // x_{k+1} whole; every read of u_k done
    }

    ps = group_max<kG>(mask, ps);
    pi = group_max<kG>(mask, pi);
    ds = group_max<kG>(mask, ds);
    di = group_max<kG>(mask, di);
    const bool pass = ps < p.pri_tol && pi < p.pri_tol &&
                      __fmul_rn(ds, rho) < p.dua_tol &&
                      __fmul_rn(di, rho) < p.dua_tol;
    const bool latch = pass && (i + 1) % p.ct == 0;
    if (latch || i + 1 == p.max_iter) {
      finish_lane(latch ? i + 1 : p.max_iter, latch ? 1 : 0);
      next_lane();
      i = 0;
      continue;
    }

    // Backward recursion; q_k, r_k recomputed from the slacks and duals.
    if (far) {
      rs.begin(false);
      sweep_step(0, false);
    }
    for (int j = t; j < nx; j += kG) {
      float acc = 0.0f;  // -(Pinf' Xref[N-1]) row j, in index order
      for (int e = 0; e < nx; ++e)
        acc = fmaf(p.Pinf[e * nx + j], p.Xref[(N - 1) * nx + e], acc);
      const int r = far ? j : ((N - 1) * nx + j) * LS;
      const float w = kStateFree ? v[r] : __fsub_rn(v[r], g[r]);
      pf[j] = __fsub_rn(-acc, __fmul_rn(rho, w));
    }
    __syncwarp(mask);
    for (int k = N - 2; k >= 0; --k) {
      if (far) sweep_step(N - 1 - k, false);
      for (int j = t; j < nx; j += kG) ax[j] = dot(mAm, j, pf, nx);
      // r_k = rref - rho (z - y); s_k = B' p_{k+1} + r_k
      for (int a = a0; a < nu; a += kG) {
        const int r = far ? a : (k * nu + a) * LS;
        const float ro = __fsub_rn(rref[k * nu + a],
                                   __fmul_rn(rho, __fsub_rn(z[r], y[r])));
        sf[a] = __fadd_rn(dot(mBt, a, pf, nx), ro);
        rf[a] = ro;
      }
      __syncwarp(mask);  // s_k, r_k whole; every read of p_{k+1} done
      // d_k = Quu s_k
      for (int a = a0; a < nu; a += kG)
        K3W_PUT(d, far ? a : (k * nu + a) * LS, dot(mQ, a, sf, nu));
      // p_k = q_k + AmBKt p_{k+1} - K' r_k, q_k = qref - rho (v - g)
      for (int j = t; j < nx; j += kG) {
        const float kr = dot(mKt, j, rf, nu);
        const int r = far ? j : (k * nx + j) * LS;
        const float w = kStateFree ? v[r] : __fsub_rn(v[r], g[r]);
        const float q = __fsub_rn(qref[k * nx + j], __fmul_rn(rho, w));
        pf[j] = __fsub_rn(__fadd_rn(q, ax[j]), kr);
      }
      __syncwarp(mask);  // p_k whole; every read of s_k, r_k done
    }
    ++i;
  }
#undef K3W_PUT

  __syncthreads();
  if (tid == 0) {
    __threadfence();
    if (atomicAdd(queue + 1, 1u) == gridDim.x - 1) {
      queue[0] = 0u;
      queue[1] = 0u;
    }
  }
}

using KernelFn = void (*)(const Params);

// The variants built: (nx, nu, G, matrices in registers), each with and
// without a state bound and with the workspace in shared or global memory;
// (0, 0, ...) is the generic one.  The Python plan (ops/cuda/fused.py
// VARIANTS) names the same.  Beyond kGenericDim, the wide variant's lane
// groups (WIDE_GROUPS there).
#define K3_VARIANTS(X) \
  X(4, 1, 1, true)     \
  X(6, 3, 2, true)     \
  X(12, 4, 4, true)    \
  X(0, 0, 4, false)

bool fixed_shape(int nx, int nu) {
  return (nx == 4 && nu == 1) || (nx == 6 && nu == 3) ||
         (nx == 12 && nu == 4);
}

bool wide_shape(int nx, int nu) {
  return nx > kGenericDim || nu > kGenericDim;
}

KernelFn pick_kernel(int nx, int nu, int group, bool regs, bool state_free,
                     bool far) {
  if (wide_shape(nx, nu)) {
    if (regs) return nullptr;
#define K3_WIDE(G)                                                        \
  if (group == G)                                                         \
    return state_free ? fused_stage_wide_kernel<G, true>                  \
                      : fused_stage_wide_kernel<G, false>;
    K3_WIDE(8) K3_WIDE(16) K3_WIDE(32)
#undef K3_WIDE
    return nullptr;
  }
  const int knx = fixed_shape(nx, nu) ? nx : 0;
  const int knu = fixed_shape(nx, nu) ? nu : 0;
#define K3_PICK(NX, NU, G, REGS)                                          \
  if (knx == NX && knu == NU && group == G && regs == REGS)               \
    return state_free                                                     \
               ? (far ? fused_stage_kernel<NX, NU, G, REGS, true, true>   \
                      : fused_stage_kernel<NX, NU, G, REGS, true, false>) \
               : (far ? fused_stage_kernel<NX, NU, G, REGS, false, true>  \
                      : fused_stage_kernel<NX, NU, G, REGS, false, false>);
  K3_VARIANTS(K3_PICK)
#undef K3_PICK
  return nullptr;
}

// The layout's shared memory: the far layout's rings, the per-stage terms
// (unless in global memory), the matrices (the generic and wide variants,
// unless in global memory), the wide variant's lane vectors, the workspace
// (unless far).
size_t smem_need(int nx, int nu, int N, bool state_box, bool regs, int tile,
                 int group, bool far, int ring, bool stage_global,
                 bool mats_global) {
  const bool wide = wide_shape(nx, nu);
  return sizeof(float) *
         ((far ? static_cast<size_t>(
                     ring_stride(nx, nu, state_box, ring, group)) *
                     tile
               : 0) +
          (stage_global ? 0
                        : static_cast<size_t>(
                              stage_floats(nx, nu, N, state_box))) +
          (regs || mats_global ? 0 : matrix_floats(nx, nu)) +
          (wide ? static_cast<size_t>(vec_floats(nx, nu)) * tile : 0) +
          (far ? 0
               : static_cast<size_t>(lane_floats(nx, nu, N, state_box)) *
                     lane_stride(tile, group)));
}

bool valid_group(int g) {
  return g == 1 || g == 2 || g == 4 || g == 8 || g == 16 || g == 32;
}

}  // namespace

extern "C" int tinympc_fused_stage(
    const float* A, const float* B, const float* f, const float* Qd,
    const float* Rd, const float* rho_ptr, float rho_val, const float* K,
    const float* Quu, const float* AmBKt, const float* Pinf, const float* xmin,
    const float* xmax, const float* umin, const float* umax,
    const float* Xref, const float* Uref, const float* x0, float* xout,
    float* uout, int* iters, int* solved, float* wsg, const float* stg,
    int nx, int nu, int N, int Bsz,
    int max_iter, int ct, float pri_tol, float dua_tol, int en_input_bound,
    int en_state_bound, int group, int regs, int tile, int smem_bytes,
    int ws_global, int ws_slots, int ring, int stage_global, int mats_global,
    void* stream) {
  // ws_global: the workspace in wsg, N x record_floats floats for each of
  // ws_slots lane slots ([warp slot][stage][lane of the warp][record]), the
  // grid held to ws_slots / tile blocks, each lane group's ring ``ring``
  // records deep; stage_global: the per-stage terms in stg (qref, rref,
  // u_min, u_max[, x_min, x_max] as the kernel lays them out in shared
  // memory); mats_global: the wide variant reads the matrices from the
  // caller's tensors.
  const bool far = ws_global != 0;
  if (nx < 1 || nu < 1 || N < 2 || Bsz < 1 || max_iter < 0 || ct < 1 ||
      !valid_group(group) || tile < 1 || tile * group > 1024 ||
      smem_bytes < 0 ||
      (far && (!wsg || ws_slots < tile || ws_slots % tile != 0 ||
               (tile * group) % 32 != 0 || ring < 2 || ring > kMaxRing)) ||
      (stage_global && (!far || !stg)) ||
      (mats_global && !wide_shape(nx, nu)))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool state_free = !en_state_bound;
  // the caller owns the layout; refuse one the kernel would overrun
  if (static_cast<size_t>(smem_bytes) <
      smem_need(nx, nu, N, !state_free, regs != 0, tile, group, far, ring,
                stage_global != 0, mats_global != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const KernelFn kernel =
      pick_kernel(nx, nu, group, regs != 0, state_free, far);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);

  Params p;
  p.A = A; p.B = B; p.f = f; p.Qd = Qd; p.Rd = Rd; p.rho_ptr = rho_ptr;
  p.K = K; p.Quu = Quu; p.AmBKt = AmBKt; p.Pinf = Pinf;
  p.xmin = xmin; p.xmax = xmax; p.umin = umin; p.umax = umax;
  p.Xref = Xref; p.Uref = Uref; p.x0 = x0; p.rho_val = rho_val;
  p.xout = xout; p.uout = uout; p.iters = iters; p.solved = solved;
  p.wsg = far ? wsg : nullptr; p.stg = stg;
  p.stage_global = stage_global; p.mats_global = mats_global;
  p.nx = nx; p.nu = nu; p.N = N; p.batch = Bsz; p.max_iter = max_iter;
  p.ct = ct; p.en_input_bound = en_input_bound; p.ring = far ? ring : 0;
  p.pri_tol = pri_tol; p.dua_tol = dua_tol;

  static std::atomic<unsigned> launches{0};
  p.slot = static_cast<int>(launches.fetch_add(1) % kQueueSlots);

  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // as many blocks as the SMs hold at once (the rest of the lanes come
  // through the queue), no more than the tiles of the batch
  int per_sm = 0, device = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, tile * group, static_cast<size_t>(smem_bytes));
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int grid = std::min((Bsz + tile - 1) / tile, std::max(per_sm, 1) * sms);
  if (far) grid = std::min(grid, ws_slots / tile);  // the workspace's slots
  kernel<<<grid, tile * group, static_cast<size_t>(smem_bytes),
           static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// What the runtime says of a variant at a launch layout: resident blocks an
// SM, registers a thread, local (spill) bytes a thread.
extern "C" int tinympc_fused_stage_occupancy(int nx, int nu, int group,
                                             int regs, int en_state_bound,
                                             int ws_global, int tile,
                                             int smem_bytes,
                                             int* blocks_per_sm, int* n_regs,
                                             int* local_bytes) {
  const KernelFn kernel =
      valid_group(group) ? pick_kernel(nx, nu, group, regs != 0,
                                       !en_state_bound, ws_global != 0)
                         : nullptr;
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  *n_regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel, tile * group, static_cast<size_t>(smem_bytes)));
}
