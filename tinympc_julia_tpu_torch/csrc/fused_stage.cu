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
// results.  What bounds the kernel is not bytes but the chain of small
// dependent matvecs (two recursions over the horizon) of the slowest lanes:
// a lane that never passes runs every iteration, and its warp with it.
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
//    kMaxDim, rows predicated) reads them from shared memory, rows padded to
//    an odd stride so that a warp's threads read different banks, through a
//    pointer that does not alias the lanes' workspace.
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

namespace {

constexpr int kMaxDim = 16;  // widest nx, nu of the generic variant

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

// The workspace's lane stride: the tile rounded up to be = 32 / G (mod 32),
// so that the G threads of the 32 / G lanes of a warp, each on its own row,
// fall on 32 different banks.
__host__ __device__ inline int lane_stride(int tile, int group) {
  const int lanes_per_warp = 32 / group;
  return tile + ((lanes_per_warp - tile) % 32 + 32) % 32;
}

struct Params {
  const float *A, *B, *f, *Qd, *Rd, *rho_ptr, *K, *Quu, *AmBKt, *Pinf;
  const float *xmin, *xmax, *umin, *umax, *Xref, *Uref, *x0;
  float rho_val;    // rho when rho_ptr is null
  float* xout;      // (B, N, nx): the state slacks v
  float* uout;      // (B, N-1, nu): the input slacks z
  int* iters;       // (B,)
  int* solved;      // (B,)
  int nx, nu, N, batch, max_iter, ct, en_input_bound;
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
// to kMaxDim, read from the parameters).  kG: threads a lane.  kRegs: the
// matrices' rows in registers (fixed shapes) or shared memory.  kStateFree:
// no state bound, so the state dual is 0 and the state slack equals the
// rollout.
template <int kNx, int kNu, int kG, bool kRegs, bool kStateFree>
__global__ void fused_stage_kernel(const Params p) {
  static_assert(kG == 1 || kG == 2 || kG == 4 || kG == 8 || kG == 16,
                "a lane group is a power of two up to 16 threads");
  static_assert(kNx > 0 || !kRegs, "the generic variant reads shared memory");
  extern __shared__ float smem[];
  constexpr int kCx = kNx > 0 ? kNx : kMaxDim;  // register capacities
  constexpr int kCu = kNu > 0 ? kNu : kMaxDim;
  constexpr int kRx = (kCx + kG - 1) / kG;      // rows a thread owns, at most
  constexpr int kRu = (kCu + kG - 1) / kG;
  const int nx = kNx > 0 ? kNx : p.nx;
  const int nu = kNu > 0 ? kNu : p.nu;
  const int N = p.N, B = p.batch;
  const int sx = N * nx, su = (N - 1) * nu;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int tile = nthreads / kG;
  const int lb = tid / kG, t = tid % kG;  // lane in the block, rank in group
  int lane = blockIdx.x * tile + lb;  // the group's lane; see the queue below
  const unsigned mask = ((1u << kG) - 1u) << ((tid & 31) & ~(kG - 1));
  const int LS = lane_stride(tile, kG);

  // -- prologue: the block's per-stage terms (and the generic variant's
  // matrices) from the caller's tensors
  float* const qref = smem;
  float* const rref = qref + sx;
  float* const umin = rref + su;
  float* const umax = umin + su;
  float* const xmin = umax + su;
  float* const xmax = xmin + (kStateFree ? 0 : sx);
  float* const mats = xmax + (kStateFree ? 0 : sx);
  float* const ws = mats + (kRegs ? 0 : matrix_floats(nx, nu));
  const int lx = odd_stride(nx), lu = odd_stride(nu);
  float* const wA = mats;          // [nx][lx]
  float* const wAm = wA + nx * lx;  // [nx][lx]
  float* const wB = wAm + nx * lx;  // [nx][lu]
  float* const wKt = wB + nx * lu;  // [nx][lu]
  float* const wK = wKt + nx * lu;  // [nu][lx]
  float* const wBt = wK + nu * lx;  // [nu][lx]
  float* const wQ = wBt + nu * lx;  // [nu][lu]
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

  // this group's workspace: row r of an array at [r * LS]
  float* __restrict__ const v = ws + lb;
  float* __restrict__ const g = v + sx * LS;  // unused when kStateFree
  float* __restrict__ const z = (kStateFree ? v : g) + sx * LS;
  float* __restrict__ const y = z + su * LS;
  float* __restrict__ const d = y + su * LS;

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
#pragma unroll
      for (int s = 0; s < kRx; ++s) {
        const int j = xrow(s);
        if (j < nx) {
          v[(k * nx + j) * LS] = 0.0f;
          if (!kStateFree) g[(k * nx + j) * LS] = 0.0f;
        }
      }
      if (k == N - 1) break;
#pragma unroll
      for (int s = 0; s < kRu; ++s) {
        const int a = urow(s);
        if (a < nu) {
          z[(k * nu + a) * LS] = 0.0f;
          y[(k * nu + a) * LS] = 0.0f;
          d[(k * nu + a) * LS] = 0.0f;
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
#pragma unroll
      for (int s = 0; s < kRx; ++s) {
        const int j = xrow(s);
        if (j < nx) xl[k * nx + j] = v[(k * nx + j) * LS];
      }
      if (k == N - 1) break;
#pragma unroll
      for (int s = 0; s < kRu; ++s) {
        const int a = urow(s);
        if (a < nu) ul[k * nu + a] = z[(k * nu + a) * LS];
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
    for (int k = 0; k < N; ++k) {
      // state side of stage k: vn = clip(x + g), g += x - vn (kStateFree:
      // no bound, vn = x)
#pragma unroll
      for (int s = 0; s < kRx; ++s) {
        const int j = xrow(s);
        if (j < nx) {
          const int r = (k * nx + j) * LS;
          float vn = xo[s];
          if (!kStateFree) {
            const float gj = g[r];
            vn = __fadd_rn(xo[s], gj);
            vn = fminf(xmax[k * nx + j], fmaxf(xmin[k * nx + j], vn));
            g[r] = __fsub_rn(__fadd_rn(gj, xo[s]), vn);
            ps = fmaxf(ps, fabsf(__fsub_rn(xo[s], vn)));
          }
          ds = fmaxf(ds, fabsf(__fsub_rn(v[r], vn)));
          v[r] = vn;
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
          const int r = (k * nu + a) * LS;
          const float tk = dot(K3_COEF(K, sK, lx, s, a), xf, nx);
          uo[s] = __fsub_rn(-tk, d[r]);
          const float ya = y[r];
          float zn = __fadd_rn(uo[s], ya);
          if (p.en_input_bound)
            zn = fminf(umax[k * nu + a], fmaxf(umin[k * nu + a], zn));
          y[r] = __fsub_rn(__fadd_rn(ya, uo[s]), zn);
          pi = fmaxf(pi, fabsf(__fsub_rn(uo[s], zn)));
          di = fmaxf(di, fabsf(__fsub_rn(z[r], zn)));
          z[r] = zn;
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
    float po[kRx], pf[kCx];
#pragma unroll
    for (int s = 0; s < kRx; ++s) {
      const int j = xrow(s);
      po[s] = 0.0f;
      if (j < nx) {
        const int r = ((N - 1) * nx + j) * LS;
        const float w = kStateFree ? v[r] : __fsub_rn(v[r], g[r]);
        po[s] = __fsub_rn(pNo[s], __fmul_rn(rho, w));
      }
    }
    gather<kG>(mask, po, pf, nx, 0);
    for (int k = N - 2; k >= 0; --k) {
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
          const int r = (k * nu + a) * LS;
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
          d[(k * nu + a) * LS] = dot(K3_COEF(Q, sQ, lu, s, a), sf, nu);
      }

      // p_k = q_k + AmBKt p_{k+1} - K' r_k, q_k = qref - rho (v - g)
#pragma unroll
      for (int s = 0; s < kRx; ++s) {
        const int j = xrow(s);
        po[s] = 0.0f;
        if (j < nx) {
          const float kr = dot(K3_COEF(Kt, sKt, lu, s, j), rf, nu);
          const int r = (k * nx + j) * LS;
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

using KernelFn = void (*)(const Params);

// The variants built: (nx, nu, G, matrices in registers), each with and
// without a state bound; (0, 0, ...) is the generic one.  The Python plan
// (ops/cuda/fused.py VARIANTS) names the same.
#define K3_VARIANTS(X) \
  X(4, 1, 1, true)     \
  X(6, 3, 2, true)     \
  X(12, 4, 4, true)    \
  X(0, 0, 4, false)

bool fixed_shape(int nx, int nu) {
  return (nx == 4 && nu == 1) || (nx == 6 && nu == 3) ||
         (nx == 12 && nu == 4);
}

KernelFn pick_kernel(int nx, int nu, int group, bool regs, bool state_free) {
  const int knx = fixed_shape(nx, nu) ? nx : 0;
  const int knu = fixed_shape(nx, nu) ? nu : 0;
#define K3_PICK(NX, NU, G, REGS)                                   \
  if (knx == NX && knu == NU && group == G && regs == REGS)        \
    return state_free ? fused_stage_kernel<NX, NU, G, REGS, true>  \
                      : fused_stage_kernel<NX, NU, G, REGS, false>;
  K3_VARIANTS(K3_PICK)
#undef K3_PICK
  return nullptr;
}

size_t smem_need(int nx, int nu, int N, bool state_box, bool regs, int tile,
                 int group) {
  return sizeof(float) *
         (static_cast<size_t>(stage_floats(nx, nu, N, state_box)) +
          (regs ? 0 : matrix_floats(nx, nu)) +
          static_cast<size_t>(lane_floats(nx, nu, N, state_box)) *
              lane_stride(tile, group));
}

bool valid_group(int g) {
  return g == 1 || g == 2 || g == 4 || g == 8 || g == 16;
}

}  // namespace

extern "C" int tinympc_fused_stage(
    const float* A, const float* B, const float* f, const float* Qd,
    const float* Rd, const float* rho_ptr, float rho_val, const float* K,
    const float* Quu, const float* AmBKt, const float* Pinf, const float* xmin,
    const float* xmax, const float* umin, const float* umax,
    const float* Xref, const float* Uref, const float* x0, float* xout,
    float* uout, int* iters, int* solved, int nx, int nu, int N, int Bsz,
    int max_iter, int ct, float pri_tol, float dua_tol, int en_input_bound,
    int en_state_bound, int group, int regs, int tile, int smem_bytes,
    void* stream) {
  if (nx < 1 || nu < 1 || nx > kMaxDim || nu > kMaxDim || N < 2 || Bsz < 1 ||
      max_iter < 0 || ct < 1 || !valid_group(group) || tile < 1 ||
      tile * group > 1024 || smem_bytes < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool state_free = !en_state_bound;
  // the caller owns the layout; refuse one the kernel would overrun
  if (static_cast<size_t>(smem_bytes) <
      smem_need(nx, nu, N, !state_free, regs != 0, tile, group))
    return static_cast<int>(cudaErrorInvalidValue);
  const KernelFn kernel = pick_kernel(nx, nu, group, regs != 0, state_free);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);

  Params p;
  p.A = A; p.B = B; p.f = f; p.Qd = Qd; p.Rd = Rd; p.rho_ptr = rho_ptr;
  p.K = K; p.Quu = Quu; p.AmBKt = AmBKt; p.Pinf = Pinf;
  p.xmin = xmin; p.xmax = xmax; p.umin = umin; p.umax = umax;
  p.Xref = Xref; p.Uref = Uref; p.x0 = x0; p.rho_val = rho_val;
  p.xout = xout; p.uout = uout; p.iters = iters; p.solved = solved;
  p.nx = nx; p.nu = nu; p.N = N; p.batch = Bsz; p.max_iter = max_iter;
  p.ct = ct; p.en_input_bound = en_input_bound;
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
  const int grid = std::min((Bsz + tile - 1) / tile, std::max(per_sm, 1) * sms);
  kernel<<<grid, tile * group, static_cast<size_t>(smem_bytes),
           static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// What the runtime says of a variant at a launch layout: resident blocks an
// SM, registers a thread, local (spill) bytes a thread.
extern "C" int tinympc_fused_stage_occupancy(int nx, int nu, int group,
                                             int regs, int en_state_bound,
                                             int tile, int smem_bytes,
                                             int* blocks_per_sm, int* n_regs,
                                             int* local_bytes) {
  const KernelFn kernel =
      valid_group(group) ? pick_kernel(nx, nu, group, regs != 0,
                                       !en_state_bound)
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
