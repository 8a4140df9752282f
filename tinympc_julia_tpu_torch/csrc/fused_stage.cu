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
// (1,862 at the cartpole, 18,848 at the quadrotor: a tenth of the condensed
// kernel's one big matvec) on matrices of a few hundred floats, and device
// memory is touched only for x0 and the results.  What bounds the kernel is
// the chain of small dependent matvecs (two recursions over the horizon) and
// how many lanes an SM can hold, not bytes.
//
// What this design does about it:
//  * One thread owns one lane and runs that lane's whole iteration loop; a
//    lane leaves its loop when it latches (its outputs are final then).
//    Lanes never exchange data: one barrier, after the prologue.
//  * The Pallas kernel keeps twelve (N, nx, Bt)/(N-1, nu, Bt) arrays.  Here
//    only what must live across iterations does: the slacks v, z (which are
//    also the outputs), the duals g, y and the feedforward d, in shared
//    memory as [row][lane] (the threads of a warp on consecutive banks).
//    The slack, dual and residual updates of stage k ride the forward pass
//    right after x_k, u_k exist; q_k, r_k are recomputed from v - g, z - y
//    in the backward pass; x_k, u_k and p are one rolling stage in registers.
//    Without a state bound g stays 0 and v = x exactly, so g is dropped
//    (kStateFree): 137 floats a lane at the cartpole, 468 at the quadrotor.
//  * nx and nu are template parameters for the plants of the repo, so every
//    stage vector is a register array and every small matvec is fully
//    unrolled: an output row's sum runs in index order on its own
//    accumulator (nx independent FMA chains hide the FMA latency).  The
//    matrices sit in shared memory transposed with their rows padded to a
//    multiple of 4, so one 16-byte broadcast load feeds four FMAs.  Any other
//    nx, nu <= kMaxDim runs the same body with its loops predicated.
//  * Elementwise arithmetic uses round-to-nearest intrinsics in the plain
//    PyTorch version's order of operations, so nothing is contracted into
//    FMAs behind its back.
//
// Launch contract: blockDim.x = the lane tile chosen by the Python wrapper
// (fused_stage_plan), ragged last tile masked here.  The wrapper packs rho,
// the matrices (kernel layout), f, the reference terms and the bounds into
// one float buffer (pack_consts in ops/cuda/fused.py; the same section order
// as consts_layout below) and owns the dynamic shared-memory size; the entry
// point refuses a layout the kernel would overrun.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxDim = 16;  // widest nx, nu of the generic variant

__host__ __device__ constexpr int pad4(int m) {
  return m >= 4 ? (m + 3) / 4 * 4 : m;
}
__host__ __device__ constexpr int align4(int n) { return (n + 3) / 4 * 4; }

// Offsets (in floats) of the sections of the packed constants; every section
// starts on a multiple of 4 floats.  A matrix M (m x n) is stored transposed
// with padded rows: element (i, j) at [j * pad4(m) + i].
struct Layout {
  int rho, Kt, At, Bt, BTt, Quut, Amt, KTt, f, pNref, qref, rref, umin, umax,
      xmin, xmax, total;
};

__host__ __device__ inline Layout consts_layout(int nx, int nu, int N,
                                                bool state_box) {
  const int sx = N * nx, su = (N - 1) * nu;
  Layout l;
  int o = 0;
  l.rho = o;   o = align4(o + 1);
  l.Kt = o;    o = align4(o + nx * pad4(nu));
  l.At = o;    o = align4(o + nx * pad4(nx));
  l.Bt = o;    o = align4(o + nu * pad4(nx));
  l.BTt = o;   o = align4(o + nx * pad4(nu));
  l.Quut = o;  o = align4(o + nu * pad4(nu));
  l.Amt = o;   o = align4(o + nx * pad4(nx));
  l.KTt = o;   o = align4(o + nu * pad4(nx));
  l.f = o;     o = align4(o + nx);
  l.pNref = o; o = align4(o + nx);
  l.qref = o;  o = align4(o + sx);
  l.rref = o;  o = align4(o + su);
  l.umin = o;  o = align4(o + su);
  l.umax = o;  o = align4(o + su);
  l.xmin = o;  if (state_box) o = align4(o + sx);
  l.xmax = o;  if (state_box) o = align4(o + sx);
  l.total = o;
  return l;
}

struct Params {
  const float* consts;  // packed constants, consts_layout order
  const float* x0;      // (B, nx)
  float* xout;          // (sx, B) v slack: the state output
  float* uout;          // (su, B) z slack: the input output
  int* iters;           // (B,)
  int* solved;          // (B,)
  int nx, nu, N, B, max_iter, ct, en_input_bound;
  float pri_tol, dua_tol;
};

// acc = M x for M (m x n) in the kernel layout: every output row on its own
// accumulator, summed in index order over the columns.  The loops run over
// the compile-time capacities and are predicated on m, n, which are
// constants in the variants of a fixed shape.
template <int kOut, int kIn>
__device__ __forceinline__ void matvec(const float* mt, int m, int n,
                                       const float (&x)[kIn],
                                       float (&acc)[kOut]) {
  const int mp = pad4(m);
#pragma unroll
  for (int i = 0; i < kOut; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int j = 0; j < kIn; ++j) {
    if (j < n) {
      if (m >= 4) {
#pragma unroll
        for (int i = 0; i + 3 < kOut; i += 4) {
          if (i < mp) {
            const float4 c = *reinterpret_cast<const float4*>(mt + j * mp + i);
            acc[i] = fmaf(c.x, x[j], acc[i]);
            acc[i + 1] = fmaf(c.y, x[j], acc[i + 1]);
            acc[i + 2] = fmaf(c.z, x[j], acc[i + 2]);
            acc[i + 3] = fmaf(c.w, x[j], acc[i + 3]);
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < kOut; ++i)
          if (i < m) acc[i] = fmaf(mt[j * mp + i], x[j], acc[i]);
      }
    }
  }
}

// kNx, kNu: the plant's widths, or 0 for the generic variant (any nx, nu up
// to kMaxDim, read from the parameters).  kStateFree: no state bound, so the
// state dual is 0 and the state slack equals the rollout.
template <int kNx, int kNu, bool kStateFree>
__global__ void fused_stage_kernel(Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int kCx = kNx > 0 ? pad4(kNx) : kMaxDim;  // register capacities
  constexpr int kCu = kNu > 0 ? pad4(kNu) : kMaxDim;
  const int nx = kNx > 0 ? kNx : p.nx;
  const int nu = kNu > 0 ? kNu : p.nu;
  const int N = p.N, B = p.B;
  const int sx = N * nx, su = (N - 1) * nu;
  const int T = blockDim.x, tid = threadIdx.x;
  const int lane = blockIdx.x * T + tid;

  const Layout L = consts_layout(nx, nu, N, !kStateFree);
  for (int e = tid; e < L.total; e += T) smem[e] = p.consts[e];
  __syncthreads();
  if (lane >= B) return;

  const float rho = smem[L.rho];
  const float* Kt = smem + L.Kt;
  const float* At = smem + L.At;
  const float* Bt = smem + L.Bt;
  const float* BTt = smem + L.BTt;
  const float* Quut = smem + L.Quut;
  const float* Amt = smem + L.Amt;
  const float* KTt = smem + L.KTt;
  const float* fv = smem + L.f;

  // this lane's workspace: row r of an array at [r * T]
  float* v = smem + L.total + tid;
  float* g = v + sx * T;  // unused when kStateFree
  float* z = (kStateFree ? v : g) + sx * T;
  float* y = z + su * T;
  float* d = y + su * T;
  for (int r = 0; r < sx; ++r) {
    v[r * T] = 0.0f;
    if (!kStateFree) g[r * T] = 0.0f;
  }
  for (int r = 0; r < su; ++r) {
    z[r * T] = 0.0f;
    y[r * T] = 0.0f;
    d[r * T] = 0.0f;
  }

  float x0[kCx];
#pragma unroll
  for (int j = 0; j < kCx; ++j)
    x0[j] = j < nx ? p.x0[lane * nx + j] : 0.0f;

  int n_iter = p.max_iter, ok = 0;
  for (int i = 0; i < p.max_iter; ++i) {
    float ps = 0.0f, pi = 0.0f, ds = 0.0f, di = 0.0f;
    float x[kCx];
#pragma unroll
    for (int j = 0; j < kCx; ++j) x[j] = x0[j];

    // Forward rollout; the slack, dual and residual updates of a stage run
    // as soon as its x_k (and u_k) exist.
    for (int k = 0; k < N; ++k) {
      // state side of stage k: vn = clip(x + g), g += x - vn (kStateFree:
      // no bound, vn = x)
      {
        const float* xmin = smem + L.xmin + k * nx;
        const float* xmax = smem + L.xmax + k * nx;
        float* vk = v + k * nx * T;
        float* gk = g + k * nx * T;
#pragma unroll
        for (int j = 0; j < kCx; ++j) {
          if (j < nx) {
            float vn = x[j];
            if (!kStateFree) {
              const float gj = gk[j * T];
              vn = __fadd_rn(x[j], gj);
              vn = fminf(xmax[j], fmaxf(xmin[j], vn));
              gk[j * T] = __fsub_rn(__fadd_rn(gj, x[j]), vn);
              ps = fmaxf(ps, fabsf(__fsub_rn(x[j], vn)));
            }
            ds = fmaxf(ds, fabsf(__fsub_rn(vk[j * T], vn)));
            vk[j * T] = vn;
          }
        }
      }
      if (k == N - 1) break;

      // u_k = -K x_k - d_k
      float t[kCu], u[kCu];
      matvec(Kt, nu, nx, x, t);
      {
        const float* umin = smem + L.umin + k * nu;
        const float* umax = smem + L.umax + k * nu;
        float* zk = z + k * nu * T;
        float* yk = y + k * nu * T;
        const float* dk = d + k * nu * T;
#pragma unroll
        for (int a = 0; a < kCu; ++a) {
          u[a] = 0.0f;
          if (a < nu) {
            u[a] = __fsub_rn(-t[a], dk[a * T]);
            // input side: zn = clip(u + y), y += u - zn
            const float ya = yk[a * T];
            float zn = __fadd_rn(u[a], ya);
            if (p.en_input_bound) zn = fminf(umax[a], fmaxf(umin[a], zn));
            yk[a * T] = __fsub_rn(__fadd_rn(ya, u[a]), zn);
            pi = fmaxf(pi, fabsf(__fsub_rn(u[a], zn)));
            di = fmaxf(di, fabsf(__fsub_rn(zk[a * T], zn)));
            zk[a * T] = zn;
          }
        }
      }

      // x_{k+1} = A x_k + B u_k + f
      float ax[kCx], bu[kCx];
      matvec(At, nx, nx, x, ax);
      matvec(Bt, nx, nu, u, bu);
#pragma unroll
      for (int j = 0; j < kCx; ++j)
        x[j] = j < nx ? __fadd_rn(__fadd_rn(ax[j], bu[j]), fv[j]) : 0.0f;
    }

    // termination: the dual residuals against the previous slacks, times rho
    const bool pass = ps < p.pri_tol && pi < p.pri_tol &&
                      __fmul_rn(ds, rho) < p.dua_tol &&
                      __fmul_rn(di, rho) < p.dua_tol;
    if (pass && (i + 1) % p.ct == 0) {  // latch: v, z hold this iteration's
      n_iter = i + 1;                   // slacks, which are the solution
      ok = 1;
      break;
    }

    // Backward recursion; q_k, r_k recomputed from the slacks and duals.
    float pv[kCx];
    {
      const float* pN = smem + L.pNref;
      const float* vN = v + (N - 1) * nx * T;
      const float* gN = g + (N - 1) * nx * T;
#pragma unroll
      for (int j = 0; j < kCx; ++j) {
        pv[j] = 0.0f;
        if (j < nx) {
          const float w = kStateFree ? vN[j * T]
                                     : __fsub_rn(vN[j * T], gN[j * T]);
          pv[j] = __fsub_rn(pN[j], __fmul_rn(rho, w));
        }
      }
    }
    for (int k = N - 2; k >= 0; --k) {
      float r[kCu], s[kCu], dn[kCu];
      const float* rref = smem + L.rref + k * nu;
      const float* zk = z + k * nu * T;
      const float* yk = y + k * nu * T;
      matvec(BTt, nu, nx, pv, s);
#pragma unroll
      for (int a = 0; a < kCu; ++a) {
        r[a] = 0.0f;
        if (a < nu) {
          r[a] = __fsub_rn(
              rref[a], __fmul_rn(rho, __fsub_rn(zk[a * T], yk[a * T])));
          s[a] = __fadd_rn(s[a], r[a]);
        } else {
          s[a] = 0.0f;
        }
      }
      matvec(Quut, nu, nu, s, dn);
      float* dk = d + k * nu * T;
#pragma unroll
      for (int a = 0; a < kCu; ++a)
        if (a < nu) dk[a * T] = dn[a];

      float ap[kCx], kr[kCx];
      matvec(Amt, nx, nx, pv, ap);
      matvec(KTt, nx, nu, r, kr);
      const float* qref = smem + L.qref + k * nx;
      const float* vk = v + k * nx * T;
      const float* gk = g + k * nx * T;
#pragma unroll
      for (int j = 0; j < kCx; ++j) {
        if (j < nx) {
          const float w = kStateFree ? vk[j * T]
                                     : __fsub_rn(vk[j * T], gk[j * T]);
          const float q = __fsub_rn(qref[j], __fmul_rn(rho, w));
          pv[j] = __fsub_rn(__fadd_rn(q, ap[j]), kr[j]);
        }
      }
    }
  }

  // a latched lane's slacks froze on its converging iteration; a lane that
  // never passed reports its last ones
  for (int r = 0; r < sx; ++r) p.xout[r * B + lane] = v[r * T];
  for (int r = 0; r < su; ++r) p.uout[r * B + lane] = z[r * T];
  p.iters[lane] = n_iter;
  p.solved[lane] = ok;
}

template <bool kStateFree>
void (*pick_kernel(int nx, int nu))(Params) {
  if (nx == 4 && nu == 1) return fused_stage_kernel<4, 1, kStateFree>;
  if (nx == 6 && nu == 3) return fused_stage_kernel<6, 3, kStateFree>;
  if (nx == 12 && nu == 4) return fused_stage_kernel<12, 4, kStateFree>;
  return fused_stage_kernel<0, 0, kStateFree>;
}

}  // namespace

extern "C" int tinympc_fused_stage(const float* consts, int n_consts,
                                   const float* x0, float* xout, float* uout,
                                   int* iters, int* solved, int nx, int nu,
                                   int N, int B, int max_iter, int ct,
                                   float pri_tol, float dua_tol,
                                   int en_input_bound, int en_state_bound,
                                   int tile, int smem_bytes, void* stream) {
  if (nx < 1 || nu < 1 || nx > kMaxDim || nu > kMaxDim || N < 2 || B < 1 ||
      max_iter < 0 || ct < 1 || tile < 1 || tile > 1024 || smem_bytes < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool state_free = !en_state_bound;
  // the caller owns the layout; refuse one the kernel would overrun
  const Layout L = consts_layout(nx, nu, N, !state_free);
  const size_t lane_floats = static_cast<size_t>(state_free ? 1 : 2) * N * nx +
                             3 * static_cast<size_t>(N - 1) * nu;
  const size_t need = sizeof(float) * (L.total + lane_floats * tile);
  if (n_consts != L.total || static_cast<size_t>(smem_bytes) < need)
    return static_cast<int>(cudaErrorInvalidValue);

  Params p;
  p.consts = consts; p.x0 = x0; p.xout = xout; p.uout = uout;
  p.iters = iters; p.solved = solved;
  p.nx = nx; p.nu = nu; p.N = N; p.B = B; p.max_iter = max_iter; p.ct = ct;
  p.en_input_bound = en_input_bound;
  p.pri_tol = pri_tol; p.dua_tol = dua_tol;

  void (*kernel)(Params) =
      state_free ? pick_kernel<true>(nx, nu) : pick_kernel<false>(nx, nu);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(B + tile - 1) / tile, tile, static_cast<size_t>(smem_bytes),
           static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
