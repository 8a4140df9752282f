// Fixed-rho condensed ADMM with box, linear and cone constraints: the whole
// solve of a tile of lanes in one kernel launch (kernel K1 of the port, with
// its projections K1e).
//
// Replaces: tinympc_julia_tpu/ops/pallas/condensed_kernel.py,
//   make_condensed_fused_solver (the pl.pallas_call kernel): cold/warm
//   start, carry output, check_termination, over-relaxation, the state-free
//   specialisation, the per-stage cyclic halfspace and scaled-SOC
//   projections (apply_lin, apply_soc), the group grid (num_groups: G
//   distinct problems, each block lanes of one group) and the
//   reduced-precision product (precision, bf16_head_iters).
//
// Per lane and iteration the work is one fused matvec
//   ux = T12w @ w2 + uxc          (sw x sw, sw = (N-1)*nu + N*nx)
// plus O(sw) elementwise work (relaxation, projections, duals, residuals).
// For the cartpole (sw = 99) that is 2*sw^2 ~ 19.6k fp32 FLOP per lane and
// iteration against on-chip traffic only: T12 (sw x sw floats) is read by
// every lane of every iteration, so what bounds the kernel is how fast the
// SM can feed T12 and the lane's iterate to its FMA units, not device memory.
//
// What this simple design does about it:
//  * One thread owns one lane and runs that lane's whole iteration loop.
//    Lanes never exchange data, so no block-wide barrier is needed after the
//    prologue: a thread leaves its loop when its lane latches (the Pallas
//    kernel's "all lanes of the tile converged" exit, taken per lane; a
//    latched lane's state is frozen, so the result is the same).
//  * T12 is staged once per block into shared memory, transposed and padded
//    to a multiple of 8 rows, so one k step of a block of 8 output rows is
//    two 16-byte broadcast loads (all threads read the same address) and
//    eight FMAs on register accumulators.  Where T12 does not fit in shared
//    memory (the quadrotor's 316 x 316), it is read through the same code
//    from global memory, where L2 holds it.
//  * The lane's w2 iterate lives in shared memory, column-major over the
//    tile ([row][lane]) so the threads of a warp touch consecutive banks;
//    it is double-buffered (current / next), and a lane that latches simply
//    keeps its current buffer (w2 freezes on the converging iteration).
//  * The rest of the lane's state (uxc, y, g, the v/z slacks that double as
//    the x/u outputs, the carry) is in the (dim, B) global layout the Python
//    side uses, read and written once per row per iteration, coalesced.
//  * The elementwise part of an iteration (relaxation, the box, halfspace
//    and cone projections, residuals, dual ascent), in round-to-nearest
//    arithmetic and the plain version's order of operations, is
//    projections.cuh, shared with the adaptive kernel.
//
//  * Group grid: the grid is (tiles per group, G).  A block reads its
//    group's T12, rollout columns, rho, bounds and constraint data by a
//    group offset into G-stacked arrays (offset 0 where an array is shared)
//    and stages its own group's T12; the last tile of every group is ragged
//    and masked.  Lanes keep the flat order lane = g * L + l.
//  * Reduced precision: on a reduced iteration the product is that of one
//    bf16 pass, both operands rounded to bf16 (round to nearest even) and
//    the products summed in fp32 in the same index order.  The rounded T12
//    is a second array (fp32 values that are exact bf16, made once by the
//    wrapper) staged beside the fp32 one; w2 is rounded as it is read.  The
//    first k0 iterations (the head) are reduced, and all of them with
//    lo_all; an iteration that runs the residual check always takes the
//    fp32 product, so what a lane latches is a true rollout of its iterate
//    and a true residual.  The head checks only on its last iteration.
//
// Launch contract: one thread per lane, blockDim.x = the lane tile chosen by
// the Python wrapper (fused_tile_plan), ragged last tile masked here.  The
// wrapper also owns the layout (T12's padded row count swp and the dynamic
// shared-memory size) and the constraint layout (counts, cone extents,
// stage widths); the entry point refuses one the kernel would overrun.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "projections.cuh"

namespace {

using namespace tinympc;

constexpr int kRowBlock = 8;

// x rounded to bf16 (round to nearest even), as an fp32 value.
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

struct Params {
  // the maps, with a leading group axis where map_grouped
  const float* t12t;  // (sw, swp) T12w transposed, rows padded to swp
  const float* t12lo; // the same rounded to bf16; null without reduced iters
  const float* t12c;  // (sw,)  fused-map constant column
  const float* tx0;   // (sw, nx) rollout map of x0
  const float* t1c;   // (sw,)  rollout constant column
  const float* rho;   // (1,) or (G,)
  const float* x0;    // (B, nx)
  const float* w2_in; // warm carry, (dim, B); null on a cold start
  const float* y_in;
  const float* g_in;
  const float* v_in;
  const float* z_in;
  float* xout;        // (sx, B) v slack / latched state output
  float* uout;        // (su, B) z slack / latched input output
  int* iters;         // (B,)
  int* solved;        // (B,)
  float* y;           // (su, B) input dual (also the carry's y)
  float* g;           // (sx, B) state dual (also the carry's g); generic path
  float* uxc;         // (sw, B) x0/const rollout (+ T12c after iteration 0)
  float* w2_out;      // (sw, B) carry outputs; null without carry_out
  float* vco;         // (sx, B)
  float* zco;         // (su, B)
  int nx, su, sx, sw, swp, B, L;  // B = G * L lanes, L in each group
  int max_iter, ct, k0, lo_all;
  float alpha, one_m_alpha, pri_tol, dua_tol;
  int state_free, warm_start, carry_out, t12_resident;
  int map_grouped, rho_grouped;
  Side side_u, side_x;
};

// ux = T12w @ w2 + uxc for one lane: blocks of 8 output rows, each k step
// two 16-byte loads of the transposed map and eight FMAs, every accumulator
// summed in index order over k.  kLo: the one-pass bf16 product (tm is the
// rounded map; w2 is rounded here; products and sums stay fp32).
template <bool kLo>
__device__ __forceinline__ void fused_matvec(
    const float* tm, const float* w2c, float* ux, const float* uxc, int sw,
    int swp, int T, int B, int lane) {
  for (int r0 = 0; r0 < sw; r0 += kRowBlock) {
    float acc[kRowBlock];
#pragma unroll
    for (int j = 0; j < kRowBlock; ++j) acc[j] = 0.0f;
    for (int k = 0; k < sw; ++k) {
      const float wk = kLo ? bf16_round(w2c[k * T]) : w2c[k * T];
      const float4* tk = reinterpret_cast<const float4*>(tm + k * swp + r0);
      const float4 a = tk[0];
      const float4 b = tk[1];
      acc[0] = fmaf(a.x, wk, acc[0]);
      acc[1] = fmaf(a.y, wk, acc[1]);
      acc[2] = fmaf(a.z, wk, acc[2]);
      acc[3] = fmaf(a.w, wk, acc[3]);
      acc[4] = fmaf(b.x, wk, acc[4]);
      acc[5] = fmaf(b.y, wk, acc[5]);
      acc[6] = fmaf(b.z, wk, acc[6]);
      acc[7] = fmaf(b.w, wk, acc[7]);
    }
#pragma unroll
    for (int j = 0; j < kRowBlock; ++j) {
      const int r = r0 + j;
      if (r < sw) ux[r * T] = __fadd_rn(acc[j], uxc[r * B + lane]);
    }
  }
}

// kProjU/kProjX: whether the input/state side has halfspaces or cones.
template <bool kProjU, bool kProjX>
__global__ void condensed_fused_kernel(Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int g = blockIdx.y;
  const int l = blockIdx.x * T + tid;  // index in the group
  const int lane = g * p.L + l;
  const int sw = p.sw, su = p.su, sx = p.sx, swp = p.swp, B = p.B;

  // this block's group's maps
  const int gm = p.map_grouped ? g : 0;
  const float* t12 = p.t12t + static_cast<size_t>(gm) * sw * swp;
  const float* t12lo =
      p.t12lo ? p.t12lo + static_cast<size_t>(gm) * sw * swp : nullptr;
  const float* t12c = p.t12c + gm * sw;
  const float* tx0 = p.tx0 + gm * sw * p.nx;
  const float* t1c = p.t1c + gm * sw;
  const float rho = p.rho[p.rho_grouped ? g : 0];
  float* w2s = smem;
  if (p.t12_resident) {
    const int n = sw * swp;
    for (int e = tid; e < n; e += T) smem[e] = t12[e];
    t12 = smem;
    w2s = smem + n;
    if (t12lo) {
      for (int e = tid; e < n; e += T) w2s[e] = t12lo[e];
      t12lo = w2s;
      w2s += n;
    }
  }
  __syncthreads();
  if (l >= p.L) return;

  // this lane's two w2 buffers: element r of buffer b at w2s[(b*sw + r)*T + tid]
  float* w2buf = w2s + tid;
  const bool state_free = p.state_free;
  const bool relax = p.alpha != 1.0f;

  // init: uxc = Tx0 @ x0 + T1c
  for (int r = 0; r < sw; ++r) {
    float acc = 0.0f;
    for (int j = 0; j < p.nx; ++j)
      acc = fmaf(tx0[r * p.nx + j], p.x0[lane * p.nx + j], acc);
    p.uxc[r * B + lane] = __fadd_rn(acc, t1c[r]);
  }
  if (p.warm_start) {
    for (int r = 0; r < sw; ++r) w2buf[r * T] = p.w2_in[r * B + lane];
    for (int r = 0; r < su; ++r) {
      p.y[r * B + lane] = p.y_in[r * B + lane];
      p.uout[r * B + lane] = p.z_in[r * B + lane];
    }
    for (int r = 0; r < sx; ++r) {
      if (!state_free) p.g[r * B + lane] = p.g_in[r * B + lane];
      p.xout[r * B + lane] = p.v_in[r * B + lane];
    }
  } else {
    for (int r = 0; r < sw; ++r) w2buf[r * T] = 0.0f;
    for (int r = 0; r < su; ++r) {
      p.y[r * B + lane] = 0.0f;
      p.uout[r * B + lane] = 0.0f;
    }
    for (int r = 0; r < sx; ++r) {
      if (!state_free) p.g[r * B + lane] = 0.0f;
      p.xout[r * B + lane] = 0.0f;
    }
  }
  if (p.carry_out) {
    // the carry's v/z freeze before the converging iteration, the outputs
    // take that iteration's vnew/znew: two buffers
    for (int r = 0; r < su; ++r) p.zco[r * B + lane] = p.uout[r * B + lane];
    for (int r = 0; r < sx; ++r) p.vco[r * B + lane] = p.xout[r * B + lane];
  }
  p.iters[lane] = p.max_iter;
  p.solved[lane] = 0;

  int cur = 0;
  for (int i = 0; i < p.max_iter; ++i) {
    const float* w2c = w2buf + cur * sw * T;
    float* ux = w2buf + (cur ^ 1) * sw * T;  // ux, then the next w2, in place
    // the head checks on its last iteration only; a checking iteration's
    // product is never reduced
    const bool check = i < p.k0 ? i == p.k0 - 1 : (i + 1) % p.ct == 0;
    const bool lo = (i < p.k0 || p.lo_all) && !check;

    if (i == 0 && !p.warm_start) {
      // cold iteration 0: d = 0, so ux is the pure rollout (no matmul);
      // the fused-map constant joins uxc only after it
      for (int r = 0; r < sw; ++r) {
        const float c = p.uxc[r * B + lane];
        ux[r * T] = c;
        p.uxc[r * B + lane] = __fadd_rn(c, t12c[r]);
      }
    } else {
      if (i == 0)  // warm start: every iteration replays the fused matmul
        for (int r = 0; r < sw; ++r)
          p.uxc[r * B + lane] = __fadd_rn(p.uxc[r * B + lane], t12c[r]);
      if (lo)
        fused_matvec<true>(t12lo, w2c, ux, p.uxc, sw, swp, T, B, lane);
      else
        fused_matvec<false>(t12, w2c, ux, p.uxc, sw, swp, T, B, lane);
    }

    // residual/latch block only on checking iterations
    float* gdual = state_free ? nullptr : p.g;
    bool newly = false;
    if (check) {
      float pi = 0.0f, di = 0.0f, ps = 0.0f, ds = 0.0f;
      side_residuals<kProjU>(p, p.side_u, g, relax, ux, p.uout, p.y, lane, T,
                             pi, di);
      side_residuals<kProjX>(p, p.side_x, g, relax, ux + su * T, p.xout,
                             gdual, lane, T, ps, ds);
      newly = ps < p.pri_tol && pi < p.pri_tol &&
              __fmul_rn(ds, rho) < p.dua_tol &&
              __fmul_rn(di, rho) < p.dua_tol;
    }

    // slack, dual, output and carry updates (this lane has not latched
    // before, so the dual update is unmasked)
    const bool carry = p.carry_out && !newly;
    side_update<kProjU>(p, p.side_u, g, relax, ux, p.uout, p.y, p.zco, carry,
                        lane, T);
    side_update<kProjX>(p, p.side_x, g, relax, ux + su * T, p.xout, gdual,
                        p.vco, carry, lane, T);

    if (newly) {  // latch: the outputs hold vnew/znew, w2 stays frozen
      p.iters[lane] = i + 1;
      p.solved[lane] = 1;
      break;
    }
    cur ^= 1;
  }

  if (p.carry_out) {
    const float* w2c = w2buf + cur * sw * T;
    for (int r = 0; r < sw; ++r) p.w2_out[r * B + lane] = w2c[r * T];
  }
}

}  // namespace

extern "C" int tinympc_condensed_fused(
    const float* t12t, const float* t12lo, const float* t12c,
    const float* tx0, const float* t1c, const float* rho, const float* umin,
    const float* umax, const float* xmin, const float* xmax, const float* x0,
    const float* w2_in, const float* y_in, const float* g_in,
    const float* v_in, const float* z_in, float* xout, float* uout,
    int* iters, int* solved, float* y, float* g, float* uxc, float* w2_out,
    float* vco, float* zco, int nx, int nu, int N, int G, int L, int max_iter,
    int ct, int k0, int lo_all, float alpha, float one_m_alpha, float pri_tol,
    float dua_tol, int en_input_bound, int en_state_bound, int warm_start,
    int carry_out, int tile, int t12_resident, int swp, int smem_bytes,
    int map_grouped, int rho_grouped, int box_u_grouped, int box_x_grouped,
    const float* lin_u, int n_lin_u, const int* soc_u, const float* soc_mu_u,
    int n_soc_u, int lin_u_grouped, int mu_u_grouped, const float* lin_x,
    int n_lin_x, const int* soc_x, const float* soc_mu_x, int n_soc_x,
    int lin_x_grouped, int mu_x_grouped, void* stream) {
  // G groups of L lanes; the *_grouped flags say which arrays carry a
  // leading group axis.  lin_*: (n_lin, 2*dim + 1) device rows; soc_*: n_soc
  // (start, dim) pairs in host memory; soc_mu_*: (n_soc,) on the device
  Params p;
  p.t12t = t12t; p.t12lo = t12lo; p.t12c = t12c; p.tx0 = tx0; p.t1c = t1c;
  p.rho = rho; p.x0 = x0;
  p.w2_in = w2_in; p.y_in = y_in; p.g_in = g_in; p.v_in = v_in; p.z_in = z_in;
  p.xout = xout; p.uout = uout; p.iters = iters; p.solved = solved;
  p.y = y; p.g = g; p.uxc = uxc; p.w2_out = w2_out; p.vco = vco; p.zco = zco;
  p.nx = nx; p.su = (N - 1) * nu; p.sx = N * nx; p.sw = p.su + p.sx;
  p.swp = swp; p.B = G * L; p.L = L;
  p.max_iter = max_iter; p.ct = ct; p.k0 = k0; p.lo_all = lo_all;
  p.alpha = alpha; p.one_m_alpha = one_m_alpha;
  p.pri_tol = pri_tol; p.dua_tol = dua_tol;
  p.warm_start = warm_start; p.carry_out = carry_out;
  p.t12_resident = t12_resident;
  p.map_grouped = map_grouped; p.rho_grouped = rho_grouped;
  // no state-side constraint at all: g == 0 and vnew = x_hat
  p.state_free = !en_state_bound && n_lin_x == 0 && n_soc_x == 0;
  // the caller owns the layout; refuse one the kernel would overrun
  const bool reduced = k0 > 0 || lo_all;
  size_t need = sizeof(float) * 2 * static_cast<size_t>(p.sw) * tile;
  if (t12_resident)
    need += sizeof(float) * static_cast<size_t>(p.sw) * swp * (reduced ? 2 : 1);
  if (G <= 0 || L <= 0 || G > 65535 || tile <= 0 || ct < 1 || k0 < 0 ||
      k0 > max_iter || swp < p.sw || swp % kRowBlock != 0 || smem_bytes < 0 ||
      static_cast<size_t>(smem_bytes) < need || !rho ||
      (reduced && !t12lo))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!reduced) p.t12lo = nullptr;
  if (!init_side(p.side_u, umin, umax, lin_u, n_lin_u, soc_u, soc_mu_u,
                 n_soc_u, nu, N - 1, en_input_bound, box_u_grouped,
                 lin_u_grouped, mu_u_grouped) ||
      !init_side(p.side_x, xmin, xmax, lin_x, n_lin_x, soc_x, soc_mu_x,
                 n_soc_x, nx, N, en_state_bound, box_x_grouped, lin_x_grouped,
                 mu_x_grouped))
    return static_cast<int>(cudaErrorInvalidValue);

  const bool proj_u = n_lin_u + n_soc_u > 0, proj_x = n_lin_x + n_soc_x > 0;
  void (*kernel)(Params) =
      proj_u ? (proj_x ? condensed_fused_kernel<true, true>
                       : condensed_fused_kernel<true, false>)
             : (proj_x ? condensed_fused_kernel<false, true>
                       : condensed_fused_kernel<false, false>);
  const size_t smem = static_cast<size_t>(smem_bytes);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L + tile - 1) / tile, G);
  kernel<<<grid, tile, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
