// Fixed-rho, box-constrained condensed ADMM: the whole solve of a tile of
// lanes in one kernel launch (kernel K1 of the port).
//
// Replaces: tinympc_julia_tpu/ops/pallas/condensed_kernel.py,
//   make_condensed_fused_solver (the pl.pallas_call kernel), in its box-only,
//   single-group, full-fp32 form with cold/warm start, carry output,
//   check_termination, over-relaxation and the state-free specialisation.
//
// Per lane and iteration the work is one fused matvec
//   ux = T12w @ w2 + uxc          (sw x sw, sw = (N-1)*nu + N*nx)
// plus O(sw) elementwise work (relaxation, box clip, duals, residuals).
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
//  * Elementwise arithmetic uses explicit round-to-nearest intrinsics so the
//    compiler does not contract it into FMAs: the kernel then computes the
//    same operations, in the same order, as its plain PyTorch version.
//
// Launch contract: one thread per lane, blockDim.x = the lane tile chosen by
// the Python wrapper (fused_tile_plan), ragged last tile masked here.  The
// wrapper also owns the layout (T12's padded row count swp and the dynamic
// shared-memory size); the entry point refuses one the kernel would overrun.
#include <cuda_runtime.h>

namespace {

constexpr int kRowBlock = 8;

struct Params {
  const float* t12t;  // (sw, swp) T12w transposed, rows padded to swp
  const float* t12c;  // (sw,)  fused-map constant column
  const float* tx0;   // (sw, nx) rollout map of x0
  const float* t1c;   // (sw,)  rollout constant column
  const float* umin;  // (su,)
  const float* umax;
  const float* xmin;  // (sx,)
  const float* xmax;
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
  int nx, su, sx, sw, swp, B;
  int max_iter, ct;
  float rho, alpha, one_m_alpha, pri_tol, dua_tol;
  int en_input_bound, en_state_bound, warm_start, carry_out, t12_resident;
};

__global__ void condensed_fused_kernel(Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = blockIdx.x * T + tid;
  const int sw = p.sw, su = p.su, sx = p.sx, swp = p.swp, B = p.B;

  const float* t12 = p.t12t;
  float* w2s = smem;
  if (p.t12_resident) {
    const int n = sw * swp;
    for (int e = tid; e < n; e += T) smem[e] = p.t12t[e];
    t12 = smem;
    w2s = smem + n;
  }
  __syncthreads();
  if (lane >= B) return;

  // this lane's two w2 buffers: element r of buffer b at w2s[(b*sw + r)*T + tid]
  float* w2buf = w2s + tid;
  const bool state_free = !p.en_state_bound;
  const bool relax = p.alpha != 1.0f;

  // init: uxc = Tx0 @ x0 + T1c
  for (int r = 0; r < sw; ++r) {
    float acc = 0.0f;
    for (int j = 0; j < p.nx; ++j)
      acc = fmaf(p.tx0[r * p.nx + j], p.x0[lane * p.nx + j], acc);
    p.uxc[r * B + lane] = __fadd_rn(acc, p.t1c[r]);
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

    if (i == 0 && !p.warm_start) {
      // cold iteration 0: d = 0, so ux is the pure rollout (no matmul);
      // the fused-map constant joins uxc only after it
      for (int r = 0; r < sw; ++r) {
        const float c = p.uxc[r * B + lane];
        ux[r * T] = c;
        p.uxc[r * B + lane] = __fadd_rn(c, p.t12c[r]);
      }
    } else {
      if (i == 0)  // warm start: every iteration replays the fused matmul
        for (int r = 0; r < sw; ++r)
          p.uxc[r * B + lane] = __fadd_rn(p.uxc[r * B + lane], p.t12c[r]);
      for (int r0 = 0; r0 < sw; r0 += kRowBlock) {
        float acc[kRowBlock];
#pragma unroll
        for (int j = 0; j < kRowBlock; ++j) acc[j] = 0.0f;
        for (int k = 0; k < sw; ++k) {
          const float wk = w2c[k * T];
          const float4* tk = reinterpret_cast<const float4*>(t12 + k * swp + r0);
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
          if (r < sw) ux[r * T] = __fadd_rn(acc[j], p.uxc[r * B + lane]);
        }
      }
    }

    // residual/latch block only on the last iteration of each ct group
    bool newly = false;
    if ((i + 1) % p.ct == 0) {
      float pi = 0.0f, di = 0.0f, ps = 0.0f, ds = 0.0f;
      for (int r = 0; r < su; ++r) {
        const int o = r * B + lane;
        const float u = ux[r * T], z = p.uout[o];
        const float uh = relax ? __fadd_rn(__fmul_rn(p.alpha, u),
                                           __fmul_rn(p.one_m_alpha, z)) : u;
        float zn = __fadd_rn(uh, p.y[o]);
        if (p.en_input_bound) zn = fminf(p.umax[r], fmaxf(p.umin[r], zn));
        pi = fmaxf(pi, fabsf(__fsub_rn(u, zn)));
        di = fmaxf(di, fabsf(__fsub_rn(z, zn)));
      }
      for (int r = 0; r < sx; ++r) {
        const int o = r * B + lane;
        const float x = ux[(su + r) * T], v = p.xout[o];
        const float xh = relax ? __fadd_rn(__fmul_rn(p.alpha, x),
                                           __fmul_rn(p.one_m_alpha, v)) : x;
        float vn = xh;
        if (!state_free) {
          vn = __fadd_rn(xh, p.g[o]);
          vn = fminf(p.xmax[r], fmaxf(p.xmin[r], vn));
        }
        ps = fmaxf(ps, fabsf(__fsub_rn(x, vn)));
        ds = fmaxf(ds, fabsf(__fsub_rn(v, vn)));
      }
      newly = ps < p.pri_tol && pi < p.pri_tol &&
              __fmul_rn(ds, p.rho) < p.dua_tol &&
              __fmul_rn(di, p.rho) < p.dua_tol;
    }

    // slack, dual, output and carry updates (this lane has not latched
    // before, so the dual update is unmasked)
    const bool carry = p.carry_out && !newly;
    for (int r = 0; r < su; ++r) {
      const int o = r * B + lane;
      const float u = ux[r * T], z = p.uout[o], y = p.y[o];
      const float uh = relax ? __fadd_rn(__fmul_rn(p.alpha, u),
                                         __fmul_rn(p.one_m_alpha, z)) : u;
      float zn = __fadd_rn(uh, y);
      if (p.en_input_bound) zn = fminf(p.umax[r], fmaxf(p.umin[r], zn));
      const float yn = __fsub_rn(__fadd_rn(y, uh), zn);
      p.y[o] = yn;
      p.uout[o] = zn;
      if (carry) p.zco[o] = zn;
      ux[r * T] = __fsub_rn(zn, yn);
    }
    for (int r = 0; r < sx; ++r) {
      const int o = r * B + lane;
      const float x = ux[(su + r) * T], v = p.xout[o];
      const float xh = relax ? __fadd_rn(__fmul_rn(p.alpha, x),
                                         __fmul_rn(p.one_m_alpha, v)) : x;
      float vn = xh;
      float w = xh;  // state-free: g == 0, vnew = x_hat, w2 = vnew
      if (!state_free) {
        const float g = p.g[o];
        vn = fminf(p.xmax[r], fmaxf(p.xmin[r], __fadd_rn(xh, g)));
        const float gn = __fsub_rn(__fadd_rn(g, xh), vn);
        p.g[o] = gn;
        w = __fsub_rn(vn, gn);
      }
      p.xout[o] = vn;
      if (carry) p.vco[o] = vn;
      ux[(su + r) * T] = w;
    }

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
    const float* t12t, const float* t12c, const float* tx0, const float* t1c,
    const float* umin, const float* umax, const float* xmin, const float* xmax,
    const float* x0, const float* w2_in, const float* y_in, const float* g_in,
    const float* v_in, const float* z_in, float* xout, float* uout,
    int* iters, int* solved, float* y, float* g, float* uxc, float* w2_out,
    float* vco, float* zco, int nx, int nu, int N, int B, int max_iter,
    int ct, float rho, float alpha, float one_m_alpha, float pri_tol,
    float dua_tol, int en_input_bound, int en_state_bound, int warm_start,
    int carry_out, int tile, int t12_resident, int swp, int smem_bytes,
    void* stream) {
  Params p;
  p.t12t = t12t; p.t12c = t12c; p.tx0 = tx0; p.t1c = t1c;
  p.umin = umin; p.umax = umax; p.xmin = xmin; p.xmax = xmax; p.x0 = x0;
  p.w2_in = w2_in; p.y_in = y_in; p.g_in = g_in; p.v_in = v_in; p.z_in = z_in;
  p.xout = xout; p.uout = uout; p.iters = iters; p.solved = solved;
  p.y = y; p.g = g; p.uxc = uxc; p.w2_out = w2_out; p.vco = vco; p.zco = zco;
  p.nx = nx; p.su = (N - 1) * nu; p.sx = N * nx; p.sw = p.su + p.sx;
  p.swp = swp; p.B = B;
  p.max_iter = max_iter; p.ct = ct;
  p.rho = rho; p.alpha = alpha; p.one_m_alpha = one_m_alpha;
  p.pri_tol = pri_tol; p.dua_tol = dua_tol;
  p.en_input_bound = en_input_bound; p.en_state_bound = en_state_bound;
  p.warm_start = warm_start; p.carry_out = carry_out;
  p.t12_resident = t12_resident;
  // the caller owns the layout; refuse one the kernel would overrun
  size_t need = sizeof(float) * 2 * static_cast<size_t>(p.sw) * tile;
  if (t12_resident) need += sizeof(float) * static_cast<size_t>(p.sw) * swp;
  if (B <= 0 || tile <= 0 || ct < 1 || swp < p.sw || swp % kRowBlock != 0 ||
      smem_bytes < 0 || static_cast<size_t>(smem_bytes) < need)
    return static_cast<int>(cudaErrorInvalidValue);

  const size_t smem = static_cast<size_t>(smem_bytes);
  cudaError_t err = cudaFuncSetAttribute(
      condensed_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + tile - 1) / tile;
  condensed_fused_kernel<<<blocks, tile, smem,
                           static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
