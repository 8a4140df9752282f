// Fixed-rho condensed ADMM with box, linear and cone constraints: the whole
// solve of a tile of lanes in one kernel launch (kernel K1 of the port, with
// its projections K1e).
//
// Replaces: tinympc_julia_tpu/ops/pallas/condensed_kernel.py,
//   make_condensed_fused_solver (the pl.pallas_call kernel), in its
//   single-group, full-fp32 form with cold/warm start, carry output,
//   check_termination, over-relaxation, the state-free specialisation, and
//   the per-stage cyclic halfspace and scaled-SOC projections (apply_lin,
//   apply_soc).
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
//  * Elementwise arithmetic uses explicit round-to-nearest intrinsics so the
//    compiler does not contract it into FMAs: the kernel then computes the
//    same operations, in the same order, as its plain PyTorch version.
//  * The projections couple the rows of one stage (a halfspace all of them,
//    a cone its own), so both passes over a side walk it stage by stage: a
//    projected side loads the stage's slack into a per-thread buffer of
//    kMaxStage floats, clips it to the box, applies each halfspace row in
//    order and then each cone, and only then takes the residuals (first
//    pass) or writes the updates (second pass, which recomputes the stage
//    exactly as the first did: the latch is known only after all stages).
//    The halfspace rows (a, a/||a||^2, b) and the cones' mu are small device
//    arrays read through the cache by every thread alike; the cones'
//    (start, dim) pairs ride in the kernel's parameters.  A side without
//    projections keeps the row-by-row arithmetic of the box path.
//
// Launch contract: one thread per lane, blockDim.x = the lane tile chosen by
// the Python wrapper (fused_tile_plan), ragged last tile masked here.  The
// wrapper also owns the layout (T12's padded row count swp and the dynamic
// shared-memory size) and the constraint layout (counts, cone extents,
// stage widths); the entry point refuses one the kernel would overrun.
#include <cuda_runtime.h>

namespace {

constexpr int kRowBlock = 8;
constexpr int kMaxStage = 12;  // widest projected stage (every plant: nx <= 12)
constexpr int kMaxCones = 8;   // cones per side

// One side (inputs or states) of the slack update.
struct Side {
  const float* wmin;  // (rows,) box
  const float* wmax;
  const float* lin;   // (n_lin, 2*dim + 1): a, a/||a||^2, b of each row
  const float* mu;    // (n_soc,)
  int cone_start[kMaxCones];
  int cone_dim[kMaxCones];
  int dim, n_stages, n_lin, n_soc, en_box;
};

struct Params {
  const float* t12t;  // (sw, swp) T12w transposed, rows padded to swp
  const float* t12c;  // (sw,)  fused-map constant column
  const float* tx0;   // (sw, nx) rollout map of x0
  const float* t1c;   // (sw,)  rollout constant column
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
  int state_free, warm_start, carry_out, t12_resident;
  Side side_u, side_x;
};

__device__ __forceinline__ float relaxed(const Params& p, bool relax, float w,
                                         float prev) {
  return relax ? __fadd_rn(__fmul_rn(p.alpha, w), __fmul_rn(p.one_m_alpha,
                                                            prev))
               : w;
}

// The slack of row r before the linear and cone projections: w_hat + dual
// (dual null: the state-free path, g == 0), clipped to the box.
__device__ __forceinline__ float row_slack(const Side& s, int r, float wh,
                                           const float* dual, int o) {
  float v = dual ? __fadd_rn(wh, dual[o]) : wh;
  if (s.en_box) v = fminf(s.wmax[r], fmaxf(s.wmin[r], v));
  return v;
}

// The projected slack of stage k: the box, then each halfspace row in order
// (w -= max(a.w - b, 0) a/||a||^2, the dot product summed in index order),
// then each cone (projections._project_soc_scaled), in the plain version's
// order of operations.
__device__ __forceinline__ void stage_slack(
    const Params& p, const Side& s, int k, bool relax, const float* ux,
    const float* prev, const float* dual, int lane, int T, float* w) {
  const int dim = s.dim;
  for (int j = 0; j < dim; ++j) {
    const int r = k * dim + j, o = r * p.B + lane;
    w[j] = row_slack(s, r, relaxed(p, relax, ux[r * T], prev[o]), dual, o);
  }
  for (int h = 0; h < s.n_lin; ++h) {
    const float* row = s.lin + h * (2 * dim + 1);
    float dot = __fmul_rn(w[0], __ldg(row));
    for (int d = 1; d < dim; ++d)
      dot = __fadd_rn(dot, __fmul_rn(w[d], __ldg(row + d)));
    const float viol = fmaxf(__fsub_rn(dot, __ldg(row + 2 * dim)), 0.0f);
    for (int d = 0; d < dim; ++d)
      w[d] = __fsub_rn(w[d], __fmul_rn(viol, __ldg(row + dim + d)));
  }
  for (int c = 0; c < s.n_soc; ++c) {
    float* seg = w + s.cone_start[c];
    const int last = s.cone_dim[c] - 1;
    const float mu = __ldg(s.mu + c);
    float sq = __fmul_rn(seg[0], seg[0]);
    for (int d = 1; d < last; ++d)
      sq = __fadd_rn(sq, __fmul_rn(seg[d], seg[d]));
    const float a = __fsqrt_rn(sq);
    const float u0 = __fmul_rn(seg[last], mu);
    if (a <= -u0) {  // below the cone: the origin
      for (int d = 0; d <= last; ++d) seg[d] = 0.0f;
    } else if (!(a <= u0)) {  // outside: onto the boundary
      const float factor = __fdiv_rn(__fadd_rn(a, u0),
                                     __fmul_rn(2.0f, fmaxf(a, 1e-30f)));
      for (int d = 0; d < last; ++d) seg[d] = __fmul_rn(factor, seg[d]);
      seg[last] = __fmul_rn(factor, __fdiv_rn(a, mu));
    }
  }
}

// Calls row(r, vnew_r) for every row r of one side, in order, with the
// row's new slack.  A projected side (kProj) goes stage by stage through
// stage_slack; a side with the box alone keeps the flat row loop of the
// box path, with no stage buffer.
template <bool kProj, class Row>
__device__ __forceinline__ void for_each_slack(
    const Params& p, const Side& s, bool relax, const float* ux,
    const float* prev, const float* dual, int lane, int T, Row row) {
  if constexpr (kProj) {
    for (int k = 0; k < s.n_stages; ++k) {
      float w[kMaxStage];
      stage_slack(p, s, k, relax, ux, prev, dual, lane, T, w);
      for (int j = 0; j < s.dim; ++j) row(k * s.dim + j, w[j]);
    }
  } else {
    const int rows = s.dim * s.n_stages;
    for (int r = 0; r < rows; ++r) {
      const int o = r * p.B + lane;
      row(r, row_slack(s, r, relaxed(p, relax, ux[r * T], prev[o]), dual, o));
    }
  }
}

// First pass over one side: the max-abs primal and dual residuals of the
// new slack against the iterate (pri) and the previous slack (dua).
template <bool kProj>
__device__ __forceinline__ void side_residuals(
    const Params& p, const Side& s, bool relax, const float* ux,
    const float* prev, const float* dual, int lane, int T, float& pri,
    float& dua) {
  for_each_slack<kProj>(p, s, relax, ux, prev, dual, lane, T,
                        [&](int r, float vn) {
    pri = fmaxf(pri, fabsf(__fsub_rn(ux[r * T], vn)));
    dua = fmaxf(dua, fabsf(__fsub_rn(prev[r * p.B + lane], vn)));
  });
}

// Second pass over one side: the new slack goes to the output (and the
// carry), the dual ascends, and the row's next-w2 entry (slack - dual)
// replaces its ux entry in place (a stage's entries are all read by
// stage_slack before the first is replaced).
template <bool kProj>
__device__ __forceinline__ void side_update(
    const Params& p, const Side& s, bool relax, float* ux, float* prev,
    float* dual, float* co, bool carry, int lane, int T) {
  for_each_slack<kProj>(p, s, relax, ux, prev, dual, lane, T,
                        [&](int r, float vn) {
    const int o = r * p.B + lane;
    const float wh = relaxed(p, relax, ux[r * T], prev[o]);
    float next = vn;  // state-free: g == 0, w2 = vnew
    if (dual) {
      const float dn = __fsub_rn(__fadd_rn(dual[o], wh), vn);
      dual[o] = dn;
      next = __fsub_rn(vn, dn);
    }
    prev[o] = vn;
    if (carry) co[o] = vn;
    ux[r * T] = next;
  });
}

// kProjU/kProjX: whether the input/state side has halfspaces or cones.
template <bool kProjU, bool kProjX>
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
  const bool state_free = p.state_free;
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
    float* gdual = state_free ? nullptr : p.g;
    bool newly = false;
    if ((i + 1) % p.ct == 0) {
      float pi = 0.0f, di = 0.0f, ps = 0.0f, ds = 0.0f;
      side_residuals<kProjU>(p, p.side_u, relax, ux, p.uout, p.y, lane, T,
                             pi, di);
      side_residuals<kProjX>(p, p.side_x, relax, ux + su * T, p.xout, gdual,
                             lane, T, ps, ds);
      newly = ps < p.pri_tol && pi < p.pri_tol &&
              __fmul_rn(ds, p.rho) < p.dua_tol &&
              __fmul_rn(di, p.rho) < p.dua_tol;
    }

    // slack, dual, output and carry updates (this lane has not latched
    // before, so the dual update is unmasked)
    const bool carry = p.carry_out && !newly;
    side_update<kProjU>(p, p.side_u, relax, ux, p.uout, p.y, p.zco, carry,
                        lane, T);
    side_update<kProjX>(p, p.side_x, relax, ux + su * T, p.xout, gdual, p.vco,
                        carry, lane, T);

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
    const float* lin_u, int n_lin_u, const int* soc_u, const float* soc_mu_u,
    int n_soc_u, const float* lin_x, int n_lin_x, const int* soc_x,
    const float* soc_mu_x, int n_soc_x, void* stream) {
  // lin_*: (n_lin, 2*dim + 1) device rows; soc_*: n_soc (start, dim) pairs
  // in host memory; soc_mu_*: (n_soc,) on the device
  Params p;
  p.t12t = t12t; p.t12c = t12c; p.tx0 = tx0; p.t1c = t1c; p.x0 = x0;
  p.w2_in = w2_in; p.y_in = y_in; p.g_in = g_in; p.v_in = v_in; p.z_in = z_in;
  p.xout = xout; p.uout = uout; p.iters = iters; p.solved = solved;
  p.y = y; p.g = g; p.uxc = uxc; p.w2_out = w2_out; p.vco = vco; p.zco = zco;
  p.nx = nx; p.su = (N - 1) * nu; p.sx = N * nx; p.sw = p.su + p.sx;
  p.swp = swp; p.B = B;
  p.max_iter = max_iter; p.ct = ct;
  p.rho = rho; p.alpha = alpha; p.one_m_alpha = one_m_alpha;
  p.pri_tol = pri_tol; p.dua_tol = dua_tol;
  p.warm_start = warm_start; p.carry_out = carry_out;
  p.t12_resident = t12_resident;
  // no state-side constraint at all: g == 0 and vnew = x_hat
  p.state_free = !en_state_bound && n_lin_x == 0 && n_soc_x == 0;
  // the caller owns the layout; refuse one the kernel would overrun
  size_t need = sizeof(float) * 2 * static_cast<size_t>(p.sw) * tile;
  if (t12_resident) need += sizeof(float) * static_cast<size_t>(p.sw) * swp;
  if (B <= 0 || tile <= 0 || ct < 1 || swp < p.sw || swp % kRowBlock != 0 ||
      smem_bytes < 0 || static_cast<size_t>(smem_bytes) < need)
    return static_cast<int>(cudaErrorInvalidValue);
  const struct {
    Side* side; const float* wmin; const float* wmax; const float* lin;
    int n_lin; const int* soc; const float* mu; int n_soc; int dim;
    int n_stages; int en_box;
  } sides[2] = {
      {&p.side_u, umin, umax, lin_u, n_lin_u, soc_u, soc_mu_u, n_soc_u, nu,
       N - 1, en_input_bound},
      {&p.side_x, xmin, xmax, lin_x, n_lin_x, soc_x, soc_mu_x, n_soc_x, nx, N,
       en_state_bound}};
  for (const auto& d : sides) {
    Side& s = *d.side;
    s.wmin = d.wmin; s.wmax = d.wmax; s.lin = d.lin; s.mu = d.mu;
    s.dim = d.dim; s.n_stages = d.n_stages; s.n_lin = d.n_lin;
    s.n_soc = d.n_soc; s.en_box = d.en_box;
    if (d.n_lin < 0 || d.n_soc < 0 || d.n_soc > kMaxCones ||
        (d.n_lin > 0 && d.lin == nullptr) ||
        (d.n_soc > 0 && (d.soc == nullptr || d.mu == nullptr)) ||
        (d.n_lin + d.n_soc > 0 && d.dim > kMaxStage))
      return static_cast<int>(cudaErrorInvalidValue);
    for (int c = 0; c < kMaxCones; ++c) {
      s.cone_start[c] = c < d.n_soc ? d.soc[2 * c] : 0;
      s.cone_dim[c] = c < d.n_soc ? d.soc[2 * c + 1] : 0;
      if (c < d.n_soc && (s.cone_start[c] < 0 || s.cone_dim[c] < 2 ||
                          s.cone_start[c] + s.cone_dim[c] > d.dim))
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }

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
  const int blocks = (B + tile - 1) / tile;
  kernel<<<blocks, tile, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
