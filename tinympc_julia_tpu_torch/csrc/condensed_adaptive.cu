// Condensed ADMM with per-lane adaptive rho: the whole solve of a tile of
// lanes in one kernel launch (kernel K2 of the port).
//
// Replaces: tinympc_julia_tpu/ops/pallas/adaptive_kernel.py,
//   make_condensed_adaptive_fused_solver (the pl.pallas_call kernel), in
//   full fp32: both rho controllers (the reference's OSQP-form one and the
//   termination-residual one with its deadband, step cap and Taylor trust
//   clip), cold/warm start, carry output, check_termination,
//   over-relaxation, the state-free specialisation, the box, halfspace and
//   cone projections, and the group grid (num_groups: G distinct problems,
//   each block lanes of one group).
//
// Per lane and iteration the work is two matvecs against maps shared by all
// lanes, each combined per lane in drho = rho_lane - rho0:
//   forward   ux = sum_k drho^k (T1_k @ [d; x0; 1])       (o+1 blocks, Horner)
//   backward  d' = (T2_0 + drho T2_1 + drho' T2_2 + drho drho' T2_3)
//                  @ [znew - y; vnew - g; 1]               (drho' after update)
// plus O(sw) elementwise work and, every 5th iteration, the rho prediction.
// At the quadrotor (sw = 316, su = 76, order 2) that is 2*(3*316*89 +
// 4*76*317) ~ 361k fp32 FLOP per lane-iteration against on-chip traffic
// only: the maps (337 KB + 385 KB) are read by every lane of every
// iteration, so what bounds the kernel is how fast an SM can feed the maps
// and the lane's iterate to its FMA units, not device memory.
//
// What this simple design does about it:
//  * One thread owns one lane and runs that lane's whole loop; lanes never
//    exchange data, so there is no block-wide barrier after the prologue,
//    and a thread leaves its loop when its lane latches (a latched lane's
//    state is frozen, so this equals the Pallas kernel's masked updates).
//  * The stacked intermediates R1 = T1s @ vec1 and R2 = T2s @ vec2 of the
//    Pallas body are never formed: a block of 32 output rows keeps o+1 (4
//    for the backward map) accumulators per row over one k loop and combines
//    them at once, in round-to-nearest arithmetic and the plain version's
//    order (Horner; the bilinear sum left to right).
//  * Both maps are stored transposed with their rows padded to a multiple of
//    32, so one k step of a row block is 8 broadcast 16-byte loads per
//    coefficient block (one 128-byte line).  Where both maps fit in shared
//    memory beside the lanes' iterates (the cartpole) they are staged there
//    once per block; otherwise (the quadrotor) they are read from global
//    memory, where L2 holds them.
//  * The lane's vec1 = [d; x0; 1] and its iterate ux (which the second pass
//    turns in place into vec2 = [znew - y; vnew - g], with a constant 1
//    behind it) live in shared memory, column-major over the tile
//    ([row][lane]); the rest of the lane's state (y, g, the v/z slacks that
//    double as the x/u outputs, the carry) is in the (dim, B) global layout
//    the Python side uses, read and written once per row per iteration.
//  * The elementwise part (relaxation, projections, residuals, dual ascent)
//    is projections.cuh, shared with condensed_fused.cu.
//  * The OSQP-form residuals are block-structured (dynamics rows A x_i +
//    B u_i - x_{i+1}, the A^T g terms, diagonal costs, the Taylor terminal
//    cost P0 + drho dP): they are computed stage by stage from A, B, the
//    cost diagonals, P0 and dP, not by the dense Dx/Du/Gx/Gu contractions
//    the Pallas kernel feeds its matrix unit.  The pass runs before the
//    second pass (it needs ux intact), so it recomputes each stage's new
//    slack and dual exactly as the second pass will.
//
//  * Group grid: the grid is (tiles per group, G).  A block reads its
//    group's Taylor maps, expansion centre rho0 and trust bounds, box
//    bounds, constraint data and (for the OSQP-form controller) plant data
//    by a group offset into G-stacked arrays (offset 0 where an array is
//    shared); the last tile of every group is ragged and masked; lanes keep
//    the flat order lane = g * L + l, and rho stays per lane.
//
// Launch contract: one thread per lane, blockDim.x = the lane tile chosen by
// the Python wrapper (adaptive_tile_plan), ragged last tile masked here.
// The wrapper owns the layout (padded row counts, residency, the dynamic
// shared-memory size); the entry point refuses one the kernel would overrun.
#include <cuda_runtime.h>

#include "projections.cuh"

namespace {

using namespace tinympc;

// Output rows a thread accumulates at once (a multiple of 4): 32, the
// fastest of 8, 16 and 32 at the quadrotor shape on an H100 (tune_k2.py,
// which overrides it at build time; the wrapper's K2_ROW_BLOCK must agree).
#ifndef TINYMPC_K2_ROWS
#define TINYMPC_K2_ROWS 32
#endif
constexpr int kRowBlock = TINYMPC_K2_ROWS;
constexpr int kRhoInterval = 5;
constexpr float kEps = 1e-10f;
constexpr float kDeadband = 5.0f;
constexpr float kMaxStep = 10.0f;

struct Params {
  // the maps and their expansion data, with a leading group axis where
  // map_grouped
  const float* t1t;   // (in1, ord1*swp): T1s transposed, [j][k*swp + r]
  const float* t2t;   // (sw+1, 4*sup): reduced T2s transposed, [k][c*sup + r]
  const float* rho0;      // (G,) expansion centre; more than one group only
  const float* trust_lo;  // (G,) rho0 -+ the Taylor trust radius
  const float* trust_hi;
  const float* x0;    // (B, nx)
  const float* d_in;  // warm carry, (dim, B); null on a cold start
  const float* y_in;
  const float* g_in;
  const float* v_in;
  const float* z_in;
  const float* rho_in;  // (B,)
  float* xout;        // (sx, B) v slack / latched state output
  float* uout;        // (su, B) z slack / latched input output
  int* iters;         // (B,)
  int* solved;        // (B,)
  float* rho_out;     // (B,) the rho each lane ended on
  float* y;           // (su, B) input dual (also the carry's y)
  float* g;           // (sx, B) state dual (also the carry's g); generic path
  float* d_out;       // (su, B) carry outputs; null without carry_out
  float* vco;         // (sx, B)
  float* zco;         // (su, B)
  // the OSQP-form controller's plant data (null for the termination one),
  // with a leading group axis where plant_grouped
  const float* A;     // (nx, nx) row-major
  const float* Bm;    // (nx, nu)
  const float* qd;    // (nx,) rho-folded cost diagonals
  const float* rd;    // (nu,)
  const float* P0;    // (nx, nx) terminal cost and its rho sensitivity
  const float* dP;
  int nx, nu, N, su, sx, sw, swp, sup, in1, B, L;  // B = G * L lanes
  int max_iter, ct;
  float alpha, one_m_alpha, pri_tol, dua_tol;
  float rho_min, rho_max;
  float rho0_one, trust_lo_one, trust_hi_one;  // the same of a single group
  int osqp, clipping, trust;
  int state_free, warm_start, carry_out, resident;
  int map_grouped, plant_grouped;
  Side side_u, side_x;
};


// One k step of a matvec against kBlocks coefficient blocks at once: row j
// of block c accumulates t[c * block_stride + j] * w, each accumulator in
// index order over the k steps.
template <int kBlocks>
__device__ __forceinline__ void fma_rows(float (&acc)[kBlocks][kRowBlock],
                                         const float* t, int block_stride,
                                         float w) {
#pragma unroll
  for (int c = 0; c < kBlocks; ++c)
#pragma unroll
    for (int q = 0; q < kRowBlock / 4; ++q) {
      const float4 a =
          *reinterpret_cast<const float4*>(t + c * block_stride + 4 * q);
      acc[c][4 * q + 0] = fmaf(a.x, w, acc[c][4 * q + 0]);
      acc[c][4 * q + 1] = fmaf(a.y, w, acc[c][4 * q + 1]);
      acc[c][4 * q + 2] = fmaf(a.z, w, acc[c][4 * q + 2]);
      acc[c][4 * q + 3] = fmaf(a.w, w, acc[c][4 * q + 3]);
    }
}

// The new slack and the ascended dual of one stage of one side, as the
// second pass will compute them (the same functions, so the same bits).
__device__ __forceinline__ void stage_new(
    const Params& p, const Side& s, int g, int k, bool relax, const float* ux,
    const float* prev, const float* dual, int lane, int T, float* w,
    float* dn) {
  stage_slack(p, s, g, k, relax, ux, prev, dual, lane, T, w);
  for (int j = 0; j < s.dim; ++j) {
    const int r = k * s.dim + j, o = r * p.B + lane;
    dn[j] = dual ? __fsub_rn(__fadd_rn(dual[o], relaxed(p, relax, ux[r * T],
                                                         prev[o])), w[j])
                 : 0.0f;
  }
}

// The reference's OSQP-form rho prediction for one lane (ops/rho.py
// osqp_residuals + predict_rho, with the per-lane terminal cost P0 + drho
// dP), before this iteration's second pass: ux holds [u; x], y/g the duals
// before their ascent, uout/xout the previous slacks.
__device__ float osqp_predict(const Params& p, int g, bool relax,
                              const float* ux, int lane, int T, float drho,
                              float rho_b) {
  const int nx = p.nx, nu = p.nu, N = p.N;
  // the group's plant data, looked up here and not kept by the caller: the
  // prediction runs on every 5th iteration only, and the caller's matvec
  // loops need every register they can get
  const int gp = p.plant_grouped ? g : 0;
  const float* A = p.A + gp * nx * nx;
  const float* Bm = p.Bm + gp * nx * nu;
  const float* qd = p.qd + gp * nx;
  const float* rd = p.rd + gp * nu;
  const float* P0 = p.P0 + gp * nx * nx;
  const float* dP = p.dP + gp * nx * nx;
  const float* xs = ux + p.su * T;
  const float* gdual = p.state_free ? nullptr : p.g;
  float vn_c[kMaxStage], g_c[kMaxStage], vn_n[kMaxStage], g_n[kMaxStage];
  float zn[kMaxStage], yn[kMaxStage];
  float pri_res = 0.0f, pri_norm = 0.0f, dual_res = 0.0f;
  float px_inf = 0.0f, aty_inf = 0.0f, q_inf = 0.0f;

  stage_new(p, p.side_x, g, 0, relax, xs, p.xout, gdual, lane, T, vn_c, g_c);
  for (int j = 0; j < N; ++j) {
    const float* xj = xs + j * nx * T;
    const bool inner = j < N - 1;
    if (inner) {
      const float* uj = ux + j * nu * T;
      stage_new(p, p.side_x, g, j + 1, relax, xs, p.xout, gdual, lane, T,
                vn_n, g_n);
      stage_new(p, p.side_u, g, j, relax, ux, p.uout, p.y, lane, T, zn, yn);
      // primal: input rows u_j against znew_j
      for (int a = 0; a < nu; ++a) {
        const float u = uj[a * T];
        pri_res = fmaxf(pri_res, fabsf(__fsub_rn(u, zn[a])));
        pri_norm = fmaxf(pri_norm, fmaxf(fabsf(u), fabsf(zn[a])));
      }
      // dynamics rows A x_j + B u_j - x_{j+1} against vnew_{j+1}
      for (int a = 0; a < nx; ++a) {
        float ax = 0.0f, bu = 0.0f;
        for (int b = 0; b < nx; ++b)
          ax = fmaf(__ldg(A + a * nx + b), xj[b * T], ax);
        for (int b = 0; b < nu; ++b)
          bu = fmaf(__ldg(Bm + a * nu + b), uj[b * T], bu);
        const float dyn = __fsub_rn(__fadd_rn(ax, bu), xj[(nx + a) * T]);
        pri_res = fmaxf(pri_res, fabsf(__fsub_rn(dyn, vn_n[a])));
        pri_norm = fmaxf(pri_norm, fmaxf(fabsf(dyn), fabsf(vn_n[a])));
      }
      // dual, input rows: R u (from P x) + R u (from q) + B^T g_{j+1} + y_j
      for (int a = 0; a < nu; ++a) {
        float btg = 0.0f;
        for (int b = 0; b < nx; ++b)
          btg = fmaf(__ldg(Bm + b * nu + a), g_n[b], btg);
        const float aty = __fadd_rn(btg, yn[a]);
        const float qu = __fmul_rn(uj[a * T], __ldg(rd + a));
        const float r = __fadd_rn(__fadd_rn(qu, qu), aty);
        dual_res = fmaxf(dual_res, fabsf(r));
        px_inf = fmaxf(px_inf, fabsf(qu));
        q_inf = fmaxf(q_inf, fabsf(qu));
        aty_inf = fmaxf(aty_inf, fabsf(aty));
      }
    }
    // dual, state rows: P x_j + Q x_j + A^T g_{j+1} [inner] - g_j [j >= 1]
    for (int a = 0; a < nx; ++a) {
      const float qx = __fmul_rn(xj[a * T], __ldg(qd + a));
      float px = qx;
      if (!inner) {
        float p0 = 0.0f, dp = 0.0f;
        for (int b = 0; b < nx; ++b) {
          p0 = fmaf(__ldg(P0 + a * nx + b), xj[b * T], p0);
          dp = fmaf(__ldg(dP + a * nx + b), xj[b * T], dp);
        }
        px = __fadd_rn(p0, __fmul_rn(drho, dp));
      }
      float aty = 0.0f;
      if (inner)
        for (int b = 0; b < nx; ++b)
          aty = fmaf(__ldg(A + b * nx + a), g_n[b], aty);
      if (j >= 1) aty = __fsub_rn(aty, g_c[a]);
      const float r = __fadd_rn(__fadd_rn(px, qx), aty);
      dual_res = fmaxf(dual_res, fabsf(r));
      px_inf = fmaxf(px_inf, fabsf(px));
      q_inf = fmaxf(q_inf, fabsf(qx));
      aty_inf = fmaxf(aty_inf, fabsf(aty));
    }
    if (inner)
      for (int a = 0; a < nx; ++a) {
        vn_c[a] = vn_n[a];
        g_c[a] = g_n[a];
      }
  }
  const float dual_norm = fmaxf(fmaxf(px_inf, aty_inf), q_inf);
  const float npri = __fdiv_rn(pri_res, __fadd_rn(pri_norm, kEps));
  const float ndual = __fdiv_rn(dual_res, __fadd_rn(dual_norm, kEps));
  float pred = __fmul_rn(rho_b, __fsqrt_rn(__fdiv_rn(
      npri, __fadd_rn(ndual, kEps))));
  if (p.clipping) pred = fminf(p.rho_max, fmaxf(p.rho_min, pred));
  return pred;
}

// The termination-residual controller (ops/rho.py termination_controller)
// from the lane's residuals: pri = max primal, dua = the max dual residual
// before its scaling by rho.
template <bool kGrouped>
__device__ __forceinline__ float termination_predict(const Params& p,
                                                     int gm, float pri,
                                                     float dua, float rho_b) {
  const float ratio = __fdiv_rn(
      __fdiv_rn(pri, p.pri_tol),
      __fadd_rn(__fdiv_rn(__fmul_rn(rho_b, dua), p.dua_tol), kEps));
  const float factor = fminf(kMaxStep, fmaxf(1.0f / kMaxStep,
                                             __fsqrt_rn(ratio)));
  const bool move = factor > kDeadband || factor < 1.0f / kDeadband;
  float pred = move ? __fmul_rn(rho_b, factor) : rho_b;
  if (p.clipping) pred = fminf(p.rho_max, fmaxf(p.rho_min, pred));
  if (p.trust) {  // around the group's own expansion centre
    const float hi = kGrouped ? __ldg(p.trust_hi + gm) : p.trust_hi_one;
    const float lo = kGrouped ? __ldg(p.trust_lo + gm) : p.trust_lo_one;
    pred = fminf(hi, fmaxf(lo, pred));
  }
  return pred;
}

// kOrd1: the number of T1 Taylor blocks (order + 1); kProjU/kProjX: whether
// the input/state side has halfspaces or cones; kGrouped: whether the launch
// has more than one group.  A single group compiles with every group offset
// folded to zero and its expansion centre as a kernel parameter: the matvec
// loops' speed hangs on how ptxas schedules their loads, and the offsets'
// address arithmetic cost the one-group launch a fifth to a half of its
// speed when it was compiled in.
template <int kOrd1, bool kProjU, bool kProjX, bool kGrouped>
__global__ void condensed_adaptive_kernel(Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int g = kGrouped ? blockIdx.y : 0;
  const int l = blockIdx.x * T + tid;  // index in the group
  const int lane = kGrouped ? g * p.L + l : l;
  const int sw = p.sw, su = p.su, sx = p.sx, B = p.B, in1 = p.in1;
  const int t1_stride = kOrd1 * p.swp, t2_stride = 4 * p.sup;

  // this block's group's maps and expansion centre
  const int gm = kGrouped && p.map_grouped ? g : 0;
  const float* t1 = p.t1t;
  const float* t2 = p.t2t;
  if constexpr (kGrouped) {
    t1 += static_cast<size_t>(gm) * in1 * t1_stride;
    t2 += static_cast<size_t>(gm) * (sw + 1) * t2_stride;
  }
  const float rho0 = kGrouped ? p.rho0[gm] : p.rho0_one;
  float* lanes = smem;
  if (p.resident) {
    const int n1 = in1 * t1_stride, n2 = (sw + 1) * t2_stride;
    for (int e = tid; e < n1; e += T) smem[e] = t1[e];
    for (int e = tid; e < n2; e += T) smem[n1 + e] = t2[e];
    t1 = smem;
    t2 = smem + n1;
    lanes = smem + n1 + n2;
  }
  __syncthreads();
  if (l >= (kGrouped ? p.L : B)) return;

  // this lane's vec1 = [d; x0; 1] and ux/vec2 (sw entries and a constant 1)
  float* vec1 = lanes + tid;
  float* ux = lanes + in1 * T + tid;
  const bool state_free = p.state_free;
  const bool relax = p.alpha != 1.0f;
  float* gdual = state_free ? nullptr : p.g;

  for (int j = 0; j < p.nx; ++j) vec1[(su + j) * T] = p.x0[lane * p.nx + j];
  vec1[(in1 - 1) * T] = 1.0f;
  ux[sw * T] = 1.0f;
  float rho_b = rho0;
  if (p.warm_start) {
    for (int r = 0; r < su; ++r) {
      vec1[r * T] = p.d_in[r * B + lane];
      p.y[r * B + lane] = p.y_in[r * B + lane];
      p.uout[r * B + lane] = p.z_in[r * B + lane];
    }
    for (int r = 0; r < sx; ++r) {
      if (!state_free) p.g[r * B + lane] = p.g_in[r * B + lane];
      p.xout[r * B + lane] = p.v_in[r * B + lane];
    }
    rho_b = p.rho_in[lane];
  } else {
    for (int r = 0; r < su; ++r) {
      vec1[r * T] = 0.0f;
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

  for (int i = 0; i < p.max_iter; ++i) {
    const float drho = __fsub_rn(rho_b, rho0);

    // forward map: o+1 accumulators per row, Horner in drho
    for (int r0 = 0; r0 < sw; r0 += kRowBlock) {
      float acc[kOrd1][kRowBlock];
#pragma unroll
      for (int k = 0; k < kOrd1; ++k)
#pragma unroll
        for (int j = 0; j < kRowBlock; ++j) acc[k][j] = 0.0f;
      for (int j = 0; j < in1; ++j)
        fma_rows<kOrd1>(acc, t1 + j * t1_stride + r0, p.swp, vec1[j * T]);
#pragma unroll
      for (int j = 0; j < kRowBlock; ++j) {
        const int r = r0 + j;
        if (r < sw) {
          float v = acc[kOrd1 - 1][j];
#pragma unroll
          for (int k = kOrd1 - 2; k >= 0; --k)
            v = __fadd_rn(__fmul_rn(v, drho), acc[k][j]);
          ux[r * T] = v;
        }
      }
    }

    // residuals where the check or the termination controller needs them
    const bool update = i > 0 && i % kRhoInterval == 0;
    const bool check = (i + 1) % p.ct == 0;
    float pi = 0.0f, di = 0.0f, ps = 0.0f, ds = 0.0f;
    if (check || (update && !p.osqp)) {
      side_residuals<kProjU>(p, p.side_u, g, relax, ux, p.uout, p.y, lane, T,
                             pi, di);
      side_residuals<kProjX>(p, p.side_x, g, relax, ux + su * T, p.xout,
                             gdual, lane, T, ps, ds);
    }

    // rho prediction (this lane has not latched, so it takes the update)
    float rho_new = rho_b;
    if (update)
      rho_new = p.osqp
                    ? osqp_predict(p, g, relax, ux, lane, T, drho, rho_b)
                    : termination_predict<kGrouped>(p, gm, fmaxf(ps, pi),
                                                    fmaxf(ds, di), rho_b);
    const float drho_new = __fsub_rn(rho_new, rho0);

    // the latch: dual residuals scale by the post-update rho
    const bool newly = check && ps < p.pri_tol && pi < p.pri_tol &&
                       __fmul_rn(ds, rho_new) < p.dua_tol &&
                       __fmul_rn(di, rho_new) < p.dua_tol;

    // slack, dual, output and carry updates; ux becomes vec2
    const bool carry = p.carry_out && !newly;
    side_update<kProjU>(p, p.side_u, g, relax, ux, p.uout, p.y, p.zco, carry,
                        lane, T);
    side_update<kProjX>(p, p.side_x, g, relax, ux + su * T, p.xout, gdual,
                        p.vco, carry, lane, T);
    rho_b = rho_new;
    if (newly) {  // the outputs hold vnew/znew; d stays frozen
      p.iters[lane] = i + 1;
      p.solved[lane] = 1;
      break;
    }

    // backward map: 4 accumulators per row, cost fold at the pre-update
    // drho, gain at the post-update drho
    const float cross = __fmul_rn(drho, drho_new);
    for (int r0 = 0; r0 < su; r0 += kRowBlock) {
      float acc[4][kRowBlock];
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int j = 0; j < kRowBlock; ++j) acc[c][j] = 0.0f;
      for (int k = 0; k <= sw; ++k)
        fma_rows<4>(acc, t2 + k * t2_stride + r0, p.sup, ux[k * T]);
#pragma unroll
      for (int j = 0; j < kRowBlock; ++j) {
        const int r = r0 + j;
        if (r < su) {
          float d = __fadd_rn(acc[0][j], __fmul_rn(drho, acc[1][j]));
          d = __fadd_rn(d, __fmul_rn(drho_new, acc[2][j]));
          vec1[r * T] = __fadd_rn(d, __fmul_rn(cross, acc[3][j]));
        }
      }
    }
  }

  p.rho_out[lane] = rho_b;
  if (p.carry_out)
    for (int r = 0; r < su; ++r) p.d_out[r * B + lane] = vec1[r * T];
}

template <int kOrd1, bool kGrouped>
void (*pick_projections(bool proj_u, bool proj_x))(Params) {
  return proj_u
             ? (proj_x
                    ? condensed_adaptive_kernel<kOrd1, true, true, kGrouped>
                    : condensed_adaptive_kernel<kOrd1, true, false, kGrouped>)
             : (proj_x
                    ? condensed_adaptive_kernel<kOrd1, false, true, kGrouped>
                    : condensed_adaptive_kernel<kOrd1, false, false,
                                                kGrouped>);
}

template <int kOrd1>
void (*pick_kernel(bool proj_u, bool proj_x, bool grouped))(Params) {
  return grouped ? pick_projections<kOrd1, true>(proj_u, proj_x)
                 : pick_projections<kOrd1, false>(proj_u, proj_x);
}

}  // namespace

extern "C" int tinympc_condensed_adaptive(
    const float* t1t, const float* t2t, const float* rho0,
    const float* trust_lo, const float* trust_hi, const float* umin,
    const float* umax, const float* xmin, const float* xmax, const float* x0,
    const float* d_in, const float* y_in, const float* g_in,
    const float* v_in, const float* z_in, const float* rho_in, float* xout,
    float* uout, int* iters, int* solved, float* rho_out, float* y, float* g,
    float* d_out, float* vco, float* zco, const float* A, const float* Bm,
    const float* qd, const float* rd, const float* P0, const float* dP,
    int nx, int nu, int N, int G, int L, int order, int max_iter, int ct,
    float alpha, float one_m_alpha, float pri_tol, float dua_tol,
    float rho_min, float rho_max, float rho0_one, float trust_lo_one,
    float trust_hi_one, int osqp, int clipping, int trust,
    int en_input_bound, int en_state_bound, int warm_start, int carry_out,
    int tile, int resident, int swp, int sup, int smem_bytes, int map_grouped,
    int plant_grouped, int box_u_grouped, int box_x_grouped,
    const float* lin_u, int n_lin_u, const int* soc_u, const float* soc_mu_u,
    int n_soc_u, int lin_u_grouped, int mu_u_grouped, const float* lin_x,
    int n_lin_x, const int* soc_x, const float* soc_mu_x, int n_soc_x,
    int lin_x_grouped, int mu_x_grouped, void* stream) {
  // G groups of L lanes; the *_grouped flags say which arrays carry a
  // leading group axis (rho0 and the trust bounds go with the maps; a
  // single group passes them by value as rho0_one, trust_*_one).
  // lin_*: (n_lin, 2*dim + 1) device rows; soc_*: n_soc (start, dim) pairs
  // in host memory; soc_mu_*: (n_soc,) on the device
  Params p;
  p.t1t = t1t; p.t2t = t2t; p.rho0 = rho0; p.trust_lo = trust_lo;
  p.trust_hi = trust_hi; p.x0 = x0;
  p.d_in = d_in; p.y_in = y_in; p.g_in = g_in; p.v_in = v_in; p.z_in = z_in;
  p.rho_in = rho_in;
  p.xout = xout; p.uout = uout; p.iters = iters; p.solved = solved;
  p.rho_out = rho_out; p.y = y; p.g = g; p.d_out = d_out; p.vco = vco;
  p.zco = zco;
  p.A = A; p.Bm = Bm; p.qd = qd; p.rd = rd; p.P0 = P0; p.dP = dP;
  p.nx = nx; p.nu = nu; p.N = N;
  p.su = (N - 1) * nu; p.sx = N * nx; p.sw = p.su + p.sx;
  p.swp = swp; p.sup = sup; p.in1 = p.su + nx + 1; p.B = G * L; p.L = L;
  p.max_iter = max_iter; p.ct = ct;
  p.alpha = alpha; p.one_m_alpha = one_m_alpha;
  p.pri_tol = pri_tol; p.dua_tol = dua_tol;
  p.rho_min = rho_min; p.rho_max = rho_max;
  p.rho0_one = rho0_one; p.trust_lo_one = trust_lo_one;
  p.trust_hi_one = trust_hi_one;
  p.osqp = osqp; p.clipping = clipping; p.trust = trust;
  p.warm_start = warm_start; p.carry_out = carry_out; p.resident = resident;
  p.map_grouped = map_grouped; p.plant_grouped = plant_grouped;
  // no state-side constraint at all: g == 0 and vnew = x_hat
  p.state_free = !en_state_bound && n_lin_x == 0 && n_soc_x == 0;
  // the caller owns the layout; refuse one the kernel would overrun
  const int ord1 = order + 1;
  size_t need = sizeof(float) * static_cast<size_t>(p.in1 + p.sw + 1) * tile;
  if (resident)
    need += sizeof(float) * (static_cast<size_t>(p.in1) * ord1 * swp +
                             static_cast<size_t>(p.sw + 1) * 4 * sup);
  if (G <= 0 || L <= 0 || G > 65535 || tile <= 0 || ct < 1 || order < 1 ||
      order > 3 || swp < p.sw || swp % kRowBlock != 0 || sup < p.su ||
      sup % kRowBlock != 0 || smem_bytes < 0 ||
      static_cast<size_t>(smem_bytes) < need ||
      (G > 1 && (!rho0 || !trust_lo || !trust_hi)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (warm_start && (!d_in || !y_in || !v_in || !z_in || !rho_in ||
                     (!p.state_free && !g_in)))
    return static_cast<int>(cudaErrorInvalidValue);
  // the stage-wise OSQP residuals hold one stage of each side per thread
  if (osqp && (!A || !Bm || !qd || !rd || !P0 || !dP || nx > kMaxStage ||
               nu > kMaxStage))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!init_side(p.side_u, umin, umax, lin_u, n_lin_u, soc_u, soc_mu_u,
                 n_soc_u, nu, N - 1, en_input_bound, box_u_grouped,
                 lin_u_grouped, mu_u_grouped) ||
      !init_side(p.side_x, xmin, xmax, lin_x, n_lin_x, soc_x, soc_mu_x,
                 n_soc_x, nx, N, en_state_bound, box_x_grouped, lin_x_grouped,
                 mu_x_grouped))
    return static_cast<int>(cudaErrorInvalidValue);

  const bool proj_u = n_lin_u + n_soc_u > 0, proj_x = n_lin_x + n_soc_x > 0;
  const bool grouped = G > 1;
  void (*kernel)(Params) =
      order == 1   ? pick_kernel<2>(proj_u, proj_x, grouped)
      : order == 2 ? pick_kernel<3>(proj_u, proj_x, grouped)
                   : pick_kernel<4>(proj_u, proj_x, grouped);
  const size_t smem = static_cast<size_t>(smem_bytes);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L + tile - 1) / tile, G);
  kernel<<<grid, tile, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
