// Condensed ADMM with per-lane adaptive rho: the whole solve of a tile of
// lanes in one kernel launch (kernel K2 of the port).
//
// Replaces: tinympc_julia_tpu/ops/pallas/adaptive_kernel.py,
//   make_condensed_adaptive_fused_solver (the pl.pallas_call kernel): both
//   rho controllers (the reference's OSQP-form one and the
//   termination-residual one with its deadband, step cap and Taylor trust
//   clip), any Taylor order, cold/warm start, carry output,
//   check_termination, over-relaxation, the state-free specialisation, the
//   box, halfspace and cone projections, the group grid (num_groups: G
//   distinct problems, each block lanes of one group) and the reduced-
//   precision products (precision).
//
// Per lane and iteration the work is two products against maps shared by
// all lanes, each combined per lane in drho = rho_lane - rho0:
//   forward   ux = sum_k drho^k (T1_k @ [d; x0; 1])       (o+1 blocks, Horner)
//   backward  d' = (T2_0 + drho T2_1 + drho' T2_2 + drho drho' T2_3)
//                  @ [znew - y; vnew - g; 1]               (drho' after update)
// plus O(sw) elementwise work and, every 5th iteration, the rho prediction.
// At the quadrotor (sw = 316, su = 76, order 2) that is 2*(3*316*89 +
// 4*76*317) ~ 361k fp32 FLOP per lane-iteration against on-chip traffic
// only: the maps (337 KB + 385 KB) are read for every iteration of every
// tile, so what bounds the kernel is how fast an SM can feed the maps and
// the iterates to its FMA units, not device memory.  The design is kernel
// K1's lane tile (tile_gemm.cuh):
//  * A block of 256 threads owns a tile of 32 lanes (16 where the iterates
//    of 32 would not fit beside a wide map's slab ring) and runs both
//    products over the tile as GEMMs, each thread a register tile of RPT
//    rows x 2 lanes, each
//    output summed over k in index order with fmaf (no TF32), so a lane's
//    fp32 result does not depend on its tile-mates and equals the plain
//    version's product.
//  * The forward product runs the T1 blocks from the highest order down,
//    one block's product at a time, and folds each into the lane's Horner
//    value: v = v drho + acc, in round-to-nearest as the plain version
//    computes it, v in the thread's own entries of ux; any Taylor order
//    takes the same registers.
//  * The backward product multiplies the four T2 blocks stacked with their
//    rows interleaved (row 4 r + c is row r of block c), so the four sums of
//    an output are in one thread (fp32) or in four lanes of a warp
//    (tensor cores, read with shuffles), and combines them left to right:
//    ((R0 + drho R1) + drho' R2) + drho drho' R3.
//  * The maps are resident in shared memory where both fit beside the tile
//    (the cartpole's) and streamed from L2 in slabs through the cp.async
//    ring otherwise (the quadrotor's); a product wider than the threads'
//    rows runs in passes.
//  * The lanes' iterates vec1 = [d; x0; 1] and ux / vec2 = [znew - y;
//    vnew - g; 1] live in shared memory as [row][lane]; so do the duals and
//    slacks (y, z, v, g) where they fit, else they stay in the (dim, B)
//    outputs.
//  * The elementwise step runs on all threads, 256 / T a lane: relaxation,
//    projections, residuals and dual ascent (tile_gemm.cuh,
//    projections.cuh), and the OSQP-form prediction stage by stage; the
//    partial maxima meet in shared memory (a max is exact in any order) and
//    every thread of a lane takes the same rho and latch decision.  A
//    shared count of latched lanes ends the tile's loop.
//  * The OSQP-form residuals are block-structured (dynamics rows A x_i +
//    B u_i - x_{i+1}, the A^T g terms, diagonal costs, the Taylor terminal
//    cost P0 + drho dP): each stage's come from A, B, the cost diagonals, P0
//    and dP, each matvec in one thread in index order.
//  * Reduced precision (precision="default"): an iteration that neither
//    checks nor predicts rho runs both products on the tensor cores
//    (mma.sync.m16n8k16 on real-bf16 maps, operands rounded to bf16, each
//    k16 step summed from zero and added in fp32: mma_product of
//    ops/cuda/condensed_kernel.py is the same arithmetic).
//  * Group grid: the grid is (tiles per group, G).  A block reads its
//    group's Taylor maps, expansion centre rho0 and trust bounds, box
//    bounds, constraint data and plant data by a group offset into
//    G-stacked arrays (offset 0 where an array is shared); the last tile of
//    every group is ragged and masked; lanes keep the flat order
//    lane = g * L + l, and rho stays per lane.
//
// Launch contract: the Python wrapper (adaptive_tile_plan) picks the tile
// and the rows a thread (32 lanes with 8 or 20 rows, 16 lanes with 8: the
// instances), the passes, the padded layouts, the
// residency of maps and state and the dynamic shared-memory size; the entry
// point refuses a layout the kernel would overrun.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "projections.cuh"
#include "tile_gemm.cuh"

namespace {

using namespace tinympc;

constexpr int kRhoInterval = 5;
constexpr float kEps = 1e-10f;
constexpr float kDeadband = 5.0f;
constexpr float kMaxStep = 10.0f;

struct Params {
  // the maps, with a leading group axis where map_grouped
  const float* t1t;  // (ord1, in1, ld1): T1 block c transposed, [c][k][row]
  const float* t2t;  // (sw + 1, ld2): the T2 blocks transposed, row 4 r + c
                     // of the stack is row r of block c
  const __nv_bfloat16* t1a;  // (ord1, ld1, kp1) the same in bf16, row-major;
  const __nv_bfloat16* t2a;  // (ld2, kp2)   null without reduced iterations
  const float* rho0;      // (G,) expansion centre; null: rho0_one
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
  float* g;           // (sx, B) state dual (also the carry's g)
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
  int nx, nu, N, su, sx, sw, in1, B, L;  // B = G * L lanes
  int ord1, ld1, ld2, kp1, kp2, passes1, passes2;
  int max_iter, ct, lo_all;
  float alpha, one_m_alpha, pri_tol, dua_tol;
  float rho_min, rho_max;
  float rho0_one, trust_lo_one, trust_hi_one;  // the same of a single group
  int osqp, clipping, trust;
  int state_free, warm_start, carry_out, resident, state_shared;
  int map_grouped, plant_grouped;
  Side side_u, side_x;
};

// Floats of one lane's duals and slacks: y and z (su each), v (sx) and,
// with a state constraint, g (sx).
__host__ __device__ inline int state_rows(int su, int sx, bool state_free) {
  return 2 * su + (state_free ? 1 : 2) * sx;
}

// Byte offsets of the block's shared memory for a tile of T lanes: vec1
// (in1 x T floats), ux / vec2 (sw + 1 rows), the latch flags (T + 1 ints),
// the lanes' rho before and after the update (2 x T), the elementwise
// partials (3 float4 a
// thread), the lanes' duals and slacks where resident, the map region
// (resident: both fp32 maps, then both bf16 ones with reduced iterations;
// streamed: the slab ring), the bf16 product input ([lane][k], reduced
// only).
struct K2Layout {
  size_t ux, flags, rho, red, state, map, t2, t1a, t2a, w2h, total;
};

__host__ __device__ inline K2Layout k2_layout(
    int T, int W, int in1, int sw, int ord1, int ld1, int ld2, int kp1,
    int kp2, int state_floats, bool resident, bool reduced) {
  K2Layout t;
  size_t off = up16(sizeof(float) * static_cast<size_t>(in1) * T);
  t.ux = off;
  off += up16(sizeof(float) * static_cast<size_t>(sw + 1) * T);
  t.flags = off;
  off += up16(sizeof(int) * (T + 1));
  t.rho = off;
  off += up16(sizeof(float) * 2 * T);
  t.red = off;
  off += up16(sizeof(float) * 12 * kThreads);
  t.state = off;
  off += up16(sizeof(float) * static_cast<size_t>(state_floats) * T);
  t.map = off;
  if (resident) {
    off += up16(sizeof(float) * static_cast<size_t>(ord1) * in1 * ld1);
    t.t2 = off;
    off += up16(sizeof(float) * static_cast<size_t>(sw + 1) * ld2);
    t.t1a = off;
    if (reduced)
      off += up16(2 * static_cast<size_t>(ord1) * ld1 * (kp1 + kPadLo));
    t.t2a = off;
    if (reduced) off += up16(2 * static_cast<size_t>(ld2) * (kp2 + kPadLo));
  } else {
    t.t2 = t.t1a = t.t2a = off;
    off += up16(ring_bytes(W, reduced) > ring_bytes(W, false)
                    ? ring_bytes(W, reduced)
                    : ring_bytes(W, false));
  }
  t.w2h = off;
  const int kp = kp1 > kp2 ? kp1 : kp2;
  if (reduced) off += up16(2 * static_cast<size_t>(T) * (kp + kPadLo));
  t.total = off;
  return t;
}

// What one block works on.
struct Tile {
  float* vec1;                 // (in1, T)
  float* ux;                   // (sw + 1, T)
  const int* done;             // (T,) latched (or absent) lanes
  float* state;                // resident duals and slacks, or null
  float* ring;                 // streamed slabs; null where resident
  const float* t1;             // the group's maps: in shared memory where
  const float* t2;             // resident, else in global memory
  const __nv_bfloat16* t1a;
  const __nv_bfloat16* t2a;
  __nv_bfloat16* w2h;
  float rho0;
  int tid, lane0, nvalid, g, gm;
};

// One lane's duals and slacks: element r of an array at [r * stride] from
// the lane's own base (its column of a [row][lane] shared array, stride T,
// or of a (dim, B) global one, stride B).
struct LaneState {
  float* y;     // (su) input dual
  float* z;     // (su) input slack (the output u)
  float* v;     // (sx) state slack (the output x)
  float* g;     // (sx) state dual; null: the state-free path
  int stride;
};

template <int T>
__device__ __forceinline__ LaneState lane_state(const Params& p,
                                                const Tile& t, int l) {
  LaneState s;
  if (t.state) {
    float* b = t.state + l;
    s.y = b;
    s.z = s.y + p.su * T;
    s.v = s.z + p.su * T;
    s.g = p.state_free ? nullptr : s.v + p.sx * T;
    s.stride = T;
  } else {
    const int lane = t.lane0 + l;
    s.y = p.y + lane;
    s.z = p.uout + lane;
    s.v = p.xout + lane;
    s.g = p.state_free ? nullptr : p.g + lane;
    s.stride = p.B;
  }
  return s;
}

// The product's output for row r of lane l: within the rows, a lane of the
// group that has not latched.
__device__ __forceinline__ bool takes(const Tile& t, int r, int rows, int l) {
  return r < rows && l < t.nvalid && !t.done[l];
}

// The forward product into ux: the T1 blocks from order o down to 0, a pass
// of W rows at a time.  The Horner value v = v drho + acc of each output
// the thread sums lives in its entry of ux, which no other thread touches
// until the product is done (the registers hold the product's tile only).
template <int RPT, int T>
__device__ __forceinline__ void forward(const Params& p, const Tile& t,
                                        bool lo, const float* rho_b) {
  const int W = Lanes<T>::kRowGroups * RPT, ord1 = p.ord1;
  auto epi = [&](int j, const auto& acc, const auto& fr) {
    const int c = ord1 - 1 - j % ord1, r0 = (j / ord1) * W;
#pragma unroll
    for (int e = 0; e < 2 * RPT; ++e) {
      const int r = r0 + fr.row(e), l = fr.lane(e);
      if (r < p.sw) {
        float* v = t.ux + r * T + l;
        *v = c == ord1 - 1
                 ? acc[e]
                 : __fadd_rn(__fmul_rn(*v, __fsub_rn(rho_b[l], t.rho0)),
                             acc[e]);
      }
    }
  };
  const int nseg = p.passes1 * ord1;
  if (lo) {
    const int lda = t.ring ? p.kp1 : p.kp1 + kPadLo;
    const GemmLo a{t.vec1, t.w2h, reinterpret_cast<__nv_bfloat16*>(t.ring),
                   p.in1, p.kp1, W, nseg, t.tid, lda};
    gemm_lo<RPT, T>(a, [&](int j) {
      const int c = ord1 - 1 - j % ord1, pass = j / ord1;
      return t.t1a + (static_cast<size_t>(c) * p.ld1 + pass * W) * lda;
    }, epi);
  } else {
    const GemmF32 a{t.vec1, t.ring, p.in1, W, p.ld1, nseg, t.tid};
    gemm_fp32<RPT, T>(a, [&](int j) {
      const int c = ord1 - 1 - j % ord1, pass = j / ord1;
      return t.t1 + static_cast<size_t>(c) * p.in1 * p.ld1 + pass * W;
    }, epi);
  }
}

// d of one output row from its four block sums: the cost fold at the
// pre-update drho, the gain at the post-update drho', left to right.
__device__ __forceinline__ float bilinear(float a0, float a1, float a2,
                                          float a3, float drho,
                                          float drho_n) {
  float d = __fadd_rn(a0, __fmul_rn(drho, a1));
  d = __fadd_rn(d, __fmul_rn(drho_n, a2));
  return __fadd_rn(d, __fmul_rn(__fmul_rn(drho, drho_n), a3));
}

// The backward product into vec1's d rows: the interleaved T2 stack, a
// pass of W stacked rows (W / 4 outputs) at a time.
template <int RPT, int T>
__device__ __forceinline__ void backward(const Params& p, const Tile& t,
                                         bool lo, const float* rho_b,
                                         const float* rho_n) {
  const int W = Lanes<T>::kRowGroups * RPT;
  auto store = [&](int r, int l, float a0, float a1, float a2, float a3) {
    if (takes(t, r, p.su, l))
      t.vec1[r * T + l] = bilinear(
          a0, a1, a2, a3, __fsub_rn(rho_b[l], t.rho0),
          __fsub_rn(rho_n[l], t.rho0));
  };
  auto epi = [&](int j, const auto& acc, const auto& fr) {
    if constexpr (std::decay_t<decltype(fr)>::kLo) {
      // the four sums of an output are in the four lanes whose row group
      // gq differs in its low two bits
      const int ln = t.tid & 31, c = fr.gq & 3;
#pragma unroll
      for (int e = 0; e < 2 * RPT; ++e) {
        float a[4];
#pragma unroll
        for (int c2 = 0; c2 < 4; ++c2)
          a[c2] = warp_read(acc[e], (ln & ~12) | (c2 << 2));
        if (c == 0)
          store((j * W + fr.row(e)) / 4, fr.lane(e), a[0], a[1], a[2], a[3]);
      }
    } else {
#pragma unroll
      for (int r4 = 0; r4 < RPT / 4; ++r4)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int e = 8 * r4 + q;  // row 4 r4 of the thread's, lane q
          store((j * W + fr.row(e)) / 4, fr.lane(e), acc[e], acc[e + 2],
                acc[e + 4], acc[e + 6]);
        }
    }
  };
  if (lo) {
    const int lda = t.ring ? p.kp2 : p.kp2 + kPadLo;
    const GemmLo a{t.ux, t.w2h, reinterpret_cast<__nv_bfloat16*>(t.ring),
                   p.sw + 1, p.kp2, W, p.passes2, t.tid, lda};
    gemm_lo<RPT, T>(a, [&](int j) {
      return t.t2a + static_cast<size_t>(j) * W * lda;
    }, epi);
  } else {
    const GemmF32 a{t.ux, t.ring, p.sw + 1, W, p.ld2, p.passes2, t.tid};
    gemm_fp32<RPT, T>(a, [&](int j) { return t.t2 + j * W; }, epi);
  }
}

// The new slack and the ascended dual of stage k of one side, as the update
// pass will compute them (the same functions, so the same bits).
template <int T>
__device__ __forceinline__ void stage_new(const Params& p, const Side& s,
                                          int g, int k, bool relax,
                                          const float* ux, const float* prev,
                                          const float* dual, int stride,
                                          float* w, float* dn) {
  const StageParams sp{p.alpha, p.one_m_alpha, stride};
  stage_slack(sp, s, g, k, relax, ux, prev, dual, 0, T, w);
  for (int j = 0; j < s.dim; ++j) {
    const int r = k * s.dim + j, o = r * stride;
    dn[j] = dual ? __fsub_rn(__fadd_rn(dual[o], relaxed(p, relax, ux[r * T],
                                                         prev[o])), w[j])
                 : 0.0f;
  }
}

// The partial maxima of the OSQP-form residuals (ops/rho.py
// osqp_residuals, with the per-lane terminal cost P0 + drho dP) over the
// stages q, q + 256 / T, ... of one lane, before this iteration's update pass:
// ux holds [u; x] (the lane's column), the state y/g the duals before their
// ascent and z/v the previous slacks.  m: pri_res, pri_norm, dual_res,
// px_inf, aty_inf, q_inf.
template <int T>
__device__ void osqp_partials(const Params& p, int g, int gp, bool relax,
                              const float* ux, const LaneState& st,
                              float drho, int q, float (&m)[6]) {
  const int nx = p.nx, nu = p.nu, N = p.N, S = st.stride;
  const float* A = p.A + gp * nx * nx;
  const float* Bm = p.Bm + gp * nx * nu;
  const float* qd = p.qd + gp * nx;
  const float* rd = p.rd + gp * nu;
  const float* P0 = p.P0 + gp * nx * nx;
  const float* dP = p.dP + gp * nx * nx;
  const float* xs = ux + p.su * T;
  float vn[kMaxStage], g_c[kMaxStage], vn_n[kMaxStage], g_n[kMaxStage];
  float zn[kMaxStage], yn[kMaxStage];
  for (int j = q; j < N; j += Lanes<T>::kLaneThreads) {
    const float* xj = xs + j * nx * T;
    const bool inner = j < N - 1;
    if (j >= 1)
      stage_new<T>(p, p.side_x, g, j, relax, xs, st.v, st.g, S, vn, g_c);
    if (inner) {
      const float* uj = ux + j * nu * T;
      stage_new<T>(p, p.side_x, g, j + 1, relax, xs, st.v, st.g, S, vn_n, g_n);
      stage_new<T>(p, p.side_u, g, j, relax, ux, st.z, st.y, S, zn, yn);
      // primal: input rows u_j against znew_j
      for (int a = 0; a < nu; ++a) {
        const float u = uj[a * T];
        m[0] = fmaxf(m[0], fabsf(__fsub_rn(u, zn[a])));
        m[1] = fmaxf(m[1], fmaxf(fabsf(u), fabsf(zn[a])));
      }
      // dynamics rows A x_j + B u_j - x_{j+1} against vnew_{j+1}
      for (int a = 0; a < nx; ++a) {
        float ax = 0.0f, bu = 0.0f;
        for (int b = 0; b < nx; ++b)
          ax = fmaf(__ldg(A + a * nx + b), xj[b * T], ax);
        for (int b = 0; b < nu; ++b)
          bu = fmaf(__ldg(Bm + a * nu + b), uj[b * T], bu);
        const float dyn = __fsub_rn(__fadd_rn(ax, bu), xj[(nx + a) * T]);
        m[0] = fmaxf(m[0], fabsf(__fsub_rn(dyn, vn_n[a])));
        m[1] = fmaxf(m[1], fmaxf(fabsf(dyn), fabsf(vn_n[a])));
      }
      // dual, input rows: R u (from P x) + R u (from q) + B^T g_{j+1} + y_j
      for (int a = 0; a < nu; ++a) {
        float btg = 0.0f;
        for (int b = 0; b < nx; ++b)
          btg = fmaf(__ldg(Bm + b * nu + a), g_n[b], btg);
        const float aty = __fadd_rn(btg, yn[a]);
        const float qu = __fmul_rn(uj[a * T], __ldg(rd + a));
        const float r = __fadd_rn(__fadd_rn(qu, qu), aty);
        m[2] = fmaxf(m[2], fabsf(r));
        m[3] = fmaxf(m[3], fabsf(qu));
        m[5] = fmaxf(m[5], fabsf(qu));
        m[4] = fmaxf(m[4], fabsf(aty));
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
      m[2] = fmaxf(m[2], fabsf(r));
      m[3] = fmaxf(m[3], fabsf(px));
      m[5] = fmaxf(m[5], fabsf(qx));
      m[4] = fmaxf(m[4], fabsf(aty));
    }
  }
}

// The reference's prediction from the lane's OSQP-form residual maxima.
__device__ __forceinline__ float osqp_predict(const Params& p,
                                              const float (&m)[6],
                                              float rho_b) {
  const float dual_norm = fmaxf(fmaxf(m[3], m[4]), m[5]);
  const float npri = __fdiv_rn(m[0], __fadd_rn(m[1], kEps));
  const float ndual = __fdiv_rn(m[2], __fadd_rn(dual_norm, kEps));
  float pred = __fmul_rn(rho_b, __fsqrt_rn(__fdiv_rn(
      npri, __fadd_rn(ndual, kEps))));
  if (p.clipping) pred = fminf(p.rho_max, fmaxf(p.rho_min, pred));
  return pred;
}

// The termination-residual controller (ops/rho.py termination_controller)
// from the lane's residuals: pri = max primal, dua = the max dual residual
// before its scaling by rho.
__device__ __forceinline__ float termination_predict(const Params& p, int gm,
                                                     float pri, float dua,
                                                     float rho_b) {
  const float ratio = __fdiv_rn(
      __fdiv_rn(pri, p.pri_tol),
      __fadd_rn(__fdiv_rn(__fmul_rn(rho_b, dua), p.dua_tol), kEps));
  const float factor = fminf(kMaxStep, fmaxf(1.0f / kMaxStep,
                                             __fsqrt_rn(ratio)));
  const bool move = factor > kDeadband || factor < 1.0f / kDeadband;
  float pred = move ? __fmul_rn(rho_b, factor) : rho_b;
  if (p.clipping) pred = fminf(p.rho_max, fmaxf(p.rho_min, pred));
  if (p.trust) {  // around the group's own expansion centre
    const float hi = p.trust_hi ? __ldg(p.trust_hi + gm) : p.trust_hi_one;
    const float lo = p.trust_lo ? __ldg(p.trust_lo + gm) : p.trust_lo_one;
    pred = fminf(hi, fmaxf(lo, pred));
  }
  return pred;
}

// RPT: rows a thread of the products; T: lanes a tile; kProjU/kProjX:
// whether the input / state side has halfspaces or cones.
template <int RPT, int T, bool kProjU, bool kProjX>
__global__ void __launch_bounds__(kThreads, 1)
    condensed_adaptive_kernel(Params p) {
  extern __shared__ float4 smem4[];
  char* sm = reinterpret_cast<char*>(smem4);
  constexpr int tpl = Lanes<T>::kLaneThreads;
  const int tid = threadIdx.x;
  const int g = blockIdx.y;
  const int l0 = blockIdx.x * T;  // the tile's first index in the group
  const int sw = p.sw, su = p.su, sx = p.sx, in1 = p.in1, B = p.B;
  const bool reduced = p.t1a != nullptr;
  const K2Layout lay = k2_layout(
      T, Lanes<T>::kRowGroups * RPT, in1, sw, p.ord1, p.ld1, p.ld2, p.kp1,
      p.kp2,
      p.state_shared ? state_rows(su, sx, p.state_free) : 0, p.resident,
      reduced);

  Tile t;
  t.tid = tid;
  t.g = g;
  t.gm = p.map_grouped ? g : 0;
  t.lane0 = g * p.L + l0;
  t.nvalid = min(T, p.L - l0);
  t.vec1 = reinterpret_cast<float*>(sm);
  t.ux = reinterpret_cast<float*>(sm + lay.ux);
  int* done = reinterpret_cast<int*>(sm + lay.flags);
  int* n_done = done + T;
  t.done = done;
  float* rho_s = reinterpret_cast<float*>(sm + lay.rho);
  float4* red = reinterpret_cast<float4*>(sm + lay.red);
  t.state = p.state_shared ? reinterpret_cast<float*>(sm + lay.state)
                           : nullptr;
  t.w2h = reduced ? reinterpret_cast<__nv_bfloat16*>(sm + lay.w2h) : nullptr;
  t.rho0 = p.rho0 ? p.rho0[t.gm] : p.rho0_one;

  // this block's group's maps
  const size_t n1 = static_cast<size_t>(p.ord1) * in1 * p.ld1;
  const size_t n2 = static_cast<size_t>(sw + 1) * p.ld2;
  const size_t n1a = static_cast<size_t>(p.ord1) * p.ld1 * p.kp1;
  const size_t n2a = static_cast<size_t>(p.ld2) * p.kp2;
  const float* t1 = p.t1t + t.gm * n1;
  const float* t2 = p.t2t + t.gm * n2;
  const __nv_bfloat16* t1a = reduced ? p.t1a + t.gm * n1a : nullptr;
  const __nv_bfloat16* t2a = reduced ? p.t2a + t.gm * n2a : nullptr;
  if (p.resident) {
    float* m1 = reinterpret_cast<float*>(sm + lay.map);
    float* m2 = reinterpret_cast<float*>(sm + lay.t2);
    for (size_t e = tid; e < n1; e += kThreads) m1[e] = t1[e];
    for (size_t e = tid; e < n2; e += kThreads) m2[e] = t2[e];
    t.t1 = m1;
    t.t2 = m2;
    t.ring = nullptr;
    if (reduced) {  // rows padded by kPadLo
      __nv_bfloat16* a1 = reinterpret_cast<__nv_bfloat16*>(sm + lay.t1a);
      __nv_bfloat16* a2 = reinterpret_cast<__nv_bfloat16*>(sm + lay.t2a);
      for (size_t e = tid; e < n1a; e += kThreads) {
        const size_t r = e / p.kp1, k = e - r * p.kp1;
        a1[r * (p.kp1 + kPadLo) + k] = t1a[e];
      }
      for (size_t e = tid; e < n2a; e += kThreads) {
        const size_t r = e / p.kp2, k = e - r * p.kp2;
        a2[r * (p.kp2 + kPadLo) + k] = t2a[e];
      }
      t.t1a = a1;
      t.t2a = a2;
    }
  } else {
    t.t1 = t1;
    t.t2 = t2;
    t.t1a = t1a;
    t.t2a = t2a;
    t.ring = reinterpret_cast<float*>(sm + lay.map);
  }

  // the lanes' state before iteration 0
  const int l = tid % T, q = tid / T, lane = t.lane0 + l;
  const bool valid = l < t.nvalid;
  {
    const LaneState st = lane_state<T>(p, t, l);
    const int S = st.stride;
    const bool warm = p.warm_start && valid;
    for (int r = q; r < in1; r += tpl) {
      float v = 0.0f;
      if (r < su) {
        v = warm ? p.d_in[r * B + lane] : 0.0f;
      } else if (r < su + p.nx) {
        v = valid ? p.x0[lane * p.nx + r - su] : 0.0f;
      } else {
        v = 1.0f;
      }
      t.vec1[r * T + l] = v;
    }
    for (int r = q; r <= sw; r += tpl) t.ux[r * T + l] = r == sw ? 1.0f : 0.0f;
    if (valid) {
      for (int r = q; r < su; r += tpl) {
        st.y[r * S] = warm ? p.y_in[r * B + lane] : 0.0f;
        st.z[r * S] = warm ? p.z_in[r * B + lane] : 0.0f;
      }
      for (int r = q; r < sx; r += tpl) {
        if (st.g) st.g[r * S] = warm ? p.g_in[r * B + lane] : 0.0f;
        st.v[r * S] = warm ? p.v_in[r * B + lane] : 0.0f;
      }
    }
    if (q == 0) {
      done[l] = valid ? 0 : 1;
      rho_s[l] = warm ? p.rho_in[lane] : t.rho0;
      rho_s[T + l] = rho_s[l];
      if (valid) {
        p.iters[lane] = p.max_iter;
        p.solved[lane] = 0;
      }
    }
  }
  if (tid == 0) *n_done = 0;
  __syncthreads();

  const bool relax = p.alpha != 1.0f;
  const int gp = p.plant_grouped ? g : 0;
  int cur = 0;  // which half of rho_s holds the lanes' rho
  for (int i = 0; i < p.max_iter; ++i) {
    const bool check = (i + 1) % p.ct == 0;
    const bool update = i > 0 && i % kRhoInterval == 0;
    // an iteration that checks or predicts rho runs its products in fp32
    const bool lo = p.lo_all && !check && !update;
    const float* rho_b = rho_s + cur * T;
    float* rho_n = rho_s + (cur ^ 1) * T;

    forward<RPT, T>(p, t, lo, rho_b);
    __syncthreads();

    // the elementwise step of lane l, thread q of its eight
    const bool active = !done[l];
    const LaneState st = lane_state<T>(p, t, l);
    const SidePass su_p{&p.side_u, t.ux + l, st.z, st.y, nullptr,
                        p.zco + lane, st.stride};
    const SidePass sx_p{&p.side_x, t.ux + l + su * T, st.v, st.g, nullptr,
                        p.vco + lane, st.stride};
    const float rb = rho_b[l];
    float rho_new = rb;
    bool newly = false;
    if (check || update) {
      float pi = 0.0f, di = 0.0f, ps = 0.0f, ds = 0.0f;
      float m[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      const bool term = check || (update && !p.osqp);
      if (active) {
        if (term) {
          side_residuals_q<kProjU, T>(p, su_p, g, relax, q, false, pi, di);
          side_residuals_q<kProjX, T>(p, sx_p, g, relax, q, false, ps, ds);
        }
        if (update && p.osqp)
          osqp_partials<T>(p, g, gp, relax, t.ux + l, st,
                        __fsub_rn(rb, t.rho0), q, m);
      }
      red[tid] = make_float4(pi, di, ps, ds);
      red[kThreads + tid] = make_float4(m[0], m[1], m[2], m[3]);
      red[2 * kThreads + tid] = make_float4(m[4], m[5], 0.0f, 0.0f);
      __syncthreads();
      if (active) {
        for (int j = 0; j < tpl; ++j) {
          const int o = j * T + l;
          const float4 a = red[o], b = red[kThreads + o],
                       c = red[2 * kThreads + o];
          pi = fmaxf(pi, a.x);
          di = fmaxf(di, a.y);
          ps = fmaxf(ps, a.z);
          ds = fmaxf(ds, a.w);
          m[0] = fmaxf(m[0], b.x);
          m[1] = fmaxf(m[1], b.y);
          m[2] = fmaxf(m[2], b.z);
          m[3] = fmaxf(m[3], b.w);
          m[4] = fmaxf(m[4], c.x);
          m[5] = fmaxf(m[5], c.y);
        }
        if (update)
          rho_new = p.osqp ? osqp_predict(p, m, rb)
                           : termination_predict(p, t.gm, fmaxf(ps, pi),
                                                 fmaxf(ds, di), rb);
        // the latch: dual residuals scale by the post-update rho
        newly = check && ps < p.pri_tol && pi < p.pri_tol &&
                __fmul_rn(ds, rho_new) < p.dua_tol &&
                __fmul_rn(di, rho_new) < p.dua_tol;
      }
    }
    // slack, dual, output and carry updates; ux becomes vec2
    if (active) {
      const bool latch = p.carry_out && newly;
      side_update_q<kProjU, T>(p, su_p, g, relax, q, false, latch);
      side_update_q<kProjX, T>(p, sx_p, g, relax, q, false, latch);
    }
    if (q == 0) {
      rho_n[l] = rho_new;
      if (newly) {  // the outputs hold vnew/znew; d stays frozen
        p.iters[lane] = i + 1;
        p.solved[lane] = 1;
        done[l] = 1;
        atomicAdd(n_done, 1);
      }
    }
    __syncthreads();
    cur ^= 1;
    if (*n_done == t.nvalid) break;  // every lane of the tile has latched

    // backward: cost fold at the pre-update drho, gain at the post-update
    backward<RPT, T>(p, t, lo, rho_b, rho_n);
    __syncthreads();
  }

  // the outputs from the resident state, the rho, d and the carry of the
  // lanes that never latched: their last state
  if (valid) {
    const LaneState st = lane_state<T>(p, t, l);
    const int S = st.stride;
    const bool carry = p.carry_out && !done[l];
    if (q == 0) p.rho_out[lane] = rho_s[cur * T + l];
    for (int r = q; r < su; r += tpl) {
      const float z = st.z[r * S];
      if (t.state) {
        p.uout[r * B + lane] = z;
        p.y[r * B + lane] = st.y[r * S];
      }
      if (p.carry_out) p.d_out[r * B + lane] = t.vec1[r * T + l];
      if (carry) p.zco[r * B + lane] = z;
    }
    for (int r = q; r < sx; r += tpl) {
      const float v = st.v[r * S];
      if (t.state) {
        p.xout[r * B + lane] = v;
        if (st.g) p.g[r * B + lane] = st.g[r * S];
      }
      if (carry) p.vco[r * B + lane] = v;
    }
  }
}

// The kernel for RPT rows a thread and tiles of T lanes, with the
// projections the sides need.
template <int RPT, int T>
void (*tile_kernel(bool proj_u, bool proj_x))(Params) {
  return proj_u ? (proj_x ? condensed_adaptive_kernel<RPT, T, true, true>
                          : condensed_adaptive_kernel<RPT, T, true, false>)
                : (proj_x ? condensed_adaptive_kernel<RPT, T, false, true>
                          : condensed_adaptive_kernel<RPT, T, false, false>);
}

}  // namespace

extern "C" int tinympc_condensed_adaptive(
    const float* t1t, const float* t2t, const void* t1a, const void* t2a,
    const float* rho0, const float* trust_lo, const float* trust_hi,
    const float* umin, const float* umax, const float* xmin,
    const float* xmax, const float* x0, const float* d_in, const float* y_in,
    const float* g_in, const float* v_in, const float* z_in,
    const float* rho_in, float* xout, float* uout, int* iters, int* solved,
    float* rho_out, float* y, float* g, float* d_out, float* vco, float* zco,
    const float* A, const float* Bm, const float* qd, const float* rd,
    const float* P0, const float* dP, int nx, int nu, int N, int G, int L,
    int order, int max_iter, int ct, int lo_all, float alpha,
    float one_m_alpha, float pri_tol, float dua_tol, float rho_min,
    float rho_max, float rho0_one, float trust_lo_one, float trust_hi_one,
    int osqp, int clipping, int trust, int en_input_bound,
    int en_state_bound, int warm_start, int carry_out, int tile, int rpt,
    int passes1, int passes2, int kp1, int kp2, int resident,
    int state_shared, int smem_bytes, int map_grouped, int plant_grouped,
    int box_u_grouped, int box_x_grouped, const float* lin_u, int n_lin_u,
    const int* soc_u, const float* soc_mu_u, int n_soc_u, int lin_u_grouped,
    int mu_u_grouped, const float* lin_x, int n_lin_x, const int* soc_x,
    const float* soc_mu_x, int n_soc_x, int lin_x_grouped, int mu_x_grouped,
    void* stream) {
  // G groups of L lanes; the *_grouped flags say which arrays carry a
  // leading group axis (rho0 and the trust bounds go with the maps; a
  // single group passes them by value as rho0_one, trust_*_one and null
  // arrays).  The maps' layouts: ld1 = passes1 x W, ld2 = passes2 x W rows
  // (W = 512 rpt / tile, the product's rows at once); t1a/t2a: the
  // bf16 maps of reduced iterations (lo_all), k padded to kp1/kp2.
  // lin_*: (n_lin, 2*dim + 1) device rows; soc_*: n_soc (start, dim) pairs
  // in host memory; soc_mu_*: (n_soc,) on the device.
  Params p;
  p.t1t = t1t; p.t2t = t2t;
  p.t1a = lo_all ? static_cast<const __nv_bfloat16*>(t1a) : nullptr;
  p.t2a = lo_all ? static_cast<const __nv_bfloat16*>(t2a) : nullptr;
  p.rho0 = rho0; p.trust_lo = trust_lo; p.trust_hi = trust_hi; p.x0 = x0;
  p.d_in = d_in; p.y_in = y_in; p.g_in = g_in; p.v_in = v_in; p.z_in = z_in;
  p.rho_in = rho_in;
  p.xout = xout; p.uout = uout; p.iters = iters; p.solved = solved;
  p.rho_out = rho_out; p.y = y; p.g = g; p.d_out = d_out; p.vco = vco;
  p.zco = zco;
  p.A = A; p.Bm = Bm; p.qd = qd; p.rd = rd; p.P0 = P0; p.dP = dP;
  p.nx = nx; p.nu = nu; p.N = N;
  p.su = (N - 1) * nu; p.sx = N * nx; p.sw = p.su + p.sx;
  p.in1 = p.su + nx + 1; p.B = G * L; p.L = L;
  p.ord1 = order + 1;
  const int W = tile > 0 ? rpt * (2 * kThreads / tile) : 0;
  p.passes1 = passes1; p.passes2 = passes2;
  p.ld1 = passes1 * W; p.ld2 = passes2 * W; p.kp1 = kp1; p.kp2 = kp2;
  p.max_iter = max_iter; p.ct = ct; p.lo_all = lo_all;
  p.alpha = alpha; p.one_m_alpha = one_m_alpha;
  p.pri_tol = pri_tol; p.dua_tol = dua_tol;
  p.rho_min = rho_min; p.rho_max = rho_max;
  p.rho0_one = rho0_one; p.trust_lo_one = trust_lo_one;
  p.trust_hi_one = trust_hi_one;
  p.osqp = osqp; p.clipping = clipping; p.trust = trust;
  p.warm_start = warm_start; p.carry_out = carry_out; p.resident = resident;
  p.state_shared = state_shared;
  p.map_grouped = map_grouped; p.plant_grouped = plant_grouped;
  // no state-side constraint at all: g == 0 and vnew = x_hat
  p.state_free = !en_state_bound && n_lin_x == 0 && n_soc_x == 0;
  // the caller owns the layout; refuse one the kernel would overrun
  const size_t need =
      k2_layout(tile, W, p.in1, p.sw, p.ord1, p.ld1, p.ld2, kp1, kp2,
                state_shared ? state_rows(p.su, p.sx, p.state_free) : 0,
                resident, lo_all)
          .total;
  if (G <= 0 || L <= 0 || G > 65535 || (tile != 32 && tile != 16) ||
      ct < 1 || order < 1 ||
      p.ld1 < p.sw || p.ld2 < 4 * p.su ||
      smem_bytes < 0 || static_cast<size_t>(smem_bytes) < need ||
      (G > 1 && (!rho0 || !trust_lo || !trust_hi)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (lo_all && (!t1a || !t2a || kp1 < p.in1 || kp2 < p.sw + 1 ||
                 kp1 % kSlabKLo != 0 || kp2 % kSlabKLo != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (warm_start && (!d_in || !y_in || !v_in || !z_in || !rho_in ||
                     (!p.state_free && !g_in)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (carry_out && (!d_out || !vco || !zco))
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
  void (*kernel)(Params);
  // the instances adaptive_tile_plan picks from
  if (tile == 32 && rpt == 8)
    kernel = tile_kernel<8, 32>(proj_u, proj_x);
  else if (tile == 32 && rpt == 20)
    kernel = tile_kernel<20, 32>(proj_u, proj_x);
  else if (tile == 16 && rpt == 8)
    kernel = tile_kernel<8, 16>(proj_u, proj_x);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(smem_bytes);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L + tile - 1) / tile, G);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
