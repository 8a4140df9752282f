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
// Over a tile of T lanes the matvecs are one small GEMM, (sw x sw) x (sw x
// T): 2*sw^2 FLOP a lane and iteration (19.6k at the cartpole's sw = 99,
// 200k at the quadrotor's sw = 316) against on-chip traffic only, so what
// bounds the kernel is the rate at which the SM feeds T12 and the iterates
// to its FMA units (or tensor cores), not device memory.  The quadrotor's
// map (316 x 316, 404 KB in fp32) does not fit in a block's 227 KB of
// shared memory.  The design is the Pallas kernel's tile-level matmul, for
// Hopper:
//  * A block of 256 threads owns a tile of 32 lanes and computes the
//    tile's product T12w @ w2 as a GEMM (tile_gemm.cuh, shared with kernel
//    K2).  Each thread keeps a register tile of RPT rows x 2 lanes (40
//    outputs at the quadrotor shape), so one k step is RPT/4 16-byte and
//    one 8-byte shared loads for 2 RPT FMAs.  The 16 thread rows cover 16
//    RPT rows of the map at once; a wider map (the quadrotor at a horizon
//    above 32) runs in passes of 16 RPT rows, the sums of all but the last
//    pass parked in a global scratch of the tile's lanes until every
//    thread is done reading w2.
//  * Each output is summed over k in index order by one thread with fmaf,
//    so a lane's fp32 result does not depend on its tile-mates or the tile
//    size (and equals the plain version's wherever cuBLAS sums in index
//    order).  No TF32: the fp32 product never touches the tensor cores.
//  * T12 (transposed, rows padded to the passes' 16 RPT each) is resident
//    in shared memory where it fits beside the tile and otherwise streamed
//    from L2 in slabs of kSlabK k-rows of one pass through a ring of
//    kStages slots filled by cp.async: kStages - 1 slabs are in flight
//    while the block multiplies one.  (A two-slot ring times the same at
//    the quadrotor shape: the slabs' latency is not what bounds the
//    streamed product; PERF.md section 6.)
//  * The tile's w2 lives in shared memory as [row][lane], a single buffer:
//    after a barrier the product overwrites it (latched lanes keep theirs),
//    and the elementwise step adds uxc and turns ux into the next w2 in
//    place.  A map too wide for the tile's w2 beside the ring keeps each
//    tile's w2 in its own columns of a global (sw, tiles x 32) array
//    (kWG), whose k-rows stream through the ring slots beside the map's
//    (tile_gemm.cuh), so the block's shared memory no longer grows with
//    the width; with reduced iterations w2 is rounded once an iteration
//    into the tile's rows of a global bf16 array and streamed the same
//    way.  A latched lane's carry is its state before its latching
//    iteration: with carry_out, every checking iteration copies the tile's
//    w2 to w2_out before the product, a latching lane writes its slacks'
//    old values as the carry's v/z, and lanes that never latch write their
//    final w2, v and z at the end.
//  * The lanes' solver state (uxc, the slacks z and v, the duals y and g)
//    lives in shared memory as [row][lane] where it fits beside the tile
//    (every plant of the repo, the quadrotor's 708 floats a lane included),
//    so the elementwise step touches no global memory; it is read from the
//    (dim, B) outputs before the loop and written back after it.  Where it
//    does not fit it stays in those global arrays.
//  * The elementwise step runs on all 256 threads: the eight threads of a
//    lane split each side's rows (box only) or stages (projected).  A
//    shared count of latched lanes ends the tile's loop when every lane of
//    the tile has latched (the Pallas kernel's exit).
//  * Reduced precision (K1c) runs on the tensor cores: the map is stored as
//    real bf16, row-major [row][k] (half the bytes; resident, or streamed in
//    slabs of kSlabKLo k-columns through the same ring, kStagesLo slots),
//    w2 is rounded to bf16 (round to nearest even) into a [lane][k] buffer
//    as it is staged, and mma.sync.m16n8k16 multiplies them; warps split
//    the rows of a pass in four and the lanes in two groups of 16.  Each k16 step's 16 exact products are
//    summed from zero in the tensor core and added to an fp32 running sum.
//    Rows of both buffers are padded by 8 bf16 so ldmatrix reads them
//    without bank conflicts.  The sums are in the tensor cores' order, the
//    same for every lane and tile: deterministic and lane-independent.  The
//    plain version sums as the tensor cores do (mma_product), so the two
//    agree to the bit.
//  * The elementwise arithmetic (relaxation, the box, halfspace and cone
//    projections, residuals, dual ascent), in round-to-nearest and the plain
//    version's order of operations, is projections.cuh's, shared with the
//    adaptive kernel.
//  * Group grid: the grid is (tiles per group, G).  A block reads its
//    group's T12, rollout columns, rho, bounds and constraint data by a
//    group offset into G-stacked arrays (offset 0 where an array is shared)
//    and stages its own group's T12; the last tile of every group is ragged
//    and masked.  Lanes keep the flat order lane = g * L + l.
//  * Reduced iterations: the first k0 iterations (the head) are reduced,
//    and all of them with lo_all; an iteration that runs the residual check
//    always takes the fp32 product, so what a lane latches is a true rollout
//    of its iterate and a true residual.  The head checks only on its last
//    iteration.
//
// Launch contract: the Python wrapper (fused_tile_plan) picks the rows a
// thread (8, 20 or 32 with w2 in shared memory, 32 with w2 in global
// memory: the instances), the passes, the padded layouts (swp = passes x
// 16 RPT rows of the transposed map; kp columns of the bf16 map), whether
// the map and the state are resident
// and the dynamic shared-memory size; the entry point refuses a layout the
// kernel would overrun and a constraint set whose arrays are missing (the
// wrapper checks the cones' extents).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "projections.cuh"
#include "tile_gemm.cuh"

namespace {

using namespace tinympc;

constexpr int kLaneThreads = Lanes<kTile>::kLaneThreads;  // threads a lane: 8
constexpr int kRowGroups = Lanes<kTile>::kRowGroups;  // product rows: 16

struct Params {
  // the maps, with a leading group axis where map_grouped
  const float* t12t;  // (sw, swp) T12w transposed, rows padded to swp
  const __nv_bfloat16* t12a;  // (swp, kp) T12w in bf16; null without
                              // reduced iterations
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
  float* uxc;         // (sw, B) x0/const rollout (+ T12c after iteration 0);
                      // unused where the state is in shared memory
  float* w2_out;      // (sw, B) carry outputs; null without carry_out
  float* vco;         // (sx, B)
  float* zco;         // (su, B)
  float* park;        // (sw, B) the sums of all but the last pass; null
                      // with one pass
  float* wsc;         // (sw, B) the projection scratch where the stage
                      // buffers leave no room in shared memory; else null
  float* w2g;         // (sw, ldg) the tiles' w2 in global memory (kWG)
  __nv_bfloat16* w2hg;  // (ldg, kp) its bf16 rounding (kWG, reduced)
  int nx, su, sx, sw, swp, kp, B, L;  // B = G * L lanes, L in each group
  int tiles, ldg;     // tiles a group; columns of the tiles' global arrays
  int passes;         // passes of the product's rows at once
  int max_iter, ct, k0, lo_all;
  float alpha, one_m_alpha, pri_tol, dua_tol;
  int state_free, warm_start, carry_out, t12_resident, state_shared;
  int map_grouped, rho_grouped;
  Side side_u, side_x;
};

// The head checks on its last iteration only; a checking iteration's
// product is never reduced.
__device__ __forceinline__ bool is_check(const Params& p, int i) {
  return i < p.k0 ? i == p.k0 - 1 : (i + 1) % p.ct == 0;
}

__device__ __forceinline__ bool is_reduced(const Params& p, int i,
                                           bool check) {
  return (i < p.k0 || p.lo_all) && !check;
}

// Floats of one lane's solver state: uxc (sw), y and z (su each), v (sx)
// and, with a state constraint, g (sx).
__host__ __device__ inline int state_rows(int su, int sx, int sw,
                                          bool state_free) {
  return sw + 2 * su + (state_free ? 1 : 2) * sx;
}

// Byte offsets of the block's shared memory: the tile's w2 (sw x kTile
// floats; none with wg, where it lives in global memory), the latch flags
// (kTile + 1 ints), the residual partials of the
// lanes' threads (kThreads float4), the lanes' solver state where it is
// resident ([row][lane]), the map region (resident: the fp32 map, then the
// bf16 one with reduced iterations; streamed: the slab ring of a pass of W
// rows, fp32 or bf16 slabs in turn, each slot with the tile's w2 rows
// beside the map's where wg), the bf16 w2 ([lane][k], reduced only; in
// global memory with wg).
struct TileLayout {
  size_t flags, red, state, map, maplo, w2h, total;
};

__host__ __device__ inline TileLayout tile_layout(bool wg, int sw,
                                                  int swp, int W, int kp,
                                                  int state_floats,
                                                  bool resident,
                                                  bool reduced) {
  TileLayout t;
  size_t off = wg ? 0 : up16(sizeof(float) * static_cast<size_t>(sw) * kTile);
  t.flags = off;
  off += up16(sizeof(int) * (kTile + 1));
  t.red = off;
  off += up16(sizeof(float) * 4 * kThreads);
  t.state = off;
  off += up16(sizeof(float) * static_cast<size_t>(state_floats) * kTile);
  t.map = off;
  if (resident) {
    off += up16(sizeof(float) * static_cast<size_t>(sw) * swp);
    t.maplo = off;
    if (reduced) off += up16(2 * static_cast<size_t>(swp) * (kp + kPadLo));
  } else {
    const int wt = wg ? kTile : 0;
    size_t ring = ring_bytes(W, false, wt);
    if (reduced && ring_bytes(W, true, wt) > ring) ring = ring_bytes(W, true, wt);
    off += up16(ring);
    t.maplo = t.map;
  }
  t.w2h = off;
  if (reduced && !wg) off += up16(2 * static_cast<size_t>(kTile) * (kp + kPadLo));
  t.total = off;
  return t;
}

// One lane's solver state for the elementwise step: element r of an array
// at [r * stride] from the lane's own base (its column of a [row][lane]
// shared array, stride kTile, or of a (dim, B) global one, stride B).
struct LaneState {
  float* uxc;   // (sw) rollout constant
  float* y;     // (su) input dual
  float* z;     // (su) input slack (the output u)
  float* v;     // (sx) state slack (the output x)
  float* g;     // (sx) state dual; null: the state-free path
  int stride;
};

// What one block works on.
struct Tile {
  float* buf;                  // (sw, kTile) w2, then ux, then the next w2:
                               // element (r, l) at buf[r * bs + l]
  int bs;                      // kTile in shared memory; ldg in global (kWG)
  const int* done;             // (kTile,) latched (or absent) lanes
  float* ring;                 // streamed slabs; null where resident
  const float* map;            // resident fp32 map (sw, swp), or the group's
                               // map in global memory when streamed
  const __nv_bfloat16* amap;   // resident bf16 map (swp, kp + kPadLo), or
                               // the group's (swp, kp) in global memory
  __nv_bfloat16* w2h;          // (kTile, kp + kPadLo) rounded w2; with kWG
                               // the tile's (kTile, kp) rows of w2hg
  float* state;                // resident solver state, or null
  float* stage;                // the projected stages' buffers in shared
                               // memory (thread tid's entry j at
                               // stage[j * kThreads + tid]), or null
  int tid, lane0, nvalid;
};

// Lane l's state (l: its index in the tile).
__device__ __forceinline__ LaneState lane_state(const Params& p,
                                                const Tile& t, int l) {
  LaneState s;
  if (t.state) {
    float* b = t.state + l;
    s.uxc = b;
    s.y = b + p.sw * kTile;
    s.z = s.y + p.su * kTile;
    s.v = s.z + p.su * kTile;
    s.g = p.state_free ? nullptr : s.v + p.sx * kTile;
    s.stride = kTile;
  } else {
    const int lane = t.lane0 + l;
    s.uxc = p.uxc + lane;
    s.y = p.y + lane;
    s.z = p.uout + lane;
    s.v = p.xout + lane;
    s.g = p.state_free ? nullptr : p.g + lane;
    s.stride = p.B;
  }
  return s;
}

// Lane l's state before iteration 0, rows q, q + kLaneThreads, ... of each
// array: uxc = Tx0 @ x0 + T1c (+ T12c on a warm start, whose every
// iteration replays the fused matmul), w2, the slacks and duals.
__device__ __forceinline__ void lane_init(const Params& p, const Tile& t,
                                          int l, int q, const float* tx0,
                                          const float* t1c,
                                          const float* t12c) {
  const int lane = t.lane0 + l, B = p.B;
  const LaneState st = lane_state(p, t, l);
  const int S = st.stride;
  for (int r = q; r < p.sw; r += kLaneThreads) {
    float acc = 0.0f;
    for (int j = 0; j < p.nx; ++j)
      acc = fmaf(tx0[r * p.nx + j], p.x0[lane * p.nx + j], acc);
    float c = __fadd_rn(acc, t1c[r]);
    if (p.warm_start) c = __fadd_rn(c, t12c[r]);
    st.uxc[r * S] = c;
    t.buf[r * t.bs + l] = p.warm_start ? p.w2_in[r * B + lane] : 0.0f;
  }
  for (int r = q; r < p.su; r += kLaneThreads) {
    st.y[r * S] = p.warm_start ? p.y_in[r * B + lane] : 0.0f;
    st.z[r * S] = p.warm_start ? p.z_in[r * B + lane] : 0.0f;
  }
  for (int r = q; r < p.sx; r += kLaneThreads) {
    if (st.g) st.g[r * S] = p.warm_start ? p.g_in[r * B + lane] : 0.0f;
    st.v[r * S] = p.warm_start ? p.v_in[r * B + lane] : 0.0f;
  }
  if (q == 0) {
    p.iters[lane] = p.max_iter;
    p.solved[lane] = 0;
  }
}

// The product T12w @ w2 into the buffer, for the rows and lanes that take
// it: within the map, a lane of the group that has not latched (the
// elementwise step adds uxc).
__device__ __forceinline__ void tile_store(const Params& p, const Tile& t,
                                           int r, int l, float acc) {
  if (r < p.sw && l < t.nvalid && !t.done[l]) t.buf[r * t.bs + l] = acc;
}

// The epilogue of pass j of either product: all but the last pass park
// their sums in the global scratch; the last waits until every thread is
// done reading w2, then stores its own sums and brings its parked ones
// back (each thread reads only what it parked itself).
template <class Frag, int kN>
__device__ __forceinline__ void tile_epilogue(const Params& p, const Tile& t,
                                              int W, int j,
                                              const float (&acc)[kN],
                                              const Frag& fr) {
  if (j + 1 < p.passes) {
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      const int r = j * W + fr.row(e), l = fr.lane(e);
      if (r < p.sw && l < t.nvalid)
        p.park[static_cast<size_t>(r) * p.B + t.lane0 + l] = acc[e];
    }
    return;
  }
  __syncthreads();  // every thread is done reading w2
#pragma unroll
  for (int e = 0; e < kN; ++e)
    tile_store(p, t, j * W + fr.row(e), fr.lane(e), acc[e]);
  for (int jp = 0; jp < j; ++jp)
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      const int r = jp * W + fr.row(e), l = fr.lane(e);
      if (r < p.sw && l < t.nvalid)
        tile_store(p, t, r, l,
                   p.park[static_cast<size_t>(r) * p.B + t.lane0 + l]);
    }
}

// The fp32 product, pass by pass: thread (tr, tl) owns rows tr*RPT ..
// +RPT-1 of the pass, lanes 2 tl, 2 tl + 1, and sums each over k in index
// order with fmaf.
template <int RPT, bool kWG>
__device__ __forceinline__ void tile_product_fp32(const Params& p,
                                                  const Tile& t) {
  const int W = kRowGroups * RPT;
  const GemmF32 a{t.buf, t.ring, p.sw, W, p.swp, p.passes, t.tid, t.bs};
  gemm_fp32<RPT, kTile, kWG>(
      a, [&](int j) { return t.map + j * W; },
      [&](int j, const float(&acc)[2 * RPT], const FragF32<RPT>& fr) {
        tile_epilogue(p, t, W, j, acc, fr);
      });
}

// The reduced product on the tensor cores, pass by pass: w2 rounded to
// bf16 into w2h[lane][k], then per warp (wm, wn) the rows wm*4*RPT ..
// +4*RPT-1 of the pass (RPT/4 tiles of 16) of lanes wn*16 .. +15 (two tiles
// of 8), k in steps of 16.
template <int RPT, bool kWG>
__device__ __forceinline__ void tile_product_lo(const Params& p,
                                                const Tile& t) {
  const int W = kRowGroups * RPT;
  const int lda = t.ring ? p.kp : p.kp + kPadLo;
  const GemmLo a{t.buf, t.w2h, reinterpret_cast<__nv_bfloat16*>(t.ring),
                 p.sw, p.kp, W, p.passes, t.tid, lda, t.bs};
  gemm_lo<RPT, kTile, kWG>(
      a, [&](int j) { return t.amap + static_cast<size_t>(j) * W * lda; },
      [&](int j, const float(&acc)[2 * RPT], const FragLo<RPT>& fr) {
        tile_epilogue(p, t, W, j, acc, fr);
      });
}

// The elementwise part of iteration i for the whole tile: thread q of lane l
// works on its share of both sides; on a checking iteration the lane's
// partial maxima meet in shared memory (a max is exact in any order) and
// every thread of the lane takes the same latch decision.  Returns whether
// lane l latched, from its thread 0 (which writes the count).
template <bool kProjU, bool kProjX>
__device__ __forceinline__ bool tile_step(const Params& p, const Tile& t,
                                          float4* red, int g, float rho,
                                          int i, bool check, bool add) {
  const int l = t.tid % kTile, q = t.tid / kTile;
  const int lane = t.lane0 + l;
  const bool active = !t.done[l];
  const bool relax = p.alpha != 1.0f;
  const LaneState st = lane_state(p, t, l);
  // where a projected stage is projected: the thread's own buffer in
  // shared memory, or the lane's rows of the global scratch
  float *wu = nullptr, *wx = nullptr;
  int ws = 0, wku = 0, wkx = 0;
  if (t.stage) {
    wu = wx = t.stage + t.tid;
    ws = kThreads;
  } else if (p.wsc) {
    wu = p.wsc + lane;
    wx = wu + p.su * p.B;
    ws = p.B;
    wku = p.side_u.dim * p.B;
    wkx = p.side_x.dim * p.B;
  }
  const SidePass su{&p.side_u, t.buf + l, st.z, st.y, st.uxc,
                    p.zco + lane, st.stride, t.bs, wu, ws, wku};
  const SidePass sx{&p.side_x, t.buf + l + p.su * t.bs, st.v, st.g,
                    st.uxc + p.su * st.stride, p.vco + lane, st.stride,
                    t.bs, wx, ws, wkx};
  bool newly = false;
  if (check) {
    float pi = 0.0f, di = 0.0f, ps = 0.0f, ds = 0.0f;
    if (active) {
      side_residuals_q<kProjU>(p, su, g, relax, q, add, pi, di);
      side_residuals_q<kProjX>(p, sx, g, relax, q, add, ps, ds);
    }
    red[q * kTile + l] = make_float4(pi, di, ps, ds);
    __syncthreads();
    if (active) {
      for (int j = 0; j < kLaneThreads; ++j) {
        const float4 v = red[j * kTile + l];
        pi = fmaxf(pi, v.x);
        di = fmaxf(di, v.y);
        ps = fmaxf(ps, v.z);
        ds = fmaxf(ds, v.w);
      }
      newly = ps < p.pri_tol && pi < p.pri_tol &&
              __fmul_rn(ds, rho) < p.dua_tol &&
              __fmul_rn(di, rho) < p.dua_tol;
    }
    add = false;  // the residual pass completed ux
  }
  if (active) {
    const bool latch = p.carry_out && newly;
    side_update_q<kProjU>(p, su, g, relax, q, add, latch);
    side_update_q<kProjX>(p, sx, g, relax, q, add, latch);
  }
  if (newly && q == 0) {
    p.iters[lane] = i + 1;
    p.solved[lane] = 1;
  }
  return newly && q == 0;
}

// RPT: rows a thread of the product; kWG: the tile's w2 in
// global memory (streamed beside the map); kProjU/kProjX: whether the
// input / state side has halfspaces or cones.
template <int RPT, bool kWG, bool kProjU, bool kProjX>
__global__ void __launch_bounds__(kThreads, RPT <= 8 ? 2 : 1)
    condensed_fused_kernel(Params p) {
  extern __shared__ float4 smem4[];
  char* sm = reinterpret_cast<char*>(smem4);
  const int tid = threadIdx.x;
  const int g = blockIdx.y;
  const int l0 = blockIdx.x * kTile;  // the tile's first index in the group
  const int sw = p.sw, swp = p.swp, kp = p.kp;
  const bool reduced = p.t12a != nullptr;
  const TileLayout lay = tile_layout(
      kWG, sw, swp, kRowGroups * RPT, kp,
      p.state_shared ? state_rows(p.su, p.sx, sw, p.state_free) : 0,
      p.t12_resident, reduced);

  Tile t;
  t.tid = tid;
  t.lane0 = g * p.L + l0;
  t.nvalid = min(kTile, p.L - l0);
  // the tile's own columns of the global arrays
  const size_t col0 = static_cast<size_t>(g * p.tiles + blockIdx.x) * kTile;
  if constexpr (kWG) {
    t.buf = p.w2g + col0;
    t.bs = p.ldg;
    t.w2h = reduced ? p.w2hg + col0 * kp : nullptr;
  } else {
    t.buf = reinterpret_cast<float*>(sm);
    t.bs = kTile;
    t.w2h =
        reduced ? reinterpret_cast<__nv_bfloat16*>(sm + lay.w2h) : nullptr;
  }
  int* done = reinterpret_cast<int*>(sm + lay.flags);
  int* n_done = done + kTile;
  t.done = done;
  t.stage = (kProjU || kProjX) && !p.wsc
                ? reinterpret_cast<float*>(sm + lay.total)
                : nullptr;
  float4* red = reinterpret_cast<float4*>(sm + lay.red);
  t.state = p.state_shared ? reinterpret_cast<float*>(sm + lay.state)
                           : nullptr;

  const int gm = p.map_grouped ? g : 0;
  const float* t12 = p.t12t + static_cast<size_t>(gm) * sw * swp;
  const __nv_bfloat16* t12a =
      reduced ? p.t12a + static_cast<size_t>(gm) * swp * kp : nullptr;
  const float* t12c = p.t12c + gm * sw;
  const float rho = p.rho[p.rho_grouped ? g : 0];
  if (p.t12_resident) {
    float* map = reinterpret_cast<float*>(sm + lay.map);
    for (int e = tid; e < sw * swp; e += kThreads) map[e] = t12[e];
    t.map = map;
    t.ring = nullptr;
    if (reduced) {
      __nv_bfloat16* a = reinterpret_cast<__nv_bfloat16*>(sm + lay.maplo);
      for (int e = tid; e < swp * kp; e += kThreads) {
        const int r = e / kp, k = e - r * kp;
        a[r * (kp + kPadLo) + k] = t12a[e];
      }
      t.amap = a;
    }
  } else {
    t.map = t12;
    t.amap = t12a;
    t.ring = reinterpret_cast<float*>(sm + lay.map);
  }
  {
    const int l = tid % kTile, q = tid / kTile;
    if (q == 0) done[l] = l < t.nvalid ? 0 : 1;
    if (l < t.nvalid)
      lane_init(p, t, l, q, p.tx0 + gm * sw * p.nx, p.t1c + gm * sw, t12c);
    else
      for (int r = q; r < sw; r += kLaneThreads) t.buf[r * t.bs + l] = 0.0f;
  }
  if (tid == 0) *n_done = 0;
  __syncthreads();

  for (int i = 0; i < p.max_iter; ++i) {
    const bool check = is_check(p, i);
    if (i == 0 && !p.warm_start) {
      // cold iteration 0: d = 0, so ux is the pure rollout (no matmul); the
      // fused-map constant joins uxc only after it
      const int l = tid % kTile, q = tid / kTile;
      if (l < t.nvalid) {
        const LaneState st = lane_state(p, t, l);
        for (int r = q; r < sw; r += kLaneThreads) {
          const float c = st.uxc[r * st.stride];
          t.buf[r * t.bs + l] = c;
          st.uxc[r * st.stride] = __fadd_rn(c, t12c[r]);
        }
      }
    } else {
      if (check && p.carry_out)  // a lane that latches now keeps this w2
        for (int e = tid; e < sw * kTile; e += kThreads) {
          const int r = e / kTile, l = e - r * kTile;
          if (!done[l]) p.w2_out[r * p.B + t.lane0 + l] = t.buf[r * t.bs + l];
        }
      if (is_reduced(p, i, check))
        tile_product_lo<RPT, kWG>(p, t);
      else
        tile_product_fp32<RPT, kWG>(p, t);
    }
    __syncthreads();
    if (tile_step<kProjU, kProjX>(p, t, red, g, rho, i, check,
                                  i > 0 || p.warm_start)) {
      done[tid % kTile] = 1;
      atomicAdd(n_done, 1);
    }
    __syncthreads();
    if (*n_done == t.nvalid) break;  // every lane of the tile has latched
  }

  // the outputs from the resident state, and the carry of the lanes that
  // never latched: their last state
  const int l = tid % kTile, q = tid / kTile, lane = t.lane0 + l;
  if (l < t.nvalid) {
    const LaneState st = lane_state(p, t, l);
    const int S = st.stride, B = p.B;
    const bool carry = p.carry_out && !done[l];
    for (int r = q; r < sw; r += kLaneThreads)
      if (carry) p.w2_out[r * B + lane] = t.buf[r * t.bs + l];
    for (int r = q; r < p.su; r += kLaneThreads) {
      const float z = st.z[r * S];
      if (t.state) {
        p.uout[r * B + lane] = z;
        p.y[r * B + lane] = st.y[r * S];
      }
      if (carry) p.zco[r * B + lane] = z;
    }
    for (int r = q; r < p.sx; r += kLaneThreads) {
      const float v = st.v[r * S];
      if (t.state) {
        p.xout[r * B + lane] = v;
        if (st.g) p.g[r * B + lane] = st.g[r * S];
      }
      if (carry) p.vco[r * B + lane] = v;
    }
  }
}

// The kernel for RPT rows a thread and w2 in shared or
// global memory, with the projections the sides need.
template <int RPT, bool kWG>
void (*tile_kernel(bool proj_u, bool proj_x))(Params) {
  return proj_u
             ? (proj_x ? condensed_fused_kernel<RPT, kWG, true, true>
                       : condensed_fused_kernel<RPT, kWG, true, false>)
             : (proj_x ? condensed_fused_kernel<RPT, kWG, false, true>
                       : condensed_fused_kernel<RPT, kWG, false, false>);
}

}  // namespace

extern "C" int tinympc_condensed_fused(
    const float* t12t, const void* t12a, const float* t12c,
    const float* tx0, const float* t1c, const float* rho, const float* umin,
    const float* umax, const float* xmin, const float* xmax, const float* x0,
    const float* w2_in, const float* y_in, const float* g_in,
    const float* v_in, const float* z_in, float* xout, float* uout,
    int* iters, int* solved, float* y, float* g, float* uxc, float* w2_out,
    float* vco, float* zco, float* park, float* wsc, float* w2g, void* w2hg,
    int nx, int nu, int N, int G, int L,
    int max_iter,
    int ct, int k0, int lo_all, float alpha, float one_m_alpha, float pri_tol,
    float dua_tol, int en_input_bound, int en_state_bound, int warm_start,
    int carry_out, int state_shared, int t12_resident, int w2_global,
    int rpt, int swp, int kp,
    int smem_bytes, int map_grouped, int rho_grouped, int box_u_grouped,
    int box_x_grouped, const float* lin_u, int n_lin_u, const int* soc_u,
    const float* soc_mu_u, int n_soc_u, int lin_u_grouped, int mu_u_grouped,
    const float* lin_x, int n_lin_x, const int* soc_x, const float* soc_mu_x,
    int n_soc_x, int lin_x_grouped, int mu_x_grouped, void* stream) {
  // G groups of L lanes; the *_grouped flags say which arrays carry a
  // leading group axis.  lin_*: (n_lin, 2*dim + 1) device rows; soc_*: n_soc
  // (start, dim) pairs on the device; soc_mu_*: (n_soc,) on the device.
  // t12a: the (swp, kp) bf16 map of reduced iterations; swp = the passes x
  // 16 x rpt, the rows a thread (the instances), kp a multiple of
  // kSlabKLo; park: the (sw, B) scratch of a launch of several passes; wsc:
  // the (sw, B) projection scratch of a launch with linear or cone
  // constraints whose stage buffers (kThreads x the widest projected
  // side's dim floats, after the tile's layout) leave no room in
  // smem_bytes, else null;
  // w2_global: the tiles' w2 in w2g (sw, G x tiles x 32), with reduced
  // iterations rounded into w2hg (G x tiles x 32, kp) bf16;
  // state_shared: the lanes' solver state lives in shared memory (else in
  // the (dim, B) arrays, uxc included).
  Params p;
  const bool reduced = k0 > 0 || lo_all;
  p.t12t = t12t; p.t12c = t12c; p.tx0 = tx0; p.t1c = t1c;
  p.t12a = reduced ? static_cast<const __nv_bfloat16*>(t12a) : nullptr;
  p.rho = rho; p.x0 = x0;
  p.w2_in = w2_in; p.y_in = y_in; p.g_in = g_in; p.v_in = v_in; p.z_in = z_in;
  p.xout = xout; p.uout = uout; p.iters = iters; p.solved = solved;
  p.y = y; p.g = g; p.uxc = uxc; p.w2_out = w2_out; p.vco = vco; p.zco = zco;
  p.park = park; p.wsc = wsc; p.w2g = w2g;
  p.w2hg = static_cast<__nv_bfloat16*>(w2hg);
  p.nx = nx; p.su = (N - 1) * nu; p.sx = N * nx; p.sw = p.su + p.sx;
  p.swp = swp; p.kp = kp; p.B = G * L; p.L = L;
  p.tiles = (L + kTile - 1) / kTile;
  p.ldg = G * p.tiles * kTile;
  p.max_iter = max_iter; p.ct = ct; p.k0 = k0; p.lo_all = lo_all;
  p.alpha = alpha; p.one_m_alpha = one_m_alpha;
  p.pri_tol = pri_tol; p.dua_tol = dua_tol;
  p.warm_start = warm_start; p.carry_out = carry_out;
  p.t12_resident = t12_resident; p.state_shared = state_shared;
  p.map_grouped = map_grouped; p.rho_grouped = rho_grouped;
  // no state-side constraint at all: g == 0 and vnew = x_hat
  p.state_free = !en_state_bound && n_lin_x == 0 && n_soc_x == 0;
  // the caller owns the layout; refuse one the kernel would overrun
  const int W = kRowGroups * rpt;
  p.passes = rpt > 0 ? swp / W : 0;
  const bool wg = w2_global != 0;
  const size_t need =
      tile_layout(wg, p.sw, swp, W, kp,
                  state_shared ? state_rows(p.su, p.sx, p.sw, p.state_free)
                               : 0,
                  t12_resident, reduced)
          .total;
  const bool proj_u = n_lin_u + n_soc_u > 0, proj_x = n_lin_x + n_soc_x > 0;
  const int sdim = proj_x && (!proj_u || nx > nu) ? nx : nu;
  const size_t stage =
      (proj_u || proj_x) && !wsc ? sizeof(float) * kThreads * sdim : 0;
  if (G <= 0 || L <= 0 || G > 65535 || ct < 1 || k0 < 0 || k0 > max_iter ||
      rpt <= 0 || swp < p.sw || swp != p.passes * W ||
      (p.passes > 1 && !park) ||
      (wg && (!w2g || t12_resident || (reduced && !w2hg))) ||
      kp % kSlabKLo != 0 || kp < p.sw || smem_bytes < 0 ||
      static_cast<size_t>(smem_bytes) < need + stage || !rho ||
      (reduced && !t12a))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!init_side(p.side_u, umin, umax, lin_u, n_lin_u, soc_u, soc_mu_u,
                 n_soc_u, nu, N - 1, en_input_bound, box_u_grouped,
                 lin_u_grouped, mu_u_grouped) ||
      !init_side(p.side_x, xmin, xmax, lin_x, n_lin_x, soc_x, soc_mu_x,
                 n_soc_x, nx, N, en_state_bound, box_x_grouped, lin_x_grouped,
                 mu_x_grouped))
    return static_cast<int>(cudaErrorInvalidValue);

  void (*kernel)(Params) = nullptr;
  // the instances fused_tile_plan picks from
  if (!wg && rpt == 8)
    kernel = tile_kernel<8, false>(proj_u, proj_x);
  else if (!wg && rpt == 20)
    kernel = tile_kernel<20, false>(proj_u, proj_x);
  else if (!wg && rpt == 32)
    kernel = tile_kernel<32, false>(proj_u, proj_x);
  else if (wg && rpt == 32)
    kernel = tile_kernel<32, true>(proj_u, proj_x);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(smem_bytes);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.tiles, G);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
