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
//  * Where the tile's w2 lives in shared memory and the map streams (the
//    quadrotor at N = 20-56, the 20-state chain, the rocket at N = 40), the
//    4-lane layout: the fp32 product's thread tile is 10 rows x 4 lanes
//    (fewer shared-memory loads an FMA), in passes of W = 320 rows, the
//    map laid out pass by pass (a pass's [k][row] block after the earlier
//    passes', the last pass's rows padded only to a thread's), so that a
//    slab of 16 k-rows of any pass is one bulk copy, issued by thread 0
//    once every warp has freed its slot (the warps wait on the slab's
//    mbarrier, not on a block barrier a slab); the sums of every pass but
//    the last are parked as on 2 lanes, and a checking iteration takes a
//    box side's residuals and updates in one pass (the carry's slack
//    written ahead, as a projected side's pass does).
//  * The tile's w2 lives in shared memory as [row][lane], a single buffer:
//    after a barrier the product overwrites it (latched lanes keep theirs),
//    and the elementwise step adds uxc and turns ux into the next w2 in
//    place.
//  * A map too wide for the tile's w2 beside the ring splits the tile over
//    a thread block cluster of C blocks (In::kCluster; C from 2 to 8 on as
//    many SMs, fused_tile_plan's choice): block c owns a slice of whole
//    stages (their rows of w2, ux and the map, and their share of the
//    elementwise step) and keeps its rows of w2 in its own shared memory;
//    its product runs its own rows of the map over every k-row of w2, the
//    peers' reaching its ring over distributed shared memory
//    (tile_gemm.cuh).  The product's store waits at a cluster barrier
//    until no block reads w2 any more, the next product at another until
//    every block's next w2 is written, and a checking iteration's residual
//    maxima meet over the cluster, so every block latches the same lanes.
//    The map's rows are laid out slice by slice (each padded to the
//    block's passes of W rows; the padding is neither copied nor
//    multiplied), the solver state stays in global memory.  One SM no
//    longer runs a whole tile, and the map's bytes a block streams shrink
//    C-fold.  Where even a cluster's slices do not fit, each tile keeps
//    its w2 in its own columns of a global (sw, tiles x 32) array
//    (In::kGlobal), whose k-rows stream through the ring slots beside the
//    map's, so the block's shared memory does not grow with the width;
//    with reduced iterations w2 is rounded once an iteration into the
//    tile's rows of a global bf16 array and streamed the same way.
//  * A latched lane's carry is its state before its latching
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
//  * A narrow map (at most 128 rows: the cartpole's, the MPC loop's) with
//    box constraints only, in fp32, takes the warp layout instead
//    (condensed_fused_warp_kernel below): lane groups of 8 lanes owned by
//    warps, no block barrier an iteration, a warp taking its next lane
//    group from the launch's queue, so a few slow lanes no longer hold a
//    32-lane tile's block and a launch of few live lanes spreads over
//    every SM.
//  * Reduced iterations: the first k0 iterations (the head) are reduced,
//    and all of them with lo_all; an iteration that runs the residual check
//    always takes the fp32 product, so what a lane latches is a true rollout
//    of its iterate and a true residual.  The head checks only on its last
//    iteration.
//
// Launch contract: the Python wrapper (fused_tile_plan) picks the rows a
// thread (8, 20 or 32 with w2 in shared memory, 20 with 4 lanes a thread,
// 32 split over a cluster, 32 with w2 in global memory: the instances; or
// the warp layout and its most warps a block), the cluster and its blocks'
// stages, the passes, the padded layouts (swp = cluster x passes x 16 RPT
// rows of the transposed map, or with 4 lanes a thread its pass_rows; kp
// columns of the bf16 map), whether
// the map and the state are resident
// and the dynamic shared-memory size; the entry point refuses a layout the
// kernel would overrun and a constraint set whose arrays are missing (the
// wrapper checks the cones' extents).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>

#include "projections.cuh"
#include "tile_gemm.cuh"

namespace {

using namespace tinympc;

constexpr int kLaneThreads = Lanes<kTile>::kLaneThreads;  // threads a lane: 8
constexpr int kRowGroups = Lanes<kTile>::kRowGroups;  // product rows: 16

struct Params {
  // the maps, with a leading group axis where map_grouped
  const float* t12t;  // (sw, swp) T12w transposed, rows padded to swp (the
                      // 4-lane layout: pass by pass, [pass][k][row])
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
  float* w2g;         // (sw, ldg) the tiles' w2 in global memory (kGlobal)
  __nv_bfloat16* w2hg;  // (ldg, kp) its bf16 rounding (kGlobal, reduced)
  int nx, su, sx, sw, swp, kp, B, L;  // B = G * L lanes, L in each group
  int tiles, ldg;     // tiles a group; columns of the tiles' global arrays
  int passes;         // passes of a block's product rows at once
  // a cluster of ``cluster`` blocks a tile (kCluster; 1 otherwise): block c
  // owns stages [stages[c], stages[c + 1]) of the list of the N - 1 input
  // stages then the N state stages, so their rows and its slice of the
  // map's padded rows (swp / cluster); rows_loc: the most rows a block owns
  int cluster, rows_loc;
  int stages[kMaxCluster + 1];
  int cons_shared;    // the constraint data staged in shared memory
  int max_iter, ct, k0, lo_all;
  float alpha, one_m_alpha, pri_tol, dua_tol;
  int state_free, warm_start, carry_out, t12_resident, state_shared;
  int map_grouped, rho_grouped;
  Side side_u, side_x;
  // the warp layout: G groups, lane groups a group, warps a block and the
  // launch's queue slot
  int G, per_g, warps, slot;
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

// Byte offsets of the block's shared memory: the tile's w2 (rows x kTile
// floats: every row; none with kGlobal, where it lives in global memory;
// the block's own rows with kCluster), the latch flags (kTile + 1 ints),
// the residual partials of the lanes' threads (kThreads float4), the lanes'
// solver state where it is resident ([row][lane]), with kCluster the
// cluster's meta (kClusterMeta), the map region (resident: the fp32 map,
// then the bf16 one with reduced iterations; streamed: the slab ring of a
// pass of W rows, fp32 or bf16 slabs in turn, each slot with the tile's w2
// rows beside the map's where w2 streams), the bf16 w2 ([lane][k], reduced
// only: every k with kShared, in global
// memory with kGlobal and kCluster).
struct TileLayout {
  size_t flags, red, state, meta, map, maplo, w2h, total;
};

__host__ __device__ inline TileLayout tile_layout(In in, int rows, int swp,
                                                  int W, int kp,
                                                  int state_floats,
                                                  bool resident,
                                                  bool reduced) {
  TileLayout t;
  size_t off = in == In::kGlobal
                   ? 0
                   : up16(sizeof(float) * static_cast<size_t>(rows) * kTile);
  t.flags = off;
  off += up16(sizeof(int) * (kTile + 1));
  t.red = off;
  off += up16(sizeof(float) * 4 * kThreads);
  t.state = off;
  off += up16(sizeof(float) * static_cast<size_t>(state_floats) * kTile);
  t.meta = off;
  if (in == In::kCluster) off += kClusterMeta;
  t.map = off;
  if (resident) {
    off += up16(sizeof(float) * static_cast<size_t>(rows) * swp);
    t.maplo = off;
    if (reduced) off += up16(2 * static_cast<size_t>(swp) * (kp + kPadLo));
  } else {
    const int wt = in == In::kShared ? 0 : kTile;
    size_t ring = ring_bytes(W, false, wt);
    if (reduced && ring_bytes(W, true, wt) > ring) ring = ring_bytes(W, true, wt);
    off += up16(ring);
    t.maplo = t.map;
  }
  t.w2h = off;
  if (reduced && in == In::kShared)
    off += up16(2 * static_cast<size_t>(kTile) * (kp + kPadLo));
  t.total = off;
  return t;
}

// Row of the first entry of stage s of the list of the N - 1 input stages
// then the N state stages.
__host__ __device__ inline int stage_row(int s, int nu, int nx, int n_u) {
  return s <= n_u ? s * nu : n_u * nu + (s - n_u) * nx;
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
                               // element (r, l) at buf[r * bs + l] for the
                               // block's rows r0 <= r < r1
  int bs;                      // kTile in shared memory; ldg in global
  const int* done;             // (kTile,) latched (or absent) lanes
  float* ring;                 // streamed slabs; null where resident
  const float* map;            // resident fp32 map (sw, swp), or the group's
                               // map in global memory when streamed
  const __nv_bfloat16* amap;   // resident bf16 map (swp, kp + kPadLo), or
                               // the group's (swp, kp) in global memory
  __nv_bfloat16* w2h;          // (kTile, kp + kPadLo) rounded w2; kGlobal,
                               // kCluster: the tile's (kTile, kp) rows of
                               // w2hg
  float* state;                // resident solver state, or null
  float* stage;                // the projected stages' buffers in shared
                               // memory (thread tid's entry j at
                               // stage[j * kThreads + tid]), or null
  SideData du, dx;             // the sides' constraint data
  int tid, lane0, nvalid;
  // the block's slice: rows [r0, r1), input stages [ku0, ku1), state stages
  // [kx0, kx1), its first padded map row (all of them without a cluster)
  int rank, r0, r1, ku0, ku1, kx0, kx1, mrow0;
  ClusterIn* ci;               // kCluster: where each k-row of w2 lives
  float4* cred;                // kCluster: the lanes' residual maxima
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
  for (int r = t.r0 + q; r < t.r1; r += kLaneThreads) {
    float acc = 0.0f;
    for (int j = 0; j < p.nx; ++j)
      acc = fmaf(tx0[r * p.nx + j], p.x0[lane * p.nx + j], acc);
    float c = __fadd_rn(acc, t1c[r]);
    if (p.warm_start) c = __fadd_rn(c, t12c[r]);
    st.uxc[r * S] = c;
    t.buf[r * t.bs + l] = p.warm_start ? p.w2_in[r * B + lane] : 0.0f;
  }
  for (int r = t.ku0 * p.side_u.dim + q; r < t.ku1 * p.side_u.dim;
       r += kLaneThreads) {
    st.y[r * S] = p.warm_start ? p.y_in[r * B + lane] : 0.0f;
    st.z[r * S] = p.warm_start ? p.z_in[r * B + lane] : 0.0f;
  }
  for (int r = t.kx0 * p.nx + q; r < t.kx1 * p.nx; r += kLaneThreads) {
    if (st.g) st.g[r * S] = p.warm_start ? p.g_in[r * B + lane] : 0.0f;
    st.v[r * S] = p.warm_start ? p.v_in[r * B + lane] : 0.0f;
  }
  if (q == 0 && t.rank == 0) {
    p.iters[lane] = p.max_iter;
    p.solved[lane] = 0;
  }
}

// The product T12w @ w2 into the buffer, for the rows and lanes that take
// it: the block's rows, a lane of the group that has not latched (the
// elementwise step adds uxc).
__device__ __forceinline__ void tile_store(const Tile& t, int r, int l,
                                           float acc) {
  if (r < t.r1 && l < t.nvalid && !t.done[l]) t.buf[r * t.bs + l] = acc;
}

// The epilogue of pass j of either product: all but the last pass park
// their sums in the global scratch; the last waits until every thread (of
// the cluster, with kCluster) is done reading w2, then stores its own sums
// and brings its parked ones back (each thread reads only what it parked
// itself).
template <In kIn, class Frag, int kN>
__device__ __forceinline__ void tile_epilogue(const Params& p, const Tile& t,
                                              int W, int j,
                                              const float (&acc)[kN],
                                              const Frag& fr) {
  if (j + 1 < p.passes) {
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      const int r = t.r0 + j * W + fr.row(e), l = fr.lane(e);
      if (r < t.r1 && l < t.nvalid)
        p.park[static_cast<size_t>(r) * p.B + t.lane0 + l] = acc[e];
    }
    return;
  }
  if constexpr (kIn == In::kCluster)
    cluster_sync();  // every block is done reading this block's w2
  else
    __syncthreads();  // every thread is done reading w2
#pragma unroll
  for (int e = 0; e < kN; ++e)
    tile_store(t, t.r0 + j * W + fr.row(e), fr.lane(e), acc[e]);
  for (int jp = 0; jp < j; ++jp)
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      const int r = t.r0 + jp * W + fr.row(e), l = fr.lane(e);
      if (r < t.r1 && l < t.nvalid)
        tile_store(t, r, l,
                   p.park[static_cast<size_t>(r) * p.B + t.lane0 + l]);
    }
}

// The fp32 product, pass by pass: thread (tr, tl) owns rows tr*R ..
// +R-1 of the pass (R = 2 RPT / LPT), lanes LPT tl .. +LPT-1, and sums each
// over k in index order with fmaf.  The cluster layout takes 8 lanes x RPT
// / 4 rows a thread; a thread of more than 2 lanes streams slabs of 16
// k-rows (the same W and ring bytes), and the 4-lane layout (4 lanes,
// w2 in shared memory) fills its ring by the bulk copy engine with no block
// barrier a slab (kMbar), its map laid out pass by pass (a pass's
// [k][row] block after the earlier passes', W rows wide, the last
// pass's rows padded only to a thread's: pass_rows), so that a slab of any
// pass is one copy; its threads past the map's rows skip the FMAs.
template <int RPT, In kIn, int LPT>
__device__ __forceinline__ void tile_product_fp32(const Params& p,
                                                  const Tile& t) {
  const int W = kRowGroups * RPT;
  constexpr int kL = kIn == In::kCluster ? 8 : LPT;
  constexpr bool kDeep = kL > 2;
  constexpr bool kMbar = kIn == In::kShared && kL == 4;
  // pass by pass: every pass's rows W apart but the last's (ld)
  const int ld = kMbar ? p.swp - (p.passes - 1) * W : p.swp;
  GemmF32 a{t.buf, t.ring, p.sw, W, ld, p.passes, t.tid, t.bs};
  if constexpr (kIn == In::kCluster) {
    a.ci = t.ci;
    a.vrows = t.r1 - t.r0;
  }
  if constexpr (kMbar) a.vrows = p.sw;
  gemm_fp32<RPT * 2 / kL, kTile, kIn, kL, kDeep ? kSlabKWide : kSlabK,
            kDeep ? kStagesWide : kStages, kIn == In::kCluster, kMbar>(
      a,
      [&](int j) {
        if constexpr (kMbar)
          return t.map + static_cast<size_t>(j) * W * p.sw;
        else
          return t.map + t.mrow0 + j * W;
      },
      [&](int j, const auto& acc, const auto& fr) {
        tile_epilogue<kIn>(p, t, W, j, acc, fr);
      });
}

// The reduced product on the tensor cores, pass by pass: w2 rounded to
// bf16 into w2h[lane][k], then per warp (wm, wn) the rows wm*4*RPT ..
// +4*RPT-1 of the pass (RPT/4 tiles of 16) of lanes wn*16 .. +15 (two tiles
// of 8), k in steps of 16.  The 4-lane layout's bf16 map keeps its rows
// (pass_rows of them, fewer than its passes' W each) and streams only the
// valid rows of its last pass.
template <int RPT, In kIn, int LPT>
__device__ __forceinline__ void tile_product_lo(const Params& p,
                                                const Tile& t) {
  const int W = kRowGroups * RPT;
  const int lda = t.ring ? p.kp : p.kp + kPadLo;
  GemmLo a{kIn == In::kCluster ? t.buf + t.r0 * t.bs : t.buf, t.w2h,
           reinterpret_cast<__nv_bfloat16*>(t.ring), p.sw, p.kp, W,
           p.passes, t.tid, lda, t.bs};
  if constexpr (kIn == In::kCluster) {
    a.ci = t.ci;
    a.vrows = t.r1 - t.r0;
  }
  if constexpr (kIn == In::kShared && LPT == 4) a.vrows = p.sw;
  gemm_lo<RPT, kTile, kIn>(
      a,
      [&](int j) {
        return t.amap + static_cast<size_t>(t.mrow0 + j * W) * lda;
      },
      [&](int j, const auto& acc, const auto& fr) {
        tile_epilogue<kIn>(p, t, W, j, acc, fr);
      });
}

// The elementwise part of iteration i for the whole tile (the block's
// slice of it with kCluster): thread q of lane l works on its share of both
// sides, a projected side's stages in one pass that also takes their
// residuals on a checking iteration; there the lane's partial maxima meet in
// shared memory (a max is exact in any order), with kCluster then the
// blocks' over distributed shared memory, and every thread of the lane (of
// every block) takes the same latch decision; a box side's update follows
// it (with kFuse, the 4-lane layout's, a checking iteration takes a box
// side's residuals and update in one pass: box_pass_q; the other layouts
// keep the two passes, where the one-pass step has not been timed: PERF.md
// section 6, ROADMAP R6).  Returns
// whether lane l latched, from its thread 0 (which writes the count).
template <In kIn, bool kProjU, bool kProjX, int kB, bool kFuse = false>
__device__ __forceinline__ bool tile_step(const Params& p, const Tile& t,
                                          float4* red, int g, float rho,
                                          int i, bool check, bool add) {
  const int l = t.tid % kTile, q = t.tid / kTile;
  const int lane = t.lane0 + l;
  const bool active = !t.done[l];
  const bool relax = p.alpha != 1.0f;
  const LaneState st = lane_state(p, t, l);
  // where a projected stage lives: the thread's own buffer in shared
  // memory, or the lane's rows of the global scratch
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
  SidePass su{&p.side_u, t.buf + l, st.z, st.y, st.uxc, p.zco + lane,
              st.stride, t.bs, wu, ws, wku, t.du, t.ku0, t.ku1};
  SidePass sx{&p.side_x, t.buf + l + p.su * t.bs, st.v, st.g,
              st.uxc + p.su * st.stride, p.vco + lane, st.stride, t.bs, wx,
              ws, wkx, t.dx, t.kx0, t.kx1};
  // the two sides' projected stages go round the lane's threads as one
  // list; a box side beside a projected one is shared out against it
  constexpr bool kRangeU = kProjX && !kProjU, kRangeX = kProjU && !kProjX;
  if constexpr (kProjU) su.qs = q;
  if constexpr (kProjX)
    sx.qs = kProjU ? (q + kLaneThreads - slice_stages(su) % kLaneThreads) %
                         kLaneThreads
                   : q;
  if constexpr (kRangeU) box_share<kLaneThreads>(su, sx, q);
  if constexpr (kRangeX) box_share<kLaneThreads>(sx, su, q);
  float pi = 0.0f, di = 0.0f, ps = 0.0f, ds = 0.0f;
  if (active) {
    const bool ahead = check && p.carry_out;
    if constexpr (kProjU)
      projected_pass<kTile, kB>(p, su, g, relax, q, add, check, ahead, pi,
                                di);
    else if (check && kFuse)
      box_pass_q<kRangeU>(p, su, g, relax, q, add, ahead, pi, di);
    else if (check)
      box_residuals_q<kRangeU>(p, su, g, relax, q, add, pi, di);
    if constexpr (kProjX)
      projected_pass<kTile, kB>(p, sx, g, relax, q, add, check, ahead, ps,
                                ds);
    else if (check && kFuse)
      box_pass_q<kRangeX>(p, sx, g, relax, q, add, ahead, ps, ds);
    else if (check)
      box_residuals_q<kRangeX>(p, sx, g, relax, q, add, ps, ds);
  }
  TINYMPC_SEC(kSecStep);
  bool newly = false;
  if (check) {
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
    }
    if constexpr (kIn == In::kCluster) {  // ... then the cluster's blocks'
      if (q == 0) t.cred[l] = make_float4(pi, di, ps, ds);
      cluster_sync();
      for (int c = 0; c < t.ci->C; ++c) {
        const float4 v = peer_load4(peer_address(t.cred + l, c));
        pi = fmaxf(pi, v.x);
        di = fmaxf(di, v.y);
        ps = fmaxf(ps, v.z);
        ds = fmaxf(ds, v.w);
      }
    }
    newly = active && ps < p.pri_tol && pi < p.pri_tol &&
            __fmul_rn(ds, rho) < p.dua_tol && __fmul_rn(di, rho) < p.dua_tol;
    add = false;  // the residual pass completed ux
    TINYMPC_SEC(kSecMaxima);
  }
  if (active && !(kFuse && check)) {
    const bool latch = p.carry_out && newly;
    if constexpr (!kProjU)
      box_update_q<kRangeU>(p, su, g, relax, q, add, latch);
    if constexpr (!kProjX)
      box_update_q<kRangeX>(p, sx, g, relax, q, add, latch);
  }
  TINYMPC_SEC(kSecStep);
  if (newly && q == 0 && t.rank == 0) {
    p.iters[lane] = i + 1;
    p.solved[lane] = 1;
  }
  return newly && q == 0;
}

// RPT: rows a thread of the product; kIn: where the tile's w2 lives (the
// block's shared memory, global memory streamed beside the map, or split
// over a cluster); kProjU/kProjX: whether the input / state side has
// halfspaces or cones.
template <int RPT, In kIn, bool kProjU, bool kProjX, int LPT>
__global__ void __launch_bounds__(kThreads, RPT <= 8 ? 2 : 1)
    condensed_fused_kernel(Params p) {
  TINYMPC_SEC_BEGIN();
  extern __shared__ float4 smem4[];
  char* sm = reinterpret_cast<char*>(smem4);
  constexpr bool kCl = kIn == In::kCluster;
  const int tid = threadIdx.x;
  const int g = blockIdx.y;
  const int C = kCl ? p.cluster : 1;
  const int tile = blockIdx.x / C;
  const int l0 = tile * kTile;  // the tile's first index in the group
  const int sw = p.sw, swp = p.swp, kp = p.kp;
  const bool reduced = p.t12a != nullptr;
  const TileLayout lay = tile_layout(
      kIn, kCl ? p.rows_loc : sw, swp, kRowGroups * RPT, kp,
      p.state_shared ? state_rows(p.su, p.sx, sw, p.state_free) : 0,
      p.t12_resident, reduced);

  Tile t;
  t.tid = tid;
  t.lane0 = g * p.L + l0;
  t.nvalid = min(kTile, p.L - l0);
  // the block's slice
  const int n_u = p.side_u.n_stages, n_x = p.side_x.n_stages;
  t.rank = kCl ? static_cast<int>(cluster_rank()) : 0;
  const int s0 = kCl ? p.stages[t.rank] : 0;
  const int s1 = kCl ? p.stages[t.rank + 1] : n_u + n_x;
  t.ku0 = min(s0, n_u);
  t.ku1 = min(s1, n_u);
  t.kx0 = max(s0 - n_u, 0);
  t.kx1 = max(s1 - n_u, 0);
  t.r0 = stage_row(s0, p.side_u.dim, p.nx, n_u);
  t.r1 = stage_row(s1, p.side_u.dim, p.nx, n_u);
  t.mrow0 = t.rank * (swp / C);
  // the tile's own columns of the global arrays
  const size_t col0 = static_cast<size_t>(g * p.tiles + tile) * kTile;
  if constexpr (kIn == In::kGlobal) {
    t.buf = p.w2g + col0;
    t.bs = p.ldg;
  } else {
    // the block's rows r0 .. r1 - 1 from the buffer's start
    t.buf = reinterpret_cast<float*>(sm) - t.r0 * kTile;
    t.bs = kTile;
  }
  t.w2h = !reduced            ? nullptr
          : kIn == In::kShared ? reinterpret_cast<__nv_bfloat16*>(sm + lay.w2h)
                               : p.w2hg + col0 * kp;
  t.ci = nullptr;
  t.cred = nullptr;
  if constexpr (kCl) {
    t.cred = reinterpret_cast<float4*>(sm + lay.meta);
    ClusterIn* ci = reinterpret_cast<ClusterIn*>(sm + lay.meta + 3 * 16 * 32);
    if (tid < C) {
      ci->base[tid] = peer_address(sm, tid);
      ci->kb[tid] = stage_row(p.stages[tid], p.side_u.dim, p.nx, n_u);
    }
    if (tid == 0) {
      ci->kb[C] = sw;
      ci->C = C;
      ci->rank = t.rank;
      ci->slabs = 0;
      for (int i = 0; i < kStages; ++i) mbar_init(&ci->full[i]);
      mbar_fence_init();
    }
    t.ci = ci;
  }
  int* done = reinterpret_cast<int*>(sm + lay.flags);
  int* n_done = done + kTile;
  t.done = done;
  // after the layout: the projected stages' buffers, then the constraint
  // data
  const size_t stage_bytes =
      (kProjU || kProjX) && !p.wsc
          ? sizeof(float) * kThreads *
                (kProjX && (!kProjU || p.nx > p.side_u.dim) ? p.nx
                                                            : p.side_u.dim)
          : 0;
  t.stage = stage_bytes ? reinterpret_cast<float*>(sm + lay.total) : nullptr;
  t.du = side_data(p.side_u, g);
  t.dx = side_data(p.side_x, g);
  if (p.cons_shared)
    stage_constraints(p.side_u, p.side_x, g, sm + lay.total + stage_bytes,
                      tid, kThreads, &t.du, &t.dx);
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
      for (int r = t.r0 + q; r < t.r1; r += kLaneThreads)
        t.buf[r * t.bs + l] = 0.0f;
  }
  if (tid == 0) *n_done = 0;
  if constexpr (kIn == In::kShared && LPT == 4)
    if (tid == 0) ring_bars_init();
  if constexpr (kCl)
    cluster_sync();  // every block's w2 and meta before the first product
  else
    __syncthreads();

  // rows a projected stage's pass loads at once (tile_gemm.cuh)
  constexpr int kB =
      (kIn == In::kShared && RPT > 8) ? kStageBatch : kStageBatchSmall;
  TINYMPC_SEC(kSecOther);
  for (int i = 0; i < p.max_iter; ++i) {
    TINYMPC_SEC_ITERATION();
    const bool check = is_check(p, i);
    if (check && p.carry_out) {  // a lane that latches now keeps this w2
      for (int e = tid; e < (t.r1 - t.r0) * kTile; e += kThreads) {
        const int r = t.r0 + e / kTile, l = e % kTile;
        if (!done[l]) p.w2_out[r * p.B + t.lane0 + l] = t.buf[r * t.bs + l];
      }
      if (i == 0 && !p.warm_start) __syncthreads();  // before it is written
    }
    if (i == 0 && !p.warm_start) {
      // cold iteration 0: d = 0, so ux is the pure rollout (no matmul); the
      // fused-map constant joins uxc only after it
      const int l = tid % kTile, q = tid / kTile;
      if (l < t.nvalid) {
        const LaneState st = lane_state(p, t, l);
        for (int r = t.r0 + q; r < t.r1; r += kLaneThreads) {
          const float c = st.uxc[r * st.stride];
          t.buf[r * t.bs + l] = c;
          st.uxc[r * st.stride] = __fadd_rn(c, t12c[r]);
        }
      }
    } else {
      if (is_reduced(p, i, check))
        tile_product_lo<RPT, kIn, LPT>(p, t);
      else
        tile_product_fp32<RPT, kIn, LPT>(p, t);
    }
    __syncthreads();
    TINYMPC_SEC(kSecBarrier);
    if (tile_step<kIn, kProjU, kProjX, kB, kIn == In::kShared && LPT == 4>(
            p, t, red, g, rho, i, check, i > 0 || p.warm_start)) {
      done[tid % kTile] = 1;
      atomicAdd(n_done, 1);
    }
    TINYMPC_SEC(kSecMaxima);
    if constexpr (kCl)
      cluster_sync();  // every block's next w2 before the next product
    else
      __syncthreads();
    TINYMPC_SEC(kSecStep);  // the wait for the lanes' slowest thread
    if (*n_done == t.nvalid) break;  // every lane of the tile has latched
  }

  // the outputs from the resident state, and the carry of the lanes that
  // never latched: their last state
  const int l = tid % kTile, q = tid / kTile, lane = t.lane0 + l;
  if (l < t.nvalid) {
    const LaneState st = lane_state(p, t, l);
    const int S = st.stride, B = p.B;
    const bool carry = p.carry_out && !done[l];
    for (int r = t.r0 + q; r < t.r1; r += kLaneThreads)
      if (carry) p.w2_out[r * B + lane] = t.buf[r * t.bs + l];
    for (int r = t.ku0 * p.side_u.dim + q; r < t.ku1 * p.side_u.dim;
         r += kLaneThreads) {
      const float z = st.z[r * S];
      if (t.state) {
        p.uout[r * B + lane] = z;
        p.y[r * B + lane] = st.y[r * S];
      }
      if (carry) p.zco[r * B + lane] = z;
    }
    for (int r = t.kx0 * p.nx + q; r < t.kx1 * p.nx; r += kLaneThreads) {
      const float v = st.v[r * S];
      if (t.state) {
        p.xout[r * B + lane] = v;
        if (st.g) p.g[r * B + lane] = st.g[r * S];
      }
      if (carry) p.vco[r * B + lane] = v;
    }
  }
  TINYMPC_SEC_END();
}

// -- the warp layout (narrow maps) -------------------------------------------
//
// A map of at most kWarpRows rows with box constraints only, in fp32, takes
// lane groups owned by warps.  A block of up to kMaxWarps warps stages its
// group's map (T12w transposed, [k][row], kWarpRows rows) and box bounds
// once in shared memory, and each warp owns a group of kWarpLanes lanes for
// the whole solve: the lanes' w2 ([row][lane], kWarpRows rows) and solver
// state ([row][lane]) in the warp's own slice of shared memory, the product
// a warp register tile (thread (tr, tl) = (lane / 2, lane % 2): rows 8 tr ..
// 8 tr + 7, lanes 4 tl .. 4 tl + 3, 16-byte map and w2 loads; each sum over
// k in index order with fmaf, as the tiles'), the elementwise step on the
// lane's kWarpLT threads (rows q, q + kWarpLT, ... in batches whose loads
// are all in flight before the arithmetic, unguarded so the rows' chains
// interleave; a checking iteration's residuals and updates in one pass)
// with the residual maxima met by shuffles.  With a carry out, the carry a
// lane would keep (its w2 before a checking iteration's product, its
// slacks before the update) is staged in the warp's slice of shared memory
// and written to global memory once, where the lane latches: staged in
// global memory at every checking iteration it cost a quarter of the MPC
// loop's warm launch (PERF.md section 6).  No block barrier an iteration: a
// warp waits on nothing but its own threads, so a tile's few slow lanes no
// longer hold 32 lanes' block.  A warp whose lanes have all latched takes
// the next lane group of its group from the launch's queue (a ticket
// counter a group in global memory), so a launch's tail is its slowest
// group of kWarpLanes lanes.  The grid is (X, G): X blocks a group, as many
// as the card holds at once (no more than the group's lane groups), each
// block of one group, the blocks of group g started after those of groups
// before it as SMs free, so the lane groups of one group spread over every
// SM (a bucketed rebuild's live lanes all lie in one bucket) and a block
// never restages.  A lane's arithmetic is the tiles' in the same order, so
// its counts, latch, carry and outputs do not depend on the warp, block or
// group slot that took it.  With 8 warps a block the instance keeps every
// value in registers (255 a thread); 12 or 16 spilled (PERF.md section 6).
constexpr int kWarpLanes = 8;   // lanes a warp's group
constexpr int kWarpRows = 128;  // product rows (16 thread rows x 8)
constexpr int kWarpLT = 32 / kWarpLanes;  // threads a lane: 4
constexpr int kWarpBatch = 8;   // rows an elementwise batch loads at once
constexpr int kMaxWarps = 8;    // warps a block
constexpr int kQueueSlots = 64;
constexpr int kQueueGroups = 1024;  // groups a launch's queue holds
// lane-group queues: blocks done, then each group's next ticket; each left
// at zero by the launch that used it; a launch takes the next slot, so
// launches on other streams running at the same time use other queues
__device__ unsigned g_warp_queue[kQueueSlots][kQueueGroups + 1];

// Floats of a warp-layout block's copy of the box bounds (lo and hi of
// every row), whole 16-byte pieces.
__host__ __device__ inline int warp_bounds(int sw) {
  return (2 * sw + 3) / 4 * 4;
}

// Floats of a warp-layout lane's state: the tiles' (state_rows), then,
// with a carry out, the carry it would keep were it to latch (w2 before the
// checking iteration's product, its slacks before the update: sw floats
// each), staged in shared memory and written out once, where it latches.
__host__ __device__ inline int warp_state_rows(int su, int sx, int sw,
                                               bool state_free,
                                               bool carry_out) {
  return state_rows(su, sx, sw, state_free) + (carry_out ? 2 * sw : 0);
}

// Bytes of a warp-layout block of ``warps`` warps: the map (sw x kWarpRows
// floats), the box bounds, then each warp's w2 (kWarpRows x kWarpLanes) and
// solver state (state_floats x kWarpLanes).
__host__ __device__ inline size_t warp_smem(int sw, int state_floats,
                                            int warps) {
  return sizeof(float) * (static_cast<size_t>(sw) * kWarpRows +
                          warp_bounds(sw) +
                          static_cast<size_t>(warps) * kWarpLanes *
                              (kWarpRows + state_floats));
}

// Four k-rows of a warp product's operands in registers: thread (tr, tl)'s
// 8 map rows (two 16-byte loads a k-row) and 4 lanes of w2 (one).
struct WarpRows {
  float4 m0[4], m1[4], w[4];

  // k-rows k .. k + 3 (a row past the map's, read into the block's memory
  // after it, is never multiplied)
  __device__ __forceinline__ void load(const float* m, const float* w2,
                                       int k) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      m0[j] = *reinterpret_cast<const float4*>(m + (k + j) * kWarpRows);
      m1[j] = *reinterpret_cast<const float4*>(m + (k + j) * kWarpRows + 4);
      w[j] = *reinterpret_cast<const float4*>(w2 + (k + j) * kWarpLanes);
    }
  }

  // the first n (<= 4) k-rows into the thread's 8 x 4 sums, in k order
  __device__ __forceinline__ void fma(float (&acc)[32], int n = 4) const {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < n) {
        const float mv[8] = {m0[j].x, m0[j].y, m0[j].z, m0[j].w,
                             m1[j].x, m1[j].y, m1[j].z, m1[j].w};
        const float wl[4] = {w[j].x, w[j].y, w[j].z, w[j].w};
#pragma unroll
        for (int e = 0; e < 8; ++e)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc[4 * e + q] = fmaf(mv[e], wl[q], acc[4 * e + q]);
      }
    }
  }
};

// The product of a warp's lane group: the buffer's w2 ([k][lane], rows of
// kWarpLanes) becomes ux = T12w @ w2 ([row][lane]) for every row and lane
// (a latched lane's entries are never read again).  The k-rows go four at
// a time through two register sets in turn, the next four's loads in
// flight while the FMAs take these, each sum in k order.
__device__ __forceinline__ void warp_product(const float* map, float* buf,
                                             int sw, int ln) {
  const int tr = ln >> 1, tl = ln & 1;
  float acc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.0f;
  const float* m = map + 8 * tr;
  const float* w = buf + 4 * tl;
  WarpRows a, b;
  a.load(m, w, 0);
  int k = 0;
  for (; k + 8 <= sw; k += 8) {
    b.load(m, w, k + 4);
    a.fma(acc);
    a.load(m, w, k + 8);
    b.fma(acc);
  }
  if (k + 4 <= sw) {  // a holds k-rows k .. k + 3, the last whole four
    b.load(m, w, k + 4);
    a.fma(acc);
    b.fma(acc, sw - k - 4);
  } else {
    a.fma(acc, sw - k);
  }
  TINYMPC_SEC(kSecProduct);
  __syncwarp();  // every thread is done reading w2
#pragma unroll
  for (int e = 0; e < 8; ++e)
    *reinterpret_cast<float4*>(buf + (8 * tr + e) * kWarpLanes + 4 * tl) =
        make_float4(acc[4 * e], acc[4 * e + 1], acc[4 * e + 2],
                    acc[4 * e + 3]);
  __syncwarp();
  TINYMPC_SEC(kSecEpilogue);
}

// One side's rows q, q + kWarpLT, ... of a lane (thread q of its kWarpLT),
// kWarpBatch rows at a time, every load of a batch (the product, the
// slack, the dual, the rollout constant, the bounds from the block's copy
// ``lo``/``hi``) in flight before its arithmetic, which runs unguarded on
// every row of the batch (a row past the side's reads its last row; only
// its stores and its residuals are dropped), so the rows' chains
// interleave: with kCheck the residual and the update pass in one
// (box_pass_q's arithmetic, the carry's slack written ahead where ``co``,
// into the lane's staged carry ``sp.co`` at the state's stride), else the
// update pass (box_update_q's).  The arithmetic is relaxed(),
// box_slack() and update_row()'s, in their order.
template <bool kCheck>
__device__ __forceinline__ void warp_box_pass(const Params& p,
                                              const SidePass& sp,
                                              const float* lo,
                                              const float* hi, bool relax,
                                              int q, bool add, bool co,
                                              float& pri, float& dua) {
  const Side& s = *sp.s;
  const int rows = s.dim * s.n_stages;
  const bool box = s.en_box != 0, has_dual = sp.dual != nullptr;
  const float alpha = p.alpha, one_m_alpha = p.one_m_alpha;
  for (int r0 = q; r0 < rows; r0 += kWarpLT * kWarpBatch) {
    float u[kWarpBatch], prev[kWarpBatch], dual[kWarpBatch],
        c[kWarpBatch], l[kWarpBatch], h[kWarpBatch];
#pragma unroll
    for (int j = 0; j < kWarpBatch; ++j) {
      const int r = min(r0 + kWarpLT * j, rows - 1), o = r * sp.stride;
      u[j] = sp.ux[r * sp.us];
      prev[j] = sp.prev[o];
      dual[j] = has_dual ? sp.dual[o] : 0.0f;
      c[j] = add ? sp.uxc[o] : 0.0f;
      l[j] = lo[r];
      h[j] = hi[r];
    }
#pragma unroll
    for (int j = 0; j < kWarpBatch; ++j) {
      const int r = r0 + kWarpLT * j, o = r * sp.stride;
      const bool in = r < rows;
      const float v = add ? __fadd_rn(u[j], c[j]) : u[j];
      const float wh = relax ? __fadd_rn(__fmul_rn(alpha, v),
                                         __fmul_rn(one_m_alpha, prev[j]))
                             : v;
      float vn = has_dual ? __fadd_rn(wh, dual[j]) : wh;
      if (box) vn = fminf(h[j], fmaxf(l[j], vn));
      if (kCheck && in) {
        pri = fmaxf(pri, fabsf(__fsub_rn(v, vn)));
        dua = fmaxf(dua, fabsf(__fsub_rn(prev[j], vn)));
      }
      const float dn = __fsub_rn(__fadd_rn(dual[j], wh), vn);
      const float next = has_dual ? __fsub_rn(vn, dn) : vn;
      if (in) {
        if (has_dual) sp.dual[o] = dn;
        sp.prev[o] = vn;
        if (co) sp.co[o] = prev[j];
        sp.ux[r * sp.us] = next;
      }
    }
  }
}

// The elementwise part of iteration i for thread q of a lane of a warp's
// group (``done``: the lane had latched; ``add``: ux = product + uxc still
// to complete; ``bnd``: the block's copy of the bounds, lo then hi of the
// input rows, then of the state rows): a checking iteration's residuals and
// updates in one pass (the carry's slack written ahead into the lane's
// staged carry), the lane's maxima over its kWarpLT threads by shuffles and
// its latch, where it latches its staged carry (``cw2``: the w2 staged
// before the product; the slacks at ``su_p.co``, ``sx_p.co``) written out;
// otherwise the update pass.  Returns whether the lane has latched.
__device__ __forceinline__ bool warp_step(const Params& p,
                                          const SidePass& su_p,
                                          const SidePass& sx_p,
                                          const float* cw2, const float* bnd,
                                          float rho, int q, int lane, int i,
                                          bool check, bool add, bool done) {
  const bool relax = p.alpha != 1.0f;
  const float* lx = bnd + 2 * p.su;
  float pi = 0.0f, di = 0.0f, ps = 0.0f, ds = 0.0f;
  if (!done) {
    if (check) {
      const bool ahead = p.carry_out;
      warp_box_pass<true>(p, su_p, bnd, bnd + p.su, relax, q, add, ahead,
                          pi, di);
      warp_box_pass<true>(p, sx_p, lx, lx + p.sx, relax, q, add, ahead, ps,
                          ds);
    } else {
      warp_box_pass<false>(p, su_p, bnd, bnd + p.su, relax, q, add, false,
                           pi, di);
      warp_box_pass<false>(p, sx_p, lx, lx + p.sx, relax, q, add, false, ps,
                           ds);
    }
  }
  TINYMPC_SEC(kSecStep);
  if (!check) return done;
#pragma unroll
  for (int o = kWarpLanes; o < 32; o <<= 1) {
    pi = fmaxf(pi, __shfl_xor_sync(0xffffffffu, pi, o));
    di = fmaxf(di, __shfl_xor_sync(0xffffffffu, di, o));
    ps = fmaxf(ps, __shfl_xor_sync(0xffffffffu, ps, o));
    ds = fmaxf(ds, __shfl_xor_sync(0xffffffffu, ds, o));
  }
  const bool newly = !done && ps < p.pri_tol && pi < p.pri_tol &&
                     __fmul_rn(ds, rho) < p.dua_tol &&
                     __fmul_rn(di, rho) < p.dua_tol;
  if (newly && q == 0) {
    p.iters[lane] = i + 1;
    p.solved[lane] = 1;
  }
  if (newly && p.carry_out) {  // the carry staged at this iteration, out
    const int B = p.B, S = kWarpLanes;
    for (int r = q; r < p.sw; r += kWarpLT)
      p.w2_out[r * B + lane] = cw2[r * S];
    for (int r = q; r < p.su; r += kWarpLT)
      p.zco[r * B + lane] = su_p.co[r * S];
    for (int r = q; r < p.sx; r += kWarpLT)
      p.vco[r * B + lane] = sx_p.co[r * S];
  }
  return done || newly;
}

// The whole solve of one lane group: lanes l0 .. l0 + 7 of group g (past L:
// absent), thread q of lane l = ln % kWarpLanes.  ``map``, ``bnd``: the
// group's map and bounds in the block's shared memory; ``buf``, ``st``: the
// warp's w2 and state.
__device__ void warp_group(const Params& p, const float* map,
                           const float* bnd, float* buf, float* st, int g,
                           int l0, int ln) {
  const int l = ln % kWarpLanes, q = ln / kWarpLanes;
  const bool valid = l0 + l < p.L;
  const int lane = g * p.L + l0 + l, B = p.B;
  const int sw = p.sw, su = p.su, sx = p.sx, S = kWarpLanes;
  const int gm = p.map_grouped ? g : 0;
  const float* tx0 = p.tx0 + gm * sw * p.nx;
  const float* t1c = p.t1c + gm * sw;
  const float* t12c = p.t12c + gm * sw;
  const float rho = p.rho[p.rho_grouped ? g : 0];
  float* uxc = st + l;
  float* y = uxc + sw * S;
  float* z = y + su * S;
  float* v = z + su * S;
  float* gd = p.state_free ? nullptr : v + sx * S;
  // the staged carry (carry_out): w2 (sw rows), then the slacks z and v
  float* cw2 = st + state_rows(su, sx, sw, p.state_free) * S + l;
  // the state before iteration 0 (lane_init's arithmetic), kWarpBatch
  // rows at a time, a batch's loads in flight before its stores
  constexpr int kStep = kWarpLT * kWarpBatch;
  if (valid) {
    const bool warm = p.warm_start;
    for (int r0 = q; r0 < sw; r0 += kStep) {
      float acc[kWarpBatch], c1[kWarpBatch], c12[kWarpBatch],
          w2[kWarpBatch];
#pragma unroll
      for (int j = 0; j < kWarpBatch; ++j) acc[j] = 0.0f;
      for (int i = 0; i < p.nx; ++i) {
        const float xi = p.x0[lane * p.nx + i];
#pragma unroll
        for (int j = 0; j < kWarpBatch; ++j) {
          const int r = r0 + kWarpLT * j;
          if (r < sw) acc[j] = fmaf(tx0[r * p.nx + i], xi, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kWarpBatch; ++j) {
        const int r = r0 + kWarpLT * j;
        if (r < sw) {
          c1[j] = t1c[r];
          c12[j] = warm ? t12c[r] : 0.0f;
          w2[j] = warm ? p.w2_in[r * B + lane] : 0.0f;
        }
      }
#pragma unroll
      for (int j = 0; j < kWarpBatch; ++j) {
        const int r = r0 + kWarpLT * j;
        if (r < sw) {
          float c = __fadd_rn(acc[j], c1[j]);
          if (warm) c = __fadd_rn(c, c12[j]);
          uxc[r * S] = c;
          buf[r * S + l] = w2[j];
          if (p.carry_out) cw2[r * S] = w2[j];  // a lane latching at 0
        }
      }
    }
    for (int r0 = q; r0 < su; r0 += kStep) {
      float yv[kWarpBatch], zv[kWarpBatch];
#pragma unroll
      for (int j = 0; j < kWarpBatch; ++j) {
        const int r = r0 + kWarpLT * j;
        if (r < su) {
          yv[j] = warm ? p.y_in[r * B + lane] : 0.0f;
          zv[j] = warm ? p.z_in[r * B + lane] : 0.0f;
        }
      }
#pragma unroll
      for (int j = 0; j < kWarpBatch; ++j) {
        const int r = r0 + kWarpLT * j;
        if (r < su) {
          y[r * S] = yv[j];
          z[r * S] = zv[j];
        }
      }
    }
    for (int r0 = q; r0 < sx; r0 += kStep) {
      float gv[kWarpBatch], vv[kWarpBatch];
#pragma unroll
      for (int j = 0; j < kWarpBatch; ++j) {
        const int r = r0 + kWarpLT * j;
        if (r < sx) {
          gv[j] = warm && gd ? p.g_in[r * B + lane] : 0.0f;
          vv[j] = warm ? p.v_in[r * B + lane] : 0.0f;
        }
      }
#pragma unroll
      for (int j = 0; j < kWarpBatch; ++j) {
        const int r = r0 + kWarpLT * j;
        if (r < sx) {
          if (gd) gd[r * S] = gv[j];
          v[r * S] = vv[j];
        }
      }
    }
    if (q == 0) {
      p.iters[lane] = p.max_iter;
      p.solved[lane] = 0;
    }
  } else {
    for (int r = q; r < sw; r += kWarpLT) buf[r * S + l] = 0.0f;
  }
  __syncwarp();
  TINYMPC_SEC(kSecOther);
  SidePass su_p{&p.side_u, buf + l, z, y, uxc, cw2 + sw * S, S, S,
                nullptr, 0, 0, {}};
  SidePass sx_p{&p.side_x, buf + l + su * S, v, gd, uxc + su * S,
                cw2 + (sw + su) * S, S, S, nullptr, 0, 0, {}};
  bool done = !valid;
  for (int i = 0; i < p.max_iter; ++i) {
    TINYMPC_SEC_ITERATION();
    const bool check = (i + 1) % p.ct == 0;
    if (i == 0 && !p.warm_start) {
      // cold iteration 0: ux is the pure rollout; T12c joins uxc after it
      if (valid)
        for (int r = q; r < sw; r += kWarpLT) {
          const float c = uxc[r * S];
          buf[r * S + l] = c;
          uxc[r * S] = __fadd_rn(c, t12c[r]);
        }
      __syncwarp();
    } else {
      if (check && p.carry_out && !done)  // a lane latching now keeps it
        for (int r = q; r < sw; r += kWarpLT) cw2[r * S] = buf[r * S + l];
      warp_product(map, buf, sw, ln);
    }
    done = warp_step(p, su_p, sx_p, cw2, bnd, rho, q, lane, i, check,
                     i > 0 || p.warm_start, done);
    __syncwarp();  // the next w2 before the next product
    TINYMPC_SEC(kSecMaxima);
    if (__all_sync(0xffffffffu, done)) break;  // every lane has latched
  }
  // the outputs from the state, and the carry of the lanes that never
  // latched: their last state
  if (valid) {
    const bool carry = p.carry_out && !done;
    if (carry)
      for (int r = q; r < sw; r += kWarpLT)
        p.w2_out[r * B + lane] = buf[r * S + l];
    for (int r = q; r < su; r += kWarpLT) {
      const float zr = z[r * S];
      p.uout[r * B + lane] = zr;
      p.y[r * B + lane] = y[r * S];
      if (carry) p.zco[r * B + lane] = zr;
    }
    for (int r = q; r < sx; r += kWarpLT) {
      const float vr = v[r * S];
      p.xout[r * B + lane] = vr;
      if (gd) p.g[r * B + lane] = gd[r * S];
      if (carry) p.vco[r * B + lane] = vr;
    }
  }
  __syncwarp();  // before the warp's next group overwrites its state
  TINYMPC_SEC(kSecOther);
}

// The warp layout's kernel: grid (X, G), blockDim.x = 32 x p.warps; ticket
// t of group g's queue is its lane group t (lanes 8 t .. 8 t + 7).
template <int RPT, int LPT>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
    condensed_fused_warp_kernel(Params p) {
  static_assert(RPT == 8 && LPT == 4, "8 rows x 4 lanes a thread");
  TINYMPC_SEC_BEGIN();
  extern __shared__ float4 smem4[];
  __shared__ int any;  // a warp of the block holds a ticket
  float* map = reinterpret_cast<float*>(smem4);
  const int warp = threadIdx.x >> 5, ln = threadIdx.x & 31;
  const int sw = p.sw, g = blockIdx.y;
  float* bnd = map + sw * kWarpRows;
  float* buf = bnd + warp_bounds(sw) +
               warp * kWarpLanes *
                   (kWarpRows + warp_state_rows(p.su, p.sx, sw, p.state_free,
                                                p.carry_out));
  float* st = buf + kWarpRows * kWarpLanes;
  unsigned* const queue = g_warp_queue[p.slot];
  auto claim = [&]() {
    int t = 0;
    if (ln == 0) t = static_cast<int>(atomicAdd(queue + 1 + g, 1u));
    return __shfl_sync(0xffffffffu, t, 0);
  };
  if (threadIdx.x == 0) any = 0;
  __syncthreads();
  int ticket = claim();
  if (ln == 0 && ticket < p.per_g) any = 1;
  __syncthreads();
  if (any) {  // the group's map and bounds, once
    const float4* src = reinterpret_cast<const float4*>(
        p.t12t + static_cast<size_t>(p.map_grouped ? g : 0) * sw * kWarpRows);
    for (int e = threadIdx.x; e < sw * kWarpRows / 4; e += blockDim.x)
      smem4[e] = src[e];
    const Side* sides[2] = {&p.side_u, &p.side_x};
    float* dst = bnd;
    for (const Side* s : sides) {
      const int rows = s->dim * s->n_stages;
      for (int e = threadIdx.x; e < rows; e += blockDim.x) {
        dst[e] = s->wmin[g * s->box_stride + e];
        dst[rows + e] = s->wmax[g * s->box_stride + e];
      }
      dst += 2 * rows;
    }
  }
  __syncthreads();
  TINYMPC_SEC(kSecBarrier);
  while (ticket < p.per_g) {
    warp_group(p, map, bnd, buf, st, g, ticket * kWarpLanes, ln);
    ticket = claim();
  }
  // the last block out resets its queue for the next launch
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(queue, 1u) == gridDim.x * gridDim.y - 1) {
      for (int h = 0; h <= p.G; ++h) queue[h] = 0u;
    }
  }
  TINYMPC_SEC_END();
}

// The kernel for RPT rows a thread (2 RPT / LPT rows x LPT lanes of the
// fp32 product) and w2 in shared, global or a cluster's memory, with the
// projections the sides need.
template <int RPT, In kIn, int LPT = 2>
void (*tile_kernel(bool proj_u, bool proj_x))(Params) {
  return proj_u
             ? (proj_x ? condensed_fused_kernel<RPT, kIn, true, true, LPT>
                       : condensed_fused_kernel<RPT, kIn, true, false, LPT>)
             : (proj_x ? condensed_fused_kernel<RPT, kIn, false, true, LPT>
                       : condensed_fused_kernel<RPT, kIn, false, false,
                                                LPT>);
}

// The instances fused_tile_plan picks from; null for any other.
void (*pick_kernel(int rpt, In in, int lanes, bool proj_u,
                   bool proj_x))(Params) {
  if (lanes == 4)  // the 4-lane layout: 10 rows x 4 lanes a thread
    return in == In::kShared && rpt == 20
               ? tile_kernel<20, In::kShared, 4>(proj_u, proj_x)
               : nullptr;
  if (lanes != 2) return nullptr;
  if (in == In::kShared && rpt == 8)
    return tile_kernel<8, In::kShared>(proj_u, proj_x);
  if (in == In::kShared && rpt == 20)
    return tile_kernel<20, In::kShared>(proj_u, proj_x);
  if (in == In::kShared && rpt == 32)
    return tile_kernel<32, In::kShared>(proj_u, proj_x);
  if (in == In::kGlobal && rpt == 32)
    return tile_kernel<32, In::kGlobal>(proj_u, proj_x);
  if (in == In::kCluster && rpt == 32)
    return tile_kernel<32, In::kCluster>(proj_u, proj_x);
  return nullptr;
}

In layout_of(int w2_global, int cluster) {
  return cluster > 1 ? In::kCluster : w2_global ? In::kGlobal : In::kShared;
}

// Launches ``kernel`` on ``grid`` (x a multiple of ``cluster``), as
// clusters of ``cluster`` blocks along x where that is more than 1.
cudaError_t launch(void (*kernel)(Params), dim3 grid, int cluster,
                   size_t smem, cudaStream_t stream, const Params& p) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, p);
}

// The warp layout's launch (the entry point has checked the shared
// arguments; ``not_shared``: the map or the state not in shared memory, or
// a cluster): refuses a layout it does not take; grid (X, G), X blocks a
// group as many as the card holds at once and no more than a group's lane
// groups, each of at most ``warps`` warps and no more than a group's lane
// groups share out over its X blocks.
int launch_warps(Params& p, int warps, int rpt, int lanes, bool projected,
                 bool reduced, bool not_shared, int smem_bytes,
                 void* stream) {
  const int sf = warp_state_rows(p.su, p.sx, p.sw, p.state_free,
                                 p.carry_out);
  if (warps < 1 || warps > kMaxWarps || rpt != 8 || lanes != 4 ||
      projected || reduced || not_shared || p.swp != kWarpRows ||
      p.sw > kWarpRows || p.passes != 1 || p.G > kQueueGroups ||
      static_cast<size_t>(smem_bytes) < warp_smem(p.sw, sf, warps))
    return static_cast<int>(cudaErrorInvalidValue);
  void (*kernel)(Params) = condensed_fused_warp_kernel<8, 4>;
  p.per_g = (p.L + kWarpLanes - 1) / kWarpLanes;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, 32 * warps, static_cast<size_t>(smem_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int X = std::min(p.per_g, std::max(per_sm, 1) * sms);
  p.warps = std::min(warps, (p.per_g + X - 1) / X);
  static std::atomic<unsigned> launches{0};
  p.slot = static_cast<int>(launches.fetch_add(1) % kQueueSlots);
  const size_t smem = warp_smem(p.sw, sf, p.warps);
  kernel<<<dim3(X, p.G), 32 * p.warps, smem,
           static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Blocks of one SM for the instance of a launch (the occupancy API; the
// warp layout's blocks of ``warps`` warps where that is not 0), or, for a
// cluster of ``cluster`` blocks, the clusters the whole card holds at once;
// a negative CUDA error.
extern "C" int tinympc_condensed_fused_occupancy(int rpt, int lanes,
                                                 int w2_global, int cluster,
                                                 int proj_u, int proj_x,
                                                 int smem_bytes, int warps) {
  void (*kernel)(Params) =
      warps > 0 ? (rpt == 8 && lanes == 4 && !proj_u && !proj_x
                       ? condensed_fused_warp_kernel<8, 4>
                       : nullptr)
                : pick_kernel(rpt, layout_of(w2_global, cluster), lanes,
                              proj_u != 0, proj_x != 0);
  if (!kernel || warps < 0 || warps > kMaxWarps)
    return -static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  int n = 0;
  if (err == cudaSuccess && cluster > 1) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cluster * 64);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem_bytes;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  } else if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, kernel, warps > 0 ? 32 * warps : kThreads, smem_bytes);
  }
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

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
    int cluster, const int* stages, int rpt, int lanes, int warps, int swp,
    int kp,
    int smem_bytes, int map_grouped, int rho_grouped, int box_u_grouped,
    int box_x_grouped, const float* lin_u, int n_lin_u, const int* soc_u,
    const float* soc_mu_u, int n_soc_u, int lin_u_grouped, int mu_u_grouped,
    const float* lin_x, int n_lin_x, const int* soc_x, const float* soc_mu_x,
    int n_soc_x, int lin_x_grouped, int mu_x_grouped, void* stream) {
  // G groups of L lanes; the *_grouped flags say which arrays carry a
  // leading group axis.  lin_*: (n_lin, 2*dim + 1) device rows; soc_*: n_soc
  // (start, dim) pairs on the device; soc_mu_*: (n_soc,) on the device.
  // t12a: the (swp, kp) bf16 map of reduced iterations; swp = the passes x
  // 16 x rpt, the rows a thread (the instances: 2 rpt / lanes rows x lanes
  // lanes of the fp32 product, lanes 2, or 4 at rpt 20: then the map pass
  // by pass in ceil(sw / 320) passes, swp = pass_rows(sw, 10, 320), the
  // map streamed, w2 in shared memory, no cluster), kp a multiple of
  // kSlabKLo; park: the (sw, B) scratch of a launch of several passes; wsc:
  // the (sw, B) projection scratch of a launch with linear or cone
  // constraints whose stage buffers (kThreads x the widest projected
  // side's dim floats, after the tile's layout) leave no room in
  // smem_bytes, else null;
  // w2_global: the tiles' w2 in w2g (sw, G x tiles x 32), with reduced
  // iterations (also with a cluster) rounded into w2hg (G x tiles x 32, kp)
  // bf16; warps: the warp layout with blocks of at most ``warps`` warps
  // (rpt 8, lanes 4, swp kWarpRows, fp32, box only, the map and the state
  // in shared memory, smem_bytes for that many warps), 0: tiles; cluster:
  // the blocks a tile (1, or 2 to 8 with ``stages``, the host's cluster + 1
  // stage bounds, and swp = cluster x passes x 16 x rpt);
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
  const bool wg = w2_global != 0;
  const In in = layout_of(w2_global, cluster);
  const int n_u = N - 1, n_st = n_u + N;
  p.cluster = cluster;
  p.rows_loc = p.sw;
  if (cluster < 1 || cluster > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  if (cluster > 1) {  // each block's stages, rows and slice of the map
    if (!stages || stages[0] != 0 || stages[cluster] != n_st || wg ||
        t12_resident || state_shared || swp % cluster != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    p.rows_loc = 0;
    for (int c = 0; c <= cluster; ++c) {
      p.stages[c] = stages[c];
      if (c == 0) continue;
      const int rows = stage_row(stages[c], nu, nx, n_u) -
                       stage_row(stages[c - 1], nu, nx, n_u);
      if (stages[c] <= stages[c - 1] || rows > swp / cluster)
        return static_cast<int>(cudaErrorInvalidValue);
      p.rows_loc = rows > p.rows_loc ? rows : p.rows_loc;
    }
  }
  // the 4-lane layout's map pass by pass: passes of W rows, the last's
  // padded only to a thread's rows (2 rpt / lanes)
  const bool pass_major = lanes == 4 && warps == 0;
  p.passes = rpt <= 0       ? 0
             : pass_major ? (p.sw + W - 1) / W
                          : swp / cluster / W;
  const size_t need =
      tile_layout(in, p.rows_loc, swp, W, kp,
                  state_shared ? state_rows(p.su, p.sx, p.sw, p.state_free)
                               : 0,
                  t12_resident, reduced)
          .total;
  const bool proj_u = n_lin_u + n_soc_u > 0, proj_x = n_lin_x + n_soc_x > 0;
  const int sdim = proj_x && (!proj_u || nx > nu) ? nx : nu;
  const size_t stage =
      (proj_u || proj_x) && !wsc ? sizeof(float) * kThreads * sdim : 0;
  if (G <= 0 || L <= 0 || G > 65535 || ct < 1 || k0 < 0 || k0 > max_iter ||
      rpt <= 0 || swp < p.sw ||
      (pass_major ? cluster != 1 || wg || t12_resident ||
                        swp != pass_rows(p.sw, 2 * rpt / lanes, W)
                  : swp != cluster * p.passes * W) ||
      (p.passes > 1 && !park) ||
      (wg && (!w2g || t12_resident)) ||
      ((wg || cluster > 1) && reduced && !w2hg) ||
      kp % kSlabKLo != 0 || kp < p.sw || smem_bytes < 0 ||
      (warps == 0 && static_cast<size_t>(smem_bytes) < need + stage) ||
      !rho ||
      (reduced && !t12a))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!init_side(p.side_u, umin, umax, lin_u, n_lin_u, soc_u, soc_mu_u,
                 n_soc_u, nu, N - 1, en_input_bound, box_u_grouped,
                 lin_u_grouped, mu_u_grouped) ||
      !init_side(p.side_x, xmin, xmax, lin_x, n_lin_x, soc_x, soc_mu_x,
                 n_soc_x, nx, N, en_state_bound, box_x_grouped, lin_x_grouped,
                 mu_x_grouped))
    return static_cast<int>(cudaErrorInvalidValue);
  // the block's group's constraint data in shared memory after the stage
  // buffers, where the launch left room for it
  const size_t cons = constraint_bytes(p.side_u, p.side_x);
  p.cons_shared =
      cons > 0 && static_cast<size_t>(smem_bytes) >= need + stage + cons;

  p.G = G;
  if (warps != 0) return launch_warps(p, warps, rpt, lanes, proj_u || proj_x,
                                      reduced, wg || cluster > 1 ||
                                      !t12_resident || !state_shared,
                                      smem_bytes, stream);
  void (*kernel)(Params) = pick_kernel(rpt, in, lanes, proj_u, proj_x);
  if (!kernel) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(smem_bytes);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch(kernel, dim3(p.tiles * cluster, G), cluster, smem,
               static_cast<cudaStream_t>(stream), p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
