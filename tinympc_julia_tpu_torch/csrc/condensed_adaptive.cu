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
//    rows x 2 lanes (or fewer rows x more lanes: K2Product), each
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
//  * From K2_CLUSTER_FROM_WIDTH, or where even the iterates of a tile of
//    16 lanes leave no room beside the ring, a tile of 32 splits over a
//    thread block cluster of 2-8 blocks (In::kCluster, tile_gemm.cuh):
//    block c owns the rows of ux of whole stages (the forward product's
//    output and the elementwise step) and the rows of d of whole input
//    stages (the backward product's output), the last block also x0's and
//    the 1s; each keeps its rows of vec1 and ux in its shared memory and
//    fetches the others' k-rows over distributed shared memory.  Cluster
//    barriers order each product after every block's last read of its
//    output and its inputs' last writes; the residual and OSQP-form maxima
//    meet over the cluster, so every block predicts the same rho and
//    latches the same lanes; the OSQP-form residuals read the next stage's
//    rows of ux from a global copy.  Where even a cluster of 8's slices
//    leave no room, vec1 and ux live in global memory, each tile its own
//    columns, and stream through the ring beside the maps' slabs
//    (In::kGlobal).  The sums keep their order in every layout.
//  * Where the iterates of a tile of 32 lanes fit beside it, the maps
//    stream through a ring filled by the bulk copy engine (the bulk-ring
//    layouts, K2Product): each map laid out pass by pass, a pass's [k][row]
//    block with its rows padded only to a thread's rows, so that a 16-row
//    slab of a pass is one bulk copy, issued by thread 0 once every warp
//    has freed the slot (no block barrier a slab), each thread 4 lanes of
//    the fp32 products (a k step's 16-byte load of w feeds 4 lanes: fewer
//    shared-memory wavefronts an FMA than 2 lanes' 8-byte one), a row's 4
//    lanes stored as one 16-byte word in the forward epilogue.  A launch
//    of few tiles (a continuation's slots: tiles of 32 would leave the card
//    idle) takes tiles of 16 lanes on twice the SMs, each product one pass
//    of 512 rows (8 rows x 4 lanes a thread); a batch that fills the card
//    keeps tiles of 32 lanes, passes of 320 rows in the forward product
//    (10 rows x 4 lanes a thread) and of 384 in the backward (12 x 4, whose
//    outputs take 4 rows each), the ring's slots as wide as the widest
//    pass (bulk_ring_rows).  Both take a checking iteration's box residuals
//    and updates in one pass; with a carry out, each lane's slack is
//    written ahead to a copy staged in shared memory (carry_stage_bytes)
//    and written out where the lane latches, and where that copy does not
//    fit the two passes stay.
//  * The elementwise step runs on all threads, 256 / T a lane: relaxation,
//    projections, residuals and dual ascent (tile_gemm.cuh,
//    projections.cuh), and the OSQP-form prediction stage by stage; the
//    partial maxima meet in shared memory (a max is exact in any order) and
//    every thread of a lane takes the same rho and latch decision.  A
//    shared count of latched lanes ends the tile's loop.
//  * The OSQP-form residuals are block-structured (dynamics rows A x_i +
//    B u_i - x_{i+1}, the A^T g terms, diagonal costs, the Taylor terminal
//    cost P0 + drho dP): each stage's come from A, B, the cost diagonals, P0
//    and dP, each matvec in one thread in index order.  The new slacks and
//    duals they read (a stage's and the next one's) are first written, each
//    stage by its own thread, to two global scratch arrays, so a stage of
//    any width takes no registers.
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
// Launch contract: the Python wrapper (adaptive_tile_plan) picks the tile,
// the rows a thread and the lanes a thread of the fp32 products (32 lanes
// with 8 or 20 rows at 2 lanes or 20 at 4, 16 lanes with 8 rows at 2 or 16
// at 4, 32 lanes with 20 rows at 2 and the iterates in global memory, and
// 32 lanes with 32 at 8 split over a cluster: the instances), the cluster
// and its blocks' stages, the passes, the padded layouts, the
// residency of maps and state and the dynamic shared-memory size; the entry
// point refuses a layout the kernel would overrun.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "projections.cuh"
#include "tile_gemm.cuh"

// The shipped build compiles this file twice, side by side, and links the
// two (ops/cuda/_build.py PARTS): -DTINYMPC_PART=0 holds the entry points
// and part of the instances, -DTINYMPC_PART=1 the rest (pick_rest); a
// build without the define (a probe build) holds everything.
#ifndef TINYMPC_PART
#define TINYMPC_PART -1
#endif

namespace {

using namespace tinympc;

constexpr int kRhoInterval = 5;
constexpr float kEps = 1e-10f;
constexpr float kDeadband = 5.0f;
constexpr float kMaxStep = 10.0f;

struct Params {
  // the maps, with a leading group axis where map_grouped
  const float* t1t;  // (ord1, in1, ld1): T1 block c transposed, [c][k][row]
                     // (bulk-ring layouts: [c][pass][k][row], pass_rows)
  const float* t2t;  // (sw + 1, ld2): the T2 blocks transposed, row 4 r + c
                     // of the stack is row r of block c (bulk-ring
                     // layouts: [pass][k][row])
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
  float* wsc;         // (sw, B) new slacks: the projected stages' scratch,
                      // and every stage's for the OSQP-form residuals; null
                      // where neither runs
  float* dsc;         // (sw, B) the OSQP-form residuals' new duals
  float* vecg;        // (in1, ldg) the tiles' vec1 in global memory
  float* uxg;         // (sw + 1, ldg) their ux / vec2 (both kGlobal)
  __nv_bfloat16* w2hg;  // (ldg, max(kp1, kp2)) a product's rounded input
                        // (kGlobal, reduced)
  float* uxo;         // (sw, B) ux for the OSQP-form residuals (kCluster)
  int nx, nu, N, su, sx, sw, in1, B, L;  // B = G * L lanes
  int tiles, ldg;     // tiles a group; columns of the tiles' global arrays
  int ord1, ld1, ld2, kp1, kp2, passes1, passes2;
  // a cluster of ``cluster`` blocks a tile (kCluster; 1 otherwise): block c
  // owns stages [stages[c], stages[c + 1]) of the list of the N - 1 input
  // stages then the N state stages (its rows of ux, the forward product's
  // output) and input stages [ustages[c], ustages[c + 1]) (its rows of d,
  // the backward product's); the last block also the rows of x0 and the
  // constant 1 of vec1 and the 1 of vec2.  rows1 / rows2: the most rows of
  // vec1 / ux a block owns.
  int cluster, rows1, rows2;
  int stages[kMaxCluster + 1], ustages[kMaxCluster + 1];
  int cons_shared;    // the constraint data staged in shared memory
  int carry_stage;    // the lanes' carry slacks staged in shared memory
                      // (carry_stage_bytes after the layout) and written
                      // out where a lane latches
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

// Byte offsets of the block's shared memory for a tile of T lanes (W: the
// rows of a slot of the fp32 products' ring, bulk_ring_rows on the
// bulk-ring layouts): vec1
// (rows1 x T floats: in1 rows, or a cluster block's own), ux / vec2
// (rows2: sw + 1, or the block's own; neither with kGlobal, where they live
// in global memory and stream beside each ring slab), the latch flags
// (T + 1 ints), the lanes' rho before and after the update (2 x T), the
// elementwise partials (3 float4 a thread), the lanes' duals and slacks
// where resident, with kCluster the cluster's meta (kClusterMeta), the map
// region (resident: both fp32 maps, then both bf16 ones with reduced
// iterations; streamed: the slab ring), the bf16 product input ([lane][k],
// reduced only; in global memory with kGlobal and kCluster).
struct K2Layout {
  size_t ux, flags, rho, red, state, meta, map, t2, t1a, t2a, w2h, total;
};

__host__ __device__ inline K2Layout k2_layout(
    int T, In in, int W, int rows1, int rows2, int in1, int sw, int ord1,
    int ld1, int ld2, int kp1, int kp2, int state_floats, bool resident,
    bool reduced) {
  K2Layout t;
  const bool wg = in == In::kGlobal;
  size_t off =
      wg ? 0 : up16(sizeof(float) * static_cast<size_t>(rows1) * T);
  t.ux = off;
  if (!wg) off += up16(sizeof(float) * static_cast<size_t>(rows2) * T);
  t.flags = off;
  off += up16(sizeof(int) * (T + 1));
  t.rho = off;
  off += up16(sizeof(float) * 2 * T);
  t.red = off;
  off += up16(sizeof(float) * 12 * kThreads);
  t.state = off;
  off += up16(sizeof(float) * static_cast<size_t>(state_floats) * T);
  t.meta = off;
  if (in == In::kCluster) off += kClusterMeta;
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
    const int wt = in == In::kShared ? 0 : T;
    off += up16(ring_bytes(W, reduced, wt) > ring_bytes(W, false, wt)
                    ? ring_bytes(W, reduced, wt)
                    : ring_bytes(W, false, wt));
  }
  t.w2h = off;
  const int kp = kp1 > kp2 ? kp1 : kp2;
  if (reduced && in == In::kShared)
    off += up16(2 * static_cast<size_t>(T) * (kp + kPadLo));
  t.total = off;
  return t;
}

// Rows of a slot of a bulk-ring layout's fp32 ring: the widest pass of
// either product (W rows at once in the forward, W2 in the backward; a
// backward of one pass its ld2 padded rows), at least W.
__host__ __device__ inline int bulk_ring_rows(int W, int W2, int passes2,
                                              int ld2) {
  const int w2 = passes2 > 1 ? W2 : ld2;
  return w2 > W ? w2 : W;
}

// Bytes of a tile's staged carry slacks (sw rows of T lanes), after the
// layout: a bulk-ring launch with a carry out takes a checking iteration's
// box residuals and updates in one pass and writes each lane's slack there
// ahead, instead of to the (dim, B) outputs, where it fits.
__host__ __device__ inline size_t carry_stage_bytes(int sw, int T) {
  return up16(sizeof(float) * static_cast<size_t>(sw) * T);
}

// Row of the first entry of stage s of the list of the N - 1 input stages
// then the N state stages.
__host__ __device__ inline int stage_row(int s, int nu, int nx, int n_u) {
  return s <= n_u ? s * nu : n_u * nu + (s - n_u) * nx;
}

// What one block works on.
struct Tile {
  float* vec1;                 // (in1, T): element (r, l) at vec1[r * bs + l]
                               // for the block's rows v0 <= r < v1
  float* ux;                   // (sw + 1, T), the same for u0 <= r < u1
  int bs;                      // T in shared memory; ldg in global
  const int* done;             // (T,) latched (or absent) lanes
  float* state;                // resident duals and slacks, or null
  float* ring;                 // streamed slabs; null where resident
  const float* t1;             // the group's maps: in shared memory where
  const float* t2;             // resident, else in global memory
  const __nv_bfloat16* t1a;
  const __nv_bfloat16* t2a;
  __nv_bfloat16* w2h;          // shared (T, kp + kPadLo); kGlobal,
                               // kCluster: the tile's global (T, kp) rows
  SideData du, dx;             // the sides' constraint data
  float rho0;
  int tid, lane0, nvalid, g, gm;
  // the block's slice (all of it without a cluster): ux rows [r0, r1) (the
  // forward product's output), input stages [ku0, ku1), state stages [kx0,
  // kx1), d rows [d0, d1) (the backward product's); the rows of vec1 [v0,
  // v1) = [d0, d1) and of ux [u0, u1) = [r0, r1) it keeps, plus those of
  // x0 and the 1s on the last block; its first padded row of each map
  int rank, r0, r1, ku0, ku1, kx0, kx1, d0, d1, v1, u1, m1row0, m2row0;
  ClusterIn* ci1;              // kCluster: where each k-row of vec1 lives
  ClusterIn* ci2;              // ... and of ux / vec2
  float4* cred;                // kCluster: the lanes' residual maxima
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

// The fp32 products' thread layout of an instance: lanes a thread (LPT: 8
// on a cluster, RPT / 4 rows; 4 in the bulk-ring layouts, RPT / 2 rows;
// else 2, RPT rows), the rows a thread of the backward product (whole
// outputs of the interleaved stack: a multiple of 4, so the four block
// sums of an output are in one thread; 12 where the forward takes 10), the
// ring's slab depth and slots (16 k-rows in 3 slots where a thread takes
// more than 2 lanes, else 8 in 6: the same bytes), whether a slab carries
// only the map's valid rows (a cluster block's slice; the bulk-ring
// layouts' one pass over fewer rows), and whether the ring fills by the
// bulk copy engine with no block barrier a slab (gemm_fp32's kMbar; those
// layouts' maps have their rows padded only to a thread's rows, so a slab
// is one copy).  The bulk-ring layouts: the continuation layout (tiles of
// 16 lanes, 8 rows x 4 lanes a thread, each product one pass, for launches
// whose tiles of 32 would leave the card idle) and tiles of 32 lanes at 10
// rows x 4 lanes (12 in the backward product), in one pass or more, for
// the batches that fill it (adaptive_tile_plan); their maps are laid out
// pass by pass (pass_rows), so that a slab of any pass is one copy.
template <int RPT, int T, In kIn, int LPT>
struct K2Product {
  static constexpr int kLanes = kIn == In::kCluster ? 8 : LPT;
  static constexpr int kRows = RPT * 2 / kLanes;
  static constexpr int kRows2 = (kRows + 3) / 4 * 4;
  static constexpr bool kDeep = kLanes > 2;
  static constexpr int kSK = kDeep ? kSlabKWide : kSlabK;
  static constexpr int kST = kDeep ? kStagesWide : kStages;
  static constexpr bool kMbar = kIn == In::kShared && kLanes == 4;
  static constexpr bool kValid = kIn == In::kCluster || kMbar;
  static_assert(kLanes == 2 || kLanes == 4 || kLanes == 8,
                "lanes a thread: 2, 4 or 8");
};

// The forward product into ux: the T1 blocks from order o down to 0, a pass
// of W rows at a time.  The Horner value v = v drho + acc of each output
// the thread sums lives in its entry of ux, which no other thread touches
// until the product is done (the registers hold the product's tile only).
template <int RPT, int T, In kIn, int LPT>
__device__ __forceinline__ void forward(const Params& p, const Tile& t,
                                        bool lo, const float* rho_b) {
  const int W = Lanes<T>::kRowGroups * RPT, ord1 = p.ord1;
  using P = K2Product<RPT, T, kIn, LPT>;
  auto epi = [&](int j, const auto& acc, const auto& fr) {
    const int c = ord1 - 1 - j % ord1, r0 = t.r0 + (j / ord1) * W;
    using F = std::decay_t<decltype(fr)>;
    constexpr bool kRow4 = [] {
      if constexpr (F::kLo)
        return false;
      else
        return F::kLanes == 4 && kIn == In::kShared;
    }();
    if constexpr (kRow4) {
      // the bulk-ring layouts: a row's 4 lanes as one 16-byte load and
      // store (a warp's rows share the banks), their drho read once
      const int l0 = fr.lane(0);
      float4 d = *reinterpret_cast<const float4*>(rho_b + l0);
      d = make_float4(__fsub_rn(d.x, t.rho0), __fsub_rn(d.y, t.rho0),
                      __fsub_rn(d.z, t.rho0), __fsub_rn(d.w, t.rho0));
#pragma unroll
      for (int i = 0; i < F::kN / 4; ++i) {
        const int r = r0 + fr.row(4 * i);
        if (r >= t.r1) continue;
        float4* v = reinterpret_cast<float4*>(t.ux + r * t.bs + l0);
        const float* a = acc + 4 * i;
        if (c == ord1 - 1) {
          *v = make_float4(a[0], a[1], a[2], a[3]);
        } else {
          const float4 u = *v;
          *v = make_float4(__fadd_rn(__fmul_rn(u.x, d.x), a[0]),
                           __fadd_rn(__fmul_rn(u.y, d.y), a[1]),
                           __fadd_rn(__fmul_rn(u.z, d.z), a[2]),
                           __fadd_rn(__fmul_rn(u.w, d.w), a[3]));
        }
      }
      return;
    }
#pragma unroll
    for (int e = 0; e < F::kN; ++e) {
      const int r = r0 + fr.row(e), l = fr.lane(e);
      if (r < t.r1) {
        float* v = t.ux + r * t.bs + l;
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
    GemmLo a{kIn == In::kCluster ? t.vec1 + t.d0 * t.bs : t.vec1, t.w2h,
             reinterpret_cast<__nv_bfloat16*>(t.ring), p.in1, p.kp1, W,
             nseg, t.tid, lda, t.bs};
    if constexpr (kIn == In::kCluster) a.ci = t.ci1;
    if constexpr (P::kValid) {
      a.vrows = t.r1 - t.r0;
      a.vper = ord1;
    }
    gemm_lo<RPT, T, kIn>(a, [&](int j) {
      const int c = ord1 - 1 - j % ord1, pass = j / ord1;
      return t.t1a +
             (static_cast<size_t>(c) * p.ld1 + t.m1row0 + pass * W) * lda;
    }, epi);
  } else {
    // pass by pass: every pass's rows W apart but the last's (ld)
    const int ld = P::kMbar ? p.ld1 - (p.passes1 - 1) * W : p.ld1;
    GemmF32 a{t.vec1, t.ring, p.in1, W, ld, nseg, t.tid, t.bs};
    if constexpr (kIn == In::kCluster) a.ci = t.ci1;
    if constexpr (P::kValid) {
      a.vrows = t.r1 - t.r0;
      a.vper = ord1;
    }
    gemm_fp32<P::kRows, T, kIn, P::kLanes, P::kSK, P::kST, false, P::kMbar>(
        a, [&](int j) {
      const int c = ord1 - 1 - j % ord1, pass = j / ord1;
      if constexpr (P::kMbar)
        return t.t1 + (static_cast<size_t>(c) * p.ld1 + pass * W) * p.in1;
      else
        return t.t1 + static_cast<size_t>(c) * p.in1 * p.ld1 + t.m1row0 +
               pass * W;
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
// pass of W stacked rows (W / 4 outputs) at a time (the fp32 product's W
// at its own rows a thread, K2Product::kRows2).
template <int RPT, int T, In kIn, int LPT>
__device__ __forceinline__ void backward(const Params& p, const Tile& t,
                                         bool lo, const float* rho_b,
                                         const float* rho_n) {
  using P = K2Product<RPT, T, kIn, LPT>;
  const int W = Lanes<T>::kRowGroups * RPT;
  const int W2 = W / P::kRows * P::kRows2;
  // r: the output's index in the block's d rows
  auto store = [&](int r, int l, float a0, float a1, float a2, float a3) {
    r += t.d0;
    if (takes(t, r, t.d1, l))
      t.vec1[r * t.bs + l] = bilinear(
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
      using F = std::decay_t<decltype(fr)>;
      constexpr int kL = F::kLanes;
      static_assert(F::kN / kL % 4 == 0, "whole outputs a thread");
#pragma unroll
      for (int r4 = 0; r4 < F::kN / kL / 4; ++r4)
#pragma unroll
        for (int q = 0; q < kL; ++q) {
          const int e = 4 * kL * r4 + q;  // row 4 r4 of the thread's, lane q
          store((j * W2 + fr.row(e)) / 4, fr.lane(e), acc[e], acc[e + kL],
                acc[e + 2 * kL], acc[e + 3 * kL]);
        }
    }
  };
  if (lo) {
    const int lda = t.ring ? p.kp2 : p.kp2 + kPadLo;
    // the bf16 stack in passes of W rows (passes2 counts the fp32
    // product's of W2)
    const int np = P::kRows2 == P::kRows ? p.passes2
                                         : (4 * (t.d1 - t.d0) + W - 1) / W;
    GemmLo a{kIn == In::kCluster ? t.ux + t.r0 * t.bs : t.ux, t.w2h,
             reinterpret_cast<__nv_bfloat16*>(t.ring), p.sw + 1, p.kp2, W,
             np, t.tid, lda, t.bs};
    if constexpr (kIn == In::kCluster) a.ci = t.ci2;
    if constexpr (P::kValid) a.vrows = 4 * (t.d1 - t.d0);
    gemm_lo<RPT, T, kIn>(a, [&](int j) {
      return t.t2a + static_cast<size_t>(t.m2row0 + j * W) * lda;
    }, epi);
  } else {
    // pass by pass: every pass's rows W2 apart but the last's (ld)
    const int ld = P::kMbar ? p.ld2 - (p.passes2 - 1) * W2 : p.ld2;
    GemmF32 a{t.ux, t.ring, p.sw + 1, W2, ld, p.passes2, t.tid, t.bs};
    if constexpr (kIn == In::kCluster) a.ci = t.ci2;
    if constexpr (P::kValid) a.vrows = 4 * (t.d1 - t.d0);
    gemm_fp32<P::kRows2, T, kIn, P::kLanes, P::kSK, P::kST, false, P::kMbar>(
        a, [&](int j) {
      if constexpr (P::kMbar)
        return t.t2 + static_cast<size_t>(j) * W2 * (p.sw + 1);
      else
        return t.t2 + t.m2row0 + j * W2;
    }, epi);
  }
}

// The new slack and the ascended dual of each of thread q's stages of one
// side, as the update pass would compute them (the same functions, so the
// same bits), into the side's rows of the scratch arrays w and dn (element
// r at [r * B]): a projected side's stages (sp.qs on) projected where they
// live, the scratch itself, kStageBatchSmall rows' loads at a time; a box
// side's (q on) row by row.
template <int T, bool kProj>
__device__ __forceinline__ void stage_new(const Params& p,
                                          const SidePass& sp, int g,
                                          bool relax, int q, float* w,
                                          float* dn) {
  constexpr int kB = kStageBatchSmall;
  const Side& s = *sp.s;
  const int B = p.B, k1 = min(sp.k1, s.n_stages);
  for (int k = sp.k0 + (kProj ? sp.qs : q); k < k1;
       k += Lanes<T>::kLaneThreads) {
    const int rk = k * s.dim;
    if constexpr (!kProj) {
      for (int r = rk; r < rk + s.dim; ++r) {
        const int o = r * sp.stride, b = g * s.box_stride + r;
        const float dual = sp.dual ? sp.dual[o] : 0.0f;
        const float wh = relaxed(p, relax, sp.ux[r * sp.us], sp.prev[o]);
        const float v = box_slack(s, wh, sp.dual != nullptr, dual,
                                  s.en_box ? __ldg(s.wmin + b) : 0.0f,
                                  s.en_box ? __ldg(s.wmax + b) : 0.0f);
        w[r * B] = v;
        dn[r * B] = sp.dual ? __fsub_rn(__fadd_rn(dual, wh), v) : 0.0f;
      }
      continue;
    }
    const StageMem st{w + rk * B, B};
    stage_slack<kB>(p, sp, g, k, relax, false, st);
    project_stage(st, s, sp.d);
    for (int j0 = 0; j0 < s.dim; j0 += kB) {
      float u[kB], prev[kB], dual[kB], vn[kB];
#pragma unroll
      for (int i = 0; i < kB; ++i) {
        const int j = j0 + i, r = rk + j, o = r * sp.stride;
        if (j < s.dim) {
          u[i] = sp.ux[r * sp.us];
          prev[i] = sp.prev[o];
          dual[i] = sp.dual ? sp.dual[o] : 0.0f;
          vn[i] = st[j];
        }
      }
#pragma unroll
      for (int i = 0; i < kB; ++i) {
        const int j = j0 + i;
        if (j < s.dim)
          dn[(rk + j) * B] =
              sp.dual ? __fsub_rn(__fadd_rn(dual[i], relaxed(p, relax, u[i],
                                                             prev[i])),
                                  vn[i])
                      : 0.0f;
      }
    }
  }
}

// The OSQP-form residuals' inputs of one lane, before this iteration's
// update pass: the new slack and dual of every stage of the block's slice of
// both sides, each thread its stages, into the scratch (the lane's column:
// wsc + lane, dsc + lane).
template <int T, bool kProjU, bool kProjX>
__device__ void osqp_fill(const Params& p, const SidePass& su,
                          const SidePass& sx, int g, bool relax, int lane,
                          int q) {
  const int B = p.B;
  stage_new<T, kProjX>(p, sx, g, relax, q, p.wsc + p.su * B + lane,
                       p.dsc + p.su * B + lane);
  stage_new<T, kProjU>(p, su, g, relax, q, p.wsc + lane, p.dsc + lane);
}

// The residual pass (residuals) or the update pass (else) of thread q of a
// lane over its stages of a projected side, from the new slacks and duals
// osqp_fill wrote (w, dn: the side's rows of the scratch, element r at [r *
// B]): nothing is projected again.  The update writes the carry's slack
// where the lane latches now (latch).
template <int T>
__device__ __forceinline__ void fresh_pass_q(const Params& p,
                                             const SidePass& sp,
                                             const float* w, const float* dn,
                                             bool residuals, bool latch,
                                             float& pri, float& dua) {
  const Side& s = *sp.s;
  const int B = p.B, k1 = min(sp.k1, s.n_stages);
  for (int k = sp.k0 + sp.qs; k < k1; k += Lanes<T>::kLaneThreads) {
    const int rk = k * s.dim;
    for (int j0 = 0; j0 < s.dim; j0 += kStageBatchSmall) {
      float u[kStageBatchSmall], prev[kStageBatchSmall],
          vn[kStageBatchSmall], d[kStageBatchSmall];
#pragma unroll
      for (int i = 0; i < kStageBatchSmall; ++i) {
        const int r = rk + j0 + i;
        if (j0 + i < s.dim) {
          u[i] = sp.ux[r * sp.us];
          prev[i] = sp.prev[r * sp.stride];
          vn[i] = w[r * B];
          d[i] = residuals ? 0.0f : dn[r * B];
        }
      }
#pragma unroll
      for (int i = 0; i < kStageBatchSmall; ++i) {
        const int r = rk + j0 + i, o = r * sp.stride;
        if (j0 + i >= s.dim) continue;
        if (residuals) {
          pri = fmaxf(pri, fabsf(__fsub_rn(u[i], vn[i])));
          dua = fmaxf(dua, fabsf(__fsub_rn(prev[i], vn[i])));
          continue;
        }
        float next = vn[i];
        if (sp.dual) {
          sp.dual[o] = d[i];
          next = __fsub_rn(vn[i], d[i]);
        }
        sp.prev[o] = vn[i];
        if (latch) carry_at(p, sp, r) = prev[i];
        sp.ux[r * sp.us] = next;
      }
    }
  }
}

// The partial maxima of the OSQP-form residuals (ops/rho.py
// osqp_residuals, with the per-lane terminal cost P0 + drho dP) over the
// block's stages q, q + 256 / T, ... of [kx0, kx1) of one lane, from
// osqp_fill's scratch: ux holds [u; x] (the lane's column, element r at
// ux[r * us]).  m: pri_res, pri_norm, dual_res, px_inf, aty_inf, q_inf.
template <int T>
__device__ void osqp_partials(const Params& p, const Tile& t, int gp,
                              const float* ux, int us, int lane, float drho,
                              int q, float (&m)[6]) {
  const int nx = p.nx, nu = p.nu, N = p.N, B = p.B;
  const float* A = p.A + gp * nx * nx;
  const float* Bm = p.Bm + gp * nx * nu;
  const float* qd = p.qd + gp * nx;
  const float* rd = p.rd + gp * nu;
  const float* P0 = p.P0 + gp * nx * nx;
  const float* dP = p.dP + gp * nx * nx;
  const float* xs = ux + p.su * us;
  // the new slacks and duals, element r of a side at [r * B]
  const float* wx = p.wsc + p.su * B + lane;
  const float* dx = p.dsc + p.su * B + lane;
  const float* wu = p.wsc + lane;
  const float* du = p.dsc + lane;
  for (int j = t.kx0 + q; j < t.kx1; j += Lanes<T>::kLaneThreads) {
    const float* xj = xs + j * nx * us;
    const bool inner = j < N - 1;
    const float* vn_n = wx + (j + 1) * nx * B;  // stage j + 1 (inner)
    const float* g_n = dx + (j + 1) * nx * B;
    const float* g_c = dx + j * nx * B;
    if (inner) {
      const float* uj = ux + j * nu * us;
      const float* zn = wu + j * nu * B;
      const float* yn = du + j * nu * B;
      // primal: input rows u_j against znew_j
      for (int a = 0; a < nu; ++a) {
        const float u = uj[a * us];
        m[0] = fmaxf(m[0], fabsf(__fsub_rn(u, zn[a * B])));
        m[1] = fmaxf(m[1], fmaxf(fabsf(u), fabsf(zn[a * B])));
      }
      // dynamics rows A x_j + B u_j - x_{j+1} against vnew_{j+1}
      for (int a = 0; a < nx; ++a) {
        float ax = 0.0f, bu = 0.0f;
        for (int b = 0; b < nx; ++b)
          ax = fmaf(__ldg(A + a * nx + b), xj[b * us], ax);
        for (int b = 0; b < nu; ++b)
          bu = fmaf(__ldg(Bm + a * nu + b), uj[b * us], bu);
        const float dyn = __fsub_rn(__fadd_rn(ax, bu), xj[(nx + a) * us]);
        m[0] = fmaxf(m[0], fabsf(__fsub_rn(dyn, vn_n[a * B])));
        m[1] = fmaxf(m[1], fmaxf(fabsf(dyn), fabsf(vn_n[a * B])));
      }
      // dual, input rows: R u (from P x) + R u (from q) + B^T g_{j+1} + y_j
      for (int a = 0; a < nu; ++a) {
        float btg = 0.0f;
        for (int b = 0; b < nx; ++b)
          btg = fmaf(__ldg(Bm + b * nu + a), g_n[b * B], btg);
        const float aty = __fadd_rn(btg, yn[a * B]);
        const float qu = __fmul_rn(uj[a * us], __ldg(rd + a));
        const float r = __fadd_rn(__fadd_rn(qu, qu), aty);
        m[2] = fmaxf(m[2], fabsf(r));
        m[3] = fmaxf(m[3], fabsf(qu));
        m[5] = fmaxf(m[5], fabsf(qu));
        m[4] = fmaxf(m[4], fabsf(aty));
      }
    }
    // dual, state rows: P x_j + Q x_j + A^T g_{j+1} [inner] - g_j [j >= 1]
    for (int a = 0; a < nx; ++a) {
      const float qx = __fmul_rn(xj[a * us], __ldg(qd + a));
      float px = qx;
      if (!inner) {
        float p0 = 0.0f, dp = 0.0f;
        for (int b = 0; b < nx; ++b) {
          p0 = fmaf(__ldg(P0 + a * nx + b), xj[b * us], p0);
          dp = fmaf(__ldg(dP + a * nx + b), xj[b * us], dp);
        }
        px = __fadd_rn(p0, __fmul_rn(drho, dp));
      }
      float aty = 0.0f;
      if (inner)
        for (int b = 0; b < nx; ++b)
          aty = fmaf(__ldg(A + b * nx + a), g_n[b * B], aty);
      if (j >= 1) aty = __fsub_rn(aty, g_c[a * B]);
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

// RPT: rows a thread of the products (2 RPT / LPT rows x LPT lanes in the
// fp32 products, K2Product); T: lanes a tile; kIn: where the tile's
// iterates live (the block's shared memory, global memory streamed beside
// the maps, or split over a cluster); kProjU/kProjX: whether the input /
// state side has halfspaces or cones.
template <int RPT, int T, In kIn, bool kProjU, bool kProjX, int LPT>
__global__ void __launch_bounds__(kThreads, 1)
    condensed_adaptive_kernel(Params p) {
  using P = K2Product<RPT, T, kIn, LPT>;
  TINYMPC_SEC_BEGIN();
  extern __shared__ float4 smem4[];
  char* sm = reinterpret_cast<char*>(smem4);
  constexpr int tpl = Lanes<T>::kLaneThreads;
  constexpr bool kCl = kIn == In::kCluster;
  const int tid = threadIdx.x;
  const int g = blockIdx.y;
  const int C = kCl ? p.cluster : 1;
  const int tile = blockIdx.x / C;
  const int l0 = tile * T;  // the tile's first index in the group
  const int sw = p.sw, su = p.su, sx = p.sx, in1 = p.in1, B = p.B;
  const bool reduced = p.t1a != nullptr;
  constexpr int W = Lanes<T>::kRowGroups * RPT;
  const K2Layout lay = k2_layout(
      T, kIn,
      P::kMbar ? bulk_ring_rows(W, W / P::kRows * P::kRows2, p.passes2,
                                p.ld2)
               : W,
      kCl ? p.rows1 : in1,
      kCl ? p.rows2 : sw + 1, in1, sw, p.ord1, p.ld1, p.ld2, p.kp1, p.kp2,
      p.state_shared ? state_rows(su, sx, p.state_free) : 0, p.resident,
      reduced);

  Tile t;
  t.tid = tid;
  t.g = g;
  t.gm = p.map_grouped ? g : 0;
  t.lane0 = g * p.L + l0;
  t.nvalid = min(T, p.L - l0);
  // the block's slice
  const int n_u = p.N - 1, n_x = p.N, nu = p.nu;
  t.rank = kCl ? static_cast<int>(cluster_rank()) : 0;
  const bool last = t.rank == C - 1;
  const int s0 = kCl ? p.stages[t.rank] : 0;
  const int s1 = kCl ? p.stages[t.rank + 1] : n_u + n_x;
  t.ku0 = min(s0, n_u);
  t.ku1 = min(s1, n_u);
  t.kx0 = max(s0 - n_u, 0);
  t.kx1 = max(s1 - n_u, 0);
  t.r0 = stage_row(s0, nu, p.nx, n_u);
  t.r1 = stage_row(s1, nu, p.nx, n_u);
  t.d0 = kCl ? p.ustages[t.rank] * nu : 0;
  t.d1 = kCl ? p.ustages[t.rank + 1] * nu : su;
  t.v1 = last ? in1 : t.d1;
  t.u1 = last ? sw + 1 : t.r1;
  t.m1row0 = t.rank * (p.ld1 / C);
  t.m2row0 = t.rank * (p.ld2 / C);
  // the tile's own columns of the global arrays
  const size_t col0 = static_cast<size_t>(g * p.tiles + tile) * T;
  if constexpr (kIn == In::kGlobal) {
    t.vec1 = p.vecg + col0;
    t.ux = p.uxg + col0;
    t.bs = p.ldg;
  } else {
    // the block's rows from each buffer's start
    t.vec1 = reinterpret_cast<float*>(sm) - t.d0 * T;
    t.ux = reinterpret_cast<float*>(sm + lay.ux) - t.r0 * T;
    t.bs = T;
  }
  int* done = reinterpret_cast<int*>(sm + lay.flags);
  int* n_done = done + T;
  t.done = done;
  float* rho_s = reinterpret_cast<float*>(sm + lay.rho);
  float4* red = reinterpret_cast<float4*>(sm + lay.red);
  t.state = p.state_shared ? reinterpret_cast<float*>(sm + lay.state)
                           : nullptr;
  if constexpr (kIn == In::kShared) {
    t.w2h =
        reduced ? reinterpret_cast<__nv_bfloat16*>(sm + lay.w2h) : nullptr;
  } else {
    t.w2h = reduced ? p.w2hg + col0 * (p.kp1 > p.kp2 ? p.kp1 : p.kp2)
                    : nullptr;
  }
  t.ci1 = t.ci2 = nullptr;
  t.cred = nullptr;
  if constexpr (kCl) {
    t.cred = reinterpret_cast<float4*>(sm + lay.meta);
    ClusterIn* ci1 = reinterpret_cast<ClusterIn*>(sm + lay.meta + 3 * 16 * 32);
    ClusterIn* ci2 = reinterpret_cast<ClusterIn*>(sm + lay.meta + 3 * 16 * 32 +
                                                  256);
    if (tid < C) {
      ci1->base[tid] = peer_address(sm, tid);
      ci2->base[tid] = peer_address(sm + lay.ux, tid);
      ci1->kb[tid] = p.ustages[tid] * nu;
      ci2->kb[tid] = stage_row(p.stages[tid], nu, p.nx, n_u);
    }
    if (tid == 0) {
      ci1->kb[C] = in1;
      ci2->kb[C] = sw + 1;
      ci1->C = ci2->C = C;
      ci1->rank = ci2->rank = t.rank;
    }
    t.ci1 = ci1;
    t.ci2 = ci2;
  }
  t.du = side_data(p.side_u, g);
  t.dx = side_data(p.side_x, g);
  // the staged carry slacks ([row][lane], u rows then x rows), then the
  // constraint data
  float* cstage =
      p.carry_stage ? reinterpret_cast<float*>(sm + lay.total) : nullptr;
  const size_t after =
      lay.total + (p.carry_stage ? carry_stage_bytes(sw, T) : 0);
  if (p.cons_shared)
    stage_constraints(p.side_u, p.side_x, g, sm + after, tid, kThreads,
                      &t.du, &t.dx);
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
    for (int r = t.d0 + q; r < t.v1; r += tpl) {
      float v = 0.0f;
      if (r < su) {
        v = warm ? p.d_in[r * B + lane] : 0.0f;
      } else if (r < su + p.nx) {
        v = valid ? p.x0[lane * p.nx + r - su] : 0.0f;
      } else {
        v = 1.0f;
      }
      t.vec1[r * t.bs + l] = v;
    }
    for (int r = t.r0 + q; r < t.u1; r += tpl)
      t.ux[r * t.bs + l] = r == sw ? 1.0f : 0.0f;
    if (valid) {
      for (int r = t.ku0 * nu + q; r < t.ku1 * nu; r += tpl) {
        st.y[r * S] = warm ? p.y_in[r * B + lane] : 0.0f;
        st.z[r * S] = warm ? p.z_in[r * B + lane] : 0.0f;
      }
      for (int r = t.kx0 * p.nx + q; r < t.kx1 * p.nx; r += tpl) {
        if (st.g) st.g[r * S] = warm ? p.g_in[r * B + lane] : 0.0f;
        st.v[r * S] = warm ? p.v_in[r * B + lane] : 0.0f;
      }
    }
    if (q == 0) {
      done[l] = valid ? 0 : 1;
      rho_s[l] = warm ? p.rho_in[lane] : t.rho0;
      rho_s[T + l] = rho_s[l];
      if (valid && t.rank == 0) {
        p.iters[lane] = p.max_iter;
        p.solved[lane] = 0;
      }
    }
  }
  if (tid == 0) *n_done = 0;
  if constexpr (P::kMbar)
    if (tid == 0) ring_bars_init();
  // a barrier of the block, or of the cluster, whose blocks read each
  // other's iterates
  auto sync = [] {
    if constexpr (kCl)
      cluster_sync();
    else
      __syncthreads();
  };
  sync();
  TINYMPC_SEC(kSecOther);

  const bool relax = p.alpha != 1.0f;
  const int gp = p.plant_grouped ? g : 0;
  int cur = 0;  // which half of rho_s holds the lanes' rho
  for (int i = 0; i < p.max_iter; ++i) {
    TINYMPC_SEC_ITERATION();
    const bool check = (i + 1) % p.ct == 0;
    const bool update = i > 0 && i % kRhoInterval == 0;
    // an iteration that checks or predicts rho runs its products in fp32
    const bool lo = p.lo_all && !check && !update;
    const float* rho_b = rho_s + cur * T;
    float* rho_n = rho_s + (cur ^ 1) * T;

    forward<RPT, T, kIn, LPT>(p, t, lo, rho_b);
    sync();  // ux complete; no block reads vec1 any more
    TINYMPC_SEC(kSecBarrier);

    // the elementwise step of lane l, thread q of its 256 / T
    const bool active = !done[l];
    const LaneState st = lane_state<T>(p, t, l);
    float* wsc = p.wsc ? p.wsc + lane : nullptr;
    SidePass su_p{&p.side_u, t.ux + l, st.z, st.y, nullptr,
                  cstage ? cstage + l : p.zco + lane, st.stride, t.bs, wsc,
                  B, p.side_u.dim * B, t.du, t.ku0, t.ku1};
    SidePass sx_p{&p.side_x, t.ux + l + su * t.bs, st.v, st.g, nullptr,
                  cstage ? cstage + su * T + l : p.vco + lane, st.stride,
                  t.bs, wsc ? wsc + su * B : nullptr, B, p.side_x.dim * B,
                  t.dx, t.kx0, t.kx1};
    if (cstage) su_p.cs = sx_p.cs = T;
    // the two sides' projected stages go round the lane's threads as one
    // list; a box side beside a projected one is shared out against it
    constexpr bool kRangeU = kProjX && !kProjU, kRangeX = kProjU && !kProjX;
    if constexpr (kProjU) su_p.qs = q;
    if constexpr (kProjX)
      sx_p.qs = kProjU ? (q + tpl - slice_stages(su_p) % tpl) % tpl : q;
    if constexpr (kRangeU) box_share<tpl>(su_p, sx_p, q);
    if constexpr (kRangeX) box_share<tpl>(sx_p, su_p, q);
    const float rb = rho_b[l];
    float rho_new = rb;
    bool newly = false;
    const bool osqp_now = update && p.osqp;
    // the termination residuals, on a checking iteration and where the
    // termination controller predicts rho
    const bool term = check || (update && !p.osqp);
    // the bulk-ring layouts take a box side's residuals and update in one
    // pass (box_pass_q) where the launch has no carry out or stages it
    // (the carry's slack written ahead to the staged copy on a checking
    // iteration; to the outputs it would cost every lane's slack every
    // such iteration); the other layouts and launches keep the two passes
    const bool fused =
        P::kMbar && term && !osqp_now && (!p.carry_out || cstage);
    float pi = 0.0f, di = 0.0f, ps = 0.0f, ds = 0.0f;
    if (active && !osqp_now) {  // a projected side's one pass: its stages'
                                // residuals and updates
      const bool ahead = check && p.carry_out;
      if constexpr (kProjU)
        projected_pass<T, kStageBatchSmall>(p, su_p, g, relax, q, false,
                                            term, ahead, pi, di);
      if constexpr (kProjX)
        projected_pass<T, kStageBatchSmall>(p, sx_p, g, relax, q, false,
                                            term, ahead, ps, ds);
    }
    TINYMPC_SEC(kSecStep);
    if (osqp_now) {  // every stage's new slack and dual, for all threads
      if (active) {
        osqp_fill<T, kProjU, kProjX>(p, su_p, sx_p, g, relax, lane, q);
        if constexpr (kCl)  // the block's rows of ux, for the neighbours'
          for (int r = t.r0 + q; r < t.r1; r += tpl)
            p.uxo[r * B + lane] = t.ux[r * t.bs + l];
      }
      sync();
      TINYMPC_SEC(kSecRho);
    }
    if (check || update) {
      float m[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      if (active) {
        const bool ahead = check && p.carry_out;
        if (term) {  // the projected slacks are fresh after osqp_fill
          if constexpr (!kProjU) {
            if (fused)
              box_pass_q<kRangeU, T>(p, su_p, g, relax, q, false, ahead, pi,
                                     di);
            else
              box_residuals_q<kRangeU, T>(p, su_p, g, relax, q, false, pi,
                                          di);
          } else if (osqp_now) {
            fresh_pass_q<T>(p, su_p, p.wsc + lane, p.dsc + lane, true,
                            false, pi, di);
          }
          if constexpr (!kProjX) {
            if (fused)
              box_pass_q<kRangeX, T>(p, sx_p, g, relax, q, false, ahead, ps,
                                     ds);
            else
              box_residuals_q<kRangeX, T>(p, sx_p, g, relax, q, false, ps,
                                          ds);
          } else if (osqp_now)
            fresh_pass_q<T>(p, sx_p, p.wsc + su * B + lane,
                            p.dsc + su * B + lane, true, false, ps, ds);
        }
        TINYMPC_SEC(kSecStep);
        if (osqp_now) {
          if constexpr (kCl)
            osqp_partials<T>(p, t, gp, p.uxo + lane, B, lane,
                             __fsub_rn(rb, t.rho0), q, m);
          else
            osqp_partials<T>(p, t, gp, t.ux + l, t.bs, lane,
                             __fsub_rn(rb, t.rho0), q, m);
          TINYMPC_SEC(kSecRho);
        }
      }
      red[tid] = make_float4(pi, di, ps, ds);
      red[kThreads + tid] = make_float4(m[0], m[1], m[2], m[3]);
      red[2 * kThreads + tid] = make_float4(m[4], m[5], 0.0f, 0.0f);
      __syncthreads();
      TINYMPC_SEC(kSecMaximaWait);
      auto fold = [&](const float4& a, const float4& b, const float4& c) {
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
      };
      if (active)
        for (int j = 0; j < tpl; ++j) {
          const int o = j * T + l;
          fold(red[o], red[kThreads + o], red[2 * kThreads + o]);
        }
      if constexpr (kCl) {  // ... then the cluster's blocks'
        if (q == 0) {
          t.cred[3 * l] = make_float4(pi, di, ps, ds);
          t.cred[3 * l + 1] = make_float4(m[0], m[1], m[2], m[3]);
          t.cred[3 * l + 2] = make_float4(m[4], m[5], 0.0f, 0.0f);
        }
        cluster_sync();
        for (int c = 0; c < C; ++c) {
          const unsigned a = peer_address(t.cred + 3 * l, c);
          fold(peer_load4(a), peer_load4(a + 16), peer_load4(a + 32));
        }
      }
      TINYMPC_SEC(kSecMaxima);
      if (active) {
        if (update)
          rho_new = p.osqp ? osqp_predict(p, m, rb)
                           : termination_predict(p, t.gm, fmaxf(ps, pi),
                                                 fmaxf(ds, di), rb);
        // the latch: dual residuals scale by the post-update rho
        newly = check && ps < p.pri_tol && pi < p.pri_tol &&
                __fmul_rn(ds, rho_new) < p.dua_tol &&
                __fmul_rn(di, rho_new) < p.dua_tol;
      }
      TINYMPC_SEC(kSecRho);
    }
    // a box side's slack, dual, output and carry updates (and a projected
    // side's from the scratch after osqp_fill); ux becomes vec2
    if (active) {
      const bool latch = p.carry_out && newly;
      float unused = 0.0f;
      if constexpr (!kProjU) {
        if (!fused)
          box_update_q<kRangeU, T>(p, su_p, g, relax, q, false, latch);
      } else if (osqp_now) {
        fresh_pass_q<T>(p, su_p, p.wsc + lane, p.dsc + lane, false, latch,
                        unused, unused);
      }
      if constexpr (!kProjX) {
        if (!fused)
          box_update_q<kRangeX, T>(p, sx_p, g, relax, q, false, latch);
      } else if (osqp_now)
        fresh_pass_q<T>(p, sx_p, p.wsc + su * B + lane,
                        p.dsc + su * B + lane, false, latch, unused, unused);
    }
    TINYMPC_SEC(kSecStep);
    if (q == 0) {
      rho_n[l] = rho_new;
      if (newly) {  // the outputs hold vnew/znew; d stays frozen
        if (t.rank == 0) {
          p.iters[lane] = i + 1;
          p.solved[lane] = 1;
        }
        done[l] = 1;
        atomicAdd(n_done, 1);
      }
    }
    TINYMPC_SEC(kSecMaxima);
    sync();  // vec2 complete
    TINYMPC_SEC(kSecStep);  // the wait for the lanes' slowest thread
    if (cstage && newly) {  // the latched lane's staged carry slacks, out
      for (int r = q; r < su; r += tpl)
        p.zco[r * B + lane] = cstage[r * T + l];
      for (int r = q; r < sx; r += tpl)
        p.vco[r * B + lane] = cstage[(su + r) * T + l];
    }
    cur ^= 1;
    if (*n_done == t.nvalid) break;  // every lane of the tile has latched

    // backward: cost fold at the pre-update drho, gain at the post-update
    backward<RPT, T, kIn, LPT>(p, t, lo, rho_b, rho_n);
    sync();  // d complete; no block reads vec2 any more
    TINYMPC_SEC(kSecBarrier);
  }

  // the outputs from the resident state, the rho, d and the carry of the
  // lanes that never latched: their last state
  if (valid) {
    const LaneState st = lane_state<T>(p, t, l);
    const int S = st.stride;
    const bool carry = p.carry_out && !done[l];
    if (q == 0 && t.rank == 0) p.rho_out[lane] = rho_s[cur * T + l];
    for (int r = t.d0 + q; r < t.d1; r += tpl)
      if (p.carry_out) p.d_out[r * B + lane] = t.vec1[r * t.bs + l];
    for (int r = t.ku0 * nu + q; r < t.ku1 * nu; r += tpl) {
      const float z = st.z[r * S];
      if (t.state) {
        p.uout[r * B + lane] = z;
        p.y[r * B + lane] = st.y[r * S];
      }
      if (carry) p.zco[r * B + lane] = z;
    }
    for (int r = t.kx0 * p.nx + q; r < t.kx1 * p.nx; r += tpl) {
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

// The kernel for RPT rows a thread, LPT lanes a thread of the fp32
// products, tiles of T lanes and the iterates in shared, global or a
// cluster's memory, with the projections the sides need.
template <int RPT, int T, In kIn, int LPT = 2>
void (*tile_kernel(bool proj_u, bool proj_x))(Params) {
  return proj_u
             ? (proj_x
                    ? condensed_adaptive_kernel<RPT, T, kIn, true, true, LPT>
                    : condensed_adaptive_kernel<RPT, T, kIn, true, false, LPT>)
             : (proj_x
                    ? condensed_adaptive_kernel<RPT, T, kIn, false, true, LPT>
                    : condensed_adaptive_kernel<RPT, T, kIn, false, false,
                                                LPT>);
}

// The instances adaptive_tile_plan picks from (lanes: a thread's of the
// fp32 products), in two sets that the shipped build compiles in two
// translation units side by side (TINYMPC_PART, below): tiles of 32 lanes
// with the iterates in shared memory (part 0, beside the entry points), and
// the rest (part 1); null for any other.
#if TINYMPC_PART != 1
void (*pick_shared32(int tile, int rpt, int lanes, In in, bool proj_u,
                     bool proj_x))(Params) {
  if (tile != 32 || in != In::kShared) return nullptr;
  if (lanes == 4 && rpt == 20)  // the bulk-ring layout of the bulk batches
    return tile_kernel<20, 32, In::kShared, 4>(proj_u, proj_x);
  if (lanes == 2 && rpt == 8)
    return tile_kernel<8, 32, In::kShared>(proj_u, proj_x);
  if (lanes == 2 && rpt == 20)
    return tile_kernel<20, 32, In::kShared>(proj_u, proj_x);
  return nullptr;
}
#endif

#if TINYMPC_PART != 0
void (*pick_rest(int tile, int rpt, int lanes, In in, bool proj_u,
                 bool proj_x))(Params) {
  if (in == In::kCluster)
    return tile == 32 && rpt == 32 && lanes == 8
               ? tile_kernel<32, 32, In::kCluster, 8>(proj_u, proj_x)
               : nullptr;
  if (lanes == 4)  // the continuation layout
    return tile == 16 && in == In::kShared && rpt == 16
               ? tile_kernel<16, 16, In::kShared, 4>(proj_u, proj_x)
               : nullptr;
  if (lanes != 2) return nullptr;
  if (tile == 16 && in == In::kShared && rpt == 8)
    return tile_kernel<8, 16, In::kShared>(proj_u, proj_x);
  if (tile == 32 && in == In::kGlobal && rpt == 20)
    return tile_kernel<20, 32, In::kGlobal>(proj_u, proj_x);
  return nullptr;
}
#endif

In layout_of(int iterates_global, int cluster) {
  return cluster > 1 ? In::kCluster
                     : iterates_global ? In::kGlobal : In::kShared;
}

// The launch configuration of ``grid`` (x a multiple of ``cluster``), as
// clusters of ``cluster`` blocks along x where that is more than 1.
struct LaunchConfig {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  LaunchConfig(dim3 grid, int cluster, size_t smem, cudaStream_t stream) {
    cfg.gridDim = grid;
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = cluster > 1 ? 1 : 0;
  }
};

}  // namespace

// Part 1's instances, for part 0 (a kernel's address as void*: the
// translation units share no type).
namespace tinympc {
void* k2_pick_rest(int tile, int rpt, int lanes, int in, int proj_u,
                   int proj_x)
#if TINYMPC_PART == 0
    ;
#else
{
  return reinterpret_cast<void*>(pick_rest(tile, rpt, lanes,
                                           static_cast<In>(in), proj_u != 0,
                                           proj_x != 0));
}
#endif
}  // namespace tinympc

#if TINYMPC_PART != 1
namespace {

void (*pick_kernel(int tile, int rpt, int lanes, In in, bool proj_u,
                   bool proj_x))(Params) {
  if (auto k = pick_shared32(tile, rpt, lanes, in, proj_u, proj_x)) return k;
  return reinterpret_cast<void (*)(Params)>(k2_pick_rest(
      tile, rpt, lanes, static_cast<int>(in), proj_u, proj_x));
}

}  // namespace

// Blocks of one SM for the instance of a launch (the occupancy API), or,
// for a cluster of ``cluster`` blocks, the clusters the whole card holds at
// once; a negative CUDA error.
extern "C" int tinympc_condensed_adaptive_occupancy(int tile, int rpt,
                                                    int lanes,
                                                    int iterates_global,
                                                    int cluster, int proj_u,
                                                    int proj_x,
                                                    int smem_bytes) {
  void (*kernel)(Params) =
      pick_kernel(tile, rpt, lanes, layout_of(iterates_global, cluster),
                  proj_u != 0, proj_x != 0);
  if (!kernel) return -static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  int n = 0;
  if (err == cudaSuccess && cluster > 1) {
    LaunchConfig lc(dim3(cluster * 64), cluster, smem_bytes, nullptr);
    err = cudaOccupancyMaxActiveClusters(&n, kernel, &lc.cfg);
  } else if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads,
                                                        smem_bytes);
  }
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

extern "C" int tinympc_condensed_adaptive(
    const float* t1t, const float* t2t, const void* t1a, const void* t2a,
    const float* rho0, const float* trust_lo, const float* trust_hi,
    const float* umin, const float* umax, const float* xmin,
    const float* xmax, const float* x0, const float* d_in, const float* y_in,
    const float* g_in, const float* v_in, const float* z_in,
    const float* rho_in, float* xout, float* uout, int* iters, int* solved,
    float* rho_out, float* y, float* g, float* d_out, float* vco, float* zco,
    const float* A, const float* Bm, const float* qd, const float* rd,
    const float* P0, const float* dP, float* wsc, float* dsc, float* vecg,
    float* uxg, void* w2hg, float* uxo, int nx, int nu, int N, int G, int L,
    int order, int max_iter, int ct, int lo_all, float alpha,
    float one_m_alpha, float pri_tol, float dua_tol, float rho_min,
    float rho_max, float rho0_one, float trust_lo_one, float trust_hi_one,
    int osqp, int clipping, int trust, int en_input_bound,
    int en_state_bound, int warm_start, int carry_out, int tile,
    int iterates_global, int cluster, const int* stages,
    const int* ustages, int rpt, int lanes,
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
  // (W = 512 rpt / tile, the product's rows at once; with lanes 4, pass
  // by pass, pass_rows of sw and 4 su at a thread's rows of each product
  // in passes of W and of the backward's W2);
  // t1a/t2a: the bf16 maps of reduced iterations (lo_all), k padded to
  // kp1/kp2.  lanes: a thread's of the fp32 products (2; 4 in the
  // bulk-ring layouts, tile 32 with rpt 20 or tile 16 with rpt 16; 8 on
  // a cluster).
  // lin_*: (n_lin, 2*dim + 1) device rows; soc_*: n_soc (start, dim) pairs
  // on the device; soc_mu_*: (n_soc,) on the device.  wsc: the (sw, B)
  // scratch of the new slacks (a projected side, where its stages live, or
  // the OSQP-form controller), dsc its new duals (the OSQP-form
  // controller);
  // iterates_global: vec1 and ux in vecg (in1, G x tiles x tile) and uxg
  // (sw + 1, the same), with reduced iterations rounded into w2hg
  // (G x tiles x tile, max(kp1, kp2)) bf16.  cluster: the blocks a tile
  // (1, or 2 to 8 with ``stages`` and ``ustages``, the host's cluster + 1
  // stage bounds, the maps' padded rows cluster x passes x W; uxo the (sw,
  // B) scratch of ux for the OSQP-form controller).
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
  p.wsc = wsc; p.dsc = dsc; p.vecg = vecg; p.uxg = uxg; p.uxo = uxo;
  p.w2hg = static_cast<__nv_bfloat16*>(w2hg);
  p.tiles = tile > 0 ? (L + tile - 1) / tile : 0;
  p.ldg = G * p.tiles * tile;
  p.nx = nx; p.nu = nu; p.N = N;
  p.su = (N - 1) * nu; p.sx = N * nx; p.sw = p.su + p.sx;
  p.in1 = p.su + nx + 1; p.B = G * L; p.L = L;
  p.ord1 = order + 1;
  const int W = tile > 0 ? rpt * (2 * kThreads / tile) : 0;
  p.passes1 = passes1; p.passes2 = passes2;
  p.ld1 = cluster * passes1 * W; p.ld2 = cluster * passes2 * W;
  int ringw = W;  // rows of a slot of the fp32 ring
  if (lanes == 4) {
    // the bulk-ring layouts, pass by pass: every pass but the last the
    // product's rows at once (W; the backward's W2 at its thread's rows,
    // K2Product: 2 rpt / 4, rounded up to whole outputs), the last's rows
    // padded only to a thread's, so that a slab is one contiguous copy
    // into a slot as wide as the widest pass, at least W
    const int rows = rpt / 2, rows2 = (rows + 3) / 4 * 4;
    const int W2 = W / rows * rows2;
    if (passes1 != (p.sw + W - 1) / W ||
        passes2 != (4 * p.su + W2 - 1) / W2 || cluster != 1 ||
        iterates_global || resident)
      return static_cast<int>(cudaErrorInvalidValue);
    p.ld1 = pass_rows(p.sw, rows, W);
    p.ld2 = pass_rows(4 * p.su, rows2, W2);
    if (p.ld1 - (passes1 - 1) * W > W || p.ld2 - (passes2 - 1) * W2 > W2)
      return static_cast<int>(cudaErrorInvalidValue);
    ringw = bulk_ring_rows(W, W2, passes2, p.ld2);
  }
  p.kp1 = kp1; p.kp2 = kp2;
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
  const bool wg = iterates_global != 0;
  const In in = layout_of(iterates_global, cluster);
  const int n_u = N - 1, n_st = n_u + N;
  p.cluster = cluster;
  p.rows1 = p.in1;
  p.rows2 = p.sw + 1;
  if (cluster < 1 || cluster > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  if (cluster > 1) {  // each block's stages, rows and slices of the maps
    if (!stages || !ustages || stages[0] != 0 || stages[cluster] != n_st ||
        ustages[0] != 0 || ustages[cluster] != n_u || wg || resident ||
        state_shared || tile != 32 || (osqp && !uxo))
      return static_cast<int>(cudaErrorInvalidValue);
    p.rows1 = p.rows2 = 0;
    for (int c = 0; c <= cluster; ++c) {
      p.stages[c] = stages[c];
      p.ustages[c] = ustages[c];
      if (c == 0) continue;
      const bool end = c == cluster;
      const int rows = stage_row(stages[c], nu, nx, n_u) -
                       stage_row(stages[c - 1], nu, nx, n_u);
      const int drows = (ustages[c] - ustages[c - 1]) * nu;
      if (stages[c] <= stages[c - 1] || ustages[c] <= ustages[c - 1] ||
          rows > passes1 * W || 4 * drows > passes2 * W)
        return static_cast<int>(cudaErrorInvalidValue);
      const int r1 = drows + (end ? nx + 1 : 0), r2 = rows + (end ? 1 : 0);
      p.rows1 = r1 > p.rows1 ? r1 : p.rows1;
      p.rows2 = r2 > p.rows2 ? r2 : p.rows2;
    }
  }
  const size_t need =
      k2_layout(tile, in, ringw, p.rows1, p.rows2, p.in1, p.sw, p.ord1,
                p.ld1, p.ld2, kp1, kp2,
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
  // the stage-wise OSQP residuals read every stage's new slack and dual
  // from the scratch
  if (osqp && (!A || !Bm || !qd || !rd || !P0 || !dP || !wsc || !dsc))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool proj_u = n_lin_u + n_soc_u > 0, proj_x = n_lin_x + n_soc_x > 0;
  if ((proj_u || proj_x) && !wsc)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((wg && (!vecg || !uxg || resident)) ||
      ((wg || cluster > 1) && lo_all && !w2hg))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!init_side(p.side_u, umin, umax, lin_u, n_lin_u, soc_u, soc_mu_u,
                 n_soc_u, nu, N - 1, en_input_bound, box_u_grouped,
                 lin_u_grouped, mu_u_grouped) ||
      !init_side(p.side_x, xmin, xmax, lin_x, n_lin_x, soc_x, soc_mu_x,
                 n_soc_x, nx, N, en_state_bound, box_x_grouped, lin_x_grouped,
                 mu_x_grouped))
    return static_cast<int>(cudaErrorInvalidValue);
  // the tiles' staged carry slacks, then the block's group's constraint
  // data, in shared memory after the layout, each where the launch left
  // room for it
  const size_t stage = carry_out && lanes == 4 && cluster == 1
                           ? carry_stage_bytes(p.sw, tile)
                           : 0;
  p.carry_stage =
      stage > 0 && static_cast<size_t>(smem_bytes) >= need + stage;
  const size_t cons = constraint_bytes(p.side_u, p.side_x);
  p.cons_shared =
      cons > 0 && static_cast<size_t>(smem_bytes) >=
                      need + (p.carry_stage ? stage : 0) + cons;

  void (*kernel)(Params) = pick_kernel(tile, rpt, lanes, in, proj_u,
                                       proj_x);
  if (!kernel) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(smem_bytes);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  LaunchConfig lc(dim3(p.tiles * cluster, G), cluster, smem,
                  static_cast<cudaStream_t>(stream));
  err = cudaLaunchKernelEx(&lc.cfg, kernel, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
#endif  // TINYMPC_PART != 1
