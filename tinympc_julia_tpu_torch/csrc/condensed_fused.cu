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
//    tile's product T12w @ w2 as a GEMM.  Each thread keeps a register tile
//    of RPT rows x 2 lanes (40 outputs at the quadrotor shape), so one k
//    step is RPT/4 16-byte and one 8-byte shared loads for 2 RPT FMAs.
//  * Each output is summed over k in index order by one thread with fmaf,
//    so a lane's fp32 result does not depend on its tile-mates or the tile
//    size (and equals the plain version's wherever cuBLAS sums in index
//    order).  No TF32: the fp32 product never touches the tensor cores.
//  * T12 (transposed, rows padded to 16 RPT) is resident in shared memory
//    where it fits beside the tile and otherwise streamed from L2 in slabs
//    of kSlabK k-rows through a ring of kStages slots filled by cp.async:
//    kStages - 1 slabs are in flight while the block multiplies one.  (A
//    two-slot ring times the same at the quadrotor shape: the slabs'
//    latency is not what bounds the streamed product; PERF.md section 6.)
//  * The tile's w2 lives in shared memory as [row][lane], a single buffer:
//    after a barrier the product overwrites it (latched lanes keep theirs),
//    and the elementwise step adds uxc and turns ux into the next w2 in
//    place.  A latched lane's carry is its state before its latching
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
//    the rows in four and the lanes in two groups of 16.  Each k16 step's 16 exact products are
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
// Launch contract: the Python wrapper (fused_tile_plan) picks the padded
// layouts (swp rows of the transposed map; kp columns of the bf16 map),
// whether the map and the state are resident and the dynamic shared-memory
// size; the entry point refuses a layout the kernel would overrun, and the
// constraint layout (counts, cone extents, stage widths) likewise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "projections.cuh"

namespace {

using namespace tinympc;

constexpr int kTile = 32;         // lanes a block
constexpr int kThreads = 256;     // threads a block
constexpr int kLaneThreads = kThreads / kTile;  // threads a lane: 8
constexpr int kRowGroups = 16;    // thread rows of the fp32 product
constexpr int kLaneGroups = kThreads / kRowGroups;  // thread lanes: 16
constexpr int kLpt = kTile / kLaneGroups;  // lanes a product thread: 2
constexpr int kSlabK = 8;         // fp32 map k-rows per slab
constexpr int kStages = 6;        // fp32 slabs in the ring
constexpr int kSlabKLo = 16;      // bf16 map k-columns per slab
constexpr int kStagesLo = 4;      // bf16 slabs in the ring
constexpr int kPadLo = 8;         // bf16 row padding (conflict-free ldmatrix)
constexpr int kRowBatch = 4;      // rows an elementwise pass loads at once

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
  int nx, su, sx, sw, swp, kp, B, L;  // B = G * L lanes, L in each group
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

__host__ __device__ inline size_t up16(size_t n) { return (n + 15) / 16 * 16; }

// Floats of one lane's solver state: uxc (sw), y and z (su each), v (sx)
// and, with a state constraint, g (sx).
__host__ __device__ inline int state_rows(int su, int sx, int sw,
                                          bool state_free) {
  return sw + 2 * su + (state_free ? 1 : 2) * sx;
}

// Byte offsets of the block's shared memory: the tile's w2 (sw x kTile
// floats), the latch flags (kTile + 1 ints), the residual partials of the
// lanes' threads (kThreads float4), the lanes' solver state where it is
// resident ([row][lane]), the map region (resident: the fp32 map, then the
// bf16 one with reduced iterations; streamed: the slab ring, fp32 or bf16
// slabs in turn), the bf16 w2 ([lane][k], reduced only).
struct TileLayout {
  size_t flags, red, state, map, maplo, w2h, total;
};

__host__ __device__ inline TileLayout tile_layout(int sw, int swp, int kp,
                                                  int state_floats,
                                                  bool resident,
                                                  bool reduced) {
  TileLayout t;
  size_t off = up16(sizeof(float) * static_cast<size_t>(sw) * kTile);
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
    size_t ring = sizeof(float) * kStages * static_cast<size_t>(kSlabK) * swp;
    const size_t lo =
        2 * kStagesLo * static_cast<size_t>(swp) * (kSlabKLo + kPadLo);
    if (reduced && lo > ring) ring = lo;
    off += up16(ring);
    t.maplo = t.map;
  }
  t.w2h = off;
  if (reduced) off += up16(2 * static_cast<size_t>(kTile) * (kp + kPadLo));
  t.total = off;
  return t;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4],
                                            const __nv_bfloat16* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(src));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

// d += a (16 x 16, row-major) * b (16 x 8, column-major), bf16 in, fp32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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
  float* buf;                  // (sw, kTile) w2, then ux, then the next w2
  const int* done;             // (kTile,) latched (or absent) lanes
  float* ring;                 // streamed slabs; null where resident
  const float* map;            // resident fp32 map (sw, swp), or the group's
                               // map in global memory when streamed
  const __nv_bfloat16* amap;   // resident bf16 map (swp, kp + kPadLo), or
                               // the group's (swp, kp) in global memory
  __nv_bfloat16* w2h;          // (kTile, kp + kPadLo) rounded w2
  float* state;                // resident solver state, or null
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
    t.buf[r * kTile + l] = p.warm_start ? p.w2_in[r * B + lane] : 0.0f;
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
  if (r < p.sw && l < t.nvalid && !t.done[l]) t.buf[r * kTile + l] = acc;
}

// The fp32 product: thread (tr, tl) owns rows tr*RPT .. +RPT-1 of lanes
// 2 tl, 2 tl + 1 and sums each over k in index order with fmaf.
template <int RPT>
__device__ __forceinline__ void tile_product_fp32(const Params& p,
                                                  const Tile& t) {
  const int sw = p.sw, swp = p.swp;
  const int tl = t.tid % kLaneGroups, tr = t.tid / kLaneGroups;
  const int r0 = tr * RPT;
  float acc[RPT][kLpt];
#pragma unroll
  for (int j = 0; j < RPT; ++j)
#pragma unroll
    for (int q = 0; q < kLpt; ++q) acc[j][q] = 0.0f;
  const float* wcol = t.buf + kLpt * tl;
  auto step = [&](const float* mrow, int k) {
    const float2 w = *reinterpret_cast<const float2*>(wcol + k * kTile);
#pragma unroll
    for (int j4 = 0; j4 < RPT / 4; ++j4) {
      const float4 m = *reinterpret_cast<const float4*>(mrow + r0 + 4 * j4);
      const float mv[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[4 * j4 + j][0] = fmaf(mv[j], w.x, acc[4 * j4 + j][0]);
        acc[4 * j4 + j][1] = fmaf(mv[j], w.y, acc[4 * j4 + j][1]);
      }
    }
  };
  if (!t.ring) {
    for (int k = 0; k < sw; ++k) step(t.map + k * swp, k);
  } else {
    // slab s: map rows [s*kSlabK, ...), contiguous in global memory, in
    // ring slot s % kStages; kStages - 1 slabs are in flight
    const int nslab = (sw + kSlabK - 1) / kSlabK;
    auto issue = [&](int s) {
      const int k0 = s * kSlabK;
      const int rows = min(kSlabK, sw - k0);
      float* dst = t.ring + (s % kStages) * kSlabK * swp;
      const float* src = t.map + static_cast<size_t>(k0) * swp;
      for (int e = t.tid; e < rows * swp / 4; e += kThreads)
        cp_async16(dst + 4 * e, src + 4 * e);
      cp_async_commit();  // always, so the group count stays in step
    };
    for (int s = 0; s < kStages - 1; ++s) issue(s);
    for (int s = 0; s < nslab; ++s) {
      cp_async_wait<kStages - 2>();  // slab s has landed
      __syncthreads();  // ... for every thread; slab s - 1 is consumed
      issue(s + kStages - 1);  // into slab s - 1's slot
      const float* slab = t.ring + (s % kStages) * kSlabK * swp;
      const int k0 = s * kSlabK, k1 = min(sw, k0 + kSlabK);
      for (int k = k0; k < k1; ++k) step(slab + (k - k0) * swp, k);
    }
  }
  __syncthreads();  // every thread is done reading w2
#pragma unroll
  for (int j = 0; j < RPT; ++j)
#pragma unroll
    for (int q = 0; q < kLpt; ++q)
      tile_store(p, t, r0 + j, kLpt * tl + q, acc[j][q]);
}

// The reduced product on the tensor cores: w2 rounded to bf16 into
// w2h[lane][k], then per warp (wm, wn) the rows wm*4*RPT .. +4*RPT-1 (RPT/4
// tiles of 16) of lanes wn*16 .. +15 (two tiles of 8), k in steps of 16.
template <int RPT>
__device__ __forceinline__ void tile_product_lo(const Params& p,
                                                const Tile& t) {
  constexpr int kMt = RPT / 4;  // 16-row tiles per warp
  const int sw = p.sw, kp = p.kp, swp = p.swp;
  const int ldw = kp + kPadLo;
  for (int e = t.tid; e < sw * kTile; e += kThreads) {
    const int k = e / kTile, n = e - k * kTile;
    t.w2h[n * ldw + k] = __float2bfloat16_rn(t.buf[e]);
  }
  const int warp = t.tid >> 5, ln = t.tid & 31;
  const int wm = warp & 3, wn = warp >> 2;
  float acc[kMt][2][4];
#pragma unroll
  for (int m = 0; m < kMt; ++m)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[m][j][q] = 0.0f;
  // this thread's ldmatrix rows: lanes (B) and map rows (A)
  const __nv_bfloat16* brow =
      t.w2h + (wn * 16 + (ln & 7) + ((ln >> 4) << 3)) * ldw +
      ((ln >> 3) & 1) * 8;
  const int arow = wm * kMt * 16 + (ln & 15), acol = (ln >> 4) * 8;
  // k16 steps over a block of columns of A (row stride lda) whose column 0
  // is column kb of the map
  auto ksteps = [&](const __nv_bfloat16* a, int lda, int kb, int n16) {
    for (int kk = 0; kk < n16; ++kk) {
      unsigned b[4];
      ldmatrix_x4(b, brow + kb + kk * 16);
#pragma unroll
      for (int m = 0; m < kMt; ++m) {
        unsigned af[4];
        ldmatrix_x4(af, a + (arow + m * 16) * lda + kk * 16 + acol);
        // each k16 step's 16 products summed from zero in the tensor core,
        // then added to the running sum in IEEE fp32: the tensor core's own
        // accumulation is not round-to-nearest
        float c0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, c1[4] = {0.0f, 0.0f, 0.0f,
                                                         0.0f};
        mma_bf16(c0, af, b[0], b[1]);
        mma_bf16(c1, af, b[2], b[3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[m][0][e] = __fadd_rn(acc[m][0][e], c0[e]);
          acc[m][1][e] = __fadd_rn(acc[m][1][e], c1[e]);
        }
      }
    }
  };
  if (!t.ring) {
    __syncthreads();  // w2h staged
    ksteps(t.amap, ldw, 0, kp / 16);
  } else {
    // slab s: map columns [s*kSlabKLo, ...) of every row, in ring slot
    // s % kStagesLo; kStagesLo - 1 slabs are in flight
    const int nslab = kp / kSlabKLo;
    constexpr int lds = kSlabKLo + kPadLo;
    auto issue = [&](int s) {
      if (s < nslab) {
        __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(t.ring) +
                             (s % kStagesLo) * swp * lds;
        for (int e = t.tid; e < swp * (kSlabKLo / 8); e += kThreads) {
          const int r = e / (kSlabKLo / 8), j = e % (kSlabKLo / 8);
          cp_async16(dst + r * lds + 8 * j,
                     t.amap + static_cast<size_t>(r) * kp + s * kSlabKLo +
                         8 * j);
        }
      }
      cp_async_commit();
    };
    for (int s = 0; s < kStagesLo - 1; ++s) issue(s);
    for (int s = 0; s < nslab; ++s) {
      cp_async_wait<kStagesLo - 2>();  // slab s has landed
      __syncthreads();  // ... for every thread (and on s = 0 w2h is staged);
                        // slab s - 1 is consumed
      issue(s + kStagesLo - 1);
      ksteps(reinterpret_cast<const __nv_bfloat16*>(t.ring) +
                 (s % kStagesLo) * swp * lds,
             lds, s * kSlabKLo, kSlabKLo / 16);
    }
  }
  __syncthreads();  // every thread is done reading w2
  const int gq = ln >> 2, tq = ln & 3;
#pragma unroll
  for (int m = 0; m < kMt; ++m) {
    const int r = (wm * kMt + m) * 16 + gq;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int l = wn * 16 + j * 8 + 2 * tq;
      tile_store(p, t, r, l, acc[m][j][0]);
      tile_store(p, t, r, l + 1, acc[m][j][1]);
      tile_store(p, t, r + 8, l, acc[m][j][2]);
      tile_store(p, t, r + 8, l + 1, acc[m][j][3]);
    }
  }
}

// The elementwise part: the kLaneThreads threads of a lane split each side,
// the rows of a box-only side (thread q takes rows q, q + 8, ...) or the
// stages of a projected one (stages q, q + 8, ...: the projections couple
// only the rows of a stage).  A box pass loads kRowBatch rows' slack, dual,
// bounds and rollout constant before it computes and stores.  The product
// left T12w @ w2 in the tile's buffer; the first pass of an iteration adds
// the rollout constant uxc there (add: every iteration but the cold
// rollout, whose buffer holds the rollout itself).  The arithmetic is
// projections.cuh's (relaxed, the box clip, stage_slack, the dual step) in
// the same order, so the results are those of a lane's step run by one
// thread.
struct BoxRows {
  float prev[kRowBatch], dual[kRowBatch], lo[kRowBatch], hi[kRowBatch],
      uxc[kRowBatch];
};

// One side of a lane: its slack, dual and rollout constant (element r at
// [r * stride]), its column of the tile buffer and its carry slack (global,
// element r at [r * B]).
struct SidePass {
  const Side* s;
  float* ux;
  float* prev;        // slack / output
  float* dual;        // null: the state-free path
  const float* uxc;
  float* co;          // carry slack
  int stride;
};

// What stage_slack (projections.cuh) reads of the kernel's parameters,
// with the state's row stride in place of the batch size.
struct StageParams {
  float alpha, one_m_alpha;
  int B;
};

__device__ __forceinline__ void load_box_rows(const SidePass& sp, int g,
                                              int r0, int rows, bool add,
                                              BoxRows& b) {
  const Side& s = *sp.s;
#pragma unroll
  for (int j = 0; j < kRowBatch; ++j) {
    const int r = r0 + kLaneThreads * j;
    if (r < rows) {
      const int o = r * sp.stride;
      b.prev[j] = sp.prev[o];
      b.dual[j] = sp.dual ? sp.dual[o] : 0.0f;
      b.uxc[j] = add ? sp.uxc[o] : 0.0f;
      if (s.en_box) {
        b.lo[j] = __ldg(s.wmin + g * s.box_stride + r);
        b.hi[j] = __ldg(s.wmax + g * s.box_stride + r);
      }
    }
  }
}

// row_slack of projections.cuh on loaded values
__device__ __forceinline__ float box_slack(const Side& s, float wh,
                                          bool has_dual, float dual, float lo,
                                          float hi) {
  float v = has_dual ? __fadd_rn(wh, dual) : wh;
  if (s.en_box) v = fminf(hi, fmaxf(lo, v));
  return v;
}

// Adds uxc to the rows of stage k of a projected side, then its slack.
__device__ __forceinline__ void projected_stage(const Params& p,
                                                const SidePass& sp, int g,
                                                int k, bool relax, bool add,
                                                float* w) {
  const Side& s = *sp.s;
  if (add)
    for (int j = 0; j < s.dim; ++j) {
      const int r = k * s.dim + j;
      sp.ux[r * kTile] = __fadd_rn(sp.ux[r * kTile], sp.uxc[r * sp.stride]);
    }
  const StageParams sp_p{p.alpha, p.one_m_alpha, sp.stride};
  stage_slack(sp_p, s, g, k, relax, sp.ux, sp.prev, sp.dual, 0, kTile, w);
}

// The residual pass (the first pass of a checking iteration: it completes
// ux in the buffer).
template <bool kProj>
__device__ __forceinline__ void side_residuals_q(const Params& p,
                                                 const SidePass& sp, int g,
                                                 bool relax, int q, bool add,
                                                 float& pri, float& dua) {
  const Side& s = *sp.s;
  float* ux = sp.ux;
  if constexpr (kProj) {
    for (int k = q; k < s.n_stages; k += kLaneThreads) {
      float w[kMaxStage];
      projected_stage(p, sp, g, k, relax, add, w);
      for (int j = 0; j < s.dim; ++j) {
        const int r = k * s.dim + j;
        pri = fmaxf(pri, fabsf(__fsub_rn(ux[r * kTile], w[j])));
        dua = fmaxf(dua, fabsf(__fsub_rn(sp.prev[r * sp.stride], w[j])));
      }
    }
  } else {
    const int rows = s.dim * s.n_stages;
    for (int r0 = q; r0 < rows; r0 += kLaneThreads * kRowBatch) {
      BoxRows b;
      load_box_rows(sp, g, r0, rows, add, b);
#pragma unroll
      for (int j = 0; j < kRowBatch; ++j) {
        const int r = r0 + kLaneThreads * j;
        if (r < rows) {
          float u = ux[r * kTile];
          if (add) {
            u = __fadd_rn(u, b.uxc[j]);
            ux[r * kTile] = u;
          }
          const float vn = box_slack(s, relaxed(p, relax, u, b.prev[j]),
                                     sp.dual != nullptr, b.dual[j], b.lo[j],
                                     b.hi[j]);
          pri = fmaxf(pri, fabsf(__fsub_rn(u, vn)));
          dua = fmaxf(dua, fabsf(__fsub_rn(b.prev[j], vn)));
        }
      }
    }
  }
}

// The update pass: the new slack, the dual ascent, and the next w2 entry
// (slack - dual) into the buffer.  The carry's slack freezes before the
// converging iteration: a lane that latches now (latch) writes the slack it
// had; the other lanes' carry is written once, at the end.
template <bool kProj>
__device__ __forceinline__ void side_update_q(const Params& p,
                                              const SidePass& sp, int g,
                                              bool relax, int q, bool add,
                                              bool latch) {
  const Side& s = *sp.s;
  float* ux = sp.ux;
  auto row = [&](int r, float u, float prev, float dual, float vn) {
    const int o = r * sp.stride;
    const float wh = relaxed(p, relax, u, prev);
    float next = vn;  // state-free: g == 0, the entry is vnew
    if (sp.dual) {
      const float dn = __fsub_rn(__fadd_rn(dual, wh), vn);
      sp.dual[o] = dn;
      next = __fsub_rn(vn, dn);
    }
    sp.prev[o] = vn;
    if (latch) sp.co[r * p.B] = prev;
    ux[r * kTile] = next;
  };
  if constexpr (kProj) {
    for (int k = q; k < s.n_stages; k += kLaneThreads) {
      float w[kMaxStage];
      projected_stage(p, sp, g, k, relax, add, w);
      for (int j = 0; j < s.dim; ++j) {
        const int r = k * s.dim + j, o = r * sp.stride;
        row(r, ux[r * kTile], sp.prev[o], sp.dual ? sp.dual[o] : 0.0f, w[j]);
      }
    }
  } else {
    const int rows = s.dim * s.n_stages;
    for (int r0 = q; r0 < rows; r0 += kLaneThreads * kRowBatch) {
      BoxRows b;
      load_box_rows(sp, g, r0, rows, add, b);
#pragma unroll
      for (int j = 0; j < kRowBatch; ++j) {
        const int r = r0 + kLaneThreads * j;
        if (r < rows) {
          float u = ux[r * kTile];
          if (add) u = __fadd_rn(u, b.uxc[j]);
          const float vn = box_slack(s, relaxed(p, relax, u, b.prev[j]),
                                     sp.dual != nullptr, b.dual[j], b.lo[j],
                                     b.hi[j]);
          row(r, u, b.prev[j], b.dual[j], vn);
        }
      }
    }
  }
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
  const SidePass su{&p.side_u, t.buf + l, st.z, st.y, st.uxc,
                    p.zco + lane, st.stride};
  const SidePass sx{&p.side_x, t.buf + l + p.su * kTile, st.v, st.g,
                    st.uxc + p.su * st.stride, p.vco + lane, st.stride};
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

template <int RPT, bool kProjU, bool kProjX>
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
      sw, swp, kp,
      p.state_shared ? state_rows(p.su, p.sx, sw, p.state_free) : 0,
      p.t12_resident, reduced);

  Tile t;
  t.tid = tid;
  t.lane0 = g * p.L + l0;
  t.nvalid = min(kTile, p.L - l0);
  t.buf = reinterpret_cast<float*>(sm);
  int* done = reinterpret_cast<int*>(sm + lay.flags);
  int* n_done = done + kTile;
  t.done = done;
  float4* red = reinterpret_cast<float4*>(sm + lay.red);
  t.state = p.state_shared ? reinterpret_cast<float*>(sm + lay.state)
                           : nullptr;
  t.w2h = reduced ? reinterpret_cast<__nv_bfloat16*>(sm + lay.w2h) : nullptr;

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
  if (reduced)  // the k padding of the rounded w2 meets zeros of the map
    for (int e = tid; e < kTile * (kp - sw); e += kThreads) {
      const int n = e / (kp - sw), k = sw + e % (kp - sw);
      t.w2h[n * (kp + kPadLo) + k] = __float2bfloat16_rn(0.0f);
    }
  {
    const int l = tid % kTile, q = tid / kTile;
    if (q == 0) done[l] = l < t.nvalid ? 0 : 1;
    if (l < t.nvalid)
      lane_init(p, t, l, q, p.tx0 + gm * sw * p.nx, p.t1c + gm * sw, t12c);
    else
      for (int r = q; r < sw; r += kLaneThreads) t.buf[r * kTile + l] = 0.0f;
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
          t.buf[r * kTile + l] = c;
          st.uxc[r * st.stride] = __fadd_rn(c, t12c[r]);
        }
      }
    } else {
      if (check && p.carry_out)  // a lane that latches now keeps this w2
        for (int e = tid; e < sw * kTile; e += kThreads) {
          const int r = e / kTile, l = e - r * kTile;
          if (!done[l]) p.w2_out[r * p.B + t.lane0 + l] = t.buf[e];
        }
      if (is_reduced(p, i, check))
        tile_product_lo<RPT>(p, t);
      else
        tile_product_fp32<RPT>(p, t);
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
      if (carry) p.w2_out[r * B + lane] = t.buf[r * kTile + l];
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

// The kernel for RPT rows a thread, with the projections the sides need.
template <int RPT>
void (*tile_kernel(bool proj_u, bool proj_x))(Params) {
  return proj_u ? (proj_x ? condensed_fused_kernel<RPT, true, true>
                          : condensed_fused_kernel<RPT, true, false>)
                : (proj_x ? condensed_fused_kernel<RPT, false, true>
                          : condensed_fused_kernel<RPT, false, false>);
}

}  // namespace

extern "C" int tinympc_condensed_fused(
    const float* t12t, const void* t12a, const float* t12c,
    const float* tx0, const float* t1c, const float* rho, const float* umin,
    const float* umax, const float* xmin, const float* xmax, const float* x0,
    const float* w2_in, const float* y_in, const float* g_in,
    const float* v_in, const float* z_in, float* xout, float* uout,
    int* iters, int* solved, float* y, float* g, float* uxc, float* w2_out,
    float* vco, float* zco, int nx, int nu, int N, int G, int L, int max_iter,
    int ct, int k0, int lo_all, float alpha, float one_m_alpha, float pri_tol,
    float dua_tol, int en_input_bound, int en_state_bound, int warm_start,
    int carry_out, int state_shared, int t12_resident, int swp, int kp,
    int smem_bytes, int map_grouped, int rho_grouped, int box_u_grouped,
    int box_x_grouped, const float* lin_u, int n_lin_u, const int* soc_u,
    const float* soc_mu_u, int n_soc_u, int lin_u_grouped, int mu_u_grouped,
    const float* lin_x, int n_lin_x, const int* soc_x, const float* soc_mu_x,
    int n_soc_x, int lin_x_grouped, int mu_x_grouped, void* stream) {
  // G groups of L lanes; the *_grouped flags say which arrays carry a
  // leading group axis.  lin_*: (n_lin, 2*dim + 1) device rows; soc_*: n_soc
  // (start, dim) pairs in host memory; soc_mu_*: (n_soc,) on the device.
  // t12a: the (swp, kp) bf16 map of reduced iterations; swp = 16 x the rows
  // a thread (8, 20 or 32: the instances), kp a multiple of kSlabKLo;
  // state_shared: the lanes' solver
  // state lives in shared memory (else in the (dim, B) arrays, uxc
  // included).
  Params p;
  const bool reduced = k0 > 0 || lo_all;
  p.t12t = t12t; p.t12c = t12c; p.tx0 = tx0; p.t1c = t1c;
  p.t12a = reduced ? static_cast<const __nv_bfloat16*>(t12a) : nullptr;
  p.rho = rho; p.x0 = x0;
  p.w2_in = w2_in; p.y_in = y_in; p.g_in = g_in; p.v_in = v_in; p.z_in = z_in;
  p.xout = xout; p.uout = uout; p.iters = iters; p.solved = solved;
  p.y = y; p.g = g; p.uxc = uxc; p.w2_out = w2_out; p.vco = vco; p.zco = zco;
  p.nx = nx; p.su = (N - 1) * nu; p.sx = N * nx; p.sw = p.su + p.sx;
  p.swp = swp; p.kp = kp; p.B = G * L; p.L = L;
  p.max_iter = max_iter; p.ct = ct; p.k0 = k0; p.lo_all = lo_all;
  p.alpha = alpha; p.one_m_alpha = one_m_alpha;
  p.pri_tol = pri_tol; p.dua_tol = dua_tol;
  p.warm_start = warm_start; p.carry_out = carry_out;
  p.t12_resident = t12_resident; p.state_shared = state_shared;
  p.map_grouped = map_grouped; p.rho_grouped = rho_grouped;
  // no state-side constraint at all: g == 0 and vnew = x_hat
  p.state_free = !en_state_bound && n_lin_x == 0 && n_soc_x == 0;
  // the caller owns the layout; refuse one the kernel would overrun
  const int rpt = swp / kRowGroups;
  const size_t need =
      tile_layout(p.sw, swp, kp,
                  state_shared ? state_rows(p.su, p.sx, p.sw, p.state_free)
                               : 0,
                  t12_resident, reduced)
          .total;
  if (G <= 0 || L <= 0 || G > 65535 || ct < 1 || k0 < 0 || k0 > max_iter ||
      swp < p.sw || swp != kRowGroups * rpt ||
      kp % kSlabKLo != 0 || kp < p.sw || smem_bytes < 0 ||
      static_cast<size_t>(smem_bytes) < need || !rho || (reduced && !t12a))
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
  switch (rpt) {  // the instances fused_tile_plan picks from
    case 8: kernel = tile_kernel<8>(proj_u, proj_x); break;
    case 20: kernel = tile_kernel<20>(proj_u, proj_x); break;
    case 32: kernel = tile_kernel<32>(proj_u, proj_x); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(smem_bytes);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L + kTile - 1) / kTile, G);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
