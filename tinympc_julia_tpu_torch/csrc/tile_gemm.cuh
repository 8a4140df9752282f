// The lane-tile layout shared by the condensed kernels K1
// (condensed_fused.cu) and K2 (condensed_adaptive.cu): a block of 256
// threads owns a tile of T lanes (32; 16 where the iterates of 32 lanes
// would not fit beside a wide map), runs the tile's matrix products
// as GEMMs and the elementwise step of an ADMM iteration with 256 / T
// threads a lane.  The tile is a template parameter (Lanes<T>), 32 by
// default.
//
// The products.  out(row, lane) = sum_k M(k, row) w(k, lane) over the
// tile, w in shared memory as [k][lane] (row stride T), M a transposed map
// ([k][row], row stride ld) in fp32 or a row-major bf16 map ([row][k]).
//  * fp32 (gemm_fp32): each thread keeps a register tile of RPT rows x LPT
//    lanes and sums every output over k in index order with fmaf, so a
//    lane's result does not depend on its tile-mates (and equals a
//    product that sums in index order: cuBLAS's at these shapes).  No
//    TF32.  The T / LPT lane groups x 256 LPT / T row groups cover W = 256
//    LPT RPT / T rows at once.  LPT = 2 (the shared-memory layouts): a
//    thread's k step loads RPT / 4 16-byte map chunks that 16 threads of
//    its warp share and 8 bytes of w for 2 RPT FMAs.  LPT = 8 (the cluster
//    layout, RPT 8): 32 bytes of map and 32 of w for 64 FMAs, so a k step
//    of the block asks the shared-memory pipe for about half the
//    wavefronts per FMA (each 16-byte load of a warp costs 4 whatever it
//    shares).
//  * bf16 (gemm_lo): the input is rounded to bf16 (round to nearest even)
//    into a [lane][k] buffer and mma.sync.m16n8k16 multiplies it by a
//    real-bf16 map, warps split over rows (128 / T of them) and lanes
//    (groups of 16); each k16 step's products are summed from zero in the
//    tensor core and added to an fp32 running sum (mma_product of
//    ops/cuda/condensed_kernel.py is the same arithmetic).  The same W rows
//    at once.
//  * A map wider than W rows, or several maps in turn (K2's Taylor
//    blocks), is a sequence of segments of W rows; after each segment the
//    caller's epilogue takes the thread's register tile (Frag says which
//    row and lane each entry is).
//  * The map is resident in shared memory, or streamed from L2 in slabs
//    through a ring filled by cp.async (kStages - 1 slabs in flight), the
//    segments one after another in one stream.
//  * Where a tile's iterates do not fit in one block's shared memory (the
//    wide maps), a thread block cluster of C blocks (2 to 8, on C SMs)
//    shares the tile (In::kCluster): block c owns a slice of the product's
//    output rows and the k-rows of w it computes itself, in its own shared
//    memory; the k-rows of every block reach each ring slot beside the
//    map's slab over distributed shared memory (a peer's shared memory
//    loaded through its shared::cluster address), fetched before the block
//    multiplies the slab in hand and stored after it, so the loads' latency
//    hides behind the FMAs.  The bf16 product rounds each block's own rows
//    once into the tile's [lane][k] rows of a global bf16 array, and every
//    block streams those as In::kGlobal does.
//    Where even a cluster's slices do not fit, w lives in global memory as
//    the tile's own columns of a [k][lane] array (In::kGlobal) and its
//    k-rows stream through the same ring slots; the bf16 product then
//    rounds w once into the tile's [lane][k] rows of a global bf16 array.
//    The sums keep their order in every layout, so the results do not
//    change.  A segment's map rows past its valid ones (``vrows``: a
//    slice's padding) are neither copied nor multiplied.
//
// The elementwise step: the threads of a lane split each side of it, the
// rows of a box-only side (thread q of its 256 / T takes rows q, q + 256 /
// T, ...) or the stages of a projected one (the projections couple only the
// rows of a stage), a projected side's stages and the rows of a box side
// beside it dealt so that the threads' work comes out even.  A projected
// stage is projected once an iteration in memory (a stage buffer of the
// thread's own in shared memory, or where that leaves no room the lane's
// rows of a global scratch), its rows' loads in flight a batch at a time
// before the arithmetic; one pass then takes the residuals and writes the
// updates.  The arithmetic is projections.cuh's, in the plain version's
// order of operations.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "projections.cuh"
#include "ptx.cuh"
#include "sections.cuh"

namespace tinympc {

constexpr int kThreads = 256;  // threads a block
constexpr int kTile = 32;      // lanes a block, unless a kernel asks for 16
constexpr int kSlabK = 8;      // fp32 map k-rows per slab
constexpr int kStages = 6;     // fp32 slabs in the ring
constexpr int kSlabKLo = 16;   // bf16 map k-columns per slab
constexpr int kStagesLo = 4;   // bf16 slabs in the ring
constexpr int kPadLo = 8;      // bf16 row padding (conflict-free ldmatrix)
constexpr int kRowBatch = 4;   // rows an elementwise pass loads at once
constexpr int kMaxCluster = 8; // blocks a cluster (the portable maximum)
// the cluster layout's fp32 ring: half the slabs, each twice as deep (the
// same bytes as kStages x kSlabK), so a block waits at half the barriers
constexpr int kSlabKWide = 2 * kSlabK;
constexpr int kStagesWide = kStages / 2;

__host__ __device__ inline size_t up16(size_t n) { return (n + 15) / 16 * 16; }

// The thread layout of a tile of T lanes.
template <int T>
struct Lanes {
  static_assert(T == 32 || T == 16, "tiles of 32 or 16 lanes");
  static constexpr int kLaneThreads = kThreads / T;  // threads a lane
  static constexpr int kLaneGroups = T / 2;          // product lanes: 2 each
  static constexpr int kRowGroups = kThreads / kLaneGroups;  // product rows
  static constexpr int kRowWarps = 128 / T;  // warps over a bf16 product's rows
};

// Where a product's input w lives: in the block's shared memory (all its
// k-rows), in global memory streamed beside the map, or split over a
// cluster's blocks.
enum class In { kShared, kGlobal, kCluster };

// A cluster's product input: block c owns k-rows [kb[c], kb[c + 1]) of w,
// [k][lane] with row stride T from its buffer's start (shared::cluster
// address base[c]).  Lives in each block's shared memory, beside the
// mbarriers on which the bulk copies of the map's slabs complete (one a
// ring slot) and the count of slabs the block has streamed through them
// (a slab's slot and its barrier's phase follow from it).
struct ClusterIn {
  unsigned long long full[kStages];
  unsigned base[kMaxCluster];
  int kb[kMaxCluster + 1];
  int C, rank, slabs;

  // the block that owns k-row k (k < kb[C]; the same in every thread of a
  // warp where the warp fetches one k-row)
  __device__ __forceinline__ int owner(int k) const {
    int c = 0;
    while (c + 1 < C && k >= kb[c + 1]) ++c;
    return c;
  }
};

static_assert(sizeof(ClusterIn) <= 256, "a ClusterIn fits its 256 bytes");

// The slab ring's barriers of a product that streams its map by the bulk
// copy engine with no block barrier a slab (gemm_fp32's kMbar, the
// continuation layouts): slot i fills on full[i] (one arrival and the
// copies' bytes) and frees on empty[i] (one arrival a warp once it is done
// with the slab); slabs counts the slabs the block has streamed through
// the ring (a slab's slot and its barriers' phases follow from it).  In the
// static shared memory of the kernels that use it.  The cluster products
// (kBulk) keep their own barriers in ClusterIn: a slot there also holds
// the tile's k-rows of w, which every thread stores from its peer loads,
// so a slab still ends at a block barrier and needs no empty barrier; the
// rows of a block's slice of the map are ld > W apart, one copy a k-row;
// and ClusterIn lives in the dynamic shared memory the cluster plans are
// sized in (cluster_smem), which a RingBars beside it would shrink.
struct RingBars {
  unsigned long long full[kStages], empty[kStages];
  int slabs;
};
static __shared__ RingBars ring_bars;  // each translation unit's own

// Thread 0 of a kernel whose products take kMbar, before a block barrier
// that precedes its first product.
__device__ __forceinline__ void ring_bars_init() {
  for (int i = 0; i < kStages; ++i) {
    mbar_init(&ring_bars.full[i]);
    mbar_init(&ring_bars.empty[i], kThreads / 32);
  }
  ring_bars.slabs = 0;
  mbar_fence_init();
}

// Bytes a cluster block keeps beside its slices: the lanes' residual maxima
// that the cluster combines (up to 3 float4 a lane of a tile of 32) and a
// ClusterIn for each product input.
constexpr size_t kClusterMeta = 3 * 16 * 32 + 2 * 256;

// Bytes of the slab ring of a streamed product of width W (fp32 slabs, or
// bf16 slabs where ``lo``), with the k-rows of wt lanes of w beside each
// slab where w streams too (kGlobal, kCluster).
__host__ __device__ inline size_t ring_bytes(int W, bool lo, int wt = 0) {
  return lo ? 2 * kStagesLo * static_cast<size_t>(W + wt) *
                  (kSlabKLo + kPadLo)
            : sizeof(float) * kStages * static_cast<size_t>(kSlabK) *
                  (W + wt);
}

// The padded rows of a map that the bulk copy engine streams in one pass
// (``v`` valid rows, ``rows`` a thread): a multiple of the thread's rows,
// so that its last rows are read inside the slab's row, and of 4 (16-byte
// rows).
__host__ __device__ inline int bulk_rows(int v, int rows) {
  return ((v + rows - 1) / rows * rows + 3) / 4 * 4;
}

// The padded rows of a map of ``v`` valid rows that the bulk copy engine
// streams in passes of W rows, laid out pass by pass: every pass but the
// last W rows, the last its valid rows padded (bulk_rows).
__host__ __device__ inline int pass_rows(int v, int rows, int W) {
  const int full = (v + W - 1) / W * W - W;
  return full + bulk_rows(v - full, rows);
}

// Which output each register of an fp32 product thread holds: entry e of
// its LPT RPT is row tr * RPT + e / LPT of the segment, lane LPT tl + e %
// LPT.
template <int RPT, int LPT = 2>
struct FragF32 {
  static constexpr bool kLo = false;
  static constexpr int kLanes = LPT;
  static constexpr int kN = RPT * LPT;
  int tr, tl;
  __device__ __forceinline__ int row(int e) const {
    return tr * RPT + e / LPT;
  }
  __device__ __forceinline__ int lane(int e) const {
    return LPT * tl + e % LPT;
  }
};

// ... and of a bf16 product thread (mma.sync's m16n8 accumulator layout):
// entry e = (m * 2 + jn) * 4 + ee of 16-row tile m and 8-lane tile jn of
// warp (wm, wn).
template <int RPT>
struct FragLo {
  static constexpr bool kLo = true;
  static constexpr int kMt = RPT / 4;  // 16-row tiles a warp
  static constexpr int kN = 8 * kMt;
  int wm, wn, gq, tq;
  __device__ __forceinline__ int row(int e) const {
    return (wm * kMt + e / 8) * 16 + gq + 8 * ((e & 3) >> 1);
  }
  __device__ __forceinline__ int lane(int e) const {
    return wn * 16 + ((e >> 2) & 1) * 8 + 2 * tq + (e & 1);
  }
};

struct GemmF32 {
  const float* w;  // [k][lane], row stride T (shared memory); kGlobal: the
                   // tile's first column of a global array, row stride ldw;
                   // kCluster: unused (ci says where each k-row lives)
  float* ring;     // the slab ring where the segments are streamed; null:
                   // seg(j) points into shared memory
  int K, W, ld, nseg, tid;  // W: the rows the threads cover at once
  int ldw = 0;
  ClusterIn* ci = nullptr;  // kCluster
  // segment j's valid rows: min(W, vrows - (j / vper) W); 0: all W
  int vrows = 0, vper = 1;
};

// The valid rows of segment j of a product (GemmF32 / GemmLo's vrows).
template <class A>
__device__ __forceinline__ int seg_rows(const A& a, int j) {
  return a.vrows ? min(a.W, a.vrows - (j / a.vper) * a.W) : a.W;
}

// seg(j): segment j's map, [k][row] with row stride ld (W rows of it);
// with kMbar, the map laid out pass by pass (a pass: the vper segments j /
// vper), segment j's rows W apart where a later pass follows it and ld
// apart in the last pass (its rows padded only to a thread's), so that
// every slab is one contiguous copy; epi(j, acc, frag)
// after segment j, on every thread.  Every thread must be past its last
// use of the ring and of w (with kGlobal, w's stores behind a barrier;
// with kCluster, every block's behind a cluster barrier) before the call.
template <int RPT, int T = kTile, In kIn = In::kShared, int LPT = 2,
          int kSK = kSlabK, int kST = kStages, bool kBulk = false,
          bool kMbar = false, class Seg, class Epi>
__device__ __forceinline__ void gemm_fp32(const GemmF32& a, Seg seg,
                                          Epi epi) {
  static_assert(RPT % 2 == 0, "rows a thread: even");
  static_assert(LPT == 2 || LPT == 4 || LPT == 8, "lanes a thread: 2, 4, 8");
  constexpr bool kStream = kIn != In::kShared;  // w's rows in the ring slots
  constexpr int kLaneGroups = T / LPT;
  const FragF32<RPT, LPT> fr{a.tid / kLaneGroups, a.tid % kLaneGroups};
  const int r0 = fr.tr * RPT;
  float acc[LPT * RPT];
  auto zero = [&] {
#pragma unroll
    for (int e = 0; e < LPT * RPT; ++e) acc[e] = 0.0f;
  };
  // mrow: the map's k-row; wrow: w's (T lanes)
  auto step = [&](const float* mrow, const float* wrow) {
    float w[LPT];
    if constexpr (LPT == 2) {
      const float2 v = *reinterpret_cast<const float2*>(wrow + 2 * fr.tl);
      w[0] = v.x;
      w[1] = v.y;
    } else {
#pragma unroll
      for (int q4 = 0; q4 < LPT / 4; ++q4) {
        const float4 v =
            *reinterpret_cast<const float4*>(wrow + LPT * fr.tl + 4 * q4);
        w[4 * q4] = v.x;
        w[4 * q4 + 1] = v.y;
        w[4 * q4 + 2] = v.z;
        w[4 * q4 + 3] = v.w;
      }
    }
    // the map's rows, 16 bytes a load (8 where RPT is not a multiple of 4)
    constexpr int kV = RPT % 4 == 0 ? 4 : 2;
#pragma unroll
    for (int jv = 0; jv < RPT / kV; ++jv) {
      float mv[kV];
      if constexpr (kV == 4) {
        const float4 m =
            *reinterpret_cast<const float4*>(mrow + r0 + 4 * jv);
        mv[0] = m.x;
        mv[1] = m.y;
        mv[2] = m.z;
        mv[3] = m.w;
      } else {
        const float2 m =
            *reinterpret_cast<const float2*>(mrow + r0 + 2 * jv);
        mv[0] = m.x;
        mv[1] = m.y;
      }
#pragma unroll
      for (int j = 0; j < kV; ++j)
#pragma unroll
        for (int q = 0; q < LPT; ++q)
          acc[LPT * (kV * jv + j) + q] =
              fmaf(mv[j], w[q], acc[LPT * (kV * jv + j) + q]);
    }
  };
  zero();
  if (!a.ring) {
    for (int j = 0; j < a.nseg; ++j) {
      const float* m = seg(j);
      for (int k = 0; k < a.K; ++k) step(m + k * a.ld, a.w + k * T);
      TINYMPC_SEC(kSecProduct);
      epi(j, acc, fr);
      TINYMPC_SEC(kSecEpilogue);
      zero();
    }
    return;
  }
  // slab s: k-rows [(s % nslab) * kSK, ...) of segment s / nslab, in ring
  // slot (s0 + s) % kST.  kBulk (kCluster only): the map's rows of a slab
  // arrive by the bulk copy engine, one copy a k-row issued by thread 0, on
  // the slot's mbarrier (phase (s0 + s) / kST; s0 the block's slabs before
  // this product); kMbar (kShared only): the slab's k-rows of the map, its
  // segment's stride apart (at most W), as one copy into a slot of rows as
  // far apart, issued by
  // thread 0 once every warp has arrived on the slot's empty barrier, the
  // warps waiting on nothing but their slab's full barrier (no block
  // barrier a slab); otherwise by cp.async, 16 bytes a thread at a time
  static_assert(!kBulk || kIn == In::kCluster, "bulk copies: a cluster's");
  static_assert(!kMbar || (kIn == In::kShared && kST <= kStages),
                "the barrier ring: a shared-memory product's");
  const int nslab = (a.K + kSK - 1) / kSK, total = nslab * a.nseg;
  int s0 = 0;
  if constexpr (kBulk || kMbar) {
    int* count;
    if constexpr (kBulk)
      count = &a.ci->slabs;
    else
      count = &ring_bars.slabs;
    s0 = *count;
    __syncthreads();  // every thread has read the count
    if (a.tid == 0) *count = s0 + total;
  }
  const int per = a.W / 4;  // 16-byte chunks of a slab row
  // segment j's row stride in the map and in its slab (with kMbar, pass by
  // pass: the last pass's segments are the last vper)
  auto stride = [&](int j) {
    if constexpr (kMbar)
      return j < a.nseg - a.vper ? a.W : a.ld;
    else
      return a.W;
  };
  int rs = stride(0);  // ... of the slab in hand
  // floats a slot (with kMbar as wide as the widest pass)
  const int slot =
      kSK * ((kMbar && a.nseg > a.vper ? a.W : rs) + (kStream ? T : 0));
  // this thread's first chunk of a slab: row r0c, chunk c0c; it then steps
  // kThreads chunks at a time
  const int r0c = a.tid / per, c0c = a.tid - r0c * per;
  int ij = 0, ik = 0;  // the next slab to issue: segment ij, k-row ik
  // kCluster: this thread's entries of the w rows of the slab last issued
  // (entry e = tid + i kThreads: k-row ik + e / T, lane e % T), held in
  // registers until put
  constexpr int kPer = (kSK * T + kThreads - 1) / kThreads;
  float wv[kPer];
  float* wdst = nullptr;
  int wn = 0;  // entries of this thread in the slab
  auto issue = [&](int s) {
    wn = 0;
    if constexpr (kMbar) {
      if (s >= total) return;
      const int rows = min(kSK, a.K - ik);
      const int g = s0 + s, ld = stride(ij);
      float* dst = a.ring + (g % kST) * slot;
      const float* src = seg(ij) + static_cast<size_t>(ik) * ld;
      ik += kSK;
      if (ik >= a.K) {
        ik = 0;
        ++ij;
      }
      if (a.tid >= 32) return;
      // warp 0: the slot's last slab consumed by every warp, then thread 0
      // announces this one's bytes and issues its copies
      if (g >= kST) mbar_wait(&ring_bars.empty[g % kST], (g / kST - 1) & 1);
      if (a.tid == 0) {
        unsigned long long* bar = &ring_bars.full[g % kST];
        const unsigned bytes = 4u * static_cast<unsigned>(rows * ld);
        mbar_expect(bar, bytes);
        bulk_copy(dst, src, bytes, bar);
      }
      return;
    }
    if (s < total) {
      const int rows = min(kSK, a.K - ik);
      const int vr = seg_rows(a, ij);
      float* dst = a.ring + ((s0 + s) % kST) * slot;
      const float* src = seg(ij) + static_cast<size_t>(ik) * a.ld;
      if constexpr (kIn == In::kGlobal) {  // the tile's w rows of the slab
        constexpr int kPerW = T / 4;
        const float* wsrc = a.w + static_cast<size_t>(ik) * a.ldw;
        for (int e = a.tid; e < rows * kPerW; e += kThreads) {
          const int r = e / kPerW, c = e - r * kPerW;
          cp_async16(dst + kSK * a.W + r * T + 4 * c,
                     wsrc + static_cast<size_t>(r) * a.ldw + 4 * c);
        }
      }
      if constexpr (kIn == In::kCluster) {  // ... from the block owning it
        wdst = dst + kSK * a.W + a.tid;
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int e = a.tid + i * kThreads, r = e / T;
          if (r < rows) {
            const int k = ik + r, c = a.ci->owner(k);
            wv[i] = peer_load(a.ci->base[c] +
                              4u * static_cast<unsigned>(
                                       (k - a.ci->kb[c]) * T + e - r * T));
            wn = i + 1;
          }
        }
      }
      ik += kSK;
      if (ik >= a.K) {
        ik = 0;
        ++ij;
      }
      if constexpr (kBulk) {
        if (a.tid == 0) {
          const unsigned bytes = 16u * static_cast<unsigned>((vr + 3) / 4);
          unsigned long long* bar = &a.ci->full[(s0 + s) % kST];
          mbar_expect(bar, bytes * rows);
          for (int r = 0; r < rows; ++r)
            bulk_copy(dst + r * a.W, src + static_cast<size_t>(r) * a.ld,
                      bytes, bar);
        }
      } else if (vr < a.W) {  // a slice's last segment: its valid rows only
        const int pv = (vr + 3) / 4;
        for (int e = a.tid; e < rows * pv; e += kThreads) {
          const int r = e / pv, c = e - r * pv;
          cp_async16(dst + r * a.W + 4 * c,
                     src + static_cast<size_t>(r) * a.ld + 4 * c);
        }
      } else if (a.ld == a.W) {  // one pass: the slab is contiguous
        for (int e = a.tid; e < rows * per; e += kThreads)
          cp_async16(dst + 4 * e, src + 4 * e);
      } else {
        for (int r = r0c, c = c0c; r < rows;) {
          cp_async16(dst + r * a.W + 4 * c,
                     src + static_cast<size_t>(r) * a.ld + 4 * c);
          for (c += kThreads; c >= per; c -= per) ++r;
        }
      }
    }
    cp_async_commit();  // always, so the group count stays in step
  };
  auto put = [&] {
    if constexpr (kIn == In::kCluster)
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        if (i < wn) wdst[i * kThreads] = wv[i];
  };
  for (int s = 0; s < kST - 1; ++s) {
    issue(s);
    put();
  }
  TINYMPC_SEC(kSecRing);
  int j = 0, k0 = 0;  // slab s's segment and first k-row
  bool rows_here = r0 < seg_rows(a, 0);  // the thread has valid rows
  for (int s = 0; s < total; ++s) {
    if constexpr (kBulk)
      mbar_wait(&a.ci->full[(s0 + s) % kST], ((s0 + s) / kST) & 1);
    else if constexpr (kMbar)
      mbar_wait(&ring_bars.full[(s0 + s) % kST], ((s0 + s) / kST) & 1);
    else
      cp_async_wait<kST - 2>();  // slab s has landed
    if constexpr (!kMbar)
      __syncthreads();  // ... for every thread; slab s - 1 is consumed
    TINYMPC_SEC(kSecRing);
    issue(s + kST - 1);  // into slab s - 1's slot
    const float* slab = a.ring + ((s0 + s) % kST) * slot;
    const int k1 = min(a.K, k0 + kSK);
    if (rows_here) {
      const float* wk = kStream ? slab + kSK * rs : a.w + k0 * T;
      if (LPT >= 4 && k1 - k0 == kSK) {
        // a whole slab, unrolled, so the next k-row's loads overlap this
        // one's FMAs
#pragma unroll
        for (int k = 0; k < kSK; ++k) step(slab + k * rs, wk + k * T);
      } else {
        for (int k = k0; k < k1; ++k)
          step(slab + (k - k0) * rs, wk + (k - k0) * T);
      }
    }
    put();  // after the FMAs: the peer load's latency hides behind them
    if constexpr (kMbar) {  // this warp is done with the slot
      __syncwarp();
      if ((a.tid & 31) == 0) mbar_arrive(&ring_bars.empty[(s0 + s) % kST]);
    }
    TINYMPC_SEC(kSecProduct);
    k0 = k1;
    if (k1 == a.K) {
      epi(j, acc, fr);
      TINYMPC_SEC(kSecEpilogue);
      zero();
      ++j;
      k0 = 0;
      if (j < a.nseg) {
        rows_here = r0 < seg_rows(a, j);
        if constexpr (kMbar) rs = stride(j);
      }
    }
  }
}

struct GemmLo {
  const float* w;        // fp32 [k][lane], row stride T (shared memory);
                         // kGlobal: global, row stride ldw; kCluster: the
                         // block's own k-rows
  __nv_bfloat16* w2h;    // (T, kp + kPadLo): w rounded to bf16; kGlobal,
                         // kCluster: the tile's (T, kp) rows of a global
                         // array
  __nv_bfloat16* ring;   // the slab ring where streamed; null: resident
  int K, kp, W, nseg, tid;
  int lda;  // row stride of a resident segment (kp + kPadLo)
  int ldw = 0;
  ClusterIn* ci = nullptr;  // kCluster
  int vrows = 0, vper = 1;        // as GemmF32's
};

// seg(j): segment j's bf16 map, W rows of kp columns (row stride kp in
// global memory where streamed, lda where resident); epi as gemm_fp32's.
// The map's columns K..kp-1 are zero, and so are w2h's.
template <int RPT, int T = kTile, In kIn = In::kShared, class Seg, class Epi>
__device__ __forceinline__ void gemm_lo(const GemmLo& a, Seg seg, Epi epi) {
  constexpr int kMt = RPT / 4;
  constexpr int kRowWarps = Lanes<T>::kRowWarps;
  constexpr bool kStream = kIn != In::kShared;
  const int ldh = kStream ? a.kp : a.kp + kPadLo;  // w2h's row stride
  if constexpr (kIn == In::kCluster) {
    // the block's own k-rows (the last block's also the zero columns K ..
    // kp - 1); a.w: the block's buffer, its first row kb[rank]
    const ClusterIn& ci = *a.ci;
    const int k0 = ci.kb[ci.rank];
    const int k1 = ci.rank + 1 == ci.C ? a.kp : ci.kb[ci.rank + 1];
    for (int e = a.tid; e < (k1 - k0) * T; e += kThreads) {
      const int k = e / T, n = e - k * T;
      const float v = k0 + k >= a.K ? 0.0f : a.w[e];
      a.w2h[n * ldh + k0 + k] = __float2bfloat16_rn(v);
    }
    cluster_sync();  // every block's rounded rows before they stream
  } else {
    for (int e = a.tid; e < a.kp * T; e += kThreads) {
      const int k = e / T, n = e - k * T;
      const float v = k >= a.K ? 0.0f
                      : kIn == In::kGlobal ? a.w[k * a.ldw + n] : a.w[e];
      a.w2h[n * ldh + k] = __float2bfloat16_rn(v);
    }
    if constexpr (kIn == In::kGlobal) __syncthreads();  // before it streams
  }
  const int warp = a.tid >> 5, ln = a.tid & 31;
  const FragLo<RPT> fr{warp % kRowWarps, warp / kRowWarps, ln >> 2, ln & 3};
  float acc[8 * kMt];
  auto zero = [&] {
#pragma unroll
    for (int e = 0; e < 8 * kMt; ++e) acc[e] = 0.0f;
  };
  // this thread's ldmatrix rows: lanes (B, in w2h or, streamed, in a ring
  // slot's w rows) and map rows (A)
  constexpr int lds = kSlabKLo + kPadLo;
  const int bn = fr.wn * 16 + (ln & 7) + ((ln >> 4) << 3);
  const int bk = ((ln >> 3) & 1) * 8;
  const __nv_bfloat16* brow = a.w2h + bn * ldh + bk;
  const int arow = fr.wm * kMt * 16 + (ln & 15), acol = (ln >> 4) * 8;
  // k16 steps over a block of columns of A (row stride lda) and of B (this
  // thread's row at bp)
  auto ksteps = [&](const __nv_bfloat16* A, int lda, const __nv_bfloat16* bp,
                    int n16) {
    for (int kk = 0; kk < n16; ++kk) {
      unsigned b[4];
      ldmatrix_x4(b, bp + kk * 16);
#pragma unroll
      for (int m = 0; m < kMt; ++m) {
        unsigned af[4];
        ldmatrix_x4(af, A + (arow + m * 16) * lda + kk * 16 + acol);
        // each k16 step's 16 products summed from zero in the tensor core,
        // then added to the running sum in IEEE fp32: the tensor core's own
        // accumulation is not round-to-nearest
        float c0[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        float c1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_bf16(c0, af, b[0], b[1]);
        mma_bf16(c1, af, b[2], b[3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[(2 * m) * 4 + e] = __fadd_rn(acc[(2 * m) * 4 + e], c0[e]);
          acc[(2 * m + 1) * 4 + e] =
              __fadd_rn(acc[(2 * m + 1) * 4 + e], c1[e]);
        }
      }
    }
  };
  zero();
  if (!a.ring) {
    __syncthreads();  // w2h staged
    for (int j = 0; j < a.nseg; ++j) {
      ksteps(seg(j), a.lda, brow, a.kp / 16);
      TINYMPC_SEC(kSecProductLo);
      epi(j, acc, fr);
      TINYMPC_SEC(kSecEpilogue);
      zero();
    }
    return;
  }
  // slab s: map columns [(s % nslab) * kSlabKLo, ...) of every row of
  // segment s / nslab, in ring slot s % kStagesLo
  const int nslab = a.kp / kSlabKLo, total = nslab * a.nseg;
  const int slot = (a.W + (kStream ? T : 0)) * lds;  // bf16 of a ring slot
  int ij = 0, ic = 0;  // the next slab to issue: segment ij, slab ic of it
  auto issue = [&](int s) {
    if (s < total) {
      const int vr = seg_rows(a, ij);
      __nv_bfloat16* dst = a.ring + (s % kStagesLo) * slot;
      const __nv_bfloat16* src = seg(ij) + ic * kSlabKLo;
      if constexpr (kStream) {  // the tile's rounded w columns
        for (int e = a.tid; e < T * (kSlabKLo / 8); e += kThreads) {
          const int n = e / (kSlabKLo / 8), q = e % (kSlabKLo / 8);
          cp_async16(dst + (a.W + n) * lds + 8 * q,
                     a.w2h + n * a.kp + ic * kSlabKLo + 8 * q);
        }
      }
      if (++ic == nslab) {
        ic = 0;
        ++ij;
      }
      for (int e = a.tid; e < vr * (kSlabKLo / 8); e += kThreads) {
        const int r = e / (kSlabKLo / 8), q = e % (kSlabKLo / 8);
        cp_async16(dst + r * lds + 8 * q,
                   src + static_cast<size_t>(r) * a.kp + 8 * q);
      }
    }
    cp_async_commit();
  };
  for (int s = 0; s < kStagesLo - 1; ++s) issue(s);
  TINYMPC_SEC(kSecProductLo);  // w's rounding and the first issues
  int j = 0, c = 0;  // slab s's segment and slab within it
  bool rows_here = fr.wm * kMt * 16 < seg_rows(a, 0);
  for (int s = 0; s < total; ++s) {
    cp_async_wait<kStagesLo - 2>();  // slab s has landed
    __syncthreads();  // ... for every thread (and on s = 0 w2h is staged);
                      // slab s - 1 is consumed
    TINYMPC_SEC(kSecRingLo);
    issue(s + kStagesLo - 1);
    const __nv_bfloat16* sl = a.ring + (s % kStagesLo) * slot;
    if (rows_here)
      ksteps(sl, lds,
             kStream ? sl + (a.W + bn) * lds + bk : brow + c * kSlabKLo, 1);
    TINYMPC_SEC(kSecProductLo);
    if (++c == nslab) {
      epi(j, acc, fr);
      TINYMPC_SEC(kSecEpilogue);
      zero();
      c = 0;
      ++j;
      if (j < a.nseg) rows_here = fr.wm * kMt * 16 < seg_rows(a, j);
    }
  }
}

// -- the elementwise step ---------------------------------------------------

// One side of a lane: its column of the tile buffer (element r at
// ux[r * us]: us = T in shared memory, the global array's row stride with
// In::kGlobal), its slack, dual and rollout constant (element r at
// [r * stride]: a [row][lane] shared array or a (dim, B) global one), its
// carry slack (element r at [r * cs]; cs 0: the launch's B, the global
// output; else the lane's column of a block's staged copy in shared
// memory, which the kernel writes out where the lane latches) and, for a
// projected side, its
// constraint data and where a stage of it lives (StageMem): entry j of
// stage k at w[k * wk + j * ws] (the lane's rows of a (sw, B) global
// scratch: ws = B, wk = dim * B; or a stage buffer of the thread's own in
// shared memory, reused by each of its stages: wk = 0).  A
// pass covers the side's stages [k0, k1) (a cluster block's slice; all of
// them by default).  Who takes what: thread q of a lane takes the projected
// stages k0 + qs, k0 + qs + 256 / T, ... (qs: q less the stages the lane's
// other projected side dealt out first, so the two sides' stages go round
// the threads as one list), and of a box side beside a projected one the
// rows [rb0, rb1), a share that evens out the threads' work (box_share);
// of a box side beside another, rows q, q + 256 / T, ....
struct SidePass {
  const Side* s;
  float* ux;
  float* prev;        // slack / output
  float* dual;        // null: the state-free path
  const float* uxc;   // null: nothing to add
  float* co;          // carry slack
  int stride;
  int us;
  float* w;           // where a stage lives; null: a box-only side
  int ws, wk;
  SideData d{};       // a projected side's halfspace rows, mu, cone pairs
  int k0 = 0, k1 = 0x7fffffff;
  int qs = 0;         // the thread's first stage, from k0
  int rb0 = 0, rb1 = 0;  // a box side's rows beside a projected side
  int cs = 0;         // the carry slack's row stride (0: B, global)
};

// The carry slack's entry of row r of a side (SidePass::cs).
template <class P>
__device__ __forceinline__ float& carry_at(const P& p, const SidePass& sp,
                                           int r) {
  return sp.co[r * (sp.cs ? sp.cs : p.B)];
}

// Stages k0 .. k1 - 1 of a side in a block's slice.
__device__ __forceinline__ int slice_stages(const SidePass& sp) {
  return max(min(sp.k1, sp.s->n_stages) - sp.k0, 0);
}

// A projected stage's work in box rows: an entry about two (its slack and
// its update), a fifth more for each halfspace row and four fifths for the
// cones (an estimate from the instructions of the two paths): what
// box_share weighs a thread's stages by.
__device__ __forceinline__ int stage_weight(const Side& s) {
  return s.dim * (10 + 2 * s.n_lin + 4 * (s.n_soc > 0)) / 5;
}

// The rows [rb0, rb1) of a box side ``box`` that thread q of tpl takes
// beside the stages it takes of the projected side ``proj`` (round the
// threads from the slice's first stage): the threads with fewer stages take
// more rows, so every thread's work (stage_weight a stage) comes to about
// the mean.
template <int tpl>
__device__ __forceinline__ void box_share(SidePass& box, const SidePass& proj,
                                          int q) {
  const int n = slice_stages(proj), c = stage_weight(*proj.s);
  const int r0 = box.s->dim * box.k0;
  const int rows = box.s->dim * min(box.k1, box.s->n_stages) - r0;
  const int mean = (n * c + max(rows, 0) + tpl - 1) / tpl;
  int at = 0;
  for (int t = 0; t <= q; ++t) {
    const int stages = n / tpl + (t < n % tpl);
    const int take = t == tpl - 1 ? rows : max(mean - stages * c, 0);
    box.rb0 = r0 + min(at, rows);
    at += take;
    box.rb1 = r0 + min(at, rows);
  }
}

struct BoxRows {
  float prev[kRowBatch], dual[kRowBatch], lo[kRowBatch], hi[kRowBatch],
      uxc[kRowBatch];
};

template <int kStep>
__device__ __forceinline__ void load_box_rows(const SidePass& sp, int g,
                                              int r0, int rows, bool add,
                                              BoxRows& b) {
  const Side& s = *sp.s;
#pragma unroll
  for (int j = 0; j < kRowBatch; ++j) {
    const int r = r0 + kStep * j;
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

// The rows a box pass of thread q walks: [first, end) by kStep, rows q, q
// + 256 / T, ... of the slice (kRange false), or its share [rb0, rb1)
// beside a projected side (kRange true, kStep 1).
template <int T, bool kRange>
struct BoxWalk {
  static constexpr int kStep = kRange ? 1 : Lanes<T>::kLaneThreads;
  int first, end;
  __device__ __forceinline__ BoxWalk(const SidePass& sp, int q) {
    const int dim = sp.s->dim;
    first = kRange ? sp.rb0 : dim * sp.k0 + q;
    end = kRange ? sp.rb1 : dim * min(sp.k1, sp.s->n_stages);
  }
};

// The residual pass of thread q of a lane over a box side: the max-abs
// primal (pri) and dual (dua, before its rho scaling) residuals of its rows;
// with add it also completes ux = product + uxc in the buffer.
template <bool kRange = false, int T = kTile, class P>
__device__ __forceinline__ void box_residuals_q(const P& p,
                                                const SidePass& sp, int g,
                                                bool relax, int q, bool add,
                                                float& pri, float& dua) {
  const Side& s = *sp.s;
  float* ux = sp.ux;
  const BoxWalk<T, kRange> wk(sp, q);
  constexpr int kStep = BoxWalk<T, kRange>::kStep;
  for (int r0 = wk.first; r0 < wk.end; r0 += kStep * kRowBatch) {
    BoxRows b;
    load_box_rows<kStep>(sp, g, r0, wk.end, add, b);
#pragma unroll
    for (int j = 0; j < kRowBatch; ++j) {
      const int r = r0 + kStep * j;
      if (r < wk.end) {
        float u = ux[r * sp.us];
        if (add) {
          u = __fadd_rn(u, b.uxc[j]);
          ux[r * sp.us] = u;
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

// The update of one row: the new slack vn, the dual ascent, and the next
// product input (slack - dual) into the buffer; the carry's slack ``prev``
// where co_prev (the row's lane latches now, or a checking iteration writes
// it ahead).
template <class P>
__device__ __forceinline__ void update_row(const P& p, const SidePass& sp,
                                           bool relax, int r, float u,
                                           float prev, float dual, float vn,
                                           bool co_prev) {
  const int o = r * sp.stride;
  const float wh = relaxed(p, relax, u, prev);
  float next = vn;  // state-free: g == 0, the entry is vnew
  if (sp.dual) {
    const float dn = __fsub_rn(__fadd_rn(dual, wh), vn);
    sp.dual[o] = dn;
    next = __fsub_rn(vn, dn);
  }
  sp.prev[o] = vn;
  if (co_prev) carry_at(p, sp, r) = prev;
  sp.ux[r * sp.us] = next;
}

// The residual and the update pass of thread q of a lane over a box side
// in one pass (the continuation layouts, on a checking iteration): each
// row's residuals (box_residuals_q's) and its update (box_update_q's) from
// the same loads; the carry's slack written ahead where the launch has a
// carry (``ahead``; a lane that latches on it keeps the slack it had, the
// others overwrite it at the end), as a projected side's pass does.
template <bool kRange = false, int T = kTile, class P>
__device__ __forceinline__ void box_pass_q(const P& p, const SidePass& sp,
                                           int g, bool relax, int q,
                                           bool add, bool ahead, float& pri,
                                           float& dua) {
  const Side& s = *sp.s;
  const BoxWalk<T, kRange> wk(sp, q);
  constexpr int kStep = BoxWalk<T, kRange>::kStep;
  for (int r0 = wk.first; r0 < wk.end; r0 += kStep * kRowBatch) {
    BoxRows b;
    load_box_rows<kStep>(sp, g, r0, wk.end, add, b);
#pragma unroll
    for (int j = 0; j < kRowBatch; ++j) {
      const int r = r0 + kStep * j;
      if (r < wk.end) {
        float u = sp.ux[r * sp.us];
        if (add) u = __fadd_rn(u, b.uxc[j]);
        const float vn = box_slack(s, relaxed(p, relax, u, b.prev[j]),
                                   sp.dual != nullptr, b.dual[j], b.lo[j],
                                   b.hi[j]);
        pri = fmaxf(pri, fabsf(__fsub_rn(u, vn)));
        dua = fmaxf(dua, fabsf(__fsub_rn(b.prev[j], vn)));
        update_row(p, sp, relax, r, u, b.prev[j], b.dual[j], vn, ahead);
      }
    }
  }
}

// The update pass of thread q of a lane over a box side.  The carry's
// slack freezes before the converging iteration: a lane that latches now
// (latch) writes the slack it had; the other lanes' carry is written once,
// at the end.
template <bool kRange = false, int T = kTile, class P>
__device__ __forceinline__ void box_update_q(const P& p, const SidePass& sp,
                                             int g, bool relax, int q,
                                             bool add, bool latch) {
  const Side& s = *sp.s;
  const BoxWalk<T, kRange> wk(sp, q);
  constexpr int kStep = BoxWalk<T, kRange>::kStep;
  for (int r0 = wk.first; r0 < wk.end; r0 += kStep * kRowBatch) {
    BoxRows b;
    load_box_rows<kStep>(sp, g, r0, wk.end, add, b);
#pragma unroll
    for (int j = 0; j < kRowBatch; ++j) {
      const int r = r0 + kStep * j;
      if (r < wk.end) {
        float u = sp.ux[r * sp.us];
        if (add) u = __fadd_rn(u, b.uxc[j]);
        const float vn = box_slack(s, relaxed(p, relax, u, b.prev[j]),
                                   sp.dual != nullptr, b.dual[j], b.lo[j],
                                   b.hi[j]);
        update_row(p, sp, relax, r, u, b.prev[j], b.dual[j], vn, latch);
      }
    }
  }
}

// Rows a projected stage's pass loads at once: 8, or 4 in an instance whose
// registers 8 rows' loads would overflow (two blocks an SM, 128 registers a
// thread; the cluster and global layouts and K2, whose products already
// fill 255).
constexpr int kStageBatch = 8;
constexpr int kStageBatchSmall = 4;

// The clipped slack of stage k of a projected side into w (with add, ux =
// product + uxc completed in the buffer), kB rows at a time: a batch's
// loads are all in flight before its arithmetic starts.
template <int kB, class P>
__device__ __forceinline__ void stage_slack(const P& p, const SidePass& sp,
                                            int g, int k, bool relax,
                                            bool add, const StageMem& w) {
  const Side& s = *sp.s;
  const int rk = k * s.dim;
  const float* wmin = s.wmin + g * s.box_stride + rk;
  const float* wmax = s.wmax + g * s.box_stride + rk;
  for (int j0 = 0; j0 < s.dim; j0 += kB) {
    float u[kB], prev[kB], dual[kB], c[kB], lo[kB], hi[kB];
#pragma unroll
    for (int i = 0; i < kB; ++i) {
      const int j = j0 + i, r = rk + j, o = r * sp.stride;
      if (j < s.dim) {
        u[i] = sp.ux[r * sp.us];
        c[i] = add ? sp.uxc[o] : 0.0f;
        prev[i] = sp.prev[o];
        dual[i] = sp.dual ? sp.dual[o] : 0.0f;
        if (s.en_box) {
          lo[i] = __ldg(wmin + j);
          hi[i] = __ldg(wmax + j);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kB; ++i) {
      const int j = j0 + i;
      if (j < s.dim) {
        float v = u[i];
        if (add) {
          v = __fadd_rn(v, c[i]);
          sp.ux[(rk + j) * sp.us] = v;
        }
        w[j] = box_slack(s, relaxed(p, relax, v, prev[i]),
                         sp.dual != nullptr, dual[i], lo[i], hi[i]);
      }
    }
  }
}

// Where stage k of a projected side lives: the side's StageMem.
__device__ __forceinline__ StageMem stage_at(const SidePass& sp, int k) {
  return {sp.w + k * sp.wk, sp.ws};
}

// The projected pass of thread q of a lane over its stages of one side,
// each stage projected once an iteration (stage_slack, project_stage), then
// each row's residuals (check: the max-abs primal and dual residuals, the
// dual before its rho scaling) and its update (update_row), kB rows at a
// time; the carry's slack is written ahead on every checking
// iteration where the launch has a carry (co_ahead): a lane that latches on
// it keeps the slack it had, and the others overwrite it at the end.  The
// residuals and the update read only the row's own entries, so one pass
// serves both.
template <int T, int kB, class P>
__device__ __forceinline__ void projected_pass(const P& p, const SidePass& sp,
                                               int g, bool relax, int q,
                                               bool add, bool check,
                                               bool co_ahead, float& pri,
                                               float& dua) {
  const Side& s = *sp.s;
  const int k1 = min(sp.k1, s.n_stages);
  for (int k = sp.k0 + sp.qs; k < k1; k += Lanes<T>::kLaneThreads) {
    const StageMem w = stage_at(sp, k);
    stage_slack<kB>(p, sp, g, k, relax, add, w);
    project_stage(w, s, sp.d);
    const int rk = k * s.dim;
    for (int j0 = 0; j0 < s.dim; j0 += kB) {
      float u[kB], prev[kB], dual[kB], vn[kB];
#pragma unroll
      for (int i = 0; i < kB; ++i) {
        const int j = j0 + i, r = rk + j, o = r * sp.stride;
        if (j < s.dim) {
          u[i] = sp.ux[r * sp.us];
          prev[i] = sp.prev[o];
          dual[i] = sp.dual ? sp.dual[o] : 0.0f;
          vn[i] = w[j];
        }
      }
#pragma unroll
      for (int i = 0; i < kB; ++i) {
        const int j = j0 + i;
        if (j < s.dim) {
          if (check) {
            pri = fmaxf(pri, fabsf(__fsub_rn(u[i], vn[i])));
            dua = fmaxf(dua, fabsf(__fsub_rn(prev[i], vn[i])));
          }
          update_row(p, sp, relax, rk + j, u[i], prev[i], dual[i], vn[i],
                     co_ahead);
        }
      }
    }
  }
}

}  // namespace tinympc
