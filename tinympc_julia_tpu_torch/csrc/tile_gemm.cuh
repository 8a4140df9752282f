// The lane-tile layout shared by the condensed kernels K1
// (condensed_fused.cu) and K2 (condensed_adaptive.cu): a block of 256
// threads owns a tile of T lanes (32; K2 takes 16 where the iterates of 32
// lanes would not fit beside a wide map), runs the tile's matrix products
// as GEMMs and the elementwise step of an ADMM iteration with 256 / T
// threads a lane.  The tile is a template parameter (Lanes<T>), 32 by
// default.
//
// The products.  out(row, lane) = sum_k M(k, row) w(k, lane) over the
// tile, w in shared memory as [k][lane] (row stride T), M a transposed map
// ([k][row], row stride ld) in fp32 or a row-major bf16 map ([row][k]).
//  * fp32 (gemm_fp32): each thread keeps a register tile of RPT rows x 2
//    lanes and sums every output over k in index order with fmaf, so a
//    lane's result does not depend on its tile-mates (and equals a
//    product that sums in index order: cuBLAS's at these shapes).  No
//    TF32.  The T / 2 lane groups x 512 / T row groups cover W = 512 RPT /
//    T rows at once.
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
//
// The elementwise step: the threads of a lane split each side of it, the
// rows of a box-only side (thread q of its 256 / T takes rows q, q + 256 /
// T, ...) or the stages of a projected one (stages q, ...: the projections couple
// only the rows of a stage), in projections.cuh's arithmetic and the plain
// version's order of operations.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "projections.cuh"
#include "ptx.cuh"

namespace tinympc {

constexpr int kThreads = 256;  // threads a block
constexpr int kTile = 32;      // lanes a block, unless a kernel asks for 16
constexpr int kSlabK = 8;      // fp32 map k-rows per slab
constexpr int kStages = 6;     // fp32 slabs in the ring
constexpr int kSlabKLo = 16;   // bf16 map k-columns per slab
constexpr int kStagesLo = 4;   // bf16 slabs in the ring
constexpr int kPadLo = 8;      // bf16 row padding (conflict-free ldmatrix)
constexpr int kRowBatch = 4;   // rows an elementwise pass loads at once

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

// Bytes of the slab ring of a streamed product of width W (fp32 slabs, or
// bf16 slabs where ``lo``).
__host__ __device__ inline size_t ring_bytes(int W, bool lo) {
  return lo ? 2 * kStagesLo * static_cast<size_t>(W) * (kSlabKLo + kPadLo)
            : sizeof(float) * kStages * static_cast<size_t>(kSlabK) * W;
}

// Which output each register of an fp32 product thread holds: entry e of
// its 2 RPT is row tr * RPT + e / 2 of the segment, lane 2 tl + e % 2.
template <int RPT>
struct FragF32 {
  static constexpr bool kLo = false;
  int tr, tl;
  __device__ __forceinline__ int row(int e) const { return tr * RPT + e / 2; }
  __device__ __forceinline__ int lane(int e) const { return 2 * tl + (e & 1); }
};

// ... and of a bf16 product thread (mma.sync's m16n8 accumulator layout):
// entry e = (m * 2 + jn) * 4 + ee of 16-row tile m and 8-lane tile jn of
// warp (wm, wn).
template <int RPT>
struct FragLo {
  static constexpr bool kLo = true;
  static constexpr int kMt = RPT / 4;  // 16-row tiles a warp
  int wm, wn, gq, tq;
  __device__ __forceinline__ int row(int e) const {
    return (wm * kMt + e / 8) * 16 + gq + 8 * ((e & 3) >> 1);
  }
  __device__ __forceinline__ int lane(int e) const {
    return wn * 16 + ((e >> 2) & 1) * 8 + 2 * tq + (e & 1);
  }
};

struct GemmF32 {
  const float* w;  // [k][lane], row stride T (shared memory)
  float* ring;     // the slab ring where the segments are streamed; null:
                   // seg(j) points into shared memory
  int K, W, ld, nseg, tid;  // W = Lanes<T>::kRowGroups * RPT
};

// seg(j): segment j's map, [k][row] with row stride ld (W rows of it);
// epi(j, acc, frag) after segment j, on every thread.  Every thread must be
// past its last use of the ring and of w before the call.
template <int RPT, int T = kTile, class Seg, class Epi>
__device__ __forceinline__ void gemm_fp32(const GemmF32& a, Seg seg,
                                          Epi epi) {
  static_assert(RPT % 4 == 0, "rows a thread: a multiple of 4");
  constexpr int kLaneGroups = Lanes<T>::kLaneGroups;
  const FragF32<RPT> fr{a.tid / kLaneGroups, a.tid % kLaneGroups};
  const int r0 = fr.tr * RPT;
  float acc[2 * RPT];
  auto zero = [&] {
#pragma unroll
    for (int e = 0; e < 2 * RPT; ++e) acc[e] = 0.0f;
  };
  const float* wcol = a.w + 2 * fr.tl;
  auto step = [&](const float* mrow, int k) {
    const float2 w = *reinterpret_cast<const float2*>(wcol + k * T);
#pragma unroll
    for (int j4 = 0; j4 < RPT / 4; ++j4) {
      const float4 m = *reinterpret_cast<const float4*>(mrow + r0 + 4 * j4);
      const float mv[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[2 * (4 * j4 + j)] = fmaf(mv[j], w.x, acc[2 * (4 * j4 + j)]);
        acc[2 * (4 * j4 + j) + 1] =
            fmaf(mv[j], w.y, acc[2 * (4 * j4 + j) + 1]);
      }
    }
  };
  zero();
  if (!a.ring) {
    for (int j = 0; j < a.nseg; ++j) {
      const float* m = seg(j);
      for (int k = 0; k < a.K; ++k) step(m + k * a.ld, k);
      epi(j, acc, fr);
      zero();
    }
    return;
  }
  // slab s: k-rows [(s % nslab) * kSlabK, ...) of segment s / nslab, in
  // ring slot s % kStages
  const int nslab = (a.K + kSlabK - 1) / kSlabK, total = nslab * a.nseg;
  const int per = a.W / 4;  // 16-byte chunks of a slab row
  // this thread's first chunk of a slab: row r0c, chunk c0c; it then steps
  // kThreads chunks at a time
  const int r0c = a.tid / per, c0c = a.tid - r0c * per;
  int ij = 0, ik = 0;  // the next slab to issue: segment ij, k-row ik
  auto issue = [&](int s) {
    if (s < total) {
      const int rows = min(kSlabK, a.K - ik);
      float* dst = a.ring + (s % kStages) * kSlabK * a.W;
      const float* src = seg(ij) + static_cast<size_t>(ik) * a.ld;
      ik += kSlabK;
      if (ik >= a.K) {
        ik = 0;
        ++ij;
      }
      if (a.ld == a.W) {  // one pass: the slab is contiguous
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
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  int j = 0, k0 = 0;  // slab s's segment and first k-row
  for (int s = 0; s < total; ++s) {
    cp_async_wait<kStages - 2>();  // slab s has landed
    __syncthreads();  // ... for every thread; slab s - 1 is consumed
    issue(s + kStages - 1);  // into slab s - 1's slot
    const float* slab = a.ring + (s % kStages) * kSlabK * a.W;
    const int k1 = min(a.K, k0 + kSlabK);
    for (int k = k0; k < k1; ++k) step(slab + (k - k0) * a.W, k);
    k0 = k1;
    if (k1 == a.K) {
      epi(j, acc, fr);
      zero();
      ++j;
      k0 = 0;
    }
  }
}

struct GemmLo {
  const float* w;        // fp32 [k][lane], row stride T (shared memory)
  __nv_bfloat16* w2h;    // (T, kp + kPadLo): w rounded to bf16
  __nv_bfloat16* ring;   // the slab ring where streamed; null: resident
  int K, kp, W, nseg, tid;
  int lda;  // row stride of a resident segment (kp + kPadLo)
};

// seg(j): segment j's bf16 map, W rows of kp columns (row stride kp in
// global memory where streamed, lda where resident); epi as gemm_fp32's.
// The map's columns K..kp-1 are zero, and so are w2h's.
template <int RPT, int T = kTile, class Seg, class Epi>
__device__ __forceinline__ void gemm_lo(const GemmLo& a, Seg seg, Epi epi) {
  constexpr int kMt = RPT / 4;
  constexpr int kRowWarps = Lanes<T>::kRowWarps;
  const int ldw = a.kp + kPadLo;
  for (int e = a.tid; e < a.kp * T; e += kThreads) {
    const int k = e / T, n = e - k * T;
    a.w2h[n * ldw + k] = __float2bfloat16_rn(k < a.K ? a.w[e] : 0.0f);
  }
  const int warp = a.tid >> 5, ln = a.tid & 31;
  const FragLo<RPT> fr{warp % kRowWarps, warp / kRowWarps, ln >> 2, ln & 3};
  float acc[8 * kMt];
  auto zero = [&] {
#pragma unroll
    for (int e = 0; e < 8 * kMt; ++e) acc[e] = 0.0f;
  };
  // this thread's ldmatrix rows: lanes (B) and map rows (A)
  const __nv_bfloat16* brow =
      a.w2h + (fr.wn * 16 + (ln & 7) + ((ln >> 4) << 3)) * ldw +
      ((ln >> 3) & 1) * 8;
  const int arow = fr.wm * kMt * 16 + (ln & 15), acol = (ln >> 4) * 8;
  // k16 steps over a block of columns of A (row stride lda) whose column 0
  // is column kb of the map
  auto ksteps = [&](const __nv_bfloat16* A, int lda, int kb, int n16) {
    for (int kk = 0; kk < n16; ++kk) {
      unsigned b[4];
      ldmatrix_x4(b, brow + kb + kk * 16);
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
      ksteps(seg(j), a.lda, 0, a.kp / 16);
      epi(j, acc, fr);
      zero();
    }
    return;
  }
  // slab s: map columns [(s % nslab) * kSlabKLo, ...) of every row of
  // segment s / nslab, in ring slot s % kStagesLo
  const int nslab = a.kp / kSlabKLo, total = nslab * a.nseg;
  constexpr int lds = kSlabKLo + kPadLo;
  int ij = 0, ic = 0;  // the next slab to issue: segment ij, slab ic of it
  auto issue = [&](int s) {
    if (s < total) {
      __nv_bfloat16* dst = a.ring + (s % kStagesLo) * a.W * lds;
      const __nv_bfloat16* src = seg(ij) + ic * kSlabKLo;
      if (++ic == nslab) {
        ic = 0;
        ++ij;
      }
      for (int e = a.tid; e < a.W * (kSlabKLo / 8); e += kThreads) {
        const int r = e / (kSlabKLo / 8), q = e % (kSlabKLo / 8);
        cp_async16(dst + r * lds + 8 * q,
                   src + static_cast<size_t>(r) * a.kp + 8 * q);
      }
    }
    cp_async_commit();
  };
  for (int s = 0; s < kStagesLo - 1; ++s) issue(s);
  int j = 0, c = 0;  // slab s's segment and slab within it
  for (int s = 0; s < total; ++s) {
    cp_async_wait<kStagesLo - 2>();  // slab s has landed
    __syncthreads();  // ... for every thread (and on s = 0 w2h is staged);
                      // slab s - 1 is consumed
    issue(s + kStagesLo - 1);
    ksteps(a.ring + (s % kStagesLo) * a.W * lds, lds, c * kSlabKLo, 1);
    if (++c == nslab) {
      epi(j, acc, fr);
      zero();
      c = 0;
      ++j;
    }
  }
}

// -- the elementwise step ---------------------------------------------------

// One side of a lane: its column of the tile buffer (element r at
// ux[r * T]), its slack, dual and rollout constant (element r at
// [r * stride]: a [row][lane] shared array or a (dim, B) global one) and its
// carry slack (global, element r at [r * B]).
struct SidePass {
  const Side* s;
  float* ux;
  float* prev;        // slack / output
  float* dual;        // null: the state-free path
  const float* uxc;   // null: nothing to add
  float* co;          // carry slack
  int stride;
};

// What stage_slack (projections.cuh) reads of the kernel's parameters,
// with the state's row stride in place of the batch size.
struct StageParams {
  float alpha, one_m_alpha;
  int B;
};

struct BoxRows {
  float prev[kRowBatch], dual[kRowBatch], lo[kRowBatch], hi[kRowBatch],
      uxc[kRowBatch];
};

template <int T>
__device__ __forceinline__ void load_box_rows(const SidePass& sp, int g,
                                              int r0, int rows, bool add,
                                              BoxRows& b) {
  constexpr int kLaneThreads = Lanes<T>::kLaneThreads;
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

// Adds uxc to the rows of stage k of a projected side (add), then its
// slack into w.
template <int T, class P>
__device__ __forceinline__ void projected_stage(const P& p, const SidePass& sp,
                                                int g, int k, bool relax,
                                                bool add, float* w) {
  const Side& s = *sp.s;
  if (add)
    for (int j = 0; j < s.dim; ++j) {
      const int r = k * s.dim + j;
      sp.ux[r * T] = __fadd_rn(sp.ux[r * T], sp.uxc[r * sp.stride]);
    }
  const StageParams sp_p{p.alpha, p.one_m_alpha, sp.stride};
  stage_slack(sp_p, s, g, k, relax, sp.ux, sp.prev, sp.dual, 0, T, w);
}

// The residual pass of thread q of a lane: the max-abs primal (pri) and
// dual (dua, before its rho scaling) residuals of its share of one side;
// with add it also completes ux = product + uxc in the buffer.
template <bool kProj, int T = kTile, class P>
__device__ __forceinline__ void side_residuals_q(const P& p,
                                                 const SidePass& sp, int g,
                                                 bool relax, int q, bool add,
                                                 float& pri, float& dua) {
  constexpr int kLaneThreads = Lanes<T>::kLaneThreads;
  const Side& s = *sp.s;
  float* ux = sp.ux;
  if constexpr (kProj) {
    for (int k = q; k < s.n_stages; k += kLaneThreads) {
      float w[kMaxStage];
      projected_stage<T>(p, sp, g, k, relax, add, w);
      for (int j = 0; j < s.dim; ++j) {
        const int r = k * s.dim + j;
        pri = fmaxf(pri, fabsf(__fsub_rn(ux[r * T], w[j])));
        dua = fmaxf(dua, fabsf(__fsub_rn(sp.prev[r * sp.stride], w[j])));
      }
    }
  } else {
    const int rows = s.dim * s.n_stages;
    for (int r0 = q; r0 < rows; r0 += kLaneThreads * kRowBatch) {
      BoxRows b;
      load_box_rows<T>(sp, g, r0, rows, add, b);
#pragma unroll
      for (int j = 0; j < kRowBatch; ++j) {
        const int r = r0 + kLaneThreads * j;
        if (r < rows) {
          float u = ux[r * T];
          if (add) {
            u = __fadd_rn(u, b.uxc[j]);
            ux[r * T] = u;
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

// The update pass of thread q of a lane: the new slack, the dual ascent,
// and the next product input (slack - dual) into the buffer.  The carry's
// slack freezes before the converging iteration: a lane that latches now
// (latch) writes the slack it had; the other lanes' carry is written once,
// at the end.
template <bool kProj, int T = kTile, class P>
__device__ __forceinline__ void side_update_q(const P& p, const SidePass& sp,
                                              int g, bool relax, int q,
                                              bool add, bool latch) {
  constexpr int kLaneThreads = Lanes<T>::kLaneThreads;
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
    ux[r * T] = next;
  };
  if constexpr (kProj) {
    for (int k = q; k < s.n_stages; k += kLaneThreads) {
      float w[kMaxStage];
      projected_stage<T>(p, sp, g, k, relax, add, w);
      for (int j = 0; j < s.dim; ++j) {
        const int r = k * s.dim + j, o = r * sp.stride;
        row(r, ux[r * T], sp.prev[o], sp.dual ? sp.dual[o] : 0.0f, w[j]);
      }
    }
  } else {
    const int rows = s.dim * s.n_stages;
    for (int r0 = q; r0 < rows; r0 += kLaneThreads * kRowBatch) {
      BoxRows b;
      load_box_rows<T>(sp, g, r0, rows, add, b);
#pragma unroll
      for (int j = 0; j < kRowBatch; ++j) {
        const int r = r0 + kLaneThreads * j;
        if (r < rows) {
          float u = ux[r * T];
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

}  // namespace tinympc
