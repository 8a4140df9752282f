// The slack update of one side (inputs or states) of a condensed ADMM
// iteration, shared by the fused kernels (condensed_fused.cu, kernel K1, and
// condensed_adaptive.cu, kernel K2, through tile_gemm.cuh's elementwise
// passes): over-relaxation, the dual shift, the box, the per-stage cyclic
// halfspaces and the scaled second-order cones, composed box -> linear ->
// SOC.
//
// Replaces apply_lin and apply_soc of
// tinympc_julia_tpu/ops/pallas/condensed_kernel.py (selector matmuls there;
// here one thread walks a stage of one lane).
//
// The over-relaxation reads the kernel's parameter struct P (P::alpha,
// P::one_m_alpha); the stage functions work on a stage's entries wherever
// it lives (Stage, StageMem), tile_gemm.cuh's passes load and store them.
//
// Elementwise arithmetic uses explicit round-to-nearest intrinsics so the
// compiler does not contract it into FMAs: a kernel then computes the same
// operations, in the same order, as its plain PyTorch version.
//
// The projections couple the rows of one stage (a halfspace all of them, a
// cone its own), so a projected side is walked stage by stage: the stage's
// slack is clipped to the box, put through each halfspace row in order and
// then each cone where it lies, and only then the pass takes the residuals
// or writes the updates (tile_gemm.cuh's projected pass, once a stage an
// iteration).  The stage lives in memory (StageMem, entry j at w[j * ws]):
// a buffer of the thread's own in shared memory, or the lane's rows of a
// global scratch where the stage leaves no room there, so a stage of any
// width and any cones fit.  The halfspace rows (a, a/||a||^2, b), the
// cones' mu and their (start, dim) pairs are read from the block's copy in
// shared memory where the launch leaves room (stage_constraints), else from
// the device arrays.  A side without projections keeps the row-by-row
// arithmetic of the box path.
//
// Group grid: a launch may solve G distinct problems, each block lanes of
// one group g.  The constraint STRUCTURE (row counts, cone extents) is the
// same for every group; the DATA (box bounds, halfspace rows, cone mu) is
// either shared or stacked along a leading group axis, and every function
// takes the block's group g and reads its group's slice through the
// Side's strides (0 where the data is shared).
#pragma once
#include <cuda_runtime.h>

namespace tinympc {

// One side (inputs or states) of the slack update.
struct Side {
  const float* wmin;  // (rows,) box
  const float* wmax;
  const float* lin;   // (n_lin, 2*dim + 1): a, a/||a||^2, b of each row
  const float* mu;    // (n_soc,)
  const int* cones;   // (n_soc, 2): each cone's (start, dim) in a stage
  int dim, n_stages, n_lin, n_soc, en_box;
  // floats between two groups' slices of wmin/wmax, lin and mu; 0: shared
  int box_stride, lin_stride, mu_stride;
};

// Fills one Side from the entry point's arguments (``soc``: n_soc (start,
// dim) pairs in device memory, each within a stage, which the caller
// checks; ``grouped_*``: whether that array has a leading group axis) and
// refuses a side whose arrays are missing.
inline bool init_side(Side& s, const float* wmin, const float* wmax,
                      const float* lin, int n_lin, const int* soc,
                      const float* mu, int n_soc, int dim, int n_stages,
                      int en_box, int grouped_box, int grouped_lin,
                      int grouped_mu) {
  s.wmin = wmin; s.wmax = wmax; s.lin = lin; s.mu = mu; s.cones = soc;
  s.dim = dim; s.n_stages = n_stages; s.n_lin = n_lin; s.n_soc = n_soc;
  s.en_box = en_box;
  s.box_stride = grouped_box ? dim * n_stages : 0;
  s.lin_stride = grouped_lin ? n_lin * (2 * dim + 1) : 0;
  s.mu_stride = grouped_mu ? n_soc : 0;
  return !(n_lin < 0 || n_soc < 0 || dim < 1 ||
           (n_lin > 0 && lin == nullptr) ||
           (n_soc > 0 && (soc == nullptr || mu == nullptr)));
}

// The constraint data of one side as a block reads it: its group's
// halfspace rows and cone mu, and the cones' (start, dim) pairs.
struct SideData {
  const float* lin;
  const float* mu;
  const int* cones;
};

// Bytes of both sides' constraint data staged in shared memory: the cone
// pairs, the mu and the halfspace rows of one group.
__host__ __device__ inline size_t constraint_bytes(const Side& su,
                                                   const Side& sx) {
  auto up = [](size_t n) { return (n + 15) / 16 * 16; };
  const size_t nc = su.n_soc + sx.n_soc;
  const size_t nl = static_cast<size_t>(su.n_lin) * (2 * su.dim + 1) +
                    static_cast<size_t>(sx.n_lin) * (2 * sx.dim + 1);
  return nc ? up(8 * nc) + up(4 * nc) + up(4 * nl) : up(4 * nl);
}

// Where a side's data is read: group g's slice of the device arrays.
__device__ __forceinline__ SideData side_data(const Side& s, int g) {
  return {s.lin + g * s.lin_stride, s.mu + g * s.mu_stride, s.cones};
}

// Copies both sides' constraint data of group g into the block's shared
// memory (constraint_bytes at ``dst``: the cone pairs, the mu, the halfspace
// rows) and points du, dx at it; the caller's barrier makes it visible.
__device__ __forceinline__ void stage_constraints(const Side& su,
                                                  const Side& sx, int g,
                                                  char* dst, int tid,
                                                  int threads, SideData* du,
                                                  SideData* dx) {
  const int nu2 = 2 * su.n_soc, nx2 = 2 * sx.n_soc, nc = su.n_soc + sx.n_soc;
  int* pairs = reinterpret_cast<int*>(dst);
  float* mu = reinterpret_cast<float*>(
      dst + (nc ? (8 * static_cast<size_t>(nc) + 15) / 16 * 16 : 0));
  float* lin = mu + (nc ? (nc + 3) / 4 * 4 : 0);
  const int lu = su.n_lin * (2 * su.dim + 1), lx = sx.n_lin * (2 * sx.dim + 1);
  for (int e = tid; e < nu2 + nx2; e += threads)
    pairs[e] = e < nu2 ? su.cones[e] : sx.cones[e - nu2];
  for (int e = tid; e < nc; e += threads)
    mu[e] = e < su.n_soc ? su.mu[g * su.mu_stride + e]
                         : sx.mu[g * sx.mu_stride + e - su.n_soc];
  for (int e = tid; e < lu + lx; e += threads)
    lin[e] = e < lu ? su.lin[g * su.lin_stride + e]
                    : sx.lin[g * sx.lin_stride + e - lu];
  *du = {lin, mu, pairs};
  *dx = {lin + lu, mu + su.n_soc, pairs + nu2};
}

template <class P>
__device__ __forceinline__ float relaxed(const P& p, bool relax, float w,
                                         float prev) {
  return relax ? __fadd_rn(__fmul_rn(p.alpha, w), __fmul_rn(p.one_m_alpha,
                                                            prev))
               : w;
}

// The slack of row r before the linear and cone projections: w_hat + dual
// (no dual: the state-free path, g == 0), clipped to the box [lo, hi].
__device__ __forceinline__ float box_slack(const Side& s, float wh,
                                           bool has_dual, float dual,
                                           float lo, float hi) {
  float v = has_dual ? __fadd_rn(wh, dual) : wh;
  if (s.en_box) v = fminf(hi, fmaxf(lo, v));
  return v;
}

// A stage in memory, entry j at w[j * ws].
struct StageMem {
  float* w;
  int ws;
  __device__ __forceinline__ float& operator[](int j) const {
    return w[j * ws];
  }
};

// Each halfspace row in order on stage w (w -= max(a.w - b, 0) a/||a||^2,
// the dot product summed in index order).
__device__ __forceinline__ void project_halfspaces(const StageMem& w,
                                                   int dim,
                                                   const float* lin,
                                                   int n_lin) {
  for (int h = 0; h < n_lin; ++h) {
    const float* row = lin + h * (2 * dim + 1);
    float dot = __fmul_rn(w[0], row[0]);
    for (int d = 1; d < dim; ++d)
      dot = __fadd_rn(dot, __fmul_rn(w[d], row[d]));
    const float viol = fmaxf(__fsub_rn(dot, row[2 * dim]), 0.0f);
    for (int d = 0; d < dim; ++d)
      w[d] = __fsub_rn(w[d], __fmul_rn(viol, row[dim + d]));
  }
}

// Each cone in order (projections._project_soc_scaled): the origin below
// the cone, the boundary outside it, unchanged inside.
__device__ __forceinline__ void project_cones(const StageMem& w,
                                              const float* mu,
                                              const int* cones, int n_soc) {
  for (int c = 0; c < n_soc; ++c) {
    const StageMem seg{w.w + cones[2 * c] * w.ws, w.ws};
    const int last = cones[2 * c + 1] - 1;
    float sq = __fmul_rn(seg[0], seg[0]);
    for (int d = 1; d < last; ++d)
      sq = __fadd_rn(sq, __fmul_rn(seg[d], seg[d]));
    const float a = __fsqrt_rn(sq);
    const float u0 = __fmul_rn(seg[last], mu[c]);
    if (a <= -u0) {  // below the cone: the origin
      for (int d = 0; d <= last; ++d) seg[d] = 0.0f;
    } else if (!(a <= u0)) {  // outside: onto the boundary
      const float factor = __fdiv_rn(__fadd_rn(a, u0),
                                     __fmul_rn(2.0f, fmaxf(a, 1e-30f)));
      for (int d = 0; d < last; ++d) seg[d] = __fmul_rn(factor, seg[d]);
      seg[last] = __fmul_rn(factor, __fdiv_rn(a, mu[c]));
    }
  }
}

// The linear and cone projections of a stage's clipped slack w, in the
// plain version's order of operations.
__device__ __forceinline__ void project_stage(const StageMem& w,
                                              const Side& s,
                                              const SideData& d) {
  project_halfspaces(w, s.dim, d.lin, s.n_lin);
  project_cones(w, d.mu, d.cones, s.n_soc);
}

}  // namespace tinympc
