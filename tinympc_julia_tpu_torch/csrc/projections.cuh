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
// Every function is a template on the kernel's parameter struct P, of which
// it reads P::alpha, P::one_m_alpha (over-relaxation) and P::B (the row
// stride of the lane's slack and dual: element r of the lane at [r * B +
// lane]).  The lane's iterate ux lives in shared memory, element r at
// ux[r * T] for a tile of T lanes.
//
// Elementwise arithmetic uses explicit round-to-nearest intrinsics so the
// compiler does not contract it into FMAs: a kernel then computes the same
// operations, in the same order, as its plain PyTorch version.
//
// The projections couple the rows of one stage (a halfspace all of them, a
// cone its own), so a projected side is walked stage by stage: the stage's
// slack is loaded into a per-thread buffer of kMaxStage floats, clipped to
// the box, put through each halfspace row in order and then each cone, and
// only then the pass takes the residuals or writes the updates.  The
// halfspace rows (a, a/||a||^2, b) and the cones' mu are small device arrays
// read through the cache by every thread alike; the cones' (start, dim)
// pairs ride in the kernel's parameters.  A side without projections keeps
// the row-by-row arithmetic of the box path.
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
  // floats between two groups' slices of wmin/wmax, lin and mu; 0: shared
  int box_stride, lin_stride, mu_stride;
};

// Fills one Side from the entry point's arguments (``soc``: n_soc (start,
// dim) pairs in host memory; ``grouped_*``: whether that array has a leading
// group axis) and refuses a layout the kernels would overrun.
inline bool init_side(Side& s, const float* wmin, const float* wmax,
                      const float* lin, int n_lin, const int* soc,
                      const float* mu, int n_soc, int dim, int n_stages,
                      int en_box, int grouped_box, int grouped_lin,
                      int grouped_mu) {
  s.wmin = wmin; s.wmax = wmax; s.lin = lin; s.mu = mu;
  s.dim = dim; s.n_stages = n_stages; s.n_lin = n_lin; s.n_soc = n_soc;
  s.en_box = en_box;
  s.box_stride = grouped_box ? dim * n_stages : 0;
  s.lin_stride = grouped_lin ? n_lin * (2 * dim + 1) : 0;
  s.mu_stride = grouped_mu ? n_soc : 0;
  if (n_lin < 0 || n_soc < 0 || n_soc > kMaxCones ||
      (n_lin > 0 && lin == nullptr) ||
      (n_soc > 0 && (soc == nullptr || mu == nullptr)) ||
      (n_lin + n_soc > 0 && dim > kMaxStage))
    return false;
  for (int c = 0; c < kMaxCones; ++c) {
    s.cone_start[c] = c < n_soc ? soc[2 * c] : 0;
    s.cone_dim[c] = c < n_soc ? soc[2 * c + 1] : 0;
    if (c < n_soc && (s.cone_start[c] < 0 || s.cone_dim[c] < 2 ||
                      s.cone_start[c] + s.cone_dim[c] > dim))
      return false;
  }
  return true;
}

template <class P>
__device__ __forceinline__ float relaxed(const P& p, bool relax, float w,
                                         float prev) {
  return relax ? __fadd_rn(__fmul_rn(p.alpha, w), __fmul_rn(p.one_m_alpha,
                                                            prev))
               : w;
}

// The slack of row r before the linear and cone projections: w_hat + dual
// (dual null: the state-free path, g == 0), clipped to the box.
__device__ __forceinline__ float row_slack(const Side& s, int g, int r,
                                           float wh, const float* dual,
                                           int o) {
  float v = dual ? __fadd_rn(wh, dual[o]) : wh;
  if (s.en_box) {
    const int b = g * s.box_stride + r;
    v = fminf(s.wmax[b], fmaxf(s.wmin[b], v));
  }
  return v;
}

// The projected slack of stage k: the box, then each halfspace row in order
// (w -= max(a.w - b, 0) a/||a||^2, the dot product summed in index order),
// then each cone (projections._project_soc_scaled), in the plain version's
// order of operations.
template <class P>
__device__ __forceinline__ void stage_slack(
    const P& p, const Side& s, int g, int k, bool relax, const float* ux,
    const float* prev, const float* dual, int lane, int T, float* w) {
  const int dim = s.dim;
  for (int j = 0; j < dim; ++j) {
    const int r = k * dim + j, o = r * p.B + lane;
    w[j] = row_slack(s, g, r, relaxed(p, relax, ux[r * T], prev[o]), dual, o);
  }
  for (int h = 0; h < s.n_lin; ++h) {
    const float* row = s.lin + g * s.lin_stride + h * (2 * dim + 1);
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
    const float mu = __ldg(s.mu + g * s.mu_stride + c);
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

}  // namespace tinympc
