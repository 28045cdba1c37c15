// What the wide fused-rollout kernels share: B1w (rollout_wide_fwd.cu) and
// B2w (rollout_wide_bwd.cu) at every hidden width H in 1..128 other than the
// 8 and 21 of the specialised kernels (rollout_fwd.cu, rollout_bwd.cu).
//
// Why the specialised layout does not stretch: B1/B2 run one thread per
// path with the head's hidden activations in its registers (float h1[H]),
// which at H = 128 alone would take 128 registers, and B2 stages a whole
// [h1; 1; x; J] × [dp2; dp1] row set per warp.
//
// Padding.  Each kernel is built for a width class HP ∈ {32, 64, 128}
// (tc_split.cuh) and takes any H <= HP: the head's weights are zero past H.
// That is exact: a padded first-layer unit is tanh(0) = 0 and feeds W2's
// zero rows, a padded second-layer unit is tanh(0) = 0 and is weighted by a
// zero W3; the padded cotangents are computed and never written.
//
// Layouts.  The head is 3 → H → H → 1 (inputs t, x, J).  B2w runs its
// three H×H products on the tensor cores in split TF32 in the m16 layout of
// tc_split.cuh: a warp carries 16 paths, one m16 tile, a block of eight
// warps 128, and lane (g, t) computes the first layer of paths g and g + 8
// at its units 8k + 2t, 8k + 2t + 1 (``first_unit`` from the packed rows t,
// x, J and b1 of ``load_first_layer``), the A layout of h1·W2, where the
// second layer's accumulators come out at the same units.  B1w sums its
// one product in FP32 in the plain version's order, the hidden units
// spread over a warp's lanes (its own layout, rollout_wide_fwd.cu: why
// there), in both instances.
//
// Scalar work in B2w.  Each path's scalar work (the piece lookup, the
// Clenshaw evaluations with derivatives, the adjoint recurrence) runs on
// the lanes of its row group: lane (g, t) carries path g + 8·(t & 1), so
// lanes t = 0, 2 carry path g and t = 1, 3 path g + 8, in step, the first
// two of them reading and writing memory.  All 32 lanes run the same
// instruction stream either way, so splitting a row group's two paths
// between its lanes pays each warp's scalar work once per 16 paths (where
// every lane doing both of its paths would pay it twice); the first layer
// then takes the x, J and ḡ of both paths from lanes 4g and 4g + 1 by
// shuffles.  The walk is the specialised kernels' own (rollout_common.cuh),
// bit for bit, in both kernels.
//
// f32 throughout outside the products, with the accurate tanhf/expf and no
// fast-math flags.
#pragma once

#include "rollout_common.cuh"
#include "sweep_common.cuh"
#include "tc_split.cuh"

namespace rollout_wide {

using rollout::D;
using rollout::Piece;
using tc::FULL;
using tc::Mma;
using tc::THREADS;
using tc::WARP;
using tc::WARPS;

// The model constants baked into both kernels: rollout::Consts', but with
// r·dt where it holds 1 + r·dt, so that y·(1 + r dt) is formed as
// y + y·(r dt) (ops/rollout.py KernelSpec.scalars).  Rounded to f32,
// 1 + r dt is off by up to 6e-8 relative, the same way at every step and
// path; over N steps that offsets y_N for every path alike, and the loss's
// gradient, a sum over paths of y_N − g(x_N) that largely cancels,
// magnifies the offset past the checks' tolerance.  r dt rounds at the
// scale of the increment.
struct Consts {
  float time_scale;
  float r_dt;
  float a_lin;
  float dt;
  float sigma;
  float drift;
};

// The width class of hidden width h for these kernels: that of the wide
// sweep, but 0 at the specialised kernels' 8 and 21, which they refuse.
inline int wide_width_class(int h) {
  return (h == 8 || h == 21) ? 0 : tc::width_class(h);
}

// The first layer's rows t, x, J and b1 of width h (zero past h) into
// ``dst`` packed per 8-unit block k and lane column t (u = 8k + 2t): the
// float4s (W1[t][u], W1[t][u + 1], W1[x][u], W1[x][u + 1]) and (W1[J][u],
// W1[J][u + 1], b1[u], b1[u + 1]) at float4 index 2·(4k + t) and the next,
// 4·HP floats in all; the four columns t of a warp read distinct
// consecutive float4s, its row groups the same ones (a broadcast).
template <int HP>
__device__ __forceinline__ void load_first_layer(float* dst,
                                                 const float* __restrict__ w1,
                                                 const float* __restrict__ b1,
                                                 int h) {
  float4* out = reinterpret_cast<float4*>(dst);
  for (int q = threadIdx.x; q < HP / 2; q += blockDim.x) {
    const int u = 2 * q;  // q = 4k + t
    float v[8];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const bool in = u + j < h;
      v[j] = in ? __ldg(w1 + u + j) : 0.0f;
      v[2 + j] = in ? __ldg(w1 + h + u + j) : 0.0f;
      v[4 + j] = in ? __ldg(w1 + 2 * h + u + j) : 0.0f;
      v[6 + j] = in ? __ldg(b1 + u + j) : 0.0f;
    }
    out[2 * q] = make_float4(v[0], v[1], v[2], v[3]);
    out[2 * q + 1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// One first-layer unit, tanh(t·W1[t] + x·W1[x] + J·W1[J] + b1), in the sum
// order of rollout::first_layer (with TF, of rollout::first_sum_tf32).
template <bool TF>
__device__ __forceinline__ float first_unit(float wt, float wx, float wj,
                                            float b, float ti, float x,
                                            float j) {
  if constexpr (TF)
    return tanhf(rollout::first_sum_tf32(wt, wx, wj, b, ti, x, j));
  else
    return tanhf(wt * ti + wx * x + wj * j + b);
}

// v of paths g and g + 8 of lane ``lane``'s row group (B2w's layout): the
// values of lanes 4g and 4g + 1, which carry them.
__device__ __forceinline__ void row_pair(float v, int lane, float (&out)[2]) {
  const int src = lane & ~3;
  out[0] = __shfl_sync(FULL, v, src);
  out[1] = __shfl_sync(FULL, v, src + 1);
}

}  // namespace rollout_wide
