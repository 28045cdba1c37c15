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
// (sweep_wide.cuh) and takes any H <= HP: the head's weights are zero past
// H.  That is exact: a padded first-layer unit is tanh(0) = 0 and feeds
// W2's zero rows, a padded second-layer unit is tanh(0) = 0 and is weighted
// by a zero W3; the padded cotangents are computed and never written.
//
// Layout.  The hidden units are spread over a warp's lanes as in the wide
// sweep: lane l owns the U = HP / 32 units k = l + 32u, and a warp carries
// P = 16 / U paths, so a lane holds P·U = 16 values of a layer at every
// width.  The SPAN = 32 / P lanes l with l / SPAN == p carry path p: each
// of them holds its carries (x, y; in B2 also x̄, ȳ) and does its scalar
// work (the piece lookup, the Clenshaw evaluations, the walk) in step, so
// a path's scalars cost what one path a thread costs; the first of them
// reads and writes device memory.  W2 and b2 sit in dynamic shared memory
// in sweep_wide::load_weights' layout (rows of HP + 1 floats, so h1·W2 and
// W2·dp2 both read it without bank conflicts), and second_layer forms
// h1·W2 + b2 from the warp's staged h1.  The first layer's rows (t, x, J),
// b1, b2 and W3 of a lane's units sit in its registers.  The walk is the
// specialised kernels' own (rollout_common.cuh), bit for bit; the hidden
// layers and Γ are summed in the order of the plain version's matmuls.
//
// f32 throughout with the accurate tanhf/expf and no fast-math flags.
#pragma once

#include "rollout_common.cuh"
#include "sweep_wide.cuh"

namespace rollout_wide {

using rollout::D;
using rollout::Piece;
using sweep_wide::FULL;
using sweep_wide::THREADS;
using sweep_wide::WARP;
using sweep_wide::WARPS;
using sweep_wide::width_class;

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
  return (h == 8 || h == 21) ? 0 : width_class(h);
}

template <int HP>
struct Lanes {
  using L = sweep_wide::Wide<HP>;
  static constexpr int U = L::U;        // units per lane
  static constexpr int P = L::P;        // paths per warp
  static constexpr int TILE = L::TILE;  // paths per block
  static constexpr int SPAN = WARP / P; // lanes per path
  static constexpr int LDW = L::LDW;
  // W2 (HP rows of LDW) at 0 and b2 at L::B1, as sweep_wide::load_weights
  // lays out its matrix and bias; then the block's staged h1 rows
  static constexpr int H1S = L::B1 + HP;
  static_assert(H1S % 4 == 0, "staged rows are read as float4s");
};

// The first layer's rows t, x, J, b1, b2 and W3 at the lane's units k =
// lane + 32u, zero past h.
template <int U>
struct Units {
  float wt[U], wx[U], wj[U], b1[U], b2[U], w3[U];

  __device__ __forceinline__ void load(const float* __restrict__ w1,
                                       const float* __restrict__ b1_,
                                       const float* __restrict__ b2_,
                                       const float* __restrict__ w3_, int h,
                                       int lane) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = lane + WARP * u;
      const bool in = k < h;
      wt[u] = in ? __ldg(w1 + k) : 0.0f;
      wx[u] = in ? __ldg(w1 + h + k) : 0.0f;
      wj[u] = in ? __ldg(w1 + 2 * h + k) : 0.0f;
      b1[u] = in ? __ldg(b1_ + k) : 0.0f;
      b2[u] = in ? __ldg(b2_ + k) : 0.0f;
      w3[u] = in ? __ldg(w3_ + k) : 0.0f;
    }
  }
};

// v[p] of lane ``lane`` for each of the warp's P paths: the value that the
// path's first lane holds.
template <int P>
__device__ __forceinline__ void gather_paths(float v, float (&out)[P]) {
  constexpr int SPAN = WARP / P;
#pragma unroll
  for (int p = 0; p < P; ++p) out[p] = __shfl_sync(FULL, v, p * SPAN);
}

// h1[p][u] = tanh(t·W1[t, k] + x_p·W1[x, k] + J_p·W1[J, k] + b1[k]) at the
// lane's units, in the sum order of rollout::first_layer, written to the
// warp's staging rows ``stage`` (P rows of HP); returns them too.
template <int HP>
__device__ __forceinline__ void first_layer(
    const Units<Lanes<HP>::U>& w, float ti, const float (&x)[Lanes<HP>::P],
    const float (&j)[Lanes<HP>::P], int lane,
    float (&h1)[Lanes<HP>::P][Lanes<HP>::U], float* stage) {
  using L = Lanes<HP>;
#pragma unroll
  for (int u = 0; u < L::U; ++u)
#pragma unroll
    for (int p = 0; p < L::P; ++p) {
      h1[p][u] = tanhf(w.wt[u] * ti + w.wx[u] * x[p] + w.wj[u] * j[p] +
                       w.b1[u]);
      stage[p * HP + lane + WARP * u] = h1[p][u];
    }
}

// z[p][u] = Σ_h h1[p][h]·W2[h][k] + b2[k] at the lane's units, the sum over
// h in order from zero and the bias added last, as the plain version's
// matmul and add round it; h1 is read from the warp's staging rows as
// float4 broadcasts and W2 from shared memory (rows of LDW: lane l reads
// bank h + l, no conflicts).
template <int HP>
__device__ __forceinline__ void second_layer(
    const float* sm, const Units<Lanes<HP>::U>& w, int lane,
    const float* stage, float (&z)[Lanes<HP>::P][Lanes<HP>::U]) {
  using L = Lanes<HP>;
#pragma unroll
  for (int u = 0; u < L::U; ++u)
#pragma unroll
    for (int p = 0; p < L::P; ++p) z[p][u] = 0.0f;
#pragma unroll 2
  for (int q = 0; q < HP / 4; ++q) {
    float4 hv[L::P];
#pragma unroll
    for (int p = 0; p < L::P; ++p) hv[p] = quad(stage + p * HP, q);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* wrow = sm + (4 * q + j) * L::LDW + lane;
#pragma unroll
      for (int u = 0; u < L::U; ++u) {
        const float wv = wrow[WARP * u];
#pragma unroll
        for (int p = 0; p < L::P; ++p) z[p][u] += lane_of(hv[p], j) * wv;
      }
    }
  }
#pragma unroll
  for (int u = 0; u < L::U; ++u)
#pragma unroll
    for (int p = 0; p < L::P; ++p) z[p][u] += w.b2[u];
}

// The halving stages of warp_sum_paths, from HALF live values at lane bit
// BIT down to one.
template <int HALF, int BIT, int P>
__device__ __forceinline__ void halve_paths(float (&v)[P], int lane) {
  if constexpr (HALF >= 1) {
    const bool upper = (lane & BIT) != 0;
#pragma unroll
    for (int i = 0; i < HALF; ++i) {
      const float send = upper ? v[i] : v[i + HALF];
      const float keep = upper ? v[i + HALF] : v[i];
      v[i] = keep + __shfl_xor_sync(FULL, send, BIT);
    }
    halve_paths<HALF / 2, BIT / 2>(v, lane);
  }
}

// Σ over the warp's lanes of v[p], for each of its P paths, returned in the
// lanes that carry path p (lane / SPAN == p): log2 P halving stages, in
// which the lanes whose bit BIT is set keep the upper half of the live
// values and the others the lower half, each adding its partner's copy of
// the half it keeps; then a butterfly over the SPAN lanes of a path.  The
// same fixed tree on every call, and every lane of a path ends with the
// same bits (float addition commutes).
template <int P>
__device__ __forceinline__ float warp_sum_paths(float (&v)[P], int lane) {
  halve_paths<P / 2, WARP / 2>(v, lane);
  float s = v[0];
#pragma unroll
  for (int bit = WARP / P / 2; bit >= 1; bit /= 2)
    s += __shfl_xor_sync(FULL, s, bit);
  return s;
}

}  // namespace rollout_wide
