// Per-path arithmetic shared by the fused rollout kernels B1
// (rollout_fwd.cu) and B2 (rollout_bwd.cu): the walk update, the piece
// lookup and the Clenshaw evaluations of the hoisted piecewise Chebyshev
// tables, and the Γ head's hidden layers.  Every function here works on one
// path in registers; the head's weights sit in shared memory.
//
// f32 throughout, IEEE division and the accurate tanhf/expf: the kernels are
// built without fast-math flags, and the port's parity tolerances (loss rel
// 1e-5 against the plain PyTorch loop) leave no room for approximate
// transcendentals.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "quad.cuh"

namespace rollout {

// Chebyshev coefficients per piece (the tables' degree is 7).
constexpr int D = 8;

// x rounded to TF32 (10 mantissa bits, to nearest, ties away from zero, in
// two integer operations on finite x), as tc_split.cuh's split_tf32 forms
// its hi part.  In the head-TF32 mode (the template flag TF of the kernels,
// ops/rollout.py ``head_precision="default"``) every operand of the Γ head's
// H×H products is rounded so before it is multiplied, and the sums stay in
// f32: the products of two TF32 values are exact in f32, so a kernel and
// its plain version differ only in their order of summation.
__device__ __forceinline__ float tf32_round(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

// A first-layer unit's pre-activation t·wt + x·wx + j·wj + b in the
// head-TF32 mode, where h1 is rounded to TF32 and a last-bit difference of
// h1 becomes one of 2^-11: formed product by product and sum by sum, each
// rounded and none fused, as the plain version forms it elementwise
// (ops/rollout.py ``gamma_head``), so that both see the same h1 at the same
// inputs.
__device__ __forceinline__ float first_sum_tf32(float wt, float wx, float wj,
                                                float b, float ti, float x,
                                                float j) {
  return __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(wt, ti), __fmul_rn(wx, x)),
                __fmul_rn(wj, j)),
      b);
}

// Model constants baked into both kernels (ops/rollout.py KernelSpec).
struct Consts {
  float time_scale;  // time feature = step index * time_scale
  float growth;      // 1 + r dt: y - f(y) dt with f(y) = -r y
  float a_lin;       // coupling aLin |y - A|
  float dt;
  float sigma;
  float drift;       // uncoupled log-increment = drift + sigma dW + J
};

// e^u - 1: degree-7 Taylor (exactly rounded mul/add) on |u| < 0.125, the
// same polynomial as ops/numerics.expm1_acc.
__device__ __forceinline__ float expm1_acc(float u) {
  if (fabsf(u) < 0.125f) {
    float p = u / 7.0f;
    p = (1.0f + p) * u / 6.0f;
    p = (1.0f + p) * u / 5.0f;
    p = (1.0f + p) * u / 4.0f;
    p = (1.0f + p) * u / 3.0f;
    p = (1.0f + p) * u / 2.0f;
    return u * (1.0f + p);
  }
  return expf(u) - 1.0f;
}

// Piece index k, local coordinate t in [-1, 1] and dt/dx of x on the step's
// interval [lo, hi] split into p pieces.  Outside the interval x clamps to
// the edge and dt/dx is 0 (ops/piecewise.pw_eval_with_deriv).  A NaN x
// lands in piece 0, never out of bounds.
struct Piece {
  int k;
  float t;
  float dtdx;
};

__device__ __forceinline__ Piece locate(float x, float lo, float hi, int p) {
  const float span = fmaxf(hi - lo, 1e-6f);
  const float s_raw = (x - lo) / span;
  const float s = fminf(fmaxf(s_raw, 0.0f), 1.0f) * (float)p;
  const float kf = fminf(fmaxf(floorf(s), 0.0f), (float)(p - 1));
  Piece r;
  r.k = (int)kf;
  r.t = 2.0f * (s - kf) - 1.0f;
  r.dtdx = (s_raw >= 0.0f && s_raw <= 1.0f) ? (2.0f * (float)p / span) : 0.0f;
  return r;
}

// sum_k c[k] T_k(t) by Clenshaw over one piece's D coefficients.
__device__ __forceinline__ float clenshaw(const float* __restrict__ c,
                                          float t) {
  float b1 = 0.0f, b2 = 0.0f;
#pragma unroll
  for (int k = D - 1; k > 0; --k) {
    const float nb = __ldg(c + k) + 2.0f * t * b1 - b2;
    b2 = b1;
    b1 = nb;
  }
  return __ldg(c) + t * b1 - b2;
}

// (value, d/dt value) of the same series.
__device__ __forceinline__ float clenshaw_deriv(const float* __restrict__ c,
                                                float t, float* dval) {
  float b1 = 0.0f, b2 = 0.0f, db1 = 0.0f, db2 = 0.0f;
#pragma unroll
  for (int k = D - 1; k > 0; --k) {
    const float nb = __ldg(c + k) + 2.0f * t * b1 - b2;
    const float ndb = 2.0f * b1 + 2.0f * t * db1 - db2;
    b2 = b1;
    b1 = nb;
    db2 = db1;
    db1 = ndb;
  }
  *dval = b1 + t * db1 - db2;
  return __ldg(c) + t * b1 - b2;
}

// Shared-memory layout of the Γ head's weights, (in, out) row-major as in
// the JAX parameter tree, every row padded with zeros to HP, a multiple of
// 4 floats: W1 (3 rows: t, x, J) | b1 | W2 (H rows, one per input) | b2 |
// W3.  A row is read as float4s that every thread of a warp reads at once
// (a broadcast): W2ᵀ·h1 walks the inputs h and reads row h's output quads,
// W2·dp2 walks the outputs of row h, so one layout serves both products.
// The output bias b3 is folded into the compensator table's T_0
// coefficients by the caller.  With TF (the head-TF32 mode) W2 is rounded
// to TF32 as it is loaded.
template <int H>
struct Head {
  static constexpr int HP = (H + 3) / 4 * 4;
  static constexpr int QUADS = HP / 4;
  static constexpr int W1 = 0;
  static constexpr int B1 = 3 * HP;
  static constexpr int W2 = 4 * HP;
  static constexpr int B2 = W2 + H * HP;
  static constexpr int W3 = B2 + HP;
  static constexpr int SIZE = W3 + HP;
};

template <int H, bool TF = false>
__device__ __forceinline__ void load_head(float* sw, const float* w1,
                                          const float* b1, const float* w2,
                                          const float* b2, const float* w3) {
  using L = Head<H>;
  for (int q = threadIdx.x; q < L::SIZE; q += blockDim.x) {
    const int row = q / L::HP, col = q % L::HP;
    float v = 0.0f;
    if (col < H) {
      if (row < 3) v = w1[row * H + col];
      else if (row == 3) v = b1[col];
      else if (row < 4 + H) {
        v = w2[(row - 4) * H + col];
        if constexpr (TF) v = tf32_round(v);
      }
      else if (row == 4 + H) v = b2[col];
      else v = w3[col];
    }
    sw[q] = v;
  }
}

// The Γ head's first layer at (t_i, x, j): h1 = tanh(W1ᵀ [t_i, x, j] + b1).
template <int H, bool TF = false>
__device__ __forceinline__ void first_layer(const float* sw, float ti,
                                            float x, float j, float* h1) {
  using L = Head<H>;
#pragma unroll
  for (int q = 0; q < L::QUADS; ++q) {
    const float4 wt = quad(sw + L::W1, q), wx = quad(sw + L::W1 + L::HP, q),
                 wj = quad(sw + L::W1 + 2 * L::HP, q),
                 bq = quad(sw + L::B1, q);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int h = 4 * q + k;
      if (h < H)
        h1[h] = TF ? tanhf(first_sum_tf32(lane_of(wt, k), lane_of(wx, k),
                                          lane_of(wj, k), lane_of(bq, k), ti,
                                          x, j))
                   : tanhf(lane_of(wt, k) * ti + lane_of(wx, k) * x +
                           lane_of(wj, k) * j + lane_of(bq, k));
    }
  }
}

// Quad q of the second layer: h2[4q + k] = tanh(Σ_h h1[h]·W2[h, 4q + k] +
// b2[4q + k]), each sum over h in order from a zero start, for the k with
// 4q + k < H.  One float4 read of W2 feeds four FMAs.  With TF each h1[h]
// enters rounded to TF32 (W2 was rounded at its load), h1 itself unchanged.
template <int H, bool TF = false>
__device__ __forceinline__ void second_layer_quad(const float* sw,
                                                  const float* h1, int q,
                                                  float (&h2)[4]) {
  using L = Head<H>;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const float4 w = quad(sw + L::W2 + h * L::HP, q);
    float hv = h1[h];
    if constexpr (TF) hv = tf32_round(hv);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (4 * q + k < H) acc[k] += hv * lane_of(w, k);
  }
  const float4 bq = quad(sw + L::B2, q);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (4 * q + k < H) h2[k] = tanhf(acc[k] + lane_of(bq, k));
}

}  // namespace rollout
