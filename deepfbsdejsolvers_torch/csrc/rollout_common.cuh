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

namespace rollout {

// Chebyshev coefficients per piece (the tables' degree is 7).
constexpr int D = 8;

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
// the JAX parameter tree: W1 (3, H) | b1 (H) | W2 (H, H) | b2 (H) | W3 (H).
// The output bias b3 is folded into the compensator table's T_0
// coefficients by the caller.
template <int H>
struct Head {
  static constexpr int W1 = 0;
  static constexpr int B1 = 3 * H;
  static constexpr int W2 = 4 * H;
  static constexpr int B2 = 4 * H + H * H;
  static constexpr int W3 = 5 * H + H * H;
  static constexpr int SIZE = 6 * H + H * H;
};

template <int H>
__device__ __forceinline__ void load_head(float* sw, const float* w1,
                                          const float* b1, const float* w2,
                                          const float* b2, const float* w3) {
  using L = Head<H>;
  for (int q = threadIdx.x; q < L::SIZE; q += blockDim.x) {
    float v;
    if (q < L::B1) v = w1[q];
    else if (q < L::W2) v = b1[q - L::B1];
    else if (q < L::B2) v = w2[q - L::W2];
    else if (q < L::W3) v = b2[q - L::B2];
    else v = w3[q - L::W3];
    sw[q] = v;
  }
}

// Hidden activations of the Γ head at (t_i, x, j):
// h1 = tanh(W1ᵀ [t_i, x, j] + b1), h2 = tanh(W2ᵀ h1 + b2).
template <int H>
__device__ __forceinline__ void hidden_layers(const float* sw, float ti,
                                              float x, float j, float* h1,
                                              float* h2) {
  using L = Head<H>;
#pragma unroll
  for (int h = 0; h < H; ++h) {
    h1[h] = tanhf(sw[L::W1 + h] * ti + sw[L::W1 + H + h] * x +
                  sw[L::W1 + 2 * H + h] * j + sw[L::B1 + h]);
  }
#pragma unroll
  for (int o = 0; o < H; ++o) {
    float acc = 0.0f;
#pragma unroll
    for (int h = 0; h < H; ++h) acc += h1[h] * sw[L::W2 + h * H + o];
    h2[o] = tanhf(acc + sw[L::B2 + o]);
  }
}

}  // namespace rollout
