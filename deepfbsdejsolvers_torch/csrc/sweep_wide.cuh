// What the wide compensator-sweep kernels share: B3 (sweep_wide_fwd.cu) and
// B4 (sweep_wide_bwd.cu) at every hidden width H in 1..128 other than the 8
// and 21 of the specialised kernels (sweep_fwd.cu, sweep_bwd.cu).
//
// The sweep (ops/sweep.py) is, per path b,
//   out_b = Σ_m Σ_k v[m,k]·tanh(Σ_h tanh(x_b·a[m,h] + c[m,h])·W1[h,k] + b1[k])
// with a, c, v (M, H) row-major per node and W1 (H, H) row-major (in, out).
//
// Padding.  Each kernel is built for a width class HP ∈ {32, 64, 128} and
// takes any H <= HP: W1, b1 and the node rows are staged in shared memory
// with zeros past H.  That is exact: a padded first-layer unit is tanh(0) = 0
// and feeds W1's zero rows, a padded second-layer unit is tanh(0) = 0 and is
// weighted by a zero v; the padded cotangents are computed and not written.
//
// Layout.  The hidden units are spread over a warp's lanes: lane l owns the
// U = HP / 32 units k = l + 32u, and a warp carries P = 16 / U paths at once,
// so each lane holds P·U = 16 values of a layer in registers at every width.
// W1 sits in shared memory with a row stride of HP + 1 floats, so both of
// its products read it without bank conflicts: lane l reading row h at
// column l + 32u (the forward, h1·W1) and row l + 32u at column k (the
// backward, W1·dz2).  A warp's h1 (and in B4 its dz2) of its P paths is
// staged in shared memory, where every lane reads it as float4 broadcasts.
//
// f32 throughout with the accurate tanhf and no fast-math flags.
#pragma once

#include "sweep_common.cuh"

namespace sweep_wide {

using sweep::kahan_add;

constexpr int WARP = 32;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * WARP;
constexpr int NODE_CHUNK = 16;  // node rows staged in shared memory at a time
constexpr unsigned FULL = 0xffffffffu;

// Shared-memory layout of width class HP, in floats: W1 (HP rows of LDW) |
// b1 (HP) | a, c, v of one chunk of nodes (NODE_CHUNK rows of HP each) |
// per warp its P staging rows of HP (h1; in B4 then dz2).  Every row that
// is read as float4s starts at a multiple of 4.
template <int HP>
struct Wide {
  static_assert(HP == 32 || HP == 64 || HP == 128, "width class");
  static constexpr int U = HP / WARP;      // units per lane
  static constexpr int P = 16 / U;         // paths per warp
  static constexpr int TILE = WARPS * P;   // paths per block
  static constexpr int LDW = HP + 1;
  static constexpr int W1 = 0;
  static constexpr int B1 = (HP * LDW + 3) / 4 * 4;
  static constexpr int A = B1 + HP;
  static constexpr int C = A + NODE_CHUNK * HP;
  static constexpr int V = C + NODE_CHUNK * HP;
  static constexpr int STAGE = V + NODE_CHUNK * HP;
};

// W1 and b1 of width h into shared memory, zero past h.
template <int HP>
__device__ __forceinline__ void load_weights(float* sm,
                                             const float* __restrict__ w1,
                                             const float* __restrict__ b1,
                                             int h) {
  using L = Wide<HP>;
  for (int q = threadIdx.x; q < HP * HP; q += blockDim.x) {
    const int row = q / HP, col = q % HP;
    sm[L::W1 + row * L::LDW + col] =
        (row < h && col < h) ? __ldg(w1 + row * h + col) : 0.0f;
  }
  for (int q = threadIdx.x; q < HP; q += blockDim.x)
    sm[L::B1 + q] = q < h ? __ldg(b1 + q) : 0.0f;
}

// Rows m0 .. m0 + count - 1 of a, c and v into the chunk slots; the slots
// past ``count`` and the columns past h are zero.
template <int HP>
__device__ __forceinline__ void load_chunk(float* sm,
                                           const float* __restrict__ a,
                                           const float* __restrict__ c,
                                           const float* __restrict__ v,
                                           int m0, int count, int h) {
  using L = Wide<HP>;
  constexpr int ROWS = NODE_CHUNK * HP;
  for (int q = threadIdx.x; q < 3 * ROWS; q += blockDim.x) {
    const int which = q / ROWS, r = (q / HP) % NODE_CHUNK, col = q % HP;
    const float* src = which == 0 ? a : which == 1 ? c : v;
    sm[L::A + q] = (r < count && col < h)
                       ? __ldg(src + (size_t)(m0 + r) * h + col)
                       : 0.0f;
  }
}

// h1[p][u] = tanh(x[p]·a[k] + c[k]) at node row r for this lane's units
// k = lane + 32u, also written to the warp's staging rows ``stage`` (P rows
// of HP).
template <int HP>
__device__ __forceinline__ void first_layer(
    const float* sm, int r, int lane, const float (&x)[Wide<HP>::P],
    float (&h1)[Wide<HP>::P][Wide<HP>::U], float* stage) {
  using L = Wide<HP>;
#pragma unroll
  for (int u = 0; u < L::U; ++u) {
    const int k = lane + WARP * u;
    const float ak = sm[L::A + r * HP + k], ck = sm[L::C + r * HP + k];
#pragma unroll
    for (int p = 0; p < L::P; ++p) {
      h1[p][u] = tanhf(x[p] * ak + ck);
      stage[p * HP + k] = h1[p][u];
    }
  }
}

// z[p][u] = b1[k] + Σ_h h1[p][h]·W1[h][k] for this lane's units, summed over
// h in order, with h1 read from the warp's staging rows.
template <int HP>
__device__ __forceinline__ void second_layer(
    const float* sm, int lane, const float* stage,
    float (&z)[Wide<HP>::P][Wide<HP>::U]) {
  using L = Wide<HP>;
#pragma unroll
  for (int u = 0; u < L::U; ++u)
#pragma unroll
    for (int p = 0; p < L::P; ++p) z[p][u] = sm[L::B1 + lane + WARP * u];
#pragma unroll 2
  for (int q = 0; q < HP / 4; ++q) {
    float4 hv[L::P];
#pragma unroll
    for (int p = 0; p < L::P; ++p) hv[p] = quad(stage + p * HP, q);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* wrow = sm + L::W1 + (4 * q + j) * L::LDW + lane;
#pragma unroll
      for (int u = 0; u < L::U; ++u) {
        const float w = wrow[WARP * u];
#pragma unroll
        for (int p = 0; p < L::P; ++p) z[p][u] += lane_of(hv[p], j) * w;
      }
    }
  }
}

// Σ over the warp's lanes, the same fixed butterfly on every call.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = WARP / 2; off > 0; off /= 2)
    v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// The width class of hidden width h: the least of 32, 64, 128 that holds it,
// or 0 when none does.
inline int width_class(int h) {
  return h < 1 ? 0 : h <= 32 ? 32 : h <= 64 ? 64 : h <= 128 ? 128 : 0;
}

}  // namespace sweep_wide
