// Per-path arithmetic shared by the compensator-sweep kernels B3
// (sweep_fwd.cu) and B4 (sweep_bwd.cu): staging the head's second layer and
// a chunk of node rows in shared memory, and one node's hidden layers for
// one path in registers.
//
// The sweep (ops/sweep.py) is, per path b,
//   out_b = Σ_m Σ_k v[m,k]·tanh(Σ_h tanh(x_b·a[m,h] + c[m,h])·W1[h,k] + b1[k])
// with a, c, v (M, H) row-major per node and W1 (H, H) row-major (in, out).
//
// Every row in shared memory is padded to HP, a multiple of 4 floats, with
// zeros, so a thread reads it as float4s: all threads of a block read the
// same row at once (a broadcast), and one 16-byte load feeds four FMAs.
// Sums over the nodes are compensated (kahan_add), since M reaches 5000.
//
// f32 throughout with the accurate tanhf, no fast-math flags: the port's
// parity tolerances leave no room for approximate transcendentals.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace sweep {

constexpr int THREADS = 128;   // paths per block (ops/sweep.py _THREADS)
constexpr int NODE_CHUNK = 16; // node rows staged in shared memory at a time

template <int H>
struct Pad {
  static constexpr int HP = (H + 3) / 4 * 4;
};

// Shared-memory layout, in floats: W1 (H rows of HP) | b1 (HP) | a, c, v of
// one chunk of nodes (NODE_CHUNK rows of HP each).  Every offset is a
// multiple of 4.
template <int H>
struct Stage {
  static constexpr int HP = Pad<H>::HP;
  static constexpr int W1 = 0;
  static constexpr int B1 = H * HP;
  static constexpr int A = B1 + HP;
  static constexpr int C = A + NODE_CHUNK * HP;
  static constexpr int V = C + NODE_CHUNK * HP;
  static constexpr int SIZE = V + NODE_CHUNK * HP;
};

template <int H>
__device__ __forceinline__ void load_weights(float* sm,
                                             const float* __restrict__ w1,
                                             const float* __restrict__ b1) {
  using S = Stage<H>;
  for (int q = threadIdx.x; q < S::A; q += blockDim.x) {
    const int row = q / S::HP, col = q % S::HP;
    float val = 0.0f;
    if (col < H) val = row < H ? __ldg(w1 + row * H + col) : __ldg(b1 + col);
    sm[q] = val;
  }
}

// Rows m0 .. m0 + count - 1 of a, c and v into the chunk slots; the slots
// past ``count`` and the padding columns are zero.
template <int H>
__device__ __forceinline__ void load_chunk(float* sm,
                                           const float* __restrict__ a,
                                           const float* __restrict__ c,
                                           const float* __restrict__ v,
                                           int m0, int count) {
  using S = Stage<H>;
  constexpr int ROWS = NODE_CHUNK * S::HP;
  for (int q = threadIdx.x; q < 3 * ROWS; q += blockDim.x) {
    const int which = q / ROWS, r = (q / S::HP) % NODE_CHUNK,
              col = q % S::HP;
    const float* src = which == 0 ? a : which == 1 ? c : v;
    sm[S::A + q] = (r < count && col < H)
                       ? __ldg(src + (size_t)(m0 + r) * H + col)
                       : 0.0f;
  }
}

// sum += v with Kahan's compensation in ``comp``: a sum over thousands of
// nodes in order keeps the accuracy of the plain version's reduction (a
// plain f32 running sum over 5000 nodes does not).  No fast-math flag lets
// the compiler reassociate it away.
__device__ __forceinline__ void kahan_add(float& sum, float& comp, float v) {
  const float y = v - comp;
  const float t = sum + y;
  comp = (t - sum) - y;
  sum = t;
}

// The HP floats of a padded shared-memory row into registers.
template <int H>
__device__ __forceinline__ void load_row(const float* s, float* r) {
  const float4* s4 = reinterpret_cast<const float4*>(s);
#pragma unroll
  for (int q = 0; q < Pad<H>::HP / 4; ++q) {
    const float4 t = s4[q];
    r[4 * q] = t.x;
    r[4 * q + 1] = t.y;
    r[4 * q + 2] = t.z;
    r[4 * q + 3] = t.w;
  }
}

// Node ``r`` of the staged chunk at path value x: h1 = tanh(x·a + c) and the
// second layer's pre-activation z = b1 + h1·W1.
template <int H>
__device__ __forceinline__ void hidden(const float* sm, int r, float x,
                                       float* h1, float* z) {
  using S = Stage<H>;
  float ra[S::HP], rc[S::HP], w[S::HP];
  load_row<H>(sm + S::A + r * S::HP, ra);
  load_row<H>(sm + S::C + r * S::HP, rc);
#pragma unroll
  for (int h = 0; h < H; ++h) h1[h] = tanhf(x * ra[h] + rc[h]);
  load_row<H>(sm + S::B1, w);
#pragma unroll
  for (int k = 0; k < H; ++k) z[k] = w[k];
#pragma unroll
  for (int h = 0; h < H; ++h) {
    load_row<H>(sm + S::W1 + h * S::HP, w);
#pragma unroll
    for (int k = 0; k < H; ++k) z[k] += h1[h] * w[k];
  }
}

}  // namespace sweep
