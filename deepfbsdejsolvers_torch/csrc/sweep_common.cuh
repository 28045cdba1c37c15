// Arithmetic shared by the compensator-sweep kernels B3 (sweep_fwd.cu) and
// B4 (sweep_bwd.cu): staging the head's second layer and a chunk of node rows
// in shared memory, and one node's hidden layers for several paths per
// thread in registers; and the fixed-order sum of B4's per-block partials,
// which the wide kernels (sweep_wide.cuh) share.
//
// The sweep (ops/sweep.py) is, per path b,
//   out_b = Σ_m Σ_k v[m,k]·tanh(Σ_h tanh(x_b·a[m,h] + c[m,h])·W1[h,k] + b1[k])
// with a, c, v (M, H) row-major per node and W1 (H, H) row-major (in, out).
//
// Every row in shared memory is padded to HP, a multiple of 4 floats, with
// zeros, so a thread reads it as float4s: all threads of a block read the
// same row at once (a broadcast).  Each thread carries P paths, so one
// 16-byte load feeds 4·P FMAs: the loads per path-node fall P-fold against
// one path per thread, and the FP32 work stays what it was.  Sums over the
// nodes are compensated (kahan_add), since M reaches 5000.
//
// f32 throughout with the accurate tanhf, no fast-math flags: the port's
// parity tolerances leave no room for approximate transcendentals.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "quad.cuh"

namespace sweep {

constexpr int THREADS = 128;   // threads per block of both kernels
constexpr int WARP = 32;
constexpr int NODE_CHUNK = 16; // node rows staged in shared memory at a time

// Shared-memory layout, in floats: W1 (H rows of HP) | b1 (HP) | a, c, v of
// one chunk of nodes (NODE_CHUNK rows of HP each).  Every offset is a
// multiple of 4.
template <int H>
struct Stage {
  static constexpr int HP = (H + 3) / 4 * 4;
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

// The first layer at node ``r`` of the staged chunk for P paths:
// h1[p][h] = tanh(x[p]·a[h] + c[h]).
template <int H, int P>
__device__ __forceinline__ void first_layer(const float* sm, int r,
                                            const float (&x)[P],
                                            float (&h1)[P][H]) {
  using S = Stage<H>;
  const float* ra = sm + S::A + r * S::HP;
  const float* rc = sm + S::C + r * S::HP;
#pragma unroll
  for (int q = 0; q < S::HP / 4; ++q) {
    const float4 a4 = quad(ra, q), c4 = quad(rc, q);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int h = 4 * q + j;
      if (h < H) {
#pragma unroll
        for (int p = 0; p < P; ++p)
          h1[p][h] = tanhf(x[p] * lane_of(a4, j) + lane_of(c4, j));
      }
    }
  }
}

// Quad q of the second layer's pre-activation z = b1 + h1·W1 for P paths:
// z[p][j] is column 4q + j of path p, summed over h in order.  Callers walk
// q over the HP / 4 quads, so each W1 quad read feeds 4·P FMAs and only 4·P
// sums are live beside h1.
template <int H, int P>
__device__ __forceinline__ void second_layer_quad(const float* sm,
                                                  const float (&h1)[P][H],
                                                  int q, float (&z)[P][4]) {
  using S = Stage<H>;
  const float4 b4 = quad(sm + S::B1, q);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    z[p][0] = b4.x;
    z[p][1] = b4.y;
    z[p][2] = b4.z;
    z[p][3] = b4.w;
  }
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const float4 w4 = quad(sm + S::W1 + h * S::HP, q);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      z[p][0] += h1[p][h] * w4.x;
      z[p][1] += h1[p][h] * w4.y;
      z[p][2] += h1[p][h] * w4.z;
      z[p][3] += h1[p][h] * w4.w;
    }
  }
}

constexpr int REDUCE_THREADS = 256;

// out[q] = sum over blocks of part[block][q], in block order.
__global__ void __launch_bounds__(REDUCE_THREADS)
reduce_partials(const float* __restrict__ part, float* __restrict__ out,
                int n_blocks, int n_out) {
  const int q = blockIdx.x * REDUCE_THREADS + threadIdx.x;
  if (q >= n_out) return;
  float s = 0.0f;
  for (int k = 0; k < n_blocks; ++k) s += __ldg(part + (size_t)k * n_out + q);
  out[q] = s;
}

}  // namespace sweep
