// Kernel B3: the forward of the compensator sweep (ops/sweep.py),
//   out_b = Σ_m Σ_k v[m,k]·tanh(Σ_h tanh(x_b·a[m,h] + c[m,h])·W1[h,k] + b1[k]).
//
// Replaces the Pallas kernel of the JAX package's ops/pallas_sweep.py
// _fwd_kernel (its call site is _fused_sweep_fwd_impl).  The TPU kernel packs
// six nodes into a block-diagonal 128×128 matrix for the MXU; that is a TPU
// layout and is not carried over.
//
// What bounds it on an H100: instruction issue.  Per path and node: 2H² + 7H
// FP32 operations with 2H accurate tanhf (each some twenty instructions, so
// the tanhf are more than half of the ~1.3k instructions), over 8 bytes per
// path (x in, out out) and the node rows, read once per block.  With one
// path per thread, the ~150 float4 reads of node rows and W1 per node from
// shared memory each fed at most four FMAs and held the kernel at ~1.7× its
// issue count.
//
// Design: each thread carries FWD_PATHS paths (sweep_common.cuh), looping
// over the nodes in order with one compensated sum per path in registers, so
// each shared-memory read serves FWD_PATHS paths.  W1, b1 and a chunk of
// NODE_CHUNK node rows sit in shared memory, padded to float4 rows; every
// thread of a block reads the same row at once, so each load is a
// broadcast.  The sums run in the same order as with one path per thread.
// Any M >= 1 and B >= 1: the ragged last block's idle paths compute on x = 0
// and write nothing.
#include "sweep_common.cuh"

namespace sweep {

// Paths per thread.  Each path's h1 takes H registers, and occupancy falls
// as the count grows: on an H100 at H = 21 two paths took 80 registers,
// three 124 and ran 40% slower, four 164 and 8% slower (PERF.md).
constexpr int FWD_PATHS = 2;
constexpr int FWD_TILE = THREADS * FWD_PATHS;  // paths per block

template <int H>
__global__ void __launch_bounds__(THREADS)
fwd_kernel(const float* __restrict__ x, const float* __restrict__ a,
           const float* __restrict__ c, const float* __restrict__ w1,
           const float* __restrict__ b1, const float* __restrict__ v,
           float* __restrict__ out, int batch, int m) {
  using S = Stage<H>;
  constexpr int P = FWD_PATHS;
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const int b0 = blockIdx.x * FWD_TILE + threadIdx.x;
  float xb[P], acc[P], acc_c[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int b = b0 + p * THREADS;
    xb[p] = b < batch ? __ldg(x + b) : 0.0f;
    acc[p] = 0.0f;
    acc_c[p] = 0.0f;
  }

  load_weights<H>(sm, w1, b1);
  float h1[P][H];
  for (int m0 = 0; m0 < m; m0 += NODE_CHUNK) {
    const int count = min(NODE_CHUNK, m - m0);
    __syncthreads();  // every thread is done with the previous chunk
    load_chunk<H>(sm, a, c, v, m0, count);
    __syncthreads();
#pragma unroll 1
    for (int r = 0; r < count; ++r) {
      // No barrier in this loop, so without this fence the compiler hoists
      // the loop-invariant W1 and b1 reads (H·HP + HP floats) out of it into
      // registers; at H = 21 they do not fit, and the kernel spills.
      asm volatile("" ::: "memory");
      first_layer<H, P>(sm, r, xb, h1);
      const float* rv = sm + S::V + r * S::HP;
      float s[P];
#pragma unroll
      for (int p = 0; p < P; ++p) s[p] = 0.0f;
#pragma unroll
      for (int q = 0; q < S::HP / 4; ++q) {
        float z[P][4];
        second_layer_quad<H, P>(sm, h1, q, z);
        const float4 v4 = quad(rv, q);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (4 * q + j < H) {
#pragma unroll
            for (int p = 0; p < P; ++p)
              s[p] += lane_of(v4, j) * tanhf(z[p][j]);
          }
        }
      }
#pragma unroll
      for (int p = 0; p < P; ++p) kahan_add(acc[p], acc_c[p], s[p]);
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int b = b0 + p * THREADS;
    if (b < batch) out[b] = acc[p];
  }
}

template <int H>
cudaError_t launch_fwd(const float* x, const float* a, const float* c,
                       const float* w1, const float* b1, const float* v,
                       float* out, int batch, int m, cudaStream_t stream) {
  const int blocks = (batch + FWD_TILE - 1) / FWD_TILE;
  const size_t smem = sizeof(float) * Stage<H>::SIZE;
  fwd_kernel<H><<<blocks, THREADS, smem, stream>>>(x, a, c, w1, b1, v, out,
                                                   batch, m);
  return cudaGetLastError();
}

template <int H>
cudaError_t info_fwd(int* smem, int* blocks_per_sm) {
  *smem = (int)(sizeof(float) * Stage<H>::SIZE);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, fwd_kernel<H>, THREADS, *smem);
}

}  // namespace sweep

// C entry (bound with ctypes by ops/sweep.py b3_forward).  x, out (batch,);
// a, c, v (m, hidden); w1 (hidden, hidden); b1 (hidden,).  Returns the
// launch's cudaError_t; cudaErrorInvalidValue for a hidden width not built
// here.
extern "C" int sweep_fwd(const float* x, const float* a, const float* c,
                         const float* w1, const float* b1, const float* v,
                         float* out, int batch, int m, int hidden,
                         void* stream) {
  using namespace sweep;
  if (batch < 1 || m < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (hidden) {
    case 8:
      return (int)launch_fwd<8>(x, a, c, w1, b1, v, out, batch, m, st);
    case 21:
      return (int)launch_fwd<21>(x, a, c, w1, b1, v, out, batch, m, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The kernel's dynamic shared memory per block and its resident blocks per
// SM at ``hidden`` (chip_smoke.py reports them).
extern "C" int sweep_fwd_info(int hidden, int* smem, int* blocks_per_sm) {
  using namespace sweep;
  switch (hidden) {
    case 8:
      return (int)info_fwd<8>(smem, blocks_per_sm);
    case 21:
      return (int)info_fwd<21>(smem, blocks_per_sm);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
