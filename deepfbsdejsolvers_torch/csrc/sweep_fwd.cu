// Kernel B3: the forward of the compensator sweep (ops/sweep.py),
//   out_b = Σ_m Σ_k v[m,k]·tanh(Σ_h tanh(x_b·a[m,h] + c[m,h])·W1[h,k] + b1[k]).
//
// Replaces the Pallas kernel of the JAX package's ops/pallas_sweep.py
// _fwd_kernel (its call site is _fused_sweep_fwd_impl).  The TPU kernel packs
// six nodes into a block-diagonal 128×128 matrix for the MXU; that is a TPU
// layout and is not carried over.
//
// What bounds it on an H100: arithmetic.  Per path and node: 2H² + 7H
// operations with 2H tanhf, over 8 bytes per path (x in, out out) and the
// node rows, read once per block.
//
// Design: one thread per path, looping over the nodes in order with its
// compensated sum in registers.  W1, b1 and a chunk of NODE_CHUNK node rows
// sit in shared memory, padded to float4 rows; every thread of a block reads
// the same row at once, so each load is a broadcast.  Any M >= 1 and B >= 1:
// the ragged last block's idle threads compute on x = 0 and write nothing.
#include "sweep_common.cuh"

namespace sweep {

template <int H>
__global__ void __launch_bounds__(THREADS)
fwd_kernel(const float* __restrict__ x, const float* __restrict__ a,
           const float* __restrict__ c, const float* __restrict__ w1,
           const float* __restrict__ b1, const float* __restrict__ v,
           float* __restrict__ out, int batch, int m) {
  using S = Stage<H>;
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const int b = blockIdx.x * THREADS + threadIdx.x;
  const bool active = b < batch;
  const float xb = active ? __ldg(x + b) : 0.0f;

  load_weights<H>(sm, w1, b1);
  float acc = 0.0f, acc_c = 0.0f;
  float h1[H], z[H], rv[S::HP];
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
      hidden<H>(sm, r, xb, h1, z);
      load_row<H>(sm + S::V + r * S::HP, rv);
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < H; ++k) s += rv[k] * tanhf(z[k]);
      kahan_add(acc, acc_c, s);
    }
  }
  if (active) out[b] = acc;
}

template <int H>
cudaError_t launch_fwd(const float* x, const float* a, const float* c,
                       const float* w1, const float* b1, const float* v,
                       float* out, int batch, int m, cudaStream_t stream) {
  const int blocks = (batch + THREADS - 1) / THREADS;
  const size_t smem = sizeof(float) * Stage<H>::SIZE;
  fwd_kernel<H><<<blocks, THREADS, smem, stream>>>(x, a, c, w1, b1, v, out,
                                                   batch, m);
  return cudaGetLastError();
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
