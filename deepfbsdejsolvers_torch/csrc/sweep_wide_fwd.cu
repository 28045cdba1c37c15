// Kernel B3 at the wide head widths: the forward of the compensator sweep
// (ops/sweep.py) for any hidden width H in 1..128, built for the width
// classes HP = 32, 64, 128 (sweep_wide.cuh); the specialised sweep_fwd.cu
// keeps H = 8 and 21.
//
// Replaces the Pallas kernel of the JAX package's ops/pallas_sweep.py
// _fwd_kernel (its call site is _fused_sweep_fwd_impl) at the widths it
// takes beyond those two.  The TPU kernel packs 128 // H nodes into a
// block-diagonal matrix for the MXU; that is a TPU layout and is not carried
// over.
//
// What bounds it on an H100: FP32 issue.  Per path and node 2H² + 7H
// operations with 2H accurate tanhf, over 8 bytes per path and the node
// rows, read once per block; at H = 64 and beyond the H×H product is most
// of the instructions.
//
// Design: a block of eight warps takes TILE = 8·P paths, each warp P of them,
// and walks the nodes in order, NODE_CHUNK rows at a time staged in shared
// memory beside W1 and b1.  Per node a lane computes the first layer of its
// U units for the warp's P paths (staged for the warp), then the second
// layer of its units, reading each staged h1 quad as one broadcast and
// each W1 value once for P paths, and adds v·tanh(z) of its units into one
// compensated running sum per path.  After the last node the warp sums its
// lanes in a fixed butterfly.  No barrier but the two per node chunk and
// __syncwarp per node.  Idle paths of the ragged last block compute on
// x = 0 and write nothing.
#include "sweep_wide.cuh"

namespace sweep_wide {

template <int HP>
struct Fwd {
  static constexpr int SIZE = Wide<HP>::STAGE + WARPS * Wide<HP>::P * HP;
};

template <int HP>
__global__ void __launch_bounds__(THREADS)
fwd_kernel(const float* __restrict__ x, const float* __restrict__ a,
           const float* __restrict__ c, const float* __restrict__ w1,
           const float* __restrict__ b1, const float* __restrict__ v,
           float* __restrict__ out, int batch, int m, int h) {
  using L = Wide<HP>;
  constexpr int P = L::P, U = L::U;
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const int lane = threadIdx.x % WARP, warp = threadIdx.x / WARP;
  const int b0 = blockIdx.x * L::TILE + warp * P;
  float* stage = sm + L::STAGE + warp * P * HP;
  float xb[P], acc[P], acc_c[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    xb[p] = b0 + p < batch ? __ldg(x + b0 + p) : 0.0f;
    acc[p] = 0.0f;
    acc_c[p] = 0.0f;
  }

  load_weights<HP>(sm, w1, b1, h);
  for (int m0 = 0; m0 < m; m0 += NODE_CHUNK) {
    const int count = min(NODE_CHUNK, m - m0);
    __syncthreads();  // every warp is done with the previous chunk
    load_chunk<HP>(sm, a, c, v, m0, count, h);
    __syncthreads();
#pragma unroll 1
    for (int r = 0; r < count; ++r) {
      // keep the loop-invariant W1 reads inside the loop (as in B3)
      asm volatile("" ::: "memory");
      float h1[P][U], z[P][U];
      first_layer<HP>(sm, r, lane, xb, h1, stage);
      __syncwarp();
      second_layer<HP>(sm, lane, stage, z);
      float s[P];
#pragma unroll
      for (int p = 0; p < P; ++p) s[p] = 0.0f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float vk = sm[L::V + r * HP + lane + WARP * u];
#pragma unroll
        for (int p = 0; p < P; ++p) s[p] += vk * tanhf(z[p][u]);
      }
#pragma unroll
      for (int p = 0; p < P; ++p) kahan_add(acc[p], acc_c[p], s[p]);
      __syncwarp();  // the staging rows are free for the next node
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const float total = warp_sum(acc[p]);
    if (lane == 0 && b0 + p < batch) out[b0 + p] = total;
  }
}

// The shared memory above 48 KB needs the kernel's opt-in before a launch.
template <int HP>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(fwd_kernel<HP>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)(sizeof(float) * Fwd<HP>::SIZE));
}

template <int HP>
cudaError_t launch_fwd(const float* x, const float* a, const float* c,
                       const float* w1, const float* b1, const float* v,
                       float* out, int batch, int m, int h,
                       cudaStream_t stream) {
  const cudaError_t err = allow_smem<HP>();
  if (err != cudaSuccess) return err;
  const int blocks = (batch + Wide<HP>::TILE - 1) / Wide<HP>::TILE;
  fwd_kernel<HP><<<blocks, THREADS, sizeof(float) * Fwd<HP>::SIZE,
                   stream>>>(x, a, c, w1, b1, v, out, batch, m, h);
  return cudaGetLastError();
}

template <int HP>
cudaError_t info_fwd(int* smem, int* blocks_per_sm) {
  *smem = (int)(sizeof(float) * Fwd<HP>::SIZE);
  const cudaError_t err = allow_smem<HP>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, fwd_kernel<HP>, THREADS, *smem);
}

}  // namespace sweep_wide

// C entry (bound with ctypes by ops/sweep.py b3_wide_forward).  x, out
// (batch,); a, c, v (m, hidden); w1 (hidden, hidden); b1 (hidden,).  Returns
// the launch's cudaError_t; cudaErrorInvalidValue for a hidden width outside
// 1..128.
extern "C" int sweep_wide_fwd(const float* x, const float* a, const float* c,
                              const float* w1, const float* b1,
                              const float* v, float* out, int batch, int m,
                              int hidden, void* stream) {
  using namespace sweep_wide;
  if (batch < 1 || m < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (width_class(hidden)) {
    case 32:
      return (int)launch_fwd<32>(x, a, c, w1, b1, v, out, batch, m, hidden,
                                 st);
    case 64:
      return (int)launch_fwd<64>(x, a, c, w1, b1, v, out, batch, m, hidden,
                                 st);
    case 128:
      return (int)launch_fwd<128>(x, a, c, w1, b1, v, out, batch, m, hidden,
                                  st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The kernel's dynamic shared memory per block and its resident blocks per
// SM at the width class of ``hidden`` (chip_smoke.py reports them).
extern "C" int sweep_wide_fwd_info(int hidden, int* smem, int* blocks_per_sm) {
  using namespace sweep_wide;
  switch (width_class(hidden)) {
    case 32:
      return (int)info_fwd<32>(smem, blocks_per_sm);
    case 64:
      return (int)info_fwd<64>(smem, blocks_per_sm);
    case 128:
      return (int)info_fwd<128>(smem, blocks_per_sm);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
