// Kernel B3 at the wide head widths: the forward of the compensator sweep
// (ops/sweep.py) for any hidden width H in 1..128, built for the width
// classes HP = 32, 64, 128 (sweep_wide.cuh); the specialised sweep_fwd.cu
// keeps H = 8 and 21.
//
// Replaces the Pallas kernel of the JAX package's ops/pallas_sweep.py
// _fwd_kernel (its call site is _fused_sweep_fwd_impl) at the widths it
// takes beyond those two.  The TPU kernel packs 128 // H nodes into a
// block-diagonal matrix for the MXU; here the H×H product goes to the
// tensor cores in split TF32 (tc_split.cuh), node by node.
//
// What bounds it on an H100: per path and node the product h1·W1 (2H²
// operations, 3·2H² on the tensor cores in split TF32) and 7H FP32
// operations around it with 2H accurate tanhf, over 8 bytes per path and
// the node rows, read once per block.  With the product on the tensor cores
// the accurate tanhf are a large share of what is left (about half at
// H = 64).
//
// Design: a block of eight warps (twelve at HP = 128, whose 168 registers
// a thread leave the SM room for them) takes 16 paths a warp, one m16
// tile, and walks the nodes in order, NODE_CHUNK rows of a, c, v at a time
// staged in shared memory beside W1's split fragments (staged once: hi of
// b0 and b1, then lo of both, as one float4 per lane and 8 × 8 block, in
// the permuted order of tc_split.cuh, so that each pair loads into two
// consecutive registers as the mma takes it).  Per node a lane computes
// the first layer of its two paths at its units 8k + 2t, 8k + 2t + 1
// straight into the A layout and splits it (hi, lo in registers for the
// node), then walks the output units two n-tiles at a time: 3 mma per tile
// and k-step, then b1, tanh and v on the accumulators, summed into one
// running sum per path and lane; per node that sum enters a compensated
// sum.  After the last node the four lanes of a path add their sums in a
// fixed butterfly.  No barrier but the two per node chunk.  Idle paths of
// the ragged last block compute on x = 0 and write nothing.
#include "sweep_wide.cuh"

namespace sweep_wide {

// Warps and paths per block; shared memory in floats: W1's fragments (NB ×
// NB blocks of 32 float4s) | b1 (HP) | a, c, v of one chunk of nodes
// (NODE_CHUNK rows of HP each).
template <int HP>
struct Fwd {
  static constexpr int NWARPS = HP == 128 ? 12 : WARPS;
  static constexpr int NTHREADS = NWARPS * WARP;
  static constexpr int TILE = NWARPS * Mma<HP>::ROWS;
  static constexpr int W1F = 0;
  static constexpr int B1 = W1F + 2 * HP * HP;
  static constexpr int A = B1 + HP;
  static constexpr int C = A + NODE_CHUNK * HP;
  static constexpr int V = C + NODE_CHUNK * HP;
  static constexpr int SIZE = V + NODE_CHUNK * HP;
  static constexpr int NG = 2;  // n-tiles an accumulator group
};

// W1 of width h (zero past h) into ``dst`` as split B fragments of h1·W1:
// for 8 × 8 block (k, n) and lane (g, t), with b0 = W1[8k + 2t][8n + g] and
// b1 = W1[8k + 2t + 1][8n + g], the float4 (hi b0, hi b1, lo b0, lo b1) at
// index (k·NB + n)·32 + lane.
template <int HP>
__device__ __forceinline__ void load_w1_fragments(float* dst,
                                                  const float* __restrict__ w1,
                                                  int h) {
  constexpr int NB = Mma<HP>::NB;
  float4* out = reinterpret_cast<float4*>(dst);
  for (int q = threadIdx.x; q < NB * NB * WARP; q += blockDim.x) {
    const int lane = q % WARP, blk = q / WARP;
    const int r = 8 * (blk / NB) + 2 * (lane % 4);
    const int col = 8 * (blk % NB) + lane / 4;
    const bool in = col < h;
    const float w0 = in && r < h ? __ldg(w1 + r * h + col) : 0.0f;
    const float w1v = in && r + 1 < h ? __ldg(w1 + (r + 1) * h + col) : 0.0f;
    float4 f;
    split_tf32(w0, f.x, f.z);
    split_tf32(w1v, f.y, f.w);
    out[q] = f;
  }
}

// Rows m0 .. m0 + count - 1 of a, c and v into the chunk slots at ``dst``
// (NODE_CHUNK rows of HP each); the slots past ``count`` and the columns
// past h are zero.
template <int HP>
__device__ __forceinline__ void load_chunk(float* dst,
                                           const float* __restrict__ a,
                                           const float* __restrict__ c,
                                           const float* __restrict__ v,
                                           int m0, int count, int h) {
  constexpr int ROWS = NODE_CHUNK * HP;
  for (int q = threadIdx.x; q < 3 * ROWS; q += blockDim.x) {
    const int which = q / ROWS, r = (q / HP) % NODE_CHUNK, col = q % HP;
    const float* src = which == 0 ? a : which == 1 ? c : v;
    dst[q] = (r < count && col < h) ? __ldg(src + (size_t)(m0 + r) * h + col)
                                    : 0.0f;
  }
}

template <int HP>
__global__ void __launch_bounds__(Fwd<HP>::NTHREADS)
fwd_kernel(const float* __restrict__ x, const float* __restrict__ a,
           const float* __restrict__ c, const float* __restrict__ w1,
           const float* __restrict__ b1, const float* __restrict__ v,
           float* __restrict__ out, int batch, int m, int h) {
  using M = Mma<HP>;
  using F = Fwd<HP>;
  constexpr int NB = M::NB, NG = F::NG;
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const int lane = threadIdx.x % WARP, warp = threadIdx.x / WARP;
  const int t = lane % 4;
  // this lane's paths: rows g and g + 8 of the warp's tile
  const int b0 = blockIdx.x * F::TILE + warp * M::ROWS + lane / 4;
  float xb[2], acc[2], comp[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int b = b0 + 8 * e;
    xb[e] = b < batch ? __ldg(x + b) : 0.0f;
    acc[e] = 0.0f;
    comp[e] = 0.0f;
  }
  load_w1_fragments<HP>(sm + F::W1F, w1, h);
  for (int q = threadIdx.x; q < HP; q += blockDim.x)
    sm[F::B1 + q] = q < h ? __ldg(b1 + q) : 0.0f;
  const float4* wf = reinterpret_cast<const float4*>(sm + F::W1F) + lane;

  for (int m0 = 0; m0 < m; m0 += NODE_CHUNK) {
    const int count = min(NODE_CHUNK, m - m0);
    __syncthreads();  // every warp is done with the previous chunk
    load_chunk<HP>(sm + F::A, a, c, v, m0, count, h);
    __syncthreads();
#pragma unroll 1
    for (int r = 0; r < count; ++r) {
      // h1 at (path g, unit 8k + 2t) → a0, (g + 8, 2t) → a1, (g, 2t + 1)
      // → a2, (g + 8, 2t + 1) → a3, split
      float ah[NB][4], al[NB][4];
#pragma unroll
      for (int k = 0; k < NB; ++k) {
        const int u = 8 * k + 2 * t;
        const float2 ak = *reinterpret_cast<const float2*>(
            sm + F::A + r * HP + u);
        const float2 ck = *reinterpret_cast<const float2*>(
            sm + F::C + r * HP + u);
        split_tf32(tanhf(xb[0] * ak.x + ck.x), ah[k][0], al[k][0]);
        split_tf32(tanhf(xb[1] * ak.x + ck.x), ah[k][1], al[k][1]);
        split_tf32(tanhf(xb[0] * ak.y + ck.y), ah[k][2], al[k][2]);
        split_tf32(tanhf(xb[1] * ak.y + ck.y), ah[k][3], al[k][3]);
      }
      float s[2] = {0.0f, 0.0f};
#pragma unroll 1
      for (int n0 = 0; n0 < NB; n0 += NG) {
        float zb[NG][4], zs[NG][4];
#pragma unroll
        for (int q = 0; q < NG; ++q)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            zb[q][i] = 0.0f;
            zs[q][i] = 0.0f;
          }
#pragma unroll
        for (int k = 0; k < NB; ++k) {
#pragma unroll
          for (int q = 0; q < NG; ++q) {
            const float4 f = wf[(k * NB + n0 + q) * WARP];
            const float bh[2] = {f.x, f.y}, bl[2] = {f.z, f.w};
            mma_split(zb[q], zs[q], ah[k], al[k], bh, bl);
          }
        }
        // Z at (g, 8n + 2t), (g, +1), (g + 8, 8n + 2t), (g + 8, +1)
#pragma unroll
        for (int q = 0; q < NG; ++q) {
          const int u = 8 * (n0 + q) + 2 * t;
          const float2 bk = *reinterpret_cast<const float2*>(sm + F::B1 + u);
          const float2 vk = *reinterpret_cast<const float2*>(
              sm + F::V + r * HP + u);
#pragma unroll
          for (int e = 0; e < 2; ++e)
            s[e] += vk.x * tanhf(zb[q][2 * e] + zs[q][2 * e] + bk.x) +
                    vk.y * tanhf(zb[q][2 * e + 1] + zs[q][2 * e + 1] + bk.y);
        }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) kahan_add(acc[e], comp[e], s[e]);
    }
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const float total = sum_lanes_t(acc[e]);
    if (t == 0 && b0 + 8 * e < batch) out[b0 + 8 * e] = total;
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
  const int blocks = (batch + Fwd<HP>::TILE - 1) / Fwd<HP>::TILE;
  fwd_kernel<HP><<<blocks, Fwd<HP>::NTHREADS, sizeof(float) * Fwd<HP>::SIZE,
                   stream>>>(x, a, c, w1, b1, v, out, batch, m, h);
  return cudaGetLastError();
}

template <int HP>
cudaError_t info_fwd(int* smem, int* blocks_per_sm) {
  *smem = (int)(sizeof(float) * Fwd<HP>::SIZE);
  const cudaError_t err = allow_smem<HP>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, fwd_kernel<HP>, Fwd<HP>::NTHREADS, *smem);
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
