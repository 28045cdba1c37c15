// Kernel B4: the backward of the compensator sweep (ops/sweep.py) for a
// cotangent g (B,): dx per path; da, dc, dv per node; dW1 and db1.  With
// h1 = tanh(x·a_m + c_m), h2 = tanh(h1·W1 + b1) at path b and node m:
//   dz2 = g·v_m·(1 − h2²),  dz1 = (W1·dz2)·(1 − h1²),
//   dx_b = Σ_m dz1·a_m,  da_m = Σ_b dz1·x_b,  dc_m = Σ_b dz1,
//   dv_m = Σ_b g·h2,  dW1 = Σ_{b,m} h1 ⊗ dz2,  db1 = Σ_{b,m} dz2.
//
// Replaces the Pallas kernel of the JAX package's ops/pallas_sweep.py
// _bwd_kernel (its call site is _fused_sweep_bwd).  The TPU kernel takes the
// three H×H products of a tile (h1·W1, dz2·W1ᵀ, h1ᵀ·dz2) on the MXU; here
// they are FP32 FMAs, tiled in registers.
//
// What bounds it on an H100: instruction issue.  Per path and node it
// recomputes the hidden layers (2H² + 5H operations, 2H accurate tanhf of
// some twenty instructions each), runs their backward (2H² + 8H) and adds
// into the sums over paths (2H² + 9H): about 2.6k instructions per
// path-node at H = 21, over 12 bytes per path and the node rows.  Taken one
// path per thread, with every sum over the block's paths formed per node
// as a dot product over the paths in shared memory between two barriers,
// shared-memory traffic takes most of the cycles instead.
//
// Design: a fixed number of blocks (ops/sweep.py b4_blocks, at most 512,
// independent of B) each walk their BWD_TILE-path tiles in order; the TPU
// kernel's sequential grid becomes that walk.  Each warp owns 64 paths of a
// tile, two per thread, and works alone between the block's barriers:
//   * per node, each thread computes the hidden layers and their backward
//     for its two paths (sweep_common.cuh: each W1 read serves both), with
//     dx in registers;
//   * dW1 and db1: the warp stages h1 and dz2 of its 64 paths in shared
//     memory (h1 with a row of ones, so db1 = Σ 1·dz2 is one more row of the
//     product) and each thread adds a fixed RM×CM micro-tile of h1ᵀ·dz2 in
//     registers, RM + CM float4 reads feeding 4·RM·CM FMAs; the warp needs
//     only __syncwarp.  At the end of each node chunk the micro-tile is
//     Kahan-added into the thread's running sums in shared memory; at the
//     end of the walk the block sums them in warp order;
//   * da, dc and dv of a node: each thread sums its two paths, the warp
//     reduces the 3H values by a reduce-scatter butterfly of shuffles in a
//     fixed order, and the warp's sums wait in shared memory until the next
//     chunk's barrier, where the block adds the warps' sums in warp order
//     into its partial in device memory (written on the block's first tile,
//     added to after);
//   * two barriers per chunk of NODE_CHUNK nodes, not two per node;
//   * a second kernel sums the blocks' partials in block order.
// Registers and shared memory leave room for two blocks (eight warps) per
// SM, few to hide the latency of the tanhf chains, shuffles and
// shared-memory reads: the rest of the gap to the issue bound (PERF.md).
// No float atomics, so two runs on the same inputs give the same bits, and
// the partial buffer holds at most 512 × (H² + H + 3·M·H) floats whatever B.
#include "sweep_common.cuh"

namespace sweep {

constexpr int BWD_PATHS = 2;                     // paths per thread
constexpr int WARPS = THREADS / WARP;
constexpr int WARP_PATHS = WARP * BWD_PATHS;     // paths per warp
constexpr int BWD_TILE = THREADS * BWD_PATHS;    // paths per tile
constexpr int LDJ = WARP_PATHS + 4;  // staging row, 4 floats off a bank line

// Which part of h1ᵀ·dz2 a lane of a warp adds up: NRT × NCT micro-tiles of
// RM rows (h1's H rows, its row of ones, zero rows) by CM columns (dz2's H
// rows, zero rows), each over KS slices of the warp's paths; lanes past
// NRT·NCT·KS idle.  At H = 21 the 8 × 4 tiles of 3 × 6 cover 24 × 24 with
// every lane, and a warp's reads of the eight h1 rows fall in eight
// distinct bank quads.
template <int H>
struct Tiling;
template <>
struct Tiling<21> {
  static constexpr int RM = 3, NRT = 8, CM = 6, NCT = 4, KS = 1;
};
template <>
struct Tiling<8> {
  static constexpr int RM = 3, NRT = 3, CM = 4, NCT = 2, KS = 4;
};

template <int H>
struct Bwd {
  using T = Tiling<H>;
  static constexpr int RM = T::RM, CM = T::CM;
  static constexpr int ROWS = T::NRT * RM, COLS = T::NCT * CM;
  static constexpr int TEAM = T::NRT * T::NCT * T::KS;
  static constexpr int KLEN = WARP_PATHS / T::KS;
  static_assert(ROWS >= H + 1 && COLS >= H && TEAM <= WARP && KLEN % 4 == 0,
                "tiling does not cover h1ᵀ·dz2");
  // da and dc of a node in 2·HS butterfly slots (da at h, dc at HS + h),
  // dv in 32 slots
  static constexpr int HS = H <= 16 ? 16 : 32;
  static constexpr int R2 = 2 * HS / WARP;
  static_assert(H <= 32, "the butterfly slots take H <= 32");
  static constexpr int WSROW = 2 * HS + WARP;
  // Shared memory after the staged weights, in floats: per warp its h1 and
  // dz2 rows | per node of a chunk and warp its WSROW sums | per thread the
  // running sums and compensations of its micro-tile, [slot][thread].
  static constexpr int STG = Stage<H>::SIZE;
  static constexpr int STG_WARP = (ROWS + COLS) * LDJ;
  static constexpr int WS = STG + WARPS * STG_WARP;
  static constexpr int DW = WS + NODE_CHUNK * WARPS * WSROW;
  static constexpr int SIZE = DW + 2 * RM * CM * THREADS;
  // Summed over nodes: dW1 (H×H) and db1 (H); then da | dc | dv (M×H each).
  static constexpr int KEPT = H * H + H;
};

// One stage of reduce_scatter: lanes whose bit BIT is set keep the upper
// half of the live slots, the others the lower half; each adds its
// partner's copy of the half it keeps and sends the other half.  The slot
// indices are compile-time, so the slots stay in registers.
template <int R, int BIT>
__device__ __forceinline__ void scatter_stage(float (&v)[WARP * R],
                                              int lane) {
  constexpr int HALF = R * BIT;
  const bool upper = (lane & BIT) != 0;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = upper ? v[i] : v[i + HALF];
    const float keep = upper ? v[i + HALF] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, BIT);
  }
}

// Σ over the warp's lanes of v[i] for every i, left in lane l as
// out[k] = that sum of v[R·l + k]: five stages in a fixed tree, 31·R
// shuffles, where a butterfly of each slot alone takes 5·32·R.
template <int R>
__device__ __forceinline__ void reduce_scatter(float (&v)[WARP * R],
                                               float (&out)[R], int lane) {
  scatter_stage<R, 16>(v, lane);
  scatter_stage<R, 8>(v, lane);
  scatter_stage<R, 4>(v, lane);
  scatter_stage<R, 2>(v, lane);
  scatter_stage<R, 1>(v, lane);
#pragma unroll
  for (int k = 0; k < R; ++k) out[k] = v[k];
}

// The block adds its warps' sums of nodes m0 .. m0 + count - 1 (waiting in
// ``ws``), in warp order, into its partial's da, dc and dv.
template <int H>
__device__ __forceinline__ void flush_nodes(const float* ws, float* my_part,
                                            int m, int m0, int count,
                                            bool first) {
  using W = Bwd<H>;
  for (int q = threadIdx.x; q < count * 3 * H; q += THREADS) {
    const int r = q / (3 * H), seg = (q % (3 * H)) / H, idx = q % H;
    const float* src = ws + r * WARPS * W::WSROW + seg * W::HS + idx;
    float s = src[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) s += src[w * W::WSROW];
    float* dst = my_part + W::KEPT + (size_t)seg * m * H +
                 (size_t)(m0 + r) * H + idx;
    *dst = first ? s : *dst + s;
  }
}

// Two blocks per SM, as its shared memory allows: up to 255 registers each.
template <int H>
__global__ void __launch_bounds__(THREADS, 2)
bwd_kernel(const float* __restrict__ x, const float* __restrict__ a,
           const float* __restrict__ c, const float* __restrict__ w1,
           const float* __restrict__ b1, const float* __restrict__ v,
           const float* __restrict__ g, float* __restrict__ dx,
           float* __restrict__ part, int batch, int m) {
  using S = Stage<H>;
  using W = Bwd<H>;
  using T = Tiling<H>;
  constexpr int P = BWD_PATHS, RM = W::RM, CM = W::CM;
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const int tid = threadIdx.x, lane = tid % WARP, warp = tid / WARP;
  const int n_tiles = (batch + BWD_TILE - 1) / BWD_TILE;
  const size_t n_out = (size_t)W::KEPT + 3 * (size_t)m * H;
  float* my_part = part + (size_t)blockIdx.x * n_out;
  float* h1s = sm + W::STG + warp * W::STG_WARP;  // [row][path of the warp]
  float* dz2s = h1s + W::ROWS * LDJ;
  float* ws = sm + W::WS;
  float* dw = sm + W::DW;

  load_weights<H>(sm, w1, b1);
  // the staging rows no thread writes per node: h1's row H is ones and the
  // rows past it zero, dz2's rows from H on zero
  for (int q = lane; q < (W::ROWS - H) * LDJ; q += WARP)
    h1s[H * LDJ + q] = q < LDJ ? 1.0f : 0.0f;
  for (int q = lane; q < (W::COLS - H) * LDJ; q += WARP)
    dz2s[H * LDJ + q] = 0.0f;
  for (int q = 0; q < 2 * RM * CM; ++q) dw[q * THREADS + tid] = 0.0f;

  // this lane's micro-tile of h1ᵀ·dz2 and its slice of the warp's paths
  const bool in_team = lane < W::TEAM;
  const int rt = lane % T::NRT, ct = (lane / T::NRT) % T::NCT,
            ks = lane / (T::NRT * T::NCT);
  const float* tile_h1 = h1s + rt * RM * LDJ + ks * W::KLEN;
  const float* tile_dz2 = dz2s + ct * CM * LDJ + ks * W::KLEN;

  // the chunk whose per-node sums wait in ws for the next barrier
  int wait_m0 = 0, wait_count = 0;
  bool wait_first = false;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const bool first = tile == (int)blockIdx.x;
    // idle paths of the ragged last tile carry a zero cotangent, so every
    // sum they enter gets exact zeros from them
    float xb[P], gb[P], dxb[P], dxb_c[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int b = tile * BWD_TILE + warp * WARP_PATHS + p * WARP + lane;
      xb[p] = b < batch ? __ldg(x + b) : 0.0f;
      gb[p] = b < batch ? __ldg(g + b) : 0.0f;
      dxb[p] = 0.0f;
      dxb_c[p] = 0.0f;
    }
    for (int m0 = 0; m0 < m; m0 += NODE_CHUNK) {
      const int count = min(NODE_CHUNK, m - m0);
      __syncthreads();  // every warp is done with the previous chunk
      flush_nodes<H>(ws, my_part, m, wait_m0, wait_count, wait_first);
      wait_m0 = m0;
      wait_count = count;
      wait_first = first;
      load_chunk<H>(sm, a, c, v, m0, count);
      __syncthreads();
      float acc[RM][CM];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CM; ++j) acc[i][j] = 0.0f;
#pragma unroll 1
      for (int r = 0; r < count; ++r) {
        // keep the loop-invariant W1 reads inside the loop (as in B3)
        asm volatile("" ::: "memory");
        float h1[P][H];
        first_layer<H, P>(sm, r, xb, h1);
#pragma unroll
        for (int h = 0; h < H; ++h)
#pragma unroll
          for (int p = 0; p < P; ++p) h1s[h * LDJ + p * WARP + lane] = h1[p][h];

        // h2, g·h2 summed over the thread's paths (dv), and dz2
        const float* rv = sm + S::V + r * S::HP;
        float dz2[P][H], dv[WARP];
#pragma unroll
        for (int k = 0; k < WARP; ++k) dv[k] = 0.0f;
#pragma unroll
        for (int q = 0; q < S::HP / 4; ++q) {
          float z[P][4];
          second_layer_quad<H, P>(sm, h1, q, z);
          const float4 v4 = quad(rv, q);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int k = 4 * q + j;
            if (k < H) {
#pragma unroll
              for (int p = 0; p < P; ++p) {
                const float h2 = tanhf(z[p][j]);
                dv[k] += gb[p] * h2;
                dz2[p][k] = (gb[p] * lane_of(v4, j)) * (1.0f - h2 * h2);
              }
            }
          }
        }
        float dv_sum[1];
        reduce_scatter<1>(dv, dv_sum, lane);
#pragma unroll
        for (int k = 0; k < H; ++k)
#pragma unroll
          for (int p = 0; p < P; ++p)
            dz2s[k * LDJ + p * WARP + lane] = dz2[p][k];

        // dz1 = (W1·dz2)·(1 − h1²), dx, and da, dc summed over the paths
        const float* ra = sm + S::A + r * S::HP;
        float dadc[2 * W::HS], dxm[P];
#pragma unroll
        for (int k = 0; k < 2 * W::HS; ++k) dadc[k] = 0.0f;
#pragma unroll
        for (int p = 0; p < P; ++p) dxm[p] = 0.0f;
#pragma unroll
        for (int h = 0; h < H; ++h) {
          float s[P];
#pragma unroll
          for (int p = 0; p < P; ++p) s[p] = 0.0f;
#pragma unroll
          for (int q = 0; q < S::HP / 4; ++q) {
            const float4 w4 = quad(sm + S::W1 + h * S::HP, q);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (4 * q + j < H) {
#pragma unroll
                for (int p = 0; p < P; ++p)
                  s[p] += lane_of(w4, j) * dz2[p][4 * q + j];
              }
            }
          }
          const float ah = ra[h];
#pragma unroll
          for (int p = 0; p < P; ++p) {
            const float h1v = h1s[h * LDJ + p * WARP + lane];
            const float dz1 = s[p] * (1.0f - h1v * h1v);
            dxm[p] += dz1 * ah;
            dadc[h] += dz1 * xb[p];
            dadc[W::HS + h] += dz1;
          }
        }
#pragma unroll
        for (int p = 0; p < P; ++p) kahan_add(dxb[p], dxb_c[p], dxm[p]);
        float dadc_sum[W::R2];
        reduce_scatter<W::R2>(dadc, dadc_sum, lane);

        // this lane's micro-tile of h1ᵀ·dz2 over the warp's paths
        __syncwarp();
        if (in_team) {
#pragma unroll 4
          for (int j = 0; j < W::KLEN; j += 4) {
            float4 hq[RM], dq[CM];
#pragma unroll
            for (int i = 0; i < RM; ++i) hq[i] = quad(tile_h1 + i * LDJ, j / 4);
#pragma unroll
            for (int i = 0; i < CM; ++i)
              dq[i] = quad(tile_dz2 + i * LDJ, j / 4);
#pragma unroll
            for (int i = 0; i < RM; ++i)
#pragma unroll
              for (int k = 0; k < CM; ++k) {
                acc[i][k] += hq[i].x * dq[k].x;
                acc[i][k] += hq[i].y * dq[k].y;
                acc[i][k] += hq[i].z * dq[k].z;
                acc[i][k] += hq[i].w * dq[k].w;
              }
          }
        }
        __syncwarp();  // the staging rows are free for the next node

        float* wsr = ws + (r * WARPS + warp) * W::WSROW;
#pragma unroll
        for (int k = 0; k < W::R2; ++k) wsr[W::R2 * lane + k] = dadc_sum[k];
        wsr[2 * W::HS + lane] = dv_sum[0];
      }
      if (in_team) {
#pragma unroll
        for (int i = 0; i < RM * CM; ++i)
          kahan_add(dw[2 * i * THREADS + tid], dw[(2 * i + 1) * THREADS + tid],
                    acc[i / CM][i % CM]);
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int b = tile * BWD_TILE + warp * WARP_PATHS + p * WARP + lane;
      if (b < batch) dx[b] = dxb[p];
    }
  }
  __syncthreads();
  flush_nodes<H>(ws, my_part, m, wait_m0, wait_count, wait_first);
  // dW1 and db1 (row H of the product): each entry's micro-tile sums over
  // the warps and slices, in that order
  for (int q = tid; q < W::KEPT; q += THREADS) {
    const int h = q / H, k = q % H;
    const int lane_q = h / RM + T::NRT * (k / CM);
    const int slot = 2 * ((h % RM) * CM + k % CM) * THREADS;
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w)
#pragma unroll
      for (int kk = 0; kk < T::KS; ++kk)
        s += dw[slot + w * WARP + lane_q + T::NRT * T::NCT * kk];
    my_part[q] = s;
  }
}

// The shared memory above 48 KB needs the kernel's opt-in before a launch.
template <int H>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(bwd_kernel<H>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)(sizeof(float) * Bwd<H>::SIZE));
}

template <int H>
cudaError_t info_bwd(int* smem, int* blocks_per_sm) {
  *smem = (int)(sizeof(float) * Bwd<H>::SIZE);
  const cudaError_t err = allow_smem<H>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, bwd_kernel<H>, THREADS, *smem);
}

template <int H>
cudaError_t launch_bwd(const float* x, const float* a, const float* c,
                       const float* w1, const float* b1, const float* v,
                       const float* g, float* dx, float* part, float* out,
                       int batch, int m, int n_blocks, cudaStream_t stream) {
  const size_t smem = sizeof(float) * Bwd<H>::SIZE;
  cudaError_t err = allow_smem<H>();
  if (err != cudaSuccess) return err;
  bwd_kernel<H><<<n_blocks, THREADS, smem, stream>>>(x, a, c, w1, b1, v, g,
                                                     dx, part, batch, m);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_out = Bwd<H>::KEPT + 3 * m * H;
  reduce_partials<<<(n_out + REDUCE_THREADS - 1) / REDUCE_THREADS,
                    REDUCE_THREADS, 0, stream>>>(part, out, n_blocks, n_out);
  return cudaGetLastError();
}

}  // namespace sweep

// C entry (bound with ctypes by ops/sweep.py b4_backward).  x, g, dx
// (batch,); a, c, v (m, hidden); w1 (hidden, hidden); b1 (hidden,); part
// n_blocks partials of (hidden² + hidden + 3·m·hidden) floats, n_blocks in
// [1, ceil(batch / 256)]; out one of them, the sum.  Returns the launches'
// cudaError_t; cudaErrorInvalidValue for a hidden width not built here.
extern "C" int sweep_bwd(const float* x, const float* a, const float* c,
                         const float* w1, const float* b1, const float* v,
                         const float* g, float* dx, float* part, float* out,
                         int batch, int m, int hidden, int n_blocks,
                         void* stream) {
  using namespace sweep;
  if (batch < 1 || m < 1 || n_blocks < 1 ||
      n_blocks > (batch + BWD_TILE - 1) / BWD_TILE)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (hidden) {
    case 8:
      return (int)launch_bwd<8>(x, a, c, w1, b1, v, g, dx, part, out, batch,
                                m, n_blocks, st);
    case 21:
      return (int)launch_bwd<21>(x, a, c, w1, b1, v, g, dx, part, out,
                                 batch, m, n_blocks, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The kernel's dynamic shared memory per block and its resident blocks per
// SM at ``hidden`` (chip_smoke.py reports them).
extern "C" int sweep_bwd_info(int hidden, int* smem, int* blocks_per_sm) {
  using namespace sweep;
  switch (hidden) {
    case 8:
      return (int)info_bwd<8>(smem, blocks_per_sm);
    case 21:
      return (int)info_bwd<21>(smem, blocks_per_sm);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
