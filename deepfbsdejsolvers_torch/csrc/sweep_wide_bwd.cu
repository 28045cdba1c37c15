// Kernel B4 at the wide head widths: the backward of the compensator sweep
// (ops/sweep.py) for a cotangent g (B,) at any hidden width H in 1..128,
// built for the width classes HP = 32, 64, 128 (sweep_wide.cuh); the
// specialised sweep_bwd.cu keeps H = 8 and 21.  With h1 = tanh(x·a_m + c_m),
// h2 = tanh(h1·W1 + b1) at path b and node m:
//   dz2 = g·v_m·(1 − h2²),  dz1 = (W1·dz2)·(1 − h1²),
//   dx_b = Σ_m dz1·a_m,  da_m = Σ_b dz1·x_b,  dc_m = Σ_b dz1,
//   dv_m = Σ_b g·h2,  dW1 = Σ_{b,m} h1 ⊗ dz2,  db1 = Σ_{b,m} dz2.
//
// Replaces the Pallas kernel of the JAX package's ops/pallas_sweep.py
// _bwd_kernel (its call site is _fused_sweep_bwd) at the widths it takes
// beyond 8 and 21.  The TPU kernel takes a tile's three H×H products on the
// MXU; here they are FP32 FMAs.
//
// What bounds it on an H100: FP32 issue, 6H² + 20H operations per path and
// node (the hidden layers recomputed, their backward, the sums over paths)
// with 2H accurate tanhf, over 12 bytes per path and the node rows.
//
// Design: a fixed number of blocks (ops/sweep.py b4_wide_blocks, at most
// 264, two per SM) each walk their TILE-path tiles in order, eight warps of
// P paths each.  Per node:
//   * each warp recomputes the hidden layers of its P paths, its lanes
//     owning units k = lane + 32u (sweep_wide.cuh), stages h1 and dz2 of its
//     paths in shared memory, forms W1·dz2 for its lanes' units from the
//     staged dz2, and keeps dx per path in a compensated sum per lane, db1
//     per unit in compensated lane sums, and the node's da, dc and dv of
//     its units summed over its paths, written to the warp's slot;
//   * one barrier; then the block adds h1ᵀ·dz2 over the tile's staged rows
//     into register micro-tiles of dW1 (each thread RM × CM entries, rows
//     and columns strided by 16, so its shared reads are conflict-free) and
//     sums the warps' da, dc, dv in warp order into its partial in device
//     memory (written on the block's first tile, added to after); a second
//     barrier frees the staging for the next node;
//   * at the end of each node chunk the micro-tiles are added into the
//     partial's dW1, so a register sum runs over at most NODE_CHUNK·TILE
//     terms; at the end of the walk the warps' db1 sums, in warp order.
// A second kernel sums the blocks' partials in block order.  No float
// atomics: two runs on the same inputs give the same bits, and the partial
// buffer holds at most 264 × (H² + H + 3·M·H) floats whatever B.
#include "sweep_wide.cuh"

namespace sweep_wide {

template <int HP>
struct Bwd {
  using L = Wide<HP>;
  // the micro-tile of dW1 per thread: 16 × 16 threads tile HP × HP
  static constexpr int RM = HP / 16, CM = HP / 16;
  static_assert(16 * 16 == THREADS, "16 × 16 micro-tiles");
  // after the common layout: the tile's h1 rows (TILE of HP) | its dz2 rows
  // | per warp the node's da, dc, dv of its units (3 rows of HP)
  static constexpr int H1S = L::STAGE;
  static constexpr int DZ2S = H1S + L::TILE * HP;
  static constexpr int WS = DZ2S + L::TILE * HP;
  static constexpr int SIZE = WS + WARPS * 3 * HP;
};

template <int HP>
__global__ void __launch_bounds__(THREADS)
bwd_kernel(const float* __restrict__ x, const float* __restrict__ a,
           const float* __restrict__ c, const float* __restrict__ w1,
           const float* __restrict__ b1, const float* __restrict__ v,
           const float* __restrict__ g, float* __restrict__ dx,
           float* __restrict__ part, int batch, int m, int h) {
  using L = Wide<HP>;
  using B = Bwd<HP>;
  constexpr int P = L::P, U = L::U, RM = B::RM, CM = B::CM;
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const int tid = threadIdx.x, lane = tid % WARP, warp = tid / WARP;
  const int n_tiles = (batch + L::TILE - 1) / L::TILE;
  const size_t kept = (size_t)h * h + h;
  float* my_part = part + (size_t)blockIdx.x * (kept + 3 * (size_t)m * h);
  float* h1s = sm + B::H1S + warp * P * HP;  // this warp's staging rows
  float* dz2s = sm + B::DZ2S + warp * P * HP;
  float* ws = sm + B::WS;
  // this thread's micro-tile: rows rt + 16i, columns ct + 16j of dW1
  const int rt = tid % 16, ct = tid / 16;

  load_weights<HP>(sm, w1, b1, h);
  float acc[RM][CM];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CM; ++j) acc[i][j] = 0.0f;
  float db1[U], db1_c[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    db1[u] = 0.0f;
    db1_c[u] = 0.0f;
  }
  bool dw_first = true;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const bool first = tile == (int)blockIdx.x;
    // idle paths of the ragged last tile carry a zero cotangent, so every
    // sum they enter gets exact zeros from them
    const int b0 = tile * L::TILE + warp * P;
    float xb[P], gb[P], dxb[P], dxb_c[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      xb[p] = b0 + p < batch ? __ldg(x + b0 + p) : 0.0f;
      gb[p] = b0 + p < batch ? __ldg(g + b0 + p) : 0.0f;
      dxb[p] = 0.0f;
      dxb_c[p] = 0.0f;
    }
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
        first_layer<HP>(sm, r, lane, xb, h1, h1s);
        __syncwarp();
        second_layer<HP>(sm, lane, h1s, z);

        // h2, g·h2 summed over the warp's paths (dv), dz2 staged, db1
        float dv[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int k = lane + WARP * u;
          const float vk = sm[L::V + r * HP + k];
          dv[u] = 0.0f;
#pragma unroll
          for (int p = 0; p < P; ++p) {
            const float h2 = tanhf(z[p][u]);
            dv[u] += gb[p] * h2;
            const float dz = (gb[p] * vk) * (1.0f - h2 * h2);
            dz2s[p * HP + k] = dz;
            kahan_add(db1[u], db1_c[u], dz);
          }
        }
        __syncwarp();

        // s = W1·dz2 at this lane's units h = lane + 32u, summed over k in
        // order from the staged dz2
        float s[P][U];
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int p = 0; p < P; ++p) s[p][u] = 0.0f;
#pragma unroll 2
        for (int q = 0; q < HP / 4; ++q) {
          float4 dq[P];
#pragma unroll
          for (int p = 0; p < P; ++p) dq[p] = quad(dz2s + p * HP, q);
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const float* wrow = sm + L::W1 + (lane + WARP * u) * L::LDW + 4 * q;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float w = wrow[j];
#pragma unroll
              for (int p = 0; p < P; ++p) s[p][u] += w * lane_of(dq[p], j);
            }
          }
        }

        // dz1 = s·(1 − h1²), dx, and da, dc summed over the warp's paths
        float dxm[P];
#pragma unroll
        for (int p = 0; p < P; ++p) dxm[p] = 0.0f;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int k = lane + WARP * u;
          const float ak = sm[L::A + r * HP + k];
          float da = 0.0f, dc = 0.0f;
#pragma unroll
          for (int p = 0; p < P; ++p) {
            const float dz1 = s[p][u] * (1.0f - h1[p][u] * h1[p][u]);
            dxm[p] += dz1 * ak;
            da += dz1 * xb[p];
            dc += dz1;
          }
          float* wsw = ws + warp * 3 * HP;
          wsw[k] = da;
          wsw[HP + k] = dc;
          wsw[2 * HP + k] = dv[u];
        }
#pragma unroll
        for (int p = 0; p < P; ++p) kahan_add(dxb[p], dxb_c[p], dxm[p]);
        __syncthreads();  // the tile's h1, dz2 and the warps' sums are in

        // the block: h1ᵀ·dz2 over the tile's paths into the micro-tiles
        const float* hrow = sm + B::H1S + rt;
        const float* drow = sm + B::DZ2S + ct;
#pragma unroll 2
        for (int j = 0; j < L::TILE; ++j) {
          float hv[RM], dv2[CM];
#pragma unroll
          for (int i = 0; i < RM; ++i) hv[i] = hrow[j * HP + 16 * i];
#pragma unroll
          for (int i = 0; i < CM; ++i) dv2[i] = drow[j * HP + 16 * i];
#pragma unroll
          for (int i = 0; i < RM; ++i)
#pragma unroll
            for (int k = 0; k < CM; ++k) acc[i][k] += hv[i] * dv2[k];
        }
        // the block: the node's da, dc, dv summed over the warps in order
        for (int q = tid; q < 3 * h; q += THREADS) {
          const int seg = q / h, idx = q % h;
          float t = ws[seg * HP + idx];
#pragma unroll
          for (int w = 1; w < WARPS; ++w) t += ws[(w * 3 + seg) * HP + idx];
          float* dst = my_part + kept + (size_t)seg * m * h +
                       (size_t)(m0 + r) * h + idx;
          *dst = first ? t : *dst + t;
        }
        __syncthreads();  // the staging rows are free for the next node
      }
      // the chunk's micro-tiles into the partial's dW1 (entries past h are
      // the padding's, dropped)
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int k = 0; k < CM; ++k) {
          const int row = rt + 16 * i, col = ct + 16 * k;
          if (row < h && col < h) {
            float* dst = my_part + (size_t)row * h + col;
            *dst = dw_first ? acc[i][k] : *dst + acc[i][k];
          }
          acc[i][k] = 0.0f;
        }
      dw_first = false;
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float total = warp_sum(dxb[p]);
      if (lane == 0 && b0 + p < batch) dx[b0 + p] = total;
    }
  }
  // db1: the warps' lane sums of their units, added in warp order
  __syncthreads();
#pragma unroll
  for (int u = 0; u < U; ++u) ws[warp * HP + lane + WARP * u] = db1[u];
  __syncthreads();
  for (int q = tid; q < h; q += THREADS) {
    float t = ws[q];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) t += ws[w * HP + q];
    my_part[(size_t)h * h + q] = t;
  }
}

// The shared memory above 48 KB needs the kernel's opt-in before a launch.
template <int HP>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(bwd_kernel<HP>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)(sizeof(float) * Bwd<HP>::SIZE));
}

template <int HP>
cudaError_t info_bwd(int* smem, int* blocks_per_sm) {
  *smem = (int)(sizeof(float) * Bwd<HP>::SIZE);
  const cudaError_t err = allow_smem<HP>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, bwd_kernel<HP>, THREADS, *smem);
}

template <int HP>
cudaError_t launch_bwd(const float* x, const float* a, const float* c,
                       const float* w1, const float* b1, const float* v,
                       const float* g, float* dx, float* part, float* out,
                       int batch, int m, int h, int n_blocks,
                       cudaStream_t stream) {
  if (n_blocks > (batch + Wide<HP>::TILE - 1) / Wide<HP>::TILE)
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem<HP>();
  if (err != cudaSuccess) return err;
  bwd_kernel<HP><<<n_blocks, THREADS, sizeof(float) * Bwd<HP>::SIZE,
                   stream>>>(x, a, c, w1, b1, v, g, dx, part, batch, m, h);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_out = h * h + h + 3 * m * h;
  sweep::reduce_partials<<<(n_out + sweep::REDUCE_THREADS - 1) /
                               sweep::REDUCE_THREADS,
                           sweep::REDUCE_THREADS, 0, stream>>>(
      part, out, n_blocks, n_out);
  return cudaGetLastError();
}

}  // namespace sweep_wide

// C entry (bound with ctypes by ops/sweep.py b4_wide_backward).  x, g, dx
// (batch,); a, c, v (m, hidden); w1 (hidden, hidden); b1 (hidden,); part
// n_blocks partials of (hidden² + hidden + 3·m·hidden) floats, n_blocks in
// [1, number of tiles]; out one of them, the sum.  Returns the launches'
// cudaError_t; cudaErrorInvalidValue for a hidden width outside 1..128.
extern "C" int sweep_wide_bwd(const float* x, const float* a, const float* c,
                              const float* w1, const float* b1,
                              const float* v, const float* g, float* dx,
                              float* part, float* out, int batch, int m,
                              int hidden, int n_blocks, void* stream) {
  using namespace sweep_wide;
  if (batch < 1 || m < 1 || n_blocks < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (width_class(hidden)) {
    case 32:
      return (int)launch_bwd<32>(x, a, c, w1, b1, v, g, dx, part, out, batch,
                                 m, hidden, n_blocks, st);
    case 64:
      return (int)launch_bwd<64>(x, a, c, w1, b1, v, g, dx, part, out, batch,
                                 m, hidden, n_blocks, st);
    case 128:
      return (int)launch_bwd<128>(x, a, c, w1, b1, v, g, dx, part, out,
                                  batch, m, hidden, n_blocks, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The kernel's dynamic shared memory per block and its resident blocks per
// SM at the width class of ``hidden`` (chip_smoke.py reports them).
extern "C" int sweep_wide_bwd_info(int hidden, int* smem, int* blocks_per_sm) {
  using namespace sweep_wide;
  switch (width_class(hidden)) {
    case 32:
      return (int)info_bwd<32>(smem, blocks_per_sm);
    case 64:
      return (int)info_bwd<64>(smem, blocks_per_sm);
    case 128:
      return (int)info_bwd<128>(smem, blocks_per_sm);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
