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
// MXU; here they go to the tensor cores in split TF32 (tc_split.cuh).
//
// What bounds it on an H100: the three products Z = h1·W1 (recomputed),
// S = dz2·W1ᵀ and dW1 += h1ᵀ·dz2, 6H² operations per path and node (3·6H²
// on the tensor cores), and 20H FP32 operations around them with 2H
// accurate tanhf, over 12 bytes per path and the node rows.
//
// Design: a fixed number of blocks (ops/sweep.py b4_wide_blocks, at most
// 264) each walk their 128-path tiles in order, eight warps of one m16 tile
// of 16 paths each.  W1 sits in shared memory once, in f32 (tc_split.cuh
// tc::w_at: a layout that serves both products' fragments), and is split into
// hi and lo as its fragments are read: its split planes and the staging
// below do not fit the 227 KB of a block together at HP = 128.  A node's
// rows of a, c and v are double-buffered in shared memory, the next loaded
// while the block sums the current one.  Per node:
//   * each warp computes h1 of its 16 paths at its lanes' units (the A
//     layout of tc_split.cuh) into its staging rows, then Z = h1·W1 four
//     n-tiles at a time (the A fragments read back from the staging rows,
//     split; hi·hi and the cross terms in two accumulators), then b1, h2,
//     dz2 = g·v·(1 − h2²) into the staging rows, and the sums of g·h2 (dv)
//     and dz2 (db1) over its paths (a fixed shuffle tree, ``reduce_rows``)
//     into the warp's slot;
//   * then S = dz2·W1ᵀ four n-tiles at a time, dz2 from the staging rows in
//     the layout it was written (C = A up to the permutation W1ᵀ's rows
//     carry), dz1 = S·(1 − h1²), dx per path in a compensated sum across
//     the nodes, and the sums of dz1·x (da) and dz1 (dc) over its paths;
//   * one barrier; then the block adds h1ᵀ·dz2 over its 128 staged paths on
//     the tensor cores into fresh fragments of dW1 (each warp a 2-D tile of
//     them; the paths are the contraction, read as fragments from the
//     staging rows, split), and those into per-warp running sums with f32
//     adds that round to nearest; it sums the warps' da, dc, dv in warp
//     order into its partial in device memory (written on the block's first
//     tile, added to after) and db1 into a compensated sum per unit; a
//     second barrier frees the staging for the next node;
//   * every NODE_CHUNK nodes, and at the end of a tile, the running sums of
//     dW1 are added into the partial's dW1, so an f32 register sum runs
//     over at most NODE_CHUNK block sums; at the end of the walk db1.
// A second kernel sums the blocks' partials in block order.  No float
// atomics: two runs on the same inputs give the same bits, and the partial
// buffer holds at most 264 × (H² + H + 3·M·H) floats whatever B.
#include "sweep_wide.cuh"

namespace sweep_wide {

template <int HP>
struct Bwd {
  using M = Mma<HP>;
  static constexpr int NB = M::NB, LDS = M::LDS, TILE = M::TILE;
  // the warps' 2-D tiling of dW1: WM × WN warps, each TM m16 tiles (rows of
  // W1) × TN n8 tiles (columns)
  static constexpr int MT = HP / 16;
  static constexpr int WM = MT < 4 ? MT : 4, WN = WARPS / WM;
  static constexpr int TM = MT / WM, TN = NB / WN;
  static_assert(WM * WN == WARPS && TM * WM == MT && TN * WN == NB,
                "the warps tile dW1");
  // shared memory, floats: W1 (w_at) | b1 (HP) | two buffers of a node's
  // a, c, v rows (3 HP each) | the tile's h1 rows (TILE of LDS) | its dz2
  // rows | per warp the node's da, dc, dv, db1 (4 HP)
  static constexpr int W1 = 0;
  static constexpr int B1 = HP * HP;
  static constexpr int ROWS = B1 + HP;
  static constexpr int H1S = ROWS + 2 * 3 * HP;
  static constexpr int DZ2S = H1S + TILE * LDS;
  static constexpr int WS = DZ2S + TILE * LDS;
  static constexpr int SIZE = WS + WARPS * 4 * HP;
};

// Node ``node``'s rows of a, c and v into ``dst`` (3 rows of HP), zero past h.
template <int HP>
__device__ __forceinline__ void load_node(float* dst,
                                          const float* __restrict__ a,
                                          const float* __restrict__ c,
                                          const float* __restrict__ v,
                                          int node, int h) {
  for (int q = threadIdx.x; q < 3 * HP; q += blockDim.x) {
    const int which = q / HP, col = q % HP;
    const float* src = which == 0 ? a : which == 1 ? c : v;
    dst[q] = col < h ? __ldg(src + (size_t)node * h + col) : 0.0f;
  }
}

// The split A fragment of k-step k from a warp's staging rows (as h1 and
// dz2 are written): (path g, unit 8k + 2t) → a0, (g + 8, 8k + 2t) → a1,
// (g, 8k + 2t + 1) → a2, (g + 8, 8k + 2t + 1) → a3.
__device__ __forceinline__ void a_from_rows(const float* rows, int s0, int s1,
                                            int k, float (&ah)[4],
                                            float (&al)[4]) {
  const float2 p0 = *reinterpret_cast<const float2*>(rows + s0 + 8 * k);
  const float2 p1 = *reinterpret_cast<const float2*>(rows + s1 + 8 * k);
  split_tf32(p0.x, ah[0], al[0]);
  split_tf32(p1.x, ah[1], al[1]);
  split_tf32(p0.y, ah[2], al[2]);
  split_tf32(p1.y, ah[3], al[3]);
}

template <int HP>
__global__ void __launch_bounds__(THREADS)
bwd_kernel(const float* __restrict__ x, const float* __restrict__ a,
           const float* __restrict__ c, const float* __restrict__ w1,
           const float* __restrict__ b1, const float* __restrict__ v,
           const float* __restrict__ g, float* __restrict__ dx,
           float* __restrict__ part, int batch, int m, int h) {
  using B = Bwd<HP>;
  constexpr int NB = B::NB, NG = Mma<HP>::NG, LDS = B::LDS;
  constexpr int TM = B::TM, TN = B::TN;
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const int tid = threadIdx.x, lane = tid % WARP, warp = tid / WARP;
  const int gq = lane / 4, t = lane % 4;
  const int n_tiles = (batch + B::TILE - 1) / B::TILE;
  const size_t kept = (size_t)h * h + h;
  float* my_part = part + (size_t)blockIdx.x * (kept + 3 * (size_t)m * h);
  // this warp's staging rows, and this lane's offsets in them: rows g and
  // g + 8, column 2t
  float* h1w = sm + B::H1S + warp * 16 * LDS;
  float* dzw = sm + B::DZ2S + warp * 16 * LDS;
  const int s0 = gq * LDS + 2 * t, s1 = s0 + 8 * LDS;
  // offsets in an 8 × 8 block of W1: h1·W1's b0 (row 2t, column g; b1 is
  // the next float), dz2·W1ᵀ's b0 (row g, column 2t) and b1 (column 2t + 1)
  const int oz = w_at<HP>(2 * t, gq);
  const int os0 = w_at<HP>(gq, 2 * t), os1 = w_at<HP>(gq, 2 * t + 1);
  // this warp's tile of dW1: rows 16·(TM·wm + i) + …, columns 8·(TN·wn + j)
  const int wm = warp % B::WM, wn = warp / B::WM;
  float* ws = sm + B::WS;

  for (int q = tid; q < HP * HP; q += THREADS) {
    const int row = q / HP, col = q % HP;
    sm[B::W1 + w_at<HP>(row, col)] =
        (row < h && col < h) ? __ldg(w1 + row * h + col) : 0.0f;
  }
  for (int q = tid; q < HP; q += THREADS)
    sm[B::B1 + q] = q < h ? __ldg(b1 + q) : 0.0f;

  float run[TM][TN][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) run[i][j][e] = 0.0f;
  float db1s = 0.0f, db1c = 0.0f;  // db1[tid] of the block, tid < h
  bool dw_first = true;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const bool first = tile == (int)blockIdx.x;
    // idle paths of the ragged last tile carry a zero cotangent, so every
    // sum they enter gets exact zeros from them
    const int b0 = tile * B::TILE + warp * 16 + gq;  // paths b0, b0 + 8
    float xb[2], gb[2], dxs[2], dxc[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int b = b0 + 8 * e;
      xb[e] = b < batch ? __ldg(x + b) : 0.0f;
      gb[e] = b < batch ? __ldg(g + b) : 0.0f;
      dxs[e] = 0.0f;
      dxc[e] = 0.0f;
    }
    load_node<HP>(sm + B::ROWS, a, c, v, 0, h);
    __syncthreads();  // W1, b1 and node 0's rows are in
#pragma unroll 1
    for (int node = 0; node < m; ++node) {
      const float* ra = sm + B::ROWS + (node & 1) * 3 * HP;
      const float* rc = ra + HP;
      const float* rv = rc + HP;

      // h1 of the warp's paths into its staging rows
#pragma unroll
      for (int k = 0; k < NB; ++k) {
        const int u = 8 * k + 2 * t;
        const float2 ak = *reinterpret_cast<const float2*>(ra + u);
        const float2 ck = *reinterpret_cast<const float2*>(rc + u);
        *reinterpret_cast<float2*>(h1w + s0 + 8 * k) = make_float2(
            tanhf(xb[0] * ak.x + ck.x), tanhf(xb[0] * ak.y + ck.y));
        *reinterpret_cast<float2*>(h1w + s1 + 8 * k) = make_float2(
            tanhf(xb[1] * ak.x + ck.x), tanhf(xb[1] * ak.y + ck.y));
      }

      // Z = h1·W1 + b1 by groups of NG n-tiles; h2, dz2, and the sums of
      // dv and db1 over the warp's paths
#pragma unroll 1
      for (int n0 = 0; n0 < NB; n0 += NG) {
        float zb[NG][4], zs[NG][4];
#pragma unroll
        for (int q = 0; q < NG; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            zb[q][e] = 0.0f;
            zs[q][e] = 0.0f;
          }
#pragma unroll
        for (int k = 0; k < NB; ++k) {
          float ah[4], al[4];
          a_from_rows(h1w, s0, s1, k, ah, al);
#pragma unroll
          for (int q = 0; q < NG; ++q) {
            const float2 w = *reinterpret_cast<const float2*>(
                sm + B::W1 + (k * NB + n0 + q) * 64 + oz);
            float bh[2], bl[2];
            split_tf32(w.x, bh[0], bl[0]);
            split_tf32(w.y, bh[1], bl[1]);
            mma_split(zb[q], zs[q], ah, al, bh, bl);
          }
        }
        // red: dv at units u, u + 1 of each n-tile, then db1 likewise
        float red[4 * NG];
#pragma unroll
        for (int q = 0; q < NG; ++q) {
          const int u = 8 * (n0 + q) + 2 * t;
          const float2 bk = *reinterpret_cast<const float2*>(sm + B::B1 + u);
          const float2 vk = *reinterpret_cast<const float2*>(rv + u);
          float h2[2][2], dz[2][2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            h2[e][0] = tanhf(zb[q][2 * e] + zs[q][2 * e] + bk.x);
            h2[e][1] = tanhf(zb[q][2 * e + 1] + zs[q][2 * e + 1] + bk.y);
            dz[e][0] = (gb[e] * vk.x) * (1.0f - h2[e][0] * h2[e][0]);
            dz[e][1] = (gb[e] * vk.y) * (1.0f - h2[e][1] * h2[e][1]);
          }
          *reinterpret_cast<float2*>(dzw + s0 + 8 * (n0 + q)) =
              make_float2(dz[0][0], dz[0][1]);
          *reinterpret_cast<float2*>(dzw + s1 + 8 * (n0 + q)) =
              make_float2(dz[1][0], dz[1][1]);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            red[2 * q + j] = gb[0] * h2[0][j] + gb[1] * h2[1][j];
            red[2 * NG + 2 * q + j] = dz[0][j] + dz[1][j];
          }
        }
        reduce_rows<4 * NG>(red, lane);
        // lane (g, t) now holds entries 2g, 2g + 1: dv (g < 4) or db1, at
        // units 8·(n0 + g % 4) + 2t, + 1
        *reinterpret_cast<float2*>(
            ws + (warp * 4 + 2 + gq / 4) * HP + 8 * (n0 + gq % 4) + 2 * t) =
            make_float2(red[0], red[1]);
      }

      // S = dz2·W1ᵀ by groups of NG n-tiles (units of h1); dz1, dx, and the
      // sums of da and dc over the warp's paths
      float dxm[2] = {0.0f, 0.0f};
#pragma unroll 1
      for (int n0 = 0; n0 < NB; n0 += NG) {
        float sb[NG][4], ss[NG][4];
#pragma unroll
        for (int q = 0; q < NG; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sb[q][e] = 0.0f;
            ss[q][e] = 0.0f;
          }
#pragma unroll
        for (int k = 0; k < NB; ++k) {
          float ah[4], al[4];
          a_from_rows(dzw, s0, s1, k, ah, al);
#pragma unroll
          for (int q = 0; q < NG; ++q) {
            const float* blk = sm + B::W1 + ((n0 + q) * NB + k) * 64;
            float bh[2], bl[2];
            split_tf32(blk[os0], bh[0], bl[0]);
            split_tf32(blk[os1], bh[1], bl[1]);
            mma_split(sb[q], ss[q], ah, al, bh, bl);
          }
        }
        float red[4 * NG];
#pragma unroll
        for (int q = 0; q < NG; ++q) {
          const int u = 8 * (n0 + q) + 2 * t;
          const float2 ak = *reinterpret_cast<const float2*>(ra + u);
          const float2 p[2] = {
              *reinterpret_cast<const float2*>(h1w + s0 + 8 * (n0 + q)),
              *reinterpret_cast<const float2*>(h1w + s1 + 8 * (n0 + q))};
          float dz1[2][2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float s0 = sb[q][2 * e] + ss[q][2 * e];
            const float s1 = sb[q][2 * e + 1] + ss[q][2 * e + 1];
            dz1[e][0] = s0 * (1.0f - p[e].x * p[e].x);
            dz1[e][1] = s1 * (1.0f - p[e].y * p[e].y);
            dxm[e] += dz1[e][0] * ak.x + dz1[e][1] * ak.y;
          }
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            red[2 * q + j] = dz1[0][j] * xb[0] + dz1[1][j] * xb[1];
            red[2 * NG + 2 * q + j] = dz1[0][j] + dz1[1][j];
          }
        }
        reduce_rows<4 * NG>(red, lane);
        // entries 2g, 2g + 1: da (g < 4) or dc
        *reinterpret_cast<float2*>(
            ws + (warp * 4 + gq / 4) * HP + 8 * (n0 + gq % 4) + 2 * t) =
            make_float2(red[0], red[1]);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) kahan_add(dxs[e], dxc[e], dxm[e]);
      __syncthreads();  // the tile's h1, dz2 and the warps' sums are in

      // the block: h1ᵀ·dz2 over the tile's 128 paths (the contraction, in
      // k-steps of 8: rows 8k + t and 8k + t + 4 of the staging) into fresh
      // fragments of this warp's tile of dW1, then into its running sums
      {
        float f[TM][TN][4];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) f[i][j][e] = 0.0f;
#pragma unroll 2
        for (int k = 0; k < B::TILE / 8; ++k) {
          const float* hr = sm + B::H1S + (8 * k + t) * LDS;
          const float* dr = sm + B::DZ2S + (8 * k + t) * LDS;
          float ah[TM][4], al[TM][4];
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const int r0 = 16 * (TM * wm + i) + gq;
            split_tf32(hr[r0], ah[i][0], al[i][0]);
            split_tf32(hr[r0 + 8], ah[i][1], al[i][1]);
            split_tf32(hr[4 * LDS + r0], ah[i][2], al[i][2]);
            split_tf32(hr[4 * LDS + r0 + 8], ah[i][3], al[i][3]);
          }
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            const int c0 = 8 * (TN * wn + j) + gq;
            float bh[2], bl[2];
            split_tf32(dr[c0], bh[0], bl[0]);
            split_tf32(dr[4 * LDS + c0], bh[1], bl[1]);
#pragma unroll
            for (int i = 0; i < TM; ++i)
              mma_split(f[i][j], f[i][j], ah[i], al[i], bh, bl);
          }
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) run[i][j][e] += f[i][j][e];
      }
      // the block: the node's da, dc, dv summed over the warps in order
      // into the partial, db1 into its compensated sums
      for (int q = tid; q < 3 * h; q += THREADS) {
        const int seg = q / h, idx = q % h;
        float s = ws[seg * HP + idx];
#pragma unroll
        for (int w = 1; w < WARPS; ++w) s += ws[(w * 4 + seg) * HP + idx];
        float* dst = my_part + kept + (size_t)seg * m * h +
                     (size_t)node * h + idx;
        *dst = first ? s : *dst + s;
      }
      if (tid < h) {
        float s = ws[3 * HP + tid];
#pragma unroll
        for (int w = 1; w < WARPS; ++w) s += ws[(w * 4 + 3) * HP + tid];
        kahan_add(db1s, db1c, s);
      }
      if (node + 1 < m)
        load_node<HP>(sm + B::ROWS + ((node + 1) & 1) * 3 * HP, a, c, v,
                      node + 1, h);
      // every NODE_CHUNK nodes and at the tile's end, the running sums into
      // the partial's dW1 (entries past h are the padding's, dropped)
      if ((node + 1) % NODE_CHUNK == 0 || node + 1 == m) {
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = 16 * (TM * wm + i) + gq + 8 * (e / 2);
              const int col = 8 * (TN * wn + j) + 2 * t + e % 2;
              if (row < h && col < h) {
                float* dst = my_part + (size_t)row * h + col;
                *dst = dw_first ? run[i][j][e] : *dst + run[i][j][e];
              }
              run[i][j][e] = 0.0f;
            }
        dw_first = false;
      }
      __syncthreads();  // the staging rows and slots are free, next rows in
    }
    // dx: the four lanes of each path in a fixed order
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float total = sum_lanes_t(dxs[e]);
      if (t == 0 && b0 + 8 * e < batch) dx[b0 + 8 * e] = total;
    }
  }
  if (tid < h) my_part[(size_t)h * h + tid] = db1s;
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
  if (n_blocks > (batch + Mma<HP>::TILE - 1) / Mma<HP>::TILE)
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
// [1, number of 128-path tiles]; out one of them, the sum.  Returns the
// launches' cudaError_t; cudaErrorInvalidValue for a hidden width outside
// 1..128.
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
