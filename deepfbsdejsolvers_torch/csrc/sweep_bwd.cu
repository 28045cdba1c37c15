// Kernel B4: the backward of the compensator sweep (ops/sweep.py) for a
// cotangent g (B,): dx per path; da, dc, dv per node; dW1 and db1.  With
// h1 = tanh(x·a_m + c_m), h2 = tanh(h1·W1 + b1) at path b and node m:
//   dz2 = g·v_m·(1 − h2²),  dz1 = (W1·dz2)·(1 − h1²),
//   dx_b = Σ_m dz1·a_m,  da_m = Σ_b dz1·x_b,  dc_m = Σ_b dz1,
//   dv_m = Σ_b g·h2,  dW1 = Σ_{b,m} h1 ⊗ dz2,  db1 = Σ_{b,m} dz2.
//
// Replaces the Pallas kernel of the JAX package's ops/pallas_sweep.py
// _bwd_kernel (its call site is _fused_sweep_bwd), without its MXU packing.
//
// What bounds it on an H100: arithmetic.  Per path and node it recomputes
// the hidden layers (2H² + 5H operations, 2H tanhf), runs their backward
// (2H² + 8H) and adds into the sums over paths (2H² + 9H): about three
// times B3's work over the same bytes.
//
// Design: one thread per path with dx in registers, as in B3.  The TPU
// kernel carries its sums across a sequential grid; CUDA blocks run in no
// order, so:
//   * a fixed number of blocks (ops/sweep.py b4_blocks, at most 512,
//     independent of B) each walk their 128-path tiles in order;
//   * per node, each thread writes its h1, dz2, dz1 and g·h2 to shared
//     memory (rows of 128 paths padded to 132 floats, read as float4s), and
//     then each thread takes a few of the H² + 4H sums over the block's
//     paths in a fixed order: dW1 and db1 stay in registers across nodes
//     and tiles; da, dc and dv of that node go to the block's partial in
//     device memory (written on the block's first tile, added to after);
//   * a second kernel sums the blocks' partials in block order.
// No float atomics, so two runs on the same inputs give the same bits, and
// the partial buffer holds at most 512 × (H² + H + 3·M·H) floats whatever B.
#include "sweep_common.cuh"

namespace sweep {

constexpr int LD = THREADS + 4;  // a row of one tile's paths, float4-aligned
constexpr int REDUCE_THREADS = 256;

// Shared-memory layout after the staged weights, in floats.
template <int H>
struct Rows {
  static constexpr int H1 = Stage<H>::SIZE;
  static constexpr int DZ2 = H1 + H * LD;
  static constexpr int DZ1 = DZ2 + H * LD;
  static constexpr int GH2 = DZ1 + H * LD;
  static constexpr int X = GH2 + H * LD;
  static constexpr int SIZE = X + LD;
};

// The sums a block takes over its paths, by index q: dW1 (H×H, row h ×
// column k) | db1 | da | dc | dv of the current node.  Output layout:
// dW1 | db1 | da (M×H) | dc (M×H) | dv (M×H).
template <int H>
struct Sums {
  static constexpr int KEPT = H * H + H;  // summed over nodes in registers
  static constexpr int N = KEPT + 3 * H;
  static constexpr int PER_THREAD = (N + THREADS - 1) / THREADS;
};

// Rows (A, B; B < 0 means a row of ones) of sum q.
template <int H>
__device__ __forceinline__ void sum_rows(int q, int* ra, int* rb) {
  using R = Rows<H>;
  if (q < H * H) {
    *ra = R::H1 + (q / H) * LD;
    *rb = R::DZ2 + (q % H) * LD;
    return;
  }
  const int seg = (q - H * H) / H, idx = (q - H * H) % H;
  switch (seg) {
    case 0: *ra = R::DZ2 + idx * LD; *rb = -1; break;     // db1
    case 1: *ra = R::DZ1 + idx * LD; *rb = R::X; break;   // da
    case 2: *ra = R::DZ1 + idx * LD; *rb = -1; break;     // dc
    default: *ra = R::GH2 + idx * LD; *rb = -1; break;    // dv
  }
}

// Σ over the tile's paths of row A (times row B), in path order by float4.
__device__ __forceinline__ float row_sum(const float* sm, int ra, int rb) {
  const float4* a4 = reinterpret_cast<const float4*>(sm + ra);
  float s = 0.0f;
  if (rb < 0) {
#pragma unroll 8
    for (int k = 0; k < THREADS / 4; ++k) {
      const float4 u = a4[k];
      s += u.x + u.y + u.z + u.w;
    }
  } else {
    const float4* b4 = reinterpret_cast<const float4*>(sm + rb);
#pragma unroll 8
    for (int k = 0; k < THREADS / 4; ++k) {
      const float4 u = a4[k], w = b4[k];
      s += u.x * w.x + u.y * w.y + u.z * w.z + u.w * w.w;
    }
  }
  return s;
}

template <int H>
__global__ void __launch_bounds__(THREADS)
bwd_kernel(const float* __restrict__ x, const float* __restrict__ a,
           const float* __restrict__ c, const float* __restrict__ w1,
           const float* __restrict__ b1, const float* __restrict__ v,
           const float* __restrict__ g, float* __restrict__ dx,
           float* __restrict__ part, int batch, int m) {
  using S = Stage<H>;
  using R = Rows<H>;
  using Q = Sums<H>;
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const int tid = threadIdx.x;
  const int n_tiles = (batch + THREADS - 1) / THREADS;
  const size_t n_out = (size_t)Q::KEPT + 3 * (size_t)m * H;
  float* my_part = part + (size_t)blockIdx.x * n_out;

  load_weights<H>(sm, w1, b1);
  int row_a[Q::PER_THREAD], row_b[Q::PER_THREAD];
  float acc[Q::PER_THREAD], acc_c[Q::PER_THREAD];
#pragma unroll
  for (int i = 0; i < Q::PER_THREAD; ++i) {
    const int q = tid + i * THREADS;
    row_a[i] = R::X;
    row_b[i] = -1;
    if (q < Q::N) sum_rows<H>(q, &row_a[i], &row_b[i]);
    acc[i] = 0.0f;
    acc_c[i] = 0.0f;
  }

  float h1[H], z[H], rv[S::HP], w[S::HP];
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const bool first = tile == (int)blockIdx.x;
    const int b = tile * THREADS + tid;
    const bool active = b < batch;
    // idle threads of the ragged last tile carry a zero cotangent, so every
    // sum they enter gets exact zeros from them
    const float xb = active ? __ldg(x + b) : 0.0f;
    const float gb = active ? __ldg(g + b) : 0.0f;
    __syncthreads();  // the previous tile's last sums are taken
    sm[R::X + tid] = xb;
    float dxb = 0.0f, dxb_c = 0.0f;
    for (int m0 = 0; m0 < m; m0 += NODE_CHUNK) {
      const int count = min(NODE_CHUNK, m - m0);
      __syncthreads();
      load_chunk<H>(sm, a, c, v, m0, count);
      __syncthreads();
      for (int r = 0; r < count; ++r) {
        hidden<H>(sm, r, xb, h1, z);
        load_row<H>(sm + S::V + r * S::HP, rv);
#pragma unroll
        for (int k = 0; k < H; ++k) {
          const float h2 = tanhf(z[k]);
          sm[R::GH2 + k * LD + tid] = gb * h2;
          z[k] = (gb * rv[k]) * (1.0f - h2 * h2);  // now dz2
          sm[R::DZ2 + k * LD + tid] = z[k];
        }
        load_row<H>(sm + S::A + r * S::HP, rv);  // now a of this node
        float dxm = 0.0f;
#pragma unroll
        for (int h = 0; h < H; ++h) {
          load_row<H>(sm + S::W1 + h * S::HP, w);
          float s = 0.0f;
#pragma unroll
          for (int k = 0; k < H; ++k) s += w[k] * z[k];
          const float dz1 = s * (1.0f - h1[h] * h1[h]);
          dxm += dz1 * rv[h];
          sm[R::H1 + h * LD + tid] = h1[h];
          sm[R::DZ1 + h * LD + tid] = dz1;
        }
        kahan_add(dxb, dxb_c, dxm);
        __syncthreads();
        const size_t node = (size_t)(m0 + r) * H;
#pragma unroll
        for (int i = 0; i < Q::PER_THREAD; ++i) {
          const int q = tid + i * THREADS;
          if (q < Q::N) {
            const float s = row_sum(sm, row_a[i], row_b[i]);
            if (q < Q::KEPT) {
              kahan_add(acc[i], acc_c[i], s);
            } else {
              const int seg = (q - Q::KEPT) / H, idx = (q - Q::KEPT) % H;
              float* dst = my_part + Q::KEPT + seg * (size_t)m * H + node + idx;
              *dst = first ? s : *dst + s;
            }
          }
        }
        __syncthreads();  // the rows are free for the next node
      }
    }
    if (active) dx[b] = dxb;
  }
#pragma unroll
  for (int i = 0; i < Q::PER_THREAD; ++i) {
    const int q = tid + i * THREADS;
    if (q < Q::KEPT) my_part[q] = acc[i];
  }
}

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

template <int H>
cudaError_t launch_bwd(const float* x, const float* a, const float* c,
                       const float* w1, const float* b1, const float* v,
                       const float* g, float* dx, float* part, float* out,
                       int batch, int m, int n_blocks, cudaStream_t stream) {
  const size_t smem = sizeof(float) * Rows<H>::SIZE;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  bwd_kernel<H><<<n_blocks, THREADS, smem, stream>>>(x, a, c, w1, b1, v, g,
                                                     dx, part, batch, m);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_out = Sums<H>::KEPT + 3 * m * H;
  reduce_partials<<<(n_out + REDUCE_THREADS - 1) / REDUCE_THREADS,
                    REDUCE_THREADS, 0, stream>>>(part, out, n_blocks, n_out);
  return cudaGetLastError();
}

}  // namespace sweep

// C entry (bound with ctypes by ops/sweep.py b4_backward).  x, g, dx
// (batch,); a, c, v (m, hidden); w1 (hidden, hidden); b1 (hidden,); part
// n_blocks partials of (hidden² + hidden + 3·m·hidden) floats, n_blocks in
// [1, ceil(batch / 128)]; out one of them, the sum.  Returns the launches'
// cudaError_t; cudaErrorInvalidValue for a hidden width not built here.
extern "C" int sweep_bwd(const float* x, const float* a, const float* c,
                         const float* w1, const float* b1, const float* v,
                         const float* g, float* dx, float* part, float* out,
                         int batch, int m, int hidden, int n_blocks,
                         void* stream) {
  using namespace sweep;
  if (batch < 1 || m < 1 || n_blocks < 1 ||
      n_blocks > (batch + THREADS - 1) / THREADS)
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
