// Kernel B1: the whole N-step forward of the hoisted Merton global rollout.
//
// Replaces the Pallas kernel of the JAX package's ops/pallas_rollout.py,
// make_fused_rollout -> _make_fwd_kernel(save)._fwd_kernel (its call site is
// _fwd_call).
//
// What bounds it on an H100: arithmetic.  Per path and step it does about
// 2H² + 10H FLOPs of the Γ head, 2H tanhf and three degree-7 Clenshaw
// evaluations (~1.2 kFLOP at H = 21), and it moves 16 bytes (dW and J read,
// the xs and ys residuals written): ~75 FLOP per byte, far above the card's
// FP32 ridge of 67 TFLOP/s over 3.35 TB/s = 20 FLOP per byte.
//
// Design: one thread per path.  The carries x and y and the hidden
// activations live in registers for the whole rollout; the head's weights
// sit in shared memory, rows padded to a multiple of 4 floats
// (rollout_common.cuh), where every thread of a warp reads the same float4
// at the same time (a broadcast): 162 16-byte loads per path-step at
// H = 21 where scalar reads took 567, every sum in the same order, so the
// results are those of the scalar version bit for bit.  Γ is summed as
// each quad of h2 is made, so h2 never lives whole.  What is left is
// mostly the 2H accurate tanhf (~40% of the instructions) and the 441 FMAs
// of the H×H layer.  The three tables' rows of a step (768 bytes
// at P = 8) are shared by all paths and come through the read-only cache.
// The (N, B) noise and residual rows are read and written coalesced, one
// word per thread per step.  After the weight load the threads never
// communicate, so the kernel takes any N and any B: the ragged last block
// simply has idle threads.  The TPU kernel's tile size, batch % TILE == 0
// and its N·TILE VMEM envelope do not carry over.
//
// The template flag TF is the head-TF32 mode (rollout_common.cuh
// tf32_round): h1 and W2 enter the H×H layer rounded to TF32, the sums in
// f32 in the same order.  Without it the kernel is the FP32 one, unchanged.
//
// Two paths a thread (256 a block, each float4 broadcast feeding both
// paths' FMAs, every sum in the same order, the outputs this layout's bit
// for bit) did not pay on an H100 80GB at 700 W, in either instance: at
// H = 21 and B = 2^17 the pair issued 6% fewer instructions a path-step but
// left 16 warps an SM, and the kernel, latency-bound there, ran 9-10%
// slower; at H = 8 it ran 2-4% faster at 2^17 only, where both layouts
// put at most 1024 paths on an SM, and 7-16% slower at 118272 and 65536
// paths.
#include "rollout_common.cuh"

namespace rollout {

constexpr int FWD_THREADS = 128;

template <int H, bool TF>
__global__ void __launch_bounds__(FWD_THREADS)
fwd_kernel(const float* __restrict__ dw, const float* __restrict__ jr,
           const float* __restrict__ cc, const float* __restrict__ pc,
           const float* __restrict__ zc, const float* __restrict__ lo,
           const float* __restrict__ hi, const float* __restrict__ w1,
           const float* __restrict__ b1, const float* __restrict__ w2,
           const float* __restrict__ b2, const float* __restrict__ w3,
           const float* __restrict__ y0, float* __restrict__ xn,
           float* __restrict__ yn, float* __restrict__ xs,
           float* __restrict__ ys, int n, int batch, int p, Consts c,
           float x0) {
  using L = Head<H>;
  __shared__ __align__(16) float sw[L::SIZE];
  load_head<H, TF>(sw, w1, b1, w2, b2, w3);
  __syncthreads();
  const int b = blockIdx.x * FWD_THREADS + threadIdx.x;
  if (b >= batch) return;
  const bool save = xs != nullptr;
  float x = x0;
  float y = __ldg(y0);
  float h1[H];
  for (int i = 0; i < n; ++i) {
    const size_t off = (size_t)i * batch + b;
    if (save) xs[off] = x;
    const float dwr = __ldg(dw + off);
    const float jv = __ldg(jr + off);
    const Piece pk = locate(x, __ldg(lo + i), __ldg(hi + i), p);
    const size_t row = ((size_t)i * p + pk.k) * D;
    const float comp = clenshaw(cc + row, pk.t);
    first_layer<H, TF>(sw, c.time_scale * (float)i, x, jv, h1);
    // Γ summed over the outputs in order as each quad of h2 is made
    float gam = 0.0f;
#pragma unroll
    for (int q = 0; q < L::QUADS; ++q) {
      float h2[4];
      second_layer_quad<H, TF>(sw, h1, q, h2);
      const float4 w3 = quad(sw + L::W3, q);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (4 * q + k < H) gam += h2[k] * lane_of(w3, k);
    }
    y = y * c.growth + gam - comp;
    y = y + clenshaw(zc + row, pk.t) * dwr;
    const float a = clenshaw(pc + row, pk.t);
    if (save) ys[off] = y;
    const float e = 1.0f + expm1_acc(c.drift + c.sigma * dwr + jv);
    x = x * e + (c.a_lin * fabsf(y - a)) * c.dt;
  }
  xn[b] = x;
  yn[b] = y;
}

template <int H, bool TF>
cudaError_t info_fwd(int* smem, int* blocks_per_sm) {
  *smem = (int)(sizeof(float) * Head<H>::SIZE);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, fwd_kernel<H, TF>, FWD_THREADS, 0);
}

template <bool TF>
int info_fwd_at(int hidden, int* smem, int* blocks_per_sm) {
  switch (hidden) {
    case 8:
      return (int)info_fwd<8, TF>(smem, blocks_per_sm);
    case 21:
      return (int)info_fwd<21, TF>(smem, blocks_per_sm);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <int H, bool TF>
cudaError_t launch_fwd(const float* dw, const float* jr, const float* cc,
                       const float* pc, const float* zc, const float* lo,
                       const float* hi, const float* w1, const float* b1,
                       const float* w2, const float* b2, const float* w3,
                       const float* y0, float* xn, float* yn, float* xs,
                       float* ys, int n, int batch, int p, Consts c, float x0,
                       cudaStream_t stream) {
  const int blocks = (batch + FWD_THREADS - 1) / FWD_THREADS;
  fwd_kernel<H, TF><<<blocks, FWD_THREADS, 0, stream>>>(
      dw, jr, cc, pc, zc, lo, hi, w1, b1, w2, b2, w3, y0, xn, yn, xs, ys, n,
      batch, p, c, x0);
  return cudaGetLastError();
}

}  // namespace rollout

// C entry (bound with ctypes by ops/rollout.py b1_forward).  xs and ys may
// be null: the residuals are then not written.  head_tf32 != 0 selects the
// head-TF32 instance.  Returns the launch's cudaError_t;
// cudaErrorInvalidValue for a hidden width not built here.
extern "C" int rollout_fwd(const float* dw, const float* jr, const float* cc,
                           const float* pc, const float* zc, const float* lo,
                           const float* hi, const float* w1, const float* b1,
                           const float* w2, const float* b2, const float* w3,
                           const float* y0, float* xn, float* yn, float* xs,
                           float* ys, int n, int batch, int n_pieces,
                           int hidden, int head_tf32, float time_scale,
                           float growth, float a_lin, float dt, float sigma,
                           float drift, float x0, void* stream) {
  using namespace rollout;
  if ((xs == nullptr) != (ys == nullptr) || n < 1 || batch < 1 ||
      n_pieces < 1)
    return (int)cudaErrorInvalidValue;
  const Consts c{time_scale, growth, a_lin, dt, sigma, drift};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (hidden * 2 + (head_tf32 != 0)) {
#define ROLLOUT_FWD_CASE(H, TF)                                              \
  case H * 2 + TF:                                                           \
    return (int)launch_fwd<H, TF>(dw, jr, cc, pc, zc, lo, hi, w1, b1, w2,    \
                                  b2, w3, y0, xn, yn, xs, ys, n, batch,      \
                                  n_pieces, c, x0, st);
    ROLLOUT_FWD_CASE(8, false)
    ROLLOUT_FWD_CASE(8, true)
    ROLLOUT_FWD_CASE(21, false)
    ROLLOUT_FWD_CASE(21, true)
#undef ROLLOUT_FWD_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The kernel's static shared memory per block and its resident blocks per
// SM at ``hidden`` (chip_smoke.py and kernel_ab.py report them), of the
// FP32 instance and of the head-TF32 one.
extern "C" int rollout_fwd_info(int hidden, int* smem, int* blocks_per_sm) {
  return rollout::info_fwd_at<false>(hidden, smem, blocks_per_sm);
}

extern "C" int rollout_fwd_tf32_info(int hidden, int* smem,
                                     int* blocks_per_sm) {
  return rollout::info_fwd_at<true>(hidden, smem, blocks_per_sm);
}
