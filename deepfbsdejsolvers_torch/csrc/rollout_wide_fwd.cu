// Kernel B1 at the wide head widths: the whole N-step forward of the
// hoisted Merton global rollout (ops/rollout.py) for any hidden width H in
// 1..128 other than 8 and 21, built for the width classes HP = 32, 64, 128
// (rollout_wide.cuh); the specialised rollout_fwd.cu keeps H = 8 and 21.
//
// Replaces the Pallas kernel of the JAX package's ops/pallas_rollout.py,
// make_fused_rollout -> _make_fwd_kernel(save)._fwd_kernel (its call site
// is _fwd_call), at the widths it takes beyond those two.
//
// What bounds it on an H100: FP32 issue.  Per path and step the Γ head
// takes 2H² + 10H operations with 2H accurate tanhf, beside three degree-7
// Clenshaw evaluations and the walk, over 16 bytes of noise and residuals.
//
// Why the FP32 instance's product h1·W2 stays in FP32 (B2w takes its three
// on the tensor cores): this kernel sets every path's trajectory, and the
// checks hold
// the loss's gradient, a sum over paths of (y_N − g(x_N)) times the
// path's sensitivities that largely cancels, to the plain version's.  The
// plain version's f32 forward drifts from a float64 evaluation by errors
// that the paths share (~1e-7 of y at the first steps, where the paths'
// inputs are equal or alike), and so does any other rounding of the same
// sums; the gradient magnifies the difference between two such drifts.
// Summing h1·W2, Γ and the first layer in the plain version's own order
// (one f32 fma a term, from zero, the bias added last) reproduces its
// rounding, and its loss to the last bit on the card.  On the tensor cores
// the kernel missed the 1e-4 check at hidden 20: 1.67e-4 with the product
// in split TF32 (W2 in three terms) and 2.31e-4 on the FP64 tensor cores
// (exact products, f64 sums), against 8.1e-6 for this order.
//
// Design: one kernel template, fwd_kernel<HP, TF>, for both instances.  A
// block of eight warps takes TILE = 8·P paths, each warp P = 32 / U of
// them, where U = HP / 32 is the hidden units a lane owns (lane l: units
// l + 32u), so that SPAN = 32 / P lanes share a path; it walks the N steps.
// Per step the lanes of each path look up its piece, evaluate the
// compensator table and broadcast x and J over the warp; each lane forms
// the first layer of its units for the warp's paths and stages it in
// shared memory; then Z = h1·W2 at its units: the quad loop takes the four
// W2 rows of a quad of h once (4U values in registers) and the paths one
// at a time, one float4 broadcast of h1 each, so that each W2 value read
// from shared memory serves P paths and the registers hold the P·U
// accumulators, not P float4s of h1.  Each accumulator sums over h in order
// from zero, one f32 fma a term, the bias b2 (in registers) added last.
// The lane stages h2, and the lanes of each path sum Γ = Σ_o W3[o]·h2[o]
// over the outputs in order, as B1 and the plain version's matmul do (a
// shuffle tree rounds it otherwise, the same way for every path of equal
// inputs, and the loss's gradient, a sum over paths, magnifies that), then
// update y and walk x exactly as B1 does.  No barrier after the weight load
// but __syncwarp, so the kernel takes any N and B: the ragged last block's
// idle paths compute on zero noise and write nothing.
//
// TF (head_tf32 != 0) changes two things: W2 is loaded rounded to TF32,
// and h1 is summed as first_sum_tf32 sums it (so that h1 is the plain
// version's bits) and staged rounded; the products of two TF32 values are
// exact in f32 and the sums are the plain version's.  Without TF the first
// layer's sum is written out in the FMAs of the FP32 instance's earlier
// layout of 16 / U paths a warp (first_sum), and only which lane holds
// which path differs from that layout, so the FP32 instance's outputs are
// the earlier kernel's bit for bit.  The register tiling took it on an
// NVIDIA H100 80GB HBM3 at 700 W (kernel_ab.py --wide-rollout, B = 2^17,
// N = 50, in turns) from 0.99 to 0.92 ms at HP 32, 2.27 to 2.15 at 64 and
// 8.26 to 6.59 at 128.  Larger tiles did not pay: 32 paths a warp at HP 64
// (128 registers, 2 blocks an SM) ran 2.15 ms, its TF instance 2.21
// against 2.18; 16 at HP 128 (1 block an SM) 9.99 against 6.59.  The path
// index stays an int: in 64 bits the TF instance ran 2.39 ms at HP 64
// against 2.22.
//
// The TF instance's product on the tensor cores (B2w's layout, h1 rounded
// in registers as the A operand, one TF32 mma.sync pass, h2 staged 32 units
// at a time for the in-order Γ sum) ran 0.54, 1.04 and 2.28 ms at HP 32,
// 64 and 128 (NVIDIA H100 80GB HBM3, 700 W, kernel_ab.py --wide-rollout,
// B = 2^17, N = 50) and missed the
// B1 + B2 gradient check at hidden 20: global 1.02e-4, per leaf up to
// 2.9e-4 (y0), against 2.6e-6 for this order (tolerance 1e-4).  Its
// trajectories held step by step (Σ of the local errors 9.3e-6) and the
// loss held (2.5e-7); the gradient, which cancels, did not.  The tensor
// cores' sums truncate where the plain version's f32 FMAs round to
// nearest, shifting every path's Z toward zero alike; emulated on the CPU
// (tests/test_torch_rollout_tf32.py) a sum of the same order that rounds
// to nearest holds, one that truncates misses, and keeping the plain order
// at step 0 alone, where the paths share their inputs, does not save it.
#include "rollout_wide.cuh"

namespace rollout_wide {

// B1w's layout: lane l owns the U = HP / 32 hidden units k = l + 32u of P =
// 32 / U paths a warp, SPAN = 32 / P lanes a path, TILE = 8·P paths a
// block; in shared memory W2 with a row stride of HP + 1 floats, so that
// lane l reading row h at column l + 32u is free of bank conflicts, then
// W3, then per warp its P staging rows of HP (h1, then h2).
template <int HP>
struct Lanes {
  static_assert(HP == 32 || HP == 64 || HP == 128, "width class");
  static constexpr int U = HP / WARP;
  static constexpr int P = WARP / U;
  static constexpr int TILE = WARPS * P;
  static constexpr int SPAN = WARP / P;
  static constexpr int LDW = HP + 1;
  static constexpr int W3 = (HP * LDW + 3) / 4 * 4;
  static constexpr int STAGE = W3 + HP;
  static constexpr int SIZE = STAGE + WARPS * P * HP;
  static_assert(STAGE % 4 == 0, "staged rows are read as float4s");
};

// The first layer's rows t, x, J, b1 and b2 at the lane's units k = lane +
// 32u, zero past h.
template <int U>
struct Units {
  float wt[U], wx[U], wj[U], b1[U], b2[U];

  __device__ __forceinline__ void load(const float* __restrict__ w1,
                                       const float* __restrict__ b1_,
                                       const float* __restrict__ b2_, int h,
                                       int lane) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = lane + WARP * u;
      const bool in = k < h;
      wt[u] = in ? __ldg(w1 + k) : 0.0f;
      wx[u] = in ? __ldg(w1 + h + k) : 0.0f;
      wj[u] = in ? __ldg(w1 + 2 * h + k) : 0.0f;
      b1[u] = in ? __ldg(b1_ + k) : 0.0f;
      b2[u] = in ? __ldg(b2_ + k) : 0.0f;
    }
  }
};

// A first-layer unit's pre-activation t·wt + x·wx + J·wj + b.  With TF
// as rollout::first_sum_tf32 forms it.  Without TF in the FMAs that this
// kernel has always rounded it with, written out because the compiler's
// own contraction of t·wt + x·wx depends on how many uses the product
// t·wt (shared by the warp's paths) has: nvcc fuses a product into an FMA
// only where it has fewer than five, so the earlier layout's four paths a
// warp at HP 128 took t·wt into the FMA, its eight or more at HP 32 and 64
// took x·wx.
template <int HP, bool TF>
__device__ __forceinline__ float first_sum(float wt, float wx, float wj,
                                           float b, float ti, float x,
                                           float j) {
  if constexpr (TF) {
    return rollout::first_sum_tf32(wt, wx, wj, b, ti, x, j);
  } else {
    const float tx = HP == 128 ? __fmaf_rn(wt, ti, __fmul_rn(wx, x))
                               : __fmaf_rn(wx, x, __fmul_rn(wt, ti));
    return __fadd_rn(__fmaf_rn(wj, j, tx), b);
  }
}

// v[p] of lane ``lane`` for each of the warp's P paths: the value that the
// path's first lane holds.
template <int P>
__device__ __forceinline__ void gather_paths(float v, float (&out)[P]) {
  constexpr int SPAN = WARP / P;
#pragma unroll
  for (int p = 0; p < P; ++p) out[p] = __shfl_sync(FULL, v, p * SPAN);
}

template <int HP, bool TF>
__global__ void __launch_bounds__(THREADS)
fwd_kernel(const float* __restrict__ dw, const float* __restrict__ jr,
           const float* __restrict__ cc, const float* __restrict__ pc,
           const float* __restrict__ zc, const float* __restrict__ lo,
           const float* __restrict__ hi, const float* __restrict__ w1,
           const float* __restrict__ b1, const float* __restrict__ w2,
           const float* __restrict__ b2, const float* __restrict__ w3,
           const float* __restrict__ y0, float* __restrict__ xn,
           float* __restrict__ yn, float* __restrict__ xs,
           float* __restrict__ ys, int n, int batch, int np, int h,
           Consts c, float x0) {
  using L = Lanes<HP>;
  constexpr int P = L::P, U = L::U;
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const int lane = threadIdx.x % WARP, warp = threadIdx.x / WARP;
  const bool writer = lane % L::SPAN == 0;
  // ops/rollout.py keeps B under 2^31 − 256, so b fits an int
  const int b = blockIdx.x * L::TILE + warp * P + lane / L::SPAN;
  const bool active = b < batch;
  float* stage = sm + L::STAGE + warp * P * HP;
  for (int q = threadIdx.x; q < HP * HP; q += THREADS) {
    const int row = q / HP, col = q % HP;
    const float v = (row < h && col < h) ? __ldg(w2 + row * h + col) : 0.0f;
    sm[row * L::LDW + col] = TF ? rollout::tf32_round(v) : v;
  }
  for (int q = threadIdx.x; q < HP; q += THREADS)
    sm[L::W3 + q] = q < h ? __ldg(w3 + q) : 0.0f;
  Units<U> wu;
  wu.load(w1, b1, b2, h, lane);
  __syncthreads();

  const bool save = xs != nullptr;
  float x = x0;
  float y = __ldg(y0);
  for (int i = 0; i < n; ++i) {
    const size_t off = (size_t)i * batch + b;
    float dwr = 0.0f, jv = 0.0f;
    if (active) {
      dwr = __ldg(dw + off);
      jv = __ldg(jr + off);
      if (save && writer) xs[off] = x;
    }
    const Piece pk = rollout::locate(x, __ldg(lo + i), __ldg(hi + i), np);
    const size_t row = ((size_t)i * np + pk.k) * D;
    const float comp = rollout::clenshaw(cc + row, pk.t);
    const float ti = c.time_scale * (float)i;

    // h1 of the warp's paths at this lane's units, staged (rounded with TF)
    float xp[P], jp[P];
    gather_paths<P>(x, xp);
    gather_paths<P>(jv, jp);
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float v = tanhf(first_sum<HP, TF>(wu.wt[u], wu.wx[u], wu.wj[u],
                                                wu.b1[u], ti, xp[p], jp[p]));
        stage[p * HP + lane + WARP * u] = TF ? rollout::tf32_round(v) : v;
      }
    __syncwarp();
    // Z = h1·W2 + b2 at the lane's units, in order over h
    float z[P][U];
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int u = 0; u < U; ++u) z[p][u] = 0.0f;
#pragma unroll 1
    for (int q = 0; q < HP / 4; ++q) {
      float wv[4][U];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int u = 0; u < U; ++u)
          wv[j][u] = sm[(4 * q + j) * L::LDW + lane + WARP * u];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float4 hv = quad(stage + p * HP, q);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          z[p][u] += hv.x * wv[0][u];
          z[p][u] += hv.y * wv[1][u];
          z[p][u] += hv.z * wv[2][u];
          z[p][u] += hv.w * wv[3][u];
        }
      }
    }
    __syncwarp();  // every lane has read h1: the rows take h2
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int p = 0; p < P; ++p)
        stage[p * HP + lane + WARP * u] = tanhf(z[p][u] + wu.b2[u]);
    __syncwarp();
    // Γ of this lane's path, over the outputs in order (the padding adds
    // exact zeros)
    float gam = 0.0f;
    const float* h2 = stage + (lane / L::SPAN) * HP;
#pragma unroll 4
    for (int q = 0; q < HP / 4; ++q) {
      const float4 hq = quad(h2, q), wq = quad(sm + L::W3, q);
      gam += hq.x * wq.x;
      gam += hq.y * wq.y;
      gam += hq.z * wq.z;
      gam += hq.w * wq.w;
    }
    __syncwarp();  // the staging rows are free for the next step

    y = y + y * c.r_dt + gam - comp;
    y = y + rollout::clenshaw(zc + row, pk.t) * dwr;
    const float av = rollout::clenshaw(pc + row, pk.t);
    if (save && writer && active) ys[off] = y;
    const float e = 1.0f + rollout::expm1_acc(c.drift + c.sigma * dwr + jv);
    x = x * e + (c.a_lin * fabsf(y - av)) * c.dt;
  }
  if (writer && active) {
    xn[b] = x;
    yn[b] = y;
  }
}

// The shared memory above 48 KB needs the kernel's opt-in before a launch.
template <int HP, bool TF>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(fwd_kernel<HP, TF>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)(sizeof(float) * Lanes<HP>::SIZE));
}

template <int HP, bool TF>
cudaError_t launch_fwd(const float* dw, const float* jr, const float* cc,
                       const float* pc, const float* zc, const float* lo,
                       const float* hi, const float* w1, const float* b1,
                       const float* w2, const float* b2, const float* w3,
                       const float* y0, float* xn, float* yn, float* xs,
                       float* ys, int n, int batch, int np, int h, Consts c,
                       float x0, cudaStream_t stream) {
  const cudaError_t err = allow_smem<HP, TF>();
  if (err != cudaSuccess) return err;
  using L = Lanes<HP>;
  const int blocks = (int)(((long long)batch + L::TILE - 1) / L::TILE);
  fwd_kernel<HP, TF><<<blocks, THREADS, sizeof(float) * L::SIZE, stream>>>(
      dw, jr, cc, pc, zc, lo, hi, w1, b1, w2, b2, w3, y0, xn, yn, xs, ys, n,
      batch, np, h, c, x0);
  return cudaGetLastError();
}

template <int HP, bool TF>
cudaError_t info_fwd(int* smem, int* blocks_per_sm) {
  *smem = (int)(sizeof(float) * Lanes<HP>::SIZE);
  const cudaError_t err = allow_smem<HP, TF>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, fwd_kernel<HP, TF>, THREADS, *smem);
}

template <bool TF>
int info_fwd_at(int hidden, int* smem, int* blocks_per_sm) {
  switch (wide_width_class(hidden)) {
    case 32:
      return (int)info_fwd<32, TF>(smem, blocks_per_sm);
    case 64:
      return (int)info_fwd<64, TF>(smem, blocks_per_sm);
    case 128:
      return (int)info_fwd<128, TF>(smem, blocks_per_sm);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace rollout_wide

// C entry (bound with ctypes by ops/rollout.py b1_wide_forward): the
// arguments of rollout_fwd, r·dt in the place of its 1 + r·dt.  xs and ys may be null: the residuals are then
// not written.  Returns the launch's cudaError_t; cudaErrorInvalidValue for
// 8, 21 and widths outside 1..128.
extern "C" int rollout_wide_fwd(const float* dw, const float* jr,
                                const float* cc, const float* pc,
                                const float* zc, const float* lo,
                                const float* hi, const float* w1,
                                const float* b1, const float* w2,
                                const float* b2, const float* w3,
                                const float* y0, float* xn, float* yn,
                                float* xs, float* ys, int n, int batch,
                                int n_pieces, int hidden, int head_tf32,
                                float time_scale, float r_dt, float a_lin,
                                float dt, float sigma, float drift, float x0,
                                void* stream) {
  using namespace rollout_wide;
  if ((xs == nullptr) != (ys == nullptr) || n < 1 || batch < 1 ||
      n_pieces < 1)
    return (int)cudaErrorInvalidValue;
  const Consts c{time_scale, r_dt, a_lin, dt, sigma, drift};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (wide_width_class(hidden) * 2 + (head_tf32 != 0)) {
#define ROLLOUT_WIDE_FWD_CASE(HP, TF)                                        \
  case HP * 2 + TF:                                                          \
    return (int)launch_fwd<HP, TF>(dw, jr, cc, pc, zc, lo, hi, w1, b1, w2,   \
                                   b2, w3, y0, xn, yn, xs, ys, n, batch,     \
                                   n_pieces, hidden, c, x0, st);
    ROLLOUT_WIDE_FWD_CASE(32, false)
    ROLLOUT_WIDE_FWD_CASE(32, true)
    ROLLOUT_WIDE_FWD_CASE(64, false)
    ROLLOUT_WIDE_FWD_CASE(64, true)
    ROLLOUT_WIDE_FWD_CASE(128, false)
    ROLLOUT_WIDE_FWD_CASE(128, true)
#undef ROLLOUT_WIDE_FWD_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The kernel's dynamic shared memory per block and its resident blocks per
// SM at the width class of ``hidden`` (chip_smoke.py reports them), of the
// FP32 instance and of the head-TF32 one.
extern "C" int rollout_wide_fwd_info(int hidden, int* smem,
                                     int* blocks_per_sm) {
  return rollout_wide::info_fwd_at<false>(hidden, smem, blocks_per_sm);
}

extern "C" int rollout_wide_fwd_tf32_info(int hidden, int* smem,
                                          int* blocks_per_sm) {
  return rollout_wide::info_fwd_at<true>(hidden, smem, blocks_per_sm);
}
