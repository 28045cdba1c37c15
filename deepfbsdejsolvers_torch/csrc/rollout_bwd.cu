// Kernel B2: the backward of the hoisted Merton global rollout, a reverse
// replay of the adjoint recurrence over the residuals B1 saved.
//
// Replaces the Pallas kernel of the JAX package's ops/pallas_rollout.py,
// make_fused_rollout -> _bwd_kernel (its call site is _bwd_call).
//
// What bounds it on an H100: arithmetic.  Per path and step it recomputes
// the Γ head's hidden layers (2H² + 6H FLOPs, 2H tanhf), runs the head's
// backward (another ~2H² FLOPs, which also give dΓ/dx), three Clenshaw
// evaluations with derivatives, and reads 16 bytes (xs, ys, dW, J).  On top
// of that come the sums over paths of the parameter and table cotangents
// (~2H² FLOPs): about three times B1's work over the same bytes.
//
// Design: one thread per path, as in B1, with the adjoint carries (x̄, ȳ)
// in registers.  The TPU kernel carries its sums across a sequential grid;
// CUDA blocks run in no order, so each block reduces its own paths:
//   * every step, each thread writes its h1, h2, dp1, dp2, ḡ, x, J, piece
//     index, Chebyshev basis and the three table weights to shared memory
//     (rows padded to 129 words, so threads reading different rows at one
//     column hit different banks);
//   * then each thread computes a few of the block's sums over its 128 paths
//     in a fixed order: of the (H² + 6H) parameter cotangents, kept in
//     registers across the steps, and of that step's 3·P·D table
//     cotangents, written straight to the block's partial;
//   * a second kernel sums the per-block partials in block order.
// No float atomics anywhere, so two runs on the same inputs give the same
// bits.  The Γ output bias never reaches the kernel: the caller folds it
// into the compensator table's T_0 row and derives its cotangent from that
// row's (ops/rollout.py).
#include "rollout_common.cuh"

namespace rollout {

constexpr int BWD_THREADS = 128;
constexpr int LD = BWD_THREADS + 1;  // padded row of one block's paths
constexpr int REDUCE_THREADS = 256;

// Shared-memory layout, in floats.
template <int H>
struct Smem {
  static constexpr int H1 = Head<H>::SIZE;  // head weights come first
  static constexpr int H2 = H1 + H * LD;
  static constexpr int DP1 = H2 + H * LD;
  static constexpr int DP2 = DP1 + H * LD;
  static constexpr int BASIS = DP2 + H * LD;  // T_0..T_{D-1}(t)
  static constexpr int GBAR = BASIS + D * LD;
  static constexpr int X = GBAR + LD;
  static constexpr int J = X + LD;
  static constexpr int GC = J + LD;  // cc cotangent weight: -ḡ
  static constexpr int GP = GC + LD;  // pc: -ū
  static constexpr int GZ = GP + LD;  // zc: ḡ·dW
  static constexpr int K = GZ + LD;   // piece index, as a float
  static constexpr int SIZE = K + LD;
};

// Parameter cotangents, in this order: dW2 (H×H, row h1 × column out) |
// db2 | dW3 | db1 | dW1 row t | dW1 row x | dW1 row J.  Then ȳ0 at index
// n_param, then the table cotangents.
template <int H>
struct Params {
  static constexpr int N = H * H + 6 * H;
  static constexpr int PER_THREAD = (N + BWD_THREADS - 1) / BWD_THREADS;
};

// Row offsets (A, B; B < 0 means a row of ones) of one parameter sum.
template <int H>
__device__ __forceinline__ void param_rows(int q, int* a, int* b) {
  using S = Smem<H>;
  if (q < H * H) {
    *a = S::H1 + (q / H) * LD;
    *b = S::DP2 + (q % H) * LD;
    return;
  }
  const int seg = (q - H * H) / H, idx = (q - H * H) % H;
  switch (seg) {
    case 0: *a = S::DP2 + idx * LD; *b = -1; break;      // db2
    case 1: *a = S::H2 + idx * LD; *b = S::GBAR; break;  // dW3
    case 2:                                              // db1
    case 3: *a = S::DP1 + idx * LD; *b = -1; break;      // dW1 row t
    case 4: *a = S::DP1 + idx * LD; *b = S::X; break;    // dW1 row x
    default: *a = S::DP1 + idx * LD; *b = S::J; break;   // dW1 row J
  }
}

template <int H>
__global__ void __launch_bounds__(BWD_THREADS)
bwd_kernel(const float* __restrict__ dw, const float* __restrict__ jr,
           const float* __restrict__ cc, const float* __restrict__ pc,
           const float* __restrict__ zc, const float* __restrict__ lo,
           const float* __restrict__ hi, const float* __restrict__ w1,
           const float* __restrict__ b1, const float* __restrict__ w2,
           const float* __restrict__ b2, const float* __restrict__ w3,
           const float* __restrict__ xs, const float* __restrict__ ys,
           const float* __restrict__ cxn, const float* __restrict__ cyn,
           float* __restrict__ part, int n, int batch, int p, Consts c) {
  using L = Head<H>;
  using S = Smem<H>;
  using PP = Params<H>;
  extern __shared__ float sm[];
  const int tid = threadIdx.x;
  const int b = blockIdx.x * BWD_THREADS + tid;
  const bool active = b < batch;
  const int n_tab = 3 * p * D;
  const size_t n_out = (size_t)PP::N + 1 + (size_t)n * n_tab;
  float* my_part = part + (size_t)blockIdx.x * n_out;

  load_head<H>(sm, w1, b1, w2, b2, w3);

  int row_a[PP::PER_THREAD], row_b[PP::PER_THREAD];
  float acc[PP::PER_THREAD];
#pragma unroll
  for (int m = 0; m < PP::PER_THREAD; ++m) {
    const int q = tid + m * BWD_THREADS;
    row_a[m] = 0;
    row_b[m] = -1;
    if (q < PP::N) param_rows<H>(q, &row_a[m], &row_b[m]);
    acc[m] = 0.0f;
  }
  __syncthreads();

  // Idle threads of the ragged last block carry zero cotangents, so every
  // sum they enter gets exact zeros from them.
  float xb = active ? __ldg(cxn + b) : 0.0f;
  float yb = active ? __ldg(cyn + b) : 0.0f;
  float h1[H], h2[H], dp2[H];
  for (int i = n - 1; i >= 0; --i) {
    const float ti = c.time_scale * (float)i;
    float x = 0.0f, yrow = 0.0f, dwr = 0.0f, jv = 0.0f;
    if (active) {
      const size_t off = (size_t)i * batch + b;
      x = __ldg(xs + off);
      yrow = __ldg(ys + off);
      dwr = __ldg(dw + off);
      jv = __ldg(jr + off);
    }
    const Piece pk = locate(x, __ldg(lo + i), __ldg(hi + i), p);
    const size_t row = ((size_t)i * p + pk.k) * D;
    float dcd, dad, dzd;
    clenshaw_deriv(cc + row, pk.t, &dcd);
    const float a_val = clenshaw_deriv(pc + row, pk.t, &dad);
    clenshaw_deriv(zc + row, pk.t, &dzd);
    const float cps = dcd * pk.dtdx, aps = dad * pk.dtdx,
                zps = dzd * pk.dtdx;
    hidden_layers<H>(sm, ti, x, jv, h1, h2);
#pragma unroll
    for (int h = 0; h < H; ++h) {
      sm[S::H1 + h * LD + tid] = h1[h];
      sm[S::H2 + h * LD + tid] = h2[h];
      h1[h] = 1.0f - h1[h] * h1[h];  // now s1 = tanh' of layer 1
      h2[h] = 1.0f - h2[h] * h2[h];  // now s2
    }
    // adjoint recurrence (f' = -r, coupling' = aLin sign(u))
    const float u = yrow - a_val;
    const float sgn = (float)((u > 0.0f) - (u < 0.0f));
    const float ub = xb * (c.a_lin * sgn) * c.dt;
    yb = yb + ub;
    const float e = 1.0f + expm1_acc(c.drift + c.sigma * dwr + jv);
    const float gbar = yb;
    yb = yb * c.growth;
    // the head's backward: dp2 = W3 ḡ s2, dp1 = (W2 dp2) s1.  Its x entry,
    // Σ_h W1[x, h] dp1[h], is ḡ·dΓ/dx, so no forward-mode pass is needed.
#pragma unroll
    for (int o = 0; o < H; ++o) {
      dp2[o] = (sm[L::W3 + o] * gbar) * h2[o];
      sm[S::DP2 + o * LD + tid] = dp2[o];
    }
    float gx = 0.0f;
#pragma unroll
    for (int h = 0; h < H; ++h) {
      float s = 0.0f;
#pragma unroll
      for (int o = 0; o < H; ++o) s += sm[L::W2 + h * H + o] * dp2[o];
      const float dp1 = s * h1[h];
      sm[S::DP1 + h * LD + tid] = dp1;
      gx += sm[L::W1 + H + h] * dp1;
    }
    xb = xb * e - gbar * cps + gbar * dwr * zps - ub * aps + gx;
    float tk0 = 1.0f, tk1 = pk.t;
    sm[S::BASIS + tid] = tk0;
    sm[S::BASIS + LD + tid] = tk1;
#pragma unroll
    for (int d = 2; d < D; ++d) {
      const float tk2 = 2.0f * pk.t * tk1 - tk0;
      sm[S::BASIS + d * LD + tid] = tk2;
      tk0 = tk1;
      tk1 = tk2;
    }
    sm[S::GBAR + tid] = gbar;
    sm[S::X + tid] = x;
    sm[S::J + tid] = jv;
    sm[S::GC + tid] = -gbar;
    sm[S::GP + tid] = -ub;
    sm[S::GZ + tid] = gbar * dwr;
    sm[S::K + tid] = (float)pk.k;
    __syncthreads();

    // this block's parameter sums for step i, accumulated across steps
#pragma unroll
    for (int m = 0; m < PP::PER_THREAD; ++m) {
      const int q = tid + m * BWD_THREADS;
      if (q < PP::N) {
        const float* ra = sm + row_a[m];
        float s = 0.0f;
        if (row_b[m] < 0) {
          for (int k = 0; k < BWD_THREADS; ++k) s += ra[k];
        } else {
          const float* rb = sm + row_b[m];
          for (int k = 0; k < BWD_THREADS; ++k) s += ra[k] * rb[k];
        }
        // dW1 row t: the time feature is the same for every path of a step
        const bool is_t = q >= H * H + 3 * H && q < H * H + 4 * H;
        acc[m] += is_t ? ti * s : s;
      }
    }
    // this block's table cotangents for step i: (table, piece, coefficient)
    for (int q = tid; q < n_tab; q += BWD_THREADS) {
      const int tab = q / (p * D);
      const float piece = (float)((q / D) % p);
      const float* basis = sm + S::BASIS + (q % D) * LD;
      const float* g = sm + (tab == 0 ? S::GC : tab == 1 ? S::GP : S::GZ);
      float s = 0.0f;
      for (int k = 0; k < BWD_THREADS; ++k)
        s += sm[S::K + k] == piece ? basis[k] * g[k] : 0.0f;
      my_part[PP::N + 1 + (size_t)i * n_tab + q] = s;
    }
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < PP::PER_THREAD; ++m) {
    const int q = tid + m * BWD_THREADS;
    if (q < PP::N) my_part[q] = acc[m];
  }
  sm[S::GBAR + tid] = yb;  // ȳ0 contributions (zero for idle threads)
  __syncthreads();
  if (tid == 0) {
    float s = 0.0f;
    for (int k = 0; k < BWD_THREADS; ++k) s += sm[S::GBAR + k];
    my_part[PP::N] = s;
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
cudaError_t launch_bwd(const float* dw, const float* jr, const float* cc,
                       const float* pc, const float* zc, const float* lo,
                       const float* hi, const float* w1, const float* b1,
                       const float* w2, const float* b2, const float* w3,
                       const float* xs, const float* ys, const float* cxn,
                       const float* cyn, float* part, float* out, int n,
                       int batch, int p, Consts c, cudaStream_t stream) {
  const int blocks = (batch + BWD_THREADS - 1) / BWD_THREADS;
  const size_t smem = sizeof(float) * Smem<H>::SIZE;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  bwd_kernel<H><<<blocks, BWD_THREADS, smem, stream>>>(
      dw, jr, cc, pc, zc, lo, hi, w1, b1, w2, b2, w3, xs, ys, cxn, cyn, part,
      n, batch, p, c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_out = Params<H>::N + 1 + n * 3 * p * D;
  reduce_partials<<<(n_out + REDUCE_THREADS - 1) / REDUCE_THREADS,
                    REDUCE_THREADS, 0, stream>>>(part, out, blocks, n_out);
  return cudaGetLastError();
}

}  // namespace rollout

// C entry (bound with ctypes by ops/rollout.py b2_backward).  ``part`` holds
// ceil(batch / 128) partials of (H² + 6H + 1 + N·3·P·D) floats; ``out`` one
// of them, the sum.  Returns the launches' cudaError_t;
// cudaErrorInvalidValue for a hidden width not built here.
extern "C" int rollout_bwd(const float* dw, const float* jr, const float* cc,
                           const float* pc, const float* zc, const float* lo,
                           const float* hi, const float* w1, const float* b1,
                           const float* w2, const float* b2, const float* w3,
                           const float* xs, const float* ys, const float* cxn,
                           const float* cyn, float* part, float* out, int n,
                           int batch, int n_pieces, int hidden,
                           float time_scale, float growth, float a_lin,
                           float dt, float sigma, float drift, void* stream) {
  using namespace rollout;
  if (n < 1 || batch < 1 || n_pieces < 1) return (int)cudaErrorInvalidValue;
  const Consts c{time_scale, growth, a_lin, dt, sigma, drift};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (hidden) {
    case 8:
      return (int)launch_bwd<8>(dw, jr, cc, pc, zc, lo, hi, w1, b1, w2, b2,
                                w3, xs, ys, cxn, cyn, part, out, n, batch,
                                n_pieces, c, st);
    case 21:
      return (int)launch_bwd<21>(dw, jr, cc, pc, zc, lo, hi, w1, b1, w2, b2,
                                 w3, xs, ys, cxn, cyn, part, out, n, batch,
                                 n_pieces, c, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
