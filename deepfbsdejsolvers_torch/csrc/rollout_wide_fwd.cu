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
// Design: a block of eight warps takes TILE = 8·P paths, each warp P of
// them, and walks the N steps.  Per step the lanes of each path look up its
// piece, evaluate the compensator table and broadcast x and J over the
// warp; each lane forms the first layer of its units for the warp's paths
// (staged in shared memory), then the second layer of its units, reading
// each staged h1 quad as one broadcast and each W2 value once for P paths,
// and stages h2; the lanes of each path sum Γ = Σ_o W3[o]·h2[o] over the
// outputs in order, as B1 and the plain version's matmul do (a shuffle
// tree rounds it otherwise, the same way for every path of equal inputs,
// and the loss's gradient, a sum over paths, magnifies that), then update
// y and walk x exactly as B1 does.  No barrier after the weight load but
// __syncwarp, so the kernel
// takes any N and B: the ragged last block's idle paths compute on zero
// noise and write nothing.
//
// The head-TF32 instance (fwd_tf32_kernel, head_tf32 != 0) keeps this
// order too: W2 loaded and h1 staged rounded to TF32 (the first layer
// summed as first_sum_tf32 sums it, so h1 is the plain version's bits),
// the products of two TF32 values exact in f32, the sums the plain
// version's.  It gains by register tiling: twice the FP32 instance's paths
// a warp (LanesTf32), so each W2 value read from shared memory serves
// twice the paths, with its loop reordered so that the extra paths cost
// accumulators, not staged h1 quads, in registers (NVIDIA H100 80GB HBM3,
// 700 W, kernel_ab.py --wide-rollout, B = 2^17, N = 50: 1.02 → 0.97 ms at
// HP 32, 2.33 → 2.19 at 64, 8.34 → 6.62 at 128).
//
// Its product on the tensor cores (B2w's layout, h1 rounded in registers
// as the A operand, one TF32 mma.sync pass, h2 staged 32 units at a time
// for the in-order Γ sum) ran 0.54, 1.04 and 2.28 ms there and missed the
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

// B1w's layout of the head's second layer: the hidden units spread over a
// warp's lanes, lane l owning the U = HP / 32 units k = l + 32u, P = 16 / U
// paths a warp; W2 in shared memory with a row stride of HP + 1 floats, so
// that lane l reading row h at column l + 32u and row l + 32u at column k
// are both free of bank conflicts; then b2; then the block's staged rows.
template <int HP>
struct Lanes {
  static_assert(HP == 32 || HP == 64 || HP == 128, "width class");
  static constexpr int U = HP / WARP;    // units per lane
  static constexpr int P = 16 / U;       // paths per warp
  static constexpr int TILE = WARPS * P; // paths per block
  static constexpr int SPAN = WARP / P;  // lanes per path
  static constexpr int LDW = HP + 1;
  static constexpr int W2 = 0;
  static constexpr int B2 = (HP * LDW + 3) / 4 * 4;
  static constexpr int H1S = B2 + HP;
  static_assert(H1S % 4 == 0, "staged rows are read as float4s");
};


// The first layer's rows t, x, J, b1, b2 and W3 at the lane's units k =
// lane + 32u, zero past h.
template <int U>
struct Units {
  float wt[U], wx[U], wj[U], b1[U], b2[U], w3[U];

  __device__ __forceinline__ void load(const float* __restrict__ w1,
                                       const float* __restrict__ b1_,
                                       const float* __restrict__ b2_,
                                       const float* __restrict__ w3_, int h,
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
      w3[u] = in ? __ldg(w3_ + k) : 0.0f;
    }
  }
};

// v[p] of lane ``lane`` for each of the warp's P paths: the value that the
// path's first lane holds.
template <int P>
__device__ __forceinline__ void gather_paths(float v, float (&out)[P]) {
  constexpr int SPAN = WARP / P;
#pragma unroll
  for (int p = 0; p < P; ++p) out[p] = __shfl_sync(FULL, v, p * SPAN);
}

// h1[p][u] = tanh(t·W1[t, k] + x_p·W1[x, k] + J_p·W1[J, k] + b1[k]) at the
// lane's units, in the sum order of rollout::first_layer, written to the
// warp's staging rows ``stage`` (P rows of HP); returns them too.
template <int HP>
__device__ __forceinline__ void first_layer(
    const Units<Lanes<HP>::U>& w, float ti, const float (&x)[Lanes<HP>::P],
    const float (&j)[Lanes<HP>::P], int lane,
    float (&h1)[Lanes<HP>::P][Lanes<HP>::U], float* stage) {
  using L = Lanes<HP>;
#pragma unroll
  for (int u = 0; u < L::U; ++u)
#pragma unroll
    for (int p = 0; p < L::P; ++p) {
      h1[p][u] = tanhf(w.wt[u] * ti + w.wx[u] * x[p] + w.wj[u] * j[p] +
                       w.b1[u]);
      stage[p * HP + lane + WARP * u] = h1[p][u];
    }
}

// z[p][u] = Σ_h h1[p][h]·W2[h][k] + b2[k] at the lane's units, the sum over
// h in order from zero and the bias added last, as the plain version's
// matmul and add round it; h1 is read from the warp's staging rows as
// float4 broadcasts and W2 from shared memory (rows of LDW: lane l reads
// bank h + l, no conflicts).
template <int HP>
__device__ __forceinline__ void second_layer(
    const float* sm, const Units<Lanes<HP>::U>& w, int lane,
    const float* stage, float (&z)[Lanes<HP>::P][Lanes<HP>::U]) {
  using L = Lanes<HP>;
#pragma unroll
  for (int u = 0; u < L::U; ++u)
#pragma unroll
    for (int p = 0; p < L::P; ++p) z[p][u] = 0.0f;
#pragma unroll 2
  for (int q = 0; q < HP / 4; ++q) {
    float4 hv[L::P];
#pragma unroll
    for (int p = 0; p < L::P; ++p) hv[p] = quad(stage + p * HP, q);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* wrow = sm + (4 * q + j) * L::LDW + lane;
#pragma unroll
      for (int u = 0; u < L::U; ++u) {
        const float wv = wrow[WARP * u];
#pragma unroll
        for (int p = 0; p < L::P; ++p) z[p][u] += lane_of(hv[p], j) * wv;
      }
    }
  }
#pragma unroll
  for (int u = 0; u < L::U; ++u)
#pragma unroll
    for (int p = 0; p < L::P; ++p) z[p][u] += w.b2[u];
}

// W2 and b2 of width h into shared memory in ``Lanes``' layout, zero past
// h.
template <int HP>
__device__ __forceinline__ void load_weights(float* sm,
                                             const float* __restrict__ w2,
                                             const float* __restrict__ b2,
                                             int h) {
  using L = Lanes<HP>;
  for (int q = threadIdx.x; q < HP * HP; q += blockDim.x) {
    const int row = q / HP, col = q % HP;
    const float v = (row < h && col < h) ? __ldg(w2 + row * h + col) : 0.0f;
    sm[L::W2 + row * L::LDW + col] = v;
  }
  for (int q = threadIdx.x; q < HP; q += blockDim.x)
    sm[L::B2 + q] = q < h ? __ldg(b2 + q) : 0.0f;
}


template <int HP>
struct Fwd {
  // W2 | b2 | W3 (HP) | per warp its P staging rows of HP (h1, then h2)
  static constexpr int W3 = Lanes<HP>::H1S;
  static constexpr int STAGE = W3 + HP;
  static constexpr int SIZE = STAGE + WARPS * Lanes<HP>::P * HP;
};

template <int HP>
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
  const int b = blockIdx.x * L::TILE + warp * P + lane / L::SPAN;
  const bool active = b < batch;
  using F = Fwd<HP>;
  float* stage = sm + F::STAGE + warp * P * HP;
  load_weights<HP>(sm, w2, b2, h);
  for (int q = threadIdx.x; q < HP; q += THREADS)
    sm[F::W3 + q] = q < h ? __ldg(w3 + q) : 0.0f;
  Units<U> wu;
  wu.load(w1, b1, b2, w3, h, lane);
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

    float xp[P], jp[P], h1[P][U], z[P][U];
    gather_paths<P>(x, xp);
    gather_paths<P>(jv, jp);
    first_layer<HP>(wu, c.time_scale * (float)i, xp, jp, lane, h1, stage);
    __syncwarp();
    second_layer<HP>(sm, wu, lane, stage, z);
    __syncwarp();  // every lane has read h1: the rows take h2
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int p = 0; p < P; ++p)
        stage[p * HP + lane + WARP * u] = tanhf(z[p][u]);
    __syncwarp();
    // Γ of this lane's path, over the outputs in order (the padding adds
    // exact zeros)
    float gam = 0.0f;
    const float* h2 = stage + (lane / L::SPAN) * HP;
#pragma unroll 4
    for (int q = 0; q < HP / 4; ++q) {
      const float4 hq = quad(h2, q), wq = quad(sm + F::W3, q);
      gam += hq.x * wq.x;
      gam += hq.y * wq.y;
      gam += hq.z * wq.z;
      gam += hq.w * wq.w;
    }
    __syncwarp();  // the staging rows are free for the next step

    y = y + y * c.r_dt + gam - comp;
    y = y + rollout::clenshaw(zc + row, pk.t) * dwr;
    const float a = rollout::clenshaw(pc + row, pk.t);
    if (save && writer && active) ys[off] = y;
    const float e = 1.0f + rollout::expm1_acc(c.drift + c.sigma * dwr + jv);
    x = x * e + (c.a_lin * fabsf(y - a)) * c.dt;
  }
  if (writer && active) {
    xn[b] = x;
    yn[b] = y;
  }
}

// The head-TF32 instance: the FP32 instance's lanes (``Lanes``: lane l owns
// the U = HP / 32 units l + 32u), but twice its paths a warp, P = 32 / U
// (TILE = 8·P a block, SPAN = 32 / P lanes a path), so that each W2 value
// read from shared memory serves twice the paths; W2 loaded and h1 staged
// rounded to TF32.  Z's loop takes the four W2 rows of a quad of h once
// (4U values in registers) and the paths one at a time, one float4 of h1
// each, so its registers hold the P·U accumulators, not P float4s of h1.
// Each accumulator still sums over h in order from zero, the bias last:
// the plain version's rounding.
template <int HP>
struct LanesTf32 {
  static constexpr int U = HP / WARP;
  static constexpr int P = 32 / U;
  static constexpr int TILE = WARPS * P;
  static constexpr int SPAN = WARP / P;
  // W2 (rows of LDW) | W3 | per warp its P staging rows of HP
  static constexpr int LDW = Lanes<HP>::LDW;
  static constexpr int W3 = Lanes<HP>::B2;
  static constexpr int STAGE = W3 + HP;
  static constexpr int SIZE = STAGE + WARPS * P * HP;
};

template <int HP>
__global__ void __launch_bounds__(THREADS)
fwd_tf32_kernel(const float* __restrict__ dw, const float* __restrict__ jr,
                const float* __restrict__ cc, const float* __restrict__ pc,
                const float* __restrict__ zc, const float* __restrict__ lo,
                const float* __restrict__ hi, const float* __restrict__ w1,
                const float* __restrict__ b1, const float* __restrict__ w2,
                const float* __restrict__ b2, const float* __restrict__ w3,
                const float* __restrict__ y0, float* __restrict__ xn,
                float* __restrict__ yn, float* __restrict__ xs,
                float* __restrict__ ys, int n, int batch, int np, int h,
                Consts c, float x0) {
  using L = LanesTf32<HP>;
  constexpr int P = L::P, U = L::U;
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const int lane = threadIdx.x % WARP, warp = threadIdx.x / WARP;
  const bool writer = lane % L::SPAN == 0;
  const int b = blockIdx.x * L::TILE + warp * P + lane / L::SPAN;
  const bool active = b < batch;
  float* stage = sm + L::STAGE + warp * P * HP;
  for (int q = threadIdx.x; q < HP * HP; q += THREADS) {
    const int row = q / HP, col = q % HP;
    const float v = (row < h && col < h) ? __ldg(w2 + row * h + col) : 0.0f;
    sm[row * L::LDW + col] = rollout::tf32_round(v);
  }
  for (int q = threadIdx.x; q < HP; q += THREADS)
    sm[L::W3 + q] = q < h ? __ldg(w3 + q) : 0.0f;
  Units<U> wu;
  wu.load(w1, b1, b2, w3, h, lane);
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

    // h1 of the warp's paths at this lane's units, staged rounded
    float xp[P], jp[P];
    gather_paths<P>(x, xp);
    gather_paths<P>(jv, jp);
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int p = 0; p < P; ++p)
        stage[p * HP + lane + WARP * u] =
            rollout::tf32_round(tanhf(rollout::first_sum_tf32(
                wu.wt[u], wu.wx[u], wu.wj[u], wu.b1[u], ti, xp[p], jp[p])));
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
    // Γ of this lane's path, over the outputs in order
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

// The shared memory above 48 KB needs the kernels' opt-in before a launch.
template <int HP, bool TF>
cudaError_t allow_smem() {
  if constexpr (TF)
    return cudaFuncSetAttribute(fwd_tf32_kernel<HP>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)(sizeof(float) * LanesTf32<HP>::SIZE));
  else
    return cudaFuncSetAttribute(fwd_kernel<HP>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)(sizeof(float) * Fwd<HP>::SIZE));
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
  if constexpr (TF) {
    using L = LanesTf32<HP>;
    const int blocks = (batch + L::TILE - 1) / L::TILE;
    fwd_tf32_kernel<HP><<<blocks, THREADS, sizeof(float) * L::SIZE,
                          stream>>>(dw, jr, cc, pc, zc, lo, hi, w1, b1, w2,
                                    b2, w3, y0, xn, yn, xs, ys, n, batch, np,
                                    h, c, x0);
  } else {
    const int blocks = (batch + Lanes<HP>::TILE - 1) / Lanes<HP>::TILE;
    fwd_kernel<HP><<<blocks, THREADS, sizeof(float) * Fwd<HP>::SIZE,
                     stream>>>(dw, jr, cc, pc, zc, lo, hi, w1, b1, w2, b2,
                               w3, y0, xn, yn, xs, ys, n, batch, np, h, c,
                               x0);
  }
  return cudaGetLastError();
}

template <int HP, bool TF>
cudaError_t info_fwd(int* smem, int* blocks_per_sm) {
  *smem = (int)(sizeof(float) * (TF ? LanesTf32<HP>::SIZE : Fwd<HP>::SIZE));
  const cudaError_t err = allow_smem<HP, TF>();
  if (err != cudaSuccess) return err;
  if constexpr (TF)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, fwd_tf32_kernel<HP>, THREADS, *smem);
  else
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, fwd_kernel<HP>, THREADS, *smem);
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
