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
#include "rollout_wide.cuh"

namespace rollout_wide {

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
  sweep_wide::load_weights<HP>(sm, w2, b2, h);
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

// The shared memory above 48 KB needs the kernel's opt-in before a launch.
template <int HP>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(fwd_kernel<HP>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)(sizeof(float) * Fwd<HP>::SIZE));
}

template <int HP>
cudaError_t launch_fwd(const float* dw, const float* jr, const float* cc,
                       const float* pc, const float* zc, const float* lo,
                       const float* hi, const float* w1, const float* b1,
                       const float* w2, const float* b2, const float* w3,
                       const float* y0, float* xn, float* yn, float* xs,
                       float* ys, int n, int batch, int np, int h, Consts c,
                       float x0, cudaStream_t stream) {
  const cudaError_t err = allow_smem<HP>();
  if (err != cudaSuccess) return err;
  const int blocks = (batch + Lanes<HP>::TILE - 1) / Lanes<HP>::TILE;
  fwd_kernel<HP><<<blocks, THREADS, sizeof(float) * Fwd<HP>::SIZE,
                   stream>>>(dw, jr, cc, pc, zc, lo, hi, w1, b1, w2, b2, w3,
                             y0, xn, yn, xs, ys, n, batch, np, h, c, x0);
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
                                int n_pieces, int hidden, float time_scale,
                                float r_dt, float a_lin, float dt,
                                float sigma, float drift, float x0,
                                void* stream) {
  using namespace rollout_wide;
  if ((xs == nullptr) != (ys == nullptr) || n < 1 || batch < 1 ||
      n_pieces < 1)
    return (int)cudaErrorInvalidValue;
  const Consts c{time_scale, r_dt, a_lin, dt, sigma, drift};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (wide_width_class(hidden)) {
    case 32:
      return (int)launch_fwd<32>(dw, jr, cc, pc, zc, lo, hi, w1, b1, w2, b2,
                                 w3, y0, xn, yn, xs, ys, n, batch, n_pieces,
                                 hidden, c, x0, st);
    case 64:
      return (int)launch_fwd<64>(dw, jr, cc, pc, zc, lo, hi, w1, b1, w2, b2,
                                 w3, y0, xn, yn, xs, ys, n, batch, n_pieces,
                                 hidden, c, x0, st);
    case 128:
      return (int)launch_fwd<128>(dw, jr, cc, pc, zc, lo, hi, w1, b1, w2, b2,
                                  w3, y0, xn, yn, xs, ys, n, batch, n_pieces,
                                  hidden, c, x0, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The kernel's dynamic shared memory per block and its resident blocks per
// SM at the width class of ``hidden`` (chip_smoke.py reports them).
extern "C" int rollout_wide_fwd_info(int hidden, int* smem,
                                     int* blocks_per_sm) {
  using namespace rollout_wide;
  switch (wide_width_class(hidden)) {
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
