// Kernel B2 at the wide head widths: the backward of the hoisted Merton
// global rollout, a reverse replay of the adjoint recurrence over the
// residuals B1 saved (the recurrence of rollout_bwd.cu's header), for any
// hidden width H in 1..128 other than 8 and 21, built for the width classes
// HP = 32, 64, 128 (rollout_wide.cuh); the specialised rollout_bwd.cu keeps
// H = 8 and 21.
//
// Replaces the Pallas kernel of the JAX package's ops/pallas_rollout.py,
// make_fused_rollout -> _bwd_kernel (its call site is _bwd_call), at the
// widths it takes beyond those two.
//
// What bounds it on an H100: FP32 issue.  Per path and step it recomputes
// the Γ head's hidden layers (2H² + 10H operations, 2H accurate tanhf),
// runs the head's backward (2H² + 4H, which also gives dΓ/dx as
// Σ_h W1[x, h]·dp1[h]) and adds into the sums over paths: h1ᵀ·dp2 (2H²),
// the other parameter cotangents (12H) and the step's table cotangents,
// beside three Clenshaw evaluations with derivatives; it reads 16 bytes.
//
// Design: a fixed number of blocks (ops/rollout.py b2_wide_blocks, at most
// two per SM, independent of B) each walk their TILE-path tiles in order,
// eight warps of P paths each, the adjoint carries (x̄, ȳ) of a path in its
// lanes.  Per step:
//   * the lanes of each path do its scalar work (the piece lookup, the
//     three Clenshaw evaluations with derivatives, the recurrence) and the
//     warp broadcasts x, J and ḡ = ȳ of its paths;
//   * each warp recomputes the hidden layers of its P paths, its lanes
//     owning units k = lane + 32u, stages h1 and dp2 = W3·ḡ·(1 − h2²) of
//     its paths in shared memory, forms W2·dp2 for its lanes' units from
//     the staged dp2, and dp1 = (W2·dp2)·(1 − h1²); a lane keeps the sums
//     over its paths of db2, dW3 = ḡ·h2, db1 and the three dW1 rows of its
//     units in registers across the whole walk; dΓ/dx per path is a fixed
//     shuffle tree over the lanes, and x̄ walks back;
//   * the first lane of a path stages its piece, table weights (−ḡ, −ū,
//     ḡ·dW) and Chebyshev basis; one barrier;
//   * the block adds h1ᵀ·dp2 over the tile's staged rows into register
//     micro-tiles of dW2 held across the whole walk (each thread RM × CM
//     entries, rows and columns strided by 16, so its shared reads are
//     conflict-free), and sums the step's table cotangents over the tile's
//     paths in order into its partial in device memory (written on the
//     block's first tile, added to after); a second barrier frees the
//     staging for the next step.
// At the end of the walk each thread writes its micro-tile, and the block
// sums the lanes' unit sums and ȳ0 over its warps in order.  A second
// kernel sums the blocks' partials in block order.  No float atomics, so
// two runs on the same inputs give the same bits, and the partial buffer
// holds at most 264 × (H² + 6H + 1 + N·3·P·D) floats whatever B.  The Γ
// output bias never reaches the kernel: the caller folds it into the
// compensator table's T_0 row and derives its cotangent from that row's
// (ops/rollout.py).
#include "rollout_wide.cuh"

namespace rollout_wide {

template <int HP>
struct Bwd {
  using L = Lanes<HP>;
  // the micro-tile of dW2 per thread: 16 × 16 threads tile HP × HP
  static constexpr int RM = HP / 16, CM = HP / 16;
  static_assert(16 * 16 == THREADS, "16 × 16 micro-tiles");
  // after W2 and b2: the tile's h1 rows (TILE of HP) | its dp2 rows | per
  // path of the tile its piece, −ḡ, −ū, ḡ·dW and T_0 .. T_{D-1}
  static constexpr int H1S = L::H1S;
  static constexpr int DP2S = H1S + L::TILE * HP;
  static constexpr int SC = DP2S + L::TILE * HP;
  static constexpr int NSC = 4 + D;
  static constexpr int SIZE = SC + L::TILE * NSC;
  // at the end of the walk, over the h1 and dp2 rows: per warp its lanes'
  // six unit sums (db2, dW3, db1, dW1 rows t, x, J), then ȳ0 per thread
  static constexpr int SEGS = 6;
  static constexpr int FIN_Y0 = H1S + WARPS * SEGS * HP;
  static_assert(FIN_Y0 + THREADS <= SC, "the final sums fit the staging");
};

template <int HP>
__global__ void __launch_bounds__(THREADS)
bwd_kernel(const float* __restrict__ dw, const float* __restrict__ jr,
           const float* __restrict__ cc, const float* __restrict__ pc,
           const float* __restrict__ zc, const float* __restrict__ lo,
           const float* __restrict__ hi, const float* __restrict__ w1,
           const float* __restrict__ b1, const float* __restrict__ w2,
           const float* __restrict__ b2, const float* __restrict__ w3,
           const float* __restrict__ xs, const float* __restrict__ ys,
           const float* __restrict__ cxn, const float* __restrict__ cyn,
           float* __restrict__ part, int n, int batch, int np, int h,
           Consts c) {
  using L = Lanes<HP>;
  using B = Bwd<HP>;
  constexpr int P = L::P, U = L::U, RM = B::RM, CM = B::CM;
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const int tid = threadIdx.x, lane = tid % WARP, warp = tid / WARP;
  const int mine = lane / L::SPAN;
  const bool writer = lane % L::SPAN == 0;
  const int n_tab = 3 * np * D;
  const int n_tiles = (batch + L::TILE - 1) / L::TILE;
  const size_t n_param = (size_t)h * h + 6 * (size_t)h;
  const size_t n_out = n_param + 1 + (size_t)n * n_tab;
  float* my_part = part + (size_t)blockIdx.x * n_out;
  float* h1s = sm + B::H1S + warp * P * HP;  // this warp's staging rows
  float* dp2s = sm + B::DP2S + warp * P * HP;
  float* sc = sm + B::SC + (warp * P + mine) * B::NSC;  // its path's row
  // this thread's micro-tile: rows rt + 16i, columns ct + 16j of dW2
  const int rt = tid % 16, ct = tid / 16;

  sweep_wide::load_weights<HP>(sm, w2, b2, h);
  Units<U> wu;
  wu.load(w1, b1, b2, w3, h, lane);
  float acc[RM][CM];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int k = 0; k < CM; ++k) acc[i][k] = 0.0f;
  // the lane's sums over its paths of its units' db2, dW3, db1 and dW1
  // rows t, x, J
  float s_db2[U], s_dw3[U], s_db1[U], s_dwt[U], s_dwx[U], s_dwj[U];
#pragma unroll
  for (int u = 0; u < U; ++u)
    s_db2[u] = s_dw3[u] = s_db1[u] = s_dwt[u] = s_dwx[u] = s_dwj[u] = 0.0f;
  float ay0 = 0.0f;
  __syncthreads();

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const bool first = tile == (int)blockIdx.x;
    const int b = tile * L::TILE + warp * P + mine;
    // idle paths of the ragged last tile carry zero cotangents, so every
    // sum they enter gets exact zeros from them
    const bool active = b < batch;
    float xb = active ? __ldg(cxn + b) : 0.0f;
    float yb = active ? __ldg(cyn + b) : 0.0f;
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
      const Piece pk = rollout::locate(x, __ldg(lo + i), __ldg(hi + i), np);
      const size_t row = ((size_t)i * np + pk.k) * D;
      float dcd, dad, dzd;
      rollout::clenshaw_deriv(cc + row, pk.t, &dcd);
      const float a_val = rollout::clenshaw_deriv(pc + row, pk.t, &dad);
      rollout::clenshaw_deriv(zc + row, pk.t, &dzd);
      const float cps = dcd * pk.dtdx, aps = dad * pk.dtdx,
                  zps = dzd * pk.dtdx;
      // adjoint recurrence (f' = -r, coupling' = aLin sign(u))
      const float u_ = yrow - a_val;
      const float sgn = (float)((u_ > 0.0f) - (u_ < 0.0f));
      const float ub = xb * (c.a_lin * sgn) * c.dt;
      yb = yb + ub;
      const float e = 1.0f + rollout::expm1_acc(c.drift + c.sigma * dwr + jv);
      const float gbar = yb;
      yb = yb + yb * c.r_dt;

      float xp[P], jp[P], gp[P], h1[P][U], z[P][U];
      gather_paths<P>(x, xp);
      gather_paths<P>(jv, jp);
      gather_paths<P>(gbar, gp);
      first_layer<HP>(wu, ti, xp, jp, lane, h1, h1s);
      __syncwarp();
      second_layer<HP>(sm, wu, lane, h1s, z);
      // h2, dp2 staged, and the lane's db2 and dW3 = ḡ·h2
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const float h2 = tanhf(z[p][u]);
          const float dp2 = (wu.w3[u] * gp[p]) * (1.0f - h2 * h2);
          dp2s[p * HP + lane + WARP * u] = dp2;
          s_db2[u] += dp2;
          s_dw3[u] += gp[p] * h2;
        }
      __syncwarp();

      // s = W2·dp2 at this lane's units k = lane + 32u, summed over the
      // outputs in order from the staged dp2
      float s[P][U];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int p = 0; p < P; ++p) s[p][u] = 0.0f;
#pragma unroll 2
      for (int q = 0; q < HP / 4; ++q) {
        float4 dq[P];
#pragma unroll
        for (int p = 0; p < P; ++p) dq[p] = quad(dp2s + p * HP, q);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float* wrow = sm + (lane + WARP * u) * L::LDW + 4 * q;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float w = wrow[j];
#pragma unroll
            for (int p = 0; p < P; ++p) s[p][u] += w * lane_of(dq[p], j);
          }
        }
      }
      // dp1 = s·(1 − h1²): the lane's db1 and dW1 rows, and its part of
      // ḡ·dΓ/dx = Σ_h W1[x, h]·dp1[h] per path
      float gx[P];
#pragma unroll
      for (int p = 0; p < P; ++p) gx[p] = 0.0f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float d1 = 0.0f;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const float dp1 = s[p][u] * (1.0f - h1[p][u] * h1[p][u]);
          d1 += dp1;
          s_dwx[u] += xp[p] * dp1;
          s_dwj[u] += jp[p] * dp1;
          gx[p] += wu.wx[u] * dp1;
        }
        s_db1[u] += d1;
        s_dwt[u] += ti * d1;  // the time feature is the same for every path
      }
      const float gxs = warp_sum_paths<P>(gx, lane);
      xb = xb * e - gbar * cps + gbar * dwr * zps - ub * aps + gxs;
      // the path's table weights and Chebyshev basis for the block's sums
      if (writer) {
        sc[0] = (float)pk.k;
        sc[1] = -gbar;
        sc[2] = -ub;
        sc[3] = gbar * dwr;
        float tk0 = 1.0f, tk1 = pk.t;
        sc[4] = tk0;
        sc[5] = tk1;
#pragma unroll
        for (int d = 2; d < D; ++d) {
          const float tk2 = 2.0f * pk.t * tk1 - tk0;
          sc[4 + d] = tk2;
          tk0 = tk1;
          tk1 = tk2;
        }
      }
      __syncthreads();  // the tile's h1, dp2 and path rows are in

      // the block: h1ᵀ·dp2 over the tile's paths into the micro-tiles
      const float* hrow = sm + B::H1S + rt;
      const float* drow = sm + B::DP2S + ct;
#pragma unroll 2
      for (int j = 0; j < L::TILE; ++j) {
        float hv[RM], dv[CM];
#pragma unroll
        for (int r = 0; r < RM; ++r) hv[r] = hrow[j * HP + 16 * r];
#pragma unroll
        for (int k = 0; k < CM; ++k) dv[k] = drow[j * HP + 16 * k];
#pragma unroll
        for (int r = 0; r < RM; ++r)
#pragma unroll
          for (int k = 0; k < CM; ++k) acc[r][k] += hv[r] * dv[k];
      }
      // the block: the step's table cotangents, each a sum over the tile's
      // paths in order of those in its piece
      float* dst = my_part + n_param + 1 + (size_t)i * n_tab;
      for (int q = tid; q < n_tab; q += THREADS) {
        const int table = q / (np * D), d = q % D;
        const float piece = (float)((q / D) % np);
        float t = 0.0f;
        for (int j = 0; j < L::TILE; ++j) {
          const float* r = sm + B::SC + j * B::NSC;
          if (r[0] == piece) t += r[4 + d] * r[1 + table];
        }
        dst[q] = first ? t : dst[q] + t;
      }
      __syncthreads();  // the staging rows are free for the next step
    }
    if (writer) ay0 += yb;  // ȳ0 contributions (zero for idle paths)
  }

  // dW2: each thread's micro-tile (entries past h are the padding's,
  // dropped)
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int k = 0; k < CM; ++k) {
      const int row = rt + 16 * r, col = ct + 16 * k;
      if (row < h && col < h) my_part[(size_t)row * h + col] = acc[r][k];
    }
  // the lanes' unit sums and ȳ0 into shared memory, then each output
  // summed over the warps (ȳ0 over the threads) in order
  float* fin = sm + B::H1S;  // [warp][segment][HP]
#pragma unroll
  for (int u = 0; u < U; ++u) {
    float* f = fin + warp * B::SEGS * HP + lane + WARP * u;
    f[0] = s_db2[u];
    f[HP] = s_dw3[u];
    f[2 * HP] = s_db1[u];
    f[3 * HP] = s_dwt[u];
    f[4 * HP] = s_dwx[u];
    f[5 * HP] = s_dwj[u];
  }
  sm[B::FIN_Y0 + tid] = ay0;
  __syncthreads();
  // [db2 | dW3 | db1 | dW1 row t | dW1 row x | dW1 row J] after dW2
  for (int q = tid; q < B::SEGS * h; q += THREADS) {
    const int seg = q / h, idx = q % h;
    float t = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) t += fin[(w * B::SEGS + seg) * HP + idx];
    my_part[(size_t)h * h + q] = t;
  }
  if (tid == 0) {
    float t = 0.0f;
    for (int k = 0; k < THREADS; ++k) t += sm[B::FIN_Y0 + k];
    my_part[n_param] = t;
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
cudaError_t launch_bwd(const float* dw, const float* jr, const float* cc,
                       const float* pc, const float* zc, const float* lo,
                       const float* hi, const float* w1, const float* b1,
                       const float* w2, const float* b2, const float* w3,
                       const float* xs, const float* ys, const float* cxn,
                       const float* cyn, float* part, float* out, int n,
                       int batch, int np, int h, int n_blocks, Consts c,
                       cudaStream_t stream) {
  if (n_blocks > (batch + Lanes<HP>::TILE - 1) / Lanes<HP>::TILE)
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem<HP>();
  if (err != cudaSuccess) return err;
  bwd_kernel<HP><<<n_blocks, THREADS, sizeof(float) * Bwd<HP>::SIZE,
                   stream>>>(dw, jr, cc, pc, zc, lo, hi, w1, b1, w2, b2, w3,
                             xs, ys, cxn, cyn, part, n, batch, np, h, c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_out = h * h + 6 * h + 1 + n * 3 * np * D;
  sweep::reduce_partials<<<(n_out + sweep::REDUCE_THREADS - 1) /
                               sweep::REDUCE_THREADS,
                           sweep::REDUCE_THREADS, 0, stream>>>(
      part, out, n_blocks, n_out);
  return cudaGetLastError();
}

}  // namespace rollout_wide

// C entry (bound with ctypes by ops/rollout.py b2_wide_backward): the
// arguments of rollout_bwd, r·dt in the place of its 1 + r·dt.  ``part`` holds n_blocks partials of (H² + 6H +
// 1 + N·3·P·D) floats, n_blocks in [1, number of tiles]; ``out`` one of
// them, the sum.  Returns the launches' cudaError_t; cudaErrorInvalidValue
// for 8, 21 and widths outside 1..128.
extern "C" int rollout_wide_bwd(const float* dw, const float* jr,
                                const float* cc, const float* pc,
                                const float* zc, const float* lo,
                                const float* hi, const float* w1,
                                const float* b1, const float* w2,
                                const float* b2, const float* w3,
                                const float* xs, const float* ys,
                                const float* cxn, const float* cyn,
                                float* part, float* out, int n, int batch,
                                int n_pieces, int hidden, int n_blocks,
                                float time_scale, float r_dt, float a_lin,
                                float dt, float sigma, float drift,
                                void* stream) {
  using namespace rollout_wide;
  if (n < 1 || batch < 1 || n_pieces < 1 || n_blocks < 1)
    return (int)cudaErrorInvalidValue;
  const Consts c{time_scale, r_dt, a_lin, dt, sigma, drift};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (wide_width_class(hidden)) {
    case 32:
      return (int)launch_bwd<32>(dw, jr, cc, pc, zc, lo, hi, w1, b1, w2, b2,
                                 w3, xs, ys, cxn, cyn, part, out, n, batch,
                                 n_pieces, hidden, n_blocks, c, st);
    case 64:
      return (int)launch_bwd<64>(dw, jr, cc, pc, zc, lo, hi, w1, b1, w2, b2,
                                 w3, xs, ys, cxn, cyn, part, out, n, batch,
                                 n_pieces, hidden, n_blocks, c, st);
    case 128:
      return (int)launch_bwd<128>(dw, jr, cc, pc, zc, lo, hi, w1, b1, w2, b2,
                                  w3, xs, ys, cxn, cyn, part, out, n, batch,
                                  n_pieces, hidden, n_blocks, c, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The kernel's dynamic shared memory per block and its resident blocks per
// SM at the width class of ``hidden`` (chip_smoke.py reports them).
extern "C" int rollout_wide_bwd_info(int hidden, int* smem,
                                     int* blocks_per_sm) {
  using namespace rollout_wide;
  switch (wide_width_class(hidden)) {
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
