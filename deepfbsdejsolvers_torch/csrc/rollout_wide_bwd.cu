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
// What bounds it on an H100: the Γ head's three H×H products per path and
// step, Z = h1·W2 (recomputed), S = dp2·W2ᵀ and dW2 += h1ᵀ·dp2 (6H²
// operations, 3·6H² on the tensor cores in split TF32, 6H² in the TF32
// instance), and ~28H FP32
// operations around them with 2H accurate tanhf, beside three Clenshaw
// evaluations with derivatives and the table sums; it reads 16 bytes.
// Its products are those of the wide sweep's B4 (sweep_wide_bwd.cu), and
// so is its layout.  B1w keeps its one product in FP32 (its header says
// why); B2w's products enter the paths' sensitivities, not the
// trajectories whose shared errors the loss's cancelling gradient would
// magnify, and hold the checks in split TF32.
//
// The template flag TF is the head-TF32 instance: every operand rounded to
// TF32 once, where it is staged (tf32_biased below): W2 as it
// is loaded, h1 and dp2 as they are written to the staging rows; each
// product is one TF32 pass (mma.sync m16n8k8) on fragments loaded as they
// are stored, with no split, no conversion in any inner loop and one
// accumulator; db2 stays the sum of the unrounded dp2, and dp1 takes the
// unrounded h1 back from its staged bits.  Freed of the split's second
// accumulators and lo operands, it holds three blocks an SM at HP 32
// (bwd_blocks_per_sm); HP 64 and 128 stay at two and one, where shared
// memory allows no more.  Its block sum dW2 += h1ᵀ·dp2 stays on mma.sync:
// its loop is ~330 of the ~4000 warp instructions of a step at HP 64
// (SASS), so wgmma could take no more than that; TF32 wgmma takes both
// operands K-major, here path-major per unit, while the per-warp products
// Z and S read the same rows unit-major per path, and a second copy of the
// tile's h1 and dp2 rows does not fit beside them at HP 128 (223 KB of the
// 227 KB a block may hold).  The step's time is the 2H accurate tanhf, the
// epilogues and the latency of 8–16 warps an SM, not the products.
// Without TF the kernel is the split-TF32 one, unchanged.
//
// Design: a fixed number of blocks (ops/rollout.py b2_wide_blocks, as many
// as are resident on the card, independent of B) each walk their 128-path
// tiles in order, eight warps of one m16 tile of 16 paths each, the
// adjoint carries (x̄, ȳ) of a path on the lanes of its row group
// (rollout_wide.cuh).  W2 sits in shared memory once, in f32 (tc_split.cuh
// w_at: a layout that serves both Z's and S's fragments), and is split into
// hi and lo as its fragments are read (TF: stored rounded).  Per step:
//   * the lanes of each path do its scalar work (the piece lookup, the
//     three Clenshaw evaluations with derivatives, the recurrence), and each
//     lane takes the x, J and ḡ = ȳ of its row group's two paths;
//   * each warp computes h1 of its 16 paths at its lanes' units into its
//     staging rows, then Z = h1·W2 four n-tiles at a time (hi·hi and the
//     cross terms in two accumulators), then b2, h2, dp2 = W3·ḡ·(1 − h2²)
//     into the staging rows, and the sums over its paths of dW3 = ḡ·h2 and
//     db2 = dp2 (a fixed shuffle tree, ``reduce_rows``) into the warp's
//     slots; then S = dp2·W2ᵀ, dp1 = S·(1 − h1²), each lane's part of
//     ḡ·dΓ/dx = Σ_h W1[x, h]·dp1[h], and the sums of db1 = dp1 and of the
//     dW1 rows x·dp1 and J·dp1 into its slots; the four lanes of a path
//     add their parts of dΓ/dx in a fixed butterfly and x̄ walks back;
//   * the lanes of each path stage its piece and table weights (−ḡ, −ū,
//     ḡ·dW) in its h1 row's padding and its Chebyshev basis in its dp2
//     row's; one barrier;
//   * the block adds h1ᵀ·dp2 over its 128 staged paths on the tensor cores
//     into fresh fragments of dW2 (each warp a 2-D tile of them; the paths
//     are the contraction), and those into per-warp running sums with f32
//     adds that round to nearest; each thread sums its entries of the
//     warps' slots in warp order into compensated running sums (and ti
//     times the step's db1 into dW1's row t); the step's table
//     cotangents, each a sum over the tile's paths of those in its piece
//     (four interleaved quarters of the paths, each in order, then a fixed
//     butterfly), go into the block's partial in device memory (written on
//     its first tile, added to after); a second barrier frees the staging;
//   * every NCHUNK steps, and at the end of a tile, the running sums of dW2
//     are added into the partial's dW2, so an f32 register sum runs over at
//     most NCHUNK block sums.
// At the end of the walk each thread writes its unit sums and the block
// sums ȳ0 over its threads in order.  A second kernel sums the blocks'
// partials in block order.  No float atomics, so two runs on the same
// inputs give the same bits, and the partial buffer holds at most
// 2 × 132 × (H² + 6H + 1 + N·3·P·D) floats whatever B.  The Γ output bias
// never reaches the kernel: the caller folds it into the compensator
// table's T_0 row and derives its cotangent from that row's
// (ops/rollout.py).
#include "rollout_wide.cuh"

namespace rollout_wide {

using sweep::kahan_add;
using tc::mma_split;
using tc::mma_tf32;
using tc::reduce_rows;
using tc::split_tf32;
using tc::sum_lanes_t;
using tc::w_at;

template <int HP>
struct Bwd {
  using M = Mma<HP>;
  static constexpr int NB = M::NB, NG = M::NG, LDS = M::LDS, TILE = M::TILE;
  // the warps' 2-D tiling of dW2: WM × WN warps, each TM m16 tiles (rows of
  // W2) × TN n8 tiles (columns)
  static constexpr int MT = HP / 16;
  static constexpr int WM = MT < 4 ? MT : 4, WN = WARPS / WM;
  static constexpr int TM = MT / WM, TN = NB / WN;
  static_assert(WM * WN == WARPS && TM * WM == MT && TN * WN == NB,
                "the warps tile dW2");
  // the warps' slots: per warp and step its paths' sums of db2, dW3, db1
  // and the dW1 rows x and J, SEGS rows of HP
  static constexpr int SEGS = 5, DB2 = 0, DW3 = 1, DB1 = 2, DWX = 3, DWJ = 4;
  // the slot entries each thread sums across the walk
  static constexpr int R = (SEGS * HP + THREADS - 1) / THREADS;
  // shared memory, floats: W2 (w_at) | the first layer, packed (4·HP) | b2
  // (HP) | W3 (HP) | the tile's h1 rows (TILE of LDS; past HP each row
  // holds its path's piece, −ḡ, −ū and ḡ·dW) | its dp2 rows (past HP the
  // path's T_0 .. T_7) | the warps' slots
  static constexpr int W2S = 0;
  static constexpr int L1 = HP * HP;
  static constexpr int B2 = L1 + 4 * HP;
  static constexpr int W3 = B2 + HP;
  static constexpr int H1S = W3 + HP;
  static constexpr int DP2S = H1S + TILE * LDS;
  static constexpr int WS = DP2S + TILE * LDS;
  static constexpr int SIZE = WS + WARPS * SEGS * HP;
  static_assert(LDS - HP >= D && D == 8, "the padding holds a path's row");
  // dW2's running sums go into the partial every NCHUNK steps
  static constexpr int NCHUNK = 16;
};

// The head-TF32 instance (the template flag TF) takes every operand of the
// H×H products rounded to TF32 once, where it is staged, so that no inner
// loop rounds or splits anything.  W2 and dp2 are stored rounded
// (rollout::tf32_round).  h1, whose unrounded value B2w still needs for
// its tanh derivative 1 − h1², is stored as ``tf32_biased``: its bits plus
// half a TF32 unit.  The tensor cores read an operand register's TF32 bits
// and drop the 13 below, so they read the biased value as
// tf32_round(h1) (what cvt.rna.tf32.f32 gives, ties away from zero), and
// ``tf32_unbiased`` gives h1 back exactly.  h1 = tanh(·) is finite and at
// most 1 in magnitude, so the integer add never reaches an infinity.
__device__ __forceinline__ float tf32_biased(float x) {
  return __uint_as_float(__float_as_uint(x) + 0x1000u);
}

__device__ __forceinline__ float tf32_unbiased(float x) {
  return __uint_as_float(__float_as_uint(x) - 0x1000u);
}

// An operand as an instance stages it: with TF rounded to TF32, else as
// it is; h1 with TF biased, and back.
template <bool TF>
__device__ __forceinline__ float staged(float x) {
  if constexpr (TF)
    return rollout::tf32_round(x);
  else
    return x;
}

template <bool TF>
__device__ __forceinline__ float staged_h1(float x) {
  if constexpr (TF)
    return tf32_biased(x);
  else
    return x;
}

template <bool TF>
__device__ __forceinline__ float2 unstaged_h1(float2 v) {
  if constexpr (TF)
    return make_float2(tf32_unbiased(v.x), tf32_unbiased(v.y));
  else
    return v;
}

// The A fragment of k-step k from a warp's staging rows (as h1 and dp2 are
// written): (path g, unit 8k + 2t) → a0, (g + 8, 8k + 2t) → a1, (g, 8k +
// 2t + 1) → a2, (g + 8, 8k + 2t + 1) → a3, as stored.
__device__ __forceinline__ void a_rows(const float* rows, int s0, int s1,
                                       int k, float (&a)[4]) {
  const float2 p0 = *reinterpret_cast<const float2*>(rows + s0 + 8 * k);
  const float2 p1 = *reinterpret_cast<const float2*>(rows + s1 + 8 * k);
  a[0] = p0.x;
  a[1] = p1.x;
  a[2] = p0.y;
  a[3] = p1.y;
}

// The split A fragment of k-step k from a warp's staging rows (as h1 and
// dp2 are written): (path g, unit 8k + 2t) → a0, (g + 8, 8k + 2t) → a1,
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

// The blocks an SM holds at once (ops/rollout.py _WIDE_B2_BLOCKS_PER_SM):
// two where their shared memory allows it (HP <= 64), the registers capped
// to let them in; the TF32 instance, which carries no second accumulator
// and no lo operand, three at HP 32.
template <int HP, bool TF>
constexpr int bwd_blocks_per_sm() {
  return HP == 128 ? 1 : (TF && HP == 32) ? 3 : 2;
}

template <int HP, bool TF>
__global__ void __launch_bounds__(THREADS, (bwd_blocks_per_sm<HP, TF>()))
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
  using B = Bwd<HP>;
  constexpr int NB = B::NB, NG = B::NG, LDS = B::LDS;
  constexpr int TM = B::TM, TN = B::TN, R = B::R, SEGS = B::SEGS;
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const int tid = threadIdx.x, lane = tid % WARP, warp = tid / WARP;
  const int gq = lane / 4, t = lane % 4, own = t & 1;
  const bool writer = t < 2;
  const int n_tab = 3 * np * D;
  const int n_tiles = (batch + B::TILE - 1) / B::TILE;
  const size_t n_param = (size_t)h * h + 6 * (size_t)h;
  const size_t n_out = n_param + 1 + (size_t)n * n_tab;
  float* my_part = part + (size_t)blockIdx.x * n_out;
  // this warp's staging rows, and this lane's offsets in them: rows g and
  // g + 8, column 2t; its path's row of the tile
  float* h1w = sm + B::H1S + warp * 16 * LDS;
  float* dpw = sm + B::DP2S + warp * 16 * LDS;
  const int s0 = gq * LDS + 2 * t, s1 = s0 + 8 * LDS;
  const int mine = (gq + 8 * own) * LDS + HP;
  // offsets in an 8 × 8 block of W2: h1·W2's b0 (row 2t, column g; b1 is
  // the next float), dp2·W2ᵀ's b0 (row g, column 2t) and b1 (column 2t + 1)
  const int oz = w_at<HP>(2 * t, gq);
  const int os0 = w_at<HP>(gq, 2 * t), os1 = w_at<HP>(gq, 2 * t + 1);
  // this warp's tile of dW2: rows 16·(TM·wm + i) + …, columns 8·(TN·wn + j)
  const int wm = warp % B::WM, wn = warp / B::WM;
  float* ws = sm + B::WS;
  const float4* l1 = reinterpret_cast<const float4*>(sm + B::L1) + 2 * t;

  for (int q = tid; q < HP * HP; q += THREADS) {
    const int row = q / HP, col = q % HP;
    sm[B::W2S + w_at<HP>(row, col)] = staged<TF>(
        (row < h && col < h) ? __ldg(w2 + row * h + col) : 0.0f);
  }
  load_first_layer<HP>(sm + B::L1, w1, b1, h);
  for (int q = tid; q < HP; q += THREADS) {
    sm[B::B2 + q] = q < h ? __ldg(b2 + q) : 0.0f;
    sm[B::W3 + q] = q < h ? __ldg(w3 + q) : 0.0f;
  }

  float run[TM][TN][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) run[i][j][e] = 0.0f;
  // this thread's slot entries tid + THREADS·r: compensated running sums,
  // and for the entries of db1 the time row of dW1, Σ ti·db1
  float us[R], uc[R], ts[R], tcm[R];
#pragma unroll
  for (int r = 0; r < R; ++r) us[r] = uc[r] = ts[r] = tcm[r] = 0.0f;
  bool dw_first = true;
  float ay0 = 0.0f;
  __syncthreads();

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const bool first = tile == (int)blockIdx.x;
    const int b = tile * B::TILE + warp * 16 + gq + 8 * own;
    // idle paths of the ragged last tile carry zero cotangents, so every
    // sum they enter gets exact zeros from them
    const bool active = b < batch;
    float xb = active ? __ldg(cxn + b) : 0.0f;
    float yb = active ? __ldg(cyn + b) : 0.0f;
#pragma unroll 1
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

      float xe[2], je[2], ge[2];
      row_pair(x, lane, xe);
      row_pair(jv, lane, je);
      row_pair(gbar, lane, ge);
      // h1 of the warp's paths into its staging rows (TF: biased, read by
      // the tensor cores as rounded to TF32)
#pragma unroll
      for (int k = 0; k < NB; ++k) {
        const float4 p = l1[8 * k], q = l1[8 * k + 1];
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<float2*>(h1w + (r ? s1 : s0) + 8 * k) =
              make_float2(staged_h1<TF>(first_unit<TF>(p.x, p.z, q.x, q.z, ti,
                                                       xe[r], je[r])),
                          staged_h1<TF>(first_unit<TF>(p.y, p.w, q.y, q.w, ti,
                                                       xe[r], je[r])));
      }

      // Z = h1·W2 + b2 by groups of NG n-tiles (the split's hi·hi terms
      // in zb, its cross terms in zs; TF: one pass into zb); h2, dp2, and
      // the sums of dW3 and db2 over the warp's paths
#pragma unroll 1
      for (int n0 = 0; n0 < NB; n0 += NG) {
        float zb[NG][4], zs[TF ? 1 : NG][4];
#pragma unroll
        for (int q = 0; q < NG; ++q)
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            zb[q][v] = 0.0f;
            if constexpr (!TF) zs[q][v] = 0.0f;
          }
#pragma unroll
        for (int k = 0; k < NB; ++k) {
          if constexpr (TF) {
            float a[4];
            a_rows(h1w, s0, s1, k, a);
#pragma unroll
            for (int q = 0; q < NG; ++q) {
              const float2 w = *reinterpret_cast<const float2*>(
                  sm + B::W2S + (k * NB + n0 + q) * 64 + oz);
              const float b[2] = {w.x, w.y};
              mma_tf32(zb[q], a, b);
            }
          } else {
            float ah[4], al[4];
            a_from_rows(h1w, s0, s1, k, ah, al);
#pragma unroll
            for (int q = 0; q < NG; ++q) {
              const float2 w = *reinterpret_cast<const float2*>(
                  sm + B::W2S + (k * NB + n0 + q) * 64 + oz);
              float bh[2], bl[2];
              split_tf32(w.x, bh[0], bl[0]);
              split_tf32(w.y, bh[1], bl[1]);
              mma_split(zb[q], zs[q], ah, al, bh, bl);
            }
          }
        }
        // red: dW3 at units u, u + 1 of each n-tile, then db2 likewise
        float red[4 * NG];
#pragma unroll
        for (int q = 0; q < NG; ++q) {
          const int u = 8 * (n0 + q) + 2 * t;
          const float2 bk = *reinterpret_cast<const float2*>(sm + B::B2 + u);
          const float2 wk = *reinterpret_cast<const float2*>(sm + B::W3 + u);
          float h2[2][2], dp[2][2];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            if constexpr (TF) {
              h2[r][0] = tanhf(zb[q][2 * r] + bk.x);
              h2[r][1] = tanhf(zb[q][2 * r + 1] + bk.y);
            } else {
              h2[r][0] = tanhf(zb[q][2 * r] + zs[q][2 * r] + bk.x);
              h2[r][1] = tanhf(zb[q][2 * r + 1] + zs[q][2 * r + 1] + bk.y);
            }
            dp[r][0] = (wk.x * ge[r]) * (1.0f - h2[r][0] * h2[r][0]);
            dp[r][1] = (wk.y * ge[r]) * (1.0f - h2[r][1] * h2[r][1]);
          }
          // staged for the products (TF: rounded); db2 sums them unrounded
          *reinterpret_cast<float2*>(dpw + s0 + 8 * (n0 + q)) =
              make_float2(staged<TF>(dp[0][0]), staged<TF>(dp[0][1]));
          *reinterpret_cast<float2*>(dpw + s1 + 8 * (n0 + q)) =
              make_float2(staged<TF>(dp[1][0]), staged<TF>(dp[1][1]));
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            red[2 * q + j] = ge[0] * h2[0][j] + ge[1] * h2[1][j];
            red[2 * NG + 2 * q + j] = dp[0][j] + dp[1][j];
          }
        }
        reduce_rows<4 * NG>(red, lane);
        // lane (g, t) now holds entries 2g, 2g + 1: dW3 (g < 4) or db2, at
        // units 8·(n0 + g % 4) + 2t, + 1
        *reinterpret_cast<float2*>(
            ws + (warp * SEGS + (gq < 4 ? B::DW3 : B::DB2)) * HP +
            8 * (n0 + gq % 4) + 2 * t) = make_float2(red[0], red[1]);
      }

      // S = dp2·W2ᵀ by groups of NG n-tiles (units of h1); dp1, the lane's
      // part of dΓ/dx for its two paths, and the sums of db1, x·dp1 and
      // J·dp1 over the warp's paths
      float gx[2] = {0.0f, 0.0f};
#pragma unroll 1
      for (int n0 = 0; n0 < NB; n0 += NG) {
        float sb[NG][4], ss[TF ? 1 : NG][4];
#pragma unroll
        for (int q = 0; q < NG; ++q)
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            sb[q][v] = 0.0f;
            if constexpr (!TF) ss[q][v] = 0.0f;
          }
#pragma unroll
        for (int k = 0; k < NB; ++k) {
          if constexpr (TF) {
            float a[4];
            a_rows(dpw, s0, s1, k, a);
#pragma unroll
            for (int q = 0; q < NG; ++q) {
              const float* blk = sm + B::W2S + ((n0 + q) * NB + k) * 64;
              const float b[2] = {blk[os0], blk[os1]};
              mma_tf32(sb[q], a, b);
            }
          } else {
            float ah[4], al[4];
            a_from_rows(dpw, s0, s1, k, ah, al);
#pragma unroll
            for (int q = 0; q < NG; ++q) {
              const float* blk = sm + B::W2S + ((n0 + q) * NB + k) * 64;
              float bh[2], bl[2];
              split_tf32(blk[os0], bh[0], bl[0]);
              split_tf32(blk[os1], bh[1], bl[1]);
              mma_split(sb[q], ss[q], ah, al, bh, bl);
            }
          }
        }
        // red: entry (2q + j)·3 + s, s = db1, x·dp1, J·dp1 at unit u + j
        float red[6 * NG];
#pragma unroll
        for (int q = 0; q < NG; ++q) {
          const float4 p = l1[8 * (n0 + q)];  // W1[x] at u, u + 1: p.z, p.w
          const float2 hv[2] = {
              unstaged_h1<TF>(*reinterpret_cast<const float2*>(
                  h1w + s0 + 8 * (n0 + q))),
              unstaged_h1<TF>(*reinterpret_cast<const float2*>(
                  h1w + s1 + 8 * (n0 + q)))};
          float dp1[2][2];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            if constexpr (TF) {
              dp1[r][0] = sb[q][2 * r] * (1.0f - hv[r].x * hv[r].x);
              dp1[r][1] = sb[q][2 * r + 1] * (1.0f - hv[r].y * hv[r].y);
            } else {
              dp1[r][0] = (sb[q][2 * r] + ss[q][2 * r]) *
                          (1.0f - hv[r].x * hv[r].x);
              dp1[r][1] = (sb[q][2 * r + 1] + ss[q][2 * r + 1]) *
                          (1.0f - hv[r].y * hv[r].y);
            }
            gx[r] += p.z * dp1[r][0];
            gx[r] += p.w * dp1[r][1];
          }
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            red[(2 * q + j) * 3] = dp1[0][j] + dp1[1][j];
            red[(2 * q + j) * 3 + 1] = xe[0] * dp1[0][j] + xe[1] * dp1[1][j];
            red[(2 * q + j) * 3 + 2] = je[0] * dp1[0][j] + je[1] * dp1[1][j];
          }
        }
        reduce_rows<6 * NG>(red, lane);
        // lane (g, t) now holds entries 3g .. 3g + 2: the three sums at unit
        // 8·(n0 + g / 2) + 2t + g % 2
        const int u = 8 * (n0 + gq / 2) + 2 * t + gq % 2;
#pragma unroll
        for (int s = 0; s < 3; ++s)
          ws[(warp * SEGS + B::DB1 + s) * HP + u] = red[s];
      }
      // ḡ·dΓ/dx of this lane's path: its row group's four parts in a fixed
      // butterfly
      const float gx0 = sum_lanes_t(gx[0]), gx1 = sum_lanes_t(gx[1]);
      const float gxs = own ? gx1 : gx0;
      xb = xb * e - gbar * cps + gbar * dwr * zps - ub * aps + gxs;
      // the path's piece, table weights and Chebyshev basis for the
      // block's sums, in its rows' padding
      if (writer) {
        *reinterpret_cast<float4*>(sm + B::H1S + warp * 16 * LDS + mine) =
            make_float4((float)pk.k, -gbar, -ub, gbar * dwr);
        float* tk = sm + B::DP2S + warp * 16 * LDS + mine;
        float tk0 = 1.0f, tk1 = pk.t;
        tk[0] = tk0;
        tk[1] = tk1;
#pragma unroll
        for (int d = 2; d < D; ++d) {
          const float tk2 = 2.0f * pk.t * tk1 - tk0;
          tk[d] = tk2;
          tk0 = tk1;
          tk1 = tk2;
        }
      }
      __syncthreads();  // the tile's h1, dp2, path rows and slots are in

      // the block: h1ᵀ·dp2 over the tile's 128 paths (the contraction, in
      // k-steps of 8: rows 8k + t and 8k + t + 4 of the staging) into fresh
      // fragments of this warp's tile of dW2, then into its running sums
      {
        float f[TM][TN][4];
#pragma unroll
        for (int i2 = 0; i2 < TM; ++i2)
#pragma unroll
          for (int j = 0; j < TN; ++j)
#pragma unroll
            for (int v = 0; v < 4; ++v) f[i2][j][v] = 0.0f;
#pragma unroll 2
        for (int k = 0; k < B::TILE / 8; ++k) {
          const float* hr = sm + B::H1S + (8 * k + t) * LDS;
          const float* dr = sm + B::DP2S + (8 * k + t) * LDS;
          if constexpr (TF) {
            float a[TM][4];
#pragma unroll
            for (int i2 = 0; i2 < TM; ++i2) {
              const int r0 = 16 * (TM * wm + i2) + gq;
              a[i2][0] = hr[r0];
              a[i2][1] = hr[r0 + 8];
              a[i2][2] = hr[4 * LDS + r0];
              a[i2][3] = hr[4 * LDS + r0 + 8];
            }
#pragma unroll
            for (int j = 0; j < TN; ++j) {
              const int c0 = 8 * (TN * wn + j) + gq;
              const float b[2] = {dr[c0], dr[4 * LDS + c0]};
#pragma unroll
              for (int i2 = 0; i2 < TM; ++i2) mma_tf32(f[i2][j], a[i2], b);
            }
          } else {
            float ah[TM][4], al[TM][4];
#pragma unroll
            for (int i2 = 0; i2 < TM; ++i2) {
              const int r0 = 16 * (TM * wm + i2) + gq;
              split_tf32(hr[r0], ah[i2][0], al[i2][0]);
              split_tf32(hr[r0 + 8], ah[i2][1], al[i2][1]);
              split_tf32(hr[4 * LDS + r0], ah[i2][2], al[i2][2]);
              split_tf32(hr[4 * LDS + r0 + 8], ah[i2][3], al[i2][3]);
            }
#pragma unroll
            for (int j = 0; j < TN; ++j) {
              const int c0 = 8 * (TN * wn + j) + gq;
              float bh[2], bl[2];
              split_tf32(dr[c0], bh[0], bl[0]);
              split_tf32(dr[4 * LDS + c0], bh[1], bl[1]);
#pragma unroll
              for (int i2 = 0; i2 < TM; ++i2)
                mma_split(f[i2][j], f[i2][j], ah[i2], al[i2], bh, bl);
            }
          }
        }
#pragma unroll
        for (int i2 = 0; i2 < TM; ++i2)
#pragma unroll
          for (int j = 0; j < TN; ++j)
#pragma unroll
            for (int v = 0; v < 4; ++v) run[i2][j][v] += f[i2][j][v];
      }
      // the block: this thread's slot entries summed over the warps in
      // order into its running sums
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int q = tid + THREADS * r;
        if (q < SEGS * HP) {
          float s = ws[q];
#pragma unroll
          for (int w = 1; w < WARPS; ++w) s += ws[w * SEGS * HP + q];
          kahan_add(us[r], uc[r], s);
          if (q / HP == B::DB1) kahan_add(ts[r], tcm[r], ti * s);
        }
      }
      // the block: the step's table cotangents; thread (entry, quarter)
      // sums the paths 4j + quarter of the entry's piece in order, then the
      // four quarters in a fixed butterfly
      float* dst = my_part + n_param + 1 + (size_t)i * n_tab;
      for (int ent = tid / 4; ent < np * D; ent += THREADS / 4) {
        const float piece = (float)(ent / D);
        const int d = ent % D;
        float acc[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll 4
        for (int j = tid % 4; j < B::TILE; j += 4) {
          const float4 wv = *reinterpret_cast<const float4*>(
              sm + B::H1S + j * LDS + HP);
          const float tv = sm[B::DP2S + j * LDS + HP + d];
          if (wv.x == piece) {
            acc[0] += tv * wv.y;
            acc[1] += tv * wv.z;
            acc[2] += tv * wv.w;
          }
        }
#pragma unroll
        for (int tb = 0; tb < 3; ++tb) {
          const float s = sum_lanes_t(acc[tb]);
          if (tid % 4 == 0) {
            const int q = tb * np * D + ent;
            dst[q] = first ? s : dst[q] + s;
          }
        }
      }
      // every NCHUNK steps and at the tile's end, the running sums into
      // the partial's dW2 (entries past h are the padding's, dropped)
      if ((n - i) % B::NCHUNK == 0 || i == 0) {
#pragma unroll
        for (int i2 = 0; i2 < TM; ++i2)
#pragma unroll
          for (int j = 0; j < TN; ++j)
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              const int rw = 16 * (TM * wm + i2) + gq + 8 * (v / 2);
              const int cl = 8 * (TN * wn + j) + 2 * t + v % 2;
              if (rw < h && cl < h) {
                float* p = my_part + (size_t)rw * h + cl;
                *p = dw_first ? run[i2][j][v] : *p + run[i2][j][v];
              }
              run[i2][j][v] = 0.0f;
            }
        dw_first = false;
      }
      __syncthreads();  // the staging rows and slots are free
    }
    if (writer) ay0 += yb;  // ȳ0 contributions (zero for idle paths)
  }

  // the unit sums: [db2 | dW3 | db1 | dW1 row t | dW1 row x | dW1 row J]
  // after dW2 (entries past h are the padding's, dropped)
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int q = tid + THREADS * r;
    const int seg = q / HP, idx = q % HP;
    if (q < SEGS * HP && idx < h) {
      // the slots' order db2, dW3, db1, x, J; the time row sits before x
      const int at = seg < B::DWX ? seg : seg + 1;
      my_part[(size_t)h * h + (size_t)at * h + idx] = us[r];
      if (seg == B::DB1) my_part[(size_t)h * h + 3 * (size_t)h + idx] = ts[r];
    }
  }
  // ȳ0: the threads' sums in order
  sm[B::H1S + tid] = ay0;
  __syncthreads();
  if (tid == 0) {
    float s = 0.0f;
    for (int k = 0; k < THREADS; ++k) s += sm[B::H1S + k];
    my_part[n_param] = s;
  }
}

// The shared memory above 48 KB needs the kernel's opt-in before a launch.
template <int HP, bool TF>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(bwd_kernel<HP, TF>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)(sizeof(float) * Bwd<HP>::SIZE));
}

template <int HP, bool TF>
cudaError_t info_bwd(int* smem, int* blocks_per_sm) {
  *smem = (int)(sizeof(float) * Bwd<HP>::SIZE);
  const cudaError_t err = allow_smem<HP, TF>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, bwd_kernel<HP, TF>, THREADS, *smem);
}

template <bool TF>
int info_bwd_at(int hidden, int* smem, int* blocks_per_sm) {
  switch (wide_width_class(hidden)) {
    case 32:
      return (int)info_bwd<32, TF>(smem, blocks_per_sm);
    case 64:
      return (int)info_bwd<64, TF>(smem, blocks_per_sm);
    case 128:
      return (int)info_bwd<128, TF>(smem, blocks_per_sm);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <int HP, bool TF>
cudaError_t launch_bwd(const float* dw, const float* jr, const float* cc,
                       const float* pc, const float* zc, const float* lo,
                       const float* hi, const float* w1, const float* b1,
                       const float* w2, const float* b2, const float* w3,
                       const float* xs, const float* ys, const float* cxn,
                       const float* cyn, float* part, float* out, int n,
                       int batch, int np, int h, int n_blocks, Consts c,
                       cudaStream_t stream) {
  if (n_blocks > (batch + Bwd<HP>::TILE - 1) / Bwd<HP>::TILE)
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem<HP, TF>();
  if (err != cudaSuccess) return err;
  bwd_kernel<HP, TF><<<n_blocks, THREADS, sizeof(float) * Bwd<HP>::SIZE,
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
// arguments of rollout_bwd, r·dt in the place of its 1 + r·dt.  ``part``
// holds n_blocks partials of (H² + 6H + 1 + N·3·P·D) floats, n_blocks in
// [1, number of 128-path tiles]; ``out`` one of them, the sum.  head_tf32
// != 0 selects the head-TF32 instance.  Returns the launches' cudaError_t;
// cudaErrorInvalidValue for 8, 21 and widths outside 1..128.
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
                                int head_tf32, float time_scale, float r_dt,
                                float a_lin, float dt, float sigma,
                                float drift, void* stream) {
  using namespace rollout_wide;
  if (n < 1 || batch < 1 || n_pieces < 1 || n_blocks < 1)
    return (int)cudaErrorInvalidValue;
  const Consts c{time_scale, r_dt, a_lin, dt, sigma, drift};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (wide_width_class(hidden) * 2 + (head_tf32 != 0)) {
#define ROLLOUT_WIDE_BWD_CASE(HP, TF)                                        \
  case HP * 2 + TF:                                                          \
    return (int)launch_bwd<HP, TF>(dw, jr, cc, pc, zc, lo, hi, w1, b1, w2,   \
                                   b2, w3, xs, ys, cxn, cyn, part, out, n,   \
                                   batch, n_pieces, hidden, n_blocks, c, st);
    ROLLOUT_WIDE_BWD_CASE(32, false)
    ROLLOUT_WIDE_BWD_CASE(32, true)
    ROLLOUT_WIDE_BWD_CASE(64, false)
    ROLLOUT_WIDE_BWD_CASE(64, true)
    ROLLOUT_WIDE_BWD_CASE(128, false)
    ROLLOUT_WIDE_BWD_CASE(128, true)
#undef ROLLOUT_WIDE_BWD_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The kernel's dynamic shared memory per block and its resident blocks per
// SM at the width class of ``hidden`` (chip_smoke.py reports them), of the
// split instance and of the head-TF32 one.
extern "C" int rollout_wide_bwd_info(int hidden, int* smem,
                                     int* blocks_per_sm) {
  return rollout_wide::info_bwd_at<false>(hidden, smem, blocks_per_sm);
}

extern "C" int rollout_wide_bwd_tf32_info(int hidden, int* smem,
                                          int* blocks_per_sm) {
  return rollout_wide::info_bwd_at<true>(hidden, smem, blocks_per_sm);
}
