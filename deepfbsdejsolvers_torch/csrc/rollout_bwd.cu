// Kernel B2: the backward of the hoisted Merton global rollout, a reverse
// replay of the adjoint recurrence over the residuals B1 saved.
//
// Replaces the Pallas kernel of the JAX package's ops/pallas_rollout.py,
// make_fused_rollout -> _bwd_kernel (its call site is _bwd_call).
//
// What bounds it on an H100: instruction issue.  Per path and step it
// recomputes the Γ head's hidden layers (2H² + 10H operations, 2H accurate
// tanhf of some twenty instructions each), runs the head's backward
// (2H² + 4H, which also gives dΓ/dx as Σ_h W1[x, h]·dp1[h]), three Clenshaw
// evaluations with derivatives, and adds into the sums over paths: the
// parameter cotangents (2H² + 12H) and the step's table cotangents.  It
// reads 16 bytes per path-step (xs, ys, dW, J).
//
// Design: a fixed number of blocks (ops/rollout.py b2_blocks, independent
// of B) each walk their 128-path tiles in order, one thread per path with
// the adjoint carries (x̄, ȳ) in registers; the TPU kernel's sequential grid
// becomes that walk.  Each warp works alone on its 32 paths but for one
// block barrier per step:
//   * the head's weights sit in shared memory with rows padded to a
//     multiple of 4 floats (rollout_common.cuh), read as float4 broadcasts;
//   * per step each thread stages its path's h1, dp2, dp1, x, J, piece
//     index, Chebyshev basis and three table weights in its warp's rows of
//     shared memory, and the warp syncs with __syncwarp;
//   * dW2 and db2 (the head-TF32 instance's db2 apart, below): each lane
//     adds a fixed RM×CM micro-tile of Lᵀ·R over the
//     warp's paths, L = [h1; 1; x; J] and R = [dp2; dp1] (rows past the
//     needed H + 1 by H are read and dropped), RM + CM float4 reads feeding
//     4·RM·CM FMAs; db1 and the three dW1 rows: lane h sums dp1[h], x·dp1[h]
//     and J·dp1[h] over the paths (the time row takes the step's t_i times
//     the first); dW3: ḡ·h2 is summed over the warp by shuffles in a fixed
//     tree, eight outputs at a time.  All of these sums stay in the lane's
//     registers across every step and tile the block walks, and are summed
//     over the warps, in warp order, once at the end;
//   * the step's table cotangents: lane q owns piece q / 4 and coefficients
//     2(q % 4), 2(q % 4) + 1 of all three tables, and adds the basis times
//     (−ḡ, −ū, ḡ·dW) of the warp's paths that lie in its piece.  The warps'
//     sums wait in one of two shared-memory slots for the step's barrier,
//     after which the block adds them in warp order into its partial in
//     device memory (written on the block's first tile, added to after);
//   * a second kernel sums the blocks' partials in block order.
// Shared memory (53,664 bytes at H = 21, P = 8) and the 128-register cap of
// __launch_bounds__(128, 4) leave room for four blocks (16 warps) per SM;
// ptxas then spills a few values, and three blocks per SM without spills
// ran slower (PERF.md).  No float atomics anywhere, so two runs on the same inputs give the same
// bits, and the partial buffer holds at most b2_blocks × (H² + 6H + 1 +
// N·3·P·D) floats whatever B.  The Γ output bias never reaches the kernel:
// the caller folds it into the compensator table's T_0 row and derives its
// cotangent from that row's (ops/rollout.py).
//
// The template flag TF is the head-TF32 mode (rollout_common.cuh
// tf32_round): every operand of the three H×H products is rounded to TF32,
// h1 and W2 in the recomputed layer, W2 and dp2 in W2·dp2, h1 and dp2 in
// h1ᵀ·dp2, the sums in f32 in the same order.  Each operand is rounded
// once, where it is loaded or staged (W2 at the weight load, h1 and dp2 as
// each thread writes its staging rows), so the micro-tile runs the FP32
// instance's loop on rounded rows, with no rounding and no select in it.
// db2 stays the sum of the unrounded dp2, as in the plain version: it is
// summed apart, beside dW3, by a shuffle tree over the warp of the raw dp2
// of each group of eight outputs (warp_sum8) into a register per group,
// and the micro-tile's ones row (computed on the rounded dp2) is dropped.
// Without TF the kernel is the FP32 one, unchanged: db2 is the ones row.
// On an NVIDIA H100 80GB HBM3 at 700 W (kernel_ab.py, B = 2^17, N = 50,
// P = 8, H = 21, in turns) the TF instance runs 1.36 ms beside the FP32
// instance's 1.30; with dp2 rounded and selected per element inside the
// micro-tile it ran 1.98.  Both take 128 registers and four blocks an SM;
// the TF instance spills 108 bytes (the FP32 one 92).
#include "rollout_common.cuh"

namespace rollout {

constexpr int BWD_THREADS = 128;
constexpr int BWD_MIN_BLOCKS = 4;  // resident blocks per SM asked of ptxas
constexpr int WARP = 32;
constexpr int WARPS = BWD_THREADS / WARP;
constexpr int LDJ = WARP + 4;  // staging row of a warp's paths, 4 floats off a bank line
constexpr int REDUCE_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

// Which part of Lᵀ·R a lane adds up: NRT × NCT micro-tiles of RM rows by
// CM columns, each over KS slices of the warp's paths; lanes past
// NRT·NCT·KS idle.  At H = 21 the 8 × 4 tiles of 3 × 6 cover 24 × 24 with
// every lane, and a warp's reads of the eight L rows fall in eight
// distinct bank quads.
template <int H>
struct Tiling;
template <>
struct Tiling<21> {
  static constexpr int RM = 3, NRT = 8, CM = 6, NCT = 4, KS = 1;
};
template <>
struct Tiling<8> {
  static constexpr int RM = 3, NRT = 3, CM = 4, NCT = 2, KS = 4;
};

template <int H>
struct Bwd {
  using T = Tiling<H>;
  static constexpr int RM = T::RM, CM = T::CM;
  static constexpr int ROWS = T::NRT * RM, COLS = T::NCT * CM;
  static constexpr int TEAM = T::NRT * T::NCT * T::KS;
  static constexpr int KLEN = WARP / T::KS;
  static_assert(ROWS >= H + 1 && ROWS <= H + 3 && COLS >= H &&
                    COLS <= 2 * H && TEAM <= WARP && KLEN % 4 == 0,
                "tiling does not cover h1ᵀ·dp2 inside the staged rows");
  // A warp's staging rows, LDJ floats each: L = h1 (H) | ones | x | J, then
  // R = dp2 (H) | dp1 (H), then the piece index, the table weights −ḡ, −ū,
  // ḡ·dW and the basis T_0 .. T_{D-1}(t).
  static constexpr int ONES = H, X = H + 1, J = H + 2;
  static constexpr int R = H + 3, DP1 = R + H;
  static constexpr int K = DP1 + H, G = K + 1, BASIS = G + 3;
  static constexpr int WARP_ROWS = BASIS + D;
  // Block shared memory, in floats: head | the warps' staging rows | two
  // slots of the warps' table sums (WARPS × 3·P·D each, P at run time).
  static constexpr int STG = Head<H>::SIZE;
  static constexpr int TAB = STG + WARPS * WARP_ROWS * LDJ;
  // dW3 is summed over the warp eight outputs at a time
  static constexpr int GROUPS = (H + 7) / 8;
  // At the end of the walk each thread's sums in [sum][thread] rows, over
  // the staging rows: the micro-tile, db1 and the dW1 rows t, x, J, the
  // dW3 groups, the db2 groups (head-TF32 instance), ȳ0.
  static constexpr int F_DB1 = RM * CM, F_DW3 = F_DB1 + 4,
                       F_DB2 = F_DW3 + GROUPS, F_Y0 = F_DB2 + GROUPS,
                       F_ROWS = F_Y0 + 1;
  static_assert(F_ROWS * BWD_THREADS <= WARPS * WARP_ROWS * LDJ,
                "the final sums do not fit the staging rows");
  // Parameter cotangents, in this order: dW2 (H×H, row h1 × column out) |
  // db2 | dW3 | db1 | dW1 row t | dW1 row x | dW1 row J.  Then ȳ0 at index
  // N_PARAM, then the table cotangents (N, 3, P, D).
  static constexpr int N_PARAM = H * H + 6 * H;
};

// One halving stage of a warp sum of eight slots: lanes whose bit BIT is
// set keep the upper half of the live slots, the others the lower half;
// each adds its partner's copy of the half it keeps and sends the other.
template <int HALF, int BIT>
__device__ __forceinline__ void halve(float (&v)[8], int lane) {
  const bool upper = (lane & BIT) != 0;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = upper ? v[i] : v[i + HALF];
    const float keep = upper ? v[i + HALF] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL, send, BIT);
  }
}

// Σ over the warp's lanes of v[s] for s < 8, returned in the lanes l with
// l / 4 == s: a fixed tree of 9 shuffles.
__device__ __forceinline__ float warp_sum8(float (&v)[8], int lane) {
  halve<4, 16>(v, lane);
  halve<2, 8>(v, lane);
  halve<1, 4>(v, lane);
  float s = v[0];
  s += __shfl_xor_sync(FULL, s, 2);
  s += __shfl_xor_sync(FULL, s, 1);
  return s;
}

template <int H, bool TF>
__global__ void __launch_bounds__(BWD_THREADS, BWD_MIN_BLOCKS)
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
  using W = Bwd<H>;
  using T = Tiling<H>;
  constexpr int RM = W::RM, CM = W::CM;
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const int tid = threadIdx.x, lane = tid % WARP, warp = tid / WARP;
  const int n_tab = 3 * p * D;
  const int n_tiles = (batch + BWD_THREADS - 1) / BWD_THREADS;
  const size_t n_out = (size_t)W::N_PARAM + 1 + (size_t)n * n_tab;
  float* my_part = part + (size_t)blockIdx.x * n_out;
  float* st = sm + W::STG + warp * W::WARP_ROWS * LDJ;  // [row][path]
  float* tab = sm + W::TAB;  // [slot][warp][table][piece][coefficient]

  load_head<H, TF>(sm, w1, b1, w2, b2, w3);
  st[W::ONES * LDJ + lane] = 1.0f;
  __syncthreads();

  // this lane's micro-tile of Lᵀ·R and its slice of the warp's paths
  const bool in_team = lane < W::TEAM;
  const int rt = lane % T::NRT, ct = (lane / T::NRT) % T::NCT,
            ks = lane / (T::NRT * T::NCT);
  const float* tile_l = st + rt * RM * LDJ + ks * W::KLEN;
  const float* tile_r = st + (W::R + ct * CM) * LDJ + ks * W::KLEN;
  float acc[RM][CM];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int k = 0; k < CM; ++k) acc[r][k] = 0.0f;
  // lane h < H: Σ dp1[h] | Σ t·dp1[h] | Σ x·dp1[h] | Σ J·dp1[h]
  float a1 = 0.0f, at = 0.0f, ax = 0.0f, aj = 0.0f;
  // dW3 output 8g + lane / 4, and with TF db2 output 8g + lane / 4
  float a3[W::GROUPS], a2[W::GROUPS];
#pragma unroll
  for (int g = 0; g < W::GROUPS; ++g) a3[g] = a2[g] = 0.0f;
  float ay0 = 0.0f;
  int slot = 0;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const bool first = tile == (int)blockIdx.x;
    const int b = tile * BWD_THREADS + tid;
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
      const Piece pk = locate(x, __ldg(lo + i), __ldg(hi + i), p);
      const size_t row = ((size_t)i * p + pk.k) * D;
      float dcd, dad, dzd;
      clenshaw_deriv(cc + row, pk.t, &dcd);
      const float a_val = clenshaw_deriv(pc + row, pk.t, &dad);
      clenshaw_deriv(zc + row, pk.t, &dzd);
      const float cps = dcd * pk.dtdx, aps = dad * pk.dtdx,
                  zps = dzd * pk.dtdx;
      // adjoint recurrence (f' = -r, coupling' = aLin sign(u))
      const float u = yrow - a_val;
      const float sgn = (float)((u > 0.0f) - (u < 0.0f));
      const float ub = xb * (c.a_lin * sgn) * c.dt;
      yb = yb + ub;
      const float e = 1.0f + expm1_acc(c.drift + c.sigma * dwr + jv);
      const float gbar = yb;
      yb = yb * c.growth;

      float h1[H];
      first_layer<H, TF>(sm, ti, x, jv, h1);
#pragma unroll
      for (int h = 0; h < H; ++h)
        st[h * LDJ + lane] = TF ? tf32_round(h1[h]) : h1[h];
      // h2 a quad at a time: dp2 = W3·ḡ·(1 − h2²) (with TF rounded, as
      // staged), and ḡ·h2 summed over the warp into dW3 eight outputs at a
      // time (with TF the raw dp2 into db2 beside it)
      float dp2[H];
#pragma unroll
      for (int g = 0; g < W::GROUPS; ++g) {
        float gh2[8], raw[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) gh2[k] = raw[k] = 0.0f;
#pragma unroll
        for (int q = 2 * g; q < 2 * g + 2 && q < L::QUADS; ++q) {
          float h2[4];
          second_layer_quad<H, TF>(sm, h1, q, h2);
          const float4 w3q = quad(sm + L::W3, q);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int o = 4 * q + k;
            if (o < H) {
              dp2[o] = (lane_of(w3q, k) * gbar) * (1.0f - h2[k] * h2[k]);
              if constexpr (TF) {
                raw[o - 8 * g] = dp2[o];
                dp2[o] = tf32_round(dp2[o]);
              }
              st[(W::R + o) * LDJ + lane] = dp2[o];
              gh2[o - 8 * g] = gbar * h2[k];
            }
          }
        }
        a3[g] += warp_sum8(gh2, lane);
        if constexpr (TF) a2[g] += warp_sum8(raw, lane);
      }
      // dp1 = (W2·dp2)·(1 − h1²).  Its x entry, Σ_h W1[x, h]·dp1[h], is
      // ḡ·dΓ/dx, so no forward-mode pass is needed.
      float gx = 0.0f;
#pragma unroll
      for (int q = 0; q < L::QUADS; ++q) {
        const float4 wx = quad(sm + L::W1 + L::HP, q);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int h = 4 * q + k;
          if (h < H) {
            float s = 0.0f;
#pragma unroll
            for (int oq = 0; oq < L::QUADS; ++oq) {
              const float4 w = quad(sm + L::W2 + h * L::HP, oq);
#pragma unroll
              for (int kk = 0; kk < 4; ++kk)
                if (4 * oq + kk < H) s += lane_of(w, kk) * dp2[4 * oq + kk];
            }
            const float dp1 = s * (1.0f - h1[h] * h1[h]);
            st[(W::DP1 + h) * LDJ + lane] = dp1;
            gx += lane_of(wx, k) * dp1;
          }
        }
      }
      xb = xb * e - gbar * cps + gbar * dwr * zps - ub * aps + gx;
      st[W::X * LDJ + lane] = x;
      st[W::J * LDJ + lane] = jv;
      st[W::K * LDJ + lane] = (float)pk.k;
      st[W::G * LDJ + lane] = -gbar;
      st[(W::G + 1) * LDJ + lane] = -ub;
      st[(W::G + 2) * LDJ + lane] = gbar * dwr;
      float tk0 = 1.0f, tk1 = pk.t;
      st[W::BASIS * LDJ + lane] = tk0;
      st[(W::BASIS + 1) * LDJ + lane] = tk1;
#pragma unroll
      for (int d = 2; d < D; ++d) {
        const float tk2 = 2.0f * pk.t * tk1 - tk0;
        st[(W::BASIS + d) * LDJ + lane] = tk2;
        tk0 = tk1;
        tk1 = tk2;
      }
      __syncwarp();

      // this lane's micro-tile of Lᵀ·R over the warp's paths
      if (in_team) {
#pragma unroll
        for (int j = 0; j < W::KLEN / 4; ++j) {
          float4 lq[RM], rq[CM];
#pragma unroll
          for (int r = 0; r < RM; ++r) lq[r] = quad(tile_l + r * LDJ, j);
#pragma unroll
          for (int k = 0; k < CM; ++k) rq[k] = quad(tile_r + k * LDJ, j);
#pragma unroll
          for (int r = 0; r < RM; ++r)
#pragma unroll
            for (int k = 0; k < CM; ++k) {
              acc[r][k] += lq[r].x * rq[k].x;
              acc[r][k] += lq[r].y * rq[k].y;
              acc[r][k] += lq[r].z * rq[k].z;
              acc[r][k] += lq[r].w * rq[k].w;
            }
        }
      }
      // db1 and the dW1 rows of input lane
      if (lane < H) {
        const float* rd = st + (W::DP1 + lane) * LDJ;
        float s1 = 0.0f, sx = 0.0f, sj = 0.0f;
#pragma unroll
        for (int j = 0; j < WARP / 4; ++j) {
          const float4 d4 = quad(rd, j), x4 = quad(st + W::X * LDJ, j),
                       j4 = quad(st + W::J * LDJ, j);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            s1 += lane_of(d4, k);
            sx += lane_of(x4, k) * lane_of(d4, k);
            sj += lane_of(j4, k) * lane_of(d4, k);
          }
        }
        a1 += s1;
        at += ti * s1;  // the time feature is the same for every path
        ax += sx;
        aj += sj;
      }
      // the step's table cotangents: (piece, two coefficients) of a lane
      float* wtab = tab + (slot * WARPS + warp) * n_tab;
      for (int q = lane; q < p * (D / 2); q += WARP) {
        const int piece = q / (D / 2), d = 2 * (q % (D / 2));
        const float fpiece = (float)piece;
        float s[3][2];
#pragma unroll
        for (int t = 0; t < 3; ++t) s[t][0] = s[t][1] = 0.0f;
#pragma unroll
        for (int j = 0; j < WARP / 4; ++j) {
          const float4 k4 = quad(st + W::K * LDJ, j);
          const float4 g4[3] = {quad(st + W::G * LDJ, j),
                                quad(st + (W::G + 1) * LDJ, j),
                                quad(st + (W::G + 2) * LDJ, j)};
          const float4 t0 = quad(st + (W::BASIS + d) * LDJ, j);
          const float4 t1 = quad(st + (W::BASIS + d + 1) * LDJ, j);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (lane_of(k4, k) == fpiece) {
#pragma unroll
              for (int t = 0; t < 3; ++t) {
                s[t][0] += lane_of(t0, k) * lane_of(g4[t], k);
                s[t][1] += lane_of(t1, k) * lane_of(g4[t], k);
              }
            }
          }
        }
#pragma unroll
        for (int t = 0; t < 3; ++t) {
          wtab[(t * p + piece) * D + d] = s[t][0];
          wtab[(t * p + piece) * D + d + 1] = s[t][1];
        }
      }
      // every warp's table sums of step i are in; every warp is done with
      // its staging rows, so the next step may write them
      __syncthreads();
      const float* src = tab + slot * WARPS * n_tab;
      float* dst = my_part + W::N_PARAM + 1 + (size_t)i * n_tab;
      for (int q = tid; q < n_tab; q += BWD_THREADS) {
        float s = src[q];
#pragma unroll
        for (int w = 1; w < WARPS; ++w) s += src[w * n_tab + q];
        dst[q] = first ? s : dst[q] + s;
      }
      slot ^= 1;
    }
    ay0 += yb;  // ȳ0 contributions (zero for idle threads)
  }

  // each thread's sums into [sum][thread] rows over the staging rows, then
  // each output summed over the warps (and slices) in order
  __syncthreads();
  float* fin = sm + W::STG;
#pragma unroll
  for (int e = 0; e < RM * CM; ++e)
    fin[e * BWD_THREADS + tid] = acc[e / CM][e % CM];
  fin[W::F_DB1 * BWD_THREADS + tid] = a1;
  fin[(W::F_DB1 + 1) * BWD_THREADS + tid] = at;
  fin[(W::F_DB1 + 2) * BWD_THREADS + tid] = ax;
  fin[(W::F_DB1 + 3) * BWD_THREADS + tid] = aj;
#pragma unroll
  for (int g = 0; g < W::GROUPS; ++g) {
    fin[(W::F_DW3 + g) * BWD_THREADS + tid] = a3[g];
    if constexpr (TF) fin[(W::F_DB2 + g) * BWD_THREADS + tid] = a2[g];
  }
  fin[W::F_Y0 * BWD_THREADS + tid] = ay0;
  __syncthreads();
  for (int q = tid; q <= W::N_PARAM; q += BWD_THREADS) {
    float s = 0.0f;
    if (TF && q >= H * H && q < H * H + H) {
      // db2 of the head-TF32 instance: its groups' lanes 4·(o % 8)
      const int o = q - H * H;
      const float* f = fin + (W::F_DB2 + o / 8) * BWD_THREADS + 4 * (o % 8);
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += f[w * WARP];
    } else if (q < H * H + H) {  // dW2, then db2 (row H of the product: ones)
      const int r = q < H * H ? q / H : H, k = q < H * H ? q % H : q - H * H;
      const int lane_q = r / RM + T::NRT * (k / CM);
      const float* f = fin + ((r % RM) * CM + k % CM) * BWD_THREADS;
#pragma unroll
      for (int w = 0; w < WARPS; ++w)
#pragma unroll
        for (int kk = 0; kk < T::KS; ++kk)
          s += f[w * WARP + lane_q + T::NRT * T::NCT * kk];
    } else if (q < W::N_PARAM) {
      const int seg = (q - H * H) / H - 1, idx = (q - H * H) % H;
      // seg 0: dW3 (lanes 4·(o % 8) of group o / 8); 1..4: db1, dW1 t, x, J
      const float* f =
          seg == 0 ? fin + (W::F_DW3 + idx / 8) * BWD_THREADS + 4 * (idx % 8)
                   : fin + (W::F_DB1 + seg - 1) * BWD_THREADS + idx;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += f[w * WARP];
    } else {  // ȳ0, over the block's threads in order
      for (int k = 0; k < BWD_THREADS; ++k)
        s += fin[W::F_Y0 * BWD_THREADS + k];
    }
    my_part[q] = s;
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
size_t smem_bytes(int p) {
  return sizeof(float) * ((size_t)Bwd<H>::TAB + 2 * WARPS * 3 * p * D);
}

// The shared memory above 48 KB needs the kernel's opt-in before a launch.
template <int H, bool TF>
cudaError_t allow_smem(size_t smem) {
  return cudaFuncSetAttribute(
      bwd_kernel<H, TF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
}

template <int H, bool TF>
cudaError_t info_bwd(int p, int* smem, int* blocks_per_sm) {
  const size_t bytes = smem_bytes<H>(p);
  *smem = (int)bytes;
  const cudaError_t err = allow_smem<H, TF>(bytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, bwd_kernel<H, TF>, BWD_THREADS, bytes);
}

template <bool TF>
int info_bwd_at(int hidden, int n_pieces, int* smem, int* blocks_per_sm) {
  if (n_pieces < 1) return (int)cudaErrorInvalidValue;
  switch (hidden) {
    case 8:
      return (int)info_bwd<8, TF>(n_pieces, smem, blocks_per_sm);
    case 21:
      return (int)info_bwd<21, TF>(n_pieces, smem, blocks_per_sm);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <int H, bool TF>
cudaError_t launch_bwd(const float* dw, const float* jr, const float* cc,
                       const float* pc, const float* zc, const float* lo,
                       const float* hi, const float* w1, const float* b1,
                       const float* w2, const float* b2, const float* w3,
                       const float* xs, const float* ys, const float* cxn,
                       const float* cyn, float* part, float* out, int n,
                       int batch, int p, int n_blocks, Consts c,
                       cudaStream_t stream) {
  const size_t smem = smem_bytes<H>(p);
  cudaError_t err = allow_smem<H, TF>(smem);
  if (err != cudaSuccess) return err;
  bwd_kernel<H, TF><<<n_blocks, BWD_THREADS, smem, stream>>>(
      dw, jr, cc, pc, zc, lo, hi, w1, b1, w2, b2, w3, xs, ys, cxn, cyn, part,
      n, batch, p, c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_out = Bwd<H>::N_PARAM + 1 + n * 3 * p * D;
  reduce_partials<<<(n_out + REDUCE_THREADS - 1) / REDUCE_THREADS,
                    REDUCE_THREADS, 0, stream>>>(part, out, n_blocks, n_out);
  return cudaGetLastError();
}

}  // namespace rollout

// C entry (bound with ctypes by ops/rollout.py b2_backward).  ``part`` holds
// n_blocks partials of (H² + 6H + 1 + N·3·P·D) floats, n_blocks in
// [1, ceil(batch / 128)]; ``out`` one of them, the sum.  head_tf32 != 0
// selects the head-TF32 instance.  Returns the launches' cudaError_t;
// cudaErrorInvalidValue for a hidden width not built here.
extern "C" int rollout_bwd(const float* dw, const float* jr, const float* cc,
                           const float* pc, const float* zc, const float* lo,
                           const float* hi, const float* w1, const float* b1,
                           const float* w2, const float* b2, const float* w3,
                           const float* xs, const float* ys, const float* cxn,
                           const float* cyn, float* part, float* out, int n,
                           int batch, int n_pieces, int hidden, int n_blocks,
                           int head_tf32, float time_scale, float growth,
                           float a_lin, float dt, float sigma, float drift,
                           void* stream) {
  using namespace rollout;
  if (n < 1 || batch < 1 || n_pieces < 1 || n_blocks < 1 ||
      n_blocks > (batch + BWD_THREADS - 1) / BWD_THREADS)
    return (int)cudaErrorInvalidValue;
  const Consts c{time_scale, growth, a_lin, dt, sigma, drift};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (hidden * 2 + (head_tf32 != 0)) {
#define ROLLOUT_BWD_CASE(H, TF)                                              \
  case H * 2 + TF:                                                           \
    return (int)launch_bwd<H, TF>(dw, jr, cc, pc, zc, lo, hi, w1, b1, w2,    \
                                  b2, w3, xs, ys, cxn, cyn, part, out, n,    \
                                  batch, n_pieces, n_blocks, c, st);
    ROLLOUT_BWD_CASE(8, false)
    ROLLOUT_BWD_CASE(8, true)
    ROLLOUT_BWD_CASE(21, false)
    ROLLOUT_BWD_CASE(21, true)
#undef ROLLOUT_BWD_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The kernel's dynamic shared memory per block and its resident blocks per
// SM at ``hidden`` and ``n_pieces`` (chip_smoke.py reports them), of the
// FP32 instance and of the head-TF32 one.
extern "C" int rollout_bwd_info(int hidden, int n_pieces, int* smem,
                                int* blocks_per_sm) {
  return rollout::info_bwd_at<false>(hidden, n_pieces, smem, blocks_per_sm);
}

extern "C" int rollout_bwd_tf32_info(int hidden, int n_pieces, int* smem,
                                     int* blocks_per_sm) {
  return rollout::info_bwd_at<true>(hidden, n_pieces, smem, blocks_per_sm);
}
