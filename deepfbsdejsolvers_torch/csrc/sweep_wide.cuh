// What the wide compensator-sweep kernels share: B3 (sweep_wide_fwd.cu) and
// B4 (sweep_wide_bwd.cu) at every hidden width H in 1..128 other than the 8
// and 21 of the specialised kernels (sweep_fwd.cu, sweep_bwd.cu).  The wide
// rollout kernels (rollout_wide.cuh) share the warp constants, the width
// classes and ``Wide``/``load_weights``, the layout of their head's weights.
//
// The sweep (ops/sweep.py) is, per path b,
//   out_b = Σ_m Σ_k v[m,k]·tanh(Σ_h tanh(x_b·a[m,h] + c[m,h])·W1[h,k] + b1[k])
// with a, c, v (M, H) row-major per node and W1 (H, H) row-major (in, out).
//
// Padding.  Each kernel is built for a width class HP ∈ {32, 64, 128} and
// takes any H <= HP: W1, b1 and the node rows are staged in shared memory
// with zeros past H.  That is exact: a padded first-layer unit is tanh(0) = 0
// and feeds W1's zero rows, a padded second-layer unit is tanh(0) = 0 and is
// weighted by a zero v; the padded cotangents are computed and not written.
//
// The H×H products run on the tensor cores in split TF32 ("3xTF32"): each
// f32 operand is split into hi = tf32(a) and lo = a − hi (``split_tf32``),
// and a·b is formed as hi·hi + hi·lo + lo·hi with mma.sync m16n8k8 (f32
// accumulation), which keeps ~21 bits of each operand (one TF32 pass keeps
// 11, ~1e-3).  The hi·hi terms and the two cross terms go to separate
// accumulators where registers allow, so that the accumulator's rounding
// (the tensor cores' f32 sums need not round to nearest) runs over HP / 8
// steps, not 3·HP / 8.
//
// Fragments (PTX ISA, m16n8k8 .tf32; lane = 4g + t): A (16 × 8) a0 (g, t),
// a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B (8 × 8) b0 (t, g), b1
// (t + 4, g); C (16 × 8) c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3
// (g + 8, 2t + 1).  A warp carries 16 paths, the rows of its m16 tiles: lane
// (g, t) holds paths g and g + 8.  The contraction index of each 8-wide step
// is permuted, A column t ↔ unit 2t and A column t + 4 ↔ unit 2t + 1, so the
// lane's hidden values sit at units 8k + 2t, 8k + 2t + 1 of every 8-unit
// block k in both the A and the C layout: h1, computed there, is the A
// operand of h1·W1, and in B4 dz2 leaves h1·W1's accumulator in the layout
// in which it enters dz2·W1ᵀ as the A operand, and dz1 = (dz2·W1ᵀ)·(1 − h1²)
// meets h1 unit for unit.  W1's rows (in h1·W1) and W1ᵀ's rows (in dz2·W1ᵀ)
// are permuted to match in shared memory.
//
// f32 throughout outside the products, with the accurate tanhf and no
// fast-math flags.
#pragma once

#include "sweep_common.cuh"

namespace sweep_wide {

using sweep::kahan_add;

constexpr int WARP = 32;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * WARP;
constexpr int NODE_CHUNK = 16;  // node rows staged in shared memory at a time
constexpr unsigned FULL = 0xffffffffu;

// The wide rollout's layout of its head's second layer (rollout_wide.cuh):
// the hidden units spread over a warp's lanes, lane l owning the U = HP / 32
// units k = l + 32u, P = 16 / U paths a warp; W in shared memory with a row
// stride of HP + 1 floats, so that lane l reading row h at column l + 32u
// and row l + 32u at column k are both free of bank conflicts; then b.
template <int HP>
struct Wide {
  static_assert(HP == 32 || HP == 64 || HP == 128, "width class");
  static constexpr int U = HP / WARP;      // units per lane
  static constexpr int P = 16 / U;         // paths per warp
  static constexpr int TILE = WARPS * P;   // paths per block
  static constexpr int LDW = HP + 1;
  static constexpr int W1 = 0;
  static constexpr int B1 = (HP * LDW + 3) / 4 * 4;
};

// W and b of width h into shared memory in ``Wide``'s layout, zero past h.
template <int HP>
__device__ __forceinline__ void load_weights(float* sm,
                                             const float* __restrict__ w1,
                                             const float* __restrict__ b1,
                                             int h) {
  using L = Wide<HP>;
  for (int q = threadIdx.x; q < HP * HP; q += blockDim.x) {
    const int row = q / HP, col = q % HP;
    sm[L::W1 + row * L::LDW + col] =
        (row < h && col < h) ? __ldg(w1 + row * h + col) : 0.0f;
  }
  for (int q = threadIdx.x; q < HP; q += blockDim.x)
    sm[L::B1 + q] = q < h ? __ldg(b1 + q) : 0.0f;
}

// The width class of hidden width h: the least of 32, 64, 128 that holds it,
// or 0 when none does.
inline int width_class(int h) {
  return h < 1 ? 0 : h <= 32 ? 32 : h <= 64 ? 64 : h <= 128 ? 128 : 0;
}

// The sweep's tiling at width class HP: a warp carries one m16 tile of
// paths, a block of B4 eight warps; NB 8-unit blocks of the hidden layers (the
// k-steps and n-tiles of the products), taken NG n-tiles an accumulator
// group; staged rows of LDS floats (LDS ≡ 8 mod 32, so that the rows g and
// the columns 2t of a warp's float2 accesses, and the rows t and columns g
// of its fragment reads, fall in distinct banks).
template <int HP>
struct Mma {
  static_assert(HP == 32 || HP == 64 || HP == 128, "width class");
  static constexpr int ROWS = 16;              // paths per warp
  static constexpr int TILE = WARPS * ROWS;    // paths per block
  static constexpr int NB = HP / 8;
  static constexpr int NG = 4;
  static_assert(NB % NG == 0, "whole accumulator groups");
  static constexpr int LDS = (HP + 23) / 32 * 32 + 8;
};

// x ≈ hi + lo for the tensor cores: hi = x rounded to TF32 (10 mantissa
// bits, to nearest, ties away from zero: what cvt.rna.tf32.f32 gives, here
// in two integer operations on finite x), lo = x − hi (exact).  The tensor
// cores read the TF32 bits of an operand register and ignore the 13 below,
// so lo enters its products truncated to TF32: hi + lo keeps ~21 bits of x
// (one TF32 operand keeps 11), at three instructions a split.
__device__ __forceinline__ void split_tf32(float x, float& hi, float& lo) {
  hi = __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
  lo = x - hi;
}

// d += a·b on the tensor cores: one m16n8k8 product in TF32, f32 sums.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const float (&a)[4],
                                         const float (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])),
        "r"(__float_as_uint(a[2])), "r"(__float_as_uint(a[3])),
        "r"(__float_as_uint(b[0])), "r"(__float_as_uint(b[1])));
}

// The split product a·b: big += a_hi·b_hi, small += a_hi·b_lo + a_lo·b_hi
// (big and small may be one accumulator).
__device__ __forceinline__ void mma_split(float (&big)[4], float (&small)[4],
                                          const float (&ah)[4],
                                          const float (&al)[4],
                                          const float (&bh)[2],
                                          const float (&bl)[2]) {
  mma_tf32(small, al, bh);
  mma_tf32(small, ah, bl);
  mma_tf32(big, ah, bh);
}

// Offset in floats of W1[r][c] in the f32 layout of B4: 8 × 8 blocks of 64
// floats, row-block major; within a block column-major, the two 32-float
// halves' 8-float groups swapped in the second (o ^ 8 when o >= 32), so that
// h1·W1's fragments (rows 2t, 2t + 1 at column g: one float2) and dz2·W1ᵀ's
// (row g at columns 2t and 2t + 1: two floats) are both read free of bank
// conflicts.
template <int HP>
__device__ __forceinline__ int w1_at(int r, int c) {
  const int o = 8 * (c & 7) + (r & 7);
  return ((r >> 3) * (HP / 8) + (c >> 3)) * 64 + (o ^ (((o >> 5) & 1) << 3));
}

// One halving stage of ``reduce_rows``: the lanes at distance ``off`` pair
// up, each keeping the half of the N live values that its bit of ``off``
// selects and adding its partner's copy of that half.
template <int V, int N>
__device__ __forceinline__ void halve(float (&v)[V], int lane, int off) {
  const bool up = (lane & off) != 0;
#pragma unroll
  for (int j = 0; j < N / 2; ++j) {
    const float send = up ? v[j] : v[j + N / 2];
    const float keep = up ? v[j + N / 2] : v[j];
    v[j] = keep + __shfl_xor_sync(FULL, send, off);
  }
}

// The sums over a warp's 16 paths of V per-lane values (each lane's already
// summed over its two paths): a reduce-scatter over the eight lanes of a t
// (lane bits 2-4), after which v[0 .. V/8) of lane (g, t) hold the sums of
// entries g·V/8 .. (g + 1)·V/8 − 1.  A fixed tree, the same on every call.
template <int V>
__device__ __forceinline__ void reduce_rows(float (&v)[V], int lane) {
  static_assert(V % 8 == 0, "eight lanes");
  halve<V, V>(v, lane, 16);
  halve<V, V / 2>(v, lane, 8);
  halve<V, V / 4>(v, lane, 4);
}

// The sum of v over the four lanes of a g (lane bits 0-1), the same fixed
// butterfly on every call; every one of the four gets the same bits.
__device__ __forceinline__ float sum_lanes_t(float v) {
  v += __shfl_xor_sync(FULL, v, 1);
  return v + __shfl_xor_sync(FULL, v, 2);
}

}  // namespace sweep_wide
