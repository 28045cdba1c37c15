// What the wide kernels share for their H×H products on the tensor cores in
// split TF32: the compensator sweep's B3 and B4 (sweep_wide.cuh) and the
// fused rollout's B1 and B2 (rollout_wide.cuh), at every hidden width H in
// 1..128 other than the 8 and 21 of their specialised kernels.
//
// Width classes.  Each wide kernel is built for a width class HP ∈ {32, 64,
// 128} and takes any H <= HP, its weights zero past H.
//
// Split TF32 ("3xTF32").  Each f32 operand is split into hi = tf32(a) and
// lo = a − hi (``split_tf32``), and a·b is formed as hi·hi + hi·lo + lo·hi
// with mma.sync m16n8k8 (f32 accumulation), which keeps ~21 bits of each
// operand (one TF32 pass keeps 11, ~1e-3).  The hi·hi terms and the two
// cross terms go to separate accumulators where registers allow, so that the
// accumulator's rounding (the tensor cores' f32 sums need not round to
// nearest) runs over HP / 8 steps, not 3·HP / 8.
//
// Fragments (PTX ISA, m16n8k8 .tf32; lane = 4g + t): A (16 × 8) a0 (g, t),
// a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B (8 × 8) b0 (t, g), b1
// (t + 4, g); C (16 × 8) c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3
// (g + 8, 2t + 1).  A warp carries 16 paths, the rows of its m16 tiles: lane
// (g, t) holds paths g and g + 8.  The contraction index of each 8-wide step
// is permuted, A column t ↔ unit 2t and A column t + 4 ↔ unit 2t + 1, so the
// lane's hidden values sit at units 8k + 2t, 8k + 2t + 1 of every 8-unit
// block k in both the A and the C layout: a first layer computed there is
// the A operand of the second layer's product, the second layer's
// cotangent leaves that product's accumulator in the layout in which it
// enters the product with the transposed weights as the A operand, and the
// first layer's cotangent meets the first layer unit for unit.  The
// weights' rows and their transpose's rows are permuted to match in shared
// memory (``w_at``).
#pragma once

#include <cuda_runtime.h>

namespace tc {

constexpr int WARP = 32;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * WARP;
constexpr unsigned FULL = 0xffffffffu;

// The width class of hidden width h: the least of 32, 64, 128 that holds it,
// or 0 when none does.
inline int width_class(int h) {
  return h < 1 ? 0 : h <= 32 ? 32 : h <= 64 ? 64 : h <= 128 ? 128 : 0;
}

// The tiling at width class HP: a warp carries one m16 tile of paths, a
// block of eight warps 128 paths; NB 8-unit blocks of the hidden layers (the
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

// Offset in floats of W[r][c] of an HP × HP matrix in the f32 layout that
// serves both its products: 8 × 8 blocks of 64 floats, row-block major;
// within a block column-major, the two 32-float halves' 8-float groups
// swapped in the second (o ^ 8 when o >= 32), so that the fragments of h·W
// (rows 2t, 2t + 1 at column g: one float2) and of d·Wᵀ (row g at columns
// 2t and 2t + 1: two floats) are both read free of bank conflicts.
template <int HP>
__device__ __forceinline__ int w_at(int r, int c) {
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

}  // namespace tc
