// What the wide compensator-sweep kernels share: B3 (sweep_wide_fwd.cu) and
// B4 (sweep_wide_bwd.cu) at every hidden width H in 1..128 other than the 8
// and 21 of the specialised kernels (sweep_fwd.cu, sweep_bwd.cu).  Their H×H
// products run on the tensor cores in split TF32 (tc_split.cuh: the width
// classes, the m16 tiling and fragment layout, the split, the mma and the
// f32 weight layout, shared with the wide rollout kernels).
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
// In the A layout of tc_split.cuh, h1 is the A operand of h1·W1, and in B4
// dz2 leaves h1·W1's accumulator in the layout in which it enters dz2·W1ᵀ
// as the A operand, and dz1 = (dz2·W1ᵀ)·(1 − h1²) meets h1 unit for unit.
//
// f32 throughout outside the products, with the accurate tanhf and no
// fast-math flags.
#pragma once

#include "sweep_common.cuh"
#include "tc_split.cuh"

namespace sweep_wide {

using sweep::kahan_add;
using tc::Mma;
using tc::THREADS;
using tc::WARP;
using tc::WARPS;
using tc::mma_split;
using tc::reduce_rows;
using tc::split_tf32;
using tc::sum_lanes_t;
using tc::w_at;
using tc::width_class;

constexpr int NODE_CHUNK = 16;  // node rows staged in shared memory at a time

}  // namespace sweep_wide
