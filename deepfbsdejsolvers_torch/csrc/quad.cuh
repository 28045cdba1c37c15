// Reading a shared-memory row padded to a multiple of 4 floats as float4s,
// shared by the rollout (rollout_common.cuh) and sweep (sweep_common.cuh)
// kernels.
#pragma once

#include <cuda_runtime.h>

// Floats 4q .. 4q + 3 of a shared-memory row, as one 16-byte load.
__device__ __forceinline__ float4 quad(const float* row, int q) {
  return reinterpret_cast<const float4*>(row)[q];
}

__device__ __forceinline__ float lane_of(const float4& t, int j) {
  return j == 0 ? t.x : j == 1 ? t.y : j == 2 ? t.z : t.w;
}
