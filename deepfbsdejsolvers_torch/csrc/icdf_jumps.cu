// The Merton model's compound-Poisson jump sum by the inverse CDF
// (ops/noise.py, models/merton.py ``sample_jumps`` with jump_sampler="icdf"):
// for uniform draws u and normal draws z of any shape,
//
//   dN = #{k : u > cdf[k]},   J = dN·μJ + σJ·sqrt(dN)·z.
//
// Replaces no Pallas kernel: on the TPU the JAX package leaves this
// expression to XLA, which fuses it into one pass over u and z.  Eager
// PyTorch runs it as a chain of kernels over the whole array, with
// (…, K) bool and int64 transients in device memory, so it is added here.
//
// What bounds it on an H100: memory.  Per element it reads u and z and
// writes J, 12 bytes, against K compares and five float operations; at
// (50, 2^20) that is 629 MB, 0.19 ms at 3.35 TB/s.
//
// Design: one pass.  Each thread loads four u and four z as float4 and
// stores four J as a float4, in a grid-stride loop; the last n mod 4
// elements, or every element where a pointer is not 16-byte aligned, take
// the scalar form.  The CDF travels by value in the kernel's arguments,
// padded with +inf to a compile-time length, so the fully unrolled count
// compares against constants and keeps no table in memory; the count runs
// over the whole table with no early exit, as the eager broadcast compare
// does, so trailing equal float32 entries count alike.  J is formed in
// eager's order and rounding, each product and the sum rounded apart
// (__fmul_rn, __fsqrt_rn, __fadd_rn keep nvcc from contracting to an FMA),
// so it is bit for bit the plain version's.  Indices are 64-bit.
//
// Table lengths: instances for 8, 32, 128 and 512 entries.  Every
// configuration in the repo has λ·dt = 0.06, a 6-entry table, so runs the
// first; the others are held to the plain version on the card at one step
// of a year with λ = 3, 60 and 300 (19, 113 and 411 entries).  Above 512
// entries, λ·dt above about 387, the wrapper raises where the eager chain
// took any length.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace icdf {

constexpr int THREADS = 256;
constexpr long long MAX_BLOCKS = 4096;

template <int K>
struct Table {
  float cdf[K];  // ascending; entries past the model's table are +inf
};

template <int K>
__device__ __forceinline__ float jump(float u, float z, const Table<K>& t,
                                      float mu, float sig) {
  int dn = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) dn += u > t.cdf[k] ? 1 : 0;
  const float d = (float)dn;
  return __fadd_rn(__fmul_rn(d, mu),
                   __fmul_rn(__fmul_rn(sig, __fsqrt_rn(d)), z));
}

template <int K, bool VEC>
__global__ void __launch_bounds__(THREADS)
jumps_kernel(const float* __restrict__ u, const float* __restrict__ z,
             float* __restrict__ j, long long n, const Table<K> t, float mu,
             float sig) {
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long stride = (long long)gridDim.x * THREADS;
  long long head = 0;  // elements done as float4
  if (VEC) {
    const long long n4 = n >> 2;
    const float4* u4 = reinterpret_cast<const float4*>(u);
    const float4* z4 = reinterpret_cast<const float4*>(z);
    float4* j4 = reinterpret_cast<float4*>(j);
    for (long long i = tid; i < n4; i += stride) {
      const float4 a = u4[i];
      const float4 b = z4[i];
      float4 r;
      r.x = jump(a.x, b.x, t, mu, sig);
      r.y = jump(a.y, b.y, t, mu, sig);
      r.z = jump(a.z, b.z, t, mu, sig);
      r.w = jump(a.w, b.w, t, mu, sig);
      j4[i] = r;
    }
    head = n4 << 2;
  }
  for (long long i = head + tid; i < n; i += stride)
    j[i] = jump(u[i], z[i], t, mu, sig);
}

template <int K>
cudaError_t launch(const float* u, const float* z, const float* cdf, int k,
                   float* j, long long n, float mu, float sig,
                   cudaStream_t st) {
  Table<K> t;
  for (int i = 0; i < K; ++i) t.cdf[i] = i < k ? cdf[i] : INFINITY;
  const bool vec = ((uintptr_t)u | (uintptr_t)z | (uintptr_t)j) % 16 == 0;
  const long long work = vec ? (n + 3) >> 2 : n;  // threads with work
  long long blocks = (work + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  if (vec)
    jumps_kernel<K, true><<<(unsigned)blocks, THREADS, 0, st>>>(
        u, z, j, n, t, mu, sig);
  else
    jumps_kernel<K, false><<<(unsigned)blocks, THREADS, 0, st>>>(
        u, z, j, n, t, mu, sig);
  return cudaGetLastError();
}

}  // namespace icdf

// J (n,) from u, z (n,) on the device and the model's CDF table cdf[0..k),
// a host array of k floats (1 <= k <= 512), copied into the launch's
// arguments; mu and sig are μJ and σJ as float32.  n = 0 launches nothing.
// Returns the launch's CUDA error code.
extern "C" int icdf_jumps(const float* u, const float* z, const float* cdf,
                          float* j, long long n, int k, float mu, float sig,
                          void* stream) {
  using namespace icdf;
  if (n < 0 || k < 1 || cdf == nullptr) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (k <= 8) return (int)launch<8>(u, z, cdf, k, j, n, mu, sig, st);
  if (k <= 32) return (int)launch<32>(u, z, cdf, k, j, n, mu, sig, st);
  if (k <= 128) return (int)launch<128>(u, z, cdf, k, j, n, mu, sig, st);
  if (k <= 512) return (int)launch<512>(u, z, cdf, k, j, n, mu, sig, st);
  return (int)cudaErrorInvalidValue;
}
