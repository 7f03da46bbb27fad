// Shared helpers of the hand-written Hopper kernels (plain C interface,
// float32, launched on the caller's stream).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace singa {

__device__ __forceinline__ float sigmoidf_(float v) { return 1.f / (1.f + expf(-v)); }

__device__ __forceinline__ float siluf_(float v) { return v / (1.f + expf(-v)); }

// d silu / dv = sigmoid(v) * (1 + v * (1 - sigmoid(v)))
__device__ __forceinline__ float silu_gradf_(float v) {
  const float s = sigmoidf_(v);
  return s * (1.f + v * (1.f - s));
}

// softplus(v) - log(2), in the overflow-free form max(v, 0) + log1p(exp(-|v|))
__device__ __forceinline__ float sspf_(float v) {
  return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v))) - 0.69314718055994530942f;
}

// Degree l of coefficient row i in the l-primary layout (rows l^2 .. l^2+2l).
__device__ __forceinline__ int degree_of(int i) {
  int l = (int)sqrtf((float)i + 0.5f);
  while (l * l > i) --l;
  while ((l + 1) * (l + 1) <= i) ++l;
  return l;
}

// a += s * w, lane by lane
__device__ __forceinline__ void fma4(float4& a, float s, const float4& w) {
  a.x = fmaf(s, w.x, a.x);
  a.y = fmaf(s, w.y, a.y);
  a.z = fmaf(s, w.z, a.z);
  a.w = fmaf(s, w.w, a.w);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// out[j] = sum over r, in order r = 0 .. rows-1, of partial[r][j]: the
// deterministic second pass of a cross-block reduction (each block of the
// first pass writes its own row of partial sums).
__global__ void sum_rows_kernel(const float* __restrict__ partial, float* __restrict__ out,
                                long long P, int rows) {
  for (long long j = blockIdx.x * (long long)blockDim.x + threadIdx.x; j < P;
       j += (long long)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int r = 0; r < rows; ++r) v += partial[r * P + j];
    out[j] = v;
  }
}

// Blocks to launch for a grid-stride loop over `jobs` work items: enough to
// fill every SM at the occupancy the kernel allows, never more than `jobs`.
template <typename Kernel>
inline int persistent_grid(Kernel kernel, int threads, size_t smem, long long jobs) {
  int dev = 0, sms = 1, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (per_sm < 1) per_sm = 1;
  long long g = (long long)sms * per_sm;
  if (g > jobs) g = jobs;
  if (g < 1) g = 1;
  return (int)g;
}

// Opt a kernel into more than the default 48 KB of dynamic shared memory.
// A size above the card's limit is refused (cudaErrorInvalidValue); the
// refusal is cleared from the runtime's last error, so the next launch's
// cudaGetLastError() does not report it.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

}  // namespace singa
