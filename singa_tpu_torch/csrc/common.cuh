// Shared helpers of the hand-written Hopper kernels (plain C interface,
// float32, launched on the caller's stream).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace singa {

__device__ __forceinline__ float sigmoidf_(float v) { return 1.f / (1.f + expf(-v)); }

__device__ __forceinline__ float siluf_(float v) { return v / (1.f + expf(-v)); }

// softplus(v) - log(2), in the overflow-free form max(v, 0) + log1p(exp(-|v|))
__device__ __forceinline__ float sspf_(float v) {
  return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v))) - 0.69314718055994530942f;
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
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace singa
