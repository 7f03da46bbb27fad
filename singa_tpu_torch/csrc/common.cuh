// Shared helpers of the hand-written Hopper kernels (plain C interface,
// float32, launched on the caller's stream; the bfloat16 instances of K1-K3
// read and write bfloat16 activations and compute in float32).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace singa {

using bf16 = __nv_bfloat16;

// Storage types: a value as float, and a float stored as T (bfloat16 by
// round-to-nearest-even, as torch's and JAX's casts round).
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <class T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

// v rounded to T's precision and back to float: where the TPU kernel calls
// .astype(dt) at a bfloat16 dt; the identity for T = float.
template <class T>
__device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

template <class T> constexpr bool kBf16 = std::is_same<T, bf16>::value;

// A read-only load through the texture path, as float.
__device__ __forceinline__ float ldg_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg_f(const bf16* p) { return __bfloat162float(__ldg(p)); }

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
