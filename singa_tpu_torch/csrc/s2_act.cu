// K3: separable S2 SiLU, forward; K3b: its backward.
//
// K3 replaces: singa_tpu/ops/pallas/s2_act.py::s2_silu_sep (_sep_fwd_kernel).
//   out[e, i, c] = sum_g fg[g, i] * silu(sum_j tg[g, j] * x[e, j, c])  (i >= 1)
//   out[e, 0, c] = silu(s[e, c])
// x [E, I, C] (m-primary truncated edge features), s [E, C], tg/fg [G, I].
//
// What bounds it on the H100: at the main path's shapes (E = 7,936 edges at
// 8 pockets, I = 29, C = 128, G = 70) it moves x in and out once
// (~236 MB, ~70 us at 3.35 TB/s) and does ~8.2 GFLOP of float32 FMA work
// (~120 us at the 67 TFLOP/s float32 rate of the CUDA cores), so the
// float32 arithmetic bounds it, not memory.
//
// Design: the TPU kernel's reason to exist is that the [E, G, C] grid tensor
// never reaches device memory; here it lives one grid point at a time in a
// register. One thread owns one (edge, channel) column: it loads the I
// coefficients of x into registers (neighbouring threads read neighbouring
// channels, so loads coalesce), then for each grid point forms the grid
// value, applies SiLU and accumulates into I output registers. tg and fg sit
// in shared memory with their rows zero-padded to kMaxI = 32 floats
// (2 x 70 x 32 floats = 18 KB), so every read of them is a warp-wide
// broadcast of 16 bytes that feeds four multiply-adds. A grid-stride loop
// over (edge, 128-channel block) with one resident wave of blocks loads the
// matrices once per block.
#include "common.cuh"

namespace {

constexpr int kMaxI = 32;
constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
s2_silu_sep_kernel(const float* __restrict__ x, const float* __restrict__ s,
                   const float* __restrict__ tg, const float* __restrict__ fg,
                   float* __restrict__ out, int E, int I, int C, int G) {
  extern __shared__ __align__(16) float smem[];
  float* stg = smem;              // [G, kMaxI], rows zero-padded past I
  float* sfg = smem + G * kMaxI;  // [G, kMaxI]
  for (int t = threadIdx.x; t < G * kMaxI; t += blockDim.x) {
    const int g = t / kMaxI, j = t % kMaxI;
    stg[t] = j < I ? tg[g * I + j] : 0.f;
    sfg[t] = j < I ? fg[g * I + j] : 0.f;
  }
  __syncthreads();

  const int cblocks = (C + kThreads - 1) / kThreads;
  const long long jobs = (long long)E * cblocks;
  for (long long job = blockIdx.x; job < jobs; job += gridDim.x) {
    const long long e = job / cblocks;
    const int c = (int)(job % cblocks) * kThreads + threadIdx.x;
    if (c >= C) continue;
    const float* xe = x + e * I * C + c;
    float xv[kMaxI], acc[kMaxI];
#pragma unroll
    for (int j = 0; j < kMaxI; ++j) {
      xv[j] = (j < I) ? xe[(long long)j * C] : 0.f;
      acc[j] = 0.f;
    }
    for (int g = 0; g < G; ++g) {
      const float4* tr = reinterpret_cast<const float4*>(stg + g * kMaxI);
      const float4* fr = reinterpret_cast<const float4*>(sfg + g * kMaxI);
      float v = 0.f;
#pragma unroll
      for (int j4 = 0; j4 < kMaxI / 4; ++j4) {
        const float4 w = tr[j4];
        v = fmaf(w.x, xv[4 * j4], v);
        v = fmaf(w.y, xv[4 * j4 + 1], v);
        v = fmaf(w.z, xv[4 * j4 + 2], v);
        v = fmaf(w.w, xv[4 * j4 + 3], v);
      }
      const float a = singa::siluf_(v);
#pragma unroll
      for (int j4 = 0; j4 < kMaxI / 4; ++j4) {
        const float4 w = fr[j4];
        acc[4 * j4] = fmaf(w.x, a, acc[4 * j4]);
        acc[4 * j4 + 1] = fmaf(w.y, a, acc[4 * j4 + 1]);
        acc[4 * j4 + 2] = fmaf(w.z, a, acc[4 * j4 + 2]);
        acc[4 * j4 + 3] = fmaf(w.w, a, acc[4 * j4 + 3]);
      }
    }
    float* oe = out + e * I * C + c;
    oe[0] = singa::siluf_(s[e * C + c]);
#pragma unroll
    for (int j = 1; j < kMaxI; ++j)
      if (j < I) oe[(long long)j * C] = acc[j];
  }
}


// K3b: the backward of K3.
//
// Replaces: singa_tpu/ops/pallas/s2_act.py::_sep_bwd (_sep_bwd_kernel).
//   ds[e, c]    = silu'(s[e, c]) * g[e, 0, c]
//   dx[e, j, c] = sum_g tg[g, j] * silu'(v_g) * sum_{i>=1} fg[g, i] * g[e, i, c]
//   with v_g = sum_j tg[g, j] * x[e, j, c]; row 0 of the cotangent reaches
//   only ds (it belongs to the scalar gate, not the S2 branch).
//
// What bounds it on the H100: at the training path's shapes (E = 31,744
// stage-1 edges per microbatch of 32, I = 29, C = 128, G = 70) it reads x and
// g and writes dx once (3 x 0.47 GB, ~0.42 ms at 3.35 TB/s) and does three
// contractions of 2*G*I operations per column (~49 GFLOP, ~0.74 ms at the
// 67 TFLOP/s float32 rate), so float32 arithmetic bounds it.
//
// Design: the forward's column design. The [E, G, C] grid and its cotangent
// never reach device memory: one thread owns one (edge, channel) column, keeps
// the I coefficients of x, of g and of the dx sums in registers, and walks the
// G grid points, recomputing the grid value (the forward it must redo) and
// the lifted cotangent one point at a time. tg and fg sit in shared memory
// with rows zero-padded to kMaxI floats, so every read is a 16-byte
// broadcast. No reduction crosses threads, so the result is deterministic.
__global__ void __launch_bounds__(kThreads)
s2_silu_sep_bwd_kernel(const float* __restrict__ x, const float* __restrict__ s,
                       const float* __restrict__ gin, const float* __restrict__ tg,
                       const float* __restrict__ fg, float* __restrict__ dx,
                       float* __restrict__ ds, int E, int I, int C, int G) {
  extern __shared__ __align__(16) float smem[];
  float* stg = smem;              // [G, kMaxI], rows zero-padded past I
  float* sfg = smem + G * kMaxI;  // [G, kMaxI], column 0 zeroed too
  for (int t = threadIdx.x; t < G * kMaxI; t += blockDim.x) {
    const int g = t / kMaxI, j = t % kMaxI;
    stg[t] = j < I ? tg[g * I + j] : 0.f;
    sfg[t] = (j < I && j > 0) ? fg[g * I + j] : 0.f;
  }
  __syncthreads();

  const int cblocks = (C + kThreads - 1) / kThreads;
  const long long jobs = (long long)E * cblocks;
  for (long long job = blockIdx.x; job < jobs; job += gridDim.x) {
    const long long e = job / cblocks;
    const int c = (int)(job % cblocks) * kThreads + threadIdx.x;
    if (c >= C) continue;
    const float* xe = x + e * I * C + c;
    const float* ge = gin + e * I * C + c;
    float xv[kMaxI], gv[kMaxI], acc[kMaxI];
#pragma unroll
    for (int j = 0; j < kMaxI; ++j) {
      xv[j] = (j < I) ? xe[(long long)j * C] : 0.f;
      gv[j] = (j < I) ? ge[(long long)j * C] : 0.f;
      acc[j] = 0.f;
    }
    for (int g = 0; g < G; ++g) {
      const float4* tr = reinterpret_cast<const float4*>(stg + g * kMaxI);
      const float4* fr = reinterpret_cast<const float4*>(sfg + g * kMaxI);
      float v = 0.f, u = 0.f;
#pragma unroll
      for (int j4 = 0; j4 < kMaxI / 4; ++j4) {
        const float4 w = tr[j4];
        const float4 f = fr[j4];
        v = fmaf(w.x, xv[4 * j4], v);
        v = fmaf(w.y, xv[4 * j4 + 1], v);
        v = fmaf(w.z, xv[4 * j4 + 2], v);
        v = fmaf(w.w, xv[4 * j4 + 3], v);
        u = fmaf(f.x, gv[4 * j4], u);
        u = fmaf(f.y, gv[4 * j4 + 1], u);
        u = fmaf(f.z, gv[4 * j4 + 2], u);
        u = fmaf(f.w, gv[4 * j4 + 3], u);
      }
      const float h = singa::silu_gradf_(v) * u;
#pragma unroll
      for (int j4 = 0; j4 < kMaxI / 4; ++j4) {
        const float4 w = tr[j4];
        acc[4 * j4] = fmaf(w.x, h, acc[4 * j4]);
        acc[4 * j4 + 1] = fmaf(w.y, h, acc[4 * j4 + 1]);
        acc[4 * j4 + 2] = fmaf(w.z, h, acc[4 * j4 + 2]);
        acc[4 * j4 + 3] = fmaf(w.w, h, acc[4 * j4 + 3]);
      }
    }
    ds[e * C + c] = singa::silu_gradf_(s[e * C + c]) * gv[0];
    float* de = dx + e * I * C + c;
#pragma unroll
    for (int j = 0; j < kMaxI; ++j)
      if (j < I) de[(long long)j * C] = acc[j];
  }
}

}  // namespace

extern "C" int s2_silu_sep_f32(const float* x, const float* s, const float* tg,
                               const float* fg, float* out, int E, int I, int C,
                               int G, void* stream) {
  if (I > kMaxI || I < 1 || E < 1 || C < 1 || G < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)G * kMaxI * sizeof(float);
  cudaError_t err = singa::allow_smem(s2_silu_sep_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const long long jobs = (long long)E * ((C + kThreads - 1) / kThreads);
  const int grid = singa::persistent_grid(s2_silu_sep_kernel, kThreads, smem, jobs);
  s2_silu_sep_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(x, s, tg, fg, out, E,
                                                                     I, C, G);
  return (int)cudaGetLastError();
}

extern "C" int s2_silu_sep_bwd_f32(const float* x, const float* s, const float* g,
                                   const float* tg, const float* fg, float* dx, float* ds,
                                   int E, int I, int C, int G, void* stream) {
  if (I > kMaxI || I < 1 || E < 1 || C < 1 || G < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)G * kMaxI * sizeof(float);
  cudaError_t err = singa::allow_smem(s2_silu_sep_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const long long jobs = (long long)E * ((C + kThreads - 1) / kThreads);
  const int grid = singa::persistent_grid(s2_silu_sep_bwd_kernel, kThreads, smem, jobs);
  s2_silu_sep_bwd_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(x, s, g, tg, fg, dx,
                                                                         ds, E, I, C, G);
  return (int)cudaGetLastError();
}
