// K3: separable S2 SiLU, forward; K3b: its backward. K5 / K5b: the S2 SiLU
// on all rows and its backward (at the end of the file).
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
#include "s2_grid.cuh"

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


// K5: S2 SiLU on all rows; K5b: its backward.
//
// K5 replaces: singa_tpu/ops/pallas/s2_act.py::s2_silu (s2_silu_pallas,
// _fwd_kernel); K5b: _bwd (_bwd_kernel).
//   out[n, :, c] = fg^T silu(tg x[n, :, c])
//   dx[n, :, c]  = tg^T (silu'(tg x[n, :, c]) * fg g[n, :, c])
// x, g [N, I <= 64, C]; tg/fg [G, I]. Unlike K3/K3b no row is special.
//
// What bounds it on the H100: per (node, channel) column two (K5) or three
// (K5b) contractions of 2*G*I operations against 8 (12) bytes of x (and g)
// in and out per coefficient: at the s2 FFN's hidden (I = 49, G = 210)
// ~20 operations per byte, float32 arithmetic bounds it; at the attention's
// message (I = 29, G = 70) too.
//
// Design: K3's register columns do not stretch to 49 coefficients (x, the
// accumulators and, in K5b, g would exceed the register file), so K5 runs
// K4's grid chain (csrc/s2_grid.cuh) on tiles of 128 columns of the flat
// (node, channel) column space: the tile's [I, 128] slice of x (and g) in
// shared memory, the grid formed 32 points at a time, the result in
// registers. tg and fg are staged once per block; the grid is persistent.
constexpr int kSiluCols = 128;  // columns per tile
constexpr int kSiluPad = 4;     // floats added to each row of the tile

template <bool BWD>
__global__ void __launch_bounds__(singa::kChainThreads, 1)
s2_silu_kernel(const float* __restrict__ x, const float* __restrict__ gin,
               const float* __restrict__ tg, const float* __restrict__ fg,
               float* __restrict__ out, int N, int I, int C, int G) {
  const int Ip = singa::pad_rows(I);
  const int xs = kSiluCols + kSiluPad;
  extern __shared__ __align__(16) float smem[];
  const size_t gm = singa::grid_mats_floats(G, I) / 2;
  float* stg = smem;                    // [Gp][Ip]
  float* sfg = stg + gm;                // [Gp][Ip]
  float* sx = sfg + gm;                 // [Ip][kSiluCols] (+pad): x, then the result
  float* sg = sx + Ip * xs;             // [Ip][kSiluCols] (+pad): g (K5b)
  float* sact = sg + (BWD ? Ip * xs : 0);  // [kGC][kSiluCols]
  singa::stage_grid_mats(tg, fg, G, I, stg, sfg);
  for (int t = threadIdx.x; t < (Ip - I) * xs; t += blockDim.x) {  // padded rows
    sx[I * xs + t] = 0.f;
    if (BWD) sg[I * xs + t] = 0.f;
  }

  const long long Q = (long long)N * C;  // columns (node, channel)
  const long long tiles = (Q + kSiluCols - 1) / kSiluCols;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long q0 = tile * kSiluCols;
    __syncthreads();  // the previous tile's result is stored
    for (int t = threadIdx.x; t < I * kSiluCols; t += blockDim.x) {
      const int j = t / kSiluCols, col = t % kSiluCols;
      const long long q = q0 + col;
      const long long at = (q / C) * I * C + (long long)j * C + q % C;
      sx[j * xs + col] = q < Q ? x[at] : 0.f;
      if (BWD) sg[j * xs + col] = q < Q ? gin[at] : 0.f;
    }
    __syncthreads();
    if (BWD)
      singa::grid_chain<kSiluCols, true, false, true>(stg, sfg, G, I, sx, sg, xs, nullptr, sact,
                                                      nullptr, sx, xs, nullptr);
    else
      singa::grid_chain<kSiluCols, false, true, false>(stg, sfg, G, I, sx, nullptr, xs, sact,
                                                       nullptr, sx, nullptr, xs, nullptr);
    __syncthreads();
    for (int t = threadIdx.x; t < I * kSiluCols; t += blockDim.x) {
      const int j = t / kSiluCols, col = t % kSiluCols;
      const long long q = q0 + col;
      if (q < Q) out[(q / C) * I * C + (long long)j * C + q % C] = sx[j * xs + col];
    }
  }
}

template <bool BWD>
int s2_silu_launch(const float* x, const float* g, const float* tg, const float* fg, float* out,
                   int N, int I, int C, int G, void* stream) {
  if (N < 1 || C < 1 || G < 1 || !singa::chain_fits(kSiluCols, 1, I))
    return (int)cudaErrorInvalidValue;
  const int Ip = singa::pad_rows(I);
  const size_t floats = singa::grid_mats_floats(G, I) + (BWD ? 2 : 1) * (size_t)Ip *
                        (kSiluCols + kSiluPad) + (size_t)singa::kGC * kSiluCols;
  const size_t smem = floats * sizeof(float);
  cudaError_t err = singa::allow_smem(s2_silu_kernel<BWD>, smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = ((long long)N * C + kSiluCols - 1) / kSiluCols;
  const int grid = singa::persistent_grid(s2_silu_kernel<BWD>, singa::kChainThreads, smem, tiles);
  s2_silu_kernel<BWD><<<grid, singa::kChainThreads, smem, (cudaStream_t)stream>>>(
      x, g, tg, fg, out, N, I, C, G);
  return (int)cudaGetLastError();
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

// K5 and K5b. Return cudaErrorInvalidValue for more than 64 coefficient rows.
extern "C" int s2_silu_f32(const float* x, const float* tg, const float* fg, float* out, int N,
                           int I, int C, int G, void* stream) {
  return s2_silu_launch<false>(x, nullptr, tg, fg, out, N, I, C, G, stream);
}

extern "C" int s2_silu_bwd_f32(const float* x, const float* g, const float* tg, const float* fg,
                               float* dx, int N, int I, int C, int G, void* stream) {
  return s2_silu_launch<true>(x, g, tg, fg, dx, N, I, C, G, stream);
}
