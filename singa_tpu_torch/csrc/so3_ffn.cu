// K4: S2-activation SO(3) feed-forward network, forward.
//
// Replaces: singa_tpu/ops/pallas/so3_ffn.py::so3_ffn_fused (_ffn_fwd_kernel).
//   gate[n, :]   = silu(x[n, 0, :] @ wg + bg)                    (C -> H)
//   h[n, i, :]   = x[n, i, :] @ w1[l(i)]  (+ b1 on row 0)         (C -> H)
//   mid[n, :, k] = fg^T silu(tg h[n, :, k])   per hidden channel k
//   mid[n, 0, :] = gate[n, :]
//   y[n, i, :]   = mid[n, i, :] @ w2[l(i)]  (+ b2 on row 0)       (H -> Co)
// x [N, I=(lmax+1)^2, C], w1 [L, C, H], wg [C, H], w2 [L, H, Co],
// tg/fg [G, I] (l-primary, G = 210 at lmax 6).
//
// What bounds it on the H100: per node the two grid transforms do 2*G*I*H
// operations each (10.5 MFLOP at I = 49, G = 210, H = 512) and the two
// per-degree products 0.8 MFLOP each: ~22.7 MFLOP per node against 2 KB of
// x and y. At a training microbatch (N = 14,336) that is ~325 GFLOP, ~4.9 ms
// at the 67 TFLOP/s float32 rate of the CUDA cores, against ~0.03 ms of
// memory: float32 arithmetic bounds it.
//
// Design: the TPU kernel exists so that neither the [N, I, H] hidden
// (1.44 GB here) nor the [N, G, H] grid (6.2 GB) reaches device memory; so
// here too. K2's structure (csrc/so3_gate_ffn.cu): a block owns a tile of
// kTN = 8 nodes and walks the hidden dimension in chunks of kHC = 16
// channels, with y in registers across the chunks. Per chunk it stages the
// chunk's weight slices, forms the gates and the [I, kHC x kTN] hidden slice
// in shared memory (register micro-tiles, as K2), runs the grid chain of
// csrc/s2_grid.cuh on the slice's 128 columns (the grid formed 32 points at
// a time, never whole), writes mid over the hidden slice with row 0 set to
// the gates, and adds mid's contribution to y. tg and fg (2 x 224 x 56
// floats, padded) are staged once per block: the grid is persistent, one
// block per SM (~190 KB of shared memory), each block walking node tiles.
#include "s2_grid.cuh"

namespace {

constexpr int kThreads = singa::kChainThreads;
constexpr int kNG = 2;             // groups of four nodes per tile
constexpr int kTN = 4 * kNG;       // nodes per tile
constexpr int kHC = 16;            // hidden channels per chunk
constexpr int kNCOL = kHC * kTN;   // grid-chain columns per chunk
constexpr int kPad = 8;            // floats added to each row block of sx and sh
constexpr int kMaxJobs = 2;        // output micro-tiles per thread

using singa::degree_of;
using singa::fma4;

struct Dims {
  int N, lmax, L, I, Ip, C, H, Co, G;
};

__host__ __device__ inline Dims make_dims(int N, int lmax, int C, int H, int Co, int G) {
  const int I = (lmax + 1) * (lmax + 1);
  return Dims{N, lmax, lmax + 1, I, singa::pad_rows(I), C, H, Co, G};
}

__host__ __device__ inline size_t smem_floats(const Dims& d) {
  return singa::grid_mats_floats(d.G, d.I) + (size_t)d.I * (d.C * kTN + kPad) +
         (size_t)d.Ip * (kNCOL + kPad) + (size_t)singa::kGC * kNCOL + (size_t)d.L * d.C * kHC +
         (size_t)d.C * kHC + (size_t)d.L * kHC * d.Co + kNCOL;
}

__global__ void __launch_bounds__(kThreads, 1)
ffn_kernel(const float* __restrict__ x, const float* __restrict__ w1,
           const float* __restrict__ b1, const float* __restrict__ wg,
           const float* __restrict__ bg, const float* __restrict__ w2,
           const float* __restrict__ b2, const float* __restrict__ tg,
           const float* __restrict__ fg, float* __restrict__ y, Dims d) {
  const int L = d.L, I = d.I, C = d.C, H = d.H, Co = d.Co;
  const int xs = C * kTN + kPad;  // row stride of sx
  const int hs = kNCOL + kPad;    // row stride of sh
  extern __shared__ __align__(16) float smem[];
  float* stg = smem;                                   // [Gp][Ip]
  float* sfg = stg + singa::grid_mats_floats(d.G, I) / 2;  // [Gp][Ip]
  float* sx = sfg + singa::grid_mats_floats(d.G, I) / 2;   // [I][C][kTN] (+pad per row)
  float* sh = sx + I * xs;                             // [Ip][kHC][kTN] (+pad): h, then mid
  float* sact = sh + d.Ip * hs;                        // [kGC][kNCOL]
  float* sw1 = sact + singa::kGC * kNCOL;              // [L, C, kHC]
  float* swg = sw1 + L * C * kHC;                      // [C, kHC]
  float* sw2 = swg + C * kHC;                          // [L, kHC, Co]
  float* sgate = sw2 + L * kHC * Co;                   // [kHC][kTN]

  const int tid = threadIdx.x;
  const int C4 = Co / 4;
  const int njobs = kNG * I * C4;
  singa::stage_grid_mats(tg, fg, d.G, I, stg, sfg);
  for (int t = tid; t < (d.Ip - I) * hs; t += kThreads) sh[I * hs + t] = 0.f;  // padded rows

  const int tiles = (d.N + kTN - 1) / kTN;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int n0 = tile * kTN;
    __syncthreads();  // the previous tile's readers of sx are done
    for (int t = tid; t < kTN * I * C; t += kThreads) {
      const int n = t / (I * C), i = (t / C) % I, c = t % C;
      sx[i * xs + c * kTN + n] = (n0 + n < d.N) ? x[(long long)n0 * I * C + t] : 0.f;
    }
    float4 acc[kMaxJobs][4];
#pragma unroll
    for (int k = 0; k < kMaxJobs; ++k)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[k][q] = make_float4(0.f, 0.f, 0.f, 0.f);

    for (int h0 = 0; h0 < H; h0 += kHC) {
      __syncthreads();  // the previous chunk's readers of the weights and of mid are done
      for (int t = tid; t < L * C * kHC; t += kThreads) {
        const int h = t % kHC, lc = t / kHC;
        sw1[t] = (h0 + h < H) ? w1[(long long)lc * H + h0 + h] : 0.f;
      }
      for (int t = tid; t < C * kHC; t += kThreads) {
        const int h = t % kHC, c = t / kHC;
        swg[t] = (h0 + h < H) ? wg[(long long)c * H + h0 + h] : 0.f;
      }
      for (int t = tid; t < L * kHC * Co; t += kThreads) {
        const int o = t % Co, h = (t / Co) % kHC, l = t / (Co * kHC);
        sw2[t] = (h0 + h < H) ? w2[((long long)l * H + h0 + h) * Co + o] : 0.f;
      }
      __syncthreads();

      // gates silu(x0 @ wg + bg), [kHC][kTN]: mid's row 0
      for (int t = tid; t < kNCOL; t += kThreads) {
        const int n = t % kTN, h = t / kTN;
        float v = (h0 + h < H) ? bg[h0 + h] : 0.f;
        for (int c = 0; c < C; ++c) v = fmaf(sx[c * kTN + n], swg[c * kHC + h], v);
        sgate[t] = singa::siluf_(v);
      }
      // hidden micro-tiles: four nodes x four hidden channels of one row
      for (int t = tid; t < kNG * I * (kHC / 4); t += kThreads) {
        const int h4 = t % (kHC / 4), ng = (t / (kHC / 4)) % kNG, i = t / (kHC / 4 * kNG);
        const int l = degree_of(i);
        const float* xr = sx + i * xs + 4 * ng;
        const float* wr = sw1 + l * C * kHC + 4 * h4;
        float4 a[4];  // a[r]: hidden channel 4*h4 + r of the four nodes
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int c = 0; c < C; ++c) {
          const float4 xv = *reinterpret_cast<const float4*>(xr + c * kTN);
          const float4 wv = *reinterpret_cast<const float4*>(wr + c * kHC);
          fma4(a[0], wv.x, xv);
          fma4(a[1], wv.y, xv);
          fma4(a[2], wv.z, xv);
          fma4(a[3], wv.w, xv);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int h = 4 * h4 + r;
          if (i == 0 && h0 + h < H) {
            const float bb = b1[h0 + h];
            a[r].x += bb;
            a[r].y += bb;
            a[r].z += bb;
            a[r].w += bb;
          }
          *reinterpret_cast<float4*>(sh + i * hs + h * kTN + 4 * ng) = a[r];
        }
      }
      __syncthreads();

      // mid = fg^T silu(tg h) over the 128 columns, row 0 := gates, over h
      singa::grid_chain<kNCOL, false, true, false>(stg, sfg, d.G, I, sh, nullptr, hs, sact,
                                                   nullptr, sh, nullptr, hs, sgate);
      __syncthreads();

      // output micro-tiles: four nodes x four output channels of one row
#pragma unroll
      for (int k = 0; k < kMaxJobs; ++k) {
        const int j = tid + k * kThreads;
        if (j < njobs) {
          const int o4 = j % C4, ng = (j / C4) % kNG, i = j / (C4 * kNG);
          const int l = degree_of(i);
          const float* mr = sh + i * hs + 4 * ng;
          const float* wr = sw2 + l * kHC * Co + 4 * o4;
          for (int h = 0; h < kHC; ++h) {
            const float4 mv = *reinterpret_cast<const float4*>(mr + h * kTN);
            const float4 wv = *reinterpret_cast<const float4*>(wr + h * Co);
            fma4(acc[k][0], mv.x, wv);
            fma4(acc[k][1], mv.y, wv);
            fma4(acc[k][2], mv.z, wv);
            fma4(acc[k][3], mv.w, wv);
          }
        }
      }
    }

#pragma unroll
    for (int k = 0; k < kMaxJobs; ++k) {
      const int j = tid + k * kThreads;
      if (j < njobs) {
        const int o4 = j % C4, ng = (j / C4) % kNG, i = j / (C4 * kNG);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int n = n0 + 4 * ng + q;
          if (n < d.N) {
            float4 a = acc[k][q];
            if (i == 0) {
              a.x += b2[4 * o4];
              a.y += b2[4 * o4 + 1];
              a.z += b2[4 * o4 + 2];
              a.w += b2[4 * o4 + 3];
            }
            *reinterpret_cast<float4*>(y + ((long long)n * I + i) * Co + 4 * o4) = a;
          }
        }
      }
    }
  }
}

}  // namespace

// Returns cudaErrorInvalidValue for shapes the kernel does not take: Co not
// a multiple of 4, lmax above 7, or tiles whose shared memory exceeds the
// card's (allow_smem's error).
extern "C" int so3_ffn_f32(const float* x, const float* w1, const float* b1, const float* wg,
                           const float* bg, const float* w2, const float* b2, const float* tg,
                           const float* fg, float* y, int N, int lmax, int C, int H, int Co,
                           int G, void* stream) {
  if (N < 1 || lmax < 1 || C < 1 || H < 1 || Co < 4 || Co % 4 != 0 || G < 1)
    return (int)cudaErrorInvalidValue;
  const Dims d = make_dims(N, lmax, C, H, Co, G);
  if (!singa::chain_fits(kNCOL, 1, d.I) || kNG * d.I * (Co / 4) > kMaxJobs * kThreads)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_floats(d) * sizeof(float);
  cudaError_t err = singa::allow_smem(ffn_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = singa::persistent_grid(ffn_kernel, kThreads, smem, (N + kTN - 1) / kTN);
  ffn_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(x, w1, b1, wg, bg, w2, b2, tg, fg,
                                                             y, d);
  return (int)cudaGetLastError();
}
