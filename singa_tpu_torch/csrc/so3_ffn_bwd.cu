// K4b: S2-activation SO(3) feed-forward network, backward.
//
// Replaces: singa_tpu/ops/pallas/so3_ffn.py::_bwd (_ffn_bwd_kernel). With the
// forward of csrc/so3_ffn.cu recomputed per node:
//   g0 = x[0] @ wg + bg;  h = lin1(x) (+ b1 on row 0);  v = tg h
//   dmid = dy[i] @ w2[l]^T;  dg0 = silu'(g0) * dmid[0];  dmid[0] := 0
//   mid = fg^T silu(v), mid[0] := silu(g0);  dh = tg^T (silu'(v) * fg dmid)
//   dx[i] = dh[i] @ w1[l]^T  (+ dg0 @ wg^T on row 0)
//   dw1[l] += x[i]^T dh[i];  dw2[l] += mid[i]^T dy[i];  dwg += x[0]^T dg0
//   db1 += dh[0];  dbg += dg0;  db2 += dy[0]
// b1 reaches every row through the grid, so db1 is row 0 of dh (the
// gradient of h's row 0), not of dmid; dmid's row 0 reaches only the gates.
//
// What bounds it on the H100: per node four grid transforms (to-grid of h
// and of dmid, from-grid of silu(v) and of the grid cotangent, 2*G*I*H
// operations each: 42 MFLOP at I = 49, G = 210, H = 512) and five per-degree
// products (h, dmid, dx, dw1, dw2: 4 MFLOP): ~46 MFLOP per node, ~660 GFLOP
// at a training microbatch (N = 14,336), ~9.9 ms at the 67 TFLOP/s float32
// rate, against ~0.14 GB of x, dy in and dx out (~0.04 ms): float32
// arithmetic bounds it.
//
// Design: the hidden, its cotangent and both grids stay out of device
// memory, recomputed per node tile and hidden chunk as the TPU kernel
// recomputes them in VMEM. A block owns a slice of node tiles of kTN = 4
// nodes and, per tile, walks the hidden dimension in chunks of kHC = 16
// channels with dx in registers across the chunks (no sum crosses a block).
// Per chunk: h and dmid as register micro-tiles (K2b's), the gates and dg0,
// then one pass of the grid chain (csrc/s2_grid.cuh) over the chunk's 64
// columns that forms v and the lifted cotangent 32 grid points at a time and
// accumulates both mid and dh in registers. The weight gradients are summed
// over the block's nodes in its own row of a [blocks, P] scratch buffer
// (zeroed first), each entry added by one fixed thread in tile order, and a
// last kernel adds the rows in block order (sum_rows_kernel): deterministic,
// no atomics. The TPU kernel accumulated them along its sequential grid;
// Hopper's blocks run in no order. tg and fg are staged once per block; the
// grid is persistent, one block per SM (~197 KB of shared memory). Nodes
// past N are zero rows of x and dy, which make every term they add to a
// gradient exactly zero.
#include "s2_grid.cuh"

namespace {

constexpr int kThreads = singa::kChainThreads;
constexpr int kTN = 4;            // nodes per tile
constexpr int kHC = 16;           // hidden channels per chunk
constexpr int kNCOL = kHC * kTN;  // grid-chain columns per chunk
constexpr int kPad = 4;           // floats added to each row block

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
         (size_t)d.I * (d.Co * kTN + kPad) + 2 * (size_t)d.Ip * (kNCOL + kPad) +
         2 * (size_t)singa::kGC * kNCOL + 2 * (size_t)d.L * d.C * kHC + (size_t)d.C * kHC +
         (size_t)d.L * d.Co * kHC + 2 * kNCOL;
}

// Offsets of the weight gradients in one flat row of P floats, in the order
// dw1 [L, C, H], db1 [H], dwg [C, H], dbg [H], dw2 [L, H, Co], db2 [Co].
struct GradLayout {
  long long w1, b1, wg, bg, w2, b2, total;
};

__host__ __device__ inline GradLayout grad_layout(const Dims& d) {
  GradLayout g;
  g.w1 = 0;
  g.b1 = g.w1 + (long long)d.L * d.C * d.H;
  g.wg = g.b1 + d.H;
  g.bg = g.wg + (long long)d.C * d.H;
  g.w2 = g.bg + d.H;
  g.b2 = g.w2 + (long long)d.L * d.H * d.Co;
  g.total = g.b2 + d.Co;
  return g;
}

__global__ void __launch_bounds__(kThreads, 1)
ffn_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dy,
               const float* __restrict__ w1, const float* __restrict__ b1,
               const float* __restrict__ wg, const float* __restrict__ bg,
               const float* __restrict__ w2, const float* __restrict__ tg,
               const float* __restrict__ fg, float* __restrict__ dx,
               float* __restrict__ partial, Dims d) {
  const int L = d.L, I = d.I, C = d.C, H = d.H, Co = d.Co;
  const int xs = C * kTN + kPad;   // row stride of sx
  const int ys = Co * kTN + kPad;  // row stride of sdy
  const int hs = kNCOL + kPad;     // row stride of sh and sdm
  extern __shared__ __align__(16) float smem[];
  const size_t gm = singa::grid_mats_floats(d.G, I) / 2;
  float* stg = smem;                         // [Gp][Ip]
  float* sfg = stg + gm;                     // [Gp][Ip]
  float* sx = sfg + gm;                      // [I][C][kTN] (+pad per row)
  float* sdy = sx + I * xs;                  // [I][Co][kTN] (+pad per row)
  float* sh = sdy + I * ys;                  // [Ip][kHC][kTN] (+pad): h, then mid
  float* sdm = sh + d.Ip * hs;               // [Ip][kHC][kTN] (+pad): dmid, then dh
  float* saf = sdm + d.Ip * hs;              // [kGC][kNCOL] silu(v)
  float* sab = saf + singa::kGC * kNCOL;     // [kGC][kNCOL] silu'(v) * fg dmid
  float* sw1 = sab + singa::kGC * kNCOL;     // [L][C][kHC]
  float* sw1t = sw1 + L * C * kHC;           // [L][kHC][C]
  float* swg = sw1t + L * C * kHC;           // [C][kHC]
  float* sw2t = swg + C * kHC;               // [L][Co][kHC]
  float* sgate = sw2t + L * Co * kHC;        // [kHC][kTN] g0, then silu(g0)
  float* sdg = sgate + kNCOL;                // [kHC][kTN] dg0

  const int tid = threadIdx.x;
  const int C4 = C / 4;
  const bool dx_job = tid < I * C4;  // one dx micro-tile (4 nodes x 4 channels of a row)
  const int dx_c4 = tid % C4, dx_i = tid / C4;
  const GradLayout gl = grad_layout(d);
  float* row = partial + (long long)blockIdx.x * gl.total;
  singa::stage_grid_mats(tg, fg, d.G, I, stg, sfg);
  for (int t = tid; t < (d.Ip - I) * hs; t += kThreads) {  // padded rows
    sh[I * hs + t] = 0.f;
    sdm[I * hs + t] = 0.f;
  }

  const int tiles = (d.N + kTN - 1) / kTN;
  const int t_begin = (int)((long long)tiles * blockIdx.x / gridDim.x);
  const int t_end = (int)((long long)tiles * (blockIdx.x + 1) / gridDim.x);
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int n0 = tile * kTN;
    __syncthreads();  // the previous tile's readers of sx and sdy are done
    for (int t = tid; t < kTN * I * C; t += kThreads) {
      const int n = t / (I * C), i = (t / C) % I, c = t % C;
      sx[i * xs + c * kTN + n] = (n0 + n < d.N) ? x[(long long)n0 * I * C + t] : 0.f;
    }
    for (int t = tid; t < kTN * I * Co; t += kThreads) {
      const int n = t / (I * Co), i = (t / Co) % I, o = t % Co;
      sdy[i * ys + o * kTN + n] = (n0 + n < d.N) ? dy[(long long)n0 * I * Co + t] : 0.f;
    }
    float4 acc[4];  // dx: node q of the micro-tile, four channels
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[q] = make_float4(0.f, 0.f, 0.f, 0.f);

    for (int h0 = 0; h0 < H; h0 += kHC) {
      __syncthreads();  // the previous chunk's readers of the weights, mid and dh are done
      for (int t = tid; t < L * C * kHC; t += kThreads) {
        const int h = t % kHC, lc = t / kHC;
        sw1[t] = (h0 + h < H) ? w1[(long long)lc * H + h0 + h] : 0.f;
      }
      for (int t = tid; t < L * kHC * C; t += kThreads) {
        const int c = t % C, h = (t / C) % kHC, l = t / (C * kHC);
        sw1t[t] = (h0 + h < H) ? w1[((long long)l * C + c) * H + h0 + h] : 0.f;
      }
      for (int t = tid; t < C * kHC; t += kThreads) {
        const int h = t % kHC, c = t / kHC;
        swg[t] = (h0 + h < H) ? wg[(long long)c * H + h0 + h] : 0.f;
      }
      for (int t = tid; t < L * Co * kHC; t += kThreads) {
        const int h = t % kHC, o = (t / kHC) % Co, l = t / (kHC * Co);
        sw2t[t] = (h0 + h < H) ? w2[((long long)l * H + h0 + h) * Co + o] : 0.f;
      }
      __syncthreads();

      // gate pre-activations g0, [kHC][kTN]
      for (int t = tid; t < kNCOL; t += kThreads) {
        const int n = t % kTN, h = t / kTN;
        float v = (h0 + h < H) ? bg[h0 + h] : 0.f;
        for (int c = 0; c < C; ++c) v = fmaf(sx[c * kTN + n], swg[c * kHC + h], v);
        sgate[t] = v;
      }
      // h and dmid: micro-tiles of four nodes x four hidden channels of one row
      for (int t = tid; t < I * (kHC / 4); t += kThreads) {
        const int h4 = t % (kHC / 4), i = t / (kHC / 4);
        const int l = degree_of(i);
        float4 a[4], b[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          a[r] = make_float4(0.f, 0.f, 0.f, 0.f);
          b[r] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
        const float* xr = sx + i * xs;
        const float* wr = sw1 + l * C * kHC + 4 * h4;
        for (int c = 0; c < C; ++c) {
          const float4 xv = *reinterpret_cast<const float4*>(xr + c * kTN);
          const float4 wv = *reinterpret_cast<const float4*>(wr + c * kHC);
          fma4(a[0], wv.x, xv);
          fma4(a[1], wv.y, xv);
          fma4(a[2], wv.z, xv);
          fma4(a[3], wv.w, xv);
        }
        const float* yr = sdy + i * ys;
        const float* vr = sw2t + l * Co * kHC + 4 * h4;
        for (int o = 0; o < Co; ++o) {
          const float4 yv = *reinterpret_cast<const float4*>(yr + o * kTN);
          const float4 wv = *reinterpret_cast<const float4*>(vr + o * kHC);
          fma4(b[0], wv.x, yv);
          fma4(b[1], wv.y, yv);
          fma4(b[2], wv.z, yv);
          fma4(b[3], wv.w, yv);
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
          const int off = i * hs + h * kTN;
          *reinterpret_cast<float4*>(sh + off) = a[r];
          *reinterpret_cast<float4*>(sdm + off) = b[r];
        }
      }
      __syncthreads();
      // row 0 of dmid reaches only the gates: dg0, then zero it for the grid
      for (int t = tid; t < kNCOL; t += kThreads) {
        const float g = sgate[t];
        sdg[t] = singa::silu_gradf_(g) * sdm[t];
        sgate[t] = singa::siluf_(g);
        sdm[t] = 0.f;
      }
      __syncthreads();

      // mid = fg^T silu(tg h) (row 0 := gates) over h; dh = tg^T (silu'(tg h)
      // * fg dmid) over dmid
      singa::grid_chain<kNCOL, true, true, true>(stg, sfg, d.G, I, sh, sdm, hs, saf, sab, sh,
                                                 sdm, hs, sgate);
      __syncthreads();

      // the chunk's weight gradients, each entry added by one thread
      for (int t = tid; t < L * C * kHC; t += kThreads) {  // dw1[l][c][h] += x[i][c] dh[i][h]
        const int h = t % kHC, c = (t / kHC) % C, l = t / (kHC * C);
        if (h0 + h >= H) continue;
        float v = 0.f;
        for (int i = l * l; i < (l + 1) * (l + 1); ++i) {
          const float4 a = *reinterpret_cast<const float4*>(sx + i * xs + c * kTN);
          const float4 b = *reinterpret_cast<const float4*>(sdm + i * hs + h * kTN);
          v = fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, fmaf(a.w, b.w, v))));
        }
        row[gl.w1 + ((long long)l * C + c) * H + h0 + h] += v;
      }
      for (int t = tid; t < L * kHC * Co; t += kThreads) {  // dw2[l][h][o] += mid[i][h] dy[i][o]
        const int o = t % Co, h = (t / Co) % kHC, l = t / (Co * kHC);
        if (h0 + h >= H) continue;
        float v = 0.f;
        for (int i = l * l; i < (l + 1) * (l + 1); ++i) {
          const float4 a = *reinterpret_cast<const float4*>(sh + i * hs + h * kTN);
          const float4 b = *reinterpret_cast<const float4*>(sdy + i * ys + o * kTN);
          v = fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, fmaf(a.w, b.w, v))));
        }
        row[gl.w2 + ((long long)l * H + h0 + h) * Co + o] += v;
      }
      for (int t = tid; t < C * kHC; t += kThreads) {  // dwg[c][h] += x[0][c] dg0[h]
        const int h = t % kHC, c = t / kHC;
        if (h0 + h >= H) continue;
        const float4 a = *reinterpret_cast<const float4*>(sx + c * kTN);
        const float4 b = *reinterpret_cast<const float4*>(sdg + h * kTN);
        row[gl.wg + (long long)c * H + h0 + h] += a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
      }
      for (int t = tid; t < 2 * kHC; t += kThreads) {  // db1 (row 0 of dh), dbg
        const int h = t % kHC;
        if (h0 + h >= H) continue;
        const float4 b = *reinterpret_cast<const float4*>((t < kHC ? sdm : sdg) + h * kTN);
        row[(t < kHC ? gl.b1 : gl.bg) + h0 + h] += b.x + b.y + b.z + b.w;
      }
      if (h0 == 0) {
        for (int t = tid; t < Co; t += kThreads) {  // db2 (row 0 of dy)
          const float4 b = *reinterpret_cast<const float4*>(sdy + t * kTN);
          row[gl.b2 + t] += b.x + b.y + b.z + b.w;
        }
      }

      // dx += dh @ w1^T, and on row 0 dg0 @ wg^T
      if (dx_job) {
        const int l = degree_of(dx_i);
        const float* dr = sdm + dx_i * hs;
        const float* wr = sw1t + l * kHC * C + 4 * dx_c4;
        for (int h = 0; h < kHC; ++h) {
          const float4 dv = *reinterpret_cast<const float4*>(dr + h * kTN);
          const float4 wv = *reinterpret_cast<const float4*>(wr + h * C);
          fma4(acc[0], dv.x, wv);
          fma4(acc[1], dv.y, wv);
          fma4(acc[2], dv.z, wv);
          fma4(acc[3], dv.w, wv);
        }
        if (dx_i == 0) {
          for (int h = 0; h < kHC; ++h) {
            const float4 gv = *reinterpret_cast<const float4*>(sdg + h * kTN);
            const float4 wv = make_float4(swg[(4 * dx_c4) * kHC + h], swg[(4 * dx_c4 + 1) * kHC + h],
                                          swg[(4 * dx_c4 + 2) * kHC + h],
                                          swg[(4 * dx_c4 + 3) * kHC + h]);
            fma4(acc[0], gv.x, wv);
            fma4(acc[1], gv.y, wv);
            fma4(acc[2], gv.z, wv);
            fma4(acc[3], gv.w, wv);
          }
        }
      }
    }

    if (dx_job) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = n0 + q;
        if (n < d.N)
          *reinterpret_cast<float4*>(dx + ((long long)n * I + dx_i) * C + 4 * dx_c4) = acc[q];
      }
    }
  }
}

bool dims_ok(int N, int lmax, int C, int H, int Co, int G) {
  if (N < 1 || lmax < 1 || C < 4 || C % 4 != 0 || H < 1 || Co < 1 || G < 1) return false;
  const int I = (lmax + 1) * (lmax + 1);
  return singa::chain_fits(kNCOL, 2, I) && I * (C / 4) <= kThreads;
}

}  // namespace

// Blocks the kernel runs (one per SM at its shared memory, never more than
// the node tiles); the caller allocates the [blocks, P] scratch buffer from
// this. Returns -1 for shapes the kernel does not take: C not a multiple of
// 4, lmax above 7, or tiles that exceed shared memory.
extern "C" int so3_ffn_bwd_blocks(int N, int lmax, int C, int H, int Co, int G) {
  if (!dims_ok(N, lmax, C, H, Co, G)) return -1;
  const Dims d = make_dims(N, lmax, C, H, Co, G);
  const size_t smem = smem_floats(d) * sizeof(float);
  if (singa::allow_smem(ffn_bwd_kernel, smem) != cudaSuccess) return -1;
  return singa::persistent_grid(ffn_bwd_kernel, kThreads, smem, (N + kTN - 1) / kTN);
}

extern "C" int so3_ffn_bwd_f32(const float* x, const float* dy, const float* w1, const float* b1,
                               const float* wg, const float* bg, const float* w2, const float* tg,
                               const float* fg, float* dx, float* partial, float* grads, int N,
                               int lmax, int C, int H, int Co, int G, int blocks, void* stream) {
  if (!dims_ok(N, lmax, C, H, Co, G) || blocks < 1) return (int)cudaErrorInvalidValue;
  const Dims d = make_dims(N, lmax, C, H, Co, G);
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = smem_floats(d) * sizeof(float);
  cudaError_t err = singa::allow_smem(ffn_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const long long P = grad_layout(d).total;
  err = cudaMemsetAsync(partial, 0, (size_t)blocks * P * sizeof(float), st);
  if (err != cudaSuccess) return (int)err;
  ffn_bwd_kernel<<<blocks, kThreads, smem, st>>>(x, dy, w1, b1, wg, bg, w2, tg, fg, dx, partial, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int grid = singa::persistent_grid(singa::sum_rows_kernel, 256, 0, (P + 255) / 256);
  singa::sum_rows_kernel<<<grid, 256, 0, st>>>(partial, grads, P, blocks);
  return (int)cudaGetLastError();
}
