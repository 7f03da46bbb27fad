// K2: gate-activation SO(3) feed-forward network, forward.
//
// Replaces: singa_tpu/ops/pallas/so3_ffn.py::so3_gate_ffn_fused
// (_gate_ffn_fwd_kernel).
//   h[n, i, :]   = x[n, i, :] @ w1[l(i)]                        (C -> H)
//   mid[n, 0, :] = silu(h[n, 0, :] + b1)
//   mid[n, i, :] = h[n, i, :] * sigmoid(x[n, 0, :] @ wg + bg)[(l-1)H : lH]
//   y[n, i, :]   = mid[n, i, :] @ w2[l(i)]  (+ b2 on row 0)      (H -> Co)
// x [N, I=(lmax+1)^2, C], w1 [L, C, H], wg [C, lmax*H], w2 [L, H, Co].
//
// What bounds it on the H100: at the main path's shapes (N = 3,584 nodes at
// 8 pockets, I = 49, C = Co = 16, H = 512) it does ~6.1 GFLOP (two
// per-degree products of 0.8 MFLOP per node plus the gate product) against
// ~23 MB of x in and y out, so float32 arithmetic bounds it (~91 us at the
// 67 TFLOP/s float32 CUDA-core rate, memory ~7 us).
//
// Design: the TPU kernel exists so that the [N, I, H] hidden (~360 MB f32
// here) never reaches device memory; so here too. One block owns a tile of
// kTN = 8 nodes and walks the hidden dimension in chunks of kHC = 16
// channels: per chunk it stages the chunk's slices of w1, wg and w2 in
// shared memory (the whole weights, ~655 KB in f32, do not fit), forms the
// gates and the [I, kHC, kTN] hidden slice in shared memory, and adds its
// contribution to the output, which stays in registers until the last
// chunk. Both products run as register micro-tiles of four nodes by four
// channels of one coefficient row (rows of one degree share their weights):
// each step reads one 16-byte vector of four nodes and one of four weights
// and does sixteen multiply-adds. x and the hidden slice are stored node
// minor ([row][channel][node]), each row block padded by kPad floats so
// that the rows a warp reads fall in different banks. The small chunk keeps
// shared memory at ~77 KB, so two blocks share an SM.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kNG = 2;          // groups of four nodes per block
constexpr int kTN = 4 * kNG;    // nodes per block
constexpr int kHC = 16;         // hidden channels per chunk
constexpr int kPad = 8;         // floats added to each row block of sx and smid
constexpr int kMaxJobs = 2;     // output micro-tiles per thread

__device__ __forceinline__ int degree_of(int i) {
  int l = (int)sqrtf((float)i + 0.5f);
  while (l * l > i) --l;
  while ((l + 1) * (l + 1) <= i) ++l;
  return l;
}

__device__ __forceinline__ void fma4(float4& a, float s, const float4& w) {
  a.x = fmaf(s, w.x, a.x);
  a.y = fmaf(s, w.y, a.y);
  a.z = fmaf(s, w.z, a.z);
  a.w = fmaf(s, w.w, a.w);
}

__global__ void __launch_bounds__(kThreads)
gate_ffn_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                const float* __restrict__ b1, const float* __restrict__ wg,
                const float* __restrict__ bg, const float* __restrict__ w2,
                const float* __restrict__ b2, float* __restrict__ y, int N, int lmax,
                int C, int H, int Co) {
  const int L = lmax + 1;
  const int I = L * L;
  const int xs = C * kTN + kPad;    // row stride of sx
  const int ms = kHC * kTN + kPad;  // row stride of smid
  extern __shared__ __align__(16) float smem[];
  float* sx = smem;                         // [I][C][kTN] (+pad per row)
  float* sgate = sx + I * xs;               // [lmax][kHC][kTN]
  float* smid = sgate + lmax * kHC * kTN;   // [I][kHC][kTN] (+pad per row)
  float* sw1 = smid + I * ms;               // [L, C, kHC]
  float* swg = sw1 + L * C * kHC;           // [C, lmax, kHC]
  float* sw2 = swg + C * lmax * kHC;        // [L, kHC, Co]

  const int n0 = blockIdx.x * kTN;
  const int tid = threadIdx.x;
  const int C4 = Co / 4;
  const int njobs = kNG * I * C4;
  for (int t = tid; t < kTN * I * C; t += kThreads) {
    const int n = t / (I * C), i = (t / C) % I, c = t % C;
    sx[i * xs + c * kTN + n] = (n0 + n < N) ? x[(long long)n0 * I * C + t] : 0.f;
  }
  float4 acc[kMaxJobs][4];
#pragma unroll
  for (int k = 0; k < kMaxJobs; ++k)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[k][q] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int h0 = 0; h0 < H; h0 += kHC) {
    __syncthreads();  // previous chunk's readers of the staged weights are done
    for (int t = tid; t < L * C * kHC; t += kThreads) {
      const int h = t % kHC, lc = t / kHC;
      sw1[t] = (h0 + h < H) ? w1[(long long)lc * H + h0 + h] : 0.f;
    }
    for (int t = tid; t < C * lmax * kHC; t += kThreads) {
      const int h = t % kHC, l = (t / kHC) % lmax, c = t / (kHC * lmax);
      swg[t] = (h0 + h < H) ? wg[(long long)c * lmax * H + l * H + h0 + h] : 0.f;
    }
    for (int t = tid; t < L * kHC * Co; t += kThreads) {
      const int o = t % Co, h = (t / Co) % kHC, l = t / (Co * kHC);
      sw2[t] = (h0 + h < H) ? w2[((long long)l * H + h0 + h) * Co + o] : 0.f;
    }
    __syncthreads();

    // gates of degrees 1..lmax from the l=0 row, [lmax][kHC][kTN]
    for (int t = tid; t < lmax * kHC * kTN; t += kThreads) {
      const int n = t % kTN, h = (t / kTN) % kHC, l = t / (kTN * kHC);
      float v = (h0 + h < H) ? bg[l * H + h0 + h] : 0.f;
      for (int c = 0; c < C; ++c) v = fmaf(sx[c * kTN + n], swg[(c * lmax + l) * kHC + h], v);
      sgate[t] = singa::sigmoidf_(v);
    }
    __syncthreads();

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
        float4 m;
        if (i == 0) {
          if (h0 + h < H) {
            const float bb = b1[h0 + h];
            m = make_float4(singa::siluf_(a[r].x + bb), singa::siluf_(a[r].y + bb),
                            singa::siluf_(a[r].z + bb), singa::siluf_(a[r].w + bb));
          } else {
            m = make_float4(0.f, 0.f, 0.f, 0.f);
          }
        } else {
          const float4 g =
              *reinterpret_cast<const float4*>(sgate + ((l - 1) * kHC + h) * kTN + 4 * ng);
          m = make_float4(a[r].x * g.x, a[r].y * g.y, a[r].z * g.z, a[r].w * g.w);
        }
        *reinterpret_cast<float4*>(smid + i * ms + h * kTN + 4 * ng) = m;
      }
    }
    __syncthreads();

    // output micro-tiles: four nodes x four output channels of one row
#pragma unroll
    for (int k = 0; k < kMaxJobs; ++k) {
      const int j = tid + k * kThreads;
      if (j < njobs) {
        const int o4 = j % C4, ng = (j / C4) % kNG, i = j / (C4 * kNG);
        const int l = degree_of(i);
        const float* mr = smid + i * ms + 4 * ng;
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
        if (n < N) {
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

}  // namespace

extern "C" int so3_gate_ffn_f32(const float* x, const float* w1, const float* b1,
                                const float* wg, const float* bg, const float* w2,
                                const float* b2, float* y, int N, int lmax, int C, int H,
                                int Co, void* stream) {
  if (N < 1 || lmax < 1 || C < 1 || H < 1 || Co < 4 || Co % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const int L = lmax + 1, I = L * L;
  if (kNG * I * (Co / 4) > kMaxJobs * kThreads) return (int)cudaErrorInvalidValue;
  const size_t floats = (size_t)I * (C * kTN + kPad) + (size_t)lmax * kHC * kTN +
                        (size_t)I * (kHC * kTN + kPad) + (size_t)L * C * kHC +
                        (size_t)C * lmax * kHC + (size_t)L * kHC * Co;
  const size_t smem = floats * sizeof(float);
  cudaError_t err = singa::allow_smem(gate_ffn_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (N + kTN - 1) / kTN;
  gate_ffn_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(x, w1, b1, wg, bg, w2, b2,
                                                                  y, N, lmax, C, H, Co);
  return (int)cudaGetLastError();
}
