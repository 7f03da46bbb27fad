// The dense form's closed-form rows' share of K8b's weight gradients
// (csrc/encoder_attn.cuh sets the closed form out): padded_wgrad_kernel,
// which both of K8b's instances launch, its CUDA-core one
// (csrc/dense_edge_attn_bwd.cu) and its bfloat16 tensor-core one
// (csrc/neighbor_attn_bwd.cu); and the tensor-core one's per-graph column
// sums (graph_colsum_split_kernel).
#pragma once

#include "encoder_attn.cuh"

namespace {

constexpr int kPadThreads = 256;

// dw_v summed over every (closed-form row, column) pair of the batch is
// DWV[d] = sum_b sum_h G[b, h, d] vsum[b, h, d]; all those pairs share the
// hidden ssp(bv1) (pre-activation bv1), so dwv2 = ssp(bv1)^T DWV,
// dbv2 = DWV, dbv1 = (DWV wv2^T) * sigmoid(bv1), and nothing else. Writes
// them into row [P] (zero elsewhere), then G *= w_v0 in place. One block. At
// T = bf16 the hidden ssp(bv1) and wv2 rounded.
template <class T = float>
__global__ void __launch_bounds__(kPadThreads)
padded_wgrad_kernel(const float* __restrict__ bv1, const float* __restrict__ wv2,
                    const float* __restrict__ bv2, const float* __restrict__ vsum,
                    float* __restrict__ G, float* __restrict__ row,
                    singa::encoder_attn::Dims dm) {
  using singa::rnd;
  extern __shared__ __align__(16) float smem[];
  const int H = dm.H, vd = dm.vd, HV = H * vd, tid = threadIdx.x;
  float* w0 = smem;        // [vd]
  float* dwv = w0 + vd;    // [vd]
  singa::encoder_attn::dead_wv<T>(bv1, wv2, bv2, vd, w0);
  for (int c = tid; c < vd; c += blockDim.x) {
    float acc = 0.f;
    for (int b = 0; b < dm.B; ++b)
      for (int h = 0; h < H; ++h) {
        const long long i = (long long)b * HV + h * vd + c;
        acc = fmaf(G[i], vsum[i], acc);
      }
    dwv[c] = acc;
  }
  const int P = dm.grad_floats();
  for (int t = tid; t < P; t += blockDim.x) row[t] = 0.f;
  __syncthreads();
  const int kd = dm.kd, De = dm.De;
  float* dbv1 = row + De * kd + kd + kd * kd + kd + De * vd;
  float* dwv2 = dbv1 + vd;
  float* dbv2 = dwv2 + vd * vd;
  for (int t = tid; t < vd * vd; t += blockDim.x)
    dwv2[t] = rnd<T>(singa::sspf_(bv1[t / vd])) * dwv[t % vd];
  for (int c = tid; c < vd; c += blockDim.x) {
    dbv2[c] = dwv[c];
    float acc = 0.f;
    for (int j = 0; j < vd; ++j) acc = fmaf(dwv[j], rnd<T>(wv2[c * vd + j]), acc);
    dbv1[c] = acc * singa::sigmoidf_(bv1[c]);
  }
  for (long long i = tid; i < (long long)dm.B * HV; i += blockDim.x) G[i] *= w0[i % vd];
}

// out[b, c] = the sum over graph b's N rows i of x[b*N + i, c] (times
// wt[b*N + i, c / cw] when wt is given), as encoder_attn.cuh's
// graph_colsum_kernel, with the rows cut into kColParts ranges summed
// apart (in order) and then added in order: B x ceil(C / 64) blocks of 64
// channels x kColParts ranges, where graph_colsum_kernel's B blocks walk
// all N rows a thread. X: the storage type of x.
constexpr int kColParts = 8;

template <class X>
__global__ void __launch_bounds__(64 * kColParts)
graph_colsum_split_kernel(const X* __restrict__ x, const float* __restrict__ wt,
                          float* __restrict__ out, int N, int C, int cw) {
  __shared__ float part[kColParts][64];
  const int t = threadIdx.x & 63, p = threadIdx.x >> 6;
  const int b = blockIdx.x, c = blockIdx.y * 64 + t, nw = C / cw;
  const int r0 = N * p / kColParts, r1 = N * (p + 1) / kColParts;
  float acc = 0.f;
  if (c < C)
    for (int i = r0; i < r1; ++i) {
      const long long r = (long long)b * N + i;
      const float xv = singa::to_f(x[r * C + c]);
      acc = wt ? fmaf(wt[r * nw + c / cw], xv, acc) : acc + xv;
    }
  part[p][t] = acc;
  __syncthreads();
  if (p == 0 && c < C) {
    float sum = part[0][t];
    for (int q = 1; q < kColParts; ++q) sum += part[q][t];
    out[(long long)b * C + c] = sum;
  }
}

template <class X>
inline cudaError_t launch_colsum_split(const X* x, const float* wt, float* out, int B, int N,
                                       int C, int cw, cudaStream_t st) {
  graph_colsum_split_kernel<X><<<dim3(B, (C + 63) / 64), 64 * kColParts, 0, st>>>(x, wt, out, N,
                                                                                   C, cw);
  return cudaGetLastError();
}

}  // namespace
