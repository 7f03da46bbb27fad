// A small shared-memory GEMM for the per-node pair tensors of the neighbour
// attention kernels (csrc/neighbor_attn.cu, csrc/neighbor_attn_bwd.cu).
#pragma once

#include "common.cuh"

namespace singa {

constexpr int kGemmRows = 4;  // rows of the product per thread

enum GemmEpilogue {
  kEpiNone = 0,         // out = acc
  kEpiSsp = 1,          // out = ssp(acc)
  kEpiTimesSigmoid = 2  // out = acc * sigmoid(out): out holds a pre-activation
};

// out[m, f] = epi(bias[f] + sum_d A[m, d] * W[d, f]); A [M, Din], W [Din, Fo],
// out [M, Fo], all in shared memory; bias may be null (zero); out must not
// alias A. Threads run over f fastest, so a warp reads one group of A rows
// (broadcast) and consecutive W columns; each thread keeps kGemmRows
// accumulators and, when the rows allow it, reads A four columns at a time
// (one 16-byte load feeds four multiply-adds). The sum over d runs in order
// either way. Each out element is read (kEpiTimesSigmoid) and written by the
// one thread that computes it.
__device__ inline void block_gemm(const float* A, int M, int Din, const float* W,
                                  const float* bias, int Fo, float* out, int epi) {
  const int groups = (M + kGemmRows - 1) / kGemmRows;
  const bool vec = (Din % 4 == 0) && ((reinterpret_cast<size_t>(A) & 15) == 0);
  for (int job = threadIdx.x; job < groups * Fo; job += blockDim.x) {
    const int f = job % Fo;
    const int m0 = (job / Fo) * kGemmRows;
    const float* ar[kGemmRows];
    float acc[kGemmRows];
#pragma unroll
    for (int r = 0; r < kGemmRows; ++r) {
      ar[r] = A + min(m0 + r, M - 1) * Din;
      acc[r] = bias ? bias[f] : 0.f;
    }
    if (vec) {
      for (int d = 0; d < Din; d += 4) {
        const float w0 = W[d * Fo + f], w1 = W[(d + 1) * Fo + f];
        const float w2 = W[(d + 2) * Fo + f], w3 = W[(d + 3) * Fo + f];
#pragma unroll
        for (int r = 0; r < kGemmRows; ++r) {
          const float4 a = *reinterpret_cast<const float4*>(ar[r] + d);
          acc[r] = fmaf(a.x, w0, acc[r]);
          acc[r] = fmaf(a.y, w1, acc[r]);
          acc[r] = fmaf(a.z, w2, acc[r]);
          acc[r] = fmaf(a.w, w3, acc[r]);
        }
      }
    } else {
      for (int d = 0; d < Din; ++d) {
        const float w = W[d * Fo + f];
#pragma unroll
        for (int r = 0; r < kGemmRows; ++r) acc[r] = fmaf(ar[r][d], w, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kGemmRows; ++r) {
      if (m0 + r < M) {
        float* o = out + (m0 + r) * Fo + f;
        if (epi == kEpiSsp) {
          *o = sspf_(acc[r]);
        } else if (epi == kEpiTimesSigmoid) {
          *o = acc[r] * sigmoidf_(*o);
        } else {
          *o = acc[r];
        }
      }
    }
  }
}

}  // namespace singa
