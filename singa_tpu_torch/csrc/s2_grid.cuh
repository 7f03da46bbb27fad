// The sphere-grid chain shared by K4/K4b (csrc/so3_ffn.cu,
// csrc/so3_ffn_bwd.cu) and K5/K5b (csrc/s2_act.cu).
//
// For a tile of NCOL independent columns of coefficient vectors X[:, c]
// (and Y[:, c]), per column:
//   v        = tg . X[:, c]              the G grid values
//   u        = fg . Y[:, c]              (HAS_U) the lifted cotangent
//   OF[:, c] = fg^T silu(v)              (OUT_F) the S2 SiLU
//   OB[:, c] = tg^T (silu'(v) * u)       (OUT_B) its backward
// tg/fg [G, I] are the to-grid / from-grid matrices.
//
// Both transforms are products of a [G, I] matrix with the [I, NCOL] tile,
// so the chain runs as two register-tiled GEMMs per chunk of kGC grid
// points, the flash-attention way: the to-grid product writes the chunk's
// activated grid ([kGC, NCOL], 16 KB at NCOL = 128) to shared memory, and
// the from-grid product adds its contraction into accumulators that stay in
// registers over every chunk. The [G, NCOL] grid never exists whole, in
// shared memory or in device memory. Each thread of the to-grid step owns a
// micro-tile of RA grid points x 4 columns (one 16-byte load of four columns
// feeds 4 * RA multiply-adds), each thread of the from-grid step one of kRB
// output rows x 4 columns. A warp's threads take neighbouring column groups,
// so the matrix rows they read are broadcasts and the tile reads are
// conflict-free 16-byte vectors.
//
// Layouts (shared memory, floats): tg and fg as [Gp][Ip], zero-padded to
// Gp = G rounded up to kGC grid points and Ip = I rounded up to kRB rows;
// X, Y, OF and OB as [Ip][row stride], column c at offset c. Rows I..Ip-1 of
// X and Y must hold zeros (finite, so that the zero matrix columns cancel
// them); padded grid points give v = 0, silu(0) = 0 and zero matrix rows, so
// they add exactly zero.
#pragma once

#include "common.cuh"

namespace singa {

constexpr int kChainThreads = 256;  // threads of every block that runs the chain
constexpr int kGC = 32;             // grid points per chunk
constexpr int kRB = 8;              // output rows per thread in the from-grid step
constexpr int kMaxIp = 64;          // padded coefficient rows the chain takes (lmax <= 7)

__host__ __device__ inline int pad_rows(int I) { return (I + kRB - 1) / kRB * kRB; }
__host__ __device__ inline int pad_grid(int G) { return (G + kGC - 1) / kGC * kGC; }

// tg/fg [G, I] in device memory -> stg/sfg [Gp][Ip] in shared memory.
__device__ inline void stage_grid_mats(const float* __restrict__ tg, const float* __restrict__ fg,
                                       int G, int I, float* stg, float* sfg) {
  const int Gp = pad_grid(G), Ip = pad_rows(I);
  for (int t = threadIdx.x; t < Gp * Ip; t += blockDim.x) {
    const int g = t / Ip, i = t % Ip;
    const bool in = g < G && i < I;
    stg[t] = in ? tg[g * I + i] : 0.f;
    sfg[t] = in ? fg[g * I + i] : 0.f;
  }
}

// The chain over all grid chunks; called by every thread of the block, with
// X (and Y) complete in shared memory. Writes rows 0..I-1 of OF (and OB),
// row 0 of OF taken from row0F[c] when row0F is not null. OF/OB may alias
// X/Y: every read of X and Y ends before the chain's last barrier. Starts
// and ends with no barrier of its own around it; the caller synchronises
// before reading OF/OB or rewriting X/Y, saf or sab.
template <int NCOL, bool HAS_U, bool OUT_F, bool OUT_B>
__device__ void grid_chain(const float* stg, const float* sfg, int G, int I,
                           const float* X, const float* Y, int xs, float* saf, float* sab,
                           float* OF, float* OB, int os, const float* row0F) {
  constexpr int T = kChainThreads;
  constexpr int CG = NCOL / 4;              // column groups of four
  constexpr int RA = kGC * NCOL / (4 * T);  // grid points per thread in the to-grid step
  static_assert(RA >= 1 && RA * 4 * T == kGC * NCOL, "one to-grid micro-tile per thread");
  static_assert(OUT_F || OUT_B, "the chain has an output");
  static_assert(!OUT_B || HAS_U, "the backward output needs the cotangent");
  const int Gp = pad_grid(G), Ip = pad_rows(I);
  const int tid = threadIdx.x;
  // to-grid micro-tile: grid points ag .. ag+RA-1 of the chunk, columns 4acg ..
  const int acg = tid % CG, ag = (tid / CG) * RA;
  // from-grid micro-tile: rows kRB*brg .. of output otype (0: OF if OUT_F)
  const int RG = Ip / kRB;
  const int bcg = tid % CG, brg = (tid / CG) % RG, otype = tid / (CG * RG);
  const bool active = otype < (OUT_F ? 1 : 0) + (OUT_B ? 1 : 0);
  const bool isF = OUT_F && otype == 0;
  const float* bm = isF ? sfg : stg;  // OF contracts with fg, OB with tg
  const float* bact = isF ? saf : sab;
  float4 acc[kRB];
#pragma unroll
  for (int r = 0; r < kRB; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int g0 = 0; g0 < Gp; g0 += kGC) {
    {
      float4 v[RA], u[RA];
#pragma unroll
      for (int r = 0; r < RA; ++r) {
        v[r] = make_float4(0.f, 0.f, 0.f, 0.f);
        u[r] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      const float* xc = X + 4 * acg;
      const float* yc = HAS_U ? Y + 4 * acg : nullptr;
      const float* tr = stg + (g0 + ag) * Ip;
      const float* fr = sfg + (g0 + ag) * Ip;
      for (int j = 0; j < Ip; j += 4) {
        float4 xv[4], yv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          xv[q] = *reinterpret_cast<const float4*>(xc + (j + q) * xs);
          if (HAS_U) yv[q] = *reinterpret_cast<const float4*>(yc + (j + q) * xs);
        }
#pragma unroll
        for (int r = 0; r < RA; ++r) {
          const float4 t = *reinterpret_cast<const float4*>(tr + r * Ip + j);
          fma4(v[r], t.x, xv[0]);
          fma4(v[r], t.y, xv[1]);
          fma4(v[r], t.z, xv[2]);
          fma4(v[r], t.w, xv[3]);
          if (HAS_U) {
            const float4 f = *reinterpret_cast<const float4*>(fr + r * Ip + j);
            fma4(u[r], f.x, yv[0]);
            fma4(u[r], f.y, yv[1]);
            fma4(u[r], f.z, yv[2]);
            fma4(u[r], f.w, yv[3]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RA; ++r) {
        const int off = (ag + r) * NCOL + 4 * acg;
        if (OUT_F)
          *reinterpret_cast<float4*>(saf + off) =
              make_float4(siluf_(v[r].x), siluf_(v[r].y), siluf_(v[r].z), siluf_(v[r].w));
        if (OUT_B)
          *reinterpret_cast<float4*>(sab + off) = make_float4(
              silu_gradf_(v[r].x) * u[r].x, silu_gradf_(v[r].y) * u[r].y,
              silu_gradf_(v[r].z) * u[r].z, silu_gradf_(v[r].w) * u[r].w);
      }
    }
    __syncthreads();  // the chunk's activated grid is complete
    if (active) {
      const float* mr = bm + g0 * Ip + kRB * brg;
      const float* ar = bact + 4 * bcg;
#pragma unroll 4
      for (int g = 0; g < kGC; ++g) {
        const float4 a = *reinterpret_cast<const float4*>(ar + g * NCOL);
        const float4 m0 = *reinterpret_cast<const float4*>(mr + g * Ip);
        const float4 m1 = *reinterpret_cast<const float4*>(mr + g * Ip + 4);
        fma4(acc[0], m0.x, a);
        fma4(acc[1], m0.y, a);
        fma4(acc[2], m0.z, a);
        fma4(acc[3], m0.w, a);
        fma4(acc[4], m1.x, a);
        fma4(acc[5], m1.y, a);
        fma4(acc[6], m1.z, a);
        fma4(acc[7], m1.w, a);
      }
    }
    __syncthreads();  // the chunk's grid is consumed before the next one is written
  }

  if (active) {
    float* out = isF ? OF : OB;
#pragma unroll
    for (int r = 0; r < kRB; ++r) {
      const int i = kRB * brg + r;
      if (i < I) {
        float4 val = acc[r];
        if (isF && i == 0 && row0F != nullptr)
          val = *reinterpret_cast<const float4*>(row0F + 4 * bcg);
        *reinterpret_cast<float4*>(out + i * os + 4 * bcg) = val;
      }
    }
  }
}

// Shared memory of the chain's constant part, in floats: stg and sfg.
__host__ __device__ inline size_t grid_mats_floats(int G, int I) {
  return 2 * (size_t)pad_grid(G) * pad_rows(I);
}

// Whether the chain takes I coefficient rows at NCOL columns and `nout`
// outputs: every from-grid micro-tile needs a thread of its own.
__host__ __device__ inline bool chain_fits(int ncol, int nout, int I) {
  return I >= 1 && pad_rows(I) <= kMaxIp &&
         nout * (pad_rows(I) / kRB) * (ncol / 4) <= kChainThreads;
}

}  // namespace singa
