// The sphere-grid chain of K4b (csrc/so3_ffn_bwd.cu) on the tensor cores:
// the function of s2_grid.cuh's grid_chain<NCOL, true, true, true> (which
// K4, K5 and K5b keep), with its four products as split-TF32 mma.sync
// (csrc/mma_tf32.cuh) accumulated in float32.
//
// For a tile of NCOL = 64 columns of X (the hidden h) and Y (its cotangent
// dmid), per chunk of kGC = 32 grid points, three steps between barriers:
//   to-grid    v = tg[chunk] X, u = fg[chunk] Y       M = kGC, K = I (in
//              steps of 8), N = NCOL; A read row-major with k paired
//   activate   on the accumulator fragments in registers: the v warp
//              writes silu(v) to saf and silu'(v) to a scratch plane, the u
//              warp of the same positions (after a barrier) multiplies it by
//              u into sab. Both are written already split, as TF32 hi and lo
//              planes ([kGC][NCOL + 8] each): the accumulator layout is not
//              the B operand's, so the round trip through shared memory is
//              the simple way, and splitting there spares the from-grid
//              step's B splits
//   from-grid  OF += fg[chunk]^T saf, OB += tg[chunk]^T sab   M = I in
//              m16 tiles (rows past I are never stored), K = kGC, N = NCOL;
//              A read transposed, k in order. The accumulators stay in
//              registers over every chunk.
// Row 0 of OF is taken from row0F at the end.
//
// Warps (kTcWarps = 16): in the to-grid step warp w forms one product (v
// for even w, u for odd) on grid rows 16 ((w >> 1) & 1) .. + 15 and two n8
// tiles (16 columns, 16 (w >> 2) ..); in the from-grid step warps 0-7 form
// OF and 8-15 OB, each on one m16 tile ((w >> 1) & 3) and four n8 tiles
// (32 columns), 16 accumulators a thread. Per k step a to-grid warp splits
// 8 values for 6 mma, a from-grid warp 4 for 12. 16 warps beat 8 (more
// warps to hide the latency of each k step's loads, splits and three
// dependent mma) at every stage of the tuning; 12 would not
// divide the 16 to-grid and 32 from-grid tiles of a product evenly.
//
// Layouts (shared memory, floats): tg and fg as [Gp][S], zero-padded to
// Gp = G rounded up to kGC and S = tc_stride(I) >= I rounded up to 8 with
// S % 32 of 8 or 24, so both orientations load without bank conflicts
// (mma_tf32.cuh); kTcGuard zero floats after fg, since the from-grid's last
// m16 tile reads up to 8 floats past the last row. X, Y, OF and OB as
// [Ip][xs] with xs % 16 of 4 or 12, rows I..Ip-1 of X and Y zero (Ip = I
// rounded up to 8). Padded grid points give v = 0 and zero matrix rows, so
// they add exactly zero.
#pragma once

#include "mma_tf32.cuh"
#include "s2_grid.cuh"

namespace singa {

constexpr int kTcWarps = 16;  // warps of every block that runs the tensor-core chain
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcGuard = 8;   // zero floats after the staged fg

// Row stride of the staged tg and fg: >= I rounded up to 8, % 32 of 8 or 24.
__host__ __device__ inline int tc_stride(int I) {
  const int s = pad_rows(I);
  return s % 16 == 8 ? s : s + 8;
}

// Row stride of the chain's saf and sab planes ([kGC][stride]): % 32 of 8
// or 24.
__host__ __device__ constexpr int tc_act_stride(int ncol) { return ncol + 8; }

// Shared memory of the chain's activated grid, in floats: saf and sab, each
// a hi and a lo plane.
__host__ __device__ constexpr int tc_act_floats(int ncol) { return 4 * kGC * tc_act_stride(ncol); }

// silu(v) and silu'(v) from one exponential, by the fast intrinsics
// (~1e-6 relative; __expf(-v) = inf gives 0 and 0 for v << 0)
__device__ __forceinline__ void silu_and_grad(float v, float& s, float& ds) {
  const float sg = __fdividef(1.f, 1.f + __expf(-v));
  s = v * sg;
  ds = sg * (1.f + v * (1.f - sg));
}

// Shared memory of the chain's constant part, in floats: tg, fg, guard.
__host__ __device__ inline size_t tc_mats_floats(int G, int I) {
  return 2 * (size_t)pad_grid(G) * tc_stride(I) + kTcGuard;
}

// tg/fg [G, I] in device memory -> stg/sfg [Gp][S] (sfg = stg + Gp * S),
// then the guard.
__device__ inline void stage_grid_mats_tc(const float* __restrict__ tg,
                                          const float* __restrict__ fg, int G, int I,
                                          float* stg) {
  const int S = tc_stride(I), n = pad_grid(G) * S;
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    const int g = t / S, i = t % S;
    const bool in = g < G && i < I;
    stg[t] = in ? tg[g * I + i] : 0.f;
    stg[n + t] = in ? fg[g * I + i] : 0.f;
  }
  for (int t = threadIdx.x; t < kTcGuard; t += blockDim.x) stg[2 * n + t] = 0.f;
}

// The chain over all grid chunks; called by every thread of the block
// (kTcThreads), with X and Y complete in shared memory. Writes rows 0..I-1
// of OF and OB (row 0 of OF from row0F). OF/OB may alias X/Y: every read of
// X and Y ends before the last chunk's first barrier. act points at
// tc_act_floats(NCOL) floats: the activated grid of one chunk, saf and sab,
// each as TF32 hi and lo planes of [kGC][AS]. Starts with no barrier; the
// caller synchronises before reading OF/OB or rewriting X/Y or act.
//
// I0 > 0: I is I0, known when compiling, so the to-grid loop unrolls whole
// and the next k step's loads run ahead of this step's products. Where
// I0 - 1 is a multiple of 16 (I0 = 49 at lmax 6), the last row r = I0 - 1
// alone would fill a k step of the to-grid product and an m16 tile of the
// from-grid one: it is taken on the CUDA cores instead, in float32 (a
// rank-one update of the to-grid accumulators; the from-grid warps of the
// last m16 tile sum its one output row, a column a lane), which spares
// 1/7 of the to-grid and 1/4 of the from-grid mma work. I0 = 0: any I,
// every row through mma.
template <int NCOL, int I0>
__device__ void grid_chain_tc(const float* stg, int G, int I, const float* X, const float* Y,
                              int xs, float* act, float* OF, float* OB, const float* row0F) {
  constexpr int AS = tc_act_stride(NCOL);
  constexpr int PL = kGC * AS;  // one plane
  static_assert(kTcWarps == 16 && NCOL == 64 && kGC == 32,
                "the warp map below is for 16 warps, 64 columns, 32 grid points");
  const int S = tc_stride(I), Gp = pad_grid(G);
  const float* sfg = stg + Gp * S;
  constexpr bool kTail = I0 > 0 && (I0 - 1) % 16 == 0;  // row I0 - 1 on the CUDA cores
  constexpr int kTailRow = I0 - 1;
  // m16 tiles of the from-grid output and k steps of the to-grid product
  // that run through mma
  const int MT = kTail ? kTailRow / 16 : (I + 15) / 16;
  const int KS = kTail ? kTailRow / 8 : I0 > 0 ? (I0 + 7) / 8 : (I + 7) / 8;
  const int warp = threadIdx.x / 32;
  const int grp = tc::lane_grp(), tig = tc::lane_tig();
  uint32_t* saf = reinterpret_cast<uint32_t*>(act);  // hi plane, then lo plane
  uint32_t* sab = saf + 2 * PL;
  // to-grid: product tp (0: v = tg X, 1: u = fg Y) on grid rows 16 am ..
  // and n8 tiles 2 cq, 2 cq + 1 (the v and u warps of one (am, cq) hold
  // the same positions)
  const int tp = warp & 1, am = (warp >> 1) & 1, cq = warp >> 2;
  const float* ta = (tp == 0 ? stg : sfg) + 16 * am * S;
  const float* tb = (tp == 0 ? X : Y) + 16 * cq;
  // from-grid: product fp (0: OF = fg^T saf, 1: OB = tg^T sab) on m16 tile
  // fm and n8 tiles 4 fh .. 4 fh + 3
  const int fp = warp >> 3, fm = (warp >> 1) & 3, fh = warp & 1;
  const float* fa = (fp == 0 ? sfg : stg) + 16 * fm;
  const uint32_t* fb = (fp == 0 ? saf : sab) + 32 * fh;
  float acc[4][4];
  float tail = 0.f;  // the tail row's from-grid sum (warps of m16 tile MT)
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[n][r] = 0.f;

  for (int g0 = 0; g0 < Gp; g0 += kGC) {
    float v[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) v[n][r] = 0.f;
#pragma unroll
    for (int ks = 0; ks < (I0 > 0 ? KS : kMaxIp / 8); ++ks) {
      if (I0 == 0 && ks >= KS) break;
      const tc::FragA a = tc::frag_a_paired(ta + g0 * S + 8 * ks, S);
#pragma unroll
      for (int n = 0; n < 2; ++n)
        tc::mma3(v[n], a, tc::frag_b_paired(tb + 8 * ks * xs + 8 * n, xs));
    }
    if (kTail) {  // + the tail row's rank-one term, float32
      const float t0 = ta[(g0 + grp) * S + kTailRow], t1 = ta[(g0 + grp + 8) * S + kTailRow];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const float2 x = *reinterpret_cast<const float2*>(tb + kTailRow * xs + 8 * n + 2 * tig);
        v[n][0] = fmaf(t0, x.x, v[n][0]);
        v[n][1] = fmaf(t0, x.y, v[n][1]);
        v[n][2] = fmaf(t1, x.x, v[n][2]);
        v[n][3] = fmaf(t1, x.y, v[n][3]);
      }
    }
    // the activation: the v warp writes silu(v) (split) to saf and silu'(v)
    // to sab's lo plane; after the barrier the u warp of the same positions
    // multiplies it by u and writes the product (split) to sab
    const int off = (16 * am + grp) * AS + 16 * cq + 2 * tig;
    if (tp == 0) {
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // rows grp and grp + 8
          const int o = off + 8 * n + 8 * h * AS;
          float s0, s1, d0, d1;
          silu_and_grad(v[n][2 * h], s0, d0);
          silu_and_grad(v[n][2 * h + 1], s1, d1);
          uint2 hi, lo;
          tc::split(s0, hi.x, lo.x);
          tc::split(s1, hi.y, lo.y);
          *reinterpret_cast<uint2*>(saf + o) = hi;
          *reinterpret_cast<uint2*>(saf + PL + o) = lo;
          *reinterpret_cast<float2*>(sab + PL + o) = make_float2(d0, d1);
        }
    }
    __syncthreads();  // silu'(v) is in place
    if (tp == 1) {
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int o = off + 8 * n + 8 * h * AS;
          const float2 d = *reinterpret_cast<const float2*>(sab + PL + o);
          uint2 hi, lo;
          tc::split(d.x * v[n][2 * h], hi.x, lo.x);
          tc::split(d.y * v[n][2 * h + 1], hi.y, lo.y);
          *reinterpret_cast<uint2*>(sab + o) = hi;
          *reinterpret_cast<uint2*>(sab + PL + o) = lo;
        }
    }
    __syncthreads();  // the chunk's activated grid is complete
    if (kTail && fm == MT) {  // the tail row, column 32 fh + lane: float32 sums
      const uint32_t* b = fb + (threadIdx.x & 31);
      const float* a = fa + g0 * S;  // fa is at column 16 fm = kTailRow
#pragma unroll 8
      for (int g = 0; g < kGC; ++g)
        tail = fmaf(a[g * S], __uint_as_float(b[g * AS]) + __uint_as_float(b[PL + g * AS]), tail);
    } else if (fm < MT) {
#pragma unroll
      for (int ks = 0; ks < kGC / 8; ++ks) {
        const tc::FragA a = tc::frag_a_trans(fa + (g0 + 8 * ks) * S, S);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const uint32_t* b = fb + 8 * ks * AS + 8 * n;
          tc::mma3(acc[n], a, tc::frag_b_split(b, b + PL, AS));
        }
      }
    }
    __syncthreads();  // the chunk's grid is consumed before the next one is written
  }

  float* out = fp == 0 ? OF : OB;
  if (kTail && fm == MT) {
    out[kTailRow * xs + 32 * fh + (threadIdx.x & 31)] = tail;
    return;
  }
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const int c = 32 * fh + 8 * n + 2 * tig;
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows grp and grp + 8 of the m16 tile
      const int i = 16 * fm + grp + 8 * h;
      if (i >= I) continue;
      float2 val = make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
      if (fp == 0 && i == 0) val = make_float2(row0F[c], row0F[c + 1]);
      *reinterpret_cast<float2*>(out + i * xs + c) = val;
    }
  }
}

}  // namespace singa
