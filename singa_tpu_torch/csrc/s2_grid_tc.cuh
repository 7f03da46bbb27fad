// The sphere-grid chains on the tensor cores: grid_chain_tc, K4b's float32
// chain (csrc/so3_ffn_bwd.cu), grid_chain_tc_fwd, K4's (csrc/so3_ffn.cu) and
// K3's (csrc/s2_act.cu) and K5's, and grid_chain_tc_sep_bwd, K3b's and K5b's,
// all built on split-TF32 mma.sync (csrc/mma_tf32.cuh) accumulated in
// float32, the last two also at bfloat16 storage, one TF32 product a
// product (the bfloat16 instances of K3 and K3b, and K6·bf16's and
// K6b·bf16's grid stages, csrc/so2_chain.cuh); and grid_chain_mma16_bwd,
// K4b·bf16's, and grid_chain_mma16_fwd, K4·bf16's, on bfloat16 m16n8k16
// mma.sync (csrc/mma_bf16.cuh), at the end of the file. s2_grid.cuh keeps
// the CUDA-core chain of K5's and K5b's CUDA-core instance and of K4's.
//
// grid_chain_tc: the function of s2_grid.cuh's grid_chain<NCOL, true,
// true, true>, with its four products as split TF32.
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

#include "mma_bf16.cuh"
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

// tg/fg [G, I] in device memory (T: float, or bfloat16 values staged as
// float) -> stg/sfg [Gp][S] (sfg = stg + Gp * S), then the guard.
template <class T = float>
__device__ inline void stage_grid_mats_tc(const T* __restrict__ tg, const T* __restrict__ fg,
                                          int G, int I, float* stg) {
  const int S = tc_stride(I), n = pad_grid(G) * S;
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    const int g = t / S, i = t % S;
    const bool in = g < G && i < I;
    stg[t] = in ? to_f(tg[g * I + i]) : 0.f;
    stg[n + t] = in ? to_f(fg[g * I + i]) : 0.f;
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
      for (int n = 0; n < 2; ++n) tc::mma3(v[n], a, tc::frag_b_paired(tb + 8 * ks * xs + 8 * n, xs));
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

// grid_chain_tc_fwd: K4's chain, mid = fg^T silu(tg X), for one warp's
// columns (kCT tiles of 16), with no barrier and no shared-memory round trip
// of the activated grid.
//
// The to-grid product is formed transposed, v^T = X^T tg^T (M = 16 columns
// a tile, N = 8 grid points, K = I in steps of 8, k paired). Its C
// fragment holds, in each lane, v at columns grp and grp + 8 of the tile
// and grid points 2 tig and 2 tig + 1 of the step: exactly the lane's B
// fragments (k = grid point, paired; n = column) of the from-grid product
// mid += fg^T silu(v) over the step's 8 grid points for the tile's two n8
// column tiles. So silu and the split run on the accumulators in
// registers and feed the from-grid mma at once. A warp walks its grid
// steps s0 .. s1 - 1 (8 points each), kSteps at a time, with the
// from-grid sums of its columns for every output row in registers (MT m16
// tiles x 2 kCT n8 tiles); the caller adds the sums of warps that took
// other steps of the same columns. Each split fragment feeds several mma:
// X's (k step, tile) the to-grid products of kSteps steps, tg's (step, k
// step) those of kCT tiles, fg's (step, m16 tile) the from-grid products
// of 2 kCT n8 tiles.
//
// Operands: X^T comes already split, in fragment order (xfrag: for k step
// ks and 16-column group cg, one fragment of frag_a_split's layout holding
// the lane's a0..a3 of frag_a_paired's, the groups of k step ks after those
// of ks - 1), written once per hidden chunk by the caller; tg [g][st] is
// read as B (frag_b_nk's 8-byte load, split as it loads; st % 32 of 8 or
// 24), fg [g][sf] as A transposed with k paired (four 4-byte loads a tile,
// split as they load; sf % 16 of 4 or 12: both conflict-free). Grid points
// past G are zero rows of tg and fg and add nothing.
//
// I0 = 49 (lmax 6): the last row r = 48 alone would fill a k step of the
// to-grid product and an m16 tile of the from-grid one, so it runs in
// float32 on the CUDA cores, as in grid_chain_tc: a rank-one update of v
// from X's row r (xtail, float32, unsplit), and the lane's share of output
// row r from the split activations (hi + lo) in tail[j] (column grp of n8
// tile j), which the caller sums over the four lanes of a column. I0 = 0:
// any I <= 8 kMaxKS, every row through mma (rows I .. 8 KS - 1 of xfrag
// zero, columns I .. 16 MT - 1 of fg zero). kMaxKS and kMaxMT bound the
// k steps and m16 tiles the loops unroll over (K3, and K5 at I <= 32: 4
// and 2; K5 at 33 <= I <= 48: 6 and 3).
//
// T (float by default) is the storage type of the caller's data. At T =
// bf16 (K3's bfloat16 instance and K6·bf16's grid stage, I0 = 0) X^T's
// fragments hold the hi plane alone (tc::kFragWords<T> words), each
// product is one TF32 mma.sync (tc::mma_t), and every operand is rounded
// to bfloat16 as it splits (tc::split_t): the identity on tg and fg,
// bfloat16 values staged as float, and on silu(v) the Pallas kernel's
// .astype(dt) before the from-grid product; the sums stay float32. The
// tail row then reads the same values: xtail, tg and fg bfloat16 values
// (as float) and silu(v) as its hi plane (lo = 0), so its float32 sums are
// those of the mma rows.
constexpr int kFwdMaxKS = 6;                // k steps of the to-grid product
constexpr int kFwdMaxMT = 3;                // m16 tiles of the from-grid output

// fg's stride in grid_chain_tc_fwd (and tg's read as A in
// grid_chain_tc_sep_bwd): >= rows, % 16 of 4 or 12, so the from-grid
// product's A loads are conflict-free
__host__ __device__ inline int tc_fg_stride(int rows) {
  int s = (rows + 3) / 4 * 4;
  while (s % 16 != 4 && s % 16 != 12) s += 4;
  return s;
}

// silu by the fast intrinsics, as silu_and_grad
__device__ __forceinline__ float silu_fast(float v) {
  return v * __fdividef(1.f, 1.f + __expf(-v));
}

// silu'(v) by the fast intrinsics, as silu_and_grad
__device__ __forceinline__ float silu_grad_fast(float v) {
  const float sg = __fdividef(1.f, 1.f + __expf(-v));
  return sg * (1.f + v * (1.f - sg));
}

template <int I0, int kSteps, int kCT, int kMaxKS = kFwdMaxKS, int kMaxMT = kFwdMaxMT,
          class T = float>
__device__ __forceinline__ void grid_chain_tc_fwd(const float* stg, int st, const float* sfg,
                                                  int sf, const uint32_t* xfrag,
                                                  const float* xtail, int I, int groups, int cg,
                                                  int s0, int s1,
                                                  float (&acc)[kMaxMT][2 * kCT][4],
                                                  float (&tail)[2 * kCT]) {
  constexpr bool kTail = I0 == 49;
  constexpr int kTailRow = I0 - 1;
  static_assert(I0 == 0 || I0 == 49, "I0 is 49 (the tail row) or 0 (I <= 48)");
  static_assert(!kTail || (kMaxKS >= kTailRow / 8 && kMaxMT >= kTailRow / 16),
                "the tail row's k steps and m16 tiles fit the loops");
  constexpr int FW = tc::kFragWords<T>;  // words of one X^T fragment
  const int KS = kTail ? kTailRow / 8 : (I + 7) / 8;
  const int MT = kTail ? kTailRow / 16 : (I + 15) / 16;
  const int grp = tc::lane_grp(), tig = tc::lane_tig();
  // the fragment of (k step ks, the warp's column group c) at + ks kstep + c
  const uint32_t* xf = xfrag + kCT * cg * FW;
  const int kstep = groups * FW;
  const float* xt = xtail + 16 * kCT * cg + grp;  // X's tail row, column grp of n8 tile j: xt[8 j]
#pragma unroll
  for (int mt = 0; mt < kMaxMT; ++mt)
#pragma unroll
    for (int j = 0; j < 2 * kCT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][j][q] = 0.f;
#pragma unroll
  for (int j = 0; j < 2 * kCT; ++j) tail[j] = 0.f;

  for (int s = s0; s < s1; s += kSteps) {
    // steps s .. s + kSteps - 1: grid points g0 + 8 u .. + 7 of step u
    const int g0 = 8 * s;
    float v[kSteps][kCT][4];
#pragma unroll
    for (int u = 0; u < kSteps; ++u)
#pragma unroll
      for (int c = 0; c < kCT; ++c)
#pragma unroll
        for (int q = 0; q < 4; ++q) v[u][c][q] = 0.f;
    const float* tb = stg + (g0 + grp) * st + 2 * tig;
#pragma unroll
    for (int ks = 0; ks < kMaxKS; ++ks) {
      if (kTail || ks < KS) {
        tc::FragA a[kCT];
#pragma unroll
        for (int c = 0; c < kCT; ++c)
          a[c] = tc::frag_a_split_t<T>(xf + ks * kstep + c * FW);
#pragma unroll
        for (int u = 0; u < kSteps; ++u) {
          const float2 t = *reinterpret_cast<const float2*>(tb + 8 * u * st + 8 * ks);
          tc::FragB b;
          tc::split_t<T>(t.x, b.hi[0], b.lo[0]);
          tc::split_t<T>(t.y, b.hi[1], b.lo[1]);
#pragma unroll
          for (int c = 0; c < kCT; ++c) tc::mma_t<T>(v[u][c], a[c], b);
        }
      }
    }
    // step by step (so that one step's activations are live at a time):
    // silu, split: the from-grid B of n8 tile 2 c (column grp of tile c)
    // from v[u][c][0], v[u][c][1], of tile 2 c + 1 (column grp + 8) from
    // v[u][c][2], v[u][c][3]; then the from-grid products, A = fg^T (m =
    // row i, k = grid point, paired)
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const int gu = g0 + 8 * u + 2 * tig;  // the lane's grid points gu, gu + 1
      if (kTail) {  // + the tail row's rank-one term, float32
        const float t0 = stg[gu * st + kTailRow], t1 = stg[(gu + 1) * st + kTailRow];
#pragma unroll
        for (int c = 0; c < kCT; ++c) {
          const float x0 = xt[16 * c], x1 = xt[16 * c + 8];  // read here: no registers held
          v[u][c][0] = fmaf(x0, t0, v[u][c][0]);
          v[u][c][1] = fmaf(x0, t1, v[u][c][1]);
          v[u][c][2] = fmaf(x1, t0, v[u][c][2]);
          v[u][c][3] = fmaf(x1, t1, v[u][c][3]);
        }
      }
      tc::FragB b[2 * kCT];
#pragma unroll
      for (int j = 0; j < 2 * kCT; ++j)
#pragma unroll
        for (int p = 0; p < 2; ++p)
          tc::split_t<T>(silu_fast(v[u][j >> 1][2 * (j & 1) + p]), b[j].hi[p], b[j].lo[p]);
      if (kTail) {  // the tail row's share, float32, from the split activations
        const float f0 = sfg[gu * sf + kTailRow], f1 = sfg[(gu + 1) * sf + kTailRow];
#pragma unroll
        for (int j = 0; j < 2 * kCT; ++j) {
          tail[j] = fmaf(f0, __uint_as_float(b[j].hi[0]) + __uint_as_float(b[j].lo[0]), tail[j]);
          tail[j] = fmaf(f1, __uint_as_float(b[j].hi[1]) + __uint_as_float(b[j].lo[1]), tail[j]);
        }
      }
#pragma unroll
      for (int mt = 0; mt < kMaxMT; ++mt) {
        if (kTail || mt < MT) {
          const float* p = sfg + gu * sf + 16 * mt + grp;
          tc::FragA a;
          tc::split_t<T>(p[0], a.hi[0], a.lo[0]);        // row grp,     point 2 tig
          tc::split_t<T>(p[8], a.hi[1], a.lo[1]);        // row grp + 8, point 2 tig
          tc::split_t<T>(p[sf], a.hi[2], a.lo[2]);       // row grp,     point 2 tig + 1
          tc::split_t<T>(p[sf + 8], a.hi[3], a.lo[3]);   // row grp + 8, point 2 tig + 1
#pragma unroll
          for (int j = 0; j < 2 * kCT; ++j) tc::mma_t<T>(acc[mt][j], a, b[j]);
        }
      }
    }
  }
}

// grid_chain_tc_sep_bwd: K3b's chain, dx = tg^T (silu'(tg X) * fg' Y) with
// fg' = fg with column 0 zeroed (row 0 of the cotangent Y reaches only the
// scalars), and K5b's, the same with fg' = fg, for one warp's columns (kCT
// tiles of 16), in
// grid_chain_tc_fwd's transposed form: two to-grid products, v^T = X^T
// tg^T and u^T = Y^T fg'^T, leave v and u at the same positions of every
// lane (columns grp and grp + 8 of a tile, grid points 2 tig and 2 tig + 1
// of a step), so h = silu'(v) u is formed and split in registers and feeds
// the from-grid product dx += tg^T h at once as its B fragments: no
// barrier, and the activated grid never reaches shared memory.
//
// Operands: X^T and Y^T split in fragment order (xfrag, yfrag: k step ks,
// 16-column group c at (ks groups + c) kSplitFragWords), rows I .. 8 KS - 1
// zero; tg [g][st] and fg' [g][st] read as B (8-byte loads, st % 32 of 8 or
// 24), tg again as [g][sa] read as A transposed (sa % 16 of 4 or 12, zero
// past I: the from-grid product's rows; sta may be stg itself, with sa =
// st, where staging tg once keeps more warps a block: its loads then meet
// 2-way bank conflicts). Walks grid steps s0 .. s1 - 1, kSteps at a time;
// acc[mt][j] holds dx rows 16 mt + grp (+ 8) of n8 column tile j.
//
// I0 = 49 (K5b at lmax 6), as in grid_chain_tc_fwd: row r = 48 runs in
// float32 on the CUDA cores, a rank-one update of v from X's row r and of
// u from Y's (xtail, ytail: the warp's columns of the two rows, float32,
// unsplit) and the lane's share of dx row r, sum over its grid points of
// tg[g, r] h (h in float32, unsplit), in tail[j] (column grp of n8 tile
// j), which the caller sums over the four lanes of a column. I0 = 0: any
// I <= 8 kMaxKS, every row through mma; the tail arguments go unread.
// T as in grid_chain_tc_fwd (K3b's bfloat16 instance: h = silu'(v) u is
// rounded to bfloat16 as it splits, the Pallas kernel's .astype(dt)
// before dx's product).
template <int kSteps, int kCT, int kMaxKS, int kMaxMT, int I0 = 0, class T = float>
__device__ __forceinline__ void grid_chain_tc_sep_bwd(const float* stg, const float* sfg, int st,
                                                      const float* sta, int sa,
                                                      const uint32_t* xfrag,
                                                      const uint32_t* yfrag, int I, int groups,
                                                      int s0, int s1,
                                                      float (&acc)[kMaxMT][2 * kCT][4],
                                                      const float* xtail = nullptr,
                                                      const float* ytail = nullptr,
                                                      float* tail = nullptr) {
  constexpr bool kTail = I0 == 49;
  constexpr int kTailRow = I0 - 1;
  static_assert(I0 == 0 || I0 == 49, "I0 is 49 (the tail row) or 0");
  static_assert(!kTail || (kMaxKS == kTailRow / 8 && kMaxMT == kTailRow / 16),
                "the loops are the rows before the tail row");
  static_assert(!kTail || !tc::kIsBf16<T>, "the tail row is float32's");
  constexpr int FW = tc::kFragWords<T>;  // words of one X^T or Y^T fragment
  const int KS = kTail ? kTailRow / 8 : (I + 7) / 8;
  const int MT = kTail ? kTailRow / 16 : (I + 15) / 16;
  const int grp = tc::lane_grp(), tig = tc::lane_tig();
  const int kstep = groups * FW;
  if (kTail) {
#pragma unroll
    for (int j = 0; j < 2 * kCT; ++j) tail[j] = 0.f;
  }
#pragma unroll
  for (int mt = 0; mt < kMaxMT; ++mt)
#pragma unroll
    for (int j = 0; j < 2 * kCT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][j][q] = 0.f;

  for (int s = s0; s < s1; s += kSteps) {
    const int g0 = 8 * s;
    float v[kSteps][kCT][4], u[kSteps][kCT][4];
#pragma unroll
    for (int w = 0; w < kSteps; ++w)
#pragma unroll
      for (int c = 0; c < kCT; ++c)
#pragma unroll
        for (int q = 0; q < 4; ++q) v[w][c][q] = u[w][c][q] = 0.f;
    const int tb = (g0 + grp) * st + 2 * tig;
#pragma unroll
    for (int ks = 0; ks < kMaxKS; ++ks) {
      if (kTail || ks < KS) {
        tc::FragA a[kCT];
#pragma unroll
        for (int c = 0; c < kCT; ++c)
          a[c] = tc::frag_a_split_t<T>(xfrag + ks * kstep + c * FW);
#pragma unroll
        for (int w = 0; w < kSteps; ++w) {
          const float2 t = *reinterpret_cast<const float2*>(stg + tb + 8 * w * st + 8 * ks);
          tc::FragB b;
          tc::split_t<T>(t.x, b.hi[0], b.lo[0]);
          tc::split_t<T>(t.y, b.hi[1], b.lo[1]);
#pragma unroll
          for (int c = 0; c < kCT; ++c) tc::mma_t<T>(v[w][c], a[c], b);
        }
#pragma unroll
        for (int c = 0; c < kCT; ++c)
          a[c] = tc::frag_a_split_t<T>(yfrag + ks * kstep + c * FW);
#pragma unroll
        for (int w = 0; w < kSteps; ++w) {
          const float2 t = *reinterpret_cast<const float2*>(sfg + tb + 8 * w * st + 8 * ks);
          tc::FragB b;
          tc::split_t<T>(t.x, b.hi[0], b.lo[0]);
          tc::split_t<T>(t.y, b.hi[1], b.lo[1]);
#pragma unroll
          for (int c = 0; c < kCT; ++c) tc::mma_t<T>(u[w][c], a[c], b);
        }
      }
    }
    // step by step: h = silu'(v) u, split: the from-grid B of n8 tile 2 c
    // from [w][c][0..1], of tile 2 c + 1 from [w][c][2..3] (as in
    // grid_chain_tc_fwd); then dx += tg^T h, A = tg^T (m = row j, k = grid
    // point, paired)
#pragma unroll
    for (int w = 0; w < kSteps; ++w) {
      const int gu = g0 + 8 * w + 2 * tig;  // the lane's grid points gu, gu + 1
      float t0 = 0.f, t1 = 0.f;             // tg[gu, r], tg[gu + 1, r] (the tail row)
      if (kTail) {  // + the tail row's rank-one terms, float32
        t0 = stg[gu * st + kTailRow];
        t1 = stg[(gu + 1) * st + kTailRow];
        const float f0 = sfg[gu * st + kTailRow], f1 = sfg[(gu + 1) * st + kTailRow];
#pragma unroll
        for (int c = 0; c < kCT; ++c) {
          const float x0 = xtail[16 * c + grp], x1 = xtail[16 * c + grp + 8];
          const float y0 = ytail[16 * c + grp], y1 = ytail[16 * c + grp + 8];
          v[w][c][0] = fmaf(x0, t0, v[w][c][0]);
          v[w][c][1] = fmaf(x0, t1, v[w][c][1]);
          v[w][c][2] = fmaf(x1, t0, v[w][c][2]);
          v[w][c][3] = fmaf(x1, t1, v[w][c][3]);
          u[w][c][0] = fmaf(y0, f0, u[w][c][0]);
          u[w][c][1] = fmaf(y0, f1, u[w][c][1]);
          u[w][c][2] = fmaf(y1, f0, u[w][c][2]);
          u[w][c][3] = fmaf(y1, f1, u[w][c][3]);
        }
      }
      tc::FragB b[2 * kCT];
#pragma unroll
      for (int j = 0; j < 2 * kCT; ++j)
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int q = 2 * (j & 1) + p;
          const float h = silu_grad_fast(v[w][j >> 1][q]) * u[w][j >> 1][q];
          if (kTail) tail[j] = fmaf(p == 0 ? t0 : t1, h, tail[j]);  // dx row r's share
          tc::split_t<T>(h, b[j].hi[p], b[j].lo[p]);
        }
#pragma unroll
      for (int mt = 0; mt < kMaxMT; ++mt) {
        if (kTail || mt < MT) {
          const float* p = sta + gu * sa + 16 * mt + grp;
          tc::FragA a;
          tc::split_t<T>(p[0], a.hi[0], a.lo[0]);        // row grp,     point 2 tig
          tc::split_t<T>(p[8], a.hi[1], a.lo[1]);        // row grp + 8, point 2 tig
          tc::split_t<T>(p[sa], a.hi[2], a.lo[2]);       // row grp,     point 2 tig + 1
          tc::split_t<T>(p[sa + 8], a.hi[3], a.lo[3]);   // row grp + 8, point 2 tig + 1
#pragma unroll
          for (int j = 0; j < 2 * kCT; ++j) tc::mma_t<T>(acc[mt][j], a, b[j]);
        }
      }
    }
  }
}

// grid_chain_mma16_bwd: K4b·bf16's chain (csrc/so3_ffn_bwd.cu), the
// function of grid_chain_tc at bfloat16, for one warp's 16 columns:
//   mid = fg^T silu(v),  dh = tg^T (silu'(v) u),  v = tg X,  u = fg Y,
// silu(v) and h = silu'(v) u rounded to bfloat16 before their from-grid
// products (the Pallas kernel's .astype(dt)), every sum float32, every
// product a bfloat16 m16n8k16 mma.sync (csrc/mma_bf16.cuh), with no
// barrier and no shared-memory round trip of the activated grid.
//
// Both to-grid products are formed transposed, v^T = X^T tg^T and u^T =
// Y^T fg^T (M = the warp's 16 columns, N = 8 grid points, K = rows in
// steps of 16), so v and u sit at the same lane positions (columns grp and
// grp + 8, grid points 2 tig and 2 tig + 1 of an 8-point half). A k16 grid
// step forms both halves; silu(v) and h are formed in registers, rounded
// and packed as bfloat16 pairs, and the pairs of the two halves are at
// once the B fragments (k = the step's 16 grid points, n = a column) of
// the from-grid products mid += fg^T silu(v) and dh += tg^T h over the n8
// tiles of columns 0-7 and 8-15 (mma_bf16.cuh). The warp holds both
// output sets of its columns in registers: om (mid) and od (dh) [m16 tile
// mt][n8 tile j], rows 16 mt + grp (+ 8), columns 8 j + 2 tig (+ 1).
//
// Operands: xs, ys: X^T and Y^T as bfloat16 [16 columns][S] (h^T and
// dmid^T, the warp's columns; rows past I zero), read by ldmatrix as the
// to-grid A (m = column, k = row) at each grid step: held in registers
// over the chain they spilled (284 bytes at I <= 48, 508 at I 49: 128
// registers a thread at 16 warps, ptxas on sm_90a); stg, sfg: tg and fg
// as bfloat16 [Gp][S] (S % 16 of 8: odd in
// 16-byte units, so every ldmatrix phase is conflict-free; zero past G and
// I), read as the to-grid B (ldmatrix) and as the from-grid A (ldmatrix
// .trans: fg^T, tg^T, m = row, k = grid point). The warp walks k16 grid
// steps s0 .. s1 - 1; the caller adds the sums of warps that took other
// steps of the same columns.
//
// I0 = 49 (lmax 6): rows 0 .. 47 through mma (3 k16 steps, 3 m16 tiles),
// row 48 in float32 on the CUDA cores, as grid_chain_tc's: a rank-one
// update of v and u from X's and Y's row 48 at the lane's columns (grp,
// grp + 8), and the lane's share of mid's and
// dh's row 48 from the same rounded activations (tm[j], td[j]: column grp
// of n8 tile j), which the caller sums over the four lanes of a column.
// I0 = 0: KS = MT k16 steps and m16 tiles of I <= 48 rows.
template <int I0>
__device__ __forceinline__ void grid_chain_mma16_bwd(const bf16* stg, const bf16* sfg, int S,
                                                     const bf16* xs, const bf16* ys, int KS,
                                                     int MT, int s0, int s1,
                                                     float (&om)[3][2][4], float (&od)[3][2][4],
                                                     float (&tm)[2], float (&td)[2]) {
  constexpr bool kTail = I0 == 49;
  constexpr int kTailRow = I0 - 1;
  static_assert(I0 == 0 || I0 == 49, "I0 is 49 (the tail row) or 0 (I <= 48)");
  const int grp = tc::lane_grp(), tig = tc::lane_tig();
  float xt0 = 0.f, xt1 = 0.f, yt0 = 0.f, yt1 = 0.f;  // row 48 at the lane's columns
  if (kTail) {
    xt0 = to_f(xs[grp * S + kTailRow]);
    xt1 = to_f(xs[(grp + 8) * S + kTailRow]);
    yt0 = to_f(ys[grp * S + kTailRow]);
    yt1 = to_f(ys[(grp + 8) * S + kTailRow]);
  }
#pragma unroll
  for (int mt = 0; mt < 3; ++mt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) om[mt][j][q] = od[mt][j][q] = 0.f;
#pragma unroll
  for (int j = 0; j < 2; ++j) tm[j] = td[j] = 0.f;

  for (int s = s0; s < s1; ++s) {
    const bf16* gt = stg + 16 * s * S;  // the step's 16 grid rows
    const bf16* gf = sfg + 16 * s * S;
    float v[2][4], u[2][4];  // [half: points 8 h ..][C fragment]
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = 0; q < 4; ++q) v[h][q] = u[h][q] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 3; ++ks) {
      if (kTail || ks < KS) {
        uint32_t a[4], b[4];  // X^T's or Y^T's A; the two halves' B
        mma16::ldmatrix_x4(a, mma16::a_addr<false>(xs + 16 * ks, S));
        mma16::ldmatrix_x4(b, mma16::b_addr<false>(gt + 16 * ks, S));
        const uint32_t t0[2] = {b[0], b[1]}, t1[2] = {b[2], b[3]};
        mma16::mma(v[0], a, t0);
        mma16::mma(v[1], a, t1);
        mma16::ldmatrix_x4(a, mma16::a_addr<false>(ys + 16 * ks, S));
        mma16::ldmatrix_x4(b, mma16::b_addr<false>(gf + 16 * ks, S));
        const uint32_t f0[2] = {b[0], b[1]}, f1[2] = {b[2], b[3]};
        mma16::mma(u[0], a, f0);
        mma16::mma(u[1], a, f1);
      }
    }
    float tr[2][2] = {}, fr[2][2] = {};  // tg, fg at row 48 of the lane's points 8 h + 2 tig + p
    if (kTail) {  // + the tail row's rank-one terms, float32
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int g = 8 * h + 2 * tig + p;
          tr[h][p] = to_f(gt[g * S + kTailRow]);
          fr[h][p] = to_f(gf[g * S + kTailRow]);
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        v[h][0] = fmaf(xt0, tr[h][0], v[h][0]);
        v[h][1] = fmaf(xt0, tr[h][1], v[h][1]);
        v[h][2] = fmaf(xt1, tr[h][0], v[h][2]);
        v[h][3] = fmaf(xt1, tr[h][1], v[h][3]);
        u[h][0] = fmaf(yt0, fr[h][0], u[h][0]);
        u[h][1] = fmaf(yt0, fr[h][1], u[h][1]);
        u[h][2] = fmaf(yt1, fr[h][0], u[h][2]);
        u[h][3] = fmaf(yt1, fr[h][1], u[h][3]);
      }
    }
    // silu(v) and h, rounded, as the from-grid B of n8 tile j (columns 8 j
    // + grp): register h from the h-th half's C values 2 j, 2 j + 1
    uint32_t bm[2][2], bd[2][2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float s0v, s1v, d0, d1;
        silu_and_grad(v[h][2 * j], s0v, d0);
        silu_and_grad(v[h][2 * j + 1], s1v, d1);
        bm[j][h] = mma16::pack(s0v, s1v);
        bd[j][h] = mma16::pack(d0 * u[h][2 * j], d1 * u[h][2 * j + 1]);
        if (kTail) {  // row 48's shares from the same rounded values
          tm[j] = fmaf(fr[h][0], mma16::lo_f(bm[j][h]), tm[j]);
          tm[j] = fmaf(fr[h][1], mma16::hi_f(bm[j][h]), tm[j]);
          td[j] = fmaf(tr[h][0], mma16::lo_f(bd[j][h]), td[j]);
          td[j] = fmaf(tr[h][1], mma16::hi_f(bd[j][h]), td[j]);
        }
      }
#pragma unroll
    for (int mt = 0; mt < 3; ++mt) {
      if (kTail || mt < MT) {
        uint32_t a[4];
        mma16::ldmatrix_x4_trans(a, mma16::a_addr<true>(gf + 16 * mt, S));
        mma16::mma(om[mt][0], a, bm[0]);
        mma16::mma(om[mt][1], a, bm[1]);
        mma16::ldmatrix_x4_trans(a, mma16::a_addr<true>(gt + 16 * mt, S));
        mma16::mma(od[mt][0], a, bd[0]);
        mma16::mma(od[mt][1], a, bd[1]);
      }
    }
  }
}


// grid_chain_mma16_fwd: K4·bf16's chain (csrc/so3_ffn.cu), the function of
// grid_chain_tc_fwd at bfloat16, for one warp's 16 columns:
//   mid = fg^T silu(v),  v = tg X,
// silu(v) rounded to bfloat16 before the from-grid product (the Pallas
// kernel's .astype(dt)), every sum float32, every product a bfloat16
// m16n8k16 mma.sync (csrc/mma_bf16.cuh), with no barrier and no
// shared-memory round trip of the activated grid.
//
// The to-grid product is formed transposed, v^T = X^T tg^T (M = the warp's
// 16 columns, N = 8 grid points, K = rows in steps of 16), as in
// grid_chain_mma16_bwd: a k16 grid step forms both 8-point halves, and
// silu(v) of the two halves, rounded and packed as bfloat16 pairs, is at
// once the from-grid product's B fragment (k = the step's 16 grid points,
// n = a column) for the n8 tiles of columns 0-7 and 8-15. The warp holds
// mid of its columns in registers: om [m16 tile mt][n8 tile j], rows 16 mt
// + grp (+ 8), columns 8 j + 2 tig (+ 1).
//
// Operands: xs: X (the rounded hidden h) as bfloat16 [rows][xs_ld] at the
// warp's first column (rows past I zero; xs_ld in 16-byte units odd),
// read by ldmatrix .trans as the to-grid A (m = column, k = row) once, the
// KS fragments then held in registers over the chain; stg, sfg: tg and fg
// as bfloat16 [Gp][S] (S in 16-byte units odd; zero past G and I), read as
// the to-grid B (ldmatrix) and as the from-grid A (ldmatrix .trans: fg^T,
// m = row, k = grid point). The warp walks k16 grid steps s0 .. s1 - 1;
// the caller adds the sums of warps that took other steps of the same
// columns.
//
// I0 = 49 (lmax 6): rows 0 .. 47 through mma (3 k16 steps, 3 m16 tiles),
// row 48 in float32 on the CUDA cores, as in every chain: a rank-one update
// of v from X's row 48 at the lane's columns (grp, grp + 8), and the lane's
// share of mid's row 48 from the same rounded activations (tm[j]: column
// grp of n8 tile j), which the caller sums over the four lanes of a
// column. I0 = 0: KS k16 steps and m16 tiles of I <= 48 rows.
template <int I0>
__device__ __forceinline__ void grid_chain_mma16_fwd(const bf16* stg, const bf16* sfg, int S,
                                                     const bf16* xs, int xs_ld, int KS, int s0,
                                                     int s1, float (&om)[3][2][4],
                                                     float (&tm)[2]) {
  constexpr bool kTail = I0 == 49;
  constexpr int kTailRow = I0 - 1;
  static_assert(I0 == 0 || I0 == 49, "I0 is 49 (the tail row) or 0 (I <= 48)");
  const int grp = tc::lane_grp(), tig = tc::lane_tig();
  float xt0 = 0.f, xt1 = 0.f;  // row 48 at the lane's columns
  if (kTail) {
    xt0 = to_f(xs[kTailRow * xs_ld + grp]);
    xt1 = to_f(xs[kTailRow * xs_ld + grp + 8]);
  }
  uint32_t xa[3][4];  // X^T's A fragments, k16 steps of rows
#pragma unroll
  for (int ks = 0; ks < 3; ++ks)
    if (kTail || ks < KS)
      mma16::ldmatrix_x4_trans(xa[ks], mma16::a_addr<true>(xs + 16 * ks * xs_ld, xs_ld));
#pragma unroll
  for (int mt = 0; mt < 3; ++mt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) om[mt][j][q] = 0.f;
#pragma unroll
  for (int j = 0; j < 2; ++j) tm[j] = 0.f;

  for (int s = s0; s < s1; ++s) {
    const bf16* gt = stg + 16 * s * S;  // the step's 16 grid rows
    const bf16* gf = sfg + 16 * s * S;
    float v[2][4];  // [half: points 8 h ..][C fragment]
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = 0; q < 4; ++q) v[h][q] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 3; ++ks) {
      if (kTail || ks < KS) {
        uint32_t b[4];  // the two halves' B
        mma16::ldmatrix_x4(b, mma16::b_addr<false>(gt + 16 * ks, S));
        const uint32_t t0[2] = {b[0], b[1]}, t1[2] = {b[2], b[3]};
        mma16::mma(v[0], xa[ks], t0);
        mma16::mma(v[1], xa[ks], t1);
      }
    }
    float fr[2][2] = {};  // fg at row 48 of the lane's points 8 h + 2 tig + p
    if (kTail) {  // + the tail row's rank-one term, float32
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int g = 8 * h + 2 * tig;
        const float t0 = to_f(gt[g * S + kTailRow]), t1 = to_f(gt[(g + 1) * S + kTailRow]);
        fr[h][0] = to_f(gf[g * S + kTailRow]);
        fr[h][1] = to_f(gf[(g + 1) * S + kTailRow]);
        v[h][0] = fmaf(xt0, t0, v[h][0]);
        v[h][1] = fmaf(xt0, t1, v[h][1]);
        v[h][2] = fmaf(xt1, t0, v[h][2]);
        v[h][3] = fmaf(xt1, t1, v[h][3]);
      }
    }
    // silu(v), rounded, as the from-grid B of n8 tile j (columns 8 j +
    // grp): register h from the h-th half's C values 2 j, 2 j + 1
    uint32_t bm[2][2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        bm[j][h] = mma16::pack(silu_fast(v[h][2 * j]), silu_fast(v[h][2 * j + 1]));
        if (kTail) {  // row 48's share from the same rounded values
          tm[j] = fmaf(fr[h][0], mma16::lo_f(bm[j][h]), tm[j]);
          tm[j] = fmaf(fr[h][1], mma16::hi_f(bm[j][h]), tm[j]);
        }
      }
#pragma unroll
    for (int mt = 0; mt < 3; ++mt) {
      if (kTail || mt < KS) {
        uint32_t a[4];
        mma16::ldmatrix_x4_trans(a, mma16::a_addr<true>(gf + 16 * mt, S));
        mma16::mma(om[mt][0], a, bm[0]);
        mma16::mma(om[mt][1], a, bm[1]);
      }
    }
  }
}

}  // namespace singa
