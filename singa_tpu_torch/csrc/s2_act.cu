// K3: separable S2 SiLU, forward; K3b: its backward. K5 / K5b: the S2 SiLU
// on all rows and its backward (at the end of the file).
//
// K3 replaces: singa_tpu/ops/pallas/s2_act.py::s2_silu_sep (_sep_fwd_kernel).
//   out[e, i, c] = sum_g fg[g, i] * silu(sum_j tg[g, j] * x[e, j, c])  (i >= 1)
//   out[e, 0, c] = silu(s[e, c])
// K3b replaces: s2_act.py::_sep_bwd (_sep_bwd_kernel).
//   ds[e, c]    = silu'(s[e, c]) * g[e, 0, c]
//   dx[e, j, c] = sum_g tg[g, j] * silu'(v_g) * sum_{i>=1} fg[g, i] * g[e, i, c]
//   with v_g = sum_j tg[g, j] * x[e, j, c]; row 0 of the cotangent reaches
//   only ds (it belongs to the scalar gate, not the S2 branch).
// x, g [E, I, C] (m-primary truncated edge features), s [E, C], tg/fg [G, I].
//
// What bounds them on the H100: at a training microbatch's stage-1 call (E =
// 31,744 edges, I = 29, C = 128, G = 70) K3 moves x in, out and s (0.96 GB,
// 0.29 ms at 3.35 TB/s) and does 32.4 GFLOP, K3b moves x, g, dx, s and ds
// (1.45 GB, 0.43 ms) and does 49.5 GFLOP. As split TF32 (three TF32
// products a product, 495 TFLOP/s) the arithmetic needs 0.20 and 0.30 ms:
// memory bounds both, and the arithmetic is not far behind.
//
// Design (s2_silu_sep_tc_kernel, s2_silu_sep_bwd_tc_kernel): the [E, G, C]
// grid never reaches device memory, as in the TPU kernel, and on the tensor
// cores it never reaches shared memory either. The columns are the flat
// (edge, channel) space, edge-major, so C = 128 channels of one edge are 128
// columns; a warp owns a tile of 16 kCT columns at a time (K3: 32, K3b:
// 16), with no barrier between warps after the block stages tg and fg once:
//   copy   the tile's I rows of x (K3b: and of g) by 16-byte cp.async into
//          the warp's raw stage [I][16 kCT + 4] (a stride % 16 of 4: the
//          split's reads are conflict-free; 32 or 128 would give 4-way
//          conflicts), zeros past E * C; the next tile's copy is issued as
//          soon as this one is split, so it runs under this tile's chain
//   split  the raw stage -> X^T (K3b: and Y^T) split into TF32 hi and lo in
//          the chains' A fragment order, once a tile (rows past I zero)
//   chain  K3: grid_chain_tc_fwd<0, 3, 2, 4, 2> (csrc/s2_grid_tc.cuh), K4's
//          chain: the to-grid product transposed (v^T = X^T tg^T), so
//          silu(v) is split in registers and fed at once as the from-grid
//          product's B; K3b: grid_chain_tc_sep_bwd, the same form with two
//          to-grid products (v^T = X^T tg^T, u^T = Y^T fg'^T, fg' = fg with
//          column 0 zeroed) whose fragments share their positions, so h =
//          silu'(v) u is formed, split and fed to dx += tg^T h in
//          registers. The grid is walked in steps of 8 points, three a
//          pass, G rounded up to 24 (72 at G = 70: two zero rows); the
//          output rows in two m16 tiles (I <= 32), k steps of 8 rows
//   store  the sums from registers as float2 pieces of whole rows; K3's row
//          0 is silu(s) in place of the chain's; K3b's ds from the raw
//          stage's g row 0, one column a lane
// Every product is three-product split TF32 (csrc/mma_tf32.cuh), float32
// to round-off. tg is staged twice in K3b: as B ([g][st], st % 32 of 8 or
// 24: the to-grid's 8-byte loads) and as A transposed ([g][sa], sa % 16 of
// 4 or 12: the from-grid's 4-byte loads); one stride cannot serve both
// without conflicts.
//
// Why this map (tools/bench_k3_variants.py times it against its variants
// on the card): both kernels are bound by latency and issue slots, not by
// the tensor cores or by memory, so the most warps an SM holds win. K3
// takes 16 warps of 32 columns (219,776 B of shared memory at I 29, G 70,
// one block an SM); 12 or 14 warps, or 8 warps of 64 columns, ran slower.
// K3b's warp keeps two raw stages and two fragment sets, so it takes 15
// warps of 16 columns (225,888 B), faster than 7 warps of 32 columns.
// Where the matrices leave room for fewer (K3b at I 32: 14), a block takes
// as many as fit (fit_warps), chosen by shape before the launch. One grid
// step a pass ran slower than three; so did, in builds not kept, all nine
// in K3b, fragments loaded straight from device memory without the
// cp.async stage, and tg and fg staged already split at the cost of two
// warps.
//
// Shapes: the tensor-core kernels take I <= 32, any G whose matrices fit
// in shared memory, and C a multiple of 16 (a 16-column group then lies in
// one edge, and each 16-byte copy in one row): lmax 6, 4 and 2 at mmax 2
// (I 29, 19, 9). Every other shape the CUDA-core kernels took (C = 100,
// say) runs them, chosen by shape before the launch (sep_instance).
#include "s2_grid.cuh"
#include "s2_grid_tc.cuh"

namespace {

constexpr int kMaxI = 32;  // coefficient rows K3 and K3b take

// ------------------------------ tensor cores -------------------------------
using singa::tc::kSplitFragWords;

constexpr int kSteps = 3;          // grid steps of 8 points a chain pass takes
constexpr int kSepKS = kMaxI / 8;  // k steps of the to-grid products
constexpr int kSepMT = kMaxI / 16; // m16 tiles of the from-grid output
constexpr int kFwdCT = 2;          // K3: 16-column groups of a warp tile
constexpr int kBwdCT = 1;          // K3b: the same
constexpr int kFwdWarps = 16;      // warps of a K3 block, at most
constexpr int kBwdWarps = 15;      // warps of a K3b block, at most

// a warp tile of kCT 16-column groups: its columns, and its raw stage's row
// stride (% 16 of 4: the split's reads are conflict-free)
template <int kCT> constexpr int kCols = 16 * kCT;
template <int kCT> constexpr int kRawStride = 16 * kCT + 4;

struct SepDims {
  int I, C, G, Gp, st, sa, KS;  // Gp: G rounded up to a chain pass; KS: k steps
  long long Q;                  // columns: E * C
};

SepDims make_sep_dims(long long E, int I, int C, int G) {
  SepDims d;
  d.I = I, d.C = C, d.G = G;
  d.Gp = (G + 8 * kSteps - 1) / (8 * kSteps) * (8 * kSteps);
  d.st = singa::tc_stride(I);
  d.sa = singa::tc_fg_stride(16 * ((I + 15) / 16));
  d.KS = (I + 7) / 8;
  d.Q = E * C;
  return d;
}

// warp tiles of kCT groups
template <int kCT>
__host__ __device__ inline long long tiles(const SepDims& d) {
  return (d.Q + kCols<kCT> - 1) / kCols<kCT>;
}

// floats of one warp's raw stage and words of its fragments, of one operand
template <int kCT>
__host__ __device__ inline int warp_floats(const SepDims& d) {
  return d.I * kRawStride<kCT> + d.KS * kCT * kSplitFragWords;
}

// floats of the staged matrices: K3's tg [Gp][st] and fg [Gp][sa]; K3b's
// tg [Gp][st], fg' [Gp][st] and tg [Gp][sa]
__host__ __device__ inline int fwd_mats(const SepDims& d) { return d.Gp * (d.st + d.sa); }
__host__ __device__ inline int bwd_mats(const SepDims& d) { return d.Gp * (2 * d.st + d.sa); }

// A tensor-core kernel's block: its warps, the most (up to max_warps) whose
// stages fit in a block's shared memory beside the matrices, and its
// shared memory; no warp: the shapes do not fit
struct TcLaunch {
  int warps;
  size_t smem;
};

TcLaunch fit_warps(size_t mats, size_t per_warp, int max_warps) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  int w = max_warps;
  while (w > 0 && (mats + w * per_warp) * sizeof(float) > (size_t)optin) --w;
  return {w, (mats + w * per_warp) * sizeof(float)};
}

TcLaunch fwd_launch(const SepDims& d) {
  return fit_warps(fwd_mats(d), warp_floats<kFwdCT>(d), kFwdWarps);
}

TcLaunch bwd_launch(const SepDims& d) {
  return fit_warps(bwd_mats(d), 2 * warp_floats<kBwdCT>(d), kBwdWarps);
}

// m [G, I] -> dst [Gp][stride], zeros past G and I and in columns < col0
__device__ void stage_mat(const float* __restrict__ m, const SepDims& d, int stride, int col0,
                          float* dst) {
  for (int t = threadIdx.x; t < d.Gp * stride; t += blockDim.x) {
    const int g = t / stride, i = t % stride;
    dst[t] = g < d.G && i < d.I && i >= col0 ? m[g * d.I + i] : 0.f;
  }
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// The offset in [E, I, C] of row 0 of column q0 + k (k < 32) of a
// warp tile whose first column is channel c0 of edge e0: no division a
// column (C >= 16, so k crosses at most two edges)
__device__ __forceinline__ long long col_offset(const SepDims& d, long long e0, int c0, int k) {
  int c = c0 + k;
  long long e = e0;
  while (c >= d.C) c -= d.C, ++e;
  return e * d.I * d.C + c;
}

// The warp tile at column q0 (channel c0 of edge e0) of x [E, I, C] -> raw
// [I][kRawStride], zeros past E * C; called by the 32 lanes of one warp,
// joins their next commit. A lane copies the same four columns of every
// (32 / kChunks)-th row.
template <int kCT>
__device__ __forceinline__ void copy_tile(const float* __restrict__ x, long long q0,
                                          const SepDims& d, float* raw) {
  constexpr int kChunks = kCols<kCT> / 4;  // 16-byte pieces of a row
  const int lane = threadIdx.x & 31, c4 = lane % kChunks;
  const long long e0 = q0 / d.C;
  const bool ok = q0 + 4 * c4 < d.Q;
  const float* src = x + col_offset(d, e0, (int)(q0 - e0 * d.C), 4 * c4);
  for (int j = lane / kChunks; j < d.I; j += 32 / kChunks)
    cp_async16(raw + j * kRawStride<kCT> + 4 * c4, ok ? src + (long long)j * d.C : x, ok);
}

// raw [I][kRawStride] -> X^T split, in the chains' fragment order ((ks kCT +
// c) kSplitFragWords for k step ks and 16-column group c), rows past I zero
template <int kCT>
__device__ __forceinline__ void split_tile(const float* raw, int I, int KS, uint32_t* frag) {
  constexpr int S = kRawStride<kCT>;
  const int lane = threadIdx.x & 31, col = lane >> 2;
#pragma unroll
  for (int ks = 0; ks < kSepKS; ++ks) {
    if (ks < KS) {
      const int i0 = 8 * ks + 2 * (lane & 3);
      const bool r0 = i0 < I, r1 = i0 + 1 < I;
#pragma unroll
      for (int c = 0; c < kCT; ++c) {
        const float* src = raw + i0 * S + 16 * c + col;
        singa::tc::store_a_split(frag + (ks * kCT + c) * kSplitFragWords, lane,
                                 r0 ? src[0] : 0.f, r0 ? src[8] : 0.f, r1 ? src[S] : 0.f,
                                 r1 ? src[S + 8] : 0.f);
      }
    }
  }
}

// The from-grid sums of a warp tile (acc[mt][j]: rows 16 mt + grp (+ 8) of
// n8 column tile j) -> out [E, I, C], float2 pieces of whole rows; row 0
// from row0 (K3: silu(s)) when it is not null
template <int kCT>
__device__ __forceinline__ void store_tile(const float (&acc)[kSepMT][2 * kCT][4], long long q0,
                                           const SepDims& d, const float* __restrict__ row0,
                                           float* __restrict__ out) {
  const int grp = singa::tc::lane_grp(), tig = singa::tc::lane_tig();
  const int MT = (d.I + 15) / 16;
  const long long e0 = q0 / d.C;
  const int c0 = (int)(q0 - e0 * d.C);
#pragma unroll
  for (int j = 0; j < 2 * kCT; ++j) {
    const long long q = q0 + 8 * j + 2 * tig;  // the lane's columns q, q + 1 (one edge)
    if (q >= d.Q) continue;
    float* o = out + col_offset(d, e0, c0, 8 * j + 2 * tig);
#pragma unroll
    for (int mt = 0; mt < kSepMT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 16 * mt + grp + 8 * h;
        if (mt >= MT || i >= d.I) continue;
        float2 v = make_float2(acc[mt][j][2 * h], acc[mt][j][2 * h + 1]);
        if (row0 != nullptr && i == 0) {
          const float2 sv = *reinterpret_cast<const float2*>(row0 + q);
          v = make_float2(singa::siluf_(sv.x), singa::siluf_(sv.y));
        }
        *reinterpret_cast<float2*>(o + (long long)i * d.C) = v;
      }
  }
}

__global__ void __launch_bounds__(32 * kFwdWarps, 1)
s2_silu_sep_tc_kernel(const float* __restrict__ x, const float* __restrict__ s,
                      const float* __restrict__ tg, const float* __restrict__ fg,
                      float* __restrict__ out, SepDims d) {
  extern __shared__ __align__(16) float smem[];
  float* stg = smem;                   // [Gp][st]: tg, read as B
  float* sfg = stg + d.Gp * d.st;      // [Gp][sa]: fg, read as A transposed
  const int warp = threadIdx.x >> 5;
  // the warp's raw stage and fragments
  float* raw = smem + fwd_mats(d) + warp * (warp_floats<kFwdCT>(d));
  uint32_t* frag = reinterpret_cast<uint32_t*>(raw + d.I * kRawStride<kFwdCT>);
  constexpr int W = kCols<kFwdCT>;
  const int warps = blockDim.x >> 5;
  const long long nw = (long long)gridDim.x * warps, nt = tiles<kFwdCT>(d);
  long long wt = (long long)blockIdx.x * warps + warp;
  if (wt < nt) copy_tile<kFwdCT>(x, wt * W, d, raw);
  cp_async_commit();
  stage_mat(tg, d, d.st, 0, stg);
  stage_mat(fg, d, d.sa, 0, sfg);
  __syncthreads();
  for (; wt < nt; wt += nw) {
    cp_async_wait_all();
    __syncwarp();  // the tile's raw stage; every lane is done with the last chain
    split_tile<kFwdCT>(raw, d.I, d.KS, frag);
    __syncwarp();  // the fragments; every lane is done with the raw stage
    if (wt + nw < nt) copy_tile<kFwdCT>(x, (wt + nw) * W, d, raw);
    cp_async_commit();
    float acc[kSepMT][2 * kFwdCT][4], tl[2 * kFwdCT];
    singa::grid_chain_tc_fwd<0, kSteps, kFwdCT, kSepKS, kSepMT>(
        stg, d.st, sfg, d.sa, frag, raw, d.I, kFwdCT, 0, 0, d.Gp / 8, acc, tl);
    store_tile<kFwdCT>(acc, wt * W, d, s, out);
  }
}

__global__ void __launch_bounds__(32 * kBwdWarps, 1)
s2_silu_sep_bwd_tc_kernel(const float* __restrict__ x, const float* __restrict__ s,
                          const float* __restrict__ gin, const float* __restrict__ tg,
                          const float* __restrict__ fg, float* __restrict__ dx,
                          float* __restrict__ ds, SepDims d) {
  extern __shared__ __align__(16) float smem[];
  float* stg = smem;                   // [Gp][st]: tg, read as B
  float* sfg = stg + d.Gp * d.st;      // [Gp][st]: fg', column 0 zeroed, read as B
  float* sta = sfg + d.Gp * d.st;      // [Gp][sa]: tg, read as A transposed
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int W = kCols<kBwdCT>;
  const int raw = d.I * kRawStride<kBwdCT>, frag = d.KS * kBwdCT * kSplitFragWords;
  float* rx = smem + bwd_mats(d) + warp * 2 * warp_floats<kBwdCT>(d);  // the warp's
  float* rg = rx + raw;
  uint32_t* fx = reinterpret_cast<uint32_t*>(rg + raw);
  uint32_t* fy = fx + frag;
  const int warps = blockDim.x >> 5;
  const long long nw = (long long)gridDim.x * warps, nt = tiles<kBwdCT>(d);
  long long wt = (long long)blockIdx.x * warps + warp;
  if (wt < nt) {
    copy_tile<kBwdCT>(x, wt * W, d, rx);
    copy_tile<kBwdCT>(gin, wt * W, d, rg);
  }
  cp_async_commit();
  stage_mat(tg, d, d.st, 0, stg);
  stage_mat(fg, d, d.st, 1, sfg);
  stage_mat(tg, d, d.sa, 0, sta);
  __syncthreads();
  for (; wt < nt; wt += nw) {
    const long long q0 = wt * W;
    cp_async_wait_all();
    __syncwarp();  // the tile's raw stages; every lane is done with the last chain
    split_tile<kBwdCT>(rx, d.I, d.KS, fx);
    split_tile<kBwdCT>(rg, d.I, d.KS, fy);
    if (lane < W && q0 + lane < d.Q)  // ds of the lane's column, from g's row 0
      ds[q0 + lane] = singa::silu_gradf_(s[q0 + lane]) * rg[lane];
    __syncwarp();  // the fragments; every lane is done with the raw stages
    if (wt + nw < nt) {
      copy_tile<kBwdCT>(x, (wt + nw) * W, d, rx);
      copy_tile<kBwdCT>(gin, (wt + nw) * W, d, rg);
    }
    cp_async_commit();
    float acc[kSepMT][2 * kBwdCT][4];
    singa::grid_chain_tc_sep_bwd<kSteps, kBwdCT, kSepKS, kSepMT>(
        stg, sfg, d.st, sta, d.sa, fx, fy, d.I, kBwdCT, 0, d.Gp / 8, acc);
    store_tile<kBwdCT>(acc, q0, d, nullptr, dx);
  }
}

namespace cc {

// ------------------------------- CUDA cores --------------------------------
// K3's and K3b's CUDA-core instance, for the shapes the tensor-core kernels
// do not take (C not a multiple of 16): one thread owns one (edge, channel)
// column, keeps its I coefficients (K3b: of x, of g and of the dx sums) in
// registers and walks the G grid points in float32, one grid value at a
// time; tg and fg sit in shared memory with their rows zero-padded to kMaxI
// floats (K3b: fg's column 0 zeroed too), so every read is a 16-byte
// broadcast. A grid-stride loop over (edge, 128-channel block).
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


// K3b's CUDA-core instance.
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

}  // namespace cc

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

// Whether the tensor-core kernels take these shapes: I <= 32, C a multiple
// of 16, a warp of each kernel beside its matrices in shared memory
bool tc_takes(int I, int C, int G) {
  if (I < 1 || I > kMaxI || C < 16 || C % 16 != 0 || G < 1) return false;
  const SepDims d = make_sep_dims(1, I, C, G);
  const TcLaunch f = fwd_launch(d), b = bwd_launch(d);
  return f.warps > 0 && b.warps > 0 &&
         singa::allow_smem(s2_silu_sep_tc_kernel, f.smem) == cudaSuccess &&
         singa::allow_smem(s2_silu_sep_bwd_tc_kernel, b.smem) == cudaSuccess;
}

size_t cc_smem(int G) { return 2 * (size_t)G * kMaxI * sizeof(float); }

// 1: the tensor-core kernels take these shapes; 0: the CUDA-core instance
// does; -1: neither (I above 32, or tg and fg over shared memory)
int sep_instance(int I, int C, int G) {
  if (I < 1 || I > kMaxI || C < 1 || G < 1) return -1;
  if (tc_takes(I, C, G)) return 1;
  const bool cc = singa::allow_smem(cc::s2_silu_sep_kernel, cc_smem(G)) == cudaSuccess &&
                  singa::allow_smem(cc::s2_silu_sep_bwd_kernel, cc_smem(G)) == cudaSuccess;
  return cc ? 0 : -1;
}

// The kernel to run: the tensor-core one where it takes the shapes and the
// caller did not ask for the CUDA-core one (cuda_cores); -1: none
int sep_which(int I, int C, int G, int cuda_cores) {
  const int which = sep_instance(I, C, G);
  return which == 1 && cuda_cores ? 0 : which;
}

}  // namespace

// Which of K3's (and K3b's) kernels runs these shapes, for any E: 1 the
// tensor-core kernels, 0 the CUDA-core instance, -1 neither. Launches nothing.
extern "C" int s2_silu_sep_instance(int I, int C, int G) { return sep_instance(I, C, G); }

// Resident blocks per SM of K3's (bwd: K3b's) tensor-core kernel at these
// shapes (-1: shapes it does not take), its shared memory per block in
// *smem_bytes and its threads per block in *threads. Launches nothing.
extern "C" int s2_silu_sep_residency(int I, int C, int G, int bwd, int* smem_bytes,
                                     int* threads) {
  if (!tc_takes(I, C, G)) return -1;
  const SepDims d = make_sep_dims(1, I, C, G);
  const TcLaunch l = bwd ? bwd_launch(d) : fwd_launch(d);
  *smem_bytes = (int)l.smem;
  *threads = 32 * l.warps;
  int per_sm = 0;
  const cudaError_t err =
      bwd ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, s2_silu_sep_bwd_tc_kernel,
                                                          *threads, l.smem)
          : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, s2_silu_sep_tc_kernel,
                                                          *threads, l.smem);
  return err == cudaSuccess ? per_sm : -1;
}

// K3. Returns cudaErrorInvalidValue for shapes no kernel takes (I above 32);
// cuda_cores: the CUDA-core instance wherever it takes the shapes.
extern "C" int s2_silu_sep_f32(const float* x, const float* s, const float* tg,
                               const float* fg, float* out, int E, int I, int C,
                               int G, int cuda_cores, void* stream) {
  const int which = E < 1 ? -1 : sep_which(I, C, G, cuda_cores);
  const cudaStream_t st = (cudaStream_t)stream;
  if (which == 1) {
    const SepDims d = make_sep_dims(E, I, C, G);
    const TcLaunch l = fwd_launch(d);
    const int grid = singa::persistent_grid(s2_silu_sep_tc_kernel, 32 * l.warps, l.smem,
                                            (tiles<kFwdCT>(d) + l.warps - 1) / l.warps);
    s2_silu_sep_tc_kernel<<<grid, 32 * l.warps, l.smem, st>>>(x, s, tg, fg, out, d);
    return (int)cudaGetLastError();
  }
  if (which == 0) {
    const size_t smem = cc_smem(G);
    cudaError_t err = singa::allow_smem(cc::s2_silu_sep_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const long long jobs = (long long)E * ((C + cc::kThreads - 1) / cc::kThreads);
    const int grid = singa::persistent_grid(cc::s2_silu_sep_kernel, cc::kThreads, smem, jobs);
    cc::s2_silu_sep_kernel<<<grid, cc::kThreads, smem, st>>>(x, s, tg, fg, out, E, I, C, G);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

// K3b, as K3.
extern "C" int s2_silu_sep_bwd_f32(const float* x, const float* s, const float* g,
                                   const float* tg, const float* fg, float* dx, float* ds,
                                   int E, int I, int C, int G, int cuda_cores, void* stream) {
  const int which = E < 1 ? -1 : sep_which(I, C, G, cuda_cores);
  const cudaStream_t st = (cudaStream_t)stream;
  if (which == 1) {
    const SepDims d = make_sep_dims(E, I, C, G);
    const TcLaunch l = bwd_launch(d);
    const int grid = singa::persistent_grid(s2_silu_sep_bwd_tc_kernel, 32 * l.warps, l.smem,
                                            (tiles<kBwdCT>(d) + l.warps - 1) / l.warps);
    s2_silu_sep_bwd_tc_kernel<<<grid, 32 * l.warps, l.smem, st>>>(x, s, g, tg, fg, dx, ds, d);
    return (int)cudaGetLastError();
  }
  if (which == 0) {
    const size_t smem = cc_smem(G);
    cudaError_t err = singa::allow_smem(cc::s2_silu_sep_bwd_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const long long jobs = (long long)E * ((C + cc::kThreads - 1) / cc::kThreads);
    const int grid =
        singa::persistent_grid(cc::s2_silu_sep_bwd_kernel, cc::kThreads, smem, jobs);
    cc::s2_silu_sep_bwd_kernel<<<grid, cc::kThreads, smem, st>>>(x, s, g, tg, fg, dx, ds, E, I,
                                                                 C, G);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
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
