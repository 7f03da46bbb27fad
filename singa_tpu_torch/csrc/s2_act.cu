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
// warps. The bfloat16 instances have their own map (kFwdCTBf16 ..
// kBwdWarpsBf16; the same tool on an H100 80GB HBM3 at 700 W, ms a call by
// CUDA events at the stage-1 call, E 31,744): K3 takes 20 warps of 32
// columns (0.603; 150,208 B at I 29, G 70, 92 registers), against 16 warps
// 0.639-0.650, 12 0.726, 24 0.597 with spills, 32 0.720 (64 registers,
// spilling), 64-column tiles at 8, 12, 16 warps 0.813, 0.646, 0.643; K3b
// takes 15 warps of 32 columns (0.834; 225,888 B, 127 registers), against
// 16-column tiles at 15, 24, 32 warps 1.106-1.128, 0.972-0.982, 1.005-1.030
// and 32-column tiles at 8 and 12 warps 1.078-1.082 and 0.919. At bfloat16
// a warp needs about half the shared memory, so more warps or wider tiles
// fit; the registers a lane may hold at 20 warps (102) and past them the
// spills end the gain.
//
// Shapes: the tensor-core kernels take I <= 32, any G whose matrices fit
// in shared memory, and C a multiple of 16 (a 16-column group then lies in
// one edge, and each 16-byte copy in one row): lmax 6, 4 and 2 at mmax 2
// (I 29, 19, 9). Every other shape the CUDA-core kernels took (C = 100,
// say) runs them, chosen by shape before the launch (sep_instance).
//
// bfloat16 (s2_silu_sep and s2_silu_sep_bwd with bf16 set; the bfloat16
// training path's K3 and K3b): the same kernels and chains at T = bf16, x,
// s, tg, fg, g and the outputs bfloat16 in device memory (the caller casts
// tg and fg, as the TPU kernel casts them to x.dtype). x (and g) come into
// the raw stage as bfloat16 by the same 16-byte cp.async, eight values a
// piece, at a row stride of 16 kCT + 8 values (% 32 of 8 or 24: the
// split's 2-byte reads stay conflict-free); a bfloat16 value is a TF32
// value, so the split keeps its bits as the hi plane alone, half the
// fragment words, and each product is one TF32 mma.sync, exact for two
// bfloat16 operands (tc::mma_t). tg and fg are staged as float, bfloat16
// values. silu(v) (K3) and h = silu'(v) u (K3b) are rounded to bfloat16
// as they split for the second product: the Pallas kernel's .astype(dt)
// at singa_tpu/ops/pallas/s2_act.py's _sep_fwd_kernel and _sep_bwd_kernel.
// Sums stay float32; the outputs are rounded once, at the store; row 0
// silu(s) and ds in float32 until stored. At the stage-1 call they move
// half the float32 bytes (0.48 and 0.73 GB, 0.14 and 0.22 ms at 3.35
// TB/s) and the 32.4 and 49.5 GFLOP take 0.07 and 0.10 ms as one TF32
// product at 495 TFLOP/s. Shapes as at float32; the other shapes run the
// CUDA-core instance at bfloat16 (cc::s2_silu_sep_kernel<bf16>,
// cc::s2_silu_sep_bwd_kernel<bf16>), as cuda_cores asks.
#include "s2_grid.cuh"
#include "s2_grid_tc.cuh"

namespace {

constexpr int kMaxI = 32;      // coefficient rows K3 and K3b take
constexpr int kSiluMaxI = 49;  // coefficient rows K5's and K5b's tensor-core kernels take

// ------------------------------ tensor cores -------------------------------
using singa::tc::kSplitFragWords;

constexpr int kSteps = 3;          // grid steps of 8 points a chain pass takes
constexpr int kSepKS = kMaxI / 8;  // k steps of the to-grid products
constexpr int kSepMT = kMaxI / 16; // m16 tiles of the from-grid output
constexpr int kFwdCT = 2;          // K3: 16-column groups of a warp tile
constexpr int kBwdCT = 1;          // K3b: the same
constexpr int kFwdWarps = 16;      // warps of a K3 (K5) block, at most
constexpr int kBwdWarps = 15;      // warps of a K3b (K5b) block, at most
// K3's and K3b's bfloat16 instances: the same, on their own (see the header)
constexpr int kFwdCTBf16 = 2;
constexpr int kBwdCTBf16 = 2;
constexpr int kFwdWarpsBf16 = 20;
constexpr int kBwdWarpsBf16 = 15;
// K5 and K5b above 32 rows: k steps and m16 tiles of 48 rows, and the
// 16-column groups of a warp tile (the matrices of a G-210 grid leave room
// for fewer warps than K3's)
constexpr int kWideKS = 6;
constexpr int kWideMT = 3;
constexpr int kWideCT = 1;
constexpr bool kTailRow = true;  // at I 49, row 48 in float32 (else a 7th k step, a 4th m16 tile)

using singa::bf16;
using singa::kBf16;
using singa::tc::kFragWords;

// K3's and K3b's warp tiles (16-column groups) and most warps a block, at
// storage type T
template <class T> constexpr int kSepFwdCT = kBf16<T> ? kFwdCTBf16 : kFwdCT;
template <class T> constexpr int kSepBwdCT = kBf16<T> ? kBwdCTBf16 : kBwdCT;
template <class T> constexpr int kSepFwdWarps = kBf16<T> ? kFwdWarpsBf16 : kFwdWarps;
template <class T> constexpr int kSepBwdWarps = kBf16<T> ? kBwdWarpsBf16 : kBwdWarps;

// a warp tile of kCT 16-column groups: its columns, and its raw stage's row
// stride in values of T (float: % 16 of 4; bf16: % 32 of 8 or 24, whole
// 16-byte pieces: the split's reads are conflict-free either way)
template <int kCT> constexpr int kCols = 16 * kCT;
template <int kCT, class T = float> constexpr int kRawStride = 16 * kCT + (kBf16<T> ? 8 : 4);

// 32-bit words of one warp's raw stage of I rows
template <int kCT, class T = float>
__host__ __device__ constexpr int raw_words(int I) {
  return kBf16<T> ? I * kRawStride<kCT, T> / 2 : I * kRawStride<kCT, T>;
}

struct SepDims {
  int I, C, G, Gp, st, sa, KS;  // Gp: G rounded up to a chain pass; KS: k steps
  long long Q;                  // columns: E * C
  bool tail;                    // row I - 1 = 48 in float32, beside the mma rows
  bool tg_once;                 // K5b: tg staged once, read both ways at stride st
};

// The kernels' dimensions. tail: rows 0 .. 47 through mma, row 48 apart (I
// 49); tg_once: tg staged once for K5b's both reads (st then covers the
// from-grid's rows too).
SepDims make_sep_dims(long long E, int I, int C, int G, bool tail = false, bool tg_once = false) {
  SepDims d;
  d.I = I, d.C = C, d.G = G, d.tail = tail, d.tg_once = tg_once;
  d.Gp = (G + 8 * kSteps - 1) / (8 * kSteps) * (8 * kSteps);
  d.KS = tail ? (I - 1) / 8 : (I + 7) / 8;
  const int MT = tail ? (I - 1) / 16 : (I + 15) / 16;
  d.st = singa::tc_stride(tg_once && 16 * MT > 8 * d.KS ? 16 * MT : 8 * d.KS);
  d.sa = tg_once ? d.st : singa::tc_fg_stride(tail ? I : 16 * MT);
  d.Q = E * C;
  return d;
}

// warp tiles of kCT groups
template <int kCT>
__host__ __device__ inline long long tiles(const SepDims& d) {
  return (d.Q + kCols<kCT> - 1) / kCols<kCT>;
}

// 32-bit words of one warp's raw stage, of its fragments (at bf16 their hi
// plane alone) and, with the tail row, of that row's columns, of one operand
template <int kCT, class T = float>
__host__ __device__ inline int warp_floats(const SepDims& d) {
  return raw_words<kCT, T>(d.I) + d.KS * kCT * kFragWords<T> + (d.tail ? kCols<kCT> : 0);
}

// floats of the staged matrices: K3's (K5's) tg [Gp][st] and fg [Gp][sa];
// K3b's (K5b's) tg [Gp][st], fg' [Gp][st] and, unless tg_once, tg [Gp][sa]
__host__ __device__ inline int fwd_mats(const SepDims& d) { return d.Gp * (d.st + d.sa); }
__host__ __device__ inline int bwd_mats(const SepDims& d) {
  return d.Gp * (2 * d.st + (d.tg_once ? 0 : d.sa));
}

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

template <int kCT = kFwdCT, class T = float>
TcLaunch fwd_launch(const SepDims& d) {
  return fit_warps(fwd_mats(d), warp_floats<kCT, T>(d), kSepFwdWarps<T>);
}

template <int kCT = kBwdCT, class T = float>
TcLaunch bwd_launch(const SepDims& d) {
  return fit_warps(bwd_mats(d), 2 * warp_floats<kCT, T>(d), kSepBwdWarps<T>);
}

// m [G, I] -> dst [Gp][stride] as float, zeros past G and I and in columns
// < col0
template <class T = float>
__device__ void stage_mat(const T* __restrict__ m, const SepDims& d, int stride, int col0,
                          float* dst) {
  for (int t = threadIdx.x; t < d.Gp * stride; t += blockDim.x) {
    const int g = t / stride, i = t % stride;
    dst[t] = g < d.G && i < d.I && i >= col0 ? singa::to_f(m[g * d.I + i]) : 0.f;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
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
// joins their next commit. A lane copies the same 16-byte piece (four
// float32 or eight bfloat16 columns) of every (32 / kChunks)-th row.
template <int kCT, class T = float>
__device__ __forceinline__ void copy_tile(const T* __restrict__ x, long long q0,
                                          const SepDims& d, T* raw) {
  constexpr int kPer = 16 / (int)sizeof(T);  // columns of a 16-byte piece
  constexpr int kChunks = kCols<kCT> / kPer;  // 16-byte pieces of a row
  const int lane = threadIdx.x & 31, c4 = lane % kChunks;
  const long long e0 = q0 / d.C;
  const bool ok = q0 + kPer * c4 < d.Q;
  const T* src = x + col_offset(d, e0, (int)(q0 - e0 * d.C), kPer * c4);
  for (int j = lane / kChunks; j < d.I; j += 32 / kChunks)
    cp_async16(raw + j * kRawStride<kCT, T> + kPer * c4, ok ? src + (long long)j * d.C : x, ok);
}

// raw [I][kRawStride] -> X^T split, in the chains' fragment order ((ks kCT +
// c) kFragWords<T> for k step ks and 16-column group c), rows past I zero;
// KS <= kMaxKS k steps (with the tail row: rows 0 .. 47 only). At bf16 a
// value's bits widened are its TF32 hi, stored alone.
template <int kCT, int kMaxKS = kSepKS, class T = float>
__device__ __forceinline__ void split_tile(const T* raw, int I, int KS, uint32_t* frag) {
  constexpr int S = kRawStride<kCT, T>;
  const int lane = threadIdx.x & 31, col = lane >> 2;
#pragma unroll
  for (int ks = 0; ks < kMaxKS; ++ks) {
    if (ks < KS) {
      const int i0 = 8 * ks + 2 * (lane & 3);
      const bool r0 = i0 < I, r1 = i0 + 1 < I;
#pragma unroll
      for (int c = 0; c < kCT; ++c) {
        if constexpr (kBf16<T>) {
          const uint16_t* src = reinterpret_cast<const uint16_t*>(raw) + i0 * S + 16 * c + col;
          const auto bits = [](uint16_t v) { return (uint32_t)v << 16; };
          reinterpret_cast<uint4*>(frag + (ks * kCT + c) * kFragWords<T>)[lane] =
              make_uint4(r0 ? bits(src[0]) : 0u, r0 ? bits(src[8]) : 0u,
                         r1 ? bits(src[S]) : 0u, r1 ? bits(src[S + 8]) : 0u);
        } else {
          const float* src = raw + i0 * S + 16 * c + col;
          singa::tc::store_a_split(frag + (ks * kCT + c) * kSplitFragWords, lane,
                                   r0 ? src[0] : 0.f, r0 ? src[8] : 0.f, r1 ? src[S] : 0.f,
                                   r1 ? src[S + 8] : 0.f);
        }
      }
    }
  }
}

// Two adjacent values of T as float, and stored from float (bf16: rounded
// to nearest even)
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float2 v) { *reinterpret_cast<float2*>(p) = v; }
__device__ __forceinline__ void store2(bf16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __float22bfloat162_rn(v);
}

// The from-grid sums of a warp tile (acc[mt][j]: rows 16 mt + grp (+ 8) of
// n8 column tile j) -> out [E, I, C], pieces of two columns of whole rows,
// rounded to T; row 0 from row0 (K3: silu(s)) when it is not null
template <int kCT, int kMT = kSepMT, class T = float>
__device__ __forceinline__ void store_tile(const float (&acc)[kMT][2 * kCT][4], long long q0,
                                           const SepDims& d, const T* __restrict__ row0,
                                           T* __restrict__ out) {
  const int grp = singa::tc::lane_grp(), tig = singa::tc::lane_tig();
  const int MT = (d.I + 15) / 16;
  const long long e0 = q0 / d.C;
  const int c0 = (int)(q0 - e0 * d.C);
#pragma unroll
  for (int j = 0; j < 2 * kCT; ++j) {
    const long long q = q0 + 8 * j + 2 * tig;  // the lane's columns q, q + 1 (one edge)
    if (q >= d.Q) continue;
    T* o = out + col_offset(d, e0, c0, 8 * j + 2 * tig);
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 16 * mt + grp + 8 * h;
        if (mt >= MT || i >= d.I) continue;
        float2 v = make_float2(acc[mt][j][2 * h], acc[mt][j][2 * h + 1]);
        if (row0 != nullptr && i == 0) {
          const float2 sv = load2(row0 + q);
          v = make_float2(singa::siluf_(sv.x), singa::siluf_(sv.y));
        }
        store2(o + (long long)i * d.C, v);
      }
  }
}

// The tail row's sums (tl[j]: the lane's share of column grp of n8 tile j)
// -> row I - 1 of out: summed over the four lanes of a column, stored by
// the first
template <int kCT>
__device__ __forceinline__ void store_tail(float (&tl)[2 * kCT], long long q0, const SepDims& d,
                                           float* __restrict__ out) {
  const int grp = singa::tc::lane_grp(), tig = singa::tc::lane_tig();
  const long long e0 = q0 / d.C;
  const int c0 = (int)(q0 - e0 * d.C);
#pragma unroll
  for (int j = 0; j < 2 * kCT; ++j) {
    tl[j] += __shfl_xor_sync(0xffffffffu, tl[j], 1);
    tl[j] += __shfl_xor_sync(0xffffffffu, tl[j], 2);
    if (tig == 0 && q0 + 8 * j + grp < d.Q)
      out[col_offset(d, e0, c0, 8 * j + grp) + (long long)(d.I - 1) * d.C] = tl[j];
  }
}

// A forward kernel's tiles, K3's (s: the scalars, whose silu is row 0) or
// K5's (s null: every row from the chain); I0 = 49: row 48 in float32
// (grid_chain_tc_fwd), the warp's columns of it kept apart (xt) before the
// next tile's copy overwrites the raw stage. T: the storage type of x, s,
// tg, fg and out (K3's bfloat16 instance: bf16; tg and fg staged as float)
template <int I0, int kCT, int kKS, int kMT, class T = float>
__device__ __forceinline__ void fwd_tiles(const T* __restrict__ x, const T* __restrict__ s,
                                          const T* __restrict__ tg, const T* __restrict__ fg,
                                          T* __restrict__ out, const SepDims& d) {
  constexpr bool kTail = I0 == 49;
  extern __shared__ __align__(16) float smem[];
  float* stg = smem;                   // [Gp][st]: tg, read as B
  float* sfg = stg + d.Gp * d.st;      // [Gp][sa]: fg, read as A transposed
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the warp's raw stage, fragments and tail row
  float* stage = smem + fwd_mats(d) + warp * (warp_floats<kCT, T>(d));
  T* raw = reinterpret_cast<T*>(stage);
  uint32_t* frag = reinterpret_cast<uint32_t*>(stage + raw_words<kCT, T>(d.I));
  float* xt = reinterpret_cast<float*>(frag + d.KS * kCT * kFragWords<T>);
  constexpr int W = kCols<kCT>;
  const int warps = blockDim.x >> 5;
  const long long nw = (long long)gridDim.x * warps, nt = tiles<kCT>(d);
  long long wt = (long long)blockIdx.x * warps + warp;
  if (wt < nt) copy_tile<kCT, T>(x, wt * W, d, raw);
  cp_async_commit();
  stage_mat<T>(tg, d, d.st, 0, stg);
  stage_mat<T>(fg, d, d.sa, 0, sfg);
  __syncthreads();
  for (; wt < nt; wt += nw) {
    cp_async_wait_all();
    __syncwarp();  // the tile's raw stage; every lane is done with the last chain
    split_tile<kCT, kKS, T>(raw, d.I, d.KS, frag);
    if constexpr (kTail) {
      if (lane < W) xt[lane] = raw[(I0 - 1) * kRawStride<kCT> + lane];
    }
    __syncwarp();  // the fragments; every lane is done with the raw stage
    if (wt + nw < nt) copy_tile<kCT, T>(x, (wt + nw) * W, d, raw);
    cp_async_commit();
    float acc[kMT][2 * kCT][4], tl[2 * kCT];
    singa::grid_chain_tc_fwd<I0, kSteps, kCT, kKS, kMT, T>(stg, d.st, sfg, d.sa, frag, xt, d.I,
                                                            kCT, 0, 0, d.Gp / 8, acc, tl);
    store_tile<kCT, kMT, T>(acc, wt * W, d, s, out);
    if constexpr (kTail) store_tail<kCT>(tl, wt * W, d, out);
  }
}

// A backward kernel's tiles, K3b's (kSep: fg's column 0 zeroed, ds from g's
// row 0) or K5b's (fg whole, no ds); I0 = 49: row 48 in float32
// (grid_chain_tc_sep_bwd), x's and g's columns of it kept apart (xt, yt).
// T as in fwd_tiles (K3b's bfloat16 instance: ds in float32 until stored)
template <int I0, int kCT, int kKS, int kMT, bool kSep, class T = float>
__device__ __forceinline__ void bwd_tiles(const T* __restrict__ x, const T* __restrict__ s,
                                          const T* __restrict__ gin, const T* __restrict__ tg,
                                          const T* __restrict__ fg, T* __restrict__ dx,
                                          T* __restrict__ ds, const SepDims& d) {
  constexpr bool kTail = I0 == 49;
  static_assert(!kSep || kCols<kCT> <= 32, "ds is a column a lane");
  extern __shared__ __align__(16) float smem[];
  float* stg = smem;                   // [Gp][st]: tg, read as B
  float* sfg = stg + d.Gp * d.st;      // [Gp][st]: fg (K3b: column 0 zeroed), read as B
  // [Gp][sa]: tg, read as A transposed (tg_once: stg itself, sa = st)
  float* sta = d.tg_once ? stg : sfg + d.Gp * d.st;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int W = kCols<kCT>;
  const int raw = raw_words<kCT, T>(d.I), frag = d.KS * kCT * kFragWords<T>;
  float* sx = smem + bwd_mats(d) + warp * 2 * warp_floats<kCT, T>(d);  // the warp's
  float* sg = sx + raw;
  T* rx = reinterpret_cast<T*>(sx);
  T* rg = reinterpret_cast<T*>(sg);
  uint32_t* fx = reinterpret_cast<uint32_t*>(sg + raw);
  uint32_t* fy = fx + frag;
  float* xt = reinterpret_cast<float*>(fy + frag);  // the tail rows
  float* yt = xt + W;
  const int warps = blockDim.x >> 5;
  const long long nw = (long long)gridDim.x * warps, nt = tiles<kCT>(d);
  long long wt = (long long)blockIdx.x * warps + warp;
  if (wt < nt) {
    copy_tile<kCT, T>(x, wt * W, d, rx);
    copy_tile<kCT, T>(gin, wt * W, d, rg);
  }
  cp_async_commit();
  stage_mat<T>(tg, d, d.st, 0, stg);
  stage_mat<T>(fg, d, d.st, kSep ? 1 : 0, sfg);
  if (!d.tg_once) stage_mat<T>(tg, d, d.sa, 0, sta);
  __syncthreads();
  for (; wt < nt; wt += nw) {
    const long long q0 = wt * W;
    cp_async_wait_all();
    __syncwarp();  // the tile's raw stages; every lane is done with the last chain
    split_tile<kCT, kKS, T>(rx, d.I, d.KS, fx);
    split_tile<kCT, kKS, T>(rg, d.I, d.KS, fy);
    if (kSep && lane < W && q0 + lane < d.Q)  // ds of the lane's column, from g's row 0
      ds[q0 + lane] = singa::from_f<T>(singa::silu_gradf_(singa::to_f(s[q0 + lane])) *
                                       singa::to_f(rg[lane]));
    if constexpr (kTail) {
      if (lane < W) {
        xt[lane] = rx[(I0 - 1) * kRawStride<kCT> + lane];
        yt[lane] = rg[(I0 - 1) * kRawStride<kCT> + lane];
      }
    }
    __syncwarp();  // the fragments; every lane is done with the raw stages
    if (wt + nw < nt) {
      copy_tile<kCT, T>(x, (wt + nw) * W, d, rx);
      copy_tile<kCT, T>(gin, (wt + nw) * W, d, rg);
    }
    cp_async_commit();
    float acc[kMT][2 * kCT][4], tl[2 * kCT];
    singa::grid_chain_tc_sep_bwd<kSteps, kCT, kKS, kMT, I0, T>(
        stg, sfg, d.st, sta, d.sa, fx, fy, d.I, kCT, 0, d.Gp / 8, acc, xt, yt, tl);
    store_tile<kCT, kMT, T>(acc, q0, d, nullptr, dx);
    if constexpr (kTail) store_tail<kCT>(tl, q0, d, dx);
  }
}

// K3's and K3b's tensor-core kernels at storage type T (float32, or their
// bfloat16 instances)
template <class T = float>
__global__ void __launch_bounds__(32 * kSepFwdWarps<T>, 1)
s2_silu_sep_tc_kernel(const T* __restrict__ x, const T* __restrict__ s,
                      const T* __restrict__ tg, const T* __restrict__ fg,
                      T* __restrict__ out, SepDims d) {
  fwd_tiles<0, kSepFwdCT<T>, kSepKS, kSepMT, T>(x, s, tg, fg, out, d);
}

template <class T = float>
__global__ void __launch_bounds__(32 * kSepBwdWarps<T>, 1)
s2_silu_sep_bwd_tc_kernel(const T* __restrict__ x, const T* __restrict__ s,
                          const T* __restrict__ gin, const T* __restrict__ tg,
                          const T* __restrict__ fg, T* __restrict__ dx,
                          T* __restrict__ ds, SepDims d) {
  bwd_tiles<0, kSepBwdCT<T>, kSepKS, kSepMT, true, T>(x, s, gin, tg, fg, dx, ds, d);
}

// K5's and K5b's tensor-core kernels (see the end of the file)
template <int I0, int kCT, int kKS, int kMT>
__global__ void __launch_bounds__(32 * kFwdWarps, 1)
s2_silu_tc_kernel(const float* __restrict__ x, const float* __restrict__ tg,
                  const float* __restrict__ fg, float* __restrict__ out, SepDims d) {
  fwd_tiles<I0, kCT, kKS, kMT, float>(x, nullptr, tg, fg, out, d);
}

template <int I0, int kCT, int kKS, int kMT>
__global__ void __launch_bounds__(32 * kBwdWarps, 1)
s2_silu_bwd_tc_kernel(const float* __restrict__ x, const float* __restrict__ gin,
                      const float* __restrict__ tg, const float* __restrict__ fg,
                      float* __restrict__ dx, SepDims d) {
  bwd_tiles<I0, kCT, kKS, kMT, false, float>(x, nullptr, gin, tg, fg, dx, nullptr, d);
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
//
// T is the storage type of x, s, tg, fg and the outputs. The bfloat16
// instance (T = bf16) is the function _sep_fwd_kernel / _sep_bwd_kernel
// compute at a bfloat16 x: values read as bfloat16 and summed in float32,
// rounded to bfloat16 where the TPU kernel calls .astype(dt): silu(grid)
// before the from-grid product (K3), h = silu'(v) u before dx's (K3b), and
// the outputs; the row-0 gate silu(s) and ds in float32 until stored.
constexpr int kThreads = 128;

template <class T>
__global__ void __launch_bounds__(kThreads)
s2_silu_sep_kernel(const T* __restrict__ x, const T* __restrict__ s,
                   const T* __restrict__ tg, const T* __restrict__ fg,
                   T* __restrict__ out, int E, int I, int C, int G) {
  extern __shared__ __align__(16) float smem[];
  float* stg = smem;              // [G, kMaxI], rows zero-padded past I
  float* sfg = smem + G * kMaxI;  // [G, kMaxI]
  for (int t = threadIdx.x; t < G * kMaxI; t += blockDim.x) {
    const int g = t / kMaxI, j = t % kMaxI;
    stg[t] = j < I ? singa::to_f(tg[g * I + j]) : 0.f;
    sfg[t] = j < I ? singa::to_f(fg[g * I + j]) : 0.f;
  }
  __syncthreads();

  const int cblocks = (C + kThreads - 1) / kThreads;
  const long long jobs = (long long)E * cblocks;
  for (long long job = blockIdx.x; job < jobs; job += gridDim.x) {
    const long long e = job / cblocks;
    const int c = (int)(job % cblocks) * kThreads + threadIdx.x;
    if (c >= C) continue;
    const T* xe = x + e * I * C + c;
    float xv[kMaxI], acc[kMaxI];
#pragma unroll
    for (int j = 0; j < kMaxI; ++j) {
      xv[j] = (j < I) ? singa::to_f(xe[(long long)j * C]) : 0.f;
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
      const float a = singa::rnd<T>(singa::siluf_(v));
#pragma unroll
      for (int j4 = 0; j4 < kMaxI / 4; ++j4) {
        const float4 w = fr[j4];
        acc[4 * j4] = fmaf(w.x, a, acc[4 * j4]);
        acc[4 * j4 + 1] = fmaf(w.y, a, acc[4 * j4 + 1]);
        acc[4 * j4 + 2] = fmaf(w.z, a, acc[4 * j4 + 2]);
        acc[4 * j4 + 3] = fmaf(w.w, a, acc[4 * j4 + 3]);
      }
    }
    T* oe = out + e * I * C + c;
    oe[0] = singa::from_f<T>(singa::siluf_(singa::to_f(s[e * C + c])));
#pragma unroll
    for (int j = 1; j < kMaxI; ++j)
      if (j < I) oe[(long long)j * C] = singa::from_f<T>(acc[j]);
  }
}


// K3b's CUDA-core instance.
template <class T>
__global__ void __launch_bounds__(kThreads)
s2_silu_sep_bwd_kernel(const T* __restrict__ x, const T* __restrict__ s,
                       const T* __restrict__ gin, const T* __restrict__ tg,
                       const T* __restrict__ fg, T* __restrict__ dx,
                       T* __restrict__ ds, int E, int I, int C, int G) {
  extern __shared__ __align__(16) float smem[];
  float* stg = smem;              // [G, kMaxI], rows zero-padded past I
  float* sfg = smem + G * kMaxI;  // [G, kMaxI], column 0 zeroed too
  for (int t = threadIdx.x; t < G * kMaxI; t += blockDim.x) {
    const int g = t / kMaxI, j = t % kMaxI;
    stg[t] = j < I ? singa::to_f(tg[g * I + j]) : 0.f;
    sfg[t] = (j < I && j > 0) ? singa::to_f(fg[g * I + j]) : 0.f;
  }
  __syncthreads();

  const int cblocks = (C + kThreads - 1) / kThreads;
  const long long jobs = (long long)E * cblocks;
  for (long long job = blockIdx.x; job < jobs; job += gridDim.x) {
    const long long e = job / cblocks;
    const int c = (int)(job % cblocks) * kThreads + threadIdx.x;
    if (c >= C) continue;
    const T* xe = x + e * I * C + c;
    const T* ge = gin + e * I * C + c;
    float xv[kMaxI], gv[kMaxI], acc[kMaxI];
#pragma unroll
    for (int j = 0; j < kMaxI; ++j) {
      xv[j] = (j < I) ? singa::to_f(xe[(long long)j * C]) : 0.f;
      gv[j] = (j < I) ? singa::to_f(ge[(long long)j * C]) : 0.f;
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
      const float h = singa::rnd<T>(singa::silu_gradf_(v) * u);
#pragma unroll
      for (int j4 = 0; j4 < kMaxI / 4; ++j4) {
        const float4 w = tr[j4];
        acc[4 * j4] = fmaf(w.x, h, acc[4 * j4]);
        acc[4 * j4 + 1] = fmaf(w.y, h, acc[4 * j4 + 1]);
        acc[4 * j4 + 2] = fmaf(w.z, h, acc[4 * j4 + 2]);
        acc[4 * j4 + 3] = fmaf(w.w, h, acc[4 * j4 + 3]);
      }
    }
    ds[e * C + c] = singa::from_f<T>(singa::silu_gradf_(singa::to_f(s[e * C + c])) * gv[0]);
    T* de = dx + e * I * C + c;
#pragma unroll
    for (int j = 0; j < kMaxI; ++j)
      if (j < I) de[(long long)j * C] = singa::from_f<T>(acc[j]);
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
// (K5b) grid transforms of 2 G I operations against 8 (12) bytes of x (and
// g) in and out a coefficient. At the s2 FFN's hidden (N 3,584 x C 512, I
// 49, G 210) K5 moves 0.72 GB (0.21 ms at 3.35 TB/s) and does 75.5 GFLOP,
// 74.0 of them as split TF32 (three TF32 products a product: 0.45 ms at
// 495 TFLOP/s); K5b 1.08 GB and 113 GFLOP (0.67 ms): the tensor cores
// bound both. At the attention message (E 7,936 x C 128, I 29, G 70)
// memory and the arithmetic come close (0.07 / 0.05 ms, K5).
//
// Design (s2_silu_tc_kernel, s2_silu_bwd_tc_kernel): K3's and K3b's
// tensor-core kernels (above) without the row-0 case, on the same tile
// bodies (fwd_tiles, bwd_tiles) and chains, widened to I <= 49 by form:
//   I <= 32       K3's and K3b's loops (4 k steps, 2 m16 tiles) and warp
//                 tiles (32 and 16 columns), 16 and 15 warps at G 70
//   33 <= I <= 48 6 k steps and 3 m16 tiles
//   I = 49        the same for rows 0 .. 47 (the full lmax-6 grid, G 210),
//                 row 48 in float32 on the CUDA cores (kTailRow): a
//                 rank-one update of v (K5b: and of u) and the lane's share
//                 of output row 48, summed over the four lanes of a column
//                 (grid_chain_tc_fwd, grid_chain_tc_sep_bwd); a 7th k step
//                 and a 4th m16 tile would be 1/8 and 1/16 full
// Above 32 rows a warp tile is kWideCT 16-column groups. tg and fg of a
// G-210 grid take 93 KB (K5) and, staged as K3b stages them (tg twice),
// 142 KB (K5b), which leaves room for 4 warps of K5b: so K5b stages tg
// once where that keeps more warps (tg_once: 6 warps at I 49, its
// from-grid loads then meet 2-way bank conflicts).
//
// Why (tools/bench_k3_variants.py on an H100 80GB HBM3 at 700 W, by CUDA
// events at the s2 FFN's hidden): the tail row ran K5 in 1.70 ms and K5b
// in 2.94, every row through mma 2.00 and 5.10 (11 and 4 warps); 32-column
// warp tiles 2.03 and 6.30 (7 and 3 warps); K5b with tg staged twice 3.09
// (4 warps). As for K3 and K3b, the chains are latency- and issue-bound,
// and the warps a block keeps decide.
//
// Shapes: the tensor-core kernels take I <= 49 and C a multiple of 16,
// where a warp of each fits in shared memory beside the matrices. Every
// other shape the CUDA-core kernels took (I 50 .. 64, lmax 7; C 24 or 5)
// runs them, chosen by shape before the launch (silu_instance): K4's
// CUDA-core grid chain (csrc/s2_grid.cuh) on tiles of 128 columns of the
// flat (node, channel) column space, the tile's [I, 128] slice of x (and
// g) in shared memory, the grid formed 32 points at a time.
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

// K3's and K3b's tensor-core launches at storage type T
template <class T>
TcLaunch sep_fwd_launch(const SepDims& d) {
  return fwd_launch<kSepFwdCT<T>, T>(d);
}
template <class T>
TcLaunch sep_bwd_launch(const SepDims& d) {
  return bwd_launch<kSepBwdCT<T>, T>(d);
}

// Whether the tensor-core kernels at storage type T take these shapes: I
// <= 32, C a multiple of 16, a warp of each kernel beside its matrices in
// shared memory
template <class T>
bool tc_takes(int I, int C, int G) {
  if (I < 1 || I > kMaxI || C < 16 || C % 16 != 0 || G < 1) return false;
  const SepDims d = make_sep_dims(1, I, C, G);
  const TcLaunch f = sep_fwd_launch<T>(d), b = sep_bwd_launch<T>(d);
  return f.warps > 0 && b.warps > 0 &&
         singa::allow_smem(s2_silu_sep_tc_kernel<T>, f.smem) == cudaSuccess &&
         singa::allow_smem(s2_silu_sep_bwd_tc_kernel<T>, b.smem) == cudaSuccess;
}

size_t cc_smem(int G) { return 2 * (size_t)G * kMaxI * sizeof(float); }

// K3's (BWD false) or K3b's CUDA-core instance at storage type T (g and ds
// unused by K3)
template <bool BWD, class T>
int cc_sep_launch(const T* x, const T* s, const T* g, const T* tg, const T* fg, T* out, T* ds,
                  int E, int I, int C, int G, cudaStream_t st) {
  const size_t smem = cc_smem(G);
  const long long jobs = (long long)E * ((C + cc::kThreads - 1) / cc::kThreads);
  if constexpr (BWD) {
    const auto kernel = cc::s2_silu_sep_bwd_kernel<T>;
    const cudaError_t err = singa::allow_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const int grid = singa::persistent_grid(kernel, cc::kThreads, smem, jobs);
    kernel<<<grid, cc::kThreads, smem, st>>>(x, s, g, tg, fg, out, ds, E, I, C, G);
  } else {
    const auto kernel = cc::s2_silu_sep_kernel<T>;
    const cudaError_t err = singa::allow_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const int grid = singa::persistent_grid(kernel, cc::kThreads, smem, jobs);
    kernel<<<grid, cc::kThreads, smem, st>>>(x, s, tg, fg, out, E, I, C, G);
  }
  return (int)cudaGetLastError();
}

// At storage type T, 1: the tensor-core kernels take these shapes; 0: the
// CUDA-core instance does; -1: neither (I above 32, or tg and fg over
// shared memory)
template <class T>
int sep_instance(int I, int C, int G) {
  if (I < 1 || I > kMaxI || C < 1 || G < 1) return -1;
  if (tc_takes<T>(I, C, G)) return 1;
  const bool cc = singa::allow_smem(cc::s2_silu_sep_kernel<T>, cc_smem(G)) == cudaSuccess &&
                  singa::allow_smem(cc::s2_silu_sep_bwd_kernel<T>, cc_smem(G)) == cudaSuccess;
  return cc ? 0 : -1;
}

// The kernel to run: the tensor-core one where it takes the shapes and the
// caller did not ask for the CUDA-core one (cuda_cores); -1: none
template <class T>
int sep_which(int I, int C, int G, int cuda_cores) {
  const int which = sep_instance<T>(I, C, G);
  return which == 1 && cuda_cores ? 0 : which;
}

// Resident blocks per SM of K3's (bwd: K3b's) tensor-core kernel at T (-1:
// shapes it does not take), its shared memory and threads per block
template <class T>
int sep_residency(int I, int C, int G, int bwd, int* smem_bytes, int* threads) {
  if (!tc_takes<T>(I, C, G)) return -1;
  const SepDims d = make_sep_dims(1, I, C, G);
  const TcLaunch l = bwd ? sep_bwd_launch<T>(d) : sep_fwd_launch<T>(d);
  *smem_bytes = (int)l.smem;
  *threads = 32 * l.warps;
  int per_sm = 0;
  const cudaError_t err =
      bwd ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, s2_silu_sep_bwd_tc_kernel<T>,
                                                          *threads, l.smem)
          : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, s2_silu_sep_tc_kernel<T>,
                                                          *threads, l.smem);
  return err == cudaSuccess ? per_sm : -1;
}

// K3 at storage type T: the tensor-core kernel where it takes the shapes
// (unless cuda_cores), else the CUDA-core instance; cudaErrorInvalidValue
// for shapes neither takes
template <class T>
int sep_fwd(const T* x, const T* s, const T* tg, const T* fg, T* out, int E, int I, int C, int G,
            int cuda_cores, cudaStream_t st) {
  const int which = E < 1 ? -1 : sep_which<T>(I, C, G, cuda_cores);
  if (which == 1) {
    const SepDims d = make_sep_dims(E, I, C, G);
    const TcLaunch l = sep_fwd_launch<T>(d);
    const auto kernel = s2_silu_sep_tc_kernel<T>;
    const int grid = singa::persistent_grid(kernel, 32 * l.warps, l.smem,
                                            (tiles<kSepFwdCT<T>>(d) + l.warps - 1) / l.warps);
    kernel<<<grid, 32 * l.warps, l.smem, st>>>(x, s, tg, fg, out, d);
    return (int)cudaGetLastError();
  }
  if (which == 0)
    return cc_sep_launch<false, T>(x, s, nullptr, tg, fg, out, nullptr, E, I, C, G, st);
  return (int)cudaErrorInvalidValue;
}

// K3b at storage type T, as K3
template <class T>
int sep_bwd(const T* x, const T* s, const T* g, const T* tg, const T* fg, T* dx, T* ds, int E,
            int I, int C, int G, int cuda_cores, cudaStream_t st) {
  const int which = E < 1 ? -1 : sep_which<T>(I, C, G, cuda_cores);
  if (which == 1) {
    const SepDims d = make_sep_dims(E, I, C, G);
    const TcLaunch l = sep_bwd_launch<T>(d);
    const auto kernel = s2_silu_sep_bwd_tc_kernel<T>;
    const int grid = singa::persistent_grid(kernel, 32 * l.warps, l.smem,
                                            (tiles<kSepBwdCT<T>>(d) + l.warps - 1) / l.warps);
    kernel<<<grid, 32 * l.warps, l.smem, st>>>(x, s, g, tg, fg, dx, ds, d);
    return (int)cudaGetLastError();
  }
  if (which == 0) return cc_sep_launch<true, T>(x, s, g, tg, fg, dx, ds, E, I, C, G, st);
  return (int)cudaErrorInvalidValue;
}


size_t silu_cc_smem(bool bwd, int I, int G) {
  return (singa::grid_mats_floats(G, I) + (bwd ? 2 : 1) * (size_t)singa::pad_rows(I) *
          (kSiluCols + kSiluPad) + (size_t)singa::kGC * kSiluCols) * sizeof(float);
}

// K5's and K5b's tensor-core forms: rows below the tail through mma in
// kKS k steps and kMT m16 tiles, warp tiles of kFCT (K5) and kBCT (K5b)
// 16-column groups; I0 = 49: row 48 in float32
template <int I0_, int kFCT_, int kBCT_, int kKS_, int kMT_>
struct SiluForm {
  static constexpr int I0 = I0_, kFCT = kFCT_, kBCT = kBCT_, kKS = kKS_, kMT = kMT_;
};

// the form that takes I rows (1 <= I <= kSiluMaxI), passed to f
template <class F>
auto with_form(int I, F&& f) {
  if (I <= kMaxI) return f(SiluForm<0, kFwdCT, kBwdCT, kSepKS, kSepMT>{});
  if (I < kSiluMaxI) return f(SiluForm<0, kWideCT, kWideCT, kWideKS, kWideMT>{});
  if constexpr (kTailRow)
    return f(SiluForm<kSiluMaxI, kWideCT, kWideCT, kWideKS, kWideMT>{});
  else
    return f(SiluForm<0, kWideCT, kWideCT, kWideKS + 1, kWideMT + 1>{});
}

template <class Form>
SepDims silu_fwd_dims(long long N, int I, int C, int G) {
  return make_sep_dims(N, I, C, G, Form::I0 == kSiluMaxI);
}

// K5b's: tg staged twice (conflict-free both ways) unless staging it once
// keeps more warps a block
template <class Form>
SepDims silu_bwd_dims(long long N, int I, int C, int G) {
  const SepDims two = make_sep_dims(N, I, C, G, Form::I0 == kSiluMaxI, false);
  const SepDims one = make_sep_dims(N, I, C, G, Form::I0 == kSiluMaxI, true);
  return bwd_launch<Form::kBCT>(one).warps > bwd_launch<Form::kBCT>(two).warps ? one : two;
}

// Whether K5's and K5b's tensor-core kernels take these shapes: I <= 49, C
// a multiple of 16, a warp of each beside its matrices in shared memory
bool silu_tc_takes(int I, int C, int G) {
  if (I < 1 || I > kSiluMaxI || C < 16 || C % 16 != 0 || G < 1) return false;
  return with_form(I, [&](auto form) {
    using F = decltype(form);
    const TcLaunch f = fwd_launch<F::kFCT>(silu_fwd_dims<F>(1, I, C, G));
    const TcLaunch b = bwd_launch<F::kBCT>(silu_bwd_dims<F>(1, I, C, G));
    return f.warps > 0 && b.warps > 0 &&
           singa::allow_smem(s2_silu_tc_kernel<F::I0, F::kFCT, F::kKS, F::kMT>, f.smem) ==
               cudaSuccess &&
           singa::allow_smem(s2_silu_bwd_tc_kernel<F::I0, F::kBCT, F::kKS, F::kMT>, b.smem) ==
               cudaSuccess;
  });
}

// 1: K5's and K5b's tensor-core kernels take these shapes; 0: the
// CUDA-core instance does; -1: neither (I above 64, or the matrices over
// shared memory)
int silu_instance(int I, int C, int G) {
  if (I < 1 || C < 1 || G < 1) return -1;
  if (silu_tc_takes(I, C, G)) return 1;
  const bool cc = singa::chain_fits(kSiluCols, 1, I) &&
                  singa::allow_smem(s2_silu_kernel<false>, silu_cc_smem(false, I, G)) ==
                      cudaSuccess &&
                  singa::allow_smem(s2_silu_kernel<true>, silu_cc_smem(true, I, G)) == cudaSuccess;
  return cc ? 0 : -1;
}

template <bool BWD>
int s2_silu_launch(const float* x, const float* g, const float* tg, const float* fg, float* out,
                   int N, int I, int C, int G, void* stream) {
  if (N < 1 || C < 1 || G < 1 || !singa::chain_fits(kSiluCols, 1, I))
    return (int)cudaErrorInvalidValue;
  const size_t smem = silu_cc_smem(BWD, I, G);
  cudaError_t err = singa::allow_smem(s2_silu_kernel<BWD>, smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = ((long long)N * C + kSiluCols - 1) / kSiluCols;
  const int grid = singa::persistent_grid(s2_silu_kernel<BWD>, singa::kChainThreads, smem, tiles);
  s2_silu_kernel<BWD><<<grid, singa::kChainThreads, smem, (cudaStream_t)stream>>>(
      x, g, tg, fg, out, N, I, C, G);
  return (int)cudaGetLastError();
}

}  // namespace

// Which of K3's (and K3b's) kernels runs these shapes at bfloat16 storage
// (bf16 != 0) or float32, for any E: 1 the tensor-core kernels, 0 the
// CUDA-core instance, -1 neither. Launches nothing.
extern "C" int s2_silu_sep_instance(int I, int C, int G, int bf16) {
  return bf16 ? sep_instance<singa::bf16>(I, C, G) : sep_instance<float>(I, C, G);
}

// Resident blocks per SM of K3's (bwd: K3b's) tensor-core kernel at these
// shapes (bf16 != 0: its bfloat16 instance; -1: shapes it does not take),
// its shared memory per block in *smem_bytes and its threads per block in
// *threads. Launches nothing.
extern "C" int s2_silu_sep_residency(int I, int C, int G, int bwd, int bf16, int* smem_bytes,
                                     int* threads) {
  return bf16 ? sep_residency<singa::bf16>(I, C, G, bwd, smem_bytes, threads)
              : sep_residency<float>(I, C, G, bwd, smem_bytes, threads);
}

// K3: x, s, tg, fg and out bfloat16 when bf16 != 0 (the caller casts tg and
// fg, as the TPU kernel casts them to x.dtype), else float32. Returns
// cudaErrorInvalidValue for shapes no kernel takes (I above 32);
// cuda_cores: the CUDA-core instance wherever it takes the shapes.
extern "C" int s2_silu_sep(const void* x, const void* s, const void* tg, const void* fg,
                           void* out, int E, int I, int C, int G, int cuda_cores, int bf16,
                           void* stream) {
  using B = singa::bf16;
  const cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return sep_fwd((const B*)x, (const B*)s, (const B*)tg, (const B*)fg, (B*)out, E, I, C, G,
                   cuda_cores, st);
  return sep_fwd((const float*)x, (const float*)s, (const float*)tg, (const float*)fg,
                 (float*)out, E, I, C, G, cuda_cores, st);
}

// K3b, as K3: x, s, g, tg, fg, dx and ds all bfloat16 or all float32.
extern "C" int s2_silu_sep_bwd(const void* x, const void* s, const void* g, const void* tg,
                               const void* fg, void* dx, void* ds, int E, int I, int C, int G,
                               int cuda_cores, int bf16, void* stream) {
  using B = singa::bf16;
  const cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return sep_bwd((const B*)x, (const B*)s, (const B*)g, (const B*)tg, (const B*)fg, (B*)dx,
                   (B*)ds, E, I, C, G, cuda_cores, st);
  return sep_bwd((const float*)x, (const float*)s, (const float*)g, (const float*)tg,
                 (const float*)fg, (float*)dx, (float*)ds, E, I, C, G, cuda_cores, st);
}


// Which of K5's (and K5b's) kernels runs these shapes, for any N: 1 the
// tensor-core kernels, 0 the CUDA-core instance, -1 neither. Launches
// nothing.
extern "C" int s2_silu_instance(int I, int C, int G) { return silu_instance(I, C, G); }

// Resident blocks per SM of K5's (bwd: K5b's) tensor-core kernel at these
// shapes (-1: shapes it does not take), its shared memory per block in
// *smem_bytes and its threads per block in *threads. Launches nothing.
extern "C" int s2_silu_residency(int I, int C, int G, int bwd, int* smem_bytes, int* threads) {
  if (!silu_tc_takes(I, C, G)) return -1;
  return with_form(I, [&](auto form) {
    using F = decltype(form);
    const TcLaunch l = bwd ? bwd_launch<F::kBCT>(silu_bwd_dims<F>(1, I, C, G))
                           : fwd_launch<F::kFCT>(silu_fwd_dims<F>(1, I, C, G));
    *smem_bytes = (int)l.smem;
    *threads = 32 * l.warps;
    int per_sm = 0;
    const cudaError_t err =
        bwd ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                  &per_sm, s2_silu_bwd_tc_kernel<F::I0, F::kBCT, F::kKS, F::kMT>, *threads, l.smem)
            : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                  &per_sm, s2_silu_tc_kernel<F::I0, F::kFCT, F::kKS, F::kMT>, *threads, l.smem);
    return err == cudaSuccess ? per_sm : -1;
  });
}

// K5. Returns cudaErrorInvalidValue for shapes no kernel takes (I above
// 64); cuda_cores: the CUDA-core instance wherever it takes the shapes.
extern "C" int s2_silu_f32(const float* x, const float* tg, const float* fg, float* out, int N,
                           int I, int C, int G, int cuda_cores, void* stream) {
  const int which = N < 1 ? -1 : silu_instance(I, C, G);
  if (which == 1 && !cuda_cores)
    return with_form(I, [&](auto form) {
      using F = decltype(form);
      const SepDims d = silu_fwd_dims<F>(N, I, C, G);
      const TcLaunch l = fwd_launch<F::kFCT>(d);
      const auto kernel = s2_silu_tc_kernel<F::I0, F::kFCT, F::kKS, F::kMT>;
      const int grid = singa::persistent_grid(kernel, 32 * l.warps, l.smem,
                                              (tiles<F::kFCT>(d) + l.warps - 1) / l.warps);
      kernel<<<grid, 32 * l.warps, l.smem, (cudaStream_t)stream>>>(x, tg, fg, out, d);
      return (int)cudaGetLastError();
    });
  if (which >= 0) return s2_silu_launch<false>(x, nullptr, tg, fg, out, N, I, C, G, stream);
  return (int)cudaErrorInvalidValue;
}

// K5b, as K5.
extern "C" int s2_silu_bwd_f32(const float* x, const float* g, const float* tg, const float* fg,
                               float* dx, int N, int I, int C, int G, int cuda_cores,
                               void* stream) {
  const int which = N < 1 ? -1 : silu_instance(I, C, G);
  if (which == 1 && !cuda_cores)
    return with_form(I, [&](auto form) {
      using F = decltype(form);
      const SepDims d = silu_bwd_dims<F>(N, I, C, G);
      const TcLaunch l = bwd_launch<F::kBCT>(d);
      const auto kernel = s2_silu_bwd_tc_kernel<F::I0, F::kBCT, F::kKS, F::kMT>;
      const int grid = singa::persistent_grid(kernel, 32 * l.warps, l.smem,
                                              (tiles<F::kBCT>(d) + l.warps - 1) / l.warps);
      kernel<<<grid, 32 * l.warps, l.smem, (cudaStream_t)stream>>>(x, g, tg, fg, dx, d);
      return (int)cudaGetLastError();
    });
  if (which >= 0) return s2_silu_launch<true>(x, g, tg, fg, dx, N, I, C, G, stream);
  return (int)cudaErrorInvalidValue;
}
