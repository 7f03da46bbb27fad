// The stages of the SO(2) edge-attention chain shared by K6 (csrc/so2_attn.cu)
// and K6b (csrc/so2_attn_bwd.cu): the edge-frame rotation and its transpose,
// a GEMM on the tensor cores (three-product split TF32 through
// csrc/mma_tf32.cuh) for the products with the shared convolution weights
// and for the weight gradients (split over edge slices), and the separable
// S2 activation over the hidden channels and its backward.
//
// Per-edge layouts in device memory (one row of floats per edge):
//   rotated message [n_trunc, C]   m-primary rows, so each conv-1 section is
//                                  a contiguous column range
//   conv-1 output   [y1_width]     section 0's rows0*H hidden columns, then
//                                  its `extra` invariant channels, then
//                                  section 1's and section 2's hidden columns:
//                                  each section's product output contiguous
//   mid             [n_trunc, H]   m-primary rows, so each conv-2 section is
//                                  a contiguous column range
#pragma once

#include <stdint.h>

#include "common.cuh"
#include "mma_tf32.cuh"

namespace singa {
namespace so2 {

constexpr int kMaxL = 7;      // degrees the rotation kernels unroll (lmax <= 7)
constexpr int kMaxRows = 32;  // m-primary rows the grid kernels keep in registers
constexpr int kSecs = 3;      // m-primary sections at mmax = 2
constexpr int kRotThreads = 128;
constexpr int kGridThreads = 128;

__host__ __device__ constexpr int j_offset(int l) { return l * (4 * l * l - 1) / 3; }
constexpr int kJFloats = j_offset(kMaxL + 1);  // the diagonal blocks of J up to degree 7

struct Dims {
  int E, lmax, mmax, C, H, F2, extra, alpha_ch, G;
  int n_full, n_trunc;
  int rows[kSecs];    // rows per section: the m=0 rows, the cos and sin rows of m=1, of m=2
  int row0[kSecs];    // first m-primary row of each section
  int out1[kSecs];    // conv-1 output columns per section (section 0 carries `extra`)
  int y1_col[kSecs];  // first column of each section in a conv-1 output row
  int y1_width;       // n_trunc * H + extra
};

inline Dims make_dims(int E, int lmax, int mmax, int C, int H, int F2, int extra, int alpha_ch,
                      int G) {
  Dims d;
  d.E = E, d.lmax = lmax, d.mmax = mmax, d.C = C, d.H = H, d.F2 = F2, d.extra = extra;
  d.alpha_ch = alpha_ch, d.G = G;
  d.n_full = (lmax + 1) * (lmax + 1);
  d.n_trunc = 0;
  for (int l = 0; l <= lmax; ++l) d.n_trunc += 2 * (l < mmax ? l : mmax) + 1;
  d.rows[0] = lmax + 1, d.rows[1] = 2 * lmax, d.rows[2] = 2 * (lmax - 1);
  int r = 0, col = 0;
  for (int s = 0; s < kSecs; ++s) {
    d.row0[s] = r;
    d.out1[s] = d.rows[s] * H + (s == 0 ? extra : 0);
    d.y1_col[s] = col;
    r += d.rows[s];
    col += d.out1[s];
  }
  d.y1_width = col;
  return d;
}

// The shapes the kernels take: mmax 2 (three sections), at most kMaxRows
// m-primary rows (lmax <= 6), the gate channels of `extra` as wide as the
// hidden.
inline bool dims_ok(const Dims& d) {
  return d.E >= 1 && d.mmax == 2 && d.lmax >= 2 && d.lmax <= kMaxL && d.n_trunc <= kMaxRows &&
         d.C >= 1 && d.H >= 1 && d.F2 >= 1 && d.alpha_ch >= 0 && d.extra == d.alpha_ch + d.H &&
         d.G >= 1;
}

// Column of m-primary hidden row r in a conv-1 output row.
__device__ __forceinline__ int y1_row_col(const Dims& d, int r) {
  if (r < d.row0[1]) return r * d.H;
  if (r < d.row0[2]) return d.y1_col[1] + (r - d.row0[1]) * d.H;
  return d.y1_col[2] + (r - d.row0[2]) * d.H;
}

// m-primary row of coefficient (l, m): the m=0 rows by degree, then for each
// m >= 1 its cos (+m) rows for l = m..lmax followed by its sin (-m) rows.
__device__ __forceinline__ int m_row(int l, int m, int lmax) {
  if (m == 0) return l;
  const int am = m < 0 ? -m : m;
  int base = lmax + 1;
  for (int k = 1; k < am; ++k) base += 2 * (lmax + 1 - k);
  return base + (m < 0 ? lmax + 1 - am : 0) + (l - am);
}

// ---------------------------------------------------------------- rotation
//
// D = J_kept Z(-beta) J^T Z(-phi) per degree l, J block-diagonal with blocks
// J_l [(2l+1), (2l+1)]; z(-theta) u [m] = cos(m theta) u[m] + sin(m theta) u[-m].

// J [n_full, n_full] -> its diagonal blocks, row-major, block l at j_offset(l).
__device__ inline void stage_j_blocks(const float* __restrict__ J, int lmax, int n_full,
                                      float* sJ) {
  for (int l = 0; l <= lmax; ++l) {
    const int n = 2 * l + 1;
    for (int t = threadIdx.x; t < n * n; t += blockDim.x)
      sJ[j_offset(l) + t] = J[(l * l + t / n) * n_full + l * l + t % n];
  }
}

struct Trig {
  float cp[kMaxL + 1], sp[kMaxL + 1], cb[kMaxL + 1], sb[kMaxL + 1];  // cos/sin of m*phi, m*beta
};

__device__ __forceinline__ void make_trig(float phi, float beta, Trig& t) {
#pragma unroll
  for (int m = 0; m <= kMaxL; ++m) {
    sincosf(m * phi, &t.sp[m], &t.cp[m]);
    sincosf(m * beta, &t.sb[m], &t.cb[m]);
  }
}

// One degree of the forward rotation for one (edge, channel) column: xe, re,
// m0e, mre point at the column's first coefficient, rows C floats apart.
template <int L>
__device__ __forceinline__ void rot_fwd_degree(const float* sJ, const Trig& tr, int lmax, int mmax,
                                               int C, const float* xe, const float* re, float* m0e,
                                               float* mre) {
  constexpr int n = 2 * L + 1;
  const float* J = sJ + j_offset(L);
  float a[n], b[n];
#pragma unroll
  for (int i = 0; i < n; ++i) {  // z(-phi) x
    const int m = i - L, am = m < 0 ? -m : m;
    const float s = m < 0 ? -tr.sp[am] : tr.sp[am];
    a[i] = fmaf(tr.cp[am], xe[(L * L + i) * C], s * xe[(L * L + n - 1 - i) * C]);
  }
#pragma unroll
  for (int j = 0; j < n; ++j) {  // J^T
    float v = 0.f;
#pragma unroll
    for (int i = 0; i < n; ++i) v = fmaf(J[i * n + j], a[i], v);
    b[j] = v;
  }
#pragma unroll
  for (int i = 0; i < n; ++i) {  // z(-beta)
    const int m = i - L, am = m < 0 ? -m : m;
    const float s = m < 0 ? -tr.sb[am] : tr.sb[am];
    a[i] = fmaf(tr.cb[am], b[i], s * b[n - 1 - i]);
  }
  const int mm = L < mmax ? L : mmax;
#pragma unroll
  for (int i = 0; i < n; ++i) {  // the kept rows of J
    const int m = i - L;
    if (m < -mm || m > mm) continue;
    float v = 0.f;
#pragma unroll
    for (int j = 0; j < n; ++j) v = fmaf(J[i * n + j], a[j], v);
    const int r = m_row(L, m, lmax);
    if (m0e != nullptr) m0e[r * C] = v;
    mre[r * C] = v * re[r * C];
  }
}

template <int L>
__device__ __forceinline__ void rot_fwd(const float* sJ, const Trig& tr, int lmax, int mmax, int C,
                                        const float* xe, const float* re, float* m0e, float* mre) {
  if (L > lmax) return;
  rot_fwd_degree<L>(sJ, tr, lmax, mmax, C, xe, re, m0e, mre);
  if constexpr (L < kMaxL) rot_fwd<L + 1>(sJ, tr, lmax, mmax, C, xe, re, m0e, mre);
}

// mpr = D x * rad per (edge, channel) column, and mp0 = D x when not null.
__global__ void __launch_bounds__(kRotThreads)
rotate_fwd_kernel(const float* __restrict__ x, const float* __restrict__ rad,
                  const float* __restrict__ phi, const float* __restrict__ beta,
                  const float* __restrict__ J, float* __restrict__ mp0, float* __restrict__ mpr,
                  Dims d) {
  __shared__ float sJ[kJFloats];
  stage_j_blocks(J, d.lmax, d.n_full, sJ);
  __syncthreads();
  const long long Q = (long long)d.E * d.C;
  for (long long q = blockIdx.x * (long long)blockDim.x + threadIdx.x; q < Q;
       q += (long long)gridDim.x * blockDim.x) {
    const long long e = q / d.C;
    const int c = (int)(q % d.C);
    Trig tr;
    make_trig(phi[e], beta[e], tr);
    const long long t0 = e * d.n_trunc * d.C + c;
    rot_fwd<0>(sJ, tr, d.lmax, d.mmax, d.C, x + e * d.n_full * d.C + c, rad + t0,
               mp0 != nullptr ? mp0 + t0 : nullptr, mpr + t0);
  }
}

// One degree of the transposed rotation: dmp = dmpr * rad over the kept rows,
// dx = Z(-phi)^T J Z(-beta)^T J_kept^T dmp; drad = dmpr * mp0.
template <int L>
__device__ __forceinline__ void rot_bwd_degree(const float* sJ, const Trig& tr, int lmax, int mmax,
                                               int C, const float* ge, const float* re,
                                               const float* m0e, float* dre, float* dxe) {
  constexpr int n = 2 * L + 1;
  const float* J = sJ + j_offset(L);
  float a[n], b[n];
#pragma unroll
  for (int j = 0; j < n; ++j) a[j] = 0.f;
  const int mm = L < mmax ? L : mmax;
#pragma unroll
  for (int i = 0; i < n; ++i) {  // J_kept^T
    const int m = i - L;
    if (m < -mm || m > mm) continue;
    const int r = m_row(L, m, lmax);
    const float g = ge[r * C];
    dre[r * C] = g * m0e[r * C];
    const float dm = g * re[r * C];
#pragma unroll
    for (int j = 0; j < n; ++j) a[j] = fmaf(J[i * n + j], dm, a[j]);
  }
#pragma unroll
  for (int i = 0; i < n; ++i) {  // z(-beta)^T
    const int m = i - L, am = m < 0 ? -m : m;
    const float s = m < 0 ? -tr.sb[am] : tr.sb[am];
    b[i] = fmaf(tr.cb[am], a[i], -s * a[n - 1 - i]);
  }
#pragma unroll
  for (int i = 0; i < n; ++i) {  // J
    float v = 0.f;
#pragma unroll
    for (int j = 0; j < n; ++j) v = fmaf(J[i * n + j], b[j], v);
    a[i] = v;
  }
#pragma unroll
  for (int i = 0; i < n; ++i) {  // z(-phi)^T
    const int m = i - L, am = m < 0 ? -m : m;
    const float s = m < 0 ? -tr.sp[am] : tr.sp[am];
    dxe[(L * L + i) * C] = fmaf(tr.cp[am], a[i], -s * a[n - 1 - i]);
  }
}

template <int L>
__device__ __forceinline__ void rot_bwd(const float* sJ, const Trig& tr, int lmax, int mmax, int C,
                                        const float* ge, const float* re, const float* m0e,
                                        float* dre, float* dxe) {
  if (L > lmax) return;
  rot_bwd_degree<L>(sJ, tr, lmax, mmax, C, ge, re, m0e, dre, dxe);
  if constexpr (L < kMaxL) rot_bwd<L + 1>(sJ, tr, lmax, mmax, C, ge, re, m0e, dre, dxe);
}

// dx and drad from the cotangent dmpr of the modulated rotated message.
__global__ void __launch_bounds__(kRotThreads)
rotate_bwd_kernel(const float* __restrict__ dmpr, const float* __restrict__ rad,
                  const float* __restrict__ mp0, const float* __restrict__ phi,
                  const float* __restrict__ beta, const float* __restrict__ J,
                  float* __restrict__ dx, float* __restrict__ drad, Dims d) {
  __shared__ float sJ[kJFloats];
  stage_j_blocks(J, d.lmax, d.n_full, sJ);
  __syncthreads();
  const long long Q = (long long)d.E * d.C;
  for (long long q = blockIdx.x * (long long)blockDim.x + threadIdx.x; q < Q;
       q += (long long)gridDim.x * blockDim.x) {
    const long long e = q / d.C;
    const int c = (int)(q % d.C);
    Trig tr;
    make_trig(phi[e], beta[e], tr);
    const long long t0 = e * d.n_trunc * d.C + c;
    rot_bwd<0>(sJ, tr, d.lmax, d.mmax, d.C, dmpr + t0, rad + t0, mp0 + t0, drad + t0,
               dx + e * d.n_full * d.C + c);
  }
}

inline cudaError_t rotate_fwd(const float* x, const float* rad, const float* phi,
                              const float* beta, const float* J, float* mp0, float* mpr,
                              const Dims& d, cudaStream_t st) {
  const long long Q = (long long)d.E * d.C;
  const int grid = persistent_grid(rotate_fwd_kernel, kRotThreads, 0,
                                   (Q + kRotThreads - 1) / kRotThreads);
  rotate_fwd_kernel<<<grid, kRotThreads, 0, st>>>(x, rad, phi, beta, J, mp0, mpr, d);
  return cudaGetLastError();
}

inline cudaError_t rotate_bwd(const float* dmpr, const float* rad, const float* mp0,
                              const float* phi, const float* beta, const float* J, float* dx,
                              float* drad, const Dims& d, cudaStream_t st) {
  const long long Q = (long long)d.E * d.C;
  const int grid = persistent_grid(rotate_bwd_kernel, kRotThreads, 0,
                                   (Q + kRotThreads - 1) / kRotThreads);
  rotate_bwd_kernel<<<grid, kRotThreads, 0, st>>>(dmpr, rad, mp0, phi, beta, J, dx, drad, d);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- GEMM
//
// C[m, n] = sum_k A[m, k] B[k, n] (+ bias[n]) on the tensor cores, as
// three-product split TF32 (csrc/mma_tf32.cuh: mma.sync.m16n8k8, float32
// accumulation, equal to a float32 product to round-off). A[m, k] is
// A[m*lda + k], or A[k*lda + m] when TA; B[k, n] is B[k*ldb + n], or
// B[n*ldb + k] when TB. gridDim.z splits k into equal slices of whole BK
// steps: slice z writes its own sum to C + z * split_stride (the weight
// gradients' partial sums, added in slice order by sum_rows_kernel).
//
// A block computes a kBM x kBN tile from BK-deep slabs. cp.async copies
// each slab of A and B from device memory into shared memory as it lies,
// A [m][k] or [k][m], B [k][n] or [n][k], with rows padded to the strides
// of mma_tf32.cuh's bank rules: the orientation is settled in the copy,
// the inner loop is one. 16-byte copies in the kernel for operands whose
// address and row stride allow them, 4-byte ones in the other; zeros past
// M, N and the slice. A ring of kStages slabs keeps kStages - 1 slabs of
// copies in flight, in no registers, one barrier a slab. 8 warps, each a
// 64 x 32 tile of m16n8 accumulators. The fragments are split into TF32
// hi and lo as they load (the frag_* loaders): planes split beforehand
// would double the bytes the warps read from shared memory, and the
// shared-memory traffic, not the splits, held that version back on the
// H100. The three products of one accumulator are issued lo_a hi_b,
// hi_a lo_b, hi_a hi_b, each round over the warp's n8 tiles, so no two
// neighbouring mma share an accumulator.
//
// The tensor cores add into their float32 accumulator without rounding to
// nearest (the low bits are cut), an error that grows with the number of
// mma chained into one accumulator: ~1e-5 of the largest output at a
// depth of 1,536 on the H100 when the whole depth is chained. So each
// slab's products go into fresh accumulators, added to the block's float32
// sums by ordinary (rounded) adds after the slab: chains of 3 * BK / 8
// mma. The sum over k runs in order, so the result does not depend on the
// launch.
//
// On the H100 (nvcc -Xptxas -v, sm_90a): 255 registers NN, 237 NT, 228 TN,
// no spills; 207 / 216 / 102 KB of shared memory; one block of 8 warps an
// SM. Two blocks an SM (128 registers: spills) and a split pass from raw
// slabs into hi/lo planes ran slower; 64-deep slabs ran faster for NN and
// NT, slower for TN.
constexpr int kBM = 128, kBN = 128, kGemmThreads = 256, kStages = 3;

template <bool TA, bool TB>
struct GemmTile {
  static_assert(!(TA && TB), "no product reads both operands transposed");
  static constexpr int WN = 4, WM = kGemmThreads / 32 / WN;  // warps
  static constexpr int WTM = kBM / WM, WTN = kBN / WN;        // warp tile
  static constexpr int MT = WTM / 16, NT = WTN / 8;           // mma tiles
  static constexpr int BK = TA ? 32 : 64;  // slab depth
  // slabs as they lie in device memory: rows of contiguous floats
  static constexpr int A_ROWS = TA ? BK : kBM, A_COLS = TA ? kBM : BK;
  static constexpr int B_ROWS = TB ? kBN : BK, B_COLS = TB ? BK : kBN;
  // strides (floats, multiples of 4): [m][k], [n][k] paired, 8-byte loads:
  // ld % 32 of 8 or 24; [k][m] and, beside it, [k][n] in order: the same;
  // [k][n] paired: ld % 16 of 4 or 12
  static constexpr int LA = A_COLS + 8;
  static constexpr int LB = TB ? BK + 8 : (TA ? kBN + 8 : kBN + 4);
  static constexpr int A_FLOATS = A_ROWS * LA, B_FLOATS = B_ROWS * LB;
  static constexpr int STAGE = A_FLOATS + B_FLOATS;
  static constexpr size_t SMEM = (size_t)kStages * STAGE * sizeof(float);
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// every group of this thread's copies but the newest kStages - 2 complete
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
}

// every group complete (the empty groups past the last slab: nothing is
// left in flight when the block ends)
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// One operand's slab into shared memory [ROWS][ld]: row r from
// p + (r0 + r) * ld_p + c0, rows valid below rlim, columns below clim,
// zeros past them. VEC: p and ld_p 16-byte aligned, 16-byte copies (the
// limits cut a copy only at a slice's or M's or N's end); else 4-byte ones.
// A copy that reads nothing gets a valid address all the same.
template <int ROWS, int COLS, bool VEC>
__device__ __forceinline__ void copy_slab(const float* __restrict__ p, long long ld_p, int r0,
                                          int rlim, int c0, int clim, float* dst, int ld) {
  constexpr int C4 = COLS / 4, V = ROWS * C4 / kGemmThreads;
  static_assert(V * kGemmThreads == ROWS * C4, "slab");
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int idx = threadIdx.x + v * kGemmThreads;
    const int r = idx / C4, c = 4 * (idx % C4);
    const int gr = r0 + r, gc = c0 + c;
    const int n = gr < rlim ? max(0, min(4, clim - gc)) : 0;  // floats in range
    const float* src = n > 0 ? p + (long long)gr * ld_p + gc : p;
    float* d = dst + r * ld + c;
    if (VEC) {
      cp_async16(d, src, 4 * n);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) cp_async4(d + q, q < n ? src + q : p, q < n ? 4 : 0);
    }
  }
}

template <bool TA, bool TB, bool VEC>
__global__ void __launch_bounds__(kGemmThreads)
gemm_kernel(const float* __restrict__ A, long long lda, const float* __restrict__ B,
            long long ldb, float* __restrict__ C, long long ldc, int M, int N, int K,
            const float* __restrict__ bias, int kslice, long long split_stride, bool vec_c) {
  using T = GemmTile<TA, TB>;
  extern __shared__ __align__(16) float gsm[];
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int kb = blockIdx.z * kslice;
  const int ke = min(K, kb + kslice);
  const int steps = ke > kb ? (ke - kb + T::BK - 1) / T::BK : 0;
  const int warp = threadIdx.x / 32;
  const int wm = (warp / T::WN) * T::WTM, wn = (warp % T::WN) * T::WTN;
  float acc[T::MT][T::NT][4];
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  // slab s of the slice into stage s % kStages (a group, empty past the end)
  auto copy = [&](int s) {
    if (s < steps) {
      float* sa = gsm + (s % kStages) * T::STAGE;
      float* sb = sa + T::A_FLOATS;
      const int k0 = kb + s * T::BK;
      copy_slab<T::A_ROWS, T::A_COLS, VEC>(A, lda, TA ? k0 : m0, TA ? ke : M, TA ? m0 : k0,
                                           TA ? M : ke, sa, T::LA);
      copy_slab<T::B_ROWS, T::B_COLS, VEC>(B, ldb, TB ? n0 : k0, TB ? N : ke, TB ? k0 : n0,
                                           TB ? ke : N, sb, T::LB);
    }
    cp_async_commit();
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) copy(s);
  for (int s = 0; s < steps; ++s) {
    cp_async_wait();  // slab s is in its stage (this thread's copies)
    __syncthreads();  // everyone's copies; slab s - 1's readers done
    copy(s + kStages - 1);  // into the stage slab s - 1 left
    const float* sa = gsm + (s % kStages) * T::STAGE;
    const float* sb = sa + T::A_FLOATS;
    float part[T::MT][T::NT][4];  // this slab's sums
#pragma unroll
    for (int i = 0; i < T::MT; ++i)
#pragma unroll
      for (int j = 0; j < T::NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) part[i][j][q] = 0.f;
#pragma unroll
    for (int kk = 0; kk < T::BK; kk += 8) {
      tc::FragB fb[T::NT];
#pragma unroll
      for (int j = 0; j < T::NT; ++j) {
        const int n = wn + 8 * j;
        if (TB)
          fb[j] = tc::frag_b_nk(sb + n * T::LB + kk, T::LB);
        else if (TA)
          fb[j] = tc::frag_b(sb + kk * T::LB + n, T::LB);
        else
          fb[j] = tc::frag_b_paired(sb + kk * T::LB + n, T::LB);
      }
#pragma unroll
      for (int i = 0; i < T::MT; ++i) {
        const int m = wm + 16 * i;
        const tc::FragA fa = TA ? tc::frag_a_trans(sa + kk * T::LA + m, T::LA)
                                : tc::frag_a_paired(sa + m * T::LA + kk, T::LA);
#pragma unroll
        for (int j = 0; j < T::NT; ++j) tc::mma(part[i][j], fa.lo, fb[j].hi);
#pragma unroll
        for (int j = 0; j < T::NT; ++j) tc::mma(part[i][j], fa.hi, fb[j].lo);
#pragma unroll
        for (int j = 0; j < T::NT; ++j) tc::mma(part[i][j], fa.hi, fb[j].hi);
      }
    }
#pragma unroll
    for (int i = 0; i < T::MT; ++i)
#pragma unroll
      for (int j = 0; j < T::NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] += part[i][j][q];
  }
  cp_async_wait_all();

  // c0, c1 at (grp, 2 tig, 2 tig + 1) of each m16n8 tile, c2, c3 eight rows below
  float* Cz = C + blockIdx.z * split_stride;
  const int g = tc::lane_grp(), t = tc::lane_tig();
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j) {
      const int n = n0 + wn + 8 * j + 2 * t;
      const float b0 = bias != nullptr && n < N ? bias[n] : 0.f;
      const float b1 = bias != nullptr && n + 1 < N ? bias[n + 1] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + 16 * i + g + 8 * h;
        if (m >= M) continue;
        float* row = Cz + (long long)m * ldc;
        const float v0 = acc[i][j][2 * h] + b0, v1 = acc[i][j][2 * h + 1] + b1;
        if (vec_c && n + 1 < N) {
          *reinterpret_cast<float2*>(row + n) = make_float2(v0, v1);
        } else {
          if (n < N) row[n] = v0;
          if (n + 1 < N) row[n + 1] = v1;
        }
      }
    }
}

inline bool aligned16(const void* p, long long ld) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && ld % 4 == 0;
}

// One product, k split into `splits` slices (1: C is the product itself).
template <bool TA, bool TB>
cudaError_t gemm(const float* A, long long lda, const float* B, long long ldb, float* C,
                 long long ldc, int M, int N, int K, const float* bias, int splits,
                 long long split_stride, cudaStream_t st) {
  using T = GemmTile<TA, TB>;
  const int steps = (K + T::BK - 1) / T::BK;
  const int kslice = (steps + splits - 1) / splits * T::BK;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
  const bool vec_c = reinterpret_cast<uintptr_t>(C) % 8 == 0 && ldc % 2 == 0 &&
                     split_stride % 2 == 0;
  // the kernel of 16-byte copies when both operands allow them. Opted in at
  // every launch: a function-local static here would be one object for
  // every library that instantiates this template (a GNU unique symbol), so
  // a second library's kernel would never be.
  auto kernel = aligned16(A, lda) && aligned16(B, ldb) ? gemm_kernel<TA, TB, true>
                                                       : gemm_kernel<TA, TB, false>;
  const cudaError_t opted = allow_smem(kernel, T::SMEM);
  if (opted != cudaSuccess) return opted;
  kernel<<<grid, kGemmThreads, T::SMEM, st>>>(A, lda, B, ldb, C, ldc, M, N, K, bias, kslice,
                                              split_stride, vec_c);
  return cudaGetLastError();
}

// Resident blocks per SM of gemm<TA, TB>'s kernel of 16-byte copies; its
// dynamic shared memory in *smem_bytes. -1 on failure.
template <bool TA, bool TB>
int gemm_residency(int* smem_bytes) {
  using T = GemmTile<TA, TB>;
  *smem_bytes = (int)T::SMEM;
  if (allow_smem(gemm_kernel<TA, TB, true>, T::SMEM) != cudaSuccess) return -1;
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gemm_kernel<TA, TB, true>,
                                                    kGemmThreads, T::SMEM) != cudaSuccess)
    return -1;
  return per_sm;
}

inline int sm_count() {
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// Edge slices of a weight gradient [M, N] = sum over E edges: enough blocks
// for two waves of the card, at least 256 edges a slice.
inline int grad_splits(int M, int N, int E) {
  const long long tiles = (long long)((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  long long s = (2LL * sm_count() + tiles - 1) / tiles;
  const long long most = (E + 255) / 256;
  if (s > most) s = most;
  return s < 1 ? 1 : (int)s;
}

// partial[z][n] = sum over the z-th slice of rows e of A[e * lda + n], in order.
__global__ void col_sum_kernel(const float* __restrict__ A, long long lda, int rows, int N,
                               int slice, float* __restrict__ partial) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int e1 = min(rows, (int)(blockIdx.y + 1) * slice);
  float v = 0.f;
  for (int e = blockIdx.y * slice; e < e1; ++e) v += A[(long long)e * lda + n];
  partial[(long long)blockIdx.y * N + n] = v;
}

inline int col_splits(int E) { return E < 256 ? 1 : (E / 256 < 128 ? E / 256 : 128); }

// out[n] = sum over rows e of A[e * lda + n]: slices, then their sum in order.
inline cudaError_t col_sum(const float* A, long long lda, int rows, int N, float* partial,
                           float* out, cudaStream_t st) {
  const int splits = col_splits(rows);
  const int slice = (rows + splits - 1) / splits;
  col_sum_kernel<<<dim3((N + 255) / 256, splits), 256, 0, st>>>(A, lda, rows, N, slice, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_rows_kernel<<<(N + 255) / 256, 256, 0, st>>>(partial, out, N, splits);
  return cudaGetLastError();
}

// out [M, N] = sum over E edges of A_e^T B_e (TA product), in edge slices
// whose partial sums are added in slice order.
inline cudaError_t weight_grad(const float* A, long long lda, const float* B, long long ldb,
                               int M, int N, int E, float* partial, float* out, cudaStream_t st) {
  const int splits = grad_splits(M, N, E);
  const long long P = (long long)M * N;
  cudaError_t err = gemm<true, false>(A, lda, B, ldb, partial, N, M, N, E, nullptr, splits, P, st);
  if (err != cudaSuccess) return err;
  const int grid = persistent_grid(sum_rows_kernel, 256, 0, (P + 255) / 256);
  sum_rows_kernel<<<grid, 256, 0, st>>>(partial, out, P, splits);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- S2 activation
//
// K3's column design over the hidden channels of a conv-1 output row: one
// thread owns one (edge, hidden channel) column, keeps its n_trunc
// coefficients in registers, and walks the G grid points with tg and fg in
// shared memory (rows zero-padded to kMaxRows floats: 16-byte broadcasts).

// tg/fg [G, I] -> shared [G, kMaxRows]; fg's row 0 zeroed when skip_row0.
__device__ inline void stage_grid_rows(const float* __restrict__ tg, const float* __restrict__ fg,
                                       int G, int I, bool skip_row0, float* stg, float* sfg) {
  for (int t = threadIdx.x; t < G * kMaxRows; t += blockDim.x) {
    const int g = t / kMaxRows, j = t % kMaxRows;
    stg[t] = j < I ? tg[g * I + j] : 0.f;
    sfg[t] = (j < I && !(skip_row0 && j == 0)) ? fg[g * I + j] : 0.f;
  }
}

// mid[e, i, k] = sum_g fg[g, i] silu(sum_j tg[g, j] h[e, j, k]) for i >= 1,
// mid[e, 0, k] = silu(gate[e, k]); h and gate read from the conv-1 output y1
// (gate = its extra channels from alpha_ch). extra_out, when not null,
// receives each edge's extra channels.
__global__ void __launch_bounds__(kGridThreads)
grid_fwd_kernel(const float* __restrict__ y1, const float* __restrict__ tg,
                const float* __restrict__ fg, float* __restrict__ mid,
                float* __restrict__ extra_out, Dims d) {
  extern __shared__ __align__(16) float smem[];
  float* stg = smem;
  float* sfg = smem + d.G * kMaxRows;
  const int I = d.n_trunc;
  stage_grid_rows(tg, fg, d.G, I, false, stg, sfg);
  __syncthreads();
  const int cblocks = (d.H + kGridThreads - 1) / kGridThreads;
  const long long jobs = (long long)d.E * cblocks;
  for (long long job = blockIdx.x; job < jobs; job += gridDim.x) {
    const long long e = job / cblocks;
    const int cb = (int)(job % cblocks);
    const float* ye = y1 + e * d.y1_width;
    const float* xe = ye + d.rows[0] * d.H;  // the edge's extra channels
    if (extra_out != nullptr && cb == 0)
      for (int q = threadIdx.x; q < d.extra; q += blockDim.x) extra_out[e * d.extra + q] = xe[q];
    const int k = cb * kGridThreads + threadIdx.x;
    if (k >= d.H) continue;
    float hv[kMaxRows], acc[kMaxRows];
#pragma unroll
    for (int j = 0; j < kMaxRows; ++j) {
      hv[j] = j < I ? ye[y1_row_col(d, j) + k] : 0.f;
      acc[j] = 0.f;
    }
    for (int g = 0; g < d.G; ++g) {
      const float4* tr = reinterpret_cast<const float4*>(stg + g * kMaxRows);
      const float4* fr = reinterpret_cast<const float4*>(sfg + g * kMaxRows);
      float v = 0.f;
#pragma unroll
      for (int j4 = 0; j4 < kMaxRows / 4; ++j4) {
        const float4 w = tr[j4];
        v = fmaf(w.x, hv[4 * j4], v);
        v = fmaf(w.y, hv[4 * j4 + 1], v);
        v = fmaf(w.z, hv[4 * j4 + 2], v);
        v = fmaf(w.w, hv[4 * j4 + 3], v);
      }
      const float a = siluf_(v);
#pragma unroll
      for (int j4 = 0; j4 < kMaxRows / 4; ++j4) {
        const float4 w = fr[j4];
        acc[4 * j4] = fmaf(w.x, a, acc[4 * j4]);
        acc[4 * j4 + 1] = fmaf(w.y, a, acc[4 * j4 + 1]);
        acc[4 * j4 + 2] = fmaf(w.z, a, acc[4 * j4 + 2]);
        acc[4 * j4 + 3] = fmaf(w.w, a, acc[4 * j4 + 3]);
      }
    }
    float* me = mid + e * I * d.H + k;
    me[0] = siluf_(xe[d.alpha_ch + k]);
#pragma unroll
    for (int j = 1; j < kMaxRows; ++j)
      if (j < I) me[(long long)j * d.H] = acc[j];
  }
}

// The backward of grid_fwd_kernel, written as a conv-1 output cotangent dy1:
//   dy1 hidden rows = tg^T (silu'(tg h) * fg' dmid)   (fg' without row 0)
//   dy1 extra       = dextra, plus silu'(gate) * dmid[0] on the gate channels
// Row 0 of dmid reaches only the gate.
__global__ void __launch_bounds__(kGridThreads)
grid_bwd_kernel(const float* __restrict__ y1, const float* __restrict__ dmid,
                const float* __restrict__ dextra, const float* __restrict__ tg,
                const float* __restrict__ fg, float* __restrict__ dy1, Dims d) {
  extern __shared__ __align__(16) float smem[];
  float* stg = smem;
  float* sfg = smem + d.G * kMaxRows;
  const int I = d.n_trunc;
  stage_grid_rows(tg, fg, d.G, I, true, stg, sfg);
  __syncthreads();
  const int cblocks = (d.H + kGridThreads - 1) / kGridThreads;
  const long long jobs = (long long)d.E * cblocks;
  for (long long job = blockIdx.x; job < jobs; job += gridDim.x) {
    const long long e = job / cblocks;
    const int cb = (int)(job % cblocks);
    const float* ye = y1 + e * d.y1_width;
    float* de = dy1 + e * d.y1_width;
    const float* dxe = dextra + e * d.extra;
    const int x0 = d.rows[0] * d.H;  // the extra channels' first column
    if (cb == 0)
      for (int q = threadIdx.x; q < d.alpha_ch; q += blockDim.x) de[x0 + q] = dxe[q];
    const int k = cb * kGridThreads + threadIdx.x;
    if (k >= d.H) continue;
    const float* ge = dmid + e * I * d.H + k;
    float hv[kMaxRows], gv[kMaxRows], acc[kMaxRows];
#pragma unroll
    for (int j = 0; j < kMaxRows; ++j) {
      hv[j] = j < I ? ye[y1_row_col(d, j) + k] : 0.f;
      gv[j] = j < I ? ge[(long long)j * d.H] : 0.f;
      acc[j] = 0.f;
    }
    for (int g = 0; g < d.G; ++g) {
      const float4* tr = reinterpret_cast<const float4*>(stg + g * kMaxRows);
      const float4* fr = reinterpret_cast<const float4*>(sfg + g * kMaxRows);
      float v = 0.f, u = 0.f;
#pragma unroll
      for (int j4 = 0; j4 < kMaxRows / 4; ++j4) {
        const float4 w = tr[j4];
        const float4 f = fr[j4];
        v = fmaf(w.x, hv[4 * j4], v);
        v = fmaf(w.y, hv[4 * j4 + 1], v);
        v = fmaf(w.z, hv[4 * j4 + 2], v);
        v = fmaf(w.w, hv[4 * j4 + 3], v);
        u = fmaf(f.x, gv[4 * j4], u);
        u = fmaf(f.y, gv[4 * j4 + 1], u);
        u = fmaf(f.z, gv[4 * j4 + 2], u);
        u = fmaf(f.w, gv[4 * j4 + 3], u);
      }
      const float hg = silu_gradf_(v) * u;
#pragma unroll
      for (int j4 = 0; j4 < kMaxRows / 4; ++j4) {
        const float4 w = tr[j4];
        acc[4 * j4] = fmaf(w.x, hg, acc[4 * j4]);
        acc[4 * j4 + 1] = fmaf(w.y, hg, acc[4 * j4 + 1]);
        acc[4 * j4 + 2] = fmaf(w.z, hg, acc[4 * j4 + 2]);
        acc[4 * j4 + 3] = fmaf(w.w, hg, acc[4 * j4 + 3]);
      }
    }
    de[x0 + d.alpha_ch + k] = dxe[d.alpha_ch + k] + silu_gradf_(ye[x0 + d.alpha_ch + k]) * gv[0];
#pragma unroll
    for (int j = 0; j < kMaxRows; ++j)
      if (j < I) de[y1_row_col(d, j) + k] = acc[j];
  }
}

inline size_t grid_smem(const Dims& d) { return 2 * (size_t)d.G * kMaxRows * sizeof(float); }

template <typename Kernel>
inline cudaError_t grid_launch_config(Kernel kernel, const Dims& d, int* blocks) {
  cudaError_t err = allow_smem(kernel, grid_smem(d));
  if (err != cudaSuccess) return err;
  const long long jobs = (long long)d.E * ((d.H + kGridThreads - 1) / kGridThreads);
  *blocks = persistent_grid(kernel, kGridThreads, grid_smem(d), jobs);
  return cudaSuccess;
}

inline cudaError_t grid_fwd(const float* y1, const float* tg, const float* fg, float* mid,
                            float* extra_out, const Dims& d, cudaStream_t st) {
  int blocks = 0;
  cudaError_t err = grid_launch_config(grid_fwd_kernel, d, &blocks);
  if (err != cudaSuccess) return err;
  grid_fwd_kernel<<<blocks, kGridThreads, grid_smem(d), st>>>(y1, tg, fg, mid, extra_out, d);
  return cudaGetLastError();
}

inline cudaError_t grid_bwd(const float* y1, const float* dmid, const float* dextra,
                            const float* tg, const float* fg, float* dy1, const Dims& d,
                            cudaStream_t st) {
  int blocks = 0;
  cudaError_t err = grid_launch_config(grid_bwd_kernel, d, &blocks);
  if (err != cudaSuccess) return err;
  grid_bwd_kernel<<<blocks, kGridThreads, grid_smem(d), st>>>(y1, dmid, dextra, tg, fg, dy1, d);
  return cudaGetLastError();
}

// conv-1 products of the rotated, modulated message mpr into y1 (b1 on
// section 0) and the S2 activation into mid: the forward up to mid, which
// K6 continues into conv 2 and K6b differentiates.
inline cudaError_t forward_to_mid(const float* mpr, const float* const* w1s, const float* b1,
                                  const float* tg, const float* fg, float* y1, float* mid,
                                  float* extra_out, const Dims& d, cudaStream_t st) {
  const long long ldm = (long long)d.n_trunc * d.C;
  for (int s = 0; s < kSecs; ++s) {
    const cudaError_t err = gemm<false, false>(
        mpr + d.row0[s] * d.C, ldm, w1s[s], d.out1[s], y1 + d.y1_col[s], d.y1_width, d.E,
        d.out1[s], d.rows[s] * d.C, s == 0 ? b1 : nullptr, 1, 0, st);
    if (err != cudaSuccess) return err;
  }
  return grid_fwd(y1, tg, fg, mid, extra_out, d, st);
}

}  // namespace so2
}  // namespace singa
