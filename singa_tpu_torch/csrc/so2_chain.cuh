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
//
// bfloat16 (K6·bf16, K6b·bf16: the stages at storage type T = bf16). The
// Pallas kernel at a bfloat16 x rounds J, the grids and the weights, the
// rotation's two products before J^T and its two z(-beta) terms before
// J_kept, the modulated message, the hidden rows before the grid, silu of
// the grid, mid, and the outputs; in the backward the dmpr * rad product,
// the z(-beta)^T term, silu'(grid) times the lifted cotangent, dmid (after
// its row 0 gave the gate's cotangent in float32) and dy (after its
// section 0 gave db1 in float32); everything else sums in float32. The
// stages round at those points (rnd<T>, the identity at T = float), keep
// in bfloat16 what the Pallas kernel rounds (the modulated message, mid,
// dy, the outputs) and in float32 what it does not (the rotated message
// before the modulation, the conv-1 output whose extra channels feed the
// gate, dmid, dmpr); the GEMM reads bfloat16 operands and issues one
// bfloat16 m16n8k16 mma.sync for each 16-deep product (csrc/mma_bf16.cuh:
// its products of two bfloat16 values exact in float32), and the grid
// stages run K3·bf16's and K3b·bf16's tensor-core chains
// (grid_fwd_tc_kernel, grid_bwd_tc_kernel below).
#pragma once

#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "mma_bf16.cuh"
#include "mma_tf32.cuh"
#include "s2_grid_tc.cuh"

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

// J [n_full, n_full] -> its diagonal blocks, row-major, block l at j_offset(l)
// (rounded to T's precision).
template <class T = float>
__device__ inline void stage_j_blocks(const float* __restrict__ J, int lmax, int n_full,
                                      float* sJ) {
  for (int l = 0; l <= lmax; ++l) {
    const int n = 2 * l + 1;
    for (int t = threadIdx.x; t < n * n; t += blockDim.x)
      sJ[j_offset(l) + t] = rnd<T>(J[(l * l + t / n) * n_full + l * l + t % n]);
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
// m0e, mre point at the column's first coefficient, rows C elements apart.
// At bf16 the two products of each z-rotation term are rounded apart (the
// Pallas kernel's x cos and x sin, then t2 cos and t2 sin, each rounded
// before its J product).
template <int L, class T>
__device__ __forceinline__ void rot_fwd_degree(const float* sJ, const Trig& tr, int lmax, int mmax,
                                               int C, const T* xe, const T* re, float* m0e,
                                               T* mre) {
  constexpr int n = 2 * L + 1;
  const float* J = sJ + j_offset(L);
  float a[n], b[n];
#pragma unroll
  for (int i = 0; i < n; ++i) {  // z(-phi) x
    const int m = i - L, am = m < 0 ? -m : m;
    const float s = m < 0 ? -tr.sp[am] : tr.sp[am];
    if constexpr (kBf16<T>)
      a[i] = rnd<T>(tr.cp[am] * to_f(xe[(L * L + i) * C])) +
             rnd<T>(s * to_f(xe[(L * L + n - 1 - i) * C]));
    else
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
    if constexpr (kBf16<T>)
      a[i] = rnd<T>(tr.cb[am] * b[i]) + rnd<T>(s * b[n - 1 - i]);
    else
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
    mre[r * C] = from_f<T>(v * to_f(re[r * C]));
  }
}

template <int L, class T>
__device__ __forceinline__ void rot_fwd(const float* sJ, const Trig& tr, int lmax, int mmax, int C,
                                        const T* xe, const T* re, float* m0e, T* mre) {
  if (L > lmax) return;
  rot_fwd_degree<L>(sJ, tr, lmax, mmax, C, xe, re, m0e, mre);
  if constexpr (L < kMaxL) rot_fwd<L + 1>(sJ, tr, lmax, mmax, C, xe, re, m0e, mre);
}

// mpr = D x * rad per (edge, channel) column (rounded to T), and mp0 = D x
// (float32) when not null.
template <class T = float>
__global__ void __launch_bounds__(kRotThreads)
rotate_fwd_kernel(const T* __restrict__ x, const T* __restrict__ rad,
                  const float* __restrict__ phi, const float* __restrict__ beta,
                  const float* __restrict__ J, float* __restrict__ mp0, T* __restrict__ mpr,
                  Dims d) {
  __shared__ float sJ[kJFloats];
  stage_j_blocks<T>(J, d.lmax, d.n_full, sJ);
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
// dx = Z(-phi)^T J Z(-beta)^T J_kept^T dmp; drad = dmpr * mp0. At bf16 dmp
// and the z(-beta)^T term are rounded (the Pallas kernel's dmpT and dt2).
template <int L, class T>
__device__ __forceinline__ void rot_bwd_degree(const float* sJ, const Trig& tr, int lmax, int mmax,
                                               int C, const float* ge, const T* re,
                                               const float* m0e, T* dre, T* dxe) {
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
    dre[r * C] = from_f<T>(g * m0e[r * C]);
    const float dm = rnd<T>(g * to_f(re[r * C]));
#pragma unroll
    for (int j = 0; j < n; ++j) a[j] = fmaf(J[i * n + j], dm, a[j]);
  }
#pragma unroll
  for (int i = 0; i < n; ++i) {  // z(-beta)^T
    const int m = i - L, am = m < 0 ? -m : m;
    const float s = m < 0 ? -tr.sb[am] : tr.sb[am];
    b[i] = rnd<T>(fmaf(tr.cb[am], a[i], -s * a[n - 1 - i]));
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
    dxe[(L * L + i) * C] = from_f<T>(fmaf(tr.cp[am], a[i], -s * a[n - 1 - i]));
  }
}

template <int L, class T>
__device__ __forceinline__ void rot_bwd(const float* sJ, const Trig& tr, int lmax, int mmax, int C,
                                        const float* ge, const T* re, const float* m0e,
                                        T* dre, T* dxe) {
  if (L > lmax) return;
  rot_bwd_degree<L>(sJ, tr, lmax, mmax, C, ge, re, m0e, dre, dxe);
  if constexpr (L < kMaxL) rot_bwd<L + 1>(sJ, tr, lmax, mmax, C, ge, re, m0e, dre, dxe);
}

// dx and drad from the (float32) cotangent dmpr of the modulated rotated
// message.
template <class T = float>
__global__ void __launch_bounds__(kRotThreads)
rotate_bwd_kernel(const float* __restrict__ dmpr, const T* __restrict__ rad,
                  const float* __restrict__ mp0, const float* __restrict__ phi,
                  const float* __restrict__ beta, const float* __restrict__ J,
                  T* __restrict__ dx, T* __restrict__ drad, Dims d) {
  __shared__ float sJ[kJFloats];
  stage_j_blocks<T>(J, d.lmax, d.n_full, sJ);
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

template <class T>
inline cudaError_t rotate_fwd(const T* x, const T* rad, const float* phi, const float* beta,
                              const float* J, float* mp0, T* mpr, const Dims& d,
                              cudaStream_t st) {
  const long long Q = (long long)d.E * d.C;
  const int grid = persistent_grid(rotate_fwd_kernel<T>, kRotThreads, 0,
                                   (Q + kRotThreads - 1) / kRotThreads);
  rotate_fwd_kernel<T><<<grid, kRotThreads, 0, st>>>(x, rad, phi, beta, J, mp0, mpr, d);
  return cudaGetLastError();
}

template <class T>
inline cudaError_t rotate_bwd(const float* dmpr, const T* rad, const float* mp0,
                              const float* phi, const float* beta, const float* J, T* dx,
                              T* drad, const Dims& d, cudaStream_t st) {
  const long long Q = (long long)d.E * d.C;
  const int grid = persistent_grid(rotate_bwd_kernel<T>, kRotThreads, 0,
                                   (Q + kRotThreads - 1) / kRotThreads);
  rotate_bwd_kernel<T><<<grid, kRotThreads, 0, st>>>(dmpr, rad, mp0, phi, beta, J, dx, drad, d);
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
// NT, slower for TN. The bfloat16 instances of 16-byte copies: 167
// registers NN and 169 NT, no spills, 128 TN, 12 bytes spilled; at a step of
// train_so2_bf16 (252 launches) 45.6 ms of device time against the
// one-TF32-product form's 68.0 (tools/bf16_kernels_ab.py, the parent in
// the same call; an H100 80GB HBM3 at 700 W).
//
// The GEMM's types, its template parameter P: float (float operands in
// split TF32, float output), or Bf16In<Out> (K6·bf16's and K6b·bf16's:
// bfloat16 operands, rows of bfloat16 in shared memory at the same slab
// shapes, each 16-deep step one bfloat16 m16n8k16 mma.sync a tile
// (csrc/mma_bf16.cuh) on fragments ldmatrix reads, .trans for the operands
// stored [k][m] and [k][n]: the products exact, the sums float32 as the
// split form's, chains of BK / 16 mma a slab; the output of type Out,
// float or rounded to bfloat16).
constexpr int kBM = 128, kBN = 128, kGemmThreads = 256, kStages = 3;

template <class Out>
struct Bf16In {};
template <class P>
struct GemmTypes {
  using In = float;
  using Out = float;
};
template <class O>
struct GemmTypes<Bf16In<O>> {
  using In = bf16;
  using Out = O;
};
// The GEMM of the stages at storage type T, with output Out
template <class T, class Out = float>
using GemmAt = typename std::conditional<kBf16<T>, Bf16In<Out>, float>::type;

template <bool TA, bool TB, class P = float>
struct GemmTile {
  static_assert(!(TA && TB), "no product reads both operands transposed");
  using S = typename GemmTypes<P>::In;  // an operand's element in memory
  static constexpr bool kB16 = kBf16<S>;
  static constexpr int WN = 4, WM = kGemmThreads / 32 / WN;  // warps
  static constexpr int WTM = kBM / WM, WTN = kBN / WN;        // warp tile
  static constexpr int MT = WTM / 16, NT = WTN / 8;           // mma tiles
  static constexpr int BK = TA ? 32 : 64;  // slab depth
  // slabs as they lie in device memory: rows of contiguous elements
  static constexpr int A_ROWS = TA ? BK : kBM, A_COLS = TA ? kBM : BK;
  static constexpr int B_ROWS = TB ? kBN : BK, B_COLS = TB ? BK : kBN;
  // strides (elements; float: multiples of 4): [m][k], [n][k] paired, 8-byte
  // loads: ld % 32 of 8 or 24; [k][m] and, beside it, [k][n] in order: the
  // same; [k][n] paired: ld % 16 of 4 or 12. bfloat16: rows of an odd
  // number of 16-byte units (ldmatrix's 8-row phases conflict-free)
  static constexpr int LA = A_COLS + 8;
  static constexpr int LB = TB ? BK + 8 : (TA || kB16 ? kBN + 8 : kBN + 4);
  static constexpr int A_ELEMS = A_ROWS * LA, B_ELEMS = B_ROWS * LB;
  static constexpr int STAGE = A_ELEMS + B_ELEMS;
  static constexpr size_t SMEM = (size_t)kStages * STAGE * sizeof(S);
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
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
// limits cut a copy only at a slice's or M's or N's end); else 4-byte ones
// (bfloat16: element by element through registers, no cp.async).
// A copy that reads nothing gets a valid address all the same.
template <int ROWS, int COLS, bool VEC>
__device__ __forceinline__ void copy_slab(const bf16* __restrict__ p, long long ld_p, int r0,
                                          int rlim, int c0, int clim, bf16* dst, int ld) {
  if constexpr (VEC) {
    constexpr int C8 = COLS / 8, V = ROWS * C8 / kGemmThreads;
    static_assert(V * kGemmThreads == ROWS * C8, "slab");
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int idx = threadIdx.x + v * kGemmThreads;
      const int r = idx / C8, c = 8 * (idx % C8);
      const int gr = r0 + r, gc = c0 + c;
      const int n = gr < rlim ? max(0, min(8, clim - gc)) : 0;  // elements in range
      cp_async16(dst + r * ld + c, n > 0 ? p + (long long)gr * ld_p + gc : p, 2 * n);
    }
  } else {
    constexpr int V = ROWS * COLS / kGemmThreads;
    static_assert(V * kGemmThreads == ROWS * COLS, "slab");
#pragma unroll 4
    for (int v = 0; v < V; ++v) {
      const int idx = threadIdx.x + v * kGemmThreads;
      const int r = idx / COLS, c = idx % COLS;
      const int gr = r0 + r, gc = c0 + c;
      dst[r * ld + c] = gr < rlim && gc < clim ? p[(long long)gr * ld_p + gc] : from_f<bf16>(0.f);
    }
  }
}

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

template <bool TA, bool TB, bool VEC, class P = float>
__global__ void __launch_bounds__(kGemmThreads)
gemm_kernel(const typename GemmTypes<P>::In* __restrict__ A, long long lda,
            const typename GemmTypes<P>::In* __restrict__ B, long long ldb,
            typename GemmTypes<P>::Out* __restrict__ C, long long ldc, int M, int N, int K,
            const float* __restrict__ bias, int kslice, long long split_stride, bool vec_c) {
  using T = GemmTile<TA, TB, P>;
  using S = typename T::S;
  using O = typename GemmTypes<P>::Out;
  extern __shared__ __align__(16) float gsm_words[];
  S* gsm = reinterpret_cast<S*>(gsm_words);
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
      S* sa = gsm + (s % kStages) * T::STAGE;
      S* sb = sa + T::A_ELEMS;
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
    const S* sa = gsm + (s % kStages) * T::STAGE;
    const S* sb = sa + T::A_ELEMS;
    float part[T::MT][T::NT][4];  // this slab's sums
#pragma unroll
    for (int i = 0; i < T::MT; ++i)
#pragma unroll
      for (int j = 0; j < T::NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) part[i][j][q] = 0.f;
    if constexpr (T::kB16) {  // bfloat16 m16n8k16, fragments by ldmatrix
#pragma unroll
      for (int kk = 0; kk < T::BK; kk += 16) {
        uint32_t fb[T::NT][2];
#pragma unroll
        for (int j = 0; j < T::NT; j += 2) {  // two n8 tiles a load
          uint32_t r[4];
          const int n = wn + 8 * j;
          if (TB)
            mma16::ldmatrix_x4(r, mma16::b_addr<false>(sb + n * T::LB + kk, T::LB));
          else
            mma16::ldmatrix_x4_trans(r, mma16::b_addr<true>(sb + kk * T::LB + n, T::LB));
          fb[j][0] = r[0], fb[j][1] = r[1], fb[j + 1][0] = r[2], fb[j + 1][1] = r[3];
        }
#pragma unroll
        for (int i = 0; i < T::MT; ++i) {
          const int m = wm + 16 * i;
          uint32_t fa[4];
          if (TA)
            mma16::ldmatrix_x4_trans(fa, mma16::a_addr<true>(sa + kk * T::LA + m, T::LA));
          else
            mma16::ldmatrix_x4(fa, mma16::a_addr<false>(sa + m * T::LA + kk, T::LA));
#pragma unroll
          for (int j = 0; j < T::NT; ++j) mma16::mma(part[i][j], fa, fb[j]);
        }
      }
    } else {
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
  O* Cz = C + blockIdx.z * split_stride;
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
        O* row = Cz + (long long)m * ldc;
        const float v0 = acc[i][j][2 * h] + b0, v1 = acc[i][j][2 * h + 1] + b1;
        if constexpr (kBf16<O>) {
          if (vec_c && n + 1 < N) {
            *reinterpret_cast<__nv_bfloat162*>(row + n) = __floats2bfloat162_rn(v0, v1);
          } else {
            if (n < N) row[n] = from_f<bf16>(v0);
            if (n + 1 < N) row[n + 1] = from_f<bf16>(v1);
          }
        } else if (vec_c && n + 1 < N) {
          *reinterpret_cast<float2*>(row + n) = make_float2(v0, v1);
        } else {
          if (n < N) row[n] = v0;
          if (n + 1 < N) row[n + 1] = v1;
        }
      }
    }
}

// p 16-byte aligned and its rows a multiple of 16 bytes apart
template <class S>
inline bool aligned16(const S* p, long long ld) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && ld % (long long)(16 / sizeof(S)) == 0;
}

// One product, k split into `splits` slices (1: C is the product itself).
template <bool TA, bool TB, class P = float>
cudaError_t gemm(const typename GemmTypes<P>::In* A, long long lda,
                 const typename GemmTypes<P>::In* B, long long ldb,
                 typename GemmTypes<P>::Out* C, long long ldc, int M, int N, int K,
                 const float* bias, int splits, long long split_stride, cudaStream_t st) {
  using T = GemmTile<TA, TB, P>;
  const int steps = (K + T::BK - 1) / T::BK;
  const int kslice = (steps + splits - 1) / splits * T::BK;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
  const bool vec_c = reinterpret_cast<uintptr_t>(C) % (2 * sizeof(*C)) == 0 && ldc % 2 == 0 &&
                     split_stride % 2 == 0;
  // the kernel of 16-byte copies when both operands allow them. Opted in at
  // every launch: a function-local static here would be one object for
  // every library that instantiates this template (a GNU unique symbol), so
  // a second library's kernel would never be.
  auto kernel = aligned16(A, lda) && aligned16(B, ldb) ? gemm_kernel<TA, TB, true, P>
                                                       : gemm_kernel<TA, TB, false, P>;
  const cudaError_t opted = allow_smem(kernel, T::SMEM);
  if (opted != cudaSuccess) return opted;
  kernel<<<grid, kGemmThreads, T::SMEM, st>>>(A, lda, B, ldb, C, ldc, M, N, K, bias, kslice,
                                              split_stride, vec_c);
  return cudaGetLastError();
}

// Resident blocks per SM of gemm<TA, TB, P>'s kernel of 16-byte copies; its
// dynamic shared memory in *smem_bytes. -1 on failure.
template <bool TA, bool TB, class P = float>
int gemm_residency(int* smem_bytes) {
  using T = GemmTile<TA, TB, P>;
  *smem_bytes = (int)T::SMEM;
  if (allow_smem(gemm_kernel<TA, TB, true, P>, T::SMEM) != cudaSuccess) return -1;
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gemm_kernel<TA, TB, true, P>,
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
template <class T = float>
__global__ void col_sum_kernel(const T* __restrict__ A, long long lda, int rows, int N,
                               int slice, float* __restrict__ partial) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int e1 = min(rows, (int)(blockIdx.y + 1) * slice);
  float v = 0.f;
  for (int e = blockIdx.y * slice; e < e1; ++e) v += to_f(A[(long long)e * lda + n]);
  partial[(long long)blockIdx.y * N + n] = v;
}

inline int col_splits(int E) { return E < 256 ? 1 : (E / 256 < 128 ? E / 256 : 128); }

// out[n] = sum over rows e of A[e * lda + n]: slices, then their sum in order.
template <class T>
inline cudaError_t col_sum(const T* A, long long lda, int rows, int N, float* partial,
                           float* out, cudaStream_t st) {
  const int splits = col_splits(rows);
  const int slice = (rows + splits - 1) / splits;
  col_sum_kernel<T><<<dim3((N + 255) / 256, splits), 256, 0, st>>>(A, lda, rows, N, slice,
                                                                  partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_rows_kernel<<<(N + 255) / 256, 256, 0, st>>>(partial, out, N, splits);
  return cudaGetLastError();
}

// out [M, N] = sum over E edges of A_e^T B_e (TA product), in edge slices
// whose partial sums (float32) are added in slice order.
template <class T>
inline cudaError_t weight_grad(const T* A, long long lda, const T* B, long long ldb, int M, int N,
                               int E, float* partial, float* out, cudaStream_t st) {
  const int splits = grad_splits(M, N, E);
  const long long P = (long long)M * N;
  cudaError_t err = gemm<true, false, GemmAt<T>>(A, lda, B, ldb, partial, N, M, N, E, nullptr,
                                                 splits, P, st);
  if (err != cudaSuccess) return err;
  const int grid = persistent_grid(sum_rows_kernel, 256, 0, (P + 255) / 256);
  sum_rows_kernel<<<grid, 256, 0, st>>>(partial, out, P, splits);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- S2 activation
//
// float32 (K6, K6b): K3's column design over the hidden channels of a
// conv-1 output row: one thread owns one (edge, hidden channel) column,
// keeps its n_trunc coefficients in registers, and walks the G grid points
// with tg and fg in shared memory (rows zero-padded to kMaxRows floats:
// 16-byte broadcasts).

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

// bfloat16 (K6·bf16, K6b·bf16): the same two functions on the tensor
// cores, as K3·bf16 and K3b·bf16 (csrc/s2_act.cu) run them. The columns are
// the flat (edge, hidden channel) space; a warp owns a tile of kTcCols = 32
// columns at a time, with no barrier between warps after the block stages
// the grid matrices once:
//   copy   the tile's n_trunc hidden rows of y1 (grid_bwd_tc_kernel: and of
//          dmid) by cp.async into the warp's raw stage [I][kTcRaw] as
//          float32, zeros past E H: 16-byte pieces where H is a multiple
//          of 32 and every row 16-byte aligned (a tile then lies in one
//          edge, and each row's 32 columns are contiguous: the training
//          widths, H 128), else 4-byte ones, a column a lane; the next
//          tile's copy is issued as soon as this one is split, so it runs
//          under this tile's chain
//   split  the raw stage -> X^T (and Y^T) A fragments, rounded to bfloat16
//          (h.astype(dt); dmid's rows but row 0, which fg' zeroes), rows
//          past I zero
//   chain  grid_chain_tc_fwd<0, 3, 2, 4, 2, bf16> (s2_grid_tc.cuh):
//          silu(v) rounded in registers as the from-grid B, no barrier;
//          grid_chain_tc_sep_bwd at bf16: v and u formed transposed, h =
//          silu'(v) u rounded in registers, dh += tg^T h. One TF32
//          mma.sync a product of two bfloat16 values (exact), sums float32
//   store  mid rounded, row 0 silu(gate) from the float32 extra channels
//          (the forward); dy1's hidden rows rounded and section 0's also
//          in float32 into dy0 (db1's sums), and a lane's column of the
//          gate cotangent dextra + silu'(gate) dmid[0], dmid's row 0 read
//          from the raw stage in float32 (the backward)
// tg and fg are staged once a block as float, rounded to bfloat16 (the
// Pallas kernel's grids at x.dtype): tg [Gp][st] read as B and fg [Gp][sa]
// as A transposed in the forward; tg [Gp][st], fg' [Gp][st] (column 0
// zeroed) as B and tg [Gp][sa] as A transposed in the backward. Gp is G
// rounded up to a chain pass (72 at G 70), at most kMaxRows rows (I <= 32:
// 4 k steps, 2 m16 tiles). A block takes the most warps whose stages fit
// in shared memory, up to kTcFwdWarps / kTcBwdWarps (tc_grid): at lmax 6,
// G 70 the forward takes 20 warps, the backward 12 (two raw stages and two
// fragment sets a warp); 94 and 128 registers, no spills (ptxas -v on
// sm_90a). A train_so2_bf16 step's 36 grid launches took 22.0 ms of device
// time against the CUDA-core column kernels' 60.7 (tools/bf16_kernels_ab.py,
// the parent in the same call; an H100 80GB HBM3 at 700 W).
constexpr int kTcCT = 2;                // 16-column groups of a warp tile
constexpr int kTcCols = 16 * kTcCT;     // a warp tile's columns
constexpr int kTcSteps = 3;             // grid steps of 8 points a chain pass
constexpr int kTcKS = kMaxRows / 8;     // k steps of the to-grid products
constexpr int kTcMT = kMaxRows / 16;    // m16 tiles of the from-grid output
constexpr int kTcRaw = kTcCols + 4;     // raw stage row stride, floats (% 16 of 4)
constexpr int kTcFwdWarps = 20;         // most warps of a forward block
constexpr int kTcBwdWarps = 15;         // most warps of a backward block
constexpr int kTcFragWords = tc::kFragWords<bf16>;  // words of one A fragment (its hi plane)

// The tensor-core stages' block at these widths: staged matrices' rows and
// strides, k steps, warps, shared memory, whether the copies are 16-byte
struct TcGrid {
  int Gp, st, sa, KS, warps;
  size_t smem;
  bool vec;
};

inline TcGrid tc_grid(const Dims& d, bool bwd) {
  TcGrid c;
  const int I = d.n_trunc, MT = (I + 15) / 16;
  c.KS = (I + 7) / 8;
  c.Gp = (d.G + 8 * kTcSteps - 1) / (8 * kTcSteps) * (8 * kTcSteps);
  c.st = tc_stride(8 * c.KS);
  c.sa = tc_fg_stride(16 * MT);
  c.vec = d.H % kTcCols == 0 && d.extra % 4 == 0;
  const size_t mats = (size_t)c.Gp * ((bwd ? 2 : 1) * c.st + c.sa);
  const size_t per_warp = (bwd ? 2 : 1) * ((size_t)I * kTcRaw + (size_t)c.KS * kTcCT * kTcFragWords);
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  c.warps = bwd ? kTcBwdWarps : kTcFwdWarps;
  while (c.warps > 0 && (mats + c.warps * per_warp) * sizeof(float) > (size_t)optin) --c.warps;
  c.smem = (mats + c.warps * per_warp) * sizeof(float);
  return c;
}

// m [G, I] (float32) -> dst [Gp][stride], rounded to bfloat16, zeros past G
// and I and in columns < col0
__device__ inline void stage_tc_mat(const float* __restrict__ m, const Dims& d, int Gp, int stride,
                                    int col0, float* dst) {
  const int I = d.n_trunc;
  for (int t = threadIdx.x; t < Gp * stride; t += blockDim.x) {
    const int g = t / stride, i = t % stride;
    dst[t] = g < d.G && i < I && i >= col0 ? rnd<bf16>(m[g * I + i]) : 0.f;
  }
}

// Offset of row r of edge e: in a conv-1 output row (y1 and dy1, hidden row
// r), or in an [E, I, H] array (mid, dmid)
__device__ __forceinline__ long long row_off(const Dims& d, bool y1_rows, long long e, int r) {
  return y1_rows ? e * d.y1_width + y1_row_col(d, r) : (e * d.n_trunc + r) * d.H;
}

// The warp tile at column q0 of src's rows -> raw [I][kTcRaw], zeros past
// E H; called by the 32 lanes of one warp, joins their next commit
template <bool kVec>
__device__ __forceinline__ void copy_cols(const float* __restrict__ src, bool y1_rows,
                                          long long q0, const Dims& d, float* raw) {
  const int lane = threadIdx.x & 31, I = d.n_trunc;
  const long long Q = (long long)d.E * d.H;
  if constexpr (kVec) {  // 8 pieces of 4 columns a row, in one edge
    const long long e = q0 / d.H;
    const int k = (int)(q0 - e * d.H) + 4 * (lane & 7);
    const bool ok = q0 < Q;
    for (int r = lane >> 3; r < I; r += 4)
      cp_async16(raw + r * kTcRaw + 4 * (lane & 7), ok ? src + row_off(d, y1_rows, e, r) + k : src,
                 ok ? 16 : 0);
  } else {  // a column a lane
    const long long q = q0 + lane;
    const bool ok = q < Q;
    const long long e = ok ? q / d.H : 0;
    const int k = ok ? (int)(q - e * d.H) : 0;
    for (int r = 0; r < I; ++r)
      cp_async4(raw + r * kTcRaw + lane, ok ? src + row_off(d, y1_rows, e, r) + k : src,
                ok ? 4 : 0);
  }
}

// raw [I][kTcRaw] -> X^T's A fragments rounded to bfloat16, in the chains'
// order ((ks kTcCT + c) kTcFragWords for k step ks and 16-column group c),
// rows past I zero
__device__ __forceinline__ void split_cols(const float* raw, int I, int KS, uint32_t* frag) {
  const int lane = threadIdx.x & 31, col = lane >> 2;
#pragma unroll
  for (int ks = 0; ks < kTcKS; ++ks) {
    if (ks < KS) {
      const int i0 = 8 * ks + 2 * (lane & 3);
      const bool r0 = i0 < I, r1 = i0 + 1 < I;
#pragma unroll
      for (int c = 0; c < kTcCT; ++c) {
        const float* p = raw + i0 * kTcRaw + 16 * c + col;
        tc::store_a_t<bf16>(frag + (ks * kTcCT + c) * kTcFragWords, lane, r0 ? p[0] : 0.f,
                            r0 ? p[8] : 0.f, r1 ? p[kTcRaw] : 0.f, r1 ? p[kTcRaw + 8] : 0.f);
      }
    }
  }
}

// The lane's columns of a warp tile's sums: column 8 j + 2 tig + p at
// (edge, channel); the caller skips those past E H
__device__ __forceinline__ long long tile_col(long long q0, int j, int p) {
  return q0 + 8 * j + 2 * tc::lane_tig() + p;
}

template <bool kVec>
__global__ void __launch_bounds__(32 * kTcFwdWarps, 1)
grid_fwd_tc_kernel(const float* __restrict__ y1, const float* __restrict__ tg,
                   const float* __restrict__ fg, bf16* __restrict__ mid,
                   bf16* __restrict__ extra_out, Dims d, TcGrid c) {
  extern __shared__ __align__(16) float smem[];
  float* stg = smem;               // [Gp][st]: tg, read as B
  float* sfg = stg + c.Gp * c.st;  // [Gp][sa]: fg, read as A transposed
  const int I = d.n_trunc, warp = threadIdx.x >> 5, grp = tc::lane_grp();
  float* raw = smem + c.Gp * (c.st + c.sa) + warp * (I * kTcRaw + c.KS * kTcCT * kTcFragWords);
  uint32_t* frag = reinterpret_cast<uint32_t*>(raw + I * kTcRaw);
  const long long Q = (long long)d.E * d.H, nt = (Q + kTcCols - 1) / kTcCols;
  const long long nw = (long long)gridDim.x * c.warps;
  long long wt = (long long)blockIdx.x * c.warps + warp;
  if (wt < nt) copy_cols<kVec>(y1, true, wt * kTcCols, d, raw);
  cp_async_commit();
  stage_tc_mat(tg, d, c.Gp, c.st, 0, stg);
  stage_tc_mat(fg, d, c.Gp, c.sa, 0, sfg);
  if (extra_out != nullptr) {  // each edge's extra channels (gate.astype(dt) beside them)
    const long long n = (long long)d.E * d.extra;
    for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x; t < n;
         t += (long long)gridDim.x * blockDim.x) {
      const long long e = t / d.extra;
      extra_out[t] = from_f<bf16>(y1[e * d.y1_width + d.rows[0] * d.H + (t - e * d.extra)]);
    }
  }
  __syncthreads();
  for (; wt < nt; wt += nw) {
    const long long q0 = wt * kTcCols;
    cp_async_wait_all();
    __syncwarp();  // the tile's raw stage; every lane is done with the last chain
    split_cols(raw, I, c.KS, frag);
    __syncwarp();  // the fragments; every lane is done with the raw stage
    if (wt + nw < nt) copy_cols<kVec>(y1, true, (wt + nw) * kTcCols, d, raw);
    cp_async_commit();
    float acc[kTcMT][2 * kTcCT][4], tl[2 * kTcCT];
    singa::grid_chain_tc_fwd<0, kTcSteps, kTcCT, kTcKS, kTcMT, bf16>(
        stg, c.st, sfg, c.sa, frag, raw, I, kTcCT, 0, 0, c.Gp / 8, acc, tl);
    // mid [E, I, H], rounded; row 0 silu(gate) of the float32 extra channels
#pragma unroll
    for (int j = 0; j < 2 * kTcCT; ++j)
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const long long q = tile_col(q0, j, p);
        if (q >= Q) continue;
        const long long e = q / d.H;
        const int k = (int)(q - e * d.H);
        bf16* o = mid + e * I * d.H + k;
#pragma unroll
        for (int mt = 0; mt < kTcMT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 16 * mt + grp + 8 * h;
            if (i >= I) continue;
            float v = acc[mt][j][2 * h + p];
            if (i == 0) v = siluf_(y1[e * d.y1_width + d.rows[0] * d.H + d.alpha_ch + k]);
            o[(long long)i * d.H] = from_f<bf16>(v);
          }
      }
  }
  cp_async_wait_all();
}

template <bool kVec>
__global__ void __launch_bounds__(32 * kTcBwdWarps, 1)
grid_bwd_tc_kernel(const float* __restrict__ y1, const float* __restrict__ dmid,
                   const bf16* __restrict__ dextra, const float* __restrict__ tg,
                   const float* __restrict__ fg, bf16* __restrict__ dy1, float* __restrict__ dy0,
                   Dims d, TcGrid c) {
  extern __shared__ __align__(16) float smem[];
  float* stg = smem;                // [Gp][st]: tg, read as B
  float* sfg = stg + c.Gp * c.st;   // [Gp][st]: fg' (column 0 zeroed), read as B
  float* sta = sfg + c.Gp * c.st;   // [Gp][sa]: tg, read as A transposed
  const int I = d.n_trunc, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = tc::lane_grp();
  const int raw_f = I * kTcRaw, frag_w = c.KS * kTcCT * kTcFragWords;
  float* rx = smem + c.Gp * (2 * c.st + c.sa) + warp * 2 * (raw_f + frag_w);  // the warp's
  float* rg = rx + raw_f;
  uint32_t* fx = reinterpret_cast<uint32_t*>(rg + raw_f);
  uint32_t* fy = fx + frag_w;
  const long long Q = (long long)d.E * d.H, nt = (Q + kTcCols - 1) / kTcCols;
  const long long nw = (long long)gridDim.x * c.warps;
  const int x0 = d.rows[0] * d.H;  // the extra channels' first column
  long long wt = (long long)blockIdx.x * c.warps + warp;
  if (wt < nt) {
    copy_cols<kVec>(y1, true, wt * kTcCols, d, rx);
    copy_cols<kVec>(dmid, false, wt * kTcCols, d, rg);
  }
  cp_async_commit();
  stage_tc_mat(tg, d, c.Gp, c.st, 0, stg);
  stage_tc_mat(fg, d, c.Gp, c.st, 1, sfg);
  stage_tc_mat(tg, d, c.Gp, c.sa, 0, sta);
  {  // the extra channels before alpha_ch: dextra's (dy0: float32 for db1)
    const long long n = (long long)d.E * d.alpha_ch;
    for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x; t < n;
         t += (long long)gridDim.x * blockDim.x) {
      const long long e = t / d.alpha_ch;
      const int q = (int)(t - e * d.alpha_ch);
      const bf16 v = dextra[e * d.extra + q];
      dy1[e * d.y1_width + x0 + q] = v;
      dy0[e * d.out1[0] + x0 + q] = to_f(v);
    }
  }
  __syncthreads();
  for (; wt < nt; wt += nw) {
    const long long q0 = wt * kTcCols;
    cp_async_wait_all();
    __syncwarp();  // the tile's raw stages; every lane is done with the last chain
    split_cols(rx, I, c.KS, fx);
    split_cols(rg, I, c.KS, fy);
    if (q0 + lane < Q) {  // the lane's gate cotangent, dmid's row 0 in float32
      const long long q = q0 + lane, e = q / d.H;
      const int k = (int)(q - e * d.H);
      const float gx = to_f(dextra[e * d.extra + d.alpha_ch + k]) +
                       silu_gradf_(y1[e * d.y1_width + x0 + d.alpha_ch + k]) * rg[lane];
      dy1[e * d.y1_width + x0 + d.alpha_ch + k] = from_f<bf16>(gx);
      dy0[e * d.out1[0] + x0 + d.alpha_ch + k] = gx;
    }
    __syncwarp();  // the fragments; every lane is done with the raw stages
    if (wt + nw < nt) {
      copy_cols<kVec>(y1, true, (wt + nw) * kTcCols, d, rx);
      copy_cols<kVec>(dmid, false, (wt + nw) * kTcCols, d, rg);
    }
    cp_async_commit();
    float acc[kTcMT][2 * kTcCT][4];
    singa::grid_chain_tc_sep_bwd<kTcSteps, kTcCT, kTcKS, kTcMT, 0, bf16>(
        stg, sfg, c.st, sta, c.sa, fx, fy, I, kTcCT, 0, c.Gp / 8, acc);
    // dy1's hidden rows, rounded; section 0's also float32 into dy0
#pragma unroll
    for (int j = 0; j < 2 * kTcCT; ++j)
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const long long q = tile_col(q0, j, p);
        if (q >= Q) continue;
        const long long e = q / d.H;
        const int k = (int)(q - e * d.H);
#pragma unroll
        for (int mt = 0; mt < kTcMT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 16 * mt + grp + 8 * h;
            if (i >= I) continue;
            const float v = acc[mt][j][2 * h + p];
            dy1[row_off(d, true, e, i) + k] = from_f<bf16>(v);
            if (i < d.rows[0]) dy0[e * d.out1[0] + i * d.H + k] = v;
          }
      }
  }
  cp_async_wait_all();
}

template <typename Kernel>
inline cudaError_t tc_grid_launch(Kernel kernel, const Dims& d, const TcGrid& c, int* blocks) {
  if (c.warps < 1) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(kernel, c.smem);
  if (err != cudaSuccess) return err;
  const long long tiles = ((long long)d.E * d.H + kTcCols - 1) / kTcCols;
  *blocks = persistent_grid(kernel, 32 * c.warps, c.smem, (tiles + c.warps - 1) / c.warps);
  return cudaSuccess;
}

// Resident blocks per SM of a tensor-core grid stage at c (-1: refused),
// its shared memory and threads a block. For reports; launches nothing.
template <typename Kernel>
inline int tc_grid_residency(Kernel kernel, const TcGrid& c, int* smem_bytes, int* threads) {
  *smem_bytes = (int)c.smem;
  *threads = 32 * c.warps;
  if (c.warps < 1 || allow_smem(kernel, c.smem) != cudaSuccess) return -1;
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * c.warps, c.smem) !=
      cudaSuccess)
    return -1;
  return per_sm;
}

inline cudaError_t grid_fwd(const float* y1, const float* tg, const float* fg, bf16* mid,
                            bf16* extra_out, const Dims& d, cudaStream_t st) {
  const TcGrid c = tc_grid(d, false);
  auto kernel = c.vec ? grid_fwd_tc_kernel<true> : grid_fwd_tc_kernel<false>;
  int blocks = 0;
  const cudaError_t err = tc_grid_launch(kernel, d, c, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, 32 * c.warps, c.smem, st>>>(y1, tg, fg, mid, extra_out, d, c);
  return cudaGetLastError();
}

inline cudaError_t grid_bwd(const float* y1, const float* dmid, const bf16* dextra,
                            const float* tg, const float* fg, bf16* dy1, float* dy0,
                            const Dims& d, cudaStream_t st) {
  const TcGrid c = tc_grid(d, true);
  auto kernel = c.vec ? grid_bwd_tc_kernel<true> : grid_bwd_tc_kernel<false>;
  int blocks = 0;
  const cudaError_t err = tc_grid_launch(kernel, d, c, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, 32 * c.warps, c.smem, st>>>(y1, dmid, dextra, tg, fg, dy1, dy0, d, c);
  return cudaGetLastError();
}

// conv-1 products of the rotated, modulated message mpr into y1 (float32;
// b1 on section 0) and the S2 activation into mid: the forward up to mid,
// which K6 continues into conv 2 and K6b differentiates.
template <class T>
inline cudaError_t forward_to_mid(const T* mpr, const T* const* w1s, const float* b1,
                                  const float* tg, const float* fg, float* y1, T* mid,
                                  T* extra_out, const Dims& d, cudaStream_t st) {
  const long long ldm = (long long)d.n_trunc * d.C;
  for (int s = 0; s < kSecs; ++s) {
    const cudaError_t err = gemm<false, false, GemmAt<T>>(
        mpr + d.row0[s] * d.C, ldm, w1s[s], d.out1[s], y1 + d.y1_col[s], d.y1_width, d.E,
        d.out1[s], d.rows[s] * d.C, s == 0 ? b1 : nullptr, 1, 0, st);
    if (err != cudaSuccess) return err;
  }
  return grid_fwd(y1, tg, fg, mid, extra_out, d, st);
}

// ---------------------------------------------------------------- bfloat16
//
// The section weights rounded to bfloat16 once a call (the Pallas wrapper's
// w.astype(x.dtype)) into the call's scratch; and the scratch's layout.

struct WeightSet {
  const float* src[2 * kSecs];  // conv 1's sections, then conv 2's
  bf16* dst[2 * kSecs];
  long long n[2 * kSecs];
};

__global__ void round_weights_kernel(WeightSet w) {
  for (int s = 0; s < 2 * kSecs; ++s)
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < w.n[s];
         i += (long long)gridDim.x * blockDim.x)
      w.dst[s][i] = from_f<bf16>(w.src[s][i]);
}

inline long long round_up256(long long bytes) { return (bytes + 255) / 256 * 256; }

// Byte offsets in the scratch of the rounded weights (w1r[s], w2r[s]), from
// 0; *end the first byte past them.
struct Bf16Weights {
  long long w1[kSecs], w2[kSecs], end;
};

inline Bf16Weights bf16_weights_layout(const Dims& d) {
  Bf16Weights w;
  long long off = 0;
  for (int s = 0; s < kSecs; ++s) {
    w.w1[s] = off;
    off = round_up256(off + 2LL * d.rows[s] * d.C * d.out1[s]);
  }
  for (int s = 0; s < kSecs; ++s) {
    w.w2[s] = off;
    off = round_up256(off + 2LL * d.rows[s] * d.H * d.rows[s] * d.F2);
  }
  w.end = off;
  return w;
}

// w1s, w2s (float32) rounded into base + the layout's offsets.
inline cudaError_t round_weights(const float* const* w1s, const float* const* w2s, char* base,
                                 const Bf16Weights& lay, const Dims& d, bf16** w1r, bf16** w2r,
                                 cudaStream_t st) {
  WeightSet w;
  long long most = 1;
  for (int s = 0; s < kSecs; ++s) {
    w1r[s] = reinterpret_cast<bf16*>(base + lay.w1[s]);
    w2r[s] = reinterpret_cast<bf16*>(base + lay.w2[s]);
    w.src[s] = w1s[s], w.dst[s] = w1r[s], w.n[s] = (long long)d.rows[s] * d.C * d.out1[s];
    w.src[kSecs + s] = w2s[s], w.dst[kSecs + s] = w2r[s];
    w.n[kSecs + s] = (long long)d.rows[s] * d.H * d.rows[s] * d.F2;
    most = w.n[s] > most ? w.n[s] : most;
    most = w.n[kSecs + s] > most ? w.n[kSecs + s] : most;
  }
  const int grid = persistent_grid(round_weights_kernel, 256, 0, (most + 255) / 256);
  round_weights_kernel<<<grid, 256, 0, st>>>(w);
  return cudaGetLastError();
}

}  // namespace so2
}  // namespace singa
