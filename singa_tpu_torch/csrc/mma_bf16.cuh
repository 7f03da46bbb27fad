// bfloat16 products on the tensor cores: the warp-level
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 (bfloat16 inputs,
// float32 accumulation), written by hand in inline PTX, ldmatrix for its
// fragments from shared memory, and the packing of float32 values into its
// bfloat16 pairs.
//
// A product of two bfloat16 values is exact in float32 (8 x 8 significant
// bits), so one m16n8k16 gives what one TF32 m16n8k8 of the same values
// gives (csrc/mma_tf32.cuh at T = bf16), twice as deep: half the
// instructions, no float -> TF32 conversion, and operands of 2 bytes.
//
// Fragments of mma.m16n8k16 with .bf16 (PTX ISA, "Matrix fragments for
// mma.m16n8k16 with floating point type"). In a warp, lane = 4 * grp + tig
// (grp 0..7, tig 0..3); each 32-bit register holds two bfloat16 values, the
// lower-indexed one in the low half:
//   A, 16 x 16 (m x k), four registers:
//     a0 (m = grp,     k = 2 tig, 2 tig + 1)      a1 (m = grp + 8, same k)
//     a2 (m = grp,     k = 2 tig + 8, 2 tig + 9)  a3 (m = grp + 8, same k)
//   B, 16 x 8 (k x n), two registers:
//     b0 (k = 2 tig, 2 tig + 1, n = grp)          b1 (k = 2 tig + 8, 2 tig + 9, n = grp)
//   C/D, 16 x 8 (m x n), four float32 registers, as m16n8k8's:
//     c0 (m = grp, n = 2 tig)  c1 (m = grp, n = 2 tig + 1)  c2, c3 the same at m = grp + 8
//
// So the C fragments of two products whose n are consecutive 8-wide
// stretches of one k16 (c of the first: k 2 tig, 2 tig + 1; of the second:
// k 2 tig + 8, 2 tig + 9), packed as bfloat16 pairs, are one lane's B
// fragment of the next product (b0 from the first's c0, c1; b1 from the
// second's), n = m of the first: grid_chain_mma16_bwd's and
// grid_chain_mma16_fwd's in csrc/s2_grid_tc.cuh.
//
// ldmatrix.m8n8.x4 reads four 8 x 8 matrices of 2-byte values, lane l
// giving the address of row l % 8 of matrix l / 8 (16 contiguous bytes,
// 16-byte aligned). Without .trans a lane receives (row grp, columns 2 tig,
// 2 tig + 1) of each matrix, with .trans (rows 2 tig, 2 tig + 1, column
// grp): an A or B fragment of either stored orientation. Its 8-row phases
// are free of bank conflicts when the row stride in 16-byte units is odd.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace singa {
namespace mma16 {

// c += a b: m16n8k16, bfloat16 operands, float32 accumulation
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// four 8 x 8 matrices of 2-byte values from shared memory (p: this lane's
// row address), without and with .trans
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// two 8 x 8 matrices (lanes 0-15 give the row addresses), without and
// with .trans: the B fragment of one n8 tile
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

// lo and hi rounded to bfloat16 (to nearest even) as one pair, lo in the
// low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The two values of a pair as float
__device__ __forceinline__ float lo_f(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_f(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// The lane's row address for an x4 load of a 16 x 16 tile at p (row stride
// ld elements): the A fragment of a tile stored [m][k] (without .trans), or
// stored [k][m] (with .trans: the A of its transpose). Matrices: (rows 0-7,
// cols 0-7), (rows 8-15, cols 0-7), (rows 0-7, cols 8-15), (rows 8-15,
// cols 8-15) for a [m][k] tile; with .trans the tile's rows are k, so the
// second and third swap: (0-7, 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15).
template <bool kTrans, class S>
__device__ __forceinline__ const S* a_addr(const S* p, int ld) {
  const int l = threadIdx.x & 31, m = l >> 3, r = l & 7;
  return kTrans ? p + (r + 8 * (m >> 1)) * ld + 8 * (m & 1)
                : p + (r + 8 * (m & 1)) * ld + 8 * (m >> 1);
}

// The lane's row address for an x4 load of the B fragments of two n8 tiles
// (n 0-7 into b[0], n 8-15 into b[1]) of a k16 x n16 tile at p: stored
// [n][k] (without .trans) or [k][n] (with .trans). Registers: b[0][0],
// b[0][1], b[1][0], b[1][1].
template <bool kTrans, class S>
__device__ __forceinline__ const S* b_addr(const S* p, int ld) {
  const int l = threadIdx.x & 31, m = l >> 3, r = l & 7;
  return kTrans ? p + (r + 8 * (m & 1)) * ld + 8 * (m >> 1)
                : p + (r + 8 * (m >> 1)) * ld + 8 * (m & 1);
}

}  // namespace mma16
}  // namespace singa
