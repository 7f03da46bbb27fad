// Float32 products on the tensor cores as three-product split TF32: the
// warp-level mma.sync.aligned.m16n8k8 (TF32 inputs, float32 accumulation),
// written by hand in inline PTX, and the fragment loaders from shared memory.
//
// Split TF32. TF32 keeps 10 explicit mantissa bits, so one TF32 product of
// float32 data is off by ~1e-3 relative to its terms. Each float32 operand
// x becomes hi = tf32(x), rounded to nearest with ties away from zero
// (cvt.rna.tf32.f32), and lo = x - hi cut to TF32 toward zero (its 13 low
// bits cleared: lo is at most 2^-11 of x, so the cut costs 2^-21 of x, and
// one instruction less than rounding it; CUTLASS's 3xTF32 does the same),
// and
//   a * b ~ hi_a * hi_b + hi_a * lo_b + lo_a * hi_b
// (lo_a * lo_b, ~2^-22 of the product, is dropped). The tensor cores form
// each product of two TF32 values exactly and accumulate in float32, so the
// sum agrees with a float32 product to float32 round-off. mma3() issues the
// three products into one accumulator, the small terms first. hi is
// rounded with integer operations (tf32_rna), equal to cvt.rna.tf32.f32.
//
// Fragments of mma.m16n8k8 .row.col (PTX ISA, "Matrix fragments for
// mma.m16n8k8" with .tf32). In a warp, lane = 4 * grp + tig (grp 0..7,
// tig 0..3):
//   A, 16 x 8 (m x k), four registers:
//     a0 (m = grp,     k = tig)      a1 (m = grp + 8, k = tig)
//     a2 (m = grp,     k = tig + 4)  a3 (m = grp + 8, k = tig + 4)
//   B, 8 x 8 (k x n), two registers:
//     b0 (k = tig, n = grp)          b1 (k = tig + 4, n = grp)
//   C/D, 16 x 8 (m x n), four float32 registers:
//     c0 (m = grp, n = 2 tig)        c1 (m = grp, n = 2 tig + 1)
//     c2 (m = grp + 8, n = 2 tig)    c3 (m = grp + 8, n = 2 tig + 1)
//
// The order of the k terms within one mma is free as long as A and B agree.
// The "paired" loaders use it: the k slots tig and tig + 4 take the
// physical columns 2 tig and 2 tig + 1, so a lane reads its two A values of
// a row with one 8-byte load.
//
// Loaders, each for one tile whose origin the pointer names:
//   frag_a_paired(A, lda)   A stored [m][k] (row-major), k paired
//   frag_b_paired(B, ldb)   B stored [k][n], k paired (pairs with the above)
//   frag_a_trans(At, lda)   A stored transposed, At[k][m], k in order
//   frag_b(B, ldb)          B stored [k][n], k in order (pairs with the above)
//   (frag_a_paired, frag_b_paired, frag_b_nk, frag_a_trans and frag_b also
//   read bfloat16 rows: the values widened, lo = 0)
//   frag_b_nk(B, ldb)       B stored [n][k], k paired (pairs with frag_a_paired)
//   frag_b_nk_seq(B, ldb)   B stored [n][k], k in order
//   frag_b_split(Bhi, Blo, ldb)  B stored [k][n], k in order, from planes
//                           split beforehand (frag_b_split_t<bf16>: the hi
//                           plane alone)
//   frag_a_split(f)         A kept split in lane order (store_a_split
//                           writes it): no split at the load
//                           (frag_a_split_t<bf16>: its hi plane alone;
//                           store_a_t<bf16> writes it rounded)
//   store_c(C, ldc, c)      C stored [m][n], two 8-byte stores
//   frag_a_from_c(c)        the C of one m16n8 product as the A of the next,
//                           whose k is that product's n, k paired (pairs
//                           with frag_b_paired and frag_b_nk): a chain of
//                           products that never leaves the registers
// Shared-memory banks (32 of 4 bytes): frag_a_paired is conflict-free when
// lda % 32 is 8 or 24 (per half-warp, grp * lda + 2 tig covers 32 banks);
// frag_a_trans when lda % 32 is 8 or 24 (tig * lda + grp); frag_b_paired
// when 2 * ldb % 32 is 8 or 24 (ldb % 16 is 4 or 12); frag_b when ldb % 32
// is 8 or 24 (frag_b_split the same). One stride with lda % 32 = 24 (or 8) thus serves a constant
// matrix read both ways: as A = M (paired) and as A = M^T (transposed).
// frag_b_nk's 8-byte loads (grp * ldb + 2 tig) are conflict-free when
// ldb % 32 is 8 or 24, as frag_a_paired's. frag_b_nk_seq (g * ldb + t) is
// conflict-free when ldb % 32 is 4, 12, 20 or 28; with ldb % 16 of 4 or 12
// the same [n][k] rows also serve frag_b_paired, read as [k][n].
//
// bfloat16 (the T = bf16 instances of the tensor-core kernels of K1, K1b,
// K2, K2b, K3 and K3b).
// A bfloat16 value is a TF32 value: its 7 explicit mantissa bits fit in
// TF32's 10, so its TF32 "hi" is its own bits and "lo" is zero, and one
// TF32 product of two bfloat16 values is exact in float32 (8 x 8
// significant bits). The loaders and frag_a_from_c take the storage type T
// (float by default): at T = bf16 each value is rounded to bfloat16 (round
// to nearest even, as torch's casts round; the identity on a value that is
// one already) and kept as hi with lo = 0, and mma_t issues one product
// (hi hi) where mma3 issues three. The bf16 loaders read bfloat16 pairs
// from shared memory as one 32-bit word, widened by a shift.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace singa {
namespace tc {

struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

// cvt.rna.tf32.f32 of a finite x, by integer operations: half a TF32 ulp
// added to the bits of the magnitude (the sign bit is untouched), then the
// 13 low mantissa bits cleared. In K4b's chain on the H100 this ran faster
// than the cvt instruction itself; tf32_rna_ptx is the
// instruction, which the tests hold it to bit for bit.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ uint32_t tf32_rna_ptx(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x -> (hi, lo): hi = tf32(x) to nearest, lo = x - hi cut to TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

template <class T> constexpr bool kIsBf16 = std::is_same<T, __nv_bfloat16>::value;

// The float bits of x rounded to bfloat16 (to nearest even): a TF32 value
__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(x)) << 16;
}

// The two bfloat16 values of a 32-bit word (element 0 in the low half) as
// float bits
__device__ __forceinline__ uint32_t bf16_lo(uint32_t w) { return w << 16; }
__device__ __forceinline__ uint32_t bf16_hi(uint32_t w) { return w & 0xffff0000u; }

// split at T = float; at T = bf16, hi = x rounded to bfloat16, lo = 0
template <class T>
__device__ __forceinline__ void split_t(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (kIsBf16<T>) {
    hi = bf16_bits(x);
    lo = 0u;
  } else {
    split(x, hi, lo);
  }
}

__device__ __forceinline__ int lane_grp() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_tig() { return threadIdx.x & 3; }

template <class T = float>
__device__ __forceinline__ FragA frag_a_paired(const float* A, int lda) {
  const int g = lane_grp(), t = lane_tig();
  const float2 r0 = *reinterpret_cast<const float2*>(A + g * lda + 2 * t);
  const float2 r1 = *reinterpret_cast<const float2*>(A + (g + 8) * lda + 2 * t);
  FragA f;
  split_t<T>(r0.x, f.hi[0], f.lo[0]);
  split_t<T>(r1.x, f.hi[1], f.lo[1]);
  split_t<T>(r0.y, f.hi[2], f.lo[2]);
  split_t<T>(r1.y, f.hi[3], f.lo[3]);
  return f;
}

// A stored [m][k] as bfloat16, k paired: one 4-byte load a row, no rounding
// (lda in elements, even)
__device__ __forceinline__ FragA frag_a_paired(const __nv_bfloat16* A, int lda) {
  const int g = lane_grp(), t = lane_tig();
  const uint32_t r0 = *reinterpret_cast<const uint32_t*>(A + g * lda + 2 * t);
  const uint32_t r1 = *reinterpret_cast<const uint32_t*>(A + (g + 8) * lda + 2 * t);
  return FragA{{bf16_lo(r0), bf16_lo(r1), bf16_hi(r0), bf16_hi(r1)}, {0u, 0u, 0u, 0u}};
}

template <class T = float>
__device__ __forceinline__ FragB frag_b_paired(const float* B, int ldb) {
  const int g = lane_grp(), t = lane_tig();
  FragB f;
  split_t<T>(B[(2 * t) * ldb + g], f.hi[0], f.lo[0]);
  split_t<T>(B[(2 * t + 1) * ldb + g], f.hi[1], f.lo[1]);
  return f;
}

// B stored [k][n] as bfloat16, k paired (ldb in elements): two 2-byte loads
__device__ __forceinline__ FragB frag_b_paired(const __nv_bfloat16* B, int ldb) {
  const int g = lane_grp(), t = lane_tig();
  const uint16_t* b = reinterpret_cast<const uint16_t*>(B);
  return FragB{{(uint32_t)b[(2 * t) * ldb + g] << 16, (uint32_t)b[(2 * t + 1) * ldb + g] << 16},
               {0u, 0u}};
}

// B stored [n][k], k paired (pairs with frag_a_paired): one 8-byte load
template <class T = float>
__device__ __forceinline__ FragB frag_b_nk(const float* B, int ldb) {
  const int g = lane_grp(), t = lane_tig();
  const float2 v = *reinterpret_cast<const float2*>(B + g * ldb + 2 * t);
  FragB f;
  split_t<T>(v.x, f.hi[0], f.lo[0]);
  split_t<T>(v.y, f.hi[1], f.lo[1]);
  return f;
}

// B stored [n][k] as bfloat16, k paired (ldb in elements, even): one 4-byte load
__device__ __forceinline__ FragB frag_b_nk(const __nv_bfloat16* B, int ldb) {
  const int g = lane_grp(), t = lane_tig();
  const uint32_t v = *reinterpret_cast<const uint32_t*>(B + g * ldb + 2 * t);
  return FragB{{bf16_lo(v), bf16_hi(v)}, {0u, 0u}};
}

// B stored [n][k], k in order
__device__ __forceinline__ FragB frag_b_nk_seq(const float* B, int ldb) {
  const int g = lane_grp(), t = lane_tig();
  FragB f;
  split(B[g * ldb + t], f.hi[0], f.lo[0]);
  split(B[g * ldb + t + 4], f.hi[1], f.lo[1]);
  return f;
}

template <class T = float>
__device__ __forceinline__ FragA frag_a_trans(const float* At, int lda) {
  const int g = lane_grp(), t = lane_tig();
  FragA f;
  split_t<T>(At[t * lda + g], f.hi[0], f.lo[0]);
  split_t<T>(At[t * lda + g + 8], f.hi[1], f.lo[1]);
  split_t<T>(At[(t + 4) * lda + g], f.hi[2], f.lo[2]);
  split_t<T>(At[(t + 4) * lda + g + 8], f.hi[3], f.lo[3]);
  return f;
}

template <class T = float>
__device__ __forceinline__ FragB frag_b(const float* B, int ldb) {
  const int g = lane_grp(), t = lane_tig();
  FragB f;
  split_t<T>(B[t * ldb + g], f.hi[0], f.lo[0]);
  split_t<T>(B[(t + 4) * ldb + g], f.hi[1], f.lo[1]);
  return f;
}

// A stored transposed as bfloat16, At[k][m], k in order (lda in elements):
// four 2-byte loads
__device__ __forceinline__ FragA frag_a_trans(const __nv_bfloat16* At, int lda) {
  const int g = lane_grp(), t = lane_tig();
  const uint16_t* a = reinterpret_cast<const uint16_t*>(At);
  return FragA{{(uint32_t)a[t * lda + g] << 16, (uint32_t)a[t * lda + g + 8] << 16,
                (uint32_t)a[(t + 4) * lda + g] << 16, (uint32_t)a[(t + 4) * lda + g + 8] << 16},
               {0u, 0u, 0u, 0u}};
}

// B stored [k][n] as bfloat16, k in order (ldb in elements): two 2-byte loads
__device__ __forceinline__ FragB frag_b(const __nv_bfloat16* B, int ldb) {
  const int g = lane_grp(), t = lane_tig();
  const uint16_t* b = reinterpret_cast<const uint16_t*>(B);
  return FragB{{(uint32_t)b[t * ldb + g] << 16, (uint32_t)b[(t + 4) * ldb + g] << 16}, {0u, 0u}};
}

// B stored [k][n] as TF32 hi and lo planes, already split; k in order
__device__ __forceinline__ FragB frag_b_split(const uint32_t* hi, const uint32_t* lo, int ldb) {
  const int g = lane_grp(), t = lane_tig();
  FragB f;
  f.hi[0] = hi[t * ldb + g];
  f.hi[1] = hi[(t + 4) * ldb + g];
  f.lo[0] = lo[t * ldb + g];
  f.lo[1] = lo[(t + 4) * ldb + g];
  return f;
}

// frag_b_split at storage type T: at T = bf16 the hi plane alone (lo = 0,
// the lo plane not read)
template <class T = float>
__device__ __forceinline__ FragB frag_b_split_t(const uint32_t* hi, const uint32_t* lo, int ldb) {
  if constexpr (kIsBf16<T>) {
    const int g = lane_grp(), t = lane_tig();
    return FragB{{hi[t * ldb + g], hi[(t + 4) * ldb + g]}, {0u, 0u}};
  } else {
    return frag_b_split(hi, lo, ldb);
  }
}

// An A fragment kept split in shared or device memory, in lane order: 32
// lanes of uint4 hi (a0..a3), then 32 lanes of uint4 lo; kSplitFragWords
// words, 16-byte aligned. Each load is two conflict-free 16-byte reads.
constexpr int kSplitFragWords = 2 * 32 * 4;

__device__ __forceinline__ FragA frag_a_split(const uint32_t* f) {
  const uint4 hi = reinterpret_cast<const uint4*>(f)[threadIdx.x & 31];
  const uint4 lo = reinterpret_cast<const uint4*>(f)[32 + (threadIdx.x & 31)];
  return FragA{{hi.x, hi.y, hi.z, hi.w}, {lo.x, lo.y, lo.z, lo.w}};
}

// a0..a3 of lane `lane`, split, into a fragment of that layout
__device__ __forceinline__ void store_a_split(uint32_t* f, int lane, float a0, float a1, float a2,
                                              float a3) {
  uint4 hi, lo;
  split(a0, hi.x, lo.x);
  split(a1, hi.y, lo.y);
  split(a2, hi.z, lo.z);
  split(a3, hi.w, lo.w);
  reinterpret_cast<uint4*>(f)[lane] = hi;
  reinterpret_cast<uint4*>(f)[32 + lane] = lo;
}

// Such a fragment at storage type T: split at T = float; at T = bf16 its hi
// plane alone (lo is zero, and mma_t<bf16> never reads it), half the words
template <class T>
constexpr int kFragWords = kIsBf16<T> ? kSplitFragWords / 2 : kSplitFragWords;

// store_a_split at storage type T: at T = bf16 the hi plane alone, each
// value rounded to bfloat16 (kFragWords<bf16> words a fragment)
template <class T = float>
__device__ __forceinline__ void store_a_t(uint32_t* f, int lane, float a0, float a1, float a2,
                                          float a3) {
  if constexpr (kIsBf16<T>) {
    reinterpret_cast<uint4*>(f)[lane] = make_uint4(bf16_bits(a0), bf16_bits(a1), bf16_bits(a2),
                                                   bf16_bits(a3));
  } else {
    store_a_split(f, lane, a0, a1, a2, a3);
  }
}

template <class T = float>
__device__ __forceinline__ FragA frag_a_split_t(const uint32_t* f) {
  if constexpr (kIsBf16<T>) {
    const uint4 hi = reinterpret_cast<const uint4*>(f)[threadIdx.x & 31];
    return FragA{{hi.x, hi.y, hi.z, hi.w}, {0u, 0u, 0u, 0u}};
  } else {
    return frag_a_split(f);
  }
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a * b in split TF32: lo_a hi_b, hi_a lo_b, then hi_a hi_b
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a, const FragB& b) {
  mma(c, a.lo, b.hi);
  mma(c, a.hi, b.lo);
  mma(c, a.hi, b.hi);
}

// c += a * b: mma3 at T = float; one TF32 product (hi hi) at T = bf16,
// whose fragments hold bfloat16 values (lo = 0)
template <class T>
__device__ __forceinline__ void mma_t(float (&c)[4], const FragA& a, const FragB& b) {
  if constexpr (kIsBf16<T>)
    mma(c, a.hi, b.hi);
  else
    mma3(c, a, b);
}

__device__ __forceinline__ void store_c(float* C, int ldc, const float (&c)[4]) {
  const int g = lane_grp(), t = lane_tig();
  *reinterpret_cast<float2*>(C + g * ldc + 2 * t) = make_float2(c[0], c[1]);
  *reinterpret_cast<float2*>(C + (g + 8) * ldc + 2 * t) = make_float2(c[2], c[3]);
}

// c (m = grp / grp + 8, n = 2 tig / 2 tig + 1) as A (m, k paired): the k
// slot tig is column 2 tig of c, the slot tig + 4 column 2 tig + 1 (at T =
// bf16 rounded to bfloat16: the Pallas kernel's .astype(dt) before the
// next product)
template <class T = float>
__device__ __forceinline__ FragA frag_a_from_c(const float (&c)[4]) {
  FragA f;
  split_t<T>(c[0], f.hi[0], f.lo[0]);
  split_t<T>(c[2], f.hi[1], f.lo[1]);
  split_t<T>(c[1], f.hi[2], f.lo[2]);
  split_t<T>(c[3], f.hi[3], f.lo[3]);
  return f;
}

}  // namespace tc
}  // namespace singa
