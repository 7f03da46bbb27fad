// The list forms' tensor-core pieces that K1/K7's forward
// (csrc/neighbor_attn.cu) and K1b/K7b's backward (csrc/neighbor_attn_bwd.cu)
// share: the encoder's widths, the tiles and their pair buffers' strides,
// the smear and the shifted softplus as the tensor cores take them, the
// smear formed in the A fragments, the rows' four-value loads and stores at
// either storage type and the score terms' sum (dot3), and the blocks'
// contiguous row ranges.
#pragma once

#include "encoder_attn.cuh"
#include "mma_tf32.cuh"

namespace singa {
namespace list_attn {

constexpr int KD = 32, VD = 64, DE = 64;  // the encoder's widths, the one instance
constexpr int kThreads = 512;             // 16 warps, one block per SM (shared memory)
constexpr int kWarps = kThreads / 32;
constexpr int kTM = 128;   // slot rows per tile: 8 m16 blocks, two warps each
constexpr int kTR = 64;    // rows per tile at most
constexpr int kMaxH = 4;
constexpr int kChunk = 16;      // slots of a row one warp takes in a per-chunk pass
constexpr int kMaxChunks = 48;  // chunks per tile at most (their partial sums)
constexpr int kRowWork = 8;  // a row's fixed cost in slots, for the blocks' shares
constexpr int kPlanThreads = 256;

// Strides (floats) of the pair buffers [slot][channel], read as A paired
// and transposed, as B in order and written as C (stride % 32 of 8).
constexpr int LPK = KD + 8, LPV = VD + 8;
constexpr int NPK = KD / 8;  // n8 tiles of h_k (then h_v's VD / 8)

// Slots of the block's control words (ctl): its rows' end and cursor, the
// tile's rows, slots, slots of the k-section (the forward) and chunks, and
// the rows waiting to be taken again.
enum Ctl { kHi = 0, kCursor, kRows, kSlots, kRedo, kChunks, kSlotsK, kCtl = 8 };

// The tensor-core kernels' shapes: the encoder's widths, H <= 4, K <= 128.
inline bool tc_ok(const encoder_attn::Dims& d) {
  return d.kd == KD && d.vd == VD && d.De == DE && d.H <= kMaxH && d.R <= kTM;
}

// The smear, the hidden and sigmoid(pre) go to the tensor cores as split
// TF32 (hi + lo: about 22 significant bits), or rounded to bfloat16 (8), so
// the hardware's exp2 and log2 (__expf, __logf: a few units in the last of
// float32's 24 bits) lose nothing the products keep.
__device__ __forceinline__ float smear(float coeff, float dist, float c) {
  const float diff = dist - c;
  return -__expf(coeff * diff * diff);
}


// ssp(v) = softplus(v) - log 2, overflow-free: max(v, 0) + log(1 + exp(-|v|)) - log 2
__device__ __forceinline__ float ssp_tc(float v) {
  return fmaxf(v, 0.f) + __logf(1.f + __expf(-fabsf(v))) - 0.69314718055994530942f;
}

// A = the smear E [slot][channel] of rows g, g + 8 (distances d0, d1), k
// paired, over the channels at cent (the k-step's first); at T = bf16
// rounded to bfloat16
template <class T = float>
__device__ __forceinline__ tc::FragA frag_smear_paired(float coeff, float d0, float d1,
                                                       const float* cent) {
  const int t = tc::lane_tig();
  const float c0 = cent[2 * t], c1 = cent[2 * t + 1];
  tc::FragA f;
  tc::split_t<T>(smear(coeff, d0, c0), f.hi[0], f.lo[0]);
  tc::split_t<T>(smear(coeff, d1, c0), f.hi[1], f.lo[1]);
  tc::split_t<T>(smear(coeff, d0, c1), f.hi[2], f.lo[2]);
  tc::split_t<T>(smear(coeff, d1, c1), f.hi[3], f.lo[3]);
  return f;
}

// Four values of T at p (16-byte aligned for float, 8-byte for bfloat16) as
// float4, through the read-only path; and four floats stored as T
__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ld4(const bf16* p) {
  const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(tc::bf16_lo(w.x)), __uint_as_float(tc::bf16_hi(w.x)),
                     __uint_as_float(tc::bf16_lo(w.y)), __uint_as_float(tc::bf16_hi(w.y)));
}
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void st4(bf16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y), b = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const uint32_t*>(&a),
                                            *reinterpret_cast<const uint32_t*>(&b));
}

// The sum of four products a b c, each rounded to T first (at float: the
// fused sum the float32 kernel takes, first term plain)
template <class T>
__device__ __forceinline__ float dot3(const float4& a, const float4& b, const float4& c) {
  if constexpr (kBf16<T>)
    return rnd<T>(a.x * b.x * c.x) + rnd<T>(a.y * b.y * c.y) + rnd<T>(a.z * b.z * c.z) +
           rnd<T>(a.w * b.w * c.w);
  float part = a.x * b.x * c.x;
  part = fmaf(a.y * b.y, c.y, part);
  part = fmaf(a.z * b.z, c.z, part);
  return fmaf(a.w * b.w, c.w, part);
}

// The n8 tile jj of [h_k | h_v] at row 0 of the buffer pair (hk, hv).
__device__ __forceinline__ float* htile(float* hk, float* hv, int jj) {
  return jj < NPK ? hk + 8 * jj : hv + 8 * (jj - NPK);
}

// The block's rows [lo, hi) into ctl: row r goes to block floor(p_r G / W),
// p_r the rows' work before r (taken slots + kRowWork each; plan[r] >> 2 is
// row r's taken slots), W the total.
__device__ inline void block_range(const int* __restrict__ plan, int rows, int* ctl) {
  __shared__ long long wsum[kWarps];
  __shared__ int cnt[2][kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (rows + kThreads - 1) / kThreads;
  const int r0 = min(rows, tid * per), r1 = min(rows, r0 + per);
  long long w = 0;
  for (int r = r0; r < r1; ++r) w += (plan[r] >> 2) + kRowWork;
  long long incl = w;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  long long p = incl - w, total = 0;
  for (int i = 0; i < kWarps; ++i) {
    if (i < warp) p += wsum[i];
    total += wsum[i];
  }
  // rows whose work starts before block b's and before block b + 1's share
  const long long G = gridDim.x, b = blockIdx.x;
  const long long t0 = (b * total + G - 1) / G, t1 = ((b + 1) * total + G - 1) / G;
  int n0 = 0, n1 = 0;
  for (int r = r0; r < r1; ++r) {
    n0 += p < t0;
    n1 += p < t1;
    p += (plan[r] >> 2) + kRowWork;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    n0 += __shfl_xor_sync(0xffffffffu, n0, o);
    n1 += __shfl_xor_sync(0xffffffffu, n1, o);
  }
  if (lane == 0) cnt[0][warp] = n0, cnt[1][warp] = n1;
  __syncthreads();
  if (tid == 0) {
    int lo = 0, hi = 0;
    for (int i = 0; i < kWarps; ++i) lo += cnt[0][i], hi += cnt[1][i];
    ctl[kHi] = b + 1 == G ? rows : hi;
    ctl[kCursor] = lo;
    ctl[kRedo] = 0;
  }
}

}  // namespace list_attn
}  // namespace singa
