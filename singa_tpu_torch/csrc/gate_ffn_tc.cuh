// What the gate FFN's forward on the tensor cores (K2's gate_ffn_tc_kernel,
// csrc/so3_gate_ffn.cu) and K2b's dx kernel (csrc/so3_gate_ffn_bwd.cu) share.
// Both walk the hidden dimension in chunks of kHC channels over tiles of kTN
// nodes, the m16 of every product, with the products as split-TF32 mma.sync
// (mma_tf32.cuh):
//   chunk_layout      one hidden chunk's words: the weights as B fragments,
//                     already split into TF32 hi and lo, then b1 and bg
//   split_chunks      the split kernels' body: every chunk's words, once a call
//   copy_tile_rows    a tile's coefficient rows by cp.async, zeros past N
//   copy_chunk        one chunk's words by cp.async into a stage of the ring
//   frag_pre          a lane's share of a pre-split B fragment
//   frag_tile         one k step of a coefficient row of the tile as A, split
//                     as it loads
//   gate_block, gates sigmoid(x_0 wg_l + bg_l) of the tile's nodes and the
//                     chunk's channels as C fragments, into shared memory
// Each takes the storage type T of the activations (float by default, K2's
// and K2b's float32 kernels). At T = bf16 (K2's and K2b's bfloat16 instances) the
// tile's rows are bfloat16 in shared memory, half the bytes, widened as
// fragments load; the weights are rounded to bfloat16 once a call and kept
// as TF32 hi only (their lo is zero), half the words of a fragment; each
// product is one TF32 mma (mma_tf32.cuh, mma_t).
#pragma once

#include "common.cuh"
#include "mma_tf32.cuh"

namespace singa {
namespace gate {

constexpr int kTN = 16;             // nodes of a tile: the m16 of every product
constexpr int kHC = 16;             // hidden channels of a chunk
constexpr int kNB = kHC / 8;        // its n8 blocks
constexpr int kFragWords = 32 * 4;  // one B fragment, split: [lane][hi b0, hi b1, lo b0, lo b1]

// Words of one B fragment at storage type T: split (kFragWords), or at
// bfloat16 hi only, [lane][hi b0, hi b1]
template <class T>
__host__ __device__ constexpr int frag_words() {
  return singa::kBf16<T> ? 32 * 2 : kFragWords;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a), "l"(src), "r"(bytes));
}

// One hidden chunk's words, fragments first, in this order:
//   w1 as h's B           [l][k step][n8 block]    k = c (paired), n = hidden
//   w2: kDx (K2b's dx kernel) as dmid's B
//                         [l][k step][n8 block]    k = o (paired), n = hidden
//       else (K2) as y's B
//                         [l][k step][n8 of o]     k = hidden (paired), n = o
//   kDx only: w1 as dx's B
//                         [l][n8 block][n8 of c]   k = hidden (paired), n = c
//   wg as the gates' B    [l - 1][k step][n8 block]  k = c (paired), n = hidden
// then the chunk's b1 [kHC] and bg [lmax][kHC] as floats. "Paired": k slots
// t and t + 4 of a lane take the columns 2 t and 2 t + 1 of the k step, as
// frag_a_paired and frag_a_from_c give them (mma_tf32.cuh). Zero past H. A
// fragment takes frag_words<T>() words.
struct ChunkLayout {
  int w2, w1t, wg, frags;  // fragment offsets
  int b1, bg, words;       // word offsets, and the words of a chunk
};

template <bool kDx, class T = float>
__host__ __device__ inline ChunkLayout chunk_layout(int lmax, int C, int Co) {
  const int KC = C / 8, KO = Co / 8, L = lmax + 1;
  ChunkLayout o;
  o.w2 = L * KC * kNB;
  o.w1t = o.w2 + L * KO * kNB;  // w2 takes as many fragments either way
  o.wg = o.w1t + (kDx ? L * kNB * KC : 0);
  o.frags = o.wg + lmax * KC * kNB;
  o.b1 = o.frags * frag_words<T>();
  o.bg = o.b1 + kHC;
  o.words = o.bg + lmax * kHC;  // a multiple of 4: each chunk is 16-byte aligned
  return o;
}

// Every chunk's words (chunk_layout), one lane of one fragment (or one bias)
// per item, in a grid-stride loop: the weights split into TF32 hi and lo once
// a call (at T = bf16 rounded to bfloat16, hi only).
template <int C, int Co, bool kDx, class T = float>
__device__ __forceinline__ void split_chunks(const float* __restrict__ w1,
                                             const float* __restrict__ b1,
                                             const float* __restrict__ wg,
                                             const float* __restrict__ bg,
                                             const float* __restrict__ w2,
                                             uint32_t* __restrict__ out, int lmax, int H) {
  constexpr int KC = C / 8, KO = Co / 8, NB = kNB;
  const ChunkLayout o = chunk_layout<kDx, T>(lmax, C, Co);
  const int items = o.frags * 32 + (o.words - o.b1);
  const long long total = (long long)((H + kHC - 1) / kHC) * items;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const int chunk = (int)(e / items), r = (int)(e % items), h0 = chunk * kHC;
    uint32_t* blk = out + (long long)chunk * o.words;
    if (r >= o.frags * 32) {  // b1, then bg of degrees 1 .. lmax
      const int b = r - o.frags * 32, h = h0 + b % kHC, which = b / kHC;
      float v = 0.f;
      if (h < H) v = which == 0 ? b1[h] : bg[(long long)(which - 1) * H + h];
      blk[o.b1 + b] = __float_as_uint(v);
      continue;
    }
    const int f = r / 32, lane = r % 32, g = lane >> 2, t = lane & 3;
    float v[2] = {0.f, 0.f};  // the lane's b0 and b1: k = 2 t and 2 t + 1 of the step
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      if (f < o.w2) {
        const int l = f / (KC * NB), ks = f / NB % KC, j = f % NB;
        const int h = h0 + 8 * j + g, c = 8 * ks + 2 * t + p;
        if (h < H) v[p] = w1[((long long)l * C + c) * H + h];
      } else if (f < o.w1t) {
        const int q = f - o.w2;
        if constexpr (kDx) {  // k = o, n = hidden
          const int l = q / (KO * NB), ks = q / NB % KO, j = q % NB;
          const int h = h0 + 8 * j + g, c = 8 * ks + 2 * t + p;
          if (h < H) v[p] = w2[((long long)l * H + h) * Co + c];
        } else {  // k = hidden, n = o
          const int l = q / (NB * KO), ks = q / KO % NB, nt = q % KO;
          const int h = h0 + 8 * ks + 2 * t + p, c = 8 * nt + g;
          if (h < H) v[p] = w2[((long long)l * H + h) * Co + c];
        }
      } else if (f < o.wg) {
        const int q = f - o.w1t, l = q / (NB * KC), j = q / KC % NB, nt = q % KC;
        const int h = h0 + 8 * j + 2 * t + p, c = 8 * nt + g;
        if (h < H) v[p] = w1[((long long)l * C + c) * H + h];
      } else {
        const int q = f - o.wg, l1 = q / (KC * NB), ks = q / NB % KC, j = q % NB;
        const int h = h0 + 8 * j + g, c = 8 * ks + 2 * t + p;
        if (h < H) v[p] = wg[(long long)c * lmax * H + (long long)l1 * H + h];
      }
    }
    uint32_t hi0, lo0, hi1, lo1;
    singa::tc::split_t<T>(v[0], hi0, lo0);
    singa::tc::split_t<T>(v[1], hi1, lo1);
    if constexpr (singa::kBf16<T>)
      *reinterpret_cast<uint2*>(blk + f * frag_words<T>() + lane * 2) = make_uint2(hi0, hi1);
    else
      *reinterpret_cast<uint4*>(blk + f * kFragWords + lane * 4) = make_uint4(hi0, hi1, lo0, lo1);
  }
}

// The column swizzle of a node's row in the tile: at width 16, columns
// 8..15 and 0..7 trade places on nodes 2, 3 (mod 4), so that frag_a_paired's
// 8-byte loads (nodes g, columns 2 t) are conflict-free; width 8 needs none.
// At bfloat16 (4-byte loads, a row of 16 taking 8 banks) they trade places
// on nodes 4..7 (mod 8).
template <int W, class T = float>
__device__ __forceinline__ int swz(int node) {
  if constexpr (singa::kBf16<T>) return W == 16 ? 8 * ((node >> 2) & 1) : 0;
  return W == 16 ? 8 * ((node >> 1) & 1) : 0;
}

// The I coefficient rows (W values of T each) of the tile at node n0 of src
// [N, I, W] by cp.async into dst [I][kTN][W] (swizzled), zeros past N.
// Commits nothing: the caller's next commit takes them.
template <int W, int kThreads, class T = float>
__device__ __forceinline__ void copy_tile_rows(const T* __restrict__ src, int n0, int I, int N,
                                               T* dst) {
  constexpr int E = 16 / sizeof(T), Q = W / E;  // values of a 16-byte piece; pieces of a row
  for (int q = threadIdx.x; q < kTN * I * Q; q += kThreads) {
    const int n = q / (I * Q), i = q / Q % I, c = E * (q % Q);
    const bool ok = n0 + n < N;
    cp_async16(dst + (i * kTN + n) * W + (c ^ swz<W, T>(n)),
               ok ? src + ((long long)(n0 + n) * I + i) * W + c : src, ok ? 16 : 0);
  }
}

// The words of hidden chunk `chunk` into a stage of the ring; commits.
template <int kThreads>
__device__ __forceinline__ void copy_chunk(const uint32_t* __restrict__ wfrag, int chunk, int words,
                                           uint32_t* stage) {
  const float* src = reinterpret_cast<const float*>(wfrag) + (long long)chunk * words;
  float* dst = reinterpret_cast<float*>(stage);
  for (int q = threadIdx.x; q < words / 4; q += kThreads) cp_async16(dst + 4 * q, src + 4 * q, 16);
  asm volatile("cp.async.commit_group;\n" ::);
}

// The lane's share of one split B fragment (at T = bf16: its hi, lo = 0)
template <class T = float>
__device__ __forceinline__ singa::tc::FragB frag_pre(const uint32_t* frag) {
  if constexpr (singa::kBf16<T>) {
    const uint2 v = *reinterpret_cast<const uint2*>(frag + 2 * (threadIdx.x & 31));
    return singa::tc::FragB{{v.x, v.y}, {0u, 0u}};
  }
  const uint4 v = *reinterpret_cast<const uint4*>(frag + 4 * (threadIdx.x & 31));
  return singa::tc::FragB{{v.x, v.y}, {v.z, v.w}};
}

// k step ks of the 16 nodes' rows (one coefficient row of the tile) as A
// (m = node, k = channel, paired), split (at bfloat16: widened)
template <int W, class T = float>
__device__ __forceinline__ singa::tc::FragA frag_tile(const T* rows, int ks) {
  return singa::tc::frag_a_paired(rows + ((8 * ks) ^ swz<W, T>(singa::tc::lane_grp())), W);
}

// The gates of degree l >= 1 at the tile's nodes and n8 block j of the
// chunk's channels, sigmoid(x_0 wg_l + bg_l) with the product split (xa: row
// 0 of the tile as A), into sgate [lmax][n8 block][lane] as the lane's C
// fragment (node g + 8 (q >> 1), channel 8 j + 2 t + (q & 1)). kRound: the
// gates rounded to T as they are stored (K2's; K2b's dx kernel rounds them
// where they scale dmid and takes sigmoid' from them unrounded).
template <int C, class T = float, bool kRound = false>
__device__ __forceinline__ void gate_block(const singa::tc::FragA (&xa)[C / 8], const uint32_t* wgf,
                                           const float* cbg, int l, int j, float* sgate) {
  using namespace singa::tc;
  constexpr int KC = C / 8, NB = kNB, FW = frag_words<T>();
  const int t = lane_tig();
  const uint32_t* f = wgf + (l - 1) * KC * NB * FW;
  float z[4] = {};
  FragB b[KC];
#pragma unroll
  for (int ks = 0; ks < KC; ++ks) b[ks] = frag_pre<T>(f + (ks * NB + j) * FW);
#pragma unroll
  for (int ks = 0; ks < KC; ++ks) mma_t<T>(z, xa[ks], b[ks]);
  const float* bias = cbg + (l - 1) * kHC + 8 * j + 2 * t;
  float4 gv = make_float4(singa::sigmoidf_(z[0] + bias[0]), singa::sigmoidf_(z[1] + bias[1]),
                          singa::sigmoidf_(z[2] + bias[0]), singa::sigmoidf_(z[3] + bias[1]));
  if constexpr (kRound)
    gv = make_float4(singa::rnd<T>(gv.x), singa::rnd<T>(gv.y), singa::rnd<T>(gv.z),
                     singa::rnd<T>(gv.w));
  *reinterpret_cast<float4*>(sgate + (((l - 1) * NB + j) * 32 + (threadIdx.x & 31)) * 4) = gv;
}

// Row 0 of the tile (sx [I][kTN][C]) as A, split
template <int C, class T = float>
__device__ __forceinline__ void row0_frags(const T* sx, singa::tc::FragA (&xa)[C / 8]) {
#pragma unroll
  for (int ks = 0; ks < C / 8; ++ks) xa[ks] = frag_tile<C, T>(sx, ks);
}

// Every n8 block of degree l's gates (one warp)
template <int C, class T = float>
__device__ __forceinline__ void gates(const T* sx, const uint32_t* wgf, const float* cbg, int l,
                                      float* sgate) {
  singa::tc::FragA xa[C / 8];
  row0_frags<C, T>(sx, xa);
#pragma unroll
  for (int j = 0; j < kNB; ++j) gate_block<C, T>(xa, wgf, cbg, l, j, sgate);
}

}  // namespace gate
}  // namespace singa
