// K1: neighbour-list graph attention of the kNN encoder, forward; and K7,
// the same function from neighbour rows gathered outside the kernel.
//
// Replaces: singa_tpu/ops/pallas/neighbor_attn.py::neighbor_attn_fused
// (_attn_fwd_kernel) and ::neighbor_attn_hybrid (_hybrid_pallas_fwd,
// _attn_fwd_kernel with gathered=True), selected by SINGA_TPU_HYBRID_ATTN.
// The function is csrc/encoder_attn.cuh's. K7 reads k[nbr[p]] and v[nbr[p]]
// from k_nb [B*N, K, H*kd] and v_nb [B*N, K, H*vd] (row node*K + p),
// gathered by torch.gather before the launch, and takes no nbr.
//
// What the data needs, exactly. A dead slot scores -1e9. Each row is in one
// of these modes, and each evaluates only what its output needs:
//   live  the row has live slots. Once its max m (over the self score and
//         the live scores) is above about -1e9 + 104 in every head, every
//         dead slot weighs exp(-1e9 - m) = 0 in float32 and adds an exact
//         zero: the row takes its live slots alone, compacted from the mask
//         in slot order (masks need not be a prefix). A row with no live
//         slot whose self score leaves the dead slots no weight (an
//         isolated real row) takes none: a_self = 1, out = dval.
//   dead-weighted  no live slot, and exp(-1e9 - max(ds, -1e9)) != 0 in some
//         head: the padded rows (self score -1e9, models/neighbor_graph.py).
//         Every score is known (-1e9 and ds), so the softmax is closed-form
//         (uniform, 1 / (K + 1), at ds = -1e9): out = a_dead * sum_p w_v[p]
//         v[row(p)] + a_self dval. The row takes all K slots on the
//         v-EdgeMLP alone, with no k-EdgeMLP, key row or score. Its output
//         is zeroed later by node_mask, but it is part of the function, so
//         the kernel computes it.
//   copy  a dead-weighted row whose slot inputs (distances, and nbr or the
//         gathered v rows) are those of the row before it in its graph, bit
//         for bit, that row dead-weighted too: the sum above is that row's,
//         so it takes no slot and list_fwd_copy_kernel writes it from the
//         sum its source left in scratch. The corpus's padded nodes all sit
//         at the origin, so a graph's padded rows are one evaluated row and
//         copies (at a training call 32 evaluated, 5,571 copies).
//   redo  a live row whose max, once its live scores are known, leaves its
//         dead slots a weight in some head (live scores near -1e9). It
//         writes nothing from that pass and is taken again, whole (all K
//         slots, both EdgeMLPs), in the block's next tile.
// At a training call (32 graphs x 384 nodes, K 96) 381,347 of 1,179,648
// slots are live (23,936 operations a slot, 94 % in the two EdgeMLPs), and
// 32 evaluated dead-weighted rows add 3,072 slots (~17,150 operations a
// slot: the v-EdgeMLP, smear and aggregate), against 28.2 GFLOP for every
// slot of both nets.
//
// What bounds it on the H100: the EdgeMLP products, ~95 % of the
// operations, as split TF32 (three TF32 mma.sync each, ~300 TFLOP/s of TF32
// issue on this card); then the k and v rows the scores and the aggregate
// read (~0.4 GB a training call, from L2 for K1, from device memory for
// K7's gathered rows). K7 also reads every dead-weighted row's gathered v
// rows once to tell a copy (~0.5 GB).
//
// Design. Three kernels, every sum in a fixed order (no atomics but the
// optional counts):
//   1. list_fwd_plan_kernel: one warp a row reads the mask and the self
//      scores (and, for a dead-weighted row, the row before's inputs) and
//      writes the row's mode and slot count (plan[row] = mode | slots << 2).
//   2. list_fwd_tile_kernel: a persistent block of 16 warps an SM (its
//      shared memory) takes a contiguous range of rows that carries a like
//      share of the slots (block_range, as K1b's blocks). It packs the
//      taken slots of consecutive rows into tiles of up to kTM = 128 slot
//      rows, rows kept whole, so a row's softmax is taken in one pass with
//      no online rescale: the live and redone rows' slots first (the
//      k-section), then the dead-weighted rows' (the v-section). Per tile:
//      the slots filled, a warp a row's 32-slot segment, the row's loads
//      issued together; then warps 2b and 2b + 1 take m16 block b: the
//      smear formed in the A fragments, h = ssp(e W1 + b1), then w = h W2 +
//      b2, both nets on the k-section's blocks, the v-net alone on the
//      rest, as split-TF32 mma.sync (csrc/mma_tf32.cuh) with float32
//      accumulation (depths 64, then 32 or 64: no chain long enough to lose
//      low bits), the weights split into TF32 hi and lo planes once a block
//      (a B fragment is two 8-byte loads). The scores (a warp a k-section
//      slot, four at a time, the key and query rows in 16-byte pieces side
//      by side, a dead slot's key never read), the softmax (a warp a row
//      and head; a dead-weighted row's in closed form, its sums kept
//      unweighted) and the aggregate (a warp a 16-slot chunk of a row and
//      128 value channels: the chunk's v rows loaded together in 16-byte
//      pieces, the chunk's sums added per row in chunk order) stay float32
//      on the CUDA cores. Those phases branch per warp, never per row
//      inside a warp's product.
//   3. list_fwd_copy_kernel: one warp a copy row, its source the nearest
//      row before it that is not a copy: out = a_dead sum + a_self dval,
//      the tile kernel's own arithmetic for a dead-weighted row.
// Shared memory, one block of 512 threads an SM: the weights' hi and lo
// planes (25,600 words) and biases, h_k, h_v, w_k, w_v [128][40 | 72]
// (28,672 floats; the aggregate's chunk sums [48][256] reuse h_k, h_v and
// w_k once the scores are taken), the scores [128][4] and the per-slot and
// per-row words: 227,296 bytes of dynamic shared memory. ptxas gives the
// tile kernel 106 registers a thread and no spills (__launch_bounds__ 512,
// 1 allows 128); `chip_smoke.py` reports both and the residency.
// Shared with neighbor_attn_bwd.cu (K1b/K7b), in csrc/list_attn.cuh: the
// widths, tiles and pair-buffer strides, the smear and its A fragments,
// the shifted softplus, the rows' loads and stores (ld4, st4), the score
// terms' sum (dot3) and block_range; the weights' planes and their
// products (mlp_pre, mlp_w) are the forward's own.
//
// Widths. The tensor-core kernel takes the encoder's widths (kd 32, vd 64,
// De 64), H <= 4 and K <= 128. Every other shape runs
// csrc/encoder_attn.cuh's attn_fwd_kernel<kList | kGathered> (every slot,
// one node's K slots a tile, the EdgeMLPs in float32 on the CUDA cores),
// kept as K1/K7's CUDA-core instance; cuda_cores asks for it at any shape.
// The instance is chosen by shape before the launch.
// bfloat16 (neighbor_attn or neighbor_attn_hybrid with bf16 != 0): K1's and
// K7's bfloat16 instances are the same three kernels at T = bf16, the
// storage type of qt, k, v (K7: k_nb, v_nb), diag_value and out (dist,
// diag_scores, the centers, the EdgeMLP weights and the sums scratch stay
// float32), at the widths above, else attn_fwd_kernel<kList | kGathered,
// bf16> (whose note lists the roundings: they are the TPU kernel's at a
// bfloat16 dtype); cuda_cores and stats as at float32. K7's rows come
// gathered in bfloat16 (torch.gather, as JAX's _gather_rows gathers them at
// the compute dtype), and _attn_fwd_kernel with gathered=True widens them
// as K1's one-hot product does: K7's bfloat16 instance rounds where K1's
// does. Every EdgeMLP product
// multiplies two bfloat16 values and is one TF32 mma.sync (mma_tf32.cuh,
// mma_t), exact to float32 accumulation, where float32 takes three: the
// weights are rounded once a block into the hi plane alone (a bfloat16 value
// is a TF32 value: its lo is zero), the smear as its fragments form, the
// hiddens ssp(pre) as they are stored; w_k and w_v are rounded as they are
// stored. The rows of qt, k, v and diag_value come in 8-byte pieces of four
// values and widen (ld4); each score term qt w_k k is rounded before the
// head sum (dot3); the softmax runs in float32, and the weights that weigh
// the values (a, a_self, and a dead-weighted or copied row's closed-form
// a_dead and a_self) are rounded; the aggregate sums in float32 and rounds
// once, at the store (st4). A dead slot still adds an exact zero: exp(-1e9 -
// m) = 0, and so is its rounding, so the modes above hold as they are. Its
// ~8.6 GFLOP of EdgeMLP products a training call as one TF32 product each:
// ~17 us at 495 TFLOP/s.
#include <stdint.h>

#include "list_attn.cuh"

namespace ea = singa::encoder_attn;
namespace tc = singa::tc;

namespace {

using namespace singa::list_attn;
using singa::kBf16;
using singa::rnd;

// A row's mode (plan[row] = mode | slots taken << 2): its live slots (none
// for an isolated real row), all K on the v-EdgeMLP (dead-weighted), (a
// live row taken again) all K on both, or a copy: a dead-weighted row whose
// slot inputs are those of the row before it, which takes none.
enum Mode { kLive = 0, kDead = 1, kWhole = 2, kCopy = 3 };

// What a launch walked (stats, when asked for): rows taken with their live
// slots, dead-weighted rows evaluated (copies are not), rows taken again
// whole, and the slots evaluated (a row taken again counts its slots twice).
enum Stat { kStatLive = 0, kStatDead, kStatWhole, kStatSlots, kStats };

// The EdgeMLP weights split once a block into TF32 hi and lo planes, each
// W^T [out][in] at these strides (words): a B fragment (k paired) is one
// 8-byte load from each plane, conflict-free at stride % 32 of 8. The lo
// plane of each matrix sits kPlaneWords after its hi plane.
constexpr int SW1 = DE + 8, SW2K = KD + 8, SW2V = VD + 8;
constexpr int kPlaneWords = KD * SW1 + VD * SW1 + KD * SW2K + VD * SW2V;

struct Sm {
  uint32_t *w1k, *w1v, *w2k, *w2v;  // hi planes of W1 and W2, k and v nets
  float *b1k, *b2k, *b1v, *b2v, *cent;
  float *hk, *hv;    // [kTM][LPK | LPV] hidden ssp(pre)
  float *wk, *wv;    // [kTM][LPK | LPV] w_k, w_v
  float* part;       // [kMaxChunks][kMaxH * VD] the aggregate's chunk sums, over hk .. wk
  float* S;          // [kTM][kMaxH] scores, then softmax weights
  float *dist, *mask;                   // [kTM]
  int *rowof, *kv;                      // [kTM] tile row, row of k/v
  float *ra, *rad, *rds;                // [kTR][kMaxH] a_self, a_dead, the self scores
  int *rnode, *rmode, *rfirst, *rcnt, *rredo, *rchunk;  // [kTR]
  int* chunkrow;                        // [kMaxChunks] each chunk's tile row
  int* redo;                            // [kTR] rows to take again whole
  int* ctl;                             // [kCtl]
};

static_assert(kMaxChunks * kMaxH * VD <= kTM * (2 * LPK + LPV),
              "the chunk sums fit over h_k, h_v and w_k");

constexpr int kSmemFloats = 2 * kPlaneWords + 2 * KD + 2 * VD + DE + kTM * (2 * LPK + 2 * LPV) +
                            kTM * kMaxH + 4 * kTM + 3 * kTR * kMaxH + 7 * kTR + kMaxChunks + kCtl;
constexpr size_t kSmemBytes = (size_t)kSmemFloats * sizeof(float);

__device__ Sm carve(float* p) {
  Sm s;
  s.w1k = reinterpret_cast<uint32_t*>(p);
  s.w1v = s.w1k + KD * SW1;     s.w2k = s.w1v + VD * SW1;
  s.w2v = s.w2k + KD * SW2K;
  s.b1k = reinterpret_cast<float*>(s.w1k + 2 * kPlaneWords);
  s.b2k = s.b1k + KD;
  s.b1v = s.b2k + KD;           s.b2v = s.b1v + VD;
  s.cent = s.b2v + VD;
  s.hk = s.cent + DE;           s.hv = s.hk + kTM * LPK;
  s.wk = s.hv + kTM * LPV;      s.wv = s.wk + kTM * LPK;
  s.part = s.hk;
  s.S = s.wv + kTM * LPV;
  s.dist = s.S + kTM * kMaxH;   s.mask = s.dist + kTM;
  s.rowof = reinterpret_cast<int*>(s.mask + kTM);
  s.kv = s.rowof + kTM;
  s.ra = reinterpret_cast<float*>(s.kv + kTM);
  s.rad = s.ra + kTR * kMaxH;
  s.rds = s.rad + kTR * kMaxH;
  s.rnode = reinterpret_cast<int*>(s.rds + kTR * kMaxH);
  s.rmode = s.rnode + kTR;      s.rfirst = s.rmode + kTR;
  s.rcnt = s.rfirst + kTR;      s.rredo = s.rcnt + kTR;
  s.rchunk = s.rredo + kTR;     s.chunkrow = s.rchunk + kTR;
  s.redo = s.chunkrow + kMaxChunks;
  s.ctl = s.redo + kTR;
  return s;
}

// W [in][out] (flax layout) into the planes at hi: W^T, split (at T = bf16
// rounded to bfloat16 into the hi plane alone: its lo is zero)
template <class T>
__device__ void put_split(uint32_t* hi, int ld, const float* __restrict__ w, int in, int out) {
  for (int t = threadIdx.x; t < in * out; t += kThreads) {
    const int k = t / out, n = t - k * out;
    if constexpr (kBf16<T>)
      hi[n * ld + k] = tc::bf16_bits(w[t]);
    else
      tc::split(w[t], hi[n * ld + k], hi[kPlaneWords + n * ld + k]);
  }
}

template <class T>
__device__ void load_split_weights(const ea::ArgsT<T>& a, const Sm& s) {
  put_split<T>(s.w1k, SW1, a.wk1, DE, KD);
  put_split<T>(s.w1v, SW1, a.wv1, DE, VD);
  put_split<T>(s.w2k, SW2K, a.wk2, KD, KD);
  put_split<T>(s.w2v, SW2V, a.wv2, VD, VD);
  for (int t = threadIdx.x; t < KD; t += kThreads) { s.b1k[t] = a.bk1[t]; s.b2k[t] = a.bk2[t]; }
  for (int t = threadIdx.x; t < VD; t += kThreads) { s.b1v[t] = a.bv1[t]; s.b2v[t] = a.bv2[t]; }
  for (int t = threadIdx.x; t < DE; t += kThreads) s.cent[t] = a.centers[t];
}

// B = W (k paired) from the planes of W^T at hi (the tile's first n row and
// k column); at T = bf16 the hi plane alone
template <class T>
__device__ __forceinline__ tc::FragB frag_b_planes(const uint32_t* hi, int ld) {
  const int g = tc::lane_grp(), t = tc::lane_tig();
  const uint2 h = *reinterpret_cast<const uint2*>(hi + g * ld + 2 * t);
  if constexpr (kBf16<T>) return tc::FragB{{h.x, h.y}, {0u, 0u}};
  const uint2 l = *reinterpret_cast<const uint2*>(hi + kPlaneWords + g * ld + 2 * t);
  return tc::FragB{{h.x, h.y}, {l.x, l.y}};
}

// h_k | h_v tiles J0 .. J1-1 of the m16 block at row m0: ssp(E [wk1 | wv1] + b1)
// (at T = bf16 from the rounded smear, one product each, and rounded)
template <class T, int J0, int J1>
__device__ void mlp_pre(const Sm& s, float coeff, int m0) {
  const int g = tc::lane_grp(), t = tc::lane_tig();
  const float d0 = s.dist[m0 + g], d1 = s.dist[m0 + g + 8];
  float c[J1 - J0][4];
#pragma unroll
  for (int j = 0; j < J1 - J0; ++j) {
    const int jj = J0 + j;
    const float* b = jj < NPK ? s.b1k + 8 * jj : s.b1v + 8 * (jj - NPK);
    c[j][0] = c[j][2] = b[2 * t];
    c[j][1] = c[j][3] = b[2 * t + 1];
  }
#pragma unroll 2
  for (int ks = 0; ks < DE / 8; ++ks) {
    const tc::FragA fa = frag_smear_paired<T>(coeff, d0, d1, s.cent + 8 * ks);
#pragma unroll
    for (int j = 0; j < J1 - J0; ++j) {
      const int jj = J0 + j;
      const uint32_t* w = jj < NPK ? s.w1k + 8 * jj * SW1 : s.w1v + 8 * (jj - NPK) * SW1;
      tc::mma_t<T>(c[j], fa, frag_b_planes<T>(w + 8 * ks, SW1));
    }
  }
#pragma unroll
  for (int j = 0; j < J1 - J0; ++j) {
    const int jj = J0 + j;
#pragma unroll
    for (int q = 0; q < 4; ++q) c[j][q] = rnd<T>(ssp_tc(c[j][q]));
    tc::store_c(htile(s.hk + m0 * LPK, s.hv + m0 * LPV, jj), jj < NPK ? LPK : LPV, c[j]);
  }
}

// w_k (kK) or w_v tiles J0 .. J1-1 of the m16 block at row m0: h W2 + b2
// (at T = bf16 one product each, and rounded)
template <class T, bool kK, int J0, int J1>
__device__ void mlp_w(const Sm& s, int m0) {
  constexpr int W = kK ? KD : VD, LP = kK ? LPK : LPV, LS = kK ? SW2K : SW2V;
  const int t = tc::lane_tig();
  const float* hid = (kK ? s.hk : s.hv) + m0 * LP;
  const uint32_t* W2 = kK ? s.w2k : s.w2v;
  const float* b2 = kK ? s.b2k : s.b2v;
  float c[J1 - J0][4];
#pragma unroll
  for (int j = 0; j < J1 - J0; ++j) {
    c[j][0] = c[j][2] = b2[8 * (J0 + j) + 2 * t];
    c[j][1] = c[j][3] = b2[8 * (J0 + j) + 2 * t + 1];
  }
#pragma unroll 2
  for (int ks = 0; ks < W / 8; ++ks) {
    const tc::FragA fa = tc::frag_a_paired<T>(hid + 8 * ks, LP);
#pragma unroll
    for (int j = 0; j < J1 - J0; ++j)
      tc::mma_t<T>(c[j], fa, frag_b_planes<T>(W2 + 8 * (J0 + j) * LS + 8 * ks, LS));
  }
  float* out = (kK ? s.wk : s.wv) + m0 * LP;
#pragma unroll
  for (int j = 0; j < J1 - J0; ++j) {
#pragma unroll
    for (int q = 0; q < 4; ++q) c[j][q] = rnd<T>(c[j][q]);
    tc::store_c(out + 8 * (J0 + j), LP, c[j]);
  }
}

// One warp: whether row r has no live slot and leaves its dead slots a
// weight, exp(-1e9 - max(ds, -1e9)) != 0, in some head (in every lane).
template <class T>
__device__ bool dead_weighted(const ea::ArgsT<T>& a, const ea::Dims& d, long long r) {
  const int lane = threadIdx.x & 31;
  bool live = false, weighs = false;
  for (int p = lane; p < d.R; p += 32) live |= a.nmask[r * d.R + p] != 0;
  for (int h = lane; h < d.H; h += 32)
    weighs |= expf(-ea::kBig - fmaxf(a.ds[r * d.H + h], -ea::kBig)) != 0.f;
  return !__any_sync(0xffffffffu, live) && __any_sync(0xffffffffu, weighs);
}

// One warp: whether rows r - 1 and r read the same slot inputs, bit for
// bit: the distances, and the rows of v (the same nbr, kList; the same
// gathered v rows, kGathered). Their slots' w_v and v rows are then the
// same, and so are their aggregates' unweighted sums.
template <int F, class T>
__device__ bool same_slots(const ea::ArgsT<T>& a, const ea::Dims& d, long long r) {
  const int lane = threadIdx.x & 31, K = d.R;
  bool diff = false;
  for (int p = lane; p < K; p += 32) {
    diff |= __float_as_uint(a.dist[r * K + p]) != __float_as_uint(a.dist[(r - 1) * K + p]);
    if (F == ea::kList) diff |= a.nbr[r * K + p] != a.nbr[(r - 1) * K + p];
  }
  if (F == ea::kGathered && !__any_sync(0xffffffffu, diff)) {
    constexpr int kPer16 = 16 / sizeof(T);  // values of a 16-byte piece
    const long long n = (long long)K * d.H * d.vd / kPer16;  // 16-byte pieces of a row's K v rows
    const uint4* x = reinterpret_cast<const uint4*>(a.v) + r * n;
    const uint4* y = x - n;
    for (long long t = lane; t < n && !diff; t += 32) {
      const uint4 u = __ldg(x + t), w = __ldg(y + t);
      diff = u.x != w.x || u.y != w.y || u.z != w.z || u.w != w.w;
    }
  }
  return !__any_sync(0xffffffffu, diff);
}

// One warp a row: the plan of each row, mode | taken << 2. A dead-weighted
// row that reads the same slot inputs as the row before it in its graph,
// itself dead-weighted, is a copy.
template <int F, class T = float>
__global__ void __launch_bounds__(kPlanThreads)
list_fwd_plan_kernel(ea::ArgsT<T> a, ea::Dims d, int* __restrict__ plan) {
  const int lane = threadIdx.x & 31, K = d.R;
  const long long rows = (long long)d.B * d.N;
  const long long warps = (long long)gridDim.x * (kPlanThreads / 32);
  for (long long r = blockIdx.x * (long long)(kPlanThreads / 32) + (threadIdx.x >> 5); r < rows;
       r += warps) {
    int live = 0;
    for (int p = lane; p < K; p += 32) live += a.nmask[r * K + p] != 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) live += __shfl_xor_sync(0xffffffffu, live, o);
    int mode = kLive | live << 2;
    if (live == 0 && dead_weighted(a, d, r)) {
      mode = kDead | K << 2;
      if (r % d.N != 0 && dead_weighted(a, d, r - 1) && same_slots<F, T>(a, d, r)) mode = kCopy;
    }
    if (lane == 0) plan[r] = mode;
  }
}

// One warp a row: each copy's output from its source's unweighted sums
// (sums [rows, H*vd], written by list_fwd_tile_kernel for every
// dead-weighted row it evaluates; the source is the nearest row before the
// copy that is not one) and its own softmax in closed form, as the tile
// kernel writes a dead-weighted row's (at T = bf16 its weights rounded, and
// the output rounded once).
template <class T = float>
__global__ void __launch_bounds__(kPlanThreads)
list_fwd_copy_kernel(const int* __restrict__ plan, const float* __restrict__ ds,
                     const T* __restrict__ dval, const float* __restrict__ sums,
                     T* __restrict__ out, long long rows, int K, int H, int vd) {
  const int lane = threadIdx.x & 31, HV = H * vd;
  const long long warps = (long long)gridDim.x * (kPlanThreads / 32);
  for (long long r = blockIdx.x * (long long)(kPlanThreads / 32) + (threadIdx.x >> 5); r < rows;
       r += warps) {
    if ((plan[r] & 3) != kCopy) continue;
    long long src = -1;
    for (long long j = r - 1; src < 0; j -= 32) {  // (a copy's chain ends in its graph)
      const long long q = j - lane;
      const unsigned bal = __ballot_sync(0xffffffffu, q < 0 || (plan[q] & 3) != kCopy);
      if (bal) src = j - (__ffs(bal) - 1);
    }
    for (int c = 4 * lane; c < HV; c += 128) {
      float2 aw = ea::dead_row_weights(ds[r * H + c / vd], K);  // (a_dead, a_self)
      aw = make_float2(rnd<T>(aw.x), rnd<T>(aw.y));
      const float4 u = *reinterpret_cast<const float4*>(sums + src * HV + c);
      const float4 dv = ld4(dval + r * HV + c);
      st4(out + r * HV + c,
          make_float4(fmaf(aw.x, u.x, aw.y * dv.x), fmaf(aw.x, u.y, aw.y * dv.y),
                      fmaf(aw.x, u.z, aw.y * dv.z), fmaf(aw.x, u.w, aw.y * dv.w)));
    }
  }
}

__device__ __forceinline__ void put_row(const Sm& s, int i, int node, int mode, int first,
                                        int cnt, int chunk) {
  s.rnode[i] = node;
  s.rmode[i] = mode;
  s.rfirst[i] = first;
  s.rcnt[i] = cnt;
  s.rredo[i] = 0;
  s.rchunk[i] = chunk;
}

// Warp 0: the next tile's rows. Rows to take again whole go first, alone;
// else rows from the cursor while their slots and chunks fit, the live
// rows' slots first (the k-section), then the dead-weighted rows'. Writes
// kRows, kSlots, kSlotsK, kChunks.
__device__ void plan_tile(const int* __restrict__ plan, int K, const Sm& s) {
  const int lane = threadIdx.x & 31;
  int rows = 0, slots = 0, kslots = 0, chunks = 0;
  const int nredo = s.ctl[kRedo];
  if (nredo > 0) {  // at most 128 / K rows: 8 + 32 chunks
    const int kch = (K + kChunk - 1) / kChunk;
    const int take = min(min(nredo, kTM / K), 32);
    if (lane < take) put_row(s, lane, s.redo[lane], kWhole, lane * K, K, lane * kch);
    __syncwarp();
    if (lane == 0)
      for (int i = take; i < nredo; ++i) s.redo[i - take] = s.redo[i];
    rows = take;
    slots = kslots = take * K;
    chunks = take * kch;
    if (lane == 0) s.ctl[kRedo] = nredo - take;
  } else {
    const int hi = s.ctl[kHi];
    int cur = s.ctl[kCursor];
    while (rows < kTR && cur < hi) {
      const int r = cur + lane;
      const int v = r < hi ? plan[r] : 0;
      const int mode = v & 3, c = v >> 2, ch = (c + kChunk - 1) / kChunk;
      const int ck = mode == kDead ? 0 : c;  // slots in the k-section
      int incl = c, inck = ck, inch = ch;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, o);
        const int yk = __shfl_up_sync(0xffffffffu, inck, o);
        const int z = __shfl_up_sync(0xffffffffu, inch, o);
        if (lane >= o) incl += y, inck += yk, inch += z;
      }
      const bool fits = r < hi && slots + incl <= kTM && chunks + inch <= kMaxChunks &&
                        rows + lane < kTR;
      const int n = __popc(__ballot_sync(0xffffffffu, fits));  // a prefix of the lanes
      // a dead-weighted row's first slot counts from the v-section's start,
      // moved past the k-section below
      const int first = mode == kDead ? (slots - kslots) + (incl - inck) - c : kslots + inck - ck;
      if (fits) put_row(s, rows + lane, r, mode, first, c, chunks + inch - ch);
      if (n > 0) {
        slots += __shfl_sync(0xffffffffu, incl, n - 1);
        kslots += __shfl_sync(0xffffffffu, inck, n - 1);
        chunks += __shfl_sync(0xffffffffu, inch, n - 1);
      }
      rows += n;
      cur += n;
      if (n < 32) break;
    }
    if (lane == 0) s.ctl[kCursor] = cur;
    __syncwarp();
    for (int i = lane; i < rows; i += 32)
      if (s.rmode[i] == kDead) s.rfirst[i] += kslots;
  }
  if (lane == 0) {
    s.ctl[kRows] = rows;
    s.ctl[kSlots] = slots;
    s.ctl[kSlotsK] = kslots;
    s.ctl[kChunks] = chunks;
  }
}

// The tile's slot rows: a live row's live slots in slot order, the other
// rows' K slots; rows ns .. 16 nb - 1 are zero padding (distance 0, no row).
// One warp a 32-slot segment of a row, its loads (and the mask of the row's
// earlier segments, which place a live row's slots) issued together; the
// first segment's warp also keeps the row's self scores.
template <int F, class T>
__device__ void fill_slots(const ea::ArgsT<T>& a, const ea::Dims& d, const Sm& s, int nrows, int ns,
                           int nb) {
  const int lane = threadIdx.x & 31, K = d.R, nseg = (K + 31) / 32;
  for (int job = threadIdx.x >> 5; job < nrows * nseg; job += kWarps) {
    const int i = job / nseg, sg = job - i * nseg;
    const int mode = s.rmode[i], node = s.rnode[i], cnt = s.rcnt[i];
    const long long s0 = (long long)node * K;
    if (sg == 0) {
      for (int q = lane; q * kChunk < cnt; q += 32) s.chunkrow[s.rchunk[i] + q] = i;
      if (lane < d.H) s.rds[i * kMaxH + lane] = a.ds[(long long)node * d.H + lane];
    }
    if (cnt == 0) continue;
    const int p = 32 * sg + lane;
    unsigned char mk[kTM / 32];
#pragma unroll
    for (int q = 0; q < kTM / 32; ++q)
      mk[q] = q <= sg && 32 * q + lane < K ? a.nmask[s0 + 32 * q + lane] : 0;
    const float dd = p < K ? a.dist[s0 + p] : 0.f;
    const int nbr = F == ea::kList && p < K ? a.nbr[s0 + p] : 0;
    int before = 32 * sg;  // the row's slots taken before this segment
    if (mode == kLive) {
      before = 0;
#pragma unroll
      for (int q = 0; q < kTM / 32; ++q)
        if (q < sg) before += __popc(__ballot_sync(0xffffffffu, mk[q] != 0));
    }
    bool live = false;
#pragma unroll
    for (int q = 0; q < kTM / 32; ++q)
      if (q == sg) live = mk[q] != 0;
    const bool take = mode == kLive ? live : p < K;
    const unsigned bal = __ballot_sync(0xffffffffu, take);
    if (take) {
      const int m = s.rfirst[i] + before + __popc(bal & ((1u << lane) - 1));
      s.rowof[m] = i;
      s.dist[m] = dd;
      s.mask[m] = live ? 1.f : 0.f;
      s.kv[m] = F == ea::kList ? (int)((long long)(node / d.N) * d.N + nbr) : (int)(s0 + p);
    }
  }
  for (int m = ns + threadIdx.x; m < 16 * nb; m += kThreads) {
    s.dist[m] = 0.f;
    s.mask[m] = 0.f;
    s.rowof[m] = -1;
  }
}

template <int F, class T = float>
__global__ void __launch_bounds__(kThreads, 1)
list_fwd_tile_kernel(ea::ArgsT<T> a, ea::Dims d, T* __restrict__ out, float* __restrict__ sums,
                     const int* __restrict__ plan, int* __restrict__ stats) {
  extern __shared__ __align__(16) float smem[];
  const Sm s = carve(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int H = d.H, K = d.R, HK = H * KD, HV = H * VD;
  const float scale = 1.f / sqrtf((float)KD), coeff = a.coeff;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  load_split_weights<T>(a, s);
  block_range(plan, d.B * d.N, s.ctl);
  int walked[kStats] = {};  // thread 0's counts, for stats

  for (;;) {
    __syncthreads();  // the last tile's readers are done; ctl is published
    if (warp == 0) plan_tile(plan, K, s);
    __syncthreads();
    const int nrows = s.ctl[kRows], ns = s.ctl[kSlots], nsk = s.ctl[kSlotsK];
    const int nchunks = s.ctl[kChunks];
    if (nrows == 0) break;
    const int nb = (ns + 15) / 16, nbk = (nsk + 15) / 16;
    fill_slots<F, T>(a, d, s, nrows, ns, nb);
    __syncthreads();

    if (ns > 0) {
      // the EdgeMLPs, two warps an m16 block: both nets on the k-section's
      // blocks, the v-net alone on the v-section's
      const int blk = warp >> 1, m0 = 16 * blk;
      if (blk < nbk) {
        if (warp & 1) mlp_pre<T, 6, 12>(s, coeff, m0);
        else mlp_pre<T, 0, 6>(s, coeff, m0);
      } else if (blk < nb) {
        if (warp & 1) mlp_pre<T, 8, 12>(s, coeff, m0);
        else mlp_pre<T, NPK, 8>(s, coeff, m0);
      }
      __syncthreads();
      if (blk < nbk) {
        if (warp & 1) {
          mlp_w<T, false, 3, 8>(s, m0);
        } else {
          mlp_w<T, true, 0, NPK>(s, m0);
          mlp_w<T, false, 0, 3>(s, m0);
        }
      } else if (blk < nb) {
        if (warp & 1) mlp_w<T, false, 4, 8>(s, m0);
        else mlp_w<T, false, 0, 4>(s, m0);
      }
      __syncthreads();
      // the k-section's scores, one warp a slot, four slots at a time: the
      // lanes read each live slot's key row and its row's query in pieces of
      // four values side by side; a head's pieces are 8 lanes (kd 32), summed
      // across them (at T = bf16 each term rounded before the sum)
      constexpr int U = 4;
      for (int mb = warp; mb < nsk; mb += U * kWarps) {
        float4 kq[U], qq[U];
        const int c = 4 * lane;
#pragma unroll
        for (int u = 0; u < U; ++u) {  // every load of the slots in flight
          const int m = mb + u * kWarps;
          const bool on = m < nsk && c < HK && s.mask[m] != 0.f;
          const long long node = on ? s.rnode[s.rowof[m]] : 0, kv = on ? s.kv[m] : 0;
          kq[u] = on ? ld4(a.k + kv * HK + c) : zero;
          qq[u] = on ? ld4(a.qt + node * HK + c) : zero;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int m = mb + u * kWarps;
          const int mm = min(m, nsk - 1);  // (a slot past the section computes, and writes nothing)
          const float4 ww = *reinterpret_cast<const float4*>(s.wk + mm * LPK + c % KD);
          float part = dot3<T>(qq[u], ww, kq[u]);
#pragma unroll
          for (int off = 1; off < KD / 4; off <<= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
          if (m < nsk && c < HK && c % KD == 0)
            s.S[m * kMaxH + c / KD] = s.mask[m] != 0.f ? part * scale : -1e9f;
        }
      }
    }
    __syncthreads();
    // one warp a (row, head): the max over the self score and the taken
    // scores, then the softmax weights in place of the scores and a_self; a
    // live row whose max leaves its dead slots a weight in some head is
    // taken again whole and sends nothing now; a dead-weighted row's
    // softmax in closed form (its K slots score -1e9); at T = bf16 the
    // weights that weigh values rounded
    for (int job = warp; job < nrows * H; job += kWarps) {
      const int i = job / H, h = job - i * H, mode = s.rmode[i];
      const int m0 = s.rfirst[i], m1 = m0 + s.rcnt[i];
      const float sd = s.rds[i * kMaxH + h];
      if (mode == kCopy) continue;
      if (mode == kDead) {  // the aggregate sums w_v v unweighted (a copy takes the same sums)
        const float2 aw = ea::dead_row_weights(sd, K);  // (a_dead, a_self)
        for (int m = m0 + lane; m < m1; m += 32) s.S[m * kMaxH + h] = 1.f;
        if (lane == 0) s.ra[i * kMaxH + h] = rnd<T>(aw.y), s.rad[i * kMaxH + h] = rnd<T>(aw.x);
        continue;
      }
      float mx = sd;
      for (int m = m0 + lane; m < m1; m += 32) mx = fmaxf(mx, s.S[m * kMaxH + h]);
      mx = singa::warp_max(mx);
      if (mode == kLive && expf(-ea::kBig - mx) != 0.f) {
        if (lane == 0) s.rredo[i] = 1;
        continue;
      }
      float l = 0.f;
      for (int m = m0 + lane; m < m1; m += 32) {
        const float e = expf(s.S[m * kMaxH + h] - mx);
        s.S[m * kMaxH + h] = e;
        l += e;
      }
      const float es = expf(sd - mx);
      l = es + singa::warp_sum(l);
      for (int m = m0 + lane; m < m1; m += 32) s.S[m * kMaxH + h] = rnd<T>(s.S[m * kMaxH + h] / l);
      if (lane == 0) s.ra[i * kMaxH + h] = rnd<T>(es / l);
    }
    __syncthreads();
    // the rows to take again, in row order, and the counts
    if (warp == 0) {
      int n = s.ctl[kRedo];
      for (int i0 = 0; i0 < nrows; i0 += 32) {
        const int i = i0 + lane;
        const bool f = i < nrows && s.rredo[i];
        const unsigned bal = __ballot_sync(0xffffffffu, f);
        if (f) s.redo[n + __popc(bal & ((1u << lane) - 1))] = s.rnode[i];
        n += __popc(bal);
      }
      if (lane == 0) s.ctl[kRedo] = n;
      if (stats && lane == 0) {
        for (int i = 0; i < nrows; ++i) {
          const int mode = s.rmode[i];
          walked[kStatLive] += mode == kLive && !s.rredo[i];
          walked[kStatDead] += mode == kDead;
          walked[kStatWhole] += mode == kWhole;
        }
        walked[kStatSlots] += ns;
      }
    }
    // the aggregate, one warp a (chunk of a row's slots, 128 value
    // channels): lane l takes channels 4l..4l+3 of the half; the chunk's v
    // rows are loaded together, then summed in slot order into the chunk's
    // partial (the chunk sums are summed per row in chunk order below)
    const int halves = (HV + 127) / 128;
    for (int job = warp; job < nchunks * halves; job += kWarps) {
      const int k = job / halves, c = 128 * (job - k * halves) + 4 * lane;
      const int i = s.chunkrow[k];
      if (s.rredo[i] || c >= HV) continue;
      const int ma = s.rfirst[i] + kChunk * (k - s.rchunk[i]);
      const int n = min(kChunk, s.rfirst[i] + s.rcnt[i] - ma);
      const int h = c / VD;
      float4 vq[kChunk];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const T* vrow = a.v + (long long)s.kv[ma + min(u, n - 1)] * HV;
        vq[u] = u < n ? ld4(vrow + c) : zero;
      }
      float4 acc = zero;
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        if (u < n) {
          const int m = ma + u;
          const float aw = s.S[m * kMaxH + h];
          const float4 w = *reinterpret_cast<const float4*>(s.wv + m * LPV + c % VD);
          acc.x = fmaf(aw * w.x, vq[u].x, acc.x);
          acc.y = fmaf(aw * w.y, vq[u].y, acc.y);
          acc.z = fmaf(aw * w.z, vq[u].z, acc.z);
          acc.w = fmaf(aw * w.w, vq[u].w, acc.w);
        }
      }
      *reinterpret_cast<float4*>(s.part + k * (kMaxH * VD) + c) = acc;
    }
    __syncthreads();
    // the rows' outputs: their chunk sums in chunk order, then a_self dval;
    // a dead-weighted row's sums (unweighted) go to sums for its copies,
    // then a_dead times them
    for (int job = tid; job < nrows * HV / 4; job += kThreads) {
      const int i = job / (HV / 4), c = 4 * (job - i * (HV / 4)), mode = s.rmode[i];
      if (s.rredo[i] || mode == kCopy) continue;
      const long long at = (long long)s.rnode[i] * HV + c;
      float4 sum = zero;
      for (int k = s.rchunk[i], e = k + (s.rcnt[i] + kChunk - 1) / kChunk; k < e; ++k) {
        const float4 p = *reinterpret_cast<const float4*>(s.part + k * (kMaxH * VD) + c);
        sum.x += p.x, sum.y += p.y, sum.z += p.z, sum.w += p.w;
      }
      const float as = s.ra[i * kMaxH + c / VD];
      const float4 dv = ld4(a.dval + at);
      float4 o;
      if (mode == kDead) {
        *reinterpret_cast<float4*>(sums + at) = sum;
        const float ad = s.rad[i * kMaxH + c / VD];
        o = make_float4(fmaf(ad, sum.x, as * dv.x), fmaf(ad, sum.y, as * dv.y),
                        fmaf(ad, sum.z, as * dv.z), fmaf(ad, sum.w, as * dv.w));
      } else {
        o = make_float4(fmaf(as, dv.x, sum.x), fmaf(as, dv.y, sum.y), fmaf(as, dv.z, sum.z),
                        fmaf(as, dv.w, sum.w));
      }
      st4(out + at, o);
    }
  }

  if (stats && tid == 0)
    for (int i = 0; i < kStats; ++i) atomicAdd(stats + i, walked[i]);
}

// Which instance runs: the tensor-core kernel where it takes the shapes
// (its slot indices are int), else the CUDA-core one (cuda_cores: the
// CUDA-core one at any shape); 0 tensor cores, 1 CUDA cores, -1 neither
// (the CUDA-core instance checks its shared memory when it launches).
int instance(const ea::Dims& d, int cuda_cores) {
  if (!d.ok()) return -1;
  const bool fits = (long long)d.B * d.N * d.R < (1LL << 31);
  return !cuda_cores && fits && tc_ok(d) ? 0 : 1;
}

template <int F, class T = float>
int launch(const ea::ArgsT<T>& a, const ea::Dims& d, T* out, float* sums, int* plan, int cuda_cores,
           int* stats, void* stream) {
  const int inst = instance(d, cuda_cores);
  if (inst < 0) return (int)cudaErrorInvalidValue;
  if (inst == 1) return ea::launch_fwd<F, T>(a, d, out, stream);
  const uintptr_t rows16 = reinterpret_cast<uintptr_t>(a.qt) | reinterpret_cast<uintptr_t>(a.k) |
                           reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(a.dval) |
                           reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(sums);
  if ((rows16 & 15) != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = singa::allow_smem(list_fwd_tile_kernel<F, T>, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)d.B * d.N;
  const long long warp_jobs = (rows + kPlanThreads / 32 - 1) / (kPlanThreads / 32);
  const int plan_grid =
      singa::persistent_grid(list_fwd_plan_kernel<F, T>, kPlanThreads, 0, warp_jobs);
  list_fwd_plan_kernel<F, T><<<plan_grid, kPlanThreads, 0, st>>>(a, d, plan);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int grid = singa::persistent_grid(list_fwd_tile_kernel<F, T>, kThreads, kSmemBytes, rows);
  list_fwd_tile_kernel<F, T><<<grid, kThreads, kSmemBytes, st>>>(a, d, out, sums, plan, stats);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int copy_grid =
      singa::persistent_grid(list_fwd_copy_kernel<T>, kPlanThreads, 0, warp_jobs);
  list_fwd_copy_kernel<T><<<copy_grid, kPlanThreads, 0, st>>>(plan, a.ds, a.dval, sums, out, rows,
                                                              d.R, d.H, d.vd);
  return (int)cudaGetLastError();
}

template <int F, class T = float>
int residency(int* smem_bytes, int* threads) {
  *smem_bytes = (int)kSmemBytes;
  *threads = kThreads;
  if (singa::allow_smem(list_fwd_tile_kernel<F, T>, kSmemBytes) != cudaSuccess) return -1;
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, list_fwd_tile_kernel<F, T>, kThreads,
                                                    kSmemBytes) != cudaSuccess)
    return -1;
  return per_sm;
}

}  // namespace

// Which kernel runs these widths (any B, N): 0 the tensor-core one, 1 the
// CUDA-core instance (which may still refuse a K whose slots exceed its
// shared memory), -1 neither. Launches nothing.
extern "C" int neighbor_attn_instance(int K, int H, int kd, int vd, int De) {
  return instance(ea::Dims{1, 1, K, H, kd, vd, De}, 0);
}

// The tensor-core tile kernel of K1 (hybrid 0) or K7 (1), at float32 or
// (bf16 != 0) at bfloat16 storage: resident blocks per SM (-1: refused), and
// its threads and dynamic shared memory per block.
extern "C" int neighbor_attn_residency(int hybrid, int bf16, int* smem_bytes, int* threads) {
  if (bf16)
    return hybrid ? residency<ea::kGathered, singa::bf16>(smem_bytes, threads)
                  : residency<ea::kList, singa::bf16>(smem_bytes, threads);
  return hybrid ? residency<ea::kGathered>(smem_bytes, threads)
                : residency<ea::kList>(smem_bytes, threads);
}

// K1: k [B*N, H*kd] and v [B*N, H*vd] read by nbr [B*N, K]; qt, k, v,
// dval and out bfloat16 when bf16 != 0 (K1's bfloat16 instance), else
// float32; the rest float32. Scratch: sums [B*N, H*vd] float32 (the
// dead-weighted rows' unweighted sums, for their copies) and plan [B*N]
// (int). cuda_cores != 0: the CUDA-core instance at any shape. stats: null,
// or int [4] zeros to which the tensor-core kernel adds what it walked (rows
// live, dead-weighted rows evaluated, rows taken again whole, slots
// evaluated; the copies are the rest of the rows); the CUDA-core instance
// evaluates every slot and adds nothing.
extern "C" int neighbor_attn(const void* qt, const void* k, const void* v, const int* nbr,
                             const unsigned char* nmask, const float* dist, const float* ds,
                             const void* dval, const float* centers, const float* wk1,
                             const float* bk1, const float* wk2, const float* bk2,
                             const float* wv1, const float* bv1, const float* wv2,
                             const float* bv2, float coeff, void* out, float* sums, int* plan,
                             int B, int N, int K, int H, int kd, int vd, int De, int cuda_cores,
                             int bf16, int* stats, void* stream) {
  const ea::Dims d{B, N, K, H, kd, vd, De};
  if (bf16) {
    const ea::ArgsT<singa::bf16> a{(const singa::bf16*)qt, (const singa::bf16*)k,
                                   (const singa::bf16*)v, nbr, nmask, dist, ds,
                                   (const singa::bf16*)dval, centers, wk1, bk1, wk2, bk2, wv1,
                                   bv1, wv2, bv2, coeff};
    return launch<ea::kList, singa::bf16>(a, d, (singa::bf16*)out, sums, plan, cuda_cores, stats,
                                          stream);
  }
  const ea::Args a{(const float*)qt, (const float*)k, (const float*)v, nbr, nmask, dist, ds,
                   (const float*)dval, centers, wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2, coeff};
  return launch<ea::kList>(a, d, (float*)out, sums, plan, cuda_cores, stats, stream);
}

// K7: k_nb [B*N, K, H*kd] and v_nb [B*N, K, H*vd], the slots' rows
// gathered, and no nbr; qt, k_nb, v_nb, dval and out bfloat16 when bf16 != 0
// (K7's bfloat16 instance), else float32; the rest as K1's.
extern "C" int neighbor_attn_hybrid(const void* qt, const void* k_nb, const void* v_nb,
                                    const unsigned char* nmask, const float* dist,
                                    const float* ds, const void* dval, const float* centers,
                                    const float* wk1, const float* bk1, const float* wk2,
                                    const float* bk2, const float* wv1, const float* bv1,
                                    const float* wv2, const float* bv2, float coeff, void* out,
                                    float* sums, int* plan, int B, int N, int K, int H, int kd,
                                    int vd, int De, int cuda_cores, int bf16, int* stats,
                                    void* stream) {
  const ea::Dims d{B, N, K, H, kd, vd, De};
  if (bf16) {
    using singa::bf16;
    const ea::ArgsT<bf16> a{(const bf16*)qt, (const bf16*)k_nb, (const bf16*)v_nb, nullptr,
                            nmask, dist, ds, (const bf16*)dval, centers, wk1, bk1, wk2, bk2,
                            wv1, bv1, wv2, bv2, coeff};
    return launch<ea::kGathered, bf16>(a, d, (bf16*)out, sums, plan, cuda_cores, stats, stream);
  }
  const ea::Args a{(const float*)qt, (const float*)k_nb, (const float*)v_nb, nullptr, nmask,
                   dist, ds, (const float*)dval, centers, wk1, bk1, wk2, bk2, wv1, bv1, wv2,
                   bv2, coeff};
  return launch<ea::kGathered>(a, d, (float*)out, sums, plan, cuda_cores, stats, stream);
}
