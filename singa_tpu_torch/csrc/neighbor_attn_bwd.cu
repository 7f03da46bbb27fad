// K1b: neighbour-list graph attention of the kNN encoder, backward; and K7b,
// the same from neighbour rows gathered outside the kernel.
//
// Replaces: singa_tpu/ops/pallas/neighbor_attn.py::_bwd (_attn_bwd_kernel)
// and ::_bwd_h (the hybrid form's backward, selected by
// SINGA_TPU_HYBRID_ATTN): k[nbr[p]] and v[nbr[p]] are then read from k_nb
// [B*N, K, H*kd] and v_nb [B*N, K, H*vd] (row node*K + p), re-gathered by
// torch.gather before the launch; dk and dv still go to the node rows. The
// gradients are those csrc/encoder_attn.cuh sets out.
//
// What the data needs, exactly. A row's dead slots score -1e9. Once the
// row's max m (over its self score and its live slots' scores) is above
// about -1e9 + 104 in every head, each dead slot weighs exp(-1e9 - m) = 0 in
// float32 and its dsc is 0 by the mask, so every term it adds to any
// gradient is an exact zero: such a row walks its live slots only. A row
// whose cotangent g is zero everywhere has every output exactly zero (inputs
// finite): nothing is computed for it. On the model path g is zero on every
// padded row (NeighborGraphMHA ends with out * node_mask and every operation
// between is row by row), so half the rows of a microbatch are skipped. A
// row whose max leaves a dead slot a weight in some head (a padded row with
// g != 0: self score -1e9, no live slot; or live scores near -1e9) sends
// nothing from its live slots and is taken again, whole, in the block's next
// tile, as before. A row with no live slot whose self score is finite has
// a_self = 1 and no slot term.
//
// What bounds it on the H100: at the training path's shapes (32 graphs x 384
// nodes, K = 96 slots, De = 64, H = 4, kd = 32, vd = 64) each live slot
// costs ~60 kFLOP, ~92 % of it the two EdgeMLPs recomputed, their backward
// and their weight gradients: ~23 GFLOP over the corpus's ~381k live slots
// (~0.34 ms at the 67 TFLOP/s float32 rate; those products as split TF32,
// three TF32 products each at 495 TFLOP/s, ~0.13 ms), against ~100 MB of
// node rows in and out (~30 us at 3.35 TB/s); arithmetic bounds it.
//
// Design. Four kernels, every sum in a fixed order (deterministic, no
// atomics):
//   1. list_plan_kernel: one warp per row reads g and the mask and writes
//      whether the row is skipped and how many live slots it takes (plan).
//   2. list_bwd_pair_kernel: a persistent block of 16 warps per SM (its
//      shared memory) takes a contiguous range of rows that carries a like
//      share of the taken slots (each block scans the plan). It packs the
//      taken slots of consecutive rows into tiles of up to 128 slot rows,
//      rows kept whole, the live slots compacted from the mask in slot
//      order. A row's slots sit in one tile, so its softmax is taken in one
//      pass, without online rescales. Per tile: the EdgeMLPs (the smear
//      formed in the fragments -> h = ssp(pre) [kd | vd], kept -> w_k, w_v),
//      dh = (dw W2^T) * sigmoid(pre) (sigmoid(pre) = 1 - exp(-h) / 2), and
//      the four weight gradients e^T dh_k, h_k^T dw_k, e^T dh_v, h_v^T dw_v
//      (depth: the tile's slots) run on the tensor cores as split TF32
//      mma.sync (csrc/mma_tf32.cuh: float32 to round-off); each tile's
//      weight-gradient products are summed from zero and added to float32
//      sums each lane keeps across the block's tiles. The scores and da (a
//      warp per slot), the softmax (a warp per row and head), dqt, dw_k and
//      dw_v (a warp per 16 slots of a row: each slot's k and v rows read
//      once, dqt's chunk sums added per row in chunk order) and the bias
//      gradients stay float32 on the CUDA cores, the k/v rows read by
//      index in 16-byte pieces side by side. Per slot it writes w_k, w_v, a
//      and dsc for the dk/dv stage; a slot it skips gets a = dsc = 0.
//   3. list_dkdv_kernel (the TPU's hybrid backward kept its one-hot
//      transpose matmul): one block per destination row sums the slots that
//      name it over the CSR transpose of nbr, built once per graph by
//      build_neighbor_graph (the adjacency is not symmetric after the top-K
//      cut), reading the source node's qt and g rows by index; the slots
//      whose a and dsc are 0 (skipped ones) are dropped as each chunk of the
//      transpose is staged, so their w_k and w_v are never read.
//   4. sum_rows_kernel: the blocks' weight-gradient rows, in block order.
// The tensor-core pair kernel and its dk/dv stage take the encoder's widths
// (kd 32, vd 64, De 64), H <= 4 and K <= 128. Every other shape whose
// weight gradients fit the sums a block's threads keep (12,288) and whose
// pair buffers for K slots fit shared memory goes to list_bwd_cc_kernel
// and list_dkdv_cc_kernel: the same plan and exact rules on the CUDA cores,
// a node at a time (below). The blocks function refuses any other shape.
// Shared with K1/K7's forward (neighbor_attn.cu), in csrc/list_attn.cuh:
// the widths, tiles and pair-buffer strides, the smear and its A fragments,
// the shifted softplus and block_range.
// bfloat16 (neighbor_attn_bwd_bf16, neighbor_attn_hybrid_bwd_bf16): K1b's
// and K7b's bfloat16 instances are the same kernels at T = bf16, the storage type of qt, k, v, diag_value, g, dqt, dk,
// dv and d diag_value: the tensor-core pair kernel and its dk/dv stage at
// the widths they take, else the CUDA-core ones (list_bwd_cc_kernel, whose
// note sets out the roundings, and list_dkdv_cc_kernel). In the pair kernel
// every EdgeMLP product multiplies two bfloat16 values (the weights, the
// smear, the hiddens, dw and dh, each rounded where the Pallas kernel calls
// .astype(dt)) and is one TF32 mma.sync, exact to float32 accumulation,
// where float32 takes three (mma_tf32.cuh, mma_t); the hiddens stay float32
// in shared memory and round as their fragments load (sigmoid(pre) reads
// them unrounded); the rows of k, v, qt and g come in 8-byte pieces of
// bfloat16 and widen; the head sums on the CUDA cores round each term as
// the CUDA-core instance does. Its ~23 GFLOP a microbatch as one TF32
// product each: ~0.05 ms at 495 TFLOP/s.
// The dense form (kDense; K8b·bf16's tensor-core instance, entry
// dense_edge_attn_bwd_tc, replacing singa_tpu/ops/pallas/dense_edge_attn.py::
// _dbwd at a bfloat16 dtype): the same plan, pair and dk/dv kernels over
// the live lists of adj_dist (ops/cuda/dense_edge_attn.py::live_columns): a
// row's slots are its live columns, whole in one tile (the lists' largest
// live count at most kTM, which the caller checks before the launch); a
// row with no live column and a cotangent takes csrc/encoder_attn.cuh's
// closed form; the plan (dense_plan_kernel) reads the live counts from the
// lists' offsets; the dk/dv stage gathers over the lists' transpose, a
// pair's source row from pair_rows, and adds the closed-form rows' share
// gw; v's and the closed-form rows' column sums, their share of the
// weight gradients (csrc/dense_closed.cuh) and the sum of the blocks' rows
// run beside them, in the order dense_edge_attn_bwd_tc sets out. It rounds
// where _dattn_bwd_kernel rounds (the smear, the weights, the hiddens, dw
// and dh), not where the list forms do (kRound).
#include <stdint.h>

#include <type_traits>

#include "dense_closed.cuh"
#include "list_attn.cuh"

namespace ea = singa::encoder_attn;
namespace tc = singa::tc;

namespace {

using namespace singa::list_attn;

constexpr int kDkdvThreads = 128;
constexpr int kDkdvChunk = kDkdvThreads;  // incoming slots the dk/dv stage stages at a time

// Strides (floats). W1, W2 [in][out] read as B with k paired (frag_b_paired:
// stride % 16 of 4; dh reads W2 as [n][k], frag_b_nk, with 2-way bank
// conflicts at that stride).
using singa::kBf16;
using singa::rnd;

constexpr int LW1K = KD + 4, LW1V = VD + 4, LW2K = KD + 4, LW2V = VD + 4;
constexpr int kWeightFloats = DE * LW1K + DE * LW1V + KD * LW2K + VD * LW2V + 2 * KD + 2 * VD + DE;

// A row's mode (plan[row] = mode | slots taken << 2): skipped (g zero), its
// live slots, or (a row taken again) all K; the dense form's rows with no
// live column (kClosed) take the closed form.
enum Mode { kZero = 0, kLive = 1, kWhole = 2, kClosed = 3 };

// What a launch walked (stats, when asked for): rows skipped for a zero
// cotangent, rows taken with their live slots, rows taken whole, and the
// slots evaluated (a row taken again whole counts its slots twice); the
// dense form also counts its closed-form rows (kStatClosed), and in
// kStatWhole the (row, head) pairs whose max would leave a dead column a
// weight, which it never takes again (none on any real input: see
// csrc/encoder_attn.cuh).
enum Stat { kStatZero = 0, kStatLive, kStatWhole, kStatSlots, kStats, kStatClosed = kStats };
template <int F>
constexpr int kStatsOf = F == ea::kDense ? kStats + 1 : kStats;

// the weight-gradient row: dwk1 dbk1 dwk2 dbk2 dwv1 dbv1 dwv2 dbv2
constexpr int OFF_WK1 = 0, OFF_BK1 = OFF_WK1 + DE * KD, OFF_WK2 = OFF_BK1 + KD;
constexpr int OFF_BK2 = OFF_WK2 + KD * KD, OFF_WV1 = OFF_BK2 + KD, OFF_BV1 = OFF_WV1 + DE * VD;
constexpr int OFF_WV2 = OFF_BV1 + VD, OFF_BV2 = OFF_WV2 + VD * VD, P_TOTAL = OFF_BV2 + VD;

// Shared memory.
struct Sm {
  float *w1k, *w1v, *w2k, *w2v, *b1k, *b2k, *b1v, *b2v, *cent;  // weights
  float *hk, *hv;    // [kTM][LPK | LPV] hidden ssp(pre), then dh
  float *wk, *wv;    // [kTM][LPK | LPV] w_k; w_v, then dw_v
  float* dwk;        // [kTM][LPK] dw_k
  float *S, *D;      // [kTM][kMaxH] scores, then a; da, then dsc
  float *dist, *mask;                   // [kTM]
  int *rowof, *slot, *kv;               // [kTM] tile row, slot p, row of k/v
  float *rm, *ra;                       // [kTR][kMaxH] row max, a_self
  float* qpart;                         // [kMaxChunks][kMaxH * KD] dqt per chunk
  int *rnode, *rmode, *rfirst, *rcnt, *rredo, *rchunk;  // [kTR]
  int* chunkrow;                        // [kMaxChunks] each chunk's tile row
  int* redo;                            // [kTR] rows to take again whole
  int* ctl;                             // [kCtl]
};

constexpr int kSmemFloats = kWeightFloats + kTM * (3 * LPK + 2 * LPV) + 2 * kTM * kMaxH +
                            5 * kTM + 2 * kTR * kMaxH + kMaxChunks * (kMaxH * KD + 1) +
                            7 * kTR + kCtl;
constexpr size_t kSmemBytes = (size_t)kSmemFloats * sizeof(float);
// the dense form's: w_v0 [VD] too, after ctl
constexpr size_t kDenseSmemBytes = kSmemBytes + VD * sizeof(float);

__device__ Sm carve(float* p) {
  Sm s;
  s.w1k = p;                    s.w1v = s.w1k + DE * LW1K;
  s.w2k = s.w1v + DE * LW1V;    s.w2v = s.w2k + KD * LW2K;
  s.b1k = s.w2v + VD * LW2V;    s.b2k = s.b1k + KD;
  s.b1v = s.b2k + KD;           s.b2v = s.b1v + VD;
  s.cent = s.b2v + VD;
  s.hk = s.cent + DE;           s.hv = s.hk + kTM * LPK;
  s.wk = s.hv + kTM * LPV;      s.wv = s.wk + kTM * LPK;
  s.dwk = s.wv + kTM * LPV;
  s.S = s.dwk + kTM * LPK;      s.D = s.S + kTM * kMaxH;
  s.dist = s.D + kTM * kMaxH;   s.mask = s.dist + kTM;
  s.rowof = reinterpret_cast<int*>(s.mask + kTM);
  s.slot = s.rowof + kTM;       s.kv = s.slot + kTM;
  s.rm = reinterpret_cast<float*>(s.kv + kTM);
  s.ra = s.rm + kTR * kMaxH;
  s.qpart = s.ra + kTR * kMaxH;
  s.rnode = reinterpret_cast<int*>(s.qpart + kMaxChunks * kMaxH * KD);
  s.rmode = s.rnode + kTR;      s.rfirst = s.rmode + kTR;
  s.rcnt = s.rfirst + kTR;      s.rredo = s.rcnt + kTR;
  s.rchunk = s.rredo + kTR;     s.chunkrow = s.rchunk + kTR;
  s.redo = s.chunkrow + kMaxChunks;
  s.ctl = s.redo + kTR;
  return s;
}

// The EdgeMLP weights (rounded to T: the TPU kernel's w.astype(dt)), biases
// and centers into shared memory
template <class T>
__device__ void load_weights(const ea::ArgsT<T>& a, const Sm& s) {
  for (int t = threadIdx.x; t < DE * KD; t += kThreads) s.w1k[(t / KD) * LW1K + t % KD] = rnd<T>(a.wk1[t]);
  for (int t = threadIdx.x; t < DE * VD; t += kThreads) s.w1v[(t / VD) * LW1V + t % VD] = rnd<T>(a.wv1[t]);
  for (int t = threadIdx.x; t < KD * KD; t += kThreads) s.w2k[(t / KD) * LW2K + t % KD] = rnd<T>(a.wk2[t]);
  for (int t = threadIdx.x; t < VD * VD; t += kThreads) s.w2v[(t / VD) * LW2V + t % VD] = rnd<T>(a.wv2[t]);
  for (int t = threadIdx.x; t < KD; t += kThreads) { s.b1k[t] = a.bk1[t]; s.b2k[t] = a.bk2[t]; }
  for (int t = threadIdx.x; t < VD; t += kThreads) { s.b1v[t] = a.bv1[t]; s.b2v[t] = a.bv2[t]; }
  for (int t = threadIdx.x; t < DE; t += kThreads) s.cent[t] = a.centers[t];
}

// A = E^T [channel][slot]: channels g, g + 8 from cent, slots t, t + 4 from
// dist, k in order (pairs with frag_b); at T = bf16 rounded
template <class T>
__device__ __forceinline__ tc::FragA frag_smear_trans(float coeff, const float* dist,
                                                      const float* cent) {
  const int g = tc::lane_grp(), t = tc::lane_tig();
  const float d0 = dist[t], d1 = dist[t + 4], c0 = cent[g], c1 = cent[g + 8];
  tc::FragA f;
  tc::split_t<T>(smear(coeff, d0, c0), f.hi[0], f.lo[0]);
  tc::split_t<T>(smear(coeff, d0, c1), f.hi[1], f.lo[1]);
  tc::split_t<T>(smear(coeff, d1, c0), f.hi[2], f.lo[2]);
  tc::split_t<T>(smear(coeff, d1, c1), f.hi[3], f.lo[3]);
  return f;
}

// sigmoid(pre) from h = ssp(pre) = softplus(pre) - log 2
__device__ __forceinline__ float sigmoid_of_hidden(float h) { return 1.f - 0.5f * __expf(-h); }

// h_k | h_v tiles J0 .. J1-1 of the m16 block at row m0: ssp(E [wk1 | wv1] + b1)
// (float32 in shared memory: at T = bf16 its users round it as it loads)
template <class T, int J0, int J1>
__device__ void fwd_pre(const Sm& s, float coeff, int m0) {
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
      const tc::FragB fb = jj < NPK
                               ? tc::frag_b_paired<T>(s.w1k + 8 * ks * LW1K + 8 * jj, LW1K)
                               : tc::frag_b_paired<T>(s.w1v + 8 * ks * LW1V + 8 * (jj - NPK), LW1V);
      tc::mma_t<T>(c[j], fa, fb);
    }
  }
#pragma unroll
  for (int j = 0; j < J1 - J0; ++j) {
    const int jj = J0 + j;
#pragma unroll
    for (int q = 0; q < 4; ++q) c[j][q] = ssp_tc(c[j][q]);
    tc::store_c(htile(s.hk + m0 * LPK, s.hv + m0 * LPV, jj), jj < NPK ? LPK : LPV, c[j]);
  }
}

// w_k (kK) or w_v tiles J0 .. J1-1 of the m16 block at row m0: h W2 + b2
// (at T = bf16 from the rounded hidden, and rounded to R: the list forms
// round them, the dense form does not)
template <class T, bool kK, int J0, int J1, class R = T>
__device__ void fwd_w(const Sm& s, int m0) {
  constexpr int W = kK ? KD : VD, LP = kK ? LPK : LPV, LW = kK ? LW2K : LW2V;
  const int t = tc::lane_tig();
  const float* hid = (kK ? s.hk : s.hv) + m0 * LP;
  const float* W2 = kK ? s.w2k : s.w2v;
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
      tc::mma_t<T>(c[j], fa, tc::frag_b_paired<T>(W2 + 8 * ks * LW + 8 * (J0 + j), LW));
  }
  float* out = (kK ? s.wk : s.wv) + m0 * LP;
#pragma unroll
  for (int j = 0; j < J1 - J0; ++j) {
#pragma unroll
    for (int q = 0; q < 4; ++q) c[j][q] = rnd<R>(c[j][q]);
    tc::store_c(out + 8 * (J0 + j), LP, c[j]);
  }
}

// dh tiles J0 .. J1-1 of the k (kK) or v net at row m0: (dw W2^T) *
// sigmoid(pre), written in place of the hidden h = ssp(pre): sigmoid(pre) =
// 1 - exp(-softplus(pre)) = 1 - exp(-h) / 2 (at T = bf16 rounded)
template <class T, bool kK, int J0, int J1>
__device__ void bwd_dh(const Sm& s, int m0) {
  constexpr int W = kK ? KD : VD, LP = kK ? LPK : LPV, LW = kK ? LW2K : LW2V;
  const int g = tc::lane_grp(), t = tc::lane_tig();
  const float* dw = (kK ? s.dwk : s.wv) + m0 * LP;
  const float* W2 = kK ? s.w2k : s.w2v;
  float* hid = (kK ? s.hk : s.hv) + m0 * LP;
  float c[J1 - J0][4] = {};
#pragma unroll 2
  for (int ks = 0; ks < W / 8; ++ks) {
    const tc::FragA fa = tc::frag_a_paired<T>(dw + 8 * ks, LP);
#pragma unroll
    for (int j = 0; j < J1 - J0; ++j)
      tc::mma_t<T>(c[j], fa, tc::frag_b_nk<T>(W2 + 8 * (J0 + j) * LW + 8 * ks, LW));
  }
#pragma unroll
  for (int j = 0; j < J1 - J0; ++j) {
    float* o = hid + 8 * (J0 + j);
    const float2 h0 = *reinterpret_cast<const float2*>(o + g * LP + 2 * t);
    const float2 h1 = *reinterpret_cast<const float2*>(o + (g + 8) * LP + 2 * t);
    c[j][0] = rnd<T>(c[j][0] * sigmoid_of_hidden(h0.x));
    c[j][1] = rnd<T>(c[j][1] * sigmoid_of_hidden(h0.y));
    c[j][2] = rnd<T>(c[j][2] * sigmoid_of_hidden(h1.x));
    c[j][3] = rnd<T>(c[j][3] * sigmoid_of_hidden(h1.y));
    tc::store_c(o, LP, c[j]);
  }
}

// One warp: the plan of each row in [0, rows), mode | taken << 2: zero (g
// is zero everywhere), else live with its live slots.
template <class T>
__global__ void __launch_bounds__(kPlanThreads)
list_plan_kernel(const T* __restrict__ g, const unsigned char* __restrict__ nmask,
                 int* __restrict__ plan, long long rows, int K, int HV) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (kPlanThreads / 32);
  for (long long r = blockIdx.x * (long long)(kPlanThreads / 32) + (threadIdx.x >> 5); r < rows;
       r += warps) {
    bool nz = false;
    for (int c = lane; c < HV; c += 32) nz |= singa::to_f(g[r * HV + c]) != 0.f;
    int live = 0;
    for (int p = lane; p < K; p += 32) live += nmask[r * K + p] != 0;
    nz = __any_sync(0xffffffffu, nz);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) live += __shfl_xor_sync(0xffffffffu, live, o);
    if (lane == 0) plan[r] = nz ? (kLive | live << 2) : kZero;
  }
}

// The dense form's plan, one warp a row, as list_plan_kernel's (its own
// kernel: a row's live count comes from the lists' row offsets lrow [rows +
// 1], not from a mask): zero (g is zero everywhere), closed (no live
// column: the closed form), else live with its live columns.
template <class T>
__global__ void __launch_bounds__(kPlanThreads)
dense_plan_kernel(const T* __restrict__ g, const int* __restrict__ lrow, int* __restrict__ plan,
                  long long rows, int HV) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (kPlanThreads / 32);
  for (long long r = blockIdx.x * (long long)(kPlanThreads / 32) + (threadIdx.x >> 5); r < rows;
       r += warps) {
    bool nz = false;
    for (int c = lane; c < HV; c += 32) nz |= singa::to_f(g[r * HV + c]) != 0.f;
    nz = __any_sync(0xffffffffu, nz);
    const int live = lrow[r + 1] - lrow[r];
    if (lane == 0) plan[r] = !nz ? kZero : live > 0 ? (kLive | live << 2) : kClosed;
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
// else rows from the cursor while their slots and chunks fit. Writes kRows,
// kSlots, kChunks.
__device__ void plan_tile(const int* __restrict__ plan, int K, const Sm& s) {
  const int lane = threadIdx.x & 31;
  const int kch = (K + kChunk - 1) / kChunk;
  int rows = 0, slots = 0, chunks = 0;
  const int nredo = s.ctl[kRedo];
  if (nredo > 0) {  // at most 128 / K rows: 8 + 32 chunks
    const int take = min(min(nredo, kTM / K), 32);
    if (lane < take) put_row(s, lane, s.redo[lane], kWhole, lane * K, K, lane * kch);
    chunks = take * kch;
    __syncwarp();
    if (lane == 0)
      for (int i = take; i < nredo; ++i) s.redo[i - take] = s.redo[i];
    rows = take;
    slots = take * K;
    if (lane == 0) s.ctl[kRedo] = nredo - take;
  } else {
    const int hi = s.ctl[kHi];
    int cur = s.ctl[kCursor];
    while (rows < kTR && cur < hi) {
      const int r = cur + lane;
      const int v = r < hi ? plan[r] : 0;
      const int c = v >> 2, ch = (c + kChunk - 1) / kChunk;
      int incl = c, inch = ch;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, o);
        const int z = __shfl_up_sync(0xffffffffu, inch, o);
        if (lane >= o) incl += y, inch += z;
      }
      const bool fits = r < hi && slots + incl <= kTM && chunks + inch <= kMaxChunks &&
                        rows + lane < kTR;
      const int n = __popc(__ballot_sync(0xffffffffu, fits));  // a prefix of the lanes
      if (fits) put_row(s, rows + lane, r, v & 3, slots + incl - c, c, chunks + inch - ch);
      if (n > 0) {
        slots += __shfl_sync(0xffffffffu, incl, n - 1);
        chunks += __shfl_sync(0xffffffffu, inch, n - 1);
      }
      rows += n;
      cur += n;
      if (n < 32) break;
    }
    if (lane == 0) s.ctl[kCursor] = cur;
  }
  if (lane == 0) {
    s.ctl[kRows] = rows;
    s.ctl[kSlots] = slots;
    s.ctl[kChunks] = chunks;
  }
}

// The tile's slot rows: a live row's live slots in slot order, a whole row's
// K slots (the dense form: a live row's live columns in order, slot = the
// pair's CSR index, 32 columns a job over all the warps); rows ns .. 16 nb
// - 1 are zero padding (distance 0, no row).
template <int F, class A>
__device__ void fill_slots(const A& a, const ea::Dims& d, const Sm& s, int nrows, int ns,
                           int nb) {
  const int lane = threadIdx.x & 31, K = d.R;
  for (int i = threadIdx.x >> 5; i < nrows; i += kWarps) {
    const int mode = s.rmode[i], first = s.rfirst[i], node = s.rnode[i];
    for (int q = lane; q * kChunk < s.rcnt[i]; q += 32) s.chunkrow[s.rchunk[i] + q] = i;
    if (mode == kZero || F == ea::kDense) continue;  // (the dense form's: below)
    const long long s0 = (long long)node * K, base = (long long)(node / d.N) * d.N;
    int done = 0;
    for (int p0 = 0; p0 < K; p0 += 32) {
      const int p = p0 + lane;
      const bool live = p < K && a.nmask[s0 + p] != 0;
      const bool take = mode == kWhole ? p < K : live;
      const unsigned bal = __ballot_sync(0xffffffffu, take);
      if (take) {
        const int m = first + done + __popc(bal & ((1u << lane) - 1));
        s.rowof[m] = i;
        s.slot[m] = p;
        s.dist[m] = a.dist[s0 + p];
        s.mask[m] = live ? 1.f : 0.f;
        s.kv[m] = F == ea::kList ? (int)(base + a.nbr[s0 + p]) : (int)(s0 + p);
      }
      done += __popc(bal);
    }
  }
  if constexpr (F == ea::kDense) {
    // a live row's live columns, 32 a job, the tile's jobs over the warps
    // (a zero or closed row has none)
    const int warp = threadIdx.x >> 5;
    for (int i = 0, job = 0; i < nrows; ++i)
      for (int j0 = 0; j0 < s.rcnt[i]; j0 += 32, ++job) {
        if (job % kWarps != warp) continue;
        const int node = s.rnode[i], j = j0 + lane;
        if (j < s.rcnt[i]) {
          const int e = a.lrow[node] + j, col = a.lcol[e], m = s.rfirst[i] + j;
          s.rowof[m] = i;
          s.slot[m] = e;
          s.dist[m] = a.dist[(long long)node * K + col];
          s.mask[m] = 1.f;
          s.kv[m] = node / d.N * d.N + col;
        }
      }
  }
  for (int m = ns + threadIdx.x; m < 16 * nb; m += kThreads) {
    s.dist[m] = 0.f;
    s.mask[m] = 0.f;
    s.rowof[m] = -1;
  }
}

// The scratch row (w_k, w_v, a and dsc) of the tile's slot m of row i: the
// list forms' flat slot node * K + p, the dense form's live pair
template <int F>
__device__ __forceinline__ long long scratch_row(const Sm& s, int i, int m, int K) {
  if constexpr (F == ea::kDense) return s.slot[m];
  return (long long)s.rnode[i] * K + s.slot[m];
}

// F: the form; the dense form (K8b's bfloat16 tensor-core instance: T =
// bf16) takes its rows' live columns (the plan's kLive rows), skips kZero
// rows and writes their live pairs' a = dsc = 0, and takes each kClosed
// row in closed form (csrc/encoder_attn.cuh: its dds, ddv and a_dead into
// s_ad, dqt zero; s_ad 0 on every other row); it never takes a row again
// whole (a dead column of a row with a live one weighs an exact 0). It
// rounds where _dattn_bwd_kernel rounds, which is not where the list forms
// do (kRound): the smear, the weights, the hiddens, dw_k, dw_v and dh; w_k,
// w_v, the score and da terms, the softmax weights, dsc and the dk/dv terms
// stay float32.
template <int F, class T = float>
__global__ void __launch_bounds__(kThreads, 1)
list_bwd_pair_kernel(ea::ArgsT<T> a, ea::Dims d, ea::GradsT<T> o, const int* __restrict__ plan,
                     int* __restrict__ stats) {
  // the list forms' roundings past the hiddens, at bfloat16; R: what they round to
  constexpr bool kRound = kBf16<T> && F != ea::kDense;
  using R = std::conditional_t<kRound, T, float>;
  extern __shared__ __align__(16) float smem[];
  const Sm s = carve(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = tc::lane_grp(), t = tc::lane_tig();
  const int H = d.H, K = d.R, HK = H * KD, HV = H * VD;
  const float scale = 1.f / sqrtf((float)KD), coeff = a.coeff;
  load_weights(a, s);
  [[maybe_unused]] float* const w0 = reinterpret_cast<float*>(s.ctl + kCtl);  // kDense: w_v0
  if constexpr (F == ea::kDense) ea::dead_wv<T>(a.bv1, a.wv2, a.bv2, VD, w0);
  block_range(plan, d.B * d.N, s.ctl);

  // float32 sums across the block's tiles, C fragments of m16 x n8 units:
  // dwv2 (m16 block warp / 4, n8 tiles 2 (warp % 4) + 0, 1); dwk2 (warps
  // 0-7: m16 block warp / 4, n8 tile warp % 4); dwk1 | dwv1 (m16 block warp
  // / 4 of the smear channels, n8 tiles 3 (warp % 4) + 0..2 of [dh_k | dh_v]);
  // threads 256 .. 351: one column of [dbk2 | dbv2] and of [dbk1 | dbv1]
  float acc_v2[2][4] = {}, acc_k2[4] = {}, acc_1[3][4] = {}, acc_b2 = 0.f, acc_b1 = 0.f;
  const int mbw = warp >> 2, q4 = warp & 3, bcol = tid - 256;
  const bool bias_thread = bcol >= 0 && bcol < KD + VD;
  int walked[kStatsOf<F>] = {};  // thread 0's counts, for stats

  for (;;) {
    __syncthreads();  // the last tile's readers are done; ctl is published
    if (warp == 0) plan_tile(plan, K, s);
    __syncthreads();
    const int nrows = s.ctl[kRows], ns = s.ctl[kSlots], nchunks = s.ctl[kChunks];
    if (nrows == 0) break;
    const int nb = (ns + 15) / 16, kst = (ns + 7) / 8;
    fill_slots<F>(a, d, s, nrows, ns, nb);
    __syncthreads();

    if (ns > 0) {
      // the EdgeMLPs: two warps per m16 block
      const int m0 = 16 * (warp >> 1);
      if (warp >> 1 < nb) {
        if (warp & 1) fwd_pre<T, 6, 12>(s, coeff, m0);
        else fwd_pre<T, 0, 6>(s, coeff, m0);
      }
      __syncthreads();
      if (warp >> 1 < nb) {
        if (warp & 1) {
          fwd_w<T, false, 3, 8, R>(s, m0);
        } else {
          fwd_w<T, true, 0, NPK, R>(s, m0);
          fwd_w<T, false, 0, 3, R>(s, m0);
        }
      }
      __syncthreads();
      // scores and da, one warp per slot, two slots at a time: the lanes read
      // each slot's k and v rows (and the row's q and g) in 16-byte pieces
      // (bfloat16: 8-byte) side by side; a head's pieces are 8 lanes of k
      // (kd 32) and 16 of v (vd 64), summed across those lanes (the list
      // forms at bfloat16 round each term first)
      for (int m0 = warp; m0 < ns; m0 += 2 * kWarps) {
        const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
        float4 kq[2], qq[2], vq[2][2], gq[2][2];
        for (int u = 0; u < 2; ++u) {  // every load of both slots in flight
          const int m = m0 + u * kWarps, c = 4 * lane;
          const bool on = m < ns;
          const long long node = on ? s.rnode[s.rowof[m]] : 0, kv = on ? s.kv[m] : 0;
          kq[u] = on && c < HK ? ld4(a.k + kv * HK + c) : zero;
          qq[u] = on && c < HK ? ld4(a.qt + node * HK + c) : zero;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const bool onv = on && c + 128 * r < HV;
            vq[u][r] = onv ? ld4(a.v + kv * HV + c + 128 * r) : zero;
            gq[u][r] = onv ? ld4(o.g + node * HV + c + 128 * r) : zero;
          }
        }
        for (int u = 0; u < 2; ++u) {
          const int m = m0 + u * kWarps, c = 4 * lane;
          const int mm = min(m, ns - 1);  // (a slot past the tile computes, and writes nothing)
          const float4 ww = *reinterpret_cast<const float4*>(s.wk + mm * LPK + c % KD);
          float part = dot3<R>(qq[u], ww, kq[u]);
#pragma unroll
          for (int off = 1; off < KD / 4; off <<= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
          if (m < ns && c < HK && c % KD == 0)
            s.S[m * kMaxH + c / KD] = s.mask[m] != 0.f ? part * scale : -1e9f;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int cv = c + 128 * r;
            const float4 wv = *reinterpret_cast<const float4*>(s.wv + mm * LPV + cv % VD);
            float pv = dot3<R>(gq[u][r], wv, vq[u][r]);
#pragma unroll
            for (int off = 1; off < VD / 4; off <<= 1) pv += __shfl_xor_sync(0xffffffffu, pv, off);
            if (m < ns && cv < HV && cv % VD == 0) s.D[m * kMaxH + cv / VD] = pv;
          }
        }
      }
      // w_k and w_v of each taken slot for the dk/dv stage (a row taken again
      // later writes its slots again)
      for (int job = tid; job < ns * (KD + VD) / 4; job += kThreads) {
        const int m = job / ((KD + VD) / 4), c = 4 * (job - m * ((KD + VD) / 4));
        const long long slot = scratch_row<F>(s, s.rowof[m], m, K);
        if (c < KD)
          *reinterpret_cast<float4*>(o.s_wk + slot * KD + c) =
              *reinterpret_cast<const float4*>(s.wk + m * LPK + c);
        else
          *reinterpret_cast<float4*>(o.s_wv + slot * VD + c - KD) =
              *reinterpret_cast<const float4*>(s.wv + m * LPV + c - KD);
      }
    }
    __syncthreads();
    // one warp per (row, head): the max over the self score and the taken
    // slots; a live row whose max leaves its dead slots a weight in some head
    // is taken again whole (the dense form counts it in stats instead)
    for (int job = warp; job < nrows * H; job += kWarps) {
      const int i = job / H, h = job - i * H, mode = s.rmode[i];
      if (mode == kZero || (F == ea::kDense && mode == kClosed)) continue;
      float mx = a.ds[(long long)s.rnode[i] * H + h];
      for (int m = s.rfirst[i] + lane, e = s.rfirst[i] + s.rcnt[i]; m < e; m += 32)
        mx = fmaxf(mx, s.S[m * kMaxH + h]);
      mx = singa::warp_max(mx);
      if (lane == 0) {
        s.rm[i * kMaxH + h] = mx;
        if (mode == kLive && expf(-ea::kBig - mx) != 0.f) {
          if constexpr (F == ea::kDense) {
            if (stats) atomicAdd(stats + kStatWhole, 1);
          } else {
            s.rredo[i] = 1;
          }
        }
      }
    }
    __syncthreads();
    // one warp per (row, head): the softmax, dds, a and dsc; a row taken
    // again sends nothing now
    for (int job = warp; job < nrows * H; job += kWarps) {
      const int i = job / H, h = job - i * H;
      const int m0 = s.rfirst[i], m1 = m0 + s.rcnt[i];
      if (s.rmode[i] == kZero) continue;
      if constexpr (F == ea::kDense) {
        if (s.rmode[i] == kClosed) {  // its N dead columns and itself, in closed form
          const long long node = s.rnode[i], gb = node / d.N;
          float das = 0.f, dead = 0.f;
          for (int c = lane; c < VD; c += 32) {
            const float gv = singa::to_f(o.g[node * HV + h * VD + c]);
            das = fmaf(gv, singa::to_f(a.dval[node * HV + h * VD + c]), das);
            dead = fmaf(gv * w0[c], a.vsum[gb * HV + h * VD + c], dead);
          }
          das = singa::warp_sum(das);
          dead = singa::warp_sum(dead);
          if (lane == 0) {
            const float2 aw = ea::dead_row_weights(a.ds[node * H + h], d.N);
            s.ra[i * kMaxH + h] = aw.y;
            o.dds[node * H + h] = aw.y * (das - fmaf(aw.x, dead, aw.y * das));
            o.s_ad[node * H + h] = aw.x;
          }
          continue;
        }
      }
      if (s.rredo[i]) {
        for (int m = m0 + lane; m < m1; m += 32) s.S[m * kMaxH + h] = s.D[m * kMaxH + h] = 0.f;
        continue;
      }
      const long long node = s.rnode[i];
      const float mx = s.rm[i * kMaxH + h];
      float das = 0.f;  // da_self
      for (int c = lane; c < VD; c += 32) {
        const float gv = singa::to_f(o.g[node * HV + h * VD + c]);
        const float dv = singa::to_f(a.dval[node * HV + h * VD + c]);
        das = kRound ? das + rnd<T>(gv * dv) : fmaf(gv, dv, das);
      }
      das = singa::warp_sum(das);
      float l = 0.f, dot = 0.f;
      for (int m = m0 + lane; m < m1; m += 32) {
        const float e = expf(s.S[m * kMaxH + h] - mx);
        l += e;
        dot = fmaf(e, s.D[m * kMaxH + h], dot);
      }
      const float es = expf(a.ds[node * H + h] - mx);
      l = es + singa::warp_sum(l);
      const float as = es / l, dotn = fmaf(es, das, singa::warp_sum(dot)) / l;
      if (lane == 0) {
        s.ra[i * kMaxH + h] = as;
        o.dds[node * H + h] = as * (das - dotn);
      }
      for (int m = m0 + lane; m < m1; m += 32) {  // (kRound: both rounded, dsc from aw)
        const float aw = expf(s.S[m * kMaxH + h] - mx) / l;
        const float dsc = s.mask[m] != 0.f ? aw * (s.D[m * kMaxH + h] - dotn) * scale : 0.f;
        s.S[m * kMaxH + h] = rnd<R>(aw);
        s.D[m * kMaxH + h] = rnd<R>(dsc);
      }
    }
    __syncthreads();
    // the rows to take again, in row order
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
          walked[kStatZero] += mode == kZero;
          walked[kStatLive] += mode == kLive && !s.rredo[i];
          walked[kStatWhole] += mode == kWhole;
          if constexpr (F == ea::kDense) walked[kStatClosed] += mode == kClosed;
        }
        walked[kStatSlots] += ns;
      }
    }
    // the rows' outputs, what the dk/dv stage reads of a and dsc, and dw_k
    // (into dwk) and dw_v (in place of w_v), four channels a job
    for (int job = tid; job < nrows * HV / 4; job += kThreads) {
      const int i = job / (HV / 4), c = 4 * (job - i * (HV / 4));
      if (s.rredo[i]) continue;
      const long long at = (long long)s.rnode[i] * HV + c;
      float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
      if (s.rmode[i] != kZero) {
        const float as = rnd<R>(s.ra[i * kMaxH + c / VD]);
        float4 gq;
        if constexpr (kBf16<T>)
          gq = ld4(o.g + at);
        else
          gq = *reinterpret_cast<const float4*>(o.g + at);
        r = make_float4(as * gq.x, as * gq.y, as * gq.z, as * gq.w);
      }
      st4(o.ddv + at, r);
    }
    for (int job = tid; job < nrows * H; job += kThreads) {
      const int i = job / H;
      if (s.rmode[i] == kZero) o.dds[(long long)s.rnode[i] * H + job - i * H] = 0.f;
      if constexpr (F == ea::kDense)  // a_dead: the closed-form rows' alone
        if (s.rmode[i] != kClosed) o.s_ad[(long long)s.rnode[i] * H + job - i * H] = 0.f;
    }
    for (int job = tid; job < ns * H; job += kThreads) {
      const int m = job / H, h = job - m * H, i = s.rowof[m];
      if (s.rredo[i]) continue;
      const long long slot = scratch_row<F>(s, i, m, K);
      o.s_a[slot * H + h] = s.S[m * kMaxH + h];
      o.s_dsc[slot * H + h] = s.D[m * kMaxH + h];
    }
    if constexpr (F == ea::kDense) {  // a skipped row's live pairs send nothing
      for (int i = warp; i < nrows; i += kWarps) {
        if (s.rmode[i] != kZero) continue;
        const long long node = s.rnode[i];
        for (long long p = a.lrow[node] + lane, e = a.lrow[node + 1]; p < e; p += 32)
          for (int h = 0; h < H; ++h) o.s_a[p * H + h] = o.s_dsc[p * H + h] = 0.f;
      }
    } else {
      for (int job = tid; job < nrows * K; job += kThreads) {
        const int i = job / K, p = job - i * K, mode = s.rmode[i];
        if (s.rredo[i] || mode == kWhole) continue;
        const long long slot = (long long)s.rnode[i] * K + p;
        if (mode == kLive && a.nmask[slot] != 0) continue;
        for (int h = 0; h < H; ++h) o.s_a[slot * H + h] = o.s_dsc[slot * H + h] = 0.f;
      }
    }
    // dqt, dw_k and dw_v, one warp per chunk of a row's slots: the lanes read
    // each slot's k and v rows once, side by side (lane l: channels 4l..4l+3
    // of k, and of v and v + 128), and the row's q and g; dw sums over the
    // heads across lanes; dqt sums the chunk's slots in the lane, into the
    // chunk's partial (summed per row in chunk order after the barrier). A
    // row taken again has a = dsc = 0: its dw rows are zero
    for (int k = warp; k < nchunks; k += kWarps) {
      const int i = s.chunkrow[k], c = 4 * lane;
      const long long node = s.rnode[i];
      const int ma = s.rfirst[i] + kChunk * (k - s.rchunk[i]);
      const int mb = min(ma + kChunk, s.rfirst[i] + s.rcnt[i]);
      const bool onk = c < HK, onv0 = c < HV, onv1 = c + 128 < HV;
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 qq = onk ? ld4(a.qt + node * HK + c) : zero;
      const float4 g0 = onv0 ? ld4(o.g + node * HV + c) : zero;
      const float4 g1 = onv1 ? ld4(o.g + node * HV + c + 128) : zero;
      const int hk = c / KD, hv0 = c / VD, hv1 = (c + 128) / VD;
      float4 dq = zero;
#pragma unroll 2
      for (int m = ma; m < mb; ++m) {
        const long long kv = s.kv[m];
        const float4 kq = onk ? ld4(a.k + kv * HK + c) : zero;
        const float4 v0 = onv0 ? ld4(a.v + kv * HV + c) : zero;
        const float4 v1 = onv1 ? ld4(a.v + kv * HV + c + 128) : zero;
        const float dsc = onk ? s.D[m * kMaxH + hk] : 0.f;  // (a lane past the heads adds 0)
        const float a0 = onv0 ? s.S[m * kMaxH + hv0] : 0.f, a1 = onv1 ? s.S[m * kMaxH + hv1] : 0.f;
        const float4 w = *reinterpret_cast<const float4*>(s.wk + m * LPK + c % KD);
        dq.x = fmaf(dsc * w.x, kq.x, dq.x);
        dq.y = fmaf(dsc * w.y, kq.y, dq.y);
        dq.z = fmaf(dsc * w.z, kq.z, dq.z);
        dq.w = fmaf(dsc * w.w, kq.w, dq.w);
        // (at bfloat16 the sum rounded; kRound: each term rounded before the
        // head sum too)
        float4 x = make_float4(rnd<R>(dsc * qq.x * kq.x), rnd<R>(dsc * qq.y * kq.y),
                               rnd<R>(dsc * qq.z * kq.z), rnd<R>(dsc * qq.w * kq.w));
        float4 y;
        if constexpr (kRound)
          y = make_float4(rnd<T>(a0 * g0.x * v0.x) + rnd<T>(a1 * g1.x * v1.x),
                          rnd<T>(a0 * g0.y * v0.y) + rnd<T>(a1 * g1.y * v1.y),
                          rnd<T>(a0 * g0.z * v0.z) + rnd<T>(a1 * g1.z * v1.z),
                          rnd<T>(a0 * g0.w * v0.w) + rnd<T>(a1 * g1.w * v1.w));
        else
          y = make_float4(fmaf(a1 * g1.x, v1.x, a0 * g0.x * v0.x),
                          fmaf(a1 * g1.y, v1.y, a0 * g0.y * v0.y),
                          fmaf(a1 * g1.z, v1.z, a0 * g0.z * v0.z),
                          fmaf(a1 * g1.w, v1.w, a0 * g0.w * v0.w));
#pragma unroll
        for (int off = KD / 4; off < 32; off <<= 1) {  // the heads of k: lanes l, l ^ 8, ...
          x.x += __shfl_xor_sync(0xffffffffu, x.x, off);
          x.y += __shfl_xor_sync(0xffffffffu, x.y, off);
          x.z += __shfl_xor_sync(0xffffffffu, x.z, off);
          x.w += __shfl_xor_sync(0xffffffffu, x.w, off);
        }
        y.x += __shfl_xor_sync(0xffffffffu, y.x, VD / 4);  // heads h and h + 1 of v
        y.y += __shfl_xor_sync(0xffffffffu, y.y, VD / 4);
        y.z += __shfl_xor_sync(0xffffffffu, y.z, VD / 4);
        y.w += __shfl_xor_sync(0xffffffffu, y.w, VD / 4);
        if (lane < KD / 4)
          *reinterpret_cast<float4*>(s.dwk + m * LPK + c) =
              make_float4(rnd<T>(x.x), rnd<T>(x.y), rnd<T>(x.z), rnd<T>(x.w));
        if (lane < VD / 4)
          *reinterpret_cast<float4*>(s.wv + m * LPV + c) =
              make_float4(rnd<T>(y.x), rnd<T>(y.y), rnd<T>(y.z), rnd<T>(y.w));
      }
      if (onk) *reinterpret_cast<float4*>(s.qpart + k * kMaxH * KD + c) = dq;
    }
    for (int job = tid; job < (16 * nb - ns) * (KD + VD) / 4; job += kThreads) {  // padding
      const int m = ns + job / ((KD + VD) / 4), c = 4 * (job % ((KD + VD) / 4));
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c < KD) *reinterpret_cast<float4*>(s.dwk + m * LPK + c) = zero;
      else *reinterpret_cast<float4*>(s.wv + m * LPV + c - KD) = zero;
    }
    for (int job = tid; job < nrows * HK / 4; job += kThreads) {  // the rows with no slot
      const int i = job / (HK / 4);
      if (s.rcnt[i] == 0)
        st4(o.dqt + (long long)s.rnode[i] * HK + 4 * (job % (HK / 4)), make_float4(0.f, 0.f, 0.f, 0.f));
    }
    if (ns == 0) continue;
    __syncthreads();
    // dqt: each row's chunk partials in chunk order
    for (int job = tid; job < nrows * HK / 4; job += kThreads) {
      const int i = job / (HK / 4), c = 4 * (job % (HK / 4));
      if (s.rredo[i] || s.rcnt[i] == 0) continue;
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int k = s.rchunk[i], e = k + (s.rcnt[i] + kChunk - 1) / kChunk; k < e; ++k) {
        const float4 p = *reinterpret_cast<const float4*>(s.qpart + k * kMaxH * KD + c);
        sum.x += p.x, sum.y += p.y, sum.z += p.z, sum.w += p.w;
      }
      st4(o.dqt + (long long)s.rnode[i] * HK + c, sum);
    }
    // dwv2 += h_v^T dw_v, dwk2 += h_k^T dw_k; the tile's products from zero,
    // then into the sums; dbk2 | dbv2 column sums
    {
      float c[2][4] = {};
      for (int ks = 0; ks < kst; ++ks) {
        const tc::FragA fa = tc::frag_a_trans<T>(s.hv + 8 * ks * LPV + 16 * mbw, LPV);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          tc::mma_t<T>(c[j], fa, tc::frag_b<T>(s.wv + 8 * ks * LPV + 8 * (2 * q4 + j), LPV));
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc_v2[j][q] += c[j][q];
    }
    if (warp < 8) {
      float c[4] = {};
      for (int ks = 0; ks < kst; ++ks)
        tc::mma_t<T>(c, tc::frag_a_trans<T>(s.hk + 8 * ks * LPK + 16 * mbw, LPK),
                     tc::frag_b<T>(s.dwk + 8 * ks * LPK + 8 * q4, LPK));
#pragma unroll
      for (int q = 0; q < 4; ++q) acc_k2[q] += c[q];
    }
    if (bias_thread) {
      float part = 0.f;
      for (int m = 0; m < ns; ++m) part += bcol < KD ? s.dwk[m * LPK + bcol] : s.wv[m * LPV + bcol - KD];
      acc_b2 += part;
    }
    __syncthreads();
    // dh in place of the hidden, two warps per m16 block
    {
      const int m0 = 16 * (warp >> 1);
      if (warp >> 1 < nb) {
        if (warp & 1) {
          bwd_dh<T, false, 3, 8>(s, m0);
        } else {
          bwd_dh<T, true, 0, NPK>(s, m0);
          bwd_dh<T, false, 0, 3>(s, m0);
        }
      }
    }
    __syncthreads();
    // dwk1 | dwv1 += E^T [dh_k | dh_v]; dbk1 | dbv1 column sums
    {
      float c[3][4] = {};
      for (int ks = 0; ks < kst; ++ks) {
        const tc::FragA fa = frag_smear_trans<T>(coeff, s.dist + 8 * ks, s.cent + 16 * mbw);
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const int jj = 3 * q4 + j;
          const tc::FragB fb = jj < NPK ? tc::frag_b<T>(s.hk + 8 * ks * LPK + 8 * jj, LPK)
                                        : tc::frag_b<T>(s.hv + 8 * ks * LPV + 8 * (jj - NPK), LPV);
          tc::mma_t<T>(c[j], fa, fb);
        }
      }
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc_1[j][q] += c[j][q];
    }
    if (bias_thread) {
      float part = 0.f;
      for (int m = 0; m < ns; ++m) part += bcol < KD ? s.hk[m * LPK + bcol] : s.hv[m * LPV + bcol - KD];
      acc_b1 += part;
    }
  }

  if (stats && tid == 0)
    for (int i = 0; i < kStatsOf<F>; ++i) atomicAdd(stats + i, walked[i]);
  // the block's row of partial sums, each entry from the one lane that owns it
  float* row = o.partial + (long long)blockIdx.x * P_TOTAL;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = 16 * mbw + g + 8 * (q >> 1), c = 2 * t + (q & 1);
#pragma unroll
    for (int j = 0; j < 2; ++j) row[OFF_WV2 + r * VD + 8 * (2 * q4 + j) + c] = acc_v2[j][q];
    if (warp < 8) row[OFF_WK2 + r * KD + 8 * q4 + c] = acc_k2[q];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int jj = 3 * q4 + j;
      if (jj < NPK) row[OFF_WK1 + r * KD + 8 * jj + c] = acc_1[j][q];
      else row[OFF_WV1 + r * VD + 8 * (jj - NPK) + c] = acc_1[j][q];
    }
  }
  if (bias_thread) {
    row[(bcol < KD ? OFF_BK2 : OFF_BV2 - KD) + bcol] = acc_b2;
    row[(bcol < KD ? OFF_BK1 : OFF_BV1 - KD) + bcol] = acc_b1;
  }
}

// dk and dv of destination row j: the slots that name row j, in the CSR
// order of the transpose (offsets [B*N + 1], slots: flat slot ids, source
// node slot / K). Each chunk of kDkdvChunk slots is staged in shared memory
// with its a and dsc, keeping only the slots whose a or dsc is non-zero in
// some head (in order): a slot the pair kernel skipped (a = dsc = 0) adds
// nothing, and its w_k and w_v, which it never wrote, are not read
// (torch.empty scratch may hold NaN, and 0 x NaN is NaN). A kept slot was
// taken, so its w_k and w_v are written and a zero weight adds 0.
// Each thread owns channels tid, tid + 128, ... of [dk | dv]. At T = bf16
// (qt, g, dk and dv bfloat16) each slot's term is rounded before the sum,
// as the TPU kernel rounds dk_nb and dv_nb before its one-hot transpose.
// The dense form (K8b·bf16's tensor-core instance): slots are live pairs
// (their CSR indices), a pair's source row is pair_rows[pair], the terms
// are not rounded (the TPU kernel's float32 column sums, cast once), and
// dv adds gw [B, H*vd] of j's graph (the closed-form rows' share).
template <int F, class T = float>
__global__ void __launch_bounds__(kDkdvThreads)
list_dkdv_kernel(const T* __restrict__ qt, const T* __restrict__ g,
                 const float* __restrict__ s_wk, const float* __restrict__ s_wv,
                 const float* __restrict__ s_a, const float* __restrict__ s_dsc,
                 const int* __restrict__ offsets, const int* __restrict__ slots,
                 T* __restrict__ dk, T* __restrict__ dv, ea::Dims dm,
                 const int* __restrict__ pair_rows = nullptr,
                 const float* __restrict__ gw = nullptr) {
  constexpr bool kRound = kBf16<T> && F != ea::kDense;
  __shared__ int sslot[kDkdvChunk], ssrc[kDkdvChunk], wcount[kDkdvThreads / 32];
  __shared__ float sdsc[kDkdvChunk][kMaxH], sa[kDkdvChunk][kMaxH];
  const int H = dm.H, K = dm.R, HK = H * KD, HV = H * VD;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int kPer = kMaxH * (KD + VD) / kDkdvThreads;  // channels a thread owns at most
  const long long rows = (long long)dm.B * dm.N;
  for (long long j = blockIdx.x; j < rows; j += gridDim.x) {
    const int e0 = offsets[j], e1 = offsets[j + 1];
    float acc[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) acc[i] = 0.f;
    for (int c0 = e0; c0 < e1; c0 += kDkdvChunk) {
      // one slot per thread (kDkdvChunk = kDkdvThreads), compacted in order
      const int e = c0 + tid;
      int sl = 0;
      bool keep = false;
      float wd[kMaxH], wa[kMaxH];
      if (e < e1) {
        sl = slots[e];
#pragma unroll
        for (int h = 0; h < kMaxH; ++h) {
          wd[h] = h < H ? s_dsc[(long long)sl * H + h] : 0.f;
          wa[h] = h < H ? s_a[(long long)sl * H + h] : 0.f;
          keep |= wd[h] != 0.f || wa[h] != 0.f;
        }
      }
      const unsigned bal = __ballot_sync(0xffffffffu, keep);
      __syncthreads();  // the last chunk's readers are done
      if (lane == 0) wcount[warp] = __popc(bal);
      __syncthreads();
      int at = __popc(bal & ((1u << lane) - 1)), n = 0;
      for (int w = 0; w < kDkdvThreads / 32; ++w) {
        if (w < warp) at += wcount[w];
        n += wcount[w];
      }
      if (keep) {
        sslot[at] = sl;
        ssrc[at] = F == ea::kDense ? pair_rows[sl] : sl / K;
#pragma unroll
        for (int h = 0; h < kMaxH; ++h) sdsc[at][h] = wd[h], sa[at][h] = wa[h];
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int c = tid + i * kDkdvThreads;
        if (c < HK) {
          const int h = c / KD, d = c - h * KD;
          float part = acc[i];
#pragma unroll 4
          for (int t = 0; t < n; ++t) {
            const float w = sdsc[t][h] * __ldg(s_wk + (long long)sslot[t] * KD + d);
            const float q = singa::ldg_f(qt + (long long)ssrc[t] * HK + c);
            part = kRound ? part + rnd<T>(w * q) : fmaf(w, q, part);
          }
          acc[i] = part;
        } else if (c < HK + HV) {
          const int cv = c - HK, h = cv / VD, d = cv - h * VD;
          float part = acc[i];
#pragma unroll 4
          for (int t = 0; t < n; ++t) {
            const float w = sa[t][h] * __ldg(s_wv + (long long)sslot[t] * VD + d);
            const float q = singa::ldg_f(g + (long long)ssrc[t] * HV + cv);
            part = kRound ? part + rnd<T>(w * q) : fmaf(w, q, part);
          }
          acc[i] = part;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = tid + i * kDkdvThreads;
      if (c < HK) {
        dk[j * HK + c] = singa::from_f<T>(acc[i]);
      } else if (c < HK + HV) {
        if constexpr (F == ea::kDense) acc[i] += gw[(j / dm.N) * HV + c - HK];
        dv[j * HV + c - HK] = singa::from_f<T>(acc[i]);
      }
    }
  }
}

// The CUDA-core instance: the same plan and the same exact rules, for every
// shape the tensor-core kernel does not take (other widths, H > 4, K > 128).
// One node at a time per block, its taken slots one tile: the EdgeMLPs and dh
// through block_gemm, the weight-gradient sums owned one per thread
// (ea::kAccPerThread a thread) across the block's nodes, all float32.
//
// VT: the storage type of qt, k, v, diag_value, g, dqt, dk, dv and d
// diag_value. The bfloat16 instance (K1b's and K7b's) is the function
// _attn_bwd_kernel computes at bfloat16 inputs: the forward recomputed as
// K1's bfloat16 instance rounds it; each g w_v v and g diag_value term
// rounded before its head sum (da); the softmax and dot in float32; the
// weights a rounded where they weigh (ddv, dw_v, dv), dsc rounded before it
// spreads; each dsc q k and a g v term rounded before the head sum of dw_k
// and dw_v, and those sums again; dh rounded; each slot's dk/dv term
// rounded before the sum over the slots that name a row (the dk/dv stage);
// every sum in float32, the outputs rounded once, d diag_scores and the
// weight gradients float32.
struct CcSmem {
  ea::Mlp w;
  float *wk2t, *wv2t, *one;
  float *A, *Pk, *Hk, *Wk, *Pv, *Hv, *Wv, *S, *D;  // pair buffers [T, *]
  float *q, *g;                                     // the node's rows
  float *sd, *dd, *m, *l, *dot, *ad;                // per head
  float *dist, *mask;                               // [K]
  int *idx, *pos, *ctl;                             // [K] row of k/v, slot p; [2]
};

long long cc_smem_floats(const ea::Dims& d) {
  const long long K = d.R, H = d.H, kd = d.kd, vd = d.vd;
  return d.mlp_floats() + kd * kd + vd * vd + 4 + K * (d.De + 3 * kd + 3 * vd + 2 * H) +
         H * (kd + vd) + 6 * H + 4 * K + 2;
}

template <int F, class VT = float>
__global__ void __launch_bounds__(kThreads)
list_bwd_cc_kernel(ea::ArgsT<VT> a, ea::Dims d, ea::GradsT<VT> o, const int* __restrict__ plan,
                   int* __restrict__ stats) {
  using singa::rnd;
  using singa::to_f;
  const int H = d.H, kd = d.kd, vd = d.vd, De = d.De, K = d.R, HK = H * kd, HV = H * vd;
  extern __shared__ __align__(16) float smem[];
  CcSmem sm;
  sm.wk2t = ea::load_mlp(a, d, smem, sm.w);  // [kd(b), kd(a)] = wk2[a, b]
  sm.wv2t = sm.wk2t + kd * kd;
  sm.one = sm.wv2t + vd * vd;  // [4], one[0] = 1
  sm.A = sm.one + 4;
  sm.Pk = sm.A + K * De;   sm.Hk = sm.Pk + K * kd;  sm.Wk = sm.Hk + K * kd;
  sm.Pv = sm.Wk + K * kd;  sm.Hv = sm.Pv + K * vd;  sm.Wv = sm.Hv + K * vd;
  sm.S = sm.Wv + K * vd;   sm.D = sm.S + K * H;
  sm.q = sm.D + K * H;     sm.g = sm.q + HK;
  sm.sd = sm.g + HV;       sm.dd = sm.sd + H;       sm.m = sm.dd + H;
  sm.l = sm.m + H;         sm.dot = sm.l + H;       sm.ad = sm.dot + H;
  sm.dist = sm.ad + H;     sm.mask = sm.dist + K;
  sm.idx = reinterpret_cast<int*>(sm.mask + K);
  sm.pos = sm.idx + K;     sm.ctl = sm.pos + K;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int t = tid; t < kd * kd; t += kThreads) sm.wk2t[(t % kd) * kd + t / kd] = rnd<VT>(a.wk2[t]);
  for (int t = tid; t < vd * vd; t += kThreads) sm.wv2t[(t % vd) * vd + t / vd] = rnd<VT>(a.wv2[t]);
  if (tid == 0) sm.one[0] = 1.f;

  const int P = d.grad_floats();
  float acc[ea::kAccPerThread];
#pragma unroll
  for (int r = 0; r < ea::kAccPerThread; ++r) acc[r] = 0.f;
  int walked[kStats] = {};  // thread 0's counts, for stats

  const float scale = 1.f / sqrtf((float)kd);
  const long long rows = (long long)d.B * d.N;
  for (long long node = blockIdx.x; node < rows; node += gridDim.x) {
    const long long first = node * K, base = node / d.N * d.N;
    __syncthreads();  // the previous node's readers are done
    if ((plan[node] & 3) == kZero) {  // a zero cotangent: zero outputs, its slots send nothing
      for (int c = tid; c < HK; c += kThreads) o.dqt[node * HK + c] = singa::from_f<VT>(0.f);
      for (int c = tid; c < HV; c += kThreads) o.ddv[node * HV + c] = singa::from_f<VT>(0.f);
      for (int h = tid; h < H; h += kThreads) o.dds[node * H + h] = 0.f;
      for (int t = tid; t < K * H; t += kThreads) o.s_a[first * H + t] = o.s_dsc[first * H + t] = 0.f;
      if (tid == 0) ++walked[kStatZero];
      continue;
    }
    for (int t = tid; t < HK; t += kThreads) sm.q[t] = to_f(a.qt[node * HK + t]);
    for (int t = tid; t < HV; t += kThreads) sm.g[t] = to_f(o.g[node * HV + t]);
    for (int h = tid; h < H; h += kThreads) sm.sd[h] = a.ds[node * H + h];
    __syncthreads();
    for (int h = warp; h < H; h += kWarps) {  // da_self
      float part = 0.f;
      for (int c = lane; c < vd; c += 32)
        part += rnd<VT>(sm.g[h * vd + c] * to_f(a.dval[node * HV + h * vd + c]));
      part = singa::warp_sum(part);
      if (lane == 0) sm.dd[h] = part;
    }
    // the taken slots: the live ones in slot order; all K when the row's max
    // leaves its dead slots a weight in some head (the node is taken again)
    bool whole = false;
    int T;
    for (;;) {
      if (warp == 0) {
        int n = 0;
        for (int p0 = 0; p0 < K; p0 += 32) {
          const int p = p0 + lane;
          const bool take = p < K && (whole || a.nmask[first + p] != 0);
          const unsigned bal = __ballot_sync(0xffffffffu, take);
          if (take) sm.pos[n + __popc(bal & ((1u << lane) - 1))] = p;
          n += __popc(bal);
        }
        if (lane == 0) sm.ctl[0] = n;
      }
      __syncthreads();
      T = sm.ctl[0];
      for (int t = tid; t < T; t += kThreads) {
        const int p = sm.pos[t];
        sm.dist[t] = a.dist[first + p];
        sm.mask[t] = a.nmask[first + p] != 0 ? 1.f : 0.f;
        sm.idx[t] = F == ea::kList ? (int)(base + a.nbr[first + p]) : (int)(first + p);
      }
      __syncthreads();
      for (int t = tid; t < T * De; t += kThreads) {
        const float diff = sm.dist[t / De] - sm.w.cent[t % De];
        sm.A[t] = rnd<VT>(-expf(a.coeff * diff * diff));
      }
      __syncthreads();
      singa::block_gemm(sm.A, T, De, sm.w.wk1, sm.w.bk1, kd, sm.Pk, singa::kEpiNone);
      singa::block_gemm(sm.A, T, De, sm.w.wv1, sm.w.bv1, vd, sm.Pv, singa::kEpiNone);
      __syncthreads();
      for (int t = tid; t < T * kd; t += kThreads) sm.Hk[t] = rnd<VT>(singa::sspf_(sm.Pk[t]));
      for (int t = tid; t < T * vd; t += kThreads) sm.Hv[t] = rnd<VT>(singa::sspf_(sm.Pv[t]));
      __syncthreads();
      singa::block_gemm(sm.Hk, T, kd, sm.w.wk2, sm.w.bk2, kd, sm.Wk, singa::kEpiNone);
      singa::block_gemm(sm.Hv, T, vd, sm.w.wv2, sm.w.bv2, vd, sm.Wv, singa::kEpiNone);
      __syncthreads();
      if constexpr (singa::kBf16<VT>) {  // w_k and w_v, rounded
        for (int t = tid; t < T * kd; t += kThreads) sm.Wk[t] = rnd<VT>(sm.Wk[t]);
        for (int t = tid; t < T * vd; t += kThreads) sm.Wv[t] = rnd<VT>(sm.Wv[t]);
        __syncthreads();
      }
      // the scores (idx holds each slot's row of k), and da per (slot, head)
      ea::tile_scores<ea::kList>(a, d, 0, 0, 0, T, sm.idx, sm.mask, sm.q, sm.Wk, sm.S);
      for (int job = tid; job < T * H; job += kThreads) {
        const int p = job / H, h = job % H;
        const VT* vrow = a.v + (long long)sm.idx[p] * HV + h * vd;
        float part = 0.f;
        if constexpr (singa::kBf16<VT>) {
          for (int c = 0; c < vd; ++c)
            part += rnd<VT>(sm.g[h * vd + c] * sm.Wv[p * vd + c] * singa::ldg_f(vrow + c));
        } else {
          for (int c = 0; c < vd; ++c)
            part = fmaf(sm.g[h * vd + c] * sm.Wv[p * vd + c], singa::ldg_f(vrow + c), part);
        }
        sm.D[job] = part;
      }
      for (int h = tid; h < H; h += kThreads) {  // the run starts at the self slot
        sm.m[h] = sm.sd[h];
        sm.l[h] = 1.f;
        sm.dot[h] = sm.dd[h];
      }
      __syncthreads();
      ea::online_softmax(sm.S, sm.D, T, H, sm.m, sm.l, sm.dot, nullptr);
      __syncthreads();
      if (whole) break;
      if (tid == 0) {
        int redo = 0;
        for (int h = 0; h < H; ++h) redo |= expf(-ea::kBig - sm.m[h]) != 0.f;
        sm.ctl[1] = redo;
        walked[kStatSlots] += T;
      }
      __syncthreads();
      if (!sm.ctl[1]) break;
      whole = true;
    }
    if (tid == 0) {
      ++walked[whole ? kStatWhole : kStatLive];
      if (whole) walked[kStatSlots] += T;
    }
    for (int h = tid; h < H; h += kThreads) {
      const float ad = expf(sm.sd[h] - sm.m[h]) / sm.l[h], dot = sm.dot[h] / sm.l[h];
      sm.ad[h] = ad;
      sm.dot[h] = dot;
      o.dds[node * H + h] = ad * (sm.dd[h] - dot);
    }
    __syncthreads();
    for (int c = tid; c < HV; c += kThreads)
      o.ddv[node * HV + c] = singa::from_f<VT>(rnd<VT>(sm.ad[c / vd]) * sm.g[c]);
    // softmax weights and dsc, one thread per (slot, head); at bfloat16 both
    // rounded (dsc from the unrounded weight)
    for (int job = tid; job < T * H; job += kThreads) {
      const int p = job / H, h = job % H;
      const float aw = expf(sm.S[job] - sm.m[h]) / sm.l[h];
      const float dsc = sm.mask[p] != 0.f ? aw * (sm.D[job] - sm.dot[h]) * scale : 0.f;
      sm.S[job] = rnd<VT>(aw);
      sm.D[job] = rnd<VT>(dsc);
    }
    __syncthreads();
    // what the dk/dv stage reads per taken slot (a dead slot not taken: a =
    // dsc = 0), and dqt
    for (int t = tid; t < T * kd; t += kThreads)
      o.s_wk[(first + sm.pos[t / kd]) * kd + t % kd] = sm.Wk[t];
    for (int t = tid; t < T * vd; t += kThreads)
      o.s_wv[(first + sm.pos[t / vd]) * vd + t % vd] = sm.Wv[t];
    for (int t = tid; t < T * H; t += kThreads) {
      const long long slot = first + sm.pos[t / H];
      o.s_a[slot * H + t % H] = sm.S[t];
      o.s_dsc[slot * H + t % H] = sm.D[t];
    }
    if (!whole)
      for (int t = tid; t < K * H; t += kThreads)
        if (a.nmask[first + t / H] == 0) o.s_a[first * H + t] = o.s_dsc[first * H + t] = 0.f;
    for (int c = tid; c < HK; c += kThreads) {
      const int h = c / kd, dc = c % kd;
      float part = 0.f;
      for (int p = 0; p < T; ++p)
        part = fmaf(sm.D[p * H + h] * sm.Wk[p * kd + dc], singa::ldg_f(a.k + (long long)sm.idx[p] * HK + c), part);
      o.dqt[node * HK + c] = singa::from_f<VT>(part);
    }
    __syncthreads();
    // dw_k into Wk and dw_v into Wv, one thread per (slot, channel)
    for (int t = tid; t < T * kd; t += kThreads) {
      const int p = t / kd, dc = t % kd;
      const VT* krow = a.k + (long long)sm.idx[p] * HK + dc;
      float part = 0.f;
      if constexpr (singa::kBf16<VT>) {
        for (int h = 0; h < H; ++h)
          part += rnd<VT>(sm.D[p * H + h] * sm.q[h * kd + dc] * singa::ldg_f(krow + h * kd));
      } else {
        for (int h = 0; h < H; ++h) part = fmaf(sm.D[p * H + h] * sm.q[h * kd + dc], singa::ldg_f(krow + h * kd), part);
      }
      sm.Wk[t] = rnd<VT>(part);
    }
    for (int t = tid; t < T * vd; t += kThreads) {
      const int p = t / vd, dc = t % vd;
      const VT* vrow = a.v + (long long)sm.idx[p] * HV + dc;
      float part = 0.f;
      if constexpr (singa::kBf16<VT>) {
        for (int h = 0; h < H; ++h)
          part += rnd<VT>(sm.S[p * H + h] * sm.g[h * vd + dc] * singa::ldg_f(vrow + h * vd));
      } else {
        for (int h = 0; h < H; ++h) part = fmaf(sm.S[p * H + h] * sm.g[h * vd + dc], singa::ldg_f(vrow + h * vd), part);
      }
      sm.Wv[t] = rnd<VT>(part);
    }
    __syncthreads();
    // dh = (dw W2^T) * sigmoid(pre), in place of the pre-activations
    singa::block_gemm(sm.Wk, T, kd, sm.wk2t, nullptr, kd, sm.Pk, singa::kEpiTimesSigmoid);
    singa::block_gemm(sm.Wv, T, vd, sm.wv2t, nullptr, vd, sm.Pv, singa::kEpiTimesSigmoid);
    __syncthreads();
    if constexpr (singa::kBf16<VT>) {  // dh, rounded
      for (int t = tid; t < T * kd; t += kThreads) sm.Pk[t] = rnd<VT>(sm.Pk[t]);
      for (int t = tid; t < T * vd; t += kThreads) sm.Pv[t] = rnd<VT>(sm.Pv[t]);
      __syncthreads();
    }
    // weight-gradient sums over the node's taken slots; sum t belongs to
    // thread t % kThreads, register t / kThreads
#pragma unroll
    for (int r = 0; r < ea::kAccPerThread; ++r) {
      int t = tid + r * kThreads;
      if (t < P) {
        const float* x;  // column of the left operand [T, sx] (sx = 0: ones)
        const float* y;  // column of the right operand [T, sy]
        int sx, sy;
        if (t < De * kd) {                         // dwk1 = e^T dhk
          x = sm.A + t / kd; sx = De; y = sm.Pk + t % kd; sy = kd;
        } else if ((t -= De * kd) < kd) {          // dbk1
          x = sm.one; sx = 0; y = sm.Pk + t; sy = kd;
        } else if ((t -= kd) < kd * kd) {          // dwk2 = hk^T dw_k
          x = sm.Hk + t / kd; sx = kd; y = sm.Wk + t % kd; sy = kd;
        } else if ((t -= kd * kd) < kd) {          // dbk2
          x = sm.one; sx = 0; y = sm.Wk + t; sy = kd;
        } else if ((t -= kd) < De * vd) {          // dwv1 = e^T dhv
          x = sm.A + t / vd; sx = De; y = sm.Pv + t % vd; sy = vd;
        } else if ((t -= De * vd) < vd) {          // dbv1
          x = sm.one; sx = 0; y = sm.Pv + t; sy = vd;
        } else if ((t -= vd) < vd * vd) {          // dwv2 = hv^T dw_v
          x = sm.Hv + t / vd; sx = vd; y = sm.Wv + t % vd; sy = vd;
        } else {                                   // dbv2
          t -= vd * vd;
          x = sm.one; sx = 0; y = sm.Wv + t; sy = vd;
        }
        float v = acc[r];
        for (int p = 0; p < T; ++p) v = fmaf(x[p * sx], y[p * sy], v);
        acc[r] = v;
      }
    }
  }

  if (stats && tid == 0)
    for (int i = 0; i < kStats; ++i) atomicAdd(stats + i, walked[i]);
  float* row = o.partial + (long long)blockIdx.x * P;
#pragma unroll
  for (int r = 0; r < ea::kAccPerThread; ++r) {
    const int t = tid + r * kThreads;
    if (t < P) row[t] = acc[r];
  }
}

// The CUDA-core instance's dk/dv stage: as list_dkdv_kernel, at any widths,
// one thread per channel; a (slot, head) whose weight is zero (every slot
// not taken) is passed over before its w_k or w_v is read.
// At bfloat16 (T) each slot's term is rounded before the sum, as the TPU
// kernel rounds dk_nb and dv_nb before its one-hot transpose.
template <class T = float>
__global__ void __launch_bounds__(kDkdvThreads)
list_dkdv_cc_kernel(const T* __restrict__ qt, const T* __restrict__ g,
                    const float* __restrict__ s_wk, const float* __restrict__ s_wv,
                    const float* __restrict__ s_a, const float* __restrict__ s_dsc,
                    const int* __restrict__ offsets, const int* __restrict__ slots,
                    T* __restrict__ dk, T* __restrict__ dv, ea::Dims dm) {
  const int H = dm.H, kd = dm.kd, vd = dm.vd, K = dm.R, HK = H * kd, HV = H * vd;
  const long long rows = (long long)dm.B * dm.N;
  for (long long j = blockIdx.x; j < rows; j += gridDim.x) {
    const int e0 = offsets[j], e1 = offsets[j + 1];
    for (int c = threadIdx.x; c < HK + HV; c += blockDim.x) {
      const bool onk = c < HK;
      const int cc = onk ? c : c - HK, w = onk ? kd : vd, h = cc / w, dc = cc - h * w;
      const float* wt = onk ? s_dsc : s_a;
      const float* rows_w = onk ? s_wk : s_wv;
      const T* src = onk ? qt : g;
      const int width = onk ? HK : HV;
      float acc = 0.f;
      for (int e = e0; e < e1; ++e) {
        const long long sl = slots[e];
        const float x = wt[sl * H + h];
        if (x != 0.f) {
          if constexpr (singa::kBf16<T>)
            acc += singa::rnd<T>(x * rows_w[sl * w + dc] * singa::ldg_f(src + (sl / K) * width + cc));
          else
            acc = fmaf(x * rows_w[sl * w + dc], singa::ldg_f(src + (sl / K) * width + cc), acc);
        }
      }
      if (onk) dk[j * HK + cc] = singa::from_f<T>(acc);
      else dv[j * HV + cc] = singa::from_f<T>(acc);
    }
  }
}

// The CUDA-core instance's: weight gradients within the sums its threads
// keep (its pair buffers within shared memory: allow_smem)
bool cc_ok(const ea::Dims& d) { return d.grad_floats() <= ea::kAccPerThread * kThreads; }

// Which instance runs: the tensor-core kernel where it takes the shapes,
// else the CUDA-core one (cuda_cores: the CUDA-core one at any shape); 0
// tensor cores, 1 CUDA cores, -1 neither. Its dynamic shared memory in *smem.
int instance(const ea::Dims& d, int cuda_cores, size_t* smem) {
  if (!d.ok() || (long long)d.B * d.N * d.R >= (1LL << 31)) return -1;
  if (!cuda_cores && tc_ok(d)) {
    *smem = kSmemBytes;
    return 0;
  }
  *smem = (size_t)cc_smem_floats(d) * sizeof(float);
  return cc_ok(d) ? 1 : -1;
}

template <int F, class T>
int blocks_of(const ea::Dims& d, int cuda_cores) {
  size_t smem = 0;
  const int inst = instance(d, cuda_cores, &smem);
  const long long rows = (long long)d.B * d.N;
  if (inst == 0) {
    if (singa::allow_smem(list_bwd_pair_kernel<F, T>, smem) != cudaSuccess) return -1;
    return singa::persistent_grid(list_bwd_pair_kernel<F, T>, kThreads, smem, rows);
  }
  if (inst == 1) {
    if (singa::allow_smem(list_bwd_cc_kernel<F, T>, smem) != cudaSuccess) return -1;
    return singa::persistent_grid(list_bwd_cc_kernel<F, T>, kThreads, smem, rows);
  }
  return -1;
}

// The plan, the pair kernel and its dk/dv stage (the tensor-core ones where
// they take the shapes, else the CUDA-core ones), and the sum of the blocks'
// weight-gradient rows; T the storage type of qt, k, v, diag_value, g and
// the outputs but d diag_scores and the weight gradients
template <int F, class T>
int launch(const ea::ArgsT<T>& a, const ea::Dims& dm, const T* g, const int* offsets,
           const int* slots, T* dqt, T* dk, T* dv, float* dds, T* ddv, float* s_wk, float* s_wv,
           float* s_a, float* s_dsc, int* plan, float* partial, float* grads, int blocks,
           int cuda_cores, int* stats, void* stream) {
  size_t smem = 0;
  const int inst = instance(dm, cuda_cores, &smem);
  const uintptr_t rows16 = reinterpret_cast<uintptr_t>(a.qt) | reinterpret_cast<uintptr_t>(a.k) |
                           reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(g);
  if (inst < 0 || blocks < 1 || (inst == 0 && (rows16 & 15) != 0)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = inst == 0 ? singa::allow_smem(list_bwd_pair_kernel<F, T>, smem)
                              : singa::allow_smem(list_bwd_cc_kernel<F, T>, smem);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)dm.B * dm.N;
  const int plan_grid = singa::persistent_grid(list_plan_kernel<T>, kPlanThreads, 0,
                                               (rows + kPlanThreads / 32 - 1) / (kPlanThreads / 32));
  list_plan_kernel<T><<<plan_grid, kPlanThreads, 0, st>>>(g, a.nmask, plan, rows, dm.R, dm.H * dm.vd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const ea::GradsT<T> o{g, dqt, dds, ddv, s_wk, s_wv, s_a, s_dsc, partial, nullptr};
  if (inst == 0) {
    list_bwd_pair_kernel<F, T><<<blocks, kThreads, smem, st>>>(a, dm, o, plan, stats);
  } else {
    list_bwd_cc_kernel<F, T><<<blocks, kThreads, smem, st>>>(a, dm, o, plan, stats);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (inst == 0) {
    const int grid = singa::persistent_grid(list_dkdv_kernel<F, T>, kDkdvThreads, 0, rows);
    list_dkdv_kernel<F, T><<<grid, kDkdvThreads, 0, st>>>(a.qt, g, s_wk, s_wv, s_a, s_dsc,
                                                          offsets, slots, dk, dv, dm);
  } else {
    const int grid = singa::persistent_grid(list_dkdv_cc_kernel<T>, kDkdvThreads, 0, rows);
    list_dkdv_cc_kernel<T><<<grid, kDkdvThreads, 0, st>>>(a.qt, g, s_wk, s_wv, s_a, s_dsc,
                                                          offsets, slots, dk, dv, dm);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int P = dm.grad_floats();
  singa::sum_rows_kernel<<<(P + 255) / 256, 256, 0, st>>>(partial, grads, P, blocks);
  return (int)cudaGetLastError();
}

template <int F, class T>
int residency(int* smem_bytes, int* threads) {
  *smem_bytes = (int)kSmemBytes;
  *threads = kThreads;
  if (singa::allow_smem(list_bwd_pair_kernel<F, T>, kSmemBytes) != cudaSuccess) return -1;
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, list_bwd_pair_kernel<F, T>, kThreads,
                                                    kSmemBytes) != cudaSuccess)
    return -1;
  return per_sm;
}

// K8b·bf16's tensor-core instance takes the encoder's widths (kd 32, vd
// 64, De 64, H <= 4) and lists whose rows have at most kTM live columns
// each (max_live: the largest live count, which live_columns records when
// it builds them), so that every live row sits whole in one tile.
bool dense_tc_ok(const ea::Dims& d, int max_live) {
  return d.ok() && d.R == d.N && d.kd == KD && d.vd == VD && d.De == DE && d.H <= kMaxH &&
         max_live >= 0 && max_live <= kTM;
}

// K8b·bf16's pair kernel: the dense form at bfloat16
using DensePair = void (*)(ea::ArgsT<singa::bf16>, ea::Dims, ea::GradsT<singa::bf16>, const int*,
                           int*);
const DensePair kDensePair = list_bwd_pair_kernel<ea::kDense, singa::bf16>;

int dense_blocks(const ea::Dims& d, int max_live) {
  if (!dense_tc_ok(d, max_live)) return -1;
  if (singa::allow_smem(kDensePair, kDenseSmemBytes) != cudaSuccess) return -1;
  return singa::persistent_grid(kDensePair, kThreads, kDenseSmemBytes, (long long)d.B * d.N);
}

}  // namespace

// Blocks of the pair kernel that runs at these shapes (the tensor-core one
// where it takes them, else the CUDA-core one; cuda_cores != 0: the
// CUDA-core one); the caller sizes the [blocks, P] scratch buffer from it
// and passes the same cuda_cores to the launch. Returns -1 for shapes
// neither takes.
extern "C" int neighbor_attn_bwd_blocks(int B, int N, int K, int H, int kd, int vd, int De,
                                        int cuda_cores) {
  return blocks_of<ea::kList, float>(ea::Dims{B, N, K, H, kd, vd, De}, cuda_cores);
}

extern "C" int neighbor_attn_hybrid_bwd_blocks(int B, int N, int K, int H, int kd, int vd, int De,
                                               int cuda_cores) {
  return blocks_of<ea::kGathered, float>(ea::Dims{B, N, K, H, kd, vd, De}, cuda_cores);
}

// The tensor-core pair kernel of K1b (hybrid 0) or K7b (1), at bfloat16
// storage when bf16 != 0: resident blocks per SM (-1: refused), and its
// threads and dynamic shared memory per block.
extern "C" int neighbor_attn_bwd_residency(int hybrid, int bf16, int* smem_bytes, int* threads) {
  if (bf16)
    return hybrid ? residency<ea::kGathered, singa::bf16>(smem_bytes, threads)
                  : residency<ea::kList, singa::bf16>(smem_bytes, threads);
  return hybrid ? residency<ea::kGathered, float>(smem_bytes, threads)
                : residency<ea::kList, float>(smem_bytes, threads);
}

// offsets [B*N + 1] and slots [B*N*K]: the CSR transpose of nbr (flat slot
// ids grouped by destination row, ascending within a row). Scratch: s_wk
// [B*N*K, kd], s_wv [B*N*K, vd], s_a and s_dsc [B*N*K, H], plan [B*N]
// (int), partial [blocks, P]. grads [P]: dwk1 dbk1 dwk2 dbk2 dwv1 dbv1 dwv2
// dbv2, flat. stats: null, or int [4] zeros that the launch adds what it
// walked to (rows skipped, rows taken live, rows taken whole, slots).
extern "C" int neighbor_attn_bwd_f32(
    const float* qt, const float* k, const float* v, const int* nbr, const unsigned char* nmask,
    const float* dist, const float* ds, const float* dval, const float* centers,
    const float* wk1, const float* bk1, const float* wk2, const float* bk2, const float* wv1,
    const float* bv1, const float* wv2, const float* bv2, float coeff, const float* g,
    const int* offsets, const int* slots, float* dqt, float* dk, float* dv, float* dds,
    float* ddv, float* s_wk, float* s_wv, float* s_a, float* s_dsc, int* plan, float* partial,
    float* grads, int B, int N, int K, int H, int kd, int vd, int De, int blocks,
    int cuda_cores, int* stats, void* stream) {
  const ea::Args a{qt, k, v, nbr, nmask, dist, ds, dval, centers,
                   wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2, coeff};
  return launch<ea::kList, float>(a, ea::Dims{B, N, K, H, kd, vd, De}, g, offsets, slots, dqt, dk, dv,
                           dds, ddv, s_wk, s_wv, s_a, s_dsc, plan, partial, grads, blocks,
                           cuda_cores, stats, stream);
}

// K7b: as K1b with k_nb [B*N, K, H*kd] and v_nb [B*N, K, H*vd] in place of k
// and v; nbr enters only through its transpose (offsets, slots).
extern "C" int neighbor_attn_hybrid_bwd_f32(
    const float* qt, const float* k_nb, const float* v_nb, const unsigned char* nmask,
    const float* dist, const float* ds, const float* dval, const float* centers,
    const float* wk1, const float* bk1, const float* wk2, const float* bk2, const float* wv1,
    const float* bv1, const float* wv2, const float* bv2, float coeff, const float* g,
    const int* offsets, const int* slots, float* dqt, float* dk, float* dv, float* dds,
    float* ddv, float* s_wk, float* s_wv, float* s_a, float* s_dsc, int* plan, float* partial,
    float* grads, int B, int N, int K, int H, int kd, int vd, int De, int blocks,
    int cuda_cores, int* stats, void* stream) {
  const ea::Args a{qt, k_nb, v_nb, nullptr, nmask, dist, ds, dval, centers,
                   wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2, coeff};
  return launch<ea::kGathered, float>(a, ea::Dims{B, N, K, H, kd, vd, De}, g, offsets, slots, dqt, dk,
                               dv, dds, ddv, s_wk, s_wv, s_a, s_dsc, plan, partial, grads, blocks,
                               cuda_cores, stats, stream);
}

// Blocks of K1b's bfloat16 pair kernel at these shapes (the tensor-core one
// where it takes them, else the CUDA-core one; cuda_cores != 0: the
// CUDA-core one), as neighbor_attn_bwd_blocks; -1 for shapes neither takes.
extern "C" int neighbor_attn_bwd_bf16_blocks(int B, int N, int K, int H, int kd, int vd, int De,
                                             int cuda_cores) {
  return blocks_of<ea::kList, singa::bf16>(ea::Dims{B, N, K, H, kd, vd, De}, cuda_cores);
}

// K1b's bfloat16 instance: qt, k, v, diag_value, g, dqt, dk, dv and ddv
// bfloat16; the rest, the scratch, grads, cuda_cores and stats as
// neighbor_attn_bwd_f32's.
extern "C" int neighbor_attn_bwd_bf16(
    const void* qt, const void* k, const void* v, const int* nbr, const unsigned char* nmask,
    const float* dist, const float* ds, const void* dval, const float* centers,
    const float* wk1, const float* bk1, const float* wk2, const float* bk2, const float* wv1,
    const float* bv1, const float* wv2, const float* bv2, float coeff, const void* g,
    const int* offsets, const int* slots, void* dqt, void* dk, void* dv, float* dds,
    void* ddv, float* s_wk, float* s_wv, float* s_a, float* s_dsc, int* plan, float* partial,
    float* grads, int B, int N, int K, int H, int kd, int vd, int De, int blocks, int cuda_cores,
    int* stats, void* stream) {
  using singa::bf16;
  const ea::ArgsT<bf16> a{(const bf16*)qt, (const bf16*)k, (const bf16*)v, nbr, nmask, dist, ds,
                          (const bf16*)dval, centers, wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2,
                          coeff};
  return launch<ea::kList, bf16>(a, ea::Dims{B, N, K, H, kd, vd, De}, (const bf16*)g, offsets,
                                 slots, (bf16*)dqt, (bf16*)dk, (bf16*)dv, dds, (bf16*)ddv, s_wk,
                                 s_wv, s_a, s_dsc, plan, partial, grads, blocks, cuda_cores, stats,
                                 stream);
}

// Blocks of K7b's bfloat16 pair kernel at these shapes, as
// neighbor_attn_bwd_bf16_blocks's.
extern "C" int neighbor_attn_hybrid_bwd_bf16_blocks(int B, int N, int K, int H, int kd, int vd,
                                                    int De, int cuda_cores) {
  return blocks_of<ea::kGathered, singa::bf16>(ea::Dims{B, N, K, H, kd, vd, De}, cuda_cores);
}

// K7b's bfloat16 instance: as K1b's with k_nb [B*N, K, H*kd] and v_nb
// [B*N, K, H*vd] (bfloat16) in place of k and v, and no nbr. Each slot's
// dk and dv terms are rounded, then summed over the CSR transpose in float32
// and rounded once, as the TPU kernel's one-hot transpose of the rounded
// dk_nb, dv_nb accumulates in float32 and casts once.
extern "C" int neighbor_attn_hybrid_bwd_bf16(
    const void* qt, const void* k_nb, const void* v_nb, const unsigned char* nmask,
    const float* dist, const float* ds, const void* dval, const float* centers,
    const float* wk1, const float* bk1, const float* wk2, const float* bk2, const float* wv1,
    const float* bv1, const float* wv2, const float* bv2, float coeff, const void* g,
    const int* offsets, const int* slots, void* dqt, void* dk, void* dv, float* dds,
    void* ddv, float* s_wk, float* s_wv, float* s_a, float* s_dsc, int* plan, float* partial,
    float* grads, int B, int N, int K, int H, int kd, int vd, int De, int blocks, int cuda_cores,
    int* stats, void* stream) {
  using singa::bf16;
  const ea::ArgsT<bf16> a{(const bf16*)qt, (const bf16*)k_nb, (const bf16*)v_nb, nullptr, nmask,
                          dist, ds, (const bf16*)dval, centers, wk1, bk1, wk2, bk2, wv1, bv1,
                          wv2, bv2, coeff};
  return launch<ea::kGathered, bf16>(a, ea::Dims{B, N, K, H, kd, vd, De}, (const bf16*)g,
                                     offsets, slots, (bf16*)dqt, (bf16*)dk, (bf16*)dv, dds,
                                     (bf16*)ddv, s_wk, s_wv, s_a, s_dsc, plan, partial, grads,
                                     blocks, cuda_cores, stats, stream);
}

// K8b·bf16's tensor-core instance (the dense form of the kernels above at
// bfloat16 storage): blocks of its pair kernel at these shapes, or -1 for
// shapes it does not take (widths, or a row of more than 128 live columns:
// max_live); the caller sizes the [blocks + 1, P] scratch buffer from it.
extern "C" int dense_edge_attn_bwd_tc_blocks(int B, int N, int H, int kd, int vd, int De,
                                             int max_live) {
  return dense_blocks(ea::Dims{B, N, N, H, kd, vd, De}, max_live);
}

// Its pair kernel: resident blocks per SM (-1: refused), its threads and
// dynamic shared memory per block.
extern "C" int dense_edge_attn_bwd_tc_residency(int* smem_bytes, int* threads) {
  *smem_bytes = (int)kDenseSmemBytes;
  *threads = kThreads;
  if (singa::allow_smem(kDensePair, kDenseSmemBytes) != cudaSuccess) return -1;
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kDensePair, kThreads,
                                                    kDenseSmemBytes) != cudaSuccess)
    return -1;
  return per_sm;
}

// K8b·bf16 on the tensor cores: the arguments of csrc/dense_edge_attn_bwd.cu's
// dense_edge_attn_bwd_bf16 (qt, k, v, dval, g, dqt, dk, dv and ddv bfloat16;
// adj [B*N, N]; the live lists lrow, lcol, pair_rows and their transpose
// col_off, col_pairs; the scratch), and plan [B*N] (int), max_live (the
// lists' largest live count) and stats (null, or int [5] zeros: rows
// skipped, rows live, (row, head) pairs whose max would leave a dead column
// a weight, live pairs evaluated, rows in closed form). Runs, in order:
// v's column sums per graph (vsum), the plan and the pair kernel, the
// closed-form rows' a_dead-weighted cotangent sums (G), their share of the
// weight gradients (padded_wgrad_kernel, the last row of partial; G
// becomes gw = w_v0 G), the dk/dv gather over the transpose adding gw to
// dv, and the sum of partial's rows. cudaErrorInvalidValue for shapes it
// does not take (dense_tc_ok).
extern "C" int dense_edge_attn_bwd_tc(
    const void* qt, const void* k, const void* v, const float* adj, const float* ds,
    const void* dval, const float* centers, const float* wk1, const float* bk1,
    const float* wk2, const float* bk2, const float* wv1, const float* bv1, const float* wv2,
    const float* bv2, float coeff, const void* g, const int* lrow, const int* lcol,
    const int* pair_rows, const int* col_off, const int* col_pairs, void* dqt, void* dk,
    void* dv, float* dds, void* ddv, float* s_wk, float* s_wv, float* s_a, float* s_dsc,
    float* s_ad, float* vsum, float* gsum, int* plan, float* partial, float* grads, int B,
    int N, int H, int kd, int vd, int De, int max_live, int blocks, int* stats, void* stream) {
  using singa::bf16;
  const ea::Dims dm{B, N, N, H, kd, vd, De};
  const ea::ArgsT<bf16> a{(const bf16*)qt, (const bf16*)k, (const bf16*)v, nullptr, nullptr,
                          adj, ds, (const bf16*)dval, centers, wk1, bk1, wk2, bk2, wv1, bv1,
                          wv2, bv2, coeff, lrow, lcol, nullptr, vsum};
  const uintptr_t rows16 = reinterpret_cast<uintptr_t>(qt) | reinterpret_cast<uintptr_t>(k) |
                           reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(g);
  if (!dense_tc_ok(dm, max_live) || blocks < 1 || (rows16 & 15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = singa::allow_smem(kDensePair, kDenseSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int HV = H * vd, P = dm.grad_floats();
  const long long rows = (long long)B * N;
  err = launch_colsum_split(a.v, nullptr, vsum, B, N, HV, vd, st);
  if (err != cudaSuccess) return (int)err;
  const long long plan_warps = (rows + kPlanThreads / 32 - 1) / (kPlanThreads / 32);
  const int plan_grid = singa::persistent_grid(dense_plan_kernel<bf16>, kPlanThreads, 0, plan_warps);
  dense_plan_kernel<bf16><<<plan_grid, kPlanThreads, 0, st>>>((const bf16*)g, lrow, plan, rows,
                                                                HV);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const ea::GradsT<bf16> o{(const bf16*)g, (bf16*)dqt, dds, (bf16*)ddv, s_wk, s_wv,
                           s_a, s_dsc, partial, s_ad};
  kDensePair<<<blocks, kThreads, kDenseSmemBytes, st>>>(a, dm, o, plan, stats);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = launch_colsum_split((const bf16*)g, s_ad, gsum, B, N, HV, vd, st);
  if (err != cudaSuccess) return (int)err;
  padded_wgrad_kernel<bf16><<<1, kPadThreads, 2 * vd * sizeof(float), st>>>(
      bv1, wv2, bv2, vsum, gsum, partial + (long long)blocks * P, dm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int grid =
      singa::persistent_grid(list_dkdv_kernel<ea::kDense, bf16>, kDkdvThreads, 0, rows);
  list_dkdv_kernel<ea::kDense, bf16><<<grid, kDkdvThreads, 0, st>>>(
      (const bf16*)qt, (const bf16*)g, s_wk, s_wv, s_a, s_dsc, col_off, col_pairs, (bf16*)dk,
      (bf16*)dv, dm, pair_rows, gsum);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  singa::sum_rows_kernel<<<(P + 255) / 256, 256, 0, st>>>(partial, grads, P, blocks + 1);
  return (int)cudaGetLastError();
}
