// The kNN encoder's graph attention in its three forms: one tiled forward
// kernel, a template over the form, and the dense form's backward (its pair
// kernel and its dk/dv stage); the list forms' backward is
// csrc/neighbor_attn_bwd.cu. The list forms run this forward only at widths
// their tensor-core kernel (csrc/neighbor_attn.cu) does not take, as their
// CUDA-core instance.
//
// K1 (neighbour lists), K7 (the lists' rows gathered before the launch) and
// K8 (every column of the untruncated adjacency) compute one function. Per
// node i (row b*N + i) and each of its R slots p (its K list slots, or the N
// columns of its graph):
//   e[p, :]  = -exp(coeff * (dist[p] - centers)^2)              RBF smear
//   w_k[p]   = ssp(e @ wk1 + bk1) @ wk2 + bk2                   k-EdgeMLP
//   w_v[p]   = ssp(e @ wv1 + bv1) @ wv2 + bv2                   v-EdgeMLP
//   s[p, h]  = live[p] ? sum_d qt[h, d] w_k[p, d] k[row(p), h, d] / sqrt(kd) : -1e9
//   a        = softmax over {s[:, h], diag_scores[h]}            (R + 1 slots)
//   out[h,d] = sum_p a[p, h] w_v[p, d] v[row(p), h, d] + a_self[h] diag_value[h, d]
// The forms differ in row(p), dist and live only:
//   kList      row = nbr[i, p] in i's graph; dist [B*N, K]; live = nbr_mask
//   kGathered  row = slot p's own row of k_nb/v_nb [B*N*K, *]; as kList
//   kDense     row = column p of i's graph; dist = adj_dist [B*N, N] (BIG = 1e9
//              where j is not adjacent to i); live = dist < BIG / 2
// EdgeMLP weights come in the flax [in, out] layout. The backward (with the
// cotangent g [H, vd]) is, per node:
//   ddv[h, d]  = a_self[h] g[h, d]
//   da[p, h]   = sum_d g[h, d] w_v[p, d] v[row(p), h, d]
//   dot[h]     = sum_p a[p, h] da[p, h] + a_self[h] da_self[h],
//                da_self[h] = sum_d g[h, d] dval[h, d]
//   dds[h]     = a_self[h] (da_self[h] - dot[h])
//   dsc[p, h]  = live[p] a[p, h] (da[p, h] - dot[h]) / sqrt(kd)
//   dqt[h, d]  = sum_p dsc[p, h] w_k[p, d] k[row(p), h, d]
//   dk[row(p)] += dsc[p, h] w_k[p, d] qt[h, d]      (every slot)
//   dv[row(p)] += a[p, h] w_v[p, d] g[h, d]         (every slot: a padded
//                 row's softmax is uniform, so its dead slots send dv too)
//   dw_k[p, d] = sum_h dsc[p, h] k[row(p), h, d] qt[h, d]
//   dw_v[p, d] = sum_h a[p, h] g[h, d] v[row(p), h, d]
//   EdgeMLPs: dW2 += h^T dw, db2 += sum dw, dh = (dw W2^T) sigmoid(pre),
//             dW1 += e^T dh, db1 += sum dh, summed over every node and slot.
// nbr, nbr_mask, dist, adj_dist and centers get no gradient.
//
// The dense form walks live columns only. A dead column of a row that has a
// live one weighs exp(-1e9 - m) = 0 in float32 (m is at least that live
// column's score), so every term it adds above is an exact zero. A row with
// no live column (a padded node: self score -1e9; or an isolated real node)
// has m = max(s_self, -1e9) and weighs each of its N dead columns alike,
// a_dead = e^(-1e9-m) / (N e^(-1e9-m) + e^(s_self-m)): every dead column sees
// the smear of BIG, -0, so one w_v0 = ssp(bv1) @ wv2 + bv2, and its output is
// a_dead w_v0 * vsum + a_self dval with vsum the graph's column sum of v
// (graph_colsum_kernel). Its backward: dot = a_dead sum_d g w_v0 vsum +
// a_self da_self, no dsc (its columns are dead), and per graph G = sum over
// such rows of a_dead g, which sends w_v0 * G to every column's dv and
// dw_v = sum_h G vsum through the constant hidden ssp(bv1) to dwv2, dbv2 and
// dbv1 (dwv1 gets e^T dh = 0: the smear is -0) (padded_wgrad_kernel).
// A row's live columns come as lists built once per graph from adj_dist
// (ops/cuda/dense_edge_attn.py::live_columns): CSR row offsets lrow
// [B*N + 1], each live pair's graph-local column lcol [E], ascending; and
// lorder [B*N], the rows by descending live count, the order in which the
// blocks' grid-stride loops take them: a row's work grows with its live
// count (0 for a padded row, up to two tiles for a hub), and in this order
// each block gets a like share of every cost.
//
// Design. A persistent grid of 512-thread blocks; each keeps the four
// EdgeMLP weight matrices in shared memory (~45 KB) for its life and walks
// nodes in a grid-stride loop. The TPU kernels gathered neighbour rows with
// one-hot matmuls; here each slot's k/v row is read by index. A node's slots
// go in tiles: the whole list (K slots) as one tile, the dense form's live
// columns in ragged tiles of at most kDenseFwdTile / kDenseBwdTile.
// Per tile, all in shared memory: the smear, the EdgeMLPs as
// register-blocked GEMMs (block_gemm.cuh), the scores one thread per (slot,
// head) with the row's 16-byte key loads all in flight, then an online
// softmax: a running max m and sum l per head, which the self slot starts
// (m = its score, l = 1, the aggregate = diag_value); a tile that moves the
// max rescales the [H, vd] aggregate by exp(m_old - m_new), and the
// aggregate is divided by l at the end. Nothing of shape [B, N, R, *] is
// kept in device memory by the forward. The dense form's forward is built
// for two resident blocks per SM (__launch_bounds__ min blocks 2: at most 64
// registers a thread), which its 64-column tile fits in shared memory.
//
// The dense form's backward pair kernel (K8b) sweeps a node's tiles twice:
// the first recomputes each tile's forward and da and carries m, l and dot
// online; the second recomputes the tile again (not when the node is one
// tile: its buffers still hold it) and writes dsc, dqt, dds, ddv, and per
// slot the four numbers the dk/dv stage needs (w_k, w_v, a, dsc) to scratch
// [slots, kd + vd + 2H], at the live pair's CSR index. The EdgeMLP weight
// gradients stay in registers, each sum owned by one thread, across all the
// block's nodes, and go to the block's row of a [blocks, P] buffer at the
// end, summed in block order by sum_rows_kernel. dk/dv are csr_dkdv_kernel:
// one block per destination row gathers its incoming live pairs over the
// CSR transpose of the live lists. Every sum runs in a fixed order: no
// atomics. The backward templates take the dense form alone (static_assert).
#pragma once

#include "block_gemm.cuh"

namespace singa {
namespace encoder_attn {

constexpr int kThreads = 512;
// the dense form's live columns per tile: the forward's fits two resident
// blocks per SM, the backward's (one block) holds almost every row whole
constexpr int kDenseFwdTile = 64;
constexpr int kDenseBwdTile = 96;
constexpr float kBig = 1e9f;       // adj_dist's value for a pair that is not adjacent
constexpr int kAccPerThread = 24;  // weight-gradient sums a backward thread owns
constexpr int kDkdvThreads = 128;

enum Form { kList = 0, kGathered = 1, kDense = 2 };

// What a launch reads. k and v: node rows [B*N, H*kd] and [B*N, H*vd], or
// (kGathered) the slots' rows [B*N*K, *]. T is the storage type of qt, k,
// v and dval (bfloat16 in the bfloat16 instances); the distances, ds, the
// centers and the EdgeMLP weights are float32 at either.
template <class T = float>
struct ArgsT {
  using value_type = T;
  const T *qt, *k, *v;
  const int* nbr;              // kList: [B*N, K]
  const unsigned char* nmask;  // kList, kGathered: [B*N, K]
  const float* dist;           // [B*N, R]
  const float* ds;             // [B*N, H]
  const T* dval;               // [B*N, H*vd]
  const float *centers, *wk1, *bk1, *wk2, *bk2, *wv1, *bv1, *wv2, *bv2;
  float coeff;
  const int *lrow, *lcol;      // kDense: live lists, [B*N + 1] and [E]
  const int* lorder;           // kDense: [B*N] the rows by descending live count
  float* vsum;                 // kDense: [B, H*vd] v summed per graph (launch_fwd sums it)
};
using Args = ArgsT<float>;

// R: slots per node (K, or N for kDense).
struct Dims {
  int B, N, R, H, kd, vd, De;
  __host__ __device__ int mlp_floats() const {  // EdgeMLP weights and biases, centers
    return De * kd + kd + kd * kd + kd + De * vd + vd + vd * vd + vd + De;
  }
  __host__ __device__ int grad_floats() const { return mlp_floats() - De; }
  __host__ bool ok() const {
    return B >= 1 && N >= 1 && R >= 1 && H >= 1 && kd >= 1 && vd >= 1 && De >= 1;
  }
};

// Slots per tile of the forward (kBwd false) or the backward pair kernel:
// the whole list, or the dense form's live columns, at most its tile.
template <int F, bool kBwd>
__host__ __device__ __forceinline__ int tile_of(const Dims& d) {
  if (F != kDense) return d.R;
  const int t = kBwd ? kDenseBwdTile : kDenseFwdTile;
  return d.R < t ? d.R : t;
}

// A node's slot count, and in `first` the flat index of its first slot.
template <int F, class A>
__device__ __forceinline__ int node_slots(const A& a, const Dims& d, long long node,
                                          long long& first) {
  if (F == kDense) {
    first = a.lrow[node];
    return a.lrow[node + 1] - (int)first;
  }
  first = node * d.R;
  return d.R;
}

// The row of k (or v) that slot c0 + p of the node reads.
template <int F>
__device__ __forceinline__ long long slot_row(long long base, long long first, const int* sidx,
                                              int c0, int p) {
  if (F == kGathered) return first + c0 + p;
  return base + sidx[p];
}

// The EdgeMLP weights and the smear centers in shared memory.
struct Mlp {
  float *wk1, *bk1, *wk2, *bk2, *wv1, *bv1, *wv2, *bv2, *cent;
};

// Lays out and fills the Mlp at p; returns the first float after it. The
// weights are rounded to the activations' type (the TPU kernel's
// w.astype(dt)); the biases and centers stay float32.
template <class A>
__device__ inline float* load_mlp(const A& a, const Dims& d, float* p, Mlp& w) {
  using T = typename A::value_type;
  const int kd = d.kd, vd = d.vd, De = d.De, tid = threadIdx.x;
  w.wk1 = p;
  w.bk1 = w.wk1 + De * kd;
  w.wk2 = w.bk1 + kd;
  w.bk2 = w.wk2 + kd * kd;
  w.wv1 = w.bk2 + kd;
  w.bv1 = w.wv1 + De * vd;
  w.wv2 = w.bv1 + vd;
  w.bv2 = w.wv2 + vd * vd;
  w.cent = w.bv2 + vd;
  for (int t = tid; t < De * kd; t += blockDim.x) w.wk1[t] = rnd<T>(a.wk1[t]);
  for (int t = tid; t < kd * kd; t += blockDim.x) w.wk2[t] = rnd<T>(a.wk2[t]);
  for (int t = tid; t < De * vd; t += blockDim.x) w.wv1[t] = rnd<T>(a.wv1[t]);
  for (int t = tid; t < vd * vd; t += blockDim.x) w.wv2[t] = rnd<T>(a.wv2[t]);
  for (int t = tid; t < kd; t += blockDim.x) { w.bk1[t] = a.bk1[t]; w.bk2[t] = a.bk2[t]; }
  for (int t = tid; t < vd; t += blockDim.x) { w.bv1[t] = a.bv1[t]; w.bv2[t] = a.bv2[t]; }
  for (int t = tid; t < De; t += blockDim.x) w.cent[t] = a.centers[t];
  return w.cent + De;
}

// w_v0 [vd] = ssp(bv1) @ wv2 + bv2, the v-EdgeMLP of a dead column (smear
// -0), from global memory, the sum over the hidden in order; at T = bf16
// the hidden and wv2 rounded, as the TPU kernel rounds a column's.
template <class T = float>
__device__ inline void dead_wv(const float* bv1, const float* wv2, const float* bv2, int vd,
                               float* out) {
  for (int c = threadIdx.x; c < vd; c += blockDim.x) {
    float acc = bv2[c];
    for (int j = 0; j < vd; ++j) acc = fmaf(rnd<T>(sspf_(bv1[j])), rnd<T>(wv2[j * vd + c]), acc);
    out[c] = acc;
  }
}

// The closed form's softmax of a row with no live column, head h: (a_dead,
// a_self) over its N dead columns and the self slot.
__device__ __forceinline__ float2 dead_row_weights(float s_self, int N) {
  const float m = fmaxf(s_self, -kBig);
  const float ed = expf(-kBig - m), es = expf(s_self - m);
  const float l = fmaf((float)N, ed, es);
  return make_float2(ed / l, es / l);
}

// One tile's slots c0 .. c0 + T - 1 of `node`: distances, live flags and
// (kList, kDense) row indices into shared memory, then the smear into sA
// [T, De] (rounded to the activations' type). Starts with a barrier: the
// previous tile's readers are done.
template <int F, class A>
__device__ void load_tile(const A& a, const Dims& d, const Mlp& w, long long node,
                          long long first, int c0, int T, float* sdist, float* smask, int* sidx,
                          float* sA) {
  const int tid = threadIdx.x, De = d.De;
  __syncthreads();
  for (int t = tid; t < T; t += blockDim.x) {
    const long long s = first + c0 + t;
    float dd;
    if (F == kDense) {
      const int col = a.lcol[s];
      sidx[t] = col;
      dd = a.dist[node * d.R + col];
      smask[t] = dd < 0.5f * kBig ? 1.f : 0.f;
    } else {
      dd = a.dist[s];
      smask[t] = a.nmask[s] != 0 ? 1.f : 0.f;
      if (F == kList) sidx[t] = a.nbr[s];
    }
    sdist[t] = dd;
  }
  __syncthreads();
  for (int t = tid; t < T * De; t += blockDim.x) {
    const float diff = sdist[t / De] - w.cent[t % De];
    sA[t] = rnd<typename A::value_type>(-expf(a.coeff * diff * diff));
  }
  __syncthreads();
}

// Masked scores sS [T, H] of the tile: one thread per (slot, head), reading
// its kd key channels of the slot's row in 16-byte loads that are all in
// flight at once (when the layout allows them). At bfloat16 activations
// the list forms round each term q w k before the head sum, as the TPU
// kernel's (kw * qt).astype(dt) ahead of its seg_k product; the dense form
// does not (its TPU kernel sums the heads' lanes in float32).
template <int F, class A>
__device__ void tile_scores(const A& a, const Dims& d, long long base, long long first, int c0,
                            int T, const int* sidx, const float* smask, const float* sq,
                            const float* sWk, float* sS) {
  using V = typename A::value_type;
  const int H = d.H, kd = d.kd, HK = H * kd;
  const float scale = 1.f / sqrtf((float)kd);
  const bool vec4 = !kBf16<V> && (kd % 4 == 0) &&
                    ((reinterpret_cast<size_t>(sq) | reinterpret_cast<size_t>(sWk)) & 15) == 0;
  for (int job = threadIdx.x; job < T * H; job += blockDim.x) {
    const int p = job / H, h = job % H;
    const V* krow = a.k + slot_row<F>(base, first, sidx, c0, p) * HK + h * kd;
    const float* qr = sq + h * kd;
    const float* wr = sWk + p * kd;
    float part = 0.f;
    if constexpr (kBf16<V> && F != kDense) {
      for (int c = 0; c < kd; ++c) part += rnd<V>(qr[c] * wr[c] * to_f(krow[c]));
    } else if (vec4) {
      for (int c = 0; c < kd; c += 4) {
        const float4 kv = __ldg(reinterpret_cast<const float4*>(krow + c));
        const float4 qv = *reinterpret_cast<const float4*>(qr + c);
        const float4 wv = *reinterpret_cast<const float4*>(wr + c);
        part = fmaf(qv.x * wv.x, kv.x, part);
        part = fmaf(qv.y * wv.y, kv.y, part);
        part = fmaf(qv.z * wv.z, kv.z, part);
        part = fmaf(qv.w * wv.w, kv.w, part);
      }
    } else {
      for (int c = 0; c < kd; ++c) part = fmaf(qr[c] * wr[c], to_f(krow[c]), part);
    }
    sS[p * H + h] = smask[p] != 0.f ? part * scale : -1e9f;
  }
}

// One tile's step of the online softmax, one warp per head: the run's max m
// and sum l move over the tile's scores S [T, H]. With D (backward) dot, the
// run's sum of exp(s - m) * D, moves too and S is left as it is; without it
// (forward) S becomes exp(s - m_new) and al the run's rescale exp(m_old -
// m_new). The caller's barrier publishes m, l, dot and al.
__device__ inline void online_softmax(float* S, const float* D, int T, int H, float* m,
                                      float* l, float* dot, float* al) {
  const int lane = threadIdx.x & 31;
  for (int h = threadIdx.x >> 5; h < H; h += blockDim.x >> 5) {
    const float m_old = m[h];
    float mx = m_old;
    for (int p = lane; p < T; p += 32) mx = fmaxf(mx, S[p * H + h]);
    mx = warp_max(mx);
    float sum = 0.f, dsum = 0.f;
    for (int p = lane; p < T; p += 32) {
      const float e = expf(S[p * H + h] - mx);
      if (D) {
        dsum = fmaf(e, D[p * H + h], dsum);
      } else {
        S[p * H + h] = e;
      }
      sum += e;
    }
    sum = warp_sum(sum);
    if (D) dsum = warp_sum(dsum);
    if (lane == 0) {
      const float r = expf(m_old - mx);
      l[h] = fmaf(l[h], r, sum);
      if (D) dot[h] = fmaf(dot[h], r, dsum);
      if (al) al[h] = r;
      m[h] = mx;
    }
  }
}

template <int F>
__host__ __device__ inline int fwd_smem_floats(const Dims& d) {
  const int T = tile_of<F, false>(d), H = d.H;
  return d.mlp_floats() + T * (d.De > d.vd ? d.De : d.vd) + 2 * T * d.kd +
         (T > H ? T : H) * d.vd + T * H + H * d.kd + H * d.vd + 3 * H +
         (F == kDense ? d.vd : 0) + 3 * T;
}

// VT: the storage type of qt, k, v, dval and out. The list forms' bfloat16
// instances (K1's and K7's: a whole list is one tile, so the run's max and
// sum are final after it) are the function _attn_fwd_kernel computes at
// bfloat16 inputs: the smear, the EdgeMLP weights, their hiddens ssp(pre)
// and outputs w_k, w_v rounded to bfloat16; each score term rounded before
// the head sum; the softmax in float32, its weights a and a_self rounded
// before they weigh the values; the aggregate summed in float32 and rounded
// once. The dense form's (K8's) is _dattn_fwd_kernel's: the smear, the
// weights and the hiddens rounded, nothing after them (w_k, w_v, the score
// terms and the softmax weights stay float32, its online form as at
// float32); a dead column's w_v0 from the rounded hidden ssp(bv1) and wv2;
// the output rounded once.
template <int F, class VT = float>
__global__ void __launch_bounds__(kThreads, F == kDense ? 2 : 1)
attn_fwd_kernel(ArgsT<VT> a, Dims d, VT* __restrict__ out) {
  // the list forms' roundings after the hiddens, at bfloat16
  constexpr bool kRound = kBf16<VT> && F != kDense;
  const int H = d.H, kd = d.kd, vd = d.vd, De = d.De, HK = H * kd, HV = H * vd;
  const int TM = tile_of<F, false>(d);
  extern __shared__ __align__(16) float smem[];
  Mlp w;
  float* sA = load_mlp(a, d, smem, w);       // [TM, De] smear, later [TM, vd] w_v
  float* sHk = sA + TM * max(De, vd);        // [TM, kd]
  float* sWk = sHk + TM * kd;                // [TM, kd]
  float* sHv = sWk + TM * kd;                // [max(TM, H), vd]: [TM, vd], then partial sums
  float* sS = sHv + max(TM, H) * vd;         // [TM, H] scores, then exp(s - m)
  float* sq = sS + TM * H;                   // [HK] query row
  float* sAcc = sq + HK;                     // [HV] running aggregate
  float* sM = sAcc + HV;                     // [H] running max
  float* sL = sM + H;                        // [H] running sum
  float* sAl = sL + H;                       // [H] this tile's rescale
  float* sW0 = sAl + H;                      // kDense: [vd] a dead column's w_v
  float* sdist = sW0 + (F == kDense ? vd : 0);  // [TM]
  float* smask = sdist + TM;                 // [TM]
  int* sidx = reinterpret_cast<int*>(smask + TM);  // [TM]

  const int tid = threadIdx.x;
  if (F == kDense) dead_wv<VT>(a.bv1, a.wv2, a.bv2, vd, sW0);
  // slices of the slots in the aggregate; their partial sums (S * HV <=
  // max(TM, H) * vd floats) meet in sHv
  const int S = max(1, min((int)blockDim.x / HV, TM / H));
  const long long total = (long long)d.B * d.N;
  for (long long i = blockIdx.x; i < total; i += gridDim.x) {
    const long long node = F == kDense ? (long long)a.lorder[i] : i;
    const long long gb = node / d.N, base = gb * d.N;  // the node's graph and its first row
    long long first;
    const int R = node_slots<F>(a, d, node, first);
    __syncthreads();  // the previous node's readers are done (and sW0 is written)
    if (F == kDense && R == 0) {  // no live column: the closed form
      for (int c = tid; c < HV; c += blockDim.x) {
        const float2 aw = dead_row_weights(a.ds[node * H + c / vd], d.N);
        out[node * HV + c] = from_f<VT>(aw.x * sW0[c % vd] * a.vsum[gb * HV + c] +
                                       aw.y * to_f(a.dval[node * HV + c]));
      }
      continue;
    }
    for (int t = tid; t < HK; t += blockDim.x) sq[t] = to_f(a.qt[node * HK + t]);
    for (int t = tid; t < HV; t += blockDim.x) sAcc[t] = to_f(a.dval[node * HV + t]);
    for (int t = tid; t < H; t += blockDim.x) {
      sM[t] = a.ds[node * H + t];
      sL[t] = 1.f;
    }
    for (int c0 = 0; c0 < R; c0 += TM) {
      const int T = min(TM, R - c0);
      load_tile<F>(a, d, w, node, first, c0, T, sdist, smask, sidx, sA);
      block_gemm(sA, T, De, w.wk1, w.bk1, kd, sHk, kEpiSsp);
      block_gemm(sA, T, De, w.wv1, w.bv1, vd, sHv, kEpiSsp);
      __syncthreads();
      if constexpr (kBf16<VT>) {  // the hiddens ssp(pre), rounded
        for (int t = tid; t < T * kd; t += blockDim.x) sHk[t] = rnd<VT>(sHk[t]);
        for (int t = tid; t < T * vd; t += blockDim.x) sHv[t] = rnd<VT>(sHv[t]);
        __syncthreads();
      }
      block_gemm(sHk, T, kd, w.wk2, w.bk2, kd, sWk, kEpiNone);
      block_gemm(sHv, T, vd, w.wv2, w.bv2, vd, sA, kEpiNone);  // the smear is dead now
      __syncthreads();
      if constexpr (kRound) {  // w_k and w_v, rounded
        for (int t = tid; t < T * kd; t += blockDim.x) sWk[t] = rnd<VT>(sWk[t]);
        for (int t = tid; t < T * vd; t += blockDim.x) sA[t] = rnd<VT>(sA[t]);
        __syncthreads();
      }
      tile_scores<F>(a, d, base, first, c0, T, sidx, smask, sq, sWk, sS);
      __syncthreads();
      online_softmax(sS, nullptr, T, H, sM, sL, nullptr, sAl);
      __syncthreads();
      // the tile's aggregate: threads over (value channel, slice of the
      // slots), partial sums in sHv (dead by now), then added to the
      // rescaled run in slice order
      for (int t = tid; t < HV * S; t += blockDim.x) {
        const int c = t % HV, sl = t / HV;
        const int h = c / vd, dc = c % vd;
        float acc = 0.f;
#pragma unroll 4
        for (int p = sl; p < T; p += S) {
          // bfloat16: the normalised weight, rounded (one tile: l is final)
          const float aw = kRound ? rnd<VT>(sS[p * H + h] / sL[h]) : sS[p * H + h];
          acc = fmaf(aw * sA[p * vd + dc],
                     ldg_f(a.v + slot_row<F>(base, first, sidx, c0, p) * HV + c), acc);
        }
        sHv[sl * HV + c] = acc;
      }
      __syncthreads();
      for (int c = tid; c < HV; c += blockDim.x) {
        float acc = 0.f;
        for (int sl = 0; sl < S; ++sl) acc += sHv[sl * HV + c];
        // bfloat16: sAcc holds diag_value (one tile), weighed by a_self
        // = exp(s_self - m) / l = al / l, rounded
        sAcc[c] = kRound ? fmaf(rnd<VT>(sAl[c / vd] / sL[c / vd]), sAcc[c], acc)
                         : fmaf(sAcc[c], sAl[c / vd], acc);
      }
    }
    // each sAcc[c] was last written by this thread, each sL[h] before the
    // last tile's barriers
    for (int c = tid; c < HV; c += blockDim.x)
      out[node * HV + c] = from_f<VT>(kRound ? sAcc[c] : sAcc[c] / sL[c / vd]);
  }
}

// out[b, c] = sum over the N rows i of graph b, in order, of x[b*N + i, c],
// each term times wt[b*N + i, c / cw] when wt is given ([B*N, C / cw]).
// kDense: v's column sums (wt none), and G, the padded rows' a_dead-weighted
// cotangent (wt = a_dead [B*N, H], cw = vd). One block per graph. X: the
// storage type of x (bfloat16 values are summed in float32).
template <class X = float>
__global__ void graph_colsum_kernel(const X* __restrict__ x, const float* __restrict__ wt,
                                    float* __restrict__ out, int B, int N, int C, int cw) {
  const int nw = C / cw;
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      float acc = 0.f;
      for (int i = 0; i < N; ++i) {
        const long long r = (long long)b * N + i;
        const float xv = to_f(x[r * C + c]);
        acc = wt ? fmaf(wt[r * nw + c / cw], xv, acc) : acc + xv;
      }
      out[(long long)b * C + c] = acc;
    }
  }
}

template <class X>
inline cudaError_t launch_colsum(const X* x, const float* wt, float* out, int B, int N, int C,
                                 int cw, cudaStream_t st) {
  graph_colsum_kernel<X><<<B, 256, 0, st>>>(x, wt, out, B, N, C, cw);
  return cudaGetLastError();
}

// The forward of every form: cudaErrorInvalidValue for a shape it does not
// take (one tile's pair tensors over shared memory among them). kDense first
// sums v per graph into vsum [B, H*vd] (a.vsum).
template <int F, class T = float>
int launch_fwd(const ArgsT<T>& a, const Dims& d, T* out, void* stream) {
  if (!d.ok()) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = (size_t)fwd_smem_floats<F>(d) * sizeof(float);
  cudaError_t err = allow_smem(attn_fwd_kernel<F, T>, smem);
  if (err != cudaSuccess) return (int)err;
  if constexpr (F == kDense) {
    err = launch_colsum(a.v, nullptr, a.vsum, d.B, d.N, d.H * d.vd, d.vd, st);
    if (err != cudaSuccess) return (int)err;
  }
  const int grid = persistent_grid(attn_fwd_kernel<F, T>, kThreads, smem, (long long)d.B * d.N);
  attn_fwd_kernel<F, T><<<grid, kThreads, smem, st>>>(a, d, out);
  return (int)cudaGetLastError();
}

// What the backward writes. Scratch per slot (its flat index): s_wk [*, kd],
// s_wv [*, vd], s_a and s_dsc [*, H]; partial [blocks, P]. kDense also:
// s_ad [B*N, H], the closed-form rows' a_dead (0 on the others).
// T: the storage type of g, dqt and ddv (bfloat16 in K1b's, K7b's and
// K8b's bfloat16 instances); dds and the scratch are float32 at either.
template <class T = float>
struct GradsT {
  const T* g;  // the cotangent [B*N, H*vd]
  T* dqt;
  float* dds;
  T* ddv;
  float *s_wk, *s_wv, *s_a, *s_dsc, *partial, *s_ad;
};
using Grads = GradsT<float>;

// Shared-memory buffers of the backward pair kernel.
struct BwdSmem {
  Mlp w;
  float *wk2t, *wv2t, *one;
  float *A, *Pk, *Hk, *Wk, *Pv, *Hv, *Wv, *S, *D;  // pair buffers [T, *]
  float *q, *g, *dv, *dq, *w0;                      // node rows; kDense: w_v0
  float *sd, *dd, *m, *l, *dot, *ad;                // per head
  float *dist, *mask;                               // [T]
  int* idx;                                         // [T]
};

template <int F>
__host__ __device__ inline int bwd_smem_floats(const Dims& d) {
  const int T = tile_of<F, true>(d), H = d.H, kd = d.kd, vd = d.vd;
  int n = d.mlp_floats() + kd * kd + vd * vd + 4;               // weights, wk2t wv2t, one
  n += T * d.De + 3 * T * kd + 3 * T * vd + 2 * T * H;          // pair buffers
  n += 2 * H * kd + 2 * H * vd + 6 * H;                         // node rows; per head
  n += vd + 3 * T;                                              // w_v0; dist, mask, idx
  return n;
}

// The forward of one tile, keeping what the backward needs: pre-activations
// Pk/Pv, hiddens Hk/Hv (at VT = bf16 rounded), modulations Wk/Wv, the
// masked scores S and da in D.
template <int F, class VT>
__device__ void tile_forward_bwd(const ArgsT<VT>& a, const Dims& d, const BwdSmem& sm,
                                 long long node, long long base, long long first, int c0, int T) {
  const int H = d.H, kd = d.kd, vd = d.vd, De = d.De, HV = H * vd, tid = threadIdx.x;
  load_tile<F>(a, d, sm.w, node, first, c0, T, sm.dist, sm.mask, sm.idx, sm.A);
  block_gemm(sm.A, T, De, sm.w.wk1, sm.w.bk1, kd, sm.Pk, kEpiNone);
  block_gemm(sm.A, T, De, sm.w.wv1, sm.w.bv1, vd, sm.Pv, kEpiNone);
  __syncthreads();
  for (int t = tid; t < T * kd; t += blockDim.x) sm.Hk[t] = rnd<VT>(sspf_(sm.Pk[t]));
  for (int t = tid; t < T * vd; t += blockDim.x) sm.Hv[t] = rnd<VT>(sspf_(sm.Pv[t]));
  __syncthreads();
  block_gemm(sm.Hk, T, kd, sm.w.wk2, sm.w.bk2, kd, sm.Wk, kEpiNone);
  block_gemm(sm.Hv, T, vd, sm.w.wv2, sm.w.bv2, vd, sm.Wv, kEpiNone);
  __syncthreads();
  tile_scores<F>(a, d, base, first, c0, T, sm.idx, sm.mask, sm.q, sm.Wk, sm.S);
  // da, one thread per (slot, head)
  for (int job = tid; job < T * H; job += blockDim.x) {
    const int p = job / H, h = job % H;
    const VT* vrow = a.v + slot_row<F>(base, first, sm.idx, c0, p) * HV + h * vd;
    float part = 0.f;
    for (int c = 0; c < vd; ++c)
      part = fmaf(sm.g[h * vd + c] * sm.Wv[p * vd + c], ldg_f(vrow + c), part);
    sm.D[p * H + h] = part;
  }
  __syncthreads();
}

// VT: the storage type of qt, k, v, dval, g, dqt and ddv. The bfloat16
// instance (K8b's) is the function _dattn_bwd_kernel computes at bfloat16
// inputs: the forward recomputed as K8's bfloat16 instance rounds it (the
// smear, the weights and the hiddens; wk2 and wv2 rounded in dh's product
// too); da, the softmax, dot, dsc, dqt, dw_k and dw_v in float32; dw_k and
// dw_v rounded before dh and the weight gradients, dh rounded after its
// sigmoid factor (from the unrounded pre-activation); every sum in float32,
// dqt and ddv rounded once, dds and the weight gradients float32.
template <int F, class VT = float>
__global__ void __launch_bounds__(kThreads)
attn_bwd_pair_kernel(ArgsT<VT> a, Dims d, GradsT<VT> o) {
  static_assert(F == kDense, "the list forms' backward is csrc/neighbor_attn_bwd.cu");
  const int H = d.H, kd = d.kd, vd = d.vd, De = d.De, HK = H * kd, HV = H * vd;
  const int TM = tile_of<F, true>(d);
  extern __shared__ __align__(16) float smem[];
  BwdSmem sm;
  sm.wk2t = load_mlp(a, d, smem, sm.w);  // [kd(b), kd(a)] = wk2[a, b]
  sm.wv2t = sm.wk2t + kd * kd;           // [vd, vd]
  sm.one = sm.wv2t + vd * vd;            // [4], one[0] = 1
  sm.A = sm.one + 4;                     // [T, De] smear
  sm.Pk = sm.A + TM * De;                // [T, kd] pre-activation, then dhk
  sm.Hk = sm.Pk + TM * kd;               // [T, kd] hidden
  sm.Wk = sm.Hk + TM * kd;               // [T, kd] w_k, then dw_k
  sm.Pv = sm.Wk + TM * kd;               // [T, vd]
  sm.Hv = sm.Pv + TM * vd;
  sm.Wv = sm.Hv + TM * vd;
  sm.S = sm.Wv + TM * vd;                // [T, H] scores, then softmax weights
  sm.D = sm.S + TM * H;                  // [T, H] da, then dsc
  sm.q = sm.D + TM * H;                  // [HK]
  sm.g = sm.q + HK;                      // [HV]
  sm.dv = sm.g + HV;                     // [HV] diag_value
  sm.dq = sm.dv + HV;                    // [HK] dqt, summed over the tiles
  sm.sd = sm.dq + HK;                    // [H] the self score
  sm.dd = sm.sd + H;                     // [H] da_self
  sm.m = sm.dd + H;                      // [H] running max
  sm.l = sm.m + H;                       // [H] running sum
  sm.dot = sm.l + H;                     // [H] running sum of e * da, then dot
  sm.ad = sm.dot + H;                    // [H] a_self
  sm.w0 = sm.ad + H;                     // [vd] a dead column's w_v
  sm.dist = sm.w0 + vd;
  sm.mask = sm.dist + TM;
  sm.idx = reinterpret_cast<int*>(sm.mask + TM);

  const int tid = threadIdx.x;
  for (int t = tid; t < kd * kd; t += blockDim.x)
    sm.wk2t[(t % kd) * kd + t / kd] = rnd<VT>(a.wk2[t]);
  for (int t = tid; t < vd * vd; t += blockDim.x)
    sm.wv2t[(t % vd) * vd + t / vd] = rnd<VT>(a.wv2[t]);
  if (tid == 0) sm.one[0] = 1.f;
  dead_wv<VT>(a.bv1, a.wv2, a.bv2, vd, sm.w0);

  const int P = d.grad_floats();
  float acc[kAccPerThread];
#pragma unroll
  for (int r = 0; r < kAccPerThread; ++r) acc[r] = 0.f;

  const float scale = 1.f / sqrtf((float)kd);
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const long long total = (long long)d.B * d.N;
  for (long long i = blockIdx.x; i < total; i += gridDim.x) {
    const long long node = a.lorder[i];
    const long long gb = node / d.N, base = gb * d.N;  // the node's graph and its first row
    long long first;
    const int R = node_slots<F>(a, d, node, first);
    const bool closed = R == 0;  // no live column: the closed form
    __syncthreads();  // the previous node's readers are done
    for (int t = tid; t < HK; t += blockDim.x) {
      sm.q[t] = to_f(a.qt[node * HK + t]);
      sm.dq[t] = 0.f;
    }
    for (int t = tid; t < HV; t += blockDim.x) {
      sm.g[t] = to_f(o.g[node * HV + t]);
      sm.dv[t] = to_f(a.dval[node * HV + t]);
    }
    for (int t = tid; t < H; t += blockDim.x) sm.sd[t] = a.ds[node * H + t];
    __syncthreads();
    // da_self; the self slot starts the run: m = its score, l = 1, dot =
    // da_self. A closed-form row's dot and a_self come whole: its columns
    // add a_dead sum_d g w_v0 vsum
    for (int h = warp; h < H; h += nwarps) {
      float part = 0.f, dead = 0.f;
      for (int c = lane; c < vd; c += 32) {
        part = fmaf(sm.g[h * vd + c], sm.dv[h * vd + c], part);
        if (closed)
          dead = fmaf(sm.g[h * vd + c] * sm.w0[c], a.vsum[gb * HV + h * vd + c], dead);
      }
      part = warp_sum(part);
      if (closed) dead = warp_sum(dead);
      if (lane == 0) {
        sm.dd[h] = part;
        if (closed) {
          const float2 aw = dead_row_weights(sm.sd[h], d.N);
          const float dot = fmaf(aw.x, dead, aw.y * part);
          sm.ad[h] = aw.y;
          o.dds[node * H + h] = aw.y * (part - dot);
          o.s_ad[node * H + h] = aw.x;
        } else {
          sm.m[h] = sm.sd[h];
          sm.l[h] = 1.f;
          sm.dot[h] = part;
          o.s_ad[node * H + h] = 0.f;
        }
      }
    }
    if (closed) {
      __syncthreads();
      for (int c = tid; c < HV; c += blockDim.x)
        o.ddv[node * HV + c] = from_f<VT>(sm.ad[c / vd] * sm.g[c]);
      for (int c = tid; c < HK; c += blockDim.x) o.dqt[node * HK + c] = from_f<VT>(0.f);
      continue;
    }

    // sweep 1: the softmax's max, sum and sum of e * da, online
    const bool one_tile = R <= TM;
    for (int c0 = 0; c0 < R; c0 += TM) {
      const int T = min(TM, R - c0);
      tile_forward_bwd<F>(a, d, sm, node, base, first, c0, T);
      online_softmax(sm.S, sm.D, T, H, sm.m, sm.l, sm.dot, nullptr);
    }
    __syncthreads();
    for (int h = tid; h < H; h += blockDim.x) {
      const float ad = expf(sm.sd[h] - sm.m[h]) / sm.l[h];
      const float dot = sm.dot[h] / sm.l[h];
      sm.ad[h] = ad;
      sm.dot[h] = dot;
      o.dds[node * H + h] = ad * (sm.dd[h] - dot);
    }
    __syncthreads();
    for (int c = tid; c < HV; c += blockDim.x)
      o.ddv[node * HV + c] = from_f<VT>(sm.ad[c / vd] * sm.g[c]);

    // sweep 2: every slot's gradient
    for (int c0 = 0; c0 < R; c0 += TM) {
      const int T = min(TM, R - c0);
      if (!one_tile) tile_forward_bwd<F>(a, d, sm, node, base, first, c0, T);
      // softmax weights and dsc, one thread per (slot, head)
      for (int job = tid; job < T * H; job += blockDim.x) {
        const int p = job / H, h = job % H;
        const float aw = expf(sm.S[job] - sm.m[h]) / sm.l[h];
        sm.S[job] = aw;
        sm.D[job] = sm.mask[p] != 0.f ? aw * (sm.D[job] - sm.dot[h]) * scale : 0.f;
      }
      __syncthreads();
      // what the dk/dv stage needs per slot, and this tile's share of dqt
      const long long slot0 = first + c0;
      for (int t = tid; t < T * kd; t += blockDim.x) o.s_wk[slot0 * kd + t] = sm.Wk[t];
      for (int t = tid; t < T * vd; t += blockDim.x) o.s_wv[slot0 * vd + t] = sm.Wv[t];
      for (int t = tid; t < T * H; t += blockDim.x) {
        o.s_a[slot0 * H + t] = sm.S[t];
        o.s_dsc[slot0 * H + t] = sm.D[t];
      }
      for (int c = tid; c < HK; c += blockDim.x) {
        const int h = c / kd, dc = c % kd;
        float part = 0.f;
        for (int p = 0; p < T; ++p)
          part = fmaf(sm.D[p * H + h] * sm.Wk[p * kd + dc],
                      ldg_f(a.k + slot_row<F>(base, first, sm.idx, c0, p) * HK + c), part);
        sm.dq[c] += part;
      }
      __syncthreads();
      // dw_k into Wk and dw_v into Wv, one thread per (slot, channel) (at
      // bfloat16 rounded)
      for (int t = tid; t < T * kd; t += blockDim.x) {
        const int p = t / kd, dc = t % kd;
        const VT* krow = a.k + slot_row<F>(base, first, sm.idx, c0, p) * HK + dc;
        float part = 0.f;
        for (int h = 0; h < H; ++h)
          part = fmaf(sm.D[p * H + h] * sm.q[h * kd + dc], ldg_f(krow + h * kd), part);
        sm.Wk[t] = rnd<VT>(part);
      }
      for (int t = tid; t < T * vd; t += blockDim.x) {
        const int p = t / vd, dc = t % vd;
        const VT* vrow = a.v + slot_row<F>(base, first, sm.idx, c0, p) * HV + dc;
        float part = 0.f;
        for (int h = 0; h < H; ++h)
          part = fmaf(sm.S[p * H + h] * sm.g[h * vd + dc], ldg_f(vrow + h * vd), part);
        sm.Wv[t] = rnd<VT>(part);
      }
      __syncthreads();
      // dh = (dw W2^T) * sigmoid(pre), in place of the pre-activations
      block_gemm(sm.Wk, T, kd, sm.wk2t, nullptr, kd, sm.Pk, kEpiTimesSigmoid);
      block_gemm(sm.Wv, T, vd, sm.wv2t, nullptr, vd, sm.Pv, kEpiTimesSigmoid);
      __syncthreads();
      if constexpr (kBf16<VT>) {  // dh, rounded
        for (int t = tid; t < T * kd; t += blockDim.x) sm.Pk[t] = rnd<VT>(sm.Pk[t]);
        for (int t = tid; t < T * vd; t += blockDim.x) sm.Pv[t] = rnd<VT>(sm.Pv[t]);
        __syncthreads();
      }

      // weight-gradient sums over the tile's slots; sum t belongs to the
      // thread tid = t % blockDim.x, slot r = t / blockDim.x
#pragma unroll
      for (int r = 0; r < kAccPerThread; ++r) {
        int t = tid + r * blockDim.x;
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
    // each dq[c] was last written by this thread
    for (int c = tid; c < HK; c += blockDim.x) o.dqt[node * HK + c] = from_f<VT>(sm.dq[c]);
  }

  float* row = o.partial + (long long)blockIdx.x * P;
#pragma unroll
  for (int r = 0; r < kAccPerThread; ++r) {
    const int t = tid + r * blockDim.x;
    if (t < P) row[t] = acc[r];
  }
}

// dk and dv of destination row j: the live pairs that read row j, in the
// CSR order of the transpose (offsets [B*N + 1], slots: live pair indices).
// A pair's source node is pair_rows[pair]; dv also gets gw[b] (w_v0 * G of
// j's graph b: the closed-form rows' share). T: the storage type of qt, g,
// dk and dv (at bfloat16 summed in float32 and rounded once, as the TPU
// kernel's float32 column sums).
template <int F, class T = float>
__global__ void __launch_bounds__(kDkdvThreads)
csr_dkdv_kernel(const T* __restrict__ qt, const T* __restrict__ gin,
                const float* __restrict__ s_wk, const float* __restrict__ s_wv,
                const float* __restrict__ s_a, const float* __restrict__ s_dsc,
                const int* __restrict__ offsets, const int* __restrict__ slots,
                const int* __restrict__ pair_rows, const float* __restrict__ gw,
                T* __restrict__ dk, T* __restrict__ dv, Dims dm) {
  static_assert(F == kDense, "the list forms' dk/dv stage is csrc/neighbor_attn_bwd.cu");
  const int H = dm.H, kd = dm.kd, vd = dm.vd;
  const int HK = H * kd, HV = H * vd;
  const long long rows = (long long)dm.B * dm.N;
  for (long long j = blockIdx.x; j < rows; j += gridDim.x) {
    const int e0 = offsets[j], e1 = offsets[j + 1];
    for (int c = threadIdx.x; c < HK + HV; c += blockDim.x) {
      float acc = 0.f;
      if (c < HK) {
        const int h = c / kd, d = c % kd;
        for (int e = e0; e < e1; ++e) {
          const long long s = slots[e];
          const long long src = pair_rows[s];
          acc = fmaf(s_dsc[s * H + h] * s_wk[s * kd + d], ldg_f(qt + src * HK + c), acc);
        }
        dk[j * HK + c] = from_f<T>(acc);
      } else {
        const int cv = c - HK, h = cv / vd, d = cv % vd;
        for (int e = e0; e < e1; ++e) {
          const long long s = slots[e];
          const long long src = pair_rows[s];
          acc = fmaf(s_a[s * H + h] * s_wv[s * vd + d], ldg_f(gin + src * HV + cv), acc);
        }
        acc += gw[(j / dm.N) * HV + cv];
        dv[j * HV + cv] = from_f<T>(acc);
      }
    }
  }
}

template <int F, class T>
cudaError_t launch_dkdv(const ArgsT<T>& a, const Dims& dm, const T* g, const GradsT<T>& o,
                        const int* offsets, const int* slots, const int* pair_rows,
                        const float* gw, T* dk, T* dv, cudaStream_t st) {
  const int grid =
      persistent_grid(csr_dkdv_kernel<F, T>, kDkdvThreads, 0, (long long)dm.B * dm.N);
  csr_dkdv_kernel<F, T><<<grid, kDkdvThreads, 0, st>>>(a.qt, g, o.s_wk, o.s_wv, o.s_a, o.s_dsc,
                                                       offsets, slots, pair_rows, gw, dk, dv, dm);
  return cudaGetLastError();
}

// Blocks of the backward pair kernel (one resident wave), or -1 for a shape
// it does not take (weight gradients over the sums its threads keep, one
// tile's pair tensors over shared memory); the caller sizes the [blocks, P]
// scratch buffer from it.
template <int F, class T = float>
int bwd_blocks(const Dims& d) {
  if (!d.ok() || d.grad_floats() > kAccPerThread * kThreads) return -1;
  const size_t smem = (size_t)bwd_smem_floats<F>(d) * sizeof(float);
  if (allow_smem(attn_bwd_pair_kernel<F, T>, smem) != cudaSuccess) return -1;
  return persistent_grid(attn_bwd_pair_kernel<F, T>, kThreads, smem, (long long)d.B * d.N);
}

// Resident blocks per SM of the form's forward (kBwd false) or backward pair
// kernel at these shapes (T: its storage type), and its dynamic shared
// memory in *smem_bytes; -1 when the shared memory is over the card's limit.
template <int F, bool kBwd, class T = float>
int residency(const Dims& d, int* smem_bytes, int* tile) {
  *tile = tile_of<F, kBwd>(d);
  const size_t smem =
      (size_t)(kBwd ? bwd_smem_floats<F>(d) : fwd_smem_floats<F>(d)) * sizeof(float);
  *smem_bytes = (int)smem;
  int per_sm = 0;
  if constexpr (kBwd) {
    if (allow_smem(attn_bwd_pair_kernel<F, T>, smem) != cudaSuccess) return -1;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, attn_bwd_pair_kernel<F, T>, kThreads,
                                                  smem);
  } else {
    if (allow_smem(attn_fwd_kernel<F, T>, smem) != cudaSuccess) return -1;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, attn_fwd_kernel<F, T>, kThreads, smem);
  }
  return per_sm;
}

// Launches the pair kernel on `blocks` blocks; the caller then runs its
// form's dk/dv stage and sum_rows_kernel over o.partial.
template <int F, class T>
cudaError_t launch_bwd_pair(const ArgsT<T>& a, const Dims& d, const GradsT<T>& o, int blocks,
                            cudaStream_t st) {
  if (!d.ok() || blocks < 1 || d.grad_floats() > kAccPerThread * kThreads)
    return cudaErrorInvalidValue;
  const size_t smem = (size_t)bwd_smem_floats<F>(d) * sizeof(float);
  cudaError_t err = allow_smem(attn_bwd_pair_kernel<F, T>, smem);
  if (err != cudaSuccess) return err;
  attn_bwd_pair_kernel<F, T><<<blocks, kThreads, smem, st>>>(a, d, o);
  return cudaGetLastError();
}

}  // namespace encoder_attn
}  // namespace singa
