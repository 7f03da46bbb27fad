// K1b: neighbour-list graph attention of the kNN encoder, backward.
//
// Replaces: singa_tpu/ops/pallas/neighbor_attn.py::_bwd (_attn_bwd_kernel).
// The forward of csrc/neighbor_attn.cu is recomputed per node i and slot p
// (smear e, EdgeMLP pre-activations pk/pv, hiddens hk/hv, modulations
// w_k/w_v, softmax weights a and a_self), then with the cotangent g [H, vd]:
//   ddv[h, d]     = a_self[h] g[h, d]
//   da[p, h]      = sum_d g[h, d] w_v[p, d] v[nbr[p], h, d]
//   dot[h]        = sum_p a[p, h] da[p, h] + a_self[h] da_self[h],
//                   da_self[h] = sum_d g[h, d] dval[h, d]
//   dds[h]        = a_self[h] (da_self[h] - dot[h])
//   dsc[p, h]     = live[p] a[p, h] (da[p, h] - dot[h]) / sqrt(kd)
//   dqt[h, d]     = sum_p dsc[p, h] w_k[p, d] k[nbr[p], h, d]
//   dk[nbr[p]]   += dsc[p, h] w_k[p, d] qt[h, d]        (every slot)
//   dv[nbr[p]]   += a[p, h] w_v[p, d] g[h, d]           (every slot)
//   dw_k[p, d]    = sum_h dsc[p, h] k[nbr[p], h, d] qt[h, d]
//   dw_v[p, d]    = sum_h a[p, h] g[h, d] v[nbr[p], h, d]
//   EdgeMLPs: dW2 += h^T dw, db2 += sum dw, dh = (dw W2^T) sigmoid(pre),
//             dW1 += e^T dh, db1 += sum dh, summed over every node and slot.
// nbr, nbr_mask, dist and centers get no gradient, as in the TPU kernel.
//
// What bounds it on the H100: at the training path's shapes (32 graphs x 384
// nodes, K = 96 slots, De = 64, H = 4, kd = 32, vd = 64) each slot costs
// ~60 kFLOP (the two EdgeMLPs recomputed, their backward and the weight
// gradient products, almost all of it), ~71 GFLOP over every slot and ~23
// GFLOP over the live slots of the corpus (~0.34 ms at the 67 TFLOP/s
// float32 rate), against ~100 MB of node rows in and out (~30 us at
// 3.35 TB/s); float32 arithmetic bounds it.
//
// Design. Three kernels, every sum in a fixed order (deterministic, no
// atomics):
//   1. pair kernel: a persistent grid, one block per SM, each walking many
//      nodes. Per node it recomputes the forward in shared memory (as the
//      forward kernel does), runs the backward above, writes dqt, dds, ddv,
//      and per slot the four numbers the scatter needs (w_k, w_v, a, dsc) to
//      scratch. The EdgeMLP weight gradients stay in registers, each sum
//      owned by one thread, across all the block's nodes, and go to the
//      block's row of a [blocks, P] scratch buffer at the end. (The TPU
//      kernel added them into one resident output along its sequential grid;
//      Hopper's blocks run in no order.)
//   2. scatter kernel: dk and dv are the one-hot transpose of the slots, over
//      every slot, masked ones included (a padded node's softmax is uniform
//      and sends dv to the nodes its masked slots name). The adjacency is not
//      symmetric after the top-K cut, so the transpose is built from nbr
//      itself: the flat slot keys sorted stably into CSR order once per graph
//      (build_neighbor_graph, beside nbr), and
//      one block per destination row sums its incoming slots in that order,
//      reading the source node's qt and g rows by index.
//   3. a sum of the blocks' weight-gradient rows, in block order.
#include "block_gemm.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kAccPerThread = 24;  // weight-gradient sums a thread owns
constexpr int kScatterThreads = 128;

using singa::warp_max;
using singa::warp_sum;

struct Dims {
  int K, H, kd, vd, De;
  __host__ __device__ int grad_floats() const {
    return De * kd + kd + kd * kd + kd + De * vd + vd + vd * vd + vd;
  }
  // shared memory of the pair kernel, in floats (every segment a multiple of 4)
  __host__ __device__ int smem_floats() const {
    int n = De * kd + kd + kd * kd + kd + De * vd + vd + vd * vd + vd;  // weights
    n += kd * kd + vd * vd + De + 4;                                    // wk2t wv2t centers one
    n += K * De + 3 * K * kd + 3 * K * vd + 2 * K * H;                  // pair buffers
    n += H * kd + 2 * H * vd + 3 * H;                                   // q, g, dval rows; per head
    n += 3 * K;                                                         // idx, mask, dist
    return n;
  }
};

__global__ void __launch_bounds__(kThreads)
neighbor_attn_bwd_pair_kernel(
    const float* __restrict__ qt, const float* __restrict__ kk, const float* __restrict__ vv,
    const int* __restrict__ nbr, const unsigned char* __restrict__ nmask,
    const float* __restrict__ dist, const float* __restrict__ ds,
    const float* __restrict__ dval, const float* __restrict__ centers,
    const float* __restrict__ wk1, const float* __restrict__ bk1,
    const float* __restrict__ wk2, const float* __restrict__ bk2,
    const float* __restrict__ wv1, const float* __restrict__ bv1,
    const float* __restrict__ wv2, const float* __restrict__ bv2, float coeff,
    const float* __restrict__ gin, float* __restrict__ dqt, float* __restrict__ dds,
    float* __restrict__ ddv, float* __restrict__ s_wk, float* __restrict__ s_wv,
    float* __restrict__ s_a, float* __restrict__ s_dsc, float* __restrict__ partial, int B,
    int N, Dims dm) {
  const int K = dm.K, H = dm.H, kd = dm.kd, vd = dm.vd, De = dm.De;
  const int HK = H * kd, HV = H * vd;
  extern __shared__ __align__(16) float smem[];
  float* swk1 = smem;
  float* sbk1 = swk1 + De * kd;
  float* swk2 = sbk1 + kd;
  float* sbk2 = swk2 + kd * kd;
  float* swv1 = sbk2 + kd;
  float* sbv1 = swv1 + De * vd;
  float* swv2 = sbv1 + vd;
  float* sbv2 = swv2 + vd * vd;
  float* swk2t = sbv2 + vd;        // [kd(b), kd(a)] = wk2[a, b]
  float* swv2t = swk2t + kd * kd;  // [vd, vd]
  float* scent = swv2t + vd * vd;
  float* sone = scent + De;        // [4], sone[0] = 1
  float* sA = sone + 4;            // [K, De] smear
  float* sPk = sA + K * De;        // [K, kd] pre-activation, then dhk
  float* sHk = sPk + K * kd;       // [K, kd] hidden
  float* sWk = sHk + K * kd;       // [K, kd] w_k, then dw_k
  float* sPv = sWk + K * kd;       // [K, vd]
  float* sHv = sPv + K * vd;
  float* sWv = sHv + K * vd;
  float* sS = sWv + K * vd;        // [K, H] softmax weights
  float* sD = sS + K * H;          // [K, H] da, then dsc
  float* sq = sD + K * H;          // [HK]
  float* sg = sq + HK;             // [HV]
  float* sdv = sg + HV;            // [HV]
  float* sAd = sdv + HV;           // [H] a_self
  float* sDd = sAd + H;            // [H] da_self
  float* sDsd = sDd + H;           // [H] the self score
  int* sidx = reinterpret_cast<int*>(sDsd + H);  // [K]
  float* smask = reinterpret_cast<float*>(sidx + K);
  float* sdist = smask + K;

  const int tid = threadIdx.x;
  for (int t = tid; t < De * kd; t += blockDim.x) swk1[t] = wk1[t];
  for (int t = tid; t < kd * kd; t += blockDim.x) {
    swk2[t] = wk2[t];
    swk2t[(t % kd) * kd + t / kd] = wk2[t];
  }
  for (int t = tid; t < De * vd; t += blockDim.x) swv1[t] = wv1[t];
  for (int t = tid; t < vd * vd; t += blockDim.x) {
    swv2[t] = wv2[t];
    swv2t[(t % vd) * vd + t / vd] = wv2[t];
  }
  for (int t = tid; t < kd; t += blockDim.x) { sbk1[t] = bk1[t]; sbk2[t] = bk2[t]; }
  for (int t = tid; t < vd; t += blockDim.x) { sbv1[t] = bv1[t]; sbv2[t] = bv2[t]; }
  for (int t = tid; t < De; t += blockDim.x) scent[t] = centers[t];
  if (tid == 0) sone[0] = 1.f;

  const int P = dm.grad_floats();
  float acc[kAccPerThread];
#pragma unroll
  for (int r = 0; r < kAccPerThread; ++r) acc[r] = 0.f;

  const float scale = 1.f / sqrtf((float)kd);
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const long long total = (long long)B * N;
  for (long long node = blockIdx.x; node < total; node += gridDim.x) {
    const long long base = (node / N) * N;  // first row of this node's graph
    __syncthreads();  // the previous node's readers are done
    for (int t = tid; t < K; t += blockDim.x) {
      sidx[t] = nbr[node * K + t];
      smask[t] = nmask[node * K + t] ? 1.f : 0.f;
      sdist[t] = dist[node * K + t];
    }
    for (int t = tid; t < HK; t += blockDim.x) sq[t] = qt[node * HK + t];
    for (int t = tid; t < HV; t += blockDim.x) {
      sg[t] = gin[node * HV + t];
      sdv[t] = dval[node * HV + t];
    }
    for (int t = tid; t < H; t += blockDim.x) sDsd[t] = ds[node * H + t];
    __syncthreads();
    for (int t = tid; t < K * De; t += blockDim.x) {
      const float diff = sdist[t / De] - scent[t % De];
      sA[t] = -expf(coeff * diff * diff);
    }
    __syncthreads();
    singa::block_gemm(sA, K, De, swk1, sbk1, kd, sPk, singa::kEpiNone);
    singa::block_gemm(sA, K, De, swv1, sbv1, vd, sPv, singa::kEpiNone);
    __syncthreads();
    for (int t = tid; t < K * kd; t += blockDim.x) sHk[t] = singa::sspf_(sPk[t]);
    for (int t = tid; t < K * vd; t += blockDim.x) sHv[t] = singa::sspf_(sPv[t]);
    __syncthreads();
    singa::block_gemm(sHk, K, kd, swk2, sbk2, kd, sWk, singa::kEpiNone);
    singa::block_gemm(sHv, K, vd, swv2, sbv2, vd, sWv, singa::kEpiNone);
    __syncthreads();

    // scores, one thread per (slot, head), as the forward
    for (int job = tid; job < K * H; job += blockDim.x) {
      const int p = job / H, h = job % H;
      const float* krow = kk + (base + sidx[p]) * HK + h * kd;
      float part = 0.f;
      for (int d = 0; d < kd; ++d) part = fmaf(sq[h * kd + d] * sWk[p * kd + d], __ldg(krow + d), part);
      sS[p * H + h] = smask[p] != 0.f ? part * scale : -1e9f;
    }
    __syncthreads();
    // softmax over the K slots and the self slot: one warp per head
    for (int h = warp; h < H; h += nwarps) {
      const float sd = sDsd[h];
      float m = sd;
      for (int p = lane; p < K; p += 32) m = fmaxf(m, sS[p * H + h]);
      m = warp_max(m);
      float sum = 0.f;
      for (int p = lane; p < K; p += 32) {
        const float e = expf(sS[p * H + h] - m);
        sS[p * H + h] = e;
        sum += e;
      }
      const float ed = expf(sd - m);
      const float inv = 1.f / (warp_sum(sum) + ed);
      for (int p = lane; p < K; p += 32) sS[p * H + h] *= inv;
      if (lane == 0) sAd[h] = ed * inv;
    }
    // da[p, h], one thread per (slot, head)
    for (int job = tid; job < K * H; job += blockDim.x) {
      const int p = job / H, h = job % H;
      const float* vrow = vv + (base + sidx[p]) * HV + h * vd;
      float part = 0.f;
      for (int d = 0; d < vd; ++d) part = fmaf(sg[h * vd + d] * sWv[p * vd + d], __ldg(vrow + d), part);
      sD[p * H + h] = part;
    }
    // da_self[h]: one warp per head
    for (int h = warp; h < H; h += nwarps) {
      float part = 0.f;
      for (int d = lane; d < vd; d += 32) part = fmaf(sg[h * vd + d], sdv[h * vd + d], part);
      part = warp_sum(part);
      if (lane == 0) sDd[h] = part;
    }
    __syncthreads();
    // softmax backward over the K + 1 slots: one warp per head
    for (int h = warp; h < H; h += nwarps) {
      float part = 0.f;
      for (int p = lane; p < K; p += 32) part = fmaf(sS[p * H + h], sD[p * H + h], part);
      const float dot = warp_sum(part) + sAd[h] * sDd[h];
      for (int p = lane; p < K; p += 32)
        sD[p * H + h] = smask[p] != 0.f ? sS[p * H + h] * (sD[p * H + h] - dot) * scale : 0.f;
      if (lane == 0) dds[node * H + h] = sAd[h] * (sDd[h] - dot);
    }
    for (int c = tid; c < HV; c += blockDim.x) ddv[node * HV + c] = sAd[c / vd] * sg[c];
    __syncthreads();

    // what the scatter kernel needs per slot, and dqt
    for (int t = tid; t < K * kd; t += blockDim.x) s_wk[node * K * kd + t] = sWk[t];
    for (int t = tid; t < K * vd; t += blockDim.x) s_wv[node * K * vd + t] = sWv[t];
    for (int t = tid; t < K * H; t += blockDim.x) {
      s_a[node * K * H + t] = sS[t];
      s_dsc[node * K * H + t] = sD[t];
    }
    for (int c = tid; c < HK; c += blockDim.x) {
      const int h = c / kd, d = c % kd;
      float part = 0.f;
      for (int p = 0; p < K; ++p)
        part = fmaf(sD[p * H + h] * sWk[p * kd + d], __ldg(kk + (base + sidx[p]) * HK + c), part);
      dqt[node * HK + c] = part;
    }
    __syncthreads();
    // dw_k into sWk and dw_v into sWv, one thread per (slot, channel)
    for (int t = tid; t < K * kd; t += blockDim.x) {
      const int p = t / kd, d = t % kd;
      const float* krow = kk + (base + sidx[p]) * HK + d;
      float part = 0.f;
      for (int h = 0; h < H; ++h) part = fmaf(sD[p * H + h] * sq[h * kd + d], __ldg(krow + h * kd), part);
      sWk[t] = part;
    }
    for (int t = tid; t < K * vd; t += blockDim.x) {
      const int p = t / vd, d = t % vd;
      const float* vrow = vv + (base + sidx[p]) * HV + d;
      float part = 0.f;
      for (int h = 0; h < H; ++h) part = fmaf(sS[p * H + h] * sg[h * vd + d], __ldg(vrow + h * vd), part);
      sWv[t] = part;
    }
    __syncthreads();
    // dh = (dw W2^T) * sigmoid(pre), in place of the pre-activations
    singa::block_gemm(sWk, K, kd, swk2t, nullptr, kd, sPk, singa::kEpiTimesSigmoid);
    singa::block_gemm(sWv, K, vd, swv2t, nullptr, vd, sPv, singa::kEpiTimesSigmoid);
    __syncthreads();

    // weight-gradient sums over the node's slots; sum t belongs to the
    // thread tid = t % blockDim.x, slot r = t / blockDim.x
#pragma unroll
    for (int r = 0; r < kAccPerThread; ++r) {
      int t = tid + r * blockDim.x;
      if (t < P) {
        const float* a;  // column of the left operand [K, sa] (sa = 0: ones)
        const float* b;  // column of the right operand [K, sb]
        int sa, sb;
        if (t < De * kd) {                         // dwk1 = e^T dhk
          a = sA + t / kd; sa = De; b = sPk + t % kd; sb = kd;
        } else if ((t -= De * kd) < kd) {          // dbk1
          a = sone; sa = 0; b = sPk + t; sb = kd;
        } else if ((t -= kd) < kd * kd) {          // dwk2 = hk^T dw_k
          a = sHk + t / kd; sa = kd; b = sWk + t % kd; sb = kd;
        } else if ((t -= kd * kd) < kd) {          // dbk2
          a = sone; sa = 0; b = sWk + t; sb = kd;
        } else if ((t -= kd) < De * vd) {          // dwv1 = e^T dhv
          a = sA + t / vd; sa = De; b = sPv + t % vd; sb = vd;
        } else if ((t -= De * vd) < vd) {          // dbv1
          a = sone; sa = 0; b = sPv + t; sb = vd;
        } else if ((t -= vd) < vd * vd) {          // dwv2 = hv^T dw_v
          a = sHv + t / vd; sa = vd; b = sWv + t % vd; sb = vd;
        } else {                                   // dbv2
          t -= vd * vd;
          a = sone; sa = 0; b = sWv + t; sb = vd;
        }
        float v = acc[r];
        for (int p = 0; p < K; ++p) v = fmaf(a[p * sa], b[p * sb], v);
        acc[r] = v;
      }
    }
  }

  float* row = partial + (long long)blockIdx.x * P;
#pragma unroll
  for (int r = 0; r < kAccPerThread; ++r) {
    const int t = tid + r * blockDim.x;
    if (t < P) row[t] = acc[r];
  }
}

// dk and dv of destination row j: the slots whose nbr names j, in CSR order.
__global__ void __launch_bounds__(kScatterThreads)
neighbor_attn_bwd_scatter_kernel(const float* __restrict__ qt, const float* __restrict__ gin,
                                 const float* __restrict__ s_wk, const float* __restrict__ s_wv,
                                 const float* __restrict__ s_a, const float* __restrict__ s_dsc,
                                 const int* __restrict__ offsets, const int* __restrict__ slots,
                                 float* __restrict__ dk, float* __restrict__ dv, long long rows,
                                 Dims dm) {
  const int K = dm.K, H = dm.H, kd = dm.kd, vd = dm.vd;
  const int HK = H * kd, HV = H * vd;
  for (long long j = blockIdx.x; j < rows; j += gridDim.x) {
    const int e0 = offsets[j], e1 = offsets[j + 1];
    for (int c = threadIdx.x; c < HK + HV; c += blockDim.x) {
      float acc = 0.f;
      if (c < HK) {
        const int h = c / kd, d = c % kd;
        for (int e = e0; e < e1; ++e) {
          const long long s = slots[e];  // flat (row, slot) of the source
          acc = fmaf(s_dsc[s * H + h] * s_wk[s * kd + d], __ldg(qt + (s / K) * HK + c), acc);
        }
        dk[j * HK + c] = acc;
      } else {
        const int cv = c - HK, h = cv / vd, d = cv % vd;
        for (int e = e0; e < e1; ++e) {
          const long long s = slots[e];
          acc = fmaf(s_a[s * H + h] * s_wv[s * vd + d], __ldg(gin + (s / K) * HV + cv), acc);
        }
        dv[j * HV + cv] = acc;
      }
    }
  }
}

bool dims_ok(const Dims& d) {
  return d.K >= 1 && d.H >= 1 && d.kd >= 1 && d.vd >= 1 && d.De >= 1 &&
         d.grad_floats() <= kAccPerThread * kThreads;
}

}  // namespace

// Blocks of the pair kernel (one resident wave); the caller sizes the
// [blocks, P] scratch buffer from it. Returns -1 for unsupported shapes.
extern "C" int neighbor_attn_bwd_blocks(int B, int N, int K, int H, int kd, int vd, int De) {
  const Dims dm{K, H, kd, vd, De};
  if (B < 1 || N < 1 || !dims_ok(dm)) return -1;
  const size_t smem = (size_t)dm.smem_floats() * sizeof(float);
  if (singa::allow_smem(neighbor_attn_bwd_pair_kernel, smem) != cudaSuccess) return -1;
  return singa::persistent_grid(neighbor_attn_bwd_pair_kernel, kThreads, smem, (long long)B * N);
}

// offsets [B*N + 1] and slots [B*N*K]: the CSR transpose of nbr (flat slot
// ids grouped by destination row, ascending within a row). Scratch: s_wk
// [B*N*K, kd], s_wv [B*N*K, vd], s_a and s_dsc [B*N*K, H], partial
// [blocks, P]. grads [P]: dwk1 dbk1 dwk2 dbk2 dwv1 dbv1 dwv2 dbv2, flat.
extern "C" int neighbor_attn_bwd_f32(
    const float* qt, const float* k, const float* v, const int* nbr, const unsigned char* nmask,
    const float* dist, const float* ds, const float* dval, const float* centers,
    const float* wk1, const float* bk1, const float* wk2, const float* bk2, const float* wv1,
    const float* bv1, const float* wv2, const float* bv2, float coeff, const float* g,
    const int* offsets, const int* slots, float* dqt, float* dk, float* dv, float* dds,
    float* ddv, float* s_wk, float* s_wv, float* s_a, float* s_dsc, float* partial,
    float* grads, int B, int N, int K, int H, int kd, int vd, int De, int blocks,
    void* stream) {
  const Dims dm{K, H, kd, vd, De};
  if (B < 1 || N < 1 || blocks < 1 || !dims_ok(dm)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = (size_t)dm.smem_floats() * sizeof(float);
  cudaError_t err = singa::allow_smem(neighbor_attn_bwd_pair_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  neighbor_attn_bwd_pair_kernel<<<blocks, kThreads, smem, st>>>(
      qt, k, v, nbr, nmask, dist, ds, dval, centers, wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2,
      coeff, g, dqt, dds, ddv, s_wk, s_wv, s_a, s_dsc, partial, B, N, dm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)B * N;
  const int sgrid = singa::persistent_grid(neighbor_attn_bwd_scatter_kernel, kScatterThreads, 0, rows);
  neighbor_attn_bwd_scatter_kernel<<<sgrid, kScatterThreads, 0, st>>>(
      qt, g, s_wk, s_wv, s_a, s_dsc, offsets, slots, dk, dv, rows, dm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int P = dm.grad_floats();
  singa::sum_rows_kernel<<<(P + 255) / 256, 256, 0, st>>>(partial, grads, P, blocks);
  return (int)cudaGetLastError();
}
