// K1: neighbour-list graph attention of the kNN encoder, forward.
//
// Replaces: singa_tpu/ops/pallas/neighbor_attn.py::neighbor_attn_fused
// (_attn_fwd_kernel). Per node i (row b*N + i) and in-neighbour slot p:
//   e[p, :]  = -exp(coeff * (dist[p] - centers)^2)              RBF smear
//   w_k[p]   = ssp(e @ wk1 + bk1) @ wk2 + bk2                   k-EdgeMLP
//   w_v[p]   = ssp(e @ wv1 + bv1) @ wv2 + bv2                   v-EdgeMLP
//   s[p, h]  = sum_d qt[h, d] * w_k[p, d] * k[nbr[p], h, d] / sqrt(kd)
//   a        = softmax over {s[:, h] masked to -1e9, diag_scores[h]}
//   out[h,d] = sum_p a[p, h] * w_v[p, d] * v[nbr[p], h, d] + a_self[h] * diag_value[h, d]
// EdgeMLP weights come in the flax [in, out] layout.
//
// What bounds it on the H100: at the main path's shapes (8 pockets x 384
// nodes, K = 96 slots, De = 64, H = 4, kd = 32, vd = 64) each pair costs
// ~23 kFLOP, almost all in the two EdgeMLPs: ~6.9 GFLOP over every slot,
// ~2.1 GFLOP over the live pairs of the val pockets, against ~15 MB of node
// rows in and out. Float32 arithmetic bounds it (~31 us for the live pairs
// at the 67 TFLOP/s float32 CUDA-core rate, memory ~5 us).
//
// Design: the TPU kernel gathered neighbour rows with one-hot matmuls (a
// TPU workaround); here each block loads its node's K neighbour indices and
// reads the k/v rows by index. The four EdgeMLP weight matrices sit in
// shared memory for the life of the block (~45 KB), which walks many nodes
// in a grid-stride loop. All pair tensors of one node ([K, De] smear, the
// MLP hiddens and outputs, the [K, H] scores) live in shared memory; nothing
// of shape [B, N, K, *] reaches device memory. The small products run as
// register-blocked shared-memory GEMMs (4 rows per thread, warp-broadcast
// 16-byte row reads). A block has 512 threads, since one node's pair
// tensors (~120 KB) leave room for one block per SM: the scores run one
// thread per (slot, head) with all of a row's 16-byte key loads in flight
// at once, and the aggregate splits the slots over two thread halves whose
// partial sums meet in shared memory.
#include "block_gemm.cuh"

namespace {

constexpr int kThreads = 512;

using singa::warp_max;
using singa::warp_sum;

__global__ void __launch_bounds__(kThreads)
neighbor_attn_kernel(const float* __restrict__ qt, const float* __restrict__ kk,
                     const float* __restrict__ vv, const int* __restrict__ nbr,
                     const unsigned char* __restrict__ nmask,
                     const float* __restrict__ dist, const float* __restrict__ ds,
                     const float* __restrict__ dval, const float* __restrict__ centers,
                     const float* __restrict__ wk1, const float* __restrict__ bk1,
                     const float* __restrict__ wk2, const float* __restrict__ bk2,
                     const float* __restrict__ wv1, const float* __restrict__ bv1,
                     const float* __restrict__ wv2, const float* __restrict__ bv2,
                     float coeff, float* __restrict__ out, int B, int N, int K, int H,
                     int kd, int vd, int De) {
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
  float* scent = sbv2 + vd;
  float* sA = scent + De;                  // [K, De] smear, later [K, vd] w_v
  float* sHk = sA + K * max(De, vd);       // [K, kd]
  float* sWk = sHk + K * kd;               // [K, kd]
  float* sHv = sWk + K * kd;               // [K, vd]
  float* sS = sHv + K * vd;                // [K, H] scores, then weights
  float* sAd = sS + K * H;                 // [H] self weight
  float* sq = sAd + H;                     // [H * kd] query row
  int* sidx = reinterpret_cast<int*>(sq + HK);  // [K]
  float* smask = reinterpret_cast<float*>(sidx + K);  // [K]
  float* sdist = smask + K;                // [K]

  const int tid = threadIdx.x;
  for (int t = tid; t < De * kd; t += blockDim.x) swk1[t] = wk1[t];
  for (int t = tid; t < kd * kd; t += blockDim.x) swk2[t] = wk2[t];
  for (int t = tid; t < De * vd; t += blockDim.x) swv1[t] = wv1[t];
  for (int t = tid; t < vd * vd; t += blockDim.x) swv2[t] = wv2[t];
  for (int t = tid; t < kd; t += blockDim.x) { sbk1[t] = bk1[t]; sbk2[t] = bk2[t]; }
  for (int t = tid; t < vd; t += blockDim.x) { sbv1[t] = bv1[t]; sbv2[t] = bv2[t]; }
  for (int t = tid; t < De; t += blockDim.x) scent[t] = centers[t];

  const float scale = 1.f / sqrtf((float)kd);
  // 16-byte reads of the query and w_k rows when their layout allows them
  const bool vec4 = (kd % 4 == 0) &&
                    ((reinterpret_cast<size_t>(sq) | reinterpret_cast<size_t>(sWk)) & 15) == 0;
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
    __syncthreads();
    for (int t = tid; t < K * De; t += blockDim.x) {
      const float diff = sdist[t / De] - scent[t % De];
      sA[t] = -expf(coeff * diff * diff);
    }
    __syncthreads();
    singa::block_gemm(sA, K, De, swk1, sbk1, kd, sHk, singa::kEpiSsp);
    singa::block_gemm(sA, K, De, swv1, sbv1, vd, sHv, singa::kEpiSsp);
    __syncthreads();
    singa::block_gemm(sHk, K, kd, swk2, sbk2, kd, sWk, singa::kEpiNone);
    singa::block_gemm(sHv, K, vd, swv2, sbv2, vd, sA, singa::kEpiNone);  // the smear is dead now
    __syncthreads();

    // scores: one thread per (slot, head), reading its kd key channels of
    // the neighbour row in 16-byte loads that are all in flight at once
    for (int job = tid; job < K * H; job += blockDim.x) {
      const int p = job / H, h = job % H;
      const float* krow = kk + (base + sidx[p]) * HK + h * kd;
      const float* qr = sq + h * kd;
      const float* wr = sWk + p * kd;
      float part = 0.f;
      if (vec4) {
        for (int d = 0; d < kd; d += 4) {
          const float4 kv = __ldg(reinterpret_cast<const float4*>(krow + d));
          const float4 qv = *reinterpret_cast<const float4*>(qr + d);
          const float4 wv = *reinterpret_cast<const float4*>(wr + d);
          part = fmaf(qv.x * wv.x, kv.x, part);
          part = fmaf(qv.y * wv.y, kv.y, part);
          part = fmaf(qv.z * wv.z, kv.z, part);
          part = fmaf(qv.w * wv.w, kv.w, part);
        }
      } else {
        for (int d = 0; d < kd; ++d) part = fmaf(qr[d] * wr[d], krow[d], part);
      }
      sS[p * H + h] = smask[p] != 0.f ? part * scale : -1e9f;
    }
    __syncthreads();

    // softmax over the K slots and the self slot: one warp per head
    for (int h = warp; h < H; h += nwarps) {
      const float sd = ds[node * H + h];
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
    __syncthreads();

    // aggregate: threads over (value channel, slice of the slots), neighbour
    // rows by index; the slices' partial sums meet in shared memory (sHv is
    // dead by now)
    const int S = max(1, min((int)blockDim.x / HV, K / H));
    for (int t = tid; t < HV * S; t += blockDim.x) {
      const int c = t % HV, sl = t / HV;
      const int h = c / vd, d = c % vd;
      float acc = 0.f;
#pragma unroll 4
      for (int p = sl; p < K; p += S)
        acc = fmaf(sS[p * H + h] * sA[p * vd + d], __ldg(vv + (base + sidx[p]) * HV + c), acc);
      sHv[sl * HV + c] = acc;
    }
    __syncthreads();
    for (int c = tid; c < HV; c += blockDim.x) {
      float acc = 0.f;
      for (int sl = 0; sl < S; ++sl) acc += sHv[sl * HV + c];
      out[node * HV + c] = acc + sAd[c / vd] * dval[node * HV + c];
    }
  }
}

}  // namespace

extern "C" int neighbor_attn_f32(const float* qt, const float* k, const float* v,
                                 const int* nbr, const unsigned char* nmask,
                                 const float* dist, const float* ds, const float* dval,
                                 const float* centers, const float* wk1, const float* bk1,
                                 const float* wk2, const float* bk2, const float* wv1,
                                 const float* bv1, const float* wv2, const float* bv2,
                                 float coeff, float* out, int B, int N, int K, int H,
                                 int kd, int vd, int De, void* stream) {
  if (B < 1 || N < 1 || K < 1 || H < 1 || kd < 1 || vd < 1 || De < 1)
    return (int)cudaErrorInvalidValue;
  const size_t floats = (size_t)De * kd + kd + (size_t)kd * kd + kd + (size_t)De * vd + vd +
                        (size_t)vd * vd + vd + De + (size_t)K * (De > vd ? De : vd) +
                        2 * (size_t)K * kd + (size_t)K * vd + (size_t)K * H + H +
                        (size_t)H * kd + 3 * (size_t)K;
  const size_t smem = floats * sizeof(float);
  cudaError_t err = singa::allow_smem(neighbor_attn_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = singa::persistent_grid(neighbor_attn_kernel, kThreads, smem, (long long)B * N);
  neighbor_attn_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      qt, k, v, nbr, nmask, dist, ds, dval, centers, wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2,
      coeff, out, B, N, K, H, kd, vd, De);
  return (int)cudaGetLastError();
}
