// K8b: dense-row edge-conditioned graph attention of the kNN encoder,
// backward.
//
// Replaces: singa_tpu/ops/pallas/dense_edge_attn.py::_dbwd
// (_dattn_bwd_kernel). The gradients are those csrc/encoder_attn.cuh sets
// out, with the N columns of a node's graph as its slots; dk[j] and dv[j]
// sum over the rows i of j's graph, every column included (a padded row's
// uniform softmax sends dv to all of them). adj_dist and centers get no
// gradient, as in the TPU kernel.
//
// What bounds it on the H100: each (row, column) pair costs K1b's ~60 kFLOP
// per slot plus a second forward (the softmax needs the row's max, sum and
// dot before any pair's gradient), ~83 kFLOP; at the training microbatch
// (32 graphs x 384 nodes, 4.7 M pairs) ~390 GFLOP over every pair, far less
// over what the data needs (the live pairs, and per graph the padded rows'
// column sums). The scratch below is ~2 GB written and read once (~1.2 ms
// at 3.35 TB/s). Float32 arithmetic bounds it.
//
// Design. Three kernels, every sum in a fixed order (deterministic, no
// atomics):
//   1. encoder_attn.cuh's pair kernel in its kDense form: two sweeps over a
//      node's column tiles (max, sum and dot online; then the gradients),
//      per-pair scratch, weight gradients as per-block rows.
//   2. column-sum kernel: dk[j] and dv[j] are the dense transpose, a plain
//      sum over the rows i of j's graph in order (no CSR: every row names
//      every column).
//   3. sum_rows_kernel: the blocks' weight-gradient rows, in block order.
#include "encoder_attn.cuh"

namespace ea = singa::encoder_attn;

namespace {

constexpr int kColThreads = 128;

// dk and dv of column row j: the pairs (i, j) of its graph, rows i in order.
__global__ void __launch_bounds__(kColThreads)
dense_edge_attn_bwd_colsum_kernel(const float* __restrict__ qt, const float* __restrict__ gin,
                                  const float* __restrict__ s_wk, const float* __restrict__ s_wv,
                                  const float* __restrict__ s_a, const float* __restrict__ s_dsc,
                                  float* __restrict__ dk, float* __restrict__ dv, long long rows,
                                  ea::Dims dm) {
  const int N = dm.N, H = dm.H, kd = dm.kd, vd = dm.vd;
  const int HK = H * kd, HV = H * vd;
  for (long long j = blockIdx.x; j < rows; j += gridDim.x) {
    const long long base = (j / N) * N, col = j - base;
    for (int c = threadIdx.x; c < HK + HV; c += blockDim.x) {
      float acc = 0.f;
      if (c < HK) {
        const int h = c / kd, d = c % kd;
        for (int i = 0; i < N; ++i) {
          const long long s = (base + i) * N + col;  // the pair (row base + i, column j)
          acc = fmaf(s_dsc[s * H + h] * s_wk[s * kd + d], __ldg(qt + (base + i) * HK + c), acc);
        }
        dk[j * HK + c] = acc;
      } else {
        const int cv = c - HK, h = cv / vd, d = cv % vd;
        for (int i = 0; i < N; ++i) {
          const long long s = (base + i) * N + col;
          acc = fmaf(s_a[s * H + h] * s_wv[s * vd + d], __ldg(gin + (base + i) * HV + cv), acc);
        }
        dv[j * HV + cv] = acc;
      }
    }
  }
}

}  // namespace

// Blocks of the pair kernel (one resident wave); the caller sizes the
// [blocks, P] scratch buffer from it. Returns -1 for unsupported shapes.
extern "C" int dense_edge_attn_bwd_blocks(int B, int N, int H, int kd, int vd, int De) {
  return ea::bwd_blocks<ea::kDense>(ea::Dims{B, N, N, H, kd, vd, De});
}

// qt/k [B*N, H*kd], v [B*N, H*vd], adj [B*N, N], ds [B*N, H], dval and g
// [B*N, H*vd]. Scratch: s_wk [B*N*N, kd], s_wv [B*N*N, vd], s_a and s_dsc
// [B*N*N, H], partial [blocks, P]. grads [P]: dwk1 dbk1 dwk2 dbk2 dwv1 dbv1
// dwv2 dbv2, flat.
extern "C" int dense_edge_attn_bwd_f32(
    const float* qt, const float* k, const float* v, const float* adj, const float* ds,
    const float* dval, const float* centers, const float* wk1, const float* bk1,
    const float* wk2, const float* bk2, const float* wv1, const float* bv1, const float* wv2,
    const float* bv2, float coeff, const float* g, float* dqt, float* dk, float* dv, float* dds,
    float* ddv, float* s_wk, float* s_wv, float* s_a, float* s_dsc, float* partial,
    float* grads, int B, int N, int H, int kd, int vd, int De, int blocks, void* stream) {
  const ea::Args a{qt, k, v, nullptr, nullptr, adj, ds, dval, centers,
                   wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2, coeff};
  const ea::Dims dm{B, N, N, H, kd, vd, De};
  const ea::Grads o{g, dqt, dds, ddv, s_wk, s_wv, s_a, s_dsc, partial};
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = ea::launch_bwd_pair<ea::kDense>(a, dm, o, blocks, st);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)B * N;
  const int cgrid = singa::persistent_grid(dense_edge_attn_bwd_colsum_kernel, kColThreads, 0, rows);
  dense_edge_attn_bwd_colsum_kernel<<<cgrid, kColThreads, 0, st>>>(
      qt, g, s_wk, s_wv, s_a, s_dsc, dk, dv, rows, dm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int P = dm.grad_floats();
  singa::sum_rows_kernel<<<(P + 255) / 256, 256, 0, st>>>(partial, grads, P, blocks);
  return (int)cudaGetLastError();
}
