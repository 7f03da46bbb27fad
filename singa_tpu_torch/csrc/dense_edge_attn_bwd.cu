// K8b: dense-row edge-conditioned graph attention of the kNN encoder,
// backward.
//
// Replaces: singa_tpu/ops/pallas/dense_edge_attn.py::_dbwd
// (_dattn_bwd_kernel). The gradients are those csrc/encoder_attn.cuh sets
// out, with the N columns of a node's graph as its slots; dk[j] and dv[j]
// sum over the rows i of j's graph (a padded row's uniform softmax sends dv
// to every column). adj_dist and centers get no gradient, as in the TPU
// kernel, which evaluated every column and summed dk/dv as dense column
// sums. Here only the live pairs are evaluated; the rows with no live column
// come in closed form, per graph.
//
// What bounds it on the H100: each live pair costs K1b's ~60 kFLOP (the
// forward recomputed, the EdgeMLPs' backward, the weight-gradient
// products); a training microbatch (32 graphs x 384 nodes) has ~381 k live
// pairs, ~23 GFLOP (~0.34 ms at the 67 TFLOP/s float32 CUDA-core rate),
// against ~100 MB of node rows in and out and ~160 MB of per-pair scratch
// written and read once (~80 us at 3.35 TB/s). Float32 arithmetic bounds it.
//
// On the H100 (nvcc -Xptxas -v, sm_90a; cudaOccupancy at tile 96,
// kDenseBwdTile): the pair kernel takes 128 registers a thread, no spills,
// 209,392 bytes of shared memory a block, 1 resident block of 512 threads
// per SM; its 24 weight-gradient sums a thread need the registers. Two
// blocks per SM were timed and lost (PERF.md, section 6): capped at 64
// registers the sums spill, and with the sums in global memory instead the
// 31-column tile that fits two blocks puts most rows over one tile (a
// second forward per row). The other kernels take 32-40 registers and no
// shared memory to speak of.
//
// Design. Six kernels on the caller's stream, every sum in a fixed order
// (deterministic, no atomics):
//   1. graph_colsum_kernel: vsum [B, H*vd], v summed over each graph's rows.
//   2. encoder_attn.cuh's pair kernel in its kDense form over the live
//      lists: two sweeps per node (max, sum and dot online; then the
//      gradients), the tile's forward kept between them when the node is
//      one tile and recomputed otherwise; the closed form
//      for rows with no live column, whose a_dead goes to s_ad; per live
//      pair (its CSR index) w_k, w_v, a, dsc to scratch [E, kd + vd + 2H];
//      weight gradients as per-block rows of partial.
//   3. graph_colsum_kernel: G [B, H*vd], the closed-form rows' a_dead * g
//      summed per graph.
//   4. padded_wgrad_kernel: G's share of the v-EdgeMLP's weight gradients,
//      through the constant hidden of a dead column, as the last row of
//      partial; G becomes gw = w_v0 * G in place.
//   5. encoder_attn.cuh's csr_dkdv_kernel over the CSR transpose of the live
//      lists (K1b's gather), adding gw to every row's dv.
//   6. sum_rows_kernel: the rows of partial, in order.
//
// bfloat16 (dense_edge_attn_bwd_bf16): K8b·bf16's CUDA-core instance, the
// same six kernels at T = bf16, the storage type of qt, k, v, dval, g, dqt,
// dk, dv and ddv (adj, ds, dds, the scratch and the weight gradients stay
// float32), on the CUDA cores as at float32; it runs the lists with a row
// over 128 live columns, and the other widths. Every other bfloat16 call
// runs K8b·bf16's tensor-core instance, csrc/neighbor_attn_bwd.cu's
// dense_edge_attn_bwd_tc (ops/cuda/dense_edge_attn.py::bwd_bf16_instance
// picks by shape before the launch). It rounds where
// _dattn_bwd_kernel rounds at a bfloat16 dtype: the forward as K8's
// bfloat16 instance recomputes it (the smear, the weights, the hiddens),
// dw_k and dw_v before the EdgeMLPs' backward, dh after its sigmoid factor;
// dk and dv are summed in float32 and rounded once, as the TPU kernel's
// float32 column sums are cast once; vsum and G sum bfloat16 values in
// float32. The closed-form rows' share of the v-EdgeMLP's gradients takes
// the rounded hidden round(ssp(bv1)) and wv2; the TPU kernel rounds each
// (row, column) pair's dw_v and dh before it sums them, which a closed form
// over the graph's sums cannot, so that share differs from it by the
// rounding of those terms (averaged over the pairs).
#include "dense_closed.cuh"

namespace ea = singa::encoder_attn;

namespace {

// The six kernels on the caller's stream; T the storage type of qt, k, v,
// dval, g and the node gradients but dds.
template <class T>
int launch(const ea::ArgsT<T>& a, const ea::Dims& dm, const T* g, const int* pair_rows,
           const int* col_off, const int* col_pairs, T* dqt, T* dk, T* dv, float* dds, T* ddv,
           float* s_wk, float* s_wv, float* s_a, float* s_dsc, float* s_ad, float* gsum,
           float* partial, float* grads, int blocks, void* stream) {
  const ea::GradsT<T> o{g, dqt, dds, ddv, s_wk, s_wv, s_a, s_dsc, partial, s_ad};
  cudaStream_t st = (cudaStream_t)stream;
  const int HV = dm.H * dm.vd, P = dm.grad_floats();
  if (!dm.ok() || blocks < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = ea::launch_colsum(a.v, nullptr, a.vsum, dm.B, dm.N, HV, dm.vd, st);
  if (err != cudaSuccess) return (int)err;
  err = ea::launch_bwd_pair<ea::kDense>(a, dm, o, blocks, st);
  if (err != cudaSuccess) return (int)err;
  err = ea::launch_colsum(g, s_ad, gsum, dm.B, dm.N, HV, dm.vd, st);
  if (err != cudaSuccess) return (int)err;
  padded_wgrad_kernel<T><<<1, kPadThreads, 2 * dm.vd * sizeof(float), st>>>(
      a.bv1, a.wv2, a.bv2, a.vsum, gsum, partial + (long long)blocks * P, dm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = ea::launch_dkdv<ea::kDense>(a, dm, g, o, col_off, col_pairs, pair_rows, gsum, dk, dv, st);
  if (err != cudaSuccess) return (int)err;
  singa::sum_rows_kernel<<<(P + 255) / 256, 256, 0, st>>>(partial, grads, P, blocks + 1);
  return (int)cudaGetLastError();
}

}  // namespace

// Blocks of the pair kernel (one resident wave; bf16 != 0: its bfloat16
// instance's); the caller sizes the [blocks + 1, P] scratch buffer from it.
// Returns -1 for unsupported shapes.
extern "C" int dense_edge_attn_bwd_blocks(int B, int N, int H, int kd, int vd, int De, int bf16) {
  const ea::Dims d{B, N, N, H, kd, vd, De};
  return bf16 ? ea::bwd_blocks<ea::kDense, singa::bf16>(d) : ea::bwd_blocks<ea::kDense>(d);
}

// qt/k [B*N, H*kd], v [B*N, H*vd], adj [B*N, N], ds [B*N, H], dval and g
// [B*N, H*vd]. The live lists: lrow [B*N + 1], lcol and pair_rows [E] (each
// live pair's column and source row), their CSR transpose col_off
// [B*N + 1] and col_pairs [E], the row order lorder [B*N]. Scratch: s_wk
// [E, kd], s_wv [E, vd], s_a and s_dsc [E, H], s_ad [B*N, H], vsum and gsum
// [B, H*vd], partial [blocks + 1, P]. grads [P]: dwk1 dbk1 dwk2 dbk2 dwv1 dbv1 dwv2 dbv2, flat.
extern "C" int dense_edge_attn_bwd_f32(
    const float* qt, const float* k, const float* v, const float* adj, const float* ds,
    const float* dval, const float* centers, const float* wk1, const float* bk1,
    const float* wk2, const float* bk2, const float* wv1, const float* bv1, const float* wv2,
    const float* bv2, float coeff, const float* g, const int* lrow, const int* lcol,
    const int* pair_rows, const int* col_off, const int* col_pairs, const int* lorder,
    float* dqt, float* dk, float* dv, float* dds, float* ddv, float* s_wk, float* s_wv,
    float* s_a, float* s_dsc, float* s_ad, float* vsum, float* gsum, float* partial,
    float* grads, int B, int N, int H, int kd, int vd, int De, int blocks, void* stream) {
  const ea::Args a{qt, k, v, nullptr, nullptr, adj, ds, dval, centers, wk1, bk1, wk2,
                   bk2, wv1, bv1, wv2, bv2, coeff, lrow, lcol, lorder, vsum};
  return launch(a, ea::Dims{B, N, N, H, kd, vd, De}, g, pair_rows, col_off, col_pairs, dqt, dk,
                dv, dds, ddv, s_wk, s_wv, s_a, s_dsc, s_ad, gsum, partial, grads, blocks, stream);
}

// K8b's bfloat16 instance: qt, k, v, dval, g, dqt, dk, dv and ddv bfloat16;
// the rest, the lists, the scratch and grads as dense_edge_attn_bwd_f32's.
extern "C" int dense_edge_attn_bwd_bf16(
    const void* qt, const void* k, const void* v, const float* adj, const float* ds,
    const void* dval, const float* centers, const float* wk1, const float* bk1,
    const float* wk2, const float* bk2, const float* wv1, const float* bv1, const float* wv2,
    const float* bv2, float coeff, const void* g, const int* lrow, const int* lcol,
    const int* pair_rows, const int* col_off, const int* col_pairs, const int* lorder,
    void* dqt, void* dk, void* dv, float* dds, void* ddv, float* s_wk, float* s_wv,
    float* s_a, float* s_dsc, float* s_ad, float* vsum, float* gsum, float* partial,
    float* grads, int B, int N, int H, int kd, int vd, int De, int blocks, void* stream) {
  using singa::bf16;
  const ea::ArgsT<bf16> a{(const bf16*)qt, (const bf16*)k, (const bf16*)v, nullptr, nullptr,
                          adj, ds, (const bf16*)dval, centers, wk1, bk1, wk2, bk2, wv1, bv1,
                          wv2, bv2, coeff, lrow, lcol, lorder, vsum};
  return launch(a, ea::Dims{B, N, N, H, kd, vd, De}, (const bf16*)g, pair_rows, col_off,
                col_pairs, (bf16*)dqt, (bf16*)dk, (bf16*)dv, dds, (bf16*)ddv, s_wk, s_wv, s_a,
                s_dsc, s_ad, gsum, partial, grads, blocks, stream);
}

// Resident blocks per SM of the kernel at these widths (bf16 != 0: its
// bfloat16 instance), its shared memory per block in *smem_bytes and its
// columns per tile in *tile (-1: over the card's limit).
extern "C" int dense_edge_attn_bwd_residency(int N, int H, int kd, int vd, int De, int bf16,
                                             int* smem_bytes, int* tile) {
  const ea::Dims d{1, N, N, H, kd, vd, De};
  return bf16 ? ea::residency<ea::kDense, true, singa::bf16>(d, smem_bytes, tile)
              : ea::residency<ea::kDense, true>(d, smem_bytes, tile);
}
