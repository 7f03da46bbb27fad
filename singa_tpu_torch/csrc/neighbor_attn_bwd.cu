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
//   1. encoder_attn.cuh's pair kernel in its kList / kGathered form: a
//      node's K slots are one tile, so its second sweep reuses the first's
//      buffers.
//   2. encoder_attn.cuh's csr_dkdv_kernel, the same for K1b, K7b and K8b
//      (the TPU's hybrid backward kept its one-hot transpose matmul): dk and
//      dv are the one-hot transpose of the slots, over every slot, masked
//      ones included (a padded node's softmax is uniform and sends dv to the
//      nodes its masked slots name). The adjacency is not symmetric after
//      the top-K cut, so the transpose is built from nbr itself: the flat
//      slot keys sorted stably into CSR order once per graph
//      (build_neighbor_graph, beside nbr), and one block per destination
//      row sums its incoming slots in that order, reading the source node's
//      qt and g rows by index.
//   3. sum_rows_kernel: the blocks' weight-gradient rows, in block order.
#include "encoder_attn.cuh"

namespace ea = singa::encoder_attn;

namespace {

template <int F>
int launch(const ea::Args& a, const ea::Dims& dm, const float* g, const int* offsets,
           const int* slots, float* dqt, float* dk, float* dv, float* dds, float* ddv,
           float* s_wk, float* s_wv, float* s_a, float* s_dsc, float* partial, float* grads,
           int blocks, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const ea::Grads o{g, dqt, dds, ddv, s_wk, s_wv, s_a, s_dsc, partial};
  cudaError_t err = ea::launch_bwd_pair<F>(a, dm, o, blocks, st);
  if (err != cudaSuccess) return (int)err;
  err = ea::launch_dkdv<F>(a, dm, g, o, offsets, slots, nullptr, nullptr, dk, dv, st);
  if (err != cudaSuccess) return (int)err;
  const int P = dm.grad_floats();
  singa::sum_rows_kernel<<<(P + 255) / 256, 256, 0, st>>>(partial, grads, P, blocks);
  return (int)cudaGetLastError();
}

}  // namespace

// Blocks of the pair kernel (one resident wave); the caller sizes the
// [blocks, P] scratch buffer from it. Returns -1 for unsupported shapes.
extern "C" int neighbor_attn_bwd_blocks(int B, int N, int K, int H, int kd, int vd, int De) {
  return ea::bwd_blocks<ea::kList>(ea::Dims{B, N, K, H, kd, vd, De});
}

extern "C" int neighbor_attn_hybrid_bwd_blocks(int B, int N, int K, int H, int kd, int vd, int De) {
  return ea::bwd_blocks<ea::kGathered>(ea::Dims{B, N, K, H, kd, vd, De});
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
  const ea::Args a{qt, k, v, nbr, nmask, dist, ds, dval, centers,
                   wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2, coeff};
  return launch<ea::kList>(a, ea::Dims{B, N, K, H, kd, vd, De}, g, offsets, slots, dqt, dk, dv,
                           dds, ddv, s_wk, s_wv, s_a, s_dsc, partial, grads, blocks, stream);
}

// K7b: as K1b with k_nb [B*N, K, H*kd] and v_nb [B*N, K, H*vd] in place of k
// and v; nbr enters only through its transpose (offsets, slots).
extern "C" int neighbor_attn_hybrid_bwd_f32(
    const float* qt, const float* k_nb, const float* v_nb, const unsigned char* nmask,
    const float* dist, const float* ds, const float* dval, const float* centers,
    const float* wk1, const float* bk1, const float* wk2, const float* bk2, const float* wv1,
    const float* bv1, const float* wv2, const float* bv2, float coeff, const float* g,
    const int* offsets, const int* slots, float* dqt, float* dk, float* dv, float* dds,
    float* ddv, float* s_wk, float* s_wv, float* s_a, float* s_dsc, float* partial,
    float* grads, int B, int N, int K, int H, int kd, int vd, int De, int blocks,
    void* stream) {
  const ea::Args a{qt, k_nb, v_nb, nullptr, nmask, dist, ds, dval, centers,
                   wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2, coeff};
  return launch<ea::kGathered>(a, ea::Dims{B, N, K, H, kd, vd, De}, g, offsets, slots, dqt, dk,
                               dv, dds, ddv, s_wk, s_wv, s_a, s_dsc, partial, grads, blocks,
                               stream);
}
