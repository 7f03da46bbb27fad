// K1: neighbour-list graph attention of the kNN encoder, forward; and K7,
// the same function from neighbour rows gathered outside the kernel.
//
// Replaces: singa_tpu/ops/pallas/neighbor_attn.py::neighbor_attn_fused
// (_attn_fwd_kernel) and ::neighbor_attn_hybrid (_hybrid_pallas_fwd,
// _attn_fwd_kernel with gathered=True), selected by SINGA_TPU_HYBRID_ATTN.
// The kernel is csrc/encoder_attn.cuh's, in its kList and kGathered forms:
// a node's K slots are one tile. K7 reads k[nbr[p]] and v[nbr[p]] from k_nb
// [B*N, K, H*kd] and v_nb [B*N, K, H*vd] (row node*K + p), gathered by
// torch.gather before the launch, and takes no nbr.
//
// What bounds it on the H100: at the main path's shapes (8 pockets x 384
// nodes, K = 96 slots, De = 64, H = 4, kd = 32, vd = 64) each pair costs
// ~23 kFLOP, almost all in the two EdgeMLPs: ~6.9 GFLOP over every slot,
// ~2.1 GFLOP over the live pairs of the val pockets, against ~15 MB of node
// rows in and out. Float32 arithmetic bounds K1 (~31 us for the live pairs
// at the 67 TFLOP/s float32 CUDA-core rate, memory ~5 us). K7 moves ~1.8 GB
// of gathered rows per training microbatch call (32 x 384 nodes x 96 slots
// x 384 channels, float32) where K1 reads the ~19 MB of node rows by index,
// so memory bounds K7 (~0.55 ms at 3.35 TB/s); the gathers that feed it are
// library calls outside the kernel.
#include "encoder_attn.cuh"

namespace ea = singa::encoder_attn;

// K1: k [B*N, H*kd] and v [B*N, H*vd] read by nbr [B*N, K].
extern "C" int neighbor_attn_f32(const float* qt, const float* k, const float* v,
                                 const int* nbr, const unsigned char* nmask,
                                 const float* dist, const float* ds, const float* dval,
                                 const float* centers, const float* wk1, const float* bk1,
                                 const float* wk2, const float* bk2, const float* wv1,
                                 const float* bv1, const float* wv2, const float* bv2,
                                 float coeff, float* out, int B, int N, int K, int H,
                                 int kd, int vd, int De, void* stream) {
  const ea::Args a{qt, k, v, nbr, nmask, dist, ds, dval, centers,
                   wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2, coeff};
  return ea::launch_fwd<ea::kList>(a, ea::Dims{B, N, K, H, kd, vd, De}, out, stream);
}

// K7: k_nb [B*N, K, H*kd] and v_nb [B*N, K, H*vd], the slots' rows gathered.
extern "C" int neighbor_attn_hybrid_f32(const float* qt, const float* k_nb, const float* v_nb,
                                        const unsigned char* nmask, const float* dist,
                                        const float* ds, const float* dval,
                                        const float* centers, const float* wk1,
                                        const float* bk1, const float* wk2, const float* bk2,
                                        const float* wv1, const float* bv1, const float* wv2,
                                        const float* bv2, float coeff, float* out, int B, int N,
                                        int K, int H, int kd, int vd, int De, void* stream) {
  const ea::Args a{qt, k_nb, v_nb, nullptr, nmask, dist, ds, dval, centers,
                   wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2, coeff};
  return ea::launch_fwd<ea::kGathered>(a, ea::Dims{B, N, K, H, kd, vd, De}, out, stream);
}
