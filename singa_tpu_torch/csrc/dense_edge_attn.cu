// K8: dense-row edge-conditioned graph attention of the kNN encoder, forward.
//
// Replaces: singa_tpu/ops/pallas/dense_edge_attn.py::dense_edge_attn
// (_dattn_fwd_kernel), selected by SINGA_TPU_DENSE_ATTN. K1's function over
// every column j of node i's graph instead of its K neighbour slots.
// adj = adj_dist [B*N, N] carries the distance where j is adjacent to i and
// BIG = 1e9 elsewhere (the diagonal and padded nodes included); a column is
// live where adj < BIG / 2. The adjacency is the untruncated one: a node
// whose in-degree exceeds K attends over more columns here than K1 gives it.
//
// The TPU kernel evaluated every column, because dense [TI, N] tiles are
// what feed its matrix unit. Here the kernel is csrc/encoder_attn.cuh's in
// its kDense form: a row walks its live columns only (lists built once per
// graph, ragged tiles, online softmax), since a dead column of a row with a
// live one weighs exactly 0; a row with no live column (a padded node, whose
// softmax is uniform over all N + 1 slots, or an isolated one) takes the
// closed form from its graph's column sum of v, summed first by
// graph_colsum_kernel.
//
// What bounds it on the H100: each live pair costs K1's ~23 kFLOP, almost
// all in the two EdgeMLPs; a training microbatch (32 graphs x 384 nodes)
// has ~381 k live pairs of 4.7 M, ~9.1 GFLOP (~0.14 ms at the 67 TFLOP/s
// float32 CUDA-core rate), against ~40 MB of node rows and adj_dist (~12 us
// at 3.35 TB/s): float32 arithmetic bounds it.
//
// On the H100 (nvcc -Xptxas -v, sm_90a; cudaOccupancy at tile 64,
// kDenseFwdTile): 64 registers a thread (the __launch_bounds__ cap for two
// blocks; 16 bytes of spill stores, 32 of loads), 98,864 bytes of shared
// memory a block, 2 resident blocks of 512 threads per SM. Timed against
// tiles 32, 48 and 96 (96: 124 KB, one block) and against staging each
// tile's k and v rows in shared memory with cp.async while its EdgeMLPs
// run (two blocks need tile 32 then), tile 64 with rows read by __ldg was
// the fastest (PERF.md, section 6).
//
// bfloat16 (dense_edge_attn_bf16): K8's bfloat16 instance is the same kernel
// at VT = bf16, the storage type of qt, k, v, dval and out (adj, ds, the
// centers, the EdgeMLP weights and vsum stay float32), on the CUDA cores as
// at float32. It rounds where _dattn_fwd_kernel rounds at a bfloat16 dtype,
// which is not where K1 rounds: the TPU kernel sums the heads' lanes in
// float32 instead of a matrix product, so only the smear, the EdgeMLP
// weights and their hiddens are rounded; w_k, w_v, the score terms and the
// softmax weights stay float32, and the output is rounded once. A row with
// no live column takes its closed form from vsum (v's bfloat16 values
// summed in float32) and w_v0 = round(ssp(bv1)) @ round(wv2) + bv2 (a dead
// column's smear rounds to -0).
#include "encoder_attn.cuh"

namespace ea = singa::encoder_attn;

// qt/k [B*N, H*kd], v [B*N, H*vd], adj [B*N, N], ds [B*N, H], dval and out
// [B*N, H*vd]; EdgeMLP weights in the flax [in, out] layout; lrow [B*N + 1],
// lcol [E] and lorder [B*N] the live lists; vsum [B, H*vd] scratch.
extern "C" int dense_edge_attn_f32(const float* qt, const float* k, const float* v,
                                   const float* adj, const float* ds, const float* dval,
                                   const float* centers, const float* wk1, const float* bk1,
                                   const float* wk2, const float* bk2, const float* wv1,
                                   const float* bv1, const float* wv2, const float* bv2,
                                   float coeff, const int* lrow, const int* lcol,
                                   const int* lorder, float* vsum, float* out, int B, int N,
                                   int H, int kd, int vd, int De, void* stream) {
  const ea::Args a{qt, k, v, nullptr, nullptr, adj, ds, dval, centers, wk1, bk1, wk2,
                   bk2, wv1, bv1, wv2, bv2, coeff, lrow, lcol, lorder, vsum};
  return ea::launch_fwd<ea::kDense>(a, ea::Dims{B, N, N, H, kd, vd, De}, out, stream);
}

// K8's bfloat16 instance: qt, k, v, dval and out bfloat16; the rest as
// dense_edge_attn_f32's.
extern "C" int dense_edge_attn_bf16(const void* qt, const void* k, const void* v,
                                    const float* adj, const float* ds, const void* dval,
                                    const float* centers, const float* wk1, const float* bk1,
                                    const float* wk2, const float* bk2, const float* wv1,
                                    const float* bv1, const float* wv2, const float* bv2,
                                    float coeff, const int* lrow, const int* lcol,
                                    const int* lorder, float* vsum, void* out, int B, int N,
                                    int H, int kd, int vd, int De, void* stream) {
  using singa::bf16;
  const ea::ArgsT<bf16> a{(const bf16*)qt, (const bf16*)k, (const bf16*)v, nullptr, nullptr,
                          adj, ds, (const bf16*)dval, centers, wk1, bk1, wk2, bk2, wv1, bv1,
                          wv2, bv2, coeff, lrow, lcol, lorder, vsum};
  return ea::launch_fwd<ea::kDense, bf16>(a, ea::Dims{B, N, N, H, kd, vd, De}, (bf16*)out,
                                          stream);
}

// Resident blocks per SM of the kernel at these widths (bf16 != 0: its
// bfloat16 instance), its shared memory per block in *smem_bytes and its
// columns per tile in *tile (-1: over the card's limit).
extern "C" int dense_edge_attn_residency(int N, int H, int kd, int vd, int De, int bf16,
                                         int* smem_bytes, int* tile) {
  const ea::Dims d{1, N, N, H, kd, vd, De};
  return bf16 ? ea::residency<ea::kDense, false, singa::bf16>(d, smem_bytes, tile)
              : ea::residency<ea::kDense, false>(d, smem_bytes, tile);
}
