// K8: dense-row edge-conditioned graph attention of the kNN encoder, forward.
//
// Replaces: singa_tpu/ops/pallas/dense_edge_attn.py::dense_edge_attn
// (_dattn_fwd_kernel), selected by SINGA_TPU_DENSE_ATTN. K1's function over
// every column j of node i's graph instead of its K neighbour slots: the
// kernel is csrc/encoder_attn.cuh's in its kDense form, walking the row in
// column tiles of 96 with an online softmax. adj = adj_dist [B*N, N] carries
// the distance where j is adjacent to i and BIG = 1e9 elsewhere (the diagonal
// and padded nodes included); a column is live where adj < BIG / 2. The
// adjacency is the untruncated one: a node whose in-degree exceeds K attends
// over more columns here than K1 gives it. A padded node (no live column,
// diag score -1e9) has a uniform softmax over all N + 1 slots, so every
// column's w_v * v reaches its output; every column is evaluated, as the TPU
// kernel evaluates it.
//
// What bounds it on the H100: each column costs K1's ~23 kFLOP per slot,
// almost all in the two EdgeMLPs; at the training microbatch (32 graphs x
// 384 nodes) ~108 GFLOP over all 4.7 M (row, column) pairs, 4x K1's slots.
// What the data needs is far less: the live pairs (~8 % of the grid) and,
// for the padded rows, one column sum of v per graph (their EdgeMLPs all see
// the smear of BIG, one constant). Node rows and adj_dist are ~40 MB;
// float32 arithmetic bounds it.
#include "encoder_attn.cuh"

namespace ea = singa::encoder_attn;

// qt/k [B*N, H*kd], v [B*N, H*vd], adj [B*N, N], ds [B*N, H], dval and out
// [B*N, H*vd]; EdgeMLP weights in the flax [in, out] layout.
extern "C" int dense_edge_attn_f32(const float* qt, const float* k, const float* v,
                                   const float* adj, const float* ds, const float* dval,
                                   const float* centers, const float* wk1, const float* bk1,
                                   const float* wk2, const float* bk2, const float* wv1,
                                   const float* bv1, const float* wv2, const float* bv2,
                                   float coeff, float* out, int B, int N, int H, int kd, int vd,
                                   int De, void* stream) {
  const ea::Args a{qt, k, v, nullptr, nullptr, adj, ds, dval, centers,
                   wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2, coeff};
  return ea::launch_fwd<ea::kDense>(a, ea::Dims{B, N, N, H, kd, vd, De}, out, stream);
}
