// K6b: the fused SO(2) edge-attention chain of GraphAttention, backward.
//
// Replaces: singa_tpu/ops/pallas/so2_attn.py::_bwd (_bwd_kernel). With the
// forward of csrc/so2_attn.cu recomputed up to mid (never z), and the
// cotangents dz_s of the conv-2 sections and dextra of the extra channels:
//   dw2_s = mid_s^T dz_s;  db2 = sum_e dz_0;  dmid_s = dz_s w2_s^T
//   dgate = silu'(gate) * dmid[0];  dmid[0] := 0
//   dh    = tg^T (silu'(tg h) * fg dmid);  dy = [dh | dextra + dgate at alpha_ch:]
//   dw1_s = mpr_s^T dy_s;  db1 = sum_e dy_0;  dmpr_s = dy_s w1_s^T
//   drad  = dmpr * mp0;  dx = D^T (dmpr * rad)
// (mp0 the rotated message before the modulation, mpr = mp0 * rad.) phi,
// beta and the grid matrices get no gradient.
//
// What bounds it on the H100: per edge the recomputed conv 1 and grid
// (2.56 + 1.04 MFLOP), the four weight-shaped products dw2, dmid (8.40
// each), dw1, dmpr (2.56 each), the backward grid (1.04) and the two
// rotations: ~26.7 MFLOP against ~24 KB, ~12.7 ms of float32 work at a
// training microbatch's 31,744 stage-1 edges. The five products (24.5
// MFLOP of it) run on the tensor cores as three-product split TF32: 3 x 777
// GFLOP, 4.7 ms at the dense TF32 rate. Arithmetic bounds it.
//
// Design: K2b's split. The stages of the forward (csrc/so2_chain.cuh)
// write the rotated message, the conv-1 output and mid; the backward grid
// kernel writes the conv-1 output cotangent; the cotangent products are the
// forward's GEMM with the weight read transposed (B stored [n][k]). The
// weight gradients
// (5.5 M floats at the default Config, 22 MB) are sums over every edge of
// a_e^T b_e: the same GEMM with the edge dimension as its depth, split
// over edge slices so that the card fills (each slice's tile of the
// gradient in registers, written once to its own partial buffer), the
// partials then added in slice order by sum_rows_kernel; the bias gradients
// are column sums in edge slices, added the same way. No atomics: the result
// does not depend on the launch. ~2.3 GB of scratch at the training
// microbatch (the per-edge operands of the weight products), on an 80 GB
// card.
//
// K6b·bf16 (so2_attn_bwd_bf16): the same stages at bfloat16 storage,
// rounding where the Pallas _bwd_kernel rounds at a bfloat16 x
// (so2_chain.cuh): the modulated message, mid and dy in bfloat16 (the
// GEMM's operands, bfloat16 m16n8k16 mma.sync), the rotated message mp0,
// the conv-1 output, dmid and dmpr in float32, and section 0 of dy also in
// float32 for db1; the grid stages (the recomputed forward's and the
// backward's) on the tensor cores, K3·bf16's and K3b·bf16's chains
// (grid_fwd_tc_kernel, grid_bwd_tc_kernel); the weight gradients' partial
// sums and their slice sums float32, returned float32 (the parameters'
// dtype).
#include <algorithm>

#include "so2_chain.cuh"

namespace {

using singa::bf16;
using singa::so2::Dims;
using singa::so2::kSecs;

struct Scratch {
  long long mp0, mpr, y1, mid, dmid, dy1, dmpr, partial, total;
};

// The partial buffer serves each weight gradient and bias sum in turn.
inline Scratch scratch_layout(const Dims& d) {
  const long long E = d.E, msg = E * d.n_trunc * d.C, hid = E * d.n_trunc * d.H;
  long long part = (long long)singa::so2::col_splits(d.E) * std::max(d.out1[0], d.rows[0] * d.F2);
  for (int s = 0; s < kSecs; ++s) {
    const long long m1 = (long long)d.rows[s] * d.C, n1 = d.out1[s];
    const long long m2 = (long long)d.rows[s] * d.H, n2 = (long long)d.rows[s] * d.F2;
    part = std::max(part, singa::so2::grad_splits((int)m1, (int)n1, d.E) * m1 * n1);
    part = std::max(part, singa::so2::grad_splits((int)m2, (int)n2, d.E) * m2 * n2);
  }
  Scratch s;
  s.mp0 = 0;
  s.mpr = s.mp0 + msg;
  s.y1 = s.mpr + msg;
  s.mid = s.y1 + E * d.y1_width;
  s.dmid = s.mid + hid;
  s.dy1 = s.dmid + hid;
  s.dmpr = s.dy1 + E * d.y1_width;
  s.partial = s.dmpr + msg;
  s.total = s.partial + part;
  return s;
}

// Byte offsets of the bfloat16 backward's scratch: the rounded weights, then
// mp0 (f32), mpr (bf16), y1 (f32), mid (bf16), dmid (f32), dy1 (bf16), dy0
// [E, out1[0]] (f32), dmpr (f32), the float32 partial sums (as large as the
// float32 instance's).
struct Bf16Bwd {
  singa::so2::Bf16Weights w;
  long long mp0, mpr, y1, mid, dmid, dy1, dy0, dmpr, partial, total;
};

inline Bf16Bwd bf16_bwd_layout(const Dims& d) {
  using singa::so2::round_up256;
  const Scratch f = scratch_layout(d);
  const long long E = d.E, msg = E * d.n_trunc * d.C, hid = E * d.n_trunc * d.H;
  Bf16Bwd s;
  s.w = singa::so2::bf16_weights_layout(d);
  s.mp0 = s.w.end;
  s.mpr = round_up256(s.mp0 + 4 * msg);
  s.y1 = round_up256(s.mpr + 2 * msg);
  s.mid = round_up256(s.y1 + 4 * E * d.y1_width);
  s.dmid = round_up256(s.mid + 2 * hid);
  s.dy1 = round_up256(s.dmid + 4 * hid);
  s.dy0 = round_up256(s.dy1 + 2 * E * d.y1_width);
  s.dmpr = round_up256(s.dy0 + 4 * E * d.out1[0]);
  s.partial = round_up256(s.dmpr + 4 * msg);
  s.total = round_up256(s.partial + 4 * (f.total - f.partial));
  return s;
}

// Offsets (floats) of each weight and bias gradient in `grads`: dw1_0..2,
// db1, dw2_0..2, db2.
struct GradOffsets {
  long long w1[kSecs], w2[kSecs], b1, b2;
};

inline GradOffsets grad_offsets(const Dims& d) {
  GradOffsets g;
  long long off = 0;
  for (int s = 0; s < kSecs; ++s) {
    g.w1[s] = off;
    off += (long long)d.rows[s] * d.C * d.out1[s];
  }
  g.b1 = off;
  off += d.out1[0];
  for (int s = 0; s < kSecs; ++s) {
    g.w2[s] = off;
    off += (long long)d.rows[s] * d.H * d.rows[s] * d.F2;
  }
  g.b2 = off;
  return g;
}

}  // namespace

// Floats of scratch the backward needs; -1 for shapes it does not take.
extern "C" long long so2_attn_bwd_scratch_floats(int E, int lmax, int mmax, int C, int H, int F2,
                                                 int extra, int alpha_ch, int G) {
  const Dims d = singa::so2::make_dims(E, lmax, mmax, C, H, F2, extra, alpha_ch, G);
  return singa::so2::dims_ok(d) ? scratch_layout(d).total : -1;
}

// grads: dw1_0, dw1_1, dw1_2, db1, dw2_0, dw2_1, dw2_2, db2, flat in that
// order. Returns cudaErrorInvalidValue for the shapes K6 does not take.
extern "C" int so2_attn_bwd_f32(const float* x, const float* rad, const float* phi,
                                const float* beta, const float* w10, const float* w11,
                                const float* w12, const float* b1, const float* w20,
                                const float* w21, const float* w22, const float* J,
                                const float* tg, const float* fg, const float* dz0,
                                const float* dz1, const float* dz2, const float* dextra,
                                float* dx, float* drad, float* grads, float* scratch, int E,
                                int lmax, int mmax, int C, int H, int F2, int extra, int alpha_ch,
                                int G, void* stream) {
  namespace so2 = singa::so2;
  const Dims d = so2::make_dims(E, lmax, mmax, C, H, F2, extra, alpha_ch, G);
  if (!so2::dims_ok(d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const Scratch sl = scratch_layout(d);
  float *mp0 = scratch + sl.mp0, *mpr = scratch + sl.mpr, *y1 = scratch + sl.y1;
  float *mid = scratch + sl.mid, *dmid = scratch + sl.dmid, *dy1 = scratch + sl.dy1;
  float *dmpr = scratch + sl.dmpr, *partial = scratch + sl.partial;
  const float* w1s[kSecs] = {w10, w11, w12};
  const float* w2s[kSecs] = {w20, w21, w22};
  const float* dzs[kSecs] = {dz0, dz1, dz2};
  const GradOffsets g = grad_offsets(d);
  const long long ldm = (long long)d.n_trunc * C, ldh = (long long)d.n_trunc * H;

  // the forward up to mid
  cudaError_t err = so2::rotate_fwd(x, rad, phi, beta, J, mp0, mpr, d, st);
  if (err != cudaSuccess) return (int)err;
  err = so2::forward_to_mid<float>(mpr, w1s, b1, tg, fg, y1, mid, nullptr, d, st);
  if (err != cudaSuccess) return (int)err;

  // conv 2: its weight and bias gradients, and dmid
  for (int s = 0; s < kSecs; ++s) {
    const int m2 = d.rows[s] * H, n2 = d.rows[s] * F2;
    err = so2::weight_grad(mid + d.row0[s] * H, ldh, dzs[s], n2, m2, n2, E, partial,
                           grads + g.w2[s], st);
    if (err != cudaSuccess) return (int)err;
    err = so2::gemm<false, true>(dzs[s], n2, w2s[s], n2, dmid + d.row0[s] * H, ldh, E, m2, n2,
                                 nullptr, 1, 0, st);
    if (err != cudaSuccess) return (int)err;
  }
  err = so2::col_sum(dz0, d.rows[0] * F2, E, d.rows[0] * F2, partial, grads + g.b2, st);
  if (err != cudaSuccess) return (int)err;

  // the S2 activation and the gate: the conv-1 output cotangent
  err = so2::grid_bwd(y1, dmid, dextra, tg, fg, dy1, d, st);
  if (err != cudaSuccess) return (int)err;

  // conv 1: its weight and bias gradients, and the message cotangent
  for (int s = 0; s < kSecs; ++s) {
    const int m1 = d.rows[s] * C, n1 = d.out1[s];
    err = so2::weight_grad(mpr + d.row0[s] * C, ldm, dy1 + d.y1_col[s], d.y1_width, m1, n1, E,
                           partial, grads + g.w1[s], st);
    if (err != cudaSuccess) return (int)err;
    err = so2::gemm<false, true>(dy1 + d.y1_col[s], d.y1_width, w1s[s], n1, dmpr + d.row0[s] * C,
                                 ldm, E, m1, n1, nullptr, 1, 0, st);
    if (err != cudaSuccess) return (int)err;
  }
  err = so2::col_sum(dy1, d.y1_width, E, d.out1[0], partial, grads + g.b1, st);
  if (err != cudaSuccess) return (int)err;

  // the radial modulation and the rotation
  return (int)so2::rotate_bwd(dmpr, rad, mp0, phi, beta, J, dx, drad, d, st);
}

// Bytes of scratch K6b·bf16 needs; -1 for shapes it does not take.
extern "C" long long so2_attn_bwd_bf16_scratch_bytes(int E, int lmax, int mmax, int C, int H,
                                                     int F2, int extra, int alpha_ch, int G) {
  const Dims d = singa::so2::make_dims(E, lmax, mmax, C, H, F2, extra, alpha_ch, G);
  return singa::so2::dims_ok(d) ? bf16_bwd_layout(d).total : -1;
}

// K6b·bf16: x, rad, dz0..dz2, dextra, dx and drad bfloat16; the weights,
// biases, angles, J, the grids and grads (laid out as so2_attn_bwd_f32's)
// float32; scratch of so2_attn_bwd_bf16_scratch_bytes, 256-byte aligned.
extern "C" int so2_attn_bwd_bf16(const void* x, const void* rad, const float* phi,
                                 const float* beta, const float* w10, const float* w11,
                                 const float* w12, const float* b1, const float* w20,
                                 const float* w21, const float* w22, const float* J,
                                 const float* tg, const float* fg, const void* dz0,
                                 const void* dz1, const void* dz2, const void* dextra, void* dx,
                                 void* drad, float* grads, void* scratch, int E, int lmax,
                                 int mmax, int C, int H, int F2, int extra, int alpha_ch, int G,
                                 void* stream) {
  namespace so2 = singa::so2;
  const Dims d = so2::make_dims(E, lmax, mmax, C, H, F2, extra, alpha_ch, G);
  if (!so2::dims_ok(d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const Bf16Bwd sl = bf16_bwd_layout(d);
  const GradOffsets g = grad_offsets(d);
  char* base = static_cast<char*>(scratch);
  float* mp0 = reinterpret_cast<float*>(base + sl.mp0);
  bf16* mpr = reinterpret_cast<bf16*>(base + sl.mpr);
  float* y1 = reinterpret_cast<float*>(base + sl.y1);
  bf16* mid = reinterpret_cast<bf16*>(base + sl.mid);
  float* dmid = reinterpret_cast<float*>(base + sl.dmid);
  bf16* dy1 = reinterpret_cast<bf16*>(base + sl.dy1);
  float* dy0 = reinterpret_cast<float*>(base + sl.dy0);
  float* dmpr = reinterpret_cast<float*>(base + sl.dmpr);
  float* partial = reinterpret_cast<float*>(base + sl.partial);
  const float* w1s[kSecs] = {w10, w11, w12};
  const float* w2s[kSecs] = {w20, w21, w22};
  const bf16* dzs[kSecs] = {static_cast<const bf16*>(dz0), static_cast<const bf16*>(dz1),
                            static_cast<const bf16*>(dz2)};
  bf16 *w1r[kSecs], *w2r[kSecs];
  const long long ldm = (long long)d.n_trunc * C, ldh = (long long)d.n_trunc * H;
  using F = so2::Bf16In<float>;

  // the weights rounded, then the forward up to mid
  cudaError_t err = so2::round_weights(w1s, w2s, base, sl.w, d, w1r, w2r, st);
  if (err != cudaSuccess) return (int)err;
  err = so2::rotate_fwd(static_cast<const bf16*>(x), static_cast<const bf16*>(rad), phi, beta, J,
                        mp0, mpr, d, st);
  if (err != cudaSuccess) return (int)err;
  err = so2::forward_to_mid<bf16>(mpr, w1r, b1, tg, fg, y1, mid, nullptr, d, st);
  if (err != cudaSuccess) return (int)err;

  // conv 2: its weight and bias gradients, and dmid (float32)
  for (int s = 0; s < kSecs; ++s) {
    const int m2 = d.rows[s] * H, n2 = d.rows[s] * F2;
    err = so2::weight_grad(static_cast<const bf16*>(mid + d.row0[s] * H), ldh, dzs[s], n2, m2, n2,
                           E, partial, grads + g.w2[s], st);
    if (err != cudaSuccess) return (int)err;
    err = so2::gemm<false, true, F>(dzs[s], n2, w2r[s], n2, dmid + d.row0[s] * H, ldh, E, m2, n2,
                                    nullptr, 1, 0, st);
    if (err != cudaSuccess) return (int)err;
  }
  err = so2::col_sum(dzs[0], d.rows[0] * F2, E, d.rows[0] * F2, partial, grads + g.b2, st);
  if (err != cudaSuccess) return (int)err;

  // the S2 activation and the gate: the conv-1 output cotangent
  err = so2::grid_bwd(y1, dmid, static_cast<const bf16*>(dextra), tg, fg, dy1, dy0, d, st);
  if (err != cudaSuccess) return (int)err;

  // conv 1: its weight and bias gradients, and the message cotangent (float32)
  for (int s = 0; s < kSecs; ++s) {
    const int m1 = d.rows[s] * C, n1 = d.out1[s];
    err = so2::weight_grad(static_cast<const bf16*>(mpr + d.row0[s] * C), ldm,
                           static_cast<const bf16*>(dy1 + d.y1_col[s]), d.y1_width, m1, n1, E,
                           partial, grads + g.w1[s], st);
    if (err != cudaSuccess) return (int)err;
    err = so2::gemm<false, true, F>(dy1 + d.y1_col[s], d.y1_width, w1r[s], n1,
                                    dmpr + d.row0[s] * C, ldm, E, m1, n1, nullptr, 1, 0, st);
    if (err != cudaSuccess) return (int)err;
  }
  err = so2::col_sum(dy0, d.out1[0], E, d.out1[0], partial, grads + g.b1, st);
  if (err != cudaSuccess) return (int)err;

  // the radial modulation and the rotation
  return (int)so2::rotate_bwd(dmpr, static_cast<const bf16*>(rad), mp0, phi, beta, J,
                              static_cast<bf16*>(dx), static_cast<bf16*>(drad), d, st);
}

// The same of K6b·bf16's backward grid stage (grid_bwd_tc_kernel).
extern "C" int so2_grid_bwd_bf16_residency(int lmax, int mmax, int C, int H, int F2, int extra,
                                           int alpha_ch, int G, int* smem_bytes, int* threads) {
  namespace so2 = singa::so2;
  const Dims d = so2::make_dims(1, lmax, mmax, C, H, F2, extra, alpha_ch, G);
  if (!so2::dims_ok(d)) return -1;
  const so2::TcGrid c = so2::tc_grid(d, true);
  return so2::tc_grid_residency(c.vec ? so2::grid_bwd_tc_kernel<true> : so2::grid_bwd_tc_kernel<false>,
                                c, smem_bytes, threads);
}
