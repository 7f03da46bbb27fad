// K6: the fused SO(2) edge-attention chain of GraphAttention, forward.
//
// Replaces: singa_tpu/ops/pallas/so2_attn.py::so2_attn_fused (_fwd_kernel).
// Per edge e, with x [E, (lmax+1)^2, C] l-primary and rad [E, n_trunc, C]:
//   mpr  = (J_kept Z(-beta) J^T Z(-phi) x) * rad         m-primary [n_trunc, C]
//   y_s  = mpr[section s] @ w1s[s]  (+ b1, s = 0)          conv 1, per section
//   h    = the hidden rows of y [n_trunc, H]; extra = y_0's last `extra` columns
//   mid  = fg^T silu(tg h) per hidden channel, row 0 := silu(extra[alpha_ch:])
//   z_s  = mid[section s] @ w2s[s]  (+ b2, s = 0)          conv 2, per section
// Sections: the m=0 rows, then the cos and sin rows of m = 1, of m = 2.
//
// What bounds it on the H100: at the default Config (C = 32, H = 128,
// F2 = 112, extra = 352, sections [7, 12, 10], G = 70) one edge costs 2.56
// MFLOP in conv 1, 8.40 in conv 2, 1.04 in the grid and ~0.05 in the
// block-diagonal rotation, ~12 MFLOP against ~24 KB of its inputs and
// outputs: ~5.7 ms of float32 work at a training microbatch's 31,744
// stage-1 edges (67 TFLOP/s) against ~0.2 ms of memory. The convolutions
// run on the tensor cores as three-product split TF32: 3 x 348 GFLOP, 2.1
// ms at the dense TF32 rate (495 TFLOP/s); mma.sync reaches ~0.3 PFLOP/s
// of it on the H100. Arithmetic bounds it.
//
// Design: 90 % of the work is the two convolutions, products of every edge
// with weights that all edges share (conv 2's are 16.8 MB). So the chain
// runs as stages (csrc/so2_chain.cuh), cut where the work turns from
// per-edge to shared-weight products: the rotation (one thread per (edge,
// channel) column, the J blocks in shared memory, cos/sin of m*phi and
// m*beta formed in the kernel), the conv-1 products (a 128 x 128-tiled
// GEMM on the tensor cores in split TF32, one per section), the separable
// S2 activation (K3's register columns, the [G, H] grid never stored), the
// conv-2 products (the same GEMM). The rotated message, the conv-1 output
// and mid pass through device memory: ~2 GB of traffic at the training
// microbatch, ~0.6 ms against the ~5.7 ms operation bound, the price of
// keeping each weight tile in shared memory across 128 edges. The TPU
// kernel's 128-lane channel padding of conv 1 (4x its products at C = 32),
// its edge padding and its transposed weight copies are not carried over.
//
// K6·bf16 (so2_attn_bf16): the same stages at bfloat16 storage (x, rad, the
// outputs; the weights rounded once a call into the scratch), rounding where
// the Pallas kernel rounds at a bfloat16 x (so2_chain.cuh): the modulated
// message and mid in bfloat16, the conv-1 output in float32, every conv
// product a bfloat16 m16n8k16 mma.sync (exact products, float32 sums), and
// the grid stage on the tensor cores (grid_fwd_tc_kernel: K3·bf16's chain).
#include "so2_chain.cuh"

namespace {

using singa::bf16;
using singa::so2::Dims;

inline long long fwd_scratch(const Dims& d) {
  return (long long)d.E * ((long long)d.n_trunc * d.C + d.y1_width + (long long)d.n_trunc * d.H);
}

// Byte offsets of the bfloat16 forward's scratch: the rounded weights, the
// modulated message (bf16), the conv-1 output (float32), mid (bf16).
struct Bf16Fwd {
  singa::so2::Bf16Weights w;
  long long mpr, y1, mid, total;
};

inline Bf16Fwd bf16_fwd_layout(const Dims& d) {
  using singa::so2::round_up256;
  Bf16Fwd s;
  s.w = singa::so2::bf16_weights_layout(d);
  const long long E = d.E;
  s.mpr = s.w.end;
  s.y1 = round_up256(s.mpr + 2 * E * d.n_trunc * d.C);
  s.mid = round_up256(s.y1 + 4 * E * d.y1_width);
  s.total = round_up256(s.mid + 2 * E * d.n_trunc * d.H);
  return s;
}

}  // namespace

// Floats of scratch the forward needs (the rotated message, the conv-1
// output and mid); -1 for shapes the kernels do not take.
extern "C" long long so2_attn_scratch_floats(int E, int lmax, int mmax, int C, int H, int F2,
                                             int extra, int alpha_ch, int G) {
  const Dims d = singa::so2::make_dims(E, lmax, mmax, C, H, F2, extra, alpha_ch, G);
  return singa::so2::dims_ok(d) ? fwd_scratch(d) : -1;
}

// Returns cudaErrorInvalidValue for shapes the kernels do not take: mmax
// other than 2, more than 32 m-primary rows (lmax above 6), gate channels
// (extra - alpha_ch) other than H.
extern "C" int so2_attn_f32(const float* x, const float* rad, const float* phi, const float* beta,
                            const float* w10, const float* w11, const float* w12, const float* b1,
                            const float* w20, const float* w21, const float* w22, const float* b2,
                            const float* J, const float* tg, const float* fg, float* z0, float* z1,
                            float* z2, float* extra_out, float* scratch, int E, int lmax, int mmax,
                            int C, int H, int F2, int extra, int alpha_ch, int G, void* stream) {
  const Dims d = singa::so2::make_dims(E, lmax, mmax, C, H, F2, extra, alpha_ch, G);
  if (!singa::so2::dims_ok(d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  float* mpr = scratch;
  float* y1 = mpr + (long long)E * d.n_trunc * C;
  float* mid = y1 + (long long)E * d.y1_width;
  const float* w1s[singa::so2::kSecs] = {w10, w11, w12};
  const float* w2s[singa::so2::kSecs] = {w20, w21, w22};
  float* zs[singa::so2::kSecs] = {z0, z1, z2};

  cudaError_t err = singa::so2::rotate_fwd(x, rad, phi, beta, J, nullptr, mpr, d, st);
  if (err != cudaSuccess) return (int)err;
  err = singa::so2::forward_to_mid(mpr, w1s, b1, tg, fg, y1, mid, extra_out, d, st);
  if (err != cudaSuccess) return (int)err;
  for (int s = 0; s < singa::so2::kSecs; ++s) {
    const int n_out = d.rows[s] * F2;
    err = singa::so2::gemm<false, false>(mid + d.row0[s] * H, (long long)d.n_trunc * H, w2s[s],
                                         n_out, zs[s], n_out, E, n_out, d.rows[s] * H,
                                         s == 0 ? b2 : nullptr, 1, 0, st);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// Bytes of scratch K6·bf16 needs; -1 for shapes the kernels do not take.
extern "C" long long so2_attn_bf16_scratch_bytes(int E, int lmax, int mmax, int C, int H, int F2,
                                                 int extra, int alpha_ch, int G) {
  const Dims d = singa::so2::make_dims(E, lmax, mmax, C, H, F2, extra, alpha_ch, G);
  return singa::so2::dims_ok(d) ? bf16_fwd_layout(d).total : -1;
}

// K6·bf16: x, rad, z0..z2 and extra_out bfloat16; the weights, biases,
// angles, J and the grids float32; scratch of so2_attn_bf16_scratch_bytes,
// 256-byte aligned. The shapes as so2_attn_f32's.
extern "C" int so2_attn_bf16(const void* x, const void* rad, const float* phi, const float* beta,
                             const float* w10, const float* w11, const float* w12,
                             const float* b1, const float* w20, const float* w21,
                             const float* w22, const float* b2, const float* J, const float* tg,
                             const float* fg, void* z0, void* z1, void* z2, void* extra_out,
                             void* scratch, int E, int lmax, int mmax, int C, int H, int F2,
                             int extra, int alpha_ch, int G, void* stream) {
  namespace so2 = singa::so2;
  const Dims d = so2::make_dims(E, lmax, mmax, C, H, F2, extra, alpha_ch, G);
  if (!so2::dims_ok(d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const Bf16Fwd sl = bf16_fwd_layout(d);
  char* base = static_cast<char*>(scratch);
  bf16* mpr = reinterpret_cast<bf16*>(base + sl.mpr);
  float* y1 = reinterpret_cast<float*>(base + sl.y1);
  bf16* mid = reinterpret_cast<bf16*>(base + sl.mid);
  const float* w1s[so2::kSecs] = {w10, w11, w12};
  const float* w2s[so2::kSecs] = {w20, w21, w22};
  bf16* zs[so2::kSecs] = {static_cast<bf16*>(z0), static_cast<bf16*>(z1), static_cast<bf16*>(z2)};
  bf16 *w1r[so2::kSecs], *w2r[so2::kSecs];

  cudaError_t err = so2::round_weights(w1s, w2s, base, sl.w, d, w1r, w2r, st);
  if (err != cudaSuccess) return (int)err;
  err = so2::rotate_fwd(static_cast<const bf16*>(x), static_cast<const bf16*>(rad), phi, beta, J,
                        nullptr, mpr, d, st);
  if (err != cudaSuccess) return (int)err;
  err = so2::forward_to_mid<bf16>(mpr, w1r, b1, tg, fg, y1, mid, static_cast<bf16*>(extra_out), d,
                                  st);
  if (err != cudaSuccess) return (int)err;
  for (int s = 0; s < so2::kSecs; ++s) {
    const int n_out = d.rows[s] * F2;
    err = so2::gemm<false, false, so2::Bf16In<bf16>>(
        mid + d.row0[s] * H, (long long)d.n_trunc * H, w2r[s], n_out, zs[s], n_out, E, n_out,
        d.rows[s] * H, s == 0 ? b2 : nullptr, 1, 0, st);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// The chain's GEMM alone, for the tests on the card (tests/test_torch_cuda.py);
// on no path of the model. orient 0: C = A B (+ bias), 1: C = A B^T with B
// [N][K], 2: C = A^T B with A [K][M], its depth split into `splits` slices
// whose partial sums (in `partial`, splits * M * N floats) are added in
// slice order into C [M][N] (ldc == N). Strides in floats.
extern "C" int so2_gemm_f32(const float* A, long long lda, const float* B, long long ldb,
                            float* C, long long ldc, int M, int N, int K, const float* bias,
                            int orient, int splits, float* partial, void* stream) {
  namespace so2 = singa::so2;
  cudaStream_t st = (cudaStream_t)stream;
  if (M < 1 || N < 1 || K < 1 || splits < 1 || orient < 0 || orient > 2)
    return (int)cudaErrorInvalidValue;
  if (orient == 0)
    return (int)so2::gemm<false, false>(A, lda, B, ldb, C, ldc, M, N, K, bias, 1, 0, st);
  if (orient == 1)
    return (int)so2::gemm<false, true>(A, lda, B, ldb, C, ldc, M, N, K, bias, 1, 0, st);
  if (ldc != N || bias != nullptr || (splits > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  if (splits == 1) return (int)so2::gemm<true, false>(A, lda, B, ldb, C, N, M, N, K, nullptr, 1, 0, st);
  const long long P = (long long)M * N;
  cudaError_t err = so2::gemm<true, false>(A, lda, B, ldb, partial, N, M, N, K, nullptr, splits, P, st);
  if (err != cudaSuccess) return (int)err;
  singa::sum_rows_kernel<<<(int)((P + 255) / 256), 256, 0, st>>>(partial, C, P, splits);
  return (int)cudaGetLastError();
}

// so2_gemm_f32's products at bfloat16 (the GEMM of K6·bf16 and K6b·bf16): A
// and B bfloat16, C float32, or bfloat16 when out_bf16 (orient 0 and 1
// only); the partial sums of orient 2 float32. Strides in elements.
extern "C" int so2_gemm_bf16(const void* A, long long lda, const void* B, long long ldb, void* C,
                             long long ldc, int M, int N, int K, const float* bias, int orient,
                             int splits, float* partial, int out_bf16, void* stream) {
  namespace so2 = singa::so2;
  using F = so2::Bf16In<float>;
  using H = so2::Bf16In<bf16>;
  cudaStream_t st = (cudaStream_t)stream;
  const bf16* a = static_cast<const bf16*>(A);
  const bf16* b = static_cast<const bf16*>(B);
  if (M < 1 || N < 1 || K < 1 || splits < 1 || orient < 0 || orient > 2 ||
      (out_bf16 && orient == 2))
    return (int)cudaErrorInvalidValue;
  if (orient < 2) {
    if (out_bf16)
      return (int)(orient == 0
                       ? so2::gemm<false, false, H>(a, lda, b, ldb, static_cast<bf16*>(C), ldc, M,
                                                    N, K, bias, 1, 0, st)
                       : so2::gemm<false, true, H>(a, lda, b, ldb, static_cast<bf16*>(C), ldc, M,
                                                   N, K, bias, 1, 0, st));
    float* c = static_cast<float*>(C);
    return (int)(orient == 0 ? so2::gemm<false, false, F>(a, lda, b, ldb, c, ldc, M, N, K, bias, 1,
                                                          0, st)
                             : so2::gemm<false, true, F>(a, lda, b, ldb, c, ldc, M, N, K, bias, 1,
                                                         0, st));
  }
  if (ldc != N || bias != nullptr || (splits > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  float* c = static_cast<float*>(C);
  if (splits == 1) return (int)so2::gemm<true, false, F>(a, lda, b, ldb, c, N, M, N, K, nullptr, 1, 0, st);
  const long long P = (long long)M * N;
  cudaError_t err = so2::gemm<true, false, F>(a, lda, b, ldb, partial, N, M, N, K, nullptr, splits,
                                              P, st);
  if (err != cudaSuccess) return (int)err;
  singa::sum_rows_kernel<<<(int)((P + 255) / 256), 256, 0, st>>>(partial, c, P, splits);
  return (int)cudaGetLastError();
}

// Resident blocks per SM of the GEMM kernel of each orientation (0 NN, 1 NT,
// 2 TN) as the chain launches it, its dynamic shared memory per block in
// *smem_bytes and its threads per block in *threads; -1 on failure. For
// reports; launches nothing.
extern "C" int so2_gemm_residency(int orient, int* smem_bytes, int* threads) {
  namespace so2 = singa::so2;
  *threads = so2::kGemmThreads;
  if (orient == 0) return so2::gemm_residency<false, false>(smem_bytes);
  if (orient == 1) return so2::gemm_residency<false, true>(smem_bytes);
  if (orient == 2) return so2::gemm_residency<true, false>(smem_bytes);
  return -1;
}

// The same of K6·bf16's and K6b·bf16's GEMM kernels (bfloat16 operands,
// float32 output; NN's conv-2 instance, bfloat16 output, has the same
// shared memory).
extern "C" int so2_gemm_bf16_residency(int orient, int* smem_bytes, int* threads) {
  namespace so2 = singa::so2;
  using F = so2::Bf16In<float>;
  *threads = so2::kGemmThreads;
  if (orient == 0) return so2::gemm_residency<false, false, F>(smem_bytes);
  if (orient == 1) return so2::gemm_residency<false, true, F>(smem_bytes);
  if (orient == 2) return so2::gemm_residency<true, false, F>(smem_bytes);
  return -1;
}

// Resident blocks per SM of K6·bf16's tensor-core grid stage
// (grid_fwd_tc_kernel) at these widths, its dynamic shared memory and its
// threads per block; -1 for shapes it does not take. For reports;
// launches nothing.
extern "C" int so2_grid_bf16_residency(int lmax, int mmax, int C, int H, int F2, int extra,
                                       int alpha_ch, int G, int* smem_bytes, int* threads) {
  namespace so2 = singa::so2;
  const Dims d = so2::make_dims(1, lmax, mmax, C, H, F2, extra, alpha_ch, G);
  if (!so2::dims_ok(d)) return -1;
  const so2::TcGrid c = so2::tc_grid(d, false);
  return so2::tc_grid_residency(c.vec ? so2::grid_fwd_tc_kernel<true> : so2::grid_fwd_tc_kernel<false>,
                                c, smem_bytes, threads);
}
