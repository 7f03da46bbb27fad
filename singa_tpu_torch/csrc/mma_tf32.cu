// One block's product C = A B through csrc/mma_tf32.cuh, and its TF32
// rounding beside cvt.rna.tf32.f32, for the tests of the helper on the card
// (tests/test_torch_cuda.py); and the card's mma.sync TF32 rate, which
// chip_smoke.py reports beside the kernels built on the helper. On no path
// of the model.
//
// trans = 0: a holds A as [M][K], read with frag_a_paired and B with
// frag_b_paired (the to-grid orientation of csrc/s2_grid_tc.cuh).
// trans = 1: a holds A^T as [K][M], read with frag_a_trans and B with
// frag_b (the from-grid orientation). b is [K][N], c is [M][N], all
// float32 in device memory. The operands are staged in shared memory at
// the strides the bank rules of mma_tf32.cuh ask for.
//
// mma_bf16_tile_f32: the same product through csrc/mma_bf16.cuh, bfloat16
// operands (A as [M][K] or, ta, [K][M]; B as [K][N] or, tb, [N][K]) read by
// ldmatrix (.trans where the layout asks for it) into m16n8k16 mma.sync,
// float32 output.
#include "common.cuh"
#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int kThreads = 256;

// the smallest stride >= n with stride % 16 == 8 (stride % 32 is 8 or 24)
inline int stride8(int n) {
  const int s = (n + 7) / 8 * 8;
  return s % 16 == 8 ? s : s + 8;
}

__global__ void __launch_bounds__(kThreads)
tile_kernel(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ c, int M,
            int K, int N, int trans, int lda, int ldb) {
  extern __shared__ __align__(16) float smem[];
  const int arows = trans ? K : M, acols = trans ? M : K;
  float* sa = smem;
  float* sb = sa + arows * lda;
  for (int t = threadIdx.x; t < arows * acols; t += blockDim.x)
    sa[(t / acols) * lda + t % acols] = a[t];
  for (int t = threadIdx.x; t < K * N; t += blockDim.x) sb[(t / N) * ldb + t % N] = b[t];
  __syncthreads();
  const int warp = threadIdx.x / 32, warps = blockDim.x / 32;
  const int ntiles = N / 8;
  for (int tile = warp; tile < (M / 16) * ntiles; tile += warps) {
    const int m0 = 16 * (tile / ntiles), n0 = 8 * (tile % ntiles);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < K; k0 += 8) {
      if (trans) {
        const singa::tc::FragA fa = singa::tc::frag_a_trans(sa + k0 * lda + m0, lda);
        singa::tc::mma3(acc, fa, singa::tc::frag_b(sb + k0 * ldb + n0, ldb));
      } else {
        const singa::tc::FragA fa = singa::tc::frag_a_paired(sa + m0 * lda + k0, lda);
        singa::tc::mma3(acc, fa, singa::tc::frag_b_paired(sb + k0 * ldb + n0, ldb));
      }
    }
    singa::tc::store_c(c + m0 * N + n0, N, acc);
  }
}

__global__ void rna_kernel(const float* __restrict__ x, unsigned* __restrict__ bits,
                           unsigned* __restrict__ ptx, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    bits[i] = singa::tc::tf32_rna(x[i]);
    ptx[i] = singa::tc::tf32_rna_ptx(x[i]);
  }
}

// A, B bfloat16, staged at row strides of an odd number of 16-byte units;
// each warp a 16 x 16 output tile at a time
__global__ void __launch_bounds__(kThreads)
bf16_tile_kernel(const singa::bf16* __restrict__ a, const singa::bf16* __restrict__ b,
                 float* __restrict__ c, int M, int K, int N, int ta, int tb, int lda, int ldb) {
  namespace mma16 = singa::mma16;
  extern __shared__ __align__(16) float smem[];
  const int arows = ta ? K : M, acols = ta ? M : K, brows = tb ? N : K, bcols = tb ? K : N;
  singa::bf16* sa = reinterpret_cast<singa::bf16*>(smem);
  singa::bf16* sb = sa + arows * lda;
  for (int t = threadIdx.x; t < arows * acols; t += blockDim.x)
    sa[(t / acols) * lda + t % acols] = a[t];
  for (int t = threadIdx.x; t < brows * bcols; t += blockDim.x)
    sb[(t / bcols) * ldb + t % bcols] = b[t];
  __syncthreads();
  const int warp = threadIdx.x / 32, warps = blockDim.x / 32;
  const int grp = singa::tc::lane_grp(), tig = singa::tc::lane_tig();
  const int ntiles = N / 16;
  for (int tile = warp; tile < (M / 16) * ntiles; tile += warps) {
    const int m0 = 16 * (tile / ntiles), n0 = 16 * (tile % ntiles);
    float acc[2][4] = {};
    for (int k0 = 0; k0 < K; k0 += 16) {
      uint32_t fa[4], r[4];
      if (ta)
        mma16::ldmatrix_x4_trans(fa, mma16::a_addr<true>(sa + k0 * lda + m0, lda));
      else
        mma16::ldmatrix_x4(fa, mma16::a_addr<false>(sa + m0 * lda + k0, lda));
      if (tb)
        mma16::ldmatrix_x4(r, mma16::b_addr<false>(sb + n0 * ldb + k0, ldb));
      else
        mma16::ldmatrix_x4_trans(r, mma16::b_addr<true>(sb + k0 * ldb + n0, ldb));
      const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
      mma16::mma(acc[0], fa, b0);
      mma16::mma(acc[1], fa, b1);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float* o = c + (m0 + grp) * N + n0 + 8 * j + 2 * tig;
      o[0] = acc[j][0];
      o[1] = acc[j][1];
      o[8 * N] = acc[j][2];
      o[8 * N + 1] = acc[j][3];
    }
  }
}

// kChains independent mma.sync chains a warp, operands in registers: the
// card's issue rate of mma.m16n8k8 TF32, the ceiling of any kernel built
// on this helper (three of them per split product)
constexpr int kChains = 8;

__global__ void __launch_bounds__(kThreads) rate_kernel(float* __restrict__ out, int iters) {
  const uint32_t a[4] = {threadIdx.x, 1u, 2u, 3u}, b[2] = {5u, threadIdx.x};
  float c[kChains][4] = {};
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int j = 0; j < kChains; ++j) singa::tc::mma(c[j], a, b);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kChains; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

// Returns cudaErrorInvalidValue unless M % 16 == 0, K % 8 == 0, N % 8 == 0
// and the staged operands fit in 48 KB.
extern "C" int mma_tf32_tile_f32(const float* a, const float* b, float* c, int M, int K, int N,
                                 int trans, void* stream) {
  if (M < 16 || M % 16 || K < 8 || K % 8 || N < 8 || N % 8) return (int)cudaErrorInvalidValue;
  const int lda = stride8(trans ? M : K);
  int ldb = stride8(N);                                 // frag_b: ldb % 32 of 8 or 24
  if (!trans) ldb = ldb - 4 >= N ? ldb - 4 : ldb + 4;  // frag_b_paired: ldb % 16 of 4 or 12
  const size_t smem = ((size_t)(trans ? K : M) * lda + (size_t)K * ldb) * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  tile_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(a, b, c, M, K, N, trans, lda, ldb);
  return (int)cudaGetLastError();
}

// tf32_rna (integer operations) and tf32_rna_ptx (cvt.rna.tf32.f32) of each
// of x[0..n), into bits and ptx.
extern "C" int mma_tf32_rna_f32(const float* x, unsigned* bits, unsigned* ptx, int n,
                                void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  rna_kernel<<<(n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024, 256, 0, (cudaStream_t)stream>>>(
      x, bits, ptx, n);
  return (int)cudaGetLastError();
}

// blocks of 256 threads, each warp issuing iters * mma_tf32_rate_chains()
// mma.m16n8k8 (2,048 operations each); out holds blocks * 256 floats.
extern "C" int mma_tf32_rate_f32(float* out, int blocks, int iters, void* stream) {
  if (blocks < 1 || iters < 1) return (int)cudaErrorInvalidValue;
  rate_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(out, iters);
  return (int)cudaGetLastError();
}

extern "C" int mma_tf32_rate_chains() { return kChains; }

// C [M][N] (float32) = A B through mma_bf16.cuh, A bfloat16 [M][K] (ta:
// [K][M]), B bfloat16 [K][N] (tb: [N][K]). Returns cudaErrorInvalidValue
// unless M, K and N are multiples of 16 and the staged operands fit in 48 KB.
extern "C" int mma_bf16_tile_f32(const void* a, const void* b, float* c, int M, int K, int N,
                                 int ta, int tb, void* stream) {
  if (M < 16 || M % 16 || K < 16 || K % 16 || N < 16 || N % 16) return (int)cudaErrorInvalidValue;
  const int lda = (ta ? M : K) + 8, ldb = (tb ? K : N) + 8;  // (cols + 8) / 8 odd: cols % 16 == 0
  const size_t smem = ((size_t)(ta ? K : M) * lda + (size_t)(tb ? N : K) * ldb) * sizeof(singa::bf16);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  bf16_tile_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const singa::bf16*>(a), static_cast<const singa::bf16*>(b), c, M, K, N, ta, tb,
      lda, ldb);
  return (int)cudaGetLastError();
}
