// K2: gate-activation SO(3) feed-forward network, forward.
//
// Replaces: singa_tpu/ops/pallas/so3_ffn.py::so3_gate_ffn_fused
// (_gate_ffn_fwd_kernel).
//   h[n, i, :]   = x[n, i, :] @ w1[l(i)]                        (C -> H)
//   mid[n, 0, :] = silu(h[n, 0, :] + b1)
//   mid[n, i, :] = h[n, i, :] * sigmoid(x[n, 0, :] @ wg + bg)[(l-1)H : lH]
//   y[n, i, :]   = mid[n, i, :] @ w2[l(i)]  (+ b2 on row 0)      (H -> Co)
// x [N, I=(lmax+1)^2, C], w1 [L, C, H], wg [C, lmax*H], w2 [L, H, Co].
//
// What bounds it on the H100: at a training microbatch (N = 14,336 nodes,
// I = 49, C = Co = 16, H = 512) the two per-degree products and the gate
// product are 24.4 GFLOP against ~90 MB of x in and y out: 0.36 ms at the
// 67 TFLOP/s float32 rate of the CUDA cores, memory ~27 us. The
// tensor-core kernel runs all of it as three-product split TF32
// (csrc/mma_tf32.cuh, float32 to round-off): 0.148 ms at 495 TFLOP/s, and
// this card issues mma.sync TF32 at ~300 TFLOP/s (chip_smoke.py's
// mma_rate), so ~0.245 ms for split products.
//
// Design: the TPU kernel exists so that the [N, I, H] hidden (1.44 GB here)
// never reaches device memory; so here too. The tensor-core kernel is K2b's
// dx kernel (csrc/so3_gate_ffn_bwd.cu) with dmid and the gate term left out
// and y = mid w2 in place of dx, on csrc/gate_ffn_tc.cuh:
//   * the split kernel (gate_ffn_wsplit_kernel) writes, once a call, each
//     hidden chunk of kHC = 16 channels of w1 (h's B: k = c, n = hidden),
//     w2 (y's B: k = hidden, n = o) and wg (the gates' B) as fragments
//     split into TF32 hi and lo, then the chunk's b1 and bg
//     (chunk_layout<false>): one block of words a chunk;
//   * the product kernel (gate_ffn_tc_kernel): one block of 12 warps per
//     tile of kTN = 16 nodes, the m16 of every product. x comes once a
//     tile by 16-byte cp.async (rows past N zero-filled); each chunk's
//     block of words by cp.async into a ring of two stages, the next
//     chunk's copy in flight during this one's products, so each weight is
//     read from global memory once a block and chunk, coalesced, split
//     already. A chunk starts with its gates, gate_l = sigmoid(x_0 wg_l +
//     bg_l): an m16n8 product of row 0 at depth C for each (degree, n8
//     block), one warp each, into shared memory (two barriers a chunk).
//     Then per row i of degree l and n8 block j of the chunk's channels:
//       h = x_i w1[l]          m16 (node) x n8 x k C; A: the tile's row,
//                              split as it loads (once a row and chunk)
//       mid = silu(h + b1) (row 0) or h gate_l, on h's C fragment
//       y_i += mid w2[l]       A: frag_a_from_c(mid), k = the n8 block;
//                              n = Co (Co / 8 n8 tiles)
//     so the hidden never leaves the registers. Warp w takes the rows
//     I - 1 - w - 12 s; the first kRows slots of every warp hold a row of
//     degree >= 1 (kRows = 4 at lmax 6, 2 at lmax 4 and 5), so their loop
//     has no branch a row; the last slots (row 0 among them) are taken
//     where they hold a row. Each row's products in one chunk start from
//     zero on the tensor cores (chains of 3 C / 8 mma for h, 3 kHC / 8 for
//     y) and are added to the warp's float32 sums of y in registers
//     (so2_chain.cuh: the tensor cores cut low bits as they accumulate). b2
//     is added to row 0 at the end; y is written once, with no atomics.
// Shared memory: the tile [I][16][C], two stages of chunk_layout<false> words
// and the gates [lmax][2][32][4]: at lmax 6 and 16 channels 50,176 + 2 x
// 41,408 + 6,144 = 139,136 B; at lmax 7 167,936 B. One block an SM.
//
// The tensor-core kernel takes C and Co of 8 or 16 (the products' k and n
// steps are 8 wide) and lmax 1..7. Every other shape K2 takes runs the
// CUDA-core instance (gate_ffn_kernel below), chosen by shape before the
// launch: 8-node tiles, each 16-channel hidden chunk of w1, wg and w2 staged
// in shared memory by every block, both products as float4 register
// micro-tiles of four nodes by four channels on the CUDA cores in float32.
// bfloat16 (so3_gate_ffn with bf16 != 0): K2's bfloat16 instance is the same two
// kernels at T = bf16, the storage type of x and y, at the widths the
// tensor-core kernel takes (the same rule as float32), else the CUDA-core
// kernel at T = bf16 (gate_ffn_kernel<bf16>, whose note lists the
// roundings: they are the TPU kernel's at a bfloat16 dtype); cuda_cores asks
// for the latter at any width. At bf16 the split kernel rounds w1, wg and w2
// to bfloat16 once a call and writes the hi plane alone (a bfloat16 value is
// a TF32 value: its lo is zero), half the words of a fragment; the tile
// arrives by 16-byte cp.async as bfloat16, half the bytes (at lmax 6 and 16
// channels 25,088), and widens as its fragments load; every product (h, the
// gates, y) multiplies two bfloat16 values and is one TF32 mma.sync
// (mma_tf32.cuh, mma_t), exact to float32 accumulation, where float32 takes
// three. The gates are rounded as they are stored, mid as it becomes the A
// fragment of y's product (frag_a_from_c), and y, summed in float32 with b2
// added on row 0, once at the store. Its 24.4 GFLOP a microbatch as one TF32
// product each: ~49 us at 495 TFLOP/s.
#include "gate_ffn_tc.cuh"

namespace {

using singa::degree_of;

// ------------------------------- tensor cores -------------------------------
using singa::gate::ChunkLayout;
using singa::gate::frag_words;
using singa::gate::kHC;
using singa::gate::kNB;
using singa::gate::kTN;

constexpr int kThreads = 384;  // 12 warps, as K2b's dx kernel
constexpr int kWarps = kThreads / 32;

// y_i's products over the chunk (st) for row i of degree l (xi: its rows in
// the tile), from zero into py; kRow0: i = 0 (silu with b1; no gate). At T =
// bf16 one product each, mid rounded as it becomes the A fragment.
template <int C, int Co, bool kRow0, class T>
__device__ __forceinline__ void row_y(const T* xi, const uint32_t* st, const ChunkLayout& o,
                                      const float* cb1, const float* sgate, int l,
                                      float (&py)[Co / 8][4]) {
  using namespace singa::tc;
  using singa::gate::frag_pre;
  constexpr int KC = C / 8, KO = Co / 8, FW = frag_words<T>();
  const int t = lane_tig(), lane = threadIdx.x & 31;
  FragA xa[KC];
#pragma unroll
  for (int ks = 0; ks < KC; ++ks) xa[ks] = singa::gate::frag_tile<C, T>(xi, ks);
  const uint32_t* w1f = st + l * KC * kNB * FW;
  const uint32_t* w2f = st + (o.w2 + l * kNB * KO) * FW;
  float hc[kNB][4] = {};  // c fragments: (node g + 8 (q >> 1), channel 8 j + 2 t + (q & 1))
#pragma unroll
  for (int ks = 0; ks < KC; ++ks)
#pragma unroll
    for (int j = 0; j < kNB; ++j) mma_t<T>(hc[j], xa[ks], frag_pre<T>(w1f + (ks * kNB + j) * FW));
#pragma unroll
  for (int j = 0; j < kNB; ++j) {
    float mid[4];
    if (kRow0) {
#pragma unroll
      for (int q = 0; q < 4; ++q) mid[q] = singa::siluf_(hc[j][q] + cb1[8 * j + 2 * t + (q & 1)]);
    } else {
      const float4 gv =
          *reinterpret_cast<const float4*>(sgate + (((l - 1) * kNB + j) * 32 + lane) * 4);
      mid[0] = hc[j][0] * gv.x, mid[1] = hc[j][1] * gv.y;
      mid[2] = hc[j][2] * gv.z, mid[3] = hc[j][3] * gv.w;
    }
    const FragA ma = frag_a_from_c<T>(mid);
    FragB b[KO];
#pragma unroll
    for (int nt = 0; nt < KO; ++nt) b[nt] = frag_pre<T>(w2f + (j * KO + nt) * FW);
    if constexpr (!singa::kBf16<T>) {
#pragma unroll
      for (int nt = 0; nt < KO; ++nt) mma(py[nt], ma.lo, b[nt].hi);
#pragma unroll
      for (int nt = 0; nt < KO; ++nt) mma(py[nt], ma.hi, b[nt].lo);
    }
#pragma unroll
    for (int nt = 0; nt < KO; ++nt) mma(py[nt], ma.hi, b[nt].hi);
  }
}

// The product kernel (design: the top of the file). Slot s of warp w holds
// row I - 1 - w - kWarps s; slots below kRows hold a row of degree >= 1 at
// every warp (kRows <= (I - 1) / kWarps), and two more slots take the rest
// (tc_kernel_rows picks kRows so that they do). T: the storage type of x and
// y (at bf16 the tile is bfloat16 in shared memory and y rounded once, at
// the store).
template <int C, int Co, int kRows, class T = float>
__global__ void __launch_bounds__(kThreads, 1)
gate_ffn_tc_kernel(const T* __restrict__ x, const uint32_t* __restrict__ wfrag,
                   const float* __restrict__ b2, T* __restrict__ y, int N, int lmax, int H) {
  constexpr int KO = Co / 8, kSlots = kRows + 2;
  const int I = (lmax + 1) * (lmax + 1);
  const ChunkLayout o = singa::gate::chunk_layout<false, T>(lmax, C, Co);
  extern __shared__ __align__(16) float smem[];
  T* sx = reinterpret_cast<T*>(smem);                               // [I][kTN][C]
  uint32_t* ring = reinterpret_cast<uint32_t*>(sx + I * kTN * C);  // [2][o.words]
  float* sgate = reinterpret_cast<float*>(ring + 2 * o.words);      // [lmax][kNB][32][4]
  const int chunks = (H + kHC - 1) / kHC;
  const int n0 = blockIdx.x * kTN;
  const int warp = threadIdx.x / 32;

  singa::gate::copy_tile_rows<C, kThreads, T>(x, n0, I, N, sx);
  singa::gate::copy_chunk<kThreads>(wfrag, 0, o.words, ring);  // one group with the tile

  int row[kSlots], deg[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    row[s] = I - 1 - warp - kWarps * s;
    deg[s] = row[s] >= 0 ? degree_of(row[s]) : 0;
  }
  float acc[kSlots][KO][4] = {};  // y of the warp's rows, c fragments (node, o)
  for (int k = 0; k < chunks; ++k) {
    const uint32_t* st = ring + (k & 1) * o.words;
    asm volatile("cp.async.wait_group 0;\n" ::);  // this chunk (and the tile): this thread's copies
    __syncthreads();  // everyone's; and every warp is done with the stage the next copy fills
    if (k + 1 < chunks)
      singa::gate::copy_chunk<kThreads>(wfrag, k + 1, o.words, ring + ((k + 1) & 1) * o.words);
    const float* cb1 = reinterpret_cast<const float*>(st + o.b1);
    const float* cbg = reinterpret_cast<const float*>(st + o.bg);
    const uint32_t* wgf = st + o.wg * frag_words<T>();
    for (int p = warp; p < lmax * kNB; p += kWarps) {  // the gates, a (degree, n8 block) a warp
      singa::tc::FragA xa[C / 8];
      singa::gate::row0_frags<C, T>(sx, xa);
      // (at T = bf16 rounded as they are stored)
      singa::gate::gate_block<C, T, true>(xa, wgf, cbg, p / kNB + 1, p % kNB, sgate);
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      float py[KO][4] = {};  // this row's products in this chunk, from zero
      const T* xi = sx + row[s] * kTN * C;
      if (s < kRows) {  // a row of degree >= 1 at every warp
        row_y<C, Co, false, T>(xi, st, o, cb1, sgate, deg[s], py);
      } else if (row[s] > 0) {
        row_y<C, Co, false, T>(xi, st, o, cb1, sgate, deg[s], py);
      } else if (row[s] == 0) {
        row_y<C, Co, true, T>(xi, st, o, cb1, sgate, 0, py);
      } else {
        continue;  // an empty last slot
      }
#pragma unroll
      for (int nt = 0; nt < KO; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[s][nt][q] += py[nt][q];
    }
  }

  const int g = singa::tc::lane_grp(), t = singa::tc::lane_tig();
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int i = row[s];
    if (i < 0) break;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = n0 + g + 8 * half;
      if (n >= N) continue;
#pragma unroll
      for (int nt = 0; nt < KO; ++nt) {
        float2 v = make_float2(acc[s][nt][2 * half], acc[s][nt][2 * half + 1]);
        if (i == 0) v.x += b2[8 * nt + 2 * t], v.y += b2[8 * nt + 2 * t + 1];
        T* out = y + ((long long)n * I + i) * Co + 8 * nt + 2 * t;
        if constexpr (singa::kBf16<T>)
          *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(v.x, v.y);
        else
          *reinterpret_cast<float2*>(out) = v;
      }
    }
  }
}

// Every chunk's words (chunk_layout<false, T>): the weights split into TF32
// hi and lo once a call (at T = bf16 rounded to bfloat16, hi only).
template <int C, int Co, class T = float>
__global__ void gate_ffn_wsplit_kernel(const float* __restrict__ w1, const float* __restrict__ b1,
                                       const float* __restrict__ wg, const float* __restrict__ bg,
                                       const float* __restrict__ w2, uint32_t* __restrict__ out,
                                       int lmax, int H) {
  singa::gate::split_chunks<C, Co, false, T>(w1, b1, wg, bg, w2, out, lmax, H);
}

template <class T>
using TcKernel = void (*)(const T*, const uint32_t*, const float*, T*, int, int, int);
using SplitKernel = void (*)(const float*, const float*, const float*, const float*, const float*,
                             uint32_t*, int, int);

// The rows every warp's first slots hold for I rows: 4 (lmax 6, 7), 2 (lmax
// 4, 5), else none (lmax 1..3: every slot may be empty); the two slots after
// them take the rest, at most 2 kWarps rows
template <int C, int Co, class T>
TcKernel<T> tc_kernel_rows(int I) {
  const int r = (I - 1) / kWarps;
  if (r >= 4) return gate_ffn_tc_kernel<C, Co, 4, T>;
  if (r >= 2) return gate_ffn_tc_kernel<C, Co, 2, T>;
  return gate_ffn_tc_kernel<C, Co, 0, T>;
}

// The product kernel's and the split kernel's instances for C input and Co
// output channels and lmax, at storage type T (null: none)
template <class T = float>
TcKernel<T> tc_kernel(int lmax, int C, int Co) {
  const int I = (lmax + 1) * (lmax + 1);
  if (C == 8 && Co == 8) return tc_kernel_rows<8, 8, T>(I);
  if (C == 8 && Co == 16) return tc_kernel_rows<8, 16, T>(I);
  if (C == 16 && Co == 8) return tc_kernel_rows<16, 8, T>(I);
  if (C == 16 && Co == 16) return tc_kernel_rows<16, 16, T>(I);
  return nullptr;
}

template <class T = float>
SplitKernel split_kernel(int C, int Co) {
  if (C == 8 && Co == 8) return gate_ffn_wsplit_kernel<8, 8, T>;
  if (C == 8 && Co == 16) return gate_ffn_wsplit_kernel<8, 16, T>;
  if (C == 16 && Co == 8) return gate_ffn_wsplit_kernel<16, 8, T>;
  if (C == 16 && Co == 16) return gate_ffn_wsplit_kernel<16, 16, T>;
  return nullptr;
}

// 32-bit words of the split weights: every hidden chunk's chunk_layout<false, T>
template <class T = float>
long long tc_words(int lmax, int C, int H, int Co) {
  return (long long)((H + kHC - 1) / kHC) *
         singa::gate::chunk_layout<false, T>(lmax, C, Co).words;
}

// The tile, the ring's two stages and the gates
template <class T = float>
size_t tc_smem(int lmax, int C, int Co) {
  const int I = (lmax + 1) * (lmax + 1);
  return (size_t)I * kTN * C * sizeof(T) +
         (2 * (size_t)singa::gate::chunk_layout<false, T>(lmax, C, Co).words +
          (size_t)lmax * kNB * 128) *
             sizeof(float);
}

// Whether the tensor-core kernel at storage type T takes these widths: C
// and Co of 8 or 16, lmax 1..7 (at most 64 rows: tc_kernel_rows), and its
// shared memory, which this opts the instance into (every width fits at
// float32, and the bfloat16 instance's is smaller: one rule for both)
template <class T = float>
bool tc_takes(int lmax, int C, int H, int Co) {
  if (lmax < 1 || lmax > 7 || H < 1) return false;
  const TcKernel<T> k = tc_kernel<T>(lmax, C, Co);
  return k != nullptr && singa::allow_smem(k, tc_smem<T>(lmax, C, Co)) == cudaSuccess;
}

// Resident blocks per SM of the tensor-core kernel at storage type T (-1:
// refused) and its shared memory per block in *smem_bytes
template <class T>
int tc_residency(int lmax, int C, int Co, int* smem_bytes) {
  const size_t smem = tc_smem<T>(lmax, C, Co);
  *smem_bytes = (int)smem;
  const TcKernel<T> k = tc_kernel<T>(lmax, C, Co);
  int per_sm = 0;
  if (singa::allow_smem(k, smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, kThreads, smem) != cudaSuccess)
    return -1;
  return per_sm;
}

// Splits the weights into wfrag (tc_words<T>() words, 16-byte aligned), then
// the tensor-core kernel at storage type T; the caller has checked
// tc_takes<T>, which set the kernel's shared memory
template <class T>
int launch_tc(const T* x, const float* w1, const float* b1, const float* wg, const float* bg,
              const float* w2, const float* b2, T* y, void* wfrag, int N, int lmax, int C, int H,
              int Co, cudaStream_t st) {
  uint32_t* frags = reinterpret_cast<uint32_t*>(wfrag);
  const SplitKernel sk = split_kernel<T>(C, Co);
  const ChunkLayout o = singa::gate::chunk_layout<false, T>(lmax, C, Co);
  const long long items = (long long)((H + kHC - 1) / kHC) * (o.frags * 32 + (o.words - o.b1));
  const int sgrid = singa::persistent_grid(sk, 256, 0, (items + 255) / 256);
  sk<<<sgrid, 256, 0, st>>>(w1, b1, wg, bg, w2, frags, lmax, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const TcKernel<T> k = tc_kernel<T>(lmax, C, Co);
  const size_t smem = tc_smem<T>(lmax, C, Co);
  k<<<(N + kTN - 1) / kTN, kThreads, smem, st>>>(x, frags, b2, y, N, lmax, H);
  return (int)cudaGetLastError();
}

// ------------------------------- CUDA cores --------------------------------
namespace cc {

constexpr int kThreads = 256;
constexpr int kNG = 2;          // groups of four nodes per block
constexpr int kTN = 4 * kNG;    // nodes per block
constexpr int kHC = 16;         // hidden channels per chunk
constexpr int kPad = 8;         // floats added to each row block of sx and smid
constexpr int kMaxJobs = 2;     // output micro-tiles per thread

using singa::fma4;

// One block owns a tile of kTN = 8 nodes and walks the hidden dimension in
// chunks of kHC = 16 channels: per chunk it stages the chunk's slices of
// w1, wg and w2 in shared memory, forms the gates and the [I, kHC, kTN]
// hidden slice in shared memory, and adds its contribution to the output,
// which stays in registers until the last chunk. Both products run as
// register micro-tiles of four nodes by four channels of one coefficient
// row: each step reads one 16-byte vector of four nodes and one of four
// weights and does sixteen multiply-adds. x and the hidden slice are stored
// node minor ([row][channel][node]), each row block padded by kPad floats so
// that the rows a warp reads fall in different banks.
//
// T is the storage type of x and y. The bfloat16 instance (T = bf16) is
// the function _gate_ffn_fwd_kernel computes at a bfloat16 x: w1, wg and w2
// rounded to bfloat16 as they are staged (the biases stay float32), every
// product summed in float32, the gates sigmoid(x0 wg + bg) and the hidden
// after its activation rounded to bfloat16, y rounded as it is stored.
template <class T>
__global__ void __launch_bounds__(kThreads)
gate_ffn_kernel(const T* __restrict__ x, const float* __restrict__ w1,
                const float* __restrict__ b1, const float* __restrict__ wg,
                const float* __restrict__ bg, const float* __restrict__ w2,
                const float* __restrict__ b2, T* __restrict__ y, int N, int lmax,
                int C, int H, int Co) {
  const int L = lmax + 1;
  const int I = L * L;
  const int xs = C * kTN + kPad;    // row stride of sx
  const int ms = kHC * kTN + kPad;  // row stride of smid
  extern __shared__ __align__(16) float smem[];
  float* sx = smem;                         // [I][C][kTN] (+pad per row)
  float* sgate = sx + I * xs;               // [lmax][kHC][kTN]
  float* smid = sgate + lmax * kHC * kTN;   // [I][kHC][kTN] (+pad per row)
  float* sw1 = smid + I * ms;               // [L, C, kHC]
  float* swg = sw1 + L * C * kHC;           // [C, lmax, kHC]
  float* sw2 = swg + C * lmax * kHC;        // [L, kHC, Co]

  const int n0 = blockIdx.x * kTN;
  const int tid = threadIdx.x;
  const int C4 = Co / 4;
  const int njobs = kNG * I * C4;
  for (int t = tid; t < kTN * I * C; t += kThreads) {
    const int n = t / (I * C), i = (t / C) % I, c = t % C;
    sx[i * xs + c * kTN + n] = (n0 + n < N) ? singa::to_f(x[(long long)n0 * I * C + t]) : 0.f;
  }
  float4 acc[kMaxJobs][4];
#pragma unroll
  for (int k = 0; k < kMaxJobs; ++k)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[k][q] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int h0 = 0; h0 < H; h0 += kHC) {
    __syncthreads();  // previous chunk's readers of the staged weights are done
    for (int t = tid; t < L * C * kHC; t += kThreads) {
      const int h = t % kHC, lc = t / kHC;
      sw1[t] = (h0 + h < H) ? singa::rnd<T>(w1[(long long)lc * H + h0 + h]) : 0.f;
    }
    for (int t = tid; t < C * lmax * kHC; t += kThreads) {
      const int h = t % kHC, l = (t / kHC) % lmax, c = t / (kHC * lmax);
      swg[t] = (h0 + h < H) ? singa::rnd<T>(wg[(long long)c * lmax * H + l * H + h0 + h]) : 0.f;
    }
    for (int t = tid; t < L * kHC * Co; t += kThreads) {
      const int o = t % Co, h = (t / Co) % kHC, l = t / (Co * kHC);
      sw2[t] = (h0 + h < H) ? singa::rnd<T>(w2[((long long)l * H + h0 + h) * Co + o]) : 0.f;
    }
    __syncthreads();

    // gates of degrees 1..lmax from the l=0 row, [lmax][kHC][kTN]
    for (int t = tid; t < lmax * kHC * kTN; t += kThreads) {
      const int n = t % kTN, h = (t / kTN) % kHC, l = t / (kTN * kHC);
      float v = (h0 + h < H) ? bg[l * H + h0 + h] : 0.f;
      for (int c = 0; c < C; ++c) v = fmaf(sx[c * kTN + n], swg[(c * lmax + l) * kHC + h], v);
      sgate[t] = singa::rnd<T>(singa::sigmoidf_(v));
    }
    __syncthreads();

    // hidden micro-tiles: four nodes x four hidden channels of one row
    for (int t = tid; t < kNG * I * (kHC / 4); t += kThreads) {
      const int h4 = t % (kHC / 4), ng = (t / (kHC / 4)) % kNG, i = t / (kHC / 4 * kNG);
      const int l = degree_of(i);
      const float* xr = sx + i * xs + 4 * ng;
      const float* wr = sw1 + l * C * kHC + 4 * h4;
      float4 a[4];  // a[r]: hidden channel 4*h4 + r of the four nodes
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int c = 0; c < C; ++c) {
        const float4 xv = *reinterpret_cast<const float4*>(xr + c * kTN);
        const float4 wv = *reinterpret_cast<const float4*>(wr + c * kHC);
        fma4(a[0], wv.x, xv);
        fma4(a[1], wv.y, xv);
        fma4(a[2], wv.z, xv);
        fma4(a[3], wv.w, xv);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int h = 4 * h4 + r;
        float4 m;
        if (i == 0) {
          if (h0 + h < H) {
            const float bb = b1[h0 + h];
            m = make_float4(singa::siluf_(a[r].x + bb), singa::siluf_(a[r].y + bb),
                            singa::siluf_(a[r].z + bb), singa::siluf_(a[r].w + bb));
          } else {
            m = make_float4(0.f, 0.f, 0.f, 0.f);
          }
        } else {
          const float4 g =
              *reinterpret_cast<const float4*>(sgate + ((l - 1) * kHC + h) * kTN + 4 * ng);
          m = make_float4(a[r].x * g.x, a[r].y * g.y, a[r].z * g.z, a[r].w * g.w);
        }
        m = make_float4(singa::rnd<T>(m.x), singa::rnd<T>(m.y), singa::rnd<T>(m.z),
                        singa::rnd<T>(m.w));
        *reinterpret_cast<float4*>(smid + i * ms + h * kTN + 4 * ng) = m;
      }
    }
    __syncthreads();

    // output micro-tiles: four nodes x four output channels of one row
#pragma unroll
    for (int k = 0; k < kMaxJobs; ++k) {
      const int j = tid + k * kThreads;
      if (j < njobs) {
        const int o4 = j % C4, ng = (j / C4) % kNG, i = j / (C4 * kNG);
        const int l = degree_of(i);
        const float* mr = smid + i * ms + 4 * ng;
        const float* wr = sw2 + l * kHC * Co + 4 * o4;
        for (int h = 0; h < kHC; ++h) {
          const float4 mv = *reinterpret_cast<const float4*>(mr + h * kTN);
          const float4 wv = *reinterpret_cast<const float4*>(wr + h * Co);
          fma4(acc[k][0], mv.x, wv);
          fma4(acc[k][1], mv.y, wv);
          fma4(acc[k][2], mv.z, wv);
          fma4(acc[k][3], mv.w, wv);
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kMaxJobs; ++k) {
    const int j = tid + k * kThreads;
    if (j < njobs) {
      const int o4 = j % C4, ng = (j / C4) % kNG, i = j / (C4 * kNG);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = n0 + 4 * ng + q;
        if (n < N) {
          float4 a = acc[k][q];
          if (i == 0) {
            a.x += b2[4 * o4];
            a.y += b2[4 * o4 + 1];
            a.z += b2[4 * o4 + 2];
            a.w += b2[4 * o4 + 3];
          }
          T* yr = y + ((long long)n * I + i) * Co + 4 * o4;
          if constexpr (singa::kBf16<T>) {
            yr[0] = singa::from_f<T>(a.x);
            yr[1] = singa::from_f<T>(a.y);
            yr[2] = singa::from_f<T>(a.z);
            yr[3] = singa::from_f<T>(a.w);
          } else {
            *reinterpret_cast<float4*>(yr) = a;
          }
        }
      }
    }
  }
}

size_t smem_bytes(int lmax, int C, int Co) {
  const int L = lmax + 1, I = L * L;
  const size_t floats = (size_t)I * (C * kTN + kPad) + (size_t)lmax * kHC * kTN +
                        (size_t)I * (kHC * kTN + kPad) + (size_t)L * C * kHC +
                        (size_t)C * lmax * kHC + (size_t)L * kHC * Co;
  return floats * sizeof(float);
}

// Whether the CUDA-core kernel at storage type T takes these widths: Co a
// multiple of 4, the output micro-tiles within kMaxJobs a thread, and its
// shared memory
template <class T = float>
bool cc_takes(int lmax, int C, int H, int Co) {
  if (lmax < 1 || C < 1 || H < 1 || Co < 4 || Co % 4 != 0) return false;
  const int I = (lmax + 1) * (lmax + 1);
  if (kNG * I * (Co / 4) > kMaxJobs * kThreads) return false;
  return singa::allow_smem(gate_ffn_kernel<T>, smem_bytes(lmax, C, Co)) == cudaSuccess;
}

}  // namespace cc

// 1: the tensor-core kernel takes the widths; 0: the CUDA-core instance
// does; -1: neither.
int instance(int lmax, int C, int H, int Co) {
  if (tc_takes(lmax, C, H, Co)) return 1;
  return cc::cc_takes(lmax, C, H, Co) ? 0 : -1;
}

// K2 at storage type T of x and y: the tensor-core kernel where it takes
// the widths (unless cuda_cores), else the CUDA-core kernel at T
template <class T>
int launch(const T* x, const float* w1, const float* b1, const float* wg, const float* bg,
           const float* w2, const float* b2, T* y, void* wfrag, int N, int lmax, int C, int H,
           int Co, int cuda_cores, cudaStream_t st) {
  if (N < 1) return (int)cudaErrorInvalidValue;
  if (!cuda_cores && tc_takes<T>(lmax, C, H, Co))
    return launch_tc(x, w1, b1, wg, bg, w2, b2, y, wfrag, N, lmax, C, H, Co, st);
  if (!cc::cc_takes<T>(lmax, C, H, Co)) return (int)cudaErrorInvalidValue;
  const size_t smem = cc::smem_bytes(lmax, C, Co);
  cc::gate_ffn_kernel<T><<<(N + cc::kTN - 1) / cc::kTN, cc::kThreads, smem, st>>>(
      x, w1, b1, wg, bg, w2, b2, y, N, lmax, C, H, Co);
  return (int)cudaGetLastError();
}

}  // namespace

// Which kernel runs these widths (any N): 1 the tensor-core kernel, 0 the
// CUDA-core instance, -1 none (a shape no kernel takes).
extern "C" int so3_gate_ffn_instance(int lmax, int C, int H, int Co) {
  return instance(lmax, C, H, Co);
}

// 32-bit words of scratch so3_gate_ffn needs at these widths and the same
// bf16 (the tensor-core kernel's split weights; 0 for the CUDA-core
// instance), -1 for shapes no kernel takes.
extern "C" long long so3_gate_ffn_words(int lmax, int C, int H, int Co, int bf16) {
  const int which = instance(lmax, C, H, Co);
  if (which < 0) return -1;
  if (which == 0) return 0;
  return bf16 ? tc_words<singa::bf16>(lmax, C, H, Co) : tc_words(lmax, C, H, Co);
}

// Resident blocks per SM of the tensor-core kernel at these widths (bf16 !=
// 0: its bfloat16 instance; -1: a shape it does not take), its shared
// memory per block in *smem_bytes and its threads per block in *threads.
// For reports; launches nothing.
extern "C" int so3_gate_ffn_residency(int lmax, int C, int H, int Co, int bf16, int* smem_bytes,
                                      int* threads) {
  if (!tc_takes(lmax, C, H, Co)) return -1;
  *threads = kThreads;
  return bf16 ? tc_residency<singa::bf16>(lmax, C, Co, smem_bytes)
              : tc_residency<float>(lmax, C, Co, smem_bytes);
}

// K2: x and y bfloat16 when bf16 != 0, else float32; the weights and
// biases float32. Returns cudaErrorInvalidValue for shapes no kernel takes
// (Co not a multiple of 4, too many output micro-tiles, shared memory). The
// tensor-core kernel runs every shape it takes (tc_takes), after the split
// kernel has written the weights into wfrag (so3_gate_ffn_words() words at
// the same bf16, 16-byte aligned); the CUDA-core instance the others, and
// every shape it takes when cuda_cores is non-zero (wfrag unused).
extern "C" int so3_gate_ffn(const void* x, const float* w1, const float* b1, const float* wg,
                            const float* bg, const float* w2, const float* b2, void* y,
                            void* wfrag, int N, int lmax, int C, int H, int Co, int cuda_cores,
                            int bf16, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return launch((const singa::bf16*)x, w1, b1, wg, bg, w2, b2, (singa::bf16*)y, wfrag, N, lmax,
                  C, H, Co, cuda_cores, st);
  return launch((const float*)x, w1, b1, wg, bg, w2, b2, (float*)y, wfrag, N, lmax, C, H, Co,
                cuda_cores, st);
}
