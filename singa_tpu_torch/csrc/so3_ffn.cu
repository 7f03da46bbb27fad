// K4: S2-activation SO(3) feed-forward network, forward.
//
// Replaces: singa_tpu/ops/pallas/so3_ffn.py::so3_ffn_fused (_ffn_fwd_kernel).
//   gate[n, :]   = silu(x[n, 0, :] @ wg + bg)                    (C -> H)
//   h[n, i, :]   = x[n, i, :] @ w1[l(i)]  (+ b1 on row 0)         (C -> H)
//   mid[n, :, k] = fg^T silu(tg h[n, :, k])   per hidden channel k
//   mid[n, 0, :] = gate[n, :]
//   y[n, i, :]   = mid[n, i, :] @ w2[l(i)]  (+ b2 on row 0)       (H -> Co)
// x [N, I=(lmax+1)^2, C], w1 [L, C, H], wg [C, H], w2 [L, H, Co],
// tg/fg [G, I] (l-primary, G = 210 at lmax 6).
//
// What bounds it on the H100: per node the two grid transforms do 2*G*I*H
// operations each (10.5 MFLOP at I = 49, G = 210, H = 512) and the two
// per-degree products 0.8 MFLOP each: ~22.7 MFLOP per node against 2 KB of
// x and y. At a training microbatch (N = 14,336) that is 325.4 GFLOP, 4.86
// ms at the 67 TFLOP/s float32 rate of the CUDA cores, against ~0.03 ms of
// memory: arithmetic bounds it. The tensor-core kernel runs 319.0 GFLOP of
// it (the grid transforms but their last row at lmax 6, h and y) as split
// TF32, three TF32 products each: 1.93 ms at 495 TFLOP/s, ~3.2 ms at the
// ~300 TFLOP/s this card issues mma.sync at (chip_smoke.py's mma_rate).
//
// Design (ffn_tc_kernel): the [N, I, H] hidden (1.44 GB here) and the
// [N, G, H] grid (6.2 GB) never reach device memory, as in the TPU kernel.
// A persistent block of 8 warps (one an SM) owns a tile of kTN = 8 nodes at
// a time, with y's float32 sums in registers, and walks the hidden
// dimension in chunks of kHC = 16 channels: 128 chain columns (column
// ch * 8 + node). Per chunk, between five barriers:
//   h      x_i w1[l] per row i, on the tensor cores: h^T = w1[l]^T x_i^T,
//          M = 16 channels, N = 8 nodes, K = C (warp w takes rows w + 8 r),
//          + b1 on row 0, into a float32 staging [I][136]; the gates
//          silu(x_0 wg + bg) in float32 on the CUDA cores (four warps)
//   split  the staging -> X^T split into TF32 hi and lo, in the chain's A
//          fragment order (grid_chain_tc_fwd's xfrag), once a chunk
//   chain  grid_chain_tc_fwd (csrc/s2_grid_tc.cuh): warp w takes the 32
//          columns 32 (w % 4) .. and half w / 4 of the grid, two 8-point
//          steps a pass; the to-grid product, formed transposed, leaves
//          silu(v) in registers as the from-grid product's B, so the
//          activated grid never touches shared memory and the chain has no
//          barrier; at lmax 6 the last coefficient row runs in float32 on
//          the CUDA cores
//   sum    the second half's from-grid sums through shared memory into the
//          first's: mid, row 0 := the gates, over the X^T fragments
//   y      y^T += w2[l]^T mid_i^T per row, M = Co (one m16 tile), N = 8
//          nodes, K = 16 channels, at the start of the next chunk beside
//          its h (the two short products overlap); each chunk's product
//          from zero on the tensor cores, added to the float32 sums (row
//          48's, the one row of a warp's last slot, in shared memory)
// The phases outside the chain are short chains of dependent loads and
// mma, so at lmax 6 their loops have no branch a row (every slot but the
// last holds a row), the degrees come from a table, and the split's trip
// count is known when compiling; in scratch builds on the H100 (not in the
// repository) that gained more than any change to the chain's warp map.
// Every product is three-product split TF32 (csrc/mma_tf32.cuh), float32
// to round-off. tg and fg are staged once a block in float32 and split as
// their fragments load. x comes once a tile, by cp.async during the
// previous tile's last chunk. A split kernel (ffn_wsplit_kernel) writes
// each chunk's weights once a call (w_layout: w1 and w2 as h's and y's A
// fragments, split, zero past C, H and Co, so any H takes the same path;
// wg, b1, bg in float32); the kernel copies a chunk's two parts with
// 16-byte cp.async from L2 (~30 KB a chunk and tile, ~1.7 GB a training
// call), part A of the next chunk and part B of this one while this
// chunk's split and chain run.
//
// Why this map: the chain's sums of 32 columns over every output row (3
// m16 x 4 n8 tiles) and y's of 6 rows stay in registers; each split
// fragment feeds several mma (X's two steps, tg's two column tiles, fg's
// four n8 tiles), and 8 warps at up to 255 registers keep them without
// spills. In scratch builds on the H100 (not in the repository), 16 warps
// of 16 columns ran about as fast but spilled at 128 registers; 12 warps
// (three parts of the grid), and one or three steps a pass, ran slower; 8
// warps that each take the whole grid ran far slower (too few warps to
// hide the chains' latency).
//
// Shapes: the tensor-core kernel takes lmax 1..6, C <= 16, Co <= 16 (a
// multiple of 4), any H and N. The other shapes K4 takes (lmax 7, C or Co
// above 16) run its CUDA-core instance (ffn_cc_kernel below, with
// s2_grid.cuh's chain), chosen by shape before the launch.
//
// bfloat16 (so3_ffn with bf16 set; the bfloat16 training path's K4): a
// kernel of its own, ffn_fwd_bf16_kernel in namespace bf below, every
// product a bfloat16 m16n8k16 mma.sync, at lmax 1..6 and C, Co multiples of
// 4 up to 16; no CUDA-core instance runs bfloat16, so any other width is
// refused.
//
// ptxas at lmax 6, C = Co = 16, H = 512 (sm_90a): 222 registers, no spills;
// 228,832 B of dynamic shared memory, 256 threads, one block an SM
// (chip_smoke.py's k4_ptxas and K4's residency).
#include "s2_grid.cuh"
#include "s2_grid_tc.cuh"

namespace {

using singa::degree_of;
using singa::tc::kSplitFragWords;

// ------------------------------- tensor cores -------------------------------
constexpr int kTN = 8;                       // nodes of a tile: the n8 of h and y
constexpr int kHC = 16;                      // hidden channels of a chunk: h's m16, y's k
constexpr int kNCOL = kHC * kTN;             // chain columns: column ch * kTN + node
constexpr int kGroups = kNCOL / 16;          // 16-column groups (the chain's m16)
constexpr int kColTiles = 2;                 // 16-column groups of a warp's chain
constexpr int kParts = 2;                    // warps of a column group, each half the grid
constexpr int kChainSteps = 2;               // grid steps a chain pass takes at once
constexpr int kWarps = kGroups / kColTiles * kParts;
constexpr int kThreads = 32 * kWarps;
constexpr int kHS = kNCOL + 8;               // row stride of the staging and mid (float2 stores)
constexpr int kMaxRows = (49 + kWarps - 1) / kWarps;  // coefficient rows of a warp in h and y
// y's sums of the warp's rows r < kMaxRows - 1 stay in registers; the last
// slot holds row 48 alone (49 = kWarps (kMaxRows - 1) + 1), whose sums stay
// in shared memory (sy48), so no warp keeps registers for a slot that
// only one row fills
static_assert(49 == kWarps * (kMaxRows - 1) + 1, "the last row slot is row 48's alone");
constexpr int kTcMaxC = 16;                  // input and output channels the kernel takes
static_assert(kThreads >= kNCOL, "a thread for each gate");

struct TcDims {
  int N, L, I, C, H, Co, G;
  int Gp, st, sf, KS, MT;  // grid rows, tg's and fg's strides, k steps, m16 tiles of the chain
};

__host__ __device__ inline TcDims make_tc_dims(int N, int lmax, int C, int H, int Co, int G) {
  TcDims d;
  d.N = N, d.L = lmax + 1, d.I = (lmax + 1) * (lmax + 1), d.C = C, d.H = H, d.Co = Co, d.G = G;
  const bool tail = d.I == 49;  // row 48 in float32 (grid_chain_tc_fwd)
  d.KS = tail ? 6 : (d.I + 7) / 8;
  d.MT = tail ? 3 : (d.I + 15) / 16;
  // a whole number of chain passes (kChainSteps steps of 8 points) for each part
  constexpr int q = 8 * kChainSteps * kParts;
  d.Gp = (G + q - 1) / q * q;
  d.st = singa::tc_stride(d.I);
  d.sf = singa::tc_fg_stride(d.I > 16 * d.MT ? d.I : 16 * d.MT);
  return d;
}

// words of the chain's X^T fragments, which mid reuses
__host__ __device__ inline int xfrag_words(const TcDims& d) {
  const int f = d.KS * kGroups * kSplitFragWords, p = d.I * kHS;
  return f > p ? f : p;
}

// One hidden chunk's weights as the split kernel writes them (words), in
// two parts that the kernel copies at different times:
//   part A: w1 as h's A (w1[l]^T: m = channel, k = c in order), split,
//           [l][k step][kSplitFragWords]; then wg [C8][kHC], b1 [kHC],
//           bg [kHC] as float32
//   part B: w2 as y's A (w2[l]^T: m = o, k = channel in order), split,
//           [l][k step][kSplitFragWords]
// zeros past C, H and Co. Both parts are 16-byte aligned.
struct WLayout {
  int wg, b1, bg, a, b, words;  // offsets in part A; part A's words, part B's, a chunk's
};

__host__ __device__ inline WLayout w_layout(int L, int C8) {
  constexpr int FW = singa::tc::kFragWords<float>;
  WLayout o;
  o.wg = L * (C8 / 8) * FW;
  o.b1 = o.wg + C8 * kHC;
  o.bg = o.b1 + kHC;
  o.a = o.bg + kHC;
  o.b = L * (kHC / 8) * FW;
  o.words = o.a + o.b;
  return o;
}

__host__ __device__ inline size_t tc_smem_floats(const TcDims& d, int C8) {
  return (size_t)d.Gp * (d.st + d.sf) + (size_t)d.I * C8 * kTN + (size_t)d.I * kHS +
         xfrag_words(d) + (size_t)w_layout(d.L, C8).words + kNCOL + 128 + 16 + 64;
}

// Every chunk's words (w_layout), one item a lane of one fragment or one
// float32: the weights split into TF32 hi and lo once a call.
template <int C8>
__global__ void ffn_wsplit_kernel(const float* __restrict__ w1, const float* __restrict__ b1,
                                  const float* __restrict__ wg, const float* __restrict__ bg,
                                  const float* __restrict__ w2, uint32_t* __restrict__ out,
                                  TcDims d) {
  using namespace singa::tc;
  constexpr int KC = C8 / 8;
  const WLayout o = w_layout(d.L, C8);
  const int n1 = d.L * KC * 32, n2 = n1 + d.L * (kHC / 8) * 32;  // w1's lanes, then w2's
  const int items = n2 + (o.a - o.wg);
  const long long total = (long long)((d.H + kHC - 1) / kHC) * items;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const int chunk = (int)(e / items), r = (int)(e % items), h0 = chunk * kHC;
    uint32_t* blk = out + (long long)chunk * o.words;
    if (r >= n2) {  // wg [c][ch], then b1, then bg, float32
      const int q = r - n2, ch = q % kHC, h = h0 + ch;
      float v = 0.f;
      if (q < C8 * kHC) {
        const int c = q / kHC;
        if (c < d.C && h < d.H) v = wg[(long long)c * d.H + h];
      } else if (h < d.H) {
        v = q < C8 * kHC + kHC ? b1[h] : bg[h];
      }
      blk[o.wg + q] = __float_as_uint(v);
      continue;
    }
    // a lane (g, t) of one A fragment: (m = g / g + 8, k = t / t + 4)
    const bool is1 = r < n1;
    const int f = is1 ? r / 32 : (r - n1) / 32, lane = r % 32, g = lane >> 2, t = lane & 3;
    const int KS = is1 ? KC : kHC / 8, l = f / KS, ks = f % KS;
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int m = g + 8 * (q & 1), k = 8 * ks + t + 4 * (q >> 1);
      v[q] = 0.f;
      if (is1) {  // h's A: w1[l][c = k][channel = m]
        if (k < d.C && h0 + m < d.H) v[q] = w1[((long long)l * d.C + k) * d.H + h0 + m];
      } else {  // y's A: w2[l][channel = k][o = m]
        if (m < d.Co && h0 + k < d.H) v[q] = w2[((long long)l * d.H + h0 + k) * d.Co + m];
      }
    }
    store_a_t<float>(blk + (is1 ? 0 : o.a) + f * kFragWords<float>, lane, v[0], v[1], v[2],
                     v[3]);
  }
}


__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(a), "l"(src),
               "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a), "l"(src));
}

// `words` words (a multiple of 4, 16-byte aligned) from device to shared
// memory in 16-byte pieces; the caller commits
__device__ void copy_words(const uint32_t* __restrict__ src, int words, uint32_t* dst) {
  for (int q = threadIdx.x; q < words / 4; q += kThreads) cp_async16(dst + 4 * q, src + 4 * q);
}

// x of the tile at node n0 -> sx [i][c][node], zeros past N and C; joins
// the caller's next commit group
template <int C8>
__device__ void copy_x(const float* __restrict__ x, int n0, const TcDims& d, float* sx) {
  for (int t = threadIdx.x; t < kTN * d.I * C8; t += kThreads) {
    const int node = t / (d.I * C8), i = (t / C8) % d.I, c = t % C8;
    const bool ok = n0 + node < d.N && c < d.C;
    cp_async4(sx + (i * C8 + c) * kTN + node,
              ok ? x + ((long long)(n0 + node) * d.I + i) * d.C + c : x, ok);
  }
}

// KC: k steps of h (C <= 8 KC); I0: 49 at lmax 6 (the tail row), else 0
template <int KC, int I0>
__global__ void __launch_bounds__(kThreads, 1)
ffn_tc_kernel(const float* __restrict__ x, const float* __restrict__ w1,
              const float* __restrict__ b1, const float* __restrict__ wg,
              const float* __restrict__ bg, const float* __restrict__ w2,
              const float* __restrict__ b2, const float* __restrict__ tg,
              const float* __restrict__ fg, const uint32_t* __restrict__ wfrag,
              float* __restrict__ y, TcDims d) {
  using namespace singa::tc;
  using T = float;  // the storage type (the split TF32 helpers' parameter)
  constexpr int C8 = 8 * KC;
  constexpr bool kTail = I0 == 49;
  constexpr int FW = kFragWords<T>;  // words of one split fragment
  const int L = d.L, I = d.I, H = d.H, Co = d.Co;
  extern __shared__ __align__(16) float smem[];
  float* stg = smem;                                           // [Gp][st]
  float* sfg = stg + d.Gp * d.st;                              // [Gp][sf]
  float* sx = sfg + d.Gp * d.sf;                               // [I][C8][kTN]
  float* sst = sx + I * C8 * kTN;                              // [I][kHS]: h (the staging)
  uint32_t* sxf = reinterpret_cast<uint32_t*>(sst + I * kHS);  // X^T split, then mid
  const WLayout wl = w_layout(L, C8);
  uint32_t* swa = sxf + xfrag_words(d);  // the chunk's part A: w1 split, wg, b1, bg
  uint32_t* swb = swa + wl.a;            // its part B: w2 split
  const float* swg = reinterpret_cast<const float*>(swa + wl.wg);  // [C8][kHC]
  const float* sb1 = reinterpret_cast<const float*>(swa + wl.b1);  // [kHC]
  const float* sbg = reinterpret_cast<const float*>(swa + wl.bg);  // [kHC]
  float* sgate = reinterpret_cast<float*>(swb + wl.b);             // [kNCOL]: mid's row 0
  float* sy48 = sgate + kNCOL;  // [32 lanes][4]: y's sums of row 48 (its warp's C fragment)
  float* sb2 = sy48 + 128;      // [16]: b2, zero past Co
  int* sdeg = reinterpret_cast<int*>(sb2 + 16);  // [64]: the degree of each row

  const int tid = threadIdx.x, warp = tid >> 5;
  const int grp = lane_grp(), tig = lane_tig();
  const int chunks = (H + kHC - 1) / kHC;
  // the warp's chain columns (16-column groups kColTiles cg ..) and part of the grid
  const int cg = warp % (kGroups / kColTiles), part = warp / (kGroups / kColTiles);
  const int s0 = part * (d.Gp / 8 / kParts), s1 = s0 + d.Gp / 8 / kParts;
  const int gate0 = kThreads - kNCOL;  // the threads of the gates: the last four warps
  // tg, fg (zero-padded), in the first commit group
  for (int t = tid; t < d.Gp * d.st; t += kThreads) {
    const int g = t / d.st, i = t % d.st;
    const bool ok = g < d.G && i < I;
    cp_async4(stg + t, ok ? tg + g * I + i : tg, ok);
  }
  for (int t = tid; t < d.Gp * d.sf; t += kThreads) {
    const int g = t / d.sf, i = t % d.sf;
    const bool ok = g < d.G && i < I;
    cp_async4(sfg + t, ok ? fg + g * I + i : fg, ok);
  }
  // the block's (tile, chunk) steps, tiles blockIdx.x, + gridDim.x, ..., the
  // chunks inside; step j's y product runs at the start of step j + 1,
  // beside its h (one barrier fewer a chunk, and the two short products
  // overlap)
  const int tiles = (d.N + kTN - 1) / kTN;
  const int steps = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x * chunks;
  copy_x<C8>(x, blockIdx.x * kTN, d, sx);  // the first tile's x and chunk's part A
  copy_words(wfrag, wl.a, swa);
  cp_async_commit();
  if (tid < 16) sb2[tid] = tid < Co ? b2[tid] : 0.f;  // read after the first barriers
  if (tid < 64) sdeg[tid] = degree_of(tid);
  // a warp's rows i = warp + kWarps r: at I = 49 every slot but the last
  // holds a row, so those rows run without a branch and interleave
  auto has_row = [&](int r, int i) { return (kTail && r < kMaxRows - 1) || i < I; };
  float* mid = reinterpret_cast<float*>(sxf);  // [I][kHS]: the second half's sums, then mid
  float yacc[kMaxRows - 1][4];  // y^T of the warp's rows: (o = grp (+8), node = 2 tig (+1))
#pragma unroll
  for (int r = 0; r < kMaxRows - 1; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) yacc[r][q] = 0.f;
  if (warp == 0)  // row 48's sums: each lane's own four, read and written by it alone
    for (int q = 0; q < 4; ++q) sy48[4 * (tid & 31) + q] = 0.f;

  for (int j = 0; j <= steps; ++j) {
    cp_async_wait<0>();  // step j's part A, step j - 1's part B, the tile's x
    __syncthreads();     // B0: everyone's copies; step j - 1's mid is complete
    if (j > 0) {
      // y^T += w2[l]^T mid_i^T for step j - 1, its product from zero
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        const int i = warp + kWarps * r;
        if (has_row(r, i)) {
          const int l = sdeg[i];
          float p[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int ks = 0; ks < kHC / 8; ++ks)
            mma_t<T>(p, frag_a_split_t<T>(swb + (l * (kHC / 8) + ks) * FW),
                     frag_b<T>(mid + i * kHS + 8 * ks * kTN, kTN));
          if (r < kMaxRows - 1) {
#pragma unroll
            for (int q = 0; q < 4; ++q) yacc[r < kMaxRows - 1 ? r : 0][q] += p[q];
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q) sy48[4 * (tid & 31) + q] += p[q];
          }
        }
      }
      if (j % chunks == 0) {  // step j - 1 was its tile's last chunk: y of the tile (+ b2 on row 0)
        const int n0 = (blockIdx.x + (j / chunks - 1) * gridDim.x) * kTN;
#pragma unroll
        for (int r = 0; r < kMaxRows; ++r) {
          const int i = warp + kWarps * r;
          if (has_row(r, i))
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int o = grp + 8 * (q >> 1), node = n0 + 2 * tig + (q & 1);
              float v;
              if (r < kMaxRows - 1) {
                v = yacc[r < kMaxRows - 1 ? r : 0][q];
                yacc[r < kMaxRows - 1 ? r : 0][q] = 0.f;
              } else {
                v = sy48[4 * (tid & 31) + q];
                sy48[4 * (tid & 31) + q] = 0.f;
              }
              if (o < Co && node < d.N)
                y[((long long)node * I + i) * Co + o] = v + (i == 0 ? sb2[o] : 0.f);
            }
        }
      }
    }
    if (j == steps) break;
    const int k = j % chunks, tile = blockIdx.x + j / chunks * gridDim.x;
    // h^T = w1[l]^T x_i^T (+ b1 on row 0) -> staging, columns ch * kTN + node
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      const int i = warp + kWarps * r;
      if (has_row(r, i)) {
        const int l = sdeg[i];
        float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int ks = 0; ks < KC; ++ks)
          mma_t<T>(c, frag_a_split_t<T>(swa + (l * KC + ks) * FW),
                   frag_b<T>(sx + (i * C8 + 8 * ks) * kTN, kTN));
        const float b0 = i == 0 ? sb1[grp] : 0.f, b8 = i == 0 ? sb1[grp + 8] : 0.f;  // b1, row 0
        c[0] += b0;
        c[1] += b0;
        c[2] += b8;
        c[3] += b8;
        store_c(sst + i * kHS, kTN, c);
      }
    }
    if (tid >= gate0) {  // the gates, float32: mid's row 0
      const int t = tid - gate0, ch = t / kTN, node = t % kTN;
      float v = sbg[ch];
#pragma unroll
      for (int c = 0; c < C8; ++c) v = fmaf(sx[c * kTN + node], swg[c * kHC + ch], v);  // 0 past C
      sgate[t] = singa::siluf_(v);
    }
    __syncthreads();  // B1: y is done with part B and mid, h and the gates with sx and part A
    if (k + 1 == chunks)  // the block's next tile's x
      copy_x<C8>(x, (tile + gridDim.x) * kTN, d, sx);
    copy_words(wfrag + (long long)((k + 1) % chunks) * wl.words, wl.a, swa);  // the next chunk's
    copy_words(wfrag + (long long)k * wl.words + wl.a, wl.b, swb);  // this chunk's w2
    cp_async_commit();
    // the staging -> X^T split, in the chain's fragment order
    const int KS = kTail ? (I0 - 1) / 8 : d.KS;  // known when compiling at I = 49
#pragma unroll 2
    for (int e = tid; e < KS * kGroups * 32; e += kThreads) {
      const int ln = e & 31, g = (e >> 5) % kGroups, ks = e / (32 * kGroups);
      const int i0 = 8 * ks + 2 * (ln & 3), col = 16 * g + (ln >> 2);
      const float* src = sst + i0 * kHS + col;
      const bool r0 = kTail || i0 < I, r1 = kTail || i0 + 1 < I;  // at I = 49 every row is there
      const float a0 = r0 ? src[0] : 0.f, a1 = r0 ? src[8] : 0.f;
      const float a2 = r1 ? src[kHS] : 0.f, a3 = r1 ? src[kHS + 8] : 0.f;
      store_a_t<T>(sxf + (ks * kGroups + g) * FW, ln, a0, a1, a2, a3);
    }
    __syncthreads();  // B2
    constexpr int kJ = 2 * kColTiles;  // n8 tiles of the warp's columns
    float acc[singa::kFwdMaxMT][kJ][4], tl[kJ];
    singa::grid_chain_tc_fwd<I0, kChainSteps, kColTiles, singa::kFwdMaxKS, singa::kFwdMaxMT, T>(
        stg, d.st, sfg, d.sf, sxf, sst + (kTail ? I0 - 1 : 0) * kHS, I, kGroups, cg, s0, s1, acc,
        tl);
#pragma unroll
    for (int n = 0; n < kJ; ++n) {  // the tail row: the four lanes of a column
      tl[n] += __shfl_xor_sync(0xffffffffu, tl[n], 1);
      tl[n] += __shfl_xor_sync(0xffffffffu, tl[n], 2);
    }
    const int c0 = 16 * kColTiles * cg;  // the warp's first column
    __syncthreads();  // B3: every chain is done with sxf
    if (part == 1) {  // the second half's sums, [I][kHS], over sxf (mid's place)
#pragma unroll
      for (int mt = 0; mt < singa::kFwdMaxMT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 16 * mt + grp + 8 * h;
          if (kTail || (mt < d.MT && i < I))  // at I = 49: the 48 rows of 3 m16 tiles
#pragma unroll
            for (int n = 0; n < kJ; ++n)
              *reinterpret_cast<float2*>(mid + i * kHS + c0 + 8 * n + 2 * tig) =
                  make_float2(acc[mt][n][2 * h], acc[mt][n][2 * h + 1]);
        }
      if (kTail && tig == 0)
#pragma unroll
        for (int n = 0; n < kJ; ++n) mid[(I0 - 1) * kHS + c0 + 8 * n + grp] = tl[n];
    }
    __syncthreads();  // B4
    if (part == 0) {  // mid = the halves' sums (over the second's, in place), row 0 := gates
#pragma unroll
      for (int mt = 0; mt < singa::kFwdMaxMT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 16 * mt + grp + 8 * h;
          if (kTail || (mt < d.MT && i < I))  // at I = 49: the 48 rows of 3 m16 tiles
#pragma unroll
            for (int n = 0; n < kJ; ++n) {
              const int at = i * kHS + c0 + 8 * n + 2 * tig;
              const float2 o = *reinterpret_cast<const float2*>(mid + at);
              float2 m = make_float2(acc[mt][n][2 * h] + o.x, acc[mt][n][2 * h + 1] + o.y);
              if (i == 0) m = make_float2(sgate[at], sgate[at + 1]);
              *reinterpret_cast<float2*>(mid + at) = m;
            }
        }
      if (kTail && tig == 0)
#pragma unroll
        for (int n = 0; n < kJ; ++n) {
          const int at = (I0 - 1) * kHS + c0 + 8 * n + grp;
          mid[at] += tl[n];
        }
    }
  }
}

using TcKernel = void (*)(const float*, const float*, const float*, const float*, const float*,
                          const float*, const float*, const float*, const float*, const uint32_t*,
                          float*, TcDims);
using SplitKernel = void (*)(const float*, const float*, const float*, const float*, const float*,
                             uint32_t*, TcDims);

// The tensor-core kernel's and the split kernel's instances for C input
// channels and I rows (null: none), and the kernel's shared memory
TcKernel tc_kernel(int C, int I) {
  if (C < 1 || C > kTcMaxC || I > 49) return nullptr;
  if (C <= 8) return I == 49 ? ffn_tc_kernel<1, 49> : ffn_tc_kernel<1, 0>;
  return I == 49 ? ffn_tc_kernel<2, 49> : ffn_tc_kernel<2, 0>;
}

SplitKernel split_kernel(int C) {
  return C <= 8 ? ffn_wsplit_kernel<8> : ffn_wsplit_kernel<16>;
}

// 32-bit words of the split weights: every hidden chunk's w_layout
long long tc_words(const TcDims& d) {
  return (long long)((d.H + kHC - 1) / kHC) * w_layout(d.L, d.C <= 8 ? 8 : 16).words;
}

size_t tc_smem(const TcDims& d) {
  return tc_smem_floats(d, d.C <= 8 ? 8 : 16) * sizeof(float);
}

// Whether the tensor-core kernel takes these widths: lmax 1..6, C <= 16,
// Co <= 16 (a multiple of 4, as for every instance), and its shared memory
bool tc_takes(int lmax, int C, int H, int Co, int G) {
  if (lmax < 1 || lmax > 6 || C < 1 || C > kTcMaxC || H < 1 || Co < 4 || Co > kTcMaxC ||
      Co % 4 != 0 || G < 1)
    return false;
  const TcDims d = make_tc_dims(1, lmax, C, H, Co, G);
  return singa::allow_smem(tc_kernel(C, d.I), tc_smem(d)) == cudaSuccess;
}

// ------------------------------- CUDA cores --------------------------------
// The CUDA-core kernel, for the widths the tensor-core kernel does not take:
// the design of so3_gate_ffn.cu (a block owns a tile of kTN = 8 nodes and
// walks the hidden dimension in chunks of kHC = 16 channels, y in registers
// across the chunks), each chunk's weight slices staged, the gates and the
// hidden slice as register micro-tiles, s2_grid.cuh's chain over the 128
// columns, then mid's contribution to y. tg and fg (padded) are staged once
// per block; one block per SM, each walking node tiles.
namespace cc {


constexpr int kThreads = singa::kChainThreads;
constexpr int kNG = 2;             // groups of four nodes per tile
constexpr int kTN = 4 * kNG;       // nodes per tile
constexpr int kHC = 16;            // hidden channels per chunk
constexpr int kNCOL = kHC * kTN;   // grid-chain columns per chunk
constexpr int kPad = 8;            // floats added to each row block of sx and sh
constexpr int kMaxJobs = 2;        // output micro-tiles per thread

using singa::degree_of;
using singa::fma4;

struct Dims {
  int N, lmax, L, I, Ip, C, H, Co, G;
};

__host__ __device__ inline Dims make_dims(int N, int lmax, int C, int H, int Co, int G) {
  const int I = (lmax + 1) * (lmax + 1);
  return Dims{N, lmax, lmax + 1, I, singa::pad_rows(I), C, H, Co, G};
}

__host__ __device__ inline size_t smem_floats(const Dims& d) {
  return singa::grid_mats_floats(d.G, d.I) + (size_t)d.I * (d.C * kTN + kPad) +
         (size_t)d.Ip * (kNCOL + kPad) + (size_t)singa::kGC * kNCOL + (size_t)d.L * d.C * kHC +
         (size_t)d.C * kHC + (size_t)d.L * kHC * d.Co + kNCOL;
}

__global__ void __launch_bounds__(kThreads, 1)
ffn_cc_kernel(const float* __restrict__ x, const float* __restrict__ w1,
           const float* __restrict__ b1, const float* __restrict__ wg,
           const float* __restrict__ bg, const float* __restrict__ w2,
           const float* __restrict__ b2, const float* __restrict__ tg,
           const float* __restrict__ fg, float* __restrict__ y, Dims d) {
  const int L = d.L, I = d.I, C = d.C, H = d.H, Co = d.Co;
  const int xs = C * kTN + kPad;  // row stride of sx
  const int hs = kNCOL + kPad;    // row stride of sh
  extern __shared__ __align__(16) float smem[];
  float* stg = smem;                                   // [Gp][Ip]
  float* sfg = stg + singa::grid_mats_floats(d.G, I) / 2;  // [Gp][Ip]
  float* sx = sfg + singa::grid_mats_floats(d.G, I) / 2;   // [I][C][kTN] (+pad per row)
  float* sh = sx + I * xs;                             // [Ip][kHC][kTN] (+pad): h, then mid
  float* sact = sh + d.Ip * hs;                        // [kGC][kNCOL]
  float* sw1 = sact + singa::kGC * kNCOL;              // [L, C, kHC]
  float* swg = sw1 + L * C * kHC;                      // [C, kHC]
  float* sw2 = swg + C * kHC;                          // [L, kHC, Co]
  float* sgate = sw2 + L * kHC * Co;                   // [kHC][kTN]

  const int tid = threadIdx.x;
  const int C4 = Co / 4;
  const int njobs = kNG * I * C4;
  singa::stage_grid_mats(tg, fg, d.G, I, stg, sfg);
  for (int t = tid; t < (d.Ip - I) * hs; t += kThreads) sh[I * hs + t] = 0.f;  // padded rows

  const int tiles = (d.N + kTN - 1) / kTN;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int n0 = tile * kTN;
    __syncthreads();  // the previous tile's readers of sx are done
    for (int t = tid; t < kTN * I * C; t += kThreads) {
      const int n = t / (I * C), i = (t / C) % I, c = t % C;
      sx[i * xs + c * kTN + n] = (n0 + n < d.N) ? x[(long long)n0 * I * C + t] : 0.f;
    }
    float4 acc[kMaxJobs][4];
#pragma unroll
    for (int k = 0; k < kMaxJobs; ++k)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[k][q] = make_float4(0.f, 0.f, 0.f, 0.f);

    for (int h0 = 0; h0 < H; h0 += kHC) {
      __syncthreads();  // the previous chunk's readers of the weights and of mid are done
      for (int t = tid; t < L * C * kHC; t += kThreads) {
        const int h = t % kHC, lc = t / kHC;
        sw1[t] = (h0 + h < H) ? w1[(long long)lc * H + h0 + h] : 0.f;
      }
      for (int t = tid; t < C * kHC; t += kThreads) {
        const int h = t % kHC, c = t / kHC;
        swg[t] = (h0 + h < H) ? wg[(long long)c * H + h0 + h] : 0.f;
      }
      for (int t = tid; t < L * kHC * Co; t += kThreads) {
        const int o = t % Co, h = (t / Co) % kHC, l = t / (Co * kHC);
        sw2[t] = (h0 + h < H) ? w2[((long long)l * H + h0 + h) * Co + o] : 0.f;
      }
      __syncthreads();

      // gates silu(x0 @ wg + bg), [kHC][kTN]: mid's row 0
      for (int t = tid; t < kNCOL; t += kThreads) {
        const int n = t % kTN, h = t / kTN;
        float v = (h0 + h < H) ? bg[h0 + h] : 0.f;
        for (int c = 0; c < C; ++c) v = fmaf(sx[c * kTN + n], swg[c * kHC + h], v);
        sgate[t] = singa::siluf_(v);
      }
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
          if (i == 0 && h0 + h < H) {
            const float bb = b1[h0 + h];
            a[r].x += bb;
            a[r].y += bb;
            a[r].z += bb;
            a[r].w += bb;
          }
          *reinterpret_cast<float4*>(sh + i * hs + h * kTN + 4 * ng) = a[r];
        }
      }
      __syncthreads();

      // mid = fg^T silu(tg h) over the 128 columns, row 0 := gates, over h
      singa::grid_chain<kNCOL, false, true, false>(stg, sfg, d.G, I, sh, nullptr, hs, sact,
                                                   nullptr, sh, nullptr, hs, sgate);
      __syncthreads();

      // output micro-tiles: four nodes x four output channels of one row
#pragma unroll
      for (int k = 0; k < kMaxJobs; ++k) {
        const int j = tid + k * kThreads;
        if (j < njobs) {
          const int o4 = j % C4, ng = (j / C4) % kNG, i = j / (C4 * kNG);
          const int l = degree_of(i);
          const float* mr = sh + i * hs + 4 * ng;
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
          if (n < d.N) {
            float4 a = acc[k][q];
            if (i == 0) {
              a.x += b2[4 * o4];
              a.y += b2[4 * o4 + 1];
              a.z += b2[4 * o4 + 2];
              a.w += b2[4 * o4 + 3];
            }
            *reinterpret_cast<float4*>(y + ((long long)n * I + i) * Co + 4 * o4) = a;
          }
        }
      }
    }
  }
}


// Whether the CUDA-core kernel takes these widths
bool cc_takes(int lmax, int C, int H, int Co, int G) {
  if (lmax < 1 || C < 1 || H < 1 || Co < 4 || Co % 4 != 0 || G < 1) return false;
  const Dims d = make_dims(1, lmax, C, H, Co, G);
  if (!singa::chain_fits(kNCOL, 1, d.I) || kNG * d.I * (Co / 4) > kMaxJobs * kThreads)
    return false;
  return singa::allow_smem(ffn_cc_kernel, smem_floats(d) * sizeof(float)) == cudaSuccess;
}

}  // namespace cc

// ------------------------------- bfloat16 --------------------------------
// The bfloat16 instance (so3_ffn with bf16 set; the bfloat16 training
// path's K4): the function _ffn_fwd_kernel computes at a bfloat16 x,
// rounding where it rounds, with every product a bfloat16 m16n8k16
// mma.sync (csrc/mma_bf16.cuh): the product of two bfloat16 values is
// exact in float32, so one m16n8k16 gives what one TF32 m16n8k8 of the same
// values gives, twice as deep, on 2-byte operands.
//
// Roundings: h rounded after b1 (h.astype(dt)); silu(v) rounded before the
// from-grid product; the gates silu(x0 wg + bg) rounded (gate.astype(dt));
// mid rounded as y reads it (mid.astype(dt), row 0 the gates); y rounded
// at the store; w1, wg and w2 rounded once a call (b1, bg, b2 float32);
// every sum float32.
//
// Design (ffn_fwd_bf16_kernel): a persistent block of 16 warps (one an SM)
// owns a tile of kTN = 8 nodes at a time, y's float32 sums in registers,
// and walks the hidden dimension in chunks of kHC = 16 channels: 128 chain
// columns (column ch * kTN + node). x, tg and fg stay bfloat16 in shared
// memory: tg and fg staged once a block, x once a tile by cp.async (16-byte
// pieces, 8-byte where C is not a multiple of 8), during the previous
// tile's last chunk. A weight kernel (ffn_wfrag_bf16_kernel) rounds w1 and
// w2 once a call into the A fragments of h's and y's products, and wg into
// float32 values of bfloat16; the kernel copies each chunk's words (8.1 KB
// at lmax 6) by cp.async into the other of two buffers while a chunk runs.
// Per (tile, chunk), between three barriers:
//   y      y^T += w2[l]^T mid_i^T for the step before, one m16n8k16 a row
//          (M = Co, N = 8 nodes, K = 16 channels; mid by ldmatrix .trans),
//          warp w taking rows w + 16 r; at a tile's last chunk y is stored
//   h      h^T = w1[l]^T x_i^T (+ b1 on row 0), one m16n8k16 a row (M = 16
//          channels, N = 8 nodes, K = C padded to 16 with zeros; x by
//          ldmatrix), rounded and stored as bfloat16 pairs into h [row]
//          [column] (a lane's pair is two neighbouring columns: no bank
//          conflict); the gates in float32 on the CUDA cores (four warps:
//          C multiply-adds a gate)
//   chain  grid_chain_mma16_fwd (csrc/s2_grid_tc.cuh): warp w takes the 16
//          columns 16 (w % 8) .. and half w / 8 of the grid; silu(v) stays
//          in registers as the from-grid B, no barrier; at lmax 6 the last
//          row in float32 on the CUDA cores
//   sum    the second half's sums through shared memory into the first's,
//          rounded into mid (bfloat16 [row][column]), row 0 := the gates
// ptxas and residency: chip_smoke.py's k4_bf16_ptxas and K4·bf16's row.
namespace bf {

using singa::bf16;
namespace mma16 = singa::mma16;

constexpr int kTN = 8;                      // nodes of a tile: the n8 of h and y
constexpr int kHC = 16;                     // hidden channels of a chunk: h's m16, y's k16
constexpr int kNCOL = kHC * kTN;            // chain columns: column ch * kTN + node
constexpr int kColTiles = kNCOL / 16;       // the chain's 16-column tiles
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kParts = kWarps / kColTiles;  // warps of a column tile, each half the grid
constexpr int kXS = kNCOL + 8;  // row stride (values) of h and mid: 17 16-byte units
constexpr int kXC = 24;         // row stride (values) of x [row][node][c]: 3 16-byte units
constexpr int kMS = kNCOL + 8;  // row stride (floats) of the halves' exchange
constexpr int kFragWords = 128;  // an m16 x k16 A fragment: four words a lane
constexpr int kMaxRows = 4;      // rows of a warp in h and y: i = warp + 16 r
static_assert(kParts == 2, "two halves of the grid a column tile: one exchange of sums");
static_assert(49 == kWarps * (kMaxRows - 1) + 1, "the last row slot is row 48's alone");
static_assert(kThreads >= kNCOL, "a thread for each gate");

// S: the row stride (values) of the staged tg and fg, 16 KS + 8, odd in
// 16-byte units; KS: k16 steps of the to-grid product and m16 tiles of the
// from-grid one (rows 0 .. 47 at I 49); XR: rows of h staged (rows past I
// zero).
struct Dims {
  int N, L, I, C, H, Co, G, Gp, S, KS, XR;
};

__host__ __device__ inline Dims make_dims(int N, int lmax, int C, int H, int Co, int G) {
  Dims d;
  d.N = N, d.L = lmax + 1, d.I = d.L * d.L, d.C = C, d.H = H, d.Co = Co, d.G = G;
  d.KS = ((d.I == 49 ? 48 : d.I) + 15) / 16;
  d.S = 16 * d.KS + 8;
  constexpr int q = 16 * kParts;  // whole k16 grid steps for each part
  d.Gp = (G + q - 1) / q * q;
  d.XR = d.I > 16 * d.KS ? d.I : 16 * d.KS;
  return d;
}

// One hidden chunk's weights (32-bit words) as ffn_wfrag_bf16_kernel writes
// them: w1 as h's A fragments [l][lane][4] (m = channel, k = c), then w2 as
// y's (m = o, k = channel), bfloat16 pairs; wg [16][kHC], b1 [kHC] and bg
// [kHC] as float32 (wg's values bfloat16's); zeros past C, H and Co.
struct WLayout {
  int w2, wg, b1, bg, words;
};

__host__ __device__ inline WLayout w_layout(int L) {
  WLayout o;
  o.w2 = L * kFragWords;
  o.wg = 2 * L * kFragWords;
  o.b1 = o.wg + 16 * kHC;
  o.bg = o.b1 + kHC;
  o.words = o.bg + kHC;
  return o;
}

inline long long words(const Dims& d) {
  return (long long)((d.H + kHC - 1) / kHC) * w_layout(d.L).words;
}

// float32 words first (the two weight buffers, the exchange, the gates,
// row 48's y sums, b2, the degrees), then the bfloat16 arrays
inline size_t smem_bytes(const Dims& d) {
  const size_t fl = 2 * (size_t)w_layout(d.L).words + (size_t)d.I * kMS + kNCOL + 128 + 16 + 64;
  const size_t b16 = 2 * (size_t)d.Gp * d.S + (size_t)d.XR * kXS + (size_t)d.I * kTN * kXC +
                     (size_t)d.I * kXS;
  return fl * sizeof(float) + b16 * sizeof(bf16);
}

// Every chunk's words (w_layout), one word an item.
__global__ void ffn_wfrag_bf16_kernel(const float* __restrict__ w1, const float* __restrict__ b1,
                                      const float* __restrict__ wg, const float* __restrict__ bg,
                                      const float* __restrict__ w2, uint32_t* __restrict__ out,
                                      Dims d) {
  const WLayout o = w_layout(d.L);
  const long long total = (long long)((d.H + kHC - 1) / kHC) * o.words;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const int chunk = (int)(e / o.words), r = (int)(e % o.words), h0 = chunk * kHC;
    uint32_t v;
    if (r < o.wg) {  // register q of lane (grp, tig) of one A fragment
      const bool is1 = r < o.w2;
      const int f = is1 ? r : r - o.w2, l = f / kFragWords, lane = (f / 4) % 32, q = f % 4;
      const int m = (lane >> 2) + 8 * (q & 1), k0 = 2 * (lane & 3) + 8 * (q >> 1);
      float x[2];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int k = k0 + p;
        x[p] = 0.f;
        if (is1) {  // h's A: w1[l][c = k][channel = m]
          if (k < d.C && h0 + m < d.H) x[p] = w1[((long long)l * d.C + k) * d.H + h0 + m];
        } else {  // y's A: w2[l][channel = k][o = m]
          if (m < d.Co && h0 + k < d.H) x[p] = w2[((long long)l * d.H + h0 + k) * d.Co + m];
        }
      }
      v = mma16::pack(x[0], x[1]);
    } else if (r < o.b1) {  // wg [c][ch], rounded
      const int q = r - o.wg, c = q / kHC, h = h0 + q % kHC;
      v = __float_as_uint(c < d.C && h < d.H ? singa::rnd<bf16>(wg[(long long)c * d.H + h]) : 0.f);
    } else {  // b1, bg
      const int q = r - o.b1, h = h0 + q % kHC;
      v = __float_as_uint(h < d.H ? (q < kHC ? b1[h] : bg[h]) : 0.f);
    }
    out[(long long)chunk * o.words + r] = v;
  }
}

__device__ __forceinline__ void cp_async16z(void* dst, const void* src, bool ok) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async8z(void* dst, const void* src, bool ok) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(a), "l"(src),
               "r"(ok ? 8 : 0));
}

// x of the tile at node n0 -> sx [i][node][kXC] (zeros for nodes past N;
// channels past C are never written), in 16-byte pieces where C is a
// multiple of 8, else 8-byte ones; joins the caller's next commit group
__device__ void copy_x(const bf16* __restrict__ x, int n0, const Dims& d, bf16* sx) {
  const int I = d.I, C = d.C, w = d.C % 8 == 0 ? 8 : 4, P = C / w;  // piece: w values
  for (int t = threadIdx.x; t < kTN * I * P; t += kThreads) {
    const int node = t / (I * P), i = (t / P) % I, p = t % P;
    const bool ok = n0 + node < d.N;
    bf16* dst = sx + (i * kTN + node) * kXC + w * p;
    const bf16* src = ok ? x + ((long long)(n0 + node) * I + i) * C + w * p : x;
    if (w == 8)
      cp_async16z(dst, src, ok);
    else
      cp_async8z(dst, src, ok);
  }
}

// `words` words (a multiple of 4, 16-byte aligned) into shared memory by
// 16-byte cp.async; joins the caller's next commit group
__device__ void copy_words(const uint32_t* __restrict__ src, int words, uint32_t* dst) {
  for (int q = threadIdx.x; q < words / 4; q += kThreads) cp_async16(dst + 4 * q, src + 4 * q);
}

// I0: 49 at lmax 6 (row 48 in float32, grid_chain_mma16_fwd), else 0
template <int I0>
__global__ void __launch_bounds__(kThreads, 1)
ffn_fwd_bf16_kernel(const bf16* __restrict__ x, const float* __restrict__ b2,
                    const bf16* __restrict__ tg, const bf16* __restrict__ fg,
                    const uint32_t* __restrict__ wfrag, bf16* __restrict__ y, Dims d) {
  constexpr bool kTail = I0 == 49;
  const int I = d.I, C = d.C, Co = d.Co, S = d.S;
  const WLayout wl = w_layout(d.L);
  extern __shared__ __align__(16) float smem[];
  uint32_t* swb = reinterpret_cast<uint32_t*>(smem);  // [2][wl.words]: two chunks' weights
  float* smf = reinterpret_cast<float*>(swb + 2 * wl.words);  // [I][kMS]: the second half's sums
  float* sgate = smf + I * kMS;                     // [kNCOL]: mid's row 0, rounded
  float* sy48 = sgate + kNCOL;                      // [32 lanes][4]: y's sums of row 48
  float* sb2 = sy48 + 128;                          // [16]: b2, zero past Co
  int* sdeg = reinterpret_cast<int*>(sb2 + 16);     // [64]: the degree of each row
  bf16* stg = reinterpret_cast<bf16*>(sdeg + 64);   // [Gp][S]
  bf16* sfg = stg + d.Gp * S;                       // [Gp][S]
  bf16* sh = sfg + d.Gp * S;                        // [XR][kXS]: h, rounded
  bf16* sx = sh + d.XR * kXS;                       // [I][kTN][kXC]: x
  bf16* smb = sx + I * kTN * kXC;                   // [I][kXS]: mid, rounded

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int chunks = (d.H + kHC - 1) / kHC;
  const int tiles = (d.N + kTN - 1) / kTN;
  // the chain's map: warp w's 16 columns and half of the grid (k16 steps)
  const int c0 = 16 * (warp % kColTiles), part = warp / kColTiles;
  const int half = d.Gp / 16 / kParts;
  const bf16 zero = singa::from_f<bf16>(0.f);
  for (int t = tid; t < I * kTN * kXC; t += kThreads) sx[t] = zero;  // channels past C
  for (int t = tid; t < (d.XR - I) * kXS; t += kThreads) sh[I * kXS + t] = zero;  // rows past I
  for (int t = tid; t < d.Gp * S; t += kThreads) {
    const int g = t / S, i = t - g * S;
    const bool in = g < d.G && i < I;
    stg[t] = in ? tg[g * I + i] : zero;
    sfg[t] = in ? fg[g * I + i] : zero;
  }
  if (tid < 16) sb2[tid] = tid < Co ? b2[tid] : 0.f;
  if (tid < 64) sdeg[tid] = degree_of(tid);
  if (warp == 0)  // row 48's sums: each lane's own four, read and written by it alone
    for (int q = 0; q < 4; ++q) sy48[4 * lane + q] = 0.f;
  __syncthreads();  // x's zeros before its copies
  copy_x(x, blockIdx.x * kTN, d, sx);  // the first tile's x and chunk's weights
  copy_words(wfrag, wl.words, swb);
  cp_async_commit();

  // the block's (tile, chunk) steps, tiles blockIdx.x, + gridDim.x, ..., the
  // chunks inside; step j's y product runs at the start of step j + 1
  const int steps = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x * chunks;
  // a warp's rows i = warp + kWarps r: at I = 49 every slot but the last
  // holds a row
  auto has_row = [&](int r, int i) { return (kTail && r < kMaxRows - 1) || i < I; };
  float yacc[kMaxRows - 1][4];  // y^T of the warp's rows: (o = grp (+8), node = 2 tig (+1))
#pragma unroll
  for (int r = 0; r < kMaxRows - 1; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) yacc[r][q] = 0.f;

  for (int j = 0; j <= steps; ++j) {
    cp_async_wait<0>();  // step j's weights, the tile's x
    __syncthreads();     // B0: everyone's copies; step j - 1's mid is complete
    if (j > 0) {
      // y^T += w2[l]^T mid_i^T for step j - 1
      const uint32_t* wb = swb + ((j - 1) & 1) * wl.words + wl.w2;
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        const int i = warp + kWarps * r;
        if (has_row(r, i)) {
          const uint4 w = *reinterpret_cast<const uint4*>(wb + sdeg[i] * kFragWords + 4 * lane);
          const uint32_t a[4] = {w.x, w.y, w.z, w.w};
          uint32_t b[2];
          mma16::ldmatrix_x2_trans(b, smb + i * kXS + (lane & 15) * kTN);
          if (r < kMaxRows - 1) {
            mma16::mma(yacc[r < kMaxRows - 1 ? r : 0], a, b);
          } else {
            float p[4] = {0.f, 0.f, 0.f, 0.f};
            mma16::mma(p, a, b);
#pragma unroll
            for (int q = 0; q < 4; ++q) sy48[4 * lane + q] += p[q];
          }
        }
      }
      if (j % chunks == 0) {  // step j - 1 was its tile's last chunk: y of the tile (+ b2 on row 0)
        const int n0 = (blockIdx.x + (j / chunks - 1) * gridDim.x) * kTN;
#pragma unroll
        for (int r = 0; r < kMaxRows; ++r) {
          const int i = warp + kWarps * r;
          if (has_row(r, i))
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int o = grp + 8 * (q >> 1), node = n0 + 2 * tig + (q & 1);
              float v;
              if (r < kMaxRows - 1) {
                v = yacc[r < kMaxRows - 1 ? r : 0][q];
                yacc[r < kMaxRows - 1 ? r : 0][q] = 0.f;
              } else {
                v = sy48[4 * lane + q];
                sy48[4 * lane + q] = 0.f;
              }
              if (o < Co && node < d.N)
                y[((long long)node * I + i) * Co + o] =
                    singa::from_f<bf16>(v + (i == 0 ? sb2[o] : 0.f));
            }
        }
      }
    }
    if (j == steps) break;
    const int k = j % chunks, tile = blockIdx.x + j / chunks * gridDim.x;
    const uint32_t* wa = swb + (j & 1) * wl.words;
    const float* swg = reinterpret_cast<const float*>(wa + wl.wg);  // [16][kHC]
    const float* sb1 = reinterpret_cast<const float*>(wa + wl.b1);  // [kHC]
    const float* sbg = reinterpret_cast<const float*>(wa + wl.bg);  // [kHC]
    // h^T = w1[l]^T x_i^T (+ b1 on row 0), rounded, into h [i][ch * kTN + node]
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      const int i = warp + kWarps * r;
      if (has_row(r, i)) {
        const uint4 w = *reinterpret_cast<const uint4*>(wa + sdeg[i] * kFragWords + 4 * lane);
        const uint32_t a[4] = {w.x, w.y, w.z, w.w};
        uint32_t b[2];
        mma16::ldmatrix_x2(b, sx + (i * kTN + (lane & 7)) * kXC + 8 * ((lane >> 3) & 1));
        float c[4] = {0.f, 0.f, 0.f, 0.f};
        mma16::mma(c, a, b);
        if (i == 0) {
          c[0] += sb1[grp];
          c[1] += sb1[grp];
          c[2] += sb1[grp + 8];
          c[3] += sb1[grp + 8];
        }
        *reinterpret_cast<uint32_t*>(sh + i * kXS + grp * kTN + 2 * tig) = mma16::pack(c[0], c[1]);
        *reinterpret_cast<uint32_t*>(sh + i * kXS + (grp + 8) * kTN + 2 * tig) =
            mma16::pack(c[2], c[3]);
      }
    }
    if (tid >= kThreads - kNCOL) {  // the gates, float32: mid's row 0 (the last four warps)
      const int t = tid - (kThreads - kNCOL), ch = t / kTN, node = t % kTN;
      float v = sbg[ch];
      for (int c = 0; c < C; ++c) v = fmaf(singa::to_f(sx[node * kXC + c]), swg[c * kHC + ch], v);
      sgate[t] = singa::rnd<bf16>(singa::siluf_(v));  // gate.astype(dt)
    }
    __syncthreads();  // B1: y is done with mid and the other buffer, h and the gates with x
    copy_words(wfrag + (long long)((k + 1) % chunks) * wl.words, wl.words,
               swb + ((j + 1) & 1) * wl.words);  // the next chunk's weights
    if (k + 1 == chunks && tile + (int)gridDim.x < tiles)  // the block's next tile's x
      copy_x(x, (tile + gridDim.x) * kTN, d, sx);
    cp_async_commit();
    // the chain over the warp's columns and half of the grid
    float om[3][2][4], tm[2];
    singa::grid_chain_mma16_fwd<I0>(stg, sfg, S, sh + c0, kXS, d.KS, part * half,
                                    (part + 1) * half, om, tm);
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {  // the tail row: the four lanes of a column
      tm[jj] += __shfl_xor_sync(0xffffffffu, tm[jj], 1);
      tm[jj] += __shfl_xor_sync(0xffffffffu, tm[jj], 2);
    }
    if (part == 1) {  // the second half's sums
#pragma unroll
      for (int mt = 0; mt < 3; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 16 * mt + grp + 8 * h;
          if ((kTail || mt < d.KS) && i < I)
#pragma unroll
            for (int jj = 0; jj < 2; ++jj)
              *reinterpret_cast<float2*>(smf + i * kMS + c0 + 8 * jj + 2 * tig) =
                  make_float2(om[mt][jj][2 * h], om[mt][jj][2 * h + 1]);
        }
      if (kTail && tig == 0)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) smf[(I0 - 1) * kMS + c0 + 8 * jj + grp] = tm[jj];
    }
    __syncthreads();  // B2
    if (part == 0) {  // mid = the halves' sums, rounded (mid.astype(dt)); row 0 := the gates
#pragma unroll
      for (int mt = 0; mt < 3; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 16 * mt + grp + 8 * h;
          if ((kTail || mt < d.KS) && i < I)
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
              const int col = c0 + 8 * jj + 2 * tig;
              const float2 o = *reinterpret_cast<const float2*>(smf + i * kMS + col);
              *reinterpret_cast<uint32_t*>(smb + i * kXS + col) =
                  i == 0 ? mma16::pack(sgate[col], sgate[col + 1])
                         : mma16::pack(om[mt][jj][2 * h] + o.x, om[mt][jj][2 * h + 1] + o.y);
            }
        }
      if (kTail && tig == 0)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int col = c0 + 8 * jj + grp;
          smb[(I0 - 1) * kXS + col] = singa::from_f<bf16>(smf[(I0 - 1) * kMS + col] + tm[jj]);
        }
    }
  }
}

using Kernel = void (*)(const bf16*, const float*, const bf16*, const bf16*, const uint32_t*,
                        bf16*, Dims);

inline Kernel kernel_for(const Dims& d) {
  return d.I == 49 ? ffn_fwd_bf16_kernel<49> : ffn_fwd_bf16_kernel<0>;
}

// Whether the bfloat16 kernel takes these widths: lmax 1..6, C and Co
// multiples of 4 up to 16, and its shared memory
bool takes(int lmax, int C, int H, int Co, int G) {
  if (lmax < 1 || lmax > 6 || C < 4 || C > 16 || C % 4 != 0 || H < 1 || Co < 4 || Co > 16 ||
      Co % 4 != 0 || G < 1)
    return false;
  const Dims d = make_dims(1, lmax, C, H, Co, G);
  return singa::allow_smem(kernel_for(d), smem_bytes(d)) == cudaSuccess;
}

// The weight kernel, then the kernel
int launch(const bf16* x, const float* w1, const float* b1, const float* wg, const float* bg,
           const float* w2, const float* b2, const bf16* tg, const bf16* fg, bf16* y,
           void* wfrag, int N, int lmax, int C, int H, int Co, int G, cudaStream_t st) {
  const Dims d = make_dims(N, lmax, C, H, Co, G);
  uint32_t* frags = reinterpret_cast<uint32_t*>(wfrag);
  const int wgrid = singa::persistent_grid(ffn_wfrag_bf16_kernel, 256, 0, (words(d) + 255) / 256);
  ffn_wfrag_bf16_kernel<<<wgrid, 256, 0, st>>>(w1, b1, wg, bg, w2, frags, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const Kernel k = kernel_for(d);
  const size_t smem = smem_bytes(d);
  err = singa::allow_smem(k, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = singa::persistent_grid(k, kThreads, smem, (N + kTN - 1) / kTN);
  k<<<grid, kThreads, smem, st>>>(x, b2, tg, fg, frags, y, d);
  return (int)cudaGetLastError();
}

}  // namespace bf

// 1: the tensor-core kernel takes the widths; 0: the CUDA-core instance
// does; -1: neither. bf16: the bfloat16 instance, which is its bfloat16
// kernel alone (bf::ffn_fwd_bf16_kernel)
int instance(int lmax, int C, int H, int Co, int G, int bf16) {
  if (bf16) return bf::takes(lmax, C, H, Co, G) ? 1 : -1;
  if (tc_takes(lmax, C, H, Co, G)) return 1;
  return cc::cc_takes(lmax, C, H, Co, G) ? 0 : -1;
}

// The split kernel, then the tensor-core kernel
int tc_launch(const float* x, const float* w1, const float* b1, const float* wg,
              const float* bg, const float* w2, const float* b2, const float* tg,
              const float* fg, float* y, void* wfrag, int N, int lmax, int C, int H, int Co,
              int G, cudaStream_t st) {
  const TcDims d = make_tc_dims(N, lmax, C, H, Co, G);
  uint32_t* frags = reinterpret_cast<uint32_t*>(wfrag);
  const SplitKernel sk = split_kernel(C);
  const int sgrid = singa::persistent_grid(sk, 256, 0, (tc_words(d) / 4 + 255) / 256);
  sk<<<sgrid, 256, 0, st>>>(w1, b1, wg, bg, w2, frags, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const TcKernel k = tc_kernel(C, d.I);
  const size_t smem = tc_smem(d);
  const int grid = singa::persistent_grid(k, kThreads, smem, (N + kTN - 1) / kTN);
  k<<<grid, kThreads, smem, st>>>(x, w1, b1, wg, bg, w2, b2, tg, fg, frags, y, d);
  return (int)cudaGetLastError();
}

}  // namespace

// Which kernel runs these widths (any N): 1 the tensor-core kernel, 0 the
// CUDA-core instance, -1 none (a shape no kernel takes). bf16: the
// bfloat16 instance's (1 or -1).
extern "C" int so3_ffn_instance(int lmax, int C, int H, int Co, int G, int bf16) {
  return instance(lmax, C, H, Co, G, bf16);
}

// 32-bit words of scratch so3_ffn needs at these widths (the tensor-core
// kernel's split weights, bf16: the bfloat16 kernel's rounded fragments; 0
// for the CUDA-core instance), -1 for shapes no kernel takes.
extern "C" long long so3_ffn_words(int lmax, int C, int H, int Co, int G, int bf16) {
  const int which = instance(lmax, C, H, Co, G, bf16);
  if (which < 0) return -1;
  if (which == 0) return 0;
  if (bf16) return bf::words(bf::make_dims(1, lmax, C, H, Co, G));
  return tc_words(make_tc_dims(1, lmax, C, H, Co, G));
}

// Resident blocks per SM of the tensor-core kernel at these widths (bf16:
// its bfloat16 instance; -1: a shape it does not take), its shared memory
// per block in *smem_bytes and its threads per block in *threads. For
// reports; launches nothing.
extern "C" int so3_ffn_residency(int lmax, int C, int H, int Co, int G, int bf16,
                                 int* smem_bytes, int* threads) {
  if (instance(lmax, C, H, Co, G, bf16) != 1) return -1;
  int per_sm = 0;
  cudaError_t err;
  if (bf16) {
    const bf::Dims d = bf::make_dims(1, lmax, C, H, Co, G);
    const size_t smem = bf::smem_bytes(d);
    *smem_bytes = (int)smem;
    *threads = bf::kThreads;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bf::kernel_for(d), bf::kThreads,
                                                        smem);
  } else {
    const TcDims d = make_tc_dims(1, lmax, C, H, Co, G);
    const size_t smem = tc_smem(d);
    *smem_bytes = (int)smem;
    *threads = kThreads;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tc_kernel(C, d.I), kThreads,
                                                        smem);
  }
  return err == cudaSuccess ? per_sm : -1;
}

// K4: x, tg, fg and y bfloat16 when bf16 != 0 (the caller casts tg and fg,
// as the TPU kernel casts them to x.dtype), else float32; the weights and
// biases float32. Returns cudaErrorInvalidValue for shapes no kernel takes:
// Co not a multiple of 4, lmax above 7, tiles whose shared memory exceeds
// the card's, and at bfloat16 every shape the bfloat16 kernel does not
// take (lmax 7, C or Co above 16 or not a multiple of 4). The tensor-core
// kernel runs every shape it takes (tc_takes), after the split kernel has
// written the weights into wfrag (so3_ffn_words() words, 16-byte aligned);
// the CUDA-core instance the others at float32; at bfloat16 the bfloat16
// kernel (bf::takes) after its weight kernel has written wfrag.
extern "C" int so3_ffn(const void* x, const float* w1, const float* b1, const float* wg,
                       const float* bg, const float* w2, const float* b2, const void* tg,
                       const void* fg, void* y, void* wfrag, int N, int lmax, int C, int H,
                       int Co, int G, int bf16, void* stream) {
  if (N < 1) return (int)cudaErrorInvalidValue;
  const int which = instance(lmax, C, H, Co, G, bf16);
  cudaStream_t st = (cudaStream_t)stream;
  using B = singa::bf16;
  if (which == 1 && bf16)
    return bf::launch((const B*)x, w1, b1, wg, bg, w2, b2, (const B*)tg, (const B*)fg, (B*)y,
                      wfrag, N, lmax, C, H, Co, G, st);
  if (which == 1)
    return tc_launch((const float*)x, w1, b1, wg, bg, w2, b2, (const float*)tg,
                     (const float*)fg, (float*)y, wfrag, N, lmax, C, H, Co, G, st);
  if (which == 0) {
    const cc::Dims d = cc::make_dims(N, lmax, C, H, Co, G);
    const size_t smem = cc::smem_floats(d) * sizeof(float);
    const int grid =
        singa::persistent_grid(cc::ffn_cc_kernel, cc::kThreads, smem, (N + cc::kTN - 1) / cc::kTN);
    cc::ffn_cc_kernel<<<grid, cc::kThreads, smem, st>>>(
        (const float*)x, w1, b1, wg, bg, w2, b2, (const float*)tg, (const float*)fg, (float*)y, d);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}
