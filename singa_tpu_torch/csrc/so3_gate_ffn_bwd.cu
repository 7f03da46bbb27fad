// K2b: gate-activation SO(3) feed-forward network, backward.
//
// Replaces: singa_tpu/ops/pallas/so3_ffn.py::_gate_bwd (_gate_ffn_bwd_kernel).
// With the forward of csrc/so3_gate_ffn.cu recomputed per node and row i of
// degree l:
//   h      = x[i] @ w1[l];   gate = sigmoid(x[0] @ wg + bg)
//   dmid   = dy[i] @ w2[l]^T
//   row 0:  dh = silu'(h + b1) * dmid,  mid = silu(h + b1)
//   l >= 1: dh = dmid * gate_l,         mid = h * gate_l,
//           dgate_l += dmid * h  (summed over the rows of degree l)
//   dg0 = gate * (1 - gate) * dgate
//   dx[i] = dh @ w1[l]^T  (+ dg0 @ wg^T on row 0)
//   dw1[l] += x[i]^T dh;  dw2[l] += mid^T dy[i];  dwg += x[0]^T dg0
//   db1 += dh[row 0];  dbg += dg0;  db2 += dy[row 0]
//
// What bounds it on the H100: at the training path's shapes (N = 14,336
// nodes per microbatch of 32, I = 49, C = Co = 16, H = 512) the work is five
// per-degree products of 2*N*I*C*H operations (h and dmid, which both
// kernels recompute but the function needs once, dx, dw1, dw2: ~57 GFLOP)
// and the gate path (~4 GFLOP) against ~140 MB of x, dy in and dx out, so
// float32 arithmetic bounds it (~0.92 ms at 67 TFLOP/s; memory ~41 us). Both
// kernels run their products on the tensor cores as three-product split
// TF32 (csrc/mma_tf32.cuh: float32 to round-off), ~60 GFLOP of them: ~0.37
// ms at 495 TFLOP/s, and mma.sync issues TF32 at ~300 TFLOP/s on this card,
// so a third of that for split products. What is left is the latency of the
// products' chains (h and dmid, then dh, then dx) at one block an SM, and the
// barriers of the chunk walk.
//
// Design: the [N, I, H] hidden and its cotangent (1.44 GB each here) never
// reach device memory; they are recomputed tile by tile in registers, as
// the TPU kernel recomputes them in VMEM. The TPU kernel added the weight
// gradients of every node tile into one resident output along its
// sequential grid; Hopper's blocks run in no order, so the work is split:
//   * the split kernel writes, once a call, each hidden chunk of kHC
//     channels of w1, w2 and wg as the dx kernel's B fragments, split into
//     TF32 hi and lo, then the chunk's b1 and bg (chunk_layout<true> of
//     csrc/gate_ffn_tc.cuh, which K2's forward shares): one block of words
//     a chunk, which the dx kernel copies as it is.
//   * the dx kernel: one block of 12 warps per tile of kTN = 16 nodes, the
//     m16 of every product; warp w owns the coefficient rows
//     [w I / 12, (w + 1) I / 12) and keeps their dx as float32 sums in
//     registers over the whole hidden dimension. It walks the hidden chunks;
//     each chunk's block of fragments comes by cp.async into a ring of two
//     stages, the next chunk's copy in flight during this one's products, so
//     each weight is read from global memory once a block and chunk,
//     coalesced, split already; x and dy come once a tile. A chunk starts
//     with its gates, gate_l = sigmoid(x_0 wg_l + bg_l), an m16n8 product of
//     row 0 (k C) by one warp for each degree, into shared memory (two
//     barriers a chunk). Then per row i of degree l and n8 block of hidden
//     channels:
//       h = x_i w1[l], dmid = dy_i w2[l]^T   m16 (node) x n8 x k C or Co;
//                                            A: the tile's rows, split as
//                                            they load (once a row and chunk)
//       dh = silu'(h + b1) dmid (row 0) or dmid gate_l, and dgate += dmid h,
//            on the C fragments
//       dx_i += dh w1[l]^T                   A: frag_a_from_c(dh), k = hidden
//     After the warp's rows of degree l, dg0 = gate (1 - gate) dgate, and
//     row 0's term dx_0 += dg0 wg_l^T runs on the tensor cores too (A:
//     frag_a_from_c(dg0); B: the gates' fragments read transposed). The term
//     is linear in each row's share of dgate, so a degree that two warps
//     share needs no sum across warps until the end, where row 0's terms
//     from the warps are added in warp order through shared memory. The
//     products of one row (or of row 0's term) in one chunk start from zero
//     on the tensor cores (chains of at most 3 (C / 8) and 3 kHC / 8 mma)
//     and are added to the float32 sums (so2_chain.cuh: the tensor cores cut
//     low bits as they accumulate).
//   * the weight kernel: one block per (hidden chunk of kWHC, slice of the
//     node tiles) walks its slice's tiles recomputing the chunk's hidden,
//     with the four per-degree products (h, dmid, dw1, dw2) on the tensor
//     cores as split TF32 and the gate path in float32 on the CUDA cores,
//     and keeps the weight gradients' float32 sums in registers, each owned
//     by one lane. It writes them to its slice's row of a [slices, P]
//     scratch buffer; a last kernel adds the rows in slice order.
// Every sum runs in a fixed order: the result is deterministic, with no
// atomics. Nodes past N in the last tile are staged as zero rows of x and dy,
// which makes every term they add to a gradient exactly zero, and the dx
// kernel writes nothing for them; hidden channels past H get zero weights and
// biases, which add nothing.
// bfloat16: all three kernels are templated on the storage type T of x, dy
// and dx (so3_gate_ffn_bwd_tc). At T = bf16 they compute the function
// _gate_ffn_bwd_kernel computes at a bfloat16 dtype, whose every product
// multiplies two bfloat16 operands and sums in float32: the rows of x and
// dy come by cp.async as bfloat16 (half the bytes) and widen as fragments
// load; the weights are rounded to bfloat16 once (the split kernel, or the
// weight kernel's staging) and kept as TF32 hi only, their lo being zero;
// each product is one TF32 mma.sync, exact to float32 accumulation
// (mma_tf32.cuh), where float32 takes three. The Pallas kernel's roundings
// are taken in registers: the gates where they scale h and dmid (float32 in
// sigmoid'), mid and dh as C fragments become A fragments (db1 sums dh
// unrounded), dg0 before dwg, dbg and row 0's dx term; dx is stored
// rounded, the weight gradients float32. Tiles, plans, degree groups, rings
// and summation orders are the float32 kernels', so the results are
// deterministic; ~61 GFLOP a microbatch in one TF32 product each (~0.12 ms
// at 495 TFLOP/s).
// Besides: K2b's CUDA-core instance (namespace cc, below), the kernel before
// the tensor-core ones, templated on the storage type of x, dy and dx. It
// runs the widths the tensor-core kernels refuse (C or Co not 8 or 16, lmax
// 7 at 16 channels), at float32 and at bfloat16 (so3_gate_ffn_bwd_cc);
// ~61 GFLOP a microbatch on the CUDA cores in float32 (~0.92 ms at 67
// TFLOP/s).
#include "gate_ffn_tc.cuh"

namespace {

using singa::kBf16;
using singa::gate::cp_async16;
using singa::tc::bf16_bits;
using singa::tc::bf16_hi;
using singa::tc::bf16_lo;

struct Dims {
  int N, lmax, L, I, C, H, Co;
};

__host__ __device__ inline Dims make_dims(int N, int lmax, int C, int H, int Co) {
  return Dims{N, lmax, lmax + 1, (lmax + 1) * (lmax + 1), C, H, Co};
}

// Offsets of the weight gradients in one flat row of P floats, in the order
// dw1 [L, C, H], db1 [H], dwg [C, lmax*H], dbg [lmax*H], dw2 [L, H, Co], db2 [Co].
struct GradLayout {
  long long w1, b1, wg, bg, w2, b2, total;
};

__host__ __device__ inline GradLayout grad_layout(const Dims& d) {
  GradLayout g;
  g.w1 = 0;
  g.b1 = g.w1 + (long long)d.L * d.C * d.H;
  g.wg = g.b1 + d.H;
  g.bg = g.wg + (long long)d.C * d.lmax * d.H;
  g.w2 = g.bg + (long long)d.lmax * d.H;
  g.b2 = g.w2 + (long long)d.L * d.H * d.Co;
  g.total = g.b2 + d.Co;
  return g;
}

// The weight kernel: the four per-degree products on the tensor cores as
// split TF32 (csrc/mma_tf32.cuh), the gate path in float32 on the CUDA
// cores; one instance for each C and Co of 8 or 16 (the products' k and n
// steps are 8 wide; the sums live in registers). A block owns kWHC hidden
// channels and a slice of the node tiles;
// its warp (group, hb) owns the 16-channel block hb and the degrees of
// its group (a greedy split of the rows into kGroups near-equal parts,
// at most kSlots degrees each for lmax <= 7). For each tile of kWTN nodes
// and each of its degrees l, the warp walks the rows i of degree l, two at
// a time into two sets of partial sums (independent chains, which the
// tensor cores' latency needs with 8 warps an SM), each row an m16n8
// product over (16 hidden channels) x (the tile's 8 nodes):
//   h^T    = w1[l]^T x_i^T   A: w1's fragments, split once per block;
//   dmid^T = w2[l]   dy_i^T  B: the tile's rows in shared memory, k = C, Co
// and, from their C fragments in registers (frag_a_from_c, k = the node):
//   dh = silu'(h + b1) dmid, mid = silu(h + b1) (row 0), or dmid g_l, h g_l;
//   dw1[l]^T += dh^T x_i,  dw2[l] += mid^T dy_i (B: the same rows, k = node)
// and sum_{i of l} dmid h for dg0 in the lane's own registers: the C
// fragment holds the same (channel, node) pairs in every row. The partial
// sums of one degree in one tile start from zero on the tensor cores
// (chains of at most 3 (l + 1) C / 8 mma) and are added to float32 sums in
// registers, which the slice carries over all its tiles (see so2_chain.cuh
// on the tensor cores' accumulation). The gates (x0 wg + bg), dwg (x0^T dg0),
// dbg, db1 and db2 run in float32 on the CUDA cores, per warp and degree:
// dwg's sums over the tile's nodes are reduced across the four lanes that
// hold them by shuffles. x and dy tiles come by cp.async into a ring of
// kWStages, the next tile's copies in flight during this one's products;
// rows past N are zero-filled. No sum crosses a warp: each writes its own
// entries of the slice's row of partial. On the H100 (nvcc -Xptxas -v,
// sm_90a) at C = Co = 16: 203 registers, no spills; 195,840 B of shared
// memory at lmax 6, so one block of 8 warps an SM. Why 32 channels a
// block and not 64: the split fragments of w1 and w2 take 4 KB per degree
// and 16 channels (57 KB at lmax 6 for 32 channels), the two-stage ring
// 125 KB; at 64 channels the fragments take 115 KB and the ring no longer
// fits in the 227 KB a block can have. At T = bf16 the ring holds bfloat16
// rows and the weights' one plane (hi): about half the shared memory. Its
// fragments of w1 and w2 then take k paired (k = 8 ks + 2 t + (r >> 1)),
// so that a lane reads its two values of a row of x or dy with one 4-byte
// load (frag_b_nk); the row stride w_ld<bf16> keeps those loads and
// frag_b_paired's conflict-free.
constexpr int kWThreads = 256;  // 8 warps
constexpr int kHB = 2;          // 16-channel hidden blocks of a block
constexpr int kGroups = kWThreads / 32 / kHB;
constexpr int kWHC = 16 * kHB;  // hidden channels of a block
constexpr int kWTN = 8;         // nodes of a tile: the n8 of the products
constexpr int kSlots = 2;       // degrees of a group
constexpr int kWStages = 2;

// values of T of a node's row of x (C wide) or dy (Co wide) in the ring:
// for frag_b_nk_seq and frag_b_paired, conflict-free at widths 8 and 16
// (bfloat16: frag_b_nk's words at g * ld / 2 + t, and frag_b_paired's)
template <class T = float>
__host__ __device__ constexpr int w_ld(int width) {
  return kBf16<T> ? (width % 16 ? width : width + 8) : width + 4;
}
// words of one (degree, hidden block)'s fragments of w1 and w2, one plane
__host__ __device__ constexpr int w_frag(int C, int Co) { return (C / 8 + Co / 8) * 32 * 4; }
// planes of the weight kernel's fragments: hi and lo, or (bfloat16) hi
template <class T>
__host__ __device__ constexpr int w_planes() { return kBf16<T> ? 1 : 2; }

template <class T>
__host__ __device__ inline size_t w_smem_bytes(const Dims& d) {
  return (size_t)kWStages * d.I * kWTN * (w_ld<T>(d.C) + w_ld<T>(d.Co)) * sizeof(T) +
         ((size_t)w_planes<T>() * d.L * kHB * w_frag(d.C, d.Co) + (size_t)d.lmax * d.C * kWHC +
          (size_t)d.lmax * kWHC) * sizeof(float);
}

// The degrees of group `group`, largest first (-1: none): degrees from
// lmax down, each to the group with the fewest rows so far.
// (Every index is a constant after unrolling, so nothing goes to local memory.)
__device__ void degree_group(int lmax, int group, int (&deg)[kSlots]) {
  int rows[kGroups] = {};
  int n = 0;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) deg[s] = -1;
  for (int l = lmax; l >= 0; --l) {
    int best = 0, least = rows[0];
#pragma unroll
    for (int q = 1; q < kGroups; ++q)
      if (rows[q] < least) least = rows[q], best = q;
#pragma unroll
    for (int q = 0; q < kGroups; ++q)
      if (q == best) rows[q] += 2 * l + 1;
    if (best == group) {
#pragma unroll
      for (int s = 0; s < kSlots; ++s)
        if (s == n) deg[s] = l;
      ++n;
    }
  }
}

// x and dy of the tile at node n0 into one stage: x [i][node][w_ld(C)], then
// dy [i][node][w_ld(Co)], zeros past N
template <int C, int Co, class T>
__device__ void copy_tile(const T* __restrict__ x, const T* __restrict__ dy, int n0,
                          const Dims& d, T* stage) {
  constexpr int E = 16 / sizeof(T), QX = C / E, QY = Co / E;  // 16-byte pieces of a row
  for (int q = threadIdx.x; q < (QX + QY) * d.I; q += kWThreads) {
    const bool isy = q >= QX * d.I;
    const int r = isy ? q - QX * d.I : q, pieces = isy ? QY : QX;
    const int w = isy ? Co : C, ld = w_ld<T>(w);
    const int i = r / pieces, c = E * (r % pieces);
    const T* src = isy ? dy : x;
    T* dst = stage + (isy ? d.I * kWTN * w_ld<T>(C) : 0) + i * kWTN * ld + c;
#pragma unroll
    for (int node = 0; node < kWTN; ++node) {
      const bool ok = n0 + node < d.N;
      cp_async16(dst + node * ld, ok ? src + ((long long)(n0 + node) * d.I + i) * w + c : src,
                 ok ? 16 : 0);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// One row i of degree l for the warp's 16 channels and the tile's 8 nodes:
// h and dmid on the tensor cores, the elementwise step, dg += dmid h (l >= 1)
// or db1 += dh (row 0), and dw1^T, dw2 += this row's products into pw1, pw2.
// At T = bf16: one product each, the gates rounded where they scale, mid
// and dh rounded as they become A fragments.
template <int C, int Co, class T>
__device__ __forceinline__ void row_products(const T* xi, const T* yi,
                                             const singa::tc::FragA (&wa1)[C / 8],
                                             const singa::tc::FragA (&wa2)[Co / 8], bool row0,
                                             const float (&gate)[4], const float (&b1r)[2],
                                             float (&dg)[4], float (&ab1)[2],
                                             float (&pw1)[C / 8][4], float (&pw2)[Co / 8][4]) {
  using namespace singa::tc;
  constexpr int KC = C / 8, KO = Co / 8, K = KC > KO ? KC : KO;
  constexpr int LX = w_ld<T>(C), LY = w_ld<T>(Co);
  float hc[4] = {}, dc[4] = {};
#pragma unroll
  for (int ks = 0; ks < K; ++ks) {  // each accumulator: lo hi, hi lo, hi hi
    const int kx = ks < KC ? ks : 0, ky = ks < KO ? ks : 0;
    if constexpr (kBf16<T>) {  // k paired, as the weights' fragments
      const FragB xb = frag_b_nk(xi + 8 * kx, LX), yb = frag_b_nk(yi + 8 * ky, LY);
      if (ks < KC) mma(hc, wa1[kx].hi, xb.hi);
      if (ks < KO) mma(dc, wa2[ky].hi, yb.hi);
    } else {
      const FragB xb = frag_b_nk_seq(xi + 8 * kx, LX), yb = frag_b_nk_seq(yi + 8 * ky, LY);
      if (ks < KC) mma(hc, wa1[kx].lo, xb.hi);
      if (ks < KO) mma(dc, wa2[ky].lo, yb.hi);
      if (ks < KC) mma(hc, wa1[kx].hi, xb.lo);
      if (ks < KO) mma(dc, wa2[ky].hi, yb.lo);
      if (ks < KC) mma(hc, wa1[kx].hi, xb.hi);
      if (ks < KO) mma(dc, wa2[ky].hi, yb.hi);
    }
  }
  float dh[4], mid[4];  // c fragments: (channel g + 8 (q >> 1), node 2t + (q & 1))
  if (row0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float v = hc[q] + b1r[q >> 1];
      dh[q] = singa::silu_gradf_(v) * dc[q];
      mid[q] = singa::siluf_(v);
    }
    ab1[0] += dh[0] + dh[1];
    ab1[1] += dh[2] + dh[3];
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float gr = singa::rnd<T>(gate[q]);
      dh[q] = dc[q] * gr;
      mid[q] = hc[q] * gr;
      dg[q] = fmaf(dc[q], hc[q], dg[q]);
    }
  }
  const FragA da = frag_a_from_c<T>(dh), ma = frag_a_from_c<T>(mid);
  FragB xp[KC], yp[KO];
#pragma unroll
  for (int j = 0; j < KC; ++j) xp[j] = frag_b_paired(xi + 8 * j, LX);
#pragma unroll
  for (int j = 0; j < KO; ++j) yp[j] = frag_b_paired(yi + 8 * j, LY);
  if constexpr (!kBf16<T>) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (j < KC) mma(pw1[j < KC ? j : 0], da.lo, xp[j < KC ? j : 0].hi);
      if (j < KO) mma(pw2[j < KO ? j : 0], ma.lo, yp[j < KO ? j : 0].hi);
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (j < KC) mma(pw1[j < KC ? j : 0], da.hi, xp[j < KC ? j : 0].lo);
      if (j < KO) mma(pw2[j < KO ? j : 0], ma.hi, yp[j < KO ? j : 0].lo);
    }
  }
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (j < KC) mma(pw1[j < KC ? j : 0], da.hi, xp[j < KC ? j : 0].hi);
    if (j < KO) mma(pw2[j < KO ? j : 0], ma.hi, yp[j < KO ? j : 0].hi);
  }
}

template <int C, int Co, class T>
__global__ void __launch_bounds__(kWThreads, 1)
gate_ffn_bwd_w_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                      const float* __restrict__ w1, const float* __restrict__ b1,
                      const float* __restrict__ wg, const float* __restrict__ bg,
                      const float* __restrict__ w2, float* __restrict__ partial, int N,
                      int lmax, int H, int slices) {
  using namespace singa::tc;
  constexpr int KC = C / 8, KO = Co / 8, KS = KC + KO, WF = w_frag(C, Co);
  constexpr int LX = w_ld<T>(C), LY = w_ld<T>(Co);
  constexpr int IX = kWTN * LX, IY = kWTN * LY;  // values of a coefficient row's block
  const Dims d = make_dims(N, lmax, C, H, Co);
  const int L = d.L, I = d.I;
  extern __shared__ __align__(16) float smem[];
  const int ss = I * (IX + IY);  // values of a stage
  T* ring = reinterpret_cast<T*>(smem);  // [stage][x [I][kWTN][LX], dy [I][kWTN][LY]]
  uint32_t* wf = reinterpret_cast<uint32_t*>(ring + kWStages * ss);  // [hi, lo][l][hb][...]
  float* swg = reinterpret_cast<float*>(wf + w_planes<T>() * L * kHB * WF);  // [lmax][C][kWHC]
  float* sbg = swg + lmax * C * kWHC;                                // [lmax][kWHC]
  const int chunks = (H + kWHC - 1) / kWHC;
  const int chunk = blockIdx.x % chunks, slice = blockIdx.x / chunks;
  const int hc0 = chunk * kWHC;
  const int tiles = (N + kWTN - 1) / kWTN;
  const int t_begin = (int)((long long)tiles * slice / slices);
  const int t_end = (int)((long long)tiles * (slice + 1) / slices);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane_grp(), t = lane_tig();
  const int hb = warp % kHB;
  const int h0 = hc0 + 16 * hb;  // the warp's first hidden channel

  if (t_begin < t_end) copy_tile<C, Co>(x, dy, t_begin * kWTN, d, ring);
  // w1 and w2 as A fragments, split: [l][hb][k step: w1's KC, then w2's KO][lane][reg];
  // reg r holds m = g + 8 (r & 1), k = 8 ks + t + 4 (r >> 1) (bfloat16: rounded,
  // the hi plane alone, k = 8 ks + 2 t + (r >> 1))
  for (int e = tid; e < L * kHB * WF; e += kWThreads) {
    const int r = e & 3, ln = (e >> 2) & 31, step = (e >> 7) % KS, lb = (e >> 7) / KS;
    const int b = lb % kHB, l = lb / kHB;
    const bool of_w2 = step >= KC;
    const int ks = of_w2 ? step - KC : step;
    const int h = hc0 + 16 * b + (ln >> 2) + 8 * (r & 1);
    const int k = kBf16<T> ? 8 * ks + 2 * (ln & 3) + (r >> 1) : 8 * ks + (ln & 3) + 4 * (r >> 1);
    float v = 0.f;
    if (h < H) v = of_w2 ? w2[((long long)l * H + h) * Co + k] : w1[((long long)l * C + k) * H + h];
    if constexpr (kBf16<T>)
      wf[e] = bf16_bits(v);
    else
      split(v, wf[e], wf[L * kHB * WF + e]);
  }
  for (int e = tid; e < lmax * C * kWHC; e += kWThreads) {
    const int h = e % kWHC, c = (e / kWHC) % C, l = e / (kWHC * C);
    swg[e] = hc0 + h < H ? singa::rnd<T>(wg[(long long)c * lmax * H + (long long)l * H + hc0 + h])
                         : 0.f;
  }
  for (int e = tid; e < lmax * kWHC; e += kWThreads) {
    const int h = e % kWHC, l = e / kWHC;
    sbg[e] = hc0 + h < H ? bg[(long long)l * H + hc0 + h] : 0.f;
  }
  int deg[kSlots];
  degree_group(lmax, warp / kHB, deg);
  float b1r[2];  // b1 of the lane's channels g, g + 8
#pragma unroll
  for (int a = 0; a < 2; ++a) b1r[a] = h0 + g + 8 * a < H ? b1[h0 + g + 8 * a] : 0.f;

  // the slice's float32 sums, per degree slot. C fragments: dw1^T (m = h,
  // n = c) and dw2 (m = h, n = o), C / 8 and Co / 8 n8 tiles; dwg: after
  // the shuffles, channel g + 8 (t >> 1), inputs C / 2 (t & 1) + k
  float aw1[kSlots][KC][4] = {}, aw2[kSlots][KO][4] = {}, awg[kSlots][C / 2] = {};
  float abg[kSlots][2] = {}, ab1[2] = {}, ab2 = 0.f;

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int k = tile - t_begin;
    __syncthreads();  // every warp is done with the stage the next copy fills
    if (tile + 1 < t_end)
      copy_tile<C, Co>(x, dy, (tile + 1) * kWTN, d, ring + ((k + 1) % kWStages) * ss);
    else
      asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);  // this tile's copies, this thread's
    __syncthreads();                                 // and everyone's
    const T* sx = ring + (k % kWStages) * ss;
    const T* sy = sx + I * IX;

    float x0[2][C];  // row 0 of x at the lane's nodes 2t, 2t + 1, read where needed
    auto load_x0 = [&]() {
#pragma unroll
      for (int nd = 0; nd < 2; ++nd)
        if constexpr (kBf16<T>) {
#pragma unroll
          for (int c = 0; c < C; c += 8) {
            const uint4 v = *reinterpret_cast<const uint4*>(sx + (2 * t + nd) * LX + c);
            const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              x0[nd][c + 2 * u] = __uint_as_float(bf16_lo(w[u]));
              x0[nd][c + 2 * u + 1] = __uint_as_float(bf16_hi(w[u]));
            }
          }
        } else {
#pragma unroll
          for (int c = 0; c < C; c += 4) {
            const float4 v = *reinterpret_cast<const float4*>(sx + (2 * t + nd) * LX + c);
            x0[nd][c] = v.x, x0[nd][c + 1] = v.y, x0[nd][c + 2] = v.z, x0[nd][c + 3] = v.w;
          }
        }
    };
    if (chunk == 0 && warp == 0 && lane < Co)  // db2: row 0 of dy
      for (int nd = 0; nd < kWTN; ++nd) ab2 += singa::to_f(sy[nd * LY + lane]);

#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int l = deg[s];
      if (l < 0) continue;
      FragA wa1[KC], wa2[KO];
      const uint32_t* wl = wf + (l * kHB + hb) * WF + lane * 4;
#pragma unroll
      for (int step = 0; step < KS; ++step) {
        const uint4 hi = *reinterpret_cast<const uint4*>(wl + step * 128);
        const uint4 lo = kBf16<T> ? make_uint4(0u, 0u, 0u, 0u)
                                  : *reinterpret_cast<const uint4*>(wl + L * kHB * WF + step * 128);
        const FragA f{{hi.x, hi.y, hi.z, hi.w}, {lo.x, lo.y, lo.z, lo.w}};
        if (step < KC)
          wa1[step < KC ? step : 0] = f;
        else
          wa2[step < KC ? 0 : step - KC] = f;
      }
      // gates of the lane's (channel, node) pairs: q = 2 a + nd
      float gate[4] = {}, dg[4] = {};
      if (l > 0) {
        load_x0();
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const int hh = 16 * hb + g + 8 * a;
          float p0 = sbg[(l - 1) * kWHC + hh], p1 = p0;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const float w = swg[((l - 1) * C + c) * kWHC + hh];
            p0 = fmaf(x0[0][c], w, p0);
            p1 = fmaf(x0[1][c], w, p1);
          }
          gate[2 * a] = singa::sigmoidf_(p0);
          gate[2 * a + 1] = singa::sigmoidf_(p1);
        }
      }
      float pw1[KC][4] = {}, pw2[KO][4] = {};  // this tile's products, from zero
      float qw1[KC][4] = {}, qw2[KO][4] = {};  // the odd rows' (a second chain)
      int i = l * l;
      for (; i + 1 < (l + 1) * (l + 1); i += 2) {
        row_products<C, Co, T>(sx + i * IX, sy + i * IY, wa1, wa2, l == 0, gate, b1r, dg, ab1,
                               pw1, pw2);
        row_products<C, Co, T>(sx + (i + 1) * IX, sy + (i + 1) * IY, wa1, wa2, l == 0, gate, b1r,
                               dg, ab1, qw1, qw2);
      }
      if (i < (l + 1) * (l + 1))
        row_products<C, Co, T>(sx + i * IX, sy + i * IY, wa1, wa2, l == 0, gate, b1r, dg, ab1,
                               pw1, pw2);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int j = 0; j < KC; ++j) aw1[s][j][q] += pw1[j][q] + qw1[j][q];
#pragma unroll
        for (int j = 0; j < KO; ++j) aw2[s][j][q] += pw2[j][q] + qw2[j][q];
      }
      if (l > 0) {  // the gate path: dg0, dbg, dwg
        float g0[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) g0[q] = singa::rnd<T>(gate[q] * (1.f - gate[q]) * dg[q]);
        abg[s][0] += g0[0] + g0[1];
        abg[s][1] += g0[2] + g0[3];
        load_x0();
        float v[2 * C];  // [channel a][input c], over the lane's two nodes
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int c = 0; c < C; ++c)
            v[a * C + c] = fmaf(x0[1][c], g0[2 * a + 1], x0[0][c] * g0[2 * a]);
        // over the four lanes of a group: lane t keeps channel t >> 1, then inputs C / 2 (t & 1) ..
        float w[C];
        const bool up = t & 2, right = t & 1;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float send = up ? v[c] : v[C + c], keep = up ? v[C + c] : v[c];
          w[c] = keep + __shfl_xor_sync(0xffffffffu, send, 2);
        }
#pragma unroll
        for (int c = 0; c < C / 2; ++c) {
          const float send = right ? w[c] : w[C / 2 + c], keep = right ? w[C / 2 + c] : w[c];
          awg[s][c] += keep + __shfl_xor_sync(0xffffffffu, send, 1);
        }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);

  // this slice's row of partial: each entry from the one warp that owns it
  const GradLayout gl = grad_layout(d);
  float* row = partial + (long long)slice * gl.total;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int l = deg[s];
    if (l < 0) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int h = h0 + g + 8 * (q >> 1);
      if (h >= H) continue;
#pragma unroll
      for (int j = 0; j < KC; ++j)
        row[gl.w1 + ((long long)l * C + 8 * j + 2 * t + (q & 1)) * H + h] = aw1[s][j][q];
#pragma unroll
      for (int j = 0; j < KO; ++j)
        row[gl.w2 + ((long long)l * H + h) * Co + 8 * j + 2 * t + (q & 1)] = aw2[s][j][q];
    }
    if (l > 0) {
      const int h = h0 + g + 8 * (t >> 1);
#pragma unroll
      for (int c = 0; c < C / 2; ++c)
        if (h < H)
          row[gl.wg + (long long)(C / 2 * (t & 1) + c) * lmax * H + (long long)(l - 1) * H + h] =
              awg[s][c];
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        float v = abg[s][a];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (t == 0 && h0 + g + 8 * a < H) row[gl.bg + (long long)(l - 1) * H + h0 + g + 8 * a] = v;
      }
    } else {
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        float v = ab1[a];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (t == 0 && h0 + g + 8 * a < H) row[gl.b1 + h0 + g + 8 * a] = v;
      }
    }
  }
  if (chunk == 0 && warp == 0 && lane < Co) row[gl.b2 + lane] = ab2;
}

template <class T>
using WKernel = void (*)(const T*, const T*, const float*, const float*, const float*,
                         const float*, const float*, float*, int, int, int, int);

// The weight kernel's instance for C input and Co output channels (null: none)
template <class T>
WKernel<T> w_kernel(int C, int Co) {
  if (C == 8 && Co == 8) return gate_ffn_bwd_w_kernel<8, 8, T>;
  if (C == 8 && Co == 16) return gate_ffn_bwd_w_kernel<8, 16, T>;
  if (C == 16 && Co == 8) return gate_ffn_bwd_w_kernel<16, 8, T>;
  if (C == 16 && Co == 16) return gate_ffn_bwd_w_kernel<16, 16, T>;
  return nullptr;
}

// The dx kernel (design: the top of the file); one instance for each C and
// Co of 8 or 16. At lmax 6 and 16 channels: 217,984 B of shared memory (the
// tile 100,352 B, two stages of 55,744 B, the gates 6,144 B), so one block
// of 12 warps an SM, at most 168 registers a thread (chip_smoke.py's
// k2b_ptxas and dx_residency). 12 warps, not 8 or 16: 8 hide too little of
// the products' latency (two warps a scheduler), and at 16 the 128
// registers a thread spill the dx sums. At T = bf16 the tile is bfloat16
// and a chunk's fragments hi only: about half the shared memory.
constexpr int kDThreads = 384;  // 12 warps
constexpr int kDWarps = kDThreads / 32;
constexpr int kDMaxRows = 6;    // rows of a warp: I <= 64 over 12 warps
using singa::gate::ChunkLayout;
using singa::gate::frag_pre;
using singa::gate::frag_tile;
using singa::gate::frag_words;
using singa::gate::gates;
using singa::gate::kHC;
using singa::gate::kNB;
using singa::gate::kTN;
static_assert((64 + kDWarps - 1) / kDWarps <= kDMaxRows, "a warp's rows must fit kDMaxRows");
static_assert(kDWarps >= 7, "one warp for each degree's gates");

// Every chunk's words (the layout chunk_layout<true, T>): the weights split
// into TF32 hi and lo once a call (gate_ffn_tc.cuh; bfloat16: rounded, hi).
template <int C, int Co, class T>
__global__ void gate_ffn_bwd_wsplit_kernel(const float* __restrict__ w1, const float* __restrict__ b1,
                                           const float* __restrict__ wg, const float* __restrict__ bg,
                                           const float* __restrict__ w2, uint32_t* __restrict__ out,
                                           int lmax, int H) {
  singa::gate::split_chunks<C, Co, true, T>(w1, b1, wg, bg, w2, out, lmax, H);
}

// x and dy of the tile at node n0 by cp.async: sx [I][kTN][C], sy
// [I][kTN][Co] (swizzled), zeros past N. One commit group with the caller's.
template <int C, int Co, class T>
__device__ void copy_dx_tile(const T* __restrict__ x, const T* __restrict__ dy, int n0,
                             const Dims& d, T* sx, T* sy) {
  singa::gate::copy_tile_rows<C, kDThreads, T>(x, n0, d.I, d.N, sx);
  singa::gate::copy_tile_rows<Co, kDThreads, T>(dy, n0, d.I, d.N, sy);
}

// Row 0's term of degree l from the warp's rows of l: dg0 = gate (1 - gate)
// dgate, part0 += dg0 wg_l^T on the tensor cores. B (k = hidden, paired;
// n = c) is read from the gates' fragments (k = c, paired; n = hidden):
// lane (g, t) takes k slot t from lane 8 t + (g >> 1) and slot t + 4 from
// lane 8 t + 4 + (g >> 1), their register g & 1. At T = bf16 dg0 is
// rounded as it becomes the A fragment, and the gates' fragments are hi only.
template <int C, class T>
__device__ __forceinline__ void gate_term(const uint32_t* wgf, int l, const float (&gate)[kNB][4],
                                          const float (&dgate)[kNB][4], float (&part0)[C / 8][4]) {
  using namespace singa::tc;
  constexpr int KC = C / 8, NB = kNB, FW = frag_words<T>();
  const uint32_t* f = wgf + (l - 1) * KC * NB * FW;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    float dg[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) dg[q] = gate[j][q] * (1.f - gate[j][q]) * dgate[j][q];
    const FragA da = frag_a_from_c<T>(dg);
    FragB b[KC];
#pragma unroll
    for (int nt = 0; nt < KC; ++nt) {
      const uint32_t* w = f + (nt * NB + j) * FW;
      if constexpr (kBf16<T>) {  // [lane][hi b0, hi b1]
        const int w0 = (8 * lane_tig() + (lane_grp() >> 1)) * 2 + (lane_grp() & 1);
        b[nt].hi[0] = w[w0];
        b[nt].hi[1] = w[w0 + 8];
        b[nt].lo[0] = b[nt].lo[1] = 0u;
      } else {
        const int w0 = (8 * lane_tig() + (lane_grp() >> 1)) * 4 + (lane_grp() & 1);
        b[nt].hi[0] = w[w0];
        b[nt].lo[0] = w[w0 + 2];
        b[nt].hi[1] = w[w0 + 16];
        b[nt].lo[1] = w[w0 + 18];
      }
    }
    if constexpr (!kBf16<T>) {
#pragma unroll
      for (int nt = 0; nt < KC; ++nt) mma(part0[nt], da.lo, b[nt].hi);
#pragma unroll
      for (int nt = 0; nt < KC; ++nt) mma(part0[nt], da.hi, b[nt].lo);
    }
#pragma unroll
    for (int nt = 0; nt < KC; ++nt) mma(part0[nt], da.hi, b[nt].hi);
  }
}

// One row i of degree l over the chunk: h and dmid per n8 block, dh on their
// C fragments (dgate += dmid h where l >= 1), and pdx += dh w1[l]^T. At T =
// bf16 one product each, the gates rounded where they scale dmid, dh rounded
// as it becomes the A fragment.
template <int C, int Co, class T>
__device__ __forceinline__ void row_dx(const T* xi, const T* yi, const uint32_t* st,
                                       const ChunkLayout& o, const float* cb1, int l,
                                       const float (&gate)[kNB][4], float (&dgate)[kNB][4],
                                       float (&pdx)[C / 8][4]) {
  using namespace singa::tc;
  constexpr int KC = C / 8, KO = Co / 8, K = KC > KO ? KC : KO, NB = kNB, FW = frag_words<T>();
  const int t = lane_tig();
  FragA xa[KC], ya[KO];
#pragma unroll
  for (int ks = 0; ks < KC; ++ks) xa[ks] = frag_tile<C, T>(xi, ks);
#pragma unroll
  for (int ks = 0; ks < KO; ++ks) ya[ks] = frag_tile<Co, T>(yi, ks);
  const uint32_t* w1f = st + l * KC * NB * FW;
  const uint32_t* w2f = st + (o.w2 + l * KO * NB) * FW;
  const uint32_t* w1t = st + (o.w1t + l * NB * KC) * FW;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    float hc[4] = {}, dc[4] = {};
#pragma unroll
    for (int ks = 0; ks < K; ++ks) {  // two chains, each: lo hi, hi lo, hi hi
      const int kx = ks < KC ? ks : 0, ky = ks < KO ? ks : 0;
      FragB bw{}, bv{};
      if (ks < KC) bw = frag_pre<T>(w1f + (kx * NB + j) * FW);
      if (ks < KO) bv = frag_pre<T>(w2f + (ky * NB + j) * FW);
      if constexpr (!kBf16<T>) {
        if (ks < KC) mma(hc, xa[kx].lo, bw.hi);
        if (ks < KO) mma(dc, ya[ky].lo, bv.hi);
        if (ks < KC) mma(hc, xa[kx].hi, bw.lo);
        if (ks < KO) mma(dc, ya[ky].hi, bv.lo);
      }
      if (ks < KC) mma(hc, xa[kx].hi, bw.hi);
      if (ks < KO) mma(dc, ya[ky].hi, bv.hi);
    }
    float dh[4];  // c fragments: (node g + 8 (q >> 1), channel 8 j + 2 t + (q & 1))
    if (l == 0) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        dh[q] = singa::silu_gradf_(hc[q] + cb1[8 * j + 2 * t + (q & 1)]) * dc[q];
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        dh[q] = dc[q] * singa::rnd<T>(gate[j][q]);
        dgate[j][q] = fmaf(dc[q], hc[q], dgate[j][q]);
      }
    }
    const FragA da = frag_a_from_c<T>(dh);
    FragB b[KC];
#pragma unroll
    for (int nt = 0; nt < KC; ++nt) b[nt] = frag_pre<T>(w1t + (j * KC + nt) * FW);
    if constexpr (!kBf16<T>) {
#pragma unroll
      for (int nt = 0; nt < KC; ++nt) mma(pdx[nt], da.lo, b[nt].hi);
#pragma unroll
      for (int nt = 0; nt < KC; ++nt) mma(pdx[nt], da.hi, b[nt].lo);
    }
#pragma unroll
    for (int nt = 0; nt < KC; ++nt) mma(pdx[nt], da.hi, b[nt].hi);
  }
}

template <int C, int Co, class T>
__global__ void __launch_bounds__(kDThreads, 1)
gate_ffn_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                       const uint32_t* __restrict__ wfrag, T* __restrict__ dx, int N, int lmax,
                       int H) {
  constexpr int KC = C / 8;
  const Dims d = make_dims(N, lmax, C, H, Co);
  const int I = d.I;
  const ChunkLayout o = singa::gate::chunk_layout<true, T>(lmax, C, Co);
  extern __shared__ __align__(16) float smem[];
  T* sx = reinterpret_cast<T*>(smem);                               // [I][kTN][C]
  T* sy = sx + I * kTN * C;                                         // [I][kTN][Co]
  uint32_t* ring = reinterpret_cast<uint32_t*>(sy + I * kTN * Co);  // [2][o.words]
  float* sgate = reinterpret_cast<float*>(ring + 2 * o.words);      // [lmax][kNB][32][4]
  const int chunks = (H + kHC - 1) / kHC;
  const int n0 = blockIdx.x * kTN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = singa::tc::lane_grp(), t = singa::tc::lane_tig();
  const int r0 = warp * I / kDWarps, r1 = (warp + 1) * I / kDWarps;  // the warp's rows

  copy_dx_tile<C, Co>(x, dy, n0, d, sx, sy);
  asm volatile("cp.async.commit_group;\n" ::);
  singa::gate::copy_chunk<kDThreads>(wfrag, 0, o.words, ring);

  float acc[kDMaxRows][KC][4] = {};  // dx of the warp's rows, c fragments (node, c)
  float acc0[KC][4] = {};            // row 0's gate terms from the warp's rows
  for (int k = 0; k < chunks; ++k) {
    const uint32_t* st = ring + (k & 1) * o.words;
    asm volatile("cp.async.wait_group 0;\n" ::);  // this chunk (and the tile): this thread's copies
    __syncthreads();  // everyone's; and every warp is done with the stage the next copy fills
    if (k + 1 < chunks)
      singa::gate::copy_chunk<kDThreads>(wfrag, k + 1, o.words, ring + ((k + 1) & 1) * o.words);
    const float* cb1 = reinterpret_cast<const float*>(st + o.b1);
    const float* cbg = reinterpret_cast<const float*>(st + o.bg);
    const uint32_t* wgf = st + o.wg * frag_words<T>();
    if (warp < lmax) gates<C, T>(sx, wgf, cbg, warp + 1, sgate);  // the chunk's gates, a degree a warp
    __syncthreads();
    float part0[KC][4] = {};  // this chunk's row-0 terms, from zero
    float gate[kNB][4] = {}, dgate[kNB][4] = {};
    int cur = -1;  // the degree whose gates are in `gate`
#pragma unroll
    for (int s = 0; s < kDMaxRows; ++s) {
      const int i = r0 + s;
      if (i < r1) {
        const int l = singa::degree_of(i);
        if (l != cur) {
          if (cur > 0) gate_term<C, T>(wgf, cur, gate, dgate, part0);
          cur = l;
          if (l > 0)
#pragma unroll
            for (int j = 0; j < kNB; ++j) {
              const float4 v =
                  *reinterpret_cast<const float4*>(sgate + (((l - 1) * kNB + j) * 32 + lane) * 4);
              gate[j][0] = v.x, gate[j][1] = v.y, gate[j][2] = v.z, gate[j][3] = v.w;
              dgate[j][0] = dgate[j][1] = dgate[j][2] = dgate[j][3] = 0.f;
            }
        }
        float pdx[KC][4] = {};  // this row's products in this chunk, from zero
        row_dx<C, Co, T>(sx + i * kTN * C, sy + i * kTN * Co, st, o, cb1, l, gate, dgate, pdx);
#pragma unroll
        for (int nt = 0; nt < KC; ++nt)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[s][nt][q] += pdx[nt][q];
      }
    }
    if (cur > 0) gate_term<C, T>(wgf, cur, gate, dgate, part0);
#pragma unroll
    for (int nt = 0; nt < KC; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc0[nt][q] += part0[nt][q];
  }

  // row 0: its own products, then the warps' gate terms in warp order
  __syncthreads();  // every warp is done with the tile and the ring
  float* p0 = smem;  // [warp][lane][KC][4]
#pragma unroll
  for (int nt = 0; nt < KC; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q) p0[((warp * 32 + lane) * KC + nt) * 4 + q] = acc0[nt][q];
  __syncthreads();
  if (r0 == 0 && r1 > 0)  // the warp that owns row 0
    for (int w = 0; w < kDWarps; ++w)
#pragma unroll
      for (int nt = 0; nt < KC; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[0][nt][q] += p0[((w * 32 + lane) * KC + nt) * 4 + q];

#pragma unroll
  for (int s = 0; s < kDMaxRows; ++s) {
    const int i = r0 + s;
    if (i >= r1) break;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = n0 + g + 8 * half;
      if (n >= N) continue;
#pragma unroll
      for (int nt = 0; nt < KC; ++nt) {
        T* out = dx + ((long long)n * I + i) * C + 8 * nt + 2 * t;
        if constexpr (kBf16<T>)
          *reinterpret_cast<__nv_bfloat162*>(out) =
              __floats2bfloat162_rn(acc[s][nt][2 * half], acc[s][nt][2 * half + 1]);
        else
          *reinterpret_cast<float2*>(out) = make_float2(acc[s][nt][2 * half], acc[s][nt][2 * half + 1]);
      }
    }
  }
}

template <class T>
using DxKernel = void (*)(const T*, const T*, const uint32_t*, T*, int, int, int);
using SplitKernel = void (*)(const float*, const float*, const float*, const float*, const float*,
                             uint32_t*, int, int);

// The dx kernel's and the split kernel's instances for C input and Co
// output channels (null: none)
template <class T>
DxKernel<T> dx_kernel(int C, int Co) {
  if (C == 8 && Co == 8) return gate_ffn_bwd_dx_kernel<8, 8, T>;
  if (C == 8 && Co == 16) return gate_ffn_bwd_dx_kernel<8, 16, T>;
  if (C == 16 && Co == 8) return gate_ffn_bwd_dx_kernel<16, 8, T>;
  if (C == 16 && Co == 16) return gate_ffn_bwd_dx_kernel<16, 16, T>;
  return nullptr;
}

template <class T>
SplitKernel split_kernel(int C, int Co) {
  if (C == 8 && Co == 8) return gate_ffn_bwd_wsplit_kernel<8, 8, T>;
  if (C == 8 && Co == 16) return gate_ffn_bwd_wsplit_kernel<8, 16, T>;
  if (C == 16 && Co == 8) return gate_ffn_bwd_wsplit_kernel<16, 8, T>;
  if (C == 16 && Co == 16) return gate_ffn_bwd_wsplit_kernel<16, 16, T>;
  return nullptr;
}

template <class T>
size_t w_smem(const Dims& d) { return w_smem_bytes<T>(d); }

// The dx kernel's shared memory: the tile, the ring's two stages and the
// gates, and at least row 0's terms of the warps at the end
template <class T>
size_t dx_smem(const Dims& d) {
  const size_t tile = (size_t)d.I * kTN * (d.C + d.Co) * sizeof(T);
  const size_t ring = (2 * (size_t)singa::gate::chunk_layout<true, T>(d.lmax, d.C, d.Co).words +
                       (size_t)d.lmax * kNB * 128) * sizeof(float);
  const size_t p0 = (size_t)kDThreads * (d.C / 8) * 4 * sizeof(float);
  return tile + ring > p0 ? tile + ring : p0;
}

// Both kernels: C and Co of 8 or 16 (their products' k and n steps are 8
// wide), at most 64 coefficient rows (lmax <= 7: the dx kernel's warps own
// at most kDMaxRows rows each; the weight kernel's degree groups).
bool dims_ok(int N, int lmax, int C, int H, int Co) {
  if (N < 1 || lmax < 1 || lmax > 7 || H < 1) return false;
  return dx_kernel<float>(C, Co) != nullptr && w_kernel<float>(C, Co) != nullptr;
}

// Slices of node tiles the weight kernel at T splits N into (-1: a shape it
// does not take, or whose tiles exceed shared memory). Every width the
// float32 kernels refuse is refused at bfloat16 too (lmax 7 at 16 channels
// in and out, which would fit there, included): one rule for both.
template <class T>
int slices_of(int N, int lmax, int C, int H, int Co) {
  if (!dims_ok(N, lmax, C, H, Co)) return -1;
  const Dims d = make_dims(N, lmax, C, H, Co);
  if (singa::allow_smem(dx_kernel<float>(C, Co), dx_smem<float>(d)) != cudaSuccess) return -1;
  if (singa::allow_smem(w_kernel<float>(C, Co), w_smem<float>(d)) != cudaSuccess) return -1;
  const WKernel<T> wk = w_kernel<T>(C, Co);
  const size_t smem = w_smem<T>(d);
  if (singa::allow_smem(dx_kernel<T>(C, Co), dx_smem<T>(d)) != cudaSuccess) return -1;
  if (singa::allow_smem(wk, smem) != cudaSuccess) return -1;
  const int chunks = (H + kWHC - 1) / kWHC;
  const int tiles = (N + kWTN - 1) / kWTN;
  const int resident = singa::persistent_grid(wk, kWThreads, smem, 1LL << 30);
  int slices = resident / chunks;
  if (slices < 1) slices = 1;
  if (slices > tiles) slices = tiles;
  return slices;
}

template <class T>
int tc_launch(const T* x, const T* dy, const float* w1, const float* b1, const float* wg,
              const float* bg, const float* w2, T* dx, float* partial, float* grads, void* wfrag,
              int N, int lmax, int C, int H, int Co, int slices, cudaStream_t st) {
  if (!dims_ok(N, lmax, C, H, Co) || slices < 1) return (int)cudaErrorInvalidValue;
  const Dims d = make_dims(N, lmax, C, H, Co);
  const WKernel<T> wk = w_kernel<T>(C, Co);
  const DxKernel<T> dk = dx_kernel<T>(C, Co);
  const SplitKernel sk = split_kernel<T>(C, Co);
  const size_t sa = dx_smem<T>(d), sb = w_smem<T>(d);
  cudaError_t err = singa::allow_smem(dk, sa);
  if (err != cudaSuccess) return (int)err;
  err = singa::allow_smem(wk, sb);
  if (err != cudaSuccess) return (int)err;
  uint32_t* frags = reinterpret_cast<uint32_t*>(wfrag);
  const ChunkLayout o = singa::gate::chunk_layout<true, T>(lmax, C, Co);
  const int dx_chunks = (H + kHC - 1) / kHC;
  const long long items = (long long)dx_chunks * (o.frags * 32 + (o.words - o.b1));
  const int sgrid = singa::persistent_grid(sk, 256, 0, (items + 255) / 256);
  sk<<<sgrid, 256, 0, st>>>(w1, b1, wg, bg, w2, frags, lmax, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int tiles = (N + kTN - 1) / kTN;
  dk<<<tiles, kDThreads, sa, st>>>(x, dy, frags, dx, N, lmax, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int chunks = (H + kWHC - 1) / kWHC;
  wk<<<chunks * slices, kWThreads, sb, st>>>(x, dy, w1, b1, wg, bg, w2, partial, N, lmax, H,
                                             slices);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long P = grad_layout(d).total;
  const int grid = singa::persistent_grid(singa::sum_rows_kernel, 256, 0, (P + 255) / 256);
  singa::sum_rows_kernel<<<grid, 256, 0, st>>>(partial, grads, P, slices);
  return (int)cudaGetLastError();
}

// The weight kernel (dx: the dx kernel) at T: resident blocks per SM (-1:
// a shape it does not take), its threads and dynamic shared memory per block.
template <class T>
int residency_of(int lmax, int C, int H, int Co, bool dx, int* smem_bytes, int* threads) {
  if (!dims_ok(1, lmax, C, H, Co)) return -1;
  const Dims d = make_dims(1, lmax, C, H, Co);
  const size_t smem = dx ? dx_smem<T>(d) : w_smem<T>(d);
  *smem_bytes = (int)smem;
  *threads = dx ? kDThreads : kWThreads;
  int per_sm = 0;
  if (dx) {
    if (singa::allow_smem(dx_kernel<T>(C, Co), smem) != cudaSuccess) return -1;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dx_kernel<T>(C, Co), kDThreads,
                                                      smem) != cudaSuccess)
      return -1;
  } else {
    if (singa::allow_smem(w_kernel<T>(C, Co), smem) != cudaSuccess) return -1;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, w_kernel<T>(C, Co), kWThreads,
                                                      smem) != cudaSuccess)
      return -1;
  }
  return per_sm;
}


// ------------------------------- CUDA cores --------------------------------
// K2b's CUDA-core instance: the backward the port ran before its tensor-core
// kernels, templated on the storage type T of x, dy and dx. It runs the
// float32 shapes the tensor-core kernels do not take (C or Co not 8 or 16:
// 32 sphere channels, say) and K2b's bfloat16 instance at every shape.
//
// The chunk's [I, kHC] hidden and its cotangent are recomputed tile by tile
// in shared memory, as the TPU kernel recomputes them in VMEM:
//   * the dx kernel: one block per tile of kTN nodes walks the hidden
//     dimension in chunks of kHC channels and keeps dx in registers across
//     the chunks; dgate of a chunk is complete within it (the gate columns
//     of a chunk see only that chunk's hidden channels), so the gate path's
//     row-0 term is added chunk by chunk. No sum crosses a block.
//   * the weight kernel: one block per (hidden chunk, slice of the node
//     tiles) stages its chunk's weights once, walks its slice's tiles
//     recomputing the chunk's hidden, and keeps the chunk's weight-gradient
//     sums in shared memory, each sum owned by one thread. It writes them to
//     its slice's row of a [slices, P] scratch buffer; sum_rows_kernel adds
//     the rows in slice order. Deterministic, no atomics.
// Nodes past N in the last tile are staged as zero rows of x and dy, which
// makes every term they add to a gradient exactly zero. At T = bf16 it is
// the function _gate_ffn_bwd_kernel computes at a bfloat16 x: w1, wg and w2
// rounded to bfloat16 as they are staged; h, dmid, dgate and the gates in
// float32; the gates rounded where they scale h and dmid (not in sigmoid');
// mid, dh (before dx and dw1; db1 sums it unrounded) and dg0 rounded; dx
// rounded as it is stored; the weight gradients float32.
namespace cc {

constexpr int kThreads = 512;   // 16 warps: one block per SM (shared memory) hides latency
constexpr int kNG = 2;          // groups of four nodes per tile
constexpr int kTN = 4 * kNG;    // nodes per tile
constexpr int kHC = 16;         // hidden channels per chunk
constexpr int kPad = 8;         // floats added to each row block
constexpr int kMaxJobs = 1;     // dx micro-tiles per thread

using singa::degree_of;
using singa::fma4;

// Shared-memory layout common to both kernels (offsets in floats).
struct Smem {
  float* sx;     // [I][C][kTN]   row stride xs
  float* sdy;    // [I][Co][kTN]  row stride ys
  float* sh;     // [I][kHC][kTN] row stride ms: h, then mid
  float* sdm;    // [I][kHC][kTN] row stride ms: dmid, then dh
  float* sgate;  // [lmax][kHC][kTN]
  float* sdg;    // [lmax][kHC][kTN] dg0
  float* sw1;    // [L][C][kHC]
  float* swg;    // [C][lmax][kHC]
  float* sw2t;   // [L][Co][kHC]
  float* end;
  int xs, ys, ms;
};

__host__ __device__ inline size_t common_floats(const Dims& d) {
  const size_t xs = d.C * kTN + kPad, ys = d.Co * kTN + kPad, ms = kHC * kTN + kPad;
  return d.I * (xs + ys + 2 * ms) + 2 * (size_t)d.lmax * kHC * kTN +
         (size_t)d.L * d.C * kHC + (size_t)d.C * d.lmax * kHC + (size_t)d.L * d.Co * kHC;
}

__device__ Smem carve(float* base, const Dims& d) {
  Smem s;
  s.xs = d.C * kTN + kPad;
  s.ys = d.Co * kTN + kPad;
  s.ms = kHC * kTN + kPad;
  s.sx = base;
  s.sdy = s.sx + d.I * s.xs;
  s.sh = s.sdy + d.I * s.ys;
  s.sdm = s.sh + d.I * s.ms;
  s.sgate = s.sdm + d.I * s.ms;
  s.sdg = s.sgate + d.lmax * kHC * kTN;
  s.sw1 = s.sdg + d.lmax * kHC * kTN;
  s.swg = s.sw1 + d.L * d.C * kHC;
  s.sw2t = s.swg + d.C * d.lmax * kHC;
  s.end = s.sw2t + d.L * d.Co * kHC;
  return s;
}

// x and dy of nodes n0 .. n0+kTN-1, node minor; rows past N are zero.
template <class T>
__device__ void stage_tile(const T* __restrict__ x, const T* __restrict__ dy, int n0,
                           const Dims& d, const Smem& s) {
  for (int t = threadIdx.x; t < kTN * d.I * d.C; t += kThreads) {
    const int n = t / (d.I * d.C), i = (t / d.C) % d.I, c = t % d.C;
    s.sx[i * s.xs + c * kTN + n] =
        (n0 + n < d.N) ? singa::to_f(x[(long long)n0 * d.I * d.C + t]) : 0.f;
  }
  for (int t = threadIdx.x; t < kTN * d.I * d.Co; t += kThreads) {
    const int n = t / (d.I * d.Co), i = (t / d.Co) % d.I, o = t % d.Co;
    s.sdy[i * s.ys + o * kTN + n] =
        (n0 + n < d.N) ? singa::to_f(dy[(long long)n0 * d.I * d.Co + t]) : 0.f;
  }
}

// The chunk's slices of w1, wg and w2 (zero past H), rounded to T.
template <class T>
__device__ void stage_weights(const float* __restrict__ w1, const float* __restrict__ wg,
                              const float* __restrict__ w2, int h0, const Dims& d,
                              const Smem& s) {
  for (int t = threadIdx.x; t < d.L * d.C * kHC; t += kThreads) {
    const int h = t % kHC, lc = t / kHC;
    s.sw1[t] = (h0 + h < d.H) ? singa::rnd<T>(w1[(long long)lc * d.H + h0 + h]) : 0.f;
  }
  for (int t = threadIdx.x; t < d.C * d.lmax * kHC; t += kThreads) {
    const int h = t % kHC, l = (t / kHC) % d.lmax, c = t / (kHC * d.lmax);
    s.swg[t] =
        (h0 + h < d.H) ? singa::rnd<T>(wg[(long long)c * d.lmax * d.H + l * d.H + h0 + h]) : 0.f;
  }
  for (int t = threadIdx.x; t < d.L * d.Co * kHC; t += kThreads) {
    const int h = t % kHC, o = (t / kHC) % d.Co, l = t / (kHC * d.Co);
    s.sw2t[t] = (h0 + h < d.H) ? singa::rnd<T>(w2[((long long)l * d.H + h0 + h) * d.Co + o]) : 0.f;
  }
}

// With the tile and the chunk's weights staged: the gates (float32), h and
// dmid, then dg0 (rounded to T), then dh (in sdm, float32: its users round
// it, db1 sums it as it is) and, if want_mid, mid (in sh, rounded to T).
// Ends synchronised.
template <class T>
__device__ void chunk_backward(const float* __restrict__ b1, const float* __restrict__ bg,
                               int h0, const Dims& d, const Smem& s, bool want_mid) {
  const int tid = threadIdx.x;
  // gates of degrees 1..lmax from the l=0 row
  for (int t = tid; t < d.lmax * kHC * kTN; t += kThreads) {
    const int n = t % kTN, h = (t / kTN) % kHC, l = t / (kTN * kHC);
    float v = (h0 + h < d.H) ? bg[l * d.H + h0 + h] : 0.f;
    for (int c = 0; c < d.C; ++c) v = fmaf(s.sx[c * kTN + n], s.swg[(c * d.lmax + l) * kHC + h], v);
    s.sgate[t] = singa::sigmoidf_(v);
  }
  // h and dmid: micro-tiles of four nodes x four hidden channels of one row
  for (int t = tid; t < kNG * d.I * (kHC / 4); t += kThreads) {
    const int h4 = t % (kHC / 4), ng = (t / (kHC / 4)) % kNG, i = t / (kHC / 4 * kNG);
    const int l = degree_of(i);
    float4 a[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      a[r] = make_float4(0.f, 0.f, 0.f, 0.f);
      b[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    const float* xr = s.sx + i * s.xs + 4 * ng;
    const float* wr = s.sw1 + l * d.C * kHC + 4 * h4;
    for (int c = 0; c < d.C; ++c) {
      const float4 xv = *reinterpret_cast<const float4*>(xr + c * kTN);
      const float4 wv = *reinterpret_cast<const float4*>(wr + c * kHC);
      fma4(a[0], wv.x, xv);
      fma4(a[1], wv.y, xv);
      fma4(a[2], wv.z, xv);
      fma4(a[3], wv.w, xv);
    }
    const float* yr = s.sdy + i * s.ys + 4 * ng;
    const float* vr = s.sw2t + l * d.Co * kHC + 4 * h4;
    for (int o = 0; o < d.Co; ++o) {
      const float4 yv = *reinterpret_cast<const float4*>(yr + o * kTN);
      const float4 wv = *reinterpret_cast<const float4*>(vr + o * kHC);
      fma4(b[0], wv.x, yv);
      fma4(b[1], wv.y, yv);
      fma4(b[2], wv.z, yv);
      fma4(b[3], wv.w, yv);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int off = i * s.ms + (4 * h4 + r) * kTN + 4 * ng;
      *reinterpret_cast<float4*>(s.sh + off) = a[r];
      *reinterpret_cast<float4*>(s.sdm + off) = b[r];
    }
  }
  __syncthreads();
  // dg0 = sigmoid'(g0) * sum over the degree's rows of dmid * h
  for (int t = tid; t < d.lmax * kHC * kTN; t += kThreads) {
    const int n = t % kTN, h = (t / kTN) % kHC, l = t / (kTN * kHC) + 1;
    float dg = 0.f;
    for (int i = l * l; i < (l + 1) * (l + 1); ++i) {
      const int off = i * s.ms + h * kTN + n;
      dg = fmaf(s.sdm[off], s.sh[off], dg);
    }
    const float g = s.sgate[t];
    s.sdg[t] = singa::rnd<T>(g * (1.f - g) * dg);
  }
  __syncthreads();
  // dh (and mid) in place
  for (int t = tid; t < d.I * kHC * kTN; t += kThreads) {
    const int n = t % kTN, h = (t / kTN) % kHC, i = t / (kTN * kHC);
    const int off = i * s.ms + h * kTN + n;
    const float hv = s.sh[off], dm = s.sdm[off];
    float dh, mid;
    if (i == 0) {
      const float hb = hv + ((h0 + h < d.H) ? b1[h0 + h] : 0.f);
      dh = singa::silu_gradf_(hb) * dm;
      mid = singa::rnd<T>(singa::siluf_(hb));
    } else {
      const float g = singa::rnd<T>(s.sgate[((degree_of(i) - 1) * kHC + h) * kTN + n]);
      dh = dm * g;
      mid = singa::rnd<T>(hv * g);
    }
    s.sdm[off] = dh;
    if (want_mid) s.sh[off] = mid;
  }
  __syncthreads();
}

template <class T>
__global__ void __launch_bounds__(kThreads)
gate_ffn_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                       const float* __restrict__ w1, const float* __restrict__ b1,
                       const float* __restrict__ wg, const float* __restrict__ bg,
                       const float* __restrict__ w2, T* __restrict__ dx, int N, int lmax,
                       int C, int H, int Co) {
  const Dims d = make_dims(N, lmax, C, H, Co);
  extern __shared__ __align__(16) float smem[];
  const Smem s = carve(smem, d);
  float* sw1t = s.end;  // [L][kHC][C]
  const int n0 = blockIdx.x * kTN;
  const int tid = threadIdx.x;
  const int C4 = C / 4;
  const int njobs = kNG * d.I * C4;
  stage_tile(x, dy, n0, d, s);

  float4 acc[kMaxJobs][4];  // acc[k][q]: node q of the micro-tile, four channels
#pragma unroll
  for (int k = 0; k < kMaxJobs; ++k)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[k][q] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int h0 = 0; h0 < H; h0 += kHC) {
    __syncthreads();  // the previous chunk's readers of the staged weights are done
    stage_weights<T>(w1, wg, w2, h0, d, s);
    for (int t = tid; t < d.L * kHC * C; t += kThreads) {
      const int c = t % C, h = (t / C) % kHC, l = t / (C * kHC);
      sw1t[t] = (h0 + h < H) ? singa::rnd<T>(w1[((long long)l * C + c) * H + h0 + h]) : 0.f;
    }
    __syncthreads();
    chunk_backward<T>(b1, bg, h0, d, s, false);

#pragma unroll
    for (int k = 0; k < kMaxJobs; ++k) {
      const int j = tid + k * kThreads;
      if (j < njobs) {
        const int c4 = j % C4, ng = (j / C4) % kNG, i = j / (C4 * kNG);
        const int l = degree_of(i);
        const float* dr = s.sdm + i * s.ms + 4 * ng;
        const float* wr = sw1t + l * kHC * C + 4 * c4;
        for (int h = 0; h < kHC; ++h) {
          const float4 dv = *reinterpret_cast<const float4*>(dr + h * kTN);
          const float4 wv = *reinterpret_cast<const float4*>(wr + h * C);
          fma4(acc[k][0], singa::rnd<T>(dv.x), wv);
          fma4(acc[k][1], singa::rnd<T>(dv.y), wv);
          fma4(acc[k][2], singa::rnd<T>(dv.z), wv);
          fma4(acc[k][3], singa::rnd<T>(dv.w), wv);
        }
        if (i == 0) {  // the gate path: dg0 @ wg^T on row 0
          for (int lh = 0; lh < d.lmax * kHC; ++lh) {
            const int l2 = lh / kHC, h = lh % kHC;
            const float4 gv = *reinterpret_cast<const float4*>(s.sdg + lh * kTN + 4 * ng);
            const int wi = l2 * kHC + h;
            const float4 wv = make_float4(s.swg[(4 * c4) * d.lmax * kHC + wi],
                                          s.swg[(4 * c4 + 1) * d.lmax * kHC + wi],
                                          s.swg[(4 * c4 + 2) * d.lmax * kHC + wi],
                                          s.swg[(4 * c4 + 3) * d.lmax * kHC + wi]);
            fma4(acc[k][0], gv.x, wv);
            fma4(acc[k][1], gv.y, wv);
            fma4(acc[k][2], gv.z, wv);
            fma4(acc[k][3], gv.w, wv);
          }
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kMaxJobs; ++k) {
    const int j = tid + k * kThreads;
    if (j < njobs) {
      const int c4 = j % C4, ng = (j / C4) % kNG, i = j / (C4 * kNG);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = n0 + 4 * ng + q;
        if (n < N) {
          T* out = dx + ((long long)n * d.I + i) * C + 4 * c4;
          if constexpr (singa::kBf16<T>) {
            out[0] = singa::from_f<T>(acc[k][q].x);
            out[1] = singa::from_f<T>(acc[k][q].y);
            out[2] = singa::from_f<T>(acc[k][q].z);
            out[3] = singa::from_f<T>(acc[k][q].w);
          } else {
            *reinterpret_cast<float4*>(out) = acc[k][q];
          }
        }
      }
    }
  }
}

__host__ __device__ inline int acc_floats(const Dims& d) {
  return d.L * d.C * kHC + d.L * kHC * d.Co + d.C * d.lmax * kHC + kHC + d.lmax * kHC + d.Co;
}

template <class T>
__global__ void __launch_bounds__(kThreads)
gate_ffn_bwd_w_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                      const float* __restrict__ w1, const float* __restrict__ b1,
                      const float* __restrict__ wg, const float* __restrict__ bg,
                      const float* __restrict__ w2, float* __restrict__ partial, int N,
                      int lmax, int C, int H, int Co, int slices) {
  const Dims d = make_dims(N, lmax, C, H, Co);
  extern __shared__ __align__(16) float smem[];
  const Smem s = carve(smem, d);
  const int chunks = (H + kHC - 1) / kHC;
  const int chunk = blockIdx.x % chunks, slice = blockIdx.x / chunks;
  const int h0 = chunk * kHC;
  const int tiles = (N + kTN - 1) / kTN;
  const int t_begin = (int)((long long)tiles * slice / slices);
  const int t_end = (int)((long long)tiles * (slice + 1) / slices);
  const int tid = threadIdx.x;

  const int nw1 = d.L * C * kHC, nw2 = d.L * kHC * Co, nwg = C * lmax * kHC;
  float* aw1 = s.end;      // [L][C][kHC]
  float* aw2 = aw1 + nw1;  // [L][kHC][Co]
  float* awg = aw2 + nw2;  // [C][lmax][kHC]
  float* ab1 = awg + nwg;  // [kHC]
  float* abg = ab1 + kHC;  // [lmax][kHC]
  float* ab2 = abg + lmax * kHC;  // [Co]
  // every sum below is owned by the thread tid == index % kThreads
  for (int t = tid; t < acc_floats(d); t += kThreads) aw1[t] = 0.f;
  stage_weights<T>(w1, wg, w2, h0, d, s);

  for (int tile = t_begin; tile < t_end; ++tile) {
    __syncthreads();  // the previous tile's readers are done
    stage_tile(x, dy, tile * kTN, d, s);
    __syncthreads();
    chunk_backward<T>(b1, bg, h0, d, s, true);

    for (int t = tid; t < nw1; t += kThreads) {  // dw1[l][c][h] += x[i][c] dh[i][h]
      const int h = t % kHC, c = (t / kHC) % C, l = t / (kHC * C);
      float v = aw1[t];
      for (int i = l * l; i < (l + 1) * (l + 1); ++i) {
        const float* xr = s.sx + i * s.xs + c * kTN;
        const float* dr = s.sdm + i * s.ms + h * kTN;
#pragma unroll
        for (int n = 0; n < kTN; n += 4) {
          const float4 a = *reinterpret_cast<const float4*>(xr + n);
          const float4 b = *reinterpret_cast<const float4*>(dr + n);
          v = fmaf(a.x, singa::rnd<T>(b.x), v);
          v = fmaf(a.y, singa::rnd<T>(b.y), v);
          v = fmaf(a.z, singa::rnd<T>(b.z), v);
          v = fmaf(a.w, singa::rnd<T>(b.w), v);
        }
      }
      aw1[t] = v;
    }
    for (int t = tid; t < nw2; t += kThreads) {  // dw2[l][h][o] += mid[i][h] dy[i][o]
      const int o = t % Co, h = (t / Co) % kHC, l = t / (Co * kHC);
      float v = aw2[t];
      for (int i = l * l; i < (l + 1) * (l + 1); ++i) {
        const float* mr = s.sh + i * s.ms + h * kTN;
        const float* yr = s.sdy + i * s.ys + o * kTN;
#pragma unroll
        for (int n = 0; n < kTN; n += 4) {
          const float4 a = *reinterpret_cast<const float4*>(mr + n);
          const float4 b = *reinterpret_cast<const float4*>(yr + n);
          v = fmaf(a.x, b.x, v);
          v = fmaf(a.y, b.y, v);
          v = fmaf(a.z, b.z, v);
          v = fmaf(a.w, b.w, v);
        }
      }
      aw2[t] = v;
    }
    for (int t = tid; t < nwg; t += kThreads) {  // dwg[c][l][h] += x[0][c] dg0[l][h]
      const int h = t % kHC, l = (t / kHC) % lmax, c = t / (kHC * lmax);
      float v = awg[t];
      const float* xr = s.sx + c * kTN;
      const float* gr = s.sdg + (l * kHC + h) * kTN;
      for (int n = 0; n < kTN; ++n) v = fmaf(xr[n], gr[n], v);
      awg[t] = v;
    }
    for (int t = tid; t < kHC; t += kThreads) {
      float v = ab1[t];
      for (int n = 0; n < kTN; ++n) v += s.sdm[t * kTN + n];  // row 0 of dh
      ab1[t] = v;
    }
    for (int t = tid; t < lmax * kHC; t += kThreads) {
      float v = abg[t];
      for (int n = 0; n < kTN; ++n) v += s.sdg[t * kTN + n];
      abg[t] = v;
    }
    if (chunk == 0) {
      for (int t = tid; t < Co; t += kThreads) {
        float v = ab2[t];
        for (int n = 0; n < kTN; ++n) v += s.sdy[t * kTN + n];  // row 0 of dy
        ab2[t] = v;
      }
    }
  }

  __syncthreads();  // a slice with no tiles still sees its zeroed sums
  const GradLayout g = grad_layout(d);
  float* row = partial + (long long)slice * g.total;
  for (int t = tid; t < nw1; t += kThreads) {
    const int h = t % kHC, lc = t / kHC;
    if (h0 + h < H) row[g.w1 + (long long)lc * H + h0 + h] = aw1[t];
  }
  for (int t = tid; t < nw2; t += kThreads) {
    const int o = t % Co, h = (t / Co) % kHC, l = t / (Co * kHC);
    if (h0 + h < H) row[g.w2 + ((long long)l * H + h0 + h) * Co + o] = aw2[t];
  }
  for (int t = tid; t < nwg; t += kThreads) {
    const int h = t % kHC, l = (t / kHC) % lmax, c = t / (kHC * lmax);
    if (h0 + h < H) row[g.wg + (long long)c * lmax * H + l * H + h0 + h] = awg[t];
  }
  for (int t = tid; t < kHC; t += kThreads)
    if (h0 + t < H) row[g.b1 + h0 + t] = ab1[t];
  for (int t = tid; t < lmax * kHC; t += kThreads) {
    const int h = t % kHC, l = t / kHC;
    if (h0 + h < H) row[g.bg + l * H + h0 + h] = abg[t];
  }
  if (chunk == 0)
    for (int t = tid; t < Co; t += kThreads) row[g.b2 + t] = ab2[t];
}

size_t dx_smem(const Dims& d) { return (common_floats(d) + (size_t)d.L * kHC * d.C) * sizeof(float); }
size_t w_smem(const Dims& d) { return (common_floats(d) + acc_floats(d)) * sizeof(float); }

// The kernels take C a multiple of 4 within kMaxJobs dx micro-tiles a
// thread (their shared memory is checked at the launch)
bool dims_ok(int N, int lmax, int C, int H, int Co) {
  if (N < 1 || lmax < 1 || C < 4 || C % 4 != 0 || H < 1 || Co < 1) return false;
  const int I = (lmax + 1) * (lmax + 1);
  return kNG * I * (C / 4) <= kMaxJobs * kThreads;
}


}  // namespace cc
}  // namespace

// Slices of node tiles the weight kernel (at bfloat16 x and dy when bf16 !=
// 0) splits N into: as many blocks as fit on the card at once, at least one
// per hidden chunk. The caller allocates the [slices, P] scratch buffer from
// this. Returns -1 for shapes the kernels do not take or whose tiles exceed
// shared memory (at float32: bfloat16 takes the same widths).
extern "C" int so3_gate_ffn_bwd_slices(int N, int lmax, int C, int H, int Co, int bf16) {
  return bf16 ? slices_of<singa::bf16>(N, lmax, C, H, Co) : slices_of<float>(N, lmax, C, H, Co);
}

// 32-bit words of the dx kernel's split weights (the caller's wfrag
// buffer): every hidden chunk's block of chunk_layout<true, T>; -1 for
// shapes the kernels do not take.
extern "C" long long so3_gate_ffn_bwd_dx_words(int lmax, int C, int H, int Co, int bf16) {
  if (!dims_ok(1, lmax, C, H, Co)) return -1;
  const int words = bf16 ? singa::gate::chunk_layout<true, singa::bf16>(lmax, C, Co).words
                         : singa::gate::chunk_layout<true>(lmax, C, Co).words;
  return (long long)((H + kHC - 1) / kHC) * words;
}

// The weight kernel (dx != 0: the dx kernel) at these widths and storage
// type: resident blocks per SM (-1: a shape it does not take), and its
// threads and dynamic shared memory per block.
extern "C" int so3_gate_ffn_bwd_residency(int lmax, int C, int H, int Co, int dx, int bf16,
                                          int* smem_bytes, int* threads) {
  return bf16 ? residency_of<singa::bf16>(lmax, C, H, Co, dx, smem_bytes, threads)
              : residency_of<float>(lmax, C, H, Co, dx, smem_bytes, threads);
}

// The tensor-core kernels: x, dy and dx bfloat16 when bf16 != 0, else
// float32; partial [slices, P] from so3_gate_ffn_bwd_slices (same bf16);
// wfrag: so3_gate_ffn_bwd_dx_words() words of scratch (same bf16), 16-byte
// aligned; grads [P] float32, in grad_layout's order.
extern "C" int so3_gate_ffn_bwd_tc(const void* x, const void* dy, const float* w1,
                                   const float* b1, const float* wg, const float* bg,
                                   const float* w2, void* dx, float* partial, float* grads,
                                   void* wfrag, int N, int lmax, int C, int H, int Co, int slices,
                                   int bf16, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return tc_launch((const singa::bf16*)x, (const singa::bf16*)dy, w1, b1, wg, bg, w2,
                     (singa::bf16*)dx, partial, grads, wfrag, N, lmax, C, H, Co, slices, st);
  return tc_launch((const float*)x, (const float*)dy, w1, b1, wg, bg, w2, (float*)dx, partial,
                   grads, wfrag, N, lmax, C, H, Co, slices, st);
}

// Which of K2b's kernels runs these widths, at float32 and at bfloat16 alike
// (slices_of's one rule; any N): 1 the tensor-core kernels, 0 the CUDA-core
// instance, -1 none. Launches nothing.
extern "C" int so3_gate_ffn_bwd_instance(int lmax, int C, int H, int Co) {
  if (slices_of<float>(1, lmax, C, H, Co) >= 1) return 1;
  return cc::dims_ok(1, lmax, C, H, Co) ? 0 : -1;
}

// Slices of node tiles the CUDA-core weight kernel (at bfloat16 x and dy
// when bf16 != 0) splits N into, as so3_gate_ffn_bwd_slices; -1 for shapes
// it does not take or whose tiles exceed shared memory.
extern "C" int so3_gate_ffn_bwd_cc_slices(int N, int lmax, int C, int H, int Co, int bf16) {
  if (!cc::dims_ok(N, lmax, C, H, Co)) return -1;
  const Dims d = make_dims(N, lmax, C, H, Co);
  const size_t smem = cc::w_smem(d);
  const bool ok = bf16 ? singa::allow_smem(cc::gate_ffn_bwd_dx_kernel<singa::bf16>, cc::dx_smem(d)) ==
                             cudaSuccess &&
                         singa::allow_smem(cc::gate_ffn_bwd_w_kernel<singa::bf16>, smem) == cudaSuccess
                       : singa::allow_smem(cc::gate_ffn_bwd_dx_kernel<float>, cc::dx_smem(d)) ==
                             cudaSuccess &&
                         singa::allow_smem(cc::gate_ffn_bwd_w_kernel<float>, smem) == cudaSuccess;
  if (!ok) return -1;
  const int chunks = (H + cc::kHC - 1) / cc::kHC;
  const int tiles = (N + cc::kTN - 1) / cc::kTN;
  const int resident = bf16 ? singa::persistent_grid(cc::gate_ffn_bwd_w_kernel<singa::bf16>,
                                                     cc::kThreads, smem, 1LL << 30)
                            : singa::persistent_grid(cc::gate_ffn_bwd_w_kernel<float>,
                                                     cc::kThreads, smem, 1LL << 30);
  int slices = resident / chunks;
  if (slices < 1) slices = 1;
  if (slices > tiles) slices = tiles;
  return slices;
}

namespace {

template <class T>
int cc_bwd_launch(const T* x, const T* dy, const float* w1, const float* b1, const float* wg,
                  const float* bg, const float* w2, T* dx, float* partial, float* grads, int N,
                  int lmax, int C, int H, int Co, int slices, cudaStream_t st) {
  if (!cc::dims_ok(N, lmax, C, H, Co) || slices < 1) return (int)cudaErrorInvalidValue;
  const Dims d = make_dims(N, lmax, C, H, Co);
  const size_t sa = cc::dx_smem(d), sb = cc::w_smem(d);
  cudaError_t err = singa::allow_smem(cc::gate_ffn_bwd_dx_kernel<T>, sa);
  if (err != cudaSuccess) return (int)err;
  err = singa::allow_smem(cc::gate_ffn_bwd_w_kernel<T>, sb);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (N + cc::kTN - 1) / cc::kTN;
  const int chunks = (H + cc::kHC - 1) / cc::kHC;
  cc::gate_ffn_bwd_dx_kernel<T><<<tiles, cc::kThreads, sa, st>>>(x, dy, w1, b1, wg, bg, w2, dx,
                                                                 N, lmax, C, H, Co);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cc::gate_ffn_bwd_w_kernel<T><<<chunks * slices, cc::kThreads, sb, st>>>(
      x, dy, w1, b1, wg, bg, w2, partial, N, lmax, C, H, Co, slices);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long P = grad_layout(d).total;
  const int grid = singa::persistent_grid(singa::sum_rows_kernel, 256, 0, (P + 255) / 256);
  singa::sum_rows_kernel<<<grid, 256, 0, st>>>(partial, grads, P, slices);
  return (int)cudaGetLastError();
}

}  // namespace

// K2b's CUDA-core instance: x, dy and dx bfloat16 when bf16 != 0, else
// float32; partial [slices, P] from so3_gate_ffn_bwd_cc_slices (same bf16);
// grads [P] float32 as so3_gate_ffn_bwd_tc's.
extern "C" int so3_gate_ffn_bwd_cc(const void* x, const void* dy, const float* w1,
                                   const float* b1, const float* wg, const float* bg,
                                   const float* w2, void* dx, float* partial, float* grads, int N,
                                   int lmax, int C, int H, int Co, int slices, int bf16,
                                   void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return cc_bwd_launch((const singa::bf16*)x, (const singa::bf16*)dy, w1, b1, wg, bg, w2,
                         (singa::bf16*)dx, partial, grads, N, lmax, C, H, Co, slices, st);
  return cc_bwd_launch((const float*)x, (const float*)dy, w1, b1, wg, bg, w2, (float*)dx, partial,
                       grads, N, lmax, C, H, Co, slices, st);
}
