// K4b: S2-activation SO(3) feed-forward network, backward.
//
// Replaces: singa_tpu/ops/pallas/so3_ffn.py::_bwd (_ffn_bwd_kernel). With the
// forward of csrc/so3_ffn.cu recomputed per node:
//   g0 = x[0] @ wg + bg;  h = lin1(x) (+ b1 on row 0);  v = tg h
//   dmid = dy[i] @ w2[l]^T;  dg0 = silu'(g0) * dmid[0];  dmid[0] := 0
//   mid = fg^T silu(v), mid[0] := silu(g0);  dh = tg^T (silu'(v) * fg dmid)
//   dx[i] = dh[i] @ w1[l]^T  (+ dg0 @ wg^T on row 0)
//   dw1[l] += x[i]^T dh[i];  dw2[l] += mid[i]^T dy[i];  dwg += x[0]^T dg0
//   db1 += dh[0];  dbg += dg0;  db2 += dy[0]
// b1 reaches every row through the grid, so db1 is row 0 of dh (the
// gradient of h's row 0), not of dmid; dmid's row 0 reaches only the gates.
//
// What bounds it on the H100: per node four grid transforms (to-grid of h
// and of dmid, from-grid of silu(v) and of the grid cotangent, 2*G*I*H
// operations each: 42 MFLOP at I = 49, G = 210, H = 512) and five per-degree
// products (h, dmid, dx, dw1, dw2: 4 MFLOP): ~46 MFLOP per node, ~660 GFLOP
// at a training microbatch (N = 14,336), ~9.9 ms at the 67 TFLOP/s float32
// rate, against ~0.14 GB of x, dy in and dx out (~0.04 ms): arithmetic
// bounds it. The grid transforms are 91 % of it and run on the tensor
// cores as three TF32 products each (604 GFLOP x 3 at 495 TFLOP/s,
// ~3.7 ms); the rest stays float32 on the CUDA cores (~0.9 ms).
//
// Design: the hidden, its cotangent and both grids stay out of device
// memory, recomputed per node tile and hidden chunk as the TPU kernel
// recomputes them in VMEM. A block (16 warps) owns a slice of node tiles of
// kTN = 4 nodes and walks the hidden dimension in chunks of kHC = 16
// channels, the chunks outside and its tiles inside: a chunk's weights are
// staged once per block, and its weight-gradient sums stay in shared memory
// over the block's tiles (each sum kept by one fixed thread, added in tile
// order) and go to the block's row of a [blocks, P] scratch buffer once;
// a last kernel adds the rows in block order (sum_rows_kernel):
// deterministic, no atomics. dx is added to in device memory, chunk by
// chunk, in chunk order, by the thread that owns the entry. Per (chunk,
// tile): x and dy staged (float4 loads issued together, while the previous
// tile's sums run), h and dmid as register micro-tiles, the gates and dg0
// (on threads the hidden jobs leave idle), then one pass of the
// tensor-core grid chain (csrc/s2_grid_tc.cuh) over the 64 columns, which
// forms v and the lifted cotangent 32 grid points at a time with split-TF32
// mma.sync (csrc/mma_tf32.cuh) and accumulates mid and dh in registers (at
// lmax 6 the last coefficient row in float32 on the CUDA cores, see
// grid_chain_tc); then the weight-gradient sums and dx. The TPU kernel accumulated the
// weight gradients along its sequential grid; Hopper's blocks run in no
// order. tg and fg are staged once per block, as float32 ([Gp][S], S = 56
// at I = 49, which both fragment orientations read without bank conflicts)
// and split into TF32 halves as each fragment is loaded: their halves
// would take ~200 KB. The grid is persistent, one block per SM. Nodes past
// N are zero rows of x and dy, which make every term they add to a
// gradient exactly zero. The price of the chunks outside the tiles: x and
// dy are read and dx read and written once per chunk, H / kHC = 32 times,
// ~5.7 GB a call at the training microbatch (~1.7 ms at 3.35 TB/s, which
// the next tile's loads during the sums partly hide).
//
// At lmax 6, C = Co = 16 (the model's): 225,792 B of dynamic shared memory,
// 512 threads, 128 registers, no spills (ptxas -v on sm_90a), one block
// per SM.
//
// K4b·bf16 (so3_ffn_bwd with bf16 set; the bfloat16 training path's K4b):
// ffn_bwd_bf16_kernel, the function _ffn_bwd_kernel computes at a bfloat16
// x, rounding where it rounds (singa_tpu/ops/pallas/so3_ffn.py:205-256).
// x, dy, tg, fg and dx are bfloat16 in device memory; w1, wg and w2 are
// rounded as they are staged (b1, bg float32). h is rounded after b1;
// dmid = dy w2^T is rounded but for its row 0, whose float32 values form
// dg0 = silu'(g0) dmid[0] before the row is zeroed; dg0 and the gates are
// rounded. Its chain is grid_chain_mma16_bwd (csrc/s2_grid_tc.cuh): both
// to-grid products transposed, so silu(v) and h = silu'(v) u are formed
// in registers, rounded and fed at once as the B fragments of both
// from-grid products; every product of the chain a bfloat16 m16n8k16
// mma.sync (csrc/mma_bf16.cuh), no barrier inside it, the activated grid
// never in shared memory. h and dmid go to shared memory once a chunk as
// bfloat16 columns (h^T, dmid^T [column][row]), from which each warp loads
// its A fragments by ldmatrix at each grid step; tg and fg are staged
// once a block as bfloat16 [Gp][S], read by ldmatrix as the to-grid B and
// (.trans) as the from-grid A. 16 warps: warp w takes the 16 columns 16 (w
// % 8) .. of a chunk's 128 (kHC = 32 hidden channels x kTN = 4 nodes) and
// half w / 8 of the grid; the second half's sums reach the first's
// through shared memory, where mid and dh are stored rounded (mid's row 0
// the gates, dh's row 0 also unrounded: db1 sums it, dbg the rounded dg0,
// as the TPU kernel). The chunk is twice the float32 kernel's, so x, dy
// and dx's float32 sums (dxf, the caller's scratch; dx is stored rounded
// once, at the last chunk) are read half as often. At lmax 6 row 48 runs
// in float32 on the CUDA cores from the same rounded values. Every sum is
// float32; the weight-gradient sums each kept by one fixed thread, added
// in tile order (dw1 and dw2 in blocks of 4 x 4 sums a thread, each
// shared-memory load feeding four), block rows added in block order. It takes
// lmax 1..6 and C, Co <= 16, the widths of K4's bfloat16 instance.
//
// What bounds K4b·bf16 on the H100: the four grid transforms, 604 GFLOP at
// the training microbatch, take 0.61 ms at the bfloat16 rate (989
// TFLOP/s); the rest, 58 GFLOP on the CUDA cores, 0.87 ms at 67 TFLOP/s.
// At lmax 6, C = Co = 16, G 210: 221,056 B of dynamic shared memory, 512
// threads, 128 registers, 32 B spilled (ptxas -v on sm_90a), one block per
// SM. On an H100 80GB HBM3 at 700 W (tools/bench_k4_parts.py) the call
// took 9.4 ms, of which the chain 3.8, the weight-gradient sums 0.9 and dx
// 1.2 (each the time the kernel lost without it); the sums took 2.8 of
// 11.3 ms one sum a thread, a shared-memory read of two float4s for four
// multiply-adds, before their 4 x 4 blocks.
#include "s2_grid_tc.cuh"

namespace {

constexpr int kThreads = singa::kTcThreads;
constexpr int kTN = 4;            // nodes per tile
constexpr int kHC = 16;           // hidden channels per chunk
constexpr int kNCOL = kHC * kTN;  // grid-chain columns per chunk
constexpr int kPad = 4;           // floats added to each row block
constexpr int kStageLoads = 4;    // float4 loads a thread issues together when staging a tile

using singa::degree_of;
using singa::fma4;

struct Dims {
  int N, lmax, L, I, Ip, C, H, Co, G;
};

__host__ __device__ inline Dims make_dims(int N, int lmax, int C, int H, int Co, int G) {
  const int I = (lmax + 1) * (lmax + 1);
  return Dims{N, lmax, lmax + 1, I, singa::pad_rows(I), C, H, Co, G};
}

// A block's weight-gradient sums for one hidden chunk, in shared memory:
// dw1 [L][C][kHC], dw2 [L][kHC][Co], dwg [C][kHC], db1 [kHC], dbg [kHC],
// db2 [Co] (db2 in the first chunk only).
__host__ __device__ inline int wsum_floats(const Dims& d) {
  return d.L * d.C * kHC + d.L * kHC * d.Co + d.C * kHC + 2 * kHC + d.Co;
}

__host__ __device__ inline size_t smem_floats(const Dims& d) {
  return singa::tc_mats_floats(d.G, d.I) + (size_t)d.I * (d.C * kTN + kPad) +
         (size_t)d.I * (d.Co * kTN + kPad) + 2 * (size_t)d.Ip * (kNCOL + kPad) +
         singa::tc_act_floats(kNCOL) + (size_t)d.L * d.C * kHC + (size_t)d.C * kHC +
         (size_t)d.L * d.Co * kHC + 2 * kNCOL + wsum_floats(d);
}

// Offsets of the weight gradients in one flat row of P floats, in the order
// dw1 [L, C, H], db1 [H], dwg [C, H], dbg [H], dw2 [L, H, Co], db2 [Co].
struct GradLayout {
  long long w1, b1, wg, bg, w2, b2, total;
};

__host__ __device__ inline GradLayout grad_layout(const Dims& d) {
  GradLayout g;
  g.w1 = 0;
  g.b1 = g.w1 + (long long)d.L * d.C * d.H;
  g.wg = g.b1 + d.H;
  g.bg = g.wg + (long long)d.C * d.H;
  g.w2 = g.bg + d.H;
  g.b2 = g.w2 + (long long)d.L * d.H * d.Co;
  g.total = g.b2 + d.Co;
  return g;
}

// x / d and x % d for 0 <= x < 2^32 / d by one multiply-high with
// ceil(2^32 / d), in place of the division by a value known only at run
// time (d = 1 is taken as it is)
struct FastDiv {
  unsigned d, m;
  __device__ explicit FastDiv(int d_) : d(d_), m(d_ > 1 ? 0xffffffffu / d_ + 1 : 0) {}
  __device__ int div(int x) const { return d > 1 ? __umulhi((unsigned)x, m) : x; }
  __device__ int mod(int x) const { return x - div(x) * d; }
};

// sum over the rows i of degree l and the kTN nodes of a[i][n] b[i][n]
// (a and b: float4 columns at row strides as and bs), four partial sums
__device__ inline float dot_rows(const float* a, int as, const float* b, int bs, int l) {
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int i = l * l; i < (l + 1) * (l + 1); ++i) {
    const float4 x = *reinterpret_cast<const float4*>(a + i * as);
    const float4 y = *reinterpret_cast<const float4*>(b + i * bs);
    s.x = fmaf(x.x, y.x, s.x);
    s.y = fmaf(x.y, y.y, s.y);
    s.z = fmaf(x.z, y.z, s.z);
    s.w = fmaf(x.w, y.w, s.w);
  }
  return (s.x + s.y) + (s.z + s.w);
}

__global__ void __launch_bounds__(kThreads, 1)
ffn_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dy,
               const float* __restrict__ w1, const float* __restrict__ b1,
               const float* __restrict__ wg, const float* __restrict__ bg,
               const float* __restrict__ w2, const float* __restrict__ tg,
               const float* __restrict__ fg, float* __restrict__ dx,
               float* __restrict__ partial, Dims d) {
  const int L = d.L, I = d.I, C = d.C, H = d.H, Co = d.Co;
  const int xs = C * kTN + kPad;   // row stride of sx
  const int ys = Co * kTN + kPad;  // row stride of sdy
  const int hs = kNCOL + kPad;     // row stride of sh and sdm
  extern __shared__ __align__(16) float smem[];
  float* stg = smem;                         // tg, fg [Gp][S], guard
  float* sx = stg + singa::tc_mats_floats(d.G, I);  // [I][C][kTN] (+pad per row)
  float* sdy = sx + I * xs;                  // [I][Co][kTN] (+pad per row)
  float* sh = sdy + I * ys;                  // [Ip][kHC][kTN] (+pad): h, then mid
  float* sdm = sh + d.Ip * hs;               // [Ip][kHC][kTN] (+pad): dmid, then dh
  float* sact = sdm + d.Ip * hs;             // the chain's activated grid
  float* sw1 = sact + singa::tc_act_floats(kNCOL);  // [L][C][kHC]
  float* swg = sw1 + L * C * kHC;            // [C][kHC]
  float* sw2t = swg + C * kHC;               // [L][Co][kHC]
  float* sgate = sw2t + L * Co * kHC;        // [kHC][kTN] g0, then silu(g0)
  float* sdg = sgate + kNCOL;                // [kHC][kTN] dg0
  float* swsum = sdg + kNCOL;                // the chunk's weight-gradient sums

  const int tid = threadIdx.x;
  const int C4 = C / 4, Co4 = Co / 4;
  const int nx4 = kTN * I * C4, ny4 = kTN * I * Co4;  // float4s of a tile's x and dy
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const float4* dy4 = reinterpret_cast<const float4*>(dy);
  const FastDiv divC(C), divCo(Co), divC4(C4), divCo4(Co4), divI(I);
  const bool dx_job = tid < I * C4;  // one dx micro-tile (4 nodes x 4 channels of a row)
  const int dx_c4 = tid % C4, dx_i = tid / C4;
  const GradLayout gl = grad_layout(d);
  float* row = partial + (long long)blockIdx.x * gl.total;
  singa::stage_grid_mats_tc(tg, fg, d.G, I, stg);
  for (int t = tid; t < (d.Ip - I) * hs; t += kThreads) {  // padded rows
    sh[I * hs + t] = 0.f;
    sdm[I * hs + t] = 0.f;
  }

  const int tiles = (d.N + kTN - 1) / kTN;
  const int t_begin = (int)((long long)tiles * blockIdx.x / gridDim.x);
  const int t_end = (int)((long long)tiles * (blockIdx.x + 1) / gridDim.x);
  // x and dy of a tile as float4s t = base + k * kThreads (k < kStageLoads),
  // loaded together into v, then stored transposed into sx and sdy
  auto load_tile = [&](int n0, int base, float4 (&v)[kStageLoads]) {
#pragma unroll
    for (int k = 0; k < kStageLoads; ++k) {
      const int t = base + k * kThreads;
      v[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t < nx4) {
        if (t < (d.N - n0) * I * C4) v[k] = x4[(long long)n0 * I * C4 + t];
      } else if (t < nx4 + ny4) {
        if (t - nx4 < (d.N - n0) * I * Co4) v[k] = dy4[(long long)n0 * I * Co4 + t - nx4];
      }
    }
  };
  auto store_tile = [&](int base, const float4 (&v)[kStageLoads]) {
#pragma unroll
    for (int k = 0; k < kStageLoads; ++k) {
      const int t = base + k * kThreads;
      float* p;
      if (t < nx4) {
        const int q = divC4.div(t), n = divI.div(q), i = q - n * I, c = 4 * (t - q * C4);
        p = sx + i * xs + c * kTN + n;
      } else if (t < nx4 + ny4) {
        const int u = t - nx4, q = divCo4.div(u), n = divI.div(q), i = q - n * I;
        p = sdy + i * ys + 4 * (u - q * Co4) * kTN + n;
      } else {
        continue;
      }
      p[0] = v[k].x;
      p[kTN] = v[k].y;
      p[2 * kTN] = v[k].z;
      p[3 * kTN] = v[k].w;
    }
  };

  const bool one_batch = nx4 + ny4 <= kStageLoads * kThreads;
  float4 pre[kStageLoads];  // the next tile's x and dy
  const int gate_first = 2 * I * (kHC / 4) + kNCOL <= kThreads ? 2 * I * (kHC / 4) : 0;
  const int E = wsum_floats(d);
  const int e2 = L * C * kHC, e3 = e2 + L * kHC * Co, e4 = e3 + C * kHC, e5 = e4 + 2 * kHC;
  for (int h0 = 0; h0 < H; h0 += kHC) {
    __syncthreads();  // the previous chunk's readers of the weights and the sums are done
    for (int t = tid; t < L * C * kHC; t += kThreads) {
      const int h = t % kHC, lc = t / kHC;
      sw1[t] = (h0 + h < H) ? w1[(long long)lc * H + h0 + h] : 0.f;
    }
    for (int t = tid; t < C * kHC; t += kThreads) {
      const int h = t % kHC, c = t / kHC;
      swg[t] = (h0 + h < H) ? wg[(long long)c * H + h0 + h] : 0.f;
    }
    for (int t = tid; t < L * Co * kHC; t += kThreads) {
      const int h = t % kHC, o = (t / kHC) % Co, l = t / (kHC * Co);
      sw2t[t] = (h0 + h < H) ? w2[((long long)l * H + h0 + h) * Co + o] : 0.f;
    }
    for (int e = tid; e < E; e += kThreads) swsum[e] = 0.f;
    if (one_batch && t_begin < t_end) load_tile(t_begin * kTN, tid, pre);

    for (int tile = t_begin; tile < t_end; ++tile) {
      const int n0 = tile * kTN;
      __syncthreads();  // the previous tile's readers of sx, sdy, sh and sdm are done
      // x and dy of the tile: loaded while the previous tile's sums ran where
      // they fit one batch of loads (lmax <= 7 at C = Co = 16), else here
      if (one_batch) {
        store_tile(tid, pre);
      } else {
        for (int base = tid; base < nx4 + ny4; base += kStageLoads * kThreads) {
          float4 v[kStageLoads];
          load_tile(n0, base, v);
          store_tile(base, v);
        }
      }
      __syncthreads();
      // gate pre-activations g0, [kHC][kTN], on threads the hidden jobs
      // below leave idle where there are enough of them
      for (int t = tid - gate_first; t < kNCOL; t += kThreads) {
        if (t < 0) continue;
        const int n = t % kTN, h = t / kTN;
        float4 v = make_float4((h0 + h < H) ? bg[h0 + h] : 0.f, 0.f, 0.f, 0.f);
        for (int c = 0; c < C; c += 4) {  // C % 4 == 0; four partial sums
          v.x = fmaf(sx[c * kTN + n], swg[c * kHC + h], v.x);
          v.y = fmaf(sx[(c + 1) * kTN + n], swg[(c + 1) * kHC + h], v.y);
          v.z = fmaf(sx[(c + 2) * kTN + n], swg[(c + 2) * kHC + h], v.z);
          v.w = fmaf(sx[(c + 3) * kTN + n], swg[(c + 3) * kHC + h], v.w);
        }
        sgate[t] = (v.x + v.y) + (v.z + v.w);
      }
      // h (the first I * kHC / 4 jobs) and dmid (the rest): micro-tiles of
      // four nodes x four hidden channels of one row
      for (int t = tid; t < 2 * I * (kHC / 4); t += kThreads) {
        const bool is_h = t < I * (kHC / 4);
        const int j = is_h ? t : t - I * (kHC / 4);
        const int h4 = j % (kHC / 4), i = j / (kHC / 4);
        const int l = degree_of(i);
        const int K = is_h ? C : Co;
        const float* xr = is_h ? sx + i * xs : sdy + i * ys;
        const float* wr = (is_h ? sw1 + l * C * kHC : sw2t + l * Co * kHC) + 4 * h4;
        float4 a[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
        for (int c = 0; c < K; ++c) {
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
          if (is_h && i == 0 && h0 + h < H) {
            const float bb = b1[h0 + h];
            a[r].x += bb;
            a[r].y += bb;
            a[r].z += bb;
            a[r].w += bb;
          }
          *reinterpret_cast<float4*>((is_h ? sh : sdm) + i * hs + h * kTN) = a[r];
        }
      }
      __syncthreads();
      // row 0 of dmid reaches only the gates: dg0, then zero it for the grid
      for (int t = tid; t < kNCOL; t += kThreads) {
        const float g = sgate[t];
        sdg[t] = singa::silu_gradf_(g) * sdm[t];
        sgate[t] = singa::siluf_(g);
        sdm[t] = 0.f;
      }
      __syncthreads();

      // mid = fg^T silu(tg h) (row 0 := gates) over h; dh = tg^T (silu'(tg h)
      // * fg dmid) over dmid
      if (I == 49)  // lmax 6, the model's: I known when compiling (see grid_chain_tc)
        singa::grid_chain_tc<kNCOL, 49>(stg, d.G, I, sh, sdm, hs, sact, sh, sdm, sgate);
      else
        singa::grid_chain_tc<kNCOL, 0>(stg, d.G, I, sh, sdm, hs, sact, sh, sdm, sgate);
      __syncthreads();
      if (one_batch && tile + 1 < t_end) load_tile(n0 + kTN, tid, pre);

      // dx of the tile so far (device memory, added to in chunk order)
      float4 acc[4];
      float4* dx4 = reinterpret_cast<float4*>(dx) + (long long)n0 * I * C4 + tid;
#pragma unroll
      for (int q = 0; q < 4; ++q)  // node n0 + q, row dx_i, channels 4 dx_c4 ..
        acc[q] = (dx_job && h0 > 0 && n0 + q < d.N) ? dx4[q * I * C4]
                                                    : make_float4(0.f, 0.f, 0.f, 0.f);

      // the tile's share of the chunk's weight gradients, each sum kept by one thread
      for (int e = tid; e < E; e += kThreads) {
        float v = 0.f;
        if (e < e2) {  // dw1[l][c][h] += x[i][c] dh[i][h]
          const int h = e % kHC, l = divC.div(e / kHC), c = e / kHC - l * C;
          v = dot_rows(sx + c * kTN, xs, sdm + h * kTN, hs, l);
        } else if (e < e3) {  // dw2[l][h][o] += mid[i][h] dy[i][o]
          const int t = e - e2, q = divCo.div(t), o = t - q * Co, h = q % kHC, l = q / kHC;
          v = dot_rows(sh + h * kTN, hs, sdy + o * kTN, ys, l);
        } else if (e < e4) {  // dwg[c][h] += x[0][c] dg0[h]
          const int t = e - e3, h = t % kHC, c = t / kHC;
          const float4 a = *reinterpret_cast<const float4*>(sx + c * kTN);
          const float4 b = *reinterpret_cast<const float4*>(sdg + h * kTN);
          v = a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
        } else if (e < e5) {  // db1 (row 0 of dh), dbg
          const int t = e - e4, h = t % kHC;
          const float4 b = *reinterpret_cast<const float4*>((t < kHC ? sdm : sdg) + h * kTN);
          v = b.x + b.y + b.z + b.w;
        } else if (h0 == 0) {  // db2 (row 0 of dy)
          const float4 b = *reinterpret_cast<const float4*>(sdy + (e - e5) * kTN);
          v = b.x + b.y + b.z + b.w;
        }
        swsum[e] += v;
      }

      // dx += dh @ w1^T, and on row 0 dg0 @ wg^T
      if (dx_job) {
        const int l = degree_of(dx_i);
        const float* dr = sdm + dx_i * hs;
        const float* wr = sw1 + (l * C + 4 * dx_c4) * kHC;
        // the hidden channels in an order rotated by channel group and degree,
        // so that a warp's reads of sw1 (four channel groups, at most four
        // degrees) fall in distinct banks
        const int rot = 4 * dx_c4 + l;
        for (int k = 0; k < kHC; ++k) {
          const int h = (k + rot) % kHC;
          const float4 dv = *reinterpret_cast<const float4*>(dr + h * kTN);
          const float4 wv = make_float4(wr[h], wr[kHC + h], wr[2 * kHC + h], wr[3 * kHC + h]);
          fma4(acc[0], dv.x, wv);
          fma4(acc[1], dv.y, wv);
          fma4(acc[2], dv.z, wv);
          fma4(acc[3], dv.w, wv);
        }
        if (dx_i == 0) {
          for (int h = 0; h < kHC; ++h) {
            const float4 gv = *reinterpret_cast<const float4*>(sdg + h * kTN);
            const float* wc = swg + 4 * dx_c4 * kHC + h;
            const float4 wv = make_float4(wc[0], wc[kHC], wc[2 * kHC], wc[3 * kHC]);
            fma4(acc[0], gv.x, wv);
            fma4(acc[1], gv.y, wv);
            fma4(acc[2], gv.z, wv);
            fma4(acc[3], gv.w, wv);
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (n0 + q < d.N) dx4[q * I * C4] = acc[q];
      }
    }
    __syncthreads();  // the chunk's sums are complete

    // the chunk's sums into the block's row
    for (int e = tid; e < E; e += kThreads) {
      long long at = -1;
      if (e < e2) {
        const int h = e % kHC, c = (e / kHC) % C, l = e / (kHC * C);
        if (h0 + h < H) at = gl.w1 + ((long long)l * C + c) * H + h0 + h;
      } else if (e < e3) {
        const int t = e - e2, o = t % Co, h = (t / Co) % kHC, l = t / (Co * kHC);
        if (h0 + h < H) at = gl.w2 + ((long long)l * H + h0 + h) * Co + o;
      } else if (e < e4) {
        const int t = e - e3, h = t % kHC, c = t / kHC;
        if (h0 + h < H) at = gl.wg + (long long)c * H + h0 + h;
      } else if (e < e5) {
        const int t = e - e4, h = t % kHC;
        if (h0 + h < H) at = (t < kHC ? gl.b1 : gl.bg) + h0 + h;
      } else if (h0 == 0) {
        at = gl.b2 + (e - e5);
      }
      if (at >= 0) row[at] = swsum[e];
    }
  }
}

// ------------------------------- bfloat16 --------------------------------
namespace bf {

using singa::bf16;
namespace mma16 = singa::mma16;

constexpr int kTN = 4;                   // nodes per tile
constexpr int kHC = 32;                  // hidden channels per chunk
constexpr int kNCOL = kHC * kTN;         // chain columns per chunk: column ch * kTN + node
constexpr int kColTiles = kNCOL / 16;    // the chain's 16-column tiles
constexpr int kParts = kThreads / 32 / kColTiles;  // warps of a column tile, each a part of the grid
constexpr int kOS = kNCOL + kPad;        // row stride of mid and dh in shared memory
static_assert(kParts == 2, "two halves of the grid a column tile: one exchange of sums");

// S: the row stride (values) of the staged tg, fg and of h^T, dmid^T: 16 KS
// + 8, odd in 16-byte units (ldmatrix reads it without bank conflicts),
// past row 48 at lmax 6 (the tail row). KS = MT: k16 steps of the to-grid
// products and m16 tiles of the from-grid ones (rows 0 .. 47 at I 49).
struct Dims {
  int N, L, I, C, H, Co, G, Gp, S, KS;
};

inline Dims make_dims(int N, int lmax, int C, int H, int Co, int G) {
  Dims d;
  d.N = N, d.L = lmax + 1, d.I = d.L * d.L, d.C = C, d.H = H, d.Co = Co, d.G = G;
  d.KS = ((d.I == 49 ? 48 : d.I) + 15) / 16;
  d.S = 16 * d.KS + 8;
  constexpr int q = 16 * kParts;  // whole k16 grid steps for each part
  d.Gp = (G + q - 1) / q * q;
  return d;
}

// A block's weight-gradient sums for one hidden chunk (as wsum_floats)
__host__ __device__ inline int wsum_floats(const Dims& d) {
  return d.L * d.C * kHC + d.L * kHC * d.Co + d.C * kHC + 2 * kHC + d.Co;
}

inline size_t smem_bytes(const Dims& d) {
  const size_t bf = (size_t)(2 * d.Gp + 2 * kNCOL) * d.S * sizeof(bf16);
  const size_t fl = (size_t)d.I * (d.C * kTN + kPad) + (size_t)d.I * (d.Co * kTN + kPad) +
                    2 * (size_t)d.I * kOS + (size_t)d.L * d.C * kHC + (size_t)d.C * kHC +
                    (size_t)d.L * d.Co * kHC + 4 * kNCOL + wsum_floats(d);
  return bf + fl * sizeof(float);
}

// Four values of a bfloat16 array from 8-byte word q, as float
__device__ __forceinline__ float4 load4(const bf16* p, long long q) {
  const uint2 u = reinterpret_cast<const uint2*>(p)[q];
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// Four floats rounded to bfloat16, as one 8-byte word (the first in the low half)
__device__ __forceinline__ uint2 pack4(const float4& a) {
  return make_uint2(mma16::pack(a.x, a.y), mma16::pack(a.z, a.w));
}

// I0: 49 at lmax 6 (row 48 in float32, grid_chain_mma16_bwd), else 0
template <int I0>
__global__ void __launch_bounds__(kThreads, 1)
ffn_bwd_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                    const float* __restrict__ w1, const float* __restrict__ b1,
                    const float* __restrict__ wg, const float* __restrict__ bg,
                    const float* __restrict__ w2, const bf16* __restrict__ tg,
                    const bf16* __restrict__ fg, bf16* __restrict__ dx,
                    float* __restrict__ dxf, float* __restrict__ partial, Dims d) {
  constexpr bool kTail = I0 == 49;
  using singa::rnd;
  const int L = d.L, I = d.I, C = d.C, H = d.H, Co = d.Co, S = d.S;
  const int xs = C * kTN + kPad;   // row stride of sx
  const int ys = Co * kTN + kPad;  // row stride of sdy
  extern __shared__ __align__(16) float smem[];
  bf16* stg = reinterpret_cast<bf16*>(smem);  // tg [Gp][S]
  bf16* sfg = stg + d.Gp * S;                 // fg [Gp][S]
  bf16* shT = sfg + d.Gp * S;                 // h^T [kNCOL][S], rounded
  bf16* syT = shT + kNCOL * S;                // dmid^T [kNCOL][S], rounded, row 0 zero
  float* sx = reinterpret_cast<float*>(syT + kNCOL * S);  // [I][C][kTN] (+pad per row)
  float* sdy = sx + I * xs;                   // [I][Co][kTN] (+pad per row)
  float* smid = sdy + I * ys;                 // [I][kOS]: mid, rounded
  float* sdh = smid + I * kOS;                // [I][kOS]: dh, rounded
  float* sw1 = sdh + I * kOS;                 // [L][C][kHC]
  float* swg = sw1 + L * C * kHC;             // [C][kHC]
  float* sw2t = swg + C * kHC;                // [L][Co][kHC]
  float* sgate = sw2t + L * Co * kHC;         // [kNCOL] g0, then the gate, rounded
  float* sdg = sgate + kNCOL;                 // [kNCOL] dg0, rounded
  float* sdm0 = sdg + kNCOL;                  // [kNCOL] dmid's row 0, float32
  float* sdb1 = sdm0 + kNCOL;                 // [kNCOL] dh's row 0, unrounded
  float* swsum = sdb1 + kNCOL;                // the chunk's weight-gradient sums

  const int tid = threadIdx.x, warp = tid >> 5;
  const int grp = singa::tc::lane_grp(), tig = singa::tc::lane_tig();
  const int C4 = C / 4, Co4 = Co / 4;
  const int nx4 = kTN * I * C4, ny4 = kTN * I * Co4;  // 4-value words of a tile's x and dy
  const FastDiv divC4(C4), divCo4(Co4), divI(I);
  const bool dx_job = tid < I * C4;  // one dx micro-tile (4 nodes x 4 channels of a row)
  const int dx_c4 = tid % C4, dx_i = tid / C4;
  const GradLayout gl = grad_layout(::make_dims(d.N, L - 1, C, H, Co, d.G));
  float* row = partial + (long long)blockIdx.x * gl.total;
  const bf16 zero = singa::from_f<bf16>(0.f);
  for (int t = tid; t < d.Gp * S; t += kThreads) {
    const int g = t / S, i = t - g * S;
    const bool in = g < d.G && i < I;
    stg[t] = in ? tg[g * I + i] : zero;
    sfg[t] = in ? fg[g * I + i] : zero;
  }
  for (int t = tid; t < kNCOL * S; t += kThreads) {  // rows past I stay zero, and dmid's row 0
    shT[t] = zero;
    syT[t] = zero;
  }
  // the chain's map: warp w's 16 columns and half of the grid (k16 steps)
  const int c0 = 16 * (warp % kColTiles), part = warp / kColTiles;
  const int half = d.Gp / 16 / kParts;

  const int tiles = (d.N + kTN - 1) / kTN;
  const int t_begin = (int)((long long)tiles * blockIdx.x / gridDim.x);
  const int t_end = (int)((long long)tiles * (blockIdx.x + 1) / gridDim.x);
  // x and dy of a tile as 4-value words t = base + k * kThreads (k <
  // kStageLoads), loaded together into v, then stored transposed into sx
  // and sdy as float
  auto load_tile = [&](int n0, int base, float4 (&v)[kStageLoads]) {
#pragma unroll
    for (int k = 0; k < kStageLoads; ++k) {
      const int t = base + k * kThreads;
      v[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t < nx4) {
        if (t < (d.N - n0) * I * C4) v[k] = load4(x, (long long)n0 * I * C4 + t);
      } else if (t < nx4 + ny4) {
        if (t - nx4 < (d.N - n0) * I * Co4) v[k] = load4(dy, (long long)n0 * I * Co4 + t - nx4);
      }
    }
  };
  auto store_tile = [&](int base, const float4 (&v)[kStageLoads]) {
#pragma unroll
    for (int k = 0; k < kStageLoads; ++k) {
      const int t = base + k * kThreads;
      float* p;
      if (t < nx4) {
        const int q = divC4.div(t), n = divI.div(q), i = q - n * I, c = 4 * (t - q * C4);
        p = sx + i * xs + c * kTN + n;
      } else if (t < nx4 + ny4) {
        const int u = t - nx4, q = divCo4.div(u), n = divI.div(q), i = q - n * I;
        p = sdy + i * ys + 4 * (u - q * Co4) * kTN + n;
      } else {
        continue;
      }
      p[0] = v[k].x;
      p[kTN] = v[k].y;
      p[2 * kTN] = v[k].z;
      p[3 * kTN] = v[k].w;
    }
  };

  const bool one_batch = nx4 + ny4 <= kStageLoads * kThreads;
  float4 pre[kStageLoads];  // the next tile's x and dy
  const int njobs = 2 * I * (kHC / 4);  // h's and dmid's micro-tiles, then the gates
  const int E = wsum_floats(d);
  const int e2 = L * C * kHC, e3 = e2 + L * kHC * Co, e4 = e3 + C * kHC, e5 = e4 + 2 * kHC;
  // dw1's and dw2's blocks of 4 x 4 sums
  const int nb1 = L * C4 * (kHC / 4), nb12 = nb1 + L * Co4 * (kHC / 4);
  for (int h0 = 0; h0 < H; h0 += kHC) {
    __syncthreads();  // the previous chunk's readers of the weights and the sums are done
    for (int t = tid; t < L * C * kHC; t += kThreads) {
      const int h = t % kHC, lc = t / kHC;
      sw1[t] = (h0 + h < H) ? rnd<bf16>(w1[(long long)lc * H + h0 + h]) : 0.f;
    }
    for (int t = tid; t < C * kHC; t += kThreads) {
      const int h = t % kHC, c = t / kHC;
      swg[t] = (h0 + h < H) ? rnd<bf16>(wg[(long long)c * H + h0 + h]) : 0.f;
    }
    for (int t = tid; t < L * Co * kHC; t += kThreads) {
      const int h = t % kHC, o = (t / kHC) % Co, l = t / (kHC * Co);
      sw2t[t] = (h0 + h < H) ? rnd<bf16>(w2[((long long)l * H + h0 + h) * Co + o]) : 0.f;
    }
    for (int e = tid; e < E; e += kThreads) swsum[e] = 0.f;
    if (one_batch && t_begin < t_end) load_tile(t_begin * kTN, tid, pre);

    for (int tile = t_begin; tile < t_end; ++tile) {
      const int n0 = tile * kTN;
      __syncthreads();  // the previous tile's readers of every tile buffer are done
      // x and dy of the tile: loaded while the previous tile's sums ran where
      // they fit one batch of loads (lmax <= 7 at C = Co = 16), else here
      if (one_batch) {
        store_tile(tid, pre);
      } else {
        for (int base = tid; base < nx4 + ny4; base += kStageLoads * kThreads) {
          float4 v[kStageLoads];
          load_tile(n0, base, v);
          store_tile(base, v);
        }
      }
      __syncthreads();
      // h (the first I * kHC / 4 jobs) and dmid (the next): micro-tiles of
      // four nodes x four hidden channels of one row, rows first so that a
      // warp's stores to h^T and dmid^T fall on neighbouring values; then
      // the gate pre-activations g0
      for (int t = tid; t < njobs + kNCOL; t += kThreads) {
        if (t >= njobs) {
          const int u = t - njobs, n = u % kTN, h = u / kTN;
          float4 v = make_float4((h0 + h < H) ? bg[h0 + h] : 0.f, 0.f, 0.f, 0.f);
          for (int c = 0; c < C; c += 4) {  // C % 4 == 0; four partial sums
            v.x = fmaf(sx[c * kTN + n], swg[c * kHC + h], v.x);
            v.y = fmaf(sx[(c + 1) * kTN + n], swg[(c + 1) * kHC + h], v.y);
            v.z = fmaf(sx[(c + 2) * kTN + n], swg[(c + 2) * kHC + h], v.z);
            v.w = fmaf(sx[(c + 3) * kTN + n], swg[(c + 3) * kHC + h], v.w);
          }
          sgate[u] = (v.x + v.y) + (v.z + v.w);
          continue;
        }
        const bool is_h = t < I * (kHC / 4);
        const int j = is_h ? t : t - I * (kHC / 4);
        const int h4 = divI.div(j), i = j - h4 * I;
        const int l = degree_of(i);
        const int K = is_h ? C : Co;
        const float* xr = is_h ? sx + i * xs : sdy + i * ys;
        const float* wr = (is_h ? sw1 + l * C * kHC : sw2t + l * Co * kHC) + 4 * h4;
        float4 a[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
        for (int c = 0; c < K; ++c) {
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
          if (is_h && i == 0 && h0 + h < H) {
            const float bb = b1[h0 + h];
            a[r].x += bb;
            a[r].y += bb;
            a[r].z += bb;
            a[r].w += bb;
          }
          if (!is_h && i == 0) {  // dmid's row 0, float32: dg0's (zero for the grid)
            *reinterpret_cast<float4*>(sdm0 + h * kTN) = a[r];
            continue;
          }
          // h.astype(dt); dmid.astype(dt) (rows past 0)
          bf16* col = (is_h ? shT : syT) + h * kTN * S + i;
          col[0] = singa::from_f<bf16>(a[r].x);
          col[S] = singa::from_f<bf16>(a[r].y);
          col[2 * S] = singa::from_f<bf16>(a[r].z);
          col[3 * S] = singa::from_f<bf16>(a[r].w);
        }
      }
      __syncthreads();
      // row 0 of dmid reaches only the gates: dg0.astype(dt), gate.astype(dt)
      // (read after the chain, behind its barriers)
      for (int t = tid; t < kNCOL; t += kThreads) {
        const float g = sgate[t];
        sdg[t] = rnd<bf16>(singa::silu_gradf_(g) * sdm0[t]);
        sgate[t] = rnd<bf16>(singa::siluf_(g));
      }

      // the chain: mid = fg^T silu(tg h), dh = tg^T (silu'(tg h) fg dmid)
      // over the warp's columns and half of the grid
      float om[3][2][4], od[3][2][4], tm[2], td[2];
      singa::grid_chain_mma16_bwd<I0>(stg, sfg, S, shT + c0 * S, syT + c0 * S, d.KS, d.KS,
                                      part * half, (part + 1) * half, om, od, tm, td);
#pragma unroll
      for (int j = 0; j < 2; ++j) {  // the tail row: the four lanes of a column
        tm[j] += __shfl_xor_sync(0xffffffffu, tm[j], 1);
        tm[j] += __shfl_xor_sync(0xffffffffu, tm[j], 2);
        td[j] += __shfl_xor_sync(0xffffffffu, td[j], 1);
        td[j] += __shfl_xor_sync(0xffffffffu, td[j], 2);
      }
      // the second half's sums into smid and sdh; the first half adds its
      // own, rounds (mid.astype(dt), dh.astype(dt)), mid's row 0 the gates,
      // dh's row 0 also unrounded into sdb1
      if (part == 1) {
#pragma unroll
        for (int mt = 0; mt < 3; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 16 * mt + grp + 8 * h;
            if ((kTail || mt < d.KS) && i < I)
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                const int at = i * kOS + c0 + 8 * j + 2 * tig;
                *reinterpret_cast<float2*>(smid + at) =
                    make_float2(om[mt][j][2 * h], om[mt][j][2 * h + 1]);
                *reinterpret_cast<float2*>(sdh + at) =
                    make_float2(od[mt][j][2 * h], od[mt][j][2 * h + 1]);
              }
          }
        if (kTail && tig == 0)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            smid[(I0 - 1) * kOS + c0 + 8 * j + grp] = tm[j];
            sdh[(I0 - 1) * kOS + c0 + 8 * j + grp] = td[j];
          }
      }
      __syncthreads();
      if (part == 0) {
#pragma unroll
        for (int mt = 0; mt < 3; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 16 * mt + grp + 8 * h;
            if ((kTail || mt < d.KS) && i < I)
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                const int c = c0 + 8 * j + 2 * tig, at = i * kOS + c;
                const float2 pm = *reinterpret_cast<const float2*>(smid + at);
                const float2 pd = *reinterpret_cast<const float2*>(sdh + at);
                float2 m = make_float2(rnd<bf16>(om[mt][j][2 * h] + pm.x),
                                       rnd<bf16>(om[mt][j][2 * h + 1] + pm.y));
                const float2 dv = make_float2(od[mt][j][2 * h] + pd.x,
                                              od[mt][j][2 * h + 1] + pd.y);
                if (i == 0) {
                  m = make_float2(sgate[c], sgate[c + 1]);
                  *reinterpret_cast<float2*>(sdb1 + c) = dv;
                }
                *reinterpret_cast<float2*>(smid + at) = m;
                *reinterpret_cast<float2*>(sdh + at) = make_float2(rnd<bf16>(dv.x), rnd<bf16>(dv.y));
              }
          }
        if (kTail && tig == 0)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int at = (I0 - 1) * kOS + c0 + 8 * j + grp;
            smid[at] = rnd<bf16>(smid[at] + tm[j]);
            sdh[at] = rnd<bf16>(sdh[at] + td[j]);
          }
      }
      __syncthreads();
      if (one_batch && tile + 1 < t_end) load_tile(n0 + kTN, tid, pre);

      // dx of the tile so far: float32 sums in dxf over the chunks, rounded
      // once into dx at the last (dx.astype(dt))
      float4 acc[4];
      float4* dx4 = reinterpret_cast<float4*>(dxf) + (long long)n0 * I * C4 + tid;
#pragma unroll
      for (int q = 0; q < 4; ++q)  // node n0 + q, row dx_i, channels 4 dx_c4 ..
        acc[q] = (dx_job && h0 > 0 && n0 + q < d.N) ? dx4[q * I * C4]
                                                    : make_float4(0.f, 0.f, 0.f, 0.f);

      // the tile's share of the chunk's weight gradients, each sum kept by
      // one fixed thread: dw1 and dw2 in blocks of 4 x 4 sums a thread
      // (channels k4 + K4 a of x or dy, hidden channels h4 + 8 b of dh or
      // mid: the eight h4 of a phase read neighbouring float4s, its k4 one
      // float4, so a row's loads are conflict-free and each feeds four
      // sums), the rest one sum a thread
      for (int j = tid; j < nb12 + (E - e3); j += kThreads) {
        if (j < nb12) {
          const bool w1b = j < nb1;  // dw1[l][c][h] += x[i][c] dh[i][h], else
          const int K4 = w1b ? C4 : Co4;  // dw2[l][h][o] += mid[i][h] dy[i][o]
          const int q = (w1b ? j : j - nb1) / (kHC / 4), h4 = (w1b ? j : j - nb1) % (kHC / 4);
          const int k4 = q % K4, l = q / K4;
          const float* kr = w1b ? sx : sdy;
          const int ks = w1b ? xs : ys;
          const float* hr = w1b ? sdh : smid;
          float acc[4][4];
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;
          for (int i = l * l; i < (l + 1) * (l + 1); ++i) {
            float4 kv[4], hv[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              kv[r] = *reinterpret_cast<const float4*>(kr + i * ks + (k4 + K4 * r) * kTN);
              hv[r] = *reinterpret_cast<const float4*>(hr + i * kOS + (h4 + 8 * r) * kTN);
            }
#pragma unroll
            for (int u = 0; u < 4; ++u)
#pragma unroll
              for (int v = 0; v < 4; ++v)
                acc[u][v] = fmaf(kv[u].w, hv[v].w,
                                 fmaf(kv[u].z, hv[v].z,
                                      fmaf(kv[u].y, hv[v].y, fmaf(kv[u].x, hv[v].x, acc[u][v]))));
          }
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              const int k = k4 + K4 * u, h = h4 + 8 * v;
              swsum[w1b ? (l * C + k) * kHC + h : e2 + (l * kHC + h) * Co + k] += acc[u][v];
            }
          continue;
        }
        const int e = e3 + j - nb12;
        float v = 0.f;
        if (e < e4) {  // dwg[c][h] += x[0][c] dg0[h]
          const int t = e - e3, h = t % kHC, c = t / kHC;
          const float4 a = *reinterpret_cast<const float4*>(sx + c * kTN);
          const float4 b = *reinterpret_cast<const float4*>(sdg + h * kTN);
          v = a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
        } else if (e < e5) {  // db1 (row 0 of dh, unrounded), dbg
          const int t = e - e4, h = t % kHC;
          const float4 b = *reinterpret_cast<const float4*>((t < kHC ? sdb1 : sdg) + h * kTN);
          v = b.x + b.y + b.z + b.w;
        } else if (h0 == 0) {  // db2 (row 0 of dy)
          const float4 b = *reinterpret_cast<const float4*>(sdy + (e - e5) * kTN);
          v = b.x + b.y + b.z + b.w;
        }
        swsum[e] += v;
      }

      // dx += dh @ w1^T, and on row 0 dg0 @ wg^T
      if (dx_job) {
        const int l = degree_of(dx_i);
        const float* dr = sdh + dx_i * kOS;
        const float* wr = sw1 + (l * C + 4 * dx_c4) * kHC;
        // the hidden channels in an order rotated by channel group and degree,
        // so that a warp's reads of sw1 fall in distinct banks
        const int rot = 4 * dx_c4 + l;
        for (int k = 0; k < kHC; ++k) {
          const int h = (k + rot) % kHC;
          const float4 dv = *reinterpret_cast<const float4*>(dr + h * kTN);
          const float4 wv = make_float4(wr[h], wr[kHC + h], wr[2 * kHC + h], wr[3 * kHC + h]);
          fma4(acc[0], dv.x, wv);
          fma4(acc[1], dv.y, wv);
          fma4(acc[2], dv.z, wv);
          fma4(acc[3], dv.w, wv);
        }
        if (dx_i == 0) {
          for (int h = 0; h < kHC; ++h) {
            const float4 gv = *reinterpret_cast<const float4*>(sdg + h * kTN);
            const float* wc = swg + 4 * dx_c4 * kHC + h;
            const float4 wv = make_float4(wc[0], wc[kHC], wc[2 * kHC], wc[3 * kHC]);
            fma4(acc[0], gv.x, wv);
            fma4(acc[1], gv.y, wv);
            fma4(acc[2], gv.z, wv);
            fma4(acc[3], gv.w, wv);
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (n0 + q < d.N) {
            if (h0 + kHC >= H)  // the last chunk
              reinterpret_cast<uint2*>(dx)[((long long)n0 + q) * I * C4 + tid] = pack4(acc[q]);
            else
              dx4[q * I * C4] = acc[q];
          }
      }
    }
    __syncthreads();  // the chunk's sums are complete

    // the chunk's sums into the block's row
    for (int e = tid; e < E; e += kThreads) {
      long long at = -1;
      if (e < e2) {
        const int h = e % kHC, c = (e / kHC) % C, l = e / (kHC * C);
        if (h0 + h < H) at = gl.w1 + ((long long)l * C + c) * H + h0 + h;
      } else if (e < e3) {
        const int t = e - e2, o = t % Co, h = (t / Co) % kHC, l = t / (Co * kHC);
        if (h0 + h < H) at = gl.w2 + ((long long)l * H + h0 + h) * Co + o;
      } else if (e < e4) {
        const int t = e - e3, h = t % kHC, c = t / kHC;
        if (h0 + h < H) at = gl.wg + (long long)c * H + h0 + h;
      } else if (e < e5) {
        const int t = e - e4, h = t % kHC;
        if (h0 + h < H) at = (t < kHC ? gl.b1 : gl.bg) + h0 + h;
      } else if (h0 == 0) {
        at = gl.b2 + (e - e5);
      }
      if (at >= 0) row[at] = swsum[e];
    }
  }
}

using Kernel = void (*)(const bf16*, const bf16*, const float*, const float*, const float*,
                        const float*, const float*, const bf16*, const bf16*, bf16*, float*,
                        float*, Dims);

inline Kernel kernel_for(const Dims& d) {
  return d.I == 49 ? ffn_bwd_bf16_kernel<49> : ffn_bwd_bf16_kernel<0>;
}

}  // namespace bf

// bf16: the bfloat16 instance's widths, lmax 1..6 and C, Co <= 16 (those
// of K4's bfloat16 instance; no other width trains at bfloat16)
bool dims_ok(int N, int lmax, int C, int H, int Co, int G, int bf16) {
  if (N < 1 || lmax < 1 || C < 4 || C % 4 != 0 || H < 1 || Co < 4 || Co % 4 != 0 || G < 1)
    return false;
  if (bf16 && (lmax > 6 || C > 16 || Co > 16)) return false;
  const int I = (lmax + 1) * (lmax + 1);
  return I <= singa::kMaxIp && I * (C / 4) <= kThreads;
}

// The kernel of these widths (bf16: the bfloat16 kernel), its shared memory,
// and its tiles: a launch's blocks are one an SM, never more than the tiles
struct Launch {
  const void* kernel;
  size_t smem;
  long long tiles;
};

Launch launch_of(int N, int lmax, int C, int H, int Co, int G, int bf16) {
  if (bf16) {
    const bf::Dims d = bf::make_dims(N, lmax, C, H, Co, G);
    return {(const void*)bf::kernel_for(d), bf::smem_bytes(d), (N + bf::kTN - 1) / bf::kTN};
  }
  const Dims d = make_dims(N, lmax, C, H, Co, G);
  return {(const void*)ffn_bwd_kernel, smem_floats(d) * sizeof(float), (N + kTN - 1) / kTN};
}

int blocks_of(const Launch& k) {
  if (singa::allow_smem(k.kernel, k.smem) != cudaSuccess) return -1;
  return singa::persistent_grid(k.kernel, kThreads, k.smem, k.tiles);
}

}  // namespace

// Blocks the kernel runs (one per SM at its shared memory, never more than
// the node tiles; bf16: its bfloat16 kernel); the caller allocates the
// [blocks, P] scratch buffer from this. Returns -1 for shapes the kernel
// does not take: C or Co not a multiple of 4, lmax above 7, tiles that
// exceed shared memory, and at bfloat16 lmax 7 or C, Co above 16.
extern "C" int so3_ffn_bwd_blocks(int N, int lmax, int C, int H, int Co, int G, int bf16) {
  if (!dims_ok(N, lmax, C, H, Co, G, bf16)) return -1;
  return blocks_of(launch_of(N, lmax, C, H, Co, G, bf16));
}

// Resident blocks per SM of the kernel at these widths (bf16: its bfloat16
// kernel; -1: a shape it does not take), its shared memory per block in
// *smem_bytes and its threads per block in *threads. For reports; launches
// nothing.
extern "C" int so3_ffn_bwd_residency(int lmax, int C, int H, int Co, int G, int bf16,
                                     int* smem_bytes, int* threads) {
  if (!dims_ok(1, lmax, C, H, Co, G, bf16)) return -1;
  const Launch k = launch_of(1, lmax, C, H, Co, G, bf16);
  *smem_bytes = (int)k.smem;
  *threads = kThreads;
  if (singa::allow_smem(k.kernel, k.smem) != cudaSuccess) return -1;
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k.kernel, kThreads, k.smem) !=
      cudaSuccess)
    return -1;
  return per_sm;
}

// K4b: x, dy, tg, fg and dx bfloat16 when bf16 != 0 (dxf: N * I * C floats
// of scratch for dx's sums), else float32 (dxf unread); the weights and
// the seven gradients float32.
extern "C" int so3_ffn_bwd(const void* x, const void* dy, const float* w1, const float* b1,
                           const float* wg, const float* bg, const float* w2, const void* tg,
                           const void* fg, void* dx, float* dxf, float* partial, float* grads,
                           int N, int lmax, int C, int H, int Co, int G, int blocks, int bf16,
                           void* stream) {
  if (!dims_ok(N, lmax, C, H, Co, G, bf16) || blocks < 1) return (int)cudaErrorInvalidValue;
  const Dims d = make_dims(N, lmax, C, H, Co, G);
  const Launch k = launch_of(N, lmax, C, H, Co, G, bf16);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = singa::allow_smem(k.kernel, k.smem);
  if (err != cudaSuccess) return (int)err;
  const long long P = grad_layout(d).total;
  err = cudaMemsetAsync(partial, 0, (size_t)blocks * P * sizeof(float), st);
  if (err != cudaSuccess) return (int)err;
  using B = singa::bf16;
  if (bf16) {
    const bf::Dims bd = bf::make_dims(N, lmax, C, H, Co, G);
    const bf::Kernel kernel = bf::kernel_for(bd);
    kernel<<<blocks, kThreads, k.smem, st>>>((const B*)x, (const B*)dy, w1, b1, wg, bg, w2,
                                             (const B*)tg, (const B*)fg, (B*)dx, dxf, partial, bd);
  } else {
    ffn_bwd_kernel<<<blocks, kThreads, k.smem, st>>>((const float*)x, (const float*)dy, w1, b1,
                                                     wg, bg, w2, (const float*)tg,
                                                     (const float*)fg, (float*)dx, partial, d);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int grid = singa::persistent_grid(singa::sum_rows_kernel, 256, 0, (P + 255) / 256);
  singa::sum_rows_kernel<<<grid, 256, 0, st>>>(partial, grads, P, blocks);
  return (int)cudaGetLastError();
}
