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
// per-degree products of 2*N*I*C*H operations (h and dmid recomputed, dx, dw1,
// dw2: ~57 GFLOP) and the gate products (~4 GFLOP) against ~140 MB of x, dy
// in and dx out, so float32 arithmetic bounds it (~0.92 ms at 67 TFLOP/s;
// memory ~41 us).
//
// Design: the [N, I, H] hidden and its cotangent (1.44 GB each here) never
// reach device memory; they are recomputed tile by tile in shared memory, as
// the TPU kernel recomputes them in VMEM. The TPU kernel added the weight
// gradients of every node tile into one resident output along its sequential
// grid; Hopper's blocks run in no order, so the work is split in two:
//   * the dx kernel: one block per tile of kTN nodes walks the hidden
//     dimension in chunks of kHC channels, as the forward does, and keeps dx
//     in registers across the chunks. dgate of a chunk is complete within it
//     (the gate columns of a chunk see only that chunk's hidden channels), so
//     the gate path's row-0 term is added chunk by chunk. No sum crosses a
//     block.
//   * the weight kernel: one block per (hidden chunk, slice of the node tiles)
//     stages its chunk's weights once, walks its slice's tiles recomputing the
//     chunk's hidden, and keeps the chunk's weight-gradient sums in shared
//     memory, each sum owned by one thread. It writes them to its slice's row
//     of a [slices, P] scratch buffer; a last kernel adds the rows in slice
//     order. Every sum runs in a fixed order: the result is deterministic,
//     with no atomics.
// Nodes past N in the last tile are staged as zero rows of x and dy, which
// makes every term they add to a gradient exactly zero.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;   // 16 warps: one block per SM (shared memory) hides latency
constexpr int kNG = 2;          // groups of four nodes per tile
constexpr int kTN = 4 * kNG;    // nodes per tile
constexpr int kHC = 16;         // hidden channels per chunk
constexpr int kPad = 8;         // floats added to each row block
constexpr int kMaxJobs = 1;     // dx micro-tiles per thread

using singa::degree_of;
using singa::fma4;

struct Dims {
  int N, lmax, L, I, C, H, Co;
};

__host__ __device__ inline Dims make_dims(int N, int lmax, int C, int H, int Co) {
  return Dims{N, lmax, lmax + 1, (lmax + 1) * (lmax + 1), C, H, Co};
}

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
__device__ void stage_tile(const float* __restrict__ x, const float* __restrict__ dy, int n0,
                           const Dims& d, const Smem& s) {
  for (int t = threadIdx.x; t < kTN * d.I * d.C; t += kThreads) {
    const int n = t / (d.I * d.C), i = (t / d.C) % d.I, c = t % d.C;
    s.sx[i * s.xs + c * kTN + n] = (n0 + n < d.N) ? x[(long long)n0 * d.I * d.C + t] : 0.f;
  }
  for (int t = threadIdx.x; t < kTN * d.I * d.Co; t += kThreads) {
    const int n = t / (d.I * d.Co), i = (t / d.Co) % d.I, o = t % d.Co;
    s.sdy[i * s.ys + o * kTN + n] = (n0 + n < d.N) ? dy[(long long)n0 * d.I * d.Co + t] : 0.f;
  }
}

// The chunk's slices of w1, wg and w2 (zero past H).
__device__ void stage_weights(const float* __restrict__ w1, const float* __restrict__ wg,
                              const float* __restrict__ w2, int h0, const Dims& d,
                              const Smem& s) {
  for (int t = threadIdx.x; t < d.L * d.C * kHC; t += kThreads) {
    const int h = t % kHC, lc = t / kHC;
    s.sw1[t] = (h0 + h < d.H) ? w1[(long long)lc * d.H + h0 + h] : 0.f;
  }
  for (int t = threadIdx.x; t < d.C * d.lmax * kHC; t += kThreads) {
    const int h = t % kHC, l = (t / kHC) % d.lmax, c = t / (kHC * d.lmax);
    s.swg[t] = (h0 + h < d.H) ? wg[(long long)c * d.lmax * d.H + l * d.H + h0 + h] : 0.f;
  }
  for (int t = threadIdx.x; t < d.L * d.Co * kHC; t += kThreads) {
    const int h = t % kHC, o = (t / kHC) % d.Co, l = t / (kHC * d.Co);
    s.sw2t[t] = (h0 + h < d.H) ? w2[((long long)l * d.H + h0 + h) * d.Co + o] : 0.f;
  }
}

// With the tile and the chunk's weights staged: the gates, h and dmid, then
// dg0, then dh (in sdm) and, if want_mid, mid (in sh). Ends synchronised.
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
    s.sdg[t] = g * (1.f - g) * dg;
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
      mid = singa::siluf_(hb);
    } else {
      const float g = s.sgate[((degree_of(i) - 1) * kHC + h) * kTN + n];
      dh = dm * g;
      mid = hv * g;
    }
    s.sdm[off] = dh;
    if (want_mid) s.sh[off] = mid;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
gate_ffn_bwd_dx_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                       const float* __restrict__ w1, const float* __restrict__ b1,
                       const float* __restrict__ wg, const float* __restrict__ bg,
                       const float* __restrict__ w2, float* __restrict__ dx, int N, int lmax,
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
    stage_weights(w1, wg, w2, h0, d, s);
    for (int t = tid; t < d.L * kHC * C; t += kThreads) {
      const int c = t % C, h = (t / C) % kHC, l = t / (C * kHC);
      sw1t[t] = (h0 + h < H) ? w1[((long long)l * C + c) * H + h0 + h] : 0.f;
    }
    __syncthreads();
    chunk_backward(b1, bg, h0, d, s, false);

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
          fma4(acc[k][0], dv.x, wv);
          fma4(acc[k][1], dv.y, wv);
          fma4(acc[k][2], dv.z, wv);
          fma4(acc[k][3], dv.w, wv);
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
        if (n < N) *reinterpret_cast<float4*>(dx + ((long long)n * d.I + i) * C + 4 * c4) = acc[k][q];
      }
    }
  }
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

__host__ __device__ inline int acc_floats(const Dims& d) {
  return d.L * d.C * kHC + d.L * kHC * d.Co + d.C * d.lmax * kHC + kHC + d.lmax * kHC + d.Co;
}

__global__ void __launch_bounds__(kThreads)
gate_ffn_bwd_w_kernel(const float* __restrict__ x, const float* __restrict__ dy,
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
  stage_weights(w1, wg, w2, h0, d, s);

  for (int tile = t_begin; tile < t_end; ++tile) {
    __syncthreads();  // the previous tile's readers are done
    stage_tile(x, dy, tile * kTN, d, s);
    __syncthreads();
    chunk_backward(b1, bg, h0, d, s, true);

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
          v = fmaf(a.x, b.x, v);
          v = fmaf(a.y, b.y, v);
          v = fmaf(a.z, b.z, v);
          v = fmaf(a.w, b.w, v);
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

bool dims_ok(int N, int lmax, int C, int H, int Co) {
  if (N < 1 || lmax < 1 || C < 4 || C % 4 != 0 || H < 1 || Co < 1) return false;
  const int I = (lmax + 1) * (lmax + 1);
  return kNG * I * (C / 4) <= kMaxJobs * kThreads;
}

}  // namespace

// Slices of node tiles the weight kernel splits N into: as many blocks as
// fit on the card at once, at least one per hidden chunk. The caller
// allocates the [slices, P] scratch buffer from this. Returns -1 for shapes
// the kernels do not take or whose tiles exceed shared memory.
extern "C" int so3_gate_ffn_bwd_slices(int N, int lmax, int C, int H, int Co) {
  if (!dims_ok(N, lmax, C, H, Co)) return -1;
  const Dims d = make_dims(N, lmax, C, H, Co);
  const size_t smem = w_smem(d);
  if (singa::allow_smem(gate_ffn_bwd_dx_kernel, dx_smem(d)) != cudaSuccess) return -1;
  if (singa::allow_smem(gate_ffn_bwd_w_kernel, smem) != cudaSuccess) return -1;
  const int chunks = (H + kHC - 1) / kHC;
  const int tiles = (N + kTN - 1) / kTN;
  const int resident = singa::persistent_grid(gate_ffn_bwd_w_kernel, kThreads, smem, 1LL << 30);
  int slices = resident / chunks;
  if (slices < 1) slices = 1;
  if (slices > tiles) slices = tiles;
  return slices;
}

extern "C" int so3_gate_ffn_bwd_f32(const float* x, const float* dy, const float* w1,
                                    const float* b1, const float* wg, const float* bg,
                                    const float* w2, float* dx, float* partial, float* grads,
                                    int N, int lmax, int C, int H, int Co, int slices,
                                    void* stream) {
  if (!dims_ok(N, lmax, C, H, Co) || slices < 1) return (int)cudaErrorInvalidValue;
  const Dims d = make_dims(N, lmax, C, H, Co);
  cudaStream_t st = (cudaStream_t)stream;
  const size_t sa = dx_smem(d), sb = w_smem(d);
  cudaError_t err = singa::allow_smem(gate_ffn_bwd_dx_kernel, sa);
  if (err != cudaSuccess) return (int)err;
  err = singa::allow_smem(gate_ffn_bwd_w_kernel, sb);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (N + kTN - 1) / kTN;
  const int chunks = (H + kHC - 1) / kHC;
  gate_ffn_bwd_dx_kernel<<<tiles, kThreads, sa, st>>>(x, dy, w1, b1, wg, bg, w2, dx, N, lmax, C,
                                                      H, Co);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gate_ffn_bwd_w_kernel<<<chunks * slices, kThreads, sb, st>>>(x, dy, w1, b1, wg, bg, w2, partial,
                                                               N, lmax, C, H, Co, slices);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long P = grad_layout(d).total;
  const int grid = singa::persistent_grid(singa::sum_rows_kernel, 256, 0, (P + 255) / 256);
  singa::sum_rows_kernel<<<grid, 256, 0, st>>>(partial, grads, P, slices);
  return (int)cudaGetLastError();
}
