// spec_ds_fold: channel cross-spectra, inverse real DFT, DS finalize, pad
// mask, 128-sample block maxima and uniform histogram of the overlap-save
// scan.
//
// Replaces detex_tpu/ops/pallas_kernels.py spec_ds_fold (:1038, kernel body
// :782-981). Row r is (chunk b, template s) in mode "net" (r = b*S + s) and
// (s, b) in mode "sub" (r = s*B + b). For each basis dim d of a row and each
// block i, Y[k] = sum_c U[d,s,c,k] * F[b,c,i,k] over bins 0..blk/2 (the
// template spectra carry the inverse weights c_k/blk, ops/ds.py
// bank_spec_pair) is inverted to x[0, blk); x[head : head+W] gives
// y = x - sum_u*a, and ds = sum_d y^2 / power, -inf at positions >= nv, with
// the per-128-sample maxima and the floor-rule histogram, counted in shared
// memory and added to the row's global counts (integer atomics keep the
// counts exact and order-free).
//
// Bound on the card: every inverse transform reads nc complex U and F half
// spectra (2 * 2 * nc * Rp floats, ~400 KB at nc = 3), nearly all from L2:
// the same F block serves every dim and template of a (chunk, block), the
// same U every chunk. That L2 traffic, not device memory and not the FFT's
// arithmetic, is the nearest floor. Design:
//  - the transform is the register-resident inverse of fft_regs.cuh: the
//    cross-spectra of bins k and M-k feed its pack pre-pass in registers
//    (warp loads consecutive in both directions), three passes, and the
//    samples arrive in registers, where y^2 is formed;
//  - at blk 16384 a block of 512 threads runs TWO transforms side by side
//    (two groups of 256 threads, each with its own 64 KiB exchange buffer
//    and named barrier), chosen so that both read the same F block at the
//    same time and the second read hits L1: two dims d, d+1 of one row when
//    D > 1 (the block is one (row, block); each group leaves its y^2 in its
//    own exchange buffer, free once the samples are in registers, and the
//    whole block then adds both to one shared accumulator, group 0's first:
//    the sum's order is fixed and no group waits for the other's loads), or
//    two templates s, s+1 of one (chunk, block) when D = 1 (no accumulator:
//    each group finalizes its own row from its exchange buffer). At blk
//    32768 one group of 512 threads;
//  - nothing depends on scheduling and two launches give equal bits;
//  - with emit_ds = 0 (summary-only scan) the DS array is never written.
#pragma once

#include "fft_regs.cuh"

namespace detex {

template <int LOG2M>
struct SpecDs {
  static constexpr int T = RegsFft<LOG2M>::T;        // threads a transform
  static constexpr int NH = LOG2M == 13 ? 2 : 1;     // transforms side by side
  static constexpr int kThreads = NH * T;
};

// Half spectrum V = Y / c_k of one (template dim, block): Y = sum_c U_c F_c
// with c_0 = c_M = 1 (imaginary parts dropped), else 2. NC > 0 fixes the
// channel count at compile time (all loads of a bin pair are in flight together).
template <int NC>
struct CrossSpectra {
  const float* ur;      // U[d, s, 0, 0]
  const float* ui;
  const float* fr;      // F[b, 0, i, 0]
  const float* fi;
  int nc, Rp;
  long long frow;       // floats between the channels of F
  __device__ __forceinline__ float2 sum(int k) const {
    float yr = 0.f, yi = 0.f;
    const int n = NC > 0 ? NC : nc;
#pragma unroll
    for (int c = 0; c < n; ++c) {
      const float ar = __ldg(&ur[c * Rp + k]), ai = __ldg(&ui[c * Rp + k]);
      const float br = __ldg(&fr[c * frow + k]), bi = __ldg(&fi[c * frow + k]);
      yr += ar * br - ai * bi;
      yi += ar * bi + ai * br;
    }
    return make_float2(yr, yi);
  }
  __device__ __forceinline__ float2 operator()(int k) const {
    const float2 y = sum(k);
    return make_float2(0.5f * y.x, 0.5f * y.y);
  }
  __device__ __forceinline__ float edge(int k) const { return sum(k).x; }
};

// y^2 of the samples a thread holds after irfft_regs_row (x[q] = samples
// 2j, 2j + 1 at j = t + q T), for the kept positions 2j - head in [0, W)
// (head is even), stored to buf: the group's own exchange buffer, free
// once the transform has returned. arow2: the block's window means as
// pairs.
template <int LOG2M>
__device__ __forceinline__ void spec_ds_squares(
    const float2 (&x)[32], int t, int head, const float2* __restrict__ arow2,
    float sud, float* buf) {
  constexpr int T = RegsFft<LOG2M>::T;
  float2* buf2 = reinterpret_cast<float2*>(buf);
  // sixteen pairs of means in flight at a time: a load per sample would
  // wait out its latency 32 times over
#pragma unroll
  for (int q0 = 0; q0 < 32; q0 += 16) {
    float2 av[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int p2 = t + (q0 + k) * T - head / 2;
      av[k] = arow2[p2 < 0 ? 0 : p2];
    }
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int p2 = t + (q0 + k) * T - head / 2;
      if (p2 < 0) continue;
      const float y0 = x[q0 + k].x - sud * av[k].x;
      const float y1 = x[q0 + k].y - sud * av[k].y;
      buf2[p2] = make_float2(y0 * y0, y1 * y1);
    }
  }
}

// buf[0..W) holds the finished DS of row r's block i (divided, masked,
// counted in hs): the G threads gt = 0..G-1 write DS, the 128-sample
// maxima and the row's counts. Every thread's writes to buf and hs must be
// behind a barrier.
__device__ __forceinline__ void spec_ds_emit(
    const float* buf, const int* hs, int gt, int G, long long r, int i,
    float* __restrict__ ds, float* __restrict__ pyr, int* __restrict__ hist,
    int m, int W, int nbin) {
  if (ds) {
    float* drow = ds + r * m * (long long)W + (long long)i * W;
#pragma unroll 4
    for (int p = gt; p < W; p += G) drow[p] = buf[p];
  }
  const int nb = W / 128;
  const int lane = gt & 31;
  for (int g = gt >> 5; g < nb; g += G / 32) {
    const float* v = buf + g * 128;
    float mx = fmaxf(fmaxf(v[lane], v[lane + 32]),
                     fmaxf(v[lane + 64], v[lane + 96]));
    for (int o = 16; o > 0; o >>= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    }
    if (lane == 0) pyr[r * m * (long long)nb + (long long)i * nb + g] = mx;
  }
  for (int k = gt; k < nbin; k += G) {
    if (hs[k]) atomicAdd(&hist[r * nbin + k], hs[k]);
  }
}

// After the last dim: buf[0..W) holds sum_d y^2 of row r's block i. The G
// threads gt = 0..G-1 behind ``bar`` divide by the power, mask at nv, count
// the histogram in hs, then emit.
template <class Bar>
__device__ __forceinline__ void spec_ds_finalize(
    float* buf, int* hs, int gt, int G, Bar bar, long long r, int i,
    long long nvb, const float* __restrict__ prow, float* __restrict__ ds,
    float* __restrict__ pyr, int* __restrict__ hist, int m, int W,
    int nbin) {
  // eight powers in flight at a time (a load per sample would wait out its
  // latency W / G times over)
  BinRun bins(hs, nbin);
  for (int p0 = gt; p0 < W; p0 += 8 * G) {
    float pv[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int p = p0 + k * G;
      pv[k] = p < W ? prow[p] : 1.f;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int p = p0 + k * G;
      if (p >= W) break;
      float v = buf[p] / pv[k];
      if ((long long)i * W + p >= nvb) v = -INFINITY;
      buf[p] = v;
      if (nbin) bins.count(v);
    }
  }
  bins.flush();
  bar();
  spec_ds_emit(buf, hs, gt, G, r, i, ds, pyr, hist, m, W, nbin);
}

// The kernel's arguments (the C entry point's, in its order).
struct SpecDsArgs {
  const float *ur, *ui, *fr, *fi, *a, *pw, *su;
  const int* nv;
  const float2 *stage, *tw;
  float *ds, *pyr;
  int* hist;
  int B, S, D, nc, m, W, head, Rp, nbin, sub;
};

// Block and thread indices read anew. The compiler cannot merge two such
// reads, so what is derived from one before a transform (row, block,
// pointers) is not kept in registers across it for the code after it, which
// derives its own: the transform needs every register it can get.
__device__ __forceinline__ unsigned fresh_block_index() {
#ifdef DETEX_HOST_EMULATION
  return blockIdx.x;
#else
  unsigned v;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(v));
  return v;
#endif
}
__device__ __forceinline__ unsigned fresh_thread_index() {
#ifdef DETEX_HOST_EMULATION
  return threadIdx.x;
#else
  unsigned v;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(v));
  return v;
#endif
}

// Where a thread works: group ``half`` of its block, thread t of the group,
// chunk b, template s, block i, output row r.
template <int LOG2M>
struct SpecDsPlace {
  int half, t, i;
  long long b, s, r;
  __device__ __forceinline__ SpecDsPlace(const SpecDsArgs& p, unsigned bid,
                                         unsigned tid) {
    using K = SpecDs<LOG2M>;
    half = K::NH > 1 ? tid / K::T : 0;
    t = tid - half * K::T;
    const unsigned um = p.m, uB = p.B, uS = p.S;     // 32-bit divisions
    const unsigned g = bid / um;
    i = bid - g * um;
    if (K::NH > 1 && p.D == 1) {          // the groups take templates
      const unsigned SP = (uS + K::NH - 1) / K::NH;
      b = g / SP;
      s = (g % SP) * K::NH + half;
    } else {
      b = p.sub ? g % uB : g / uS;
      s = p.sub ? g / uB : g % uS;
    }
    r = p.sub ? s * p.B + b : b * p.S + s;
  }
  // offset of the block's window stats in a / power
  __device__ __forceinline__ long long stats(const SpecDsArgs& p) const {
    return b * p.m * (long long)p.W + (long long)i * p.W;
  }
};

// Dim d of the thread's template against its block, inverted into x.
template <int LOG2M, int NC>
__device__ __forceinline__ void spec_ds_transform(const SpecDsArgs& p, int d,
                                                  float2* zbase,
                                                  float2 (&x)[32]) {
  const SpecDsPlace<LOG2M> w(p, blockIdx.x, threadIdx.x);
  const long long frow = (long long)p.m * p.Rp;
  const long long fo = w.b * p.nc * frow + (long long)w.i * p.Rp;
  const long long uo = ((long long)d * p.S + w.s) * p.nc * p.Rp;
  const CrossSpectra<NC> src{p.ur + uo, p.ui + uo, p.fr + fo, p.fi + fo,
                             p.nc, p.Rp, frow};
  irfft_regs_row<LOG2M>(w.t, src, p.tw, p.stage,
                        zbase + (size_t)w.half * (1 << LOG2M),
                        GroupBarrier{1 + w.half, SpecDs<LOG2M>::T}, x);
}

// Grid: B * S * m blocks, one per (row, block i); B * ceil(S / NH) * m when
// the groups take templates (NH > 1 and D == 1), one per (chunk, template
// pair, block i). Dynamic shared memory: NH exchange buffers of M float2,
// W floats of accumulator unless the groups take templates, NH * nbin
// counts.
template <int LOG2M, int NC>
__global__ void __launch_bounds__(SpecDs<LOG2M>::kThreads, 1)
spec_ds_fold_kernel(const SpecDsArgs p) {
  using K = SpecDs<LOG2M>;
  constexpr int M = 1 << LOG2M, T = K::T, NH = K::NH;
  extern __shared__ __align__(16) unsigned char smem[];
  float2* zbase = reinterpret_cast<float2*>(smem);
  float* acc = reinterpret_cast<float*>(smem + (size_t)NH * M * sizeof(float2));
  // x of one dim of template s, block i, in registers: samples 2j, 2j + 1
  // at j = t + q T
  float2 x[32];

  if (NH > 1 && p.D == 1) {               // the groups take templates
    {
      const SpecDsPlace<LOG2M> w(p, blockIdx.x, threadIdx.x);
      if (w.s >= p.S) return;
      int* hsh = reinterpret_cast<int*>(acc) + w.half * p.nbin;
      for (int k = w.t; k < p.nbin; k += T) hsh[k] = 0;
    }
    spec_ds_transform<LOG2M, NC>(p, 0, zbase, x);
    const SpecDsPlace<LOG2M> w(p, fresh_block_index(), fresh_thread_index());
    const GroupBarrier bar{1 + w.half, T};
    float* buf = reinterpret_cast<float*>(zbase + (size_t)w.half * M);
    spec_ds_squares<LOG2M>(
        x, w.t, p.head, reinterpret_cast<const float2*>(p.a + w.stats(p)),
        p.su[w.s], buf);
    bar();
    spec_ds_finalize(buf, reinterpret_cast<int*>(acc) + w.half * p.nbin, w.t,
                     T, bar, w.r, w.i, p.nv[w.b], p.pw + w.stats(p), p.ds,
                     p.pyr, p.hist, p.m, p.W, p.nbin);
    return;
  }

  // The groups take dims d0, d0 + 1 of one row. Each leaves its y^2 in its
  // own exchange buffer; then the whole block adds them to the accumulator,
  // group 0's before group 1's: the order of the sum is fixed, and no group
  // waits for the other's loads.
  int* hs = reinterpret_cast<int*>(acc + p.W);
  for (int k = threadIdx.x; k < p.nbin; k += K::kThreads) hs[k] = 0;
  for (int d0 = 0; d0 < p.D; d0 += NH) {
    const int mine = d0 + (NH > 1 ? (int)threadIdx.x / T : 0);
    if (mine < p.D) spec_ds_transform<LOG2M, NC>(p, mine, zbase, x);
    {
      const SpecDsPlace<LOG2M> w(p, fresh_block_index(), fresh_thread_index());
      const int d = d0 + w.half;
      if (d < p.D) {
        spec_ds_squares<LOG2M>(
            x, w.t, p.head,
            reinterpret_cast<const float2*>(p.a + w.stats(p)),
            p.su[(long long)d * p.S + w.s],
            reinterpret_cast<float*>(zbase + (size_t)w.half * M));
      }
    }
    __syncthreads();
    const float4* y0 = reinterpret_cast<const float4*>(zbase);
    const float4* y1 = reinterpret_cast<const float4*>(zbase + M);
    float4* acc4 = reinterpret_cast<float4*>(acc);
    const bool both = NH > 1 && d0 + 1 < p.D;
    for (int q = threadIdx.x; q < p.W / 4; q += K::kThreads) {
      float4 v = y0[q];
      if (d0) {
        const float4 c = acc4[q];
        v = make_float4(c.x + v.x, c.y + v.y, c.z + v.z, c.w + v.w);
      }
      if (both) {
        const float4 u = y1[q];
        v = make_float4(v.x + u.x, v.y + u.y, v.z + u.z, v.w + u.w);
      }
      acc4[q] = v;
    }
    __syncthreads();
  }
  const SpecDsPlace<LOG2M> w(p, fresh_block_index(), fresh_thread_index());
  spec_ds_finalize(acc, hs, w.half * T + w.t, K::kThreads, BlockBarrier{},
                   w.r, w.i, p.nv[w.b], p.pw + w.stats(p), p.ds, p.pyr,
                   p.hist, p.m, p.W, p.nbin);
}

}  // namespace detex
