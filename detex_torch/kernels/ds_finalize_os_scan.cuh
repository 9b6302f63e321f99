// ds_finalize_os_scan: DS finalize of one chunk's raw overlap-save inverse
// blocks with the pad mask, 128-sample block maxima and the optional
// uniform histogram summed over the chunk's m blocks; and the body it
// shares with ds_finalize_os (ds_finalize_os.cuh), the same finalize
// without mask, maxima or histogram.
//
// Replaces detex_tpu/ops/pallas_kernels.py ds_finalize_os_scan (:438,
// kernel body :388-434), the per-chunk route's finalize. Row r of the S DS
// rows has D basis rows r*D + d of cb [S*D, m, blk]; position p = i*W + t
// of block i reads
//
//   ds[r, p] = sum_d (cb[r*D + d, i, head + t] - su[r*D + d] * a[p])^2
//              / power[p]      (power 0 -> inf, so the quotient is 0)
//
// with the one stats row a, power [m*W] every row shares (padded past the
// valid length by the caller), -inf where p >= nv[0] (read on the device:
// the per-chunk loop passes it without a host sync), the maximum of every
// 128-sample group in pyr [S, m*W/128] and, for nbin > 0, floor-rule
// counts added to hist [S, nbin] (zeroed by the caller): bin
// floor(v * nbin) in float32, v == 1.0 in the last bin, values outside
// [0, 1] and -inf dropped.
//
// Bound on the card: device-memory traffic (read D*W floats of cb, write W
// DS values a block; the stats rows stay in L2; ~3D + 2 flops a sample).
// One thread block per (row, OS block). What the design does about what
// held the older body (finalize_os.cuh, now B3's alone) back at the
// per-chunk route's shapes, where loads that waited on each other left the
// card at a third of its memory rate:
//  - a warp takes one 128-sample group a step, each lane four consecutive
//    samples, so every load and store is 16 bytes a lane and the group's
//    maximum is one warp reduction; the step's loads (cb of every dim, a,
//    power) are all issued before the first use, D is a compile-time
//    constant for D = 1..4, and su is read once per block;
//  - noise puts nearly every sample into bin 0: a thread counts runs of
//    equal bins in a register (BinRun, fft.cuh) and adds a run to the
//    block's shared counts only when its bin changes; the block adds its
//    counts to the row's global ones once (integer atomics: exact and
//    order-free).
// Measured on an H100 against variants (PERF.md, B7's and B8's findings):
// two groups' loads a step, a grid of whole waves over equal ranges of
// groups, and a fast division each gained nothing; streaming stores of DS
// gained 6-9% in B8 at one D1 chunk (B7 keeps plain stores: its code is
// what was measured).
#pragma once

#include "fft.cuh"

namespace detex {

constexpr int kOsFinThreads = 256;

// The kernels' arguments (ds_finalize_os_scan's C entry point's, in its
// order; ds_finalize_os passes nv, pyr and hist null and nbin 0).
struct OsFinArgs {
  const float *cb, *a, *pw, *su;
  const int* nv;
  float *ds, *pyr;
  int* hist;
  long long S;
  int D, m, blk, W, head, nbin;
};

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void add_sq(float4& acc, float4 c, float s,
                                       float4 a) {
  const float y0 = c.x - s * a.x, y1 = c.y - s * a.y;
  const float y2 = c.z - s * a.z, y3 = c.w - s * a.w;
  acc.x += y0 * y0;
  acc.y += y1 * y1;
  acc.z += y2 * y2;
  acc.w += y3 * y3;
}

// DS of one sample: IEEE division, power 0 -> inf
__device__ __forceinline__ float os_quotient(float acc, float p) {
  return acc / (p == 0.f ? INFINITY : p);
}

// ... and -inf at pos >= nv
__device__ __forceinline__ float os_value(float acc, float p, long long pos,
                                          long long nv) {
  const float v = os_quotient(acc, p);
  return pos >= nv ? -INFINITY : v;
}

// The body of both kernels. Grid: S * m blocks, block r m + i taking OS
// block i of DS row r. DC: D at compile time (1..4), or 0 for any D, whose
// basis rows are then loaded four at a time. SCAN: the mask, maxima and
// histogram (dynamic shared memory: nbin counts); without it nv, pyr, hist
// and nbin are not read, and the block uses no shared memory and no
// barrier.
template <int DC, bool SCAN>
__device__ __forceinline__ void os_finalize_block(const OsFinArgs& p) {
  constexpr int DL = DC > 0 ? DC : 4;                  // dims loaded together
  constexpr int NWARP = kOsFinThreads / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  int* hs = reinterpret_cast<int*>(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int D = DC > 0 ? DC : p.D;
  const long long r = blockIdx.x / p.m;
  const int i = blockIdx.x - (int)(r * p.m);
  const int nb = p.W / 128;
  const long long nv = SCAN ? p.nv[0] : 0;
  const long long dstride = (long long)p.m * p.blk;    // basis row d -> d + 1
  if constexpr (SCAN) {
    for (int k = tid; k < p.nbin; k += kOsFinThreads) hs[k] = 0;
  }
  const float* sur = p.su + r * D;
  float sv[DL];
#pragma unroll
  for (int d = 0; d < DL; ++d) sv[d] = DC > 0 ? sur[d] : 0.f;
  const long long o = (long long)i * p.W + lane * 4;   // position in the row
  const float* cbr = p.cb + (r * D * p.m + i) * p.blk + p.head + lane * 4;
  float* dsr = p.ds + r * p.m * (long long)p.W + o;
  float* pyr = SCAN ? p.pyr + (r * p.m + i) * nb : nullptr;
  BinRun bins(hs, p.nbin);                             // used with SCAN only
  if constexpr (SCAN) __syncthreads();
  for (int g = warp; g < nb; g += NWARP) {
    const float4 av = ldg4(p.a + o + g * 128);
    const float4 pv = ldg4(p.pw + o + g * 128);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int d0 = 0; d0 < D; d0 += DL) {
      float4 c[DL];
#pragma unroll
      for (int dd = 0; dd < DL; ++dd) {
        if (DC > 0 || d0 + dd < D) {
          c[dd] = ldg4(cbr + (d0 + dd) * dstride + g * 128);
        }
      }
#pragma unroll
      for (int dd = 0; dd < DL; ++dd) {
        if (DC > 0 || d0 + dd < D) {
          add_sq(acc, c[dd], DC > 0 ? sv[dd] : sur[d0 + dd], av);
        }
      }
    }
    float4 v;
    if constexpr (!SCAN) {
      v.x = os_quotient(acc.x, pv.x);
      v.y = os_quotient(acc.y, pv.y);
      v.z = os_quotient(acc.z, pv.z);
      v.w = os_quotient(acc.w, pv.w);
      // streaming store: DS outgrows L2 before it is read again
      __stcs(reinterpret_cast<float4*>(dsr + g * 128), v);
    } else {
      const long long pos = o + g * 128;
      v.x = os_value(acc.x, pv.x, pos, nv);
      v.y = os_value(acc.y, pv.y, pos + 1, nv);
      v.z = os_value(acc.z, pv.z, pos + 2, nv);
      v.w = os_value(acc.w, pv.w, pos + 3, nv);
      *reinterpret_cast<float4*>(dsr + g * 128) = v;
      float mx = fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w));
      for (int s = 16; s > 0; s >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, s));
      }
      if (lane == 0) pyr[g] = mx;
      if (p.nbin) {
        bins.count(v.x);
        bins.count(v.y);
        bins.count(v.z);
        bins.count(v.w);
      }
    }
  }
  if constexpr (SCAN) {
    bins.flush();
    __syncthreads();
    for (int k = tid; k < p.nbin; k += kOsFinThreads) {
      if (hs[k]) atomicAdd(&p.hist[r * p.nbin + k], hs[k]);
    }
  }
}

template <int DC>
__global__ void __launch_bounds__(kOsFinThreads)
ds_finalize_os_scan_kernel(const OsFinArgs p) {
  os_finalize_block<DC, true>(p);
}

}  // namespace detex
