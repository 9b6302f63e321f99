// fwd_prep_fold: framing + forward real DFT + window statistics of the
// overlap-save scan, one thread block per (chunk, frame).
//
// Replaces detex_tpu/ops/pallas_kernels.py fwd_prep_fold (:1437, kernel body
// :1290-1408). Frame f of chunk b covers xq[b, c, f*W : f*W + blk] for every
// channel c; the block emits that frame's real DFT (bins 0..blk/2 in natural
// order, zeros up to Rp) and the window mean / n * sample variance of the
// multiplexed windows behind outputs f*W + t, t < W. Windows are
// frame-local: output t needs samples [t + pad0, t + pad0 + n_c) of every
// channel, inside [0, blk).
//
// Bound on the card: device-memory traffic (read xq once, write 2 * Rp
// floats per channel-frame and the stats once) and shared-memory bandwidth
// of the FFT passes. Design: the stats need only the channel sums
// sum_c x_c and sum_c x_c^2 per sample, accumulated in registers while
// each channel streams through shared memory. Each sum gets a two-level
// prefix (window_sum below), and every window sum is written once. A window
// whose samples are all equal (a zero-filled gap, a constant after the
// standardization) gets power 0 (inf, DS 0) by an exact integer count of
// sample-to-sample changes, as rolling.window_stats_rows does: the float
// sums would leave rounding in its variance. The same 64 KiB buffer then
// holds each channel's M = blk/2 point complex FFT (four Stockham passes,
// fft.cuh).
#pragma once

#include "fft.cuh"

namespace detex {

// Fixed-point grid of the run totals' prefix: exact int64 sums, 2^-24 units.
constexpr double kFixScale = 16777216.0;

// Two-level prefix of one per-sample sum v (E contiguous samples per
// thread): buf holds each run's float running sum loc[p] (padded one word
// per 32 against bank conflicts), offs[r] the exclusive prefix of the run
// totals T_r = loc[end of run r] on the fixed-point grid, summed exactly.
template <int E>
__device__ __forceinline__ void stage_prefix(const float (&v)[E], float* buf,
                                             long long* offs,
                                             long long* sh) {
  const int p0 = threadIdx.x * E;
  float run = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    run += v[e];
    buf[p0 + e + ((p0 + e) >> 5)] = run;
  }
  long long q = llrint((double)run * kFixScale);
  block_exclusive_scan(q, sh);
  offs[threadIdx.x] = q;
  __syncthreads();
}

// Sum of v over samples (pl, ph] from stage_prefix's two levels: with runs
// a and b holding pl and ph, (T_a - loc[pl]) + sum of the runs between +
// loc[ph]. Every term is exactly 0 over all-zero samples, so an all-zero
// window sums to 0 exactly (power 0 -> inf, as in the float64 twin);
// otherwise the error is the float rounding of two runs plus half a grid
// step per run spanned.
template <int E>
__device__ __forceinline__ double window_sum(const float* buf,
                                             const long long* offs, int pl,
                                             int ph) {
  const double lh = buf[ph + (ph >> 5)];
  const int rb = ph / E;
  if (pl < 0) return (double)offs[rb] * (1.0 / kFixScale) + lh;
  const int ra = pl / E;
  const double ll = buf[pl + (pl >> 5)];
  if (ra == rb) return lh - ll;
  const int ea = ra * E + E - 1;
  const double ta = buf[ea + (ea >> 5)];
  return (ta - ll) + (double)(offs[rb] - offs[ra + 1]) * (1.0 / kFixScale) +
         lh;
}

// Exact test that a window's multiplexed samples are all equal, from one
// int prefix count per sample p of a frame: e[p] = 1 where two channels
// differ at p or channel 0 changes from p - 1 to p. Window (pl, ph] is
// constant when no e falls in (pl + 1, ph] and the channels agree at pl + 1
// (that bit is kept in bit 30 of the sample's local count).
struct ChangeCount {
  static constexpr int kW = 1 << 30;
  const int* loc;             // each run's inclusive count | w << 30
  const long long* offs;      // exclusive prefix of the run totals
  int E;
  __device__ long long at(int p) const {  // inclusive count through p
    return offs[p / E] + (loc[p + (p >> 5)] & (kW - 1));
  }
  __device__ bool constant(int pl, int ph) const {
    const int q = pl + 1;
    return !(loc[q + (q >> 5)] & kW) && at(ph) == at(q);
  }
};

template <int LOG2M>
__global__ void __launch_bounds__(kThreads)
fwd_prep_fold_kernel(const float* __restrict__ xq,
                     const float2* __restrict__ tw,
                     float* __restrict__ fr, float* __restrict__ fi,
                     float* __restrict__ a, float* __restrict__ pw,
                     int nc, long long Lp, int m, int W, int D0, int pad0,
                     int n_c, long long out_len, int Rp) {
  constexpr int M = 1 << LOG2M;
  constexpr int N = 2 * M;            // block length blk
  constexpr int E = N / kThreads;     // contiguous samples per thread
  static_assert(E <= 32, "one change bit per sample of a thread");
  extern __shared__ __align__(16) unsigned char smem[];
  float* buf = reinterpret_cast<float*>(smem);     // N + N/32 floats
  float2* z = reinterpret_cast<float2*>(smem);     // M complex values
  long long* sh = reinterpret_cast<long long*>(
      smem + (size_t)(N + N / 32) * sizeof(float));  // 32 scan partials
  long long* offs = sh + 32;                         // kThreads run offsets
  const int tid = threadIdx.x;
  const long long b = blockIdx.x / m;
  const int f = blockIdx.x % m;
  const int p0 = tid * E;

  // ---- window stats from the channel sums of x and x^2 ----
  // wbits bit k: channels c - 1 and c differ at sample tid + k * kThreads
  // (seen while loading); xbits bit e: channel 0 changes at p0 + e
  float xs[E], x2[E];
  unsigned wbits = 0u, xbits = 0u;
#pragma unroll
  for (int e = 0; e < E; ++e) xs[e] = x2[e] = 0.f;
  for (int c = 0; c < nc; ++c) {
    const float* src = xq + (b * nc + c) * Lp + (long long)f * W;
    for (int k = 0, e = tid; e < N; ++k, e += kThreads) {
      const float v = src[e];
      if (c > 0 && v != buf[e + (e >> 5)]) wbits |= 1u << k;
      buf[e + (e >> 5)] = v;
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int p = p0 + e;
      const float v = buf[p + (p >> 5)];
      xs[e] += v;
      x2[e] += v * v;
      if (c == 0 && p > 0 && v != buf[p - 1 + ((p - 1) >> 5)]) {
        xbits |= 1u << e;
      }
    }
    __syncthreads();
  }
  // window of output t: samples (pad0 - 1 + t, D0 + t]; cst bit q: output
  // tid + q * kThreads has all its samples equal
  int* ibuf = reinterpret_cast<int*>(smem);
  for (int k = 0, e = tid; e < N; ++k, e += kThreads) {
    ibuf[e + (e >> 5)] = (wbits >> k) & 1u;
  }
  __syncthreads();
  int run = 0;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int p = p0 + e;
    const int w = ibuf[p + (p >> 5)];
    run += w | ((xbits >> e) & 1u);
    ibuf[p + (p >> 5)] = run | (w ? ChangeCount::kW : 0);
  }
  long long qrun = run;
  block_exclusive_scan(qrun, sh);
  offs[tid] = qrun;
  __syncthreads();
  const ChangeCount chg{ibuf, offs, E};
  unsigned cst = 0u;
#pragma unroll
  for (int q = 0; q < E; ++q) {
    const int t = tid + q * kThreads;
    if (t < W && chg.constant(pad0 - 1 + t, D0 + t)) cst |= 1u << q;
  }
  __syncthreads();
  stage_prefix<E>(xs, buf, offs, sh);
  float s1[E];
#pragma unroll
  for (int q = 0; q < E; ++q) {
    const int t = tid + q * kThreads;
    s1[q] = t < W ? (float)window_sum<E>(buf, offs, pad0 - 1 + t, D0 + t)
                  : 0.f;
  }
  __syncthreads();
  stage_prefix<E>(x2, buf, offs, sh);
  // a = s1 / n, power = n * sample variance (0 -> inf); a = 0, power = 1
  // past the valid output length
  const double n_win = (double)n_c * nc;
  float* arow = a + b * m * (long long)W + (long long)f * W;
  float* prow = pw + b * m * (long long)W + (long long)f * W;
#pragma unroll
  for (int q = 0; q < E; ++q) {
    const int t = tid + q * kThreads;
    if (t >= W) break;
    const double s2 = window_sum<E>(buf, offs, pad0 - 1 + t, D0 + t);
    const double s = s1[q];
    const double var = (s2 - s * s / n_win) / (n_win - 1.0);
    const double pv = fmax(var, 0.0) * n_win;
    const bool valid = (long long)f * W + t < out_len;
    arow[t] = valid ? (float)(s / n_win) : 0.f;
    prow[t] = valid ? (pv == 0.0 || ((cst >> q) & 1u) ? INFINITY : (float)pv)
                    : 1.f;
  }

  // ---- forward transform of each channel: z[j] = x[2j] + i x[2j+1] ----
  for (int c = 0; c < nc; ++c) {
    const float2* src2 = reinterpret_cast<const float2*>(
        xq + (b * nc + c) * Lp + (long long)f * W);
    __syncthreads();                  // buf / z free
    for (int j = tid; j < M; j += kThreads) z[j] = __ldg(&src2[j]);
    fft_smem<LOG2M, false>(z, tw);
    float* outr = fr + (b * nc + c) * m * (long long)Rp + (long long)f * Rp;
    float* outi = fi + (b * nc + c) * m * (long long)Rp + (long long)f * Rp;
    for (int k = tid; k < Rp; k += kThreads) {
      const float2 v =
          k <= M ? rfft_split<M>(z, tw, k) : make_float2(0.f, 0.f);
      outr[k] = v.x;
      outi[k] = v.y;
    }
  }
}

}  // namespace detex
