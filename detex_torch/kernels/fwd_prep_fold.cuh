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
// floats per channel-frame and the stats once); next to it the
// instructions of the stats (two window sums in double and one change
// count per output) and the latency of their loads at 16 warps an SM. Design:
//  - the nc transforms are rfft_ct_half's: the register-resident FFT of
//    fft_regs.cuh reads each channel's frame in place from xq, 16 bytes a
//    lane, and the paired split writes fr / fi; a block is that core's
//    M/32 threads, two blocks resident per SM at blk 16384;
//  - the stats then reuse the exchange buffer. They need only the channel
//    sums sum_c x_c and sum_c x_c^2 per sample, so the frame is swept twice
//    more (from L2), each sweep leaving one sum per sample in shared
//    memory: no thread holds a per-sample array in registers. Each sum
//    gets a two-level prefix (prefix_runs, window_sum below) over 1024
//    runs, a thread owning runs t, t + T, ...; the first sweep's window
//    sums wait in the power output's own place until the second is done;
//  - a window whose samples are all equal (a zero-filled gap, a constant
//    after the standardization) gets power 0 (inf, DS 0) by an exact count
//    of sample-to-sample changes, as rolling.window_stats_rows does: the
//    float sums would leave rounding in its variance. The changes are one
//    bit per sample (warp ballots during the first sweep), counted by
//    popc over a word prefix.
#pragma once

#include "fft_regs.cuh"

namespace detex {

// Fixed-point grid of the run totals' prefix: exact int64 sums, 2^-24 units.
constexpr double kFixScale = 16777216.0;
// Runs of the two-level prefix per frame (blk / 1024 samples each).
constexpr int kPrepRuns = 1024;
// The sweeps load kPrepTile samples a thread of kPrepGroup channels before
// they use any.
constexpr int kPrepTile = 16;
constexpr int kPrepGroup = 3;

template <int LOG2M>
struct PrepFold {
  static constexpr int M = 1 << LOG2M;
  static constexpr int N = 2 * M;                 // block length blk
  static constexpr int T = RegsFft<LOG2M>::T;
  static constexpr int E = N / kPrepRuns;         // samples per run
  static constexpr int Q = kPrepRuns / T;         // runs per thread
  static constexpr int NWORD = N / 32;            // bit words per frame
  // shared memory: the per-sample buffer (padded one word per 32; the FFT's
  // M float2 alias it), 32 scan partials and the run offsets, three bit
  // arrays (channels differ, any change, window constant) and the change
  // counts' word prefix
  static constexpr int kBufFloats = N + N / 32;
  static constexpr int kSmemBytes =
      kBufFloats * (int)sizeof(float) +
      (32 + kPrepRuns) * (int)sizeof(long long) +
      4 * NWORD * (int)sizeof(unsigned);
  static_assert(NWORD == 2 * T, "two bit words per thread");
  static_assert(N % (kPrepTile * T) == 0, "whole tiles");
};

// Two-level prefix of the per-sample sum in buf (index p at p + p/32):
// every run of E samples becomes its float running sum, and offs[r] the
// exclusive prefix of the run totals T_r on the fixed-point grid, summed
// exactly. Thread tid owns runs tid + q T. Called by the whole block; ends
// with a barrier.
template <int LOG2M>
__device__ __forceinline__ void prefix_runs(float* buf, long long* offs,
                                            long long* sh) {
  using P = PrepFold<LOG2M>;
  const int tid = threadIdx.x;
#pragma unroll
  for (int q = 0; q < P::Q; ++q) {
    const int r = tid + q * P::T;
    const int p0 = r * P::E;
    float run = 0.f;
#pragma unroll
    for (int e = 0; e < P::E; ++e) {
      const int p = p0 + e;
      run += buf[p + (p >> 5)];
      buf[p + (p >> 5)] = run;
    }
    offs[r] = llrint((double)run * kFixScale);
  }
  __syncthreads();
  long long loc[P::Q];
  long long s = 0;
#pragma unroll
  for (int q = 0; q < P::Q; ++q) {
    loc[q] = offs[P::Q * tid + q];
    s += loc[q];
  }
  block_exclusive_scan(s, sh);
#pragma unroll
  for (int q = 0; q < P::Q; ++q) {
    offs[P::Q * tid + q] = s;
    s += loc[q];
  }
  __syncthreads();
}

// Sum of v over samples (pl, ph] from prefix_runs' two levels: with runs
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
// bit per sample p of a frame: chg[p] where two channels differ at p or
// channel 0 changes from p - 1 to p, dif[p] where two channels differ at
// p; cpre[w] counts the chg bits before word w. Window (pl, ph] is
// constant when no chg falls in (pl + 1, ph] and the channels agree at
// pl + 1.
struct ChangeCount {
  const unsigned* dif;
  const unsigned* chg;
  const int* cpre;
  __device__ __forceinline__ int at(int p) const {  // count through p
    return cpre[p >> 5] + __popc(chg[p >> 5] & (0xffffffffu >> (31 - (p & 31))));
  }
  __device__ __forceinline__ bool constant(int pl, int ph) const {
    const int q = pl + 1;
    return !((dif[q >> 5] >> (q & 31)) & 1u) && at(ph) == at(q);
  }
};

// Samples x[k T] of channels c0 .. c0 + kPrepGroup - 1 (0 for channels
// >= nc) behind x = x0 + e0, every load started before any use.
template <int LOG2M>
__device__ __forceinline__ void load_tile(
    const float* __restrict__ x, long long Lp, int nc, int c0,
    float (&v)[kPrepGroup][kPrepTile]) {
#pragma unroll
  for (int j = 0; j < kPrepGroup; ++j) {
#pragma unroll
    for (int k = 0; k < kPrepTile; ++k) {
      v[j][k] = c0 + j < nc
                    ? __ldg(&x[(c0 + j) * Lp + k * PrepFold<LOG2M>::T])
                    : 0.f;
    }
  }
}

// prep_transform and prep_stats are compiled out of line: each gets the
// block's whole register budget to itself. Inlined into one kernel body
// they spilled (680 bytes at blk 16384) and the kernel ran 1.5 times as
// long.

// One channel's frame (2M floats at src) to its half spectrum in outr /
// outi [Rp], zeros past bin M. Called by the whole block; the exchange
// buffer (the start of shared memory) free at entry.
template <int LOG2M>
__device__ __noinline__ void prep_transform(
    const float* __restrict__ src, const float2* __restrict__ stage,
    const float2* __restrict__ tw, float* __restrict__ outr,
    float* __restrict__ outi, int Rp) {
  using P = PrepFold<LOG2M>;
  // the block's shared memory by its own name: a pointer handed to a
  // function out of line would lose its address space
  extern __shared__ __align__(16) unsigned char smem[];
  float2* z = reinterpret_cast<float2*>(smem);     // M complex values
  for (int k = P::M + 1 + threadIdx.x; k < Rp; k += P::T) {
    outr[k] = 0.f;
    outi[k] = 0.f;
  }
  fft_regs_row<LOG2M>(reinterpret_cast<const float4*>(src), stage, z);
  rfft_split_pairs<LOG2M>(z, tw, StorePair{outr, outi});
}

// Window mean and power of one frame's W outputs into arow / prow, from
// the frame's nc channels at x0 + c Lp. ``first`` : f W, the frame's first
// output. Called by the whole block; smem free at entry.
template <int LOG2M>
__device__ __noinline__ void prep_stats(
    const float* __restrict__ x0, float* __restrict__ arow, float* prow,
    int nc, long long Lp, int W, int D0, int pad0, int n_c,
    long long out_len, long long first) {
  using P = PrepFold<LOG2M>;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int N = P::N, T = P::T, E = P::E;
  float* buf = reinterpret_cast<float*>(smem);     // N + N/32 floats
  long long* sh = reinterpret_cast<long long*>(
      smem + (size_t)P::kBufFloats * sizeof(float));   // 32 scan partials
  long long* offs = sh + 32;                           // kPrepRuns offsets
  unsigned* dif = reinterpret_cast<unsigned*>(offs + kPrepRuns);
  unsigned* chg = dif + P::NWORD;
  unsigned* cst = chg + P::NWORD;
  int* cpre = reinterpret_cast<int*>(cst + P::NWORD);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  // sweep 1: sum_c x_c per sample, the change bits by warp ballot (a warp
  // holds the 32 samples of one word). A tile of kPrepTile samples a thread
  // of kPrepGroup channels is in flight at a time: a load per sample and
  // channel would wait out its latency N / T * nc times over.
  for (int e0 = tid; e0 < N; e0 += kPrepTile * T) {
    float xs[kPrepTile], prev[kPrepTile];
    unsigned differ = 0u, change = 0u;         // bit k: sample e0 + k T
    for (int c0 = 0; c0 < nc; c0 += kPrepGroup) {
      float v[kPrepGroup][kPrepTile], left[kPrepTile];
      load_tile<LOG2M>(x0 + e0, Lp, nc, c0, v);
      if (c0 == 0) {
        // channel 0 at the sample before: the lane below holds it, lane 0
        // loads it (sample 0 of the frame has none). Loads only in this
        // loop: a use between two loads would wait out the first.
#pragma unroll
        for (int k = 0; k < kPrepTile; ++k) {
          const int e = e0 + k * T;
          left[k] = 0.f;
          if (lane == 0 && e > 0) left[k] = __ldg(&x0[e - 1]);
        }
#pragma unroll
        for (int k = 0; k < kPrepTile; ++k) {
          const float below = __shfl_up_sync(0xffffffffu, v[0][k], 1);
          const float before =
              lane ? below : (e0 + k * T > 0 ? left[k] : v[0][k]);
          if (v[0][k] != before) change |= 1u << k;
          xs[k] = 0.f;
          prev[k] = v[0][k];
        }
      }
#pragma unroll
      for (int j = 0; j < kPrepGroup; ++j) {
        if (c0 + j >= nc) break;
#pragma unroll
        for (int k = 0; k < kPrepTile; ++k) {
          if (v[j][k] != prev[k]) differ |= 1u << k;
          prev[k] = v[j][k];
          xs[k] += v[j][k];
        }
      }
    }
    change |= differ;
#pragma unroll
    for (int k = 0; k < kPrepTile; ++k) {
      const int e = e0 + k * T;
      buf[e + (e >> 5)] = xs[k];
      const unsigned dw = __ballot_sync(0xffffffffu, (differ >> k) & 1u);
      const unsigned cw = __ballot_sync(0xffffffffu, (change >> k) & 1u);
      if (lane == 0) {
        dif[e >> 5] = dw;
        chg[e >> 5] = cw;
      }
    }
  }
  __syncthreads();
  {
    const int c0 = __popc(chg[2 * tid]);
    int before = c0 + __popc(chg[2 * tid + 1]);
    block_exclusive_scan(before, reinterpret_cast<int*>(sh));
    cpre[2 * tid] = before;
    cpre[2 * tid + 1] = before + c0;
  }
  prefix_runs<LOG2M>(buf, offs, sh);
  // window of output t: samples (pad0 - 1 + t, D0 + t]. The window sum of x
  // waits in the power output's place for the second sweep; a warp's 32
  // outputs give one word of constant-window bits.
  const ChangeCount changes{dif, chg, cpre};
  // 1/n and n/(n - 1) once: no division per output
  const double n_win = (double)n_c * nc;
  const double inv_n = 1.0 / n_win;
  const double unbias = n_win / (n_win - 1.0);
#pragma unroll 4
  for (int t = tid; t < W; t += T) {
    const int pl = pad0 - 1 + t, ph = D0 + t;
    const float s1 = (float)window_sum<E>(buf, offs, pl, ph);
    arow[t] = first + t < out_len ? (float)((double)s1 * inv_n) : 0.f;
    prow[t] = s1;
    const unsigned kw = __ballot_sync(0xffffffffu, changes.constant(pl, ph));
    if (lane == 0) cst[t >> 5] = kw;
  }
  __syncthreads();
  // sweep 2: sum_c x_c^2 per sample
  for (int e0 = tid; e0 < N; e0 += kPrepTile * T) {
    float x2[kPrepTile];
#pragma unroll
    for (int k = 0; k < kPrepTile; ++k) x2[k] = 0.f;
    for (int c0 = 0; c0 < nc; c0 += kPrepGroup) {
      float v[kPrepGroup][kPrepTile];
      load_tile<LOG2M>(x0 + e0, Lp, nc, c0, v);
#pragma unroll
      for (int j = 0; j < kPrepGroup; ++j) {
#pragma unroll
        for (int k = 0; k < kPrepTile; ++k) x2[k] += v[j][k] * v[j][k];
      }
    }
#pragma unroll
    for (int k = 0; k < kPrepTile; ++k) {
      const int e = e0 + k * T;
      buf[e + (e >> 5)] = x2[k];
    }
  }
  __syncthreads();
  prefix_runs<LOG2M>(buf, offs, sh);
  // a = s1 / n, power = n * sample variance (0 -> inf); a = 0, power = 1
  // past the valid output length
  for (int t0 = tid; t0 < W; t0 += 16 * T) {
    float s1[16];                     // sixteen parked sums in flight
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int t = t0 + k * T;
      s1[k] = t < W ? prow[t] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int t = t0 + k * T;
      if (t >= W) break;
      const double s2 = window_sum<E>(buf, offs, pad0 - 1 + t, D0 + t);
      const double s = s1[k];
      const double pv = fmax(s2 - s * s * inv_n, 0.0) * unbias;
      const bool flat = (cst[t >> 5] >> (t & 31)) & 1u;
      prow[t] = first + t < out_len
                    ? (pv == 0.0 || flat ? INFINITY : (float)pv)
                    : 1.f;
    }
  }
}

template <int LOG2M>
__global__ void __launch_bounds__(RegsFft<LOG2M>::T,
                                  RegsFft<LOG2M>::kRowsPerSm)
fwd_prep_fold_kernel(const float* __restrict__ xq,
                     const float2* __restrict__ stage,
                     const float2* __restrict__ tw,
                     float* __restrict__ fr, float* __restrict__ fi,
                     float* __restrict__ a, float* __restrict__ pw,
                     int nc, long long Lp, int m, int W, int D0, int pad0,
                     int n_c, long long out_len, int Rp) {
  const long long b = blockIdx.x / m;
  const int f = blockIdx.x % m;
  const float* x0 = xq + b * nc * Lp + (long long)f * W;   // channel 0
  // forward transform of each channel, the frame read in place
  for (int c = 0; c < nc; ++c) {
    if (c) __syncthreads();           // the split still reads z
    const long long o = (b * nc + c) * m * (long long)Rp + (long long)f * Rp;
    prep_transform<LOG2M>(x0 + c * Lp, stage, tw, fr + o, fi + o, Rp);
  }
  __syncthreads();                    // z free: the stats take the buffer
  const long long first = (long long)f * W;
  const long long so = b * m * (long long)W + first;
  prep_stats<LOG2M>(x0, a + so, pw + so, nc, Lp, W, D0, pad0, n_c, out_len,
                    first);
}

}  // namespace detex
