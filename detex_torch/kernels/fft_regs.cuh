// Register-resident FFT core of the block transforms rfft_ct, rfft_ct_half,
// fwd_prep_fold (forward), irfft_ct and spec_ds_fold (inverse): a row of
// n = 2M real samples (M = 8192 or 16384) is transformed as M complex points
// z[j] = x[2j] + i x[2j+1] by T = M/32 threads, each holding 32 complex
// points in registers, in three Stockham passes (radix 16, 16, 32 at
// M = 8192; 16, 32, 32 at 16384) with two exchanges through shared memory
// between them. Forward, the split pass then makes the real DFT's bins 0..M
// from Z, bins k and M-k in one thread. Inverse (irfft_regs_row, below), the
// pack pre-pass runs in registers before pass 1 and the last pass leaves the
// samples in registers; the roots are the forward tables' conjugates.
//
// What the layout does for the card:
//  - pass 1 reads the row from device memory, 16 bytes a lane (two work
//    items j = 2t, 2t+1 per thread), straight into registers, with plain
//    read-only loads: streaming (evict-first) loads measured 7% slower;
//  - pass 1 leaves each thread 32 consecutive points; it writes them with
//    the index swizzled (i ^ ((i >> 5) & 15)) so that the strided writes
//    and pass 2's reads are both free of bank conflicts at 8 bytes a lane;
//    passes 2 and 3 write where consecutive lanes hold consecutive points;
//  - pass 3 writes the points it read (z[t + r T]), so no barrier stands
//    between its reads and writes: four barriers a row;
//  - the roots of unity of passes 2 and 3 come from a per-stage table
//    laid out [r][lane] (detex_torch/ops/dft.py stage_twiddles, built in
//    float64), so a warp's loads are consecutive; the DFTs inside a pass
//    use compile-time constants and skip the trivial roots;
//  - at M = 8192 a row takes 256 threads and 64 KiB of shared memory, so
//    two rows are resident on an SM and one's loads and stores run under
//    the other's butterflies; at M = 16384 (512 threads, 128 KiB) one.
#pragma once

#include "fft.cuh"

namespace detex {

template <int LOG2M>
struct RegsFft {
  static_assert(LOG2M == 13 || LOG2M == 14, "8192 or 16384 points");
  static constexpr int M = 1 << LOG2M;
  static constexpr int T = M / 32;                    // threads per row
  static constexpr int R2 = LOG2M == 13 ? 16 : 32;    // radix of pass 2
  static constexpr int NW2 = M / R2;                  // pass-2 work items
  static constexpr int TAB2 = 16 * R2;                // pass-2 table entries
  static constexpr int kSmemBytes = M * (int)sizeof(float2);
  // resident rows per SM the launch bounds ask for
  static constexpr int kRowsPerSm = LOG2M == 13 ? 2 : 1;
};

// cos(2 pi k / 32), 0 <= k <= 8; constant once the loops below unroll
__device__ __forceinline__ float cos32(int k) {
  switch (k) {
    case 0: return 1.f;
    case 1: return 0.98078528040323043f;
    case 2: return 0.92387953251128674f;
    case 3: return 0.83146961230254524f;
    case 4: return 0.70710678118654752f;
    case 5: return 0.55557023301960218f;
    case 6: return 0.38268343236508977f;
    case 7: return 0.19509032201612825f;
    default: return 0.f;
  }
}

// v * exp(-2 pi i k / 32) (INV: exp(+2 pi i k / 32)), 0 <= k < 16 known at
// compile time: the trivial roots cost no multiply, the odd eighths two
template <bool INV>
__device__ __forceinline__ float2 mul_root32(float2 v, int k) {
  if (k == 0) return v;
  if (INV) v.y = -v.y;                // conj(conj(v) w) = v conj(w)
  float2 p;
  if (k == 8) {
    p = make_float2(v.y, -v.x);
  } else if (k == 4) {
    const float c = cos32(4);
    p = make_float2(c * (v.x + v.y), c * (v.y - v.x));
  } else if (k == 12) {
    const float c = cos32(4);
    p = make_float2(c * (v.y - v.x), -c * (v.x + v.y));
  } else {
    const float c = k < 8 ? cos32(k) : -cos32(16 - k);
    const float s = k < 8 ? cos32(8 - k) : cos32(k - 8);
    p = make_float2(v.x * c + v.y * s, v.y * c - v.x * s);
  }
  if (INV) p.y = -p.y;
  return p;
}

// R-point DFT (R = 16 or 32; INV: sign +1, unscaled) of values held in
// registers: radix-2 decimation in time, every index and root known at
// compile time. Every loop counts up to a constant, so that the compiler
// unrolls all of them and the values stay in registers.
template <int R, bool INV>
__device__ __forceinline__ void dft_radix(float2 (&v)[R]) {
  constexpr int LR = R == 16 ? 4 : 5;
  static_assert((1 << LR) == R, "radix must be 16 or 32");
#pragma unroll
  for (int i = 0; i < R; ++i) {
    int j = 0;
#pragma unroll
    for (int b = 0; b < LR; ++b) j |= ((i >> b) & 1) << (LR - 1 - b);
    if (j > i) {
      const float2 t = v[i];
      v[i] = v[j];
      v[j] = t;
    }
  }
#pragma unroll
  for (int l = 0; l < LR; ++l) {
#pragma unroll
    for (int b = 0; b < R / 2; ++b) {        // butterfly b of level l
      const int p = b & ((1 << l) - 1);
      const int lo = ((b >> l) << (l + 1)) + p;
      const int hi = lo + (1 << l);
      const float2 t = mul_root32<INV>(v[hi], p * (16 >> l));
      const float2 u = v[lo];
      v[lo] = make_float2(u.x + t.x, u.y + t.y);
      v[hi] = make_float2(u.x - t.x, u.y - t.y);
    }
  }
}

// Barrier of the threads that share one transform: the whole block, or
// one group of a block that runs several transforms side by side (named
// barrier ``id`` >= 1 over ``count`` threads, a multiple of 32).
struct BlockBarrier {
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};
#ifndef DETEX_HOST_EMULATION
__device__ __forceinline__ void named_barrier_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}
#endif
struct GroupBarrier {
  int id, count;
  __device__ __forceinline__ void operator()() const {
    named_barrier_sync(id, count);
  }
};

// Pass 2 of either direction (radix R2 after 16 points): work item j reads
// z[j + r NW2], multiplies by W_{16 R2}^{r (j mod 16)} (INV: its conjugate)
// and writes z[(j - j mod 16) R2 + j mod 16 + 16 r]; a thread's items
// j = t, t + T share j mod 16 and so their roots. Pass 1 left logical index
// i at z[i ^ ((i >> SWZ) & 15)]; the writes here are in natural order,
// consecutive lanes on consecutive points. One barrier between the reads
// and the writes; the caller puts one before and one after.
template <int LOG2M, bool INV, int SWZ, class Bar>
__device__ __forceinline__ void regs_pass2(int t,
                                           const float2* __restrict__ stage,
                                           float2* z, Bar bar) {
  using P = RegsFft<LOG2M>;
  constexpr int T = P::T, R2 = P::R2, NW2 = P::NW2;
  constexpr int IT = NW2 / T;
  float2 v[IT][R2];
  const int jm = t & 15;
#pragma unroll
  for (int it = 0; it < IT; ++it) {
#pragma unroll
    for (int r = 0; r < R2; ++r) {
      const int i = t + it * T + r * NW2;
      v[it][r] = z[i ^ ((i >> SWZ) & 15)];
    }
  }
  bar();
#pragma unroll
  for (int r = 1; r < R2; ++r) {
    float2 w = __ldg(&stage[r * 16 + jm]);
    if (INV) w.y = -w.y;
#pragma unroll
    for (int it = 0; it < IT; ++it) v[it][r] = cmul(v[it][r], w);
  }
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    dft_radix<R2, INV>(v[it]);
    const int j = t + it * T;
    float2* zb = z + (j - jm) * R2 + jm;
#pragma unroll
    for (int r = 0; r < R2; ++r) zb[r * 16] = v[it][r];
  }
}

// Pass 3 of either direction (radix 32 after T = M/32 points): thread t
// reads z[t + r T], multiplies by W_M^{r t} (INV: its conjugate) and ends
// with the transform's points t + r T in v[r].
template <int LOG2M>
__device__ __forceinline__ void regs_pass3_load(int t, const float2* z,
                                                float2 (&v)[32]) {
  constexpr int T = RegsFft<LOG2M>::T;
#pragma unroll
  for (int r = 0; r < 32; ++r) v[r] = z[t + r * T];
}
template <int LOG2M, bool INV>
__device__ __forceinline__ void regs_pass3_dft(
    int t, const float2* __restrict__ stage, float2 (&v)[32]) {
  using P = RegsFft<LOG2M>;
#pragma unroll
  for (int r = 1; r < 32; ++r) {
    float2 w = __ldg(&stage[P::TAB2 + r * P::T + t]);
    if (INV) w.y = -w.y;
    v[r] = cmul(v[r], w);
  }
  dft_radix<32, INV>(v);
}

// Forward FFT of the M complex points behind ``src`` (the row's 2M floats
// as M/2 float4, 16-byte aligned) into shared memory z[0..M) in natural
// order. ``stage`` is dft.stage_twiddles' table: [R2][16] roots
// exp(-2 pi i r jm / (16 R2)) of pass 2, then [32][T] roots
// exp(-2 pi i r t / M) of pass 3. Called by all T threads of the block;
// ends with a barrier.
template <int LOG2M>
__device__ __forceinline__ void fft_regs_row(const float4* __restrict__ src,
                                             const float2* __restrict__ stage,
                                             float2* z) {
  using P = RegsFft<LOG2M>;
  constexpr int T = P::T;
  const int t = threadIdx.x;
  {
    // pass 1 (radix 16, no roots): work items j = 2t and 2t + 1 read
    // z[j + r M/16] as one float4 a step and write z[16 j + r]
    float2 v0[16], v1[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float4 q = __ldg(&src[t + r * T]);
      v0[r] = make_float2(q.x, q.y);
      v1[r] = make_float2(q.z, q.w);
    }
    dft_radix<16, false>(v0);
    dft_radix<16, false>(v1);
    float2* zt = z + 32 * t;
    const int sw = t & 15;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      zt[r ^ sw] = v0[r];
      zt[(16 + r) ^ sw] = v1[r];
    }
  }
  __syncthreads();
  regs_pass2<LOG2M, false, 5>(t, stage, z, BlockBarrier{});
  __syncthreads();
  {
    // pass 3 writes the places it read
    float2 v[32];
    regs_pass3_load<LOG2M>(t, z, v);
    regs_pass3_dft<LOG2M, false>(t, stage, v);
#pragma unroll
    for (int r = 0; r < 32; ++r) z[t + r * T] = v[r];
  }
  __syncthreads();
}

// Inverse real DFT of one row, the converse of fft_regs_row +
// rfft_split_pairs: from the half spectrum V[0..M] behind ``src`` (already
// scaled by 1/n; src(k) gives V[k] for 0 < k < M, src.edge(k) the real
// part of V[0] or V[M], whose imaginary parts do not count) to the row's
// samples, x[r] = (x[2j], x[2j + 1]) at j = t + r T, left in registers.
// Called by the T threads (t = 0..T-1) that share ``bar`` and the exchange
// buffer z[0..M); its last barrier follows its last read of z, so z is
// free when it returns.
//
// Pack pre-pass, in registers: Z'[k] = (V[k] + conj V[M-k]) + i e^{+2 pi i
// k/2M} (V[k] - conj V[M-k]), the converse of the forward split, and with
// (A, E) the two terms of Z'[k], Z'[M-k] = conj A + i conj E: one read of
// the pair and one root give both. Pass 1's work item j holds points
// j + r M/16; its mirror points M - k belong to work item M/16 - j, so
// thread t takes items t and M/16 - t and finds every pair in its own
// registers. Items 0 and M/32 are their own mirrors: thread 0 takes both,
// pairs them inside each item, and moves the results to the registers the
// other threads use. Pass 1 writes
// logical index i at z[i ^ ((i >> 4) & 15)]: 16 consecutive points a work
// item, free of bank conflicts there and in pass 2's reads.
template <int LOG2M, class Src, class Bar>
__device__ __forceinline__ void irfft_regs_row(
    int t, Src src, const float2* __restrict__ tw,
    const float2* __restrict__ stage, float2* z, Bar bar, float2 (&x)[32]) {
  using P = RegsFft<LOG2M>;
  constexpr int M = P::M, T = P::T;
  {
    float2 v0[16], v1[16];      // items ja = t and jb = 2T - t (T at t = 0)
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      // slot i: k = t + i 2T -> v0[i], M - k -> v1[15 - i]. Thread 0 loads
      // item T's pairs (i, 15 - i) in slots 0..7 and item 0's pairs
      // (i - 7, 23 - i) in slots 8..14, and moves them into place below;
      // its slot 15 is redone there
      const int k0 = i < 8 ? T + i * 2 * T : i < 15 ? (i - 7) * 2 * T : T;
      const int k = t ? t + i * 2 * T : k0;
      const float2 a = src(k);
      const float2 b = src(M - k);
      const float2 w = __ldg(&tw[k]);
      const float ar = a.x + b.x, ai = a.y - b.y;
      const float dr = a.x - b.x, di = a.y + b.y;
      const float er = w.x * dr + w.y * di;
      const float ei = w.x * di - w.y * dr;
      v0[i] = make_float2(ar - ei, ai + er);
      v1[15 - i] = make_float2(ar + ei, er - ai);
    }
    if (t == 0) {
      // item 0's mirror halves wait in v1[1..7], item T's first half in
      // v0[0..7]; v1[8..15] is in place
      float2 lo[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) lo[i] = v0[i];
#pragma unroll
      for (int i = 1; i < 8; ++i) v0[i] = v0[i + 7];
#pragma unroll
      for (int i = 1; i < 8; ++i) v0[i + 8] = v1[i];
#pragma unroll
      for (int i = 0; i < 8; ++i) v1[i] = lo[i];
      // Z'[0] from the real V[0] and V[M]; Z'[M/2] = 2 conj V[M/2]
      const float e0 = src.edge(0), eM = src.edge(M);
      const float2 h = src(M / 2);
      v0[0] = make_float2(e0 + eM, e0 - eM);
      v0[8] = make_float2(2.f * h.x, -2.f * h.y);
    }
    // pass 1 (radix 16, no roots): item j writes z[16 j + r]
    dft_radix<16, true>(v0);
    dft_radix<16, true>(v1);
    const int jb = t ? 2 * T - t : T;
    float2* za = z + 16 * t;
    float2* zb = z + 16 * jb;
    const int swa = t & 15, swb = jb & 15;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      za[r ^ swa] = v0[r];
      zb[r ^ swb] = v1[r];
    }
  }
  bar();
  regs_pass2<LOG2M, true, 4>(t, stage, z, bar);
  bar();
  regs_pass3_load<LOG2M>(t, z, x);
  bar();
  regs_pass3_dft<LOG2M, true>(t, stage, x);
}

// The split pass after fft_regs_row: bins 0..M of the real DFT of the
// 2M-sample row from Z in shared memory. With E = (Z[k] + conj Z[M-k]) / 2,
// O = (Z[k] - conj Z[M-k]) / 2i and P = tw[k] O (tw[k] = exp(-2 pi i k/2M),
// tw[M-k] = -conj tw[k]): X[k] = E + P and X[M-k] = conj(E - P), so one
// read of the pair and one root give both bins; X[0] and X[M] come from
// Z[0]. ``out(k, X)`` is called once for every k in [0, M].
template <int LOG2M, class Out>
__device__ __forceinline__ void rfft_split_pairs(const float2* z,
                                                 const float2* __restrict__ tw,
                                                 Out out) {
  using P = RegsFft<LOG2M>;
  constexpr int M = P::M, T = P::T;
  const int t = threadIdx.x;
  // pairs (k, M - k), 0 < k < M/2: k = t + i T, so every address below is
  // a per-thread base plus a compile-time offset
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    if (i == 0 && t == 0) continue;
    const int k = t + i * T;
    const float2 p = z[k];
    const float2 q = z[M - k];
    const float2 w = __ldg(&tw[k]);
    const float er = 0.5f * (p.x + q.x);
    const float ei = 0.5f * (p.y - q.y);
    const float orr = 0.5f * (p.y + q.y);
    const float oi = -0.5f * (p.x - q.x);
    const float pr = w.x * orr - w.y * oi;
    const float pi = w.x * oi + w.y * orr;
    out(k, make_float2(er + pr, ei + pi));
    out(M - k, make_float2(er - pr, pi - ei));
  }
  if (t == 0) {
    // X[0] and X[M] from Z[0]; bin M/2 is its own pair with tw = -i
    const float2 z0 = z[0];
    const float2 zh = z[M / 2];
    out(0, make_float2(z0.x + z0.y, 0.f));
    out(M, make_float2(z0.x - z0.y, 0.f));
    out(M / 2, make_float2(zh.x, -zh.y));
  }
}

// Output of rfft_split_pairs as the float pair (fr, fi)
struct StorePair {
  float* fr;
  float* fi;
  __device__ __forceinline__ void operator()(int k, float2 v) const {
    fr[k] = v.x;
    fi[k] = v.y;
  }
};

// Start of row ``row`` of a framed source: rows of ``Lp`` floats behind
// ``x``, each cut into ``m`` frames at stride ``W`` (row r m + f starts at
// x + r Lp + f W). Contiguous [N, n] input is m = 1, Lp = n.
__device__ __forceinline__ const float4* frame_start(const float* x,
                                                     long long row,
                                                     long long Lp, int m,
                                                     int W) {
  const long long r = row / m;
  const long long f = row - r * m;
  return reinterpret_cast<const float4*>(x + r * Lp + f * W);
}

}  // namespace detex
