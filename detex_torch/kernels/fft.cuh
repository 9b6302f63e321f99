// Shared device helpers of the block-transform kernels: an in-place
// mixed-radix Stockham FFT over shared memory (irfft_ct runs on it; the
// other transforms on the register-resident core of fft_regs.cuh), the
// pack pass from a half spectrum to the half-length complex transform of a
// real block, and a block-wide exclusive scan.
//
// A real block of n = 2M samples is transformed as M complex points
// z[j] = x[2j] + i*x[2j+1] plus a pre-pass (inverse; the forward post-pass
// is fft_regs.cuh's), so one transform of a 16384-sample block needs
// M = 8192 complex values, 64 KiB of shared memory. Roots of unity come from a float32 table
// tw[k] = exp(-2*pi*i*k/n), k < n/2, built in float64 on the host
// (detex_torch/ops/dft.py twiddles).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace detex {

// Threads per block of the shared-memory FFT (irfft_ct). On an H100
// (700 W) 1024 threads beat 512 by 11% on the scan kernel that first ran on
// it; asking for two resident 512-thread blocks (64 registers) was slower.
constexpr int kThreads = 1024;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// exp(-2 pi i k / 16); constant once the radix loops below unroll
__device__ __forceinline__ float2 root16(int k) {
  constexpr float c1 = 0.92387953251128674f;   // cos(pi/8)
  constexpr float c2 = 0.70710678118654752f;   // cos(pi/4)
  constexpr float c3 = 0.38268343236508977f;   // cos(3pi/8)
  switch (k & 15) {
    case 0: return make_float2(1.f, 0.f);
    case 1: return make_float2(c1, -c3);
    case 2: return make_float2(c2, -c2);
    case 3: return make_float2(c3, -c1);
    case 4: return make_float2(0.f, -1.f);
    case 5: return make_float2(-c3, -c1);
    case 6: return make_float2(-c2, -c2);
    case 7: return make_float2(-c1, -c3);
    case 8: return make_float2(-1.f, 0.f);
    case 9: return make_float2(-c1, c3);
    case 10: return make_float2(-c2, c2);
    case 11: return make_float2(-c3, c1);
    case 12: return make_float2(0.f, 1.f);
    case 13: return make_float2(c3, c1);
    case 14: return make_float2(c2, c2);
    default: return make_float2(c1, c3);
  }
}

// R-point DFT (R = 2, 4, 8, 16) of values held in registers: radix-2
// decimation in time with every index known at compile time.
// INV: sign +1 (unscaled), else -1.
template <int R, bool INV>
__device__ __forceinline__ void dft_regs(float2 (&v)[R]) {
  constexpr int LR = R == 2 ? 1 : R == 4 ? 2 : R == 8 ? 3 : 4;
  static_assert((1 << LR) == R, "radix must be 2, 4, 8 or 16");
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
  for (int half = 1; half < R; half <<= 1) {
#pragma unroll
    for (int g = 0; g < R; g += 2 * half) {
#pragma unroll
      for (int p = 0; p < half; ++p) {
        float2 w = root16(p * (16 / (2 * half)));
        if (INV) w.y = -w.y;
        const float2 t = cmul(v[g + p + half], w);
        const float2 u = v[g + p];
        v[g + p] = make_float2(u.x + t.x, u.y + t.y);
        v[g + p + half] = make_float2(u.x - t.x, u.y - t.y);
      }
    }
  }
}

// exp(-+2 pi i e / P) for P a power of two dividing 2M, e < P, from the
// table tw[k] = exp(-2 pi i k / 2M), k < M
template <int M, bool INV>
__device__ __forceinline__ float2 twiddle(const float2* __restrict__ tw,
                                          int e, int P) {
  const int idx = e * (2 * M / P);                // in [0, 2M)
  float2 w = __ldg(&tw[idx & (M - 1)]);
  if (idx & M) {                                  // second half: -tw
    w.x = -w.x;
    w.y = -w.y;
  }
  if (INV) w.y = -w.y;
  return w;
}

// One radix-R pass of an in-place Stockham (self-sorting) FFT of M points
// in shared memory, after Ns points' worth of earlier passes: work item
// j < M/R reads z[j + r*M/R], multiplies by W_{Ns R}^{r (j mod Ns)}, runs
// the R-point DFT in registers and writes z[(j - j mod Ns)*R + j mod Ns +
// r*Ns]. Every thread reads before the barrier and writes after it.
template <int R, int M, bool INV>
__device__ __forceinline__ void stockham_pass(float2* z,
                                              const float2* __restrict__ tw,
                                              int Ns) {
  constexpr int NW = M / R;
  constexpr int IPT = NW >= kThreads ? NW / kThreads : 1;
  static_assert(NW < kThreads || NW % kThreads == 0, "uneven work split");
  const int tid = threadIdx.x;
  const bool active = NW >= kThreads || tid < NW;
  float2 v[IPT][R];
  if (active) {
#pragma unroll
    for (int it = 0; it < IPT; ++it) {
      const int j = tid + it * kThreads;
      const int jm = j & (Ns - 1);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float2 x = z[j + r * NW];
        if (r > 0 && jm > 0) x = cmul(x, twiddle<M, INV>(tw, r * jm, Ns * R));
        v[it][r] = x;
      }
      dft_regs<R, INV>(v[it]);
    }
  }
  __syncthreads();
  if (active) {
#pragma unroll
    for (int it = 0; it < IPT; ++it) {
      const int j = tid + it * kThreads;
      const int jm = j & (Ns - 1);
      const int base = (j - jm) * R + jm;
#pragma unroll
      for (int r = 0; r < R; ++r) z[base + r * Ns] = v[it][r];
    }
  }
  __syncthreads();
}

// In-place FFT of M = 2^LOG2M points in shared memory, natural order in
// and out: four radix-8 passes, then radix 2 (8192 points) or 4 (16384).
// A radix-16 last pass measured 9% slower on an H100 (700 W): its 16
// values per thread went to local memory. INV: sign +1 (unscaled), else
// -1. Starts and ends with a barrier.
template <int LOG2M, bool INV>
__device__ __forceinline__ void fft_smem(float2* z,
                                         const float2* __restrict__ tw) {
  constexpr int M = 1 << LOG2M;
  static_assert(LOG2M == 13 || LOG2M == 14, "8192 or 16384 points");
  __syncthreads();
  stockham_pass<8, M, INV>(z, tw, 1);
  stockham_pass<8, M, INV>(z, tw, 8);
  stockham_pass<8, M, INV>(z, tw, 64);
  stockham_pass<8, M, INV>(z, tw, 512);
  stockham_pass<(LOG2M == 13 ? 2 : 4), M, INV>(z, tw, 4096);
}

// Pre-pass of the inverse real DFT, the converse of the forward split
// (fft_regs.cuh rfft_split_pairs): from the half spectrum V (already scaled
// by 1/N), with a = V[k], b = V[M-k] and
// w = tw[k] = e^{-2 pi i k/N},
// Z'[k] = (a + conj b) + i e^{+2 pi i k/N} (a - conj b);
// the inverse M-point FFT of Z' is z[j] = x[2j] + i x[2j+1].
__device__ __forceinline__ float2 irfft_pack(float2 a, float2 b, float2 w) {
  const float ar = a.x + b.x, ai = a.y - b.y;
  const float dr = a.x - b.x, di = a.y + b.y;
  const float er = w.x * dr + w.y * di;
  const float ei = w.x * di - w.y * dr;
  return make_float2(ar - ei, ai + er);
}

// Block-wide exclusive scan of one value per thread (exact for integer T).
// ``sh`` is 32 values of shared scratch. Contains __syncthreads(); every
// thread of the block must call it.
template <class T>
__device__ __forceinline__ void block_exclusive_scan(T& v, T* sh) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarp = blockDim.x >> 5;
  T inc = v;
  for (int o = 1; o < 32; o <<= 1) {
    const T t = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += t;
  }
  if (lane == 31) sh[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    T w = lane < nwarp ? sh[lane] : T(0);
    for (int o = 1; o < 32; o <<= 1) {
      const T t = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += t;
    }
    sh[lane] = w;
  }
  __syncthreads();
  v = (warp > 0 ? sh[warp - 1] : T(0)) + inc - v;
  __syncthreads();
}

}  // namespace detex
