// hist_uniform: exact per-row histogram of DS rows over [0, 1] in nbin
// uniform bins; one thread block per (row, tile of kHistTile samples).
//
// Replaces detex_tpu/ops/pallas_kernels.py hist_uniform (:199, kernel body
// :161-195), which counts through two one-hot matrices on the TPU's matrix
// unit (nbin a perfect square there). Here the rule is applied directly:
// bin floor(v * nbin) in float32, v == 1.0 in the last bin, values outside
// [0, 1], -inf and NaN dropped. Counts go to shared-memory bins with integer
// atomics, then each nonzero bin to the row's counts hist [S, nbin] (zeroed
// by the caller) with one global atomic; exact and order-free.
//
// Bound on the card: device-memory traffic (read each DS value once; the
// counts are nbin ints a row). Design: one pass, coalesced reads, a tile
// long enough that the shared bins are zeroed and flushed once per 32
// samples a thread.
#pragma once

#include <cuda_runtime.h>

namespace detex {

constexpr int kHistThreads = 256;
constexpr int kHistTile = 8192;

__global__ void __launch_bounds__(kHistThreads)
hist_uniform_kernel(const float* __restrict__ ds, int* __restrict__ hist,
                    long long L, int tiles, int nbin) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* hs = reinterpret_cast<int*>(smem);
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const long long r = blockIdx.x / tiles;
  const long long lo = (long long)(blockIdx.x % tiles) * kHistTile;
  const long long hi = lo + kHistTile < L ? lo + kHistTile : L;
  for (int k = tid; k < nbin; k += nthr) hs[k] = 0;
  __syncthreads();
  const float* row = ds + r * L;
  for (long long p = lo + tid; p < hi; p += nthr) {
    const float v = row[p];
    float bin = floorf(v * (float)nbin);
    if (v == 1.0f) bin = (float)(nbin - 1);
    if (bin >= 0.f && bin < (float)nbin) atomicAdd(&hs[(int)bin], 1);
  }
  __syncthreads();
  for (int k = tid; k < nbin; k += nthr) {
    if (hs[k]) atomicAdd(&hist[r * nbin + k], hs[k]);
  }
}

}  // namespace detex
