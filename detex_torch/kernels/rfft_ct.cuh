// rfft_ct: forward real DFT of the rows of x [N, n], n = 2M in
// {16384, 32768}, one thread block per row.
//
// Replaces detex_tpu/ops/pallas_kernels.py rfft_ct_fused (:336, kernel body
// :309-332), which runs the transform as two 128 x 128 Cooley-Tukey matrix
// stages for the TPU's matrix unit and emits the full-width (fr, fi) pair
// of which its callers keep bins 0..n/2. Here the block loads the row as M
// complex points z[j] = x[2j] + i x[2j+1] into shared memory, runs the
// Stockham FFT of fft.cuh and writes only the kept bins, X[0..M], as
// interleaved complex values (out [N, M + 1] float2, which PyTorch views
// as complex64).
//
// Bound on the card: device-memory traffic (read n floats, write n + 2
// floats per row; the FFT is ~2.5 n log2 n flops, far below the float32
// peak at these sizes) and the shared-memory passes of the FFT. Design:
// one row per block keeps the whole transform in shared memory (64 KiB at
// n = 16384, 128 KiB at 32768); a simple, correct first version.
#pragma once

#include "fft.cuh"

namespace detex {

template <int LOG2M>
__global__ void __launch_bounds__(kThreads)
rfft_ct_kernel(const float* __restrict__ x, const float2* __restrict__ tw,
               float2* __restrict__ out) {
  constexpr int M = 1 << LOG2M;
  extern __shared__ __align__(16) unsigned char smem[];
  float2* z = reinterpret_cast<float2*>(smem);
  const long long r = blockIdx.x;
  const float2* src = reinterpret_cast<const float2*>(x + r * (2LL * M));
  for (int j = threadIdx.x; j < M; j += kThreads) z[j] = __ldg(&src[j]);
  fft_smem<LOG2M, false>(z, tw);
  float2* dst = out + r * (M + 1LL);
  for (int k = threadIdx.x; k <= M; k += kThreads) {
    dst[k] = rfft_split<M>(z, tw, k);
  }
}

}  // namespace detex
