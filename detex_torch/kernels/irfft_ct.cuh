// irfft_ct: inverse real DFT of half spectra, spec [N, M + 1] complex ->
// x [N, n] float32 scaled by 1/n, n = 2M in {16384, 32768}, one thread
// block per row (== torch.fft.irfft(spec, n): the imaginary parts of bins
// 0 and M are ignored).
//
// Replaces detex_tpu/ops/pallas_kernels.py irfft_ct_fused (:270, kernel
// body :236-266), which takes the hermitian extension [N, n] built by its
// caller and runs two 128 x 128 Cooley-Tukey matrix stages for the TPU's
// matrix unit. Here the block reads the M + 1 bins once, packs them into M
// complex points (irfft_pack of fft.cuh, 1/n folded in), runs the inverse
// Stockham FFT in shared memory and writes z[j] = x[2j] + i x[2j+1]; no
// hermitian extension is ever built.
//
// Bound on the card: device-memory traffic (read n + 2, write n floats
// per row; ~2.5 n log2 n flops) and the shared-memory FFT passes.
#pragma once

#include "fft.cuh"

namespace detex {

template <int LOG2M>
__global__ void __launch_bounds__(kThreads)
irfft_ct_kernel(const float2* __restrict__ spec,
                const float2* __restrict__ tw, float* __restrict__ out) {
  constexpr int M = 1 << LOG2M;
  constexpr float kScale = 1.0f / (2 * M);  // exact: a power of two
  extern __shared__ __align__(16) unsigned char smem[];
  float2* z = reinterpret_cast<float2*>(smem);
  const long long r = blockIdx.x;
  const float2* src = spec + r * (M + 1LL);
  // bin pair (k, M-k) -> z[k] and z[M-k]
  for (int k = threadIdx.x; k <= M / 2; k += kThreads) {
    const int k2 = M - k;
    float2 v1 = __ldg(&src[k]);
    float2 v2 = __ldg(&src[k2]);
    if (k == 0) {             // bins 0 and M: real parts only
      v1.y = 0.f;
      v2.y = 0.f;
    }
    v1 = make_float2(v1.x * kScale, v1.y * kScale);
    v2 = make_float2(v2.x * kScale, v2.y * kScale);
    z[k] = irfft_pack(v1, v2, __ldg(&tw[k]));
    if (k != 0 && k != M / 2) z[k2] = irfft_pack(v2, v1, __ldg(&tw[k2]));
  }
  fft_smem<LOG2M, true>(z, tw);
  float2* dst = reinterpret_cast<float2*>(out + r * (2LL * M));
  for (int j = threadIdx.x; j < M; j += kThreads) dst[j] = z[j];
}

}  // namespace detex
