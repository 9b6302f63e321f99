// irfft_ct: inverse real DFT of half spectra, spec [N, M + 1] complex ->
// x [N, n] float32 scaled by 1/n, n = 2M in {16384, 32768}, one thread
// block per row (== torch.fft.irfft(spec, n): the imaginary parts of bins
// 0 and M are ignored).
//
// Replaces detex_tpu/ops/pallas_kernels.py irfft_ct_fused (:270, kernel
// body :236-266), which takes the hermitian extension [N, n] built by its
// caller and runs two 128 x 128 Cooley-Tukey matrix stages for the TPU's
// matrix unit. Here no hermitian extension is ever built: a block of M/32
// threads runs the inverse register-resident FFT of fft_regs.cuh
// (irfft_regs_row) on the stored half spectrum, 1/n folded into the read.
//
// Bound on the card: device-memory traffic (read n + 2, write n floats
// per row; ~2.5 n log2 n flops, far below the float32 peak). Design
// (fft_regs.cuh): every thread reads its bin pairs (k, M - k) straight into
// registers, neighbouring lanes on neighbouring bins in both directions,
// and packs them there; three register passes with two conflict-free
// exchanges through shared memory; the samples come back in registers and
// go out as float2 at z[t + r T], neighbouring lanes on neighbouring
// points; two rows resident per SM at n = 16384 (one at 32768), so one
// row's loads and stores run under the other's butterflies.
#pragma once

#include "fft_regs.cuh"

namespace detex {

// Bins V[k] of one stored half spectrum, scaled by 1/n on the read
// (irfft_regs_row's source: edge(k) is the real part of bin 0 or M)
struct ScaledSpectrum {
  const float2* v;
  float scale;
  __device__ __forceinline__ float2 operator()(int k) const {
    const float2 b = __ldg(&v[k]);
    return make_float2(b.x * scale, b.y * scale);
  }
  __device__ __forceinline__ float edge(int k) const {
    return __ldg(&v[k]).x * scale;
  }
};

template <int LOG2M>
__global__ void __launch_bounds__(RegsFft<LOG2M>::T,
                                  RegsFft<LOG2M>::kRowsPerSm)
irfft_ct_kernel(const float2* __restrict__ spec,
                const float2* __restrict__ stage,
                const float2* __restrict__ tw, float* __restrict__ out) {
  using P = RegsFft<LOG2M>;
  constexpr int M = P::M, T = P::T;
  extern __shared__ __align__(16) unsigned char smem[];
  const long long row = blockIdx.x;
  const int t = threadIdx.x;
  float2 x[32];
  // exact: 1/n is a power of two
  const ScaledSpectrum src{spec + row * (M + 1LL), 0.5f / M};
  irfft_regs_row<LOG2M>(t, src, tw, stage, reinterpret_cast<float2*>(smem),
                        BlockBarrier{}, x);
  float2* dst = reinterpret_cast<float2*>(out + row * (2LL * M));
#pragma unroll
  for (int r = 0; r < 32; ++r) dst[t + r * T] = x[r];
}

}  // namespace detex
