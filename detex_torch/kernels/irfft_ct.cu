// C entry point of the irfft_ct kernel (irfft_ct.cuh), bound from Python
// with ctypes (detex_torch/ops/cuda_kernels.py). Launches on the given
// stream, does not synchronise, allocates nothing; returns the cudaError_t
// of the launch. One form serves every N, as for rfft_ct.
#include "irfft_ct.cuh"

namespace {

template <int LOG2M>
int launch_irfft_ct(const float2* spec, const float2* stage,
                    const float2* tw, float* out, long long N,
                    cudaStream_t stream) {
  using P = detex::RegsFft<LOG2M>;
  cudaError_t err = cudaFuncSetAttribute(
      detex::irfft_ct_kernel<LOG2M>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  detex::irfft_ct_kernel<LOG2M>
      <<<(unsigned)N, P::T, P::kSmemBytes, stream>>>(spec, stage, tw, out);
  return (int)cudaGetLastError();
}

}  // namespace

// spec [N, 2^log2m + 1] complex (re, im pairs) -> out [N, 2^(log2m + 1)]
extern "C" int detex_irfft_ct(const float* spec, const float* stage,
                              const float* tw, float* out, long long N,
                              int log2m, void* stream) {
  const float2* spec2 = reinterpret_cast<const float2*>(spec);
  const float2* st2 = reinterpret_cast<const float2*>(stage);
  const float2* tw2 = reinterpret_cast<const float2*>(tw);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (log2m) {
    case 13:
      return launch_irfft_ct<13>(spec2, st2, tw2, out, N, st);
    case 14:
      return launch_irfft_ct<14>(spec2, st2, tw2, out, N, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
