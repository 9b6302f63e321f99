// C entry point of the rfft_ct kernel (rfft_ct.cuh), bound from Python with
// ctypes (detex_torch/ops/cuda_kernels.py). Launches on the given stream,
// does not synchronise, allocates nothing; returns the cudaError_t of the
// launch.
#include "rfft_ct.cuh"

namespace {

template <int LOG2M>
int launch_rfft_ct(const float* x, const float2* tw, float2* out,
                   long long N, cudaStream_t stream) {
  const size_t smem = (size_t)(1 << LOG2M) * sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(
      detex::rfft_ct_kernel<LOG2M>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  detex::rfft_ct_kernel<LOG2M>
      <<<(unsigned)N, detex::kThreads, smem, stream>>>(x, tw, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int detex_rfft_ct(const float* x, const float* tw, float* out,
                             long long N, int log2m, void* stream) {
  const float2* tw2 = reinterpret_cast<const float2*>(tw);
  float2* out2 = reinterpret_cast<float2*>(out);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (log2m) {
    case 13:
      return launch_rfft_ct<13>(x, tw2, out2, N, st);
    case 14:
      return launch_rfft_ct<14>(x, tw2, out2, N, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
