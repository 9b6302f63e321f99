// C entry point of the rfft_ct_half kernel (rfft_ct_half.cuh), bound from
// Python with ctypes (detex_torch/ops/cuda_kernels.py). Launches on the
// given stream, does not synchronise, allocates nothing; returns the
// cudaError_t of the launch.
#include "rfft_ct_half.cuh"

namespace {

template <int LOG2M>
int launch_rfft_ct_half(const float* x, const float2* tw, float* fr,
                        float* fi, long long N, int Rp, cudaStream_t stream) {
  const size_t smem = (size_t)(1 << LOG2M) * sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(
      detex::rfft_ct_half_kernel<LOG2M>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  detex::rfft_ct_half_kernel<LOG2M>
      <<<(unsigned)N, detex::kThreads, smem, stream>>>(x, tw, fr, fi, Rp);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int detex_rfft_ct_half(const float* x, const float* tw, float* fr,
                                  float* fi, long long N, int Rp, int log2m,
                                  void* stream) {
  const float2* tw2 = reinterpret_cast<const float2*>(tw);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (log2m) {
    case 13:
      return launch_rfft_ct_half<13>(x, tw2, fr, fi, N, Rp, st);
    case 14:
      return launch_rfft_ct_half<14>(x, tw2, fr, fi, N, Rp, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
