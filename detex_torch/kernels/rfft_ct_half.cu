// C entry point of the rfft_ct_half kernel (rfft_ct_half.cuh), bound from
// Python with ctypes (detex_torch/ops/cuda_kernels.py). Launches on the
// given stream, does not synchronise, allocates nothing; returns the
// cudaError_t of the launch. One form serves every N, as rfft_ct.cu.
#include "rfft_ct_half.cuh"

namespace {

template <int LOG2M>
int launch_rfft_ct_half(const float* x, long long Lp, int m, int W,
                        const float2* stage, const float2* tw, float* fr,
                        float* fi, long long N, int Rp,
                        cudaStream_t stream) {
  using P = detex::RegsFft<LOG2M>;
  cudaError_t err = cudaFuncSetAttribute(
      detex::rfft_ct_half_kernel<LOG2M>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  detex::rfft_ct_half_kernel<LOG2M>
      <<<(unsigned)N, P::T, P::kSmemBytes, stream>>>(x, Lp, m, W, stage, tw,
                                                     fr, fi, Rp);
  return (int)cudaGetLastError();
}

}  // namespace

// x: rows of Lp floats, each cut into m frames of 2^(log2m + 1) samples at
// stride W; N = rows * m transforms
extern "C" int detex_rfft_ct_half(const float* x, const float* stage,
                                  const float* tw, float* fr, float* fi,
                                  long long N, long long Lp, int m, int W,
                                  int Rp, int log2m, void* stream) {
  const float2* st2 = reinterpret_cast<const float2*>(stage);
  const float2* tw2 = reinterpret_cast<const float2*>(tw);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (log2m) {
    case 13:
      return launch_rfft_ct_half<13>(x, Lp, m, W, st2, tw2, fr, fi, N, Rp,
                                     st);
    case 14:
      return launch_rfft_ct_half<14>(x, Lp, m, W, st2, tw2, fr, fi, N, Rp,
                                     st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
