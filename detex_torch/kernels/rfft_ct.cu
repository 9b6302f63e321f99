// C entry point of the rfft_ct kernel (rfft_ct.cuh), bound from Python with
// ctypes (detex_torch/ops/cuda_kernels.py). Launches on the given stream,
// does not synchronise, allocates nothing; returns the cudaError_t of the
// launch. Rule for small N: there is one form, a block of M/32 threads a
// row whatever the number of rows. Under one wave of an H100 (84 rows of
// 16,384, 42 rows of 32,768) it measured 2.2x and 2.6x faster than the
// 1,024-thread block it replaced (PERF.md), so no wider form exists.
#include "rfft_ct.cuh"

namespace {

template <int LOG2M>
int launch_rfft_ct(const float* x, long long Lp, int m, int W,
                   const float2* stage, const float2* tw, float2* out,
                   long long N, cudaStream_t stream) {
  using P = detex::RegsFft<LOG2M>;
  cudaError_t err = cudaFuncSetAttribute(
      detex::rfft_ct_kernel<LOG2M>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  detex::rfft_ct_kernel<LOG2M>
      <<<(unsigned)N, P::T, P::kSmemBytes, stream>>>(x, Lp, m, W, stage, tw,
                                                     out);
  return (int)cudaGetLastError();
}

}  // namespace

// x: rows of Lp floats, each cut into m frames of 2^(log2m + 1) samples at
// stride W; N = rows * m transforms
extern "C" int detex_rfft_ct(const float* x, const float* stage,
                             const float* tw, float* out, long long N,
                             long long Lp, int m, int W, int log2m,
                             void* stream) {
  const float2* st2 = reinterpret_cast<const float2*>(stage);
  const float2* tw2 = reinterpret_cast<const float2*>(tw);
  float2* out2 = reinterpret_cast<float2*>(out);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (log2m) {
    case 13:
      return launch_rfft_ct<13>(x, Lp, m, W, st2, tw2, out2, N, st);
    case 14:
      return launch_rfft_ct<14>(x, Lp, m, W, st2, tw2, out2, N, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
