// C entry point of the fwd_prep_fold kernel (fwd_prep_fold.cuh), bound from
// Python with ctypes (detex_torch/ops/cuda_kernels.py). Launches on the
// given stream, does not synchronise, allocates nothing; returns the
// cudaError_t of the launch.
#include "fwd_prep_fold.cuh"

namespace {

template <int LOG2M>
int launch_fwd_prep(const float* xq, const float2* stage, const float2* tw,
                    float* fr, float* fi, float* a, float* pw, int B, int nc,
                    long long Lp, int m, int W, int D0, int pad0, int n_c,
                    long long out_len, int Rp, cudaStream_t stream) {
  using P = detex::PrepFold<LOG2M>;
  cudaError_t err = cudaFuncSetAttribute(
      detex::fwd_prep_fold_kernel<LOG2M>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((long long)B * m));
  detex::fwd_prep_fold_kernel<LOG2M><<<grid, P::T, P::kSmemBytes, stream>>>(
      xq, stage, tw, fr, fi, a, pw, nc, Lp, m, W, D0, pad0, n_c, out_len, Rp);
  return (int)cudaGetLastError();
}

}  // namespace

// xq rows of Lp floats must start on 16-byte boundaries (Lp % 4 == 0, the
// base aligned): the transforms read the frames 16 bytes a lane
extern "C" int detex_fwd_prep_fold(const float* xq, const float* stage,
                                   const float* tw, float* fr, float* fi,
                                   float* a, float* pw, int B, int nc,
                                   long long Lp, int m, int W, int D0,
                                   int pad0, int n_c, long long out_len,
                                   int Rp, int log2m, void* stream) {
  const float2* st2 = reinterpret_cast<const float2*>(stage);
  const float2* tw2 = reinterpret_cast<const float2*>(tw);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (log2m) {
    case 13:
      return launch_fwd_prep<13>(xq, st2, tw2, fr, fi, a, pw, B, nc, Lp, m, W,
                                 D0, pad0, n_c, out_len, Rp, st);
    case 14:
      return launch_fwd_prep<14>(xq, st2, tw2, fr, fi, a, pw, B, nc, Lp, m, W,
                                 D0, pad0, n_c, out_len, Rp, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
