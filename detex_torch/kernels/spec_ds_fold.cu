// C entry point of the spec_ds_fold kernel (spec_ds_fold.cuh), bound from
// Python with ctypes (detex_torch/ops/cuda_kernels.py). Launches on the
// given stream, does not synchronise, allocates nothing; ``hist`` must be
// zeroed by the caller (the kernel adds to it). Returns the cudaError_t of
// the launch.
#include "spec_ds_fold.cuh"

namespace {

template <int LOG2M>
int launch_spec_ds(const float* ur, const float* ui, const float* fr,
                   const float* fi, const float* a, const float* pw,
                   const float* su, const int* nv, const float2* tw,
                   float* ds, float* pyr, int* hist, int B, int S, int D,
                   int nc, int m, int W, int head, int Rp, int nbin, int sub,
                   cudaStream_t stream) {
  constexpr int M = 1 << LOG2M;
  const size_t smem = (size_t)M * sizeof(float2) + (size_t)W * sizeof(float) +
                      (size_t)nbin * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      detex::spec_ds_fold_kernel<LOG2M>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((long long)B * S * m));
  detex::spec_ds_fold_kernel<LOG2M><<<grid, detex::kThreads, smem, stream>>>(
      ur, ui, fr, fi, a, pw, su, nv, tw, ds, pyr, hist, B, S, D, nc, m, W,
      head, Rp, nbin, sub);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int detex_spec_ds_fold(const float* ur, const float* ui,
                                  const float* fr, const float* fi,
                                  const float* a, const float* pw,
                                  const float* su, const int* nv,
                                  const float* tw, float* ds, float* pyr,
                                  int* hist, int B, int S, int D, int nc,
                                  int m, int W, int head, int Rp, int nbin,
                                  int sub, int log2m, void* stream) {
  const float2* tw2 = reinterpret_cast<const float2*>(tw);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (log2m) {
    case 13:
      return launch_spec_ds<13>(ur, ui, fr, fi, a, pw, su, nv, tw2, ds, pyr,
                                hist, B, S, D, nc, m, W, head, Rp, nbin, sub,
                                st);
    case 14:
      return launch_spec_ds<14>(ur, ui, fr, fi, a, pw, su, nv, tw2, ds, pyr,
                                hist, B, S, D, nc, m, W, head, Rp, nbin, sub,
                                st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* detex_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
