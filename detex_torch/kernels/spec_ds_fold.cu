// C entry point of the spec_ds_fold kernel (spec_ds_fold.cuh), bound from
// Python with ctypes (detex_torch/ops/cuda_kernels.py). Launches on the
// given stream, does not synchronise, allocates nothing; ``hist`` must be
// zeroed by the caller (the kernel adds to it). Returns the cudaError_t of
// the launch.
#include "spec_ds_fold.cuh"

namespace {

template <int LOG2M, int NC>
int launch_spec_ds(const float* ur, const float* ui, const float* fr,
                   const float* fi, const float* a, const float* pw,
                   const float* su, const int* nv, const float2* stage,
                   const float2* tw, float* ds, float* pyr, int* hist, int B,
                   int S, int D, int nc, int m, int W, int head, int Rp,
                   int nbin, int sub, cudaStream_t stream) {
  using K = detex::SpecDs<LOG2M>;
  constexpr int M = 1 << LOG2M;
  // the groups of a block take templates when D == 1 (no accumulator),
  // else dims of one row
  const bool pair = K::NH > 1 && D == 1;
  const size_t smem = (size_t)K::NH * M * sizeof(float2) +
                      (pair ? 0 : (size_t)W * sizeof(float)) +
                      (size_t)K::NH * nbin * sizeof(int);
  const long long rows = pair ? (long long)B * ((S + K::NH - 1) / K::NH)
                              : (long long)B * S;
  cudaError_t err = cudaFuncSetAttribute(
      detex::spec_ds_fold_kernel<LOG2M, NC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(rows * m));
  const detex::SpecDsArgs args{ur, ui, fr, fi, a,  pw,  su, nv,   stage,
                               tw, ds, pyr, hist, B,  S,   D,  nc,   m,
                               W,  head, Rp, nbin, sub};
  detex::spec_ds_fold_kernel<LOG2M, NC>
      <<<grid, K::kThreads, smem, stream>>>(args);
  return (int)cudaGetLastError();
}

}  // namespace

// nc == 3 (three-component data) runs the form with the channel loop
// unrolled; any other count the general one
#define DETEX_SPEC_DS(L)                                                     \
  (nc == 3 ? launch_spec_ds<L, 3>(ur, ui, fr, fi, a, pw, su, nv, st2, tw2,   \
                                  ds, pyr, hist, B, S, D, nc, m, W, head,    \
                                  Rp, nbin, sub, st)                         \
           : launch_spec_ds<L, 0>(ur, ui, fr, fi, a, pw, su, nv, st2, tw2,   \
                                  ds, pyr, hist, B, S, D, nc, m, W, head,    \
                                  Rp, nbin, sub, st))

extern "C" int detex_spec_ds_fold(const float* ur, const float* ui,
                                  const float* fr, const float* fi,
                                  const float* a, const float* pw,
                                  const float* su, const int* nv,
                                  const float* stage, const float* tw,
                                  float* ds, float* pyr, int* hist, int B,
                                  int S, int D, int nc, int m, int W,
                                  int head, int Rp, int nbin, int sub,
                                  int log2m, void* stream) {
  const float2* st2 = reinterpret_cast<const float2*>(stage);
  const float2* tw2 = reinterpret_cast<const float2*>(tw);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (log2m) {
    case 13:
      return DETEX_SPEC_DS(13);
    case 14:
      return DETEX_SPEC_DS(14);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* detex_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
