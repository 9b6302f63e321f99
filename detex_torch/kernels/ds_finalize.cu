// C entry point of the ds_finalize kernel (ds_finalize.cuh), bound from
// Python with ctypes (detex_torch/ops/cuda_kernels.py). Launches on the given
// stream, does not synchronise, allocates nothing; returns the cudaError_t of
// the launch.
#include "ds_finalize.cuh"

extern "C" int detex_ds_finalize(const float* cc, const float* a,
                                 const float* pw, const float* su, float* ds,
                                 long long S, int D, long long L,
                                 void* stream) {
  const int tiles = (int)((L + detex::kDsFinTile - 1) / detex::kDsFinTile);
  detex::ds_finalize_kernel<<<(unsigned)(S * tiles), detex::kDsFinThreads, 0,
                              reinterpret_cast<cudaStream_t>(stream)>>>(
      cc, a, pw, su, ds, D, L, tiles);
  return (int)cudaGetLastError();
}
