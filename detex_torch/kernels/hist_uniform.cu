// C entry point of the hist_uniform kernel (hist_uniform.cuh), bound from
// Python with ctypes (detex_torch/ops/cuda_kernels.py). Launches on the
// given stream, does not synchronise, allocates nothing; ``hist`` must be
// zeroed by the caller (the kernel adds to it). Returns the cudaError_t of
// the launch.
#include "hist_uniform.cuh"

extern "C" int detex_hist_uniform(const float* ds, int* hist, long long S,
                                  long long L, int nbin, void* stream) {
  const size_t smem = (size_t)nbin * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      detex::hist_uniform_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (int)((L + detex::kHistTile - 1) / detex::kHistTile);
  detex::hist_uniform_kernel<<<(unsigned)(S * tiles), detex::kHistThreads,
                               smem,
                               reinterpret_cast<cudaStream_t>(stream)>>>(
      ds, hist, L, tiles, nbin);
  return (int)cudaGetLastError();
}
