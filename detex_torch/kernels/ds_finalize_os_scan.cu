// C entry point of the ds_finalize_os_scan kernel (ds_finalize_os_scan.cuh),
// bound from Python with ctypes (detex_torch/ops/cuda_kernels.py). Launches
// on the given stream, does not synchronise, allocates nothing; ``hist``
// must be zeroed by the caller (the kernel adds to it). Returns the
// cudaError_t of the launch.
#include "ds_finalize_os_scan.cuh"

extern "C" int detex_ds_finalize_os_scan(
    const float* cb, const float* a, const float* pw, const float* su,
    const int* nv, float* ds, float* pyr, int* hist, long long S, int D,
    int m, int blk, int W, int head, int nbin, void* stream) {
  const size_t smem = (size_t)nbin * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      detex::ds_finalize_os_scan_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  detex::ds_finalize_os_scan_kernel<<<(unsigned)(S * m), detex::kFinThreads,
                                      smem,
                                      reinterpret_cast<cudaStream_t>(
                                          stream)>>>(
      cb, a, pw, su, nv, ds, pyr, hist, D, m, blk, W, head, nbin);
  return (int)cudaGetLastError();
}
