// C entry point of the ds_finalize_os kernel (ds_finalize_os.cuh), bound
// from Python with ctypes (detex_torch/ops/cuda_kernels.py). Launches on the
// given stream, does not synchronise, allocates nothing; returns the
// cudaError_t of the launch.
#include "ds_finalize_os.cuh"

extern "C" int detex_ds_finalize_os(const float* cb, const float* a,
                                    const float* pw, const float* su,
                                    float* ds, long long S, int D, int m,
                                    int blk, int W, int head, void* stream) {
  detex::ds_finalize_os_kernel<<<(unsigned)(S * m), detex::kFinThreads, 0,
                                 reinterpret_cast<cudaStream_t>(stream)>>>(
      cb, a, pw, su, ds, D, m, blk, W, head);
  return (int)cudaGetLastError();
}
