// C entry point of the ds_finalize_os_scan kernel (ds_finalize_os_scan.cuh),
// bound from Python with ctypes (detex_torch/ops/cuda_kernels.py). Launches
// on the given stream, does not synchronise, allocates nothing; ``hist``
// must be zeroed by the caller (the kernel adds to it). Returns the
// cudaError_t of the launch.
#include "ds_finalize_os_scan.cuh"

namespace {

template <int DC>
int launch_os_scan(const detex::OsFinArgs& args, cudaStream_t stream) {
  const size_t smem = (size_t)args.nbin * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      detex::ds_finalize_os_scan_kernel<DC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  detex::ds_finalize_os_scan_kernel<DC>
      <<<(unsigned)(args.S * args.m), detex::kOsFinThreads, smem,
         stream>>>(args);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int detex_ds_finalize_os_scan(
    const float* cb, const float* a, const float* pw, const float* su,
    const int* nv, float* ds, float* pyr, int* hist, long long S, int D,
    int m, int blk, int W, int head, int nbin, void* stream) {
  const detex::OsFinArgs args{cb, a, pw, su, nv, ds, pyr, hist,
                               S,  D, m,  blk, W, head, nbin};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (D) {
    case 1:
      return launch_os_scan<1>(args, st);
    case 2:
      return launch_os_scan<2>(args, st);
    case 3:
      return launch_os_scan<3>(args, st);
    case 4:
      return launch_os_scan<4>(args, st);
    default:
      return launch_os_scan<0>(args, st);
  }
}
