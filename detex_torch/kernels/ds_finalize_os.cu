// C entry point of the ds_finalize_os kernel (ds_finalize_os.cuh), bound
// from Python with ctypes (detex_torch/ops/cuda_kernels.py). Launches on the
// given stream, does not synchronise, allocates nothing; returns the
// cudaError_t of the launch. cb, a and pw must start on 16-byte boundaries
// and head be a multiple of 4 (the kernel loads four positions at once).
#include "ds_finalize_os.cuh"

namespace {

template <int DC>
int launch_os(const detex::OsFinArgs& args, cudaStream_t stream) {
  detex::ds_finalize_os_kernel<DC>
      <<<(unsigned)(args.S * args.m), detex::kOsFinThreads, 0, stream>>>(
          args);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int detex_ds_finalize_os(const float* cb, const float* a,
                                    const float* pw, const float* su,
                                    float* ds, long long S, int D, int m,
                                    int blk, int W, int head, void* stream) {
  const detex::OsFinArgs args{cb, a, pw, su, nullptr, ds, nullptr, nullptr,
                              S,  D, m,  blk, W, head, 0};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (D) {
    case 1:
      return launch_os<1>(args, st);
    case 2:
      return launch_os<2>(args, st);
    case 3:
      return launch_os<3>(args, st);
    case 4:
      return launch_os<4>(args, st);
    default:
      return launch_os<0>(args, st);
  }
}
