// Shared device helpers of the kernels: a complex multiply, a block-wide
// exclusive scan and per-thread histogram run counts. The block transforms
// themselves run on the register-resident FFT core of fft_regs.cuh.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace detex {

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// Block-wide exclusive scan of one value per thread (exact for integer T).
// ``sh`` is 32 values of shared scratch. Contains __syncthreads(); every
// thread of the block must call it.
template <class T>
__device__ __forceinline__ void block_exclusive_scan(T& v, T* sh) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarp = blockDim.x >> 5;
  T inc = v;
  for (int o = 1; o < 32; o <<= 1) {
    const T t = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += t;
  }
  if (lane == 31) sh[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    T w = lane < nwarp ? sh[lane] : T(0);
    for (int o = 1; o < 32; o <<= 1) {
      const T t = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += t;
    }
    sh[lane] = w;
  }
  __syncthreads();
  v = (warp > 0 ? sh[warp - 1] : T(0)) + inc - v;
  __syncthreads();
}

// Histogram counts of one thread: noise puts nearly every sample of a block
// into one bin, where shared-memory atomics would queue, so a thread counts
// a run of equal bins in a register and adds it once.
struct BinRun {
  int* hs;
  int nbin;
  int bin = -1, run = 0;
  __device__ __forceinline__ BinRun(int* hs_, int nbin_)
      : hs(hs_), nbin(nbin_) {}
  __device__ __forceinline__ void count(float v) {
    float b = floorf(v * (float)nbin);
    if (v == 1.0f) b = (float)(nbin - 1);
    const int ib = b >= 0.f && b < (float)nbin ? (int)b : -1;
    if (ib != bin) {
      flush();
      bin = ib;
    }
    run += ib >= 0;
  }
  __device__ __forceinline__ void flush() {
    if (run) atomicAdd(&hs[bin], run);
    run = 0;
  }
};

}  // namespace detex
