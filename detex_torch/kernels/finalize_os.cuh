// finalize_os_block: the body of ds_finalize_os_fold (ds_finalize_os_fold.cuh;
// ds_finalize_os_scan and ds_finalize_os run on os_finalize_block in
// ds_finalize_os_scan.cuh):
// DS finalize of block i of one DS row r from its raw overlap-save inverse
// blocks. Row r has D basis rows r*D + d of cb [rows*D, m, blk]; block i
// covers DS positions p = i*W + t, t < W:
//
//   ds[r, p] = sum_d (cb[r*D + d, i, head + t] - su[r*D + d] * a[c, p])^2
//              / power[c, p]      (power 0 -> inf, so the quotient is 0)
//
// with stats row c of a, power [rows, m*W] (the callers pad them with
// a = 0, power = 1 past the valid output length, as detex_tpu's _os_block
// does), ds = -inf where p >= nv, the maximum of every 128-sample block in
// pyr and, for nbin > 0, floor-rule counts added to hist (zeroed by the
// caller): bin floor(v * nbin) in float32, v == 1.0 in the last bin,
// values outside [0, 1] and -inf dropped. A row's m blocks run as separate
// thread blocks; counts go to shared memory and then to the row's global
// counts with integer atomics (exact, order-free).
//
// Bound on the card: device-memory traffic (read D*W floats of cb and the
// two stats rows, write W DS values per block; ~3D + 2 flops a sample).
// Design: a warp takes 128-sample groups, each lane four samples 32 apart,
// so every load and store is coalesced and the group maximum is one warp
// reduction; no shared memory beyond the histogram.
#pragma once

#include <cuda_runtime.h>

namespace detex {

constexpr int kFinThreads = 256;

// Block i of DS row r, reading stats row c (a, pw [rows, m*W]) and valid
// length nvc.
__device__ __forceinline__ void finalize_os_block(
    const float* __restrict__ cb, const float* __restrict__ a,
    const float* __restrict__ pw, const float* __restrict__ su,
    long long nvc, float* __restrict__ ds, float* __restrict__ pyr,
    int* __restrict__ hist, long long r, long long c, int i, int D, int m,
    int blk, int W, int head, int nbin) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* hs = reinterpret_cast<int*>(smem);
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  for (int k = tid; k < nbin; k += nthr) hs[k] = 0;
  __syncthreads();
  const long long mW = (long long)m * W;
  const float* arow = a + c * mW + (long long)i * W;
  const float* prow = pw + c * mW + (long long)i * W;
  const float* cbr = cb + (r * D * m + i) * (long long)blk + head;
  const long long dstride = (long long)m * blk;   // basis row d -> d + 1
  float* drow = ds + r * mW + (long long)i * W;
  const int nb = W / 128;
  const int lane = tid & 31;
  for (int g = tid >> 5; g < nb; g += nthr >> 5) {
    float mx = -INFINITY;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int t = g * 128 + q * 32 + lane;
      const float av = arow[t];
      float acc = 0.f;
      for (int d = 0; d < D; ++d) {
        const float y = cbr[d * dstride + t] - su[r * D + d] * av;
        acc += y * y;
      }
      const float p = prow[t];
      float v = acc / (p == 0.f ? INFINITY : p);
      if ((long long)i * W + t >= nvc) v = -INFINITY;
      if (nbin) {
        float bin = floorf(v * (float)nbin);
        if (v == 1.0f) bin = (float)(nbin - 1);
        if (bin >= 0.f && bin < (float)nbin) atomicAdd(&hs[(int)bin], 1);
      }
      mx = fmaxf(mx, v);
      drow[t] = v;
    }
    for (int o = 16; o > 0; o >>= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    }
    if (lane == 0) pyr[r * m * (long long)nb + (long long)i * nb + g] = mx;
  }
  if (nbin) {
    __syncthreads();
    for (int k = tid; k < nbin; k += nthr) {
      if (hs[k]) atomicAdd(&hist[r * nbin + k], hs[k]);
    }
  }
}

}  // namespace detex
