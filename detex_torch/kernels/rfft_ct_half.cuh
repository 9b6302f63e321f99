// rfft_ct_half: forward real DFT of the rows of x [N, n], n = 2M in
// {16384, 32768}, written as the padded half spectrum pair (fr, fi)
// [N, Rp]; one thread block per row.
//
// Replaces detex_tpu/ops/pallas_kernels.py rfft_ct_half (:1223, kernel body
// :1185-1220), the forward transform of the fused scan's unfused prep
// (dft.rfft_pair in ds.os_prep_batch_pair). There two 128 x 128 matrix
// stages emit Rp = n/2 + n/128 columns, bins past n/2 holding mirror
// values. Here the block runs rfft_ct's transform (fft.cuh: the row as M
// complex points, the Stockham FFT in shared memory, the split pass) and
// writes bins 0..M to fr / fi, zeros up to Rp: the layout fwd_prep_fold
// writes and spec_ds_fold reads.
//
// Bound on the card: device-memory traffic (read n floats, write 2 * Rp
// floats per row; the FFT is ~2.5 n log2 n flops) and the shared-memory
// passes of the FFT. Design: one row per block, as rfft_ct.
#pragma once

#include "fft.cuh"

namespace detex {

template <int LOG2M>
__global__ void __launch_bounds__(kThreads)
rfft_ct_half_kernel(const float* __restrict__ x,
                    const float2* __restrict__ tw, float* __restrict__ fr,
                    float* __restrict__ fi, int Rp) {
  constexpr int M = 1 << LOG2M;
  extern __shared__ __align__(16) unsigned char smem[];
  float2* z = reinterpret_cast<float2*>(smem);
  const long long r = blockIdx.x;
  const float2* src = reinterpret_cast<const float2*>(x + r * (2LL * M));
  for (int j = threadIdx.x; j < M; j += kThreads) z[j] = __ldg(&src[j]);
  fft_smem<LOG2M, false>(z, tw);
  float* outr = fr + r * Rp;
  float* outi = fi + r * Rp;
  for (int k = threadIdx.x; k < Rp; k += kThreads) {
    const float2 v =
        k <= M ? rfft_split<M>(z, tw, k) : make_float2(0.f, 0.f);
    outr[k] = v.x;
    outi[k] = v.y;
  }
}

}  // namespace detex
