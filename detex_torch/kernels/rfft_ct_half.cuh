// rfft_ct_half: forward real DFT of float32 rows of n = 2M samples, n in
// {16384, 32768}, written as the padded half spectrum pair (fr, fi)
// [N, Rp]; one thread block per row.
//
// Replaces detex_tpu/ops/pallas_kernels.py rfft_ct_half (:1223, kernel body
// :1185-1220), the forward transform of the fused scan's unfused prep
// (dft.rfft_pair_frames in ds.os_prep_batch_pair). There two 128 x 128
// matrix stages emit Rp = n/2 + n/128 columns, bins past n/2 holding mirror
// values. Here the block runs rfft_ct's transform (fft_regs.cuh: the row
// as M complex points, the register-resident FFT, the paired split pass)
// and writes bins 0..M to fr / fi, zeros up to Rp: the layout
// fwd_prep_fold writes and spec_ds_fold reads.
//
// Bound on the card: device-memory traffic (read n floats, write 2 * Rp
// floats per row; the FFT is ~2.5 n log2 n flops). Design as rfft_ct: the
// row read 16 bytes a lane straight into registers, three register passes
// with two conflict-free exchanges, coalesced per-stage roots, both bins
// of a pair from one read, two rows resident per SM at n = 16384 (one at
// 32768), frames of a padded chunk batch read in place. Each lane stores
// 4 bytes per instruction to fr and to fi, neighbouring lanes neighbouring
// bins; the Rp - M - 1 zeros of the pad have their own short loop.
#pragma once

#include "fft_regs.cuh"

namespace detex {

template <int LOG2M>
__global__ void __launch_bounds__(RegsFft<LOG2M>::T,
                                  RegsFft<LOG2M>::kRowsPerSm)
rfft_ct_half_kernel(const float* __restrict__ x, long long Lp, int m, int W,
                    const float2* __restrict__ stage,
                    const float2* __restrict__ tw, float* __restrict__ fr,
                    float* __restrict__ fi, int Rp) {
  constexpr int M = 1 << LOG2M;
  extern __shared__ __align__(16) unsigned char smem[];
  float2* z = reinterpret_cast<float2*>(smem);
  const long long row = blockIdx.x;
  float* outr = fr + row * Rp;
  float* outi = fi + row * Rp;
  for (int k = M + 1 + threadIdx.x; k < Rp; k += RegsFft<LOG2M>::T) {
    outr[k] = 0.f;
    outi[k] = 0.f;
  }
  fft_regs_row<LOG2M>(frame_start(x, row, Lp, m, W), stage, z);
  rfft_split_pairs<LOG2M>(z, tw, StorePair{outr, outi});
}

}  // namespace detex
