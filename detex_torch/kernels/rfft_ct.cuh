// rfft_ct: forward real DFT of float32 rows of n = 2M samples, n in
// {16384, 32768}, as complex64 [N, M + 1]; one thread block per row.
//
// Replaces detex_tpu/ops/pallas_kernels.py rfft_ct_fused (:336, kernel body
// :309-332), which runs the transform as two 128 x 128 Cooley-Tukey matrix
// stages for the TPU's matrix unit and emits the full-width (fr, fi) pair
// of which its callers keep bins 0..n/2. Here a block of M/32 threads runs
// the register-resident FFT of fft_regs.cuh on the row as M complex points
// and writes only the kept bins, X[0..M], as interleaved complex values
// (out [N, M + 1] float2, which PyTorch views as complex64).
//
// Bound on the card: device-memory traffic (read n floats, write n + 2
// floats per row; the FFT is ~2.5 n log2 n flops, far below the float32
// peak at these sizes). Design (fft_regs.cuh): the row goes from device
// memory to registers 16 bytes a lane, three register passes with two
// conflict-free exchanges through shared memory, coalesced per-stage roots
// of unity, a split pass that makes bins k and M-k from one read, and two
// rows resident per SM at n = 16384 (one at 32768) so that one row's
// loads and stores run under the other's butterflies. The source may be
// framed: row r m + f starts at x + r Lp + f W, so overlapping frames of a
// padded chunk batch are read in place (contiguous [N, n]: m = 1, Lp = n).
// Each lane stores one 8-byte bin per instruction, neighbouring lanes
// neighbouring bins: rows of M + 1 bins start on 8-byte boundaries only.
#pragma once

#include "fft_regs.cuh"

namespace detex {

struct StoreComplex {
  float2* dst;
  __device__ __forceinline__ void operator()(int k, float2 v) const {
    dst[k] = v;
  }
};

template <int LOG2M>
__global__ void __launch_bounds__(RegsFft<LOG2M>::T,
                                  RegsFft<LOG2M>::kRowsPerSm)
rfft_ct_kernel(const float* __restrict__ x, long long Lp, int m, int W,
               const float2* __restrict__ stage,
               const float2* __restrict__ tw, float2* __restrict__ out) {
  constexpr int M = 1 << LOG2M;
  extern __shared__ __align__(16) unsigned char smem[];
  float2* z = reinterpret_cast<float2*>(smem);
  const long long row = blockIdx.x;
  fft_regs_row<LOG2M>(frame_start(x, row, Lp, m, W), stage, z);
  rfft_split_pairs<LOG2M>(z, tw, StoreComplex{out + row * (M + 1LL)});
}

}  // namespace detex
