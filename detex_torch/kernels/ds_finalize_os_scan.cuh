// ds_finalize_os_scan: DS finalize of one chunk's raw overlap-save inverse
// blocks with the pad mask, 128-sample block maxima and the optional
// uniform histogram summed over the chunk's m blocks; one thread block per
// (template row, OS block).
//
// Replaces detex_tpu/ops/pallas_kernels.py ds_finalize_os_scan (:438,
// kernel body :388-434), the per-chunk route's finalize. The arithmetic is
// finalize_os.cuh's scan form with the one stats row a, power [m*W]
// every row shares and the chunk's valid length read from nv[0] on the
// device (the per-chunk loop passes it without a host sync).
//
// Bound on the card and design: as finalize_os.cuh.
#pragma once

#include "finalize_os.cuh"

namespace detex {

__global__ void __launch_bounds__(kFinThreads)
ds_finalize_os_scan_kernel(const float* __restrict__ cb,
                           const float* __restrict__ a,
                           const float* __restrict__ pw,
                           const float* __restrict__ su,
                           const int* __restrict__ nv,
                           float* __restrict__ ds, float* __restrict__ pyr,
                           int* __restrict__ hist, int D, int m, int blk,
                           int W, int head, int nbin) {
  finalize_os_block<true>(cb, a, pw, su, nv[0], ds, pyr, hist,
                          blockIdx.x / m, 0, blockIdx.x % m, D, m, blk, W,
                          head, nbin);
}

}  // namespace detex
