// ds_finalize_os_fold: DS finalize of a chunk batch's raw overlap-save
// inverse blocks, pad mask, 128-sample block maxima and uniform histogram;
// one thread block per (row, OS block).
//
// Replaces detex_tpu/ops/pallas_kernels.py ds_finalize_os_fold (:575,
// kernel body :499-550). Row r is a (chunk, template) pair; the arithmetic
// is finalize_os.cuh's (its only user), with stats row c = r / group of a,
// power [BS/group, m*W] and valid length nv[c] [BS/group]: group = 1 gives
// every row its own stats, group = S lets a chunk's S template rows share
// one.
//
// Bound on the card and design: as finalize_os.cuh.
#pragma once

#include "finalize_os.cuh"

namespace detex {

__global__ void __launch_bounds__(kFinThreads)
ds_finalize_os_fold_kernel(const float* __restrict__ cb,
                           const float* __restrict__ a,
                           const float* __restrict__ pw,
                           const float* __restrict__ su,
                           const int* __restrict__ nv,
                           float* __restrict__ ds, float* __restrict__ pyr,
                           int* __restrict__ hist, int D, int m, int blk,
                           int W, int head, int group, int nbin) {
  const long long r = blockIdx.x / m;
  const long long c = r / group;
  finalize_os_block(cb, a, pw, su, nv[c], ds, pyr, hist, r, c, blockIdx.x % m,
                    D, m, blk, W, head, nbin);
}

}  // namespace detex
