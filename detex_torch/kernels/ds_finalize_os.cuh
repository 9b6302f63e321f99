// ds_finalize_os: DS finalize of one chunk's raw overlap-save inverse blocks,
// without mask, maxima or histogram; one thread block per (template row, OS
// block).
//
// Replaces detex_tpu/ops/pallas_kernels.py ds_finalize_os (:701, kernel body
// :375-385), the finalize of ds_bank_demux_os (run_bank, run_bank_rows, the
// dense re-verify's per-chunk fallback) and of the per-chunk scan where the
// block is too wide for the scan form (W // 128 > 128). The arithmetic is
// finalize_os.cuh's without SCAN, with the one stats row a, power [m*W]
// every template row of the chunk shares.
//
// Bound on the card and design: as finalize_os.cuh.
#pragma once

#include "finalize_os.cuh"

namespace detex {

__global__ void __launch_bounds__(kFinThreads)
ds_finalize_os_kernel(const float* __restrict__ cb,
                      const float* __restrict__ a,
                      const float* __restrict__ pw,
                      const float* __restrict__ su, float* __restrict__ ds,
                      int D, int m, int blk, int W, int head) {
  finalize_os_block<false>(cb, a, pw, su, 0, ds, nullptr, nullptr,
                           blockIdx.x / m, 0, blockIdx.x % m, D, m, blk, W,
                           head, 0);
}

}  // namespace detex
