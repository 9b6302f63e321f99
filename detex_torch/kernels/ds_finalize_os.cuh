// ds_finalize_os: DS finalize of one chunk's raw overlap-save inverse blocks,
// without mask, maxima or histogram; one thread block per (template row, OS
// block).
//
// Replaces detex_tpu/ops/pallas_kernels.py ds_finalize_os (:701, kernel body
// :375-385), the finalize of ds_bank_demux_os (run_bank, run_bank_rows, the
// dense re-verify's per-chunk fallback) and of the per-chunk scan where the
// block is too wide for the scan form (W // 128 > 128). It computes
// ds_finalize_os_scan's function without its mask, maxima and histogram,
// so it runs on that kernel's body (os_finalize_block in
// ds_finalize_os_scan.cuh) with SCAN = false: the one stats row a, power
// [m*W] every template row of the chunk shares, 16-byte loads issued
// before use, D a compile-time constant for 1..4, no shared memory, DS
// written with streaming stores (a D1 chunk's 192 MB of DS leaves the
// 50 MB L2 before the mask, maxima and histogram read it again).
//
// Bound on the card and design: as ds_finalize_os_scan.cuh.
#pragma once

#include "ds_finalize_os_scan.cuh"

namespace detex {

template <int DC>
__global__ void __launch_bounds__(kOsFinThreads)
ds_finalize_os_kernel(const OsFinArgs p) {
  os_finalize_block<DC, false>(p);
}

}  // namespace detex
