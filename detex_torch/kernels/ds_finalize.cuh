// ds_finalize: DS finalize of a full-length bank; one thread block per
// (template row, tile of kDsFinTile positions).
//
// Replaces detex_tpu/ops/pallas_kernels.py ds_finalize (:104, kernel body
// :91-100), the finalize of ds_bank_demux (ops/ds.py) and of the device-prep
// raw path ds_bank_demux_raw (ops/prep.py). Per output (s, t):
//
//   ds[s, t] = sum_d (cc[s, d, t] - su[s, d] * a[t])^2 / power[t]
//
// cc [S, D, L] (L = L_c - n_c + 1, any length), a, power [L] (the caller
// makes power safe: inf where it is 0, so the quotient is 0), su [S, D]
// (0 on masked basis slots, whose cc rows are 0). The TPU kernel pads L to
// its lane tile with power 1 and slices the pad off; here the ragged last
// tile is masked instead, nothing is padded.
//
// Bound on the card: device-memory traffic (read S*D*L floats of cc and the
// two stats rows, write S*L; 3D + 1 flops a sample). Design: threads run
// along t, so every cc load and ds store is coalesced; the sum over D stays
// in a register; a thread takes kDsFinTile / kDsFinThreads positions of its
// tile, kDsFinThreads apart.
#pragma once

#include <cuda_runtime.h>

namespace detex {

constexpr int kDsFinThreads = 256;
constexpr int kDsFinTile = 1024;

__global__ void __launch_bounds__(kDsFinThreads)
ds_finalize_kernel(const float* __restrict__ cc, const float* __restrict__ a,
                   const float* __restrict__ pw, const float* __restrict__ su,
                   float* __restrict__ ds, int D, long long L, int tiles) {
  const long long s = blockIdx.x / tiles;
  const long long lo = (long long)(blockIdx.x % tiles) * kDsFinTile;
  const float* ccs = cc + s * D * L;
  const float* sus = su + s * D;
  for (int k = 0; k < kDsFinTile / kDsFinThreads; ++k) {
    const long long t = lo + k * kDsFinThreads + threadIdx.x;
    if (t >= L) break;
    const float av = a[t];
    float acc = 0.f;
    for (int d = 0; d < D; ++d) {
      const float y = ccs[d * L + t] - sus[d] * av;
      acc += y * y;
    }
    ds[s * L + t] = acc / pw[t];
  }
}

}  // namespace detex
