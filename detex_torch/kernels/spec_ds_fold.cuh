// spec_ds_fold: channel cross-spectra, inverse real DFT, DS finalize, pad
// mask, 128-sample block maxima and uniform histogram of the overlap-save
// scan, one thread block per (row, block).
//
// Replaces detex_tpu/ops/pallas_kernels.py spec_ds_fold (:1038, kernel body
// :782-981). Row r is (chunk b, template s) in mode "net" (r = b*S + s) and
// (s, b) in mode "sub" (r = s*B + b). For each basis dim d the block forms
// Y[k] = sum_c U[d,s,c,k] * F[b,c,i,k] over bins 0..blk/2 (the template
// spectra carry the inverse weights c_k/blk, ops/ds.py bank_spec_pair),
// inverts it to x[0, blk), keeps x[head : head+W], forms y = x - sum_u*a and
// accumulates y^2 in shared memory (registers stay free for the FFT). After
// the last d: ds = acc / power, -inf
// at positions >= nv, the per-128-sample maxima, and the floor-rule
// histogram, counted in shared memory and added to the row's global counts
// (the row's m blocks run as separate thread blocks; integer atomics keep
// the counts exact and order-free).
//
// Bound on the card: shared-memory bandwidth of one M = blk/2 point complex
// FFT per (row, block, d); device memory reads U and F spectra (2 * nc * Rp
// floats each), most from L2 since D dims reread the same F. With
// emit_ds = 0 (summary-only scan) the DS array is never written: only pyr
// and hist leave the block.
#pragma once

#include "fft.cuh"

namespace detex {

template <int LOG2M>
__global__ void __launch_bounds__(kThreads)
spec_ds_fold_kernel(const float* __restrict__ ur, const float* __restrict__ ui,
                    const float* __restrict__ fr, const float* __restrict__ fi,
                    const float* __restrict__ a, const float* __restrict__ pw,
                    const float* __restrict__ su, const int* __restrict__ nv,
                    const float2* __restrict__ tw,
                    float* __restrict__ ds, float* __restrict__ pyr,
                    int* __restrict__ hist,
                    int B, int S, int D, int nc, int m, int W, int head, int Rp,
                    int nbin, int sub) {
  constexpr int M = 1 << LOG2M;
  constexpr int JPT = M / kThreads;   // complex outputs per thread
  extern __shared__ __align__(16) unsigned char smem[];
  float2* z = reinterpret_cast<float2*>(smem);
  float* dss = reinterpret_cast<float*>(smem);     // reused after the last d
  float* acc = reinterpret_cast<float*>(smem + (size_t)M * sizeof(float2));
  int* hs = reinterpret_cast<int*>(acc + W);
  const int tid = threadIdx.x;
  const long long r = blockIdx.x / m;
  const int i = blockIdx.x % m;
  long long b, s;
  if (sub) {
    s = r / B;
    b = r % B;
  } else {
    b = r / S;
    s = r % S;
  }
  for (int k = tid; k < nbin; k += kThreads) hs[k] = 0;
  for (int t = tid; t < W; t += kThreads) acc[t] = 0.f;
  const long long frow = (long long)m * Rp;
  const float* arow = a + b * m * (long long)W + (long long)i * W;
  const float* prow = pw + b * m * (long long)W + (long long)i * W;

  for (int d = 0; d < D; ++d) {
    const float sud = su[(long long)d * S + s];
    const float* urd = ur + ((long long)d * S + s) * nc * Rp;
    const float* uid = ui + ((long long)d * S + s) * nc * Rp;
    // cross-spectra of the bin pair (k, M-k), packed for the M-point inverse
    for (int k = tid; k <= M / 2; k += kThreads) {
      const int k2 = M - k;
      float y1r = 0.f, y1i = 0.f, y2r = 0.f, y2i = 0.f;
      for (int c = 0; c < nc; ++c) {
        const long long uo = (long long)c * Rp;
        const long long fo = (b * nc + c) * frow + (long long)i * Rp;
        float ar = urd[uo + k], ai = uid[uo + k];
        float br = fr[fo + k], bi = fi[fo + k];
        y1r += ar * br - ai * bi;
        y1i += ar * bi + ai * br;
        ar = urd[uo + k2];
        ai = uid[uo + k2];
        br = fr[fo + k2];
        bi = fi[fo + k2];
        y2r += ar * br - ai * bi;
        y2i += ar * bi + ai * br;
      }
      // V = Y / c_k: c_0 = c_M = 1 (imaginary parts dropped), else 2
      float2 v1, v2;
      if (k == 0) {
        v1 = make_float2(y1r, 0.f);
        v2 = make_float2(y2r, 0.f);
      } else {
        v1 = make_float2(0.5f * y1r, 0.5f * y1i);
        v2 = make_float2(0.5f * y2r, 0.5f * y2i);
      }
      z[k] = irfft_pack(v1, v2, __ldg(&tw[k]));
      if (k != 0 && k != M / 2) z[k2] = irfft_pack(v2, v1, __ldg(&tw[k2]));
    }
    fft_smem<LOG2M, true>(z, tw);
    // z[j] = x[2j] + i x[2j+1]; keep t = 2j + e - head in [0, W)
#pragma unroll
    for (int q = 0; q < JPT; ++q) {
      const int j = tid + q * kThreads;
      const float2 v = z[j];
      const int p = 2 * j - head;
      if (p >= 0 && p < W) {
        const float y = v.x - sud * arow[p];
        acc[p] += y * y;
      }
      if (p + 1 >= 0 && p + 1 < W) {
        const float y = v.y - sud * arow[p + 1];
        acc[p + 1] += y * y;
      }
    }
    __syncthreads();
  }

  // finalize: divide, mask, histogram; stage the block's DS in shared memory
  // (each thread reads back only the accumulator entries it wrote)
  const long long nvb = nv[b];
#pragma unroll
  for (int q = 0; q < JPT; ++q) {
    const int j = tid + q * kThreads;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int p = 2 * j + e - head;
      if (p < 0 || p >= W) continue;
      float v = acc[p] / prow[p];
      if ((long long)i * W + p >= nvb) v = -INFINITY;
      dss[p] = v;
      if (nbin) {
        float bin = floorf(v * (float)nbin);
        if (v == 1.0f) bin = (float)(nbin - 1);
        if (bin >= 0.f && bin < (float)nbin) atomicAdd(&hs[(int)bin], 1);
      }
    }
  }
  __syncthreads();
  if (ds) {
    float* drow = ds + r * m * (long long)W + (long long)i * W;
    for (int t = tid; t < W; t += kThreads) drow[t] = dss[t];
  }
  const int nb = W / 128;
  const int lane = tid & 31;
  for (int g = tid >> 5; g < nb; g += kThreads / 32) {
    const float* v = dss + g * 128;
    float mx = fmaxf(fmaxf(v[lane], v[lane + 32]), fmaxf(v[lane + 64], v[lane + 96]));
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (lane == 0) pyr[r * m * (long long)nb + (long long)i * nb + g] = mx;
  }
  for (int k = tid; k < nbin; k += kThreads) {
    if (hs[k]) atomicAdd(&hist[r * nbin + k], hs[k]);
  }
}

}  // namespace detex
