// Host build of the fused overlap-save kernels for checking them without a
// GPU: g++ -std=c++20 -O2 -shared -fPIC -I<this dir> -I<kernels dir>
// emulate.cpp. Entry points take host pointers and the arguments of the
// CUDA entry points (blk = 16384 or 32768) and run every thread block of
// the grid in turn.
#include <functional>
#include <thread>
#include <vector>

#include "cuda_runtime.h"

thread_local dim3e threadIdx;
dim3e blockIdx, blockDim;
std::barrier<>* emu_block_barrier;
EmuWarp emu_warps[32];
namespace detex {
alignas(16) unsigned char smem[232448];  // the H100 per-block maximum
}

#include "fwd_prep_fold.cuh"
#include "spec_ds_fold.cuh"

namespace {

void run_grid(long long nblocks, const std::function<void()>& body) {
  const int T = detex::kThreads;
  blockDim = {(unsigned)T, 1, 1};
  std::barrier<> bar(T);
  emu_block_barrier = &bar;
  std::vector<std::barrier<>*> warp_bars;
  for (int w = 0; w < T / 32; ++w) {
    emu_warps[w].bar = new std::barrier<>(32);
    warp_bars.push_back(emu_warps[w].bar);
  }
  for (long long b = 0; b < nblocks; ++b) {
    blockIdx = {(unsigned)b, 0, 0};
    std::memset(detex::smem, 0xff, sizeof(detex::smem));  // stale smem = NaN
    std::vector<std::thread> threads;
    for (int t = 0; t < T; ++t) {
      threads.emplace_back([t, &body] {
        threadIdx = {(unsigned)t, 0, 0};
        body();
      });
    }
    for (auto& th : threads) th.join();
  }
  for (auto* p : warp_bars) delete p;
}

}  // namespace

extern "C" int emu_fwd_prep_fold(const float* xq, const float* tw, float* fr,
                                 float* fi, float* a, float* pw, int B, int nc,
                                 long long Lp, int m, int W, int D0, int pad0,
                                 int n_c, long long out_len, int Rp,
                                 int log2m) {
  const float2* tw2 = reinterpret_cast<const float2*>(tw);
  if (log2m != 13 && log2m != 14) return 1;
  run_grid((long long)B * m, [=] {
    if (log2m == 13) {
      detex::fwd_prep_fold_kernel<13>(xq, tw2, fr, fi, a, pw, nc, Lp, m, W,
                                      D0, pad0, n_c, out_len, Rp);
    } else {
      detex::fwd_prep_fold_kernel<14>(xq, tw2, fr, fi, a, pw, nc, Lp, m, W,
                                      D0, pad0, n_c, out_len, Rp);
    }
  });
  return 0;
}

extern "C" int emu_spec_ds_fold(const float* ur, const float* ui,
                                const float* fr, const float* fi,
                                const float* a, const float* pw,
                                const float* su, const int* nv,
                                const float* tw, float* ds, float* pyr,
                                int* hist, int B, int S, int D, int nc, int m,
                                int W, int head, int Rp, int nbin, int sub,
                                int log2m) {
  const float2* tw2 = reinterpret_cast<const float2*>(tw);
  if (log2m != 13 && log2m != 14) return 1;
  run_grid((long long)B * S * m, [=] {
    if (log2m == 13) {
      detex::spec_ds_fold_kernel<13>(ur, ui, fr, fi, a, pw, su, nv, tw2, ds,
                                     pyr, hist, B, S, D, nc, m, W, head, Rp,
                                     nbin, sub);
    } else {
      detex::spec_ds_fold_kernel<14>(ur, ui, fr, fi, a, pw, su, nv, tw2, ds,
                                     pyr, hist, B, S, D, nc, m, W, head, Rp,
                                     nbin, sub);
    }
  });
  return 0;
}
