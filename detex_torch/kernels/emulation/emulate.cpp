// Host build of the CUDA kernels for checking them without a GPU:
// g++ -std=c++20 -O2 -shared -fPIC -I<this dir> -I<kernels dir>
// emulate.cpp. Entry points take host pointers and the arguments of the
// CUDA entry points (blk = 16384 or 32768) and run every thread block of
// the grid in turn; emu_fft_regs and emu_ifft_regs run the forward and the
// inverse register-resident FFT core of fft_regs.cuh alone.
#include <functional>
#include <thread>
#include <vector>

#include "cuda_runtime.h"

thread_local dim3e threadIdx;
dim3e blockIdx, blockDim;
std::barrier<>* emu_block_barrier;
std::barrier<>* emu_group_barriers[16];
EmuWarp emu_warps[32];
namespace detex {
alignas(16) unsigned char smem[232448];  // the H100 per-block maximum
}

#include "ds_finalize.cuh"
#include "ds_finalize_os.cuh"
#include "ds_finalize_os_fold.cuh"
#include "ds_finalize_os_scan.cuh"
#include "fwd_prep_fold.cuh"
#include "hist_uniform.cuh"
#include "irfft_ct.cuh"
#include "rfft_ct.cuh"
#include "rfft_ct_half.cuh"
#include "spec_ds_fold.cuh"

namespace {

// ``groups``: equal parts of the block that meet at named barriers 1..groups
void run_grid(long long nblocks, int T, const std::function<void()>& body,
              int groups = 1) {
  blockDim = {(unsigned)T, 1, 1};
  std::barrier<> bar(T);
  emu_block_barrier = &bar;
  std::vector<std::barrier<>*> group_bars;
  for (int g = 1; g <= groups; ++g) {
    emu_group_barriers[g] = new std::barrier<>(T / groups);
    group_bars.push_back(emu_group_barriers[g]);
  }
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
  for (auto* p : group_bars) delete p;
}

}  // namespace

extern "C" int emu_fwd_prep_fold(const float* xq, const float* stage,
                                 const float* tw, float* fr, float* fi,
                                 float* a, float* pw, int B, int nc,
                                 long long Lp, int m, int W, int D0, int pad0,
                                 int n_c, long long out_len, int Rp,
                                 int log2m) {
  const float2* st2 = reinterpret_cast<const float2*>(stage);
  const float2* tw2 = reinterpret_cast<const float2*>(tw);
  if (log2m != 13 && log2m != 14) return 1;
  run_grid((long long)B * m,
           log2m == 13 ? detex::PrepFold<13>::T : detex::PrepFold<14>::T, [=] {
    if (log2m == 13) {
      detex::fwd_prep_fold_kernel<13>(xq, st2, tw2, fr, fi, a, pw, nc, Lp, m,
                                      W, D0, pad0, n_c, out_len, Rp);
    } else {
      detex::fwd_prep_fold_kernel<14>(xq, st2, tw2, fr, fi, a, pw, nc, Lp, m,
                                      W, D0, pad0, n_c, out_len, Rp);
    }
  });
  return 0;
}

// nc == 3 runs the form with the channel loop unrolled, as the CUDA entry
// point does
extern "C" int emu_spec_ds_fold(const float* ur, const float* ui,
                                const float* fr, const float* fi,
                                const float* a, const float* pw,
                                const float* su, const int* nv,
                                const float* stage, const float* tw,
                                float* ds, float* pyr, int* hist, int B,
                                int S, int D, int nc, int m, int W, int head,
                                int Rp, int nbin, int sub, int log2m) {
  const float2* st2 = reinterpret_cast<const float2*>(stage);
  const float2* tw2 = reinterpret_cast<const float2*>(tw);
  if (log2m != 13 && log2m != 14) return 1;
  const int NH = log2m == 13 ? detex::SpecDs<13>::NH : detex::SpecDs<14>::NH;
  const int T = log2m == 13 ? detex::SpecDs<13>::kThreads
                            : detex::SpecDs<14>::kThreads;
  const bool pair = NH > 1 && D == 1;
  const long long rows = pair ? (long long)B * ((S + NH - 1) / NH)
                              : (long long)B * S;
  const detex::SpecDsArgs args{ur, ui, fr, fi, a,  pw,  su, nv,   st2,
                               tw2, ds, pyr, hist, B,  S,   D,  nc,   m,
                               W,  head, Rp, nbin, sub};
  run_grid(rows * m, T, [=] {
#define EMU_SPEC_DS(L, C) detex::spec_ds_fold_kernel<L, C>(args)
    if (log2m == 13) {
      if (nc == 3) EMU_SPEC_DS(13, 3); else EMU_SPEC_DS(13, 0);
    } else {
      if (nc == 3) EMU_SPEC_DS(14, 3); else EMU_SPEC_DS(14, 0);
    }
#undef EMU_SPEC_DS
  }, NH);
  return 0;
}

extern "C" int emu_rfft_ct(const float* x, const float* stage,
                           const float* tw, float* out, long long N,
                           long long Lp, int m, int W, int log2m) {
  const float2* st2 = reinterpret_cast<const float2*>(stage);
  const float2* tw2 = reinterpret_cast<const float2*>(tw);
  float2* out2 = reinterpret_cast<float2*>(out);
  if (log2m != 13 && log2m != 14) return 1;
  run_grid(N, log2m == 13 ? detex::RegsFft<13>::T : detex::RegsFft<14>::T,
           [=] {
    if (log2m == 13) {
      detex::rfft_ct_kernel<13>(x, Lp, m, W, st2, tw2, out2);
    } else {
      detex::rfft_ct_kernel<14>(x, Lp, m, W, st2, tw2, out2);
    }
  });
  return 0;
}

// The FFT core alone: the M-point complex forward transform of each row of
// zin [N, M] (re, im pairs) to zout, natural order in and out.
extern "C" int emu_fft_regs(const float* zin, const float* stage,
                            float* zout, long long N, int log2m) {
  const float2* st2 = reinterpret_cast<const float2*>(stage);
  float2* z = reinterpret_cast<float2*>(detex::smem);
  if (log2m != 13 && log2m != 14) return 1;
  const int M = 1 << log2m;
  const int T = M / 32;
  run_grid(N, T, [=] {
    const float* row = zin + blockIdx.x * 2LL * M;
    if (log2m == 13) {
      detex::fft_regs_row<13>(reinterpret_cast<const float4*>(row), st2, z);
    } else {
      detex::fft_regs_row<14>(reinterpret_cast<const float4*>(row), st2, z);
    }
    float2* dst = reinterpret_cast<float2*>(zout) + blockIdx.x * (long long)M;
    for (int k = threadIdx.x; k < M; k += T) dst[k] = z[k];
  });
  return 0;
}

// The inverse core alone: each row of spec [N, M + 1] (re, im pairs; the
// half spectrum of 2M real samples, unscaled) to out [N, 2M], scaled by
// 1/2M: pack, three passes, the samples stored from registers.
struct EmuSpectrum {
  const float2* v;
  float scale;
  float2 operator()(int k) const {
    return make_float2(v[k].x * scale, v[k].y * scale);
  }
  float edge(int k) const { return v[k].x * scale; }
};

extern "C" int emu_ifft_regs(const float* spec, const float* stage,
                             const float* tw, float* out, long long N,
                             int log2m) {
  const float2* sp2 = reinterpret_cast<const float2*>(spec);
  const float2* st2 = reinterpret_cast<const float2*>(stage);
  const float2* tw2 = reinterpret_cast<const float2*>(tw);
  float2* z = reinterpret_cast<float2*>(detex::smem);
  if (log2m != 13 && log2m != 14) return 1;
  const int M = 1 << log2m;
  const int T = M / 32;
  run_grid(N, T, [=] {
    const int t = threadIdx.x;
    const EmuSpectrum src{sp2 + blockIdx.x * (M + 1LL), 0.5f / M};
    const detex::GroupBarrier bar{1, T};
    float2 x[32];
    if (log2m == 13) {
      detex::irfft_regs_row<13>(t, src, tw2, st2, z, bar, x);
    } else {
      detex::irfft_regs_row<14>(t, src, tw2, st2, z, bar, x);
    }
    float2* dst = reinterpret_cast<float2*>(out) + blockIdx.x * (long long)M;
    for (int r = 0; r < 32; ++r) dst[t + r * T] = x[r];
  });
  return 0;
}

extern "C" int emu_irfft_ct(const float* spec, const float* stage,
                            const float* tw, float* out, long long N,
                            int log2m) {
  const float2* spec2 = reinterpret_cast<const float2*>(spec);
  const float2* st2 = reinterpret_cast<const float2*>(stage);
  const float2* tw2 = reinterpret_cast<const float2*>(tw);
  if (log2m != 13 && log2m != 14) return 1;
  run_grid(N, log2m == 13 ? detex::RegsFft<13>::T : detex::RegsFft<14>::T,
           [=] {
    if (log2m == 13) {
      detex::irfft_ct_kernel<13>(spec2, st2, tw2, out);
    } else {
      detex::irfft_ct_kernel<14>(spec2, st2, tw2, out);
    }
  });
  return 0;
}

extern "C" int emu_ds_finalize_os_fold(const float* cb, const float* a,
                                       const float* pw, const float* su,
                                       const int* nv, float* ds, float* pyr,
                                       int* hist, long long BS, int D, int m,
                                       int blk, int W, int head, int group,
                                       int nbin) {
  run_grid(BS * m, detex::kFinThreads, [=] {
    detex::ds_finalize_os_fold_kernel(cb, a, pw, su, nv, ds, pyr, hist, D,
                                      m, blk, W, head, group, nbin);
  });
  return 0;
}

extern "C" int emu_ds_finalize_os_scan(const float* cb, const float* a,
                                       const float* pw, const float* su,
                                       const int* nv, float* ds, float* pyr,
                                       int* hist, long long S, int D, int m,
                                       int blk, int W, int head, int nbin) {
  const detex::OsFinArgs args{cb, a, pw, su, nv, ds, pyr, hist,
                               S,  D, m,  blk, W, head, nbin};
  run_grid(S * m, detex::kOsFinThreads, [=] {
    switch (D) {
      case 1: detex::ds_finalize_os_scan_kernel<1>(args); break;
      case 2: detex::ds_finalize_os_scan_kernel<2>(args); break;
      case 3: detex::ds_finalize_os_scan_kernel<3>(args); break;
      case 4: detex::ds_finalize_os_scan_kernel<4>(args); break;
      default: detex::ds_finalize_os_scan_kernel<0>(args); break;
    }
  });
  return 0;
}

extern "C" int emu_ds_finalize_os(const float* cb, const float* a,
                                  const float* pw, const float* su, float* ds,
                                  long long S, int D, int m, int blk, int W,
                                  int head) {
  const detex::OsFinArgs args{cb, a, pw, su, nullptr, ds, nullptr, nullptr,
                              S,  D, m,  blk, W, head, 0};
  run_grid(S * m, detex::kOsFinThreads, [=] {
    switch (D) {
      case 1: detex::ds_finalize_os_kernel<1>(args); break;
      case 2: detex::ds_finalize_os_kernel<2>(args); break;
      case 3: detex::ds_finalize_os_kernel<3>(args); break;
      case 4: detex::ds_finalize_os_kernel<4>(args); break;
      default: detex::ds_finalize_os_kernel<0>(args); break;
    }
  });
  return 0;
}

extern "C" int emu_hist_uniform(const float* ds, int* hist, long long S,
                                long long L, int nbin) {
  const int tiles = (int)((L + detex::kHistTile - 1) / detex::kHistTile);
  run_grid(S * tiles, detex::kHistThreads, [=] {
    detex::hist_uniform_kernel(ds, hist, L, tiles, nbin);
  });
  return 0;
}

extern "C" int emu_rfft_ct_half(const float* x, const float* stage,
                                const float* tw, float* fr, float* fi,
                                long long N, long long Lp, int m, int W,
                                int Rp, int log2m) {
  const float2* st2 = reinterpret_cast<const float2*>(stage);
  const float2* tw2 = reinterpret_cast<const float2*>(tw);
  if (log2m != 13 && log2m != 14) return 1;
  run_grid(N, log2m == 13 ? detex::RegsFft<13>::T : detex::RegsFft<14>::T,
           [=] {
    if (log2m == 13) {
      detex::rfft_ct_half_kernel<13>(x, Lp, m, W, st2, tw2, fr, fi, Rp);
    } else {
      detex::rfft_ct_half_kernel<14>(x, Lp, m, W, st2, tw2, fr, fi, Rp);
    }
  });
  return 0;
}

extern "C" int emu_ds_finalize(const float* cc, const float* a,
                               const float* pw, const float* su, float* ds,
                               long long S, int D, long long L) {
  const int tiles = (int)((L + detex::kDsFinTile - 1) / detex::kDsFinTile);
  run_grid(S * tiles, detex::kDsFinThreads, [=] {
    detex::ds_finalize_kernel(cc, a, pw, su, ds, D, L, tiles);
  });
  return 0;
}
