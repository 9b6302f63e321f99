// Host stand-in for <cuda_runtime.h>: lets g++ compile the kernel bodies
// (../*.cuh) so their arithmetic and indexing can be checked on a machine
// without a GPU. One thread block runs as kThreads std::threads:
// __syncthreads is a std::barrier, warp shuffles exchange through a
// per-warp buffer behind a 32-thread barrier, shared memory is one global
// buffer (blocks run one after another, see emulate.cpp). Not a model of
// timing or of the memory system.
#pragma once
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__
#define __align__(x) __attribute__((aligned(x)))

struct float2 { float x, y; };
inline float2 make_float2(float x, float y) { return float2{x, y}; }
struct alignas(16) float4 { float x, y, z, w; };
struct dim3e { unsigned x, y, z; };

extern thread_local dim3e threadIdx;
extern dim3e blockIdx, blockDim;
extern std::barrier<>* emu_block_barrier;
struct EmuWarp {
  std::barrier<>* bar;
  alignas(8) unsigned char v[32][8];
};
extern EmuWarp emu_warps[32];

inline void __syncthreads() { emu_block_barrier->arrive_and_wait(); }
template <class T> inline T __ldg(const T* p) { return *p; }
inline unsigned __brev(unsigned x) {
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) {
    r = (r << 1) | (x & 1u);
    x >>= 1;
  }
  return r;
}
template <class T> T emu_shuffle(T v, int src_lane, bool take) {
  static_assert(sizeof(T) <= 8, "shuffles move at most 8 bytes");
  const int lane = threadIdx.x & 31;
  EmuWarp& w = emu_warps[threadIdx.x >> 5];
  std::memcpy(w.v[lane], &v, sizeof(T));
  w.bar->arrive_and_wait();
  T r = v;
  if (take) std::memcpy(&r, w.v[src_lane], sizeof(T));
  w.bar->arrive_and_wait();
  return r;
}
template <class T> T __shfl_up_sync(unsigned, T v, int o) {
  const int lane = threadIdx.x & 31;
  return emu_shuffle(v, lane - o, lane >= o);
}
template <class T> T __shfl_xor_sync(unsigned, T v, int o) {
  return emu_shuffle(v, (threadIdx.x & 31) ^ o, true);
}
inline int atomicAdd(int* p, int v) { return std::atomic_ref<int>(*p).fetch_add(v); }
