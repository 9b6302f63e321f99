// Host stand-in for <cuda_runtime.h>: lets g++ compile the kernel bodies
// (../*.cuh) so their arithmetic and indexing can be checked on a machine
// without a GPU. One thread block runs as kThreads std::threads:
// __syncthreads is a std::barrier, warp shuffles exchange through a
// per-warp buffer behind a 32-thread barrier, a named barrier (bar.sync id,
// count) is one std::barrier per equal group of the block, shared memory is
// one global buffer (blocks run one after another, see emulate.cpp). Not a model of
// timing or of the memory system.
#pragma once
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>

#define DETEX_HOST_EMULATION 1
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__
#define __launch_bounds__(...)
#define __shared__
#define __align__(x) __attribute__((aligned(x)))

struct float2 { float x, y; };
inline float2 make_float2(float x, float y) { return float2{x, y}; }
struct alignas(16) float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) {
  return float4{x, y, z, w};
}
struct dim3e { unsigned x, y, z; };

extern thread_local dim3e threadIdx;
extern dim3e blockIdx, blockDim;
extern std::barrier<>* emu_block_barrier;
struct EmuWarp {
  std::barrier<>* bar;
  alignas(8) unsigned char v[32][8];
};
extern EmuWarp emu_warps[32];

extern std::barrier<>* emu_group_barriers[16];   // [id], id >= 1

inline void __syncthreads() { emu_block_barrier->arrive_and_wait(); }
inline void named_barrier_sync(int id, int) {
  emu_group_barriers[id]->arrive_and_wait();
}
template <class T> inline T __ldg(const T* p) { return *p; }
template <class T> inline void __stcs(T* p, T v) { *p = v; }
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
// lanes of the warp holding the same value as this one
inline unsigned __match_any_sync(unsigned, int v) {
  const int lane = threadIdx.x & 31;
  EmuWarp& w = emu_warps[threadIdx.x >> 5];
  std::memcpy(w.v[lane], &v, sizeof(int));
  w.bar->arrive_and_wait();
  unsigned mask = 0u;
  for (int l = 0; l < 32; ++l) {
    int u;
    std::memcpy(&u, w.v[l], sizeof(int));
    if (u == v) mask |= 1u << l;
  }
  w.bar->arrive_and_wait();
  return mask;
}
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
inline unsigned __ballot_sync(unsigned, int pred) {
  unsigned v = pred ? 1u << (threadIdx.x & 31) : 0u;
  for (int o = 16; o > 0; o >>= 1) v |= __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int atomicAdd(int* p, int v) { return std::atomic_ref<int>(*p).fetch_add(v); }
