// CPU emulation of the CUDA features the fused physics kernel uses, so that
// its device code (ops/csrc/physics_step.cu) builds with g++ and runs on the
// CPU: one OS thread per lane, a barrier per warp for __syncwarp, shuffles
// through a per-warp exchange buffer; blocks run one after another.
// Used by scripts/kernel_emulate.py (emulate.cpp) and tests/test_torch_kernel_ldl.py
// (ldl.cpp).
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __noinline__
#define __grid_constant__
#define __shared__
#define __launch_bounds__(...)
using std::min;
using std::max;
struct EmuDim { unsigned x = 0, y = 0, z = 0; };
extern thread_local EmuDim threadIdx, blockIdx;
extern EmuDim blockDim;
struct float4 { float x, y, z, w; };
extern float4 dyn_smem[];
struct EmuWarp {
  std::barrier<> bar{32};
  uint64_t xch[32];
};
extern thread_local EmuWarp* emu_warp;
template <class T> inline T __ldg(const T* p) { return *p; }
inline void __syncwarp(unsigned = 0xffffffffu) { emu_warp->bar.arrive_and_wait(); }
template <class T> inline T emu_shfl(T v, int src_of_lane(int, int), int arg) {
  int lane = threadIdx.x & 31;
  uint64_t bits = 0;
  std::memcpy(&bits, &v, sizeof(T));
  emu_warp->xch[lane] = bits;
  emu_warp->bar.arrive_and_wait();
  int src = src_of_lane(lane, arg);
  uint64_t got = emu_warp->xch[src >= 0 && src < 32 ? src : lane];
  emu_warp->bar.arrive_and_wait();
  T r;
  std::memcpy(&r, &got, sizeof(T));
  return r;
}
inline int emu_xor(int lane, int a) { return lane ^ a; }
inline int emu_idx(int, int a) { return a & 31; }
inline int emu_down(int lane, int a) { return lane + a; }
template <class T> inline T __shfl_xor_sync(unsigned, T v, int o, int = 32) { return emu_shfl(v, emu_xor, o); }
template <class T> inline T __shfl_sync(unsigned, T v, int s, int = 32) { return emu_shfl(v, emu_idx, s); }
template <class T> inline T __shfl_down_sync(unsigned, T v, int o, int = 32) { return emu_shfl(v, emu_down, o); }
inline unsigned __ballot_sync(unsigned, int pred) {
  int lane = threadIdx.x & 31;
  emu_warp->xch[lane] = pred ? 1 : 0;
  emu_warp->bar.arrive_and_wait();
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= (emu_warp->xch[i] ? 1u : 0u) << i;
  emu_warp->bar.arrive_and_wait();
  return r;
}
inline bool __all_sync(unsigned mask, int pred) { return __ballot_sync(mask, pred) == 0xffffffffu; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(unsigned x) { return __builtin_ffs(x); }
