// The fused kernel's LDL routine alone on the CPU: ldl_factor + ldl_solve of
// the source named by KERNEL_SRC for one warp (a thread per lane), as the
// kernel factors the Newton Hessian: in place over the packed triangle.
// Used by tests/test_torch_kernel_ldl.py.
#include "cuda_runtime.h"
thread_local EmuDim threadIdx, blockIdx;
EmuDim blockDim;
thread_local EmuWarp* emu_warp;
alignas(16) float4 dyn_smem[1];
#include KERNEL_SRC

template <int NVC>
static void ldl_warp(int nv, const uint32_t* mask, float* A, const float* b, float* x,
                     float* dinv) {
  const int lane = threadIdx.x & 31;
  LdlRow<NVC> row;
  ldl_factor(nv, mask, A, A, row, lane);
  const float z = ldl_solve(nv, mask, A, row, lane < nv ? b[lane] : 0.0f, lane);
  if (lane < nv) {
    x[lane] = z;
    dinv[lane] = row.dinv;
  }
}

// A: nv (nv + 1) / 2 floats, the packed lower triangle, overwritten with L's
// strict lower part (the diagonal kept); b: nv floats; out: x and 1 / d (nv
// each). `ceiling`: the kernel's LDL unroll ceiling (24 or 32), >= nv.
extern "C" int emu_ldl(int nv, int ceiling, const uint32_t* mask, float* A, const float* b,
                       float* x, float* dinv) {
  if (nv < 1 || nv > ceiling || (ceiling != 24 && ceiling != MAX_NV)) return -1;
  EmuWarp warp;
  std::vector<std::thread> lanes;
  blockDim.x = 32;
  for (int t = 0; t < 32; ++t)
    lanes.emplace_back([&, t] {
      threadIdx.x = t;
      blockIdx.x = 0;
      emu_warp = &warp;
      if (ceiling == 24)
        ldl_warp<24>(nv, mask, A, b, x, dinv);
      else
        ldl_warp<MAX_NV>(nv, mask, A, b, x, dinv);
    });
  for (auto& t : lanes) t.join();
  return 0;
}
