// Host side of the CPU emulation: includes the kernel source named by
// KERNEL_SRC and runs its blocks one after another, a thread per lane.
#include "cuda_runtime.h"
thread_local EmuDim threadIdx, blockIdx;
EmuDim blockDim;
thread_local EmuWarp* emu_warp;
alignas(16) float4 dyn_smem[1 << 16];
#include KERNEL_SRC

// duck_physics_step's arguments, on host pointers; k envs (warps) per block.
// `ceiling` picks the source's kernel instantiation (duck_step_kernel); a
// source older than those instantiations has one kernel and ignores it.
extern "C" int emu_physics_step(const DuckModel* m, const DuckDR* dr, int B, int n_substeps,
                                int nsensordata, const float* qpos, const float* qvel,
                                const float* warm, const float* ctrl, float* qpos_out,
                                float* qvel_out, float* warm_out, float* sensordata,
                                float* actuator_force, float* contact_dist, float* site_xpos,
                                float* site_xmat, int k, int ceiling) {
  if ((size_t)k * m->env_floats * sizeof(float) > sizeof(dyn_smem)) return -1;
#ifdef DUCK_SINGLE_KERNEL
  auto physics_step_kernel = ::physics_step_kernel;
  (void)ceiling;
#else
  auto physics_step_kernel = duck_step_kernel(ceiling);
  if (!physics_step_kernel) return -1;
#endif
  for (int b = 0; b < (B + k - 1) / k; ++b) {
    std::memset(dyn_smem, 0xff, sizeof(dyn_smem));  // NaN: a read before a write shows
    std::vector<EmuWarp> warps(k);
    std::vector<std::thread> lanes;
    blockDim.x = 32 * k;
    for (int t = 0; t < 32 * k; ++t)
      lanes.emplace_back([&, t] {
        threadIdx.x = t;
        blockIdx.x = b;
        emu_warp = &warps[t / 32];
        physics_step_kernel(*m, *dr, B, n_substeps, nsensordata, qpos, qvel, warm, ctrl,
                            qpos_out, qvel_out, warm_out, sensordata, actuator_force,
                            contact_dist, site_xpos, site_xmat);
      });
    for (auto& t : lanes) t.join();
  }
  return 0;
}
