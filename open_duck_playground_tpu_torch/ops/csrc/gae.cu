// The trainer's GAE (train/ppo.py compute_gae with its inputs from
// loss_points) over one minibatch in one launch.
//
// Replaces no TPU kernel: the counterpart of XLA's fusion of the reverse
// `lax.scan` of the JAX package's compute_gae inside its jitted sgd_step.
// Eager PyTorch runs it as ~140 small kernels per minibatch step (the
// reverse loop's 20 steps of 6 each, the deltas, the advantages, their
// inputs), each a node of the SGD step's CUDA graph; here it is one node.
//
// One thread per column (env) walks t = T-1 .. 0, every column alone, with
// the float32 operations of compute_gae in its order and association:
//   r    = reward * reward_scaling
//   tm   = 1 - truncation                       (truncation_mask)
//   term = (1 - discount) * (1 - truncation)    (termination)
//   d    = discounting * (1 - term)
//   delta = ((r + d * v[t+1]) - v[t]) * tm      (v[T]: the bootstrap value)
//   acc   = delta + ((d * tm) * lambda) * acc   (acc from 0)
//   vs[t] = acc + v[t]
//   adv[t] = ((r + d * vs[t+1]) - v[t]) * tm    (vs[T]: the bootstrap value)
// every product and sum rounded on its own, round to nearest (the _rn
// intrinsics: no FMA contraction), the Python constants as the float32
// values torch casts them to. So vs and the advantages equal compute_gae's
// bit for bit, a NaN included, and it stays in its column.
//
// Bound: the dependent chain, not bytes. A launch reads 4 [T, b] inputs and
// the bootstrap and writes 2 [T, b] outputs (~124 KB at T=20, b=256: well
// under 0.1 us at 3.35 TB/s); each column is T steps of a few dependent
// flops, with its loads independent of the chain (__restrict__, unrolled,
// so they issue ahead of it). Neighbouring threads read neighbouring
// columns: every load and store is coalesced. Built into the same library
// as physics_step.cu (ops/cuda_step.py::build_library), called through
// ctypes.

#define DUCK_GAE_THREADS 128

__global__ void __launch_bounds__(DUCK_GAE_THREADS)
duck_gae_kernel(int T, int b, const float* __restrict__ reward,
                const float* __restrict__ discount, const float* __restrict__ truncation,
                const float* __restrict__ values, const float* __restrict__ bootstrap,
                float* __restrict__ vs, float* __restrict__ advantages, float reward_scaling,
                float discounting, float gae_lambda) {
  const int c = blockIdx.x * DUCK_GAE_THREADS + threadIdx.x;
  if (c >= b) return;
  const float boot = bootstrap[c];
  float next_v = boot, next_vs = boot, acc = 0.f;
#pragma unroll 4
  for (int t = T - 1; t >= 0; --t) {
    const long long i = (long long)t * b + c;
    const float r = __fmul_rn(reward[i], reward_scaling);
    const float tr = truncation[i];
    const float tm = __fsub_rn(1.f, tr);
    const float term = __fmul_rn(__fsub_rn(1.f, discount[i]), __fsub_rn(1.f, tr));
    const float d = __fmul_rn(discounting, __fsub_rn(1.f, term));
    const float v = values[i];
    const float delta = __fmul_rn(__fsub_rn(__fadd_rn(r, __fmul_rn(d, next_v)), v), tm);
    acc = __fadd_rn(delta, __fmul_rn(__fmul_rn(__fmul_rn(d, tm), gae_lambda), acc));
    const float vs_t = __fadd_rn(acc, v);
    vs[i] = vs_t;
    advantages[i] = __fmul_rn(__fsub_rn(__fadd_rn(r, __fmul_rn(d, next_vs)), v), tm);
    next_v = v;
    next_vs = vs_t;
  }
}

extern "C" {

// GAE over a [T, b] minibatch in one launch on `stream`: reward, discount,
// truncation and values are device pointers to T * b contiguous float32s
// (row t, column c at t * b + c), bootstrap to b; vs and advantages receive
// T * b each. Returns the CUDA error, or 0 (cudaErrorInvalidValue for T or
// b below 1).
int duck_gae(int T, int b, const void* reward, const void* discount, const void* truncation,
             const void* values, const void* bootstrap, void* vs, void* advantages,
             float reward_scaling, float discounting, float gae_lambda, void* stream) {
  if (T < 1 || b < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (b + DUCK_GAE_THREADS - 1) / DUCK_GAE_THREADS;
  duck_gae_kernel<<<blocks, DUCK_GAE_THREADS, 0, (cudaStream_t)stream>>>(
      T, b, (const float*)reward, (const float*)discount, (const float*)truncation,
      (const float*)values, (const float*)bootstrap, (float*)vs, (float*)advantages,
      reward_scaling, discounting, gae_lambda);
  return (int)cudaGetLastError();
}

}  // extern "C"
