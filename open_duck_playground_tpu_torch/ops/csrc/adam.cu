// The trainer's gradient clip and Adam update (train/optim.py clip_and_adam)
// over every parameter tensor in one launch.
//
// Replaces no TPU kernel: the counterpart of XLA's fusion of optax's
// clip_by_global_norm + adam in the JAX package's jitted sgd_step. Eager
// PyTorch runs that step as ~290 small elementwise kernels per minibatch
// (16 tensors x the clip's select, both moments, the update), each a node of
// the SGD step's CUDA graph; here it is one node.
//
// Per element, with the global norm and the bias corrections read from
// device scalars that torch computed (the norm's reduction tree and pow's
// rounding stay torch's):
//   g' = norm < max_norm ? g : (g / norm) * max_norm      (no norm: g' = g)
//   m' = b1*m + (1-b1)*g',  v' = b2*v + (1-b2)*(g'*g')
//   p' = p + (-lr) * ((m'/bc1) / (sqrt(v'/bc2) + eps))
// rounded term for term as optim.py's torch ops round on the card: every
// product, sum, quotient and root on its own, round to nearest (the _rn
// intrinsics: no FMA contraction, IEEE division and square root), the
// Python constants as the float32 values torch casts them to. So the result
// equals the plain functions' bit for bit.
//
// Bound: bytes. Each element reads p, g, m, v and writes p, m, v: 28 B, no
// reuse. One launch takes the tensors as a by-value argument (pointers and
// sizes, __grid_constant__), so a CUDA graph node holds it and nothing is
// copied at replay; each block takes DUCK_ADAM_BLOCK_ELEMS elements of one
// tensor, with 16-byte loads and stores where the four pointers allow and
// scalar ones otherwise. Built into the same library as physics_step.cu
// (ops/cuda_step.py::build_library), called through ctypes.

#include <stdint.h>

#define DUCK_ADAM_LEAVES 32      // tensors per launch, at most (the recipe has 16)
#define DUCK_ADAM_THREADS 256
#define DUCK_ADAM_BLOCK_ELEMS (DUCK_ADAM_THREADS * 4)

struct DuckAdamLeaf {
  float* p;
  const float* g;
  float* m;
  float* v;
  long long n;
};

struct DuckAdamArgs {
  DuckAdamLeaf leaf[DUCK_ADAM_LEAVES];
  int block_end[DUCK_ADAM_LEAVES];  // blocks of leaves 0..k, cumulative
  int n_leaves;
  const float* norm;  // the global norm, or null: no clip
  const float* bc1;
  const float* bc2;
  float max_norm, b1, c1, b2, c2, eps, neg_lr;  // c1 = (float)(1 - b1), c2 likewise
};

struct DuckAdamScalars {
  bool scale;  // the clip scales g
  float norm, bc1, bc2;
};

__device__ __forceinline__ void duck_adam_one(const DuckAdamArgs& a, const DuckAdamScalars& s,
                                              float& p, float g, float& m, float& v) {
  if (s.scale) g = __fmul_rn(__fdiv_rn(g, s.norm), a.max_norm);
  m = __fadd_rn(__fmul_rn(m, a.b1), __fmul_rn(a.c1, g));
  v = __fadd_rn(__fmul_rn(v, a.b2), __fmul_rn(a.c2, __fmul_rn(g, g)));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.bc2)), a.eps);
  const float upd = __fdiv_rn(__fdiv_rn(m, s.bc1), den);
  p = __fadd_rn(p, __fmul_rn(a.neg_lr, upd));
}

__global__ void __launch_bounds__(DUCK_ADAM_THREADS)
duck_adam_kernel(const __grid_constant__ DuckAdamArgs a) {
  int k = 0;
  while (k + 1 < a.n_leaves && (int)blockIdx.x >= a.block_end[k]) ++k;
  const int first = k ? a.block_end[k - 1] : 0;
  const DuckAdamLeaf& L = a.leaf[k];
  const long long i0 =
      ((long long)((int)blockIdx.x - first) * DUCK_ADAM_THREADS + threadIdx.x) * 4;
  if (i0 >= L.n) return;
  DuckAdamScalars s;
  s.norm = a.norm ? *a.norm : 0.f;
  s.scale = a.norm && !(s.norm < a.max_norm);  // torch.where(norm < max_norm, g, ...)
  s.bc1 = *a.bc1;
  s.bc2 = *a.bc2;
  const bool aligned =
      (((uintptr_t)L.p | (uintptr_t)L.g | (uintptr_t)L.m | (uintptr_t)L.v) & 15) == 0;
  if (aligned && i0 + 4 <= L.n) {
    float4 p = *reinterpret_cast<const float4*>(L.p + i0);
    const float4 g = *reinterpret_cast<const float4*>(L.g + i0);
    float4 m = *reinterpret_cast<const float4*>(L.m + i0);
    float4 v = *reinterpret_cast<const float4*>(L.v + i0);
    duck_adam_one(a, s, p.x, g.x, m.x, v.x);
    duck_adam_one(a, s, p.y, g.y, m.y, v.y);
    duck_adam_one(a, s, p.z, g.z, m.z, v.z);
    duck_adam_one(a, s, p.w, g.w, m.w, v.w);
    *reinterpret_cast<float4*>(L.p + i0) = p;
    *reinterpret_cast<float4*>(L.m + i0) = m;
    *reinterpret_cast<float4*>(L.v + i0) = v;
    return;
  }
  const long long end = i0 + 4 < L.n ? i0 + 4 : L.n;
  for (long long i = i0; i < end; ++i) duck_adam_one(a, s, L.p[i], L.g[i], L.m[i], L.v[i]);
}

extern "C" {

// One clip + Adam step over n tensors (1 <= n <= DUCK_ADAM_LEAVES), in place
// on p, m, v, in one launch on `stream`: p[i], g[i], m[i], v[i] are device
// pointers to numel[i] float32s each; norm (null: no clip), bc1 and bc2
// point to device float32 scalars. Returns the CUDA error, or 0
// (cudaErrorInvalidValue for n out of range).
int duck_adam(int n, void* const* p, void* const* g, void* const* m, void* const* v,
              const long long* numel, const void* norm, const void* bc1, const void* bc2,
              float max_norm, float b1, float c1, float b2, float c2, float eps, float neg_lr,
              void* stream) {
  if (n < 1 || n > DUCK_ADAM_LEAVES) return (int)cudaErrorInvalidValue;
  DuckAdamArgs a = {};
  a.n_leaves = n;
  int blocks = 0;
  for (int k = 0; k < n; ++k) {
    a.leaf[k].p = (float*)p[k];
    a.leaf[k].g = (const float*)g[k];
    a.leaf[k].m = (float*)m[k];
    a.leaf[k].v = (float*)v[k];
    a.leaf[k].n = numel[k];
    blocks += (int)((numel[k] + DUCK_ADAM_BLOCK_ELEMS - 1) / DUCK_ADAM_BLOCK_ELEMS);
    a.block_end[k] = blocks;
  }
  if (blocks == 0) return 0;
  a.norm = (const float*)norm;
  a.bc1 = (const float*)bc1;
  a.bc2 = (const float*)bc2;
  a.max_norm = max_norm;
  a.b1 = b1;
  a.c1 = c1;
  a.b2 = b2;
  a.c2 = c2;
  a.eps = eps;
  a.neg_lr = neg_lr;
  duck_adam_kernel<<<blocks, DUCK_ADAM_THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
