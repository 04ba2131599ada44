// The MLPs' swish activation (train/networks.py swish), forward and
// backward, one launch each.
//
// Replaces no TPU kernel: the counterpart of XLA's fusion of the swish
// (x * sigmoid(x)) and of its gradient into the neighbouring ops in the JAX
// package's jitted sgd_step. Eager PyTorch runs the forward as two kernels
// (sigmoid, mul: 5 passes over the tensor) and the backward as four (g * s,
// g * x, sigmoid_backward, the add that sums x's two gradients: 12 passes),
// each a node of the SGD step's CUDA graph; here they are one node each,
// 2 passes forward (read x, write y) and 3 backward (read g and x, write gx).
//
// Arithmetic, as torch's CUDA kernels round it:
//   s  = 1 / (1 + expf(-x))                 (sigmoid_kernel_cuda)
//   y  = x * s                              (mul)
//   gx = g * s + ((g * x) * (1 - s)) * s    (mul; sigmoid_backward; the add)
// every product and sum rounded on its own (the _rn intrinsics: no FMA
// contraction), the quotient IEEE. The backward recomputes s from x with
// the forward's expression, so the caller saves x alone. So y and gx equal
// torch's forward and autograd's gradient bit for bit (a NaN as a NaN, its
// payload aside).
//
// Bound: bytes (one float of arithmetic per byte or so). Each thread moves
// 16-byte float4s where every pointer is 16-byte aligned (a scalar loop
// otherwise, and for the last n % 4 floats), neighbouring threads on
// neighbouring addresses, over a grid-stride loop whose grid is what the
// card holds resident at once (the SMs times the blocks an SM takes, read
// from the runtime once per device); no shared memory. Built into the same
// library as physics_step.cu (ops/cuda_step.py::build_library), called
// through ctypes.

#include <stdint.h>

#define DUCK_SWISH_THREADS 256
#define DUCK_SWISH_DEVICES 64

__device__ __forceinline__ float duck_sigmoid(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

__device__ __forceinline__ float duck_swish(float x) { return __fmul_rn(x, duck_sigmoid(x)); }

__device__ __forceinline__ float duck_swish_grad(float g, float x) {
  const float s = duck_sigmoid(x);
  return __fadd_rn(__fmul_rn(g, s),
                   __fmul_rn(__fmul_rn(__fmul_rn(g, x), __fsub_rn(1.0f, s)), s));
}

__global__ void __launch_bounds__(DUCK_SWISH_THREADS)
duck_swish_forward_kernel(long long n, const float* __restrict__ x, float* __restrict__ y,
                          int vec) {
  const long long stride = (long long)gridDim.x * DUCK_SWISH_THREADS;
  const long long t = (long long)blockIdx.x * DUCK_SWISH_THREADS + threadIdx.x;
  long long head = 0;
  if (vec) {
    const long long n4 = n >> 2;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    float4* y4 = reinterpret_cast<float4*>(y);
    for (long long i = t; i < n4; i += stride) {
      float4 v = x4[i];
      v.x = duck_swish(v.x);
      v.y = duck_swish(v.y);
      v.z = duck_swish(v.z);
      v.w = duck_swish(v.w);
      y4[i] = v;
    }
    head = n4 << 2;
  }
  for (long long i = head + t; i < n; i += stride) y[i] = duck_swish(x[i]);
}

__global__ void __launch_bounds__(DUCK_SWISH_THREADS)
duck_swish_backward_kernel(long long n, const float* __restrict__ g, const float* __restrict__ x,
                           float* __restrict__ gx, int vec) {
  const long long stride = (long long)gridDim.x * DUCK_SWISH_THREADS;
  const long long t = (long long)blockIdx.x * DUCK_SWISH_THREADS + threadIdx.x;
  long long head = 0;
  if (vec) {
    const long long n4 = n >> 2;
    const float4* g4 = reinterpret_cast<const float4*>(g);
    const float4* x4 = reinterpret_cast<const float4*>(x);
    float4* gx4 = reinterpret_cast<float4*>(gx);
    for (long long i = t; i < n4; i += stride) {
      const float4 a = g4[i];
      const float4 v = x4[i];
      gx4[i] = make_float4(duck_swish_grad(a.x, v.x), duck_swish_grad(a.y, v.y),
                           duck_swish_grad(a.z, v.z), duck_swish_grad(a.w, v.w));
    }
    head = n4 << 2;
  }
  for (long long i = head + t; i < n; i += stride) gx[i] = duck_swish_grad(g[i], x[i]);
}

// The resident grid of a kernel on the current device: its SMs times the
// blocks of DUCK_SWISH_THREADS one SM holds, read once per device (before a
// graph captures: the trainer's warm-up calls both kernels first).
static int duck_swish_resident(const void* kernel, int* cache) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  if (dev < 0 || dev >= DUCK_SWISH_DEVICES) return -(int)cudaErrorInvalidDevice;
  if (cache[dev] > 0) return cache[dev];
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, DUCK_SWISH_THREADS, 0);
  if (err != cudaSuccess) return -(int)err;
  if (sms < 1 || per_sm < 1) return -(int)cudaErrorInvalidConfiguration;
  cache[dev] = sms * per_sm;
  return cache[dev];
}

static int duck_swish_grid(long long n, int vec, int resident) {
  // vec: n / 4 float4s, then the last n % 4 floats on the first threads
  const long long items = vec ? ((n >> 2) > (n & 3) ? (n >> 2) : (n & 3)) : n;
  const long long blocks = (items + DUCK_SWISH_THREADS - 1) / DUCK_SWISH_THREADS;
  return (int)(blocks < resident ? blocks : resident);
}

static int duck_swish_forward_resident[DUCK_SWISH_DEVICES];
static int duck_swish_backward_resident[DUCK_SWISH_DEVICES];

extern "C" {

// y = swish(x) over n contiguous float32s (device pointers) in one launch on
// `stream`. Returns the CUDA error, or 0 (nothing launched for n = 0;
// cudaErrorInvalidValue for n < 0).
int duck_swish_forward(long long n, const void* x, void* y, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int resident =
      duck_swish_resident((const void*)duck_swish_forward_kernel, duck_swish_forward_resident);
  if (resident < 0) return -resident;
  const int vec = (((uintptr_t)x | (uintptr_t)y) & 15) == 0;
  duck_swish_forward_kernel<<<duck_swish_grid(n, vec, resident), DUCK_SWISH_THREADS, 0,
                              (cudaStream_t)stream>>>(n, (const float*)x, (float*)y, vec);
  return (int)cudaGetLastError();
}

// gx = the gradient of swish at x given the output's gradient g, over n
// contiguous float32s each, in one launch on `stream`. Returns as
// duck_swish_forward.
int duck_swish_backward(long long n, const void* g, const void* x, void* gx, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int resident =
      duck_swish_resident((const void*)duck_swish_backward_kernel, duck_swish_backward_resident);
  if (resident < 0) return -resident;
  const int vec = (((uintptr_t)g | (uintptr_t)x | (uintptr_t)gx) & 15) == 0;
  duck_swish_backward_kernel<<<duck_swish_grid(n, vec, resident), DUCK_SWISH_THREADS, 0,
                               (cudaStream_t)stream>>>(n, (const float*)g, (const float*)x,
                                                       (float*)gx, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
