// Device time stamps for the port's tracer (utils/profiling.py).
//
// Replaces no TPU kernel: the JAX package reads device time from its
// profiler alone. A CUDA event cannot serve inside a CUDA graph: every
// replay re-records the same event, and a host that runs replays ahead of
// the card reads each one after later replays have overwritten it. So a
// span's device start and end are stamps: one thread reads the card's
// %globaltimer (nanoseconds, the clock CUPTI's device timestamps come
// from) and appends it to a ring in device memory, at the index a counter
// beside the ring holds, in stream order with the work around it. The
// counter lives on the card, so a stamp node inside a graph appends to the
// ring at every replay, after the stamps enqueued before it; the host keeps
// the same count (each eager stamp 1, each replay its graph's stamps) and
// so knows where each stamp lands. A stamp past the ring's end is not
// written; the counter still counts it.
//
// Bound: launch latency (a few microseconds each), not bytes or operations:
// one 8-byte load and two 8-byte stores. Built into the same library as
// physics_step.cu (ops/cuda_step.py::build_library), called through ctypes.

__global__ void duck_stamp_kernel(unsigned long long* ring, unsigned long long* count,
                                  unsigned long long capacity) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  const unsigned long long i = *count;
  if (i < capacity) ring[i] = t;
  *count = i + 1;
}

extern "C" {

// Append the device time to `ring` (device memory, `capacity` slots) at
// index *count, and count it, on `stream`.
int duck_stamp(void* ring, void* count, unsigned long long capacity, void* stream) {
  duck_stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((unsigned long long*)ring,
                                                       (unsigned long long*)count, capacity);
  return (int)cudaGetLastError();
}

}  // extern "C"
