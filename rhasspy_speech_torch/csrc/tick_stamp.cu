// The stream tick's device stamps, for sm_90a (H100).
//
// Has no TPU kernel of its own: the JAX package's tick is one XLA program
// whose parts no trace names. A replayed CUDA graph is one interval to CUDA
// events and to the profiler alike, so the tick's body
// (rhasspy_speech_torch/pipeline/device_tick.py) launches this kernel between
// its parts: one thread reads the card's nanosecond clock (%globaltimer) and
// writes it into slot `slot` of a small int64 buffer, in stream order. The
// launch is captured into the body's graph like the body's other kernels, so
// every replay stamps anew. Its plain twin (a CPU buffer) writes the host's
// perf_counter_ns.
//
// What bounds it: the launch, ~1-2 us of a graph node. It reads nothing and
// writes 8 bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void tick_stamp_kernel(int64_t* out, int slot) {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  out[slot] = (int64_t)t;
}

}  // namespace

extern "C" {

const char* rss_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// out: int64 device buffer; writes out[slot] on `stream`.
int rss_tick_stamp_launch(int64_t* out, int slot, int device, void* stream) {
  if (slot < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  tick_stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(out, slot);
  return (int)cudaGetLastError();
}

}  // extern "C"
