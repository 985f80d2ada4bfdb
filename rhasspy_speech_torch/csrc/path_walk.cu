// Whole-path walk over the stream scheduler's backpointer ring, for sm_90a
// (H100): one packed uint16 row per stream slot.
//
// Has no TPU kernel of its own: it stands in for the XLA scans of
// rhasspy_speech_tpu/pipeline/scheduler.py (walk_step inside batch_chunk,
// and finalize_trace), which walk every slot over the ring's full depth
// because a scan's trip count is static. Here each slot walks only its own
// decoded frames.
//
// The ring is [N, ring_stride, S] uint16 holding bp + 3 (0 = no frame,
// 2 = dead, arc + 3 otherwise). Slot n starts at start[n] on its last
// decoded frame and follows arc sources back to frame 0. Its row of the
// output [N, width + 8] is the arc trace (emit + 2: 0 = no frame, 1 =
// dead, arc + 2), then final_state, has_final, trailing-silence frames,
// contains-nonsilence, and the final cost and relative cost as f32 bit
// halves (lo, hi) -- the layout of the reference's packed tick row.
// Trailing silence is Kaldi's TrailingSilenceLength (online-endpoint.h),
// whole-path and uncapped; with ``stats`` 0 both endpoint columns stay 0,
// as in the reference when endpointing is off.
//
// Design: the walk is a chain of dependent loads (ring entry -> arc source
// -> next ring entry), so one thread of a block walks its slot while the
// block's other threads write the row's padding past the slot's frames. A
// step reads one 32-byte sector of the ring plus the arc's source and
// silence flag; nothing is staged, since a slot walks a few hundred frames
// and the tables would cost more to stage than the walk reads of them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void path_walk_kernel(const uint16_t* __restrict__ ring, int ring_stride, int S,
                                 const int* __restrict__ frames,
                                 const int* __restrict__ start,
                                 const float* __restrict__ costs,  // [N, 2]: final, relative
                                 const int* __restrict__ arc_src,
                                 const uint8_t* __restrict__ arc_sil, int width, int stats,
                                 uint16_t* __restrict__ out) {
  const int n = blockIdx.x;
  const int T = min(max(frames[n], 0), width);
  uint16_t* row = out + (size_t)n * (width + 8);
  for (int f = T + threadIdx.x; f < width; f += blockDim.x) row[f] = 0;
  if (threadIdx.x != 0) return;

  const uint16_t* lane = ring + (size_t)n * ring_stride * S;
  int state = start[n];
  int trail = 0;
  bool nonsil = false, done = false;
  for (int f = T - 1; f >= 0; --f) {
    const int e = (int)__ldg(lane + (size_t)f * S + state) - 3;
    row[f] = (uint16_t)(e + 2);
    if (e >= 0) {
      if (stats) {
        const bool sil = __ldg(arc_sil + e) != 0;
        if (sil && !done) ++trail;
        done = done || !sil;
        nonsil = nonsil || !sil;
      }
      state = __ldg(arc_src + e);
    } else if (stats) {
      done = true;
    }
  }
  const float fcost = costs[2 * n];
  const uint32_t cb = __float_as_uint(fcost);
  const uint32_t rb = __float_as_uint(costs[2 * n + 1]);
  uint16_t* tail = row + width;
  tail[0] = (uint16_t)start[n];
  tail[1] = fcost < 1.0e29f ? 1 : 0;
  tail[2] = (uint16_t)min(trail, 65535);
  tail[3] = nonsil ? 1 : 0;
  tail[4] = (uint16_t)(cb & 0xFFFFu);
  tail[5] = (uint16_t)(cb >> 16);
  tail[6] = (uint16_t)(rb & 0xFFFFu);
  tail[7] = (uint16_t)(rb >> 16);
}

}  // namespace

extern "C" {

const char* rss_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int rss_path_walk_launch(const uint16_t* ring, int ring_stride, int S, const int* frames,
                         const int* start, const float* costs, const int* arc_src,
                         const uint8_t* arc_sil, int N, int width, int stats, uint16_t* out,
                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (N > 0)
    path_walk_kernel<<<N, kThreads, 0, (cudaStream_t)stream>>>(
        ring, ring_stride, S, frames, start, costs, arc_src, arc_sil, width, stats, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
