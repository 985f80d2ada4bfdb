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
// What bounds it: latency. The walk is a chain of dependent loads, one
// step a frame, and the bytes it needs are a few kilobytes. The first
// version made two dependent global loads a step (the ring entry, then the
// arc's source beside its silence flag), ~280 ns a step at 803 states,
// nearly all of it the ring entry's (the ring is ~100 MB; the arc table
// sat in L1). Design:
//
// - The arc table in shared memory. The block's threads first copy the
//   graph's packed table (ops/path_walk_cuda.py walk_tables: uint16 arc
//   sources, then a silence bit an arc; 2 A + A / 8 bytes, <= 139 KB at the
//   device route's 65,532 arcs) with coalesced 16-byte loads.
// - Small rows stream. Where a ring row is small (chunk_frames > 0: at
//   least 8 rows fit a 64 KB buffer, ops/path_walk_cuda.py walk_chunks),
//   the slot's decoded rows pass through two
//   shared-memory buffers, newest first: warps 1.. copy chunk k + 1 with
//   cp.async while thread 0 walks chunk k in shared memory. A step is then
//   two shared-memory loads; the copy moves S x 2 bytes a frame instead of
//   waiting ~280 ns for 2. It is a size rule inside the kernel.
// - Large rows (13,789 states: 27.6 KB a row) are chased directly: a step
//   is one dependent global load (the ring entry) and one shared-memory
//   load, and thread 0 issues the first ring load before the table's
//   barrier. The block's other threads write the row's padding past the
//   slot's frames.
//
// Rejected: an incremental walk that stops where the path merges with the
// previous tick's. It would read state that the slot lifecycle (reset,
// quarantine, finalize) and the captured graph must keep valid across
// ticks, to save ~0.02 ms a tick.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxDevices = 64;

// Where element e0 of `src` lands in a chunk buffer `dst`: the buffer keeps
// src's offset within 16 bytes.
__device__ __forceinline__ const uint16_t* chunk_rows(const uint16_t* src, size_t e0,
                                                     unsigned char* dst) {
  return (const uint16_t*)(dst + ((uintptr_t)(src + e0) & 15));
}

// Copy ring elements [e0, e0 + n) of `src` into the chunk buffer `dst`: the
// aligned interior as 16-byte cp.async copies, the head and tail element by
// element. Threads `first`.. of the block take part.
__device__ __forceinline__ void copy_rows(const uint16_t* src, size_t e0, size_t n,
                                          unsigned char* dst, int first) {
  const uintptr_t g0 = (uintptr_t)(src + e0), g1 = g0 + 2 * n;
  const uintptr_t base = g0 & ~(uintptr_t)15;
  const uintptr_t a0 = (g0 + 15) & ~(uintptr_t)15, a1 = g1 & ~(uintptr_t)15;
  const int tid = threadIdx.x - first, nthr = blockDim.x - first;
  if (tid >= 0) {
    if (a0 < a1) {
      for (uintptr_t v = a0 + 16 * (uintptr_t)tid; v < a1; v += 16 * (uintptr_t)nthr)
        __pipeline_memcpy_async(dst + (v - base), (const void*)v, 16);
      for (uintptr_t g = g0 + 2 * (uintptr_t)tid; g < a0; g += 2 * (uintptr_t)nthr)
        *(uint16_t*)(dst + (g - base)) = __ldg((const uint16_t*)g);
      for (uintptr_t g = a1 + 2 * (uintptr_t)tid; g < g1; g += 2 * (uintptr_t)nthr)
        *(uint16_t*)(dst + (g - base)) = __ldg((const uint16_t*)g);
    } else {
      for (uintptr_t g = g0 + 2 * (uintptr_t)tid; g < g1; g += 2 * (uintptr_t)nthr)
        *(uint16_t*)(dst + (g - base)) = __ldg((const uint16_t*)g);
    }
  }
  __pipeline_commit();
}

__global__ void __launch_bounds__(kThreads)
path_walk_kernel(const uint16_t* __restrict__ ring, int ring_stride, int S,
                 const int* __restrict__ frames,
                 const int* __restrict__ start,
                 const float* __restrict__ costs,  // [N, 2]: final, relative
                 const uint4* __restrict__ table,  // src16 [A16] then sil bits [W]
                 int src_vec, int bit_vec, int chunk_frames, int chunk_bytes, int width,
                 int stats, uint16_t* __restrict__ out) {
  extern __shared__ __align__(16) uint4 tab_s[];
  const int n = blockIdx.x;
  const int T = min(max(frames[n], 0), width);
  const uint16_t* lane = ring + (size_t)n * ring_stride * S;
  int state = start[n];
  const bool stream = chunk_frames > 0;
  // the direct chase: the first step's ring entry, in flight across the copy
  int first = 0;
  if (!stream && threadIdx.x == 0 && T > 0) first = (int)__ldg(lane + (size_t)(T - 1) * S + state);

  for (int v = threadIdx.x; v < src_vec + bit_vec; v += blockDim.x) tab_s[v] = __ldg(table + v);
  unsigned char* bufs = (unsigned char*)(tab_s + src_vec + bit_vec);
  // streamed: frames [lo, hi) of the slot's ring rows, chunk k in buffer k % 2
  int hi = T, lo = max(T - chunk_frames, 0);
  const uint16_t* rows = chunk_rows(lane, (size_t)lo * S, bufs);
  if (stream && T > 0) copy_rows(lane, (size_t)lo * S, (size_t)(hi - lo) * S, bufs, 0);
  uint16_t* row = out + (size_t)n * (width + 8);
  for (int f = T + threadIdx.x; f < width; f += blockDim.x) row[f] = 0;
  __pipeline_wait_prior(0);
  __syncthreads();

  const uint16_t* src = (const uint16_t*)tab_s;
  const uint32_t* sil = (const uint32_t*)(tab_s + src_vec);
  int trail = 0;
  bool nonsil = false, done = false;
  // one step of the walk at frame f with the ring entry e + 3
  auto step = [&](int f, int e) {
    e -= 3;
    row[f] = (uint16_t)(e + 2);
    if (e >= 0) {
      if (stats) {
        const bool is_sil = (sil[e >> 5] >> (e & 31)) & 1u;
        if (is_sil && !done) ++trail;
        done = done || !is_sil;
        nonsil = nonsil || !is_sil;
      }
      state = src[e];
    } else if (stats) {
      done = true;
    }
  };
  if (stream) {
    // thread 0 walks chunk k while warps 1.. copy chunk k + 1
    for (int k = 0; hi > 0; ++k) {
      const int nlo = max(lo - chunk_frames, 0);
      unsigned char* nbuf = bufs + ((k + 1) & 1) * chunk_bytes;
      if (threadIdx.x >= 32 && lo > 0)
        copy_rows(lane, (size_t)nlo * S, (size_t)(lo - nlo) * S, nbuf, 32);
      if (threadIdx.x == 0)
        for (int f = hi - 1; f >= lo; --f) step(f, rows[(size_t)(f - lo) * S + state]);
      __pipeline_wait_prior(0);
      __syncthreads();
      rows = chunk_rows(lane, (size_t)nlo * S, nbuf);
      hi = lo;
      lo = nlo;
    }
    if (threadIdx.x != 0) return;
  } else {
    if (threadIdx.x != 0) return;
    for (int f = T - 1; f >= 0; --f)
      step(f, f == T - 1 ? first : (int)__ldg(lane + (size_t)f * S + state));
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

// table: the packed arc table of ops/path_walk_cuda.py walk_tables, src_vec
// 16-byte vectors of uint16 sources then bit_vec of silence bits;
// chunk_frames > 0 streams a slot's ring rows through two shared-memory
// buffers of chunk_bytes each (a multiple of 16 holding chunk_frames rows
// and 16 bytes of slack), chunk_frames frames at a time
// (ops/path_walk_cuda.py walk_chunks)
int rss_path_walk_launch(const uint16_t* ring, int ring_stride, int S, const int* frames,
                         const int* start, const float* costs, const void* table,
                         int src_vec, int bit_vec, int chunk_frames, int chunk_bytes, int N,
                         int width, int stats, uint16_t* out, int device, void* stream) {
  static int smem_set[kMaxDevices] = {0};  // the opt-in already granted, per device
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (device < 0 || device >= kMaxDevices || src_vec < 0 || bit_vec < 0 || chunk_frames < 0 ||
      chunk_bytes < 0 || chunk_bytes % 16 != 0 ||
      (chunk_frames > 0 && (long long)chunk_frames * S * 2 + 16 > chunk_bytes))
    return (int)cudaErrorInvalidValue;
  const int smem = (src_vec + bit_vec) * (int)sizeof(uint4) + 2 * chunk_bytes;
  if (smem > smem_set[device]) {
    err = cudaFuncSetAttribute(path_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    smem_set[device] = smem;
  }
  if (N > 0)
    path_walk_kernel<<<N, kThreads, smem, (cudaStream_t)stream>>>(
        ring, ring_stride, S, frames, start, costs, (const uint4*)table, src_vec, bit_vec,
        chunk_frames, chunk_bytes, width, stats, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
