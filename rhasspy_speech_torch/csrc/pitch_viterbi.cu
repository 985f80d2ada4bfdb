// Pitch-lag Viterbi with traceback, for sm_90a (H100): Kaldi's pitch
// tracker's last step, one stream a thread block.
//
// Has no TPU kernel of its own: it stands in for the XLA scans at the end
// of rhasspy_speech_tpu/ops/pitch.py:pitch_track (the forward scan of
// [B, NL, NL] min-plus steps and the reverse scan of the traceback).
//
// In: local [B, T, NL] f32 (each frame's cost of each log-spaced lag),
// dist [NL] f32 (the transition cost by lag distance: trans[i][j] =
// dist[|i - j|], the reference's float64 (i - j)^2 * factor cast to f32,
// so the table holds the matrix's exact values). Out: states [B, T]
// int32, the lag of each frame on the best path. Scratch: bp [B, T - 1, NL]
// uint16 (NL < 65,536).
//
// The recursion, as the reference computes it: fwd_0 = local_0;
// fwd_t[i] = local_t[i] + min_j (fwd_{t-1}[j] + dist[|i - j|]) with the
// backpointer at the FIRST j that reaches the minimum (jnp.argmin); the
// last state is the first argmin of fwd; then the traceback. Only f32 adds
// and compares, in the reference's order, so the states are bit-equal to
// the plain twin's (ops/pitch_viterbi_cuda.py:pitch_viterbi_torch).
//
// Bound: 2 * B * (T - 1) * NL^2 f32 operations (an add and a compare a
// candidate); local is read once (bytes far below). Design, simple first:
// one block a stream; fwd double-buffered in shared memory beside the
// distance table; each warp owns outputs i in turn, its lanes stride over
// j keeping their first minimum, and five shuffle steps reduce (cost, j)
// with the lower j winning ties. Lane 0 writes fwd' and the uint16
// backpointer; one barrier a frame. After the last frame the block reduces
// the first argmin of fwd and thread 0 walks the backpointers back (a
// chain of dependent loads, in L2). At B = 32 only 32 of 132 SMs work:
// spreading a stream over a cluster, or the quadratic transition's
// lower-envelope structure, is later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

// (cost, j) of the lower cost, the lower j on equal costs
__device__ __forceinline__ void take_min(float& best, int& arg, float ob, int oa) {
  if (ob < best || (ob == best && oa < arg)) {
    best = ob;
    arg = oa;
  }
}

__device__ __forceinline__ void warp_min(float& best, int& arg) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, off);
    const int oa = __shfl_xor_sync(0xffffffffu, arg, off);
    take_min(best, arg, ob, oa);
  }
}

__global__ void __launch_bounds__(kThreads)
pitch_viterbi_kernel(const float* __restrict__ local, const float* __restrict__ dist_g,
                     int T, int NL,
                     uint16_t* __restrict__ bp, int* __restrict__ states) {
  extern __shared__ float smem[];
  float* dist = smem;           // [NL]
  float* cur = smem + NL;       // [NL] fwd of the last frame
  float* nxt = smem + 2 * NL;   // [NL] fwd being built
  __shared__ float red_cost[kWarps];
  __shared__ int red_arg[kWarps];

  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* loc = local + (size_t)b * T * NL;
  uint16_t* bpb = bp + (size_t)b * (T - 1) * NL;
  int* st = states + (size_t)b * T;

  for (int i = threadIdx.x; i < NL; i += kThreads) {
    dist[i] = dist_g[i];
    cur[i] = loc[i];
  }
  __syncthreads();

  for (int t = 1; t < T; ++t) {
    const float* lt = loc + (size_t)t * NL;
    uint16_t* bpt = bpb + (size_t)(t - 1) * NL;
    for (int i = warp; i < NL; i += kWarps) {
      float best = INFINITY;
      int arg = 0x7fffffff;
      if (lane < NL) {
        best = cur[lane] + dist[abs(i - lane)];
        arg = lane;
      }
      for (int j = lane + 32; j < NL; j += 32) {
        const float c = cur[j] + dist[abs(i - j)];
        if (c < best) {  // strict: a lane keeps its first minimum
          best = c;
          arg = j;
        }
      }
      warp_min(best, arg);
      if (lane == 0) {
        nxt[i] = lt[i] + best;
        bpt[i] = (uint16_t)arg;
      }
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  // first argmin of the last frame's fwd
  float best = INFINITY;
  int arg = 0x7fffffff;
  for (int j = threadIdx.x; j < NL; j += kThreads) take_min(best, arg, cur[j], j);
  warp_min(best, arg);
  if (lane == 0) {
    red_cost[warp] = best;
    red_arg[warp] = arg;
  }
  __syncthreads();
  if (warp == 0) {
    best = INFINITY;
    arg = 0x7fffffff;
    if (lane < kWarps) {
      best = red_cost[lane];
      arg = red_arg[lane];
    }
    warp_min(best, arg);
    if (lane == 0) {
      // the traceback: states[t] = bp[t][states[t + 1]]; the backpointers
      // were written by this block before the barriers above
      int s = arg;
      st[T - 1] = s;
      for (int t = T - 2; t >= 0; --t) {
        s = bpb[(size_t)t * NL + s];
        st[t] = s;
      }
    }
  }
}

}  // namespace

extern "C" {

const char* rss_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int rss_pitch_viterbi_max_lags() {
  return (48 * 1024) / (3 * (int)sizeof(float));
}

int rss_pitch_viterbi_launch(const float* local, const float* dist, int B, int T, int NL,
                             uint16_t* bp, int* states, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B > 0 && T > 0 && NL > 0)
    pitch_viterbi_kernel<<<B, kThreads, 3 * NL * sizeof(float), (cudaStream_t)stream>>>(
        local, dist, T, NL, bp, states);
  return (int)cudaGetLastError();
}

}  // extern "C"
