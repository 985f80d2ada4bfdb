// Dense 1-best Viterbi decode with alpha resident in shared memory, for
// sm_90a (H100).
//
// Replaces the TPU kernel rhasspy_speech_tpu/ops/pallas_decoder.py
// (viterbi_pallas -> _make_kernel, tables from PallasDecodeGraph.from_dense):
// a min-plus relaxation per frame that keeps alpha on chip across all T
// frames. The TPU kernel packed in-arcs into self-lane / slot / hub tiers
// because Mosaic gathers only within one 128-lane vreg; on Hopper a gather
// from shared memory has no such limit, so each state simply walks its
// in-arcs through a CSR (ascending arc id) and reads alpha from shared
// memory.
//
// What bounds it on this card: one CTA per stream, so a batch of B streams
// occupies B of the 132 SMs; each frame is a dependent step (two block
// barriers), and the per-arc reads (source, weight, arc id) come from
// global memory through L2 (the graph is shared by every CTA and stays in
// the 50 MB L2). The per-frame backpointer row [S] is the only large write.
// The design keeps alpha (2 x 4 x S bytes, double-buffered) in dynamic
// shared memory -- 113 KB at 14,178 states -- so no alpha byte touches
// device memory between frames, and fuses the final argmin and the
// backtrace into the same launch so only [B, T] traces leave the kernel.
//
// Arithmetic is the reference's, operation for operation, so the result is
// bit-identical to ops/decoder.py's scatter step: am = (-scale) * lp with
// one rounding (no FMA contraction: __fmul_rn / __fadd_rn), candidate
// (alpha + am[src_pdf]) + w when FOLDED, else (alpha + w) + am[arc_pdf],
// then min(., 1e30); ties go to the lowest arc id (in-arcs are visited in
// ascending id and only a strictly lower cost replaces the best); a state
// is dead when its cost reaches 1e30.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInf = 1.0e30f;
constexpr int kMaxWarps = 32;

template <bool FOLDED, bool COMPACT>
__global__ void viterbi_kernel(
    const float* __restrict__ lp,        // [B, T, P]
    const int* __restrict__ lengths,     // [B]
    const float* __restrict__ init_w,    // [S]
    const float* __restrict__ final_w,   // [S]
    const int* __restrict__ in_ptr,      // [S + 1]
    const int* __restrict__ in_src,      // [A] CSR order
    const float* __restrict__ in_w,      // [A]
    const int* __restrict__ in_arc,      // [A]
    const int* __restrict__ in_pdf,      // [A] (unfolded graphs)
    const int* __restrict__ src_pdf,     // [S] (folded graphs)
    const int* __restrict__ arc_src,     // [A] by arc id
    float neg_scale, int B, int T, int P, int S, int A,
    void* __restrict__ bps_raw,          // [T, B, S] uint16 or int32
    float* __restrict__ alpha_out,       // [B, S]
    int* __restrict__ arc_trace,         // [B, T]
    int* __restrict__ final_state,       // [B]
    float* __restrict__ total_cost) {    // [B]
  extern __shared__ float smem[];
  __shared__ float red_cost[kMaxWarps];
  __shared__ int red_idx[kMaxWarps];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  float* cur = smem;
  float* nxt = smem + S;
  const int len = lengths[b];

  for (int s = tid; s < S; s += nthreads) cur[s] = init_w[s];
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const size_t row = ((size_t)t * B + b) * S;
    if (t >= len) {
      // past this stream's end: alpha carried, backpointer STAY
      for (int s = tid; s < S; s += nthreads) {
        if (COMPACT) ((uint16_t*)bps_raw)[row + s] = 0;
        else ((int*)bps_raw)[row + s] = -2;
      }
      continue;
    }
    const float* lp_t = lp + ((size_t)b * T + t) * P;
    if (FOLDED) {
      // the am fold, in place: cur becomes alpha_e for this frame only
      for (int s = tid; s < S; s += nthreads)
        cur[s] = __fadd_rn(cur[s], __fmul_rn(neg_scale, __ldg(lp_t + src_pdf[s])));
      __syncthreads();
    }
    for (int s = tid; s < S; s += nthreads) {
      float best = kInf;
      int best_arc = A;
      const int end = in_ptr[s + 1];
      for (int j = in_ptr[s]; j < end; ++j) {
        float c = __fadd_rn(cur[in_src[j]], in_w[j]);
        if (!FOLDED) c = __fadd_rn(c, __fmul_rn(neg_scale, __ldg(lp_t + in_pdf[j])));
        c = fminf(c, kInf);
        if (c < best) {
          best = c;
          best_arc = in_arc[j];
        }
      }
      nxt[s] = best;
      const bool dead = best >= kInf || best_arc >= A;
      if (COMPACT) ((uint16_t*)bps_raw)[row + s] = (uint16_t)(dead ? 1 : best_arc + 2);
      else ((int*)bps_raw)[row + s] = dead ? -1 : best_arc;
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  // best final state: lowest index among the minima of alpha + final
  float best = 0.0f;
  int best_s = -1;
  for (int s = tid; s < S; s += nthreads) {
    alpha_out[(size_t)b * S + s] = cur[s];
    const float v = __fadd_rn(cur[s], final_w[s]);
    if (best_s < 0 || v < best) {
      best = v;
      best_s = s;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, best, off);
    const int os = __shfl_down_sync(0xffffffffu, best_s, off);
    if (os >= 0 && (best_s < 0 || ov < best || (ov == best && os < best_s))) {
      best = ov;
      best_s = os;
    }
  }
  const int warp = tid >> 5;
  if ((tid & 31) == 0) {
    red_cost[warp] = best;
    red_idx[warp] = best_s;
  }
  __syncthreads();  // also publishes every backpointer row to thread 0
  if (tid != 0) return;
  best = red_cost[0];
  best_s = red_idx[0];
  for (int w = 1; w < (nthreads + 31) / 32; ++w) {
    const float ov = red_cost[w];
    const int os = red_idx[w];
    if (os >= 0 && (best_s < 0 || ov < best || (ov == best && os < best_s))) {
      best = ov;
      best_s = os;
    }
  }
  final_state[b] = best_s;
  total_cost[b] = best;

  // backtrace (ops/decoder.py viterbi_decode back_step)
  int state = best_s;
  for (int t = T - 1; t >= 0; --t) {
    const size_t at = ((size_t)t * B + b) * S + state;
    const int arc = COMPACT ? (int)((const uint16_t*)bps_raw)[at] - 2
                            : ((const int*)bps_raw)[at];
    arc_trace[(size_t)b * T + t] = arc;
    if (arc >= 0) state = arc_src[arc];
  }
}

template <bool FOLDED, bool COMPACT>
cudaError_t launch(const float* lp, const int* lengths, const float* init_w,
                   const float* final_w, const int* in_ptr, const int* in_src,
                   const float* in_w, const int* in_arc, const int* in_pdf,
                   const int* src_pdf, const int* arc_src, float neg_scale,
                   int B, int T, int P, int S, int A, void* bps,
                   float* alpha_out, int* arc_trace, int* final_state,
                   float* total_cost, int threads, cudaStream_t stream) {
  const size_t smem = 2 * sizeof(float) * (size_t)S;
  auto kernel = viterbi_kernel<FOLDED, COMPACT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<B, threads, smem, stream>>>(
      lp, lengths, init_w, final_w, in_ptr, in_src, in_w, in_arc, in_pdf,
      src_pdf, arc_src, neg_scale, B, T, P, S, A, bps, alpha_out, arc_trace,
      final_state, total_cost);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* rss_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Largest S whose double-buffered alpha fits one block's shared memory.
int rss_viterbi_max_states(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  const int static_bytes = kMaxWarps * (int)(sizeof(float) + sizeof(int));
  return (optin - static_bytes) / (2 * (int)sizeof(float));
}

int rss_viterbi_launch(const float* lp, const int* lengths,
                       const float* init_w, const float* final_w,
                       const int* in_ptr, const int* in_src, const float* in_w,
                       const int* in_arc, const int* in_pdf,
                       const int* src_pdf, const int* arc_src,
                       float neg_scale, int B, int T, int P, int S, int A,
                       int folded, int compact, void* bps, float* alpha_out,
                       int* arc_trace, int* final_state, float* total_cost,
                       int threads, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
#define RSS_VITERBI_ARGS                                                    \
  lp, lengths, init_w, final_w, in_ptr, in_src, in_w, in_arc, in_pdf,       \
      src_pdf, arc_src, neg_scale, B, T, P, S, A, bps, alpha_out, arc_trace, \
      final_state, total_cost, threads, st
  if (folded && compact) err = launch<true, true>(RSS_VITERBI_ARGS);
  else if (folded) err = launch<true, false>(RSS_VITERBI_ARGS);
  else if (compact) err = launch<false, true>(RSS_VITERBI_ARGS);
  else err = launch<false, false>(RSS_VITERBI_ARGS);
#undef RSS_VITERBI_ARGS
  return (int)err;
}

}  // extern "C"
