// Windowed (cost, arc id) lexicographic-min relaxation over 128-lane step
// tables, for sm_90a (H100).
//
// Replaces the TPU kernel in main() of examples/pallas_windowed_cost.py
// (the decode-relaxation microbenchmark): per frame every destination
// starts at (alpha + 0.5, 0), each step i merges lane j's candidate
// (alpha[sbase[i] + idx[i, j]] + w[i, j], arc[i, j]) into destination
// dbase[i] + j, a lower cost or an equal cost with a lower arc id winning;
// then alpha takes the merged costs and the frame's backpointer row the
// merged arc ids as uint16. The TPU kernel ran BT streams per grid step
// with alpha for all of them in VMEM; 32 streams x 14,208 states x 4 B is
// 1.8 MB, far more than a Hopper block's 227 KB of shared memory, so here
// one CTA owns one stream.
//
// Design (one of the two simple ones): the steps are regrouped by
// destination block on the device once per set of tables, before any
// launch (ops/windowed_relax_cuda.py, prepare_steps), and every launch
// reuses the grouping. A 128-thread group owns a destination block at a
// time; lane j merges every step of that block in registers with the
// TPU kernel's strict-< rule and writes the next alpha into a second
// shared buffer. No two threads ever write one destination, so there are
// no atomics, and since the merge is a lexicographic minimum the regrouped
// order gives the same bits as the tables' order. Alpha is double-buffered
// in dynamic shared memory: 2 x 4 x S_pad bytes, 113,664 B at S_pad =
// 14,208, so one CTA per SM.
//
// What bounds it on this card: every stream reads the whole step table
// (NSTEP x 128 x 12 B, ~2 MB at NSTEP = 1,280) once per frame. The tables
// fit the 50 MB L2 but not an SM's L1, so the ~117 GB of table reads at
// the example's shape come from L2; the backpointer rows (1.69 GB) go to
// device memory. The alpha gathers are shared-memory reads. Making it
// fast (narrower tables, several streams per CTA sharing one table read)
// is later work.
//
// Every stream is computed from its own alpha (and its own tables when
// per_stream is set), even where the tables make all streams equal.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;

__global__ void windowed_relax_kernel(
    const int* __restrict__ blk_ptr,    // [TB, nblk + 1]
    const int* __restrict__ sbase,      // [TB, nstep], grouped by dest block
    const int* __restrict__ idx,        // [TB, nstep, 128]
    const float* __restrict__ w,        // [TB, nstep, 128]
    const int* __restrict__ arc,        // [TB, nstep, 128]
    const float* __restrict__ alpha0,   // [B, S_pad] or null (zeros)
    int B, int T, int S_pad, int nstep, int per_stream,
    float* __restrict__ alpha_out,      // [B, S_pad]
    uint16_t* __restrict__ bp) {        // [T, B, S_pad]
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & (kLanes - 1);
  const int group = tid / kLanes;
  const int ngroups = nthreads / kLanes;
  const int nblk = S_pad / kLanes;
  const size_t tb = per_stream ? (size_t)b : 0;
  const int* ptr = blk_ptr + tb * (nblk + 1);
  const int* sb = sbase + tb * nstep;
  const size_t table = tb * (size_t)nstep * kLanes;
  const int* ix = idx + table;
  const float* wt = w + table;
  const int* at = arc + table;

  float* cur = smem;
  float* nxt = smem + S_pad;
  for (int s = tid; s < S_pad; s += nthreads)
    cur[s] = alpha0 ? alpha0[(size_t)b * S_pad + s] : 0.0f;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    uint16_t* row = bp + ((size_t)t * B + b) * S_pad;
    for (int k = group; k < nblk; k += ngroups) {
      const int d = k * kLanes + lane;
      float bc = __fadd_rn(cur[d], 0.5f);
      int bi = 0;
      const int end = ptr[k + 1];
      for (int i = ptr[k]; i < end; ++i) {
        const size_t e = (size_t)i * kLanes + lane;
        const float c = __fadd_rn(cur[sb[i] + ix[e]], wt[e]);
        const int a = at[e];
        if (c < bc || (c == bc && a < bi)) {
          bc = c;
          bi = a;
        }
      }
      nxt[d] = bc;
      row[d] = (uint16_t)bi;
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  for (int s = tid; s < S_pad; s += nthreads)
    alpha_out[(size_t)b * S_pad + s] = cur[s];
}

}  // namespace

extern "C" {

const char* rss_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Largest S_pad (a multiple of 128) whose double-buffered alpha fits one
// block's shared memory.
int rss_windowed_relax_max_states(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  return (optin / (2 * (int)sizeof(float))) / kLanes * kLanes;
}

int rss_windowed_relax_launch(const int* blk_ptr, const int* sbase,
                              const int* idx, const float* w, const int* arc,
                              const float* alpha0, int B, int T, int S_pad,
                              int nstep, int per_stream, float* alpha_out,
                              uint16_t* bp, int threads, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (threads % kLanes != 0 || threads <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * sizeof(float) * (size_t)S_pad;
  err = cudaFuncSetAttribute(windowed_relax_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  windowed_relax_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      blk_ptr, sbase, idx, w, arc, alpha0, B, T, S_pad, nstep, per_stream,
      alpha_out, bp);
  return (int)cudaGetLastError();
}

}  // extern "C"
