// Pitch-lag Viterbi with traceback, for sm_90a (H100): Kaldi's pitch
// tracker's last step, one stream a thread-block cluster.
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
// uint16. Optional: clocks [B, C, 4] int64, each CTA's forward cycles,
// (rank 0) its final argmin and traceback cycles, and thread 0's cycles in
// the min-plus pass and in the merge summed over the frames (the rest of
// the forward is the wait for the frame's barrier).
//
// The recursion, as the reference computes it: fwd_0 = local_0;
// fwd_t[i] = local_t[i] + min_j (fwd_{t-1}[j] + dist[|i - j|]) with the
// backpointer at the FIRST j that reaches the minimum (jnp.argmin); the
// last state is the first argmin of fwd; then the traceback. Only f32 adds
// and compares, so the states are bit-equal to the plain twin's
// (ops/pitch_viterbi_cuda.py:pitch_viterbi_torch) at every tie.
//
// Bound: 2 * B * (T - 1) * NL^2 f32 operations (an add and a compare a
// candidate). The first version (one CTA a stream, a warp an output, five
// shuffles of (cost, j) and a block barrier an output row) spent ~13 lane
// instructions a candidate and left 100 of 132 SMs idle at B = 32. The
// design (ops/pitch_viterbi_cuda.py plan_pitch_viterbi sizes it):
//
// - Register tiles, value-only minimum. Outputs are padded to NLp (a
//   multiple of 8) and cut into strips of R = 8 consecutive i, candidates
//   into blocks of U = 8 consecutive j. A strip has K lanes (K in 8, 16,
//   32, consecutive in a warp); lane mk takes the blocks mk, mk + K, ....
//   Per block it loads the 8 cur[j] and a 16-entry window of a signed
//   distance table distS[i - j + NLp - 1] (|i - j| moves by one along both
//   axes, so one window serves all 64 candidates; 16-byte shared-memory
//   loads, laid out so that the 8 lanes of a quarter-warp hit distinct
//   banks), then does an FADD and an FMNMX a candidate. A strict < at the
//   block's end keeps the lane's first block reaching each running minimum.
// - The merge in registers, then a rescan. Three reduce-scatter rounds of
//   shuffles within each 8 lanes leave lane mk output mk & 7, and the K / 8
//   groups exchange that pair; the merge keeps the lexicographic
//   (min, block) minimum, which is the first block holding the minimum
//   whatever the order. The K / 8 lanes of an output rescan that block's 8
//   candidates with the same f32 adds for the first j whose sum equals the
//   minimum: the backpointer; fwd'[i] = local_t[i] + (cur[j] + dist[|i -
//   j|]) at it. Exact: adds only (nothing can contract into an FMA), the
//   same operands twice. No shared-memory staging and no second barrier a
//   frame.
// - Cluster. The C CTAs of a cluster (C in 1, 2, 4, 8; the wrapper picks
//   C and K from the batch, a table of swept frame times and the card's
//   cudaOccupancyMaxActiveClusters) share a stream: CTA r owns a slice of
//   strips and keeps a full replica of fwd. Each output's lanes push
//   fwd'[i] into every CTA's other buffer with st.async over distributed
//   shared memory, counted in bytes on that CTA's mbarrier
//   (csrc/viterbi.cu's pattern); a CTA starts the next frame when its
//   barrier has counted 4 x NL bytes, so no cluster barrier runs per
//   frame. A cluster of one writes its own buffer; one block barrier a
//   frame either way.
// - Prefetch. Each frame's local row is copied into shared memory with
//   cp.async a frame ahead of its use.
// - The final argmin runs in rank 0 over its replica of the last fwd (the
//   replica is whole, so no cross-CTA merge is needed), and one thread
//   walks the backpointers back through L2 (global bp scratch): 4-11% of a
//   launch on the card (PERF.md), under the 15% that would pay for keeping
//   them in shared memory.
//
// Measured on an H100 (PERF.md, PR 10): the min-plus pass runs at ~31
// candidates a cycle per SM at C = 1 whatever the layout, so a stream's
// frame costs ~4.3 us alone on one SM; clusters of 8 bring it to ~1.6 us
// (one stream) and ~2.7 us (32 streams, two CTAs an SM), where the merge
// and the pushes are as long as the pass.
//
// Rejected: the quadratic transition's lower envelope (O(NL) a frame). Its
// intersection tests are computed in float, and f32 rounding of
// fwd[j] + dist[d] does not keep the monotone-argmin property that makes it
// exact, so it cannot guarantee the reference's first-index backpointers;
// this kernel holds the states bit-equal to the reference's.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kR = 8;  // outputs i a strip
constexpr int kU = 8;  // candidates j a block
constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxCluster = 8;
constexpr int kMaxLags = 4096;
constexpr int kNone = 0x7fffffff;

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

// distS is stored 12 floats a group of 8 (4 unused): lanes whose windows
// start 8 entries apart then hit distinct banks with 16-byte loads
__device__ __forceinline__ int swz(int x) { return (x >> 3) * 12 + (x & 7); }

__device__ __forceinline__ void arm(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"((unsigned)__cvta_generic_to_shared(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void wait_phase(uint64_t* bar, unsigned parity) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  }
}

// v into `dst[i]` of CTA q of the cluster, counted on that CTA's `bar`
__device__ __forceinline__ void push(float* dst, uint64_t* bar, int i, float v, int q) {
  const unsigned at = (unsigned)__cvta_generic_to_shared(dst + i);
  const unsigned at_bar = (unsigned)__cvta_generic_to_shared(bar);
  unsigned ra, rb;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(ra) : "r"(at), "r"(q));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(rb) : "r"(at_bar), "r"(q));
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
               ::"r"(ra), "r"(__float_as_uint(v)), "r"(rb) : "memory");
}

// (min, block) of the lower minimum, the lower block on equal minima
__device__ __forceinline__ void lex_min(float& m, int& b, float om, int ob) {
  if (om < m || (om == m && ob < b)) {
    m = om;
    b = ob;
  }
}

__global__ void __launch_bounds__(kMaxThreads, 1)
pitch_viterbi_kernel(const float* __restrict__ local, const float* __restrict__ dist_g,
                     int T, int NL, int slice_strips, int K,
                     uint16_t* __restrict__ bp, int* __restrict__ states,
                     long long* __restrict__ clocks) {
  // dynamic shared memory, in floats: fwd's two buffers [NLp] each, distS
  // [2 NLp] swizzled to [3 NLp], two local rows [slice_out] each
  // (ops/pitch_viterbi_cuda.py plan_pitch_viterbi)
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t full[2];  // one mbarrier per fwd buffer
  __shared__ float red_cost[kMaxWarps];
  __shared__ int red_arg[kMaxWarps];

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int r = (int)cluster.block_rank();
  const int b = blockIdx.x / C;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int NLp = (NL + kR - 1) / kR * kR, NB = NLp / kU, OFF = NLp - 1;
  const int slice_out = slice_strips * kR;
  const int o_lo = r * slice_out;                       // this CTA's first output
  const int n_out = max(0, min(NL - o_lo, slice_out));  // its real outputs

  float* buf0 = smem;
  float* buf1 = buf0 + NLp;
  float* distS = buf1 + NLp;
  float* lrows = distS + 3 * NLp;

  const float* loc = local + (size_t)b * T * NL;
  uint16_t* bpb = bp + (size_t)b * (T - 1) * NL;
  const unsigned frame_bytes = 4u * (unsigned)NL;

  // distS[x] = dist[|x - OFF|] (+inf past the table: only padded i or j
  // reach it); fwd_0 = local_0, padded j at +inf in both buffers
  for (int x = tid; x < 2 * NLp; x += nthreads) {
    const int d = abs(x - OFF);
    distS[swz(x)] = d < NL ? dist_g[d] : INFINITY;
  }
  for (int j = tid; j < NLp; j += nthreads) {
    buf0[j] = j < NL ? loc[j] : INFINITY;
    buf1[j] = INFINITY;
  }
  if (C > 1 && tid == 0) {
    for (int q = 0; q < 2; ++q)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   ::"r"((unsigned)__cvta_generic_to_shared(&full[q])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (T > 1) arm(&full[1], frame_bytes);  // step 0 writes buffer 1
    if (T > 2) arm(&full[0], frame_bytes);  // step 1 writes buffer 0
  }
  // local row t lands in lrows[(t - 1) % 2] a frame ahead of its use
  auto fetch_row = [&](int t) {
    if (t < T) {
      float* dst = lrows + ((t - 1) & 1) * slice_out;
      for (int o = tid; o < n_out; o += nthreads)
        __pipeline_memcpy_async(dst + o, loc + (size_t)t * NL + o_lo + o, sizeof(float));
    }
    __pipeline_commit();
  };
  fetch_row(1);
  // every CTA of the cluster is running, its tables and barriers are set
  cluster.sync();
  const long long t_start = clock64();
  long long t_pass = 0, t_merge = 0;  // tid 0's cycles in the two phases

  // thread (ms, mk) owns strip r * slice_strips + ms against the blocks
  // mk, mk + K, mk + 2K, ... (a strip's K lanes, K in 8, 16, 32, are
  // consecutive in a warp); after the merge lane mk holds output
  // i0 + (mk & 7) with E - 1 twins (E = K / 8 lanes an output)
  const int ms = tid / K, mk = tid % K, E = K / kR;
  const int strip = r * slice_strips + ms;
  const bool real_strip = ms < slice_strips && strip < NB;
  const int i0 = strip * kR;
  const int oq = mk & 7, oe = mk >> 3;
  const int i = i0 + oq, o = ms * kR + oq;  // the output, its index in the slice
  const bool valid = real_strip && i < NL;
  // lanes 4..7 of each 8 read the upper half of their block first: with
  // blocks mk + K n, the 8 lanes then hit 8 distinct bank groups
  const int h = (mk >> 2) & 1;

  for (int s = 0; s + 1 < T; ++s) {
    // step s: fwd_s in buffer s % 2 -> fwd_{s + 1} in the other one
    const float* cur = (s & 1) ? buf1 : buf0;
    float* nxt = (s & 1) ? buf0 : buf1;
    uint64_t* bar_next = &full[(s + 1) & 1];
    const int t = s + 1;
    __pipeline_wait_prior(0);  // this thread's copies of local row t
    // fwd_s has landed whole: step s - 1 filled full[s % 2]'s phase
    if (C > 1 && s > 0) wait_phase(&full[s & 1], (unsigned)((s - 1) >> 1) & 1u);
    __syncthreads();
    if (C > 1 && s > 0 && tid == 0 && s + 2 < T) arm(&full[s & 1], frame_bytes);  // step s + 1
    const long long t0 = clock64();
    fetch_row(t + 1);  // into the buffer step s - 1 read
    const float* lrow = lrows + ((t - 1) & 1) * slice_out;

    float m[kR];
    int bb[kR];
#pragma unroll
    for (int q = 0; q < kR; ++q) {
      m[q] = INFINITY;
      bb[q] = mk;  // a lane with no block (mk >= NB) loses every tie
    }
    if (real_strip) {
      const float4* cur4 = (const float4*)cur;
      for (int jb = mk; jb < NB; jb += K) {
        const int j0 = jb * kU;
        const float4 a = cur4[2 * jb + h], c = cur4[2 * jb + 1 - h];
        const float4 c0 = h ? c : a, c1 = h ? a : c;
        // distS[i0 + q - (j0 + u) + OFF] = w[q - u + 7]
        const int base = swz(i0 - j0 + NLp - kU);
        const float4 w0 = *(const float4*)(distS + base);
        const float4 w1 = *(const float4*)(distS + base + 4);
        const float4 w2 = *(const float4*)(distS + base + 12);
        const float4 w3 = *(const float4*)(distS + base + 16);
        const float cj[kU] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
        const float w[16] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w,
                             w2.x, w2.y, w2.z, w2.w, w3.x, w3.y, w3.z, w3.w};
#pragma unroll
        for (int q = 0; q < kR; ++q) {
          float mm = m[q];
#pragma unroll
          for (int u = 0; u < kU; ++u) mm = fminf(mm, __fadd_rn(cj[u], w[q - u + kU - 1]));
          if (mm < m[q]) bb[q] = jb;  // strict: the lane's first block reaching it
          m[q] = mm;
        }
      }
    }
    const long long t1 = clock64();

    // the merge in registers: three reduce-scatter rounds within each group
    // of 8 lanes leave lane mk output mk & 7, then the E groups exchange
    // that one pair. The lexicographic (min, block) minimum is the first
    // block holding the minimum, whatever the lanes and the merge order.
#pragma unroll
    for (int n = kR / 2; n >= 1; n >>= 1) {
      const bool upper = (lane & n) != 0;
#pragma unroll
      for (int k = 0; k < n; ++k) {
        const float sm = upper ? m[k] : m[k + n];
        const int sb = upper ? bb[k] : bb[k + n];
        const float km = upper ? m[k + n] : m[k];
        const int kbk = upper ? bb[k + n] : bb[k];
        const float om = __shfl_xor_sync(0xffffffffu, sm, n);
        const int ob = __shfl_xor_sync(0xffffffffu, sb, n);
        m[k] = km;
        bb[k] = kbk;
        lex_min(m[k], bb[k], om, ob);
      }
    }
    for (int off = kR; off < K; off <<= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, m[0], off);
      const int ob = __shfl_xor_sync(0xffffffffu, bb[0], off);
      lex_min(m[0], bb[0], om, ob);
    }
    // the rescan: the E lanes of output i try candidates oe, oe + E, ... of
    // block bb[0] for the first j whose sum equals the minimum
    const float M = m[0];
    const int jb = bb[0];
    int first = kU;
    if (valid) {
      for (int u = oe; u < kU; u += E) {
        const int j = jb * kU + u;
        if (__fadd_rn(cur[j], distS[swz(i - j + OFF)]) == M) {
          first = u;
          break;
        }
      }
    }
    for (int off = kR; off < K; off <<= 1)
      first = min(first, __shfl_xor_sync(0xffffffffu, first, off));
    if (valid && (oe == 0 || oe < C)) {
      const int j = jb * kU + first;
      const float v = __fadd_rn(lrow[o], __fadd_rn(cur[j], distS[swz(i - j + OFF)]));
      if (oe == 0) bpb[(size_t)s * NL + i] = (uint16_t)j;
      if (C == 1) {
        nxt[i] = v;
      } else {
        for (int q = oe; q < C; q += E) push(nxt, bar_next, i, v, q);
      }
    }
    t_pass += t1 - t0;
    t_merge += clock64() - t1;
  }
  __pipeline_wait_prior(0);

  // the last fwd, whole in every CTA
  const float* fin = ((T - 1) & 1) ? buf1 : buf0;
  if (C > 1 && T > 1) wait_phase(&full[(T - 1) & 1], (unsigned)((T - 2) >> 1) & 1u);
  __syncthreads();
  const long long t_fwd = clock64();

  float best = INFINITY;
  int arg = kNone;
  if (r == 0) {
    for (int j = tid; j < NL; j += nthreads) take_min(best, arg, fin[j], j);
    warp_min(best, arg);
    if (lane == 0) {
      red_cost[warp] = best;
      red_arg[warp] = arg;
    }
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < nthreads / 32; ++w) take_min(best, arg, red_cost[w], red_arg[w]);
    }
  }
  __threadfence();  // backpointer rows visible to rank 0's traceback
  cluster.sync();   // and no CTA leaves while a peer may push into it
  if (tid == 0) {
    if (r == 0) {
      // states[t] = bp[t][states[t + 1]]
      int* st = states + (size_t)b * T;
      int sidx = arg;
      st[T - 1] = sidx;
      for (int t = T - 2; t >= 0; --t) {
        sidx = bpb[(size_t)t * NL + sidx];
        st[t] = sidx;
      }
    }
    if (clocks) {
      long long* c = clocks + ((size_t)b * C + r) * 4;
      c[0] = t_fwd - t_start;
      c[1] = r == 0 ? clock64() - t_fwd : 0;
      c[2] = t_pass;
      c[3] = t_merge;
    }
  }
}

cudaLaunchConfig_t config(int grid, int threads, int smem_bytes, int cluster,
                          cudaLaunchAttribute* attr, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

bool valid_shape(int NL, int slice_strips, int K, int cluster, int threads) {
  const int NB = (NL + kR - 1) / kR;
  return NL >= 1 && NL <= kMaxLags && cluster >= 1 && cluster <= kMaxCluster &&
         (K == 8 || K == 16 || K == 32) && slice_strips >= 1 &&
         (long long)slice_strips * cluster >= NB && threads % 32 == 0 &&
         threads <= kMaxThreads && (long long)slice_strips * K <= threads;
}

}  // namespace

extern "C" {

const char* rss_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int rss_pitch_viterbi_max_lags() { return kMaxLags; }

// Clusters of this shape the card runs at once (0 where it cannot run one).
int rss_pitch_viterbi_max_clusters(int cluster, int threads, int smem_bytes, int device) {
  if (cudaSetDevice(device) != cudaSuccess) return 0;
  if (cudaFuncSetAttribute(pitch_viterbi_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_bytes) != cudaSuccess)
    return 0;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(cluster, threads, smem_bytes, cluster, attr, 0);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, pitch_viterbi_kernel, &cfg) != cudaSuccess) return 0;
  return n;
}

int rss_pitch_viterbi_launch(const float* local, const float* dist, int B, int T, int NL,
                             int slice_strips, int K, int cluster, int threads,
                             int smem_bytes, uint16_t* bp, int* states, long long* clocks,
                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!valid_shape(NL, slice_strips, K, cluster, threads))
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || T <= 0) return (int)cudaGetLastError();
  err = cudaFuncSetAttribute(pitch_viterbi_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      config(B * cluster, threads, smem_bytes, cluster, attr, (cudaStream_t)stream);
  err = cudaLaunchKernelEx(&cfg, pitch_viterbi_kernel, local, dist, T, NL, slice_strips, K,
                           bp, states, clocks);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
