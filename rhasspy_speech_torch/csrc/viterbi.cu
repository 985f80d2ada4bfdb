// Dense 1-best Viterbi decode for sm_90a (H100): one thread-block cluster
// per stream, alpha replicated in every CTA's shared memory, the graph's
// in-arc tables resident in shared memory for the whole launch.
//
// Replaces the TPU kernel rhasspy_speech_tpu/ops/pallas_decoder.py
// (viterbi_pallas -> _make_kernel, tables from PallasDecodeGraph.from_dense):
// a min-plus relaxation per frame that keeps alpha on chip across all T
// frames. The TPU kernel packed in-arcs into self-lane / slot / hub tiers
// because Mosaic gathers only within one 128-lane vreg; on Hopper a gather
// from shared memory has no such limit, so each destination state walks its
// in-arcs through a CSR (ascending arc id) and reads alpha from shared
// memory.
//
// What bounds it on this card: latency, not bytes. The bytes are one read of
// the log-probs and one write of the [T, B, S] backpointers (~44 us at
// 14,200 states, B=32), but every frame is a dependent step, and a frame's
// work is small: ~38,000 arc relaxations, each a shared-memory gather. One
// CTA per stream (the first version) left 100 of 132 SMs idle at B=32 and
// walked each state's in-arc list through four global arrays (L2) per arc.
// The design:
//
// - Cluster. The C CTAs of a cluster (C in 1..8, chosen by the wrapper from
//   the graph's bytes and the batch) share one stream. CTA r owns a
//   contiguous slice of destination states, balanced by arcs + states
//   (ops/viterbi_cuda.py plan_viterbi). Each CTA keeps the whole previous
//   alpha in shared memory. As soon as a thread has relaxed a state it
//   writes the state's next alpha into every CTA's other alpha buffer with
//   st.async over distributed shared memory; each such store counts its 4
//   bytes on the receiving CTA's mbarrier, and a CTA starts the next frame
//   when its barrier has counted all 4 x S bytes. So no cluster-wide barrier
//   runs per frame, and no thread waits for its global stores to land (a
//   cluster barrier's release would). With the pdf-per-source fold the
//   owner adds the next frame's am term before the push, so a frame's
//   relaxation reads alpha_e directly.
// - Resident tables. At launch each CTA copies its slice of the CSR (row
//   pointers, source as uint16, weight, arc id as uint16 in compact mode,
//   src_pdf as uint16) into shared memory; the graph is read once per
//   launch, not once per frame. Where the tables do not fit beside alpha the
//   kernel reads them from global memory (L2) through the same pointers; an
//   unfolded graph reads its per-arc pdf and the log-probs from L2.
// - Prefetch. With the fold, the owner of a state needs the next frame's
//   log-prob at its pdf when it pushes: each thread issues those loads for
//   its states (a gather of the row, into registers) before it relaxes the
//   current frame. A whole-row copy into shared memory would cost the 12 KB
//   that lets a 14,200-state graph's tables fit at C = 4.
// - Balanced lists. A thread walks a state's in-arcs alone only up to
//   thread_deg of them; a state with up to group_deg in-arcs is relaxed by
//   8 lanes of a warp, a larger one (a hub) by a whole warp. Lane l of a
//   group of W walks arcs l, l+W, ... in ascending order, and the lanes
//   merge with the lexicographic (cost, arc index) minimum, which equals
//   the ascending strict-< walk, so the bits do not change. A frame takes
//   as long as its slowest warp, and one thread walking 16 or 200 arcs in a
//   row would set it.
// - The final argmin (per CTA, then across the cluster in rank order) and
//   the backtrace stay in the launch; only [B, T] traces, the backpointers
//   and the final alpha leave it.
//
// Measured on the card (chip_smoke.py, PERF.md): a launch still costs ~2 us
// a frame on the 803-state graph and ~5 us on the 14,200-state one at C = 8.
// In step-by-step timings of variants, shared-memory traffic rather than
// latency set the relaxation, the pushes (each state to C CTAs) were a
// large share of a frame at C = 8, and one thread's backtrace (a chain of
// T dependent L2 loads) was a fixed cost of every launch. Clusters of 4
// with this much shared memory run 30 at a time on an H100, so 32 streams
// take two waves.
//
// A launch may start from a carried alpha (alpha0 [B, S]) instead of the
// graph's initial weights: a stream decoded chunk by chunk keeps its alpha on
// the device, and each chunk is one launch (T = 7 for the streaming
// transcriber). CARRIED is a template parameter, so the batch decode's
// kernels are compiled as they were without it: one run-time select of the
// start pointer measured 1-2% slower at the batch shapes, which
// the instantiation avoids.
//
// Arithmetic is the reference's, operation for operation, so the result is
// bit-identical to ops/decoder.py's scatter step: am = (-scale) * lp with
// one rounding (no FMA contraction: __fmul_rn / __fadd_rn), candidate
// (alpha + am[src_pdf]) + w when FOLDED, else (alpha + w) + am[arc_pdf],
// then min(., 1e30); ties go to the lowest arc id; a state is dead when its
// cost reaches 1e30.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr float kInf = 1.0e30f;
constexpr int kNone = 0x7fffffff;
constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxCluster = 8;
constexpr int kStatesPerThread = 4;  // a slice holds <= 4 x 1024 states

// Byte offsets into dynamic shared memory and its size, computed by the
// wrapper (ops/viterbi_cuda.py smem_layout); alpha's first buffer is at 0.
struct Layout {
  int alpha1, ptr, sw, arc, spdf, bytes, resident;
};

__device__ __forceinline__ bool lex_less(float c, int j, float bc, int bj) {
  return c < bc || (c == bc && j < bj);
}

// (value, index) minimum with the lowest index on ties; index -1 is empty
__device__ __forceinline__ void argmin_merge(float ov, int os, float& best, int& best_s) {
  if (os >= 0 && (best_s < 0 || ov < best || (ov == best && os < best_s))) {
    best = ov;
    best_s = os;
  }
}

template <bool FOLDED, bool COMPACT, bool CARRIED>
__global__ void __launch_bounds__(kMaxThreads, 1) viterbi_kernel(
    const float* __restrict__ lp,            // [B, T, P]
    const int* __restrict__ lengths,         // [B]
    const float* __restrict__ init_w,        // [S]
    const float* __restrict__ alpha0,        // [B, S] carried alpha (CARRIED)
    const float* __restrict__ final_w,       // [S]
    const int* __restrict__ in_ptr,          // [S + 1] CSR of in-arcs
    const uint2* __restrict__ in_sw,         // [A] CSR order: {src | arc << 16, w}
    const int* __restrict__ in_arc,          // [A] CSR order (not COMPACT)
    const int* __restrict__ in_pdf,          // [A] (unfolded graphs)
    const uint16_t* __restrict__ src_pdf,    // [S] (folded graphs)
    const uint16_t* __restrict__ arc_src,    // [A] by arc id
    const int* __restrict__ slice_state,     // [C + 1]
    const int* __restrict__ group_ptr,       // [C + 1]
    const int* __restrict__ group_state,     // slice-local index, 8 lanes each
    const int* __restrict__ hub_ptr,         // [C + 1]
    const int* __restrict__ hub_state,       // slice-local index, a warp each
    int thread_deg, float neg_scale, int B, int T, int P, int S, int A, Layout L,
    void* __restrict__ bps_raw,              // [T, B, S] uint16 or int32
    float* __restrict__ alpha_out,           // [B, S]
    int* __restrict__ arc_trace,             // [B, T]
    int* __restrict__ final_state,           // [B]
    float* __restrict__ total_cost) {        // [B]
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red_cost[kMaxWarps];
  __shared__ int red_idx[kMaxWarps];
  __shared__ float cl_cost[kMaxCluster];
  __shared__ int cl_idx[kMaxCluster];
  __shared__ __align__(8) uint64_t full[2];  // one mbarrier per alpha buffer

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int r = (int)cluster.block_rank();
  const int b = blockIdx.x / C;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  const int s_lo = slice_state[r], ns = slice_state[r + 1] - s_lo;
  const int a_lo = in_ptr[s_lo], na = in_ptr[s_lo + ns] - a_lo;
  const int len = max(0, min(lengths[b], T));

  float* cur = (float*)smem;
  float* nxt = (float*)(smem + L.alpha1);

  // the slice's tables: shared memory when they fit, else global memory;
  // arc indices are slice-local either way (ptr[i] - pbase)
  const int* ptr = in_ptr + s_lo;
  const uint2* sw = in_sw + a_lo;
  const int* arc = in_arc + a_lo;
  const uint16_t* spdf = src_pdf + s_lo;
  int pbase = a_lo;
  if (L.resident) {
    int* ptr_s = (int*)(smem + L.ptr);
    uint2* sw_s = (uint2*)(smem + L.sw);
    for (int i = tid; i <= ns; i += nthreads) ptr_s[i] = ptr[i] - a_lo;
    for (int j = tid; j < na; j += nthreads) sw_s[j] = sw[j];
    if (!COMPACT) {
      int* arc_s = (int*)(smem + L.arc);
      for (int j = tid; j < na; j += nthreads) arc_s[j] = arc[j];
      arc = arc_s;
    }
    if (FOLDED) {
      uint16_t* spdf_s = (uint16_t*)(smem + L.spdf);
      for (int i = tid; i < ns; i += nthreads) spdf_s[i] = spdf[i];
      spdf = spdf_s;
    }
    ptr = ptr_s;
    sw = sw_s;
    pbase = 0;
  }

  const float* lp_b = lp + (size_t)b * T * P;
  // alpha -> alpha_e for frame t (the fold), or alpha itself unfolded
  auto folded_value = [&](float v, float lp_v) {
    return FOLDED ? __fadd_rn(v, __fmul_rn(neg_scale, lp_v)) : v;
  };
  // alpha_e of state s_lo + i into buffer `dst` of every CTA of the
  // cluster; each store counts 4 bytes on that CTA's full[] barrier. A
  // cluster of one stores to its own shared memory, and a block barrier
  // ends its frame.
  auto push = [&](float* dst, uint64_t* bar, int i, float v) {
    if (C == 1) {
      dst[s_lo + i] = v;
      return;
    }
    const unsigned at = (unsigned)__cvta_generic_to_shared(dst + s_lo + i);
    const unsigned at_bar = (unsigned)__cvta_generic_to_shared(bar);
    for (int q = 0; q < C; ++q) {
      unsigned ra, rb;
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(ra) : "r"(at), "r"(q));
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(rb) : "r"(at_bar), "r"(q));
      asm volatile(
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
          ::"r"(ra), "r"(__float_as_uint(v)), "r"(rb) : "memory");
    }
  };
  // backpointer of a winner: CSR index bj; `packed` its sw word (COMPACT)
  auto bp_code = [&](float best, int bj, unsigned packed) {
    const bool dead = best >= kInf || bj == kNone;
    if (COMPACT) return dead ? 1 : (int)(packed >> 16) + 2;
    return dead ? -1 : arc[bj];
  };
  auto store_bp = [&](size_t row, int i, int code) {
    if (COMPACT) ((uint16_t*)bps_raw)[row + s_lo + i] = (uint16_t)code;
    else ((int*)bps_raw)[row + s_lo + i] = code;
  };
  // full[q] completes when all 4 x S bytes of alpha buffer q have landed
  const unsigned frame_bytes = 4u * (unsigned)S;
  auto arm = [&](uint64_t* bar) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"((unsigned)__cvta_generic_to_shared(bar)), "r"(frame_bytes) : "memory");
  };
  auto wait = [&](uint64_t* bar, unsigned parity) {
    const unsigned a = (unsigned)__cvta_generic_to_shared(bar);
    unsigned done = 0;
    while (!done) {
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}"
          : "=r"(done) : "r"(a), "r"(parity) : "memory");
    }
  };
  if (C > 1 && tid == 0) {
    for (int q = 0; q < 2; ++q)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   ::"r"((unsigned)__cvta_generic_to_shared(&full[q])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    arm(&full[0]);  // alpha_e(0)
    arm(&full[1]);  // alpha_e(1)
  }

  // every CTA of the cluster is running (its shared memory may be written),
  // its barriers are armed and its tables are in place
  cluster.sync();

  // per thread: the best final state among the states it finishes
  float fin = 0.0f;
  int fin_s = -1;
  auto final_state_of = [&](int i, float alpha) {
    const int s = s_lo + i;
    alpha_out[(size_t)b * S + s] = alpha;
    argmin_merge(__fadd_rn(alpha, final_w[s]), s, fin, fin_s);
  };

  // the alpha this launch starts from: the graph's initial weights, or the
  // alpha a stream carried out of its previous chunk (every CTA of the
  // cluster loads its own slice of it and pushes it to all, like any frame)
  const float* start = CARRIED ? alpha0 + (size_t)b * S : init_w;
  if (len == 0) {
    for (int i = tid; i < ns; i += nthreads) final_state_of(i, start[s_lo + i]);
  } else {
    for (int i = tid; i < ns; i += nthreads)
      push(cur, &full[0], i,
           folded_value(start[s_lo + i], FOLDED ? __ldg(lp_b + spdf[i]) : 0.0f));
  }

  // Frame t reads buffer t % 2 (alpha_e(t)) once full[t % 2] completes its
  // phase t / 2, and pushes alpha_e(t + 1) into every CTA's other buffer.
  // A CTA can only receive alpha_e(t + 2) into buffer t % 2 after every CTA
  // has pushed all of alpha_e(t + 1), so after every thread has finished
  // reading alpha_e(t): the barrier's byte count is the only frame-to-frame
  // synchronisation, and no thread waits on its global stores. Each thread
  // pushes before it stores its backpointers for the same reason.
  for (int t = 0; t < len; ++t) {
    const bool more = t + 1 < len;
    uint64_t* bar_next = &full[(t + 1) & 1];
    if (C > 1) wait(&full[t & 1], (unsigned)(t >> 1) & 1u);
    __syncthreads();  // every thread has seen this phase before it is re-armed
    if (C > 1 && tid == 0 && t + 2 < len) arm(&full[t & 1]);  // for alpha_e(t + 2)

    const float* lp_t = lp_b + (size_t)t * P;
    const float* lp_next = lp_t + P;
    const size_t row = ((size_t)t * B + b) * S;
    // next frame's log-probs for this thread's states, in flight while it
    // relaxes this frame
    float lp_own[kStatesPerThread];
#pragma unroll
    for (int k = 0; k < kStatesPerThread; ++k) {
      const int i = tid + k * nthreads;
      lp_own[k] = (FOLDED && more && i < ns) ? __ldg(lp_next + spdf[i]) : 0.0f;
    }
    auto cand = [&](int j, unsigned& packed) {
      const uint2 e = sw[j];
      packed = e.x;
      float c = __fadd_rn(cur[e.x & 0xffffu], __uint_as_float(e.y));
      if (!FOLDED) c = __fadd_rn(c, __fmul_rn(neg_scale, __ldg(lp_t + in_pdf[a_lo + j])));
      return fminf(c, kInf);
    };
    // ordinary states: one thread each, ascending strict-< walk
    float best[kStatesPerThread];
    int code[kStatesPerThread];
#pragma unroll
    for (int k = 0; k < kStatesPerThread; ++k) {
      const int i = tid + k * nthreads;
      code[k] = kNone;  // not this thread's, or a group's or a warp's
      if (i >= ns) continue;
      const int j0 = ptr[i] - pbase, j1 = ptr[i + 1] - pbase;
      if (j1 - j0 > thread_deg) continue;
      float bc = kInf;
      int bj = kNone;
      unsigned bx = 0;
      for (int j = j0; j < j1; ++j) {
        unsigned x;
        const float c = cand(j, x);
        if (c < bc) {
          bc = c;
          bj = j;
          bx = x;
        }
      }
      best[k] = bc;
      code[k] = bp_code(bc, bj, bx);
    }
#pragma unroll
    for (int k = 0; k < kStatesPerThread; ++k) {
      if (code[k] == kNone) continue;
      const int i = tid + k * nthreads;
      if (more) push(nxt, bar_next, i, folded_value(best[k], lp_own[k]));
      else final_state_of(i, best[k]);
    }
#pragma unroll
    for (int k = 0; k < kStatesPerThread; ++k)
      if (code[k] != kNone) store_bp(row, tid + k * nthreads, code[k]);
    // the larger lists: groups of `width` lanes, strided, lexicographic merge
    auto relax_groups = [&](const int* list, int lo, int hi, int width) {
      const int per_warp = 32 / width, sub = lane / width, sl = lane % width;
      for (int base = lo + warp * per_warp; base < hi; base += nwarps * per_warp) {
        const int h = base + sub;
        const bool valid = h < hi;
        const int i = valid ? list[h] : 0;
        float bc = kInf;
        int bj = kNone;
        float lp_i = 0.0f;
        if (valid) {
          const int j0 = ptr[i] - pbase, j1 = ptr[i + 1] - pbase;
          if (FOLDED && more && sl == 0) lp_i = __ldg(lp_next + spdf[i]);
          for (int j = j0 + sl; j < j1; j += width) {
            unsigned x;
            const float c = cand(j, x);
            if (c < bc) {
              bc = c;
              bj = j;
            }
          }
        }
        for (int off = width >> 1; off > 0; off >>= 1) {
          const float oc = __shfl_xor_sync(0xffffffffu, bc, off);
          const int oj = __shfl_xor_sync(0xffffffffu, bj, off);
          if (lex_less(oc, oj, bc, bj)) {
            bc = oc;
            bj = oj;
          }
        }
        if (valid && sl == 0) {
          if (more) push(nxt, bar_next, i, folded_value(bc, lp_i));
          else final_state_of(i, bc);
          store_bp(row, i, bp_code(bc, bj, bj == kNone ? 0u : sw[bj].x));
        }
      }
    };
    relax_groups(group_state, group_ptr[r], group_ptr[r + 1], 8);
    relax_groups(hub_state, hub_ptr[r], hub_ptr[r + 1], 32);
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  // past this stream's end: alpha carried, backpointer STAY
  for (int t = len; t < T; ++t) {
    const size_t row = ((size_t)t * B + b) * S + s_lo;
    for (int i = tid; i < ns; i += nthreads) {
      if (COMPACT) ((uint16_t*)bps_raw)[row + i] = 0;
      else ((int*)bps_raw)[row + i] = -2;
    }
  }

  // best final state: lowest index among the minima of alpha + final,
  // per CTA, then over the cluster in rank (= state) order
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, fin, off);
    const int os = __shfl_down_sync(0xffffffffu, fin_s, off);
    argmin_merge(ov, os, fin, fin_s);
  }
  if (lane == 0) {
    red_cost[warp] = fin;
    red_idx[warp] = fin_s;
  }
  __syncthreads();
  if (tid == 0) {
    fin = red_cost[0];
    fin_s = red_idx[0];
    for (int k = 1; k < nwarps; ++k) argmin_merge(red_cost[k], red_idx[k], fin, fin_s);
    *cluster.map_shared_rank(&cl_cost[r], 0) = fin;
    *cluster.map_shared_rank(&cl_idx[r], 0) = fin_s;
  }
  __threadfence();  // backpointer rows visible to rank 0's backtrace
  cluster.sync();
  if (r != 0) return;

  // rank 0: arc_src into its shared memory (free now) when it fits, then
  // the backtrace (ops/decoder.py viterbi_decode back_step) by one thread
  const uint16_t* asrc = arc_src;
  if ((size_t)A * sizeof(uint16_t) <= (size_t)L.bytes) {
    uint16_t* asrc_s = (uint16_t*)smem;
    for (int a = tid; a < A; a += nthreads) asrc_s[a] = arc_src[a];
    __syncthreads();
    asrc = asrc_s;
  }
  if (tid != 0) return;
  fin = cl_cost[0];
  fin_s = cl_idx[0];
  for (int q = 1; q < C; ++q) argmin_merge(cl_cost[q], cl_idx[q], fin, fin_s);
  final_state[b] = fin_s;
  total_cost[b] = fin;
  int state = fin_s;
  for (int t = T - 1; t >= 0; --t) {
    const size_t at = ((size_t)t * B + b) * S + state;
    const int a = COMPACT ? (int)((const uint16_t*)bps_raw)[at] - 2 : ((const int*)bps_raw)[at];
    arc_trace[(size_t)b * T + t] = a;
    if (a >= 0) state = asrc[a];
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

template <bool FOLDED, bool COMPACT>
int max_clusters(int cluster, int threads, int smem_bytes) {
  auto kernel = viterbi_kernel<FOLDED, COMPACT, false>;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_bytes) != cudaSuccess)
    return 0;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      config(cluster, threads, smem_bytes, cluster, attr, 0);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) return 0;
  return n;
}

template <bool FOLDED, bool COMPACT, bool CARRIED>
cudaError_t launch(const float* lp, const int* lengths, const float* init_w,
                   const float* alpha0, const float* final_w, const int* in_ptr,
                   const uint2* in_sw,
                   const int* in_arc, const int* in_pdf,
                   const uint16_t* src_pdf, const uint16_t* arc_src,
                   const int* slice_state, const int* group_ptr, const int* group_state,
                   const int* hub_ptr, const int* hub_state, int thread_deg,
                   float neg_scale, int B, int T, int P, int S, int A,
                   Layout L, int smem_bytes, void* bps, float* alpha_out, int* arc_trace,
                   int* final_state, float* total_cost, int cluster, int threads,
                   cudaStream_t stream) {
  auto kernel = viterbi_kernel<FOLDED, COMPACT, CARRIED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      config(B * cluster, threads, smem_bytes, cluster, attr, stream);
  err = cudaLaunchKernelEx(&cfg, kernel, lp, lengths, init_w, alpha0, final_w, in_ptr, in_sw,
                           in_arc, in_pdf, src_pdf, arc_src, slice_state, group_ptr,
                           group_state, hub_ptr, hub_state, thread_deg, neg_scale, B, T, P,
                           S, A, L, bps,
                           alpha_out, arc_trace, final_state, total_cost);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* rss_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Dynamic shared memory one block may use beside the kernel's static arrays.
int rss_viterbi_max_smem(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  const int static_bytes =
      kMaxWarps * (int)(sizeof(float) + sizeof(int)) +
      kMaxCluster * (int)(sizeof(float) + sizeof(int)) + 2 * (int)sizeof(uint64_t);
  return optin - static_bytes;
}

// Clusters of this shape the card runs at once (0 where it cannot run one).
int rss_viterbi_max_clusters(int folded, int compact, int cluster, int threads,
                             int smem_bytes, int device) {
  if (cudaSetDevice(device) != cudaSuccess) return 0;
  if (folded && compact) return max_clusters<true, true>(cluster, threads, smem_bytes);
  if (folded) return max_clusters<true, false>(cluster, threads, smem_bytes);
  if (compact) return max_clusters<false, true>(cluster, threads, smem_bytes);
  return max_clusters<false, false>(cluster, threads, smem_bytes);
}

int rss_viterbi_launch(const float* lp, const int* lengths, const float* init_w,
                       const float* alpha0, const float* final_w, const int* in_ptr,
                       const uint2* in_sw,
                       const int* in_arc, const int* in_pdf,
                       const uint16_t* src_pdf, const uint16_t* arc_src,
                       const int* slice_state, const int* group_ptr, const int* group_state,
                       const int* hub_ptr, const int* hub_state, int thread_deg,
                       float neg_scale, int B, int T, int P, int S, int A,
                       int folded, int compact, int off_alpha1, int off_ptr, int off_sw,
                       int off_arc, int off_spdf, int tables, int smem_bytes,
                       void* bps, float* alpha_out, int* arc_trace, int* final_state,
                       float* total_cost, int cluster, int threads, int device,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (cluster < 1 || cluster > kMaxCluster || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const Layout L = {off_alpha1, off_ptr, off_sw, off_arc, off_spdf, smem_bytes, tables};
  cudaStream_t st = (cudaStream_t)stream;
#define RSS_VITERBI_ARGS                                                       \
  lp, lengths, init_w, alpha0, final_w, in_ptr, in_sw, in_arc, in_pdf,        \
      src_pdf, arc_src, slice_state, group_ptr, group_state, hub_ptr,          \
      hub_state, thread_deg, neg_scale, B, T, P, S, A, L, smem_bytes, bps,     \
      alpha_out, arc_trace, final_state, total_cost, cluster, threads, st
#define RSS_VITERBI_LAUNCH(CARRIED)                                            \
  if (folded && compact) err = launch<true, true, CARRIED>(RSS_VITERBI_ARGS);  \
  else if (folded) err = launch<true, false, CARRIED>(RSS_VITERBI_ARGS);       \
  else if (compact) err = launch<false, true, CARRIED>(RSS_VITERBI_ARGS);      \
  else err = launch<false, false, CARRIED>(RSS_VITERBI_ARGS)
  if (alpha0) {
    RSS_VITERBI_LAUNCH(true);
  } else {
    RSS_VITERBI_LAUNCH(false);
  }
#undef RSS_VITERBI_LAUNCH
#undef RSS_VITERBI_ARGS
  return (int)err;
}

}  // extern "C"
