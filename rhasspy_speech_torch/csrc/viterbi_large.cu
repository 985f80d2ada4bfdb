// Dense 1-best Viterbi decode for sm_90a (H100) on graphs whose alpha does
// not fit one SM's shared memory: K2's two large-graph bodies.
//
// Replaces, with csrc/viterbi.cu, the TPU kernel
// rhasspy_speech_tpu/ops/pallas_decoder.py (viterbi_pallas -> _make_kernel),
// which keeps alpha on chip for any graph its VMEM holds; the JAX package's
// dense decoder (rhasspy_speech_tpu/ops/decoder.py viterbi) has no size limit
// at all. csrc/viterbi.cu keeps a whole copy of alpha in every CTA of a
// cluster, so it holds at most ~29,000 states (2 x 4 x S bytes of an SM's
// 227 KB). The two bodies here take the rest:
//
// - HALO (GLOBAL = false). The C CTAs of a cluster (C in 2..16; 16 only
//   where the card schedules such a cluster) each own a contiguous slice of
//   destination states and hold in shared memory only their slice's alpha
//   and their halo: the sources of the slice's in-arcs that other CTAs own.
//   The wrapper (ops/viterbi_cuda.py plan_halo) remaps every in-arc's source
//   into the CTA's local index space [own slice, halo] (uint16, like the
//   replicated body's sources) and builds, per state, a push list of the
//   (CTA, local offset) pairs of the halos that hold it. The owner of a state
//   writes its next alpha into its own buffer with a plain store and sends
//   it by st.async only to the CTAs on its push list; each such store counts
//   its 4 bytes on the receiver's mbarrier, which expects 4 x |halo| bytes a
//   frame. A halo is smaller than the graph, so a CTA no longer receives all
//   S values a frame, and a CTA that depends on nobody could run two frames
//   ahead and overwrite a buffer another CTA still reads: a relaxed cluster
//   barrier, arrived at the end of each frame and waited on before the next
//   frame's first push, keeps the cluster within one frame. It orders no
//   memory (the mbarrier carries the data), so no thread waits for its
//   global backpointer stores to land. Reach: about C x 29,000 states less
//   the halos.
// - GLOBAL (GLOBAL = true), for a graph the halo body cannot hold. Alpha is
//   double-buffered in a [2, B, S] f32 scratch that the wrapper allocates;
//   each CTA of a stream's cluster relaxes its slice reading sources from L2
//   (ld.global.cg: L1 is not coherent across SMs), and a cluster barrier
//   (arrive.release / wait.acquire) hands each frame to the next. Simple and
//   right; its speed is later work. Reach: device memory.
//
// What bounds them on this card: as csrc/viterbi.cu, latency per dependent
// frame rather than bytes (log-probs read once, [T, B, S] backpointers
// written once). The halo body keeps csrc/viterbi.cu's relaxation: a thread
// walks a state's in-arcs alone up to thread_deg of them, 8 lanes walk up
// to group_deg, a whole warp walks a hub; lane l of a group of W walks arcs
// l, l + W, ... and the lanes merge by the lexicographic (cost, arc index)
// minimum, which equals the ascending strict-< walk. Unlike it, a thread
// loops over as many states of its slice as the slice has (no register
// arrays, so no cap of 4 states a thread). The resident tables (row
// pointers, packed source and weight, src_pdf, the push lists) go to shared
// memory where they fit beside the two alpha buffers, else they are read
// from L2; a non-compact winner's arc id is read from L2 once per state.
//
// Arithmetic is the reference's, operation for operation, so the result is
// bit-identical to ops/decoder.py's scatter step: am = (-scale) * lp with
// one rounding (__fmul_rn / __fadd_rn), candidate (alpha + am[src_pdf]) + w
// when FOLDED, else (alpha + w) + am[arc_pdf], then min(., 1e30); ties go to
// the lowest arc id; a state is dead when its cost reaches 1e30. The final
// argmin runs per CTA, then across the cluster in rank (= state) order with
// the lowest state index on ties; rank 0 walks the backtrace. A launch may
// start from a carried alpha (alpha0 [B, S]).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

// Everything a launch reads and writes; the wrapper fills it (ops/viterbi_cuda.py
// _LargeArgs, the same fields in the same order). Outside the unnamed
// namespace: the C entry points take it, and a type with internal linkage
// would hide them from the library's symbols.
struct ViterbiLargeArgs {
  const float* lp;           // [B, T, P]
  const int* lengths;        // [B]
  const float* init_w;       // [S]
  const float* alpha0;       // [B, S] carried alpha, or null
  const float* final_w;      // [S]
  const int* in_ptr;         // [S + 1] CSR of in-arcs
  const uint2* in_sw;        // [A] CSR order: {local src | arc << 16, w} (halo), {src, w} (global)
  const int* in_arc;         // [A] CSR order
  const int* in_pdf;         // [A] CSR order (unfolded graphs)
  const uint16_t* src_pdf;   // [S] (folded graphs)
  const int* arc_src;        // [A] by arc id
  const int* slice_state;    // [C + 1]
  const int* halo_ptr;       // [C + 1] (halo)
  const int* push_ptr;       // [S + 1] (halo)
  const int* push_ent;       // [E] cta << 16 | local offset (halo)
  const int* group_ptr;      // [C + 1]
  const int* group_state;    // slice-local index, 8 lanes each
  const int* hub_ptr;        // [C + 1]
  const int* hub_state;      // slice-local index, a warp each
  float* scratch;            // [2, B, S] alpha (global)
  void* bps;                 // [T, B, S] uint16 arc + 2, or int32 arc
  float* alpha_out;          // [B, S]
  int* arc_trace;            // [B, T]
  int* final_state;          // [B]
  float* total_cost;         // [B]
  int thread_deg;
  float neg_scale;
  int B, T, P, S, A;
  // byte offsets into dynamic shared memory (ops/viterbi_cuda.py
  // large_smem_layout); alpha's first buffer is at 0
  int off_alpha1, off_ptr, off_sw, off_spdf, off_pptr, off_pent, smem_bytes, resident;
};

namespace {

using Args = ViterbiLargeArgs;

constexpr float kInf = 1.0e30f;
constexpr int kNone = 0x7fffffff;
constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxCluster = 16;

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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;" ::: "memory");
}

__device__ __forceinline__ void cluster_sync_release_acquire() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

template <bool FOLDED, bool COMPACT, bool GLOBAL>
__global__ void __launch_bounds__(kMaxThreads, 1) viterbi_large_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red_cost[kMaxWarps];
  __shared__ int red_idx[kMaxWarps];
  __shared__ float cl_cost[kMaxCluster];
  __shared__ int cl_idx[kMaxCluster];
  __shared__ __align__(8) uint64_t full[2];  // halo: one mbarrier per alpha buffer

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int r = (int)cluster.block_rank();
  const int b = blockIdx.x / C;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  const int B = a.B, T = a.T, P = a.P, S = a.S;
  const int s_lo = a.slice_state[r], ns = a.slice_state[r + 1] - s_lo;
  const int a_lo = a.in_ptr[s_lo], na = a.in_ptr[s_lo + ns] - a_lo;
  const int len = max(0, min(a.lengths[b], T));
  const float neg_scale = a.neg_scale;

  // The slice's tables. ptr[i] .. ptr[i + 1] - 1 are state i's CSR
  // positions in sw (jbase added gives the graph's CSR position), pptr[i] ..
  // pptr[i + 1] - 1 its push entries in pent: the graph's arrays, or copies
  // in shared memory (positions relative to the slice) where they fit.
  const int* ptr = a.in_ptr + s_lo;
  const uint2* sw = a.in_sw;
  const uint16_t* spdf = a.src_pdf + s_lo;
  const int* pptr = GLOBAL ? nullptr : a.push_ptr + s_lo;
  const int* pent = a.push_ent;
  int jbase = 0;
  if (!GLOBAL && a.resident) {
    int* ptr_s = (int*)(smem + a.off_ptr);
    uint2* sw_s = (uint2*)(smem + a.off_sw);
    for (int i = tid; i <= ns; i += nthreads) ptr_s[i] = ptr[i] - a_lo;
    for (int j = tid; j < na; j += nthreads) sw_s[j] = sw[a_lo + j];
    if (FOLDED) {
      uint16_t* spdf_s = (uint16_t*)(smem + a.off_spdf);
      for (int i = tid; i < ns; i += nthreads) spdf_s[i] = spdf[i];
      spdf = spdf_s;
    }
    const int e_lo = pptr[0], ne = pptr[ns] - e_lo;
    int* pptr_s = (int*)(smem + a.off_pptr);
    int* pent_s = (int*)(smem + a.off_pent);
    for (int i = tid; i <= ns; i += nthreads) pptr_s[i] = pptr[i] - e_lo;
    for (int e = tid; e < ne; e += nthreads) pent_s[e] = pent[e_lo + e];
    ptr = ptr_s;
    sw = sw_s;
    pptr = pptr_s;
    pent = pent_s;
    jbase = a_lo;
  }

  // alpha_e(t) and alpha_e(t + 1): the CTA's local buffers (halo), or the
  // stream's rows of the global scratch
  float* cur = GLOBAL ? a.scratch + (size_t)b * S : (float*)smem;
  float* nxt = GLOBAL ? a.scratch + (size_t)(B + b) * S : (float*)(smem + a.off_alpha1);

  const float* lp_b = a.lp + (size_t)b * T * P;
  // alpha -> alpha_e for frame t (the fold), or alpha itself unfolded
  auto folded_value = [&](float v, float lp_v) {
    return FOLDED ? __fadd_rn(v, __fmul_rn(neg_scale, lp_v)) : v;
  };
  auto load_alpha = [&](unsigned src) { return GLOBAL ? __ldcg(cur + src) : cur[src]; };
  // alpha_e of own state i into buffer `dst`: the global row, or the own
  // local slot and, by st.async counted on `bar` of the receiver, every
  // slot of its push list
  auto push = [&](float* dst, uint64_t* bar, int i, float v) {
    if (GLOBAL) {
      __stcg(dst + s_lo + i, v);
      return;
    }
    dst[i] = v;
    const int e1 = pptr[i + 1];
    if (pptr[i] == e1) return;
    const unsigned base = smem_addr(dst), at_bar = smem_addr(bar);
    for (int e = pptr[i]; e < e1; ++e) {
      const unsigned x = (unsigned)pent[e];
      const unsigned q = x >> 16, at = base + 4u * (x & 0xffffu);
      unsigned ra, rb;
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(ra) : "r"(at), "r"(q));
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(rb) : "r"(at_bar), "r"(q));
      asm volatile(
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
          ::"r"(ra), "r"(__float_as_uint(v)), "r"(rb) : "memory");
    }
  };
  // backpointer of a winner at CSR position bj (slice table); `packed` its
  // sw word
  auto bp_code = [&](float best, int bj, unsigned packed) {
    const bool dead = best >= kInf || bj == kNone;
    if (COMPACT && !GLOBAL) return dead ? 1 : (int)(packed >> 16) + 2;
    if (dead) return COMPACT ? 1 : -1;
    const int arc = __ldg(a.in_arc + bj + jbase);
    return COMPACT ? arc + 2 : arc;
  };
  auto store_bp = [&](size_t row, int i, int code) {
    if (COMPACT) ((uint16_t*)a.bps)[row + s_lo + i] = (uint16_t)code;
    else ((int*)a.bps)[row + s_lo + i] = code;
  };
  // halo: full[q] completes when this CTA's halo of alpha_e has landed in
  // buffer q
  const unsigned halo_bytes = GLOBAL ? 0u : 4u * (unsigned)(a.halo_ptr[r + 1] - a.halo_ptr[r]);
  auto arm = [&](uint64_t* bar) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(smem_addr(bar)), "r"(halo_bytes) : "memory");
  };
  auto wait = [&](uint64_t* bar, unsigned parity) {
    const unsigned at = smem_addr(bar);
    unsigned done = 0;
    while (!done) {
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}"
          : "=r"(done) : "r"(at), "r"(parity) : "memory");
    }
  };
  if (!GLOBAL && tid == 0) {
    for (int q = 0; q < 2; ++q)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(&full[q])) : "memory");
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
    a.alpha_out[(size_t)b * S + s] = alpha;
    argmin_merge(__fadd_rn(alpha, a.final_w[s]), s, fin, fin_s);
  };

  // the alpha this launch starts from: the graph's initial weights, or the
  // alpha a stream carried out of its previous chunk
  const float* start = a.alpha0 ? a.alpha0 + (size_t)b * S : a.init_w;
  if (len == 0) {
    for (int i = tid; i < ns; i += nthreads) final_state_of(i, start[s_lo + i]);
  } else {
    for (int i = tid; i < ns; i += nthreads)
      push(cur, &full[0], i,
           folded_value(start[s_lo + i], FOLDED ? __ldg(lp_b + spdf[i]) : 0.0f));
    if (GLOBAL) cluster_sync_release_acquire();
  }

  // Frame t reads alpha_e(t) (buffer t % 2) and writes alpha_e(t + 1) into
  // the other buffer. Halo: alpha_e(t) is complete in this CTA once full[t
  // % 2] completes its phase t / 2 (the halo) and the block barrier has
  // passed (the own slice); the cluster barrier arrived at the end of frame
  // t - 1 and waited on here keeps every CTA from pushing alpha_e(t + 1)
  // into a buffer another CTA still reads alpha_e(t - 1) from. Global: the
  // release / acquire cluster barrier at the end of each frame.
  for (int t = 0; t < len; ++t) {
    const bool more = t + 1 < len;
    uint64_t* bar_next = &full[(t + 1) & 1];
    if (!GLOBAL) {
      if (t > 0) cluster_wait();
      wait(&full[t & 1], (unsigned)(t >> 1) & 1u);
      __syncthreads();  // own slice landed; every thread saw this phase before it is re-armed
      if (tid == 0 && t + 2 < len) arm(&full[t & 1]);  // for alpha_e(t + 2)
    }

    const float* lp_t = lp_b + (size_t)t * P;
    const float* lp_next = lp_t + P;
    const size_t row = ((size_t)t * B + b) * S;
    auto cand = [&](int j, unsigned& packed) {
      const uint2 e = sw[j];
      packed = e.x;
      float c = __fadd_rn(load_alpha(GLOBAL ? e.x : (e.x & 0xffffu)), __uint_as_float(e.y));
      if (!FOLDED) c = __fadd_rn(c, __fmul_rn(neg_scale, __ldg(lp_t + a.in_pdf[j + jbase])));
      return fminf(c, kInf);
    };
    // ordinary states: one thread each, ascending strict-< walk
    for (int i = tid; i < ns; i += nthreads) {
      const int j0 = ptr[i], j1 = ptr[i + 1];
      if (j1 - j0 > a.thread_deg) continue;
      const float lp_i = (FOLDED && more) ? __ldg(lp_next + spdf[i]) : 0.0f;
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
      if (more) push(nxt, bar_next, i, folded_value(bc, lp_i));
      else final_state_of(i, bc);
      store_bp(row, i, bp_code(bc, bj, bx));
    }
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
          const int j0 = ptr[i], j1 = ptr[i + 1];
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
    relax_groups(a.group_state, a.group_ptr[r], a.group_ptr[r + 1], 8);
    relax_groups(a.hub_state, a.hub_ptr[r], a.hub_ptr[r + 1], 32);
    if (more) {
      if (GLOBAL) cluster_sync_release_acquire();
      else cluster_arrive_relaxed();
    }
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  // past this stream's end: alpha carried, backpointer STAY
  for (int t = len; t < T; ++t) {
    const size_t row = ((size_t)t * B + b) * S + s_lo;
    for (int i = tid; i < ns; i += nthreads) {
      if (COMPACT) ((uint16_t*)a.bps)[row + i] = 0;
      else ((int*)a.bps)[row + i] = -2;
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
  // the backtrace (ops/decoder.py backtrace) by one thread
  const int* asrc = a.arc_src;
  if ((size_t)a.A * sizeof(int) <= (size_t)a.smem_bytes) {
    int* asrc_s = (int*)smem;
    for (int k = tid; k < a.A; k += nthreads) asrc_s[k] = a.arc_src[k];
    __syncthreads();
    asrc = asrc_s;
  }
  if (tid != 0) return;
  fin = cl_cost[0];
  fin_s = cl_idx[0];
  for (int q = 1; q < C; ++q) argmin_merge(cl_cost[q], cl_idx[q], fin, fin_s);
  a.final_state[b] = fin_s;
  a.total_cost[b] = fin;
  int state = fin_s;
  for (int t = T - 1; t >= 0; --t) {
    const size_t at = ((size_t)t * B + b) * S + state;
    const int arc = COMPACT ? (int)((const uint16_t*)a.bps)[at] - 2 : ((const int*)a.bps)[at];
    a.arc_trace[(size_t)b * T + t] = arc;
    if (arc >= 0) state = asrc[arc];
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

// The kernel's attributes for a launch shape: its dynamic shared memory,
// and clusters past the portable 8 where asked for.
template <typename K>
cudaError_t set_attributes(K kernel, int cluster, int smem_bytes) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess || cluster <= 8) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

template <bool FOLDED, bool COMPACT, bool GLOBAL>
int max_clusters(int cluster, int threads, int smem_bytes) {
  auto kernel = viterbi_large_kernel<FOLDED, COMPACT, GLOBAL>;
  if (set_attributes(kernel, cluster, smem_bytes) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(cluster, threads, smem_bytes, cluster, attr, 0);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return n;
}

template <bool FOLDED, bool COMPACT, bool GLOBAL>
cudaError_t launch(const Args& a, int cluster, int threads, cudaStream_t stream) {
  auto kernel = viterbi_large_kernel<FOLDED, COMPACT, GLOBAL>;
  cudaError_t err = set_attributes(kernel, cluster, a.smem_bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(a.B * cluster, threads, a.smem_bytes, cluster, attr, stream);
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* rss_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Dynamic shared memory one block may use beside the kernel's static arrays.
int rss_viterbi_large_max_smem(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  const int static_bytes =
      kMaxWarps * (int)(sizeof(float) + sizeof(int)) +
      kMaxCluster * (int)(sizeof(float) + sizeof(int)) + 2 * (int)sizeof(uint64_t);
  return optin - static_bytes;
}

// sizeof(Args), which the wrapper's ctypes structure must equal.
int rss_viterbi_large_args_size() { return (int)sizeof(ViterbiLargeArgs); }

// Clusters of this shape the card runs at once (0 where it cannot run one).
int rss_viterbi_large_max_clusters(int folded, int compact, int global, int cluster,
                                   int threads, int smem_bytes, int device) {
  if (cudaSetDevice(device) != cudaSuccess) return 0;
#define RSS_MAX(F, K, G) return max_clusters<F, K, G>(cluster, threads, smem_bytes)
  if (global) {
    if (folded && compact) RSS_MAX(true, true, true);
    if (folded) RSS_MAX(true, false, true);
    if (compact) RSS_MAX(false, true, true);
    RSS_MAX(false, false, true);
  }
  if (folded && compact) RSS_MAX(true, true, false);
  if (folded) RSS_MAX(true, false, false);
  if (compact) RSS_MAX(false, true, false);
  RSS_MAX(false, false, false);
#undef RSS_MAX
}

int rss_viterbi_large_launch(const ViterbiLargeArgs* args, int folded, int compact, int global, int cluster,
                             int threads, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (cluster < 1 || cluster > kMaxCluster || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define RSS_LAUNCH(F, K, G) err = launch<F, K, G>(*args, cluster, threads, st)
  if (global) {
    if (folded && compact) RSS_LAUNCH(true, true, true);
    else if (folded) RSS_LAUNCH(true, false, true);
    else if (compact) RSS_LAUNCH(false, true, true);
    else RSS_LAUNCH(false, false, true);
  } else {
    if (folded && compact) RSS_LAUNCH(true, true, false);
    else if (folded) RSS_LAUNCH(true, false, false);
    else if (compact) RSS_LAUNCH(false, true, false);
    else RSS_LAUNCH(false, false, false);
  }
#undef RSS_LAUNCH
  return (int)err;
}

}  // extern "C"
