// Windowed (cost, arc id) lexicographic-min relaxation over 128-lane step
// tables, for sm_90a (H100): one stream a CTA, alpha in shared memory, the
// step tables staged through a shared-memory ring by bulk copies that a
// thread-block cluster shares.
//
// Replaces the TPU kernel in main() of examples/pallas_windowed_cost.py
// (the decode-relaxation microbenchmark): per frame every destination
// starts at (alpha + 0.5, 0), each step i merges lane j's candidate
// (alpha[sbase[i] + idx[i, j]] + w[i, j], arc[i, j]) into destination
// dbase[i] + j, a lower cost or an equal cost with a lower arc id winning;
// then alpha takes the merged costs and the frame's backpointer row the
// merged arc ids as uint16. The TPU kernel ran BT streams per grid step
// with alpha for all of them in VMEM; a Hopper block has 227 KB of shared
// memory, and alpha double-buffered is 2 x 4 x S_pad bytes (113,664 B at
// S_pad = 14,208), so one CTA owns one stream and streams share their
// table reads across CTAs instead.
//
// What bounds it on this card, and what the design does about each:
//
// - L2 reads of the step tables. Every stream needs the whole table every
//   frame; the first version read it from L2 per stream, 12 bytes a
//   candidate, and ran at the L2's rate. Here a candidate is 8 bytes
//   ((arc << 7) | idx beside the weight), and the streams of a cluster of C
//   CTAs read the table once between them: CTA q copies 1/C of each stage
//   with cp.async.bulk ... .multicast::cluster into the ring of every CTA
//   of the cluster, so each byte leaves L2 once per cluster, and every
//   CTA's "full" mbarrier counts the whole stage's bytes. A slot is
//   refilled when every warp of every CTA of the cluster has arrived on
//   the slot's "empty" mbarrier (mapa + mbarrier.arrive.shared::cluster).
//   The table is read T times, so the ring wraps from frame to frame; the
//   barrier between a frame's alpha buffers stays CTA-local, because
//   streams exchange nothing. Per-stream tables run the same kernel at
//   C = 1 with plain bulk copies of the stream's own table.
// - Instruction throughput. With the table in shared memory the SM's four
//   schedulers are what a round waits for: per candidate an 8-byte read of
//   the ring, the gather alpha[sbase + idx], an add and the (cost, arc id)
//   merge, about 14 instructions, and per stage each warp's wait on the
//   full barrier, its arrival on the empty ones and the ring arithmetic.
//   So a stage is four rounds long, its loads are started together before
//   the merges, the rare rounds that start or end a destination block
//   leave the common path by one branch that is the whole warp's, arc ids
//   are compared as packed words, and the shared-memory base and the
//   thread index are read once (the compiler re-derives them from special
//   registers every stage otherwise). The warps take turns to start the
//   copies, two stages after a slot was read: a single producer thread, or
//   a refill one stage after, holds every warp to the slowest one's pace.
// - Shared-memory traffic comes next: the ring's fill, the 8-byte reads and
//   the gathers go through one pipe. Unlike on the TPU, a step's cost is
//   not independent of the indices: lanes of a warp whose idx fall into
//   one bank (idx mod 32) serialise, about 3.5-fold for uniformly random
//   idx. On the example's tables that costs about 4% (chip_smoke.py times
//   the same tables with idx[i, j] = j beside them).
// - A static schedule makes one copy serve all threads. The host side
//   (ops/windowed_relax_cuda.py, build_schedule) deals the destination
//   blocks to the CTA's 8 groups of 128 threads, balanced by steps, and
//   lays each group's steps in a row: round r holds the step every group
//   executes at the same time, 8 x 128 candidates and per group (4 sbase,
//   4 dbase | flags: byte offsets into alpha; FIRST is the sign bit, LAST
//   bit 0), 8,256 contiguous bytes. Lane j keeps (cost, arc id) of
//   destination dbase + j in registers from the block's FIRST step to its
//   LAST and then writes the next alpha and the backpointer; no two
//   threads ever write one destination, so there are no atomics, and since
//   the merge is a lexicographic minimum the schedule's order gives the
//   same bits as the tables' order.
// - A group's row ends in no-op steps (weight +inf, the largest packed
//   word, no flags). A no-op loses every comparison: its cost is +inf or
//   NaN, never below a destination's, and against a destination at +inf
//   the tie goes to the lower word, which the no-op's never is. A
//   destination block without steps is one no-op round with FIRST and LAST.
//
// Every stream is computed from its own alpha (and its own tables when
// per_stream is set), even where the tables make all streams equal. A
// batch that is no multiple of C leaves CTAs without a stream in the last
// cluster; they copy their share of every stage, walk the last stream's
// alpha and store nothing, so the cluster's barriers see every CTA.
//
// Measured by chip_smoke.py at the example's shape (B=512, T=116, S_pad=
// 14,208, NSTEP=1,280) on an NVIDIA H100 80GB HBM3 at 700 W: 10.6 ms in
// clusters of 2 (66 run at once, four waves), 11.4 ms at C = 1, 13.3 ms at
// C = 4 and 18.1 ms at C = 8, of which the card runs only 30 and 15 at once
// (120 of its 132 SMs, five waves). The bytes the function must move
// (1.69 GB of backpointers) take 0.51 ms.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kLanes = 128;
constexpr int kGroups = 8;
constexpr int kThreads = kLanes * kGroups;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;
constexpr int kCandBytes = kGroups * kLanes * 8;
constexpr int kRoundBytes = kCandBytes + kGroups * 8;
constexpr int kRounds = 4;  // rounds a stage (ops/windowed_relax_cuda.py ROUNDS_PER_STAGE)
constexpr int kStageBytes = kRounds * kRoundBytes;
// A slot is refilled kLag stages after its stage was read, so the producer
// all but never finds a warp still reading it (refilling it one stage
// after, the producer waits for the slowest warp every stage).
constexpr int kLag = 2;
// A round's flags ride on 4 * dbase: FIRST is the sign bit, LAST bit 0.
constexpr unsigned kFirst = 0x80000000u, kLast = 1;
constexpr unsigned kBlockMask = ~kFirst & ~(4u * kLanes - 1);

// The hot loop addresses shared memory by 32-bit shared-window addresses
// off one base and reads the thread index once: left to itself the compiler
// re-derives both from special registers in every stage. A volatile asm
// runs once where it stands.
__device__ __forceinline__ unsigned shared_addr(const void* p) {
  unsigned a;
  asm volatile("{\n .reg .u64 t;\n cvta.to.shared.u64 t, %1;\n cvt.u32.u64 %0, t;\n}"
               : "=r"(a) : "l"(p));
  return a;
}

__device__ __forceinline__ int thread_index() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
  return t;
}

__device__ __forceinline__ uint2 load_shared_u2(unsigned a) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];" : "=r"(v.x), "=r"(v.y) : "r"(a));
  return v;
}

__device__ __forceinline__ float load_shared_f(unsigned a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(a));
  return v;
}

__device__ __forceinline__ void store_shared_f(unsigned a, float v) {
  asm volatile("st.shared.f32 [%0], %1;" ::"r"(a), "f"(v) : "memory");
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes) : "memory");
}

// the address of this CTA's shared-memory address `addr` in CTA `rank`
__device__ __forceinline__ unsigned cluster_addr(unsigned addr, int rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(addr), "r"(rank));
  return remote;
}

// One arrival on a barrier of a CTA of the cluster: this warp's reads of a
// ring slot are done. (A release at cluster scope here would make every
// stage wait for the thread's backpointer stores to land.)
__device__ __forceinline__ void mbar_arrive_remote(unsigned remote_bar) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];" ::"r"(remote_bar) : "memory");
}

// `bytes` (a multiple of 16) from global memory into this CTA's shared
// memory, counted on this CTA's barrier
__device__ __forceinline__ void bulk_copy(unsigned dst, const void* src, unsigned bytes,
                                          unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(__cvta_generic_to_global(src)), "r"(bytes), "r"(bar) : "memory");
}

// the same into every CTA of `mask`, at this CTA's offsets, counted on each
// receiving CTA's own barrier
__device__ __forceinline__ void bulk_copy_multicast(unsigned dst, const void* src,
                                                    unsigned bytes, unsigned bar,
                                                    uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster"
      " [%0], [%1], %2, [%3], %4;"
      ::"r"(dst), "l"(__cvta_generic_to_global(src)), "r"(bytes), "r"(bar), "h"(mask)
      : "memory");
}

__global__ void __launch_bounds__(kThreads, 1) windowed_relax_kernel(
    const unsigned char* __restrict__ schedule,  // [TB, L, kRoundBytes]
    const float* __restrict__ alpha0,            // [B, S_pad] or null (zeros)
    int B, int T, int S_pad,
    int L,         // rounds of the schedule, a multiple of kRounds
    int per_stream,
    int R,         // stages (slots) of the ring
    int ring_off,  // byte offsets into dynamic shared memory; alpha at 0
    int bar_off,
    float* __restrict__ alpha_out,  // [B, S_pad]
    uint16_t* __restrict__ bp) {    // [T, B, S_pad]
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = thread_index();
  const int lane = tid & (kLanes - 1);
  const int group = tid / kLanes;
  // a CTA past the batch walks the last stream and stores nothing
  const bool live = (int)blockIdx.x < B;
  const int b = live ? (int)blockIdx.x : B - 1;

  const unsigned base = shared_addr(smem);
  unsigned cur = base, nxt = base + 4 * S_pad;  // alpha's two buffers
  const int lane4 = 4 * lane;
  const unsigned ring = base + ring_off;
  const unsigned full = base + bar_off;  // [R] mbarriers, then empty [R]
  const unsigned empty = full + 8 * R;
  const unsigned char* table =
      schedule + (per_stream ? (size_t)b * L * kRoundBytes : (size_t)0);
  const int num_stages = L / kRounds;  // a frame's
  const int total = T * num_stages;    // the launch's

  if (tid == 0) {
    for (int s = 0; s < R; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kWarps * C);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int s = tid; s < S_pad; s += kThreads)
    ((float*)smem)[s] = alpha0 ? alpha0[(size_t)b * S_pad + s] : 0.0f;
  // every CTA of the cluster is running and its barriers are set up before
  // any copy or arrival reaches it
  cluster.sync();

  // Stage n of the launch (frame n / num_stages, stage n % num_stages of
  // the schedule) goes to slot n % R. This CTA's share of it: the stage's
  // 16-byte chunks split evenly over the cluster's ranks.
  const unsigned chunks = kStageBytes / 16;
  const unsigned lo = chunks * rank / C * 16, hi = chunks * (rank + 1) / C * 16;
  auto refill = [&](int stage, int slot_n, bool reuse, unsigned reuse_parity) {
    // a refill waits for the arrivals that followed the slot's previous use
    if (reuse) mbar_wait(empty + 8 * slot_n, reuse_parity);
    mbar_expect(full + 8 * slot_n, kStageBytes);
    const unsigned char* src = table + (size_t)stage * kStageBytes + lo;
    const unsigned dst = ring + slot_n * kStageBytes + lo;
    if (C == 1) bulk_copy(dst, src, hi - lo, full + 8 * slot_n);
    else bulk_copy_multicast(dst, src, hi - lo, full + 8 * slot_n, (uint16_t)((1u << C) - 1));
  };
  const int ahead = R - kLag;  // stages in flight before the one being read
  if (tid == 0)
    for (int n = 0; n < ahead && n < total; ++n) refill(n % num_stages, n, false, 0);

  const unsigned my_cand = 8 * tid, my_step = kCandBytes + 8 * group;  // within a round
  // lanes 0..C-1 of every warp tell CTAs 0..C-1 that the warp has read a slot
  const unsigned remote_empty = cluster_addr(empty, (tid & 31) < C ? (tid & 31) : 0);
  int n = 0;                         // the stage being read
  int slot = 0;                      // n % R
  unsigned parity = 0;               // (n / R) & 1
  int p_stage = ahead % num_stages;  // (n + ahead) % num_stages: the stage to copy next
  int producer = 0;                  // the thread that copies it: lane 0 of warp n % 32
  // lane's destination in the group's current block: its best cost, and
  // the packed word (arc << 7) | idx of the arc that gave it
  float bc = 0.0f;
  unsigned bi = 0;
  for (int t = 0; t < T; ++t) {
    uint16_t* row = bp + ((size_t)t * B + b) * S_pad;
    for (int sf = 0; sf < num_stages; ++sf) {
      // refill the slot whose stage was read kLag stages ago, (n - kLag) mod R;
      // the warps take turns, so none falls behind by the copies it starts
      if (tid == producer && n + ahead < total) {
        const bool wrapped = slot < kLag;
        refill(p_stage, wrapped ? slot + ahead : slot - kLag, n >= kLag,
              wrapped ? parity ^ 1u : parity);
      }
      mbar_wait(full + 8 * slot, parity);
      const unsigned stage = ring + slot * kStageBytes;
      uint2 e[kRounds];  // the lane's candidate: packed word, weight's bits
      uint2 m[kRounds];  // the group's step: 4 sbase, 4 dbase | flags
      float g[kRounds];
#pragma unroll
      for (int r = 0; r < kRounds; ++r) {
        e[r] = load_shared_u2(stage + r * kRoundBytes + my_cand);
        m[r] = load_shared_u2(stage + r * kRoundBytes + my_step);
      }
      // candidates read the frame's alpha, results go to the other buffer;
      // the block bases come as byte offsets into an alpha buffer
#pragma unroll
      for (int r = 0; r < kRounds; ++r)
        g[r] = load_shared_f(cur + m[r].x + 4 * (e[r].x & (kLanes - 1)));
#pragma unroll
      for (int r = 0; r < kRounds; ++r) {
        const float c = __fadd_rn(g[r], __uint_as_float(e[r].y));
        // Arc ids are compared as the packed words (arc << 7) | idx, which
        // saves the shift. Where two arc ids are equal the idx bits decide
        // between two candidates of one cost and one arc id: either way
        // the result is that cost and that arc id.
        const unsigned a = e[r].x;
        auto merge = [&]() {
          bool take = a < bi;
          take = (c == bc) & take;
          take = (c < bc) | take;
          bc = take ? c : bc;
          bi = take ? a : bi;
        };
        // Most rounds neither start nor end a block, and the flags are the
        // whole warp's: one branch keeps both cases out of the common path.
        if ((m[r].y & (kFirst | kLast)) == 0) {
          merge();
        } else {
          const unsigned d = (m[r].y & kBlockMask) | lane4;
          if (m[r].y & kFirst) {
            bc = __fadd_rn(load_shared_f(cur + d), 0.5f);
            bi = 0;
          }
          merge();
          if (m[r].y & kLast) {
            store_shared_f(nxt + d, bc);
            if (live) row[d >> 2] = (uint16_t)(bi >> 7);
          }
        }
      }
      // this warp has read the slot: tell every CTA of the cluster
      __syncwarp();
      if ((tid & 31) < C) mbar_arrive_remote(remote_empty + 8 * slot);
      ++n;
      if (++slot == R) {
        slot = 0;
        parity ^= 1u;
      }
      if (++p_stage == num_stages) p_stage = 0;
      producer = (producer + 32) & (kThreads - 1);
    }
    __syncthreads();
    const unsigned tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  if (live)
    for (int s = tid; s < S_pad; s += kThreads)
      alpha_out[(size_t)b * S_pad + s] = load_shared_f(cur + 4 * s);
  // no CTA leaves while another may still arrive on its barriers
  cluster.sync();
}

cudaLaunchConfig_t config(int grid, int smem_bytes, int cluster, cudaLaunchAttribute* attr,
                          cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
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

}  // namespace

extern "C" {

const char* rss_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Shared memory one block may opt into (the kernel has no static arrays).
int rss_windowed_relax_max_smem(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  return optin;
}

// Clusters of this size the card runs at once (0 where it cannot run one).
int rss_windowed_relax_max_clusters(int cluster, int smem_bytes, int device) {
  if (cudaSetDevice(device) != cudaSuccess) return 0;
  if (cudaFuncSetAttribute(windowed_relax_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_bytes) != cudaSuccess)
    return 0;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(cluster, smem_bytes, cluster, attr, 0);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, windowed_relax_kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();  // the query's error is this function's 0, not the next launch's
    return 0;
  }
  return n;
}

int rss_windowed_relax_launch(const unsigned char* schedule, const float* alpha0, int B,
                              int T, int S_pad, int L, int per_stream, int rounds_per_stage,
                              int stages, int ring_off, int bar_off, int smem_bytes,
                              float* alpha_out, uint16_t* bp, int cluster, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (cluster < 1 || cluster > kMaxCluster || (per_stream && cluster != 1) || B < 1 || T < 0 ||
      rounds_per_stage != kRounds || L < kRounds || L % kRounds != 0 ||
      (long long)T * (L / kRounds) > 0x7fffffff - kWarps || stages <= kLag ||
      S_pad % kLanes != 0 || ring_off < 2 * (int)sizeof(float) * S_pad || ring_off % 16 != 0 ||
      bar_off < ring_off + stages * kStageBytes || bar_off % 8 != 0 ||
      smem_bytes < bar_off + 2 * stages * (int)sizeof(uint64_t))
    return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(windowed_relax_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const int grid = (B + cluster - 1) / cluster * cluster;
  const cudaLaunchConfig_t cfg = config(grid, smem_bytes, cluster, attr, (cudaStream_t)stream);
  err = cudaLaunchKernelEx(&cfg, windowed_relax_kernel, schedule, alpha0, B, T, S_pad, L,
                           per_stream, stages, ring_off, bar_off, alpha_out, bp);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
