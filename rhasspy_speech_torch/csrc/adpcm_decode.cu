// IMA block-ADPCM decode for the stream scheduler's 4-bit serving wire, for
// sm_90a (H100).
//
// Has no TPU kernel of its own: it stands in for the lax.scan of
// rhasspy_speech_tpu/ops/adpcm.py decode_blocks_jnp, which XLA fuses into the
// serving tick ahead of the MFCC. Its plain twin is
// rhasspy_speech_torch/ops/adpcm.py decode_blocks_torch; the two are
// bit-equal (exact int32 arithmetic, f32 output of int16-range integers).
//
// Input: N rows of nb blocks of bpb = 3 + ceil((block - 1) / 2) bytes (the
// int16 first sample little-endian, the initial step index, then the
// nibbles of samples 1..block-1, low nibble first); a row starts every
// in_stride bytes (the upload batch carries the tick's meta columns after
// the wire bytes). Output: f32 [N, out_stride], row n's block j at
// n * out_stride + j * block.
//
// What bounds it: latency. A block's samples are a chain of block - 1
// dependent steps (159 at the 160-sample block), and the bytes are tiny
// (the flagship tick's [32, 830] bytes: 320 blocks, 26.6 KB in, 205 KB
// out). A first version ran each block's chain serially on one thread:
// 0.0276 ms of device time at that shape, ~300 cycles a step; this design,
// which cuts the chain with a scan, takes 0.0046 ms (both on an NVIDIA
// H100 80GB HBM3 at 700 W; PERF.md):
//
// - Both recurrences of a block are clamped adds, f(x) = min(max(x + a, l),
//   h): the step index idx_t = clamp(idx_{t-1} + D(code_t), 0, 88), and,
//   once the indices are known, the predictor pred_t = clamp(pred_{t-1} +-
//   dq(step[idx_{t-1}], code_t), -32768, 32767). Such maps compose in
//   closed form, (a1, l1, h1) then (a2, l2, h2) = (a1 + a2, clamp(l1 + a2,
//   l2, h2), clamp(h1 + a2, l2, h2)), exactly in int32.
// - One warp decodes one (row, block). Lane j owns K = ceil((block - 1) /
//   32) consecutive steps (5 at block 160). It composes its steps' index
//   maps, joins a warp scan of the maps (__shfl_up_sync, 5 rounds), applies
//   its exclusive prefix to the header's index, re-walks its steps for the
//   indices and increments, composes its predictor maps, joins a second
//   scan from the header's sample, and walks once more to emit its samples.
// - The warp stages the block's bytes in shared memory, with neighbouring
//   lanes on neighbouring bytes, and writes its samples into a shared row
//   that it then stores with neighbouring lanes on neighbouring addresses.
//   The 89-entry step table sits in shared memory (the lanes' indices
//   differ; constant memory would serialize them). kWarps blocks a CTA:
//   the tick's 320 blocks are 80 CTAs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // (row, block) chains a CTA, one warp each
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxDevices = 64;
// an identity map's bounds; and a sum of adds is saturated at kSat: past
// it any input of the int16 range lands on a bound, so the value of every
// composed map on that range is unchanged, and no sum leaves int32
constexpr int kBig = 1 << 29;
constexpr int kSat = 1 << 20;

__constant__ int kStepTable[89] = {
    7,     8,     9,     10,    11,    12,    13,    14,    16,    17,    19,    21,    23,
    25,    28,    31,    34,    37,    41,    45,    50,    55,    60,    66,    73,    80,
    88,    97,    107,   118,   130,   143,   157,   173,   190,   209,   230,   253,   279,
    307,   337,   371,   408,   449,   494,   544,   598,   658,   724,   796,   876,   963,
    1060,  1166,  1282,  1411,  1552,  1707,  1878,  2066,  2272,  2499,  2749,  3024,  3327,
    3660,  4026,  4428,  4871,  5358,  5894,  6484,  7132,  7845,  8630,  9493,  10442, 11487,
    12635, 13899, 15289, 16818, 18500, 20350, 22385, 24623, 27086, 29794, 32767};

// x -> min(max(x + a, l), h)
struct ClampAdd {
  int a, l, h;
};

__device__ __forceinline__ int clampi(int x, int l, int h) { return min(max(x, l), h); }

__device__ __forceinline__ int apply(ClampAdd f, int x) { return clampi(x + f.a, f.l, f.h); }

// f, then g
__device__ __forceinline__ ClampAdd then(ClampAdd f, ClampAdd g) {
  return {clampi(f.a + g.a, -kSat, kSat), clampi(f.l + g.a, g.l, g.h), clampi(f.h + g.a, g.l, g.h)};
}

// The composition of the maps of lanes 0..lane-1 (identity on lane 0).
__device__ __forceinline__ ClampAdd exclusive_scan(ClampAdd f, int lane) {
  for (int off = 1; off < 32; off <<= 1) {
    const ClampAdd g = {__shfl_up_sync(0xffffffffu, f.a, off),
                        __shfl_up_sync(0xffffffffu, f.l, off),
                        __shfl_up_sync(0xffffffffu, f.h, off)};
    if (lane >= off) f = then(g, f);
  }
  ClampAdd e = {__shfl_up_sync(0xffffffffu, f.a, 1), __shfl_up_sync(0xffffffffu, f.l, 1),
                __shfl_up_sync(0xffffffffu, f.h, 1)};
  if (lane == 0) e = {0, -kBig, kBig};
  return e;
}

// step t's nibble (t >= 1): low nibble first
__device__ __forceinline__ int nibble(const uint8_t* b, int t) {
  const int byte = b[3 + ((t - 1) >> 1)];
  return (t & 1) ? (byte & 0xF) : (byte >> 4);
}

// codes 0-3 step the index by -1, codes 4-7 by 2 * (code - 3)
__device__ __forceinline__ int index_delta(int code) { return code < 4 ? -1 : 2 * (code - 3); }

__device__ __forceinline__ int dequant(int step, int code) {
  int dq = step >> 3;
  if (code & 4) dq += step;
  if (code & 2) dq += step >> 1;
  if (code & 1) dq += step >> 2;
  return dq;
}

__global__ void __launch_bounds__(kThreads)
adpcm_decode_kernel(const uint8_t* __restrict__ in, int in_stride, int nb, int block, int bpb,
                    int total, float* __restrict__ out, int out_stride) {
  extern __shared__ int smem[];
  int* steps = smem;                                          // [89]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* row = (float*)(smem + 96) + warp * block;            // [kWarps][block]
  uint8_t* b = (uint8_t*)((float*)(smem + 96) + kWarps * block) + warp * bpb;  // [kWarps][bpb]
  for (int i = threadIdx.x; i < 89; i += kThreads) steps[i] = kStepTable[i];
  const int g = blockIdx.x * kWarps + warp;
  const long long src = (long long)(g / nb) * in_stride + (long long)(g % nb) * bpb;
  if (g < total)
    for (int i = lane; i < bpb; i += 32) b[i] = in[src + i];
  __syncthreads();
  if (g >= total) return;  // no block barrier below: each warp is on its own

  int pred0 = (int)b[0] | ((int)b[1] << 8);
  pred0 -= 2 * (pred0 & 0x8000);
  const int idx0 = min((int)b[2], 88);
  const int K = (block - 1 + 31) >> 5;
  const int t0 = 1 + lane * K;
  const int t1 = min(t0 + K, block);  // this lane's steps: [t0, t1)

  // the index maps
  ClampAdd f = {0, -kBig, kBig};
  for (int t = t0; t < t1; ++t) f = then(f, {index_delta(nibble(b, t) & 7), 0, 88});
  const int idx_start = apply(exclusive_scan(f, lane), idx0);
  // the predictor maps, their increments from the walked indices
  f = {0, -kBig, kBig};
  for (int t = t0, idx = idx_start; t < t1; ++t) {
    const int nib = nibble(b, t), code = nib & 7;
    const int dq = dequant(steps[idx], code);
    f = then(f, {(nib & 8) ? -dq : dq, -32768, 32767});
    idx = clampi(idx + index_delta(code), 0, 88);
  }
  int pred = apply(exclusive_scan(f, lane), pred0);
  // the samples
  if (lane == 0) row[0] = (float)pred0;
  for (int t = t0, idx = idx_start; t < t1; ++t) {
    const int nib = nibble(b, t), code = nib & 7;
    const int dq = dequant(steps[idx], code);
    pred = clampi(pred + ((nib & 8) ? -dq : dq), -32768, 32767);
    row[t] = (float)pred;
    idx = clampi(idx + index_delta(code), 0, 88);
  }
  __syncwarp();
  float* dst = out + (long long)(g / nb) * out_stride + (long long)(g % nb) * block;
  for (int s = lane; s < block; s += 32) dst[s] = row[s];
}

}  // namespace

extern "C" {

const char* rss_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Shared memory a CTA uses at this block size.
int rss_adpcm_decode_smem(int block, int bpb) {
  return 96 * (int)sizeof(int) + kWarps * block * (int)sizeof(float) + kWarps * bpb;
}

// in: N rows of nb * bpb wire bytes, in_stride bytes apart; out: f32, rows
// out_stride floats apart (>= nb * block).
int rss_adpcm_decode_launch(const uint8_t* in, int in_stride, int N, int nb, int block,
                            float* out, int out_stride, int device, void* stream) {
  static int smem_set[kMaxDevices] = {0};
  const int bpb = 3 + block / 2;  // 3 + ceil((block - 1) / 2)
  if (device < 0 || device >= kMaxDevices || N < 0 || nb < 0 || block < 2 ||
      in_stride < nb * bpb || out_stride < nb * block)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int smem = rss_adpcm_decode_smem(block, bpb);
  if (smem > 48 * 1024 && smem > smem_set[device]) {
    err = cudaFuncSetAttribute(adpcm_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    smem_set[device] = smem;
  }
  const long long total = (long long)N * nb;
  if (total > 0)
    adpcm_decode_kernel<<<(unsigned)((total + kWarps - 1) / kWarps), kThreads, smem,
                          (cudaStream_t)stream>>>(in, in_stride, nb, block, bpb, (int)total, out,
                                                  out_stride);
  return (int)cudaGetLastError();
}

}  // extern "C"
