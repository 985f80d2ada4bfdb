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
// What bounds it: latency. A block's samples are a chain of dependent
// steps (each step's predictor and step index feed the next), 159 at the
// 160-sample block; the bytes are tiny (at the tick's 32 x 5 blocks a slot,
// 13 KB in and 102 KB out). Design:
//
// - One thread runs one (row, block) recurrence, so every block of every
//   slot runs at once; a CTA holds kWarp lane-blocks and the grid spreads
//   over the SMs (the tick's 2,656 blocks are 83 CTAs).
// - The CTA first copies its lane-blocks' bytes into shared memory with
//   neighbouring threads on neighbouring bytes, so the step loop reads its
//   nibbles from shared memory, and the 89-entry step table sits in shared
//   memory too (the index is per thread; constant memory would serialize
//   the warp's different indices). The index table is arithmetic: codes
//   0-3 step the index by -1, codes 4-7 by 2 * (code - 3).
// - Each thread writes its samples into a shared-memory tile whose rows are
//   block + 1 words apart (odd, so the 32 threads of a step hit 32 banks),
//   and the CTA then stores the tile with neighbouring threads on
//   neighbouring addresses.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;  // lane-blocks (threads) a CTA
constexpr int kMaxDevices = 64;

__constant__ int kStepTable[89] = {
    7,     8,     9,     10,    11,    12,    13,    14,    16,    17,    19,    21,    23,
    25,    28,    31,    34,    37,    41,    45,    50,    55,    60,    66,    73,    80,
    88,    97,    107,   118,   130,   143,   157,   173,   190,   209,   230,   253,   279,
    307,   337,   371,   408,   449,   494,   544,   598,   658,   724,   796,   876,   963,
    1060,  1166,  1282,  1411,  1552,  1707,  1878,  2066,  2272,  2499,  2749,  3024,  3327,
    3660,  4026,  4428,  4871,  5358,  5894,  6484,  7132,  7845,  8630,  9493,  10442, 11487,
    12635, 13899, 15289, 16818, 18500, 20350, 22385, 24623, 27086, 29794, 32767};

__global__ void __launch_bounds__(kWarp)
adpcm_decode_kernel(const uint8_t* __restrict__ in, int in_stride, int nb, int block, int bpb,
                    int total, float* __restrict__ out, int out_stride) {
  extern __shared__ int smem[];
  int* steps = smem;                       // [89]
  float* tile = (float*)(smem + 96);       // [kWarp][block + 1]
  uint8_t* bytes = (uint8_t*)(tile + kWarp * (block + 1));  // [kWarp][bpb]
  const int g0 = blockIdx.x * kWarp;
  const int count = min(kWarp, total - g0);
  for (int i = threadIdx.x; i < 89; i += kWarp) steps[i] = kStepTable[i];
  for (int i = threadIdx.x; i < count * bpb; i += kWarp) {
    const int g = g0 + i / bpb;
    bytes[i] = in[(long long)(g / nb) * in_stride + (long long)(g % nb) * bpb + i % bpb];
  }
  __syncthreads();
  if (threadIdx.x < count) {
    const uint8_t* b = bytes + threadIdx.x * bpb;
    float* row = tile + threadIdx.x * (block + 1);
    int pred = (int)b[0] | ((int)b[1] << 8);
    pred -= 2 * (pred & 0x8000);
    int idx = min((int)b[2], 88);
    row[0] = (float)pred;
    for (int t = 1; t < block; ++t) {
      const int byte = b[3 + ((t - 1) >> 1)];
      const int nib = (t & 1) ? (byte & 0xF) : (byte >> 4);
      const int code = nib & 7;
      const int step = steps[idx];
      int dq = step >> 3;
      if (code & 4) dq += step;
      if (code & 2) dq += step >> 1;
      if (code & 1) dq += step >> 2;
      pred = min(max(pred + ((nib & 8) ? -dq : dq), -32768), 32767);
      row[t] = (float)pred;
      idx = min(max(idx + (code < 4 ? -1 : 2 * (code - 3)), 0), 88);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < count * block; i += kWarp) {
    const int g = g0 + i / block;
    const int s = i % block;
    out[(long long)(g / nb) * out_stride + (long long)(g % nb) * block + s] =
        tile[(i / block) * (block + 1) + s];
  }
}

}  // namespace

extern "C" {

const char* rss_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Shared memory a CTA uses at this block size (the wrapper reports it).
int rss_adpcm_decode_smem(int block, int bpb) {
  return 96 * (int)sizeof(int) + kWarp * (block + 1) * (int)sizeof(float) + kWarp * bpb;
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
    adpcm_decode_kernel<<<(unsigned)((total + kWarp - 1) / kWarp), kWarp, smem,
                          (cudaStream_t)stream>>>(in, in_stride, nb, block, bpb, (int)total, out,
                                                  out_stride);
  return (int)cudaGetLastError();
}

}  // extern "C"
