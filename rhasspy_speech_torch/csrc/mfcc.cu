// Fused MFCC frontend for sm_90a (H100): PCM in, cepstra out.
//
// Replaces the TPU kernel rhasspy_speech_tpu/ops/pallas_mfcc.py
// (mfcc_pallas -> _kernel). Per frame, in order: DC removal, raw log
// energy, pre-emphasis, window, processed log energy, power spectrum of
// the zero-padded frame, mel filterbank, log floor at FLT_EPSILON, DCT,
// lifter, and the energy in c0 when use_energy is set (the TPU kernel has
// no energy branch; this follows ops/frontend.py mfcc_batch, which does).
// Framing happens inside the kernel from [B, S] PCM with the frame_indices
// rule, including the reflection of snip_edges=False; the TPU kernel framed
// outside only because Mosaic cannot regroup lanes.
//
// What bounds it on this card: arithmetic. The power spectrum is a direct
// DFT of the frame_length non-zero samples (400 x 257 bins x 2 FMAs per
// frame) against a shared-memory twiddle table; mel and DCT are small
// dense products. All of it is f32 FMA on the CUDA cores -- no tensor
// cores, since TF32 loses the feature precision (ARCHITECTURE.md, "MXU
// precision": max |d| 3.7 against 4e-4). The design keeps a tile of
// kFrames frames, their spectra and log-mel energies in shared memory, so
// only PCM enters and cepstra leave device memory, and each twiddle read
// serves the whole tile.

#include <cuda_runtime.h>
#include <float.h>

namespace {

constexpr int kFrames = 8;    // frames per block (one warp each for prep)
constexpr int kThreads = 256; // 8 warps
constexpr int kMaxN = 512;    // padded window
constexpr int kMaxBins = kMaxN / 2 + 1;
constexpr int kMaxMel = 128;

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ int sample_index(int f, int j, int S, int shift,
                                            int L, int snip_edges) {
  if (snip_edges) return f * shift + j;
  int idx = f * shift + shift / 2 - L / 2 + j;
  for (int r = 0; r < 2; ++r) {
    if (idx < 0) idx = -idx - 1;
    if (idx >= S) idx = 2 * S - 1 - idx;
  }
  return idx < 0 ? 0 : (idx > S - 1 ? S - 1 : idx);
}

__global__ void __launch_bounds__(kThreads) mfcc_kernel(
    const float* __restrict__ pcm,      // [B, S]
    const float* __restrict__ window,   // [L]
    const float* __restrict__ twiddle,  // [2, N]: cos, sin of 2*pi*i/N
    const float* __restrict__ mel_w,    // [N/2 + 1, M]
    const float* __restrict__ dct,      // [M, C]
    const float* __restrict__ lifter,   // [C] or null
    float* __restrict__ out,            // [B, T, C]
    int S, int T, int L, int shift, int N, int M, int C, int snip_edges,
    int remove_dc, float preemph, int use_energy, int raw_energy,
    int energy_floored, float log_energy_floor) {
  __shared__ float xs[kFrames][kMaxN];
  __shared__ float tw[2][kMaxN];
  __shared__ float pw[kFrames][kMaxBins];
  __shared__ float lm[kFrames][kMaxMel];
  __shared__ float energy[kFrames];

  const int b = blockIdx.y;
  const int f0 = blockIdx.x * kFrames;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nbins = N / 2 + 1;
  const float eps = FLT_EPSILON;
  const float* x = pcm + (size_t)b * S;

  for (int i = tid; i < 2 * N; i += kThreads) tw[i / N][i % N] = twiddle[i];
  for (int i = tid; i < kFrames * L; i += kThreads) {
    const int j = i / L, k = i % L, f = f0 + j;
    xs[j][k] = f < T ? x[sample_index(f, k, S, shift, L, snip_edges)] : 0.0f;
  }
  __syncthreads();

  // per-frame time-domain steps: warp w owns frame w of the tile
  {
    float* fr = xs[warp];
    if (remove_dc) {
      float s = 0.0f;
      for (int k = lane; k < L; k += 32) s += fr[k];
      const float mean = __fdiv_rn(warp_sum(s), (float)L);
      for (int k = lane; k < L; k += 32) fr[k] = __fsub_rn(fr[k], mean);
      __syncwarp();
    }
    float e = 0.0f;
    if (use_energy && raw_energy) {
      for (int k = lane; k < L; k += 32) e = __fmaf_rn(fr[k], fr[k], e);
      e = warp_sum(e);
    }
    // pre-emphasis (y[k] = x[k] - c*x[k-1], y[0] = x[0] - c*x[0]) and the
    // window, in place, chunk by chunk; `carry` is the last raw sample of
    // the previous chunk
    float carry = fr[0];
    for (int base = 0; base < L; base += 32) {
      const int k = base + lane;
      const float v = k < L ? fr[k] : 0.0f;
      float prev = __shfl_up_sync(0xffffffffu, v, 1);
      if (lane == 0) prev = carry;
      carry = __shfl_sync(0xffffffffu, v, 31);
      __syncwarp();
      if (k < L) {
        const float y = preemph != 0.0f ? __fsub_rn(v, __fmul_rn(preemph, prev)) : v;
        fr[k] = __fmul_rn(y, window[k]);
      }
      __syncwarp();
    }
    if (use_energy && !raw_energy) {
      for (int k = lane; k < L; k += 32) e = __fmaf_rn(fr[k], fr[k], e);
      e = warp_sum(e);
    }
    if (lane == 0) {
      float le = logf(fmaxf(e, eps));
      if (energy_floored) le = fmaxf(le, log_energy_floor);
      energy[warp] = le;
    }
  }
  __syncthreads();

  // power spectrum of the zero-padded frame: bin f = sum_k x[k] e^{-2 pi i k f / N}
  for (int bin = tid; bin < nbins; bin += kThreads) {
    float re[kFrames], im[kFrames];
#pragma unroll
    for (int j = 0; j < kFrames; ++j) re[j] = im[j] = 0.0f;
    int idx = 0;  // (k * bin) mod N
    for (int k = 0; k < L; ++k) {
      const float c = tw[0][idx], s = tw[1][idx];
#pragma unroll
      for (int j = 0; j < kFrames; ++j) {
        re[j] = __fmaf_rn(xs[j][k], c, re[j]);
        im[j] = __fmaf_rn(xs[j][k], s, im[j]);
      }
      idx += bin;
      if (idx >= N) idx -= N;
    }
#pragma unroll
    for (int j = 0; j < kFrames; ++j)
      pw[j][bin] = __fmaf_rn(re[j], re[j], __fmul_rn(im[j], im[j]));
  }
  __syncthreads();

  for (int p = tid; p < kFrames * M; p += kThreads) {
    const int j = p / M, m = p % M;
    float s = 0.0f;
    for (int bin = 0; bin < nbins; ++bin) s = __fmaf_rn(pw[j][bin], mel_w[bin * M + m], s);
    lm[j][m] = logf(fmaxf(s, eps));
  }
  __syncthreads();

  for (int p = tid; p < kFrames * C; p += kThreads) {
    const int j = p / C, c = p % C, f = f0 + j;
    if (f >= T) continue;
    float s = 0.0f;
    for (int m = 0; m < M; ++m) s = __fmaf_rn(lm[j][m], dct[m * C + c], s);
    if (lifter) s = __fmul_rn(s, lifter[c]);
    if (use_energy && c == 0) s = energy[j];
    out[((size_t)b * T + f) * C + c] = s;
  }
}

}  // namespace

extern "C" {

const char* rss_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Limits the wrapper checks before launching.
int rss_mfcc_max_window() { return kMaxN; }
int rss_mfcc_max_mel() { return kMaxMel; }

int rss_mfcc_launch(const float* pcm, const float* window, const float* twiddle,
                    const float* mel_w, const float* dct, const float* lifter,
                    float* out, int B, int S, int T, int L, int shift, int N,
                    int M, int C, int snip_edges, int remove_dc, float preemph,
                    int use_energy, int raw_energy, int energy_floored,
                    float log_energy_floor, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + kFrames - 1) / kFrames, B);
  mfcc_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      pcm, window, twiddle, mel_w, dct, lifter, out, S, T, L, shift, N, M, C,
      snip_edges, remove_dc, preemph, use_energy, raw_energy, energy_floored,
      log_energy_floor);
  return (int)cudaGetLastError();
}

}  // extern "C"
