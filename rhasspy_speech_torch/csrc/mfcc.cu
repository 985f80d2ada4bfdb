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
// What bounds it on this card: neither bytes nor operations at the main
// path's shape (6.1 MB of PCM in, 1.5 MB of cepstra out: ~2.3 us; ~20
// kFLOP a frame once the spectrum is an FFT: ~2.9 us). The first version computed
// the spectrum as a direct DFT (400 x 257 x 2 FMAs a frame, 17x an FFT's
// work) with 257 bins over 256 threads, so one thread did two bins and
// doubled the block's DFT time. This design:
//
// - One warp per frame (an odd N: per pair of frames), kFrames frames
//   (kPairs pairs) per block; every step of a frame is the warp's own (only
//   __syncwarp between steps), and the block shares the twiddle table in
//   shared memory.
// - The power spectrum is a real N-point FFT (N = padded window, <= 512).
//   An even N is computed as an N/2-point complex FFT of the packed pairs
//   z[n] = x[2n] + i x[2n+1], then the split X[k] = E[k] + W^k O[k] for
//   k = 0..N/2. For a power of two (Kaldi's default, the main path):
//   bit-reversed load, log2(N/2) radix-2 DIT stages in place in shared
//   memory (N/4 butterflies a stage over 32 lanes, the same count on every
//   lane). Otherwise (--round-to-power-of-two=false, e.g. N = 400): one
//   Stockham stage per prime factor R of N/2 (200 = 2^3 5^2), each output a
//   direct R-point sum, ping-ponging between the pair buffers and the frame
//   buffer. f32 on the CUDA cores; no tensor cores, since TF32 loses the
//   feature precision (ARCHITECTURE.md, "MXU precision").
// - An odd N (--frame-length=25.0625 gives 401, a prime) has no half-size
//   complex FFT and, when prime, no mixed-radix split: its own kernel,
//   mfcc_bluestein_kernel below, runs Bluestein's algorithm. One warp takes
//   a pair of frames packed as z = x1 + i x2 (an odd frame count leaves
//   the last frame beside zeros), multiplies by the chirp w_n =
//   exp(-i pi n^2 / N), and convolves with the conjugate chirp over the
//   power of two Q >= 2N - 1 (1,024 at N = 401): a radix-2 DIF FFT in
//   place (natural order in, bit-reversed out), a product with the chirp's
//   spectrum (stored bit-reversed, 1/Q folded in), a radix-2 DIT inverse
//   (bit-reversed in, natural out). Then Z_k = w_k c_k, and the two frames'
//   bins split as X1 = (Z_k + conj Z_{N-k}) / 2, X2 = (Z_k - conj Z_{N-k})
//   / 2i. Each stage reads its twiddles from a table laid out by stage
//   (stage m's W_2m^p at m + p), so the 32 lanes of a butterfly step read
//   consecutive words or one broadcast, never one bank 16 times. At [32,
//   48000], N = 401: 0.177 ms, against 0.636 for the direct DFT it replaced
//   and 0.072 at N = 512 (an NVIDIA H100 80GB HBM3 at 700 W; PERF.md).
// - The mel filterbank walks each filter's nonzero band only (the wrapper
//   passes the bands; adding the dense product's zeros changes no bit), and
//   the DCT is a [M, C] product, both per warp from L1-cached tables.
// - Only PCM enters and cepstra leave device memory, and with dither the
//   noise [B, T, L] (standard normal, drawn by the caller): each frame
//   sample gets dither * noise as it is loaded, before the DC mean, as
//   ops/frontend.py mfcc_batch_torch adds it.
//
// Measured on the card (step-by-step timings of one warp, PERF.md): every
// step of a frame, the FFT's stages most, waits on the shared memory that
// the ~40 resident warps of an SM share, so a warp spends far longer on a
// frame than its ~20 kFLOP need. Keeping the butterflies in registers (8
// points a lane, the first stages without shared memory) is the next step.

#include <cuda_runtime.h>
#include <float.h>

namespace {

constexpr int kFrames = 8;              // frames per block, one warp each
constexpr int kThreads = 32 * kFrames;
constexpr int kMaxN = 512;              // padded window
constexpr int kMaxHalf = kMaxN / 2;     // complex FFT size
constexpr int kMaxMel = 128;
constexpr int kPairs = 8;               // odd N: frame pairs per block, one warp each
constexpr int kPairThreads = 32 * kPairs;
constexpr int kMaxDevices = 64;

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

// Frame f of one row into fr[0..pad) (samples past L are 0), with the
// dither draw nz (or null) added as it is loaded, then the time-domain
// steps in place: DC removal, raw energy, pre-emphasis and the window,
// processed energy. Returns the log energy (floored as asked).
__device__ __forceinline__ float prepare_frame(
    float* fr, const float* __restrict__ x, const float* __restrict__ nz, float dither,
    const float* __restrict__ window, int f, int pad, int S, int L, int shift, int snip_edges,
    int remove_dc, float preemph, int use_energy, int raw_energy, int energy_floored,
    float log_energy_floor, int lane) {
  for (int k = lane; k < pad; k += 32) {
    float v = k < L ? x[sample_index(f, k, S, shift, L, snip_edges)] : 0.0f;
    if (nz && k < L) v = __fadd_rn(v, __fmul_rn(dither, nz[k]));
    fr[k] = v;
  }
  __syncwarp();

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
  // window, in place, chunk by chunk; `carry` is the last raw sample of the
  // previous chunk
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
  float log_energy = logf(fmaxf(e, FLT_EPSILON));
  if (energy_floored) log_energy = fmaxf(log_energy, log_energy_floor);
  return log_energy;
}

// Power spectrum `spec` (bins 0..N/2) -> one frame's cepstra in `row`: the
// mel bands (log-mels staged in lmf), log, DCT, lifter, energy in c0.
__device__ __forceinline__ void mel_to_cepstra(
    const float* spec, float* lmf, const int* __restrict__ mel_ptr,
    const int* __restrict__ mel_bin0, const float* __restrict__ mel_val,
    const float* __restrict__ dct, const float* __restrict__ lifter, int M, int C,
    int use_energy, float log_energy, float* __restrict__ row, int lane) {
  for (int m = lane; m < M; m += 32) {
    const int j0 = mel_ptr[m], j1 = mel_ptr[m + 1];
    const float* pw = spec + mel_bin0[m] - j0;
    float s = 0.0f;
    for (int j = j0; j < j1; ++j) s = __fmaf_rn(pw[j], mel_val[j], s);
    lmf[m] = logf(fmaxf(s, FLT_EPSILON));
  }
  __syncwarp();
  for (int c = lane; c < C; c += 32) {
    float s = 0.0f;
    for (int m = 0; m < M; ++m) s = __fmaf_rn(lmf[m], dct[m * C + c], s);
    if (lifter) s = __fmul_rn(s, lifter[c]);
    if (use_energy && c == 0) s = log_energy;
    row[c] = s;
  }
}

__global__ void __launch_bounds__(kThreads) mfcc_kernel(
    const float* __restrict__ pcm,       // [B, S]
    const float* __restrict__ window,    // [L]
    const float* __restrict__ twiddle,   // [2, N]: cos, sin of 2*pi*k/N
    const int* __restrict__ mel_ptr,     // [M + 1] offsets into mel_val
    const int* __restrict__ mel_bin0,    // [M] first bin of each band
    const float* __restrict__ mel_val,   // band weights, concatenated
    const float* __restrict__ dct,       // [M, C]
    const float* __restrict__ lifter,    // [C] or null
    const float* __restrict__ noise,     // [B, T, L] or null: dither draw
    float dither,
    float* __restrict__ out,             // [B, T, C]
    int S, int T, int L, int shift, int N, int M, int C,
    int snip_edges, int remove_dc, float preemph, int use_energy, int raw_energy,
    int energy_floored, float log_energy_floor) {
  // the frame; then a Stockham stage's buffer or the power spectrum
  __shared__ float xs[kFrames][kMaxN];
  __shared__ float zr[kFrames][kMaxHalf];
  __shared__ float zi[kFrames][kMaxHalf];
  __shared__ float twc[kMaxN];
  __shared__ float tws[kMaxN];
  __shared__ float lm[kFrames][kMaxMel];

  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int f = blockIdx.x * kFrames + warp;
  const int H = N >> 1;

  const bool pow2 = (H & (H - 1)) == 0;
  for (int k = tid; k < N; k += kThreads) {
    twc[k] = twiddle[k];
    tws[k] = twiddle[N + k];
  }
  __syncthreads();
  if (f >= T) return;  // no block barrier below: each warp is on its own

  const float* x = pcm + (size_t)b * S;
  float* fr = xs[warp];
  float* re = zr[warp];
  float* im = zi[warp];
  const float* nz = noise ? noise + ((size_t)b * T + f) * L : nullptr;
  const float log_energy = prepare_frame(fr, x, nz, dither, window, f, N, S, L, shift,
                                         snip_edges, remove_dc, preemph, use_energy, raw_energy,
                                         energy_floored, log_energy_floor, lane);

  // z[n] = x[2n] + i x[2n+1]: Z[k] lands in (zre, zim) in natural order
  float* zre = re;
  float* zim = im;
  if (pow2) {
    // bit-reversed load, then radix-2 DIT in place: butterflies of span 2m,
    // twiddle W_N^(p * H / m)
    const int log2_half = __ffs(H) - 1;
    for (int n = lane; n < H; n += 32) {
      const int j = (int)(__brev((unsigned)n) >> (32 - log2_half));
      re[j] = fr[2 * n];
      im[j] = fr[2 * n + 1];
    }
    __syncwarp();
    for (int lm2 = 0, m = 1; m < H; ++lm2, m <<= 1) {
      for (int q = lane; q < (H >> 1); q += 32) {
        const int p = q & (m - 1);
        const int i0 = ((q >> lm2) << (lm2 + 1)) + p;
        const int i1 = i0 + m;
        const int k = p * (H >> lm2);
        const float c = twc[k], s = tws[k];
        const float br = re[i1], bi = im[i1];
        const float tr = fmaf(c, br, s * bi);
        const float ti = fmaf(c, bi, -s * br);
        const float ar = re[i0], ai = im[i0];
        re[i0] = ar + tr;
        im[i0] = ai + ti;
        re[i1] = ar - tr;
        im[i1] = ai - ti;
      }
      __syncwarp();
    }
  } else {
    // natural-order load, then one Stockham stage per prime factor R of H
    // (ns = the factors done so far): output o = (j - j % ns) * R + j % ns
    // + u * ns is sum_t in[j + t * H/R] * W_H^(t * (j % ns + u * ns) * H/(ns * R)),
    // with W_H^e = W_N^(2e) from the table. Ping-pong with the frame buffer,
    // free once packed (H <= 255 here, so 2H <= kMaxN).
    for (int n = lane; n < H; n += 32) {
      re[n] = fr[2 * n];
      im[n] = fr[2 * n + 1];
    }
    __syncwarp();
    float* dre = fr;
    float* dim = fr + H;
    for (int ns = 1, rest = H; rest > 1;) {
      int R = 2;
      while (rest % R) ++R;
      const int hr = H / R, tstep = hr / ns;
      for (int q = lane; q < H; q += 32) {
        const int u = q / hr, j = q - u * hr, k = j % ns;
        const int step = k * tstep + u * hr;  // < H
        float ar = 0.0f, ai = 0.0f;
        for (int t = 0, e = 0; t < R; ++t) {
          const float xr = zre[j + t * hr], xi = zim[j + t * hr];
          const float c = twc[2 * e], s = tws[2 * e];
          ar += fmaf(xr, c, xi * s);
          ai += fmaf(xi, c, -xr * s);
          e += step;
          if (e >= H) e -= H;
        }
        const int o = (j - k) * R + k + u * ns;
        dre[o] = ar;
        dim[o] = ai;
      }
      __syncwarp();
      float* t0 = zre;
      float* t1 = zim;
      zre = dre;
      zim = dim;
      dre = t0;
      dim = t1;
      ns *= R;
      rest /= R;
    }
  }
  // split into the real FFT's bins 0..H: power spectrum into whichever of
  // the frame buffer and the pair buffer does not hold Z
  float* spec = zre == re ? fr : re;
  for (int k = lane; k <= H; k += 32) {
    float xr, xi;
    if (k == 0 || k == H) {
      xr = k == 0 ? zre[0] + zim[0] : zre[0] - zim[0];
      xi = 0.0f;
    } else {
      const float ar = zre[k], ai = zim[k], br = zre[H - k], bi = zim[H - k];
      const float er = 0.5f * (ar + br), ei = 0.5f * (ai - bi);
      const float or_ = 0.5f * (ai + bi), oi = -0.5f * (ar - br);
      const float c = twc[k], s = tws[k];
      xr = er + fmaf(or_, c, oi * s);
      xi = ei + fmaf(oi, c, -or_ * s);
    }
    spec[k] = fmaf(xr, xr, xi * xi);
  }
  __syncwarp();
  mel_to_cepstra(spec, lm[warp], mel_ptr, mel_bin0, mel_val, dct, lifter, M, C, use_energy,
                 log_energy, out + ((size_t)b * T + f) * C, lane);
}

// Odd N: Bluestein's algorithm over Q = 2^logq >= 2N - 1, one warp a pair
// of frames (2p, 2p + 1) of row b. `table` (ops/mfcc_cuda.py
// bluestein_table): [0, Q) cos and [Q, 2Q) sin of the stage twiddles,
// entry m + p = W_2m^p; [2Q, 2Q + N) cos and [2Q + N, 2Q + 2N) sin of the
// chirp w_n = cos - i sin; [2Q + 2N, 4Q + 2N) real then imaginary parts of
// the conjugate chirp's Q-point spectrum over Q, bit-reversed. Dynamic
// shared memory: the stage twiddles, then per warp re[Q], im[Q] and two
// frames' log-mels [2M].
__global__ void __launch_bounds__(kPairThreads) mfcc_bluestein_kernel(
    const float* __restrict__ pcm, const float* __restrict__ window,
    const float* __restrict__ table, const int* __restrict__ mel_ptr,
    const int* __restrict__ mel_bin0, const float* __restrict__ mel_val,
    const float* __restrict__ dct, const float* __restrict__ lifter,
    const float* __restrict__ noise, float dither, float* __restrict__ out,
    int S, int T, int L, int shift, int N, int logq, int M, int C,
    int snip_edges, int remove_dc, float preemph, int use_energy, int raw_energy,
    int energy_floored, float log_energy_floor) {
  extern __shared__ float smem[];
  const int Q = 1 << logq;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  float* twc = smem;
  float* tws = smem + Q;
  float* re = smem + 2 * Q + warp * (2 * Q + 2 * M);
  float* im = re + Q;
  float* lmf = im + Q;
  for (int k = tid; k < 2 * Q; k += kPairThreads) smem[k] = table[k];
  __syncthreads();
  const int b = blockIdx.y;
  const int f1 = 2 * (blockIdx.x * kPairs + warp);
  if (f1 >= T) return;  // no block barrier below
  const bool two = f1 + 1 < T;

  const float* x = pcm + (size_t)b * S;
  const float* nz = noise ? noise + ((size_t)b * T + f1) * L : nullptr;
  const float e1 = prepare_frame(re, x, nz, dither, window, f1, L, S, L, shift, snip_edges,
                                 remove_dc, preemph, use_energy, raw_energy, energy_floored,
                                 log_energy_floor, lane);
  float e2 = 0.0f;
  if (two) {
    e2 = prepare_frame(im, x, nz ? nz + L : nullptr, dither, window, f1 + 1, L, S, L, shift,
                       snip_edges, remove_dc, preemph, use_energy, raw_energy, energy_floored,
                       log_energy_floor, lane);
  } else {
    for (int n = lane; n < L; n += 32) im[n] = 0.0f;
    __syncwarp();
  }

  // a_n = (x1_n + i x2_n) w_n, zero past the frame
  const float* chc = table + 2 * Q;
  const float* chs = chc + N;
  for (int n = lane; n < Q; n += 32) {
    float ar = 0.0f, ai = 0.0f;
    if (n < L) {
      const float x1 = re[n], x2 = im[n], c = __ldg(chc + n), s = __ldg(chs + n);
      ar = fmaf(x1, c, x2 * s);
      ai = fmaf(x2, c, -x1 * s);
    }
    re[n] = ar;
    im[n] = ai;
  }
  __syncwarp();

  // forward DIF: butterflies of half-span m = Q/2 .. 1, (a + b, (a - b) W_2m^p)
  for (int lm = logq - 1; lm >= 0; --lm) {
    const int m = 1 << lm;
    for (int q = lane; q < (Q >> 1); q += 32) {
      const int p = q & (m - 1);
      const int i0 = ((q >> lm) << (lm + 1)) + p;
      const int i1 = i0 + m;
      const float ar = re[i0], ai = im[i0], br = re[i1], bi = im[i1];
      const float c = twc[m + p], s = tws[m + p];
      const float dr = ar - br, di = ai - bi;
      re[i0] = ar + br;
      im[i0] = ai + bi;
      re[i1] = fmaf(dr, c, di * s);
      im[i1] = fmaf(di, c, -dr * s);
    }
    __syncwarp();
  }
  // times the chirp's spectrum, both in bit-reversed order
  const float* spr = chs + N;
  const float* spi = spr + Q;
  for (int j = lane; j < Q; j += 32) {
    const float ar = re[j], ai = im[j], br = __ldg(spr + j), bi = __ldg(spi + j);
    re[j] = fmaf(ar, br, -ai * bi);
    im[j] = fmaf(ar, bi, ai * br);
  }
  __syncwarp();
  // inverse DIT: half-span m = 1 .. Q/2, t = b conj(W_2m^p), (a + t, a - t)
  for (int lm = 0; lm < logq; ++lm) {
    const int m = 1 << lm;
    for (int q = lane; q < (Q >> 1); q += 32) {
      const int p = q & (m - 1);
      const int i0 = ((q >> lm) << (lm + 1)) + p;
      const int i1 = i0 + m;
      const float c = twc[m + p], s = tws[m + p];
      const float br = re[i1], bi = im[i1];
      const float tr = fmaf(br, c, -bi * s);
      const float ti = fmaf(bi, c, br * s);
      const float ar = re[i0], ai = im[i0];
      re[i0] = ar + tr;
      im[i0] = ai + ti;
      re[i1] = ar - tr;
      im[i1] = ai - ti;
    }
    __syncwarp();
  }

  // Z_k = w_k c_k; the two frames' power at bins 0..H land past N (c is
  // read below N only)
  const int H = N >> 1;
  float* spec1 = re + N;
  float* spec2 = im + N;
  for (int k = lane; k <= H; k += 32) {
    const int k2 = k == 0 ? 0 : N - k;
    float c = __ldg(chc + k), s = __ldg(chs + k);
    const float zr = fmaf(re[k], c, im[k] * s), zi = fmaf(im[k], c, -re[k] * s);
    c = __ldg(chc + k2);
    s = __ldg(chs + k2);
    const float yr = fmaf(re[k2], c, im[k2] * s), yi = fmaf(im[k2], c, -re[k2] * s);
    // X1 = (Z_k + conj Z_k2) / 2, X2 = (Z_k - conj Z_k2) / 2i
    const float x1r = 0.5f * (zr + yr), x1i = 0.5f * (zi - yi);
    const float x2r = 0.5f * (zi + yi), x2i = -0.5f * (zr - yr);
    spec1[k] = fmaf(x1r, x1r, x1i * x1i);
    spec2[k] = fmaf(x2r, x2r, x2i * x2i);
  }
  __syncwarp();
  float* row = out + ((size_t)b * T + f1) * C;
  mel_to_cepstra(spec1, lmf, mel_ptr, mel_bin0, mel_val, dct, lifter, M, C, use_energy, e1, row,
                 lane);
  if (two)
    mel_to_cepstra(spec2, lmf + M, mel_ptr, mel_bin0, mel_val, dct, lifter, M, C, use_energy, e2,
                   row + C, lane);
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
                    const int* mel_ptr, const int* mel_bin0, const float* mel_val,
                    const float* dct, const float* lifter, const float* noise,
                    float dither, float* out, int B, int S,
                    int T, int L, int shift, int N, int M, int C,
                    int snip_edges, int remove_dc, float preemph, int use_energy,
                    int raw_energy, int energy_floored, float log_energy_floor,
                    int device, void* stream) {
  static int smem_set[kMaxDevices] = {0};
  if (device < 0 || device >= kMaxDevices) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (N & 1) {
    // `twiddle` is the Bluestein table of this N
    int logq = 0;
    while ((1 << logq) < 2 * N - 1) ++logq;
    const int Q = 1 << logq;
    const int smem = (2 * Q + kPairs * (2 * Q + 2 * M)) * (int)sizeof(float);
    if (smem > 48 * 1024 && smem > smem_set[device]) {
      err = cudaFuncSetAttribute(mfcc_bluestein_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return (int)err;
      smem_set[device] = smem;
    }
    const int pairs = (T + 1) / 2;
    const dim3 grid((pairs + kPairs - 1) / kPairs, B);
    mfcc_bluestein_kernel<<<grid, kPairThreads, smem, (cudaStream_t)stream>>>(
        pcm, window, twiddle, mel_ptr, mel_bin0, mel_val, dct, lifter, noise, dither, out, S, T,
        L, shift, N, logq, M, C, snip_edges, remove_dc, preemph, use_energy, raw_energy,
        energy_floored, log_energy_floor);
    return (int)cudaGetLastError();
  }
  const dim3 grid((T + kFrames - 1) / kFrames, B);
  mfcc_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      pcm, window, twiddle, mel_ptr, mel_bin0, mel_val, dct, lifter, noise, dither, out,
      S, T, L,
      shift, N, M, C, snip_edges, remove_dc, preemph, use_energy,
      raw_energy, energy_floored, log_energy_floor);
  return (int)cudaGetLastError();
}

}  // extern "C"
