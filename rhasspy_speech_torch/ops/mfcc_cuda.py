"""MFCC kernel wrapper (``csrc/mfcc.cu``): the port of the TPU kernel
``rhasspy_speech_tpu/ops/pallas_mfcc.py:mfcc_pallas``.

``mfcc_batch`` launches the kernel for samples on a CUDA device and runs
the plain twin ``ops.frontend.mfcc_batch_torch`` for samples on the CPU;
it never falls back from one to the other. ``mfcc_batch.launches`` counts
kernel launches.

The kernel's power spectrum is a real FFT of the padded window. An even
window is computed as a half-size complex FFT: radix-2 stages when the
window is a power of two, mixed-radix (Stockham) stages otherwise, with
``fft_twiddles`` as its table. An odd window (e.g. 401 samples,
``round_to_power_of_two=false``) runs Bluestein's algorithm on two frames
at once, with ``bluestein_table`` as its table: the frames packed as one
complex sequence, times a chirp, convolved with the conjugate chirp through
radix-2 FFTs of the power of two ``bluestein_size(n) >= 2n - 1``, and split
into the two frames' bins. ``mel_bands`` cuts ``FrontendParams.mel_weights``
to each filter's nonzero band. The tables are made once per
``FrontendParams`` (cached on it) and are reached by the CPU tests.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from . import _build
from .frontend import FrontendParams, mfcc_batch_torch, num_frames

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = _build.load("mfcc")
    if lib.rss_mfcc_launch.argtypes is None:
        lib.rss_mfcc_launch.argtypes = (
            [_P] * 9 + [_F, _P] + [_I] * 10 + [_F] + [_I] * 3 + [_F, _I, _P]
        )
        lib.rss_mfcc_launch.restype = _I
        lib.rss_mfcc_max_window.restype = _I
        lib.rss_mfcc_max_mel.restype = _I
    return lib


def fft_twiddles(n: int) -> np.ndarray:
    """[2, n] f32 cos / sin of 2*pi*k/n, computed in float64 and rounded
    once: W_n^k = cos - i sin for the n/2-point complex FFT's butterflies
    (W_{n/2}^p = W_n^{2p}) and the real split."""
    ang = 2.0 * np.pi * np.arange(n, dtype=np.float64) / n
    return np.stack([np.cos(ang), np.sin(ang)]).astype(np.float32)


def bluestein_size(n: int) -> int:
    """Q, the power of two >= 2n - 1 over which an odd n-point DFT runs as
    a circular convolution (1,024 at n = 401)."""
    return 1 << (2 * n - 2).bit_length()


def bluestein_table(n: int) -> np.ndarray:
    """The odd-window kernel's f32 table for an n-point DFT, Q =
    ``bluestein_size(n)``, computed in float64 and rounded once:

    - ``[0, Q)`` cos and ``[Q, 2Q)`` sin of the radix-2 stages' twiddles,
      laid out by stage: entry m + p (m = 1, 2, .., Q/2; p < m) holds
      W_2m^p = cos(pi p / m) - i sin(pi p / m); entry 0 is unused;
    - ``[2Q, 2Q + n)`` cos and ``[2Q + n, 2Q + 2n)`` sin of the chirp w_k =
      exp(-i pi k^2 / n) = cos - i sin, with k^2 reduced mod 2n in integers
      so that no phase is lost at large k;
    - ``[2Q + 2n, 3Q + 2n)`` real and ``[3Q + 2n, 4Q + 2n)`` imaginary parts
      of the Q-point FFT of the conjugate chirp (w*_m at m and at Q - m,
      zero between), divided by Q and in bit-reversed order, the order the
      kernel's forward FFT leaves its output in."""
    Q = bluestein_size(n)
    tw = np.zeros((2, Q))
    tw[0, 0] = 1.0
    m = 1
    while m < Q:
        ang = np.pi * np.arange(m) / m
        tw[0, m : 2 * m], tw[1, m : 2 * m] = np.cos(ang), np.sin(ang)
        m *= 2
    k = np.arange(n, dtype=np.int64)
    ang = np.pi * ((k * k) % (2 * n)) / n
    b = np.zeros(Q, np.complex128)
    b[:n] = np.exp(1j * ang)
    b[Q - k[1:]] = b[1:n]
    bits = Q.bit_length() - 1
    rev = [int(format(j, f"0{bits}b")[::-1], 2) for j in range(Q)]
    spec = (np.fft.fft(b) / Q)[rev]
    return np.concatenate(
        [tw[0], tw[1], np.cos(ang), np.sin(ang), spec.real, spec.imag]
    ).astype(np.float32)


def mel_bands(mel_weights: np.ndarray):
    """The dense f32 mel matrix [bins, M] as bands: (ptr [M + 1], first bin
    [M], weights) with filter m's nonzero weights ``weights[ptr[m]:ptr[m +
    1]]`` on bins ``first[m]..``."""
    ptr, first, vals = [0], [], []
    for col in np.asarray(mel_weights, np.float32).T:
        nz = np.flatnonzero(col)
        lo, hi = (int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 0)
        first.append(lo)
        vals.append(col[lo:hi])
        ptr.append(ptr[-1] + hi - lo)
    return np.asarray(ptr, np.int32), np.asarray(first, np.int32), np.concatenate(vals)


def _tables(params: FrontendParams):
    """(spectrum table, mel band pointers, first bins, weights) on the
    params' device: ``fft_twiddles`` for an even window, ``bluestein_table``
    for an odd one."""
    tables = params.kernel_cache.get("mfcc")
    if tables is None:
        n = params.cfg.padded_window_size
        ptr, first, vals = mel_bands(params.mel_weights.cpu().numpy())
        spectrum = bluestein_table(n) if n % 2 else fft_twiddles(n)
        tables = tuple(
            torch.as_tensor(a, device=params.device) for a in (spectrum, ptr, first, vals)
        )
        params.kernel_cache["mfcc"] = tables
    return tables


def mfcc_batch(
    params: FrontendParams, samples: torch.Tensor, noise: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """[B, S] f32 samples -> [B, T, num_ceps] f32 MFCCs; ``noise`` [B, T,
    frame_length] f32 is the dither's standard normal draw, added times
    ``cfg.dither`` to each frame before DC removal (see
    ``ops.frontend.mfcc_batch_torch`` for the semantics)."""
    if samples.device.type == "cpu":
        return mfcc_batch_torch(params, samples, noise)
    if samples.device.type != "cuda":
        raise ValueError(f"mfcc_batch: unsupported device {samples.device}")
    cfg = params.cfg
    if samples.dim() != 2 or samples.dtype != torch.float32:
        raise ValueError("mfcc_batch: samples must be [B, S] float32")
    if params.device != samples.device:
        raise ValueError(
            f"mfcc_batch: params on {params.device}, samples on {samples.device}"
        )
    samples = samples.contiguous()
    B, S = samples.shape
    T = num_frames(cfg, S)
    out = torch.empty((B, T, cfg.num_ceps), dtype=torch.float32, device=samples.device)
    if B == 0 or T == 0:
        return out
    if noise is not None:
        if (noise.shape != (B, T, cfg.frame_length) or noise.dtype != torch.float32
                or noise.device != samples.device):
            raise ValueError(
                f"mfcc_batch: noise must be [{B}, {T}, {cfg.frame_length}] float32 on "
                f"{samples.device}, got {tuple(noise.shape)} {noise.dtype} on {noise.device}"
            )
        noise = noise.contiguous()
    lib = _lib()
    N, L, M = cfg.padded_window_size, cfg.frame_length, cfg.num_mel_bins
    if not 4 <= N <= lib.rss_mfcc_max_window() or L > N or M > lib.rss_mfcc_max_mel():
        raise ValueError(
            f"mfcc kernel takes a padded window in [4, {lib.rss_mfcc_max_window()}] "
            f"and <= {lib.rss_mfcc_max_mel()} mel bins; got N={N}, L={L}, M={M}"
        )
    tw, mel_ptr, mel_first, mel_val = _tables(params)
    lifter = params.lifter if cfg.cepstral_lifter != 0.0 else None
    floored = cfg.use_energy and cfg.energy_floor > 0.0
    log_floor = float(np.log(np.float32(cfg.energy_floor))) if floored else 0.0
    err = lib.rss_mfcc_launch(
        samples.data_ptr(),
        params.window.data_ptr(),
        tw.data_ptr(),
        mel_ptr.data_ptr(),
        mel_first.data_ptr(),
        mel_val.data_ptr(),
        params.dct.data_ptr(),
        None if lifter is None else lifter.data_ptr(),
        None if noise is None else noise.data_ptr(),
        cfg.dither,
        out.data_ptr(),
        B, S, T, L, cfg.frame_shift, N, M, cfg.num_ceps,
        int(cfg.snip_edges), int(cfg.remove_dc_offset), cfg.preemph_coeff,
        int(cfg.use_energy), int(cfg.raw_energy), int(floored), log_floor,
        samples.device.index,
        torch.cuda.current_stream(samples.device).cuda_stream,
    )
    _build.check(lib, err, "mfcc kernel launch")
    mfcc_batch.launches += 1
    return out


mfcc_batch.launches = 0
