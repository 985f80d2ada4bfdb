"""MFCC kernel wrapper (``csrc/mfcc.cu``): the port of the TPU kernel
``rhasspy_speech_tpu/ops/pallas_mfcc.py:mfcc_pallas``.

``mfcc_batch`` launches the kernel for samples on a CUDA device and runs
the plain twin ``ops.frontend.mfcc_batch_torch`` for samples on the CPU;
it never falls back from one to the other. ``mfcc_batch.launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from . import _build
from .frontend import FrontendParams, check_supported, mfcc_batch_torch, num_frames

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = _build.load("mfcc")
    if lib.rss_mfcc_launch.argtypes is None:
        lib.rss_mfcc_launch.argtypes = (
            [_P] * 7 + [_I] * 10 + [_F] + [_I] * 3 + [_F, _I, _P]
        )
        lib.rss_mfcc_launch.restype = _I
        lib.rss_mfcc_max_window.restype = _I
        lib.rss_mfcc_max_mel.restype = _I
    return lib


@lru_cache(maxsize=16)
def _twiddle(n: int, device: torch.device) -> torch.Tensor:
    """[2, n] cos / sin of 2*pi*i/n, computed in float64 and rounded once."""
    ang = 2.0 * np.pi * np.arange(n, dtype=np.float64) / n
    tab = np.stack([np.cos(ang), np.sin(ang)]).astype(np.float32)
    return torch.as_tensor(tab, device=device)


def mfcc_batch(params: FrontendParams, samples: torch.Tensor) -> torch.Tensor:
    """[B, S] f32 samples -> [B, T, num_ceps] f32 MFCCs (see
    ``ops.frontend.mfcc_batch_torch`` for the semantics)."""
    if samples.device.type == "cpu":
        return mfcc_batch_torch(params, samples)
    if samples.device.type != "cuda":
        raise ValueError(f"mfcc_batch: unsupported device {samples.device}")
    cfg = params.cfg
    check_supported(cfg)
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
    lib = _lib()
    N, L, M = cfg.padded_window_size, cfg.frame_length, cfg.num_mel_bins
    if N > lib.rss_mfcc_max_window() or L > N or M > lib.rss_mfcc_max_mel():
        raise ValueError(
            f"mfcc kernel takes padded window <= {lib.rss_mfcc_max_window()} "
            f"and <= {lib.rss_mfcc_max_mel()} mel bins; got N={N}, L={L}, M={M}"
        )
    tw = _twiddle(N, samples.device)
    lifter = params.lifter if cfg.cepstral_lifter != 0.0 else None
    floored = cfg.use_energy and cfg.energy_floor > 0.0
    log_floor = float(np.log(np.float32(cfg.energy_floor))) if floored else 0.0
    err = lib.rss_mfcc_launch(
        samples.data_ptr(),
        params.window.data_ptr(),
        tw.data_ptr(),
        params.mel_weights.data_ptr(),
        params.dct.data_ptr(),
        None if lifter is None else lifter.data_ptr(),
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
