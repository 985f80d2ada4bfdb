"""Kaldi MFCCs in float64 PyTorch, written from Kaldi's feature-mfcc.cc.

The hires configuration every cell runs (``mfcc_hires.conf``): 16 kHz,
25 ms frames every 10 ms with ``snip_edges=true``, DC removal,
pre-emphasis 0.97, the Povey window, a 512-point power spectrum, 40 mel
bins from 20 Hz to 400 Hz below Nyquist, log with the float32 epsilon as
floor, an orthonormal DCT to 40 cepstra and a lifter of 22; no dither, no
energy. Tables are built here from those numbers; nothing is read from
the port.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

EPS_F32 = float(np.finfo(np.float32).eps)


@dataclass(frozen=True)
class Mfcc:
    samp_freq: float = 16000.0
    frame_shift: int = 160
    frame_length: int = 400
    padded: int = 512
    preemph: float = 0.97
    num_mel_bins: int = 40
    low_freq: float = 20.0
    high_freq: float = -400.0
    num_ceps: int = 40
    lifter: float = 22.0

    def num_frames(self, samples: int) -> int:
        if samples < self.frame_length:
            return 0
        return 1 + (samples - self.frame_length) // self.frame_shift


def _mel(f):
    return 1127.0 * np.log1p(np.asarray(f, dtype=np.float64) / 700.0)


def tables(cfg: Mfcc):
    """(window [L], mel weights [padded/2 + 1, bins], DCT [bins, ceps],
    lifter [ceps]) in float64, as Kaldi's MelBanks and ComputeDctMatrix lay
    them out."""
    n = cfg.frame_length
    i = np.arange(n, dtype=np.float64)
    window = np.power(0.5 - 0.5 * np.cos(2.0 * np.pi / (n - 1) * i), 0.85)
    nyquist = 0.5 * cfg.samp_freq
    high = cfg.high_freq if cfg.high_freq > 0 else nyquist + cfg.high_freq
    mel_low, mel_high = _mel(cfg.low_freq), _mel(high)
    delta = (mel_high - mel_low) / (cfg.num_mel_bins + 1)
    half = cfg.padded // 2
    bin_mel = _mel(cfg.samp_freq / cfg.padded * np.arange(half, dtype=np.float64))[:, None]
    left = mel_low + np.arange(cfg.num_mel_bins, dtype=np.float64)[None, :] * delta
    center, right = left + delta, left + 2 * delta
    w = np.where(bin_mel <= center, (bin_mel - left) / delta, (right - bin_mel) / delta)
    w = np.where((bin_mel > left) & (bin_mel < right), w, 0.0)
    mel = np.zeros((half + 1, cfg.num_mel_bins))
    mel[:half] = w
    k = np.arange(cfg.num_ceps, dtype=np.float64)[:, None]
    j = np.arange(cfg.num_mel_bins, dtype=np.float64)[None, :]
    dct = math.sqrt(2.0 / cfg.num_mel_bins) * np.cos(math.pi / cfg.num_mel_bins * (j + 0.5) * k)
    dct[0, :] = math.sqrt(1.0 / cfg.num_mel_bins)
    lift = 1.0 + 0.5 * cfg.lifter * np.sin(math.pi * np.arange(cfg.num_ceps) / cfg.lifter)
    return window, mel, dct.T.copy(), lift


def mfcc(cfg: Mfcc, pcm: torch.Tensor) -> torch.Tensor:
    """[B, S] samples (any float dtype) -> [B, T, ceps] float64 on
    ``pcm``'s device, T from ``S``."""
    dev = pcm.device
    x = pcm.to(torch.float64)
    T = cfg.num_frames(x.shape[1])
    window, mel, dct, lift = (torch.as_tensor(a, device=dev) for a in tables(cfg))
    idx = (torch.arange(T, device=dev)[:, None] * cfg.frame_shift
           + torch.arange(cfg.frame_length, device=dev)[None, :])
    frames = x[:, idx]  # [B, T, L]
    frames = frames - frames.mean(dim=-1, keepdim=True)
    prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
    frames = (frames - cfg.preemph * prev) * window
    spec = torch.fft.rfft(frames, n=cfg.padded)
    power = spec.real ** 2 + spec.imag ** 2
    logmel = torch.log(torch.clamp(power @ mel, min=EPS_F32))
    return (logmel @ dct) * lift
