"""Batched MFCC frontend in PyTorch: the plain twin of the MFCC kernel.

Counterpart of ``rhasspy_speech_tpu/ops/frontend.py``. The configuration
and the NumPy functions (``FrontendConfig``, ``num_frames``,
``frame_indices``, the window, mel, DCT and lifter tables, and the float64
``mfcc_numpy`` that ``testing/synthetic.py`` builds its model from) are
copied from there, because that module imports JAX; ``tests/test_torch_frontend.py``
holds each copy equal to the original. ``mfcc_batch_torch`` follows
``mfcc_batch`` step for step (Kaldi feature-mfcc.cc numerics) and is what
``ops.mfcc_cuda.mfcc_batch`` runs for tensors on the CPU and what the CUDA
kernel is checked against on the card.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from ..io.ivector import parse_conf

EPS_F32 = float(np.finfo(np.float32).eps)


@dataclass(frozen=True)
class FrontendConfig:
    """MFCC hyperparameters (Kaldi FrameExtractionOptions/MfccOptions
    defaults with the hires overrides of mfcc_hires.conf: num_mel_bins=40,
    num_ceps=40, low_freq=20, high_freq=-400, use_energy=false)."""

    samp_freq: float = 16000.0
    frame_shift_ms: float = 10.0
    frame_length_ms: float = 25.0
    dither: float = 0.0
    preemph_coeff: float = 0.97
    remove_dc_offset: bool = True
    window_type: str = "povey"
    round_to_power_of_two: bool = True
    snip_edges: bool = True
    num_mel_bins: int = 40
    low_freq: float = 20.0
    high_freq: float = -400.0
    num_ceps: int = 40
    use_energy: bool = False
    raw_energy: bool = True
    cepstral_lifter: float = 22.0
    energy_floor: float = 0.0

    @property
    def frame_shift(self) -> int:
        return int(self.samp_freq * 0.001 * self.frame_shift_ms)

    @property
    def frame_length(self) -> int:
        return int(self.samp_freq * 0.001 * self.frame_length_ms)

    @property
    def padded_window_size(self) -> int:
        n = self.frame_length
        if not self.round_to_power_of_two:
            return n
        p = 1
        while p < n:
            p *= 2
        return p


def frontend_from_mfcc_conf(path) -> FrontendConfig:
    """FrontendConfig from a Kaldi mfcc conf file (--key=value lines)."""
    conf = parse_conf(str(path))
    key_map = {
        "sample-frequency": ("samp_freq", float),
        "frame-shift": ("frame_shift_ms", float),
        "frame-length": ("frame_length_ms", float),
        "dither": ("dither", float),
        "preemphasis-coefficient": ("preemph_coeff", float),
        "remove-dc-offset": ("remove_dc_offset", lambda v: v == "true"),
        "window-type": ("window_type", str),
        "round-to-power-of-two": ("round_to_power_of_two", lambda v: v == "true"),
        "snip-edges": ("snip_edges", lambda v: v == "true"),
        "num-mel-bins": ("num_mel_bins", int),
        "low-freq": ("low_freq", float),
        "high-freq": ("high_freq", float),
        "num-ceps": ("num_ceps", int),
        "use-energy": ("use_energy", lambda v: v == "true"),
        "raw-energy": ("raw_energy", lambda v: v == "true"),
        "cepstral-lifter": ("cepstral_lifter", float),
        "energy-floor": ("energy_floor", float),
    }
    kwargs = {}
    for key, value in conf.items():
        mapping = key_map.get(key)
        if mapping is not None:
            field_name, conv = mapping
            kwargs[field_name] = conv(value)
    return FrontendConfig(**kwargs)


def num_frames(cfg: FrontendConfig, num_samples: int) -> int:
    """Frame count (feature-window.cc NumFrames; snip_edges=False uses the
    flush=true count: round(num_samples / frame_shift))."""
    if not cfg.snip_edges:
        return (num_samples + cfg.frame_shift // 2) // cfg.frame_shift
    if num_samples < cfg.frame_length:
        return 0
    return 1 + (num_samples - cfg.frame_length) // cfg.frame_shift


def frame_indices(cfg: FrontendConfig, num_samples: int) -> np.ndarray:
    """[T, frame_length] sample indices per frame: snip_edges=True frames
    lie inside the signal; snip_edges=False frames are centred at
    f*shift + shift/2 with out-of-range samples reflected at the edges
    (feature-window.cc FirstSampleOfFrame, ExtractWindow)."""
    T = num_frames(cfg, num_samples)
    if cfg.snip_edges:
        starts = np.arange(T) * cfg.frame_shift
        return starts[:, None] + np.arange(cfg.frame_length)[None, :]
    starts = (
        np.arange(T) * cfg.frame_shift
        + cfg.frame_shift // 2
        - cfg.frame_length // 2
    )
    idx = starts[:, None] + np.arange(cfg.frame_length)[None, :]
    for _ in range(2):  # repeated reflection only for pathological lengths
        idx = np.where(idx < 0, -idx - 1, idx)
        idx = np.where(idx >= num_samples, 2 * num_samples - 1 - idx, idx)
    return np.clip(idx, 0, num_samples - 1)


def _mel_scale(freq: np.ndarray) -> np.ndarray:
    return 1127.0 * np.log1p(np.asarray(freq, dtype=np.float64) / 700.0)


def window_function(cfg: FrontendConfig) -> np.ndarray:
    n = cfg.frame_length
    a = 2.0 * np.pi / (n - 1)
    i = np.arange(n, dtype=np.float64)
    if cfg.window_type == "povey":
        return np.power(0.5 - 0.5 * np.cos(a * i), 0.85)
    if cfg.window_type == "hanning":
        return 0.5 - 0.5 * np.cos(a * i)
    if cfg.window_type == "hamming":
        return 0.54 - 0.46 * np.cos(a * i)
    if cfg.window_type == "sine":
        return np.sin(0.5 * a * i)
    if cfg.window_type == "rectangular":
        return np.ones(n, dtype=np.float64)
    raise ValueError(f"unknown window type {cfg.window_type!r}")


def make_mel_matrix(cfg: FrontendConfig) -> np.ndarray:
    """Dense mel weights [padded//2 + 1, num_mel_bins] laid out as Kaldi's
    MelBanks; the Nyquist row is zero."""
    padded = cfg.padded_window_size
    num_fft_bins = padded // 2
    nyquist = 0.5 * cfg.samp_freq
    high_freq = cfg.high_freq if cfg.high_freq > 0 else nyquist + cfg.high_freq
    if not (0 <= cfg.low_freq < nyquist and 0 < high_freq <= nyquist):
        raise ValueError("bad low/high freq")

    fft_bin_width = cfg.samp_freq / padded
    mel_low = _mel_scale(np.array(cfg.low_freq))
    mel_high = _mel_scale(np.array(high_freq))
    mel_delta = (mel_high - mel_low) / (cfg.num_mel_bins + 1)

    bin_freqs = fft_bin_width * np.arange(num_fft_bins, dtype=np.float64)
    bin_mels = _mel_scale(bin_freqs)

    left = mel_low + np.arange(cfg.num_mel_bins, dtype=np.float64) * mel_delta
    center = left + mel_delta
    right = center + mel_delta

    mel = bin_mels[:, None]
    up = (mel - left[None, :]) / (center - left)[None, :]
    down = (right[None, :] - mel) / (right - center)[None, :]
    weights = np.where(mel <= center[None, :], up, down)
    inside = (mel > left[None, :]) & (mel < right[None, :])
    weights = np.where(inside, weights, 0.0)

    out = np.zeros((num_fft_bins + 1, cfg.num_mel_bins), dtype=np.float64)
    out[:num_fft_bins] = weights
    return out


def make_dct_matrix(num_rows: int, num_cols: int) -> np.ndarray:
    """Orthonormal DCT-II (ComputeDctMatrix), transposed to
    [num_cols(mel), num_rows(ceps)] for right-multiplication."""
    n = num_cols
    k = np.arange(num_rows, dtype=np.float64)[:, None]
    j = np.arange(n, dtype=np.float64)[None, :]
    m = np.sqrt(2.0 / n) * np.cos(np.pi / n * (j + 0.5) * k)
    m[0, :] = np.sqrt(1.0 / n)
    return m.T.copy()


def make_lifter_coeffs(q: float, num_ceps: int) -> np.ndarray:
    i = np.arange(num_ceps, dtype=np.float64)
    return 1.0 + 0.5 * q * np.sin(np.pi * i / q)


def mfcc_numpy(cfg: FrontendConfig, samples: np.ndarray) -> np.ndarray:
    """Reference MFCC over one waveform [S] -> [T, num_ceps] (float64)."""
    samples = np.asarray(samples, dtype=np.float64)
    T = num_frames(cfg, samples.shape[0])
    window = window_function(cfg)
    mel_w = make_mel_matrix(cfg)
    dct = make_dct_matrix(cfg.num_ceps, cfg.num_mel_bins)
    lifter = make_lifter_coeffs(cfg.cepstral_lifter, cfg.num_ceps)
    padded = cfg.padded_window_size
    eps = float(np.finfo(np.float32).eps)

    idx = frame_indices(cfg, samples.shape[0])
    out = np.zeros((T, cfg.num_ceps), dtype=np.float64)
    for t in range(T):
        frame = samples[idx[t]].copy()
        if cfg.remove_dc_offset:
            frame -= frame.mean()
        if cfg.use_energy and cfg.raw_energy:
            log_e = np.log(max(np.dot(frame, frame), eps))
        if cfg.preemph_coeff != 0.0:
            prev = np.concatenate([frame[:1], frame[:-1]])
            frame = frame - cfg.preemph_coeff * prev
        frame = frame * window
        if cfg.use_energy and not cfg.raw_energy:
            log_e = np.log(max(np.dot(frame, frame), eps))
        buf = np.zeros(padded, dtype=np.float64)
        buf[: cfg.frame_length] = frame
        spec = np.fft.rfft(buf)
        power = spec.real**2 + spec.imag**2
        mel = power @ mel_w
        logmel = np.log(np.maximum(mel, eps))
        feats = logmel @ dct
        if cfg.cepstral_lifter != 0.0:
            feats = feats * lifter
        if cfg.use_energy:
            if cfg.energy_floor > 0.0:
                log_e = max(log_e, np.log(cfg.energy_floor))
            feats[0] = log_e
        out[t] = feats
    return out


@dataclass(frozen=True)
class FrontendParams:
    """Constant f32 tensors of one FrontendConfig on one device.
    ``kernel_cache`` holds what the kernel wrapper derives from them once
    (``ops/mfcc_cuda.py`` tables)."""

    cfg: FrontendConfig
    window: torch.Tensor  # [frame_length]
    mel_weights: torch.Tensor  # [padded//2 + 1, num_mel_bins]
    dct: torch.Tensor  # [num_mel_bins, num_ceps]
    lifter: torch.Tensor  # [num_ceps]
    kernel_cache: Dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def device(self) -> torch.device:
        return self.window.device


def make_frontend_params(
    cfg: FrontendConfig, device: Union[str, torch.device] = "cuda"
) -> FrontendParams:
    device = resolve_device(device)

    def f32(a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    return FrontendParams(
        cfg=cfg,
        window=f32(window_function(cfg)),
        mel_weights=f32(make_mel_matrix(cfg)),
        dct=f32(make_dct_matrix(cfg.num_ceps, cfg.num_mel_bins)),
        lifter=f32(make_lifter_coeffs(cfg.cepstral_lifter, cfg.num_ceps)),
    )


def mfcc_batch_torch(
    params: FrontendParams, samples: torch.Tensor, noise: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """[B, S] f32 samples (int16 range) -> [B, T, num_ceps] f32 MFCCs,
    T = num_frames(cfg, S), on the samples' device. ``noise`` [B, T,
    frame_length] is standard normal dither: ``cfg.dither * noise`` is added
    to the frames before DC removal (Kaldi's Dither, feature-window.cc), so
    overlapping frames get independent noise."""
    cfg = params.cfg
    B, S = samples.shape
    T = num_frames(cfg, S)
    if T == 0:
        return samples.new_zeros((B, 0, cfg.num_ceps))

    idx = torch.as_tensor(frame_indices(cfg, S), device=samples.device)
    frames = samples[:, idx]  # [B, T, frame_length]
    if noise is not None:
        frames = frames + cfg.dither * noise

    if cfg.remove_dc_offset:
        frames = frames - frames.mean(dim=-1, keepdim=True)

    if cfg.use_energy and cfg.raw_energy:
        log_energy = torch.log((frames * frames).sum(dim=-1).clamp_min(EPS_F32))

    if cfg.preemph_coeff != 0.0:
        shifted = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
        frames = frames - cfg.preemph_coeff * shifted

    frames = frames * params.window

    if cfg.use_energy and not cfg.raw_energy:
        log_energy = torch.log((frames * frames).sum(dim=-1).clamp_min(EPS_F32))

    spec = torch.fft.rfft(frames, n=cfg.padded_window_size, dim=-1)
    power = spec.real * spec.real + spec.imag * spec.imag  # [B, T, padded//2+1]

    mel = power @ params.mel_weights
    logmel = torch.log(mel.clamp_min(EPS_F32))
    feats = logmel @ params.dct

    if cfg.cepstral_lifter != 0.0:
        feats = feats * params.lifter

    if cfg.use_energy:
        if cfg.energy_floor > 0.0:
            log_energy = log_energy.clamp_min(float(np.log(np.float32(cfg.energy_floor))))
        feats[..., 0] = log_energy
    return feats
