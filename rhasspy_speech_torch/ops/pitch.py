"""Kaldi pitch features (compute-kaldi-pitch-feats) as batched PyTorch ops.

Counterpart of ``rhasspy_speech_tpu/ops/pitch.py``: the Ghahremani et al.
2014 pitch tracker the reference's feature pipeline can append to MFCCs
(online2/online-nnet2-feature-pipeline.cc:90-140, feat/pitch-functions.cc):

1. downsample to ``resample_freq`` (4 kHz) with a windowed-sinc low-pass
   (one strided ``conv1d``);
2. per frame, the NCCF over integer lags covering [min_f0, max_f0], with
   the online-mode energy ballast (for the Viterbi) and without it (for
   the probability of voicing);
3. windowed-sinc interpolation of the NCCF onto log-spaced lags (one
   matmul);
4. the Viterbi over lags and its traceback: ``ops.pitch_viterbi_cuda.
   pitch_viterbi``, the kernel on a card, its plain twin on the CPU;
5. post-processing: the POV feature, the POV-weighted mean-normalized log
   pitch over a sliding window, and the delta log pitch.

Output: [B, T, 3] = (pov_feature, normalized_log_pitch, delta_pitch). The
math runs on the device of the PCM it is given, in f32 (TF32 off for
matmuls and convolutions, ``device.py``). Constant tables are made once per
config, input length and device (``pitch_tables``, a cache of the latest 64);
the scheduler's captured tick holds its own and passes them in, so it
uploads nothing and no eviction frees memory its graph reads.

``PitchConfig``, ``pitch_config_from_conf``, ``_filter_func``,
``_downsample_kernel``, ``make_lags``, ``_nccf_lag_range``,
``_upsample_matrix`` and ``num_pitch_frames`` are NumPy code copied from the
JAX module, which imports JAX.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import cached_index
from .pitch_viterbi_cuda import pitch_viterbi, transition_costs


@dataclass(frozen=True)
class PitchConfig:
    """PitchExtractionOptions defaults (pitch-functions.h:113-133)."""

    samp_freq: float = 16000.0
    frame_shift_ms: float = 10.0
    frame_length_ms: float = 25.0
    min_f0: float = 50.0
    max_f0: float = 400.0
    soft_min_f0: float = 10.0
    penalty_factor: float = 0.1
    lowpass_cutoff: float = 1000.0
    resample_freq: float = 4000.0
    delta_pitch: float = 0.005
    nccf_ballast: float = 7000.0
    lowpass_filter_width: int = 1
    upsample_filter_width: int = 5

    # ProcessPitchOptions (pitch-functions.h:235-250)
    pitch_scale: float = 2.0
    pov_scale: float = 2.0
    pov_offset: float = 0.0
    delta_pitch_scale: float = 10.0
    delta_window: int = 2
    normalization_left_context: int = 75
    normalization_right_context: int = 75

    @property
    def frame_shift(self) -> int:  # at resample_freq
        return int(round(self.resample_freq * self.frame_shift_ms / 1000.0))

    @property
    def frame_length(self) -> int:  # "basic frame length" at resample_freq
        return int(round(self.resample_freq * self.frame_length_ms / 1000.0))


def pitch_config_from_conf(path, samp_freq: Optional[float] = None) -> PitchConfig:
    """Parse a Kaldi pitch conf (lines of ``--kebab-key=value``) into a
    PitchConfig; unknown keys are ignored (prepare_online_decoding.sh writes
    a number of keys this implementation fixes at their defaults)."""
    fields = {f for f in PitchConfig.__dataclass_fields__}
    kwargs = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line.startswith("--") or "=" not in line:
                continue
            key, val = line[2:].split("=", 1)
            key = key.replace("-", "_")
            if key in fields:
                typ = PitchConfig.__dataclass_fields__[key].type
                kwargs[key] = int(val) if "int" in str(typ) else float(val)
    if samp_freq is not None:
        kwargs.setdefault("samp_freq", samp_freq)
    return PitchConfig(**kwargs)


def _filter_func(t: np.ndarray, cutoff: float, num_zeros: int) -> np.ndarray:
    """Windowed sinc h(t) = sinc-filter * raised-cosine window
    (feat/resample.cc FilterFunc)."""
    t = np.asarray(t, dtype=np.float64)
    support = num_zeros / (2.0 * cutoff)
    window = np.where(
        np.abs(t) < support,
        0.5 * (1 + np.cos(2 * np.pi * cutoff / num_zeros * t)),
        0.0,
    )
    with np.errstate(divide="ignore", invalid="ignore"):
        filt = np.where(
            t != 0.0,
            np.sin(2 * np.pi * cutoff * t) / (np.pi * t),
            2.0 * cutoff,
        )
    return filt * window


def _downsample_kernel(cfg: PitchConfig) -> Tuple[np.ndarray, int]:
    """Integer-ratio polyphase kernel for samp_freq -> resample_freq
    (LinearResample with cutoff lowpass_cutoff, num_zeros =
    lowpass_filter_width). Returns (taps [K], left offset in input samples)."""
    ratio = cfg.samp_freq / cfg.resample_freq
    if abs(ratio - round(ratio)) > 1e-6:
        raise ValueError("samp_freq must be an integer multiple of resample_freq")
    cutoff = cfg.lowpass_cutoff
    num_zeros = cfg.lowpass_filter_width
    half = num_zeros / (2.0 * cutoff)  # filter support in seconds
    half_samples = int(math.ceil(half * cfg.samp_freq))
    offs = np.arange(-half_samples, half_samples + 1)
    taps = _filter_func(offs / cfg.samp_freq, cutoff, num_zeros) / cfg.samp_freq
    return taps.astype(np.float32), half_samples


def make_lags(cfg: PitchConfig) -> np.ndarray:
    """Log-spaced lags in seconds (SelectLags, pitch-functions.cc:157-168)."""
    min_lag, max_lag = 1.0 / cfg.max_f0, 1.0 / cfg.min_f0
    lags = []
    lag = min_lag
    while lag <= max_lag:
        lags.append(lag)
        lag *= 1.0 + cfg.delta_pitch
    return np.asarray(lags, dtype=np.float64)


def _nccf_lag_range(cfg: PitchConfig) -> Tuple[int, int]:
    """Integer measured-lag range with upsampling margin
    (pitch-functions.cc:723-728)."""
    margin = cfg.upsample_filter_width / (2.0 * cfg.resample_freq)
    first = int(math.ceil(cfg.resample_freq * (1.0 / cfg.max_f0 - margin)))
    last = int(math.floor(cfg.resample_freq * (1.0 / cfg.min_f0 + margin)))
    return max(first, 1), last


def _upsample_matrix(cfg: PitchConfig, lags: np.ndarray) -> np.ndarray:
    """[num_lags, num_measured] windowed-sinc interpolation weights
    (ArbitraryResample; cutoff resample_freq/2, pitch-functions.cc:743)."""
    first, last = _nccf_lag_range(cfg)
    measured = np.arange(first, last + 1) / cfg.resample_freq  # seconds
    cutoff = cfg.resample_freq * 0.5
    dt = lags[:, None] - measured[None, :]
    w = _filter_func(dt, cutoff, cfg.upsample_filter_width) / cfg.resample_freq
    return w.astype(np.float32)


def num_pitch_frames(cfg: PitchConfig, num_samples: int) -> int:
    n_ds = int(num_samples * cfg.resample_freq / cfg.samp_freq)
    _first, last = _nccf_lag_range(cfg)
    full = cfg.frame_length + last
    if n_ds < full:
        return 0
    return 1 + (n_ds - full) // cfg.frame_shift


@functools.lru_cache(maxsize=64)
def pitch_tables(cfg: PitchConfig, num_samples: int, device: torch.device) -> dict:
    """The tracker's constant tensors for ``num_samples`` of audio, made
    once: the downsampling taps, the frame and lag gathers, the ballast's
    frame ends and counts, the interpolation matrix, the lags and the
    transition costs."""
    taps, half = _downsample_kernel(cfg)
    ratio = int(round(cfg.samp_freq / cfg.resample_freq))
    first, last = _nccf_lag_range(cfg)
    basic, shift = cfg.frame_length, cfg.frame_shift
    full = basic + last
    n_ds = (num_samples + 2 * half - taps.shape[0]) // ratio + 1
    T = max(1 + (n_ds - full) // shift, 1)
    starts = np.arange(T) * shift
    lags = make_lags(cfg)

    def up(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return {
        "taps": up(taps), "half": half, "ratio": ratio, "n_ds": n_ds, "full": full,
        "frame_idx": up(starts[:, None] + np.arange(full)[None, :]),  # [T, full]
        "lag_idx": up(np.arange(first, last + 1)[:, None] + np.arange(basic)[None, :]),
        "end_i": up(np.minimum(starts + full, n_ds) - 1),
        "cnt": up(np.minimum(starts + full, n_ds).astype(np.float32)),
        "up_t": up(_upsample_matrix(cfg, lags).T),  # [L, NL]
        "lags": up(lags.astype(np.float32)),
        "dist": up(transition_costs(lags.shape[0], cfg.delta_pitch, cfg.penalty_factor)),
    }


def pitch_local(
    cfg: PitchConfig, pcm: torch.Tensor, tab: Optional[dict] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Steps 1-3 and the Viterbi's local cost: [B, S] f32 audio -> (local
    [B, T, NL] f32, POV-NCCF at every lag [B, T, NL] f32). The NCCF gathers
    every frame's lagged windows at once, [B, T, L, basic] f32 (284 MB at
    32 x 3 s), as the reference does. ``tab``: ``pitch_tables(cfg, S,
    pcm.device)``, looked up when None."""
    if tab is None:
        tab = pitch_tables(cfg, pcm.shape[1], pcm.device)
    basic = cfg.frame_length

    # 1. downsample (strided correlation with the sinc kernel)
    padded = F.pad(pcm, (tab["half"], tab["half"]))
    ds = F.conv1d(padded[:, None, :], tab["taps"][None, None, :], stride=tab["ratio"])[:, 0, :]
    if tab["n_ds"] < tab["full"]:
        ds = F.pad(ds, (0, tab["full"] - tab["n_ds"]))

    # 2. NCCF at integer lags
    frames = ds[:, tab["frame_idx"]]  # [B, T, full]
    w0 = frames[:, :, :basic]
    wl = frames[:, :, tab["lag_idx"]]  # [B, T, L, basic]
    inner = torch.einsum("btc,btlc->btl", w0, wl)
    e1 = torch.sum(w0 * w0, dim=-1)  # [B, T]
    e2 = torch.sum(wl * wl, dim=-1)  # [B, T, L]
    norm = e1[:, :, None] * e2

    # cumulative signal variance up to each frame end (ballast, online mode)
    csum = torch.cumsum(ds, dim=1)
    csum2 = torch.cumsum(ds * ds, dim=1)
    s1 = csum[:, tab["end_i"]]
    s2 = csum2[:, tab["end_i"]]
    cnt = tab["cnt"]
    mean_sq = s2 / cnt - (s1 / cnt) ** 2  # [B, T]
    ballast = (mean_sq * basic) ** 2 * cfg.nccf_ballast

    eps = 1e-20
    nccf_pitch = inner / torch.sqrt(norm + ballast[:, :, None] + eps)
    nccf_pov = inner / torch.sqrt(norm + eps)

    # 3. interpolate onto log-spaced lags
    phi_pitch = torch.matmul(nccf_pitch, tab["up_t"])
    phi_pov = torch.matmul(nccf_pov, tab["up_t"]).clamp(-1.0, 1.0)

    lags_f = tab["lags"]
    local = 1.0 - phi_pitch * (1.0 - cfg.soft_min_f0 * lags_f[None, None, :])
    return local.contiguous(), phi_pov


def pitch_track(
    cfg: PitchConfig, pcm: torch.Tensor, tab: Optional[dict] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw tracker output: ([B, T] pitch in Hz, [B, T] POV-NCCF values at
    the Viterbi lag) -- the (NCCF, pitch) pair OnlinePitchFeature::GetFrame
    serves."""
    if tab is None:
        tab = pitch_tables(cfg, pcm.shape[1], pcm.device)
    local, phi_pov = pitch_local(cfg, pcm, tab)
    # 4. Viterbi over lags (one kernel launch on a card)
    states = pitch_viterbi(local, tab["dist"]).to(torch.int64)
    pitch = 1.0 / tab["lags"][states]  # [B, T] Hz
    nccf_at = torch.gather(phi_pov, 2, states[:, :, None])[..., 0]
    return pitch, nccf_at


def pitch_batch(cfg: PitchConfig, pcm: torch.Tensor, tab: Optional[dict] = None) -> torch.Tensor:
    """[B, S] audio -> [B, T, 3] (pov_feature, normalized_log_pitch,
    delta_pitch)."""
    B = pcm.shape[0]
    pitch, nccf_at = pitch_track(cfg, pcm, tab)
    T = pitch.shape[1]
    dev = pcm.device

    # 5. post-processing
    pov_feat = cfg.pov_scale * ((1.0001 - nccf_at.clamp(-1.0, 1.0)) ** 0.15 - 1.0)
    log_pitch = torch.log(pitch)
    pov_prob = _nccf_to_pov(nccf_at)

    # sliding-window POV-weighted mean of log pitch
    lc, rc = cfg.normalization_left_context, cfg.normalization_right_context
    zeros = torch.zeros((B, 1), dtype=torch.float32, device=dev)
    wsum = torch.cat([zeros, torch.cumsum(pov_prob * log_pitch, dim=1)], dim=1)
    psum = torch.cat([zeros, torch.cumsum(pov_prob, dim=1)], dim=1)
    t_arr = np.arange(T)
    lo = cached_index(np.maximum(0, t_arr - lc), dev)
    hi = cached_index(np.minimum(T, t_arr + rc + 1), dev)
    wl_ = wsum[:, hi] - wsum[:, lo]
    pl_ = psum[:, hi] - psum[:, lo]
    avg = wl_ / pl_.clamp_min(1e-10)
    norm_log_pitch = (log_pitch - avg) * cfg.pitch_scale

    delta = _delta_like_kaldi(log_pitch, cfg.delta_window) * cfg.delta_pitch_scale

    return torch.stack([pov_feat, norm_log_pitch, delta], dim=-1)


def _nccf_to_pov(n: torch.Tensor) -> torch.Tensor:
    """NCCF -> probability of voicing (pitch-functions.cc:78-88)."""
    nd = n.abs().clamp(0.0, 1.0)
    r = (
        -5.2
        + 5.4 * torch.exp(7.5 * (nd - 1.0))
        + 4.8 * nd
        - 2.0 * torch.exp(-10.0 * nd)
        + 4.2 * torch.exp(20.0 * (nd - 1.0))
    )
    return 1.0 / (1.0 + torch.exp(-r))


def _delta_like_kaldi(x: torch.Tensor, window: int) -> torch.Tensor:
    """First-order regression deltas with edge replication
    (featbin ComputeDeltas semantics). x: [B, T] -> [B, T]."""
    T = x.shape[1]
    offs = np.arange(-window, window + 1)
    denom = float(np.sum(offs**2))
    idx = np.clip(np.arange(T)[:, None] + offs[None, :], 0, T - 1)
    gathered = x[:, cached_index(idx, x.device)]  # [B, T, 2w+1]
    coef = cached_index((offs / denom).astype(np.float32), x.device)
    return torch.einsum("btw,w->bt", gathered, coef)
