"""Online cepstral mean (and variance) normalization in PyTorch.

Counterpart of ``rhasspy_speech_tpu/ops/cmvn.py:online_cmvn`` (Kaldi
OnlineCmvn): frame t is normalized with the stats of the window
[t - cmn_window, t], the deficit filled from global stats capped at
global_frames. Global stats use Kaldi's [2, D+1] matrix convention
(``stats_from_matrix``, and ``matrix_from_stats``, copied from the JAX
module, which imports JAX).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class CmvnConfig:
    """OnlineCmvnOptions defaults (online-feature.h:331-360)."""

    cmn_window: int = 600
    global_frames: int = 200
    norm_mean: bool = True
    norm_var: bool = False


def stats_from_matrix(stats: np.ndarray) -> Tuple[np.ndarray, np.ndarray, float]:
    """Kaldi [2, D+1] stats matrix -> (sum [D], sumsq [D], count)."""
    stats = np.asarray(stats)
    return stats[0, :-1].copy(), stats[1, :-1].copy(), float(stats[0, -1])


def matrix_from_stats(total: np.ndarray, total_sq: np.ndarray, count: float) -> np.ndarray:
    """(sum [D], sumsq [D], count) -> Kaldi [2, D+1] stats matrix."""
    d = total.shape[0]
    out = np.zeros((2, d + 1), dtype=np.float64)
    out[0, :d] = total
    out[0, d] = count
    out[1, :d] = total_sq
    return out


def online_cmvn(
    feats: torch.Tensor,
    global_stats: Optional[np.ndarray] = None,
    cfg: CmvnConfig = CmvnConfig(),
) -> torch.Tensor:
    """[B, T, D] -> normalized [B, T, D]."""
    if not cfg.norm_mean and not cfg.norm_var:
        return feats
    B, T, D = feats.shape
    dev, dt = feats.device, feats.dtype
    zeros = feats.new_zeros((B, 1, D))
    cum = torch.cat([zeros, torch.cumsum(feats, dim=1)], dim=1)
    t = np.arange(T)
    lo = np.maximum(t + 1 - cfg.cmn_window, 0)
    t1 = torch.as_tensor(t + 1, device=dev)
    lo_t = torch.as_tensor(lo, device=dev)
    window_sum = cum[:, t1] - cum[:, lo_t]
    count = torch.as_tensor((t + 1 - lo).astype(np.float32), device=dev)[None, :, None]

    if cfg.norm_var:
        cum2 = torch.cat([zeros, torch.cumsum(feats * feats, dim=1)], dim=1)
        window_sumsq = cum2[:, t1] - cum2[:, lo_t]

    if global_stats is not None:
        g_sum, g_sumsq, g_count = stats_from_matrix(global_stats)
        if g_count > 0:
            take = torch.clamp(cfg.cmn_window - count, min=0.0).clamp_max(
                float(min(g_count, cfg.global_frames))
            )
            scale = take / g_count
            window_sum = window_sum + scale * torch.as_tensor(g_sum, dtype=dt, device=dev)
            if cfg.norm_var:
                window_sumsq = window_sumsq + scale * torch.as_tensor(
                    g_sumsq, dtype=dt, device=dev
                )
            count = count + take

    mean = window_sum / count
    out = feats - mean if cfg.norm_mean else feats
    if cfg.norm_var:
        var = window_sumsq / count - mean * mean
        out = out * torch.where(var > 1e-10, 1.0 / torch.sqrt(var), 1.0)
    return out
