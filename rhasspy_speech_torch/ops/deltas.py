"""Delta features (add-deltas / OnlineDeltaFeature) in PyTorch.

Counterpart of ``rhasspy_speech_tpu/ops/deltas.py``: Kaldi's
regression-window deltas (kaldi/src/feat/feature-functions.cc
DeltaFeatures: per order o, convolve the previous order's kernel with the
normalized ramp [-w..w] / sum(j^2); edges clamp to the first/last frame).
``delta_kernels`` is the JAX module's NumPy function, copied because that
module imports JAX. ``add_deltas`` sums the same terms in the same order as
the JAX function. Each clipped frame index it gathers with is made once per
(frame count, shift, device) through ``device.cached_index``, so a CUDA
graph can capture a call.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..device import cached_index


def delta_kernels(order: int = 2, window: int = 2) -> List[np.ndarray]:
    """Per-order convolution kernels (scales_ in DeltaFeatures)."""
    kernels = [np.array([1.0])]
    for _ in range(order):
        prev = kernels[-1]
        prev_offset = (prev.shape[0] - 1) // 2
        cur = np.zeros(prev.shape[0] + 2 * window)
        cur_offset = prev_offset + window
        normalizer = 0.0
        for j in range(-window, window + 1):
            normalizer += j * j
            for k in range(-prev_offset, prev_offset + 1):
                cur[j + k + cur_offset] += j * prev[k + prev_offset]
        kernels.append(cur / normalizer)
    return kernels


def add_deltas(feats: torch.Tensor, order: int = 2, window: int = 2) -> torch.Tensor:
    """[B, T, D] -> [B, T, D*(order+1)] with edge clamping
    (DeltaFeatures::Process uses std::min/max frame indexing)."""
    T = feats.shape[1]
    outs = []
    for kernel in delta_kernels(order, window):
        offset = (kernel.shape[0] - 1) // 2
        acc = None
        for i, coeff in enumerate(kernel):
            if coeff == 0.0:
                continue
            idx = cached_index(np.clip(np.arange(T) + (i - offset), 0, T - 1), feats.device)
            term = float(coeff) * feats[:, idx]
            acc = term if acc is None else acc + term
        outs.append(acc)
    return torch.cat(outs, dim=-1)
