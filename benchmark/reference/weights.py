"""Drawing model weights from the seed in NumPy, and the i-vector extractor's
weights made again from the seed.

Where a model directory is written with the port's seeded writers
(``rhasspy_speech_torch/testing/flagship.py`` for the extractor,
``full_width.py`` for the TDNN-LSTM), which draw every parameter from
``np.random.RandomState``, the reference takes nothing the port has made,
so it draws the same numbers itself: ``extractor`` below and
``nets/tdnn_lstm.py:weights`` repeat one writer's draws in the writer's
order and arithmetic, frozen here so that no later change to the port's
writers can move the yardstick. ``benchmark/tests/test_bench_reference.py``
holds each copy equal to the writer it follows. The helpers below are the
draws those writers make for each kind of layer; the benchmark's own
writers (``benchmark/models/``) use them too.

The arrays are returned as the writer stores them (float32 after the
writer's own arithmetic in float64); the reference computes in float64 from
there.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def affine(rng, in_dim: int, out_dim: int) -> Tuple[np.ndarray, np.ndarray]:
    scale = 1.0 / np.sqrt(in_dim)
    return (rng.randn(out_dim, in_dim) * scale).astype(np.float32), np.zeros(out_dim, np.float32)


def batchnorm_stats(rng, dim: int) -> Tuple[np.ndarray, np.ndarray]:
    """A test-mode batch norm's stored mean and variance (float32)."""
    mean = (0.05 * rng.randn(dim)).astype(np.float32)
    var = (1.0 + 0.1 * rng.rand(dim)).astype(np.float32)
    return mean, var


def scale_offset(mean, var, eps: float = 1.0e-3, target_rms: float = 1.0):
    """(scale, offset) in float64 of a test-mode batch norm."""
    scale = target_rms / np.sqrt(np.asarray(var, np.float64) + eps)
    return scale, -np.asarray(mean, np.float64) * scale


def batchnorm(rng, dim: int) -> Tuple[np.ndarray, np.ndarray]:
    """(scale, offset) of a test-mode batch norm: TargetRms 1, Epsilon 1e-3."""
    return scale_offset(*batchnorm_stats(rng, dim))


def tdnn(rng, in_dim: int, out_dim: int, offsets: int, bias: bool):
    scale = 1.0 / np.sqrt(in_dim * offsets)
    w = (rng.randn(out_dim, in_dim * offsets) * scale).astype(np.float32)
    return w, (np.zeros(out_dim, np.float32) if bias else None)


def lda(rng, dim: int) -> np.ndarray:
    return np.eye(dim, dtype=np.float32) + 0.01 * rng.randn(dim, dim).astype(np.float32)


def extractor(seed: int, num_ceps: int, ivector_dim: int, ubm_gauss: int) -> Dict:
    """``testing/flagship.py:write_flagship_model_dir``'s i-vector
    extractor: a diagonal UBM over the LDA-projected splice (+-3), the
    extractor's M with an identity Sigma^-1 and prior offset 4, and the
    LDA matrix with its offset column."""
    rng = np.random.RandomState(seed)
    spliced_dim = num_ceps * 7
    means = rng.randn(ubm_gauss, num_ceps) * 2.0
    variances = 0.5 + rng.rand(ubm_gauss, num_ceps)
    weights = rng.dirichlet(np.ones(ubm_gauss))
    M = (rng.randn(ubm_gauss, num_ceps, ivector_dim) * 0.1).astype(np.float32)
    lda = (rng.randn(num_ceps, spliced_dim + 1) * 0.05).astype(np.float32)
    return {"means": means, "variances": variances, "weights": weights, "M": M,
            "lda": lda, "prior_offset": 4.0}
