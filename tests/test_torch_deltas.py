"""The port's delta features against the JAX package's, on the CPU.

The same seeded features go through ``rhasspy_speech_tpu.ops.deltas`` and
``rhasspy_speech_torch.ops.deltas`` for orders 0-2, at frame counts above
and below the delta window's nine-frame reach (where every frame's terms
clamp at both edges). Both sum the same f32 terms in the same order:
rtol 1e-6 / atol 1e-6. The copied ``delta_kernels`` must equal the
original exactly.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from rhasspy_speech_tpu.ops import deltas as jd

import torch

from rhasspy_speech_torch.ops import deltas as td


@pytest.mark.parametrize("order", [0, 1, 2])
@pytest.mark.parametrize("frames", [1, 4, 8, 9, 23])
def test_add_deltas_matches_jax(order, frames):
    feats = np.random.RandomState(order * 100 + frames).randn(3, frames, 5).astype(np.float32)
    want = np.asarray(jd.add_deltas(jnp.asarray(feats), order=order))
    got = td.add_deltas(torch.as_tensor(feats), order=order).numpy()
    assert got.shape == want.shape == (3, frames, 5 * (order + 1))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("window", [1, 2, 3])
def test_delta_kernels_equal_original(window):
    for a, b in zip(td.delta_kernels(2, window), jd.delta_kernels(2, window)):
        np.testing.assert_array_equal(a, b)
