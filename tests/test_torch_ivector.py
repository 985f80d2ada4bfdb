"""The port's online CMVN and i-vector extraction against the JAX package.

Inputs are seeded NumPy arrays handed to both. Tolerances: CMVN rtol /
atol 1e-4 (cumulative f32 sums in another order; the JAX package holds
its own CMVN to the same against NumPy). I-vectors rtol / atol 2e-3: the
posteriors go through exp of log-likelihood differences and a Cholesky
solve of a [K, K] system, both amplifying f32 rounding from the
differently ordered matmuls.
"""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp

from rhasspy_speech_tpu.ops import cmvn as jc
from rhasspy_speech_tpu.ops import ivector as ji

import torch

from rhasspy_speech_torch.ops import cmvn as tc
from rhasspy_speech_torch.ops import ivector as ti

from test_ivector import _synthetic_system

IV_TOL = 2e-3


@pytest.mark.parametrize(
    "cfg,with_stats",
    [
        (dict(), True),
        (dict(), False),
        (dict(norm_var=True, cmn_window=20, global_frames=7), True),
        (dict(norm_mean=False, norm_var=True, cmn_window=9), False),
    ],
)
def test_online_cmvn_matches_jax(cfg, with_stats):
    rng = np.random.RandomState(5)
    feats = (rng.randn(3, 50, 6) * 3 + 2).astype(np.float32)
    stats = None
    if with_stats:
        stats = jc.matrix_from_stats(np.full(6, 150.0), np.full(6, 900.0), 60.0)
    want = np.asarray(jc.online_cmvn(jnp.asarray(feats), stats, jc.CmvnConfig(**cfg)))
    got = tc.online_cmvn(torch.as_tensor(feats), stats, tc.CmvnConfig(**cfg)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _params(seed):
    rng = np.random.RandomState(seed)
    dubm, extractor, lda = _synthetic_system(rng)
    cfg = ji.OnlineIvectorConfig()
    jp = ji.make_ivector_params(dubm, extractor, lda, cfg)
    return rng, dubm, extractor, lda, cfg, jp


def _numpy_fields(jp):
    return {
        f.name: (np.asarray(getattr(jp, f.name)) if hasattr(getattr(jp, f.name), "shape")
                 else getattr(jp, f.name))
        for f in dataclasses.fields(jp)
    }


def test_make_ivector_params_equals_carry_over():
    _, dubm, extractor, lda, cfg, jp = _params(0)
    ours = ti.make_ivector_params(dubm, extractor, lda, cfg, "cpu")
    carried = ti.ivector_params_from_numpy(_numpy_fields(jp), "cpu")
    for f in dataclasses.fields(ours):
        a, b = getattr(ours, f.name), getattr(carried, f.name)
        if isinstance(a, torch.Tensor):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        else:
            assert a == b, f.name


@pytest.mark.parametrize("masked", [False, True])
def test_extract_ivectors_matches_jax(masked):
    rng, *_, jp = _params(1)
    tp = ti.ivector_params_from_numpy(_numpy_fields(jp), "cpu")
    feats = rng.randn(4, 40, 6).astype(np.float32)
    lengths = np.array([40, 17, 1, 33], np.int32) if masked else None
    weights = rng.rand(4, 40).astype(np.float32) if masked else None
    want = np.asarray(ji.extract_ivectors(
        jnp.asarray(feats), jp,
        lengths=None if lengths is None else jnp.asarray(lengths),
        frame_weights=None if weights is None else jnp.asarray(weights),
    ))
    got = ti.extract_ivectors(
        torch.as_tensor(feats), tp,
        lengths=None if lengths is None else torch.as_tensor(lengths),
        frame_weights=None if weights is None else torch.as_tensor(weights),
    ).numpy()
    assert got.shape == want.shape == (4, 8)
    np.testing.assert_allclose(got, want, rtol=IV_TOL, atol=IV_TOL)


def test_gselect_posteriors_match_jax_with_ties():
    rng, *_, jp = _params(2)
    tp = ti.ivector_params_from_numpy(_numpy_fields(jp), "cpu")
    ll = np.round(rng.randn(2, 9, 16) * 2).astype(np.float32)  # many exact ties
    want = np.asarray(ji.gselect_posteriors(jnp.asarray(ll), jp))
    got = ti.gselect_posteriors(torch.as_tensor(ll), tp).numpy()
    np.testing.assert_array_equal(got != 0, want != 0)  # same top-k sets
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_splice_frames_and_apply_lda_equal_jax_and_the_fused_form():
    """The two halves of ``splice_lda`` as separate functions: the splice is
    a gather (equal to JAX's), the LDA within the matmul tolerance, and
    their composition agrees with the fused form."""
    rng, _, _, _, _, jp = _params(3)
    tp = ti.ivector_params_from_numpy(_numpy_fields(jp), "cpu")
    feats = rng.randn(2, 37, 6).astype(np.float32)
    want = np.asarray(ji.splice_frames(jnp.asarray(feats), jp.splice_left, jp.splice_right))
    got = ti.splice_frames(torch.as_tensor(feats), tp.splice_left, tp.splice_right)
    np.testing.assert_array_equal(got.numpy(), want)
    lda = ti.apply_lda(got, tp)
    np.testing.assert_allclose(lda.numpy(), np.asarray(ji.apply_lda(jnp.asarray(want), jp)),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(lda.numpy(), ti.splice_lda(torch.as_tensor(feats), tp).numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("frames", [23, 40])
def test_extract_ivectors_online_matches_jax(frames):
    rng, _, _, _, _, jp = _params(4)
    tp = ti.ivector_params_from_numpy(_numpy_fields(jp), "cpu")
    feats = (rng.randn(2, frames, 6) * 2).astype(np.float32)
    want = np.asarray(ji.extract_ivectors_online(jnp.asarray(feats), jp))
    got = ti.extract_ivectors_online(torch.as_tensor(feats), tp).numpy()
    assert got.shape == want.shape == (2, -(-frames // jp.ivector_period), tp.ivector_dim)
    np.testing.assert_allclose(got, want, rtol=IV_TOL, atol=IV_TOL)
