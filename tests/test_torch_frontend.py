"""The port's MFCC twin against the JAX package's frontends, on the CPU.

The same seeded PCM goes through ``mfcc_batch_torch``, the JAX
``mfcc_batch``, the Pallas kernel ``mfcc_pallas(interpret=True)`` (as
tests/test_pallas_mfcc.py runs it) and the float64 ``mfcc_numpy``.
Tolerances: against ``mfcc_batch`` the allowance of
``rhasspy_speech_torch/testing/feature_tolerance.py`` for two f32 front ends
(rtol 1e-4 / atol 2e-3, widened only where an f32 FFT's rounding, scaled by
the frame's power over a weak mel band, exceeds atol); against the Pallas kernel and ``mfcc_numpy`` the JAX
package's own tolerances for those pairs (rtol 2e-3 / atol 3e-2 and
rtol 2e-3 / atol 2e-2). The copied config helpers and ``mfcc_numpy`` must
equal the originals exactly.
"""

import dataclasses
import inspect

import numpy as np
import pytest

import jax.numpy as jnp

from rhasspy_speech_tpu.ops import frontend as jf
from rhasspy_speech_tpu.ops.pallas_mfcc import mfcc_pallas

import torch

from rhasspy_speech_torch.ops import frontend as tf
from rhasspy_speech_torch.ops.mfcc_cuda import mfcc_batch
from rhasspy_speech_torch.testing.feature_tolerance import (
    assert_mfcc_close,
    frames_of,
    mfcc_allowance,
)

CONFIGS = {
    "hires": {},
    "20x20": dict(num_mel_bins=20, num_ceps=20),
    "energy_raw": dict(use_energy=True),
    "energy_windowed_floor": dict(use_energy=True, raw_energy=False, energy_floor=1.0),
    "no_snip": dict(snip_edges=False),
    # Kaldi's MfccOptions defaults (a tri1 GMM system's mfcc.conf)
    "tri1_13x23": dict(num_mel_bins=23, num_ceps=13, high_freq=0.0),
    # a DeepSpeech frontend: 26 cepstra, 32 ms / 20 ms frames (512 / 320)
    "coqui_26x40": dict(num_ceps=26, frame_length_ms=32.0, frame_shift_ms=20.0),
}


def speech_like(rng, n):
    t = np.arange(n) / 16000.0
    return (
        4000 * np.sin(2 * np.pi * 300 * t)
        + 1500 * np.sin(2 * np.pi * 1200 * t)
        + 300 * rng.randn(n)
    ).astype(np.float32)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_mfcc_twin_matches_jax(name):
    kw = CONFIGS[name]
    rng = np.random.RandomState(3)
    pcm = np.stack([speech_like(rng, 6000), speech_like(rng, 6000)])
    want = np.asarray(jf.mfcc_batch(jf.make_frontend_params(jf.FrontendConfig(**kw)), jnp.asarray(pcm)))
    params = tf.make_frontend_params(tf.FrontendConfig(**kw), "cpu")
    got = tf.mfcc_batch_torch(params, torch.as_tensor(pcm)).numpy()
    assert got.shape == want.shape
    assert_mfcc_close(got, want, mfcc_allowance(params.cfg, frames_of(params.cfg, pcm), sides=2))
    # the wrapper runs the twin for CPU tensors and launches nothing
    before = mfcc_batch.launches
    np.testing.assert_array_equal(mfcc_batch(params, torch.as_tensor(pcm)).numpy(), got)
    assert mfcc_batch.launches == before
    ref = jf.mfcc_numpy(jf.FrontendConfig(**kw), pcm[0].astype(np.float64))
    np.testing.assert_allclose(got[0], ref, rtol=2e-3, atol=2e-2)


@pytest.mark.parametrize("name", ["hires", "20x20", "no_snip", "tri1_13x23", "coqui_26x40"])
def test_mfcc_twin_matches_pallas_interpret(name):
    # mfcc_pallas has no use_energy branch (ROADMAP Queue 3, R4), so only
    # energy-free configs are compared with it
    kw = CONFIGS[name]
    rng = np.random.RandomState(4)
    pcm = np.stack([speech_like(rng, 5000) for _ in range(2)])
    want = np.asarray(mfcc_pallas(jf.FrontendConfig(**kw), jnp.asarray(pcm), interpret=True))
    got = tf.mfcc_batch_torch(tf.make_frontend_params(tf.FrontendConfig(**kw), "cpu"), torch.as_tensor(pcm))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=3e-2)


def test_mfcc_short_input_gives_no_frames():
    params = tf.make_frontend_params(tf.FrontendConfig(), "cpu")
    out = tf.mfcc_batch_torch(params, torch.zeros((2, 300)))
    assert out.shape == (2, 0, 40)


def test_dither_raises():
    """Dither no longer raises: the twin adds ``dither`` times the noise it
    is given to the frames (tests/test_torch_dither.py holds it to the JAX
    package's dither), and without noise it runs undithered, as the
    stream, scheduler and Coqui routes call it."""
    params = tf.make_frontend_params(tf.FrontendConfig(dither=1.0), "cpu")
    plain = tf.make_frontend_params(tf.FrontendConfig(), "cpu")
    pcm = torch.as_tensor(speech_like(np.random.RandomState(4), 1600)[None])
    want = tf.mfcc_batch_torch(plain, pcm)
    assert torch.equal(tf.mfcc_batch_torch(params, pcm), want)
    T = tf.num_frames(params.cfg, 1600)
    noise = torch.as_tensor(np.random.RandomState(5).randn(1, T, 400).astype(np.float32))
    got = tf.mfcc_batch_torch(params, pcm, noise)
    assert got.shape == want.shape and not torch.allclose(got, want)


def test_copied_config_equals_original():
    ours = [(f.name, f.default) for f in dataclasses.fields(tf.FrontendConfig)]
    theirs = [(f.name, f.default) for f in dataclasses.fields(jf.FrontendConfig)]
    assert ours == theirs
    for kw in CONFIGS.values():
        a, b = tf.FrontendConfig(**kw), jf.FrontendConfig(**kw)
        assert (a.frame_shift, a.frame_length, a.padded_window_size) == (
            b.frame_shift, b.frame_length, b.padded_window_size)


@pytest.mark.parametrize("snip", [True, False])
def test_copied_framing_equals_original(snip):
    a, b = tf.FrontendConfig(snip_edges=snip), jf.FrontendConfig(snip_edges=snip)
    for n in (0, 1, 79, 160, 399, 400, 401, 560, 16000, 16123):
        assert tf.num_frames(a, n) == jf.num_frames(b, n)
        np.testing.assert_array_equal(tf.frame_indices(a, n), jf.frame_indices(b, n))


@pytest.mark.parametrize("window", ["povey", "hanning", "hamming", "sine", "rectangular"])
def test_copied_tables_equal_original(window):
    for kw in list(CONFIGS.values()) + [dict(window_type=window, round_to_power_of_two=False)]:
        a, b = tf.FrontendConfig(**kw), jf.FrontendConfig(**kw)
        np.testing.assert_array_equal(tf.window_function(a), jf._window_function(b))
        np.testing.assert_array_equal(tf.make_mel_matrix(a), jf.make_mel_matrix(b))
        np.testing.assert_array_equal(
            tf.make_dct_matrix(a.num_ceps, a.num_mel_bins),
            jf.make_dct_matrix(b.num_ceps, b.num_mel_bins),
        )
        np.testing.assert_array_equal(
            tf.make_lifter_coeffs(a.cepstral_lifter, a.num_ceps),
            jf.make_lifter_coeffs(b.cepstral_lifter, b.num_ceps),
        )


def test_copied_mfcc_numpy_equals_original():
    """``mfcc_numpy`` is the original's source but for the window table's
    name, and gives the same float64 rows."""
    want = inspect.getsource(jf.mfcc_numpy).replace("_window_function(cfg)", "window_function(cfg)")
    assert inspect.getsource(tf.mfcc_numpy) == want
    rng = np.random.RandomState(11)
    pcm = speech_like(rng, 3000).astype(np.float64)
    for kw in CONFIGS.values():
        np.testing.assert_array_equal(tf.mfcc_numpy(tf.FrontendConfig(**kw), pcm),
                                      jf.mfcc_numpy(jf.FrontendConfig(**kw), pcm))


def test_copied_conf_parser_equals_original(tmp_path):
    conf = tmp_path / "mfcc.conf"
    conf.write_text(
        "--sample-frequency=16000\n--num-mel-bins=30\n--num-ceps=13\n"
        "--use-energy=true\n--snip-edges=false\n--low-freq=40\n--high-freq=-200\n"
    )
    assert dataclasses.asdict(tf.frontend_from_mfcc_conf(conf)) == dataclasses.asdict(
        jf.frontend_from_mfcc_conf(conf)
    )
