"""The MFCC allowance of ``rhasspy_speech_torch/testing/feature_tolerance.py``
against float64, on the CPU.

Both f32 front ends (the JAX package's ``mfcc_batch`` and the port's twin
``mfcc_batch_torch``) must lie within the allowance of the float64
``mfcc_numpy`` (the port's copy) on every element, and within the two-sided
allowance of each other. Inputs: utterance 0 of tests/test_torch_stream.py
(synthetic speech, silence gaps; its frames reach a power 10^10 above their
weakest mel band) and a seeded family the other tests do not use: speech-like
bursts (tests/test_torch_frontend.py) and the same tones without their noise
(rounded to int16), at gains swept over 4 decades, separated by silence at
``_silence_wave``'s level. Each at N = 512 and at
N = 401 (the odd window, which FFTs take by Bluestein's algorithm).

The negative cases: a perturbation of twice the allowance fails on a
well-conditioned element and on an ill-conditioned one, and where the
scaled term is below atol the allowance is the fixed rtol 1e-4 / atol 2e-3
bound exactly, so no well-conditioned element is allowed more than that.
"""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp

from rhasspy_speech_tpu.ops import frontend as jf
from rhasspy_speech_tpu.testing import build_synthetic_profile

import torch

from rhasspy_speech_torch.ops import frontend as tf
from rhasspy_speech_torch.testing.feature_tolerance import (
    ATOL,
    RTOL,
    assert_mfcc_close,
    fft_stages,
    frames_of,
    mfcc_allowance,
    worst,
)
from rhasspy_speech_torch.testing.synthetic import _silence_wave

from test_torch_frontend import speech_like
from test_torch_pipeline import LEXICON
from test_torch_stream import utterances

ODD = dict(frame_length_ms=25.0625, round_to_power_of_two=False)  # N = 401
WINDOWS = {"n512": {}, "n401": ODD}
GAINS = 10.0 ** np.linspace(-3.3, 0.7, 9)  # 4 decades; the loudest peaks near int16's limit


def bursts(seed=21):
    """At each gain a speech-like burst, then its two tones alone (rounded
    to int16, as a clean recording holds them: their high bands lie 10^9 and
    more below the frame's power), each followed by a silence gap."""
    rng = np.random.RandomState(seed)
    t = np.arange(3200) / 16000.0
    parts = []
    for gain in GAINS:
        phase = 2 * np.pi * rng.rand(2)
        tones = 4000 * np.sin(2 * np.pi * 300 * t + phase[0]) + 1500 * np.sin(2 * np.pi * 1200 * t + phase[1])
        parts += [gain * speech_like(rng, 3200), _silence_wave(2400, rng),
                  np.round(gain * tones), _silence_wave(2400, rng)]
    return np.concatenate(parts).astype(np.float32)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """name -> (config fields, PCM [S])."""
    profile = build_synthetic_profile(tmp_path_factory.mktemp("tolerance") / "m", LEXICON)
    return {
        "stream_utterance": (dataclasses.asdict(profile.frontend), utterances(profile)[0]),
        "bursts": ({}, bursts()),
    }


def _configs(fields, window):
    fields = {**fields, **WINDOWS[window]}
    return jf.FrontendConfig(**fields), tf.FrontendConfig(**fields)


def _features(jcfg, tcfg, pcm):
    """(JAX f32, port f32, float64) MFCCs [T, C] of one PCM."""
    jax_f32 = np.asarray(jf.mfcc_batch(jf.make_frontend_params(jcfg), jnp.asarray(pcm[None])))[0]
    port_f32 = tf.mfcc_batch_torch(tf.make_frontend_params(tcfg, "cpu"), torch.as_tensor(pcm[None]))
    return jax_f32, port_f32[0].numpy(), tf.mfcc_numpy(tcfg, pcm)


@pytest.mark.parametrize("window", sorted(WINDOWS))
@pytest.mark.parametrize("name", ["stream_utterance", "bursts"])
def test_f32_front_ends_within_allowance_of_float64(inputs, name, window):
    fields, pcm = inputs[name]
    jcfg, tcfg = _configs(fields, window)
    jax_f32, port_f32, ref = _features(jcfg, tcfg, pcm)
    frames = frames_of(tcfg, pcm)
    one = mfcc_allowance(tcfg, frames)
    np.testing.assert_allclose(one.reference, ref, rtol=0, atol=1e-9)
    assert_mfcc_close(jax_f32, ref, one, "JAX mfcc_batch against float64")
    assert_mfcc_close(port_f32, ref, one, "the port's twin against float64")
    assert_mfcc_close(port_f32, jax_f32, mfcc_allowance(tcfg, frames, sides=2), "port against JAX")
    # the frames that need more than atol are there
    assert one.conditioning.max() > 1e9 and (one.scaled > ATOL).sum() > 100


def test_fft_stages():
    assert fft_stages(512) == 9.0 and fft_stages(256) == 8.0
    assert fft_stages(401) == 20.0  # Bluestein: two 1,024-point radix-2 FFTs
    assert fft_stages(200) == 18.0


def _perturbed(inputs, pick):
    fields, pcm = inputs["stream_utterance"]
    _jcfg, tcfg = _configs(fields, "n512")
    got = tf.mfcc_batch_torch(tf.make_frontend_params(tcfg, "cpu"), torch.as_tensor(pcm[None]))[0]
    got = got.numpy().astype(np.float64)
    allow = mfcc_allowance(tcfg, frames_of(tcfg, pcm))
    want = allow.reference
    idx = pick(allow)
    assert_mfcc_close(got, want, allow)
    bad = got.copy()
    bad[idx] = want[idx] + 2.0 * allow.bound(want)[idx]
    return bad, want, allow, idx


@pytest.mark.parametrize("kind", ["well_conditioned", "ill_conditioned"])
def test_twice_the_allowance_fails(inputs, kind):
    def pick(allow):
        if kind == "ill_conditioned":
            idx = np.unravel_index(int(np.argmax(allow.scaled)), allow.scaled.shape)
            assert allow.floor[idx] > 5 * ATOL
        else:
            idx = np.unravel_index(int(np.argmin(allow.conditioning)), allow.conditioning.shape)
            idx = (idx[0], 1)
            assert allow.scaled[idx] < 0.1 * ATOL and allow.floor[idx] == ATOL
        return idx

    bad, want, allow, idx = _perturbed(inputs, pick)
    ratio, at = worst(bad, want, allow)
    assert at == tuple(int(i) for i in idx) and ratio == pytest.approx(2.0)
    with pytest.raises(AssertionError, match=r"ratio 2\.000; .*conditioning"):
        assert_mfcc_close(bad, want, allow)


@pytest.mark.parametrize("sides", [1, 2])
@pytest.mark.parametrize("cfg", [{}, dict(use_energy=True), ODD], ids=["hires", "energy", "n401"])
def test_allowance_is_the_fixed_bound_below_atol(inputs, sides, cfg):
    """Where ``sides * scaled <= atol`` the bound is ``rtol |want| + atol``
    to the bit, elsewhere it is wider, never narrower; with ``use_energy``
    the energy column keeps the fixed bound; and an element past the fixed
    bound on a well-conditioned frame fails as ``assert_allclose`` fails."""
    _fields, pcm = inputs["bursts"]
    tcfg = tf.FrontendConfig(**cfg)
    want = tf.mfcc_batch_torch(tf.make_frontend_params(tcfg, "cpu"), torch.as_tensor(pcm[None]))
    want = want[0].numpy().astype(np.float64)
    allow = mfcc_allowance(tcfg, frames_of(tcfg, pcm), sides=sides)
    fixed = RTOL * np.abs(want) + ATOL
    below = sides * allow.scaled <= ATOL
    assert below.mean() > 0.5
    np.testing.assert_array_equal(allow.bound(want)[below], fixed[below])
    assert (allow.bound(want) >= fixed).all()
    if tcfg.use_energy:
        assert (allow.scaled[:, 0] == 0).all() and below[:, 0].all()
    f, k = np.argwhere(below)[len(np.argwhere(below)) // 2]
    bad = want.copy()
    bad[f, k] = want[f, k] + 1.01 * fixed[f, k]
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(bad, want, rtol=RTOL, atol=ATOL)
    with pytest.raises(AssertionError, match=rf"\({f}, {k}\)"):
        assert_mfcc_close(bad, want, allow)


def test_dither_noise_enters_the_frames():
    """``frames_of`` adds ``dither`` times the injected noise, so the
    allowance and the float64 reference are those of the dithered frames."""
    cfg = tf.FrontendConfig(dither=1.0)
    pcm = bursts(seed=4)[:6000]
    noise = np.random.RandomState(5).randn(tf.num_frames(cfg, 6000), cfg.frame_length)
    noise = noise.astype(np.float32)
    frames = frames_of(cfg, pcm, noise)
    np.testing.assert_array_equal(frames, frames_of(cfg, pcm) + noise)
    got = tf.mfcc_batch_torch(tf.make_frontend_params(cfg, "cpu"), torch.as_tensor(pcm[None]),
                              torch.as_tensor(noise[None]))[0]
    assert_mfcc_close(got, mfcc_allowance(cfg, frames).reference, mfcc_allowance(cfg, frames))


BUCKETS = (0.0, 1e7, 1e8, 1e9, 1e11, np.inf)


def conditioning_table(fields, pcm, window):
    """Rows (bucket, frames, largest |d| of JAX vs float64, port vs float64,
    port vs JAX, largest ratio to the allowance) over frames bucketed by
    their conditioning."""
    jcfg, tcfg = _configs(fields, window)
    jax_f32, port_f32, ref = _features(jcfg, tcfg, pcm)
    frames = frames_of(tcfg, pcm)
    one, two = mfcc_allowance(tcfg, frames), mfcc_allowance(tcfg, frames, sides=2)
    rows = []
    for lo, hi in zip(BUCKETS[:-1], BUCKETS[1:]):
        m = (one.conditioning >= lo) & (one.conditioning < hi)
        if not m.any():
            continue
        pairs = [(jax_f32, ref, one), (port_f32, ref, one), (port_f32, jax_f32, two)]
        rows.append((f"{lo:.0e}-{hi:.0e}", int(m.sum()))
                    + tuple(float(np.abs(a[m] - b[m]).max()) for a, b, _ in pairs)
                    + (max(worst(a[m], b[m], al.rows(m))[0] for a, b, al in pairs),))
    return rows


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_feature_tolerance.py
    import tempfile
    from pathlib import Path

    profile = build_synthetic_profile(Path(tempfile.mkdtemp()) / "m", LEXICON)
    cases = {"stream_utterance": (dataclasses.asdict(profile.frontend), utterances(profile)[0]),
             "bursts": ({}, bursts())}
    for name, (fields, pcm) in cases.items():
        for window in sorted(WINDOWS):
            print(f"{name} {window}: conditioning | frames | JAX vs f64 | port vs f64 | "
                  "port vs JAX | worst ratio to the allowance")
            for row in conditioning_table(fields, pcm, window):
                print("  " + " | ".join(f"{v:.3e}" if isinstance(v, float) else str(v) for v in row))
