"""The port's Kaldi pitch features against the JAX package's, on the CPU.

The copied NumPy/config helpers of ``ops/pitch.py`` must equal the
originals exactly. ``pitch_track`` and ``pitch_batch`` take the tone (80,
120, 200 and 333 Hz) and sweep (100 -> 300 Hz) fixtures of
tests/test_pitch.py, its noise, and spoken sentences of the synthetic
profile, in one batch through both packages: on the tones, the sweep and
the speech every frame's lag equals the JAX package's and the features are
within atol 1e-3 (f32 sums in another order; the POV feature's 0.15 power
amplifies NCCF differences near 1: measured 1.6e-4); on noise, where many
lags are near ties, at most 5% of the frames may take another lag and the
others hold the same tolerance. ``AcousticModel`` on a pitch model appends
the 3 columns (the MFCC columns within ``testing/feature_tolerance.py``'s
allowance for two f32 front ends) and its i-vector reads only the base MFCC columns, with and
without the extractor's CMVN stats; log-probs within the rtol 1e-4 / atol
1e-3 of tests/test_torch_pipeline.py. Batch transcripts equal the JAX
package's and the spoken sentences for an nnet3 pitch profile (the
synthetic profile's zero-weight pitch columns) and for a GMM whose
Gaussians read the pitch columns (``_gmm_with_pitch``).
"""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp

from rhasspy_speech_tpu.ops import pitch as jp
from rhasspy_speech_tpu.pipeline.transcribe import AcousticModel as JaxAcousticModel
from rhasspy_speech_tpu.pipeline.transcribe import Nnet3WavTranscriber as JaxTranscriber

import torch

from rhasspy_speech_torch.const import LangSuffix
from rhasspy_speech_torch.ops import pitch as tp
from rhasspy_speech_torch.ops.pitch_viterbi_cuda import pitch_viterbi
from rhasspy_speech_torch.pipeline import Nnet3WavTranscriber, lang_dir_name
from rhasspy_speech_torch.pipeline import transcribe as transcribe_mod
from rhasspy_speech_torch.pipeline.transcribe import AcousticModel
from rhasspy_speech_torch.pipeline.train import train_model_sync
from rhasspy_speech_torch.testing import build_synthetic_profile, synthesize_sentence
from rhasspy_speech_torch.testing.feature_tolerance import (
    assert_mfcc_close,
    frames_of,
    mfcc_allowance,
)

from test_torch_scheduler import LEXICON, _gmm_with_pitch

SR = 16000
ATOL = 1e-3
NOISE_LAG_SHARE = 0.05
LP_RTOL, LP_ATOL = 1e-4, 1e-3
TEXTS = ["turn on the light", "never mind"]
SENTENCES = ["turn (on|off) [the] (light|fan) [never mind]", "never mind"]
CONFS = {
    "default": {},
    "aishell_8k": dict(samp_freq=8000.0, min_f0=60.0, max_f0=300.0),
    "penalty": dict(penalty_factor=0.2, delta_pitch=0.01, upsample_filter_width=3,
                    lowpass_filter_width=2),
}


def _tone(f0, secs=1.0, amp=0.5):
    t = np.arange(int(secs * SR)) / SR
    return (amp * np.sin(2 * np.pi * f0 * t)).astype(np.float32)


def _sweep():
    t = np.arange(SR) / SR
    f0 = 100.0 * np.exp(np.log(3.0) * t)
    return (0.5 * np.sin(2 * np.pi * np.cumsum(f0) / SR)).astype(np.float32)


@pytest.fixture(scope="module")
def speech_profile(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_pitch")
    return root, build_synthetic_profile(root / "model", LEXICON)


@pytest.fixture(scope="module")
def signals(speech_profile):
    """Every fixture as a row of one [8, SR] batch, and both packages'
    outputs over it (one JAX compile a function)."""
    _root, profile = speech_profile
    rng = np.random.RandomState(0)
    rows = {f"tone_{f}": _tone(float(f)) for f in (80, 120, 200, 333)}
    rows["sweep"] = _sweep()
    rows["noise"] = (0.1 * rng.randn(SR)).astype(np.float32)
    for i, text in enumerate(TEXTS):
        pcm = synthesize_sentence(profile, text, seed=20 + i)[:SR]
        rows[f"speech_{i}"] = np.pad(pcm, (0, SR - pcm.shape[0]))
    names = list(rows)
    batch = np.stack([rows[n] for n in names])
    cfg_j, cfg_t = jp.PitchConfig(), tp.PitchConfig()
    want_pitch, want_nccf = (np.asarray(v) for v in jp.pitch_track(cfg_j, jnp.asarray(batch)))
    want_feats = np.asarray(jp.pitch_batch(cfg_j, jnp.asarray(batch)))
    got_pitch, got_nccf = (v.numpy() for v in tp.pitch_track(cfg_t, torch.as_tensor(batch)))
    got_feats = tp.pitch_batch(cfg_t, torch.as_tensor(batch)).numpy()
    return {n: (want_pitch[i], want_nccf[i], want_feats[i], got_pitch[i], got_nccf[i],
                got_feats[i]) for i, n in enumerate(names)}


@pytest.mark.parametrize("name", ["tone_80", "tone_120", "tone_200", "tone_333", "sweep",
                                  "speech_0", "speech_1"])
def test_pitch_matches_jax(signals, name):
    want_pitch, want_nccf, want_feats, got_pitch, got_nccf, got_feats = signals[name]
    assert got_feats.shape == want_feats.shape == (tp.num_pitch_frames(tp.PitchConfig(), SR), 3)
    # the lag of every frame (pitch is 1 / lag, taken from the same table)
    np.testing.assert_array_equal(got_pitch, want_pitch)
    np.testing.assert_allclose(got_nccf, want_nccf, atol=ATOL)
    np.testing.assert_allclose(got_feats, want_feats, atol=ATOL)


def test_pitch_on_noise(signals):
    want_pitch, want_nccf, want_feats, got_pitch, got_nccf, got_feats = signals["noise"]
    same = got_pitch == want_pitch
    assert 1.0 - same.mean() <= NOISE_LAG_SHARE
    np.testing.assert_allclose(got_nccf[same], want_nccf[same], atol=ATOL)
    # the normalized log pitch averages over +-75 frames; the POV feature
    # and the delta are per frame
    for col in (0, 2):
        np.testing.assert_allclose(got_feats[same, col], want_feats[same, col], atol=ATOL)


def test_pitch_tracks_tones(signals):
    """The port's own tracker finds the tones (tests/test_pitch.py's bound)."""
    for f0 in (80, 120, 200, 333):
        pitch = signals[f"tone_{f0}"][3][5:-5]
        assert np.abs(pitch - f0).max() / f0 < 0.02


def test_wrapper_runs_the_twin_on_the_cpu():
    before = pitch_viterbi.launches
    tp.pitch_batch(tp.PitchConfig(), torch.as_tensor(_tone(150.0, secs=0.5)[None]))
    assert pitch_viterbi.launches == before


@pytest.mark.parametrize("conf", sorted(CONFS))
def test_copied_helpers_equal_original(conf):
    kw = CONFS[conf]
    a, b = tp.PitchConfig(**kw), jp.PitchConfig(**kw)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert (a.frame_shift, a.frame_length) == (b.frame_shift, b.frame_length)
    assert tp._nccf_lag_range(a) == jp._nccf_lag_range(b)
    np.testing.assert_array_equal(tp.make_lags(a), jp.make_lags(b))
    for x, y in zip(tp._downsample_kernel(a), jp._downsample_kernel(b)):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(tp._upsample_matrix(a, tp.make_lags(a)),
                                  jp._upsample_matrix(b, jp.make_lags(b)))
    t = np.linspace(-0.01, 0.01, 101)
    np.testing.assert_array_equal(tp._filter_func(t, 1000.0, 3), jp._filter_func(t, 1000.0, 3))
    for n in (0, 100, 727, 728, 729, 4000, 16000, 32000, 48013):
        assert tp.num_pitch_frames(a, n) == jp.num_pitch_frames(b, n)


def test_config_fields_equal_original():
    ours = [(f.name, f.default, f.type) for f in dataclasses.fields(tp.PitchConfig)]
    theirs = [(f.name, f.default, f.type) for f in dataclasses.fields(jp.PitchConfig)]
    assert ours == theirs


def test_conf_parsing(tmp_path):
    conf = tmp_path / "pitch.conf"
    conf.write_text("--min-f0=60\n--max-f0=300\n--penalty-factor=0.2\n"
                    "--upsample-filter-width=3\n--unknown-key=whatever\n# comment\n")
    got = tp.pitch_config_from_conf(conf, samp_freq=8000.0)
    assert (got.min_f0, got.max_f0, got.penalty_factor, got.samp_freq) == (60, 300, 0.2, 8000.0)
    assert got.upsample_filter_width == 3 and isinstance(got.upsample_filter_width, int)
    assert dataclasses.asdict(got) == dataclasses.asdict(jp.pitch_config_from_conf(conf, 8000.0))


@pytest.mark.parametrize("cmvn", [False, True], ids=["plain", "ivector_cmvn"])
def test_acoustic_model_appends_pitch(tmp_path, monkeypatch, cmvn):
    """3 pitch columns after the MFCCs; the i-vector reads the base MFCC
    columns (CMVN'd with the extractor's stats when it has them), and the
    log-probs equal the JAX package's."""
    profile = build_synthetic_profile(tmp_path / "m", LEXICON, with_ivector=True,
                                      with_pitch=True, with_ivector_cmvn=cmvn)
    am = AcousticModel(profile.model_dir, device="cpu")
    jam = JaxAcousticModel(profile.model_dir)
    assert am.pitch_config is not None and am.ivector_params is not None
    assert dataclasses.asdict(am.pitch_config) == dataclasses.asdict(jam.pitch_config)
    assert (am.ivector_cmvn_stats is not None) == cmvn
    pcm = np.stack([_tone(150.0, secs=0.5), _sweep()[:8000]])
    feats = am.features(torch.as_tensor(pcm))
    C = am.frontend_config.num_ceps
    assert feats.shape[-1] == C + 3
    want = np.asarray(jam.features(pcm))
    cfg = am.frontend_config
    assert_mfcc_close(feats[..., :C], want[..., :C], mfcc_allowance(cfg, frames_of(cfg, pcm), sides=2))
    np.testing.assert_allclose(feats[..., C:].numpy(), want[..., C:], atol=ATOL)
    assert np.abs(feats[..., C:].numpy()).max() > 0.01

    widths = []
    real = transcribe_mod.extract_ivectors

    def recording(iv_feats, *args, **kwargs):
        widths.append(iv_feats.shape[-1])
        return real(iv_feats, *args, **kwargs)

    monkeypatch.setattr(transcribe_mod, "extract_ivectors", recording)
    lp = am.log_probs(feats, 8).numpy()
    assert widths == [C]
    jlp = np.asarray(jam.log_probs(jnp.asarray(feats.numpy()), num_out_frames=8))
    np.testing.assert_allclose(lp, jlp, rtol=LP_RTOL, atol=LP_ATOL)


def _train(root, profile):
    intents = {"language": "en", "intents": {"Main": {"data": [{"sentences": SENTENCES}]}}}
    train_model_sync("en", intents, root / "train", profile.model_dir,
                     lang_suffixes=[LangSuffix.GRAMMAR])
    return root / "train" / lang_dir_name(LangSuffix.GRAMMAR)


@pytest.mark.parametrize("family", ["nnet3", "gmm"])
def test_batch_transcripts_equal_jax(tmp_path, family):
    """Two utterances of different lengths in one call: pitch runs over the
    zero-padded batch, as the JAX package pads it."""
    if family == "nnet3":
        profile = build_synthetic_profile(tmp_path / "m", LEXICON, with_ivector=True,
                                          with_pitch=True)
    else:
        profile = _gmm_with_pitch(tmp_path / "m")
    graph_dir = _train(tmp_path, profile)
    pcms = [synthesize_sentence(profile, t, seed=30 + i) for i, t in enumerate(TEXTS)]
    assert pcms[0].shape != pcms[1].shape
    t = Nnet3WavTranscriber(profile.model_dir, graph_dir, device="cpu")
    jt = JaxTranscriber(profile.model_dir, graph_dir)
    assert t.am.pitch_config is not None and (t.am.gmm is not None) == (family == "gmm")
    got = t.transcribe_pcm_batch(pcms)
    assert got == jt.transcribe_pcm_batch(pcms) == [[x] for x in TEXTS]
    pcm, _feat_lengths, _lengths, _bucket = t._pad_batch(pcms)
    feats = t.am.features(pcm).numpy()
    want = np.asarray(jt.am.features(pcm.numpy()))
    C = t.am.frontend_config.num_ceps
    np.testing.assert_allclose(feats[..., C:], want[..., C:], atol=ATOL)
    if family == "gmm":
        # the Gaussians read the pitch columns and their deltas
        lp = t.am.log_probs(torch.as_tensor(feats), feats.shape[1]).numpy()
        jlp = np.asarray(jt.am.log_probs(jnp.asarray(feats), feats.shape[1]))
        np.testing.assert_allclose(lp, jlp, rtol=LP_RTOL, atol=LP_ATOL)
