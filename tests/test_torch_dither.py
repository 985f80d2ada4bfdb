"""Dither (Kaldi's ``--dither``) in the port, against the JAX package.

The batch route adds ``dither`` times standard normal noise of the frames'
shape to each frame before DC removal, with a fresh draw a call; the
stream, scheduler and Coqui routes run undithered, as the JAX package's
do. JAX and PyTorch draw different bits, so the frontends are compared on
the JAX package's own noise (``jax.random.normal(key, frames.shape)``),
injected into the port's twin, within ``testing/feature_tolerance.py``'s
allowance for two f32 front ends on the dithered frames (rtol 1e-4 /
atol 2e-3, widened only on ill-conditioned frames), as
``tests/test_torch_frontend.py`` holds the undithered ones; dithered and
undithered features differ by far more than that allowance. The port's own
draw is held to its distribution.
"""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from rhasspy_speech_tpu.ops import frontend as jf

import torch

from rhasspy_speech_torch import train_model_sync
from rhasspy_speech_torch.const import LangSuffix
from rhasspy_speech_torch.ops import frontend as tf
from rhasspy_speech_torch.ops.mfcc_cuda import mfcc_batch
from rhasspy_speech_torch.pipeline import Nnet3WavTranscriber, lang_dir_name
from rhasspy_speech_torch.pipeline.coqui import CoquiSttTranscriber
from rhasspy_speech_torch.pipeline.scheduler import StreamScheduler
from rhasspy_speech_torch.pipeline.stream import Nnet3StreamTranscriber
from rhasspy_speech_torch.pipeline.transcribe import AcousticModel
from rhasspy_speech_torch.testing import build_synthetic_profile, synthesize_sentence
from rhasspy_speech_torch.testing.feature_tolerance import (
    assert_mfcc_close,
    frames_of,
    mfcc_allowance,
    worst,
)
from rhasspy_speech_torch.testing.synthetic import build_synthetic_ctc_profile, synthesize_ctc_text

from test_torch_frontend import speech_like

LEXICON = {"turn": ["t", "er", "n"], "on": ["aa", "n"], "off": ["ao", "f"],
           "light": ["l", "ay", "t"]}


def _dithered(model_dir, dither):
    """Rewrite the profile's frontend.json with ``dither``."""
    fj = model_dir / "model" / "frontend.json"
    cfg = json.loads(fj.read_text(encoding="utf-8"))
    cfg["dither"] = dither
    fj.write_text(json.dumps(cfg), encoding="utf-8")


@pytest.mark.parametrize("cfg", [{}, dict(snip_edges=False), dict(use_energy=True)])
def test_twin_with_jax_noise_equals_jax_dither(cfg):
    rng = np.random.RandomState(5)
    pcm = np.stack([speech_like(rng, 6000), speech_like(rng, 6000)])
    jcfg = jf.FrontendConfig(dither=1.0, **cfg)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jf.mfcc_batch(jf.make_frontend_params(jcfg), jnp.asarray(pcm), dither_key=key))
    T = jf.num_frames(jcfg, pcm.shape[1])
    noise = np.array(jax.random.normal(key, (2, T, jcfg.frame_length), dtype=jnp.float32))
    params = tf.make_frontend_params(tf.FrontendConfig(dither=1.0, **cfg), "cpu")
    got = tf.mfcc_batch_torch(params, torch.as_tensor(pcm), torch.as_tensor(noise)).numpy()
    allow = mfcc_allowance(params.cfg, frames_of(params.cfg, pcm, noise), sides=2)
    assert_mfcc_close(got, want, allow)
    # the wrapper hands CPU tensors and the noise to the same twin
    np.testing.assert_array_equal(
        mfcc_batch(params, torch.as_tensor(pcm), torch.as_tensor(noise)).numpy(), got)
    # and the noise is what moved the features, far past the allowance
    plain = tf.mfcc_batch_torch(params, torch.as_tensor(pcm)).numpy()
    assert np.abs(got - plain).max() > 1e-3
    assert worst(plain, want, allow)[0] > 10.0


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_dither")
    profiles = {}
    for d in (0.0, 1.0):
        p = build_synthetic_profile(root / f"m{d}", LEXICON, with_ivector=True, with_context=True,
                                    with_ivector_cmvn=True)
        _dithered(p.model_dir, d)
        profiles[d] = p
    intents = {"language": "en",
               "intents": {"M": {"data": [{"sentences": ["turn (on|off) light"]}]}}}
    train_model_sync("en", intents, root / "train", profiles[0.0].model_dir,
                     lang_suffixes=[LangSuffix.GRAMMAR])
    return profiles, root / "train" / lang_dir_name(LangSuffix.GRAMMAR)


def test_acoustic_model_dither_config(trained):
    """A dithered model dir: each call draws new noise, two fresh models
    draw alike call for call, and the batch still transcribes."""
    profiles, graph_dir = trained
    model_dir = profiles[1.0].model_dir
    am = AcousticModel(model_dir, device="cpu")
    assert am.frontend_config.dither == 1.0
    pcm = torch.as_tensor((np.random.RandomState(3).randn(1, 8000) * 500).astype(np.float32))
    f1, f2 = am.features(pcm), am.features(pcm)
    assert f1.shape == f2.shape and not torch.allclose(f1, f2)
    fresh = AcousticModel(model_dir, device="cpu")
    assert torch.equal(fresh.features(pcm), f1) and torch.equal(fresh.features(pcm), f2)
    plain = AcousticModel(profiles[0.0].model_dir, device="cpu").features(pcm)
    assert not torch.allclose(plain, f1)
    t = Nnet3WavTranscriber(model_dir, graph_dir, device="cpu")
    speech = synthesize_sentence(profiles[1.0], "turn on light", seed=4)
    assert t.transcribe_pcm_batch([speech]) == [["turn on light"]]


def test_noise_is_standard_normal_of_the_frames_shape(trained):
    profiles, _graph_dir = trained
    am = AcousticModel(profiles[1.0].model_dir, device="cpu")
    pcm = torch.zeros((4, 32000))
    noise = am.dither_noise(pcm)
    cfg = am.frontend_config
    assert noise.shape == (4, tf.num_frames(cfg, 32000), cfg.frame_length)
    assert abs(float(noise.mean())) < 0.01 and abs(float(noise.std()) - 1.0) < 0.01
    assert not torch.equal(noise, am.dither_noise(pcm))
    assert AcousticModel(profiles[0.0].model_dir, device="cpu").dither_noise(pcm) is None


def test_stream_and_scheduler_features_undithered(trained):
    """The stream and the scheduler (device and host features) of a
    dithered model dir give the undithered model dir's feature rows and
    transcripts."""
    profiles, graph_dir = trained
    speech = synthesize_sentence(profiles[0.0], "turn off light", seed=9)
    rows = {}
    for d, p in profiles.items():
        st = Nnet3StreamTranscriber(p.model_dir, graph_dir, device="cpu")
        state = st.start_stream()
        for off in range(0, speech.shape[0], 1024):
            st.process_chunk(state, speech[off : off + 1024])
        rows[d] = state.feats.copy()
        assert st.finish_stream(state) == ["turn off light"]
        s = StreamScheduler(p.model_dir, graph_dir, max_streams=2, device="cpu")
        assert s._device_feats
        sid = s.open_stream()
        s.feed(sid, speech)
        s.finish(sid)
        for _ in range(100):
            if s.poll(sid) is not None:
                break
            s.step()
        assert s.poll(sid) == ["turn off light"]
        rows[("ring", d)] = s._st.feats_ring[sid, : state.feats.shape[0]].numpy().copy()
    np.testing.assert_array_equal(rows[1.0], rows[0.0])
    np.testing.assert_array_equal(rows[("ring", 1.0)], rows[("ring", 0.0)])


def test_coqui_features_undithered(tmp_path):
    chars = sorted(set("turnonfflight"))
    probs = {}
    for d in (0.0, 1.0):
        profile = build_synthetic_ctc_profile(tmp_path / f"m{d}", chars)
        fj = profile.model_dir / "frontend.json"
        cfg = json.loads(fj.read_text(encoding="utf-8"))
        cfg["dither"] = d
        fj.write_text(json.dumps(cfg), encoding="utf-8")
        (profile.model_dir / "config.json").write_text(json.dumps({"type": "coqui"}))
        intents = {"language": "en", "intents": {"M": {"data": [{"sentences": ["turn on light"]}]}}}
        train_model_sync("en", intents, tmp_path / f"t{d}", profile.model_dir)
        t = CoquiSttTranscriber(profile.model_dir, tmp_path / f"t{d}", device="cpu")
        assert t.frontend_config.dither == d
        pcm = synthesize_ctc_text(profile, "turn on light", seed=2)
        probs[d] = t.compute_probs(pcm)
        state = t.start_stream()
        for off in range(0, pcm.shape[0], 1024):
            t.process_chunk(state, pcm[off : off + 1024])
        probs[("stream", d)] = state.feats.copy()
    np.testing.assert_array_equal(probs[1.0], probs[0.0])
    np.testing.assert_array_equal(probs[("stream", 1.0)], probs[("stream", 0.0)])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the MFCC kernel runs only on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [{}, dict(snip_edges=False), dict(use_energy=True)])
def test_kernel_with_noise_equals_twin(cuda, cfg):
    """K1 adds the same noise as its twin: equal within K1's tolerance
    (tests/test_torch_kernels.py), one launch."""
    from test_torch_kernels import MFCC_ATOL, MFCC_RTOL

    rng = np.random.RandomState(6)
    pcm = torch.as_tensor(np.stack([speech_like(rng, 24000) for _ in range(3)]), device=cuda)
    params = tf.make_frontend_params(tf.FrontendConfig(dither=1.0, **cfg), cuda)
    T = tf.num_frames(params.cfg, pcm.shape[1])
    noise = torch.randn((3, T, params.cfg.frame_length), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(7))
    want = tf.mfcc_batch_torch(params, pcm, noise)
    before = mfcc_batch.launches
    got = mfcc_batch(params, pcm, noise)
    torch.cuda.synchronize()
    assert mfcc_batch.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=MFCC_RTOL, atol=MFCC_ATOL)
    assert not torch.allclose(got, mfcc_batch(params, pcm), rtol=MFCC_RTOL, atol=MFCC_ATOL)
    with pytest.raises(ValueError, match="noise"):
        mfcc_batch(params, pcm, noise[:, :-1])
