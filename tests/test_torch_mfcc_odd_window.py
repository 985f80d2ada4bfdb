"""K1's odd padded window (``round_to_power_of_two=false`` with an odd
frame, e.g. ``--frame-length=25.0625`` = 401 samples), which the kernel
computes as a direct real DFT.

On the CPU: the port's MFCC (the kernel's plain twin) against the JAX
package's ``mfcc_batch`` at N = 401 and N = 399, at K1's stated tolerance
(rtol 2e-3 / atol 3e-2, the JAX package's for its own DFT-as-matmul kernel
against rfft); and a synthetic profile with a 401-sample window through the
batch, stream and scheduler routes, whose transcripts equal the JAX batch
transcriber's and the spoken sentences. On a card (marker ``cuda``): the
kernel against its twin at the same tolerance.
"""

import dataclasses
import json

import numpy as np
import pytest

import jax.numpy as jnp

from rhasspy_speech_tpu.ops.frontend import FrontendConfig as JaxFrontendConfig
from rhasspy_speech_tpu.ops.frontend import make_frontend_params as jax_frontend_params
from rhasspy_speech_tpu.ops.frontend import mfcc_batch as jax_mfcc_batch
from rhasspy_speech_tpu.pipeline import Nnet3WavTranscriber as JaxTranscriber

import torch

from rhasspy_speech_torch.const import LangSuffix
from rhasspy_speech_torch.ops.frontend import FrontendConfig, make_frontend_params
from rhasspy_speech_torch.ops.mfcc_cuda import mfcc_batch
from rhasspy_speech_torch.pipeline import Nnet3WavTranscriber, lang_dir_name
from rhasspy_speech_torch.pipeline.scheduler import StreamScheduler
from rhasspy_speech_torch.pipeline.stream import Nnet3StreamTranscriber
from rhasspy_speech_torch.pipeline.train import train_model_sync
from rhasspy_speech_torch.testing import build_synthetic_profile, synthesize_sentence

from test_torch_pipeline import LEXICON, SENTENCES, SPOKEN

RTOL, ATOL = 2e-3, 3e-2
# (frame length ms, snip_edges): 401 and 399 samples at 16 kHz
ODD = {"401": (25.0625, True), "399": (24.9375, False)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _speech_like(seed, B=3, S=24000):
    rng = np.random.RandomState(seed)
    t = np.arange(S) / 16000.0
    tone = 3000.0 * np.sin(2 * np.pi * (180.0 + 40.0 * rng.rand(B, 1)) * t[None, :])
    return (tone + 600.0 * rng.randn(B, S)).astype(np.float32)


def _config(key):
    ms, snip = ODD[key]
    return dict(frame_length_ms=ms, round_to_power_of_two=False, snip_edges=snip)


@pytest.mark.parametrize("key", sorted(ODD))
def test_twin_matches_jax(key):
    cfg = FrontendConfig(**_config(key))
    assert cfg.padded_window_size == int(key) and cfg.padded_window_size % 2
    pcm = _speech_like(int(key))
    got = mfcc_batch(make_frontend_params(cfg, "cpu"), torch.as_tensor(pcm)).numpy()
    jcfg = JaxFrontendConfig(**_config(key))
    want = np.asarray(jax_mfcc_batch(jax_frontend_params(jcfg), jnp.asarray(pcm)))
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def odd_profile(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_odd_window")
    frontend = dataclasses.replace(FrontendConfig(), **_config("401"))
    profile = build_synthetic_profile(root / "model", LEXICON, frontend=frontend)
    # the profile's frontend.json keeps the mel fields only: add the window
    path = profile.model_dir / "model" / "frontend.json"
    conf = json.loads(path.read_text(encoding="utf-8"))
    conf.update(frame_length_ms=frontend.frame_length_ms, round_to_power_of_two=False)
    path.write_text(json.dumps(conf), encoding="utf-8")
    intents = {"language": "en", "intents": {"Main": {"data": [{"sentences": SENTENCES}]}}}
    train_model_sync("en", intents, root / "train", profile.model_dir,
                     lang_suffixes=[LangSuffix.GRAMMAR])
    graph_dir = root / "train" / lang_dir_name(LangSuffix.GRAMMAR)
    pcms = [synthesize_sentence(profile, t, seed=40 + i) for i, t in enumerate(SPOKEN)]
    return profile, graph_dir, pcms


def test_routes_with_odd_window(odd_profile):
    """Batch, stream and scheduler (fused device-feature route) with a
    401-sample window transcribe the spoken sentences, as the JAX batch
    transcriber does."""
    profile, graph_dir, pcms = odd_profile
    t = Nnet3WavTranscriber(profile.model_dir, graph_dir, device="cpu")
    assert t.am.frontend_config.padded_window_size == 401
    want = [[s] for s in SPOKEN]
    assert t.transcribe_pcm_batch(pcms) == want
    assert JaxTranscriber(profile.model_dir, graph_dir).transcribe_pcm_batch(pcms) == want
    st = Nnet3StreamTranscriber(profile.model_dir, graph_dir, device="cpu")
    assert [st.transcribe_pcm(p, chunk_samples=1024) for p in pcms] == want
    sched = StreamScheduler(profile.model_dir, graph_dir, max_streams=4, device="cpu")
    assert sched._device_feats
    sids = []
    for p in pcms:
        sid = sched.open_stream()
        sched.feed(sid, p)
        sched.finish(sid)
        sids.append(sid)
    sched.run_until_idle()
    assert [sched.poll(sid) for sid in sids] == want


@pytest.mark.cuda
@pytest.mark.parametrize("key", sorted(ODD))
def test_kernel_matches_twin(cuda, key):
    cfg = FrontendConfig(**_config(key))
    pcm = torch.as_tensor(_speech_like(int(key) + 1))
    want = mfcc_batch(make_frontend_params(cfg, "cpu"), pcm)
    before = mfcc_batch.launches
    got = mfcc_batch(make_frontend_params(cfg, cuda), pcm.to(cuda))
    torch.cuda.synchronize()
    assert mfcc_batch.launches == before + 1
    torch.testing.assert_close(got.cpu(), want, rtol=RTOL, atol=ATOL)
