"""The port's bf16 AM (``compute_dtype="bfloat16"``) on the CPU.

``tests/test_bf16.py``'s four cases on the port: bf16 batch transcripts,
n-best and fuzzy results and scheduler transcripts equal f32's on the
synthetic profile, and a TDNN-F forward in bf16 within the JAX package's
own bounds of f32 (log-prob |d| <= 5% of the f32 spread, the argmax equal
on >= 90% of the frames, flips only on near-ties). JAX and PyTorch round
bf16 at different points, so the port is held to those bounds, not to the
JAX package's bits. Then a recurrent model's bf16 batch forward against
the JAX package's bf16 forward and against f32, by the same bounds, and
the scheduler's rule that a recurrent model keeps its AM in f32.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from rhasspy_speech_tpu.models import compile_nnet3 as jax_compile
from rhasspy_speech_tpu.testing.tdnnf import build_tdnnf_spec

import torch

from rhasspy_speech_torch.const import LangSuffix
from rhasspy_speech_torch.models import nnet3 as tn
from rhasspy_speech_torch.pipeline import Nnet3WavTranscriber, lang_dir_name
from rhasspy_speech_torch.pipeline.scheduler import StreamScheduler
from rhasspy_speech_torch.pipeline.train import train_model_sync
from rhasspy_speech_torch.testing import build_synthetic_profile, synthesize_sentence
from rhasspy_speech_torch.testing.full_width import build_tdnn_lstm_spec

LEXICON = {
    "turn": ["t", "er", "n"],
    "on": ["aa", "n"],
    "off": ["ao", "f"],
    "the": ["dh", "ah"],
    "light": ["l", "ay", "t"],
    "fan": ["f", "ae", "n"],
}
SENTENCES = ["turn on the light", "turn off the fan", "turn on fan"]
SPREAD_SHARE = 0.05
MIN_AGREE = 0.9


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_bf16")
    profile = build_synthetic_profile(root / "model", LEXICON, with_ivector=True)
    train_model_sync(
        "en",
        {"language": "en",
         "intents": {"M": {"data": [{"sentences": ["turn (on|off) [the] (light|fan)"]}]}}},
        root / "train", profile.model_dir, lang_suffixes=[LangSuffix.GRAMMAR],
    )
    return profile, root / "train" / lang_dir_name(LangSuffix.GRAMMAR)


def _pair(profile, lang_dir):
    return (Nnet3WavTranscriber(profile.model_dir, lang_dir, device="cpu"),
            Nnet3WavTranscriber(profile.model_dir, lang_dir, device="cpu",
                                compute_dtype="bfloat16"))


def test_bf16_transcripts_match_f32(trained):
    profile, lang_dir = trained
    pcms = [synthesize_sentence(profile, s, seed=30 + i) for i, s in enumerate(SENTENCES)]
    t32, t16 = _pair(profile, lang_dir)
    assert t16.am.bf16 and t16.am.compiled(16).dtype == torch.bfloat16
    got32 = t32.transcribe_pcm_batch(pcms)
    assert got32 == [[s] for s in SENTENCES]
    assert t16.transcribe_pcm_batch(pcms) == got32


def test_bf16_nbest_and_fuzzy_match_f32(trained):
    profile, lang_dir = trained
    pcm = synthesize_sentence(profile, "turn on the light", seed=77)
    kwargs = dict(lang_dir=lang_dir, nbest=3, max_fuzzy_cost=1.0)
    t32, t16 = _pair(profile, lang_dir)
    assert t16.transcribe_pcm_batch([pcm], **kwargs) == t32.transcribe_pcm_batch([pcm], **kwargs)


def _within_bf16_bounds(out16, out32):
    spread = out32.max() - out32.min()
    delta = np.abs(out16 - out32)
    assert delta.max() <= SPREAD_SHARE * spread, (delta.max(), spread)
    top32, top16 = out32.argmax(-1), out16.argmax(-1)
    assert (top32 == top16).mean() >= MIN_AGREE
    flipped = top32 != top16
    if flipped.any():
        picked = np.take_along_axis(out32, top16[..., None], -1)[..., 0]
        assert (out32.max(-1) - picked)[flipped].max() <= SPREAD_SHARE * spread


def test_bf16_logit_delta_bounded_on_tdnnf():
    spec = build_tdnnf_spec(num_pdfs=512, input_dim=40, ivector_dim=16, hidden_dim=192,
                            num_tdnnf_layers=4)
    m32 = tn.compile_nnet3(spec, 16, subsampling=3, device="cpu")
    m16 = m32.cast(torch.bfloat16)
    lo, hi = m32.ranges["input"]
    rng = np.random.RandomState(3)
    feats = torch.as_tensor(rng.randn(4, hi - lo, 40).astype(np.float32))
    ivec = torch.as_tensor(rng.randn(4, 16).astype(np.float32))
    out32 = m32(feats, ivec).numpy()
    out16 = m16(feats, ivec)
    assert out16.dtype == torch.float32
    _within_bf16_bounds(out16.numpy(), out32)


def test_bf16_scheduler_matches_f32(trained):
    profile, lang_dir = trained

    def run(dtype):
        sched = StreamScheduler(profile.model_dir, lang_dir, max_streams=2,
                                compute_dtype=dtype, device="cpu")
        assert sched._bf16 == bool(dtype)
        assert sched._chunk_model.dtype == (torch.bfloat16 if dtype else torch.float32)
        texts = ["turn on the light", "turn off the fan"]
        sids = [sched.open_stream() for _ in texts]
        for sid, t in zip(sids, texts):
            sched.feed(sid, synthesize_sentence(profile, t, seed=500 + sid))
            sched.finish(sid)
        for _ in range(100):
            if all(sched.poll(s) is not None for s in sids):
                break
            sched.step()
        return [sched.poll(s) for s in sids]

    assert run("bfloat16") == run(None) == [["turn on the light"], ["turn off the fan"]]


def test_bf16_recurrent_batch_matches_jax_bounds():
    """A TDNN-LSTM at a narrow width, 3 chunks' worth of recurrent steps in
    bf16 (state carried in bf16, as the batch route casts it): the port's
    bf16 forward stays within the bounds of f32 and of the JAX package's
    bf16 forward, whose own f32 forward it equals at 2e-4."""
    spec = build_tdnn_lstm_spec(num_pdfs=48, input_dim=20, ivector_dim=8, hidden_dim=64,
                                cell_dim=64, proj_dim=16, seed=6)
    jm = jax_compile(spec, 21, subsampling=3)
    m32 = tn.compile_nnet3(spec, 21, subsampling=3, device="cpu")
    lo, hi = jm.ranges["input"]
    rng = np.random.RandomState(8)
    feats = rng.randn(2, hi - lo, 20).astype(np.float32)
    ivec = rng.randn(2, 8).astype(np.float32)
    want32 = np.asarray(jm.forward(jnp.asarray(feats), jnp.asarray(ivec)))
    want16 = np.asarray(jm.cast(jnp.bfloat16).forward(
        jnp.asarray(feats, jnp.bfloat16), jnp.asarray(ivec, jnp.bfloat16)).astype(jnp.float32))
    out32 = m32(torch.as_tensor(feats), torch.as_tensor(ivec)).numpy()
    np.testing.assert_allclose(out32, want32, rtol=2e-4, atol=2e-4)
    m16 = m32.cast(torch.bfloat16)
    assert m16.init_state(2)["lstm1.c_trunc"].dtype == torch.bfloat16
    out16 = m16(torch.as_tensor(feats), torch.as_tensor(ivec)).numpy()
    _within_bf16_bounds(out16, out32)
    _within_bf16_bounds(out16, want16)


def test_recurrent_scheduler_keeps_f32(tmp_path):
    """The scheduler's rule: a recurrent model's chunk AM stays in f32."""
    profile = build_synthetic_profile(tmp_path / "m", LEXICON, recurrent_delay=1)
    train_model_sync(
        "en", {"language": "en", "intents": {"M": {"data": [{"sentences": ["turn on fan"]}]}}},
        tmp_path / "t", profile.model_dir, lang_suffixes=[LangSuffix.GRAMMAR])
    sched = StreamScheduler(profile.model_dir, tmp_path / "t" / lang_dir_name(LangSuffix.GRAMMAR),
                            max_streams=2, compute_dtype="bfloat16", device="cpu")
    assert sched.am.bf16 and sched._recurrent and not sched._bf16
    assert sched._chunk_model.dtype == torch.float32
