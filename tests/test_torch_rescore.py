"""Lattice rescoring in the port against the JAX package's, end to end.

tests/test_rescore.py's case: the first pass knows only "turn red", the
rescore lang only "turn read" (a homophone). The lattice rescore remaps
the decode lattice through the new lang's lexicon and LM, so it recovers
a hypothesis no first-pass n-best can hold. The port's transcriber
(``device="cpu"``) must answer as the JAX transcriber does, through the
lattice path, its async form and the n-best fallback.
"""

import asyncio
import wave

import numpy as np
import pytest

from rhasspy_speech_tpu.const import LangSuffix
from rhasspy_speech_tpu.pipeline import Nnet3WavTranscriber as JaxTranscriber
from rhasspy_speech_tpu.pipeline import lang_dir_name
from rhasspy_speech_tpu.pipeline.train import train_model_sync
from rhasspy_speech_tpu.testing import build_synthetic_profile, synthesize_sentence

from rhasspy_speech_torch import Nnet3WavTranscriber

LEXICON = {
    "turn": ["t", "er", "n"],
    "red": ["r", "eh", "d"],
    "read": ["r", "eh", "d"],
    "on": ["aa", "n"],
}


def _intents(sentence):
    return {"language": "en", "intents": {"M": {"data": [{"sentences": [sentence]}]}}}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_rescore")
    profile = build_synthetic_profile(root / "model", LEXICON)
    old_train, new_train = root / "train_old", root / "train_new"
    train_model_sync("en", _intents("turn red"), old_train, profile.model_dir,
                     lang_suffixes=[LangSuffix.GRAMMAR])
    train_model_sync("en", _intents("turn read"), new_train, profile.model_dir,
                     lang_suffixes=[LangSuffix.ARPA, LangSuffix.ARPA_RESCORE])
    old_lang = old_train / lang_dir_name(LangSuffix.GRAMMAR)
    new_lang = new_train / lang_dir_name(LangSuffix.ARPA_RESCORE)
    pcm = synthesize_sentence(profile, "turn red", seed=7)
    wav = root / "utt.wav"
    with wave.open(str(wav), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.astype(np.int16).tobytes())
    return profile.model_dir, old_lang, new_lang, wav, pcm


def test_rescore_recovers_hypothesis_outside_first_pass(setup):
    model_dir, old_lang, new_lang, wav, pcm = setup
    tt = Nnet3WavTranscriber(model_dir, old_lang, device="cpu")
    jt = JaxTranscriber(model_dir, old_lang)
    assert tt.artifacts.words.find("read") is None
    first_pass = tt.transcribe_pcm_batch([pcm], nbest=5)[0]
    assert first_pass == jt.transcribe_pcm_batch([pcm], nbest=5)[0]
    assert first_pass and all("read" not in text.split() for text in first_pass)

    got = tt.transcribe_rescore(wav, old_lang_dir=old_lang, new_lang_dir=new_lang, nbest=5)
    want = jt.transcribe_rescore(wav, old_lang_dir=old_lang, new_lang_dir=new_lang, nbest=5)
    assert got == want and got[0] == "turn read"
    kw = dict(nbest=5, max_fuzzy_cost=-1.0, require_fuzzy=True)
    assert tt.transcribe_rescore(wav, old_lang, new_lang, **kw) == jt.transcribe_rescore(
        wav, old_lang, new_lang, **kw) == []
    assert asyncio.run(tt.async_transcribe_rescore(wav, old_lang, new_lang, nbest=5)) == want


def test_rescore_nbest_fallback_equals_jax(setup, caplog):
    """Without phone metadata on the decode graph the rescore falls back
    to an n-best LM swap over the first pass (k-best decode)."""
    model_dir, old_lang, _new_lang, wav, _pcm = setup
    tt = Nnet3WavTranscriber(model_dir, old_lang, device="cpu")
    jt = JaxTranscriber(model_dir, old_lang)
    for t in (tt, jt):
        t.artifacts.graph.arc_phone = None
    got = tt.transcribe_rescore(wav, old_lang, old_lang, nbest=3)
    assert "falling back" in caplog.text
    assert got == jt.transcribe_rescore(wav, old_lang, old_lang, nbest=3) == ["turn red"]
