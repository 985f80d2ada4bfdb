"""The port's batch transcription slice against the JAX package, end to end.

A synthetic profile with an i-vector extractor (``build_synthetic_profile
(..., with_ivector=True)``) is trained once; the JAX transcriber and the
port's transcriber (``device="cpu"``, so the plain twins run) must give
equal transcripts, equal arc traces and the spoken sentence. Log-probs
are held within rtol 1e-4 / atol 1e-3 (f32 matmuls summed in another
order); the traces are equal because the decode is exact and the tiny
log-prob differences never flip a path on these inputs.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp

from rhasspy_speech_tpu.const import LangSuffix
from rhasspy_speech_tpu.ops.decoder import viterbi_decode as jax_viterbi_decode
from rhasspy_speech_tpu.ops.frontend import num_frames as jax_num_frames
from rhasspy_speech_tpu.pipeline import Nnet3WavTranscriber as JaxTranscriber
from rhasspy_speech_tpu.pipeline import lang_dir_name
from rhasspy_speech_tpu.pipeline.train import train_model_sync
from rhasspy_speech_tpu.testing import build_synthetic_profile, synthesize_sentence

import torch

import rhasspy_speech_torch
from rhasspy_speech_torch import Nnet3WavTranscriber

LEXICON = {
    "turn": ["t", "er", "n"],
    "on": ["aa", "n"],
    "off": ["ao", "f"],
    "the": ["dh", "ah"],
    "light": ["l", "ay", "t"],
    "fan": ["f", "ae", "n"],
    "never": ["n", "eh", "v", "er"],
    "mind": ["m", "ay", "n", "d"],
}
SENTENCES = ["turn (on|off) [the] (light|fan)", "never mind"]
SPOKEN = ["turn on the light", "never mind", "turn off fan"]
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_profile")
    profile = build_synthetic_profile(root / "model", LEXICON, with_ivector=True)
    intents = {"language": "en", "intents": {"Main": {"data": [{"sentences": SENTENCES}]}}}
    train_model_sync("en", intents, root / "train", profile.model_dir,
                     lang_suffixes=[LangSuffix.GRAMMAR])
    graph_dir = root / "train" / lang_dir_name(LangSuffix.GRAMMAR)
    pcms = [synthesize_sentence(profile, s, seed=i) for i, s in enumerate(SPOKEN)]
    return profile.model_dir, graph_dir, pcms


def test_transcripts_and_traces_equal_jax(trained):
    model_dir, graph_dir, pcms = trained
    jt = JaxTranscriber(model_dir, graph_dir)
    tt = Nnet3WavTranscriber(model_dir, graph_dir, device="cpu")
    assert tt.am.ivector_params is not None  # the i-vector branch runs

    want = jt.transcribe_pcm_batch(pcms, max_fuzzy_cost=1.0)
    got = tt.transcribe_pcm_batch(pcms, max_fuzzy_cost=1.0)
    assert got == want == [[s] for s in SPOKEN]

    log_probs, lengths = tt._acoustic_batch(pcms)
    trace, final_state, cost = tt._decode_traces(log_probs, lengths)
    n_frames = [jax_num_frames(jt.am.frontend_config, len(p)) for p in pcms]
    S = max(len(p) for p in pcms)
    pcm = np.stack([np.pad(p, (0, S - len(p))) for p in pcms])
    jlp = np.asarray(jt.am.log_probs(
        jt.am.features(pcm), log_probs.shape[1],
        feat_lengths=jnp.asarray(n_frames, jnp.int32),
    ))
    np.testing.assert_allclose(log_probs.numpy(), jlp, rtol=1e-4, atol=1e-3)
    jtrace, jfinal, jcost = jax_viterbi_decode(
        jt.device_graph, jnp.asarray(jlp), lengths=jnp.asarray(lengths.numpy())
    )
    np.testing.assert_array_equal(trace, np.asarray(jtrace))
    np.testing.assert_array_equal(final_state, np.asarray(jfinal))
    np.testing.assert_allclose(cost, np.asarray(jcost), rtol=1e-5)


def test_require_fuzzy_rejects_like_jax(trained):
    model_dir, graph_dir, pcms = trained
    jt = JaxTranscriber(model_dir, graph_dir)
    tt = Nnet3WavTranscriber(model_dir, graph_dir, device="cpu")
    kw = dict(max_fuzzy_cost=-1.0, require_fuzzy=True)
    assert tt.transcribe_pcm_batch(pcms[:1], **kw) == jt.transcribe_pcm_batch(pcms[:1], **kw) == [[]]


def test_unported_options_raise(trained):
    model_dir, graph_dir, pcms = trained
    tt = Nnet3WavTranscriber(model_dir, graph_dir, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tt.transcribe_pcm_batch(pcms[:1], nbest=3)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Nnet3WavTranscriber(model_dir, graph_dir, device="cpu", silence_weight=0.1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Nnet3WavTranscriber(model_dir, graph_dir, device="cpu", compute_dtype="bfloat16")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tt.transcribe_rescore("x.wav", graph_dir, graph_dir)


def test_cuda_default_raises_without_cuda(trained):
    model_dir, graph_dir, _ = trained
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        Nnet3WavTranscriber(model_dir, graph_dir)


def test_async_transcribe_wav(trained, tmp_path):
    import asyncio
    import wave

    model_dir, graph_dir, pcms = trained
    path = tmp_path / "a.wav"
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(np.clip(pcms[1], -32768, 32767).astype(np.int16).tobytes())
    tt = Nnet3WavTranscriber(model_dir, graph_dir, device="cpu")
    assert asyncio.run(tt.async_transcribe(path)) == [SPOKEN[1]]


def test_port_runs_with_jax_blocked(trained, tmp_path):
    """A process where ``import jax`` fails imports the port and
    transcribes on the CPU from the profile this process built."""
    model_dir, graph_dir, pcms = trained
    np.save(tmp_path / "pcm.npy", pcms[0])
    script = textwrap.dedent(
        f"""
        import sys
        sys.modules["jax"] = None
        sys.path.insert(0, {str(REPO)!r})
        import numpy as np
        from rhasspy_speech_torch import Nnet3WavTranscriber
        t = Nnet3WavTranscriber({str(model_dir)!r}, {str(graph_dir)!r}, device="cpu")
        out = t.transcribe_pcm_batch([np.load({str(tmp_path / "pcm.npy")!r})])
        assert not any(m == "jax" or m.startswith("jax.") for m, v in sys.modules.items() if v is not None)
        print(out[0][0])
        """
    )
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True, timeout=300,
        cwd=str(tmp_path), env=env,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == SPOKEN[0]


def test_package_surface():
    for name in ("Nnet3WavTranscriber", "KaldiNnet3WavTranscriber", "AcousticModel",
                 "train_model", "train_model_sync", "LangSuffix"):
        assert hasattr(rhasspy_speech_torch, name)
    for method in ("transcribe", "transcribe_batch", "transcribe_pcm_batch", "async_transcribe"):
        assert callable(getattr(Nnet3WavTranscriber, method))


def test_copied_select_decoder_equals_original():
    from rhasspy_speech_tpu.pipeline.transcribe import select_decoder as jax_select
    from rhasspy_speech_torch.pipeline.transcribe import select_decoder

    for states, batch, frames, k, arcs, budget in [
        (803, 32, 112, 1, 1964, 3 << 30),
        (14178, 512, 101, 1, 37658, 3 << 30),
        (14178, 64, 400, 1, 70000, 1 << 26),
        (200000, 64, 400, 1, 500000, 1 << 26),
        (5000, 8, 50, 3, 9000, 1 << 22),
    ]:
        kw = dict(budget=budget, num_arcs=arcs, out_degree=7)
        assert select_decoder(states, batch, frames, k, 7000, **kw) == jax_select(
            states, batch, frames, k, 7000, **kw)


def test_copied_read_wav_equals_original(trained, tmp_path):
    import wave

    from rhasspy_speech_tpu.pipeline.transcribe import read_wav as jax_read_wav
    from rhasspy_speech_torch.pipeline import read_wav

    _, _, pcms = trained
    path = tmp_path / "b.wav"
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(np.clip(pcms[2], -32768, 32767).astype(np.int16).tobytes())
    np.testing.assert_array_equal(read_wav(path), jax_read_wav(path))
