"""The port's streaming transcriber against the JAX package's and against the
port's batch transcriber, end to end on the CPU.

A synthetic profile with an i-vector extractor is trained once (grammar,
ARPA and ARPA-rescore lang dirs). Utterances of 3 s and more (two sentences
with silence between them) are streamed in 1,024-sample chunks through both
packages' ``Nnet3StreamTranscriber``: transcripts must be equal, and equal
to the port's batch transcripts, plain, with ``silence_weight``, with
``nbest=3``, through ``finish_stream_rescore`` and through
``async_transcribe``. Chunk by chunk the streamed MFCCs and the pending
i-vector window agree within ``testing/feature_tolerance.py``'s allowance
for two f32 front ends (rtol 1e-4 / atol 2e-3, widened only on frames
whose weak mel bands an f32 FFT cannot resolve), the carried i-vector statistics
``(gamma, X)`` agree within rtol 1e-4 (atol 1e-4 on near-zero entries) and
the i-vectors solved from them within 2e-3, the tolerance
tests/test_torch_ivector.py states; the statistics are folded one chunk
late, and a slip there drifts on audio this long. Costs summed over an
utterance are held to atol 1e-2 (tests/test_torch_pipeline.py), the carried
alpha also to rtol 1e-5 (tests/test_torch_scheduler.py: COST_RTOL).
"""

import asyncio

import numpy as np
import pytest

import jax.numpy as jnp

from rhasspy_speech_tpu.const import LangSuffix
from rhasspy_speech_tpu.ops.ivector import solve_ivector as jax_solve_ivector
from rhasspy_speech_tpu.pipeline import lang_dir_name
from rhasspy_speech_tpu.pipeline.stream import Nnet3StreamTranscriber as JaxStreamTranscriber
from rhasspy_speech_tpu.pipeline.train import train_model_sync
from rhasspy_speech_tpu.testing import build_synthetic_profile, synthesize_sentence
from rhasspy_speech_tpu.testing.synthetic import _silence_wave

import torch

import rhasspy_speech_torch
from rhasspy_speech_torch import Nnet3StreamTranscriber, Nnet3WavTranscriber
from rhasspy_speech_torch.ops.ivector import solve_ivector
from rhasspy_speech_torch.pipeline import stream as stream_mod
from rhasspy_speech_torch.testing.feature_tolerance import (
    assert_mfcc_close,
    frames_of,
    mfcc_allowance,
)

from test_torch_pipeline import LEXICON

COST_ATOL = 1e-2
COST_RTOL = 1e-5  # a carried alpha's f32 order, as tests/test_torch_scheduler.py states
IV_TOL = 2e-3
SENTENCES = ["turn (on|off) [the] (light|fan) [never mind]", "never mind"]
SPOKEN = ["turn on the light never mind", "turn off fan never mind", "never mind"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_stream")
    profile = build_synthetic_profile(root / "model", LEXICON, with_ivector=True)
    intents = {"language": "en", "intents": {"Main": {"data": [{"sentences": SENTENCES}]}}}
    train_model_sync(
        "en", intents, root / "train", profile.model_dir,
        lang_suffixes=[LangSuffix.GRAMMAR, LangSuffix.ARPA, LangSuffix.ARPA_RESCORE])
    dirs = {s: root / "train" / lang_dir_name(s) for s in LangSuffix}
    pcms = utterances(profile)
    assert max(len(p) for p in pcms) >= 3 * 16000
    return profile.model_dir, dirs, pcms


def utterances(profile):
    """SPOKEN as PCM: each sentence's last two words after a silence gap."""
    sil = _silence_wave(16000, np.random.RandomState(0))[:10000]
    pcms = []
    for i, text in enumerate(SPOKEN):
        words = text.split()
        cut = len(words) - 2 if len(words) > 2 else 0
        parts = [synthesize_sentence(profile, " ".join(words[:cut]), seed=i)] if cut else []
        parts += [sil, synthesize_sentence(profile, " ".join(words[cut:]), seed=10 + i), sil]
        pcms.append(np.concatenate(parts).astype(np.float32))
    return pcms


def _stream(t, pcm, chunk=1024):
    state = t.start_stream()
    for off in range(0, pcm.shape[0], chunk):
        t.process_chunk(state, pcm[off : off + chunk])
    return state


@pytest.mark.parametrize("kw", [dict(), dict(silence_weight=0.01), dict(nbest=3)],
                         ids=["plain", "silence_weight", "nbest3"])
def test_streamed_transcripts_equal_jax_and_batch(trained, kw):
    model_dir, dirs, pcms = trained
    graph_dir = dirs[LangSuffix.GRAMMAR]
    js = JaxStreamTranscriber(model_dir, graph_dir, **kw)
    ts = Nnet3StreamTranscriber(model_dir, graph_dir, device="cpu", **kw)
    tb = Nnet3WavTranscriber(model_dir, graph_dir, device="cpu")
    batch = tb.transcribe_pcm_batch(pcms)
    for pcm, spoken, want_batch in zip(pcms, SPOKEN, batch):
        got = ts.transcribe_pcm(pcm, chunk_samples=1024)
        assert got == js.transcribe_pcm(pcm, chunk_samples=1024) == want_batch == [spoken]
    # the fuzzy tail on the stream's hypotheses
    fz = dict(max_fuzzy_cost=1.5, require_fuzzy=True)
    assert ts.transcribe_pcm(pcms[1], **fz) == js.transcribe_pcm(pcms[1], **fz) == [SPOKEN[1]]
    assert ts.transcribe_pcm(pcms[1], max_fuzzy_cost=-1.0, require_fuzzy=True) == []


@pytest.mark.parametrize("kw", [dict(), dict(silence_weight=0.01), dict(nbest=2)],
                         ids=["plain", "silence_weight", "nbest2"])
def test_chunk_by_chunk_state_equals_jax(trained, kw):
    """After every push: the same frames consumed, backpointer rows EQUAL
    (the decode is exact and the tiny log-prob differences flip no arc on
    these inputs), the pending i-vector window and weights equal, and the
    carried statistics and the i-vector solved from them within
    tolerance."""
    model_dir, dirs, pcms = trained
    graph_dir = dirs[LangSuffix.GRAMMAR]
    js = JaxStreamTranscriber(model_dir, graph_dir, **kw)
    ts = Nnet3StreamTranscriber(model_dir, graph_dir, device="cpu", **kw)
    pcm = pcms[0]
    cfg = ts.am.frontend_config
    allow = mfcc_allowance(cfg, frames_of(cfg, pcm), sides=2)  # rows: frames of the whole PCM
    sl, sr, chunk_in = ts._ivp.splice_left, ts._ivp.splice_right, ts._chunk_in
    jstate, tstate = js.start_stream(), ts.start_stream()
    folds = 0
    for off in range(0, pcm.shape[0], 1024):
        js.process_chunk(jstate, pcm[off : off + 1024])
        ts.process_chunk(tstate, pcm[off : off + 1024])
        assert tstate.frames_consumed == jstate.frames_consumed
        assert tstate.out_frames == jstate.out_frames and len(tstate.bps) == len(jstate.bps)
        have = tstate.feats.shape[0]
        assert_mfcc_close(tstate.feats, jstate.feats, allow.rows(slice(0, have)))
        if len(tstate.bps) > folds:
            folds = len(tstate.bps)
            np.testing.assert_array_equal(tstate.bps[-1], np.asarray(jstate.bps[-1]))
            # the last chunk's staged window: its rows, clamped as stage_ivector_window clamps
            t0 = tstate.frames_consumed - chunk_in
            rows = np.clip(np.arange(t0 - sl, t0 + chunk_in + sr), 0, max(have - 1, 0))
            assert_mfcc_close(tstate.iv_pending_win, jstate.iv_pending_win, allow.rows(rows))
            np.testing.assert_array_equal(tstate.iv_pending_w, jstate.iv_pending_w)
            gamma, X = tstate.iv_gamma.numpy(), tstate.iv_X.numpy()
            np.testing.assert_allclose(gamma, np.asarray(jstate.iv_gamma), rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(X, np.asarray(jstate.iv_X), rtol=1e-4, atol=1e-3)
            ivec = solve_ivector(tstate.iv_gamma[None], tstate.iv_X[None], ts._ivp).numpy()
            jivec = np.asarray(jax_solve_ivector(jstate.iv_gamma[None], jstate.iv_X[None], js._ivp))
            np.testing.assert_allclose(ivec, jivec, rtol=IV_TOL, atol=IV_TOL)
    assert folds >= 14  # 3 s and more: at least 14 chunks of 210 ms
    if kw.get("silence_weight") is not None:
        plain = Nnet3StreamTranscriber(model_dir, graph_dir, device="cpu")
        pstate = _stream(plain, pcm)
        assert float(tstate.iv_gamma.sum()) < float(pstate.iv_gamma.sum())  # silence weighed less
    want, got = js.finish_nbest(jstate), ts.finish_nbest(tstate)
    assert [w for w, _ in got] == [w for w, _ in want]
    np.testing.assert_allclose([c for _, c in got], [c for _, c in want], atol=COST_ATOL)
    np.testing.assert_allclose(tstate.alpha.numpy(), np.asarray(jstate.alpha), rtol=COST_RTOL,
                               atol=COST_ATOL)


def test_finish_stream_rescore_equals_jax(trained):
    model_dir, dirs, pcms = trained
    old, new = dirs[LangSuffix.ARPA], dirs[LangSuffix.ARPA_RESCORE]
    js = JaxStreamTranscriber(model_dir, old, nbest=4)
    ts = Nnet3StreamTranscriber(model_dir, old, device="cpu", nbest=4)
    pcm = pcms[1]
    want = js.finish_stream_rescore(_stream(js, pcm), old_lang_dir=old, new_lang_dir=new)
    got = ts.finish_stream_rescore(_stream(ts, pcm), old_lang_dir=old, new_lang_dir=new)
    assert got == want and got[0] == SPOKEN[1]
    # the grammar graph's stream, rescored through the ARPA rescore LM
    gs = Nnet3StreamTranscriber(model_dir, dirs[LangSuffix.GRAMMAR], device="cpu")
    jg = JaxStreamTranscriber(model_dir, dirs[LangSuffix.GRAMMAR])
    args = (dirs[LangSuffix.GRAMMAR], new)
    assert gs.finish_stream_rescore(_stream(gs, pcm), *args, nbest=5) == jg.finish_stream_rescore(
        _stream(jg, pcm), *args, nbest=5)


def test_async_transcribe_and_rescore(trained):
    model_dir, dirs, pcms = trained
    old, new = dirs[LangSuffix.ARPA], dirs[LangSuffix.ARPA_RESCORE]
    ts = Nnet3StreamTranscriber(model_dir, dirs[LangSuffix.GRAMMAR], device="cpu")

    async def audio(pcm):
        data = np.clip(pcm, -32768, 32767).astype(np.int16).tobytes()
        yield b""
        for off in range(0, len(data), 2048):
            yield data[off : off + 2048]

    assert asyncio.run(ts.async_transcribe(audio(pcms[0]))) == [SPOKEN[0]]
    assert asyncio.run(ts.async_transcribe(audio(pcms[2]), max_fuzzy_cost=1.5)) == [SPOKEN[2]]
    ta = Nnet3StreamTranscriber(model_dir, old, device="cpu")
    got = asyncio.run(ta.async_transcribe_rescore(audio(pcms[1]), old, new, nbest=3))
    assert got and got[0] == SPOKEN[1]


def test_uneven_pushes_and_empty_stream(trained):
    model_dir, dirs, pcms = trained
    ts = Nnet3StreamTranscriber(model_dir, dirs[LangSuffix.GRAMMAR], device="cpu")
    pcm = pcms[1]
    state = ts.start_stream()
    off = 0
    for c in [7, 160, 3361, 1, 20000, 399]:
        ts.process_chunk(state, pcm[off : off + c])
        off += c
    ts.process_chunk(state, pcm[off:])
    assert ts.finish_stream(state) == [SPOKEN[1]]
    assert ts.finish_stream(ts.start_stream()) == []
    assert ts.finish_nbest(ts.start_stream()) == []


def test_chunk_decode_uses_the_kernel_wrapper_with_carried_alpha(trained, monkeypatch):
    """Every chunk is ONE ``viterbi_decode`` call with ``alpha0`` the carried
    alpha, ``lengths`` the chunk's valid frames, T = 7, B = 1; on CPU tensors
    the wrapper runs the plain version and launches nothing."""
    model_dir, dirs, pcms = trained
    ts = Nnet3StreamTranscriber(model_dir, dirs[LangSuffix.GRAMMAR], device="cpu")
    calls = []
    real = stream_mod.viterbi_decode

    def recording(graph, log_probs, scale, lengths, return_forward=False, alpha0=None):
        calls.append((tuple(log_probs.shape), int(lengths[0]), alpha0.clone()))
        return real(graph, log_probs, scale, lengths, return_forward=return_forward, alpha0=alpha0)

    monkeypatch.setattr(stream_mod, "viterbi_decode", recording)
    before = real.launches
    state = _stream(ts, pcms[2])
    ts.finish_stream(state)
    assert real.launches == before
    assert len(calls) == len(state.bps) + (state.frames_consumed // ts._chunk_in - len(state.bps))
    assert all(shape[:2] == (1, 7) for shape, _, _ in calls)
    assert [n for _, n, _ in calls[:-1]] == [7] * (len(calls) - 1) and 0 < calls[-1][1] <= 7
    assert torch.equal(calls[0][2][0], ts.device_graph.init_weight)
    assert not torch.equal(calls[1][2], calls[0][2])  # the alpha moved on


def test_time_stages_are_recorded_when_asked(trained, monkeypatch):
    """A chunk step is its five stage methods, each once a chunk, so a
    caller times a stage by wrapping its method."""
    model_dir, dirs, pcms = trained
    ts = Nnet3StreamTranscriber(model_dir, dirs[LangSuffix.GRAMMAR], device="cpu")
    calls = {}

    def counted(name):
        real = getattr(ts, name)

        def wrapper(*args):
            calls[name] = calls.get(name, 0) + 1
            return real(*args)

        monkeypatch.setattr(ts, name, wrapper)

    stages = ("_upload", "_fold_ivector", "_acoustic", "_decode_chunk", "_download")
    for name in stages:
        counted(name)
    state = _stream(ts, pcms[2])
    assert ts.finish_stream(state) == [SPOKEN[2]]
    assert calls == {name: len(state.bps) for name in stages}


def test_scan_chunk_decoder_equals_dense(trained, tmp_path, monkeypatch):
    """On a graph past the replicated body's reach (the trained graph padded
    with unreachable states to 29,100 states) every chunk is still one
    ``viterbi_decode`` call, whose alpha and backpointers on the trained
    graph's states equal the unpadded stream's, and the stream transcribes
    the same."""
    from rhasspy_speech_torch.testing.decode_graphs import padded_graph_dir

    model_dir, dirs, pcms = trained
    graph_dir = dirs[LangSuffix.GRAMMAR]
    small = Nnet3StreamTranscriber(model_dir, graph_dir, device="cpu")
    big = Nnet3StreamTranscriber(model_dir, padded_graph_dir(graph_dir, tmp_path / "g", 29100),
                                 device="cpu")
    S = small.device_graph.num_states
    assert big.device_graph.num_states == 29100
    calls = []
    real = stream_mod.viterbi_decode

    def counted(*args, **kwargs):
        calls.append(args[0].num_states)
        return real(*args, **kwargs)

    monkeypatch.setattr(stream_mod, "viterbi_decode", counted)
    want, got = _stream(small, pcms[1]), _stream(big, pcms[1])
    assert calls.count(29100) == len(got.bps) == len(want.bps) == calls.count(S)
    assert torch.equal(got.alpha[:S], want.alpha)
    assert (got.alpha[S:] >= 1e30).all()
    assert all(np.array_equal(a[:, :S], b) for a, b in zip(got.bps, want.bps))
    assert big.finish_stream(got) == small.finish_stream(want) == [SPOKEN[1]]


def test_package_surface_and_aliases():
    assert rhasspy_speech_torch.KaldiNnet3StreamTranscriber is Nnet3StreamTranscriber
    assert rhasspy_speech_torch.pipeline.KaldiNnet3StreamTranscriber is Nnet3StreamTranscriber
    for method in ("start_stream", "process_chunk", "finish_nbest", "finish_stream",
                   "finish_stream_rescore", "async_transcribe", "async_transcribe_rescore",
                   "transcribe_pcm"):
        assert callable(getattr(Nnet3StreamTranscriber, method))
    assert stream_mod.CHUNK_OUT_FRAMES == 7
