"""The port's transcriber against the JAX package's, end to end.

A synthetic profile with an i-vector extractor (``build_synthetic_profile
(..., with_ivector=True)``) is trained once; the JAX transcriber and the
port's transcriber (``device="cpu"``, so the plain twins run) must give
equal transcripts, equal arc traces and the spoken sentence. Log-probs
are held within rtol 1e-4 / atol 1e-3 (f32 matmuls summed in another
order); the traces are equal because the decode is exact and the tiny
log-prob differences never flip a path on these inputs. Costs that sum
those log-probs over an utterance are held to atol 1e-2, confidences to
atol 1e-3.

Beside the 1-best path: n-best with the fuzzy tail, lattices, compact
lattices, confidence and silence weighting.
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

COST_ATOL = 1e-2
CONF_ATOL = 1e-3

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
    """bf16 answers now (tests/test_torch_bf16.py holds it to the JAX
    package's bounds): it transcribes as f32 does, and a dtype that is
    neither raises; the decoders for graphs too big for dense backpointers
    answer too (the routing tests below) and no error names their item any
    more."""
    model_dir, graph_dir, pcms = trained
    t16 = Nnet3WavTranscriber(model_dir, graph_dir, device="cpu", compute_dtype="bfloat16")
    t32 = Nnet3WavTranscriber(model_dir, graph_dir, device="cpu")
    assert t16.transcribe_pcm_batch(pcms[:1]) == t32.transcribe_pcm_batch(pcms[:1])
    with pytest.raises(ValueError, match="compute_dtype"):
        Nnet3WavTranscriber(model_dir, graph_dir, device="cpu", compute_dtype="float16")
    # a budget that leaves the frontier a state or two a frame: a beam too
    # narrow to reach a final state, in both packages alike
    tiny = Nnet3WavTranscriber(model_dir, graph_dir, device="cpu", decode_memory_budget=1024)
    jtiny = JaxTranscriber(model_dir, graph_dir, decode_memory_budget=1024)
    assert tiny.transcribe_pcm_batch(pcms[:1]) == jtiny.transcribe_pcm_batch(pcms[:1])
    assert tiny.last_decode_plan[0] == "frontier"
    assert tiny.transcribe_pcm_batch(pcms[:1], nbest=3) == jtiny.transcribe_pcm_batch(
        pcms[:1], nbest=3)


def _plans(tt, jt, batch, frames, k):
    from rhasspy_speech_tpu.pipeline.transcribe import select_decoder as jax_select

    g = jt.artifacts.graph
    want = jax_select(g.num_states, batch, frames, k, jt.max_active, jt.decode_memory_budget,
                      out_degree=jt._graph_out_degree(), num_arcs=g.num_arcs)
    assert tt._plan(batch, frames, k) == want
    return want


def _long(pcms):
    """The utterances followed by 1.2 s of silence: enough output frames
    (>= 72) for a checkpointed stream to cost less than a dense one."""
    from rhasspy_speech_tpu.testing.synthetic import _silence_wave

    sil = _silence_wave(16000, np.random.RandomState(1))
    sil = np.concatenate([sil, sil])[:19200]
    return [np.concatenate([p, sil]).astype(np.float32) for p in pcms]


def _budget(tt, pcms, mode):
    """A decode budget just under one dense 1-best stream's backpointers
    (-> checkpointed), or under one checkpointed stream's (-> frontier)."""
    g = tt.artifacts.graph
    frames = tt._acoustic_batch(pcms)[0].shape[1]
    if mode == "checkpointed":
        return frames * g.num_states * 2 - 1
    return (-(-frames // 32) + 32) * g.num_states * 4 - 1


@pytest.mark.parametrize("mode", ["checkpointed", "frontier"])
def test_starved_budget_routes_like_jax_1best(trained, mode):
    """A budget below the dense backpointer bytes flips the decoder, to the
    one the JAX transcriber picks (``out_degree`` and all), and the
    transcripts are the JAX transcriber's, also for a mixed-length batch."""
    model_dir, graph_dir, pcms = trained
    pcms = _long(pcms)
    budget = _budget(Nnet3WavTranscriber(model_dir, graph_dir, device="cpu"), pcms, mode)
    jt = JaxTranscriber(model_dir, graph_dir, decode_memory_budget=budget)
    tt = Nnet3WavTranscriber(model_dir, graph_dir, device="cpu", decode_memory_budget=budget)
    assert tt._graph_out_degree() == jt._graph_out_degree() > 1
    for batch in (pcms[:1], pcms):
        got = tt.transcribe_pcm_batch(batch)
        frames = tt._acoustic_batch(batch)[0].shape[1]
        assert _plans(tt, jt, len(batch), frames, 1)[0] == mode
        assert got == jt.transcribe_pcm_batch(batch)
        if mode == "checkpointed" or len(batch) == 1:
            # exact; the frontier's K shrinks with the batch (the budget is
            # shared), and at 3 streams it is a beam that may lose a path
            assert got == [[s] for s in SPOKEN[: len(batch)]]
    assert tt.last_decode_plan[0] == mode


def test_checkpointed_route_equals_dense_traces(trained):
    """Through ``_decode_traces`` the checkpointed route (sub-batches of one
    stream here) returns the dense route's arrays, bit for bit."""
    model_dir, graph_dir, pcms = trained
    pcms = _long(pcms)
    dense = Nnet3WavTranscriber(model_dir, graph_dir, device="cpu")
    ckpt = Nnet3WavTranscriber(model_dir, graph_dir, device="cpu",
                               decode_memory_budget=_budget(dense, pcms, "checkpointed"))
    log_probs, lengths = dense._acoustic_batch(pcms)
    want = dense._decode_traces(log_probs, lengths)
    got = ckpt._decode_traces(log_probs, lengths)
    assert (dense.last_decode_plan[0], ckpt.last_decode_plan) == ("dense", ("checkpointed", 1))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_frontier_route_nbest_equals_jax(trained):
    """n-best over a starved budget goes to the frontier with the K the JAX
    transcriber computes; word lists equal, costs within the utterance
    tolerance, and the top hypothesis is the dense k-best's."""
    model_dir, graph_dir, pcms = trained
    dense = Nnet3WavTranscriber(model_dir, graph_dir, device="cpu")
    g = dense.artifacts.graph
    frames = dense._acoustic_batch(pcms)[0].shape[1]
    budget = frames * g.num_states * 3 * 4 + g.num_arcs * 3 * 4 - 1  # under one dense stream
    jt = JaxTranscriber(model_dir, graph_dir, decode_memory_budget=budget)
    tt = Nnet3WavTranscriber(model_dir, graph_dir, device="cpu", decode_memory_budget=budget)
    want, got = jt._decode_batch(pcms, 3), tt._decode_batch(pcms, 3)
    mode, K = _plans(tt, jt, len(pcms), frames, 3)
    assert mode == "frontier" and tt.last_decode_plan == (mode, K) and K < g.num_states
    assert [[w for w, _ in h] for h in got] == [[w for w, _ in h] for h in want]
    for g_h, w_h in zip(got, want):
        np.testing.assert_allclose([c for _, c in g_h], [c for _, c in w_h], atol=COST_ATOL)
    assert tt.transcribe_pcm_batch(pcms, nbest=3) == jt.transcribe_pcm_batch(pcms, nbest=3)
    # the longest utterance alone: the same budget leaves every state, exact
    i = int(np.argmax([len(p) for p in pcms]))
    one = tt._decode_batch([pcms[i]], 3)[0]
    assert tt.last_decode_plan == ("frontier", g.num_states)
    top_words, top_cost = dense._decode_batch([pcms[i]], 3)[0][0]
    assert one[0][0] == top_words and abs(one[0][1] - top_cost) <= COST_ATOL
    assert tt.transcribe_pcm_batch([pcms[i]], nbest=3)[0][0] == SPOKEN[i]


def test_frontier_route_passes_budget_beam_and_min_active(trained, monkeypatch):
    from rhasspy_speech_torch.pipeline import transcribe as tmod

    model_dir, graph_dir, pcms = trained
    pcms = _long(pcms)
    budget = _budget(Nnet3WavTranscriber(model_dir, graph_dir, device="cpu"), pcms[:1], "frontier")
    tt = Nnet3WavTranscriber(model_dir, graph_dir, device="cpu", decode_memory_budget=budget,
                             beam=17.0, min_active=5)
    seen = {}
    real = tmod.viterbi_topk_cached

    def recording(graph, log_probs, k, **kw):
        seen.update(kw, k=k, graph=graph)
        return real(graph, log_probs, k, **kw)

    monkeypatch.setattr(tmod, "viterbi_topk_cached", recording)
    assert tt.transcribe_pcm_batch(pcms[:1]) == [[SPOKEN[0]]]
    assert (seen["scratch_bytes"], seen["beam"], seen["min_active"]) == (budget, 17.0, 5)
    assert seen["k"] == tt.last_decode_plan[1] and seen["graph"].base is tt.device_graph
    assert seen["graph"] is tt._frontier_graph  # built once, lazily


def test_dense_sub_batching_matches_whole_batch(trained):
    """A budget that keeps the dense mode but forces sub-batches of one
    stream decodes like the whole batch, 1-best and k-best."""
    from rhasspy_speech_torch.pipeline.transcribe import select_decoder

    model_dir, graph_dir, pcms = trained
    whole = Nnet3WavTranscriber(model_dir, graph_dir, device="cpu")
    g = whole.artifacts.graph
    frames = whole._acoustic_batch(pcms)[0].shape[1]
    per_1best = frames * g.num_states * 2
    per_kbest = frames * g.num_states * 2 * 4 + g.num_arcs * 2 * 4
    small = Nnet3WavTranscriber(model_dir, graph_dir, device="cpu", decode_memory_budget=per_1best + 1)
    assert small.transcribe_pcm_batch(pcms) == whole.transcribe_pcm_batch(pcms)
    assert small.last_decode_plan == ("dense", 1)
    small_k = Nnet3WavTranscriber(model_dir, graph_dir, device="cpu", decode_memory_budget=per_kbest + 1)
    assert small_k.transcribe_pcm_batch(pcms, nbest=2) == whole.transcribe_pcm_batch(pcms, nbest=2)
    assert small_k.last_decode_plan == ("dense", 1)
    assert select_decoder(g.num_states, len(pcms), frames, 2, 7000, per_kbest + 1,
                          num_arcs=g.num_arcs) == ("dense", 1)


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
        import rhasspy_speech_torch.examples.windowed_cost
        t = Nnet3WavTranscriber({str(model_dir)!r}, {str(graph_dir)!r}, device="cpu")
        pcm = np.load({str(tmp_path / "pcm.npy")!r})
        out = t.transcribe_pcm_batch([pcm])
        assert t.transcribe_pcm_batch([pcm], nbest=2)[0][0] == out[0][0]
        assert t.confidence_pcm(pcm) > 0.5
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
    for method in ("transcribe", "transcribe_batch", "transcribe_pcm_batch", "async_transcribe",
                   "get_lattice", "get_compact_lattice", "confidence", "confidence_pcm",
                   "transcribe_rescore", "async_transcribe_rescore"):
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


def test_select_decoder_names_the_scan_past_the_kernels_reach():
    """A graph past the replicated body's reach (40,000 states) plans
    "dense" like any other graph, and every answer is the JAX package's;
    the global body's scratch (``kernel_scratch``) counts toward both
    1-best budgets."""
    from rhasspy_speech_tpu.pipeline.transcribe import select_decoder as jax_select
    from rhasspy_speech_torch.pipeline.transcribe import select_decoder

    kw = dict(budget=3 << 30, num_arcs=90000, out_degree=7)
    assert select_decoder(40000, 32, 112, 1, 7000, **kw)[0] == "dense"
    for k in (1, 3):
        assert select_decoder(40000, 32, 112, k, 7000, **kw) == jax_select(
            40000, 32, 112, k, 7000, **kw)
    for budget in (1 << 24, 1 << 20):  # checkpointed, frontier
        small = dict(kw, budget=budget)
        got = select_decoder(40000, 32, 112, 1, 7000, **small)
        assert got == jax_select(40000, 32, 112, 1, 7000, **small) and got[0] != "dense"
    dense_stream, scratch = 112 * 40000 * 4, 8 * 40000
    at = dict(kw, budget=4 * dense_stream)
    assert select_decoder(40000, 32, 112, 1, 7000, **at) == ("dense", 4)
    assert select_decoder(40000, 32, 112, 1, 7000, kernel_scratch=scratch, **at) == ("dense", 3)
    ckpt_stream = (4 + 32) * 40000 * 4
    at = dict(kw, budget=2 * ckpt_stream)
    assert select_decoder(40000, 32, 112, 1, 7000, **at) == ("checkpointed", 2)
    assert select_decoder(40000, 32, 112, 1, 7000, kernel_scratch=scratch, **at) == (
        "checkpointed", 1)
    assert select_decoder(40000, 32, 112, 3, 7000, kernel_scratch=scratch, **kw) == (
        select_decoder(40000, 32, 112, 3, 7000, **kw))


def test_alpha_states_match_alpha_fits():
    from rhasspy_speech_torch.ops.viterbi_cuda import H100_MAX_SMEM, alpha_fits, max_alpha_states

    for smem in (H100_MAX_SMEM, 49152, 1000, 31):
        n = max_alpha_states(smem)
        assert (n == 0 or alpha_fits(n, smem)) and not alpha_fits(n + 1, smem)


def test_scan_mode_decodes_like_dense(trained, tmp_path):
    """A transcriber on a graph past the replicated body's reach (the
    trained graph padded with unreachable states to 29,100 states) plans
    "dense" for the silence first pass and for the decode, names the large
    bodies' library among its kernels, and transcribes like the JAX package
    on the same graph."""
    from rhasspy_speech_torch.ops.viterbi_cuda import H100_MAX_SMEM, alpha_fits
    from rhasspy_speech_torch.testing.decode_graphs import padded_graph_dir

    model_dir, graph_dir, pcms = trained
    big_dir = padded_graph_dir(graph_dir, tmp_path / "padded", 29100)
    t = Nnet3WavTranscriber(model_dir, big_dir, device="cpu", silence_weight=0.5)
    assert t.artifacts.graph.num_states == 29100 and not alpha_fits(29100, H100_MAX_SMEM)
    assert "viterbi_large" in t._kernels() and "viterbi" not in t._kernels()
    seen = []
    real = t._decode_traces
    t._decode_traces = lambda lp, lens, plan=None: seen.append(plan) or real(lp, lens, plan)
    got = t.transcribe_pcm_batch(pcms)
    assert t.last_decode_plan == ("dense", len(pcms))
    assert [p[0] for p in seen] == ["dense", "dense"]  # first pass, then the decode
    jt = JaxTranscriber(model_dir, big_dir, silence_weight=0.5)
    assert got == jt.transcribe_pcm_batch(pcms) == [[s] for s in SPOKEN]


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


def _write_wav(path, pcm):
    import wave

    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(np.clip(pcm, -32768, 32767).astype(np.int16).tobytes())


def test_nbest_equals_jax(trained):
    """k-best word lists and costs, then the fuzzy tail with
    require_fuzzy, as tests/test_pipeline.py drives them."""
    model_dir, graph_dir, pcms = trained
    jt = JaxTranscriber(model_dir, graph_dir)
    tt = Nnet3WavTranscriber(model_dir, graph_dir, device="cpu")
    want = jt._decode_batch(pcms, 5)
    got = tt._decode_batch(pcms, 5)
    assert [[w for w, _ in h] for h in got] == [[w for w, _ in h] for h in want]
    for g_h, w_h in zip(got, want):
        np.testing.assert_allclose([c for _, c in g_h], [c for _, c in w_h], atol=COST_ATOL)
    kw = dict(nbest=3, max_fuzzy_cost=1.5, require_fuzzy=True)
    assert tt.transcribe_pcm_batch(pcms, **kw) == jt.transcribe_pcm_batch(pcms, **kw) == [
        [s] for s in SPOKEN]
    assert tt.transcribe_pcm_batch(pcms, nbest=3) == jt.transcribe_pcm_batch(pcms, nbest=3)


def test_lattice_and_compact_lattice_equal_jax(trained, tmp_path):
    model_dir, graph_dir, pcms = trained
    jt = JaxTranscriber(model_dir, graph_dir)
    tt = Nnet3WavTranscriber(model_dir, graph_dir, device="cpu")
    wav = tmp_path / "lat.wav"
    _write_wav(wav, pcms[0])
    lat, jlat = tt.get_lattice(wav), jt.get_lattice(wav)
    assert lat.num_arcs() > 0
    assert [a[:3] + a[5:] for a in lat.arcs] == [a[:3] + a[5:] for a in jlat.arcs]
    np.testing.assert_allclose([a[4] for a in lat.arcs], [a[4] for a in jlat.arcs], atol=COST_ATOL)
    words, _ = lat.shortest_path_words(tt.artifacts.graph)
    assert " ".join(tt.artifacts.words.find_id(w) for w in words) == SPOKEN[0]

    clat, jclat = tt.get_compact_lattice(wav), jt.get_compact_lattice(wav)
    assert clat.num_arcs() > 0 and clat.start == jclat.start

    def shape(c):
        return [[(w, tids, ns) for w, _g, _a, tids, ns in arcs] for arcs in c.arcs]

    assert shape(clat) == shape(jclat) and clat.finals.keys() == jclat.finals.keys()
    costs = [[g + a for _w, g, a, _t, _n in arcs] for arcs in clat.arcs]
    jcosts = [[g + a for _w, g, a, _t, _n in arcs] for arcs in jclat.arcs]
    for c, jc in zip(costs, jcosts):
        np.testing.assert_allclose(c, jc, atol=COST_ATOL)


def test_confidence_equals_jax(trained, tmp_path):
    """High on clean in-grammar audio; collapses when the acoustic
    evidence is scaled away (tests/test_pipeline.py's case)."""
    model_dir, graph_dir, pcms = trained
    for scale, check in ((1.0, lambda c: c > 0.99), (1e-5, lambda c: 0.0 < c < 0.9)):
        jt = JaxTranscriber(model_dir, graph_dir, acoustic_scale=scale)
        tt = Nnet3WavTranscriber(model_dir, graph_dir, device="cpu", acoustic_scale=scale)
        got, want = tt.confidence_pcm(pcms[0]), jt.confidence_pcm(pcms[0])
        assert check(got), (scale, got)
        assert abs(got - want) <= CONF_ATOL, (scale, got, want)
    wav = tmp_path / "c.wav"
    _write_wav(wav, pcms[0])
    assert abs(tt.confidence(wav) - jt.confidence(wav)) <= CONF_ATOL


def test_silence_weighting_equals_jax(trained, monkeypatch):
    """silence_weight=0.01 on speech padded with silence: the first-pass
    frame weights are equal, the weighted i-vectors and the second pass's
    log-probs agree, the transcripts are the spoken sentence. (The
    synthetic AM reads its i-vector input with zero weights, so the
    i-vectors are compared directly.)"""
    from rhasspy_speech_tpu.ops.ivector import extract_ivectors as jax_extract_ivectors
    from rhasspy_speech_tpu.testing.synthetic import _silence_wave

    from rhasspy_speech_torch.ops.ivector import extract_ivectors

    model_dir, graph_dir, pcms = trained
    sil = _silence_wave(16000, np.random.RandomState(0))[:8000]
    batch = [np.concatenate([sil, pcms[0], sil]), pcms[1]]
    jt = JaxTranscriber(model_dir, graph_dir, silence_weight=0.01)
    tt = Nnet3WavTranscriber(model_dir, graph_dir, device="cpu", silence_weight=0.01)
    assert tt._get_silence_pdfs() == jt._get_silence_pdfs() and tt._get_silence_pdfs()

    pcm, feat_lengths, lengths, n_out = tt._pad_batch(batch)
    feats = tt.am.features(pcm)
    lp1 = tt.am.log_probs(feats, n_out, feat_lengths=feat_lengths)
    w = tt._silence_frame_weights(lp1, lengths, feats.shape[1])
    jw = np.asarray(jt._silence_frame_weights(
        jnp.asarray(lp1.numpy()), jnp.asarray(lengths.numpy()), feats.shape[1]))
    np.testing.assert_array_equal(w.numpy(), jw)
    assert (jw == np.float32(0.01)).any() and (jw == 1.0).any()

    ivec = extract_ivectors(feats, tt.am.ivector_params, feat_lengths, frame_weights=w)
    jivec = np.asarray(jax_extract_ivectors(
        jnp.asarray(feats.numpy()), jt.am.ivector_params, jnp.asarray(feat_lengths.numpy()),
        frame_weights=jnp.asarray(jw)))
    np.testing.assert_allclose(ivec.numpy(), jivec, rtol=1e-4, atol=1e-3)
    plain = extract_ivectors(feats, tt.am.ivector_params, feat_lengths)
    assert not torch.allclose(ivec, plain, rtol=1e-3, atol=1e-2)  # the weights matter

    calls = []
    log_probs = tt.am.log_probs
    monkeypatch.setattr(tt.am, "log_probs", lambda *a, **k: calls.append(k) or log_probs(*a, **k))
    lp2, _ = tt._acoustic_batch(batch)
    assert [c.get("ivector_frame_weights") is not None for c in calls] == [False, True]
    assert torch.equal(calls[1]["ivector_frame_weights"], w)
    jlp2 = np.asarray(jt.am.log_probs(
        jnp.asarray(feats.numpy()), n_out, ivector_frame_weights=jnp.asarray(jw),
        feat_lengths=jnp.asarray(feat_lengths.numpy())))
    np.testing.assert_allclose(lp2.numpy(), jlp2, rtol=1e-4, atol=1e-3)
    want = [[SPOKEN[0]], [SPOKEN[1]]]
    assert tt.transcribe_pcm_batch(batch) == jt.transcribe_pcm_batch(batch) == want
