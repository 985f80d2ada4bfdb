"""The port's example scripts against the JAX package on the CPU: each
script's ``main`` (``--device cpu``) beside the JAX library calls its JAX
counterpart in ``examples/`` makes, on the same seeded profile, PCM and
graph (the port's builders are copies of the JAX package's: the same seed
writes the same files).

- Exact: ``serve_streams``' transcripts (against the JAX ``StreamScheduler``
  fed the JAX script's way, on the i16 and mu-law wires), ``serve_multichip``'s
  sharded transcripts (against the JAX ``ShardedWavTranscriber`` over two
  CPU devices), ``inspect_utterance``'s transcript and n-best word
  sequences, ``rescore_oov``'s recovered transcript, and
  ``frontier_curve``'s graph size, exact costs and per-K frontier costs and
  agreement (a decode takes only mins and adds of the same log-probs).
- Within tolerance: the confidence and the n-best costs (rtol 1e-4 / atol
  1e-3: f32 AM sums in another order); the lattice ark's states and arcs
  equal, its weights within atol 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rhasspy_speech_tpu.graph.dense import NEG_INF_F32 as JAX_NEG_INF
from rhasspy_speech_tpu.io.lattice_io import write_lattice_ark as jax_write_lattice_ark
from rhasspy_speech_tpu.ops.decoder import make_decode_graph, viterbi_decode as jax_viterbi_decode
from rhasspy_speech_tpu.ops.frontier import FrontierGraph as JaxFrontierGraph
from rhasspy_speech_tpu.ops.frontier import viterbi_topk as jax_viterbi_topk
from rhasspy_speech_tpu.parallel import ShardedWavTranscriber as JaxSharded
from rhasspy_speech_tpu.parallel import make_stream_mesh as jax_make_stream_mesh
from rhasspy_speech_tpu.pipeline import Nnet3WavTranscriber as JaxTranscriber
from rhasspy_speech_tpu.pipeline.endpoint import EndpointConfig as JaxEndpointConfig
from rhasspy_speech_tpu.pipeline.scheduler import StreamScheduler as JaxScheduler

from rhasspy_speech_torch.examples import (
    frontier_curve,
    inspect_utterance,
    rescore_oov,
    serve_multichip,
    serve_streams,
)
from rhasspy_speech_torch.examples._common import train_sentences, write_wav
from rhasspy_speech_torch.io.lattice_io import read_lattice_ark
from rhasspy_speech_torch.testing import build_synthetic_profile, synthesize_sentence
from rhasspy_speech_torch.testing.big_grammar import big_grammar_intents

CPU = ["--device", "cpu"]
RTOL, ATOL = 1e-4, 1e-3
STREAMS = 3
FRONTIER = dict(order=3, T=50, B=2, ks=(2, 8, 512), areas=3, devices=2, scenes=2)


@pytest.mark.parametrize("wire", ["i16", "mulaw"])
def test_serve_streams_equals_jax_scheduler(tmp_path, wire):
    profile = build_synthetic_profile(tmp_path / "model", serve_streams.LEXICON)
    (lang,) = train_sentences(profile.model_dir, tmp_path / "train", serve_streams.SENTENCES)
    texts, pcms = serve_streams.utterances(profile, STREAMS)
    sched = JaxScheduler(profile.model_dir, lang, max_streams=STREAMS,
                         endpointing=JaxEndpointConfig(), wire=wire)
    # the JAX script's serving loop
    sids = [sched.open_stream() for _ in range(STREAMS)]
    offsets, finished = [0] * STREAMS, [False] * STREAMS
    chunk = serve_streams.CHUNK
    while any(sched.poll(s) is None for s in sids):
        for i, sid in enumerate(sids):
            if offsets[i] < pcms[i].shape[0]:
                sched.feed(sid, pcms[i][offsets[i] : offsets[i] + chunk])
                offsets[i] += chunk
            elif not finished[i]:
                sched.finish(sid)
                finished[i] = True
        sched.step()
    want = [sched.poll(s) for s in sids]

    got = serve_streams.main([str(STREAMS), "--wire", wire] + CPU)
    assert got["texts"] == texts
    assert got["transcripts"] == want == [[t] for t in texts]


def test_serve_multichip_equals_jax_sharded(tmp_path):
    n = 4
    profile = build_synthetic_profile(tmp_path / "model", serve_multichip.LEXICON)
    (lang,) = train_sentences(profile.model_dir, tmp_path / "train", serve_multichip.SENTENCES)
    texts = [serve_multichip.UTTS[i % len(serve_multichip.UTTS)] for i in range(n)]
    pcms = [synthesize_sentence(profile, t, seed=i) for i, t in enumerate(texts)]
    mesh = jax_make_stream_mesh(devices=jax.devices("cpu")[:2])
    want = JaxSharded(profile.model_dir, lang, mesh=mesh).transcribe_pcm_batch(pcms)

    got = serve_multichip.main([str(n), "--devices", "cpu,cpu"] + CPU)
    assert got["texts"] == texts
    assert got["transcripts"] == want


def test_inspect_utterance_equals_jax(tmp_path):
    profile, lang, pcm = inspect_utterance.build(tmp_path)
    t = JaxTranscriber(profile.model_dir, lang)
    text = t.transcribe_pcm_batch([pcm])[0]
    conf = t.confidence_pcm(pcm)
    wav = write_wav(tmp_path / "utt.wav", pcm)
    words = t.artifacts.words
    rivals = [([words.find_id(w) for w in ids if words.find_id(w) != "<eps>"], float(cost))
              for ids, cost in t.get_lattice(wav).nbest(t.artifacts.graph, 5)]
    jax_ark = tmp_path / "jax.ark"
    jax_write_lattice_ark(jax_ark, [("utt-0", t.get_compact_lattice(wav))])

    port_ark = tmp_path / "port.ark"
    got = inspect_utterance.main(["--ark", str(port_ark)] + CPU)
    assert got["transcript"] == text
    np.testing.assert_allclose(got["confidence"], conf, rtol=RTOL, atol=ATOL)
    assert [w for w, _c in got["nbest"]] == [w for w, _c in rivals]
    np.testing.assert_allclose([c for _w, c in got["nbest"]], [c for _w, c in rivals],
                               rtol=RTOL, atol=ATOL)

    (kp, lp), = list(read_lattice_ark(port_ark))
    (kj, lj), = list(read_lattice_ark(jax_ark))
    assert kp == kj and lp.start == lj.start and lp.num_states == lj.num_states
    for ap, aj in zip(lp.arcs, lj.arcs):
        assert [(w, tids, ns) for w, _g, _a, tids, ns in ap] == [
            (w, tids, ns) for w, _g, _a, tids, ns in aj]
        np.testing.assert_allclose([(g, a) for _w, g, a, _t, _n in ap],
                                   [(g, a) for _w, g, a, _t, _n in aj], atol=ATOL)
    assert sorted(lp.finals) == sorted(lj.finals)
    for s in lp.finals:
        np.testing.assert_allclose(lp.finals[s][:2], lj.finals[s][:2], atol=ATOL)
        assert lp.finals[s][2] == lj.finals[s][2]


def test_rescore_oov_equals_jax(tmp_path):
    profile, old, new, pcm = rescore_oov.build(tmp_path)
    t = JaxTranscriber(profile.model_dir, old)
    first = t.transcribe_pcm_batch([pcm], nbest=5)[0]
    rescored = t.transcribe_rescore(write_wav(tmp_path / "utt.wav", pcm), old_lang_dir=old,
                                    new_lang_dir=new, nbest=5)

    got = rescore_oov.main(CPU)
    assert got["first_pass"] == first
    assert got["rescored"] == rescored and rescored[0] == rescore_oov.RECOVERED


def _jax_frontier_graph(order, intents):
    """The JAX script's graph build (``examples/frontier_curve.py:48-86``)
    over ``intents``."""
    import io
    import re

    from rhasspy_speech_tpu.grammar import Intents, compile_intents
    from rhasspy_speech_tpu.graph.context import make_hclg_from_tree
    from rhasspy_speech_tpu.graph.dense import dense_from_hclg
    from rhasspy_speech_tpu.io.transition_model import KaldiTransitionModel
    from rhasspy_speech_tpu.io.tree import ContextDependencyTree
    from rhasspy_speech_tpu.lang import make_grammar_g, make_lg, prepare_lang
    from rhasspy_speech_tpu.lang.ngram import arpa_to_fst, make_arpa_from_fst
    from rhasspy_speech_tpu.lexicon import LexiconDatabase

    ctx = compile_intents(Intents.from_dict(intents), io.StringIO(), LexiconDatabase(),
                          number_language="en")

    def pron(w):
        return [c for c in re.sub(r"[^a-z0-9]", "", w.lower())] or ["x"]

    lang = prepare_lang([(w, pron(w)) for w in sorted(ctx.vocab)], silence_phones=["SIL", "SPN"])
    ctx.fst_file.seek(0)
    g_grammar = make_grammar_g(ctx.fst_file, lang.words)
    arpa = make_arpa_from_fst(g_grammar, order=order, symbols=lang.words)
    lg = make_lg(lang, arpa_to_fst(arpa, lang.words))
    max_phone = max(pid for (p, pid) in lang.phones if pid != 0 and not p.startswith("#"))
    ktm = KaldiTransitionModel.from_monophone_chain(max_phone)
    tree = ContextDependencyTree.monophone_from_tuples(ktm.tuples, max_phone=max_phone, n=3, p=1)
    hclg, num_pdfs = make_hclg_from_tree(lang, lg, tree, ktm, lang.phones)
    return dense_from_hclg(hclg, num_pdfs)


def test_frontier_curve_equals_jax():
    f = FRONTIER
    intents = big_grammar_intents(0, areas=f["areas"], devices=f["devices"], scenes=f["scenes"])
    graph = _jax_frontier_graph(f["order"], intents)
    lp = jnp.asarray(frontier_curve.log_probs(graph, f["B"], f["T"]))
    exact = np.asarray(jax_viterbi_decode(make_decode_graph(graph), lp)[2])
    fg = JaxFrontierGraph.from_dense(graph)
    want = []
    for k in f["ks"]:
        states_t, alphas_t, _arcs = jax_viterbi_topk(fg, lp, k, beam=frontier_curve.BEAM,
                                                     min_active=frontier_curve.MIN_ACTIVE)
        last, alphas = np.asarray(states_t)[-1], np.asarray(alphas_t)[-1]
        totals = np.where(last >= 0, alphas + graph.final_weight[np.maximum(last, 0)], JAX_NEG_INF)
        cost = totals.min(axis=1)
        want.append((k, cost, float((cost - exact <= frontier_curve.AGREE_TOL).mean())))

    got = frontier_curve.main([str(f["order"]), str(f["T"]), str(f["B"]),
                               "--k", ",".join(map(str, f["ks"])), "--areas", str(f["areas"]),
                               "--devices", str(f["devices"]), "--scenes", str(f["scenes"])] + CPU)
    assert (got["states"], got["arcs"], got["pdfs"]) == (graph.num_states, graph.num_arcs,
                                                        graph.num_pdfs)
    np.testing.assert_array_equal(got["exact_cost"], exact)
    assert [c["k"] for c in got["curve"]] == [k for k, _c, _a in want]
    for c, (_k, cost, agree) in zip(got["curve"], want):
        np.testing.assert_array_equal(c["cost"], cost)
        assert c["agreement"] == agree
    assert any(0.0 < a for _k, _c, a in want), "no K of the curve reaches the exact path"
