"""The generated deployment-size grammar (``testing/big_grammar.py``) and the
big-graph decoders on it.

The grammar comes from a seed and trains, against a model directory whose
phone table spells words by their letters, to more than 7,000 states with no
file from outside the repository. On that graph, at a narrow model width and
on the CPU: the checkpointed route returns the dense route's transcripts and
costs, the frontier with every state kept (one utterance a call) returns the
dense k-best's top hypothesis, and on seeded log-probs the checkpointed
decode and the frontier (K = S, both dedup strategies) equal the dense
decode bit for bit.
"""

import numpy as np
import pytest
import torch

from rhasspy_speech_torch import Nnet3WavTranscriber
from rhasspy_speech_torch.ops import decoder as td
from rhasspy_speech_torch.ops import frontier as tf
from rhasspy_speech_torch.testing import big_grammar as bg

SIZES = dict(areas=120, devices=80, scenes=60)
NUM_PDFS = 256


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("big_grammar")
    model_dir = bg.write_big_grammar_model_dir(
        root / "model", num_pdfs=NUM_PDFS, hidden_dim=16, num_tdnnf_layers=1, ivector_dim=4,
        ubm_gauss=4)
    graph_dir = bg.train_big_grammar(root / "train", model_dir, seed=0, **SIZES)
    rng = np.random.RandomState(1)
    pcms = [(1000.0 * rng.randn(n)).astype(np.float32) for n in (36000, 30000)]
    return model_dir, graph_dir, pcms


def test_grammar_is_seeded_and_self_contained():
    a, b = bg.big_grammar_intents(3, **SIZES), bg.big_grammar_intents(3, **SIZES)
    assert a == b != bg.big_grammar_intents(4, **SIZES)
    assert [len(a["lists"][k]["values"]) for k in ("area", "device", "scene")] == [120, 80, 60]
    lexicon = bg.spelled_lexicon(bg.big_grammar_intents(0, areas=4, devices=3, scenes=2))
    assert {"turn", "percent", "twenty", "degrees"} <= set(lexicon)
    assert lexicon["turn"] == "/t u r n/"
    assert all(set(p.strip("/").split()) <= set(bg.LETTERS) for p in lexicon.values())


def test_trains_to_more_than_7000_states(trained):
    model_dir, graph_dir, _ = trained
    t = Nnet3WavTranscriber(model_dir, graph_dir, device="cpu")
    g = t.artifacts.graph
    assert g.num_states > 7000 and g.num_arcs > 2 * g.num_states
    assert g.num_pdfs == 2 * len(bg.PHONES) and int(g.arc_pdf.max()) < NUM_PDFS
    assert t._graph_out_degree() >= 20  # the slot lists fan out
    # a monophone chain model: a state's self-loop and forward arcs read
    # different pdfs, so the decoders take their per-arc (unfolded) form
    assert not t.device_graph.folded
    words = {w for w, _ in t.artifacts.words if w.isalpha()}
    assert len(words) > 200


def test_checkpointed_and_frontier_routes_equal_dense(trained):
    model_dir, graph_dir, pcms = trained
    dense = Nnet3WavTranscriber(model_dir, graph_dir, device="cpu")
    S, A = dense.artifacts.graph.num_states, dense.artifacts.graph.num_arcs
    want = dense._decode_batch(pcms, 1)
    frames = dense._acoustic_batch(pcms)[0].shape[1]
    assert dense.last_decode_plan[0] == "dense" and all(want)
    ckpt = Nnet3WavTranscriber(model_dir, graph_dir, device="cpu",
                               decode_memory_budget=frames * S * 2 - 1)
    assert ckpt._decode_batch(pcms, 1) == want
    assert ckpt.last_decode_plan == ("checkpointed", 1)
    assert ckpt.transcribe_pcm_batch(pcms) == dense.transcribe_pcm_batch(pcms)
    k = 3  # three dense k-best streams of backpointers buy the frontier K = S states
    front = Nnet3WavTranscriber(
        model_dir, graph_dir, device="cpu", max_active=10**6, beam=float("inf"),
        decode_memory_budget=frames * S * k * 4 + A * k * 4 - 1)
    got = front._decode_batch(pcms[:1], k)[0]
    assert front.last_decode_plan == ("frontier", S)
    assert got[0] == dense._decode_batch(pcms[:1], k)[0][0]


def test_decoders_bit_equal_on_seeded_log_probs(trained):
    model_dir, graph_dir, _ = trained
    t = Nnet3WavTranscriber(model_dir, graph_dir, device="cpu")
    g, dg = t.artifacts.graph, t.device_graph
    rng = np.random.RandomState(2)
    lp = torch.as_tensor(rng.randn(2, 40, NUM_PDFS).astype(np.float32))
    lens = torch.as_tensor([40, 33], dtype=torch.int32)
    dense = [x.numpy() for x in td.viterbi_decode(dg, lp, 1.0, lens)]
    for a, b in zip(td.viterbi_decode_checkpointed(dg, lp, 1.0, segment=16, lengths=lens), dense):
        np.testing.assert_array_equal(a, b)
    fg = tf.FrontierGraph.from_dense(g, "cpu", base=dg)
    for scratch in (2 << 30, 0):
        tri = [x.numpy() for x in tf.viterbi_topk(fg, lp[:1], g.num_states, 1.0, lens[:1],
                                                  scratch_bytes=scratch)]
        words, cost = tf.topk_backtrace(g, *tri, 0)
        want_words, want_cost = td.trace_to_words(g, *dense, 0)
        assert words == want_words and np.float32(cost) == np.float32(want_cost)
