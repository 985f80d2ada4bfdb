"""The port's k-best decoder against the JAX package's: bit for bit.

``kbest_step``, ``viterbi_kbest`` and ``viterbi_kbest_decode`` take only
mins, adds and integer mins in the JAX module's order, so alpha,
backpointers, arc traces, seed states and seed costs must be EQUAL. The
top-k ties at 1e30 (every dead state ties) must come out in XLA's order,
lowest flat index first. Graphs are tests/test_decoder.py's; the copied
host helpers ``kbest_traces_to_nbest`` and ``backtrace_nbest`` must give
what the originals give.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from rhasspy_speech_tpu.graph.dense import NEG_INF_F32, DenseGraph
from rhasspy_speech_tpu.ops import decoder as jd

import torch

from rhasspy_speech_torch.ops import decoder as td

from test_decoder import _hubby_graph, _make_src_pdf_graph, _random_graph
from test_torch_decoder import _with_duplicate_arcs

GRAPHS = {
    "src_pdf": lambda rng: _make_src_pdf_graph(rng, num_states=15, extra_arcs=40),
    "hubby": lambda rng: _hubby_graph(rng, num_states=24),
    "unfolded": lambda rng: _random_graph(rng, num_states=12, extra_arcs=30),
    "ties": lambda rng: _with_duplicate_arcs(_make_src_pdf_graph(rng, num_states=13)),
}


def _case(name, B=5, T=8, seed=0):
    rng = np.random.RandomState(seed + 71)
    g = GRAPHS[name](rng)
    lp = rng.randn(B, T, g.num_pdfs).astype(np.float32)
    if name == "ties":
        lp = np.round(lp * 4) / 4
    lens = rng.randint(0, T + 1, size=B).astype(np.int32)
    lens[0], lens[1] = 0, T
    return g, lp, lens


def two_path_graph():
    """tests/test_decoder.py's two-word graph: 'a' cheap, 'b' dear."""
    return DenseGraph(
        num_states=2,
        arc_src=np.array([0, 0], dtype=np.int32),
        arc_dst=np.array([1, 1], dtype=np.int32),
        arc_pdf=np.array([0, 1], dtype=np.int32),
        arc_wseq=np.array([1, 2], dtype=np.int32),
        arc_weight=np.array([0.0, 1.0], dtype=np.float32),
        final_weight=np.array([NEG_INF_F32, 0.0], dtype=np.float32),
        final_wseq=np.zeros(2, dtype=np.int32),
        init_weight=np.array([0.0, NEG_INF_F32], dtype=np.float32),
        init_wseq=np.zeros(2, dtype=np.int32),
        word_seqs=[(), (101,), (102,)],
        num_pdfs=2,
    )


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("k", [2, 4])
def test_viterbi_kbest_bit_exact(name, masked, k):
    g, lp, lens = _case(name)
    jl = jnp.asarray(lens) if masked else None
    tl = torch.as_tensor(lens) if masked else None
    tg = td.DecodeGraph.from_dense(g, "cpu")
    assert tg.folded == (name != "unfolded")
    ref_alpha, ref_bps = jd.viterbi_kbest(jd.make_decode_graph(g), jnp.asarray(lp), k, 0.8, jl)
    alpha, bps = td.viterbi_kbest(tg, torch.as_tensor(lp), k, 0.8, tl)
    assert bps.dtype == torch.int32 and alpha.shape == (lp.shape[0], g.num_states, k)
    np.testing.assert_array_equal(alpha.numpy(), np.asarray(ref_alpha))
    np.testing.assert_array_equal(bps.numpy(), np.asarray(ref_bps))

    ref = jd.viterbi_kbest_decode(jd.make_decode_graph(g), jnp.asarray(lp), k, 0.8, jl)
    got = td.viterbi_kbest_decode(tg, torch.as_tensor(lp), k, 0.8, tl)
    for what, r, o in zip(("arc_traces", "seed_states", "seed_costs"), ref, got):
        assert o.dtype == {"seed_costs": torch.float32}.get(what, torch.int32), what
        np.testing.assert_array_equal(o.numpy(), np.asarray(r), err_msg=what)


def test_kbest_rank0_equals_1best():
    """tests/test_decoder.py's case: rank 0 of the k-best equals the
    1-best, bit for bit in the port."""
    g, lp, _ = _case("unfolded", B=2, T=10, seed=2)
    tg = td.DecodeGraph.from_dense(g, "cpu")
    alpha1, _ = td.viterbi(tg, torch.as_tensor(lp))
    alphak, bpk = td.viterbi_kbest(tg, torch.as_tensor(lp), 4)
    np.testing.assert_array_equal(alphak[:, :, 0].numpy(), alpha1.numpy())
    trace, fstate, cost = (x.numpy() for x in td.viterbi_decode(tg, torch.as_tensor(lp)))
    for b in range(2):
        best1 = td.trace_to_words(g, trace, fstate, cost, b)
        nbest = td.backtrace_nbest(g, alphak.numpy(), bpk.numpy(), b, n=4)
        assert nbest[0][0] == best1[0] and nbest[0][1] == best1[1]
        costs = [c for _, c in nbest]
        assert costs == sorted(costs)


def test_kbest_two_path_graph():
    g = two_path_graph()
    lp = np.log(np.array([[[0.5, 0.5]]], dtype=np.float32))
    got = td.viterbi_kbest_decode(td.DecodeGraph.from_dense(g, "cpu"), torch.as_tensor(lp), 3)
    ref = jd.viterbi_kbest_decode(jd.DeviceGraph.from_dense(g), jnp.asarray(lp), 3)
    for r, o in zip(ref, got):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    nbest = td.kbest_traces_to_nbest(g, *(x.numpy() for x in got), 0, n=3)
    assert [w for w, _ in nbest] == [[101], [102]]
    assert abs(nbest[1][1] - nbest[0][1] - 1.0) < 1e-5


def _reference_case():
    """tests/test_decoder.py's device-vs-host backtrace case."""
    rng = np.random.RandomState(23)
    g = _random_graph(rng)
    lp = np.log(rng.dirichlet(np.ones(g.num_pdfs), size=(2, 12))).astype(np.float32)
    return g, lp, None


@pytest.mark.parametrize("name", ["reference", "src_pdf", "unfolded", "ties"])
def test_copied_nbest_helpers_equal_original(name):
    """Both copies equal the JAX module's originals. The device backtrace
    dedups within the global top k, the host one over every (state, rank),
    so the device list is a prefix of the host list (all of it on the
    reference case)."""
    g, lp, _ = _reference_case() if name == "reference" else _case(name, B=3, T=12, seed=23)
    K = 4
    tg = td.DecodeGraph.from_dense(g, "cpu")
    alphak, bpk = (x.numpy() for x in td.viterbi_kbest(tg, torch.as_tensor(lp), K))
    traces, seeds, costs = (
        x.numpy() for x in td.viterbi_kbest_decode(tg, torch.as_tensor(lp), K)
    )
    for b in range(lp.shape[0]):
        host = td.backtrace_nbest(g, alphak, bpk, b, n=K)
        assert host == jd.backtrace_nbest(g, alphak, bpk, b, n=K)
        for dedup in (True, False):
            dev = td.kbest_traces_to_nbest(g, traces, seeds, costs, b, n=K, dedup=dedup)
            assert dev == jd.kbest_traces_to_nbest(g, traces, seeds, costs, b, n=K, dedup=dedup)
        dev = td.kbest_traces_to_nbest(g, traces, seeds, costs, b, n=K)
        assert dev == host[: len(dev)], b
        if name == "reference":
            assert dev == host


def test_dead_states_tie_in_xla_order():
    """A chain of 8 states, every state final at cost 0, one frame: two
    (state, rank) totals are live and the other 30 tie at exactly 1e30, so
    the seeds past the live ones are the lowest tied flat indices, as
    XLA's top_k orders them."""
    S = 8
    src = np.concatenate([np.arange(S), np.arange(S - 1)]).astype(np.int32)
    dst = np.concatenate([np.arange(S), np.arange(1, S)]).astype(np.int32)
    A = src.size
    init = np.full(S, NEG_INF_F32, np.float32)
    init[0] = 0.0
    g = DenseGraph(
        num_states=S, arc_src=src, arc_dst=dst, arc_pdf=(src % 3).astype(np.int32),
        arc_wseq=np.zeros(A, np.int32), arc_weight=np.linspace(0, 1, A).astype(np.float32),
        final_weight=np.zeros(S, np.float32), final_wseq=np.zeros(S, np.int32),
        init_weight=init, init_wseq=np.zeros(S, np.int32), word_seqs=[()], num_pdfs=3,
    )
    lp = np.log(np.full((2, 1, 3), 1 / 3, np.float32))
    ref = jd.viterbi_kbest_decode(jd.DeviceGraph.from_dense(g), jnp.asarray(lp), 4)
    got = td.viterbi_kbest_decode(td.DecodeGraph.from_dense(g, "cpu"), torch.as_tensor(lp), 4)
    assert (np.asarray(ref[2])[:, 2:] == NEG_INF_F32).all()  # ties at 1e30
    for r, o in zip(ref, got):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
