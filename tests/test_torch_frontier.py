"""The port's sparse-frontier decoder against the JAX package's: bit-exact.

``frontier_step`` and ``viterbi_topk`` only add, take minima and order
candidates, in the reference's order with the reference's tie-break (the
lowest index among equal costs), so states, alphas and arcs must be EQUAL to
``rhasspy_speech_tpu.ops.frontier`` on seeded inputs: by both dedup
strategies, with and without ``lengths``, with the beam and ``min_active``
cutoff, on folded and unfolded graphs, and with exact cost ties (duplicate
arcs, quantized log-probs). Graphs are tests/test_decoder.py's.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from rhasspy_speech_tpu.ops import frontier as jf

import torch

from rhasspy_speech_torch.ops import decoder as td
from rhasspy_speech_torch.ops import frontier as tf

from test_decoder import _hubby_graph, _make_src_pdf_graph, _random_graph
from test_torch_decoder import _with_duplicate_arcs

GRAPHS = {
    "src_pdf": lambda rng: _make_src_pdf_graph(rng, num_states=23, extra_arcs=70),
    "hubby": lambda rng: _hubby_graph(rng, num_states=40),
    "unfolded": lambda rng: _random_graph(rng, num_states=19, extra_arcs=60),
    "ties": lambda rng: _with_duplicate_arcs(_make_src_pdf_graph(rng, num_states=17)),
    "ties_unfolded": lambda rng: _with_duplicate_arcs(_random_graph(rng, num_states=15)),
}
SCRATCH = {"dense_dedup": 2 << 30, "sort_dedup": 0}


def _case(name, B=5, T=9, seed=0):
    rng = np.random.RandomState(seed + 71)
    g = GRAPHS[name](rng)
    lp = rng.randn(B, T, g.num_pdfs).astype(np.float32)
    if name.startswith("ties"):
        lp = np.round(lp * 2) / 2
        g.arc_weight = (np.round(g.arc_weight * 2) / 2).astype(np.float32)
    lens = rng.randint(0, T + 1, size=B).astype(np.int32)
    lens[0], lens[1] = 0, T
    return g, lp, lens


def _assert_triple_equal(got, want):
    for name, g, w in zip(("states", "alphas", "arcs"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def test_from_dense_equals_jax():
    for name in sorted(GRAPHS):
        g = GRAPHS[name](np.random.RandomState(3))
        t, j = tf.FrontierGraph.from_dense(g, device="cpu"), jf.FrontierGraph.from_dense(g)
        assert t.out_degree == j.out_degree
        np.testing.assert_array_equal(t.arcs_out.numpy(), np.asarray(j.arcs_out))


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("dedup", sorted(SCRATCH))
@pytest.mark.parametrize("masked", [True, False], ids=["lengths", "no_lengths"])
def test_viterbi_topk_bit_exact(name, dedup, masked):
    g, lp, lens = _case(name)
    k = 8  # below the states reachable at once: the top-k cut is exercised
    want = jf.viterbi_topk(
        jf.FrontierGraph.from_dense(g), jnp.asarray(lp), k, 0.8,
        jnp.asarray(lens) if masked else None, scratch_bytes=SCRATCH[dedup])
    got = tf.viterbi_topk(
        tf.FrontierGraph.from_dense(g, device="cpu"), torch.as_tensor(lp), k, 0.8,
        torch.as_tensor(lens) if masked else None, scratch_bytes=SCRATCH[dedup])
    assert got[0].dtype == torch.int32 and got[2].dtype == torch.int32
    _assert_triple_equal(got, want)


@pytest.mark.parametrize("name", ["src_pdf", "unfolded", "ties"])
@pytest.mark.parametrize("dedup", sorted(SCRATCH))
@pytest.mark.parametrize("beam,min_active", [(1.5, 0), (0.5, 3), (float("inf"), 2)])
def test_viterbi_topk_beam_and_min_active_bit_exact(name, dedup, beam, min_active):
    g, lp, lens = _case(name, seed=1)
    kw = dict(scratch_bytes=SCRATCH[dedup], beam=beam, min_active=min_active)
    want = jf.viterbi_topk(jf.FrontierGraph.from_dense(g), jnp.asarray(lp), 10, 1.0,
                           jnp.asarray(lens), **kw)
    got = tf.viterbi_topk_cached(tf.FrontierGraph.from_dense(g, device="cpu"), torch.as_tensor(lp),
                                 10, 1.0, torch.as_tensor(lens), **kw)
    _assert_triple_equal(got, want)
    if np.isfinite(beam):  # the beam did cut something the top-k alone kept
        free = tf.viterbi_topk(tf.FrontierGraph.from_dense(g, device="cpu"), torch.as_tensor(lp),
                               10, 1.0, torch.as_tensor(lens), scratch_bytes=SCRATCH[dedup])
        assert (got[0] == -1).sum() > (free[0] == -1).sum()


@pytest.mark.parametrize("name", ["hubby", "ties_unfolded"])
@pytest.mark.parametrize("dedup", sorted(SCRATCH))
def test_frontier_step_bit_exact(name, dedup):
    """One step from a seeded frontier with empty slots, dead slots and a k
    larger than the states the graph has."""
    g, lp, _ = _case(name, seed=2)
    rng = np.random.RandomState(9)
    B, K, k = lp.shape[0], 6, g.num_states + 5
    states = np.stack([rng.permutation(g.num_states)[:K] for _ in range(B)]).astype(np.int32)
    alpha = (np.round(rng.rand(B, K) * 4) / 4).astype(np.float32)
    states[:, -1] = -1
    alpha[:, 0] = 1e30
    want = jf.frontier_step(jf.FrontierGraph.from_dense(g), jnp.asarray(states), jnp.asarray(alpha),
                            jnp.asarray(-lp[:, 0]), k, SCRATCH[dedup])
    got = tf.frontier_step(tf.FrontierGraph.from_dense(g, device="cpu"),
                           torch.as_tensor(states, dtype=torch.int64), torch.as_tensor(alpha),
                           torch.as_tensor(-lp[:, 0]), k, SCRATCH[dedup])
    _assert_triple_equal(got, want)


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("dedup", sorted(SCRATCH))
def test_exact_regime_equals_dense_decode(name, dedup):
    """K >= S: the frontier's best hypothesis is the dense decoder's, words
    and cost (bit for bit: the additions run in the dense step's order)."""
    g, lp, lens = _case(name, seed=3)
    lens = np.maximum(lens, 1)
    tg = td.DecodeGraph.from_dense(g, "cpu")
    trace, final, cost = (x.numpy() for x in td.viterbi_decode(
        tg, torch.as_tensor(lp), 0.9, torch.as_tensor(lens)))
    fg = tf.FrontierGraph.from_dense(g, device="cpu", base=tg)
    assert fg.base is tg
    tri = [x.numpy() for x in tf.viterbi_topk(
        fg, torch.as_tensor(lp), g.num_states, 0.9, torch.as_tensor(lens),
        scratch_bytes=SCRATCH[dedup])]
    for b in range(lp.shape[0]):
        want = td.trace_to_words(g, trace, final, cost, b)
        got = tf.topk_backtrace(g, *tri, b)
        assert got[0] == want[0]
        if want[0] is not None:
            assert np.float32(got[1]) == np.float32(want[1])
        nbest = tf.topk_backtrace_nbest(g, *tri, b, n=1)
        assert (nbest[0] if nbest else (None, float("inf"))) == got


def test_copied_host_functions_equal_original():
    g, lp, lens = _case("src_pdf", seed=4)
    tri = [np.asarray(x) for x in jf.viterbi_topk(
        jf.FrontierGraph.from_dense(g), jnp.asarray(lp), 6, 1.0, jnp.asarray(lens))]
    for b in range(lp.shape[0]):
        assert tf.topk_backtrace(g, *tri, b) == jf.topk_backtrace(g, *tri, b)
        assert tf.topk_backtrace_nbest(g, *tri, b, n=4) == jf.topk_backtrace_nbest(g, *tri, b, n=4)
        for slot in range(6):
            if tri[0][-1, b, slot] >= 0:
                assert tf._walk_back(g, tri[0], tri[2], b, slot) == jf._walk_back(
                    g, tri[0], tri[2], b, slot)
    assert tf.DEFAULT_DEDUP_SCRATCH_BYTES == jf.DEFAULT_DEDUP_SCRATCH_BYTES
