"""The port's lattices against the JAX package's ``ops/lattice.py``.

``forward_backward`` (tropical) takes only mins and adds in the JAX
module's order, so alpha and beta must be EQUAL, folded graphs and
unfolded alike. ``forward_backward_log`` sums exponentials with a
scatter-add whose order differs from XLA's: held to rtol 1e-5 / atol 1e-5
(f32 sums of a few terms). The copied ``Lattice``, ``build_lattice`` and
``arc_posteriors`` must give what the originals give on the same inputs
(the cases of tests/test_lattice.py).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from rhasspy_speech_tpu.ops import decoder as jd
from rhasspy_speech_tpu.ops import lattice as jl

import torch

from rhasspy_speech_torch.ops import decoder as td
from rhasspy_speech_torch.ops import lattice as tl

from test_decoder import _hubby_graph, _make_src_pdf_graph, _random_graph

LOG_RTOL, LOG_ATOL = 1e-5, 1e-5

GRAPHS = {
    "src_pdf": lambda rng: _make_src_pdf_graph(rng, num_states=15, extra_arcs=40),
    "hubby": lambda rng: _hubby_graph(rng, num_states=24),
    "unfolded": lambda rng: _random_graph(rng),
}


def _setup(name="unfolded", seed=61, B=2, T=10):
    """tests/test_lattice.py's inputs (its graph is the "unfolded" one)."""
    rng = np.random.RandomState(seed)
    g = GRAPHS[name](rng)
    lp = np.log(rng.dirichlet(np.ones(g.num_pdfs), size=(B, T))).astype(np.float32)
    return g, lp


def _both(fn_j, fn_t, g, lp, scale=1.0):
    ref = [np.asarray(x) for x in fn_j(jd.make_decode_graph(g), jnp.asarray(lp), scale)]
    got = [x.numpy() for x in fn_t(td.DecodeGraph.from_dense(g, "cpu"), torch.as_tensor(lp), scale)]
    return ref, got


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("scale", [1.0, 0.3])
def test_forward_backward_bit_exact(name, scale):
    g, lp = _setup(name, B=3, T=9)
    assert td.DecodeGraph.from_dense(g, "cpu").folded == (name != "unfolded")
    (ra, rb), (ga, gb) = _both(jl.forward_backward, tl.forward_backward, g, lp, scale)
    assert ga.shape == (10, 3, g.num_states) and ga.dtype == np.float32
    np.testing.assert_array_equal(ga, ra)
    np.testing.assert_array_equal(gb, rb)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_forward_backward_log_close(name):
    g, lp = _setup(name, seed=63, B=2, T=6)
    (ra, rb), (ga, gb) = _both(jl.forward_backward_log, tl.forward_backward_log, g, lp)
    # unreachable states sit at exactly 1e30 in both
    np.testing.assert_array_equal(ga >= 1e30, ra >= 1e30)
    np.testing.assert_allclose(ga, ra, rtol=LOG_RTOL, atol=LOG_ATOL)
    np.testing.assert_allclose(gb, rb, rtol=LOG_RTOL, atol=LOG_ATOL)


def _lattice_fields(lat):
    return (lat.num_nodes, lat.starts, lat.finals, lat.arcs, lat.best_cost,
            lat.node_frame_state)


@pytest.mark.parametrize("beam", [0.01, 8.0, 30.0])
def test_copied_lattice_equals_original(beam):
    """build_lattice, shortest_path_words, nbest and to_fst of the copies
    equal the originals', on the port's forward-backward output."""
    g, lp = _setup(seed=62, B=2, T=8)
    _, (ga, gb) = _both(jl.forward_backward, tl.forward_backward, g, lp)
    for b in range(2):
        want = jl.build_lattice(g, ga, gb, lp, b, lattice_beam=beam)
        got = tl.build_lattice(g, ga, gb, lp, b, lattice_beam=beam)
        assert _lattice_fields(got) == _lattice_fields(want)
        assert got.shortest_path_words(g) == want.shortest_path_words(g)
        for dedup in (True, False):
            assert got.nbest(g, 3, dedup=dedup) == want.nbest(g, 3, dedup=dedup)
        fst_w, fst_g = want.to_fst(g), got.to_fst(g)
        assert (fst_g.arcs, fst_g.finals, fst_g.start) == (fst_w.arcs, fst_w.finals, fst_w.start)


def test_lattice_best_path_matches_viterbi():
    g, lp = _setup()
    tg = td.DecodeGraph.from_dense(g, "cpu")
    alphas, betas = (x.numpy() for x in tl.forward_backward(tg, torch.as_tensor(lp)))
    plain = [x.numpy() for x in td.viterbi_decode(tg, torch.as_tensor(lp))]
    for b in range(lp.shape[0]):
        lat = tl.build_lattice(g, alphas, betas, lp, b, lattice_beam=8.0)
        want = td.trace_to_words(g, *plain, b)
        words, cost = lat.shortest_path_words(g)
        assert words == want[0], b
        np.testing.assert_allclose(cost, want[1], rtol=1e-4)


def test_copied_arc_posteriors_equal_original():
    g, lp = _setup(seed=64, B=2, T=8)
    _, (la, lb) = _both(jl.forward_backward_log, tl.forward_backward_log, g, lp)
    for b in range(2):
        got = tl.arc_posteriors(g, la, lb, lp, b)
        np.testing.assert_array_equal(got, jl.arc_posteriors(g, la, lb, lp, b))
        np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=1e-3)


def test_phone_fst_equals_original():
    """to_phone_fst (the rescore chain's front half) on a graph that
    carries phone metadata."""
    g, lp = _setup(seed=65, B=1, T=8)
    rng = np.random.RandomState(0)
    g.arc_phone = rng.randint(0, 4, g.num_arcs).astype(np.int32)
    g.arc_tcost = rng.rand(g.num_arcs).astype(np.float32)
    g.arc_self = (g.arc_src == g.arc_dst).astype(np.int8)
    assert g.has_phone_info
    _, (ga, gb) = _both(jl.forward_backward, tl.forward_backward, g, lp)
    want = jl.build_lattice(g, ga, gb, lp, 0).to_phone_fst(g)
    got = tl.build_lattice(g, ga, gb, lp, 0).to_phone_fst(g)
    assert (got.arcs, got.finals, got.start) == (want.arcs, want.finals, want.start)
