"""The port's Viterbi twin against the JAX package's decoders: bit-exact.

Decode only takes mins and adds in the reference's order, so alpha,
backpointers, arc traces, final states and costs must be EQUAL to
``ops.decoder.viterbi`` / ``viterbi_decode`` (on the production layout
``make_decode_graph`` picks) and to the real-state prefix of
``viterbi_pallas(interpret=True)``. Graphs are tests/test_decoder.py's.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from rhasspy_speech_tpu.ops import decoder as jd
from rhasspy_speech_tpu.ops.pallas_decoder import PallasDecodeGraph, viterbi_pallas

import torch

from rhasspy_speech_torch.ops import decoder as td
from rhasspy_speech_torch.ops.viterbi_cuda import viterbi_decode as viterbi_decode_wrapper

from test_decoder import _hubby_graph, _make_src_pdf_graph, _random_graph


def _with_duplicate_arcs(g):
    """Every fifth arc appears twice: exact cost ties between arc ids."""
    dup = np.arange(0, g.num_arcs, 5)
    for name in ("arc_src", "arc_dst", "arc_pdf", "arc_weight", "arc_wseq"):
        a = getattr(g, name)
        setattr(g, name, np.concatenate([a, a[dup]]))
    return g


GRAPHS = {
    "src_pdf": lambda rng: _make_src_pdf_graph(rng, num_states=23, extra_arcs=70),
    "hubby": lambda rng: _hubby_graph(rng, num_states=40),
    "unfolded": lambda rng: _random_graph(rng, num_states=19, extra_arcs=60),
    "ties": lambda rng: _with_duplicate_arcs(_make_src_pdf_graph(rng, num_states=17)),
}


def _case(name, B=16, T=9, seed=0):
    rng = np.random.RandomState(seed + 31)
    g = GRAPHS[name](rng)
    lp = rng.randn(B, T, g.num_pdfs).astype(np.float32)
    # ties also between frames' am costs: quantized log-probs
    if name == "ties":
        lp = np.round(lp * 4) / 4
    lens = rng.randint(0, T + 1, size=B).astype(np.int32)
    lens[0], lens[1] = 0, T
    return g, lp, lens


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a).astype(np.int64) if np.asarray(a).dtype == np.uint16
                                  else np.asarray(a), b)


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("masked", [True, False])
def test_viterbi_bit_exact(name, compact, masked):
    g, lp, lens = _case(name)
    jl = jnp.asarray(lens) if masked else None
    tl = torch.as_tensor(lens) if masked else None
    ref_alpha, ref_bps = jd.viterbi(jd.make_decode_graph(g), jnp.asarray(lp), 0.7, jl, compact_bp=compact)
    alpha, bps = td.viterbi(td.DecodeGraph.from_dense(g, "cpu"), torch.as_tensor(lp), 0.7, tl, compact_bp=compact)
    assert bps.dtype == (torch.uint16 if compact else torch.int32)
    np.testing.assert_array_equal(alpha.numpy(), np.asarray(ref_alpha))
    _eq(np.asarray(ref_bps), bps.to(torch.int64).numpy())


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_viterbi_decode_bit_exact(name):
    g, lp, lens = _case(name, seed=1)
    ref = jd.viterbi_decode(jd.make_decode_graph(g), jnp.asarray(lp), 0.9, jnp.asarray(lens))
    tg = td.DecodeGraph.from_dense(g, "cpu")
    got = td.viterbi_decode(tg, torch.as_tensor(lp), 0.9, torch.as_tensor(lens))
    for r, o in zip(ref, got):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    # the kernel wrapper runs the twin for CPU tensors, launching nothing
    before = viterbi_decode_wrapper.launches
    via = viterbi_decode_wrapper(tg, torch.as_tensor(lp), 0.9, torch.as_tensor(lens))
    assert viterbi_decode_wrapper.launches == before
    for a, b in zip(via, got):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    # host word assembly: the copies equal the originals
    arrs = [o.numpy() for o in got]
    assert td.traces_to_words_batch(g, *arrs) == jd.traces_to_words_batch(g, *arrs)
    for b in range(lp.shape[0]):
        assert td.trace_to_words(g, *arrs, b) == jd.trace_to_words(g, *arrs, b)


@pytest.mark.parametrize("name", ["src_pdf", "hubby", "ties"])
@pytest.mark.parametrize("compact", [True, False])
def test_viterbi_matches_pallas_interpret_prefix(name, compact):
    g, lp, lens = _case(name, seed=2)
    alpha_p, bps_p = viterbi_pallas(
        PallasDecodeGraph.from_dense(g, width=2), jnp.asarray(lp), 0.7,
        lengths=jnp.asarray(lens), compact_bp=compact, interpret=True,
    )
    alpha, bps = td.viterbi(td.DecodeGraph.from_dense(g, "cpu"), torch.as_tensor(lp), 0.7,
                            torch.as_tensor(lens), compact_bp=compact)
    S = g.num_states
    np.testing.assert_array_equal(alpha.numpy(), np.asarray(alpha_p)[:, :S])
    _eq(np.asarray(bps_p)[:, :, :S], bps.to(torch.int64).numpy())


def test_copied_helpers_equal_original():
    rng = np.random.RandomState(5)
    for g in (_make_src_pdf_graph(rng), _random_graph(rng), _hubby_graph(rng)):
        a, b = td._state_pdf(g), jd._state_pdf(g)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert (td.STAY, td._COMPACT_BP_MAX_ARC) == (jd.STAY, jd._COMPACT_BP_MAX_ARC)


def test_csr_lists_in_arcs_in_ascending_id():
    g = _hubby_graph(np.random.RandomState(6))
    dg = td.DecodeGraph.from_dense(g, "cpu")
    ptr, arcs = dg.in_ptr.numpy(), dg.in_arc.numpy()
    for s in range(g.num_states):
        mine = arcs[ptr[s]:ptr[s + 1]]
        np.testing.assert_array_equal(mine, np.where(g.arc_dst == s)[0])
        np.testing.assert_array_equal(dg.in_src.numpy()[ptr[s]:ptr[s + 1]], g.arc_src[mine])
