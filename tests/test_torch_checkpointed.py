"""The port's memory-bounded decode against the JAX package's and against
the port's dense decode: bit-exact.

``viterbi_decode_checkpointed`` recomputes backpointers segment by segment
from stored boundary alphas; the arithmetic is the dense step's, so the arc
trace, the final state and the cost must be EQUAL to
``rhasspy_speech_tpu.ops.decoder.viterbi_decode_checkpointed`` and to
``viterbi_decode``, at frame counts that are no multiple of the segment and
with masked (``lengths``) streams. Also here: ``viterbi(alpha0=...)`` decoded
chunk by chunk equals the whole decode, and the copied ``backtrace_words``
equals its original.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from rhasspy_speech_tpu.ops import decoder as jd

import torch

from rhasspy_speech_torch.ops import decoder as td

from test_torch_decoder import GRAPHS, _case


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("T,segment", [(9, 4), (70, 32), (8, 8), (5, 32)])
@pytest.mark.parametrize("masked", [True, False], ids=["lengths", "no_lengths"])
def test_checkpointed_bit_exact(name, T, segment, masked):
    g, lp, lens = _case(name, B=4, T=T, seed=3)
    want = jd.viterbi_decode_checkpointed(
        jd.make_decode_graph(g), jnp.asarray(lp), 0.8, segment=segment,
        lengths=jnp.asarray(lens) if masked else None)
    tg = td.DecodeGraph.from_dense(g, "cpu")
    tl = torch.as_tensor(lens) if masked else None
    got = td.viterbi_decode_checkpointed(tg, torch.as_tensor(lp), 0.8, segment=segment, lengths=tl)
    dense = td.viterbi_decode(tg, torch.as_tensor(lp), 0.8, tl)
    for o, w, d in zip(got, want, dense):
        assert isinstance(o, np.ndarray) and o.dtype == d.numpy().dtype
        np.testing.assert_array_equal(o, np.asarray(w))
        np.testing.assert_array_equal(o, d.numpy())


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_relax_costs_equals_viterbi_step_alpha(name):
    g, lp, _ = _case(name, seed=4)
    tg = td.DecodeGraph.from_dense(g, "cpu")
    alpha = tg.init_weight[None, :].expand(lp.shape[0], -1)
    for t in range(3):
        am = torch.as_tensor(-lp[:, t])
        want, _bp = td.viterbi_step(tg, alpha, am)
        assert torch.equal(td.relax_costs(tg, alpha, am), want)
        alpha = want


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("compact", [True, False])
def test_viterbi_alpha0_chunked_equals_whole(name, compact):
    """A stream decoded in chunks of 7 frames with the alpha carried from
    chunk to chunk: the same final alpha and backpointers as one decode,
    masked tails included."""
    g, lp, lens = _case(name, B=4, T=23, seed=5)
    tg = td.DecodeGraph.from_dense(g, "cpu")
    lp_t, lens_t = torch.as_tensor(lp), torch.as_tensor(lens)
    want_alpha, want_bps = td.viterbi(tg, lp_t, 0.7, lens_t, compact_bp=compact)
    alpha, parts = None, []
    for lo in range(0, lp.shape[1], 7):
        chunk = lp_t[:, lo : lo + 7]
        alpha, bps = td.viterbi(tg, chunk, 0.7, (lens_t - lo).clamp(0, chunk.shape[1]),
                                compact_bp=compact, alpha0=alpha)
        parts.append(bps)
    assert torch.equal(alpha, want_alpha)
    assert torch.equal(torch.cat(parts).to(torch.int32), want_bps.to(torch.int32))


def test_copied_backtrace_words_equals_original():
    for name in sorted(GRAPHS):
        g, lp, lens = _case(name, seed=6)
        alpha, bps = td.viterbi(td.DecodeGraph.from_dense(g, "cpu"), torch.as_tensor(lp), 1.0,
                                torch.as_tensor(lens))
        alpha, bps = alpha.numpy(), bps.numpy()
        for b in range(lp.shape[0]):
            assert td.backtrace_words(g, alpha, bps, b) == jd.backtrace_words(g, alpha, bps, b)
            assert td.backtrace_words(g, alpha, bps, b, num_frames=4) == jd.backtrace_words(
                g, alpha, bps, b, num_frames=4)
