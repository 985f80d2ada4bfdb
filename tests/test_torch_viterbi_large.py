"""The decode kernel's large-graph bodies, on the CPU.

``csrc/viterbi_large.cu`` only runs on the card. These tests hold what the
wrapper prepares for it (``ops/viterbi_cuda.py``: ``plan_halo``,
``plan_global``, ``large_smem_layout``, ``choose_body``) to what the kernel
assumes, and hold a NumPy emulation of the halo body's frame -- per-CTA
local buffers over [own slice, halo], the relaxation through the remapped
sources, the owner's plain store and its pushes along the push lists, the
per-CTA and cluster argmin, the backtrace -- bit-equal to the plain twin
(``ops/decoder.py``) at 40,000 states. Keep ``emulate_halo`` in step with
the .cu. Also here: the segmented checkpointed route (one ``viterbi_decode``
a segment, the kernel on a card and the twin here) against the JAX
package's ``viterbi_decode_checkpointed``, and the port's dense decode
against the JAX package's at 40,000 states.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rhasspy_speech_tpu.ops import decoder as jd

from rhasspy_speech_torch.graph.dense import NEG_INF_F32, DenseGraph
from rhasspy_speech_torch.ops.decoder import DecodeGraph, backtrace, viterbi
from rhasspy_speech_torch.ops import decoder as td
from rhasspy_speech_torch.ops.viterbi_cuda import (
    H100_MAX_SMEM,
    LARGE_CLUSTER_SIZES,
    choose_body,
    large_smem_layout,
    max_alpha_states,
    plan_global,
    plan_halo,
    viterbi_decode,
    viterbi_decode_checkpointed,
)
from rhasspy_speech_torch.testing.decode_graphs import random_decode_graph
from rhasspy_speech_torch.testing.flagship import build_flagship_graph

from test_torch_decoder import GRAPHS, _case
from test_torch_kernels import edge_tie_graph
from test_torch_scheduler import COST_ATOL, COST_RTOL

INF = np.float32(NEG_INF_F32)
# a graph past the halo body's reach on an H100: each of 16 slices holds
# more states than two alpha buffers fit
PAST_HALO_STATES = 16 * (max_alpha_states(H100_MAX_SMEM) + 1)


def h100_clusters(plan, resident):
    """One block per SM (1,024 threads), 132 SMs; a cluster of 16 fits a
    GPC of 16 or more SMs, 7 of them at once."""
    return 7 if plan.cluster == 16 else 132 // plan.cluster


def no_16(plan, resident):
    return 0 if plan.cluster == 16 else h100_clusters(plan, resident)


def graph(name):
    if name == "flagship":
        return build_flagship_graph(order=3)[0]
    return random_decode_graph(np.random.RandomState(7), int(name), num_pdfs=3072)


def thinned(dense, keep):
    """``dense`` with only the arcs where ``keep`` (pdfs stay a function of
    the source, so the fold holds)."""
    return DenseGraph(
        num_states=dense.num_states, arc_src=dense.arc_src[keep], arc_dst=dense.arc_dst[keep],
        arc_pdf=dense.arc_pdf[keep], arc_wseq=dense.arc_wseq[keep],
        arc_weight=dense.arc_weight[keep], final_weight=dense.final_weight,
        final_wseq=dense.final_wseq, init_weight=dense.init_weight, init_wseq=dense.init_wseq,
        word_seqs=dense.word_seqs, num_pdfs=dense.num_pdfs,
    )


def compact_40k():
    """40,000 states and <= 65,533 arcs (uint16 backpointers): the chain,
    every other self-loop, 5,000 random arcs and two hubs of 200 in-arcs;
    two final states at the ends of two halves, so the final argmin crosses
    slices."""
    S = 40000
    dense = random_decode_graph(np.random.RandomState(11), S, 5000, 3072, hubs=2)
    keep = np.ones(dense.num_arcs, bool)
    keep[S : 2 * S : 2] = False  # self-loops of the even states
    dense = thinned(dense, keep)
    dense.final_weight[[S // 2 - 1, S - 1]] = 0.0
    assert dense.num_arcs <= td._COMPACT_BP_MAX_ARC
    return dense


def unfolded_40k():
    """40,000 states, arc pdfs drawn per arc (no fold)."""
    dense = random_decode_graph(np.random.RandomState(12), 40000, 9600, 3072)
    dense.arc_pdf = np.random.RandomState(13).randint(3072, size=dense.num_arcs).astype(np.int32)
    return dense


def local_to_global(plan, r, local):
    """CTA r's local indices as global state ids."""
    bounds = plan.slice_state.numpy()
    lo, ns = bounds[r], bounds[r + 1] - bounds[r]
    halo = plan.halo_state.numpy()[plan.halo_ptr[r] : plan.halo_ptr[r + 1]]
    own = local < ns
    out = lo + local
    out[~own] = halo[local[~own] - ns]
    return out


# -- (a) the halo plan's invariants -------------------------------------------


@pytest.mark.parametrize("name", ["flagship", "14200", "40000"])
@pytest.mark.parametrize("cluster", LARGE_CLUSTER_SIZES)
def test_halo_plan_invariants(name, cluster):
    g = DecodeGraph.from_dense(graph(name), "cpu")
    plan = plan_halo(g, cluster)
    bounds = plan.slice_state.numpy()
    in_ptr, in_src, in_arc = g.in_ptr.numpy(), g.in_src.numpy(), g.in_arc.numpy()
    word = plan.in_sw.numpy()[:, 0].view(np.uint32).astype(np.int64)
    np.testing.assert_array_equal(plan.in_sw.numpy()[:, 1].view(np.float32), g.in_weight.numpy())
    if plan.tables.compact:
        np.testing.assert_array_equal(word >> 16, in_arc)
    else:
        assert (word >> 16 == 0).all()
    halo_ptr, halo = plan.halo_ptr.numpy(), plan.halo_state.numpy()
    sent = {}
    for r in range(cluster):
        lo, hi = bounds[r], bounds[r + 1]
        h = halo[halo_ptr[r] : halo_ptr[r + 1]]
        # the halo: exactly the out-of-slice sources of the slice's in-arcs,
        # ascending, and the local space fits uint16
        ext = in_src[in_ptr[lo] : in_ptr[hi]]
        np.testing.assert_array_equal(h, np.unique(ext[(ext < lo) | (ext >= hi)]))
        assert (hi - lo) + h.size <= plan.max_local <= 1 << 16
        # every in-arc's source resolves in its CTA's local space
        local = word[in_ptr[lo] : in_ptr[hi]] & 0xFFFF
        assert local.max(initial=0) < (hi - lo) + h.size
        np.testing.assert_array_equal(local_to_global(plan, r, local), ext)
        for k, s in enumerate(h):
            sent[(int(s), r)] = (hi - lo) + k
    # the push lists are exactly the inverse of the halos, ascending in CTA
    push_ptr, push_ent = plan.push_ptr.numpy(), plan.push_ent.numpy()
    assert push_ptr[0] == 0 and push_ptr[-1] == push_ent.size == halo.size
    got = {}
    for s in range(g.num_states):
        ent = push_ent[push_ptr[s] : push_ptr[s + 1]]
        assert (np.diff(ent >> 16) > 0).all()
        for e in ent:
            got[(s, int(e >> 16))] = int(e & 0xFFFF)
            assert not bounds[e >> 16] <= s < bounds[(e >> 16) + 1]  # never to the owner
    assert got == sent
    # the byte counts add up: each CTA's mbarrier expects 4 x |halo| bytes a
    # frame, exactly the st.async bytes the push lists send it
    received = np.bincount(push_ent >> 16, minlength=cluster) * 4
    np.testing.assert_array_equal(received, 4 * np.diff(halo_ptr))
    assert received.sum() == 4 * push_ent.size
    assert plan.max_push == max(push_ptr[bounds[r + 1]] - push_ptr[bounds[r]] for r in range(cluster))
    # the layout holds the two local buffers and, resident, every table
    off, size = large_smem_layout(plan, g.folded, True)
    assert off["alpha1"] >= 4 * plan.max_local and off["ptr"] >= 8 * plan.max_local
    assert size >= off["pent"] + 4 * plan.max_push
    assert large_smem_layout(plan, g.folded, False)[1] == off["ptr"]
    assert plan is plan_halo(g, cluster)


@pytest.mark.parametrize("name,batch,body,cluster,resident", [
    ("flagship", 32, "replicated", None, True),
    ("14200", 32, "replicated", 4, True),
    ("14200", 1, "replicated", 8, True),
    ("40000", 32, "halo", 8, True),
    ("40000", 1, "halo", 16, True),
    (str(PAST_HALO_STATES), 1, "global", 16, False),
])
def test_body_chosen_by_size(name, batch, body, cluster, resident):
    """At an H100's shared memory the replicated body takes the graphs alpha
    fits, the halo body the next (C = 16 only where the card runs it), the
    global body the rest (plan only: a graph past the halo body's reach)."""
    g = DecodeGraph.from_dense(graph(name), "cpu")
    plan, res = choose_body(g, batch, H100_MAX_SMEM, h100_clusters)
    assert (plan.body, res) == (body, resident)
    if cluster is not None:
        assert plan.cluster == cluster
    if body == "halo":
        assert 2 * 4 * plan.max_local <= H100_MAX_SMEM
        assert large_smem_layout(plan, g.folded, True)[1] <= H100_MAX_SMEM
        fallback, _ = choose_body(g, batch, H100_MAX_SMEM, no_16)
        assert fallback.body == "halo" and fallback.cluster <= 8
    if body == "global":
        assert choose_body(g, batch, H100_MAX_SMEM, no_16)[0].cluster == 8
        assert all(g.num_states > c * max_alpha_states(H100_MAX_SMEM) or
                   plan_halo(g, c).max_local > max_alpha_states(H100_MAX_SMEM)
                   for c in LARGE_CLUSTER_SIZES)
        assert large_smem_layout(plan, g.folded, False)[1] == 0
        bounds = plan.slice_state.numpy()
        assert bounds[0] == 0 and bounds[-1] == g.num_states and (np.diff(bounds) > 0).all()


# -- (b) the halo body's frame in NumPy ------------------------------------------


def segment_first_min(cand, ptr):
    """Per CSR row [ptr[i], ptr[i + 1]): its minimum and the first position
    that reaches it (-1 for an empty row): the ascending strict-< walk, and
    the lexicographic (cost, index) merge of strided lanes."""
    n = ptr.size - 1
    best = np.full(n, INF, np.float32)
    pos = np.full(n, -1, np.int64)
    rows = np.flatnonzero(np.diff(ptr) > 0)
    if rows.size:
        best[rows] = np.minimum.reduceat(cand, ptr[rows])
        row_of = np.repeat(np.arange(n), np.diff(ptr))
        hit = np.where(cand == best[row_of], np.arange(cand.size), np.iinfo(np.int64).max)
        pos[rows] = np.minimum.reduceat(hit, ptr[rows])
    return best, pos


def emulate_halo(graph, plan, lp, scale, lengths, alpha0):
    """csrc/viterbi_large.cu's halo body, one stream at a time: (trace,
    final_state, total_cost, alpha, bps) as the kernel returns them."""
    B, T, _P = lp.shape
    S, C = graph.num_states, plan.cluster
    compact = plan.tables.compact
    neg = np.float32(-scale)
    in_ptr = graph.in_ptr.numpy().astype(np.int64)
    word = plan.in_sw.numpy()[:, 0].view(np.uint32).astype(np.int64)
    w = plan.in_sw.numpy()[:, 1].view(np.float32)
    in_arc, in_pdf = graph.in_arc.numpy(), graph.in_pdf.numpy()
    spdf = plan.tables.src_pdf.numpy().view(np.uint16).astype(np.int64)
    bounds = plan.slice_state.numpy()
    halo_ptr = plan.halo_ptr.numpy()
    push_ptr, push_ent = plan.push_ptr.numpy(), plan.push_ent.numpy()
    asrc = plan.tables.arc_src.numpy()
    final = graph.final_weight.numpy()
    lp = lp.numpy()
    bps = np.zeros((T, B, S), np.int64)
    out_alpha = np.zeros((B, S), np.float32)
    trace = np.zeros((B, T), np.int64)
    fstate, fcost = np.zeros(B, np.int64), np.zeros(B, np.float32)
    stay = 0 if compact else -2

    def fold(v, t, b, states):
        if not graph.folded:
            return v
        return (v + neg * lp[b, t, spdf[states]]).astype(np.float32)

    def push(bufs, r, v):
        """Owner r's values v (its slice, in order) into its own buffer and,
        along the push lists, into every halo that holds them."""
        lo, hi = bounds[r], bounds[r + 1]
        bufs[r][: hi - lo] = v
        ent = push_ent[push_ptr[lo] : push_ptr[hi]]
        i = np.repeat(np.arange(hi - lo), np.diff(push_ptr[lo : hi + 1]))
        for q in np.unique(ent >> 16):
            m = (ent >> 16) == q
            bufs[q][ent[m] & 0xFFFF] = v[i[m]]

    for b in range(B):
        n = min(int(lengths[b]), T)
        start = graph.init_weight.numpy() if alpha0 is None else alpha0.numpy()[b]
        sizes = np.diff(bounds) + np.diff(halo_ptr)
        cur = [np.full(k, np.nan, np.float32) for k in sizes]
        nxt = [np.full(k, np.nan, np.float32) for k in sizes]
        raw = start.astype(np.float32).copy()
        if n:
            for r in range(C):
                lo, hi = bounds[r], bounds[r + 1]
                push(cur, r, fold(start[lo:hi], 0, b, np.arange(lo, hi)))
        for t in range(n):
            more = t + 1 < n
            for r in range(C):  # every slot of the local space has landed
                assert not np.isnan(cur[r]).any()
            for r in range(C):
                lo, hi = bounds[r], bounds[r + 1]
                j0, j1 = in_ptr[lo], in_ptr[hi]
                c = (cur[r][word[j0:j1] & 0xFFFF] + w[j0:j1]).astype(np.float32)
                if not graph.folded:
                    c = (c + neg * lp[b, t, in_pdf[j0:j1]]).astype(np.float32)
                c = np.minimum(c, INF)
                best, pos = segment_first_min(c, in_ptr[lo : hi + 1] - j0)
                dead = (best >= INF) | (pos < 0)
                arc = (word[j0:j1] >> 16) if compact else in_arc[j0:j1]
                code = np.where(dead, 0, arc[np.maximum(pos, 0)])
                bps[t, b, lo:hi] = np.where(dead, 1, code + 2) if compact else np.where(dead, -1, code)
                raw[lo:hi] = best
                if more:
                    push(nxt, r, fold(best, t + 1, b, np.arange(lo, hi)))
            cur, nxt = nxt, [np.full(k, np.nan, np.float32) for k in sizes]
        bps[n:, b] = stay
        out_alpha[b] = raw
        per_cta = []
        for r in range(C):
            lo, hi = bounds[r], bounds[r + 1]
            if hi == lo:  # an empty slice offers no final state
                continue
            tot = (raw[lo:hi] + final[lo:hi]).astype(np.float32)
            per_cta.append((tot.min(), lo + int(np.argmin(tot))))  # lowest index on ties
        fcost[b], fstate[b] = min(per_cta)  # rank order: lowest state on ties
        state = fstate[b]
        for t in range(T - 1, -1, -1):
            a = bps[t, b, state] - 2 if compact else bps[t, b, state]
            trace[b, t] = a
            if a >= 0:
                state = asrc[a]
    return trace, fstate, fcost, out_alpha, bps


@pytest.mark.parametrize("kind", ["compact", "int32", "unfolded"])
def test_halo_emulation_equals_plain_at_40000_states(kind):
    dense = {"compact": compact_40k, "int32": lambda: graph("40000"),
             "unfolded": unfolded_40k}[kind]()
    g = DecodeGraph.from_dense(dense, "cpu")
    assert g.num_states == 40000 and g.folded == (kind != "unfolded")
    assert (g.num_arcs <= td._COMPACT_BP_MAX_ARC) == (kind == "compact")
    plan, resident = choose_body(g, 2, H100_MAX_SMEM, h100_clusters)
    assert plan.body == "halo"
    rng = np.random.RandomState(8)
    B, T = 2, 10
    lp = torch.as_tensor(rng.randn(B, T + 5, dense.num_pdfs).astype(np.float32))
    alpha0 = viterbi(g, lp[:, :5], 0.7)[0]  # the alpha 5 earlier frames left
    lp = lp[:, 5:].contiguous()
    lengths = torch.as_tensor([T, 6], dtype=torch.int32)
    alpha, bps = viterbi(g, lp, 0.7, lengths, compact_bp=kind == "compact", alpha0=alpha0)
    want = backtrace(g, alpha, bps) + (alpha, bps)
    for c in (plan.cluster, 2):
        got = emulate_halo(g, plan_halo(g, c), lp, 0.7, lengths.numpy(), alpha0)
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x, y.numpy().astype(x.dtype))


@pytest.mark.parametrize("cluster", LARGE_CLUSTER_SIZES)
@pytest.mark.parametrize("carried", [False, True], ids=["init", "alpha0"])
def test_halo_emulation_equals_plain_on_ties(cluster, carried):
    """Costs on a coarse grid (weights in quarters, log-probs in halves):
    equal candidates within a state's in-arcs, across the lanes of its
    group or warp, and equal final costs on either side of a slice edge
    (the stream of no frames, from the initial weights or a carried alpha
    tied there too) all resolve as the twin resolves them."""
    dense, edge = edge_tie_graph(cluster)
    g = DecodeGraph.from_dense(dense, "cpu")
    plan = plan_halo(g, cluster)
    rng = np.random.RandomState(cluster)
    B, T = 3, 9
    lp = torch.as_tensor((np.round(rng.randn(B, T + 4, dense.num_pdfs) * 2) / 2).astype(np.float32))
    alpha0 = None
    if carried:
        alpha0 = viterbi(g, lp[:, :4], 0.5)[0]
        alpha0[:, [edge - 1, edge]] = -1.0
    lp = lp[:, 4:].contiguous()
    lengths = torch.as_tensor([T, 0, 5], dtype=torch.int32)
    alpha, bps = viterbi(g, lp, 0.5, lengths, compact_bp=True, alpha0=alpha0)
    want = backtrace(g, alpha, bps) + (alpha, bps)
    assert int(want[1][1]) == edge - 1  # the tie across the edge, taken low
    got = emulate_halo(g, plan, lp, 0.5, lengths.numpy(), alpha0)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y.numpy().astype(x.dtype))


# -- (c) the segmented checkpointed route -------------------------------------------


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("T,segment", [(9, 4), (40, 8), (33, 11), (5, 32)])
def test_segmented_checkpointed_equals_jax_and_dense(name, T, segment):
    """One ``viterbi_decode`` a segment from the boundary alpha, then the
    recomputed segments walked back: traces and final states exact against
    the JAX package's checkpointed decode (costs by the scheduler tests'
    rule) and bit-equal to the port's dense decode."""
    g, lp, lens = _case(name, B=4, T=T, seed=9)
    want = jd.viterbi_decode_checkpointed(jd.make_decode_graph(g), jnp.asarray(lp), 0.8,
                                          segment=segment, lengths=jnp.asarray(lens))
    tg = DecodeGraph.from_dense(g, "cpu")
    before = viterbi_decode.launches
    got = viterbi_decode_checkpointed(tg, torch.as_tensor(lp), 0.8, segment=segment,
                                      lengths=torch.as_tensor(lens))
    assert viterbi_decode.launches == before  # the CPU runs the twin
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    np.testing.assert_allclose(got[2], np.asarray(want[2]), rtol=COST_RTOL, atol=COST_ATOL)
    dense = viterbi_decode(tg, torch.as_tensor(lp), 0.8, torch.as_tensor(lens))
    for o, d in zip(got, dense):
        assert o.dtype == d.numpy().dtype
        np.testing.assert_array_equal(o, d.numpy())


# -- (d) the port against the JAX package at 40,000 states ---------------------------


def test_dense_decode_equals_jax_at_40000_states():
    dense = graph("40000")
    rng = np.random.RandomState(10)
    B, T = 2, 12
    lp = rng.randn(B, T, dense.num_pdfs).astype(np.float32)
    lens = np.asarray([T, 7], np.int32)
    want = jd.viterbi_decode(jd.make_decode_graph(dense), jnp.asarray(lp), 0.9, jnp.asarray(lens))
    got = viterbi_decode(DecodeGraph.from_dense(dense, "cpu"), torch.as_tensor(lp), 0.9,
                         torch.as_tensor(lens))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=COST_RTOL, atol=COST_ATOL)


def test_global_plan_covers_the_graph():
    """The global body's slices partition the states and keep their in-arcs;
    its tables carry every source and arc source at full width."""
    g = DecodeGraph.from_dense(graph("40000"), "cpu")
    for c in LARGE_CLUSTER_SIZES:
        plan = plan_global(g, c)
        bounds = plan.slice_state.numpy()
        assert bounds[0] == 0 and bounds[-1] == g.num_states and (np.diff(bounds) > 0).all()
        assert plan.max_arcs == np.diff(g.in_ptr.numpy()[bounds]).max()
    np.testing.assert_array_equal(plan.in_sw.numpy()[:, 0], g.in_src.numpy())
    np.testing.assert_array_equal(plan.in_sw.numpy()[:, 1].view(np.float32), g.in_weight.numpy())
    np.testing.assert_array_equal(plan.tables.arc_src.numpy(), g.arc_src.numpy())
    with pytest.raises(ValueError, match="cluster size"):
        plan_global(g, 3)
