"""The decode kernel's graph preparation, on the CPU.

``ops/viterbi_cuda.py`` cuts a graph into the slices of a thread-block
cluster, narrows its tables and lays out shared memory in Python, once per
graph; ``csrc/viterbi.cu`` only runs on the card. These tests hold the
preparation to what the kernel assumes, and hold an emulation of the
kernel's sliced relaxation -- a thread per state with few in-arcs, 8 or 32
strided lanes per larger state merged by the lexicographic (cost, index)
minimum, the owner's fold, the push into every CTA's copy of alpha, the
per-CTA and cluster argmin, the backtrace -- bit-equal to the plain twin
(``ops/decoder.py``), which the JAX package's decoders equal bit for bit.
"""

import numpy as np
import pytest
import torch

from rhasspy_speech_torch.graph.dense import NEG_INF_F32, DenseGraph
from rhasspy_speech_torch.ops.decoder import DecodeGraph, backtrace, viterbi
from rhasspy_speech_torch.ops.viterbi_cuda import (
    CLUSTER_SIZES,
    H100_MAX_SMEM,
    GROUP_DEG,
    THREAD_DEG,
    choose_cluster,
    plan_viterbi,
    smem_layout,
)
from rhasspy_speech_torch.testing.decode_graphs import random_decode_graph

INF = np.float32(NEG_INF_F32)


def h100_clusters(plan, resident):
    """One block per SM (the kernel's shared memory), 132 SMs."""
    return 132 // plan.cluster


def hubby_graph(seed, num_states=60, extra_arcs=120, hub_arcs=(40, 300), num_pdfs=17):
    """A small folded graph with states of 40 and 300 in-arcs (an 8-lane
    group's and a warp's) and costs on a coarse grid, so equal candidates
    (ties) are common."""
    rng = np.random.RandomState(seed)
    g = random_decode_graph(rng, num_states, extra_arcs, num_pdfs, hubs=0)
    S = num_states
    hub_src = rng.randint(S, size=sum(hub_arcs))
    hub_dst = np.repeat([S // 3, S - 1], hub_arcs)
    src = np.concatenate([g.arc_src, hub_src]).astype(np.int32)
    dst = np.concatenate([g.arc_dst, hub_dst]).astype(np.int32)
    pdf_of = rng.randint(num_pdfs, size=S)
    A = src.size
    init = np.full(S, NEG_INF_F32, np.float32)
    init[:3] = [0.0, 0.5, 0.5]
    final = np.full(S, NEG_INF_F32, np.float32)
    final[[S - 1, S // 3, S // 2]] = [0.0, 0.25, 0.25]
    return DenseGraph(
        num_states=S, arc_src=src, arc_dst=dst, arc_pdf=pdf_of[src].astype(np.int32),
        arc_wseq=np.zeros(A, np.int32),
        arc_weight=(np.round(rng.rand(A) * 4) / 4).astype(np.float32),
        final_weight=final, final_wseq=np.zeros(S, np.int32), init_weight=init,
        init_wseq=np.zeros(S, np.int32), word_seqs=[()], num_pdfs=num_pdfs,
    )


def u16(t):
    return t.numpy().view(np.uint16).astype(np.int64)


def emulate_kernel(graph, plan, lp, scale, lengths):
    """csrc/viterbi.cu's arithmetic and order, one stream at a time:
    (trace, final_state, total_cost, alpha, bps) as the kernel returns them
    (compact graphs)."""
    B, T, _P = lp.shape
    S, C = graph.num_states, plan.cluster
    neg = np.float32(-scale)
    in_ptr = graph.in_ptr.numpy().astype(np.int64)
    word = plan.tables.in_sw.numpy()[:, 0].view(np.uint32).astype(np.int64)
    src, arc = word & 0xFFFF, word >> 16
    w = plan.tables.in_sw.numpy()[:, 1].view(np.float32)
    spdf, asrc = u16(plan.tables.src_pdf), u16(plan.tables.arc_src)
    bounds = plan.slice_state.numpy()
    tiers = [(plan.group_ptr.numpy(), plan.group_state.numpy(), 8),
             (plan.hub_ptr.numpy(), plan.hub_state.numpy(), 32)]
    init, final = graph.init_weight.numpy(), graph.final_weight.numpy()
    lp = lp.numpy()
    bps = np.zeros((T, B, S), np.int64)
    out_alpha = np.zeros((B, S), np.float32)
    trace = np.zeros((B, T), np.int64)
    fstate, fcost = np.zeros(B, np.int64), np.zeros(B, np.float32)

    def fold(v, t, b, s):
        return np.float32(v + np.float32(neg * lp[b, t, spdf[s]]))

    def walk(cur, js):  # ascending strict-< walk over CSR positions js
        best, bj = INF, None
        for j in js:
            c = min(np.float32(cur[src[j]] + w[j]), INF)
            if c < best:
                best, bj = c, j
        return best, bj

    for b in range(B):
        n = min(int(lengths[b]), T)
        copies = np.zeros((2, C, S), np.float32)  # every CTA's two alpha buffers
        raw = init.copy()
        if n:
            for s in range(S):
                copies[0, :, s] = fold(init[s], 0, b, s)
        for t in range(n):
            cur, nxt = copies[t % 2], copies[(t + 1) % 2]
            for r in range(C):
                lo, hi = bounds[r], bounds[r + 1]
                width = {lo + i: wd for ptr, lst, wd in tiers for i in lst[ptr[r]:ptr[r + 1]]}
                for s in range(lo, hi):
                    js = range(in_ptr[s], in_ptr[s + 1])
                    if s in width:  # strided lanes, then the lexicographic merge
                        lanes = [walk(cur[r], js[k::width[s]]) for k in range(width[s])]
                        best, bj = min(lanes, key=lambda x: (x[0], np.inf if x[1] is None else x[1]))
                    else:
                        assert len(js) <= THREAD_DEG
                        best, bj = walk(cur[r], js)
                    dead = best >= INF or bj is None
                    bps[t, b, s] = 1 if dead else arc[bj] + 2
                    raw[s] = best
                    if t + 1 < n:
                        nxt[:, s] = fold(best, t + 1, b, s)  # the push, to all C
        bps[n:, b] = 0
        out_alpha[b] = raw
        per_cta = []
        for r in range(C):
            lo, hi = bounds[r], bounds[r + 1]
            tot = (raw[lo:hi] + final[lo:hi]).astype(np.float32)
            if hi > lo:
                per_cta.append((tot.min(), lo + int(np.argmin(tot))))
        fcost[b], fstate[b] = min(per_cta)
        state = fstate[b]
        for t in range(T - 1, -1, -1):
            a = bps[t, b, state] - 2
            trace[b, t] = a
            if a >= 0:
                state = asrc[a]
    return trace, fstate, fcost, out_alpha, bps


@pytest.mark.parametrize("cluster", CLUSTER_SIZES)
def test_slices_partition_the_arcs(cluster):
    g = DecodeGraph.from_dense(random_decode_graph(np.random.RandomState(3), 500, 900, 40), "cpu")
    plan = plan_viterbi(g, cluster)
    bounds = plan.slice_state.numpy()
    in_ptr = g.in_ptr.numpy()
    assert bounds[0] == 0 and bounds[-1] == g.num_states and (np.diff(bounds) >= 0).all()
    # every arc lands in exactly one slice: the one that owns its destination
    owner = np.searchsorted(bounds, g.arc_dst.numpy(), side="right") - 1
    counts = np.bincount(owner, minlength=cluster)
    np.testing.assert_array_equal(counts, np.diff(in_ptr[bounds]))
    assert counts.sum() == g.num_arcs
    # balanced by arcs + states: no slice more than one state's load off
    load = np.diff(np.concatenate([[0], np.cumsum(np.diff(in_ptr) + 1)])[bounds])
    assert load.max() - load.min() <= 2 * (np.diff(in_ptr).max() + 1)
    # the lane-group tiers: exactly the slice-local states of their degrees
    deg = np.diff(in_ptr)
    for ptr, lst, lo_deg, hi_deg in ((plan.group_ptr, plan.group_state, THREAD_DEG, GROUP_DEG),
                                     (plan.hub_ptr, plan.hub_state, GROUP_DEG, np.inf)):
        for r in range(cluster):
            lo, hi = bounds[r], bounds[r + 1]
            d = deg[lo:hi]
            np.testing.assert_array_equal(lst[ptr[r]:ptr[r + 1]].numpy(),
                                          np.flatnonzero((d > lo_deg) & (d <= hi_deg)))
    assert plan is plan_viterbi(g, cluster)  # once per graph and cluster size


def test_tables_keep_ascending_arc_ids_and_narrow_exactly():
    dense = hubby_graph(0)
    g = DecodeGraph.from_dense(dense, "cpu")
    tab = plan_viterbi(g, 2).tables
    in_ptr = g.in_ptr.numpy()
    word = tab.in_sw.numpy()[:, 0].view(np.uint32).astype(np.int64)
    arc = word >> 16
    for s in range(g.num_states):
        assert (np.diff(arc[in_ptr[s]:in_ptr[s + 1]]) > 0).all()
    np.testing.assert_array_equal(arc, g.in_arc.numpy())
    np.testing.assert_array_equal(word & 0xFFFF, g.in_src.numpy())
    np.testing.assert_array_equal(tab.in_sw.numpy()[:, 1].view(np.float32), g.in_weight.numpy())
    np.testing.assert_array_equal(u16(tab.arc_src), dense.arc_src)
    np.testing.assert_array_equal(u16(tab.src_pdf), g.src_pdf.numpy())
    bad = DecodeGraph.from_dense(dense, "cpu")
    bad.in_arc[[0, 1]] = bad.in_arc[[1, 0]].clone()
    if bad.in_ptr[1] >= 2:
        with pytest.raises(ValueError, match="ascending"):
            plan_viterbi(bad, 1)


def test_deployment_size_graph_fits_shared_memory():
    """14,200 states / 38,400 arcs: alpha (2 x 56.8 KB) and a slice's tables
    fit one block's 227 KB at C = 4 and C = 8; with one block per SM on 132
    SMs, B = 32 takes C = 4 (one wave of 128 CTAs), B = 1 takes C = 8."""
    g = DecodeGraph.from_dense(random_decode_graph(np.random.RandomState(1)), "cpu")
    assert (g.num_states, g.num_arcs) == (14200, 38400)
    for c in (4, 8):
        plan = plan_viterbi(g, c)
        _, size = smem_layout(g.num_states, plan, True, True)
        assert size <= H100_MAX_SMEM, (c, size)
    _, size2 = smem_layout(g.num_states, plan_viterbi(g, 2), True, True)
    assert size2 > H100_MAX_SMEM
    plan32, resident32 = choose_cluster(g, 32, H100_MAX_SMEM, h100_clusters)
    plan1, resident1 = choose_cluster(g, 1, H100_MAX_SMEM, h100_clusters)
    assert (plan32.cluster, resident32, plan1.cluster, resident1) == (4, True, 8, True)
    with pytest.raises(ValueError, match="shared memory"):
        choose_cluster(DecodeGraph.from_dense(random_decode_graph(
            np.random.RandomState(2), 40000, 10, 40, hubs=0), "cpu"), 1, H100_MAX_SMEM, h100_clusters)


@pytest.mark.parametrize("cluster", CLUSTER_SIZES)
def test_sliced_relaxation_emulation_equals_plain(cluster):
    dense = hubby_graph(5)
    g = DecodeGraph.from_dense(dense, "cpu")
    plan = plan_viterbi(g, cluster)
    assert plan.group_ptr[-1] >= 1 and plan.hub_ptr[-1] >= 1  # every path runs
    rng = np.random.RandomState(6)
    B, T = 3, 7
    lp = torch.as_tensor((np.round(rng.randn(B, T, dense.num_pdfs) * 2) / 2).astype(np.float32))
    lengths = torch.as_tensor([7, 0, 4], dtype=torch.int32)
    alpha, bps = viterbi(g, lp, 0.5, lengths, compact_bp=True)
    want = backtrace(g, alpha, bps) + (alpha, bps)
    got = emulate_kernel(g, plan, lp, 0.5, lengths.numpy())
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y.numpy().astype(x.dtype))
