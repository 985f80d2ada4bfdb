"""Seeded decode graphs of a deployment's size class for the decode kernel:
chain + self-loops + random arcs + hub states, as ``DenseGraph``s; and a
trained graph directory padded past a size with states no path reaches."""

from __future__ import annotations

import shutil
from pathlib import Path
from typing import Union

import numpy as np

from ..graph.dense import NEG_INF_F32, DenseGraph


def random_decode_graph(
    rng: np.random.RandomState,
    num_states: int = 14200,
    extra_arcs: int = 9600,
    num_pdfs: int = 3072,
    hubs: int = 2,
    hub_arcs: int = 200,
) -> DenseGraph:
    """A folded graph (pdf a function of the source state): every state has
    a self-loop and an arc to the next, ``extra_arcs`` random arcs, and
    ``hubs`` states with ``hub_arcs`` extra in-arcs each. The defaults give
    14,200 states and 38,400 arcs, the size class of a 14,178-state
    deployment graph."""
    S = num_states
    src = np.concatenate([np.arange(S), np.arange(S), rng.randint(S, size=extra_arcs)])
    dst = np.concatenate([(np.arange(S) + 1) % S, np.arange(S), rng.randint(S, size=extra_arcs)])
    hub_states = np.linspace(S // 2, S - 1, hubs).astype(np.int64) if hubs else np.zeros(0, np.int64)
    src = np.concatenate([src, rng.randint(S, size=hubs * hub_arcs)])
    dst = np.concatenate([dst, np.repeat(hub_states, hub_arcs)])
    A = src.size
    init = np.full(S, NEG_INF_F32, np.float32)
    init[0] = 0.0
    final = np.full(S, NEG_INF_F32, np.float32)
    final[S - 1] = 0.0
    return DenseGraph(
        num_states=S, arc_src=src.astype(np.int32), arc_dst=dst.astype(np.int32),
        arc_pdf=rng.randint(num_pdfs, size=S)[src].astype(np.int32),
        arc_wseq=np.zeros(A, np.int32), arc_weight=rng.rand(A).astype(np.float32),
        final_weight=final, final_wseq=np.zeros(S, np.int32), init_weight=init,
        init_wseq=np.zeros(S, np.int32), word_seqs=[()], num_pdfs=num_pdfs,
    )


def device_route_graph(
    seed: int, num_states: int = 30000, extra_arcs: int = 2000, num_pdfs: int = 3072
) -> DenseGraph:
    """``random_decode_graph`` drawn from ``seed`` with every state final, so
    each stream ends on a path: at the defaults 30,000 states and 62,400
    arcs, past K2's replicated body and within the scheduler's 65,532-arc
    backpointer ring (its captured device route on K2's halo body)."""
    g = random_decode_graph(np.random.RandomState(seed), num_states, extra_arcs, num_pdfs)
    g.final_weight[:] = 0.0
    return g


def padded_graph_dir(
    graph_dir: Union[str, Path], out_dir: Union[str, Path], num_states: int
) -> Path:
    """A copy of a trained graph directory whose ``graph.npz`` holds
    ``num_states`` states: the trained graph, then states no path reaches
    (infinite initial and final weights), each with a weightless self-loop
    reading pdf 0. Every decode on it finds the trained graph's paths, so a
    test can take a graph of a given size class and keep its transcripts."""
    out_dir = Path(out_dir)
    shutil.copytree(graph_dir, out_dir)
    g = DenseGraph.load(str(out_dir / "graph.npz"))
    pad = num_states - g.num_states
    if pad < 0:
        raise ValueError(f"the graph already holds {g.num_states} > {num_states} states")
    new = np.arange(g.num_states, num_states, dtype=np.int32)

    def arcs(a, fill):
        return None if a is None else np.concatenate([a, np.full(pad, fill, a.dtype)])

    def states(a, fill):
        return np.concatenate([a, np.full(pad, fill, a.dtype)])

    padded = DenseGraph(
        num_states=num_states,
        arc_src=np.concatenate([g.arc_src, new]), arc_dst=np.concatenate([g.arc_dst, new]),
        arc_pdf=arcs(g.arc_pdf, 0), arc_wseq=arcs(g.arc_wseq, 0),
        arc_weight=arcs(g.arc_weight, 0.0),
        final_weight=states(g.final_weight, NEG_INF_F32), final_wseq=states(g.final_wseq, 0),
        init_weight=states(g.init_weight, NEG_INF_F32), init_wseq=states(g.init_wseq, 0),
        word_seqs=g.word_seqs, num_pdfs=g.num_pdfs,
        arc_phone=arcs(g.arc_phone, 0), arc_tcost=arcs(g.arc_tcost, 0.0),
        arc_self=arcs(g.arc_self, 1),
    )
    padded.save(str(out_dir / "graph.npz"))
    return out_dir
