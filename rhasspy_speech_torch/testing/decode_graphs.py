"""Seeded decode graphs of a deployment's size class for the decode kernel:
chain + self-loops + random arcs + hub states, as ``DenseGraph``s."""

from __future__ import annotations

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
