"""Lattices: tropical and log-semiring forward-backward over the dense
graph, and pruned word DAGs built from them on the host.

Counterpart of ``rhasspy_speech_tpu/ops/lattice.py``. ``forward_backward``
is its tropical pass bit for bit (the same scatter-min steps in the same
f32 order: folded forward ``(alpha + am[src_pdf])`` then ``+ w``, folded
backward ``min(scatter_min(beta[dst] + w) + am[src_pdf], 1e30)``, the am
term added after the scatter; unfolded ``(x + w) + am[arc_pdf]`` both
ways). ``forward_backward_log`` sums with ``scatter_add``, whose order
differs from XLA's, so it agrees within float rounding only. The JAX
package has no TPU kernel for either, so neither has the port.

The NumPy ``Lattice`` class, ``arc_posteriors`` and ``build_lattice`` are
copied from the JAX module, which imports JAX; the rescore chain and the
lattice writers reach the class by duck typing.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..fst.core import EPS_ID, Fst
from ..fst.determinize import determinize
from ..fst.ops import rmepsilon, shortest_path
from ..graph.dense import NEG_INF_F32, DenseGraph
from .decoder import DecodeGraph, _inf


@dataclass
class Lattice:
    """A pruned decode DAG for one stream.

    Nodes are (frame, state) pairs, renumbered densely; arcs carry the word
    sequence id of the underlying decode-graph arc plus its combined
    (graph + acoustic) cost."""

    num_nodes: int
    starts: List[int]  # node ids at frame 0 (after consuming nothing)
    finals: Dict[int, float]  # node id -> final cost
    # (src_node, dst_node, wseq, graph_cost, acoustic_cost, dense_arc_id) —
    # costs are kept split like Kaldi LatticeWeight (graph, acoustic), so
    # lattice-scale --lm-scale=0 semantics are exact; the dense arc id
    # recovers phone/transition metadata for the rescore chain.
    arcs: List[Tuple[int, int, int, float, float, int]]
    best_cost: float
    node_frame_state: List[Tuple[int, int]] = field(default_factory=list)

    def num_arcs(self) -> int:
        return len(self.arcs)

    def shortest_path_words(self, graph: DenseGraph) -> Tuple[List[int], float]:
        """Best path through the lattice (sanity: equals the Viterbi path)."""
        INF = float("inf")
        dist = [INF] * self.num_nodes
        back: List[Optional[Tuple[int, int]]] = [None] * self.num_nodes
        order = sorted(range(self.num_nodes), key=lambda n: self.node_frame_state[n])
        for n in self.starts:
            dist[n] = self._start_cost(graph, n)
        for src, dst, wseq, g_cost, a_cost, _arc in sorted(
            self.arcs, key=lambda a: self.node_frame_state[a[0]]
        ):
            cost = g_cost + a_cost
            if dist[src] + cost < dist[dst]:
                dist[dst] = dist[src] + cost
                back[dst] = (src, wseq)
        best_node, best = -1, INF
        for n, fcost in self.finals.items():
            if dist[n] + fcost < best:
                best = dist[n] + fcost
                best_node = n
        if best_node < 0:
            return [], INF
        words_rev = [graph.words_of(int(graph.final_wseq[
            self.node_frame_state[best_node][1]]))]
        n = best_node
        while back[n] is not None:
            src, wseq = back[n]
            words_rev.append(graph.words_of(wseq))
            n = src
        words_rev.append(
            graph.words_of(int(graph.init_wseq[self.node_frame_state[n][1]]))
        )
        words: List[int] = []
        for seq in reversed(words_rev):
            words.extend(seq)
        return words, best

    def _start_cost(self, graph: DenseGraph, node: int) -> float:
        state = self.node_frame_state[node][1]
        return float(graph.init_weight[state])

    def to_fst(self, graph: DenseGraph):
        """Convert to a host Fst (words on the output side), enabling the
        generic FST toolbox — compose, shortest path, pruning — exactly how
        the reference pipes lattices through fst/lat binaries."""
        fst = Fst()
        fst.add_states(self.num_nodes)
        super_start = fst.add_state()
        fst.start = super_start
        for n in self.starts:
            init_words = graph.words_of(
                int(graph.init_wseq[self.node_frame_state[n][1]])
            )
            cur = super_start
            cost = self._start_cost(graph, n)
            if init_words:
                for i, w in enumerate(init_words):
                    nxt = n if i == len(init_words) - 1 else fst.add_state()
                    fst.add_arc(cur, EPS_ID, w, cost if i == 0 else 0.0, nxt)
                    cur = nxt
            else:
                fst.add_arc(cur, EPS_ID, EPS_ID, cost, n)
        for src, dst, wseq, g_cost, a_cost, _arc in self.arcs:
            cost = g_cost + a_cost
            words = graph.words_of(wseq)
            if not words:
                fst.add_arc(src, EPS_ID, EPS_ID, cost, dst)
                continue
            cur = src
            for i, w in enumerate(words):
                nxt = dst if i == len(words) - 1 else fst.add_state()
                fst.add_arc(cur, EPS_ID, w, cost if i == 0 else 0.0, nxt)
                cur = nxt
        for n, fcost in self.finals.items():
            final_words = graph.words_of(
                int(graph.final_wseq[self.node_frame_state[n][1]])
            )
            if final_words:
                cur = n
                for i, w in enumerate(final_words):
                    nxt = fst.add_state()
                    fst.add_arc(cur, EPS_ID, w, fcost if i == 0 else 0.0, nxt)
                    cur = nxt
                fst.set_final(cur, 0.0)
            else:
                fst.set_final(n, fcost)
        return fst

    def to_phone_fst(
        self,
        graph: DenseGraph,
        transition_scale: float = 1.0,
        self_loop_scale: float = 0.1,
    ):
        """Phone-level acceptor of the lattice with graph scores dropped.

        The rescore chain's front half in one step (reference
        transcribe_wav.py:165-171 + lattice-add-trans-probs :183-190):
        graph costs are zeroed (lattice-scale --lm-scale=0.0), word labels
        are replaced by the phones crossed (lattice-to-phone-lattice; phone
        boundaries come from the dense graph's ``arc_phone`` entry tags),
        and HMM transition log-probs are re-added from ``arc_tcost`` with
        the given scales. Arc weights keep the acoustic cost.

        Requires a decode graph built with transition metadata
        (DenseGraph.has_phone_info); raises ValueError otherwise.
        """
        if not graph.has_phone_info:
            raise ValueError(
                "decode graph carries no phone metadata; retrain to enable "
                "lattice-level rescoring (graph/transitions.py)"
            )

        fst = Fst()
        fst.add_states(self.num_nodes)
        super_start = fst.add_state()
        fst.start = super_start
        for n in self.starts:
            # init closures cross no emitting arcs: no phones, graph-only
            # cost (dropped by lm-scale=0)
            fst.add_arc(super_start, EPS_ID, EPS_ID, 0.0, n)
        for src, dst, _wseq, _g_cost, a_cost, arc in self.arcs:
            phone = int(graph.arc_phone[arc])
            tcost = float(graph.arc_tcost[arc])
            scale = self_loop_scale if graph.arc_self[arc] else transition_scale
            weight = a_cost + scale * tcost
            label = phone if phone else EPS_ID
            fst.add_arc(src, label, label, weight, dst)
        for n in self.finals:
            fst.set_final(n, 0.0)  # final closure is graph-only: dropped
        return fst

    def nbest(
        self, graph: DenseGraph, n: int, dedup: bool = True
    ) -> List[Tuple[List[int], float]]:
        """lattice-to-nbest equivalent: n cheapest word sequences.

        With dedup (the default, matching lattice-to-nbest's
        determinization step) the lattice is projected to words,
        epsilon-removed, and determinized, which merges ALL alignments of
        each word sequence into one path with the Viterbi (min) cost —
        raw path enumeration would drown in same-words alignments and
        miss genuine rival sequences entirely."""
        fst = self.to_fst(graph)
        if dedup:
            acc = rmepsilon(fst.project("output"))
            try:
                acc = determinize(acc)
            except Exception:
                pass  # fall back to enumerating the undeterminized acceptor
            best = shortest_path(acc, nshortest=n, unique=True)
        else:
            best = shortest_path(fst, nshortest=n, unique=False)
        # paths() enumeration order is not cost order: sort first, dedup after
        candidates = sorted(
            best.paths(max_paths=max(n * 6, 32)), key=lambda p: p[2]
        )
        results: List[Tuple[List[int], float]] = []
        seen = set()
        for _ipath, opath, weight in candidates:
            words = [o for o in opath if o != EPS_ID]
            key = tuple(words)
            if dedup and key in seen:
                continue
            seen.add(key)
            results.append((words, weight))
            if len(results) >= n:
                break
        return results


def _scatter_min(scores: torch.Tensor, index: torch.Tensor, num_states: int) -> torch.Tensor:
    """[B, A] scores -> [B, S]: min per ``index`` entry, 1e30 where none."""
    B = scores.shape[0]
    out = torch.full((B, num_states), NEG_INF_F32, dtype=torch.float32, device=scores.device)
    return out.scatter_reduce(1, index[None, :].expand(B, index.shape[0]), scores, "amin")


def forward_backward(
    graph: DecodeGraph,
    log_probs: torch.Tensor,
    acoustic_scale: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tropical forward/backward over [B, T, P].

    Returns (alpha [T+1, B, S], beta [T+1, B, S]): alpha[t] = best cost to
    reach each state having consumed t frames; beta[t] = best cost to
    finish from each state with frames t..T-1 remaining."""
    B, T, _P = log_probs.shape
    S = graph.num_states
    inf = _inf(log_probs)
    am_costs = (-acoustic_scale) * log_probs.transpose(0, 1)  # [T, B, P]
    alphas = torch.empty((T + 1, B, S), dtype=torch.float32, device=log_probs.device)
    betas = torch.empty_like(alphas)
    alphas[0] = graph.init_weight[None, :]
    for t in range(T):
        alpha, am_t = alphas[t], am_costs[t]
        if graph.folded:
            alpha = alpha + am_t[:, graph.src_pdf]
            scores = alpha[:, graph.arc_src] + graph.arc_weight[None, :]
        else:
            scores = (alpha[:, graph.arc_src] + graph.arc_weight[None, :]) + am_t[:, graph.arc_pdf]
        alphas[t + 1] = _scatter_min(torch.minimum(scores, inf), graph.arc_dst, S)
    betas[T] = graph.final_weight[None, :]
    for t in range(T - 1, -1, -1):
        beta, am_t = betas[t + 1], am_costs[t]
        if graph.folded:
            # every arc OUT of a state shares its am term: added after the
            # scatter-min
            scores = torch.minimum(beta[:, graph.arc_dst] + graph.arc_weight[None, :], inf)
            new_beta = _scatter_min(scores, graph.arc_src, S)
            betas[t] = torch.minimum(new_beta + am_t[:, graph.src_pdf], inf)
        else:
            scores = (beta[:, graph.arc_dst] + graph.arc_weight[None, :]) + am_t[:, graph.arc_pdf]
            betas[t] = _scatter_min(torch.minimum(scores, inf), graph.arc_src, S)
    return alphas, betas


def forward_backward_log(
    graph: DecodeGraph,
    log_probs: torch.Tensor,
    acoustic_scale: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Log-semiring forward/backward (sum over paths) for posteriors.

    Returns (alpha [T+1, B, S], beta [T+1, B, S]) as NEGATED log-sums
    (costs), so alpha[t] + beta[t] - total is a state's posterior cost."""
    B, T, _P = log_probs.shape
    S = graph.num_states
    inf = _inf(log_probs)
    am_costs = (-acoustic_scale) * log_probs.transpose(0, 1)

    def logaddexp_min(scores, index):
        # -log sum exp(-scores) per index entry: scatter-min for the max
        # term, then a scatter-add of the shifted exponentials
        m = _scatter_min(scores, index, S)
        shifted = torch.exp(-(scores - m[:, index]))
        shifted = torch.where(scores >= inf, 0.0, shifted)
        sums = torch.zeros((B, S), dtype=torch.float32, device=scores.device)
        sums = sums.index_add(1, index, shifted)
        out = m - torch.log(torch.clamp_min(sums, 1e-37))
        return torch.where(sums > 0, out, inf)

    alphas = torch.empty((T + 1, B, S), dtype=torch.float32, device=log_probs.device)
    betas = torch.empty_like(alphas)
    alphas[0] = graph.init_weight[None, :]
    for t in range(T):
        scores = (alphas[t][:, graph.arc_src] + graph.arc_weight[None, :]) + am_costs[t][
            :, graph.arc_pdf
        ]
        alphas[t + 1] = logaddexp_min(torch.minimum(scores, inf), graph.arc_dst)
    betas[T] = graph.final_weight[None, :]
    for t in range(T - 1, -1, -1):
        scores = (betas[t + 1][:, graph.arc_dst] + graph.arc_weight[None, :]) + am_costs[t][
            :, graph.arc_pdf
        ]
        betas[t] = logaddexp_min(torch.minimum(scores, inf), graph.arc_src)
    return alphas, betas


def arc_posteriors(
    graph: DenseGraph,
    log_alphas: np.ndarray,  # [T+1, B, S] from forward_backward_log
    log_betas: np.ndarray,
    log_probs: np.ndarray,
    stream: int,
    acoustic_scale: float = 1.0,
) -> np.ndarray:
    """Posterior probability of each (frame, arc): [T, A].

    The occupancies at each frame sum to 1 (up to float error) — the basis
    for word confidence scores."""
    T = log_probs.shape[1]
    a = log_alphas[:, stream]
    b = log_betas[:, stream]

    def neglogsumexp(x, axis=None):
        m = np.min(x, axis=axis, keepdims=True)
        return (m - np.log(
            np.maximum(np.exp(-(x - m)).sum(axis=axis, keepdims=True), 1e-37)
        )).squeeze()

    total = float(neglogsumexp(a[0] + b[0]))
    am = -acoustic_scale * log_probs[stream]
    out = np.zeros((T, graph.num_arcs), dtype=np.float64)
    for t in range(T):
        through = (
            a[t][graph.arc_src]
            + graph.arc_weight
            + am[t][graph.arc_pdf]
            + b[t + 1][graph.arc_dst]
        )
        out[t] = np.exp(-(through - total))
    return out


def build_lattice(
    graph: DenseGraph,
    alphas: np.ndarray,  # [T+1, B, S]
    betas: np.ndarray,
    log_probs: np.ndarray,  # [B, T, P]
    stream: int,
    lattice_beam: float = 8.0,
    acoustic_scale: float = 1.0,
) -> Optional[Lattice]:
    """Prune (frame, arc) pairs to within lattice_beam of the best path."""
    T = log_probs.shape[1]
    a = alphas[:, stream]  # [T+1, S]
    b = betas[:, stream]
    best = float((a[0] + b[0]).min())
    if best >= NEG_INF_F32:
        return None
    cutoff = best + lattice_beam

    am = -acoustic_scale * log_probs[stream]  # [T, P]
    node_ids: Dict[Tuple[int, int], int] = {}
    node_frame_state: List[Tuple[int, int]] = []

    def node(frame: int, state: int) -> int:
        key = (frame, state)
        nid = node_ids.get(key)
        if nid is None:
            nid = len(node_frame_state)
            node_ids[key] = nid
            node_frame_state.append(key)
        return nid

    arcs: List[Tuple[int, int, int, float, float, int]] = []
    src_arr = graph.arc_src
    dst_arr = graph.arc_dst
    pdf_arr = graph.arc_pdf
    w_arr = graph.arc_weight
    wseq_arr = graph.arc_wseq
    for t in range(T):
        through = (
            a[t][src_arr] + w_arr + am[t][pdf_arr] + b[t + 1][dst_arr]
        )
        keep = np.where(through <= cutoff)[0]
        for arc in keep:
            arcs.append(
                (
                    node(t, int(src_arr[arc])),
                    node(t + 1, int(dst_arr[arc])),
                    int(wseq_arr[arc]),
                    float(w_arr[arc]),
                    float(am[t][pdf_arr[arc]]),
                    int(arc),
                )
            )

    starts = [
        node(0, int(s))
        for s in np.where((a[0] < NEG_INF_F32) & (a[0] + b[0] <= cutoff))[0]
    ]
    finals = {
        node(T, int(s)): float(graph.final_weight[s])
        for s in np.where(
            (graph.final_weight < NEG_INF_F32)
            & (a[T] + graph.final_weight <= cutoff)
        )[0]
    }
    return Lattice(
        num_nodes=len(node_frame_state),
        starts=starts,
        finals=finals,
        arcs=arcs,
        best_cost=best,
        node_frame_state=node_frame_state,
    )
