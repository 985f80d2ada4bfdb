"""Top-K sparse-frontier Viterbi in PyTorch: the decoder for graphs whose
[B, S] alpha and [T, B, S] backpointers cannot be held at all.

Counterpart of ``rhasspy_speech_tpu/ops/frontier.py``. The decoder keeps
only the K best states per stream (LatticeFasterDecoder's max-active
cutoff without data-dependent control flow): each frame expands the
frontier's out-arcs ([B, K, D], D the largest out-degree), deduplicates
destinations, and keeps the top K. Backpointers are [T, B, K], whatever the
graph's size.

Exact when K is at least the number of states reachable at once; otherwise a
beam approximation like Kaldi's max-active. The two dedup strategies (a
per-frame [B, S] scatter-min scratch when it fits ``scratch_bytes``, else two
stable sorts) agree exactly in the exact regime.

Bit-equality with the JAX module, and with the dense decoder in the exact
regime, rests on three things kept from it: the order of the additions
(``(alpha + am[src_pdf]) + weight`` with the pdf-per-source fold, ``(alpha +
weight) + am[arc_pdf]`` without); ties between equal costs going to the
lowest index (XLA's ``top_k`` order, a stable ascending sort here, since
``torch.topk`` promises none); and the padded destination 2**30 being
clamped to ``S - 1`` with its cost forced to 1e30, so the last state's
minimum is not corrupted.

The frame loop is plain PyTorch, as it is plain JAX in the JAX package
(which has no TPU kernel for it). ``topk_backtrace``, ``_walk_back`` and
``topk_backtrace_nbest`` are copied from the JAX module, which imports JAX.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..graph.dense import NEG_INF_F32, DenseGraph
from .decoder import _INF, STAY, DecodeGraph

# Default per-frame dedup scratch cap in bytes ([B, S] f32 + int scatter
# targets of the dense-dedup path); larger graphs or batches take the sort
# path. Callers with a decode memory budget pass it through
# (``scratch_bytes``), so the frontier never out-allocates the budget that
# routed decoding to it.
DEFAULT_DEDUP_SCRATCH_BYTES = 2 << 30

_PAD_DST = 2**30  # destination of an expansion slot that holds no arc


@dataclass(frozen=True)
class FrontierGraph:
    """A DecodeGraph plus the out-degree-padded arc table."""

    base: DecodeGraph
    arcs_out: torch.Tensor  # int64 [S, D], -1 padding, ascending arc id per row
    out_degree: int

    @staticmethod
    def from_dense(
        g: DenseGraph,
        device: Union[str, torch.device] = "cuda",
        base: Optional[DecodeGraph] = None,
    ) -> "FrontierGraph":
        """``base`` reuses a DecodeGraph of ``g`` already on ``device``."""
        device = resolve_device(device)
        S = g.num_states
        outdeg = np.bincount(g.arc_src, minlength=S) if g.num_arcs else np.zeros(S, np.int64)
        D = max(int(outdeg.max()) if S else 0, 1)
        arcs_out = np.full((S, D), -1, dtype=np.int64)
        order = np.argsort(g.arc_src, kind="stable")  # ascending arc id per source
        src_sorted = g.arc_src[order]
        first = np.concatenate([[0], np.cumsum(outdeg)])[:-1]
        arcs_out[src_sorted, np.arange(order.size) - first[src_sorted]] = order
        if base is None:
            base = DecodeGraph.from_dense(g, device)
        elif base.device != device:
            raise ValueError(f"FrontierGraph: base graph on {base.device}, asked for {device}")
        return FrontierGraph(
            base=base, arcs_out=torch.as_tensor(arcs_out, device=device), out_degree=D
        )


def _lowest_k(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k lowest values per row and their indices, the lowest index first
    among equal values (the order of XLA's ``top_k`` on the negated row)."""
    vals, idx = torch.sort(values, dim=1, stable=True)
    return vals[:, :k], idx[:, :k]


def frontier_step(
    graph: FrontierGraph,
    states: torch.Tensor,  # [B, K] int64 (-1 = empty slot)
    alpha: torch.Tensor,  # [B, K] f32
    am_cost: torch.Tensor,  # [B, P]
    k: int,
    scratch_bytes: int = DEFAULT_DEDUP_SCRATCH_BYTES,
    beam: Optional[float] = None,
    min_active: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One frame: (new_states [B, k] int64, new_alpha [B, k], arcs [B, k]
    int64), slots sorted best first.

    ``beam`` / ``min_active`` are LatticeFasterDecoder's GetCutoff under
    static shapes: after the top-k (the max-active cap), candidates costlier
    than best + beam are dropped, except the first ``min_active`` slots,
    which survive any beam. ``beam=None`` keeps every top-k candidate."""
    base = graph.base
    B, K = states.shape
    D = graph.out_degree
    S, A = base.num_states, base.num_arcs
    safe_states = states.clamp_min(0)
    arcs = graph.arcs_out[safe_states]  # [B, K, D]
    valid = (arcs >= 0) & (states >= 0)[:, :, None] & (alpha < _INF)[:, :, None]
    safe_arcs = arcs.clamp_min(0)
    if base.folded:
        # every out-arc of a frontier state shares that state's am term
        am_state = am_cost.gather(1, base.src_pdf[safe_states])  # [B, K]
        cost = (alpha + am_state)[:, :, None] + base.arc_weight[safe_arcs]
    else:
        cost = (
            alpha[:, :, None]
            + base.arc_weight[safe_arcs]
            + am_cost.gather(1, base.arc_pdf[safe_arcs].reshape(B, -1)).reshape(B, K, D)
        )
    cost = torch.where(valid, cost.clamp(max=_INF), _INF)
    dst = torch.where(valid, base.arc_dst[safe_arcs], _PAD_DST)

    flat_cost = cost.reshape(B, -1)
    flat_dst = dst.reshape(B, -1)
    flat_arc = torch.where(valid, safe_arcs, -1).reshape(B, -1)

    if B * S * 8 <= scratch_bytes:
        # dense dedup: a per-frame [B, S] scratch, two scatter-mins
        clamped_dst = flat_dst.clamp_max(S - 1)  # the pad -> in range
        pad_mask = flat_dst >= S
        dense_cost = torch.full((B, S), NEG_INF_F32, dtype=torch.float32, device=alpha.device)
        dense_cost = dense_cost.scatter_reduce(
            1, clamped_dst, torch.where(pad_mask, _INF, flat_cost), "amin"
        )
        is_best = (flat_cost <= dense_cost.gather(1, clamped_dst)) & ~pad_mask
        cand = torch.where(is_best, flat_arc.clamp_min(0), A)
        arc_best = torch.full((B, S), A, dtype=torch.int64, device=alpha.device)
        arc_best = arc_best.scatter_reduce(1, clamped_dst, cand, "amin")
        # one winner per destination: the lowest arc id among the candidates
        # at the minimum cost (the dense decoder's tie-break)
        winner = (cand == arc_best.gather(1, clamped_dst)) & (cand < A)
        uniq_cost = torch.where(winner, flat_cost, _INF)
        top_cost, top_idx = _lowest_k(uniq_cost, k)
        new_states = clamped_dst.gather(1, top_idx)
        new_arcs = flat_arc.gather(1, top_idx)
    else:
        # lexicographic (dst, cost) order by two stable sorts
        cost1, order1 = torch.sort(flat_cost, dim=1, stable=True)
        dst1 = flat_dst.gather(1, order1)
        arc1 = flat_arc.gather(1, order1)
        s_dst, order2 = torch.sort(dst1, dim=1, stable=True)
        s_cost = cost1.gather(1, order2)
        s_arc = arc1.gather(1, order2)
        # the first occurrence of a destination holds its minimum cost
        first = torch.cat(
            [torch.ones((B, 1), dtype=torch.bool, device=alpha.device),
             s_dst[:, 1:] != s_dst[:, :-1]], dim=1
        )
        uniq_cost = torch.where(first & (s_cost < _INF), s_cost, _INF)
        top_cost, top_idx = _lowest_k(uniq_cost, k)
        new_states = s_dst.gather(1, top_idx)
        new_arcs = s_arc.gather(1, top_idx)
    if beam is not None and np.isfinite(beam):
        # slots are sorted best first, so the slot index is the rank and
        # the min_active floor is a prefix mask
        best = top_cost[:, :1]
        keep = (top_cost <= best + float(np.float32(beam))) | (
            torch.arange(top_cost.shape[1], device=alpha.device)[None, :] < min_active
        )
        top_cost = torch.where(keep, top_cost, _INF)
    dead = top_cost >= _INF
    new_states = torch.where(dead, -1, new_states)
    new_arcs = torch.where(dead, -1, new_arcs)
    return new_states, top_cost, new_arcs


def viterbi_topk(
    graph: FrontierGraph,
    log_probs: torch.Tensor,
    k: int,
    acoustic_scale: float = 1.0,
    lengths: Optional[torch.Tensor] = None,
    scratch_bytes: int = DEFAULT_DEDUP_SCRATCH_BYTES,
    beam: Optional[float] = None,
    min_active: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sparse-frontier decode over [B, T, P] log-probs.

    Frames at or past ``lengths[b]`` keep the carried frontier and record
    STAY arcs. Returns (states [T, B, k] int32, alphas [T, B, k] f32, arcs
    [T, B, k] int32)."""
    base = graph.base
    B, T, _P = log_probs.shape
    dev = log_probs.device
    am_costs = (-acoustic_scale) * log_probs.transpose(0, 1)

    n0 = min(k, base.num_states)
    init_alpha, init_states = _lowest_k(base.init_weight[None, :], n0)
    alpha = init_alpha.expand(B, n0)
    states = init_states.expand(B, n0)
    if n0 < k:
        alpha = torch.nn.functional.pad(alpha, (0, k - n0), value=NEG_INF_F32)
        states = torch.nn.functional.pad(states, (0, k - n0), value=-1)
    states = torch.where(alpha >= _INF, -1, states)

    states_t = torch.empty((T, B, k), dtype=torch.int32, device=dev)
    alphas_t = torch.empty((T, B, k), dtype=torch.float32, device=dev)
    arcs_t = torch.empty((T, B, k), dtype=torch.int32, device=dev)
    if lengths is not None:
        lengths = lengths.to(dev)
    for t in range(T):
        new_states, new_alpha, arcs = frontier_step(
            graph, states, alpha, am_costs[t], k, scratch_bytes, beam, min_active
        )
        if lengths is not None:
            active = (t < lengths)[:, None]
            new_states = torch.where(active, new_states, states)
            new_alpha = torch.where(active, new_alpha, alpha)
            arcs = torch.where(active, arcs, STAY)
        states, alpha = new_states, new_alpha
        states_t[t], alphas_t[t], arcs_t[t] = states, alpha, arcs
    return states_t, alphas_t, arcs_t


def viterbi_topk_cached(
    graph: FrontierGraph,
    log_probs: torch.Tensor,
    k: int,
    acoustic_scale: float = 1.0,
    lengths: Optional[torch.Tensor] = None,
    scratch_bytes: int = DEFAULT_DEDUP_SCRATCH_BYTES,
    beam: Optional[float] = None,
    min_active: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``viterbi_topk`` with ``lengths`` defaulted to every frame (the JAX
    function of this name also caches its compiled program; eager PyTorch
    has none to cache)."""
    B, T, _P = log_probs.shape
    if lengths is None:
        lengths = torch.full((B,), T, dtype=torch.int32, device=log_probs.device)
    return viterbi_topk(
        graph, log_probs, k, acoustic_scale, lengths, scratch_bytes, beam, min_active
    )


def topk_backtrace(
    dense: DenseGraph,
    states_t: np.ndarray,  # [T, B, K]
    alphas_t: np.ndarray,
    arcs_t: np.ndarray,
    stream: int,
) -> Tuple[Optional[List[int]], float]:
    """Host backtrace of a stream's best complete hypothesis."""
    last_states = states_t[-1, stream]
    totals = np.where(
        last_states >= 0,
        alphas_t[-1, stream] + dense.final_weight[np.maximum(last_states, 0)],
        NEG_INF_F32,
    )
    slot = int(np.argmin(totals))
    if totals[slot] >= NEG_INF_F32:
        return None, float("inf")
    cost = float(totals[slot])

    words, _used = _walk_back(dense, states_t, arcs_t, stream, slot)
    if words is None:
        return None, float("inf")
    return words, cost


def _walk_back(
    dense: DenseGraph,
    states_t: np.ndarray,
    arcs_t: np.ndarray,
    stream: int,
    slot: int,
) -> Tuple[Optional[List[int]], Optional[Tuple[int, ...]]]:
    """Backtrace one final slot to (word ids, arc tuple) or (None, None)."""
    T = states_t.shape[0]
    cur_state = int(states_t[-1, stream, slot])
    words_rev = [dense.words_of(int(dense.final_wseq[cur_state]))]
    arc_path = []
    for t in range(T - 1, -1, -1):
        slots = np.where(states_t[t, stream] == cur_state)[0]
        assert slots.size, (t, cur_state)
        arc = int(arcs_t[t, stream, slots[0]])
        if arc == STAY:
            continue  # masked padding frame: frontier carried over
        if arc < 0:
            return None, None
        arc_path.append(arc)
        words_rev.append(dense.words_of(int(dense.arc_wseq[arc])))
        cur_state = int(dense.arc_src[arc])
    words_rev.append(dense.words_of(int(dense.init_wseq[cur_state])))
    words: List[int] = []
    for seq in reversed(words_rev):
        words.extend(seq)
    return words, tuple(arc_path)


def topk_backtrace_nbest(
    dense: DenseGraph,
    states_t: np.ndarray,  # [T, B, K]
    alphas_t: np.ndarray,
    arcs_t: np.ndarray,
    stream: int,
    n: int,
) -> List[Tuple[List[int], float]]:
    """N-best distinct word sequences from one stream's frontier trellis.

    The K final slots each carry an independent best-path-to-state; sorted
    by total cost and backtraced, they yield up to K alternatives — the
    max-active-bounded analogue of the dense decoder's exact k-best."""
    last_states = states_t[-1, stream]
    totals = np.where(
        last_states >= 0,
        alphas_t[-1, stream] + dense.final_weight[np.maximum(last_states, 0)],
        NEG_INF_F32,
    )
    results: List[Tuple[List[int], float]] = []
    seen = set()
    for slot in np.argsort(totals, kind="stable"):
        if totals[slot] >= NEG_INF_F32 or len(results) >= n:
            break
        words, _arcs = _walk_back(dense, states_t, arcs_t, stream, int(slot))
        if words is None:
            continue
        key = tuple(words)
        if key in seen:
            continue
        seen.add(key)
        results.append((words, float(totals[slot])))
    return results
