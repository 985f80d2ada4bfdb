"""Dense 1-best Viterbi decoding in PyTorch: the plain twin of the decode
kernel.

Counterpart of the 1-best half of ``rhasspy_speech_tpu/ops/decoder.py``.
``viterbi`` is that module's flat scatter step (``viterbi_step``): per
frame, every arc's candidate cost, a scatter-min into its destination and
the lowest arc id among the winners, with ``scatter_reduce("amin")``. The
JAX package's other layouts (padded, hybrid, self-loop lanes, the one-hot
fold) exist for TPU gathers and are bit-identical to this step by its own
tests, so the port carries only this one; the CUDA kernel
(``ops/viterbi_cuda.py``) walks a CSR of each state's in-arcs instead.

Bit-exactness with the reference needs its exact arithmetic: with the
pdf-per-source fold the candidate is ``(alpha + am[src_pdf]) + weight``,
without it ``(alpha + weight) + am[arc_pdf]``; then ``min(., 1e30)``; ties
go to the lowest arc id; a state is dead when its cost reaches 1e30.

``_state_pdf``, ``STAY``, ``_COMPACT_BP_MAX_ARC``, ``traces_to_words_batch``
and ``trace_to_words`` are copied from the JAX module, which imports JAX.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..host import NEG_INF_F32, DenseGraph

# Backpointer sentinel for masked (past-end) frames: "stay in state"
STAY = -2

# Largest arc id storable in the compact uint16 backpointer encoding
# (arc + 2, reserving 0 for STAY and 1 for "dead"): 65535 - 2.
_COMPACT_BP_MAX_ARC = 65533


def _state_pdf(g: DenseGraph):
    """Per-SOURCE-state pdf table, or None when out-arcs disagree (Kaldi
    HMM graphs carry the source state's pdf on every out-arc, so the
    acoustic cost folds into alpha once per frame). States with no
    out-arcs map to pdf 0 (never read)."""
    S = g.num_states
    if g.arc_src.size == 0:
        return np.zeros(S, np.int32)
    sp = np.full(S, -1, dtype=np.int64)
    sp[g.arc_src] = g.arc_pdf
    if not (sp[g.arc_src] == g.arc_pdf).all():
        return None
    return np.where(sp < 0, 0, sp).astype(np.int32)


@dataclass(frozen=True)
class DecodeGraph:
    """A DenseGraph's decode tensors on one device.

    The flat arc table drives the scatter twin; ``in_ptr``/``in_src``/
    ``in_weight``/``in_arc``/``in_pdf`` are the CSR of each state's in-arcs
    in ascending arc id, which the kernel walks."""

    num_states: int
    num_pdfs: int
    num_arcs: int
    max_pdf: int  # largest pdf id any arc reads (-1 for no arcs)
    arc_src: torch.Tensor  # int64 [A]
    arc_dst: torch.Tensor  # int64 [A]
    arc_pdf: torch.Tensor  # int64 [A]
    arc_weight: torch.Tensor  # f32 [A]
    init_weight: torch.Tensor  # f32 [S]
    final_weight: torch.Tensor  # f32 [S]
    src_pdf: Optional[torch.Tensor]  # int64 [S], None without the fold
    in_ptr: torch.Tensor  # int32 [S + 1]
    in_src: torch.Tensor  # int32 [A]
    in_weight: torch.Tensor  # f32 [A]
    in_arc: torch.Tensor  # int32 [A]
    in_pdf: torch.Tensor  # int32 [A]
    # int32 copies for the kernel (src_pdf is zeros without the fold)
    src_pdf_i32: torch.Tensor  # int32 [S]
    arc_src_i32: torch.Tensor  # int32 [A]

    @property
    def device(self) -> torch.device:
        return self.init_weight.device

    @property
    def folded(self) -> bool:
        return self.src_pdf is not None

    @staticmethod
    def from_dense(g: DenseGraph, device: torch.device = torch.device("cpu")) -> "DecodeGraph":
        S, A = g.num_states, g.num_arcs
        sp = _state_pdf(g)
        order = np.argsort(g.arc_dst, kind="stable")  # ascending arc id per dst
        indeg = np.bincount(g.arc_dst, minlength=S) if A else np.zeros(S, np.int64)
        in_ptr = np.concatenate([[0], np.cumsum(indeg)]).astype(np.int32)

        def t(a, dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        return DecodeGraph(
            num_states=S,
            num_pdfs=g.num_pdfs,
            num_arcs=A,
            max_pdf=int(g.arc_pdf.max()) if A else -1,
            arc_src=t(g.arc_src, torch.int64),
            arc_dst=t(g.arc_dst, torch.int64),
            arc_pdf=t(g.arc_pdf, torch.int64),
            arc_weight=t(g.arc_weight, torch.float32),
            init_weight=t(g.init_weight, torch.float32),
            final_weight=t(g.final_weight, torch.float32),
            src_pdf=None if sp is None else t(sp, torch.int64),
            in_ptr=t(in_ptr, torch.int32),
            in_src=t(g.arc_src[order], torch.int32),
            in_weight=t(g.arc_weight[order], torch.float32),
            in_arc=t(order, torch.int32),
            in_pdf=t(g.arc_pdf[order], torch.int32),
            src_pdf_i32=t(np.zeros(S, np.int32) if sp is None else sp, torch.int32),
            arc_src_i32=t(g.arc_src, torch.int32),
        )


def _inf(like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(NEG_INF_F32, dtype=torch.float32, device=like.device)


def viterbi_step(
    graph: DecodeGraph, alpha: torch.Tensor, am_cost: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode frame. alpha [B, S]; am_cost [B, P] = -scale * log p.
    Returns (new_alpha [B, S], best_arc [B, S] int64, -1 if unreached)."""
    B = alpha.shape[0]
    S, A = graph.num_states, graph.num_arcs
    inf = _inf(alpha)
    if graph.folded:
        alpha_e = alpha + am_cost[:, graph.src_pdf]
        scores = alpha_e[:, graph.arc_src] + graph.arc_weight[None, :]
    else:
        scores = (
            alpha[:, graph.arc_src] + graph.arc_weight[None, :]
        ) + am_cost[:, graph.arc_pdf]
    scores = torch.minimum(scores, inf)
    dst = graph.arc_dst[None, :].expand(B, A)
    new_alpha = torch.full((B, S), NEG_INF_F32, dtype=torch.float32, device=alpha.device)
    new_alpha = new_alpha.scatter_reduce(1, dst, scores, "amin")
    is_best = scores <= new_alpha[:, graph.arc_dst]
    arc_ids = torch.arange(A, device=alpha.device)
    cand = torch.where(is_best, arc_ids[None, :], A)
    best_arc = torch.full((B, S), A, dtype=torch.int64, device=alpha.device)
    best_arc = best_arc.scatter_reduce(1, dst, cand, "amin")
    best_arc = torch.where(new_alpha >= inf, -1, best_arc)
    return new_alpha, best_arc


def viterbi(
    graph: DecodeGraph,
    log_probs: torch.Tensor,
    acoustic_scale: float = 1.0,
    lengths: Optional[torch.Tensor] = None,
    compact_bp: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched dense Viterbi over [B, T, P] f32 log-probs.

    Frames at or past ``lengths[b]`` are no-ops (alpha carried, backpointer
    STAY). Returns (alpha_final [B, S] f32, bps [T, B, S]): int32 arc ids
    (-1 dead, -2 STAY), or with ``compact_bp`` uint16 ``arc + 2``
    (0 = STAY, 1 = dead)."""
    if compact_bp and graph.num_arcs > _COMPACT_BP_MAX_ARC:
        raise ValueError(
            f"compact_bp needs <= {_COMPACT_BP_MAX_ARC} arcs, got {graph.num_arcs}"
        )
    B, T, _P = log_probs.shape
    am_costs = (-acoustic_scale) * log_probs.transpose(0, 1)  # [T, B, P]
    alpha = graph.init_weight[None, :].expand(B, graph.num_states)
    bp_dtype = torch.uint16 if compact_bp else torch.int32
    bps = torch.empty((T, B, graph.num_states), dtype=bp_dtype, device=log_probs.device)
    for t in range(T):
        new_alpha, bp = viterbi_step(graph, alpha, am_costs[t])
        if lengths is not None:
            active = (t < lengths)[:, None]
            new_alpha = torch.where(active, new_alpha, alpha)
            bp = torch.where(active, bp, STAY)
        bps[t] = (bp + 2).to(bp_dtype) if compact_bp else bp.to(bp_dtype)
        alpha = new_alpha
    return alpha.contiguous(), bps


def backtrace(
    graph: DecodeGraph, alpha_final: torch.Tensor, bps: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Best final state (lowest index on ties), its cost, and the arc
    trace [B, T] walked back through ``bps`` (either encoding)."""
    totals = alpha_final + graph.final_weight[None, :]
    final_state = torch.argmin(totals, dim=-1)
    total_cost = totals.gather(1, final_state[:, None])[:, 0]
    T, B = bps.shape[0], bps.shape[1]
    rows = torch.arange(B, device=bps.device)
    compact = bps.dtype == torch.uint16
    state = final_state
    trace = torch.empty((B, T), dtype=torch.int32, device=bps.device)
    for t in range(T - 1, -1, -1):
        # widen the row first: uint16 has only copy support on some devices
        arc = bps[t].to(torch.int64)[rows, state]
        if compact:
            arc = arc - 2
        trace[:, t] = arc.to(torch.int32)
        state = torch.where(arc < 0, state, graph.arc_src[arc.clamp_min(0)])
    return trace, final_state.to(torch.int32), total_cost


def viterbi_decode(
    graph: DecodeGraph,
    log_probs: torch.Tensor,
    acoustic_scale: float = 1.0,
    lengths: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Forward + backtrace: (arc_trace [B, T] int32 with STAY/-1 for
    masked/dead frames, final_state [B] int32, total_cost [B] f32)."""
    compact = graph.num_arcs <= _COMPACT_BP_MAX_ARC
    alpha_final, bps = viterbi(graph, log_probs, acoustic_scale, lengths, compact_bp=compact)
    return backtrace(graph, alpha_final, bps)


def traces_to_words_batch(
    graph: DenseGraph,
    arc_trace: np.ndarray,
    final_state: np.ndarray,
    total_cost: np.ndarray,
) -> List[Tuple[Optional[List[int]], float]]:
    """Word assembly for a whole batch (NumPy per stream)."""
    B, T = arc_trace.shape
    arc_wseq = graph.arc_wseq
    arc_src = graph.arc_src
    out: List[Tuple[Optional[List[int]], float]] = []
    for b in range(B):
        cost = float(total_cost[b])
        if cost >= NEG_INF_F32:
            out.append((None, float("inf")))
            continue
        arcs = arc_trace[b]
        valid = arcs >= 0
        if not valid.any():
            fs = int(final_state[b])
            words = list(graph.words_of(int(graph.init_wseq[fs])))
            words.extend(graph.words_of(int(graph.final_wseq[fs])))
            out.append((words, cost))
            continue
        real = arcs[valid]
        if (arcs == -1).any():
            out.append((None, float("inf")))
            continue
        first_state = int(arc_src[real[0]])
        words: List[int] = list(graph.words_of(int(graph.init_wseq[first_state])))
        wseqs = arc_wseq[real]
        for wid in wseqs[wseqs != 0]:
            words.extend(graph.words_of(int(wid)))
        words.extend(
            graph.words_of(int(graph.final_wseq[int(final_state[b])]))
        )
        out.append((words, cost))
    return out


def trace_to_words(
    graph: DenseGraph,
    arc_trace: np.ndarray,
    final_state: np.ndarray,
    total_cost: np.ndarray,
    stream: int,
) -> Tuple[Optional[List[int]], float]:
    """Host word assembly for one stream of a device backtrace."""
    cost = float(total_cost[stream])
    if cost >= NEG_INF_F32:
        return None, float("inf")
    arcs = arc_trace[stream]
    words: List[int] = []
    first_state = None
    segs: List[Tuple[int, ...]] = []
    for t in range(arcs.shape[0]):
        arc = int(arcs[t])
        if arc == STAY:
            continue
        if arc < 0:
            return None, float("inf")
        if first_state is None:
            first_state = int(graph.arc_src[arc])
        segs.append(graph.words_of(int(graph.arc_wseq[arc])))
    if first_state is None:
        first_state = int(final_state[stream])
    words.extend(graph.words_of(int(graph.init_wseq[first_state])))
    for seg in segs:
        words.extend(seg)
    words.extend(graph.words_of(int(graph.final_wseq[int(final_state[stream])])))
    return words, cost
