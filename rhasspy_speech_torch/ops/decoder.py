"""Dense Viterbi decoding in PyTorch: the plain twin of the decode kernel,
and the k-best decoder.

Counterpart of the dense decoders of ``rhasspy_speech_tpu/ops/decoder.py``.
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

The k-best decoder (``kbest_step``, ``viterbi_kbest``,
``viterbi_kbest_decode``) is the JAX module's scatter form, bit for bit: k
rounds of scatter-min per frame over flat candidates ``arc * K + k_prev``,
each round knocking out the candidate it selected. The JAX package has no
TPU kernel for it, so neither has the port.

``viterbi_decode_checkpointed`` is the JAX module's memory-bounded decode:
the forward pass keeps only the alpha before each segment of frames, and the
backtrace recomputes one segment's backpointers at a time, last segment
first. Same outputs as ``viterbi_decode``, bit for bit.

``_state_pdf``, ``STAY``, ``_COMPACT_BP_MAX_ARC``, ``backtrace_words``,
``traces_to_words_batch``, ``trace_to_words``, ``kbest_traces_to_nbest`` and
``backtrace_nbest`` are copied from the JAX module, which imports JAX.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..graph.dense import NEG_INF_F32, DenseGraph

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
    in ascending arc id, which the kernel walks. ``kernel_cache`` holds what
    a kernel wrapper derives from the graph once (``ops/viterbi_cuda.py``
    plans)."""

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
    kernel_cache: Dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def device(self) -> torch.device:
        return self.init_weight.device

    @property
    def folded(self) -> bool:
        return self.src_pdf is not None

    @staticmethod
    def from_dense(g: DenseGraph, device: Union[str, torch.device] = "cuda") -> "DecodeGraph":
        device = resolve_device(device)
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
        )


# 1e30 as a Python scalar: comparing or clamping an f32 tensor with it keeps
# f32 and uploads nothing (a tensor made per frame would be a host-to-device
# copy per frame).
_INF = float(NEG_INF_F32)


def _inf(like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(NEG_INF_F32, dtype=torch.float32, device=like.device)


def _arc_scores(graph: DecodeGraph, alpha: torch.Tensor, am_cost: torch.Tensor) -> torch.Tensor:
    """Every arc's candidate cost [B, A] for one frame, clamped at 1e30."""
    if graph.folded:
        alpha_e = alpha + am_cost[:, graph.src_pdf]
        scores = alpha_e[:, graph.arc_src] + graph.arc_weight[None, :]
    else:
        scores = (
            alpha[:, graph.arc_src] + graph.arc_weight[None, :]
        ) + am_cost[:, graph.arc_pdf]
    return scores.clamp(max=_INF)


def _scatter_min(graph: DecodeGraph, scores: torch.Tensor) -> torch.Tensor:
    """The cheapest candidate into each destination state: [B, A] -> [B, S]."""
    B = scores.shape[0]
    new_alpha = torch.full(
        (B, graph.num_states), NEG_INF_F32, dtype=torch.float32, device=scores.device
    )
    dst = graph.arc_dst[None, :].expand(B, graph.num_arcs)
    return new_alpha.scatter_reduce(1, dst, scores, "amin")


def relax_costs(graph: DecodeGraph, alpha: torch.Tensor, am_cost: torch.Tensor) -> torch.Tensor:
    """The cost half of ``viterbi_step``: new_alpha [B, S] with no winner
    tracking, bit-identical to the alpha ``viterbi_step`` returns."""
    return _scatter_min(graph, _arc_scores(graph, alpha, am_cost))


def viterbi_step(
    graph: DecodeGraph, alpha: torch.Tensor, am_cost: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode frame. alpha [B, S]; am_cost [B, P] = -scale * log p.
    Returns (new_alpha [B, S], best_arc [B, S] int64, -1 if unreached)."""
    B = alpha.shape[0]
    S, A = graph.num_states, graph.num_arcs
    scores = _arc_scores(graph, alpha, am_cost)
    new_alpha = _scatter_min(graph, scores)
    dst = graph.arc_dst[None, :].expand(B, A)
    is_best = scores <= new_alpha[:, graph.arc_dst]
    arc_ids = torch.arange(A, device=alpha.device)
    cand = torch.where(is_best, arc_ids[None, :], A)
    best_arc = torch.full((B, S), A, dtype=torch.int64, device=alpha.device)
    best_arc = best_arc.scatter_reduce(1, dst, cand, "amin")
    best_arc = torch.where(new_alpha >= _INF, -1, best_arc)
    return new_alpha, best_arc


def viterbi(
    graph: DecodeGraph,
    log_probs: torch.Tensor,
    acoustic_scale: float = 1.0,
    lengths: Optional[torch.Tensor] = None,
    compact_bp: bool = False,
    alpha0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched dense Viterbi over [B, T, P] f32 log-probs.

    Frames at or past ``lengths[b]`` are no-ops (alpha carried, backpointer
    STAY). ``alpha0`` [B, S] starts each stream from a carried alpha (a
    stream decoded chunk by chunk) instead of the graph's initial weights.
    Returns (alpha_final [B, S] f32, bps [T, B, S]): int32 arc ids
    (-1 dead, -2 STAY), or with ``compact_bp`` uint16 ``arc + 2``
    (0 = STAY, 1 = dead)."""
    if compact_bp and graph.num_arcs > _COMPACT_BP_MAX_ARC:
        raise ValueError(
            f"compact_bp needs <= {_COMPACT_BP_MAX_ARC} arcs, got {graph.num_arcs}"
        )
    B, T, _P = log_probs.shape
    am_costs = (-acoustic_scale) * log_probs.transpose(0, 1)  # [T, B, P]
    alpha = graph.init_weight[None, :].expand(B, graph.num_states) if alpha0 is None else alpha0
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


def viterbi_decode_checkpointed(
    graph: DecodeGraph,
    log_probs: torch.Tensor,
    acoustic_scale: float = 1.0,
    segment: int = 32,
    lengths: Optional[torch.Tensor] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Memory-bounded decode: the forward pass keeps only the alpha before
    each segment of ``segment`` frames ([ceil(T / segment), B, S] f32), then
    each segment's backpointers are recomputed from its boundary alpha, last
    segment first, and walked back from the carried end state ([segment, B,
    S] int32 at a time, where ``viterbi`` holds [T, B, S]).

    Returns host arrays (arc_trace [B, T] int32, final_state [B] int32,
    total_cost [B] f32) identical to ``viterbi_decode``'s. The end state
    stays on the device from segment to segment, and the three results come
    to the host in one copy at the end."""
    B, T, _P = log_probs.shape
    dev = log_probs.device
    am_costs = (-acoustic_scale) * log_probs.transpose(0, 1)  # [T, B, P]
    active = None
    if lengths is not None:
        active = torch.arange(T, device=dev)[:, None, None] < lengths.to(dev)[None, :, None]

    alpha = graph.init_weight[None, :].expand(B, graph.num_states)
    boundaries = []
    for t in range(T):
        if t % segment == 0:
            boundaries.append(alpha)
        new_alpha = relax_costs(graph, alpha, am_costs[t])
        alpha = new_alpha if active is None else torch.where(active[t], new_alpha, alpha)
    totals = alpha + graph.final_weight[None, :]
    final_state = torch.argmin(totals, dim=-1)
    total_cost = totals.gather(1, final_state[:, None])[:, 0]

    rows = torch.arange(B, device=dev)
    trace = torch.empty((B, T), dtype=torch.int32, device=dev)
    state = final_state
    for seg in range(len(boundaries) - 1, -1, -1):
        lo, hi = seg * segment, min((seg + 1) * segment, T)
        alpha = boundaries[seg]
        bps = []
        for t in range(lo, hi):
            new_alpha, bp = viterbi_step(graph, alpha, am_costs[t])
            if active is not None:
                new_alpha = torch.where(active[t], new_alpha, alpha)
                bp = torch.where(active[t], bp, STAY)
            bps.append(bp)
            alpha = new_alpha
        for t in range(hi - 1, lo - 1, -1):
            arc = bps[t - lo][rows, state]
            trace[:, t] = arc.to(torch.int32)
            state = torch.where(arc < 0, state, graph.arc_src[arc.clamp_min(0)])
    packed = torch.cat(
        [trace, final_state.to(torch.int32)[:, None],
         total_cost.contiguous().view(torch.int32)[:, None]], dim=1
    ).cpu().numpy()
    return (
        np.ascontiguousarray(packed[:, :T]),
        packed[:, T].copy(),
        packed[:, T + 1].copy().view(np.float32),
    )


def backtrace_words(
    graph: DenseGraph,
    alpha_final: np.ndarray,
    backptr: np.ndarray,
    stream: int,
    num_frames: Optional[int] = None,
) -> Tuple[Optional[List[int]], float]:
    """Host-side 1-best backtrace for one stream.

    Returns (word ids, total cost) or (None, inf) when no complete path."""
    T = backptr.shape[0] if num_frames is None else num_frames
    alpha = alpha_final[stream]
    totals = alpha + graph.final_weight
    state = int(np.argmin(totals))
    if totals[state] >= NEG_INF_F32:
        return None, float("inf")
    cost = float(totals[state])

    words_rev: List[Tuple[int, ...]] = [graph.words_of(int(graph.final_wseq[state]))]
    for t in range(T - 1, -1, -1):
        arc = int(backptr[t, stream, state])
        if arc == STAY:
            continue
        if arc < 0:
            return None, float("inf")
        words_rev.append(graph.words_of(int(graph.arc_wseq[arc])))
        state = int(graph.arc_src[arc])
    words_rev.append(graph.words_of(int(graph.init_wseq[state])))

    words: List[int] = []
    for seq in reversed(words_rev):
        words.extend(seq)
    return words, cost


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


# ---------------------------------------------------------------------------
# K-best (n-best extraction)
# ---------------------------------------------------------------------------


def kbest_step(
    graph: DecodeGraph, alpha: torch.Tensor, am_cost: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One frame of k-best Viterbi. alpha [B, S, K]; am_cost [B, P].
    Returns (new_alpha [B, S, k], bp [B, S, k] int32 = winning flat
    candidate arc * K + k_prev, or -1)."""
    B, S, K = alpha.shape
    A = graph.num_arcs
    inf = _INF
    if graph.folded:
        alpha = alpha + am_cost[:, graph.src_pdf][:, :, None]
        cand = alpha[:, graph.arc_src, :] + graph.arc_weight[None, :, None]
    else:
        cand = (
            alpha[:, graph.arc_src, :] + graph.arc_weight[None, :, None]
        ) + am_cost[:, graph.arc_pdf, None]
    cand = cand.clamp(max=inf).reshape(B, A * K)
    dst_flat = graph.arc_dst.repeat_interleave(K)  # [A*K]
    dst = dst_flat[None, :].expand(B, A * K)
    flat_ids = torch.arange(A * K, device=alpha.device)
    alphas, bps = [], []
    for _ in range(k):
        m = torch.full((B, S), NEG_INF_F32, dtype=torch.float32, device=alpha.device)
        m = m.scatter_reduce(1, dst, cand, "amin")
        sel = torch.where(cand <= m[:, dst_flat], flat_ids[None, :], A * K)
        bp = torch.full((B, S), A * K, dtype=torch.int64, device=alpha.device)
        bp = bp.scatter_reduce(1, dst, sel, "amin")
        bp = torch.where(m >= inf, -1, bp)
        alphas.append(m)
        bps.append(bp)
        # knock out the selected candidate so the next round finds rank+1
        cand = torch.where(bp[:, dst_flat] == flat_ids[None, :], inf, cand)
    return torch.stack(alphas, dim=-1), torch.stack(bps, dim=-1).to(torch.int32)


def viterbi_kbest(
    graph: DecodeGraph,
    log_probs: torch.Tensor,
    k: int,
    acoustic_scale: float = 1.0,
    lengths: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K-best batched Viterbi over [B, T, P]. Returns (alpha_final [B, S, k],
    backptr [T, B, S, k] int32 flat ids arc * k + k_prev; STAY for masked
    frames)."""
    B, T, _P = log_probs.shape
    S = graph.num_states
    am_costs = (-acoustic_scale) * log_probs.transpose(0, 1)
    alpha = torch.full((B, S, k), NEG_INF_F32, dtype=torch.float32, device=log_probs.device)
    alpha[:, :, 0] = graph.init_weight[None, :]
    bps = torch.empty((T, B, S, k), dtype=torch.int32, device=log_probs.device)
    if lengths is not None:
        lengths = lengths.to(log_probs.device)
    for t in range(T):
        new_alpha, bp = kbest_step(graph, alpha, am_costs[t], k)
        if lengths is not None:
            active = (t < lengths)[:, None, None]
            new_alpha = torch.where(active, new_alpha, alpha)
            bp = torch.where(active, bp, STAY)
        bps[t] = bp
        alpha = new_alpha
    return alpha, bps


def viterbi_kbest_decode(
    graph: DecodeGraph,
    log_probs: torch.Tensor,
    k: int,
    acoustic_scale: float = 1.0,
    lengths: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K-best forward + backtrace of the global top-k hypotheses on the
    device: (arc_traces [B, k, T] int32 with STAY/-1 sentinels,
    seed_states [B, k] int32, seed_costs [B, k] f32).

    The top-k is a stable ascending sort of the [B, S * k] totals: the
    lowest flat index first among equal costs, as XLA's top_k orders
    ties (dead states all tie at 1e30)."""
    alpha_final, bps = viterbi_kbest(graph, log_probs, k, acoustic_scale, lengths)
    B, S = log_probs.shape[0], graph.num_states
    totals = alpha_final + graph.final_weight[None, :, None]
    flat = totals.reshape(B, S * k)
    seed_costs, seed_flat = torch.sort(flat, dim=1, stable=True)
    seed_costs, seed_flat = seed_costs[:, :k], seed_flat[:, :k]
    states = seed_flat // k
    ranks = seed_flat % k
    seed_states = states.to(torch.int32)
    rows = torch.arange(B, device=log_probs.device)[:, None]
    T = bps.shape[0]
    traces = torch.empty((B, k, T), dtype=torch.int32, device=log_probs.device)
    for t in range(T - 1, -1, -1):
        entry = bps[t][rows, states, ranks].to(torch.int64)  # [B, k]
        keep = (entry == STAY) | (entry == -1)
        arc = torch.where(keep, 0, entry.clamp_min(0)) // k
        traces[:, :, t] = torch.where(entry == STAY, STAY, torch.where(entry == -1, -1, arc)).to(
            torch.int32
        )
        states = torch.where(keep, states, graph.arc_src[arc])
        ranks = torch.where(keep, ranks, entry.clamp_min(0) % k)
    return traces, seed_states, seed_costs.contiguous()


def kbest_traces_to_nbest(
    graph: DenseGraph,
    arc_traces: np.ndarray,
    seed_states: np.ndarray,
    seed_costs: np.ndarray,
    stream: int,
    n: int,
    dedup: bool = True,
) -> List[Tuple[List[int], float]]:
    """Host word assembly for viterbi_kbest_decode outputs."""
    results: List[Tuple[List[int], float]] = []
    seen = set()
    K = arc_traces.shape[1]
    for kk in range(K):
        cost = float(seed_costs[stream, kk])
        if cost >= NEG_INF_F32:
            continue
        arcs = arc_traces[stream, kk]
        if (arcs == -1).any():
            continue
        real = arcs[arcs >= 0]
        if real.shape[0]:
            first_state = int(graph.arc_src[real[0]])
        else:
            first_state = int(seed_states[stream, kk])
        words: List[int] = list(graph.words_of(int(graph.init_wseq[first_state])))
        wseqs = graph.arc_wseq[real]
        for wid in wseqs[wseqs != 0]:
            words.extend(graph.words_of(int(wid)))
        words.extend(
            graph.words_of(int(graph.final_wseq[int(seed_states[stream, kk])]))
        )
        key = tuple(words)
        if dedup and key in seen:
            continue
        seen.add(key)
        results.append((words, cost))
        if len(results) >= n:
            break
    return results


def backtrace_nbest(
    graph: DenseGraph,
    alpha_final: np.ndarray,
    backptr: np.ndarray,
    stream: int,
    n: int,
    num_frames: Optional[int] = None,
    dedup: bool = True,
) -> List[Tuple[List[int], float]]:
    """Host-side n-best backtrace for one stream from k-best tensors.

    Returns up to n (word ids, cost) pairs sorted by cost; word-sequence
    duplicates keep the cheapest (like nbest after lattice determinization)."""
    T = backptr.shape[0] if num_frames is None else num_frames
    S, K = alpha_final.shape[1], alpha_final.shape[2]
    totals = alpha_final[stream] + graph.final_weight[:, None]  # [S, K]
    flat_order = np.argsort(totals, axis=None, kind="stable")

    results: List[Tuple[List[int], float]] = []
    seen = set()
    for flat in flat_order:
        state, rank = divmod(int(flat), K)
        cost = float(totals[state, rank])
        if cost >= NEG_INF_F32:
            break
        words_rev: List[Tuple[int, ...]] = [
            graph.words_of(int(graph.final_wseq[state]))
        ]
        s, r = state, rank
        dead = False
        for t in range(T - 1, -1, -1):
            entry = int(backptr[t, stream, s, r])
            if entry == STAY:
                continue
            if entry < 0:
                dead = True
                break
            arc, r = divmod(entry, K)
            words_rev.append(graph.words_of(int(graph.arc_wseq[arc])))
            s = int(graph.arc_src[arc])
        if dead:
            continue
        words_rev.append(graph.words_of(int(graph.init_wseq[s])))
        words: List[int] = []
        for seq in reversed(words_rev):
            words.extend(seq)
        key = tuple(words)
        if dedup and key in seen:
            continue
        seen.add(key)
        results.append((words, cost))
        if len(results) >= n:
            break
    return results
