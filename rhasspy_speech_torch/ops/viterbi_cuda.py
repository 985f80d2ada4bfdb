"""Viterbi decode kernel wrapper (``csrc/viterbi.cu``): the port of the TPU
kernel ``rhasspy_speech_tpu/ops/pallas_decoder.py:viterbi_pallas``.

``viterbi_decode`` launches the kernel for log-probs on a CUDA device and
runs the plain twin (``ops.decoder.viterbi`` + ``backtrace``) for log-probs
on the CPU; it never falls back from one to the other.
``viterbi_decode.launches`` counts kernel launches.

The kernel decodes each stream with a cluster of C CTAs. ``plan_viterbi``
cuts a graph into C slices of destination states once per graph and C
(cached on the ``DecodeGraph``) and checks the tables the kernel reads;
``smem_layout`` places alpha and a slice's tables in shared memory;
``choose_cluster`` picks C from the graph's bytes and the batch, and
``select_plan`` runs it once per graph and batch size with the card's
limits. The first three are plain Python, so the CPU tests reach them.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from . import _build
from .decoder import _COMPACT_BP_MAX_ARC, DecodeGraph, backtrace, viterbi

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# In-arcs a thread walks alone, and that 8 lanes walk together; a state
# with more is relaxed by a whole warp.
THREAD_DEG = 8
GROUP_DEG = 64
CLUSTER_SIZES = (1, 2, 4, 8)
# Slices are not cut below this many states to fill more SMs: on the
# 803-state flagship graph clusters of 1 to 8 decode within a few percent of
# each other, while a cluster of 8 ties up eight SMs (PERF.md, K2 sweep).
MIN_SLICE_STATES = 1024
MAX_THREADS = 1024
MAX_SLICE_STATES = 4 * MAX_THREADS  # csrc/viterbi.cu kStatesPerThread x threads
# Shared memory a block may opt into on an H100 (232,448 B) less the
# kernel's static arrays; the wrapper asks the card (rss_viterbi_max_smem).
H100_MAX_SMEM = 232448 - (32 * 8 + 8 * 8 + 2 * 8)


def _lib() -> ctypes.CDLL:
    lib = _build.load("viterbi")
    if lib.rss_viterbi_launch.argtypes is None:
        lib.rss_viterbi_launch.argtypes = (
            [_P] * 16 + [_I, _F] + [_I] * 5 + [_I] * 2 + [_I] * 7 + [_P] * 5 + [_I] * 3 + [_P]
        )
        lib.rss_viterbi_launch.restype = _I
        lib.rss_viterbi_max_smem.argtypes = [_I]
        lib.rss_viterbi_max_smem.restype = _I
        lib.rss_viterbi_max_clusters.argtypes = [_I] * 6
        lib.rss_viterbi_max_clusters.restype = _I
    return lib


@dataclass(frozen=True)
class ViterbiTables:
    """The graph's tables in the kernel's types, checked once per graph.
    ``in_sw`` packs each in-arc's source (low 16 bits), arc id (high 16
    bits, compact graphs) and weight (f32 bits) into 8 bytes, so a
    relaxation step is one shared-memory load besides alpha's. The uint16
    tables are int16 tensors of the same bits."""

    compact: bool  # <= 65533 arcs: uint16 arc ids and backpointers
    in_sw: torch.Tensor  # int32 [A, 2], CSR order
    src_pdf: torch.Tensor  # uint16 bits [S] (zeros without the fold)
    arc_src: torch.Tensor  # uint16 bits [A], by arc id


@dataclass(frozen=True)
class ViterbiPlan:
    """A decode graph cut into ``cluster`` slices of destination states.

    Slice c holds states ``slice_state[c] .. slice_state[c + 1] - 1`` and
    their in-arcs, CSR positions ``in_ptr[slice_state[c]] ..``; the cuts
    balance arcs + states. ``group_state[group_ptr[c]:group_ptr[c + 1]]``
    are the slice-local indices of its states with more than ``THREAD_DEG``
    and at most ``GROUP_DEG`` in-arcs, ``hub_state[hub_ptr[c]:hub_ptr[c +
    1]]`` those with more than ``GROUP_DEG``."""

    cluster: int
    tables: ViterbiTables
    max_states: int  # states of the largest slice
    max_arcs: int  # in-arcs of the largest slice
    slice_state: torch.Tensor  # int32 [C + 1]
    group_ptr: torch.Tensor  # int32 [C + 1]
    group_state: torch.Tensor  # int32
    hub_ptr: torch.Tensor  # int32 [C + 1]
    hub_state: torch.Tensor  # int32


def _u16(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(a.astype(np.uint16).view(np.int16), device=device)


def _tables(graph: DecodeGraph) -> ViterbiTables:
    tables = graph.kernel_cache.get("viterbi")
    if tables is not None:
        return tables
    S, A = graph.num_states, graph.num_arcs
    if S > 1 << 16:
        raise ValueError(f"viterbi kernel keeps source states as uint16: {S} states")
    in_ptr = graph.in_ptr.cpu().numpy().astype(np.int64)
    in_arc = graph.in_arc.cpu().numpy().astype(np.int64)
    dst = np.repeat(np.arange(S), np.diff(in_ptr))
    if A and not (np.diff(in_arc)[dst[1:] == dst[:-1]] > 0).all():
        raise ValueError("viterbi kernel needs each state's in-arcs in ascending arc id")
    src_pdf = np.zeros(S, np.int64) if graph.src_pdf is None else graph.src_pdf.cpu().numpy()
    if src_pdf.size and src_pdf.max() >= 1 << 16:
        raise ValueError("viterbi kernel keeps src_pdf as uint16: pdf id >= 65536")
    compact = A <= _COMPACT_BP_MAX_ARC
    dev = graph.device
    word = graph.in_src.cpu().numpy().astype(np.int64)
    if compact:
        word = word | (in_arc << 16)
    in_sw = np.stack([word.astype(np.uint32).view(np.int32),
                      graph.in_weight.cpu().numpy().view(np.int32)], axis=1)
    tables = ViterbiTables(
        compact=compact,
        in_sw=torch.as_tensor(np.ascontiguousarray(in_sw), device=dev),
        src_pdf=_u16(src_pdf, dev),
        arc_src=_u16(graph.arc_src.cpu().numpy(), dev),
    )
    graph.kernel_cache["viterbi"] = tables
    return tables


def plan_viterbi(graph: DecodeGraph, cluster: int) -> ViterbiPlan:
    """The graph cut for clusters of ``cluster`` CTAs, once per graph and
    cluster size."""
    key = ("viterbi", cluster)
    plan = graph.kernel_cache.get(key)
    if plan is not None:
        return plan
    if cluster not in CLUSTER_SIZES:
        raise ValueError(f"cluster size {cluster} not in {CLUSTER_SIZES}")
    tables = _tables(graph)
    in_ptr = graph.in_ptr.cpu().numpy().astype(np.int64)
    deg = np.diff(in_ptr)
    cum = np.concatenate([[0], np.cumsum(deg + 1)])
    bounds = np.searchsorted(cum, cum[-1] * np.arange(cluster + 1) / cluster, side="left")
    bounds[0], bounds[-1] = 0, graph.num_states
    dev = graph.device

    def tier(lo_deg, hi_deg):
        lists = [np.flatnonzero((deg[lo:hi] > lo_deg) & (deg[lo:hi] <= hi_deg))
                 for lo, hi in zip(bounds[:-1], bounds[1:])]
        ptr = np.cumsum([0] + [x.size for x in lists])
        return (torch.as_tensor(ptr, dtype=torch.int32, device=dev),
                torch.as_tensor(np.concatenate(lists), dtype=torch.int32, device=dev))

    group_ptr, group_state = tier(THREAD_DEG, GROUP_DEG)
    hub_ptr, hub_state = tier(GROUP_DEG, np.inf)
    plan = ViterbiPlan(
        cluster=cluster,
        tables=tables,
        max_states=int(np.diff(bounds).max()),
        max_arcs=int(np.diff(in_ptr[bounds]).max()),
        slice_state=torch.as_tensor(bounds, dtype=torch.int32, device=dev),
        group_ptr=group_ptr,
        group_state=group_state,
        hub_ptr=hub_ptr,
        hub_state=hub_state,
    )
    graph.kernel_cache[key] = plan
    return plan


def _align(n: int) -> int:
    return (n + 15) & ~15


def smem_layout(
    num_states: int, plan: ViterbiPlan, folded: bool, resident: bool
) -> Tuple[Dict[str, int], int]:
    """Byte offsets of the kernel's dynamic shared memory and its size:
    alpha's two buffers (the kernel reuses them for the backtrace's arc
    sources) and, when the tables are ``resident``, the largest slice's
    CSR."""
    sizes = [("alpha0", 4 * num_states), ("alpha1", 4 * num_states)]
    if resident:
        sizes += [
            ("ptr", 4 * (plan.max_states + 1)),
            ("sw", 8 * plan.max_arcs),
            ("arc", 0 if plan.tables.compact else 4 * plan.max_arcs),
            ("spdf", 2 * plan.max_states if folded else 0),
        ]
    off, at = {}, 0
    for name, size in sizes:
        off[name] = at
        at = _align(at + size)
    for name in ("ptr", "sw", "arc", "spdf"):
        off.setdefault(name, 0)
    return off, at


def alpha_fits(num_states: int, max_smem: int) -> bool:
    """Whether alpha's two buffers fit the ``max_smem`` bytes of shared
    memory a block may use: the kernel's reach."""
    return 2 * _align(4 * num_states) <= max_smem


def max_alpha_states(max_smem: int) -> int:
    """The most states ``alpha_fits`` accepts for ``max_smem`` bytes."""
    return ((max_smem // 2) & ~15) // 4


def kernel_states(device: torch.device) -> Optional[int]:
    """The largest graph (states) the kernel decodes on ``device``'s card,
    or None for the CPU, where the plain twin decodes any graph. The kernel
    raises past it; ``pipeline.transcribe.select_decoder`` takes this number
    and names another decoder (``"scan"``) for a larger graph."""
    if device.type != "cuda":
        return None
    return max_alpha_states(_lib().rss_viterbi_max_smem(device.index))


def choose_cluster(
    graph: DecodeGraph,
    batch: int,
    max_smem: int,
    max_clusters: Callable[[ViterbiPlan, bool], int],
) -> Tuple[ViterbiPlan, bool]:
    """(plan, resident) for a call, ``resident`` when the slice tables
    live in shared memory. Candidates: the smallest cluster whose tables
    fit beside alpha, and the larger ones whose tables fit and whose slices
    keep ``MIN_SLICE_STATES`` states. Of those, the one that runs the batch
    in the fewest waves (``max_clusters``: clusters of a plan the card runs
    at once), the largest on a tie. Where no cluster's tables fit: C = 8,
    tables in global memory. Raises where alpha itself cannot fit."""
    if not alpha_fits(graph.num_states, max_smem):
        raise ValueError(
            f"viterbi kernel keeps alpha in shared memory: {graph.num_states} states "
            f"exceed the {max_smem} bytes this card holds ({max_alpha_states(max_smem)} "
            f"states; select_decoder's \"scan\" mode decodes such a graph)"
        )
    plans = [plan_viterbi(graph, c) for c in CLUSTER_SIZES]
    plans = [p for p in plans if p.max_states <= MAX_SLICE_STATES]
    if not plans:
        raise ValueError(f"viterbi kernel: no slice of <= {MAX_SLICE_STATES} states")
    fits = [p for p in plans if smem_layout(graph.num_states, p, graph.folded, True)[1] <= max_smem]
    if not fits:
        return plans[-1], False
    fits = fits[:1] + [p for p in fits[1:] if p.max_states >= MIN_SLICE_STATES]

    def waves(p: ViterbiPlan) -> int:
        n = max_clusters(p, True)
        return -(-batch // n) if n > 0 else 1 << 30

    return min(fits, key=lambda p: (waves(p), -p.cluster)), True


def max_clusters(graph: DecodeGraph, plan: ViterbiPlan, resident: bool) -> int:
    """Clusters of ``plan`` the graph's card runs at once."""
    return _lib().rss_viterbi_max_clusters(
        int(graph.folded), int(plan.tables.compact), plan.cluster, _threads(plan),
        smem_layout(graph.num_states, plan, graph.folded, resident)[1], graph.device.index,
    )


def select_plan(graph: DecodeGraph, batch: int) -> Tuple[ViterbiPlan, bool]:
    """``choose_cluster`` with the limits of the graph's card, once per
    graph and batch size."""
    key = ("viterbi", "batch", batch)
    chosen = graph.kernel_cache.get(key)
    if chosen is None:
        chosen = choose_cluster(
            graph, batch, _lib().rss_viterbi_max_smem(graph.device.index),
            lambda p, resident: max_clusters(graph, p, resident),
        )
        graph.kernel_cache[key] = chosen
    return chosen


def _threads(plan: ViterbiPlan) -> int:
    """A thread per state of the largest slice, up to MAX_THREADS (then up
    to four states a thread)."""
    return max(64, min(MAX_THREADS, -(-plan.max_states // 32) * 32))


def launch(
    graph: DecodeGraph,
    plan: ViterbiPlan,
    resident: bool,
    log_probs: torch.Tensor,
    acoustic_scale: float,
    lengths: torch.Tensor,
    alpha0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """One kernel launch with a given plan: (trace, final_state,
    total_cost, alpha, bps). ``alpha0`` [B, S] f32 contiguous starts the
    streams from a carried alpha. ``viterbi_decode`` checks the inputs."""
    B, T, P = log_probs.shape
    S, A = graph.num_states, graph.num_arcs
    dev = log_probs.device
    off, smem = smem_layout(S, plan, graph.folded, resident)
    tab = plan.tables
    bps = torch.empty((T, B, S), dtype=torch.uint16 if tab.compact else torch.int32, device=dev)
    alpha = torch.empty((B, S), dtype=torch.float32, device=dev)
    trace = torch.empty((B, T), dtype=torch.int32, device=dev)
    final_state = torch.empty((B,), dtype=torch.int32, device=dev)
    total_cost = torch.empty((B,), dtype=torch.float32, device=dev)
    if B:
        lib = _lib()
        err = lib.rss_viterbi_launch(
            log_probs.data_ptr(), lengths.data_ptr(),
            graph.init_weight.data_ptr(),
            None if alpha0 is None else alpha0.data_ptr(), graph.final_weight.data_ptr(),
            graph.in_ptr.data_ptr(), tab.in_sw.data_ptr(), graph.in_arc.data_ptr(),
            graph.in_pdf.data_ptr(), tab.src_pdf.data_ptr(),
            tab.arc_src.data_ptr(), plan.slice_state.data_ptr(), plan.group_ptr.data_ptr(),
            plan.group_state.data_ptr(), plan.hub_ptr.data_ptr(), plan.hub_state.data_ptr(),
            THREAD_DEG, -acoustic_scale, B, T, P, S, A, int(graph.folded), int(tab.compact),
            off["alpha1"], off["ptr"], off["sw"], off["arc"], off["spdf"], int(resident), smem,
            bps.data_ptr(), alpha.data_ptr(), trace.data_ptr(),
            final_state.data_ptr(), total_cost.data_ptr(),
            plan.cluster, _threads(plan), dev.index,
            torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check(lib, err, "viterbi kernel launch")
        viterbi_decode.launches += 1
    return trace, final_state, total_cost, alpha, bps


def viterbi_decode(
    graph: DecodeGraph,
    log_probs: torch.Tensor,
    acoustic_scale: float = 1.0,
    lengths: Optional[torch.Tensor] = None,
    return_forward: bool = False,
    alpha0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """Dense 1-best decode of [B, T, P] f32 log-probs.

    ``alpha0`` [B, S] f32 starts each stream from a carried alpha instead of
    the graph's initial weights: a stream's chunk is one launch, and the
    alpha it returns (``return_forward``) is the next chunk's ``alpha0``.

    Returns (arc_trace [B, T] int32, final_state [B] int32, total_cost [B]
    f32), bit-identical to ``ops.decoder.viterbi_decode``; with
    ``return_forward`` also (alpha_final [B, S] f32, bps [T, B, S]) as
    ``ops.decoder.viterbi`` gives them (uint16 ``arc + 2`` when the graph
    has <= 65533 arcs, else int32)."""
    dev = log_probs.device
    if dev.type == "cpu":
        compact = graph.num_arcs <= _COMPACT_BP_MAX_ARC
        alpha, bps = viterbi(
            graph, log_probs, acoustic_scale, lengths, compact_bp=compact, alpha0=alpha0
        )
        out = backtrace(graph, alpha, bps)
        return out + (alpha, bps) if return_forward else out
    if dev.type != "cuda":
        raise ValueError(f"viterbi_decode: unsupported device {dev}")
    if graph.device != dev:
        raise ValueError(f"viterbi_decode: graph on {graph.device}, log-probs on {dev}")
    if log_probs.dim() != 3 or log_probs.dtype != torch.float32:
        raise ValueError("viterbi_decode: log_probs must be [B, T, P] float32")
    B, T, P = log_probs.shape
    if graph.max_pdf >= P:
        raise ValueError(f"viterbi_decode: graph reads pdf {graph.max_pdf}, log-probs have {P}")
    plan, resident = select_plan(graph, B)
    if lengths is None:
        lengths = torch.full((B,), T, dtype=torch.int32, device=dev)
    lengths = lengths.to(device=dev, dtype=torch.int32).contiguous()
    log_probs = log_probs.contiguous()
    if alpha0 is not None:
        if alpha0.shape != (B, graph.num_states) or alpha0.dtype != torch.float32:
            raise ValueError(f"viterbi_decode: alpha0 must be [{B}, {graph.num_states}] float32")
        if alpha0.device != dev:
            raise ValueError(f"viterbi_decode: alpha0 on {alpha0.device}, log-probs on {dev}")
        alpha0 = alpha0.contiguous()
    out = launch(graph, plan, resident, log_probs, acoustic_scale, lengths, alpha0)
    return out if return_forward else out[:3]


viterbi_decode.launches = 0
