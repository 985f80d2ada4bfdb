"""Viterbi decode kernel wrapper (``csrc/viterbi.cu``, ``csrc/viterbi_large.cu``):
the port of the TPU kernel ``rhasspy_speech_tpu/ops/pallas_decoder.py:viterbi_pallas``.

``viterbi_decode`` launches the kernel for log-probs on a CUDA device and
runs the plain twin (``ops.decoder.viterbi`` + ``backtrace``) for log-probs
on the CPU; it never falls back from one to the other.
``viterbi_decode.launches`` counts kernel launches of every body,
``viterbi_decode.body_launches`` each body's.

The kernel decodes each stream with a cluster of C CTAs, each owning a
slice of destination states, in one of three bodies chosen by the graph's
size (``choose_body``), none of which raises for size:

- replicated (``csrc/viterbi.cu``): every CTA keeps the whole alpha in
  shared memory, so it holds up to ~29,000 states on an H100
  (``alpha_fits``). ``plan_viterbi`` cuts the graph into C slices once per
  graph and C (cached on the ``DecodeGraph``); ``smem_layout`` places alpha
  and a slice's tables; ``choose_cluster`` picks C from the graph's bytes
  and the batch.
- halo (``csrc/viterbi_large.cu``): a CTA keeps only its slice and the
  sources its in-arcs read from other slices (``plan_halo``), so it holds
  about C x 29,000 states less the halos, C up to 16 where the card runs
  such a cluster; ``large_smem_layout`` places it.
- global (``csrc/viterbi_large.cu``): alpha in a [2, B, S] scratch in
  device memory (``plan_global``), for a graph no halo plan holds.

``select_plan`` runs the choice once per graph and batch size with the
card's limits. The plans and layouts are plain Python, so the CPU tests
reach them. ``viterbi_decode_checkpointed`` is the memory-bounded decode
through the same kernel: one launch per segment forward and back.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple, Union

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

    @property
    def body(self) -> str:
        return "replicated"


def _u16(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(a.astype(np.uint16).view(np.int16), device=device)


def _checked_src_pdf(graph: DecodeGraph) -> np.ndarray:
    """The graph's per-state pdf (zeros without the fold), after checking
    what every body assumes: each state's in-arcs in ascending arc id, pdf
    ids within uint16."""
    S = graph.num_states
    in_ptr = graph.in_ptr.cpu().numpy().astype(np.int64)
    in_arc = graph.in_arc.cpu().numpy().astype(np.int64)
    dst = np.repeat(np.arange(S), np.diff(in_ptr))
    if graph.num_arcs and not (np.diff(in_arc)[dst[1:] == dst[:-1]] > 0).all():
        raise ValueError("viterbi kernel needs each state's in-arcs in ascending arc id")
    src_pdf = np.zeros(S, np.int64) if graph.src_pdf is None else graph.src_pdf.cpu().numpy()
    if src_pdf.size and src_pdf.max() >= 1 << 16:
        raise ValueError("viterbi kernel keeps src_pdf as uint16: pdf id >= 65536")
    return src_pdf


def _tables(graph: DecodeGraph) -> ViterbiTables:
    tables = graph.kernel_cache.get("viterbi")
    if tables is not None:
        return tables
    S, A = graph.num_states, graph.num_arcs
    if S > 1 << 16:
        raise ValueError(f"viterbi kernel keeps source states as uint16: {S} states")
    src_pdf = _checked_src_pdf(graph)
    compact = A <= _COMPACT_BP_MAX_ARC
    dev = graph.device
    word = graph.in_src.cpu().numpy().astype(np.int64)
    if compact:
        word = word | (graph.in_arc.cpu().numpy().astype(np.int64) << 16)
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


def _cut(graph: DecodeGraph, cluster: int) -> Dict[str, np.ndarray]:
    """Slice bounds for ``cluster`` CTAs, balanced by arcs + states, and
    each slice's lane-group tiers (slice-local indices): the part of a plan
    every body shares."""
    in_ptr = graph.in_ptr.cpu().numpy().astype(np.int64)
    deg = np.diff(in_ptr)
    cum = np.concatenate([[0], np.cumsum(deg + 1)])
    bounds = np.searchsorted(cum, cum[-1] * np.arange(cluster + 1) / cluster, side="left")
    bounds[0], bounds[-1] = 0, graph.num_states

    def tier(lo_deg, hi_deg):
        lists = [np.flatnonzero((deg[lo:hi] > lo_deg) & (deg[lo:hi] <= hi_deg))
                 for lo, hi in zip(bounds[:-1], bounds[1:])]
        return np.cumsum([0] + [x.size for x in lists]), np.concatenate(lists)

    group_ptr, group_state = tier(THREAD_DEG, GROUP_DEG)
    hub_ptr, hub_state = tier(GROUP_DEG, np.inf)
    return dict(bounds=bounds, in_ptr=in_ptr, group_ptr=group_ptr, group_state=group_state,
                hub_ptr=hub_ptr, hub_state=hub_state)


def _i32(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int32, device=device)


def _cut_fields(cut: Dict[str, np.ndarray], device: torch.device) -> Dict:
    """The plan fields of a cut, as the kernels read them."""
    bounds, in_ptr = cut["bounds"], cut["in_ptr"]
    return dict(
        max_states=int(np.diff(bounds).max()),
        max_arcs=int(np.diff(in_ptr[bounds]).max()),
        slice_state=_i32(bounds, device),
        group_ptr=_i32(cut["group_ptr"], device),
        group_state=_i32(cut["group_state"], device),
        hub_ptr=_i32(cut["hub_ptr"], device),
        hub_state=_i32(cut["hub_state"], device),
    )


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
    plan = ViterbiPlan(cluster=cluster, tables=tables,
                       **_cut_fields(_cut(graph, cluster), graph.device))
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
            f"the replicated body keeps alpha in shared memory: {graph.num_states} states "
            f"exceed the {max_smem} bytes this card holds ({max_alpha_states(max_smem)} "
            f"states; choose_body takes the halo or global body for such a graph)"
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


# ---------------------------------------------------------------------------
# The large-graph bodies (csrc/viterbi_large.cu): halo and global
# ---------------------------------------------------------------------------

# Cluster sizes of the large bodies; 16 is past the portable 8 and runs only
# where the card's GPCs schedule it (max_clusters says so).
LARGE_CLUSTER_SIZES = (2, 4, 8, 16)
# A halo body's local index space [own slice, halo] as uint16 sources
MAX_LOCAL_STATES = 1 << 16


def _lib_large() -> ctypes.CDLL:
    lib = _build.load("viterbi_large")
    if lib.rss_viterbi_large_launch.argtypes is None:
        lib.rss_viterbi_large_launch.argtypes = [ctypes.POINTER(_LargeArgs)] + [_I] * 6 + [_P]
        lib.rss_viterbi_large_launch.restype = _I
        lib.rss_viterbi_large_max_smem.argtypes = [_I]
        lib.rss_viterbi_large_max_smem.restype = _I
        lib.rss_viterbi_large_max_clusters.argtypes = [_I] * 7
        lib.rss_viterbi_large_max_clusters.restype = _I
        lib.rss_viterbi_large_args_size.restype = _I
        if lib.rss_viterbi_large_args_size() != ctypes.sizeof(_LargeArgs):
            raise RuntimeError("viterbi_large: the C Args and the wrapper's _LargeArgs differ")
    return lib


class _LargeArgs(ctypes.Structure):
    """``Args`` of csrc/viterbi_large.cu, field for field."""

    _fields_ = [(name, _P) for name in (
        "lp", "lengths", "init_w", "alpha0", "final_w", "in_ptr", "in_sw", "in_arc", "in_pdf",
        "src_pdf", "arc_src", "slice_state", "halo_ptr", "push_ptr", "push_ent", "group_ptr",
        "group_state", "hub_ptr", "hub_state", "scratch", "bps", "alpha_out", "arc_trace",
        "final_state", "total_cost")] + [
        ("thread_deg", _I), ("neg_scale", _F), ("B", _I), ("T", _I), ("P", _I), ("S", _I),
        ("A", _I)] + [(name, _I) for name in (
            "off_alpha1", "off_ptr", "off_sw", "off_spdf", "off_pptr", "off_pent", "smem_bytes",
            "resident")]


@dataclass(frozen=True)
class LargeTables:
    """What both large bodies read per graph besides its CSR: ``src_pdf``
    as uint16 bits (zeros without the fold), ``arc_src`` int32 by arc id
    (sources may pass 65,535)."""

    compact: bool
    src_pdf: torch.Tensor  # uint16 bits [S]
    arc_src: torch.Tensor  # int32 [A]


def _large_tables(graph: DecodeGraph) -> LargeTables:
    tables = graph.kernel_cache.get("viterbi_large")
    if tables is not None:
        return tables
    dev = graph.device
    tables = LargeTables(
        compact=graph.num_arcs <= _COMPACT_BP_MAX_ARC,
        src_pdf=_u16(_checked_src_pdf(graph), dev),
        arc_src=_i32(graph.arc_src.cpu().numpy(), dev),
    )
    graph.kernel_cache["viterbi_large"] = tables
    return tables


@dataclass(frozen=True)
class HaloPlan:
    """The halo body's cut: ``ViterbiPlan``'s slices and tiers, and for
    each CTA r its halo ``halo_state[halo_ptr[r]:halo_ptr[r + 1]]`` (the
    ascending global ids of the sources of its slice's in-arcs that other
    CTAs own). CTA r's local index space is [own slice, halo]: own state
    s_lo + i is local i, halo entry k is local ns_r + k. ``in_sw`` holds
    each in-arc's source in its CTA's local space (low 16 bits), its arc id
    (high 16 bits, compact graphs) and its weight. State s's push list
    ``push_ent[push_ptr[s]:push_ptr[s + 1]]`` holds ``q << 16 | offset``
    for every CTA q whose halo holds s, ascending in q: exactly the inverse
    of the halos."""

    cluster: int
    tables: LargeTables
    max_states: int
    max_arcs: int
    max_local: int  # largest [own slice, halo] space
    max_push: int  # most push entries of one slice's states
    slice_state: torch.Tensor  # int32 [C + 1]
    group_ptr: torch.Tensor
    group_state: torch.Tensor
    hub_ptr: torch.Tensor
    hub_state: torch.Tensor
    halo_ptr: torch.Tensor  # int32 [C + 1]
    halo_state: torch.Tensor  # int32 [sum of halos]
    in_sw: torch.Tensor  # int32 [A, 2], CSR order
    push_ptr: torch.Tensor  # int32 [S + 1]
    push_ent: torch.Tensor  # int32 [E]

    @property
    def body(self) -> str:
        return "halo"


@dataclass(frozen=True)
class GlobalPlan:
    """The global body's cut: slices and tiers; alpha lives in a [2, B, S]
    scratch in device memory, and ``in_sw`` packs each in-arc's global
    source and weight."""

    cluster: int
    tables: LargeTables
    in_sw: torch.Tensor  # int32 [A, 2], CSR order
    max_states: int
    max_arcs: int
    slice_state: torch.Tensor
    group_ptr: torch.Tensor
    group_state: torch.Tensor
    hub_ptr: torch.Tensor
    hub_state: torch.Tensor

    @property
    def body(self) -> str:
        return "global"


Plan = Union[ViterbiPlan, HaloPlan, GlobalPlan]


def _halos(graph: DecodeGraph, bounds: np.ndarray) -> Tuple[List[np.ndarray], np.ndarray]:
    """Each CTA's halo (ascending global ids) and every in-arc's source in
    its CTA's local space (CSR order)."""
    in_ptr = graph.in_ptr.cpu().numpy().astype(np.int64)
    in_src = graph.in_src.cpu().numpy().astype(np.int64)
    local = np.empty_like(in_src)
    halos = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        j0, j1 = in_ptr[lo], in_ptr[hi]
        src = in_src[j0:j1]
        own = (src >= lo) & (src < hi)
        halo = np.unique(src[~own])
        local[j0:j1] = np.where(own, src - lo, (hi - lo) + np.searchsorted(halo, src))
        halos.append(halo)
    return halos, local


def plan_halo(graph: DecodeGraph, cluster: int) -> HaloPlan:
    """The halo body's cut for clusters of ``cluster`` CTAs, once per graph
    and cluster size. Raises where a CTA's local space passes uint16."""
    key = ("viterbi", "halo", cluster)
    plan = graph.kernel_cache.get(key)
    if plan is not None:
        return plan
    if cluster not in LARGE_CLUSTER_SIZES:
        raise ValueError(f"cluster size {cluster} not in {LARGE_CLUSTER_SIZES}")
    tables = _large_tables(graph)
    cut = _cut(graph, cluster)
    bounds, S = cut["bounds"], graph.num_states
    halos, local = _halos(graph, bounds)
    sizes = np.diff(bounds) + np.asarray([h.size for h in halos])
    if sizes.max() > MAX_LOCAL_STATES:
        raise ValueError(f"halo body: a CTA's local space of {sizes.max()} states passes uint16")
    word = local
    if tables.compact:
        word = word | (graph.in_arc.cpu().numpy().astype(np.int64) << 16)
    in_sw = np.stack([word.astype(np.uint32).view(np.int32),
                      graph.in_weight.cpu().numpy().view(np.int32)], axis=1)
    # push lists: halo entry k of CTA q is state halos[q][k] at local offset
    # ns_q + k; sorted by state, then CTA
    state = np.concatenate(halos).astype(np.int64)
    cta = np.repeat(np.arange(cluster), [h.size for h in halos])
    offset = np.concatenate([np.diff(bounds)[q] + np.arange(h.size) for q, h in enumerate(halos)])
    order = np.lexsort((cta, state))
    push_ent = ((cta << 16) | offset)[order]
    push_ptr = np.concatenate([[0], np.cumsum(np.bincount(state, minlength=S))])
    dev = graph.device
    plan = HaloPlan(
        cluster=cluster,
        tables=tables,
        max_local=int(sizes.max()),
        max_push=int(np.diff(push_ptr[bounds]).max()),
        halo_ptr=_i32(np.cumsum([0] + [h.size for h in halos]), dev),
        halo_state=_i32(state, dev),
        in_sw=_i32(in_sw, dev),
        push_ptr=_i32(push_ptr, dev),
        push_ent=_i32(push_ent, dev),
        **_cut_fields(cut, dev),
    )
    graph.kernel_cache[key] = plan
    return plan


def plan_global(graph: DecodeGraph, cluster: int) -> GlobalPlan:
    """The global body's cut for clusters of ``cluster`` CTAs, once per
    graph and cluster size."""
    key = ("viterbi", "global", cluster)
    plan = graph.kernel_cache.get(key)
    if plan is None:
        if cluster not in LARGE_CLUSTER_SIZES:
            raise ValueError(f"cluster size {cluster} not in {LARGE_CLUSTER_SIZES}")
        in_sw = np.stack([graph.in_src.cpu().numpy().astype(np.int32),
                          graph.in_weight.cpu().numpy().view(np.int32)], axis=1)
        plan = GlobalPlan(cluster=cluster, tables=_large_tables(graph),
                          in_sw=_i32(in_sw, graph.device),
                          **_cut_fields(_cut(graph, cluster), graph.device))
        graph.kernel_cache[key] = plan
    return plan


def large_smem_layout(plan: Plan, folded: bool, resident: bool) -> Tuple[Dict[str, int], int]:
    """Byte offsets of a large body's dynamic shared memory and its size:
    the halo body's two local alpha buffers (reused for the backtrace's arc
    sources) and, when ``resident``, the largest slice's row pointers,
    packed sources and weights, src_pdf and push lists. The global body
    keeps alpha and its tables in device memory."""
    names = ("alpha1", "ptr", "sw", "spdf", "pptr", "pent")
    if plan.body == "global":
        return dict.fromkeys(names, 0), 0
    sizes = [("alpha0", 4 * plan.max_local), ("alpha1", 4 * plan.max_local)]
    if resident:
        sizes += [
            ("ptr", 4 * (plan.max_states + 1)),
            ("sw", 8 * plan.max_arcs),
            ("spdf", 2 * plan.max_states if folded else 0),
            ("pptr", 4 * (plan.max_states + 1)),
            ("pent", 4 * plan.max_push),
        ]
    off, at = {}, 0
    for name, size in sizes:
        off[name] = at
        at = _align(at + size)
    for name in names:
        off.setdefault(name, 0)
    return off, at


def choose_large(
    graph: DecodeGraph,
    batch: int,
    max_smem: int,
    max_clusters: Callable[[Plan, bool], int],
) -> Tuple[Plan, bool]:
    """(plan, resident) for a graph past the replicated body's reach.
    Candidates: the halo plans whose two local alpha buffers fit
    ``max_smem`` and of which the card runs a cluster (``max_clusters``).
    Those whose tables also fit come first; of them, the one that runs the
    batch in the fewest waves, the largest on a tie. Where no halo plan
    fits: the global body at the largest cluster the card runs."""
    limit = max_alpha_states(max_smem)
    cands = []
    for c in LARGE_CLUSTER_SIZES:
        if graph.num_states > c * limit:  # some slice holds more than alpha fits
            continue
        try:
            plan = plan_halo(graph, c)
        except ValueError:  # a local space past uint16: far past what alpha fits
            continue
        if not alpha_fits(plan.max_local, max_smem):
            continue
        resident = large_smem_layout(plan, graph.folded, True)[1] <= max_smem
        n = max_clusters(plan, resident)
        if n > 0:
            cands.append((not resident, -(-batch // n), -c, plan, resident))
    if cands:
        return min(cands, key=lambda x: x[:3])[3:]
    for c in reversed(LARGE_CLUSTER_SIZES):
        plan = plan_global(graph, c)
        if max_clusters(plan, False) > 0:
            return plan, False
    raise ValueError("viterbi kernel: the card runs no cluster of the global body")


def choose_body(
    graph: DecodeGraph,
    batch: int,
    max_smem: int,
    max_clusters: Callable[[Plan, bool], int],
) -> Tuple[Plan, bool]:
    """(plan, resident) for a call: the replicated body (``choose_cluster``)
    where alpha fits ``max_smem``, else the halo or global body
    (``choose_large``). Never raises for size."""
    if alpha_fits(graph.num_states, max_smem):
        return choose_cluster(graph, batch, max_smem, max_clusters)
    return choose_large(graph, batch, max_smem, max_clusters)


def libraries(num_states: int) -> List[str]:
    """The kernel library a decode of a graph of ``num_states`` loads on an
    H100 (the replicated body's, or the large bodies')."""
    return ["viterbi" if alpha_fits(num_states, H100_MAX_SMEM) else "viterbi_large"]


def max_clusters(graph: DecodeGraph, plan: Plan, resident: bool) -> int:
    """Clusters of ``plan`` the graph's card runs at once."""
    if plan.body == "replicated":
        return _lib().rss_viterbi_max_clusters(
            int(graph.folded), int(plan.tables.compact), plan.cluster, _threads(plan),
            smem_layout(graph.num_states, plan, graph.folded, resident)[1], graph.device.index,
        )
    return _lib_large().rss_viterbi_large_max_clusters(
        int(graph.folded), int(plan.tables.compact), int(plan.body == "global"), plan.cluster,
        _threads(plan), large_smem_layout(plan, graph.folded, resident)[1], graph.device.index,
    )


def card_smem(device: torch.device, num_states: int) -> int:
    """Dynamic shared memory a block of the body for ``num_states`` may use
    on ``device``'s card (the replicated body's where it holds the graph)."""
    if alpha_fits(num_states, H100_MAX_SMEM):
        return _lib().rss_viterbi_max_smem(device.index)
    return _lib_large().rss_viterbi_large_max_smem(device.index)


def select_plan(graph: DecodeGraph, batch: int) -> Tuple[Plan, bool]:
    """``choose_body`` with the limits of the graph's card, once per graph
    and batch size."""
    key = ("viterbi", "batch", batch)
    chosen = graph.kernel_cache.get(key)
    if chosen is None:
        chosen = choose_body(
            graph, batch, card_smem(graph.device, graph.num_states),
            lambda p, resident: max_clusters(graph, p, resident),
        )
        graph.kernel_cache[key] = chosen
    return chosen


def kernel_scratch_bytes(graph: DecodeGraph) -> int:
    """Device memory a stream of a decode holds besides its backpointers
    and alpha: the global body's [2, S] f32 alpha scratch (0 for the other
    bodies and on the CPU). ``select_decoder`` counts it in its budget."""
    if graph.device.type != "cuda":
        return 0
    return 8 * graph.num_states if select_plan(graph, 1)[0].body == "global" else 0


def _threads(plan: Plan) -> int:
    """A thread per state of the largest slice, up to MAX_THREADS (then the
    replicated body takes up to four states a thread, the large bodies as
    many as the slice needs)."""
    return max(64, min(MAX_THREADS, -(-plan.max_states // 32) * 32))


def _launch_large(
    graph: DecodeGraph,
    plan: Plan,
    resident: bool,
    log_probs: torch.Tensor,
    acoustic_scale: float,
    lengths: torch.Tensor,
    alpha0: Optional[torch.Tensor],
    out: Tuple[torch.Tensor, ...],
) -> None:
    """One launch of the halo or global body into ``out`` (trace,
    final_state, total_cost, alpha, bps)."""
    B, T, P = log_probs.shape
    S = graph.num_states
    dev = log_probs.device
    off, smem = large_smem_layout(plan, graph.folded, resident)
    halo = plan.body == "halo"
    scratch = None if halo else torch.empty((2, B, S), dtype=torch.float32, device=dev)
    trace, final_state, total_cost, alpha, bps = out

    def ptr(t):
        return None if t is None else t.data_ptr()

    args = _LargeArgs(
        lp=log_probs.data_ptr(), lengths=lengths.data_ptr(), init_w=graph.init_weight.data_ptr(),
        alpha0=ptr(alpha0), final_w=graph.final_weight.data_ptr(), in_ptr=graph.in_ptr.data_ptr(),
        in_sw=plan.in_sw.data_ptr(),
        in_arc=graph.in_arc.data_ptr(), in_pdf=graph.in_pdf.data_ptr(),
        src_pdf=plan.tables.src_pdf.data_ptr(), arc_src=plan.tables.arc_src.data_ptr(),
        slice_state=plan.slice_state.data_ptr(),
        halo_ptr=ptr(plan.halo_ptr) if halo else None,
        push_ptr=ptr(plan.push_ptr) if halo else None,
        push_ent=ptr(plan.push_ent) if halo else None,
        group_ptr=plan.group_ptr.data_ptr(), group_state=plan.group_state.data_ptr(),
        hub_ptr=plan.hub_ptr.data_ptr(), hub_state=plan.hub_state.data_ptr(),
        scratch=ptr(scratch), bps=bps.data_ptr(), alpha_out=alpha.data_ptr(),
        arc_trace=trace.data_ptr(), final_state=final_state.data_ptr(),
        total_cost=total_cost.data_ptr(), thread_deg=THREAD_DEG, neg_scale=-acoustic_scale,
        B=B, T=T, P=P, S=S, A=graph.num_arcs,
        off_alpha1=off["alpha1"], off_ptr=off["ptr"], off_sw=off["sw"], off_spdf=off["spdf"],
        off_pptr=off["pptr"], off_pent=off["pent"], smem_bytes=smem, resident=int(resident),
    )
    lib = _lib_large()
    err = lib.rss_viterbi_large_launch(
        ctypes.byref(args), int(graph.folded), int(plan.tables.compact), int(not halo),
        plan.cluster, _threads(plan), dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, err, f"viterbi kernel launch ({plan.body} body)")


def launch(
    graph: DecodeGraph,
    plan: Plan,
    resident: bool,
    log_probs: torch.Tensor,
    acoustic_scale: float,
    lengths: torch.Tensor,
    alpha0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """One kernel launch with a given plan, of the body the plan names:
    (trace, final_state, total_cost, alpha, bps). ``alpha0`` [B, S] f32
    contiguous starts the streams from a carried alpha. ``viterbi_decode``
    checks the inputs."""
    B, T, P = log_probs.shape
    S, A = graph.num_states, graph.num_arcs
    dev = log_probs.device
    tab = plan.tables
    bps = torch.empty((T, B, S), dtype=torch.uint16 if tab.compact else torch.int32, device=dev)
    alpha = torch.empty((B, S), dtype=torch.float32, device=dev)
    trace = torch.empty((B, T), dtype=torch.int32, device=dev)
    final_state = torch.empty((B,), dtype=torch.int32, device=dev)
    total_cost = torch.empty((B,), dtype=torch.float32, device=dev)
    out = (trace, final_state, total_cost, alpha, bps)
    if not B:
        return out
    if plan.body != "replicated":
        _launch_large(graph, plan, resident, log_probs, acoustic_scale, lengths, alpha0, out)
    else:
        off, smem = smem_layout(S, plan, graph.folded, resident)
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
    viterbi_decode.body_launches[plan.body] += 1
    return out


def _check_inputs(
    graph: DecodeGraph, log_probs: torch.Tensor, lengths: Optional[torch.Tensor],
    alpha0: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """The kernel's inputs checked and made contiguous int32 / f32 on the
    card: (log_probs, lengths, alpha0)."""
    dev = log_probs.device
    if dev.type != "cuda":
        raise ValueError(f"viterbi_decode: unsupported device {dev}")
    if graph.device != dev:
        raise ValueError(f"viterbi_decode: graph on {graph.device}, log-probs on {dev}")
    if log_probs.dim() != 3 or log_probs.dtype != torch.float32:
        raise ValueError("viterbi_decode: log_probs must be [B, T, P] float32")
    B, T, P = log_probs.shape
    if graph.max_pdf >= P:
        raise ValueError(f"viterbi_decode: graph reads pdf {graph.max_pdf}, log-probs have {P}")
    if lengths is None:
        lengths = torch.full((B,), T, dtype=torch.int32, device=dev)
    lengths = lengths.to(device=dev, dtype=torch.int32).contiguous()
    if alpha0 is not None:
        if alpha0.shape != (B, graph.num_states) or alpha0.dtype != torch.float32:
            raise ValueError(f"viterbi_decode: alpha0 must be [{B}, {graph.num_states}] float32")
        if alpha0.device != dev:
            raise ValueError(f"viterbi_decode: alpha0 on {alpha0.device}, log-probs on {dev}")
        alpha0 = alpha0.contiguous()
    return log_probs.contiguous(), lengths, alpha0


def viterbi_decode(
    graph: DecodeGraph,
    log_probs: torch.Tensor,
    acoustic_scale: float = 1.0,
    lengths: Optional[torch.Tensor] = None,
    return_forward: bool = False,
    alpha0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """Dense 1-best decode of [B, T, P] f32 log-probs.

    On a card the body follows the graph's size (``select_plan``):
    replicated up to ~29,000 states, halo up to about C x 29,000 less the
    halos, global beyond; none raises for size.

    ``alpha0`` [B, S] f32 starts each stream from a carried alpha instead of
    the graph's initial weights: a stream's chunk is one launch, and the
    alpha it returns (``return_forward``) is the next chunk's ``alpha0``.

    Returns (arc_trace [B, T] int32, final_state [B] int32, total_cost [B]
    f32), bit-identical to ``ops.decoder.viterbi_decode``; with
    ``return_forward`` also (alpha_final [B, S] f32, bps [T, B, S]) as
    ``ops.decoder.viterbi`` gives them (uint16 ``arc + 2`` when the graph
    has <= 65533 arcs, else int32)."""
    if log_probs.device.type == "cpu":
        compact = graph.num_arcs <= _COMPACT_BP_MAX_ARC
        alpha, bps = viterbi(
            graph, log_probs, acoustic_scale, lengths, compact_bp=compact, alpha0=alpha0
        )
        out = backtrace(graph, alpha, bps)
        return out + (alpha, bps) if return_forward else out
    log_probs, lengths, alpha0 = _check_inputs(graph, log_probs, lengths, alpha0)
    plan, resident = select_plan(graph, log_probs.shape[0])
    out = launch(graph, plan, resident, log_probs, acoustic_scale, lengths, alpha0)
    return out if return_forward else out[:3]


viterbi_decode.launches = 0
viterbi_decode.body_launches = {"replicated": 0, "halo": 0, "global": 0}


def viterbi_decode_checkpointed(
    graph: DecodeGraph,
    log_probs: torch.Tensor,
    acoustic_scale: float = 1.0,
    segment: int = 32,
    lengths: Optional[torch.Tensor] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Memory-bounded 1-best decode with ``ops.decoder.viterbi_decode_checkpointed``'s
    results (host arrays: arc_trace [B, T] int32, final_state [B] int32,
    total_cost [B] f32), segment by segment through ``viterbi_decode``: one
    kernel launch a segment on a card, the plain twin on the CPU.

    Forward: one decode per segment of ``segment`` frames from the
    segment's boundary alpha (``alpha0``; the graph's initial weights for the
    first), keeping only the boundary alphas ([ceil(T / segment), B, S]
    f32); the last segment's final state and cost are the decode's.
    Backward: each segment's backpointers recomputed by one decode from its
    boundary alpha, last segment first, and walked back from the carried
    state by gathers ([segment, B, S] backpointers at a time)."""
    B, T, _P = log_probs.shape
    dev = log_probs.device
    if lengths is None:
        lengths = torch.full((B,), T, dtype=torch.int32, device=dev)
    lengths = lengths.to(device=dev, dtype=torch.int32)
    spans = [(lo, min(lo + segment, T)) for lo in range(0, max(T, 1), segment)]

    def run(lo, hi, alpha0):
        seg_len = (lengths - lo).clamp(0, hi - lo).to(torch.int32)
        return viterbi_decode(graph, log_probs[:, lo:hi], acoustic_scale, seg_len,
                              return_forward=True, alpha0=alpha0)

    boundaries, alpha = [], None
    for lo, hi in spans:
        boundaries.append(alpha)
        _trace, final_state, total_cost, alpha, _bps = run(lo, hi, alpha)

    rows = torch.arange(B, device=dev)
    trace = torch.empty((B, T), dtype=torch.int32, device=dev)
    state = final_state.long()
    for (lo, hi), alpha0 in reversed(list(zip(spans, boundaries))):
        bps = run(lo, hi, alpha0)[4]
        compact = bps.dtype == torch.uint16
        if compact:  # gathered as int16 bits: uint16 has only copy support on some devices
            bps = bps.view(torch.int16)
        for t in range(hi - lo - 1, -1, -1):
            arc = bps[t][rows, state].to(torch.int64)
            if compact:
                arc = (arc & 0xFFFF) - 2
            trace[:, lo + t] = arc.to(torch.int32)
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
