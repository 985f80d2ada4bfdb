"""Windowed relaxation over 128-lane step tables: the port of the TPU kernel
in ``main()`` of ``examples/pallas_windowed_cost.py`` (the decode-relaxation
microbenchmark), as ``csrc/windowed_relax.cu``.

Per stream, alpha starts as ``alpha0`` (zeros by default). Each frame
starts every destination at ``(alpha + 0.5, arc id 0)`` and merges, for
every step ``i`` and lane ``j``, the candidate ``(alpha[sbase[i] +
idx[i, j]] + w[i, j], arc[i, j])`` into destination ``dbase[i] + j`` by
lexicographic minimum: a lower cost wins, and an equal cost with a lower
arc id. Then alpha becomes the merged costs and the frame's backpointer row
the merged arc ids as uint16. The merge is a lexicographic minimum, so the
order of the steps does not change the result; the plain version does one
frame as a gather and two ``scatter_reduce("amin")`` calls.

The TPU kernel also takes an ``am`` block that it never reads (its
``BlockSpec`` only copies it in); the port takes no ``am``.

Tables are shared by every stream (``dbase``/``sbase`` [NSTEP], ``idx``/
``w``/``arc`` [NSTEP, 128]) as in the example, or given per stream with a
leading batch dimension. ``dbase`` and ``sbase`` are multiples of 128
below ``s_pad``; ``idx`` lies in [0, 128) and ``arc`` in [0, 2^25).

``prepare_steps`` checks the tables and lays them out once as the kernel's
schedule (``build_schedule``): the destination blocks dealt to the
``GROUPS`` 128-thread groups of a CTA, each group's steps in a row, so that
round ``r`` of the schedule holds the step every group executes at the same
time and one contiguous copy stages it for all of them. ``windowed_relax``
then launches the kernel for tables on a CUDA device and runs
``windowed_relax_torch`` for tables on the CPU, and never falls back from
one to the other. Shared tables go to thread-block clusters of ``C`` CTAs,
one stream a CTA, that receive every stage of the schedule by one multicast
copy; ``choose_cluster`` picks ``C`` from the batch and the clusters the
card runs at once. ``windowed_relax.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

from . import _build

LANES = 128
GROUPS = 8  # 128-thread groups of a CTA (1024 threads)
IDX_BITS = 7
MAX_ARC = 1 << (32 - IDX_BITS)  # arc ids share a 32-bit word with idx
# A no-op step pads a group's row of the schedule: weight +inf and the
# largest packed word (the largest arc id, idx 127). Its cost is +inf (or
# NaN), never below a destination's; against a destination at +inf the tie
# goes to the lower word, and no word is above the no-op's, so it loses
# every comparison.
NOOP_WORD = -1  # int32 bits of ((MAX_ARC - 1) << 7) | 127
NOOP_WEIGHT = 0x7F800000  # f32 bits of +inf
# a round's flags beside 4 * dbase: first / last step of a destination block
FIRST, LAST = -(1 << 31), 1
ROUND_WORDS = GROUPS * LANES * 2 + GROUPS * 2  # candidates, then (4 sbase, 4 dbase | flags)
ROUND_BYTES = 4 * ROUND_WORDS
# Rounds one bulk copy stages, and the ring's slots. Every stage costs each
# warp a wait and an arrival, so stages are long; a slot is refilled two
# stages after it was read, and a deeper ring than that needs measured
# nothing (PERF.md, K3 sweep). At s_pad = 14,208 three stages fit.
ROUNDS_PER_STAGE = 4
MIN_STAGES = 3
MAX_STAGES = 4
CLUSTER_SIZES = (1, 2, 4, 8)
# Between cluster sizes that take a batch in equally many waves: the order
# of their measured times a wave at the example's shape, 2.65 ms at C = 4,
# 2.66 at 2, 2.85 at 1 (twice the L2 reads), 3.62 at 8 (eight arrivals a
# warp a stage) on an H100 (PERF.md, K3 sweep).
CLUSTER_PREFERENCE = (4, 2, 1, 8)

_P = ctypes.c_void_p
_I = ctypes.c_int


def _flat_tables(dbase, sbase, idx, w, arc):
    """(src [TB, N], dst [TB, N], w [TB, N], arc [TB, N]) with N = NSTEP *
    128 and TB = 1 for shared tables."""
    if dbase.dim() == 1:
        dbase, sbase, idx, w, arc = (x.unsqueeze(0) for x in (dbase, sbase, idx, w, arc))
    lanes = torch.arange(LANES, device=dbase.device)
    TB = dbase.shape[0]
    src = (sbase.to(torch.int64)[..., None] + idx.to(torch.int64)).reshape(TB, -1)
    dst = (dbase.to(torch.int64)[..., None] + lanes).reshape(TB, -1)
    return src, dst, w.reshape(TB, -1), arc.to(torch.int32).reshape(TB, -1)


def windowed_relax_torch(
    dbase: torch.Tensor,
    sbase: torch.Tensor,
    idx: torch.Tensor,
    w: torch.Tensor,
    arc: torch.Tensor,
    num_frames: int,
    batch: int,
    s_pad: int,
    alpha0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version. Returns (alpha [B, s_pad] f32, bp [T, B, s_pad]
    uint16)."""
    dev = dbase.device
    src, dst, wf, af = _flat_tables(dbase, sbase, idx, w, arc)
    B, N = batch, src.shape[1]
    src, dst, wf, af = (x.expand(B, N) for x in (src, dst, wf, af))
    big = torch.iinfo(torch.int32).max
    if alpha0 is None:
        alpha = torch.zeros((B, s_pad), dtype=torch.float32, device=dev)
    else:
        alpha = alpha0.to(device=dev, dtype=torch.float32).reshape(B, s_pad)
    bp = torch.empty((num_frames, B, s_pad), dtype=torch.uint16, device=dev)
    for t in range(num_frames):
        cand = torch.gather(alpha, 1, src) + wf
        start = alpha + 0.5
        bc = start.scatter_reduce(1, dst, cand, "amin")
        won = torch.where(cand == torch.gather(bc, 1, dst), af, big)
        bi = torch.where(start == bc, 0, big).to(torch.int32).scatter_reduce(1, dst, won, "amin")
        alpha = bc
        bp[t] = (bi & 0xFFFF).to(torch.uint16)
    return alpha, bp


def _lib() -> ctypes.CDLL:
    lib = _build.load("windowed_relax")
    if lib.rss_windowed_relax_launch.argtypes is None:
        lib.rss_windowed_relax_launch.argtypes = (
            [_P, _P] + [_I] * 10 + [_P, _P] + [_I, _I, _P])
        lib.rss_windowed_relax_launch.restype = _I
        lib.rss_windowed_relax_max_smem.argtypes = [_I]
        lib.rss_windowed_relax_max_smem.restype = _I
        lib.rss_windowed_relax_max_clusters.argtypes = [_I] * 3
        lib.rss_windowed_relax_max_clusters.restype = _I
    return lib


def group_by_destination(dbase, sbase, idx, w, arc, s_pad: int):
    """The steps regrouped by destination block: (blk_ptr [TB, s_pad/128 +
    1] int32, sbase, idx, w, arc in that order, contiguous). Steps of block
    k are ``blk_ptr[k]:blk_ptr[k + 1]``. Block indices are clamped into
    range, so tables not yet checked cannot index out of bounds."""
    if dbase.dim() == 1:
        dbase, sbase, idx, w, arc = (x.unsqueeze(0) for x in (dbase, sbase, idx, w, arc))
    TB, nstep = dbase.shape
    nblk = s_pad // LANES
    order = torch.argsort(dbase, dim=1, stable=True)
    blk = (torch.gather(dbase, 1, order).to(torch.int64) // LANES).clamp(0, nblk - 1)
    counts = torch.zeros((TB, nblk), dtype=torch.int32, device=dbase.device)
    counts.scatter_add_(1, blk, torch.ones_like(blk, dtype=torch.int32))
    blk_ptr = torch.cat([counts.new_zeros((TB, 1)), counts.cumsum(1, dtype=torch.int32)], 1)
    lane_order = order[..., None].expand(TB, nstep, LANES)
    return (
        blk_ptr.contiguous(),
        torch.gather(sbase.to(torch.int32), 1, order).contiguous(),
        torch.gather(idx.to(torch.int32), 1, lane_order).contiguous(),
        torch.gather(w.to(torch.float32), 1, lane_order).contiguous(),
        torch.gather(arc.to(torch.int32), 1, lane_order).contiguous(),
    )


def pack_candidates(idx: torch.Tensor, arc: torch.Tensor) -> torch.Tensor:
    """``(arc << 7) | idx`` as the int32 of those 32 bits. The kernel reads
    the word unsigned: ``word & 127`` is idx, ``word >> 7`` the full arc id.
    It breaks ties by comparing whole words, which orders two candidates
    as their arc ids do wherever the arc ids differ."""
    word = (arc.to(torch.int64) << IDX_BITS) | idx.to(torch.int64)
    return torch.where(word >= 1 << 31, word - (1 << 32), word).to(torch.int32)


class RoundPlan(NamedTuple):
    """Where ``build_schedule`` puts each destination block: its group and
    the round of its first step in that group's row; and the schedule's
    length, the longest group's rounded up to whole stages, on the device
    (``num_rounds`` [] int64)."""

    group: torch.Tensor  # int64 [TB, nblk]
    first_round: torch.Tensor  # int64 [TB, nblk]
    num_rounds: torch.Tensor  # int64 []


def plan_rounds(blk_ptr: torch.Tensor) -> RoundPlan:
    """Deal the destination blocks to the ``GROUPS`` groups, balanced by
    step count: blocks in descending order of steps go to groups 0..G-1,
    G-1..0, 0..G-1, ... A block without steps takes one (no-op) round,
    in which its destinations still get ``alpha + 0.5`` and arc id 0."""
    dev = blk_ptr.device
    TB, nblk = blk_ptr.shape[0], blk_ptr.shape[1] - 1
    rounds = (blk_ptr[:, 1:] - blk_ptr[:, :-1]).to(torch.int64).clamp(min=1)
    order = torch.argsort(rounds, dim=1, descending=True, stable=True)
    pos = torch.arange(nblk, device=dev)
    group_of_pos = torch.where((pos // GROUPS) % 2 == 0, pos % GROUPS, GROUPS - 1 - pos % GROUPS)
    mine = torch.nn.functional.one_hot(group_of_pos, GROUPS)  # [nblk, G]
    dealt = torch.gather(rounds, 1, order)[..., None] * mine  # [TB, nblk, G]
    load = dealt.cumsum(1)
    start = ((load - dealt) * mine).sum(2)  # rounds dealt to the same group before
    group = torch.empty_like(order).scatter_(1, order, group_of_pos.expand(TB, nblk))
    first_round = torch.empty_like(order).scatter_(1, order, start)
    longest = load[:, -1].max()
    return RoundPlan(group, first_round,
                     (longest + ROUNDS_PER_STAGE - 1) // ROUNDS_PER_STAGE * ROUNDS_PER_STAGE)


def build_schedule(grouped, plan: RoundPlan, num_rounds: int, s_pad: int) -> torch.Tensor:
    """The kernel's tables, int32 [TB, num_rounds, ROUND_WORDS]: round r
    holds, for group g, lane j, the words ``(pack_candidates(idx, arc), w's
    bits)`` at ``(g * 128 + j) * 2`` and, after all candidates, per group
    ``(4 * sbase, 4 * dbase | flags)`` -- the blocks' byte offsets into an
    alpha buffer -- with FIRST on a block's first step and LAST on its
    last. ``grouped`` are ``group_by_destination``'s tensors. Rounds
    a group does not fill hold no-op steps without flags."""
    blk_ptr, sbase, idx, w, arc = grouped
    dev = blk_ptr.device
    TB, nstep = sbase.shape
    nblk, L, G = s_pad // LANES, num_rounds, GROUPS
    cand = torch.empty((TB * L * G, LANES, 2), dtype=torch.int32, device=dev)
    cand[..., 0] = NOOP_WORD
    cand[..., 1] = NOOP_WEIGHT
    meta = torch.zeros((TB * L * G, 2), dtype=torch.int32, device=dev)
    stream = torch.arange(TB, device=dev)[:, None]

    def slot(rnd, group):  # row of cand / meta
        return ((stream * L + rnd) * G + group).reshape(-1)

    counts = (blk_ptr[:, 1:] - blk_ptr[:, :-1]).to(torch.int64)
    blocks = torch.arange(nblk, device=dev)
    # a block's steps, in their sorted order, take consecutive rounds:
    # step i of the sorted steps belongs to block blk[i] and is its j-th
    steps = torch.arange(nstep, device=dev, dtype=torch.int32).expand(TB, nstep).contiguous()
    blk = torch.searchsorted(blk_ptr[:, 1:].contiguous(), steps, right=True).clamp(max=nblk - 1)
    j = steps - torch.gather(blk_ptr, 1, blk)
    at = slot(torch.gather(plan.first_round, 1, blk) + j, torch.gather(plan.group, 1, blk))
    flags = (j == 0) * FIRST + (j == torch.gather(counts, 1, blk) - 1) * LAST
    cand[at] = torch.stack([pack_candidates(idx, arc), w.view(torch.int32)], -1).reshape(-1, LANES, 2)
    meta[at] = torch.stack([4 * sbase, (4 * LANES * blk + flags).to(torch.int32)], -1).reshape(-1, 2)
    # blocks without steps: one no-op round that starts and ends the block
    empty = (counts == 0).reshape(-1)
    at = slot(plan.first_round, plan.group)[empty]
    meta[at] = torch.stack([torch.zeros_like(blocks), 4 * LANES * blocks + (FIRST | LAST)], -1).to(
        torch.int32).expand(TB, nblk, 2).reshape(-1, 2)[empty]
    return torch.cat([cand.view(TB, L, G * LANES * 2), meta.view(TB, L, G * 2)], 2).contiguous()


class StepTables(NamedTuple):
    """Step tables checked and laid out once by ``prepare_steps``, for any
    number of ``windowed_relax`` calls: ``tables`` as given (for the plain
    version) and ``build_schedule``'s tensor (for the kernel)."""

    tables: Tuple[torch.Tensor, ...]
    schedule: torch.Tensor  # int32 [TB, num_rounds, ROUND_WORDS]
    s_pad: int
    per_stream: bool

    @property
    def num_rounds(self) -> int:
        return self.schedule.shape[1]


def prepare_steps(
    dbase: torch.Tensor,
    sbase: torch.Tensor,
    idx: torch.Tensor,
    w: torch.Tensor,
    arc: torch.Tensor,
    s_pad: int,
) -> StepTables:
    """Check the tables and lay them out as the kernel's schedule, on their
    device, with one wait for the device."""
    dev = dbase.device
    if dbase.dim() not in (1, 2):
        raise ValueError(f"windowed_relax: dbase must be [NSTEP] or [B, NSTEP], got "
                         f"{tuple(dbase.shape)}")
    per_stream = dbase.dim() == 2
    lead, nstep = tuple(dbase.shape[:-1]), dbase.shape[-1]
    for name, x, shape in (
        ("sbase", sbase, lead + (nstep,)), ("idx", idx, lead + (nstep, LANES)),
        ("w", w, lead + (nstep, LANES)), ("arc", arc, lead + (nstep, LANES)),
    ):
        if tuple(x.shape) != shape or x.device != dev:
            raise ValueError(f"windowed_relax: {name} must be {shape} on {dev}, got "
                             f"{tuple(x.shape)} on {x.device}")
    if s_pad % LANES or s_pad <= 0:
        raise ValueError(f"windowed_relax: s_pad {s_pad} is not a positive multiple of {LANES}")
    bad = (
        (dbase % LANES != 0) | (dbase < 0) | (dbase >= s_pad)
        | (sbase % LANES != 0) | (sbase < 0) | (sbase >= s_pad)
    ).any() | ((idx < 0) | (idx >= LANES)).any() | ((arc < 0) | (arc >= MAX_ARC)).any()
    grouped = group_by_destination(dbase, sbase, idx, w, arc, s_pad)
    plan = plan_rounds(grouped[0])
    is_bad, num_rounds = torch.stack([bad.to(torch.int64), plan.num_rounds]).tolist()
    if is_bad:
        raise ValueError("windowed_relax: dbase/sbase must be multiples of 128 below s_pad, "
                         f"idx must lie in [0, 128) and arc in [0, {MAX_ARC})")
    schedule = build_schedule(grouped, plan, num_rounds, s_pad)
    return StepTables((dbase, sbase, idx, w, arc), schedule, s_pad, per_stream)


def stage_pieces(nbytes: int, cluster: int) -> List[Tuple[int, int]]:
    """Byte ranges of a stage that the CTAs of a cluster copy, rank by rank:
    the stage's 16-byte chunks split evenly (a bulk copy moves multiples of
    16 bytes between 16-byte aligned addresses)."""
    chunks = nbytes // 16
    return [(chunks * q // cluster * 16, chunks * (q + 1) // cluster * 16) for q in range(cluster)]


class RingLayout(NamedTuple):
    """The kernel's dynamic shared memory: alpha's two buffers at 0, the
    ring of ``stages`` slots of ``rounds_per_stage`` rounds at ``ring``, a
    full and an empty mbarrier per slot at ``barriers``."""

    rounds_per_stage: int
    stages: int
    ring: int
    barriers: int
    nbytes: int


def ring_layout(s_pad: int, max_smem: int) -> RingLayout:
    """As many ring slots (up to ``MAX_STAGES``) as fit beside alpha in
    ``max_smem`` bytes; raises where fewer than ``MIN_STAGES`` do."""
    ring = 2 * 4 * s_pad
    stage = ROUNDS_PER_STAGE * ROUND_BYTES
    stages = min(MAX_STAGES, (max_smem - ring) // (stage + 16))
    if stages < MIN_STAGES:
        raise ValueError(
            f"windowed_relax keeps alpha and a ring of step tables in shared memory: s_pad "
            f"{s_pad} leaves no room for {MIN_STAGES} stages of {stage} bytes in {max_smem}"
        )
    barriers = ring + stages * stage
    return RingLayout(ROUNDS_PER_STAGE, stages, ring, barriers, barriers + 16 * stages)


def choose_cluster(batch: int, per_stream: bool, max_clusters: Callable[[int], int]) -> int:
    """The cluster size for a call. Per-stream tables cannot be shared: 1.
    Else, of the sizes the card can run (``max_clusters(C)``: clusters of C
    CTAs it runs at once), the one that takes the batch in the fewest
    waves, by ``CLUSTER_PREFERENCE`` on a tie: a larger cluster reads the
    schedule from L2 fewer times, but a card that places fewer CTAs in
    large clusters then pays a whole wave more."""
    if per_stream:
        return 1

    def waves(c: int) -> int:
        clusters = -(-batch // c)
        return -(-clusters // max_clusters(c))

    sizes = [c for c in CLUSTER_SIZES if max_clusters(c) > 0]
    if not sizes:
        raise RuntimeError("windowed_relax: the card runs no CTA of this kernel")
    return min(sizes, key=lambda c: (waves(c), CLUSTER_PREFERENCE.index(c)))


@functools.lru_cache(maxsize=None)
def _max_smem(device_index: int) -> int:
    return _lib().rss_windowed_relax_max_smem(device_index)


@functools.lru_cache(maxsize=None)
def _max_clusters(device_index: int, cluster: int, smem_bytes: int) -> int:
    return _lib().rss_windowed_relax_max_clusters(cluster, smem_bytes, device_index)


def max_clusters(steps: StepTables, cluster: int) -> int:
    """Clusters of ``cluster`` CTAs of this kernel that the tables' card
    runs at once (0 where it cannot run one)."""
    dev = steps.schedule.device
    return _max_clusters(dev.index, cluster, ring_layout(steps.s_pad, _max_smem(dev.index)).nbytes)


def select_cluster(steps: StepTables, batch: int) -> int:
    """``choose_cluster`` with the limits of the tables' card."""
    return choose_cluster(batch, steps.per_stream, lambda c: max_clusters(steps, c))


def launch(
    steps: StepTables,
    num_frames: int,
    batch: int,
    alpha0: Optional[torch.Tensor],
    cluster: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One kernel launch with a given cluster size; raises where the card
    refuses it. ``windowed_relax`` chooses the size."""
    dev, s_pad = steps.schedule.device, steps.s_pad
    if dev.type != "cuda":
        raise ValueError(f"windowed_relax: unsupported device {dev}")
    if cluster not in CLUSTER_SIZES or (steps.per_stream and cluster != 1):
        raise ValueError(f"windowed_relax: cluster size {cluster} (per-stream tables take 1, "
                         f"shared tables one of {CLUSTER_SIZES})")
    if steps.per_stream and steps.schedule.shape[0] != batch:
        raise ValueError(f"windowed_relax: tables for {steps.schedule.shape[0]} streams, "
                         f"batch {batch}")
    layout = ring_layout(s_pad, _max_smem(dev.index))
    if alpha0 is not None:
        alpha0 = alpha0.to(device=dev, dtype=torch.float32).reshape(batch, s_pad).contiguous()
    alpha = torch.empty((batch, s_pad), dtype=torch.float32, device=dev)
    bp = torch.empty((num_frames, batch, s_pad), dtype=torch.uint16, device=dev)
    if batch:
        lib = _lib()
        err = lib.rss_windowed_relax_launch(
            steps.schedule.data_ptr(), None if alpha0 is None else alpha0.data_ptr(),
            batch, num_frames, s_pad, steps.num_rounds, int(steps.per_stream),
            layout.rounds_per_stage, layout.stages, layout.ring, layout.barriers, layout.nbytes,
            alpha.data_ptr(), bp.data_ptr(),
            cluster, dev.index, torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check(lib, err, f"windowed_relax kernel launch (cluster of {cluster})")
        windowed_relax.launches += 1
    return alpha, bp


def windowed_relax(
    steps: StepTables,
    num_frames: int,
    batch: int,
    alpha0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Windowed relaxation of ``batch`` streams over ``num_frames`` frames
    on the tables of ``prepare_steps``: (alpha [B, s_pad] f32, bp [T, B,
    s_pad] uint16), bit-identical to ``windowed_relax_torch``. Waits for the
    device nowhere."""
    if steps.schedule.device.type == "cpu":
        return windowed_relax_torch(*steps.tables, num_frames, batch, steps.s_pad, alpha0)
    return launch(steps, num_frames, batch, alpha0, select_cluster(steps, batch) if batch else 1)


windowed_relax.launches = 0
