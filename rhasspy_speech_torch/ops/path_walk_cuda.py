"""Whole-path walk kernel wrapper (``csrc/path_walk.cu``): the stream
scheduler's per-tick walk over its backpointer ring.

The kernel has no TPU original: it stands in for the XLA scans of the JAX
scheduler (``walk_step`` and ``finalize_trace``,
``rhasspy_speech_tpu/pipeline/scheduler.py``), which walk the ring's full
depth; the kernel walks each slot's own frames only.

``path_walk`` launches the kernel for a ring on a CUDA device and runs the
plain twin ``path_walk_torch`` for a ring on the CPU; it never falls back
from one to the other. ``path_walk.launches`` counts kernel launches.

uint16 data (the ring's ``bp + 3`` entries, the packed output row) lives in
int16 tensors of the same bits, as the other kernels' uint16 tables do.

The kernel stages the graph's arc table in shared memory: ``walk_tables``
packs it once per graph (uint16 sources and a silence bit an arc), and
both the kernel and its twin take the resulting ``WalkTables``. Where a
ring row is small, the kernel also streams each slot's rows through
shared memory in chunks (``walk_chunks``).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from . import _build

_P = ctypes.c_void_p
_I = ctypes.c_int

# stat columns after the [N, width] arc trace: final_state, has_final,
# trailing-silence frames, contains-nonsilence, then the final cost and the
# relative cost as f32 bit halves (lo, hi)
PACKED_STAT_COLS = 8
NOT_FINAL = 1.0e29  # a final cost at or above this reaches no final state
MAX_STATES = 65535  # uint16 sources
MAX_ARCS = 65532  # the ring holds arc + 3 in uint16
VEC = 16  # bytes of one staged vector (a uint4)
MAX_SMEM = 232448  # dynamic shared memory an H100 block may opt into
CHUNK_BYTES = 65536  # ring rows a streamed chunk holds, at most
MIN_CHUNK_FRAMES = 8  # fewer rows a chunk: the kernel chases the ring directly


def _lib() -> ctypes.CDLL:
    lib = _build.load("path_walk")
    if lib.rss_path_walk_launch.argtypes is None:
        lib.rss_path_walk_launch.argtypes = (
            [_P, _I, _I] + [_P] * 4 + [_I] * 7 + [_P, _I, _P]
        )
        lib.rss_path_walk_launch.restype = _I
    return lib


@dataclass(frozen=True)
class WalkTables:
    """A graph's arc table for the walk: ``arc_src`` int32 [A] and
    ``arc_sil`` uint8 [A] (1 = the arc emits a silence pdf), which the twin
    reads, and ``packed``, which the kernel copies into shared memory:
    ``src_vec`` 16-byte vectors of uint16 sources (little-endian, padded),
    then ``bit_vec`` of uint32 words holding arc e's silence flag at bit
    ``e % 32`` of word ``e // 32``."""

    arc_src: torch.Tensor
    arc_sil: torch.Tensor
    packed: torch.Tensor  # uint8 [16 * (src_vec + bit_vec)]
    src_vec: int
    bit_vec: int

    @property
    def smem_bytes(self) -> int:
        return VEC * (self.src_vec + self.bit_vec)


def walk_chunks(num_states: int, tables: WalkTables) -> Tuple[int, int]:
    """(frames, bytes) of a streamed chunk of ring rows, (0, 0) where the
    kernel chases the ring in global memory: as many rows as fit
    ``CHUNK_BYTES`` and half the shared memory the staged arc table leaves,
    when that is at least ``MIN_CHUNK_FRAMES``. A chunk buffer holds its
    rows and 16 bytes of slack for their alignment; the kernel keeps two."""
    budget = min(CHUNK_BYTES, (MAX_SMEM - tables.smem_bytes) // 2 - 2 * VEC)
    frames = budget // (2 * max(num_states, 1))
    if frames < MIN_CHUNK_FRAMES:
        return 0, 0
    return frames, -(-(frames * num_states * 2 + VEC) // VEC) * VEC


def walk_tables(arc_src: torch.Tensor, arc_sil: torch.Tensor, num_states: int) -> WalkTables:
    """Pack a graph's arc sources and silence flags for the kernel, once
    per graph. Refuses a graph past ``MAX_STATES`` states (the sources are
    uint16) or ``MAX_ARCS`` arcs (the ring's uint16 entries)."""
    if num_states > MAX_STATES:
        raise ValueError(f"path walk stages uint16 sources: {num_states} states exceed {MAX_STATES}")
    A = int(arc_src.shape[0])
    if A > MAX_ARCS or tuple(arc_sil.shape) != (A,):
        raise ValueError(f"path walk: {A} arcs (at most {MAX_ARCS}), {tuple(arc_sil.shape)} flags")
    if arc_src.dtype != torch.int32 or arc_sil.dtype != torch.uint8:
        raise ValueError("path walk: arc_src must be int32 and arc_sil uint8")
    src = arc_src.cpu().numpy()
    if A and (src.min() < 0 or src.max() >= num_states):
        raise ValueError(f"path walk: an arc source outside 0..{num_states - 1}")
    src_vec = -(-2 * A // VEC)
    bit_vec = -(-A // (8 * VEC))
    packed = np.zeros(VEC * (src_vec + bit_vec), np.uint8)
    packed[: 2 * A] = src.astype("<u2").view(np.uint8)
    bits = np.zeros(VEC // 4 * bit_vec, np.uint32)
    sil = np.flatnonzero(arc_sil.cpu().numpy())
    np.bitwise_or.at(bits, sil >> 5, np.left_shift(np.uint32(1), (sil & 31).astype(np.uint32)))
    packed[VEC * src_vec :] = bits.astype("<u4").view(np.uint8)
    return WalkTables(arc_src=arc_src, arc_sil=arc_sil,
                      packed=torch.as_tensor(packed, device=arc_src.device),
                      src_vec=src_vec, bit_vec=bit_vec)


def walk_start(
    alpha: torch.Tensor, final_weight: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each slot's walk start and costs from its alpha [N, S]: (start [N]
    int32, costs [N, 2] f32). The start is the best final state when one is
    reachable, else the best state (first index on ties); the costs are the
    best final cost and its distance from the best state's cost (infinity
    when no final state is reachable)."""
    totals = alpha + final_weight[None, :]
    fcost, fstate = totals.min(dim=1)
    best, bstate = alpha.min(dim=1)
    has_final = fcost < NOT_FINAL
    start = torch.where(has_final, fstate, bstate).to(torch.int32)
    rel = torch.where(has_final, fcost - best, torch.full_like(fcost, float("inf")))
    return start, torch.stack([fcost, rel], dim=1)


def _packed_bits(costs: torch.Tensor) -> torch.Tensor:
    """[N, 2] f32 -> [N, 4] int32 (lo, hi) 16-bit halves of each value."""
    bits = costs.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.stack(
        [bits[:, 0] & 0xFFFF, bits[:, 0] >> 16, bits[:, 1] & 0xFFFF, bits[:, 1] >> 16], dim=1
    )


def path_walk_torch(
    ring: torch.Tensor,
    frames: torch.Tensor,
    start: torch.Tensor,
    costs: torch.Tensor,
    tables: WalkTables,
    width: int,
    stats: bool,
) -> torch.Tensor:
    """Plain twin of the kernel: the reference's ``walk_step`` over frames
    ``width - 1 .. 0`` for every slot at once (a slot's frames at or past
    ``frames[n]`` emit 0 and leave its state as it was)."""
    N, _F, S = ring.shape
    dev = ring.device
    lanes = torch.arange(N, device=dev)
    fr = frames.to(torch.int64).clamp(0, width)
    state = start.to(torch.int64)
    trail = torch.zeros(N, dtype=torch.int64, device=dev)
    nonsil = torch.zeros(N, dtype=torch.bool, device=dev)
    done = torch.zeros(N, dtype=torch.bool, device=dev)
    sil_tab = tables.arc_sil.to(torch.bool)
    src_tab = tables.arc_src.to(torch.int64)
    out = torch.zeros((N, width + PACKED_STAT_COLS), dtype=torch.int64, device=dev)
    top = int(fr.max()) if N else 0
    for f in range(top - 1, -1, -1):
        active = f < fr
        e = (ring[:, f].to(torch.int64) & 0xFFFF)[lanes, state] - 3
        is_real = active & (e >= 0)
        safe = e.clamp_min(0)
        out[:, f] = torch.where(active, (e + 2) & 0xFFFF, 0)
        if stats:
            sil = is_real & sil_tab[safe]
            trail = torch.where(sil & ~done, trail + 1, trail)
            done = done | (active & ~sil)
            nonsil = nonsil | (is_real & ~sil_tab[safe])
        state = torch.where(is_real, src_tab[safe], state)
    out[:, width] = start.to(torch.int64) & 0xFFFF
    out[:, width + 1] = (costs[:, 0] < NOT_FINAL).to(torch.int64)
    out[:, width + 2] = trail.clamp(max=65535)
    out[:, width + 3] = nonsil.to(torch.int64)
    out[:, width + 4 :] = _packed_bits(costs)
    return out.to(torch.int32).to(torch.int16)


def path_walk(
    ring: torch.Tensor,
    frames: torch.Tensor,
    start: torch.Tensor,
    costs: torch.Tensor,
    tables: WalkTables,
    width: int,
    stats: bool,
) -> torch.Tensor:
    """Walk every slot's best path back through the ring.

    ring [N, F_ring, S] int16 (uint16 ``bp + 3`` bits, F_ring >= width);
    frames [N] int32 decoded frames a slot (<= width); start [N] int32 and
    costs [N, 2] f32 from ``walk_start``; tables from ``walk_tables``
    (the graph's arc sources and silence flags). Returns the packed rows [N,
    width + 8] int16 (uint16 bits): the arc trace, then
    ``PACKED_STAT_COLS`` stat columns. ``stats`` False leaves the two
    endpoint columns 0."""
    dev = ring.device
    if dev.type == "cpu":
        return path_walk_torch(ring, frames, start, costs, tables, width, stats)
    if dev.type != "cuda":
        raise ValueError(f"path_walk: unsupported device {dev}")
    N, F_ring, S = ring.shape
    if ring.dtype != torch.int16 or not ring.is_contiguous():
        raise ValueError("path_walk: ring must be a contiguous [N, F, S] int16 tensor")
    if width > F_ring:
        raise ValueError(f"path_walk: width {width} exceeds the ring's {F_ring} frames")
    for name, t, dt, shape in (
        ("frames", frames, torch.int32, (N,)),
        ("start", start, torch.int32, (N,)),
        ("costs", costs, torch.float32, (N, 2)),
        ("tables", tables.packed, torch.uint8, (tables.smem_bytes,)),
    ):
        if t.device != dev or t.dtype != dt or tuple(t.shape) != tuple(shape):
            raise ValueError(f"path_walk: {name} must be {dt} {tuple(shape)} on {dev}")
    out = torch.empty((N, width + PACKED_STAT_COLS), dtype=torch.int16, device=dev)
    chunk_frames, chunk_bytes = walk_chunks(S, tables)
    lib = _lib()
    err = lib.rss_path_walk_launch(
        ring.data_ptr(), F_ring, S, frames.contiguous().data_ptr(),
        start.contiguous().data_ptr(), costs.contiguous().data_ptr(),
        tables.packed.data_ptr(), tables.src_vec, tables.bit_vec,
        chunk_frames, chunk_bytes, N, width, int(stats), out.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, err, "path walk kernel launch")
    path_walk.launches += 1
    return out


path_walk.launches = 0
