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
below ``s_pad``; ``idx`` lies in [0, 128).

``prepare_steps`` checks the tables and regroups them by destination
block once; ``windowed_relax`` then launches the kernel for tables on a
CUDA device and runs ``windowed_relax_torch`` for tables on the CPU, and
never falls back from one to the other. ``windowed_relax.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from . import _build

LANES = 128

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
        lib.rss_windowed_relax_launch.argtypes = [_P] * 6 + [_I] * 5 + [_P, _P] + [_I, _I, _P]
        lib.rss_windowed_relax_launch.restype = _I
        lib.rss_windowed_relax_max_states.argtypes = [_I]
        lib.rss_windowed_relax_max_states.restype = _I
    return lib


def group_by_destination(dbase, sbase, idx, w, arc, s_pad: int):
    """The steps regrouped by destination block, for the kernel: (blk_ptr
    [TB, s_pad/128 + 1] int32, sbase, idx, w, arc in that order, contiguous).
    Steps of block k are ``blk_ptr[k]:blk_ptr[k + 1]``."""
    if dbase.dim() == 1:
        dbase, sbase, idx, w, arc = (x.unsqueeze(0) for x in (dbase, sbase, idx, w, arc))
    TB, nstep = dbase.shape
    order = torch.argsort(dbase, dim=1, stable=True)
    blk = torch.gather(dbase, 1, order).to(torch.int64) // LANES
    counts = torch.zeros((TB, s_pad // LANES), dtype=torch.int32, device=dbase.device)
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


class StepTables(NamedTuple):
    """Step tables checked and regrouped once by ``prepare_steps``, for any
    number of ``windowed_relax`` calls: ``tables`` as given (for the plain
    version) and the ``group_by_destination`` tensors (for the kernel)."""

    tables: Tuple[torch.Tensor, ...]
    blk_ptr: torch.Tensor
    sbase: torch.Tensor
    idx: torch.Tensor
    w: torch.Tensor
    arc: torch.Tensor
    s_pad: int
    per_stream: bool


def prepare_steps(
    dbase: torch.Tensor,
    sbase: torch.Tensor,
    idx: torch.Tensor,
    w: torch.Tensor,
    arc: torch.Tensor,
    s_pad: int,
) -> StepTables:
    """Check the tables (one wait for the device) and regroup them by
    destination block, on their device."""
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
    ).any() | ((idx < 0) | (idx >= LANES)).any()
    if bool(bad):
        raise ValueError("windowed_relax: dbase/sbase must be multiples of 128 below s_pad "
                         "and idx must lie in [0, 128)")
    grouped = group_by_destination(dbase, sbase, idx, w, arc, s_pad)
    return StepTables((dbase, sbase, idx, w, arc), *grouped, s_pad, per_stream)


@functools.lru_cache(maxsize=None)
def _max_states(device_index: int) -> int:
    return _lib().rss_windowed_relax_max_states(device_index)


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
    dev, s_pad = steps.blk_ptr.device, steps.s_pad
    if dev.type == "cpu":
        return windowed_relax_torch(*steps.tables, num_frames, batch, s_pad, alpha0)
    if dev.type != "cuda":
        raise ValueError(f"windowed_relax: unsupported device {dev}")
    if steps.per_stream and steps.blk_ptr.shape[0] != batch:
        raise ValueError(f"windowed_relax: tables for {steps.blk_ptr.shape[0]} streams, "
                         f"batch {batch}")
    max_states = _max_states(dev.index)
    if s_pad > max_states:
        raise ValueError(
            f"windowed_relax keeps alpha in shared memory: s_pad {s_pad} exceeds "
            f"the {max_states} this card holds"
        )
    if alpha0 is not None:
        alpha0 = alpha0.to(device=dev, dtype=torch.float32).reshape(batch, s_pad).contiguous()
    alpha = torch.empty((batch, s_pad), dtype=torch.float32, device=dev)
    bp = torch.empty((num_frames, batch, s_pad), dtype=torch.uint16, device=dev)
    if batch:
        lib = _lib()
        err = lib.rss_windowed_relax_launch(
            steps.blk_ptr.data_ptr(), steps.sbase.data_ptr(), steps.idx.data_ptr(),
            steps.w.data_ptr(), steps.arc.data_ptr(),
            None if alpha0 is None else alpha0.data_ptr(),
            batch, num_frames, s_pad, steps.sbase.shape[1], int(steps.per_stream),
            alpha.data_ptr(), bp.data_ptr(),
            1024, dev.index, torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check(lib, err, "windowed_relax kernel launch")
        windowed_relax.launches += 1
    return alpha, bp


windowed_relax.launches = 0
