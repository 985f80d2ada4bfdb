"""Pitch-lag Viterbi kernel wrapper (``csrc/pitch_viterbi.cu``): the last
step of Kaldi's pitch tracker, a min-plus Viterbi over log-spaced lags with
its traceback.

The kernel has no TPU original: it stands in for the XLA scans at the end
of ``rhasspy_speech_tpu/ops/pitch.py:pitch_track`` (the forward scan of
``[B, NL, NL]`` min-plus steps and the reverse scan of the traceback).

``pitch_viterbi`` launches the kernel for costs on a CUDA device and runs
the plain twin ``pitch_viterbi_torch`` (the reference's scans as a frame
loop) for costs on the CPU; it never falls back from one to the other.
``pitch_viterbi.launches`` counts kernel launches. Given the same costs the
two return the same states bit for bit: the recursion is f32 adds and
compares only, and both take the first index on ties, as ``jnp.argmin``
does.

The kernel runs each stream on a cluster of C CTAs. ``plan_pitch_viterbi``
sizes its tiles for NL lags, a cluster size and a lane count (plain
Python, so the CPU tests emulate the kernel's schedule from it);
``choose_cluster`` picks the cluster size and lanes from the batch, the
swept frame times in ``FRAME_US`` and the clusters the card runs at once,
and ``select_plan`` runs it once per device, batch and NL with the card's
limits.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from . import _build

_P = ctypes.c_void_p
_I = ctypes.c_int

STRIP = 8  # outputs i a thread's strip (csrc/pitch_viterbi.cu kR)
BLOCK = 8  # candidates j a block (kU)
LANE_CHUNKS = (8, 16, 32)  # lanes a strip, consecutive in a warp
CLUSTER_SIZES = (1, 2, 4, 8)
MAX_THREADS = 1024
MAX_LAGS = 4096  # kMaxLags; past 1,024 x C lags a cluster of C has too few threads
# The default lanes a strip: the most whose threads stay within this, so
# two CTAs of 64-register threads share an SM.
TARGET_THREADS = 512
# The chooser's model: microseconds a frame at 417 lags (424 padded) by
# (cluster size, lanes a strip), as (one stream alone on the card, 32
# streams at once). From the sweep of examples/pitch_viterbi_sweep.py on
# an H100 80GB HBM3 at 700 W (PERF.md, PR 10); the frame time of another
# batch is interpolated between the two, of other lags scaled by NLp^2.
FRAME_US = {
    (1, 8): (4.275, 4.265), (1, 16): (4.773, 4.769),
    (2, 8): (2.828, 2.830), (2, 16): (3.070, 3.073), (2, 32): (3.390, 3.389),
    (4, 8): (2.231, 2.826), (4, 16): (2.060, 3.137), (4, 32): (2.189, 3.559),
    (8, 8): (2.264, 2.847), (8, 16): (1.719, 2.660), (8, 32): (1.553, 3.029),
}
FRAME_US_LAGS = 424
FRAME_US_BATCH = 32


def _lib() -> ctypes.CDLL:
    lib = _build.load("pitch_viterbi")
    if lib.rss_pitch_viterbi_launch.argtypes is None:
        lib.rss_pitch_viterbi_launch.argtypes = (
            [_P] * 2 + [_I] * 3 + [_I] * 5 + [_P] * 3 + [_I, _P]
        )
        lib.rss_pitch_viterbi_launch.restype = _I
        lib.rss_pitch_viterbi_max_lags.restype = _I
        lib.rss_pitch_viterbi_max_clusters.argtypes = [_I] * 4
        lib.rss_pitch_viterbi_max_clusters.restype = _I
    return lib


@dataclass(frozen=True)
class PitchPlan:
    """The kernel's tiles for ``num_lags`` lags on clusters of ``cluster``.

    Outputs are padded to ``lags_pad`` (a multiple of ``STRIP``) and cut
    into strips of ``STRIP``; CTA r of a cluster owns strips ``r *
    slice_strips ..`` (``slice_strips * STRIP`` outputs). Candidates are
    cut into blocks of ``BLOCK``; a strip has ``lanes`` lanes (one of
    ``LANE_CHUNKS``), and thread ``tid`` owns strip ``tid // lanes`` of its
    CTA against the blocks ``tid % lanes + lanes * n``; after the merge it
    holds output ``tid % 8`` of its strip, with ``lanes // 8`` lanes an
    output."""

    cluster: int
    num_lags: int
    lags_pad: int
    slice_strips: int
    lanes: int
    threads: int
    smem_bytes: int

    @property
    def slice_out(self) -> int:
        return self.slice_strips * STRIP


def plan_pitch_viterbi(num_lags: int, cluster: int, lanes: Optional[int] = None) -> PitchPlan:
    """Tiles for ``num_lags`` lags on clusters of ``cluster`` CTAs: the most
    lanes a strip (of ``LANE_CHUNKS``) whose threads stay within
    ``TARGET_THREADS``, or ``lanes``. Raises past ``MAX_LAGS``, for a
    cluster size outside ``CLUSTER_SIZES``, and where a CTA's strips need
    more than ``MAX_THREADS`` threads."""
    if cluster not in CLUSTER_SIZES:
        raise ValueError(f"pitch_viterbi: cluster size {cluster} not in {CLUSTER_SIZES}")
    if not 1 <= num_lags <= MAX_LAGS:
        raise ValueError(f"pitch_viterbi: {num_lags} lags outside the kernel's 1..{MAX_LAGS}")
    if lanes is not None and lanes not in LANE_CHUNKS:
        raise ValueError(f"pitch_viterbi: {lanes} lanes a strip not in {LANE_CHUNKS}")
    lags_pad = -(-num_lags // STRIP) * STRIP
    nb = lags_pad // BLOCK
    slice_strips = -(-nb // cluster)
    if lanes is None:
        fit = [k for k in LANE_CHUNKS if slice_strips * k <= TARGET_THREADS]
        lanes = fit[-1] if fit else LANE_CHUNKS[0]
    threads = -(-slice_strips * lanes // 32) * 32
    if threads > MAX_THREADS:
        raise ValueError(f"pitch_viterbi: {num_lags} lags on clusters of {cluster} need "
                         f"{threads} threads a CTA (at most {MAX_THREADS})")
    # fwd's two buffers, the swizzled distance table (12 floats a group of
    # 8) and two local rows
    floats = 2 * lags_pad + 3 * lags_pad + 2 * slice_strips * STRIP
    return PitchPlan(cluster=cluster, num_lags=num_lags, lags_pad=lags_pad,
                     slice_strips=slice_strips, lanes=lanes, threads=threads,
                     smem_bytes=4 * floats)


def frame_us(plan: PitchPlan, batch: int) -> float:
    """The chooser's model of one frame's microseconds on the card for a
    launch of ``batch`` streams (``FRAME_US``)."""
    alone, full = FRAME_US[(plan.cluster, plan.lanes)]
    load = min(1.0, max(0.0, (batch - 1) / (FRAME_US_BATCH - 1)))
    return (alone + load * (full - alone)) * max(1.0, (plan.lags_pad / FRAME_US_LAGS) ** 2)


def choose_cluster(batch: int, num_lags: int,
                   max_clusters: Callable[[PitchPlan], int]) -> PitchPlan:
    """The plan, of every cluster size and lane count in ``FRAME_US``, whose
    launch takes the least modeled time: ``ceil(batch / max_clusters(plan))``
    waves of ``frame_us(plan, batch)`` a frame, the first in ``FRAME_US``'s
    order on a tie. A plan the card cannot run (``max_clusters`` 0, e.g. for
    its shared memory) or whose strips need too many threads is out;
    raises when none is left, and past ``MAX_LAGS``."""
    if not 1 <= num_lags <= MAX_LAGS:
        raise ValueError(f"pitch_viterbi: {num_lags} lags outside the kernel's 1..{MAX_LAGS}")
    best, best_cost = None, math.inf
    for c, lanes in FRAME_US:
        try:
            plan = plan_pitch_viterbi(num_lags, c, lanes=lanes)
        except ValueError:  # too many lags for this cluster size's threads
            continue
        n = max_clusters(plan)
        if n <= 0:
            continue
        cost = -(-max(batch, 1) // n) * frame_us(plan, batch)
        if cost < best_cost:
            best, best_cost = plan, cost
    if best is None:
        raise ValueError(f"pitch_viterbi: no cluster size runs {num_lags} lags on this card")
    return best


def max_clusters(plan: PitchPlan, device: torch.device) -> int:
    """Clusters of ``plan`` the device's card runs at once."""
    return _lib().rss_pitch_viterbi_max_clusters(plan.cluster, plan.threads, plan.smem_bytes,
                                                 device.index)


_PLANS: Dict[Tuple[int, int, int], PitchPlan] = {}


def select_plan(batch: int, num_lags: int, device: torch.device) -> PitchPlan:
    """``choose_cluster`` with the limits of ``device``'s card, once per
    device, batch and NL: the same inputs give the same plan, so a captured
    tick replays the launch it captured."""
    key = (device.index, batch, num_lags)
    plan = _PLANS.get(key)
    if plan is None:
        plan = choose_cluster(batch, num_lags, lambda p: max_clusters(p, device))
        _PLANS[key] = plan
    return plan


def transition_costs(num_lags: int, delta_pitch: float, penalty_factor: float) -> np.ndarray:
    """[NL] f32 transition cost by lag distance d: ``d^2 * log(1 +
    delta_pitch)^2 * penalty_factor`` in float64, cast once. The reference's
    ``[NL, NL]`` matrix (``rhasspy_speech_tpu/ops/pitch.py:249-253``) holds
    exactly ``table[|i - j|]``."""
    factor = math.log(1.0 + delta_pitch) ** 2 * penalty_factor
    d = np.arange(num_lags)
    return (d**2 * factor).astype(np.float32)


def pitch_viterbi_torch(local: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """Plain twin of the kernel: the reference's forward scan (``fwd' =
    local_t + min_j(fwd[j] + trans[i, j])``, backpointer at the first j)
    and reverse traceback as frame loops."""
    B, T, NL = local.shape
    dev = local.device
    idx = torch.arange(NL, device=dev)
    trans = dist[(idx[:, None] - idx[None, :]).abs()]  # [i, j]
    fwd = local[:, 0]
    bps = []
    for t in range(1, T):
        scores = fwd[:, None, :] + trans[None, :, :]  # [B, i, j]
        bp = torch.argmin(scores, dim=-1)
        best = torch.gather(scores, 2, bp[:, :, None])[:, :, 0]
        fwd = local[:, t] + best
        bps.append(bp)
    states = torch.empty((B, T), dtype=torch.int32, device=dev)
    s = torch.argmin(fwd, dim=-1)
    for t in range(T - 1, -1, -1):
        if t < T - 1:
            s = torch.gather(bps[t], 1, s[:, None])[:, 0]
        states[:, t] = s.to(torch.int32)
    return states


def pitch_viterbi(local: torch.Tensor, dist: torch.Tensor, *, plan: Optional[PitchPlan] = None,
                  clocks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Best lag path: local [B, T, NL] f32 per-frame lag costs, dist [NL]
    f32 transition cost by lag distance (``transition_costs``). Returns
    states [B, T] int32.

    ``plan`` forces the kernel's tiles and cluster size (tests and the
    sweep: ``plan_pitch_viterbi(NL, C)``); by default ``select_plan``
    picks them. ``clocks``, an int64 [B, C, 4] tensor on the device,
    receives each CTA's forward cycles, rank 0's final argmin and
    traceback cycles, and thread 0's cycles in the min-plus pass and in
    the merge summed over the frames (``clock64``)."""
    dev = local.device
    if dev.type == "cpu":
        return pitch_viterbi_torch(local, dist)
    if dev.type != "cuda":
        raise ValueError(f"pitch_viterbi: unsupported device {dev}")
    B, T, NL = local.shape
    if local.dtype != torch.float32 or not local.is_contiguous():
        raise ValueError("pitch_viterbi: local must be a contiguous [B, T, NL] f32 tensor")
    if dist.device != dev or dist.dtype != torch.float32 or tuple(dist.shape) != (NL,):
        raise ValueError(f"pitch_viterbi: dist must be torch.float32 ({NL},) on {dev}")
    if plan is None:
        plan = select_plan(B, NL, dev)
    elif plan.num_lags != NL:
        raise ValueError(f"pitch_viterbi: a plan for {plan.num_lags} lags, costs of {NL}")
    if clocks is not None and (clocks.device != dev or clocks.dtype != torch.int64
                               or tuple(clocks.shape) != (B, plan.cluster, 4)):
        raise ValueError(f"pitch_viterbi: clocks must be int64 ({B}, {plan.cluster}, 4) on {dev}")
    lib = _lib()
    states = torch.empty((B, T), dtype=torch.int32, device=dev)
    bp = torch.empty((B, max(T - 1, 1), NL), dtype=torch.int16, device=dev)
    err = lib.rss_pitch_viterbi_launch(
        local.data_ptr(), dist.contiguous().data_ptr(), B, T, NL, plan.slice_strips,
        plan.lanes, plan.cluster, plan.threads,
        plan.smem_bytes, bp.data_ptr(), states.data_ptr(),
        None if clocks is None else clocks.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, err, "pitch Viterbi kernel launch")
    pitch_viterbi.launches += 1
    return states


pitch_viterbi.launches = 0
