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
"""

from __future__ import annotations

import ctypes
import math
import numpy as np
import torch

from . import _build

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load("pitch_viterbi")
    if lib.rss_pitch_viterbi_launch.argtypes is None:
        lib.rss_pitch_viterbi_launch.argtypes = [_P] * 2 + [_I] * 3 + [_P, _P, _I, _P]
        lib.rss_pitch_viterbi_launch.restype = _I
        lib.rss_pitch_viterbi_max_lags.restype = _I
    return lib


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


def pitch_viterbi(local: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """Best lag path: local [B, T, NL] f32 per-frame lag costs, dist [NL]
    f32 transition cost by lag distance (``transition_costs``). Returns
    states [B, T] int32."""
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
    lib = _lib()
    if NL > lib.rss_pitch_viterbi_max_lags():
        raise ValueError(f"pitch_viterbi: {NL} lags exceed the kernel's "
                         f"{lib.rss_pitch_viterbi_max_lags()}")
    states = torch.empty((B, T), dtype=torch.int32, device=dev)
    bp = torch.empty((B, max(T - 1, 1), NL), dtype=torch.int16, device=dev)
    err = lib.rss_pitch_viterbi_launch(
        local.data_ptr(), dist.contiguous().data_ptr(), B, T, NL, bp.data_ptr(), states.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, err, "pitch Viterbi kernel launch")
    pitch_viterbi.launches += 1
    return states


pitch_viterbi.launches = 0
