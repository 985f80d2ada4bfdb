"""Viterbi decode kernel wrapper (``csrc/viterbi.cu``): the port of the TPU
kernel ``rhasspy_speech_tpu/ops/pallas_decoder.py:viterbi_pallas``.

``viterbi_decode`` launches the kernel for log-probs on a CUDA device and
runs the plain twin (``ops.decoder.viterbi`` + ``backtrace``) for log-probs
on the CPU; it never falls back from one to the other.
``viterbi_decode.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from .decoder import _COMPACT_BP_MAX_ARC, DecodeGraph, backtrace, viterbi

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = _build.load("viterbi")
    if lib.rss_viterbi_launch.argtypes is None:
        lib.rss_viterbi_launch.argtypes = (
            [_P] * 11 + [_F] + [_I] * 7 + [_P] * 5 + [_I, _I, _P]
        )
        lib.rss_viterbi_launch.restype = _I
        lib.rss_viterbi_max_states.argtypes = [_I]
        lib.rss_viterbi_max_states.restype = _I
    return lib


def _threads(num_states: int) -> int:
    return max(32, min(1024, -(-num_states // 32) * 32))


def viterbi_decode(
    graph: DecodeGraph,
    log_probs: torch.Tensor,
    acoustic_scale: float = 1.0,
    lengths: Optional[torch.Tensor] = None,
    return_forward: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Dense 1-best decode of [B, T, P] f32 log-probs.

    Returns (arc_trace [B, T] int32, final_state [B] int32, total_cost [B]
    f32), bit-identical to ``ops.decoder.viterbi_decode``; with
    ``return_forward`` also (alpha_final [B, S] f32, bps [T, B, S]) as
    ``ops.decoder.viterbi`` gives them (uint16 ``arc + 2`` when the graph
    has <= 65533 arcs, else int32)."""
    compact = graph.num_arcs <= _COMPACT_BP_MAX_ARC
    dev = log_probs.device
    if dev.type == "cpu":
        alpha, bps = viterbi(graph, log_probs, acoustic_scale, lengths, compact_bp=compact)
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
    S, A = graph.num_states, graph.num_arcs
    lib = _lib()
    max_states = lib.rss_viterbi_max_states(dev.index)
    if S > max_states:
        raise ValueError(
            f"viterbi kernel keeps alpha in shared memory: {S} states exceed "
            f"the {max_states} this card holds (big-graph decoders: ROADMAP)"
        )
    if lengths is None:
        lengths = torch.full((B,), T, dtype=torch.int32, device=dev)
    lengths = lengths.to(device=dev, dtype=torch.int32).contiguous()
    log_probs = log_probs.contiguous()
    bps = torch.empty((T, B, S), dtype=torch.uint16 if compact else torch.int32, device=dev)
    alpha = torch.empty((B, S), dtype=torch.float32, device=dev)
    trace = torch.empty((B, T), dtype=torch.int32, device=dev)
    final_state = torch.empty((B,), dtype=torch.int32, device=dev)
    total_cost = torch.empty((B,), dtype=torch.float32, device=dev)
    if B:
        err = lib.rss_viterbi_launch(
            log_probs.data_ptr(), lengths.data_ptr(),
            graph.init_weight.data_ptr(), graph.final_weight.data_ptr(),
            graph.in_ptr.data_ptr(), graph.in_src.data_ptr(),
            graph.in_weight.data_ptr(), graph.in_arc.data_ptr(),
            graph.in_pdf.data_ptr(), graph.src_pdf_i32.data_ptr(),
            graph.arc_src_i32.data_ptr(),
            -acoustic_scale, B, T, P, S, A, int(graph.folded), int(compact),
            bps.data_ptr(), alpha.data_ptr(), trace.data_ptr(),
            final_state.data_ptr(), total_cost.data_ptr(),
            _threads(S), dev.index,
            torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check(lib, err, "viterbi kernel launch")
        viterbi_decode.launches += 1
    out = (trace, final_state, total_cost)
    return out + (alpha, bps) if return_forward else out


viterbi_decode.launches = 0
