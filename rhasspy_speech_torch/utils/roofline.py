"""Work counts and roofline bounds of the port's device functions on the card.

One counting method for every figure the repository states against a bound
(``chip_smoke.py``'s kernel table, ``examples/decode_roofline.py``): each
input read once, each output written once, and the operations the function
needs for this call's inputs (where the work depends on the data, what
these inputs need, not the most they could). The bound is the larger of
the bytes' time at the card's memory rate and the operations' time at its
peak rate; the rates are NVIDIA's published H100 SXM figures at 700 W
(dense, no sparsity), TF32 off as ``models/nnet3.py`` keeps it.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from ..ops.decoder import _COMPACT_BP_MAX_ARC
from ..ops.mfcc_cuda import mel_bands

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
# nnet3 component types whose forward is a matrix product (``_component_forward``)
MATMUL_COMPONENTS = frozenset((
    "AffineComponent", "NaturalGradientAffineComponent", "FixedAffineComponent",
    "LinearComponent", "TdnnComponent",
))


def bound(nbytes: float, nops: float, bytes_per_s: float = HBM_BYTES_PER_S,
          ops_per_s: float = F32_OPS_PER_S) -> Tuple[float, str]:
    """(bound_ms, bound_by): the larger of the bytes' time at the card's
    memory rate and the operations' time at its peak rate (f32 unless
    ``ops_per_s`` says otherwise)."""
    t_bytes, t_ops = nbytes / bytes_per_s * 1e3, nops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mfcc_work(params, B: int, S: int, T: int) -> Tuple[int, int]:
    """(bytes, f32 operations) of the MFCC kernel's function at a
    power-of-two or odd window: PCM in, cepstra out; per frame the DC
    removal, pre-emphasis and window (and energy), the power spectrum, the
    mel bands, log, DCT and lifter. At a power of two the spectrum is the
    real FFT as an N/2-point complex FFT (10 operations a radix-2
    butterfly) and its split. At an odd N the kernel runs Bluestein's
    algorithm over radix-2 FFTs of 2N - 1 points and more; the bound counts
    less than that or Rader's algorithm (about twice as much at N = 401):
    the nominal 5 N log2 N operations of an N-point complex FFT of the two
    frames packed as one sequence, then the split into the two frames'
    H + 1 bins (4 operations a bin) and the power (3 a bin)."""
    cfg = params.cfg
    N, L, M, C = cfg.padded_window_size, cfg.frame_length, cfg.num_mel_bins, cfg.num_ceps
    H = N // 2
    if N % 2:
        spectrum = round(5 * N * math.log2(N) / 2) + 7 * (H + 1)
    elif H & (H - 1) == 0:
        spectrum = 10 * (H // 2) * (H.bit_length() - 1) + 14 * (H + 1)
    else:
        raise ValueError(f"mfcc_work counts a power-of-two or odd window, got N={N}")
    mel_terms = int(mel_bands(params.mel_weights.cpu().numpy())[0][-1])
    per_frame = (
        5 * L + (2 * L if cfg.use_energy else 0) + spectrum
        + 2 * mel_terms + M + 2 * M * C + C
    )
    return 4 * B * S + 4 * B * T * C, B * T * per_frame


def viterbi_bytes(graph, B: int, T: int, P: int, lengths: torch.Tensor) -> Dict[str, int]:
    """The bytes of one decode (K2) by part. In: the lengths, the graph's
    tables (packed source, arc id and weight per arc, row pointers, initial
    and final weights, and the per-state pdf when folded or the per-arc pdf
    when not), and of each stream's active frames only the log-probs at the
    pdfs the graph reads, counted as the 32-byte sectors that hold them
    (the card reads no less). Out: backpointers for every frame (STAY past
    a stream's end), final alpha, traces, final state and cost."""
    S, A = graph.num_states, graph.num_arcs
    pdfs = (graph.src_pdf if graph.folded else graph.in_pdf).long()
    # sectors a row touches, by the row's start offset in floats mod 8
    # (torch allocations start on a sector)
    sectors = [int(torch.unique((pdfs + o) // 8).numel()) for o in range(8)]
    lens = lengths.clamp(max=T).tolist()
    bp_bytes = 2 if A <= _COMPACT_BP_MAX_ARC else 4
    return {
        "lengths": 4 * B,
        "graph": 8 * A + 4 * (S + 1) + 8 * S + (2 * S if graph.folded else 4 * A),
        "log_probs": 32 * sum(sectors[((b * T + t) * P) % 8] for b in range(B) for t in range(lens[b])),
        "backpointers": bp_bytes * T * B * S,
        "alpha": 4 * B * S,
        "traces": 4 * B * T,
        "final_state_and_cost": 8 * B,
    }


def viterbi_work(graph, B: int, T: int, P: int, lengths: torch.Tensor) -> Tuple[int, int]:
    """(bytes, f32 operations) of one decode: ``viterbi_bytes`` summed; per
    active frame an add, a min and a compare per arc and the fold per
    state."""
    lens = lengths.clamp(max=T).tolist()
    nbytes = sum(viterbi_bytes(graph, B, T, P, lengths).values())
    return nbytes, sum(lens) * (3 * graph.num_arcs + 2 * graph.num_states)


def windowed_relax_work(T: int, B: int, S: int, nstep: int) -> Tuple[int, int]:
    """(bytes, f32 operations) of the windowed relaxation: step tables in,
    uint16 backpointers and alpha out; 3 operations a lane a step."""
    nbytes = 8 * nstep + 12 * nstep * 128 + 2 * T * B * S + 4 * B * S
    return nbytes, 3 * T * B * nstep * 128


def pitch_work(B: int, T: int, NL: int) -> Tuple[int, int]:
    """(bytes, f32 operations) of the pitch-lag Viterbi: local costs and
    the distance table in, states out; an add and a compare a candidate j
    for each output i of each step."""
    return 4 * B * T * NL + 4 * NL + 4 * B * T, 2 * B * (T - 1) * NL * NL


def am_work(model, B: int, in_shape: Tuple[int, ...], ivector_dim: int) -> Tuple[int, int]:
    """(bytes, operations) of a feed-forward nnet3 forward (``CompiledNnet3``)
    over ``B`` streams: 2 x the multiply-adds of its matrix-product
    components over the rows its plan computes (a node's [lo, hi) range),
    in the model's compute dtype; bytes: every parameter read once, the
    f32 features ``in_shape`` ([frames, dims] a stream) and i-vectors
    read once, the f32 log-probs written once."""
    plan = model.plan
    if plan.recurrent:
        raise ValueError("am_work counts feed-forward plans")
    macs = 0
    for node in plan.order:
        if node.kind != "component":
            continue
        if plan.spec.components[node.component].type in MATMUL_COMPONENTS:
            lo, hi = plan.ranges[node.name]
            macs += B * (hi - lo) * model.component_params(node.component)["w"].numel()
    weights = sum(b.numel() * b.element_size() for b in model.buffers())
    frames, dims = in_shape
    out_dim = plan.node_dims[plan.output_name]
    nbytes = weights + 4 * B * (frames * dims + ivector_dim) + 4 * B * plan.num_out_frames * out_dim
    return nbytes, 2 * macs
