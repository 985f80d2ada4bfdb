"""Work counts and roofline bounds on an NVIDIA H100, frozen with the
benchmark so that no later change can move the yardstick.

The method and the numbers are those of ``rhasspy_speech_torch/utils/
roofline.py`` (each input read once, each output written once, the
operations these inputs need; the bound is the larger of the bytes' time at
the card's memory rate and the operations' time at its f32 peak, TF32 off),
taken here from plain shapes and the graph's own arrays instead of the
port's objects. The AM counts are new: the useful operations of an output
frame, each node computed once at each frame some output needs (Kaldi's
looped computation), matrix products only.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
COMPACT_BP_MAX_ARC = 65533


def bound(nbytes: float, nops: float, bytes_per_s: float = HBM_BYTES_PER_S,
          ops_per_s: float = F32_OPS_PER_S) -> Tuple[float, str]:
    """(bound_ms, bound_by)."""
    t_bytes, t_ops = nbytes / bytes_per_s * 1e3, nops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mel_terms(mel: np.ndarray) -> int:
    """Weights the mel filters span, each from its first to its last
    nonzero bin (in f32, as the kernel stores them)."""
    total = 0
    for col in np.asarray(mel, np.float32).T:
        nz = np.flatnonzero(col)
        total += int(nz[-1]) + 1 - int(nz[0]) if nz.size else 0
    return total


def mfcc_work(N: int, L: int, M: int, C: int, terms: int, B: int, S: int, T: int) -> Tuple[int, int]:
    """(bytes, f32 operations) of the MFCC kernel at a power-of-two padded
    window ``N``, frame length ``L``, ``M`` mel bins, ``C`` cepstra: PCM in,
    cepstra out; per frame the DC removal, pre-emphasis and window, the
    real FFT as an N/2-point complex FFT (10 operations a radix-2
    butterfly) and its split, the mel bands, log, DCT and lifter."""
    H = N // 2
    if H & (H - 1):
        raise ValueError(f"mfcc_work counts a power-of-two window, got N={N}")
    spectrum = 10 * (H // 2) * (H.bit_length() - 1) + 14 * (H + 1)
    per_frame = 5 * L + spectrum + 2 * terms + M + 2 * M * C + C
    return 4 * B * S + 4 * B * T * C, B * T * per_frame


def graph_reads(arc_src: np.ndarray, arc_pdf: np.ndarray, arc_dst: np.ndarray,
                num_states: int) -> Tuple[bool, np.ndarray]:
    """(folded, pdfs read): a graph is folded when every state's out-arcs
    carry one pdf (the kernel reads it once a state); else it reads each
    arc's pdf in the order of the destinations' in-arcs."""
    sp = np.full(num_states, -1, dtype=np.int64)
    sp[arc_src] = arc_pdf
    if (sp[arc_src] == arc_pdf).all():
        return True, np.where(sp < 0, 0, sp)
    return False, arc_pdf[np.argsort(arc_dst, kind="stable")]


def viterbi_work(arc_src, arc_dst, arc_pdf, num_states: int, B: int, T: int, P: int,
                 lengths: Sequence[int]) -> Tuple[int, int]:
    """(bytes, f32 operations) of one decode: the graph's tables, of each
    stream's active frames the log-probs at the pdfs the graph reads (as the
    32-byte sectors holding them), backpointers for every frame, the final
    alpha, traces, final state and cost; per active frame an add, a min and
    a compare an arc and the fold a state."""
    S, A = num_states, int(arc_src.shape[0])
    folded, pdfs = graph_reads(arc_src, arc_pdf, arc_dst, S)
    sectors = [int(np.unique((pdfs + o) // 8).size) for o in range(8)]
    lens = [min(int(n), T) for n in lengths]
    log_probs = 32 * sum(sectors[((b * T + t) * P) % 8] for b in range(B) for t in range(lens[b]))
    bp = 2 if A <= COMPACT_BP_MAX_ARC else 4
    nbytes = (4 * B + 8 * A + 4 * (S + 1) + 8 * S + (2 * S if folded else 4 * A) + log_probs
              + bp * T * B * S + 4 * B * S + 4 * B * T + 8 * B)
    return nbytes, sum(lens) * (3 * A + 2 * S)


# -- acoustic models: useful operations an output frame ----------------------


def needed_rows(layers: List[Tuple[str, int, int, Sequence[int]]], sub: int) -> Dict[str, int]:
    """Rows a layer computes an output frame, in the steady state: the
    residues (mod ``sub``) of the times some output needs, found from the
    output (residue 0) back through each layer's time offsets. ``layers``
    are (name, in_dim, out_dim, offsets of its input) from input to output;
    each layer reads the one before it."""
    need = {0}
    rows: Dict[str, int] = {}
    for name, _i, _o, offsets in reversed(layers):
        rows[name] = len(need)
        need = {(r + o) % sub for r in need for o in offsets}
    return rows


def flops_per_frame(layers: List[Tuple[str, int, int, Sequence[int]]], sub: int = 3) -> int:
    rows = needed_rows(layers, sub)
    return 2 * sum(rows[name] * i * o for name, i, o, _ in layers)


def am_flops_per_frame(family: str, args: Dict) -> int:
    """Useful AM operations an output frame, from the family's products
    (``reference/nets/<family>.py:products``)."""
    from benchmark.reference import nets

    return flops_per_frame(nets.load(family).products(args))
