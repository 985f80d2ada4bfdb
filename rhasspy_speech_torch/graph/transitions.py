"""Transition table: per-arc HMM metadata for the dense decode graph.

Kaldi threads transition-ids through HCLG so lattices can recover phone
alignments and transition probabilities (transition-model.h:159,
lattice-to-phone-lattice.cc, lattice-add-trans-probs.cc). The dense TPU
graph works at the pdf level, but the phone-lattice rescore chain
(transcribe_wav.py:148-202) needs the same recoverability — so the HCLG
builders can intern each emitting arc's (pdf, phone, hmm position,
self-loop flag, unscaled transition cost) here and use the interned index
(+1) as the arc's input label. The index survives every FST transform
(connect/arcsort) because it rides the label, and the dense builder decodes
it back into parallel ``arc_phone`` / ``arc_tcost`` / ``arc_self`` arrays.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List


@dataclass(frozen=True)
class Transition:
    """One emitting HCLG arc kind within a phone's HMM chain."""

    pdf: int
    phone: int  # lang phone id owning the chain (phones.txt of the lang dir)
    is_self_loop: bool
    is_entry: bool  # first forward arc of the chain = phone boundary
    trans_cost: float  # unscaled -log transition probability


class TransitionTable:
    """Interns :class:`Transition` records; ilabel = index + 1 (0 = eps)."""

    def __init__(self) -> None:
        self.transitions: List[Transition] = []
        self._ids: Dict[Transition, int] = {}

    def ilabel(self, transition: Transition) -> int:
        idx = self._ids.get(transition)
        if idx is None:
            idx = len(self.transitions)
            self._ids[transition] = idx
            self.transitions.append(transition)
        return idx + 1

    def get(self, ilabel: int) -> Transition:
        return self.transitions[ilabel - 1]

    def __len__(self) -> int:
        return len(self.transitions)
