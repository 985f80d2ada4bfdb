"""HMM topology and transition model.

Covers the role of Kaldi's HmmTopology/TransitionModel
(kaldi/src/hmm/transition-model.h:123, hmm-utils.h:34-77) for
graph construction: mapping phones to HMM state sequences, pdf ids and
transition log-probs. Two built-in topologies:

- ``chain``: one emitting state per phone with distinct forward/self-loop
  pdfs (Kaldi chain-model topology; frame_subsampling_factor handled by the
  acoustic model, self-loop-scale 1.0 per kaldi.py:419-421).
- ``bakis3``: classic 3-state left-to-right HMM with shared pdf per state.

The decode product works at the pdf level: the dense graph stores pdf ids
directly instead of Kaldi's transition-id indirection (transition-ids exist
to recover alignments, which are not part of this system's outputs; phones
for the rescore path are recovered from arc metadata instead).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple
import math


@dataclass
class HmmState:
    """One emitting HMM state: forward/self-loop pdf-classes and the
    transition log-probs (natural log, as costs when negated)."""

    forward_pdf_class: int
    self_loop_pdf_class: Optional[int]
    forward_prob: float
    self_loop_prob: float


@dataclass
class PhoneTopology:
    """Topology entry for a set of phones."""

    states: List[HmmState]


@dataclass
class Topology:
    """Maps phone id -> topology entry."""

    entries: Dict[int, PhoneTopology] = field(default_factory=dict)

    @staticmethod
    def chain(phone_ids: Sequence[int]) -> "Topology":
        """Chain topology: 1 emitting state, separate self-loop pdf."""
        entry = PhoneTopology(
            states=[
                HmmState(
                    forward_pdf_class=0,
                    self_loop_pdf_class=1,
                    forward_prob=0.5,
                    self_loop_prob=0.5,
                )
            ]
        )
        return Topology(entries={p: entry for p in phone_ids})

    @staticmethod
    def bakis3(phone_ids: Sequence[int]) -> "Topology":
        """3-state left-to-right topology (gen_topo.pl defaults)."""
        entry = PhoneTopology(
            states=[
                HmmState(0, 0, forward_prob=0.25, self_loop_prob=0.75),
                HmmState(1, 1, forward_prob=0.25, self_loop_prob=0.75),
                HmmState(2, 2, forward_prob=0.25, self_loop_prob=0.75),
            ]
        )
        return Topology(entries={p: entry for p in phone_ids})


@dataclass
class TransitionModel:
    """Phone/state -> pdf mapping for a context-independent model.

    ``pdf_map[phone_id]`` is a list over HMM states of
    (forward_pdf, self_loop_pdf). For context-dependent models the same
    structure is keyed by the context window's leaf (see graph/hclg.py).
    """

    topology: Topology
    pdf_map: Dict[int, List[Tuple[int, int]]] = field(default_factory=dict)
    num_pdfs: int = 0

    @staticmethod
    def monophone(topology: Topology) -> "TransitionModel":
        """Assign pdf ids densely over (phone, state, fwd/self)."""
        pdf_map: Dict[int, List[Tuple[int, int]]] = {}
        next_pdf = 0
        for phone_id in sorted(topology.entries):
            entry = topology.entries[phone_id]
            state_pdfs: List[Tuple[int, int]] = []
            for state in entry.states:
                forward_pdf = next_pdf
                next_pdf += 1
                if state.self_loop_pdf_class is not None and (
                    state.self_loop_pdf_class != state.forward_pdf_class
                ):
                    self_pdf = next_pdf
                    next_pdf += 1
                else:
                    self_pdf = forward_pdf
                state_pdfs.append((forward_pdf, self_pdf))
            pdf_map[phone_id] = state_pdfs
        return TransitionModel(topology=topology, pdf_map=pdf_map, num_pdfs=next_pdf)

    def phone_states(self, phone_id: int) -> List[HmmState]:
        return self.topology.entries[phone_id].states

    def forward_cost(self, phone_id: int, state_idx: int, scale: float) -> float:
        prob = self.topology.entries[phone_id].states[state_idx].forward_prob
        return -scale * math.log(prob)

    def self_loop_cost(self, phone_id: int, state_idx: int, scale: float) -> float:
        prob = self.topology.entries[phone_id].states[state_idx].self_loop_prob
        return -scale * math.log(prob)
