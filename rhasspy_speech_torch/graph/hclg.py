"""HCLG construction: expand LG phone arcs into HMM state chains.

Covers mkgraph.sh:113-151 (CLG/Ha/HCLGa/add-self-loops) for
context-independent models. Rather than materializing Ha and composing, each
LG phone arc is expanded in place into its HMM chain with forward/self-loop
pdf emissions — the composed result is identical for monophone context
(C = identity when context-size=1), and the reorder=true self-loop placement
(self-loop follows the forward transition into the state) falls out naturally:
the first frame of a phone emits the forward pdf, later frames the self-loop
pdf, matching Kaldi chain-graph semantics.

The product uses ilabel = pdf_id + 1 (0 stays epsilon) and olabel = word id.
"""

from __future__ import annotations

from typing import Optional, Set

from ..fst.core import EPS_ID, Fst
from ..lang.lexicon_fst import Lang
from .topology import TransitionModel
from .transitions import Transition, TransitionTable


def make_hclg(
    lang: Lang,
    lg: Fst,
    transition_model: TransitionModel,
    transition_scale: float = 1.0,
    self_loop_scale: float = 1.0,
    transitions: Optional[TransitionTable] = None,
) -> Fst:
    """Expand LG (phones -> words) into HCLG (pdfs+1 -> words).

    With ``transitions``, emitting arcs carry interned transition indices
    (+1) instead of pdf+1, preserving phone/transition-prob metadata for
    the lattice rescore chain (see graph/transitions.py)."""
    disambig: Set[int] = set(lang.disambig_phone_ids)

    hclg = Fst()
    hclg.add_states(lg.num_states)
    hclg.start = lg.start
    for state in range(lg.num_states):
        hclg.finals[state] = lg.finals[state]

    for state in range(lg.num_states):
        for ilabel, olabel, weight, nextstate in lg.arcs[state]:
            if ilabel == EPS_ID or ilabel in disambig:
                # Graph-only arc (epsilon / removed disambiguation symbol)
                hclg.add_arc(state, EPS_ID, olabel, weight, nextstate)
                continue

            phone = ilabel
            states = transition_model.phone_states(phone)
            pdfs = transition_model.pdf_map[phone]

            current = state
            for hmm_idx, hmm_state in enumerate(states):
                forward_pdf, self_pdf = pdfs[hmm_idx]
                forward_cost = transition_model.forward_cost(
                    phone, hmm_idx, transition_scale
                )
                loop_state = hclg.add_state()
                # First arc carries the word label and the LG weight
                arc_weight = weight + forward_cost if hmm_idx == 0 else forward_cost
                arc_olabel = olabel if hmm_idx == 0 else EPS_ID
                fwd_ilabel = forward_pdf + 1
                if transitions is not None:
                    fwd_ilabel = transitions.ilabel(
                        Transition(
                            pdf=forward_pdf,
                            phone=phone,
                            is_self_loop=False,
                            is_entry=(hmm_idx == 0),
                            trans_cost=transition_model.forward_cost(
                                phone, hmm_idx, 1.0
                            ),
                        )
                    )
                hclg.add_arc(current, fwd_ilabel, arc_olabel, arc_weight, loop_state)
                # Self loop: subsequent frames of this HMM state
                self_cost = transition_model.self_loop_cost(
                    phone, hmm_idx, self_loop_scale
                )
                self_ilabel = self_pdf + 1
                if transitions is not None:
                    self_ilabel = transitions.ilabel(
                        Transition(
                            pdf=self_pdf,
                            phone=phone,
                            is_self_loop=True,
                            is_entry=False,
                            trans_cost=transition_model.self_loop_cost(
                                phone, hmm_idx, 1.0
                            ),
                        )
                    )
                hclg.add_arc(loop_state, self_ilabel, EPS_ID, self_cost, loop_state)
                current = loop_state

            hclg.add_arc(current, EPS_ID, EPS_ID, 0.0, nextstate)

    return hclg.connect()
