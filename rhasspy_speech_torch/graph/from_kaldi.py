"""Adapter: parsed Kaldi TransitionModel -> graph-layer TransitionModel.

Bridges final.mdl's phone inventory (model phones.txt names) onto a compiled
Lang's phone ids so HCLG expansion emits the acoustic model's real pdf ids.
Covers the monophone/context-size-1 case; context-dependent trees are a
separate adapter (io/tree.py) once real tree files are in scope.
"""

from __future__ import annotations

import math
from typing import Dict

from ..fst.core import SymbolTable
from ..io.transition_model import K_NO_PDF, KaldiTransitionModel
from .topology import HmmState, PhoneTopology, Topology, TransitionModel


def transition_model_from_kaldi(
    ktm: KaldiTransitionModel,
    model_phones: SymbolTable,
    lang_phones: SymbolTable,
) -> TransitionModel:
    """Build the graph-layer TransitionModel keyed by *lang* phone ids.

    model_phones: the acoustic model's phones.txt (name -> kaldi phone id).
    lang_phones: the compiled Lang's phone table. Every lang phone that is
    not a disambiguation symbol must exist in the model's table.
    """
    # kaldi phone id -> list over hmm states of (fwd pdf, self pdf)
    pdf_by_kaldi_phone: Dict[int, Dict[int, tuple]] = {}
    for row in ktm.tuples:
        phone, hmm_state, fwd, slf = (int(x) for x in row)
        pdf_by_kaldi_phone.setdefault(phone, {})[hmm_state] = (fwd, slf)

    entries: Dict[int, PhoneTopology] = {}
    pdf_map: Dict[int, list] = {}

    for name, lang_pid in lang_phones:
        if lang_pid == 0 or name.startswith("#"):
            continue
        kaldi_pid = model_phones.find(name)
        if kaldi_pid is None:
            raise KeyError(f"phone {name!r} missing from the model's phones.txt")
        topo_entry = ktm.topology.entry_for_phone(kaldi_pid)
        states = []
        state_pdfs = []
        for idx, st in enumerate(topo_entry):
            if st.forward_pdf_class == K_NO_PDF:
                continue  # final non-emitting state
            # transition probs: self-loop = arc to same state; forward = rest
            self_prob = 0.0
            fwd_prob = 0.0
            for dst, prob in st.transitions:
                if dst == idx:
                    self_prob += prob
                else:
                    fwd_prob += prob
            fwd_prob = fwd_prob if fwd_prob > 0 else 1.0
            states.append(
                HmmState(
                    forward_pdf_class=st.forward_pdf_class,
                    self_loop_pdf_class=(
                        st.self_loop_pdf_class
                        if st.self_loop_pdf_class != K_NO_PDF
                        else None
                    ),
                    forward_prob=fwd_prob,
                    self_loop_prob=self_prob if self_prob > 0 else math.exp(-30),
                )
            )
            fwd_slf = pdf_by_kaldi_phone.get(kaldi_pid, {}).get(idx)
            if fwd_slf is None:
                raise KeyError(
                    f"no transition tuple for model phone {name!r} state {idx}"
                )
            state_pdfs.append(fwd_slf)
        entries[lang_pid] = PhoneTopology(states=states)
        pdf_map[lang_pid] = state_pdfs

    return TransitionModel(
        topology=Topology(entries=entries),
        pdf_map=pdf_map,
        num_pdfs=ktm.num_pdfs,
    )
