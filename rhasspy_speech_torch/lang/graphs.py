"""Word-level decode-graph construction: G.fst variants and LG.

Replaces the reference's G-building pipelines
(rhasspy_speech/kaldi.py:311-407 and mkgraph.sh:100-101):

- :func:`make_grammar_g`: fstcompile | fstproject --project_type=input |
  fstdeterminize | fstminimize | fstarcsort  → the rigid grammar G.fst.
- :func:`make_fuzzy_g`: copy of G's text form plus per-state self loops
  (<eps> free, every vocab word deletable at cost 1.0) used for fuzzy
  transcript matching.
- :func:`make_lg`: fsttablecompose(L_disambig, G) | fstdeterminizestar |
  fstminimizeencoded | fstpushspecial.
"""

from __future__ import annotations

import io
from typing import Iterable, TextIO, Union

from ..fst.core import EPS_ID, Fst, SymbolTable
from ..fst.determinize import determinize, determinize_star, minimize, minimize_encoded
from ..fst.ops import compose, push
from .lexicon_fst import Lang


def compile_text_fst(
    text: Union[str, TextIO], words: SymbolTable
) -> Fst:
    """fstcompile the grammar compiler's text FST with word symbols."""
    fileobj = io.StringIO(text) if isinstance(text, str) else text
    return Fst.from_text(fileobj, isymbols=words, osymbols=words)


def make_grammar_g(text_fst: Union[str, TextIO], words: SymbolTable) -> Fst:
    """Rigid-grammar G.fst (kaldi.py:311-341). Projection onto the input
    side drops meta output labels before determinization."""
    fst = compile_text_fst(text_fst, words)
    fst.project("input")
    fst = determinize(fst)
    fst = minimize(fst)
    return fst.arcsort("ilabel")


def make_fuzzy_g(
    g_fst: Fst,
    vocab: Iterable[str],
    words: SymbolTable,
    self_loops: bool = True,
) -> Fst:
    """Fuzzy-match FST (kaldi.py:343-407): G plus self loops on every state —
    a free <eps> loop and a cost-1.0 word:<eps> deletion loop for each
    non-meta vocab word. The grammar lang uses self_loops=False (plain copy,
    kaldi.py:131-132), the ARPA lang self_loops=True (:134-136)."""
    fuzzy = g_fst.copy()
    if not self_loops:
        return fuzzy.arcsort("ilabel")
    word_ids = []
    for word in vocab:
        if word[0] in ("<", "_"):
            continue  # meta words are never deletable
        word_id = words.find(word)
        if word_id is not None:
            word_ids.append(word_id)

    # Only states that had outgoing arcs or finality in the text form exist
    # here; loop every state like the reference does.
    for state in range(fuzzy.num_states):
        fuzzy.add_arc(state, EPS_ID, EPS_ID, 0.0, state)
        for word_id in word_ids:
            fuzzy.add_arc(state, word_id, EPS_ID, 1.0, state)

    return fuzzy.arcsort("ilabel")


def push_special(fst: Fst) -> Fst:
    """fstpushspecial stand-in. Kaldi's version redistributes weights so
    every state's outgoing mass is a constant; any reweighting preserves
    per-path totals up to a constant, so plain tropical weight pushing is a
    behavior-equivalent substitute for best-path decoding."""
    return push(fst)


def make_lg(lang: Lang, g_fst: Fst) -> Fst:
    """LG = pushspecial(minimizeencoded(determinizestar(L_disambig ∘ G)))
    (mkgraph.sh:100-101)."""
    lg = compose(lang.L_disambig, g_fst)
    lg = determinize_star(lg)
    lg = minimize_encoded(lg)
    lg = push_special(lg)
    return lg.arcsort("ilabel")


def make_ldet(lang: Lang) -> Fst:
    """Ldet.fst: a deterministic phones→words map for phone-lattice
    composition (reference transcribe_wav.py:131-142: fstprint L_disambig |
    drop #0-output arcs | fstdeterminizestar | fstrmsymbols disambig).

    The #0 pass-through loop is removed, the result is determinized with
    the lexicon disambiguation symbols still present (what makes it
    determinizable), then the disambig symbols become epsilons and are
    folded away."""
    stripped = Fst(isymbols=lang.phones, osymbols=lang.words)
    stripped.add_states(lang.L_disambig.num_states)
    stripped.start = lang.L_disambig.start
    for state in range(lang.L_disambig.num_states):
        stripped.finals[state] = lang.L_disambig.finals[state]
        for il, ol, w, ns in lang.L_disambig.arcs[state]:
            if ol == lang.wdisambig_word:
                continue
            stripped.add_arc(state, il, ol, w, ns)

    ldet = determinize_star(stripped.connect())
    ldet = ldet.rm_symbols(lang.disambig_phone_ids, side="input")
    from ..fst.ops import rmepsilon

    return rmepsilon(ldet).arcsort("ilabel")
