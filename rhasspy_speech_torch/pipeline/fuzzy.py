"""Fuzzy n-best matching + n-gram rescoring (host-side lattice tail).

get_fuzzy_text replaces transcribe_util.py:11-89: the n-best word-id
sequences become a union FST (rank r penalized +0.1*r), composed with the
lang's G.fuzzy; the shortest path's output labels are the matched grammar
sentence and its cost decides acceptance.

rescore_nbest replaces the lattice rescore chain
(transcribe_wav.py:107-202: lattice-scale --lm-scale=0.0 | ... |
lattice-compose --phi-label | lattice-add-trans-probs): exact on the n-best
list — each hypothesis' order-3 LM score is swapped for its higher-order
score by walking both backoff LMs with phi (#0) semantics.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence, Tuple

_LOGGER = logging.getLogger(__name__)

from ..fst.core import EPS_ID, INF, Fst, SymbolTable
from ..fst.ops import compose, ilabel_index, shortest_path

RANK_PENALTY = 0.1  # transcribe_util.py:36


def nbest_to_fst(nbest: Sequence[Sequence[int]]) -> Fst:
    """Union FST over n-best word-id sequences (transcribe_util.py:23-45)."""
    fst = Fst()
    start = fst.add_state()
    fst.start = start
    final = fst.add_state()
    fst.set_final(final, 0.0)
    for rank, words in enumerate(nbest):
        current = start
        penalty = RANK_PENALTY * rank
        if not words:
            fst.add_arc(start, EPS_ID, EPS_ID, penalty, final)
            continue
        for i, word in enumerate(words):
            nxt = final if i == len(words) - 1 else fst.add_state()
            fst.add_arc(current, word, word, penalty if i == 0 else 0.0, nxt)
            current = nxt
    return fst.arcsort("olabel")


def get_fuzzy_text(
    nbest: Sequence[Sequence[int]],
    g_fuzzy: Fst,
    words: SymbolTable,
) -> Optional[Tuple[str, float]]:
    """Best fuzzy grammar match for the n-best list: (text, cost) or None
    (transcribe_util.py:47-89: fstcompose | fstshortestpath | fstproject
    --project_type=output)."""
    if not nbest:
        return None
    nbest_fst = nbest_to_fst(nbest)
    # Serving-path amortization: index the (big) fuzzy FST once per object,
    # not once per utterance. Keyed on (num_states, num_arcs) so in-place
    # arc mutations invalidate the cache, not just added states.
    num_arcs = sum(len(a) for a in g_fuzzy.arcs)
    cached = getattr(g_fuzzy, "_rstpu_ilabel_index", None)
    if cached is not None and cached[0] == (g_fuzzy.num_states, num_arcs):
        index = cached[1]
    else:
        index = ilabel_index(g_fuzzy)
        g_fuzzy._rstpu_ilabel_index = ((g_fuzzy.num_states, num_arcs), index)
    composed = compose(nbest_fst, g_fuzzy, fst2_index=index)
    best = shortest_path(composed, nshortest=1)
    if best.start < 0 or best.num_states == 0:
        return None

    # Walk the single path, collecting output words and total cost
    out_words: List[str] = []
    cost = 0.0
    state = best.start
    visited = 0
    while best.finals[state] == INF:
        arcs = best.arcs[state]
        if not arcs:
            return None
        ilabel, olabel, weight, nextstate = arcs[0]
        cost += weight
        if olabel != EPS_ID:
            sym = words.find_id(olabel)
            if sym is not None:
                out_words.append(sym)
        state = nextstate
        visited += 1
        if visited > 100000:  # pragma: no cover
            raise RuntimeError("non-linear shortest-path result")
    cost += best.finals[state]
    return " ".join(out_words), cost


def lm_score(
    g: Fst,
    word_ids: Sequence[int],
    phi_label: int,
) -> float:
    """Cost of a word sequence through a backoff LM acceptor.

    Phi (#0) semantics: at each state, take the matching word arc if present,
    otherwise follow the backoff arc (accumulating its weight) and retry —
    the lattice-compose --phi-label behavior (lattice-functions.cc
    PhiCompose). Final weight resolves through backoff too."""
    if g.start < 0:
        return float("inf")

    # Arc lookup maps per state
    cost = 0.0
    state = g.start
    for word in word_ids:
        guard = 0
        while True:
            guard += 1
            if guard > 10000:
                return float("inf")
            match = None
            backoff = None
            for il, _ol, w, ns in g.arcs[state]:
                if il == word:
                    match = (w, ns)
                    break
                if il == phi_label:
                    backoff = (w, ns)
            if match is not None:
                cost += match[0]
                state = match[1]
                break
            if backoff is None:
                return float("inf")
            cost += backoff[0]
            state = backoff[1]

    # Final cost with backoff resolution
    guard = 0
    while g.finals[state] == INF:
        guard += 1
        if guard > 10000:
            return float("inf")
        backoff = None
        for il, _ol, w, ns in g.arcs[state]:
            if il == phi_label:
                backoff = (w, ns)
                break
        if backoff is None:
            return float("inf")
        cost += backoff[0]
        state = backoff[1]
    return cost + g.finals[state]


def rescore_nbest(
    nbest: Sequence[Tuple[List[int], float]],
    g_old: Fst,
    g_new: Fst,
    words: SymbolTable,
    meta_prefixes: Tuple[str, ...] = ("__", "#"),
) -> List[Tuple[List[int], float]]:
    """Swap each hypothesis' LM score: cost - lm_old(seq) + lm_new(seq).

    Meta output labels (base32 slot/sentence markers) are not LM events —
    they're excluded from the scoring sequence, mirroring how the reference
    rescores at the phone level where meta words map to silence."""
    phi = words.find("#0")
    assert phi is not None

    def scoring_seq(word_ids: List[int]) -> List[int]:
        out = []
        for w in word_ids:
            sym = words.find_id(w) or ""
            if sym.startswith(meta_prefixes):
                continue
            out.append(w)
        return out

    rescored = []
    for word_ids, cost in nbest:
        seq = scoring_seq(word_ids)
        old_lm = lm_score(g_old, seq, phi)
        new_lm = lm_score(g_new, seq, phi)
        if old_lm == float("inf") or new_lm == float("inf"):
            _LOGGER.warning(
                "Hypothesis %s is unscorable under the %s LM; keeping its "
                "original cost in the rescored ranking",
                [words.find_id(w) for w in word_ids],
                "old" if old_lm == float("inf") else "new",
            )
            rescored.append((word_ids, cost))
            continue
        rescored.append((word_ids, cost - old_lm + new_lm))
    rescored.sort(key=lambda x: x[1])
    return rescored
