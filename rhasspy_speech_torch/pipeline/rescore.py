"""Lattice-level ARPA rescore: map a decode lattice onto a new lang dir.

Replaces the reference's rescore pipeline
(rhasspy_speech/transcribe_wav.py:148-202):

    lattice-scale --lm-scale=0.0          -> Lattice keeps split costs;
    lattice-to-phone-lattice              -> Lattice.to_phone_fst (graph
    lattice-add-trans-probs                  scores dropped, phones from the
      --transition-scale=1 --self-loop=0.1   dense graph's entry tags, HMM
                                             transition probs re-added)
    lattice-compose Ldet.fst              -> compose with the new lang's
                                             deterministic phones→words map
    lattice-compose --phi-label=#0 G.fst  -> phi composition with the new G
    lattice-to-nbest | nbest-to-linear    -> output-projected n-shortest

Because the whole phone lattice is remapped — not a first-pass n-best
list — hypotheses outside the first pass's n-best (including words that
do not exist in the decode graph's vocabulary) are recoverable, exactly
like the reference's chain.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Tuple

from ..fst.core import EPS_ID, Fst, SymbolTable
from ..fst.ops import compose, rmepsilon, shortest_path
from .artifacts import LangArtifacts

_LOGGER = logging.getLogger(__name__)


def remap_symbols(
    fst: Fst,
    old_table: Optional[SymbolTable],
    new_table: Optional[SymbolTable],
    side: str = "input",
) -> Fst:
    """Relabel ``fst`` so ids under ``old_table`` become ids of the same
    symbol under ``new_table``. No-op when either table is missing or they
    assign identical ids. Arcs whose symbol is absent from ``new_table``
    are REMOVED (with a warning): eliding the phone would let a hypothesis
    match a wrong word with that phone silently deleted, so the path must
    die instead. Pure: the input FST is never mutated."""
    if old_table is None or new_table is None:
        return fst

    mapping = {}
    missing_names = []
    missing_ids = set()
    for name, old_id in old_table:
        if old_id == 0:
            continue
        new_id = new_table.find(name)
        if new_id is None:
            missing_names.append(name)
            missing_ids.add(old_id)
        elif new_id != old_id:
            mapping[old_id] = new_id
    if missing_names:
        _LOGGER.warning(
            "%d symbols missing from the target table (arcs dropped): %s",
            len(missing_names),
            missing_names[:8],
        )
        check = (0,) if side == "input" else (1,) if side == "output" else (0, 1)
        from ..fst.core import Fst

        fst = Fst(
            arcs=[
                [
                    arc
                    for arc in state_arcs
                    if not any(arc[idx] in missing_ids for idx in check)
                ]
                for state_arcs in fst.arcs
            ],
            finals=list(fst.finals),
            start=fst.start,
            isymbols=fst.isymbols,
            osymbols=fst.osymbols,
        )
    if not mapping:
        return fst
    return fst.relabel(
        ipairs=mapping if side in ("input", "both") else None,
        opairs=mapping if side in ("output", "both") else None,
    )


def rescore_lattice(
    lattice,  # ops.lattice.Lattice
    graph,  # graph.dense.DenseGraph (the decode graph, with phone metadata)
    decode_phones: Optional[SymbolTable],
    new_lang: LangArtifacts,
    nbest: int = 5,
    transition_scale: float = 1.0,
    self_loop_scale: float = 0.1,
) -> List[Tuple[List[int], float]]:
    """N-best (new-lang word ids, cost) via the phone-lattice rescore chain.

    ``decode_phones`` is the phone table of the lang that built ``graph``;
    phone ids are remapped by name onto ``new_lang.phones`` before the Ldet
    composition (the reference can assume identical tables because both
    lang dirs come from one training run; remapping keeps this exact even
    when they don't)."""
    if new_lang.ldet is None:
        raise ValueError(
            "new lang dir has no ldet.fst — retrain it to enable "
            "lattice-level rescoring"
        )
    if new_lang.g_fst is None:
        raise ValueError("new lang dir has no G.fst")
    phi = new_lang.words.find("#0")

    phone_fst = lattice.to_phone_fst(
        graph, transition_scale=transition_scale, self_loop_scale=self_loop_scale
    )
    # Phones ride both sides of the acceptor
    phone_fst = remap_symbols(phone_fst, decode_phones, new_lang.phones, "both")

    words_fst = compose(phone_fst, new_lang.ldet)
    if words_fst.start < 0:
        return []

    if phi is not None:
        rescored = compose(words_fst, new_lang.g_fst, phi_label=phi)
    else:
        rescored = compose(words_fst, new_lang.g_fst)
    if rescored.start < 0:
        return []

    # lattice-to-nbest: unique word sequences by cost. shortest_path dedups
    # by input labels, so project to the word side first.
    acceptor = rmepsilon(rescored.project("output"))
    best = shortest_path(acceptor, nshortest=nbest, unique=True)

    results: List[Tuple[List[int], float]] = []
    seen = set()
    for _ipath, opath, weight in sorted(
        best.paths(max_paths=max(nbest * 6, 32)), key=lambda p: p[2]
    ):
        words = [o for o in opath if o != EPS_ID]
        key = tuple(words)
        if key in seen:
            continue
        seen.add(key)
        results.append((words, weight))
        if len(results) >= nbest:
            break
    return results


def rescore_tail(
    hyp_list: List[Tuple[List[int], float]],
    old_lang: LangArtifacts,
    new_lang: LangArtifacts,
    max_fuzzy_cost: Optional[float] = None,
    require_fuzzy: bool = False,
) -> List[str]:
    """The reference's post-rescore tail (transcribe_wav.py:205-231): fuzzy
    compose of the rescored n-best against the OLD lang's G.fuzzy; accept
    a match under ``max_fuzzy_cost``, else fall through to the rescored
    texts (or [] with ``require_fuzzy``). Word ids are the NEW lang's; they
    are remapped by name when the vocabularies differ."""
    from ..grammar.fst import decode_meta
    from .fuzzy import get_fuzzy_text

    if old_lang.g_fuzzy is not None and hyp_list:
        id_map = None
        if new_lang.words is not old_lang.words:
            id_map = {
                new_id: old_lang.words.find(name)
                for name, new_id in new_lang.words
            }
        seqs = []
        for ids, _cost in hyp_list:
            if id_map is None:
                seqs.append(list(ids))
            else:
                seqs.append([id_map[w] for w in ids if id_map.get(w) is not None])
        fuzzy = get_fuzzy_text(seqs, old_lang.g_fuzzy, old_lang.words)
        if fuzzy is not None:
            text, cost = fuzzy
            _LOGGER.debug("Fuzzy (rescore): %r cost=%.3f", text, cost)
            if max_fuzzy_cost is not None and cost <= max_fuzzy_cost:
                return [decode_meta(text)]
    if require_fuzzy:
        return []

    def ids_to_text(ids) -> str:
        return " ".join(
            new_lang.words.find_id(w) or f"<{w}>" for w in ids if w != 0
        )

    return [decode_meta(ids_to_text(ids)) for ids, _cost in hyp_list]
