"""G2P pronunciation guessing: joint n-gram model FST decode.

Replaces the phonetisaurus binary (reference: phonetisaurus/phonetisaurus.cc
:96-164 main, include/PhonetisaurusScript.h:107-150 Phoneticize): the word
is lowered to a grapheme lattice (single characters plus any multi-character
clusters the model knows, joined by '|'), composed with the joint-ngram G2P
model FST, and the n shortest paths give the pronunciations. Output tokens
skip the epsilon/'_' markers; multi-phone clusters split on '|'.

guess_pronunciations mirrors the reference wrapper (g2p.py:296-329):
word -> list of phoneme lists, empty when the model can't phoneticize
(the trainer then maps the word to silence, kaldi.py:211-217).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

from ..fst.core import EPS_ID, Fst, SymbolTable
from ..fst.ops import compose, shortest_path

SKIP = "_"
SEQ_SEP = "|"


@dataclass
class G2PModel:
    """A loaded joint-ngram G2P model."""

    fst: Fst
    isymbols: SymbolTable
    osymbols: SymbolTable
    skip: str = SKIP
    seq_sep: str = SEQ_SEP
    _cluster_ids: Dict[str, int] = field(default_factory=dict)
    max_cluster: int = 1

    def __post_init__(self):
        for sym, sid in self.isymbols:
            if sid == 0 or sym in (self.skip,):
                continue
            parts = sym.split(self.seq_sep)
            self._cluster_ids[sym] = sid
            self.max_cluster = max(self.max_cluster, len(parts))

    @staticmethod
    def load(path: str) -> "G2PModel":
        from ..io.openfst import load_openfst

        fst = load_openfst(path)
        if fst.isymbols is None or fst.osymbols is None:
            raise ValueError(f"{path}: G2P model must embed symbol tables")
        return G2PModel(fst=fst, isymbols=fst.isymbols, osymbols=fst.osymbols)

    def _word_fst(self, word: str) -> Optional[Fst]:
        """Grapheme lattice over the word's characters with cluster arcs
        (PhonetisaurusScript.h entry construction)."""
        chars = list(word)
        n = len(chars)
        fst = Fst(isymbols=self.isymbols, osymbols=self.isymbols)
        fst.add_states(n + 1)
        fst.start = 0
        fst.set_final(n, 0.0)
        skip_id = self.isymbols.find(self.skip)
        any_arc = [False] * (n + 1)
        any_arc[n] = True
        for i in range(n):
            for length in range(1, min(self.max_cluster, n - i) + 1):
                token = self.seq_sep.join(chars[i : i + length])
                sid = self._cluster_ids.get(token)
                if sid is not None:
                    fst.add_arc(i, sid, sid, 0.0, i + length)
                    any_arc[i] = True
        if not all(any_arc):
            return None  # some character has no model symbol
        # The model may insert phones via its skip symbol on the input side
        if skip_id is not None:
            for i in range(n + 1):
                fst.add_arc(i, skip_id, skip_id, 0.0, i)
        return fst.arcsort("olabel")

    def phoneticize(
        self, word: str, nbest: int = 1, max_phones: int = 64
    ) -> List[Tuple[List[str], float]]:
        """word -> up to nbest (phonemes, score), best first."""
        word_fst = self._word_fst(word)
        if word_fst is None:
            return []
        lattice = compose(word_fst, self.fst)
        # unique=False: input sequences are all the same word — pronunciation
        # diversity lives on the output side, deduped below.
        best = shortest_path(lattice, nshortest=max(nbest * 2, nbest), unique=False)
        results: List[Tuple[List[str], float]] = []
        seen = set()
        for _ipath, opath, weight in best.paths(max_paths=nbest * 4):
            phones: List[str] = []
            for ol in opath:
                if ol == EPS_ID:
                    continue
                sym = self.osymbols.find_id(ol)
                if sym is None or sym == self.skip:
                    continue
                for phone in sym.split(self.seq_sep):
                    if phone and phone != self.skip:
                        phones.append(phone)
            key = tuple(phones)
            if not phones or key in seen or len(phones) > max_phones:
                continue
            seen.add(key)
            results.append((phones, weight))
        results.sort(key=lambda pw: pw[1])
        return results[:nbest]


def guess_pronunciations(
    words: Iterable[str],
    model: G2PModel,
    nbest: int = 1,
) -> Dict[str, List[List[str]]]:
    """Batch wrapper with the reference's output contract (g2p.py:296-329):
    word -> pronunciation lists; missing entries mean 'no pronunciation'."""
    out: Dict[str, List[List[str]]] = {}
    for word in words:
        prons = model.phoneticize(word, nbest=nbest)
        if prons:
            out[word] = [p for p, _w in prons]
    return out
