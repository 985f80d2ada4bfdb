"""Lexicon → L.fst construction (prepare_lang equivalent).

Replaces the reference's recipe scripts
(kaldi/egs/wsj/s5/utils/prepare_lang.sh:172-539,
utils/lang/make_lexicon_fst.py:173-295, utils/add_lex_disambig.pl:85-197):

- position-dependent phone markers (_B/_E/_I/_S),
- lexicon disambiguation symbols #1..#N (identical prons / prefix prons),
- the optional-silence lexicon FST (sil_prob, default 0.5) with a silence
  disambiguation symbol on the L_disambig variant,
- #0 pass-through self-loops for the grammar's backoff symbol,
- words.txt / phones.txt symbol tables with the same ordering conventions
  (<eps>=0, then words sorted, then #0, <s>, </s>).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..fst.core import EPS_ID, Fst, SymbolTable

LexiconEntry = Tuple[str, List[str]]  # (word, phones)


def apply_position_markers(entries: Sequence[LexiconEntry]) -> List[LexiconEntry]:
    """Add _B/_E/_I/_S word-position suffixes (prepare_lang.sh:172-189)."""
    marked: List[LexiconEntry] = []
    for word, phones in entries:
        if not phones:
            marked.append((word, []))
        elif len(phones) == 1:
            marked.append((word, [phones[0] + "_S"]))
        else:
            marked.append(
                (
                    word,
                    [phones[0] + "_B"]
                    + [p + "_I" for p in phones[1:-1]]
                    + [phones[-1] + "_E"],
                )
            )
    return marked


def add_lex_disambig(
    entries: Sequence[LexiconEntry],
) -> Tuple[List[Tuple[str, List[str], Optional[int]]], int]:
    """Assign disambiguation symbols (add_lex_disambig.pl:85-197).

    A pronunciation needs a disambig symbol if it occurs more than once or
    is a prefix of another pronunciation. Returns entries with an optional
    disambig number appended, and the max disambig number used.
    """
    counts: Dict[Tuple[str, ...], int] = {}
    is_prefix: Dict[Tuple[str, ...], bool] = {}
    for _, phones in entries:
        key = tuple(phones)
        counts[key] = counts.get(key, 0) + 1
        for i in range(len(phones) - 1, -1, -1):
            is_prefix[tuple(phones[:i])] = True

    max_disambig = 0
    last_used: Dict[Tuple[str, ...], int] = {}
    result: List[Tuple[str, List[str], Optional[int]]] = []

    for word, phones in entries:
        key = tuple(phones)
        if key not in is_prefix and counts[key] == 1:
            result.append((word, list(phones), None))
            continue

        cur = last_used.get(key)
        cur = 1 if cur is None else cur + 1
        max_disambig = max(max_disambig, cur)
        last_used[key] = cur
        result.append((word, list(phones), cur))

    return result, max_disambig


def make_lexicon_fst(
    entries: Sequence[Tuple[str, List[str], Optional[int]]],
    phones: SymbolTable,
    words: SymbolTable,
    sil_phone: str,
    sil_prob: float = 0.5,
    sil_disambig: Optional[str] = None,
    pron_prob: float = 1.0,
) -> Fst:
    """Build L.fst with optional silence (make_lexicon_fst.py:222-295).

    Each word leaves the loop state; silence (cost -log(sil_prob)) or no
    silence (cost -log(1-sil_prob)) may follow each word and precede the
    first. When sil_disambig is given, the silence arc is followed by it
    (the L_disambig variant, for cyclic G determinizability).
    """
    assert 0.0 < sil_prob < 1.0
    sil_cost = -math.log(sil_prob)
    no_sil_cost = -math.log(1.0 - sil_prob)
    pron_cost = -math.log(pron_prob)

    fst = Fst(isymbols=phones, osymbols=words)
    start = fst.add_state()  # 0
    loop = fst.add_state()  # 1
    sil = fst.add_state()  # 2
    fst.start = start

    sil_phone_id = phones.find(sil_phone)
    assert sil_phone_id is not None, f"Unknown silence phone {sil_phone}"

    fst.add_arc(start, EPS_ID, EPS_ID, no_sil_cost, loop)
    fst.add_arc(start, EPS_ID, EPS_ID, sil_cost, sil)
    if sil_disambig is None:
        fst.add_arc(sil, sil_phone_id, EPS_ID, 0.0, loop)
    else:
        sil_disambig_id = phones.find(sil_disambig)
        assert sil_disambig_id is not None
        mid = fst.add_state()
        fst.add_arc(sil, sil_phone_id, EPS_ID, 0.0, mid)
        fst.add_arc(mid, sil_disambig_id, EPS_ID, 0.0, loop)

    for word, phone_seq, disambig in entries:
        word_id = words.find(word)
        assert word_id is not None, f"Word missing from table: {word}"
        labels = [phones.find(p) for p in phone_seq]
        assert all(l is not None for l in labels), (word, phone_seq)
        if disambig is not None:
            disambig_id = phones.find(f"#{disambig}")
            assert disambig_id is not None
            labels = labels + [disambig_id]

        current = loop
        for i in range(len(labels) - 1):
            nxt = fst.add_state()
            fst.add_arc(
                current,
                labels[i],
                word_id if i == 0 else EPS_ID,
                pron_cost if i == 0 else 0.0,
                nxt,
            )
            current = nxt

        i = len(labels) - 1  # -1 when empty pronunciation
        last_phone = labels[i] if i >= 0 else EPS_ID
        last_word = word_id if i <= 0 else EPS_ID
        last_cost = pron_cost if i <= 0 else 0.0
        fst.add_arc(current, last_phone, last_word, no_sil_cost + last_cost, loop)
        fst.add_arc(current, last_phone, last_word, sil_cost + last_cost, sil)

    fst.set_final(loop, 0.0)
    return fst.arcsort("olabel")


@dataclass
class Lang:
    """A compiled lang directory (prepare_lang output, in memory)."""

    words: SymbolTable
    phones: SymbolTable
    L: Fst
    L_disambig: Fst
    disambig_phone_ids: List[int] = field(default_factory=list)  # #0..#N
    wdisambig_phone: int = 0  # phone id of #0
    wdisambig_word: int = 0  # word id of #0
    silence_phone_ids: List[int] = field(default_factory=list)
    optional_silence: str = "SIL"
    position_dependent: bool = True
    # word id of the unknown word, if present
    unk_id: Optional[int] = None


def prepare_lang(
    lexicon: Sequence[LexiconEntry],
    silence_phones: Sequence[str],
    optional_silence: str = "SIL",
    sil_prob: float = 0.5,
    position_dependent: bool = True,
    unk: str = "<unk>",
) -> Lang:
    """prepare_lang.sh equivalent: dict → Lang (L.fst, L_disambig.fst,
    words.txt, phones.txt, disambig lists)."""
    # Nonsilence phones in lexicon order of appearance (sorted for stability)
    base_phones: List[str] = []
    seen = set(silence_phones)
    for _, phones in lexicon:
        for p in phones:
            if p not in seen:
                seen.add(p)
                base_phones.append(p)
    base_phones.sort()

    entries = list(lexicon)
    if position_dependent:
        entries = apply_position_markers(entries)

    disambig_entries, ndisambig = add_lex_disambig(entries)
    ndisambig += 1  # one extra for the silence disambig (prepare_lang.sh:299)
    sil_disambig = f"#{ndisambig}"

    # phones.txt: <eps>, silence variants, nonsilence variants, disambig
    phones = SymbolTable()
    sil_variant_ids: List[int] = []
    if position_dependent:
        for p in silence_phones:
            for suffix in ("", "_B", "_E", "_I", "_S"):
                sil_variant_ids.append(phones.add(p + suffix))
        for p in base_phones:
            for suffix in ("_B", "_E", "_I", "_S"):
                phones.add(p + suffix)
    else:
        for p in silence_phones:
            sil_variant_ids.append(phones.add(p))
        for p in base_phones:
            phones.add(p)

    disambig_ids = [phones.add(f"#{n}") for n in range(0, ndisambig + 1)]

    # words.txt: <eps>, sorted words, #0, <s>, </s>
    words = SymbolTable()
    for word in sorted({w for w, _ in lexicon}):
        words.add(word)
    wdisambig_word = words.add("#0")
    words.add("<s>")
    words.add("</s>")

    plain_entries = [(w, p, None) for (w, p, _) in disambig_entries]
    L = make_lexicon_fst(
        plain_entries, phones, words, optional_silence, sil_prob, sil_disambig=None
    )
    L_disambig = make_lexicon_fst(
        disambig_entries,
        phones,
        words,
        optional_silence,
        sil_prob,
        sil_disambig=sil_disambig,
    )
    # Pass-through for the grammar's #0 backoff symbol (prepare_lang.sh:534-539)
    wdisambig_phone = phones.find("#0")
    L_disambig.add_self_loops([(wdisambig_phone, wdisambig_word)])
    L_disambig.arcsort("olabel")

    return Lang(
        words=words,
        phones=phones,
        L=L,
        L_disambig=L_disambig,
        disambig_phone_ids=disambig_ids,
        wdisambig_phone=wdisambig_phone,
        wdisambig_word=wdisambig_word,
        silence_phone_ids=sil_variant_ids,
        optional_silence=optional_silence,
        position_dependent=position_dependent,
        unk_id=words.find(unk),
    )
