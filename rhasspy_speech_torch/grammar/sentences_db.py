"""Sentences database: expanded (input, output) pairs + match scoring.

The reference's end-to-end tests score transcripts against a pre-expanded
sentences database (tests/test_en.py:56 loads `sentences.db` and accepts a
transcript when the best normalized match score is <= 0.15). The package
that produced it predates the reference snapshot; this module provides the
equivalent: build the DB from intents via the sentence sampler, and score
hypotheses by normalized token edit distance against it.
"""

from __future__ import annotations

import sqlite3
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple, Union

from .sentences import generate_sentences


def build_sentences_db(
    sentences_yaml: Dict,
    db_path: Union[str, Path],
    number_language: Optional[str] = None,
) -> int:
    """Expand a sentences YAML dict and write sentences.db
    (input_text, output_text). Returns the number of rows."""
    from .numbers import NumberEngine

    engine = NumberEngine(number_language) if number_language else None
    conn = sqlite3.Connection(str(db_path))
    conn.execute("DROP TABLE IF EXISTS sentences")
    conn.execute(
        "CREATE TABLE sentences (input_text TEXT, output_text TEXT)"
    )
    n = 0
    for inp, out in generate_sentences(sentences_yaml, number_engine=engine):
        conn.execute("INSERT INTO sentences VALUES (?, ?)", (inp, out))
        n += 1
    conn.commit()
    conn.close()
    return n


def load_sentences(db_path: Union[str, Path]) -> List[Tuple[str, str]]:
    conn = sqlite3.Connection(str(db_path))
    rows = list(conn.execute("SELECT input_text, output_text FROM sentences"))
    conn.close()
    return [(r[0], r[1]) for r in rows]


def _edit_distance(a: List[str], b: List[str]) -> int:
    la, lb = len(a), len(b)
    if la == 0:
        return lb
    if lb == 0:
        return la
    prev = list(range(lb + 1))
    for i in range(1, la + 1):
        cur = [i] + [0] * lb
        ai = a[i - 1]
        for j in range(1, lb + 1):
            cur[j] = min(
                prev[j] + 1,
                cur[j - 1] + 1,
                prev[j - 1] + (0 if ai == b[j - 1] else 1),
            )
        prev = cur
    return prev[lb]


def get_matching_scores(
    text: str,
    sentences: Iterable[Tuple[str, str]],
) -> List[Tuple[float, str, str]]:
    """Score a transcript against the database.

    Returns (norm_score, input_text, output_text) ascending; norm_score =
    token edit distance / max(len) — 0.0 is an exact match, the reference
    accepts <= 0.15 (tests/test_en.py:59-61)."""
    words = text.split()
    scored = []
    for inp, out in sentences:
        ref = inp.split()
        denom = max(len(words), len(ref), 1)
        scored.append((_edit_distance(words, ref) / denom, inp, out))
    scored.sort(key=lambda x: x[0])
    return scored


def best_matching_score(
    text: str, sentences: Iterable[Tuple[str, str]]
) -> Tuple[float, Optional[str]]:
    """Best (norm_score, output_text); (inf, None) on an empty database."""
    scores = get_matching_scores(text, sentences)
    if not scores:
        return float("inf"), None
    return scores[0][0], scores[0][2]
