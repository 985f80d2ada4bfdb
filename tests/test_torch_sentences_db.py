"""The port's copy of the sentences.db build and match scoring, held to
the cases of ``tests/test_sentences_db.py``."""

from rhasspy_speech_torch.grammar.sentences_db import (
    best_matching_score,
    build_sentences_db,
    get_matching_scores,
    load_sentences,
)


def test_build_and_score(tmp_path):
    yaml_dict = {
        "sentences": [
            "turn (on|off) the light",
            {"in": "never mind", "out": "cancelled"},
        ],
    }
    db = tmp_path / "sentences.db"
    n = build_sentences_db(yaml_dict, db)
    assert n == 3
    rows = load_sentences(db)
    inputs = {r[0] for r in rows}
    assert inputs == {"turn on the light", "turn off the light", "never mind"}
    out_map = dict(rows)
    assert out_map["never mind"] == "cancelled"

    # exact match: score 0, output substituted
    score, out = best_matching_score("never mind", rows)
    assert score == 0.0 and out == "cancelled"
    # one substitution in 4 tokens: 0.25 > 0.15 threshold -> reject
    score, _ = best_matching_score("turn on the fan", rows)
    assert abs(score - 0.25) < 1e-9
    # garbage: high score
    score, _ = best_matching_score("completely unrelated words here", rows)
    assert score > 0.5
    # ranking is ascending
    scores = get_matching_scores("turn on the light", rows)
    assert scores[0][0] == 0.0
    assert scores[0][0] <= scores[1][0] <= scores[2][0]


def test_empty_db():
    assert best_matching_score("anything", []) == (float("inf"), None)
