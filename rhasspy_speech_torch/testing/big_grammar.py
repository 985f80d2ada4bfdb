"""A generated template grammar of deployment size, from a seed.

The flagship grammar of the benchmarks is read from a file the repository
does not carry, so ``testing/flagship.py`` builds a two-sentence stand-in
(some 800 states). This module generates a voice-assistant grammar in the
same template language instead -- commands over slot lists of generated
names (areas, devices, scenes) and number ranges -- that ``train_model_sync``
compiles, against the flagship model's spelled-out lexicon (a word's
pronunciation is its letters), to a decode graph of more than 7,000 states:
the size class at which the checkpointed and frontier decoders matter.

Everything comes from ``seed``; nothing is read from outside the repository.
``write_big_grammar_model_dir`` writes a flagship-format model directory
whose phone table covers the lexicon; ``train_big_grammar`` trains the
grammar against it and returns the graph directory.
"""

from __future__ import annotations

import io
from pathlib import Path
from typing import Dict, List, Union

import numpy as np

from ..const import LangSuffix
from ..grammar import Intents, compile_intents
from ..lexicon import LexiconDatabase
from ..pipeline.artifacts import lang_dir_name
from ..pipeline.train import train_model_sync
from .flagship import write_flagship_model_dir

# The model's phone inventory, as a Kaldi model trained with word-position
# markers lists it: silence and spoken noise (bare and _B/_E/_I/_S), then
# the letters (_B/_E/_I/_S).
LETTERS = "abcdefghijklmnopqrstuvwxyz"
PHONES = [p + sfx for p in ("SIL", "SPN") for sfx in ("", "_B", "_E", "_I", "_S")] + [
    p + sfx for p in LETTERS for sfx in ("_B", "_E", "_I", "_S")
]

_ONSETS = ["b", "d", "f", "g", "k", "l", "m", "n", "p", "r", "s", "t", "v", "z", "st", "br", "kl"]
_VOWELS = ["a", "e", "i", "o", "u", "ai", "ou"]
_CODAS = ["", "", "n", "r", "s", "l", "m", "t"]


def _names(rng: np.random.RandomState, count: int, syllables: int) -> List[str]:
    """``count`` distinct pronounceable names of ``syllables`` syllables."""
    seen: Dict[str, None] = {}
    while len(seen) < count:
        word = "".join(
            _ONSETS[rng.randint(len(_ONSETS))] + _VOWELS[rng.randint(len(_VOWELS))]
            + _CODAS[rng.randint(len(_CODAS))]
            for _ in range(syllables)
        )
        seen.setdefault(word, None)
    return list(seen)


def big_grammar_intents(
    seed: int = 0, areas: int = 260, devices: int = 160, scenes: int = 130
) -> dict:
    """The intents dict: templates over three generated slot lists and two
    number ranges. The default sizes train to some 14,000 states and 32,000
    arcs; (120, 80, 60) to some 8,000 states."""
    rng = np.random.RandomState(seed)
    lists = {
        "area": {"values": _names(rng, areas, 3)},
        "device": {"values": _names(rng, devices, 2)},
        "scene": {"values": _names(rng, scenes, 3)},
        "percent": {"range": {"from": 0, "to": 100}},
        "degrees": {"range": {"from": 10, "to": 30}},
    }
    sentences = [
        "turn (on|off) [the] {device} [in [the] {area}]",
        "set [the] {device} [in [the] {area}] to {percent} percent",
        "set [the] {area} (temperature|thermostat) to {degrees} degrees",
        "(activate|start) [the] scene {scene}",
        "what is the (temperature|humidity) in [the] {area}",
        "(open|close|stop) [the] {area} (blinds|curtains|door|window)",
        "never mind",
    ]
    return {
        "language": "en",
        "intents": {"Home": {"data": [{"sentences": sentences}]}},
        "lists": lists,
    }


def spelled_lexicon(intents: dict) -> Dict[str, str]:
    """``words`` for ``train_model_sync``: every word of the grammar (number
    words included) pronounced as its letters, in the ``/p1 p2/`` form."""
    ctx = compile_intents(
        Intents.from_dict(intents), io.StringIO(), LexiconDatabase(), number_language="en"
    )
    out = {}
    for word in sorted(ctx.vocab):
        letters = [c for c in word.lower() if c in LETTERS]
        if letters:
            out[word] = "/" + " ".join(letters) + "/"
    return out


def write_big_grammar_model_dir(model_dir: Union[str, Path], num_pdfs: int, **model_kwargs) -> Path:
    """A flagship-format model directory (``write_flagship_model_dir``) over
    ``PHONES``, with the ``model/phones.txt`` a trained Kaldi model carries;
    training maps the lexicon's phones onto it by name."""
    model_dir = write_flagship_model_dir(
        model_dir, num_pdfs=num_pdfs, max_phone=len(PHONES), **model_kwargs
    )
    with open(model_dir / "model" / "phones.txt", "w", encoding="utf-8") as f:
        f.write("<eps> 0\n")
        for i, phone in enumerate(PHONES):
            f.write(f"{phone} {i + 1}\n")
    return model_dir


def train_big_grammar(
    train_dir: Union[str, Path], model_dir: Union[str, Path], seed: int = 0, **sizes
) -> Path:
    """Train the generated grammar against ``model_dir`` (a directory from
    ``write_big_grammar_model_dir``); returns the grammar graph directory."""
    intents = big_grammar_intents(seed, **sizes)
    train_model_sync(
        "en", intents, train_dir, model_dir, words=spelled_lexicon(intents),
        lang_suffixes=[LangSuffix.GRAMMAR],
    )
    return Path(train_dir) / lang_dir_name(LangSuffix.GRAMMAR)
