"""Shared constants and small enums.

Behavioral parity with the reference package's const module
(rhasspy_speech/const.py:1-38): same special symbols and the
same three enums (WordCasing, ModelType, LangSuffix) so user configs keep
working unchanged.
"""

from collections.abc import Callable
from enum import Enum

EPS = "<eps>"
SIL = "SIL"
SPN = "SPN"
UNK = "<unk>"


class WordCasing(str, Enum):
    """How words are normalized before entering the lexicon/FST."""

    KEEP = "keep"
    LOWER = "lower"
    UPPER = "upper"

    @staticmethod
    def get_function(casing: "WordCasing") -> Callable[[str], str]:
        if casing == WordCasing.LOWER:
            return str.lower
        if casing == WordCasing.UPPER:
            return str.upper
        return lambda s: s


class ModelType(str, Enum):
    NNET3 = "nnet3"
    GMM = "gmm"


class LangSuffix(str, Enum):
    """Which decode graphs to build for a trained profile."""

    GRAMMAR = "grammar"
    ARPA = "arpa"
    ARPA_RESCORE = "arpa_rescore"
