"""Lexicon layer: pronunciation database and G2P helpers."""

from .g2p import (
    LexiconDatabase,
    get_aligned_phonemes,
    get_sounds_like,
    split_words,
)

__all__ = [
    "LexiconDatabase",
    "get_aligned_phonemes",
    "get_sounds_like",
    "split_words",
]
