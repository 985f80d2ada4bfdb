"""Fixtures of the port: the flagship decode graph and full-width TDNN-F
model directories (``flagship.py``, ``tdnnf.py``), built from a seed, and
the synthetic speech profile (``synthetic.py``: a phone synthesizer and the
acoustic model that matches it, so sentences decode to themselves)."""

from .synthetic import (
    SyntheticProfile,
    build_synthetic_profile,
    synthesize_sentence,
)

__all__ = [
    "SyntheticProfile",
    "build_synthetic_profile",
    "synthesize_sentence",
]
