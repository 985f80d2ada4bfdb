"""Closed-loop batch traffic: one client sends a batch of utterances, waits
for the transcripts, and sends the next.

Parameters (``traffic/<mix>.json``): ``batch`` utterances a call, lengths
spread evenly over ``[min_s, max_s]`` seconds (the same set in every call,
shuffled by the seed, so every seed and call does the same work), and
``distinct_batches`` different batches sent in turn (the seed makes their
PCM).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from benchmark.traffic.speech import RATE, SyllableBank, stratified_seconds


def make(params: Dict, seed: int) -> List[List[np.ndarray]]:
    """The batches, each a list of int16 PCM arrays."""
    rng = np.random.RandomState(seed % (2 ** 32 - 1))
    bank = SyllableBank(rng)
    lengths = np.round(stratified_seconds(params["batch"], params["min_s"],
                                          params["max_s"]) * RATE).astype(int)
    return [[bank.utterance(rng, int(n)) for n in rng.permutation(lengths)]
            for _ in range(params["distinct_batches"])]
