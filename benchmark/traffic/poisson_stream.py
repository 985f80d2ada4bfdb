"""Open-loop streaming traffic: utterances arrive by a Poisson process and
each is spoken in real time, one push of ``push_samples`` at a time.

Parameters (``traffic/<mix>.json``): ``rate_per_s`` arrivals a second,
lengths spread evenly over ``[min_s, max_s]``, ``prefill_s`` seconds of
arrivals before the measured window (at least one longest utterance, so
the number of streams is steady inside the window), ``push_samples``, and
``tape_s``: the seconds of distinct speech-like PCM the seed makes, from
which each utterance is cut at a seeded offset (making each utterance's PCM
afresh would take set-up seconds that grow with the window).
Every seed gets the same set of inter-arrival gaps (the quantiles of the
exponential distribution) and of lengths, each in its own order.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from benchmark.traffic.speech import RATE, SyllableBank, stratified_seconds


def make(params: Dict, seed: int, seconds: float) -> List[Tuple[float, np.ndarray]]:
    """(arrival second, int16 PCM) a stream, arrival 0 being the window's
    start, covering ``prefill_s`` before it to ``seconds`` after."""
    rng = np.random.RandomState(seed % (2 ** 32 - 1))
    bank = SyllableBank(rng)
    rate = float(params["rate_per_s"])
    span = params["prefill_s"] + seconds
    n = int(np.ceil(rate * span)) + 1
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    gaps = gaps[rng.permutation(n)]
    arrivals = -params["prefill_s"] + np.concatenate([[0.0], np.cumsum(gaps[:-1])])
    lengths = np.round(stratified_seconds(n, params["min_s"], params["max_s"]) * RATE).astype(int)
    lengths = lengths[rng.permutation(n)]
    tape = bank.utterance(rng, int(params["tape_s"] * RATE))
    starts = rng.randint(0, tape.shape[0] - int(lengths.max()) + 1, size=n)
    return [(float(a), tape[s: s + m]) for a, m, s in zip(arrivals, lengths, starts)
            if a < seconds]
