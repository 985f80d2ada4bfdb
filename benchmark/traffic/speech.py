"""Seeded speech-like PCM: voiced syllables and unvoiced bursts over a noise
floor, 16 kHz int16.

A bank of syllables is made once from the seed: a voiced one is ten
harmonics of a gliding pitch (90-220 Hz) shaped by two formants, an
unvoiced one band-limited noise, each under a raised-cosine envelope. An
utterance strings bank entries at random gains, with short pauses, over a
low noise floor, so every frame carries energy across the spectrum (no
all-zero frame) as a recorded command does.
"""

from __future__ import annotations

from typing import List

import numpy as np

RATE = 16000


class SyllableBank:
    def __init__(self, rng: np.random.RandomState, count: int = 96):
        self.items: List[np.ndarray] = []
        for _ in range(count):
            n = int(rng.uniform(0.10, 0.30) * RATE)
            env = np.sin(np.pi * (np.arange(n) + 0.5) / n) ** 1.5
            if rng.rand() < 0.2:
                noise = rng.randn(n + 8)
                band = np.convolve(noise, np.hanning(8), mode="valid")[:n]
                wave = band * (noise[:n] * 0.3 + 1.0)
            else:
                f0 = np.linspace(rng.uniform(90, 220), rng.uniform(90, 220), n)
                phase = 2 * np.pi * np.cumsum(f0) / RATE
                f1, f2 = rng.uniform(300, 900), rng.uniform(900, 2500)
                mid = f0[n // 2]
                wave = np.zeros(n)
                for k in range(1, 11):
                    f = k * mid
                    gain = (np.exp(-((f - f1) / 150.0) ** 2)
                            + 0.6 * np.exp(-((f - f2) / 250.0) ** 2) + 0.05)
                    wave += gain * np.sin(k * phase)
            wave = wave / max(np.abs(wave).max(), 1e-9)
            self.items.append((wave * env).astype(np.float32))

    def utterance(self, rng: np.random.RandomState, samples: int) -> np.ndarray:
        """``samples`` of int16 PCM."""
        out = (rng.randn(samples) * rng.uniform(20, 60)).astype(np.float32)
        pos = int(rng.uniform(0.02, 0.15) * RATE)
        while pos < samples:
            syl = self.items[rng.randint(len(self.items))]
            end = min(samples, pos + syl.shape[0])
            out[pos:end] += syl[: end - pos] * rng.uniform(2000, 9000)
            pos = end + int(rng.uniform(0.0, 0.12) * RATE)
        return np.clip(np.round(out), -32768, 32767).astype(np.int16)


def stratified_seconds(count: int, lo: float, hi: float) -> np.ndarray:
    """``count`` lengths evenly spread over [lo, hi] (the midpoints of equal
    strata): every seed gets the same set, in its own order."""
    return lo + (hi - lo) * (np.arange(count) + 0.5) / count
