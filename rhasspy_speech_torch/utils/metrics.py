"""Per-stage timing + throughput metrics.

The reference has no metrics layer — only debug logging of spawned commands
(tools.py:73,99,130) and the RTF printer buried inside a Kaldi binary
(online2bin/online2-wav-nnet3-latgen-faster.cc:197-300). This module is the
first-class replacement: stage timers (frontend / acoustic / decode /
backtrace), audio-second counters, and derived RTF / streams-per-chip.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class StageStats:
    calls: int = 0
    seconds: float = 0.0

    def add(self, seconds: float) -> None:
        self.calls += 1
        self.seconds += seconds


@dataclass
class DecodeMetrics:
    """Accumulates decode work and wall time per stage."""

    stages: Dict[str, StageStats] = field(default_factory=lambda: defaultdict(StageStats))
    audio_seconds: float = 0.0
    utterances: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def add_audio(self, seconds: float, utterances: int = 1) -> None:
        with self._lock:
            self.audio_seconds += seconds
            self.utterances += utterances

    def add_stage(self, stage: str, seconds: float) -> None:
        with self._lock:
            self.stages[stage].add(seconds)

    @property
    def total_seconds(self) -> float:
        return sum(s.seconds for s in self.stages.values())

    @property
    def rtf(self) -> float:
        """Real-time factor: processing seconds per audio second."""
        if self.audio_seconds == 0:
            return float("nan")
        return self.total_seconds / self.audio_seconds

    @property
    def streams_realtime(self) -> float:
        """Sustainable concurrent realtime streams (1/RTF)."""
        rtf = self.rtf
        return float("nan") if rtf != rtf or rtf == 0 else 1.0 / rtf

    def summary(self) -> Dict[str, object]:
        return {
            "utterances": self.utterances,
            "audio_seconds": round(self.audio_seconds, 3),
            "rtf": round(self.rtf, 5) if self.audio_seconds else None,
            "streams_realtime": (
                round(self.streams_realtime, 1) if self.audio_seconds else None
            ),
            "stages": {
                name: {"calls": s.calls, "seconds": round(s.seconds, 4)}
                for name, s in sorted(self.stages.items())
            },
        }


_GLOBAL = DecodeMetrics()


def get_metrics() -> DecodeMetrics:
    return _GLOBAL


def reset_metrics() -> DecodeMetrics:
    global _GLOBAL
    _GLOBAL = DecodeMetrics()
    return _GLOBAL


class StageTimer:
    """Context manager timing one stage into a DecodeMetrics."""

    def __init__(self, stage: str, metrics: Optional[DecodeMetrics] = None):
        self.stage = stage
        self.metrics = metrics or _GLOBAL
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.metrics.add_stage(self.stage, time.perf_counter() - self._t0)
        return False


@contextmanager
def stage(name: str, metrics: Optional[DecodeMetrics] = None):
    with StageTimer(name, metrics):
        yield
