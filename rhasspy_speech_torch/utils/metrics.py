"""The process's decode metrics: stage timers, audio counters, and the
stream scheduler's per-tick and per-stream records.

The reference has no metrics layer — only debug logging of spawned commands
(tools.py:73,99,130) and the RTF printer buried inside a Kaldi binary
(online2bin/online2-wav-nnet3-latgen-faster.cc:197-300). This module is the
first-class replacement.

- **Stages.** ``StageTimer`` adds a named host span's seconds and calls to
  the registry: host self time by name, for an operator. Each name times
  one thing, and no stage of a scheduler tick runs inside another.
- **Tick records** (``TickRecord``), one a tick body the stream scheduler's
  device route issues: the body, its lanes, host stamps for ``step()``'s
  entry, the body's issue and ``step()``'s return, the host seconds that
  ``step()`` was blocked on the card, and the body's device stamps
  (``pipeline/device_tick.py``) on the host clock once its row has landed
  (a feed-only body takes none and keeps ``stamps`` None), and for the
  fused and the chunk bodies the rows their chunk AM ran (``am_rows``, the
  lane bucket). ``summary()`` splits those two bodies into stages by their
  stamps and gives their lanes as a share of those rows.
- **Stream records** (``StreamRecord``), one a stream the device route
  finalizes, keyed by ``(sid, gen)``: ``finish()``'s host stamp and the
  ticks issued by then, the flushing tick's index and issue stamp, that
  tick's body end (its s5) and the host stamp when the transcript was set.
  Its three spans, finish -> flush issued -> s5 -> transcript, tile
  finish -> transcript.

Records are kept in memory, the newest ``RECORDS_MAX`` of each kind, each
tagged with its scheduler's serial number (``new_source``), so the records
of two schedulers (or of a mesh's blocks) never mix. Host times are
``time.perf_counter`` seconds.
"""

from __future__ import annotations

import itertools
import statistics
import threading
import time
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Deque, Dict, Iterable, Optional, Tuple

RECORDS_MAX = 1 << 17
# the tick's stages: TICK_STAGES[j - 1] ends at device stamp s_j (s0 .. s5)
TICK_STAGES = ("feed", "ivector", "am", "k2", "walk")
# the bodies whose stamps split into stages: the fused tick, and the host
# feature route's chunk (no s1: its ``ivector`` starts at s0)
SPLIT_BODIES = ("fused", "chunk")

_SOURCES = itertools.count(1)


def new_source() -> int:
    """A serial number for one scheduler's records, unique in the process."""
    return next(_SOURCES)


@dataclass
class StageStats:
    calls: int = 0
    seconds: float = 0.0

    def add(self, seconds: float) -> None:
        self.calls += 1
        self.seconds += seconds


@dataclass(slots=True)
class TickRecord:
    """One tick body the stream scheduler issued (module docstring)."""

    src: int  # the scheduler's serial number
    tick: int  # bodies the scheduler issued before this one
    key: str  # "fused", "chunk", "feed" or "finalize"
    lanes: int  # slots it decodes
    t_enter: float  # step() entry
    t_issue: float  # just before the body's run call (upload and replay)
    t_return: Optional[float] = None  # step() return
    wait_s: Optional[float] = None  # step()'s seconds blocked on the card
    # device stamps s0 .. s5 on the host clock (None: not taken by this
    # body), once the row has landed
    stamps: Optional[Tuple[Optional[float], ...]] = None
    am_rows: Optional[int] = None  # the chunk AM's rows (fused and chunk bodies)


@dataclass(slots=True)
class StreamRecord:
    """One finalized stream's path from ``finish()`` to its transcript."""

    src: int
    sid: int
    gen: int
    t_finish: Optional[float] = None  # None: flushed without finish()
    tick_finish: Optional[int] = None  # bodies issued before finish()
    tick_flush: Optional[int] = None  # the flushing body's index
    t_flush: Optional[float] = None  # its issue stamp
    s5: Optional[float] = None  # its body end on the host clock
    t_result: Optional[float] = None  # the transcript set
    flush: Optional[TickRecord] = field(default=None, repr=False)  # until harvested

    @property
    def complete(self) -> bool:
        return None not in (self.t_finish, self.t_flush, self.s5, self.t_result)

    def spans(self) -> Tuple[float, float, float]:
        """(finish -> flush issued, flush issued -> s5, s5 -> transcript)
        in seconds; they sum to finish -> transcript."""
        return (self.t_flush - self.t_finish, self.s5 - self.t_flush, self.t_result - self.s5)


@dataclass
class DecodeMetrics:
    """Stage timers, audio counters and the scheduler's records."""

    stages: Dict[str, StageStats] = field(default_factory=lambda: defaultdict(StageStats))
    audio_seconds: float = 0.0
    utterances: int = 0
    ticks: Deque[TickRecord] = field(default_factory=lambda: deque(maxlen=RECORDS_MAX))
    streams: Deque[StreamRecord] = field(default_factory=lambda: deque(maxlen=RECORDS_MAX))
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def add_audio(self, seconds: float, utterances: int = 1) -> None:
        with self._lock:
            self.audio_seconds += seconds
            self.utterances += utterances

    def add_stage(self, stage: str, seconds: float) -> None:
        with self._lock:
            self.stages[stage].add(seconds)

    def summary(self) -> Dict[str, object]:
        return {
            "utterances": self.utterances,
            "audio_seconds": round(self.audio_seconds, 3),
            "stages": {
                name: {"calls": s.calls, "seconds": round(s.seconds, 4)}
                for name, s in sorted(self.stages.items())
            },
            "tick_ms": tick_means(self.ticks),
            "finalize_ms": finalize_means(self.streams),
        }


def _mean(values: Iterable[float]) -> Optional[float]:
    values = list(values)
    return statistics.fmean(values) if values else None


def tick_means(ticks: Iterable[TickRecord]) -> Optional[Dict[str, object]]:
    """Mean ms of ``step()``'s wait on the card and of the rest of its host
    span, over the ticks that decoded a lane; and for each body of
    ``SPLIT_BODIES`` with landed stamps, the mean ms of each stage ending at
    one of its stamps (``TICK_STAGES``, from the stamp before) and of the
    whole body (first stamp to last), with its ticks counted, and the
    percent of its AM rows that were lanes (``am_row_use_pct``: the lanes
    summed over the rows summed, over its ticks with ``am_rows``). None
    without such ticks."""
    ticks = list(ticks)
    steps = [t for t in ticks if t.lanes > 0 and t.t_return is not None]
    out: Dict[str, object] = {"decoding_steps": len(steps)}
    for key in SPLIT_BODIES:
        landed = [t.stamps for t in ticks if t.key == key and t.stamps is not None]
        if landed:
            out[key] = _split(landed)
            rowed = [t for t in ticks if t.key == key and t.am_rows]
            if rowed:
                out[key]["am_row_use_pct"] = round(
                    100.0 * sum(t.lanes for t in rowed) / sum(t.am_rows for t in rowed), 4)
    if not steps and len(out) == 1:
        return None
    out["step_wait"] = _ms(_mean(t.wait_s for t in steps))
    out["step_self"] = _ms(_mean(t.t_return - t.t_enter - t.wait_s for t in steps))
    return out


def _split(landed) -> Dict[str, object]:
    """One body's stage means over its ticks' stamps (``tick_means``)."""
    taken = [j for j, x in enumerate(landed[0]) if x is not None]
    out: Dict[str, object] = {"ticks": len(landed)}
    for a, b in zip(taken, taken[1:]):
        out[TICK_STAGES[b - 1]] = _ms(_mean(s[b] - s[a] for s in landed))
    out["body"] = _ms(_mean(s[taken[-1]] - s[taken[0]] for s in landed))
    return out


def finalize_means(streams: Iterable[StreamRecord]) -> Optional[Dict[str, float]]:
    """Mean ms of a finalized stream's three spans (``flush``: finish ->
    flushing tick issued; ``device``: issued -> its s5; ``result``: s5 ->
    transcript), of their sum, and the mean ticks issued between finish and
    the flushing tick; None without a complete record."""
    done = [s for s in streams if s.complete]
    if not done:
        return None
    spans = [s.spans() for s in done]
    return {"streams": len(done),
            "flush": _ms(_mean(a for a, _b, _c in spans)),
            "device": _ms(_mean(b for _a, b, _c in spans)),
            "result": _ms(_mean(c for _a, _b, c in spans)),
            "total": _ms(_mean(s.t_result - s.t_finish for s in done)),
            "ticks": _mean(s.tick_flush - s.tick_finish for s in done)}


def _ms(seconds: Optional[float]) -> Optional[float]:
    return None if seconds is None else round(1e3 * seconds, 4)


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
