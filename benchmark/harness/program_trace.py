"""The program's own trace of the stream cells: the stream scheduler's tick
and stream records (``rhasspy_speech_torch/utils/metrics.py``), read after a
traced run from the process's registry.

``window(record)`` selects, from the records of the newest scheduler (the
highest serial number), the ticks whose ``step()`` began and the streams
whose ``finish()`` came within the window's length before that scheduler's
newest ``finish()``. The client's drain after the window lasts about one
finalize (~50 ms), so the selection is the window shifted by that, well
under 0.2% of a 51 s window. Everything is computed here from the records'
fields, so the yardstick lives in the benchmark.

Each reader returns None where the program keeps no such records (an older
program) or a run made none; a device reading (``device=True``) also where
the run had no card (the harness leaves ``window_s`` unset), as a CPU run's
stamps are the host's.
"""

from __future__ import annotations

import statistics
from typing import List, Optional, Tuple

STAGES = ("feed", "ivector", "am", "k2", "walk")  # between stamps s0 .. s5
FIN_PARTS = ("flush", "device", "result")


def _records() -> Optional[Tuple[list, list]]:
    try:
        from rhasspy_speech_torch.utils.metrics import get_metrics
    except ImportError:
        return None
    reg = get_metrics()
    ticks, streams = getattr(reg, "ticks", None), getattr(reg, "streams", None)
    if not ticks or not streams:
        return None
    return list(ticks), list(streams)


def window(record) -> Optional[Tuple[List, List]]:
    """(tick records, stream records) of the newest scheduler inside the
    window (module docstring), or None."""
    got = _records()
    bounds = record.get("bounds")
    if got is None or not bounds:
        return None
    ticks, streams = got
    src = max(r.src for r in ticks + streams)
    finishes = [s.t_finish for s in streams if s.src == src and s.t_finish is not None]
    if not finishes:
        return None
    hi = max(finishes)
    lo = hi - (record.get("window_s") or bounds[1] - bounds[0])
    return ([t for t in ticks if t.src == src and lo <= t.t_enter <= hi],
            [s for s in streams if s.src == src and s.t_finish is not None
             and lo <= s.t_finish <= hi])


def _mean_ms(values) -> Optional[float]:
    values = list(values)
    return 1e3 * statistics.fmean(values) if values else None


def _selected(record, device: bool):
    if device and not record.get("window_s"):
        return None
    return window(record)


def decoding_steps(record) -> Optional[List]:
    """The window's ticks whose ``step()`` decoded a lane, one a step."""
    got = _selected(record, False)
    if got is None:
        return None
    return [t for t in got[0] if t.lanes > 0 and t.t_return is not None]


def step_ms(record, part: str) -> Optional[float]:
    """Mean host ms of a decoding ``step()``: ``"wait"`` blocked on the card,
    ``"self"`` the rest of its span."""
    steps = decoding_steps(record)
    if not steps:
        return None
    if part == "wait":
        return _mean_ms(t.wait_s for t in steps)
    return _mean_ms(t.t_return - t.t_enter - t.wait_s for t in steps)


def tick_stage_ms(record, stage: str) -> Optional[float]:
    """Mean device ms of one stage of the fused tick, between consecutive
    stamps (``STAGES``), over the window's landed fused ticks."""
    got = _selected(record, True)
    if got is None:
        return None
    i = STAGES.index(stage)
    return _mean_ms(t.stamps[i + 1] - t.stamps[i] for t in got[0]
                    if t.key == "fused" and t.stamps is not None)


def _finalized(record, device: bool) -> Optional[List]:
    got = _selected(record, device)
    if got is None:
        return None
    return [s for s in got[1] if None not in (s.t_finish, s.t_flush, s.s5, s.t_result)]


def fin_ms(record, part: str) -> Optional[float]:
    """Mean ms of one span of a finalized stream: ``"flush"`` ``finish()`` ->
    the flushing tick issued (host clock); ``"device"`` issued -> its body
    end s5; ``"result"`` s5 -> the transcript set (the last two cross onto
    the card's stamps)."""
    done = _finalized(record, part != "flush")
    if not done:
        return None
    if part == "flush":
        return _mean_ms(s.t_flush - s.t_finish for s in done)
    if part == "device":
        return _mean_ms(s.s5 - s.t_flush for s in done)
    return _mean_ms(s.t_result - s.s5 for s in done)


def fin_total_ms(record) -> Optional[float]:
    """Mean ms from ``finish()`` to the transcript set, over the streams
    ``fin_ms`` reads."""
    done = _finalized(record, False)
    return _mean_ms(s.t_result - s.t_finish for s in done) if done else None


def fin_ticks(record) -> Optional[float]:
    """Mean tick bodies issued after a stream's ``finish()`` before its
    flushing tick."""
    done = _finalized(record, False)
    if not done:
        return None
    return statistics.fmean(s.tick_flush - s.tick_finish for s in done)
