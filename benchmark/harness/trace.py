"""Reading a traced window: device busy time, the device operations that
took most time, and the longest idle gaps by what the host was doing.

Two sources: ``torch.profiler`` (kernel intervals and the benchmark's own
``record_function`` spans), and, where the profiler records no device event
(kernels launched through ctypes, kernels inside a replayed CUDA graph),
device intervals timed by CUDA events and placed on the host's clock.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

Interval = Tuple[float, float]  # seconds


def union(intervals: Sequence[Interval]) -> List[Interval]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_seconds(intervals: Sequence[Interval]) -> float:
    return sum(e - s for s, e in union(intervals))


def top(items: Dict[str, float], n: int = 10) -> List[List]:
    return [[k, v] for k, v in sorted(items.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(busy: Sequence[Interval], spans: Sequence[Tuple[str, Interval]],
              lo: float, hi: float, n: int = 10) -> List[List]:
    """The ``n`` longest stretches of ``[lo, hi]`` with no device work, each
    named by the innermost host span around its middle ("host, no span"
    where none is)."""
    gaps, t = [], lo
    for s, e in union(busy):
        if s > t:
            gaps.append((t, min(s, hi)))
        t = max(t, e)
    if t < hi:
        gaps.append((t, hi))
    out = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
        mid = 0.5 * (s + e)
        inside = [(b - a, name) for name, (a, b) in spans if a <= mid <= b]
        out.append([min(inside)[1] if inside else "host, no span", e - s])
    return out


def profiler_intervals(prof, span_names: Sequence[str]):
    """(device intervals, device seconds by operation name, host spans)
    from a finished ``torch.profiler.profile``, in seconds on its clock."""
    from torch.autograd import DeviceType

    dev: List[Interval] = []
    by_name: Dict[str, float] = {}
    spans: List[Tuple[str, Interval]] = []
    names = set(span_names)
    for ev in prof.events():
        s, e = ev.time_range.start * 1e-6, ev.time_range.end * 1e-6
        if ev.name in names or getattr(ev, "is_user_annotation", False):
            # a span, on the host timeline or mirrored on the device's
            if ev.device_type != DeviceType.CUDA:
                spans.append((ev.name, (s, e)))
        elif ev.device_type == DeviceType.CUDA:
            dev.append((s, e))
            by_name[ev.name] = by_name.get(ev.name, 0.0) + (e - s)
    return dev, by_name, spans


def seen(by_name: Dict[str, float], fragment: str) -> Optional[float]:
    """Device seconds of operations whose name holds ``fragment``, or None."""
    hits = [v for k, v in by_name.items() if fragment in k]
    return sum(hits) if hits else None
