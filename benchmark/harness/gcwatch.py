"""Python's cyclic garbage collector, watched over a window: how many
collections of each generation ran and how long they held the host. A full
collection walks every tracked Python object that is not frozen; over the
whole heap (the grammar's FSTs among them) it stalls a serving loop for
longer than a tick, so the stream driver freezes its set-up's heap."""

from __future__ import annotations

import gc
import sys
import time
from typing import Dict, List


class GcWatch:
    def __init__(self):
        self.pauses: List[List[float]] = [[], [], []]
        self._t0 = 0.0

    def _cb(self, phase: str, info: Dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.pauses[info["generation"]].append(time.perf_counter() - self._t0)

    def __enter__(self) -> "GcWatch":
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc) -> None:
        gc.callbacks.remove(self._cb)

    def report(self, window_s: float) -> None:
        full = self.pauses[2]
        print(f"gc: {len(full)} full collections in {window_s:.1f} s, "
              f"{sum(full):.3f} s in all, longest {max(full, default=0.0) * 1e3:.1f} ms; "
              f"{sum(len(p) for p in self.pauses[:2])} young, "
              f"{sum(sum(p) for p in self.pauses[:2]):.3f} s", file=sys.stderr)
