"""Spans and taps the benchmark puts around the program's calls, from its own
files: an attribute of an object or module is replaced by a wrapper that
calls the original, and put back by ``Hooks.undo``. Nothing here waits for
the device."""

from __future__ import annotations

import contextlib
from typing import Any, Callable, List, Tuple


class Hooks:
    def __init__(self):
        self._saved: List[Tuple[Any, str, Any, bool]] = []

    def wrap(self, owner: Any, attr: str, make: Callable[[Callable], Callable]) -> None:
        """Replace ``owner.attr`` by ``make(original)``."""
        had = attr in vars(owner) if hasattr(owner, "__dict__") else True
        orig = getattr(owner, attr)
        self._saved.append((owner, attr, vars(owner).get(attr) if had else None, had))
        setattr(owner, attr, make(orig))

    def span(self, owner: Any, attr: str, name: str) -> None:
        """A profiler range named ``name`` around each call."""
        import torch

        def make(orig):
            def wrapper(*a, **k):
                with torch.profiler.record_function(name):
                    return orig(*a, **k)
            return wrapper

        self.wrap(owner, attr, make)

    def undo(self) -> None:
        while self._saved:
            owner, attr, value, had = self._saved.pop()
            if had:
                setattr(owner, attr, value)
            else:
                with contextlib.suppress(AttributeError):
                    delattr(owner, attr)
