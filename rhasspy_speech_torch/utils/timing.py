"""Timers for the card, shared by ``chip_smoke.py`` and the examples so that
every figure the repository states is timed one way.

- ``cuda_ms``: CUDA events around back-to-back calls. The span includes
  whatever time the card waits while the host issues the calls.
- ``device_ms``: the same calls queued behind long matrix products, so the
  card runs them back to back and the events time the card alone.
- ``p50_p90``: the percentiles every tick figure is quoted at.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np
import torch

# blocker products tried in turn until the host issues every call before
# the card reaches the first: 8192^3 f32 products, ~20 ms each on an H100
BLOCKER_PRODUCTS = (2, 8, 32, 128)


def cuda_ms(fn: Callable[[], object], iters: int = 10) -> float:
    """Mean milliseconds a call on the card over ``iters`` back-to-back calls
    (CUDA events, after one untimed call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_ms(fn: Callable[[], object], iters: int = 20) -> float:
    """Mean milliseconds of device time a call, host issue excluded. The
    calls are queued behind long matrix products, so the card runs them back
    to back and the events around them time the card alone. Where the host
    has not issued every call before the products end, the run is repeated
    behind more of them. Raises where ``fn`` waits for the card, because
    then no number of products can hide the host."""
    fn()
    blocker = torch.empty((8192, 8192), device="cuda")
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    ready = torch.cuda.Event()
    for products in BLOCKER_PRODUCTS:
        torch.cuda.synchronize()
        for _ in range(products):
            torch.mm(blocker, blocker)
        ready.record()
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        queued = not ready.query()  # the card is still on the products
        torch.cuda.synchronize()
        if queued:
            return start.elapsed_time(stop) / iters
    raise RuntimeError(
        f"device_ms: {iters} calls were not all issued behind {BLOCKER_PRODUCTS[-1]} "
        f"matrix products; the call waits for the card")


def p50_p90(ms: Sequence[float]) -> Tuple[float, float]:
    """(p50, p90) of ``ms``; NaN for none."""
    arr = np.asarray(ms, dtype=np.float64)
    if arr.size == 0:
        return float("nan"), float("nan")
    return float(np.percentile(arr, 50)), float(np.percentile(arr, 90))
