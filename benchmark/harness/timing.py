"""Device time of a call on the card, host issue excluded: the calls are
queued behind long matrix products, so the card runs them back to back and
CUDA events around them time the card alone. Copied from
``rhasspy_speech_torch/utils/timing.py:device_ms`` so that the benchmark's
timer cannot move with the program."""

from __future__ import annotations

from typing import Callable

# blocker products tried in turn until the host issues every call before
# the card reaches the first: 8192^3 f32 products, ~20 ms each on an H100
BLOCKER_PRODUCTS = (2, 8, 32, 128)


def device_ms(fn: Callable[[], object], iters: int = 20) -> float:
    """Mean milliseconds of device time a call of ``fn``; raises where
    ``fn`` waits for the card, because then no number of products can hide
    the host."""
    import torch

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
        "matrix products; the call waits for the card")
