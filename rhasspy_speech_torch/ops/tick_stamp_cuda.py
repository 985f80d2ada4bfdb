"""Device stamps inside the stream tick (``csrc/tick_stamp.cu``).

``tick_stamp(buf, slot)`` writes the time into ``buf[slot]`` (int64 ns) in
stream order: on a CUDA buffer one single-thread kernel reads the card's
``%globaltimer``, so a captured tick body stamps on every replay; on a CPU
buffer (the plain twin, the body running eagerly) the host's
``time.perf_counter_ns()``. ``tick_stamp.launches`` counts kernel launches.

``calibrate(device)`` maps a device's stamps onto the host's
``time.perf_counter`` clock: ``host_s = base_s + (ns - base_ns) * 1e-9``.
It stamps on a side stream of its own, so it does not wait for the work
queued on the device. The two clocks drift apart (an H100's by ~4 ppm,
PERF.md), so a mapping holds for a second or so: the stream scheduler
calibrates again every ``pipeline.scheduler.CLOCK_PERIOD_S``.
"""

from __future__ import annotations

import ctypes
import time
from typing import Dict, NamedTuple, Tuple

import torch

from . import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
CALIBRATION_ROUNDS = 5
# by device index: calibrate()'s high-priority stream and its stamp buffer
_SIDE: Dict[int, Tuple[torch.cuda.Stream, torch.Tensor]] = {}


def _lib() -> ctypes.CDLL:
    lib = _build.load("tick_stamp")
    if lib.rss_tick_stamp_launch.argtypes is None:
        lib.rss_tick_stamp_launch.argtypes = [_P, _I, _I, _P]
        lib.rss_tick_stamp_launch.restype = _I
    return lib


def tick_stamp(buf: torch.Tensor, slot: int) -> None:
    """``buf[slot]`` = now, in ns: the card's clock for a CUDA ``buf`` (one
    launch on the current stream), the host's ``perf_counter_ns`` for a CPU
    one."""
    if buf.dtype != torch.int64 or buf.dim() != 1 or not 0 <= slot < buf.shape[0]:
        raise ValueError(f"tick_stamp: need an int64 [n > {slot}] buffer, got "
                         f"{buf.dtype} {tuple(buf.shape)}")
    dev = buf.device
    if dev.type == "cpu":
        buf[slot] = time.perf_counter_ns()
        return
    if dev.type != "cuda":
        raise ValueError(f"tick_stamp: unsupported device {dev}")
    lib = _lib()
    err = lib.rss_tick_stamp_launch(buf.data_ptr(), slot, dev.index,
                                    torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "tick stamp kernel launch")
    tick_stamp.launches += 1


tick_stamp.launches = 0


class Clock(NamedTuple):
    """A device stamp ``ns`` is host time ``base_s + (ns - base_ns) * 1e-9``
    on ``time.perf_counter``'s clock, within ``error_s``."""

    base_ns: int
    base_s: float
    error_s: float

    def host(self, ns: int) -> float:
        return self.base_s + (int(ns) - self.base_ns) * 1e-9


HOST_CLOCK = Clock(0, 0.0, 0.0)  # a CPU buffer's stamps are perf_counter_ns


def calibrate(device: torch.device) -> Clock:
    """The device clock on the host's: ``CALIBRATION_ROUNDS`` stamps on a
    high-priority side stream, ``perf_counter`` read before each one's
    launch and after that stream's synchronize (the device's other streams
    run on); the tightest bracket gives the base (its middle) and the error
    (its half width)."""
    if device.type != "cuda":
        return HOST_CLOCK
    index = torch.cuda.current_device() if device.index is None else device.index
    side = _SIDE.get(index)
    if side is None:
        stream = torch.cuda.Stream(index, priority=-1)
        with torch.cuda.stream(stream):  # no kernel: nothing to order
            side = _SIDE[index] = (stream, torch.empty(CALIBRATION_ROUNDS, dtype=torch.int64,
                                                       device=torch.device("cuda", index)))
    stream, buf = side
    brackets = []
    with torch.cuda.stream(stream):
        for i in range(CALIBRATION_ROUNDS):
            h0 = time.perf_counter()
            tick_stamp(buf, i)
            stream.synchronize()
            brackets.append((h0, time.perf_counter()))
        stamps = buf.tolist()  # copied on the side stream
    best = min(range(CALIBRATION_ROUNDS), key=lambda i: brackets[i][1] - brackets[i][0])
    h0, h1 = brackets[best]
    return Clock(int(stamps[best]), 0.5 * (h0 + h1), 0.5 * (h1 - h0))
