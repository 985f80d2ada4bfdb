"""Tick bodies the scheduler issued after a stream's ``finish()`` before
the tick that flushes it, mean over the window's finalized streams
(``harness/program_trace.py``)."""

from benchmark.harness import program_trace


def read(record):
    return program_trace.fin_ticks(record)
