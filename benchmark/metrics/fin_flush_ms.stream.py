"""Host milliseconds from a stream's ``finish()`` to the issue of the tick
that flushes it (the ticks before, for its partial last chunk), mean over
the window's finalized streams (``harness/program_trace.py``)."""

from benchmark.harness import program_trace


def read(record):
    return program_trace.fin_ms(record, "flush")
