"""Milliseconds from the issue of a stream's flushing tick to that tick's
body end on the card (its s5 stamp on the host clock): the queue behind
the tick in flight and its own run; mean over the window's finalized
streams (``harness/program_trace.py``)."""

from benchmark.harness import program_trace


def read(record):
    return program_trace.fin_ms(record, "device")
