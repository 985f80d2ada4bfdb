"""Milliseconds from a stream's flushing tick's body end (s5, on the host
clock) to its transcript being set: the row's landing, the host noticing
it at its next ``step()`` or ``poll()``, and the word assembly; mean over
the window's finalized streams (``harness/program_trace.py``)."""

from benchmark.harness import program_trace


def read(record):
    return program_trace.fin_ms(record, "result")
