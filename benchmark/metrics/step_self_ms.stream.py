"""Host milliseconds of a ``step()`` that decoded a lane, less its wait on
the card: the scheduler's own span from entry to return, mean over the
window's decoding steps (``harness/program_trace.py``)."""

from benchmark.harness import program_trace


def read(record):
    return program_trace.step_ms(record, "self")
