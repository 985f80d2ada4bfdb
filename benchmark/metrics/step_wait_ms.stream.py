"""Host milliseconds a ``step()`` that decoded a lane was blocked on the
card (the scheduler's ``_pace()`` and any blocking wait for a row inside
it), mean over the window's decoding steps (``harness/program_trace.py``)."""

from benchmark.harness import program_trace


def read(record):
    return program_trace.step_ms(record, "wait")
