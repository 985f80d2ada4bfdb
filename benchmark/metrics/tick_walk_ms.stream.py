"""Device milliseconds of the fused tick from s4 to s5 (its end): the
silence weights, the backpointer ring's re-encode and write, and K4's
walk into the packed rows; mean over the window's fused ticks
(``harness/program_trace.py``)."""

from benchmark.harness import program_trace


def read(record):
    return program_trace.tick_stage_ms(record, "walk")
