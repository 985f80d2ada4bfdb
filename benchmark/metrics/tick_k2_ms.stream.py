"""Device milliseconds of the fused tick from s3 to s4: K2, the Viterbi
kernel with the carried alpha; mean over the window's fused ticks
(``harness/program_trace.py``)."""

from benchmark.harness import program_trace


def read(record):
    return program_trace.tick_stage_ms(record, "k2")
