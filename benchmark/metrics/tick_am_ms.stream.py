"""Device milliseconds of the fused tick from s2 to s3: the chunk AM over
every slot; mean over the window's fused ticks
(``harness/program_trace.py``)."""

from benchmark.harness import program_trace


def read(record):
    return program_trace.tick_stage_ms(record, "am")
