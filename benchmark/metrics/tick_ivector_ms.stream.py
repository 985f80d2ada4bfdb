"""Device milliseconds of the fused tick from s1 to s2: the AM windows
gathered, the slot reset and the i-vector fold (statistics, the batched
solve over every slot, the carried tap); mean over the window's fused
ticks (``harness/program_trace.py``)."""

from benchmark.harness import program_trace


def read(record):
    return program_trace.tick_stage_ms(record, "ivector")
