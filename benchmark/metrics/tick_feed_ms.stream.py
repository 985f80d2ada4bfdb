"""Device milliseconds of the fused tick from its body's start (s0) to after
``feed_feats`` (s1): the upload's unpack, K1 and the feature-ring write;
mean over the window's fused ticks, from the tick's own stamps
(``harness/program_trace.py``)."""

from benchmark.harness import program_trace


def read(record):
    return program_trace.tick_stage_ms(record, "feed")
