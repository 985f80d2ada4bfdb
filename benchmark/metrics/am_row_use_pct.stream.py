"""Lanes the chunk AM decoded as a share of the rows it ran: 100 x the
lanes summed over the window's fused ticks over their ``am_rows`` summed
(``harness/program_trace.py``); None where the program's tick records keep
no ``am_rows``."""

from benchmark.harness import program_trace


def read(record):
    got = program_trace.window(record)
    if got is None:
        return None
    fused = [t for t in got[0] if t.key == "fused" and getattr(t, "am_rows", None)]
    if not fused:
        return None
    return 100.0 * sum(t.lanes for t in fused) / sum(t.am_rows for t in fused)
