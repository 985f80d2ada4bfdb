"""The ``am_row_use_pct.stream`` reader (``metrics/am_row_use_pct.stream.py``)
on synthetic tick records: None where the records keep no ``am_rows``, as an
older program's do, else 100 x the lanes summed over the window's fused ticks
over their ``am_rows`` summed."""

import pytest

from benchmark.harness.spec import BENCH_DIR, load_module


def reader(name):
    return load_module(BENCH_DIR / "metrics" / f"{name}.py").read


def test_am_row_use_reads_the_fused_ticks(monkeypatch):
    from rhasspy_speech_torch.utils import metrics

    reg = metrics.DecodeMetrics()
    monkeypatch.setattr(metrics, "_GLOBAL", reg)
    src = metrics.new_source()
    # (key, lanes, rows, step() entry); the window is the 5 s before the
    # newest finish() at 13 s
    ticks = [("fused", 3, 8, 10.0), ("fused", 9, 16, 11.0), ("fused", 8, 8, 12.0),
             ("chunk", 5, 8, 12.2), ("finalize", 0, None, 12.5), ("fused", 1, 8, 2.0)]
    for i, (key, lanes, _rows, t) in enumerate(ticks):
        reg.ticks.append(metrics.TickRecord(src, i, key, lanes, t, t))
    reg.streams.append(metrics.StreamRecord(src, 0, 0, t_finish=13.0))
    record = {"bounds": (0.0, 5.0), "window_s": 5.0}
    read = reader("am_row_use_pct.stream")
    assert read(record) is None
    for t, (_key, _lanes, rows, _t) in zip(reg.ticks, ticks):
        t.am_rows = rows
    assert read(record) == pytest.approx(100.0 * (3 + 9 + 8) / (8 + 16 + 8))
