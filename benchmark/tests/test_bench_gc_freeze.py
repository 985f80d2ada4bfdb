"""The stream driver freezes its set-up's heap (``gc.freeze``) before the
arrivals, so that a full collection of Python's cyclic collector inside the
window walks only what serving made, and unfreezes it before the
comparison with the reference."""

import gc

from conftest import tiny_cell

from benchmark.harness import main


def test_stream_window_runs_on_a_frozen_heap(tiny_bench, monkeypatch):
    cell = tiny_cell(tiny_bench, "tdnnf-stream-rt")
    Driver = cell.driver().Driver
    seen = {}
    window, check = Driver.window, Driver.check

    def spy_window(self, trace):
        seen["window"] = gc.get_freeze_count()
        return window(self, trace)

    def spy_check(self):
        seen["check"] = gc.get_freeze_count()
        return check(self)

    monkeypatch.setattr(Driver, "window", spy_window)
    monkeypatch.setattr(Driver, "check", spy_check)
    res = main.run(cell, 2 ** 31 + 11, 1.5, False, "cpu")
    assert res["correct"] is True, res["checks"]
    # the set-up's heap (the modules, the model, the grammar) is frozen
    assert seen["window"] > 10000
    # and released before the comparison (CPython 3.12 still counts a few
    # hundred objects frozen after ``gc.unfreeze`` and a collection)
    assert seen["check"] < seen["window"] // 100
