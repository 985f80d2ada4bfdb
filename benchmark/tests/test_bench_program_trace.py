"""The per-layer metrics read from the program's own trace
(``harness/program_trace.py``): a tiny traced run of the stream cell on the
CPU, its records read back by every reader."""

import math

import pytest

from conftest import copy_bench, shrink, tiny_cell

from benchmark.harness import main, program_trace
from benchmark.harness.spec import BENCH_DIR, load_module

HOST = ["step_wait_ms.stream", "step_self_ms.stream", "fin_flush_ms.stream",
        "fin_ticks.stream"]
DEVICE = ["tick_feed_ms.stream", "tick_ivector_ms.stream", "tick_am_ms.stream",
          "tick_k2_ms.stream", "tick_walk_ms.stream", "fin_device_ms.stream",
          "fin_result_ms.stream"]


def reader(name):
    return load_module(BENCH_DIR / "metrics" / f"{name}.py").read


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """(result line, the run's record as a card's run leaves it, the same
    with a window that takes in the whole run). On a loaded CPU the tiny
    run's drain can outlast its 1.5 s window, and the window the readers
    select then holds little; the whole run's records are read alike."""
    from rhasspy_speech_torch.utils.metrics import reset_metrics

    root = copy_bench(tmp_path_factory.mktemp("trace"), waiting=True)
    shrink(root / "benchmark")
    reset_metrics()
    seen = {}
    layer_metrics = main.layer_metrics

    def spy(cell, record):
        seen["record"] = record
        return layer_metrics(cell, record)

    main.layer_metrics = spy
    try:
        res = main.run(tiny_cell(root, "tdnnf-stream-rt"), 2 ** 31 + 11, 1.5, True, "cpu")
    finally:
        main.layer_metrics = layer_metrics
    record = dict(seen["record"])
    lo, hi = record["bounds"]
    # a card's run keeps the window's length; the CPU's leaves it unset
    record["window_s"] = hi - lo
    return res, record, dict(record, window_s=3600.0)


def test_every_reader_finds_the_trace(traced):
    res, record, whole = traced
    assert res["correct"] is True, res["checks"]
    cpu = dict(record, window_s=None)
    for name in HOST:
        value = reader(name)(cpu)
        assert res["metrics"].get(name, {}).get("value") == value, name
    # a CPU run's stamps are the host's: no device reading in its line
    assert not set(DEVICE) & set(res["metrics"])
    for name in HOST + DEVICE:
        value = reader(name)(whole)
        assert value is not None and math.isfinite(value) and value >= 0, (name, value)


def test_finalize_spans_sum_to_finish_to_transcript(traced):
    _res, _record, whole = traced
    parts = [program_trace.fin_ms(whole, p) for p in program_trace.FIN_PARTS]
    assert sum(parts) == pytest.approx(program_trace.fin_total_ms(whole), abs=1e-6)
    assert program_trace.fin_ticks(whole) >= 0


def test_steps_match_the_clients_spans(traced):
    """Each ``step()`` that decoded a lane in the window (the client's own
    span around it, kept on the CPU) holds one decoding tick record, whose span (its
    wait plus its self time) is nearly all of it; the readers' window ends
    at the newest ``finish()``."""
    from rhasspy_speech_torch.utils.metrics import get_metrics

    _res, record, _whole = traced
    spans = [span for name, span in record["host_spans"] if name == "step()"]
    assert len(spans) == record["ticks"] > 0
    steps = [t for t in get_metrics().ticks if t.lanes > 0]
    inside = 0.0
    for a, b in spans:
        (t,) = [t for t in steps if a <= t.t_enter <= t.t_return <= b]
        inside += t.t_return - t.t_enter
    assert 0.97 * sum(b - a for a, b in spans) <= inside
    hi = max(s.t_finish for s in get_metrics().streams if s.t_finish is not None)
    chosen = program_trace.decoding_steps(record)
    assert all(hi - record["window_s"] <= t.t_enter <= hi for t in chosen)


def test_an_empty_registry_reads_none(traced):
    from rhasspy_speech_torch.utils import metrics

    _res, _record, whole = traced
    kept = metrics.get_metrics()
    metrics.reset_metrics()
    try:
        for name in HOST + DEVICE:
            assert reader(name)(whole) is None, name
    finally:
        metrics._GLOBAL = kept
