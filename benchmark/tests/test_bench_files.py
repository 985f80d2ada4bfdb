"""Every file of the benchmark parses, and the harness finds each by the names
in ``BENCHMARK.json``."""

import json
import re

import pytest

from conftest import ROOT

from benchmark.harness.spec import BENCH_DIR, load_cell, load_json, load_module

BENCH = load_json(ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_contract_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and all(0 < m["bound"] <= 0.25 for m in e2e.values())
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_config_file(name):
    entry = next(c for c in BENCH["configs"] if c["name"] == name)
    config = load_json(ROOT / entry["file"])
    assert config["name"] == name and config["source"] == entry["source"]
    assert config["reduced"] == entry["reduced"]
    assert config["compute_dtype"] == "float32" and config["tf32"] is False
    assert config["model"]["family"] in {
        p.stem for p in (BENCH_DIR / "reference" / "nets").glob("*.py")}
    assert (BENCH_DIR / "models" / f"{config['model']['family']}.py").exists()
    for key in config["reduced"]:
        assert key in config or key in config["model"]["args"]
        assert not key.endswith(("_dim", "_rank"))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = load_cell(cell)
    assert c.entry["chips"] == 1
    assert c.workload["why"] == c.entry["why"]
    assert hasattr(c.driver(), "Driver") and hasattr(c.generator(), "make")
    reported = {m["name"] for m in c.end_to_end()}
    assert "setup_s" in reported and len(reported) >= 2
    layer = c.per_layer()
    assert layer
    for m in layer:
        assert callable(load_module(BENCH_DIR / "metrics" / f"{m['name']}.py").read)
        assert m["moves"] in reported
    for k, v in c.workload["check"]["limits"].items():
        assert v >= 0, k


WAITING = [load_json(p) for p in sorted((BENCH_DIR / "waiting").glob("*.json"))]


def test_every_metric_has_a_reader():
    """Every per-layer metric, of the benchmark's cells and of those held
    back, has its reader, and every reader a metric."""
    metrics = BENCH["per_layer"] + [m for w in WAITING for m in w["per_layer"]]
    for m in metrics:
        assert (BENCH_DIR / "metrics" / f"{m['name']}.py").exists(), m["name"]
    assert {p.name[:-3] for p in (BENCH_DIR / "metrics").glob("*.py")} == {
        m["name"] for m in metrics}


@pytest.mark.parametrize("held", WAITING, ids=lambda w: w["workloads"][0]["name"])
def test_held_back_cell_is_whole(held):
    """A cell held back names a configuration of the benchmark, has its
    workload and traffic files, and its metrics name no metric the
    benchmark has."""
    configs = {c["name"] for c in BENCH["configs"]}
    names = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    for w in held["workloads"]:
        assert w["config"] in configs and w["name"] not in CELLS
        assert (BENCH_DIR / "workloads" / f"{w['name']}.json").exists()
        assert (BENCH_DIR / "traffic" / f"{w['traffic']}.json").exists()
    for m in held["end_to_end"] + held["per_layer"]:
        assert m["name"] not in names and NAME.match(m["name"])
