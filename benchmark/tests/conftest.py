"""CPU tests of the benchmark (``python -m pytest benchmark/tests``).

``tiny_bench`` copies the benchmark's files into a temporary directory with
the configurations shrunk to CPU size (each family's layout at its own
``TINY_ARGS``, a small grammar, few slots and short utterances), so a
whole run -- set-up, window, reference comparison, result line -- drives
the port's plain twins here.
Tests that need a card are marked ``cuda`` and skip, decided in the
``cuda`` fixture."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_GRAMMAR = {"areas": 3, "devices": 3, "scenes": 2}
TINY_TRAFFIC = {
    "batch_closed": {"batch": 4, "min_s": 1.0, "max_s": 2.0, "distinct_batches": 2},
    "poisson_stream": {"rate_per_s": 1.5, "slots": 6, "min_s": 1.0, "max_s": 2.0,
                       "prefill_s": 2.0},
}


def tiny_args(bench_dir: Path, family: str) -> dict:
    """The family's arguments at CPU size: ``TINY_ARGS`` of its reference
    under ``bench_dir``."""
    from benchmark.harness.spec import load_module

    return json.loads(json.dumps(
        load_module(bench_dir / "reference" / "nets" / f"{family}.py").TINY_ARGS))


def shrink(bench_dir: Path, widths: bool = True) -> None:
    """Every configuration, mix and workload under ``bench_dir`` to CPU size
    (``widths=False`` keeps the models' widths: a card's size). A
    configuration takes each of its arguments that its family's
    ``TINY_ARGS`` holds from there and keeps the others."""
    for p in (bench_dir / "configs").glob("*.json"):
        c = json.loads(p.read_text())
        if widths:
            tiny = tiny_args(bench_dir, c["model"]["family"])
            c["model"]["args"] = {k: tiny.get(k, v) for k, v in c["model"]["args"].items()}
        c["graph"]["args"].update(TINY_GRAMMAR)
        c["graph"]["states"] = c["graph"]["arcs"] = None
        p.write_text(json.dumps(c))
    for p in (bench_dir / "traffic").glob("*.json"):
        t = json.loads(p.read_text())
        t.update(TINY_TRAFFIC[t["kind"]])
        p.write_text(json.dumps(t))
    for p in (bench_dir / "workloads").glob("*.json"):
        w = json.loads(p.read_text())
        for k in ("sample_calls", "sample_streams"):
            if k in w["check"]:
                w["check"][k] = 3
        p.write_text(json.dumps(w))


def copy_bench(dst: Path, waiting: bool = False) -> Path:
    """The benchmark's files and ``BENCHMARK.json`` under ``dst``; returns
    the copy's root. ``waiting`` adds the entries of the cells held back
    (``benchmark/waiting/<cell>.json``) to the copy's ``BENCHMARK.json``."""
    shutil.copytree(ROOT / "benchmark", dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    if waiting:
        for p in sorted((ROOT / "benchmark" / "waiting").glob("*.json")):
            held = json.loads(p.read_text())
            for key in ("workloads", "end_to_end", "per_layer"):
                bench[key] += held[key]
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return dst


@pytest.fixture
def tiny_bench(tmp_path) -> Path:
    root = copy_bench(tmp_path, waiting=True)
    shrink(root / "benchmark")
    return root


@pytest.fixture
def card_bench(tmp_path) -> Path:
    """The benchmark at its models' widths, with the small grammar, mixes
    and samples of ``tiny_bench``."""
    root = copy_bench(tmp_path, waiting=True)
    shrink(root / "benchmark", widths=False)
    return root


def tiny_cell(root: Path, name: str):
    from benchmark.harness.spec import load_cell

    return load_cell(name, root / "BENCHMARK.json", root / "benchmark")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
