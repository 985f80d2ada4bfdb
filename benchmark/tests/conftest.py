"""CPU tests of the benchmark (``python -m pytest benchmark/tests``).

``tiny_bench`` copies the benchmark's files into a temporary directory with
the configurations shrunk to CPU size (same layouts, narrow widths, a small
grammar, few slots and short utterances), so a whole run -- set-up, window,
reference comparison, result line -- drives the port's plain twins here.
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

TINY_MODEL = {"num_pdfs": 400, "ivector_dim": 8, "ubm_gauss": 8, "hidden_dim": 32,
              "cell_dim": 32, "proj_dim": 8, "tdnn1_dim": 32, "tdnnf_dim": 32,
              "bottleneck_dim": 8, "prefinal_l_dim": 12, "prefinal_big_dim": 32,
              "prefinal_small_dim": 12}
# a TDNN-LSTM configuration in the port writer's layout, for the tests that
# pair each model family with each traffic kind
TDNN_LSTM_ARGS = {"num_ceps": 40, "ivector_dim": 100, "ubm_gauss": 512, "num_pdfs": 2328,
                  "hidden_dim": 1024, "cell_dim": 1024, "proj_dim": 256}
TINY_GRAMMAR = {"areas": 3, "devices": 3, "scenes": 2}
TINY_TRAFFIC = {
    "batch_closed": {"batch": 4, "min_s": 1.0, "max_s": 2.0, "distinct_batches": 2},
    "poisson_stream": {"rate_per_s": 1.5, "slots": 6, "min_s": 1.0, "max_s": 2.0,
                       "prefill_s": 2.0},
}


def tiny_model(args: dict) -> dict:
    return {k: TINY_MODEL.get(k, v) for k, v in args.items()}


def shrink(bench_dir: Path, widths: bool = True) -> None:
    """Every configuration, mix and workload under ``bench_dir`` to CPU size
    (``widths=False`` keeps the models' widths: a card's size)."""
    for p in (bench_dir / "configs").glob("*.json"):
        c = json.loads(p.read_text())
        if widths:
            c["model"]["args"] = tiny_model(c["model"]["args"])
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
