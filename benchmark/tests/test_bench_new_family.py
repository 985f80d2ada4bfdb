"""A model family joins the benchmark as new files alone. On a copy of the
benchmark, a third family is written as two new files (the TDNN-LSTM's
writer and reference under a name of their own, reading one argument more),
with a configuration of it and a cell under each traffic kind; the
benchmark's own coverage and throwaway checks (``test_bench_extend.py``)
take it, the cells run to ``correct`` on the CPU, and no file the copy had
before changes."""

import contextlib
import json
import shutil
import sys

import pytest

from conftest import copy_bench, shrink, tiny_args, tiny_cell
from test_bench_extend import check_coverage, digests, run_throwaway_cell

FAMILY = "tdnnlstm_delayed"
BASE = "tdnn_lstm"  # the family whose files the new one starts from
CONFIG = "tdnnlstm-delayed"
# the new family's arguments at a card's size; ``shrink`` takes them to the
# family's TINY_ARGS
CARD_ARGS = {"num_ceps": 40, "ivector_dim": 100, "ubm_gauss": 512, "num_pdfs": 2328,
             "hidden_dim": 1024, "cell_dim": 1024, "proj_dim": 256, "label_delay": 0}
# each cell: (the traffic mix it runs, the cell whose comparison it copies,
# the prefix of the end-to-end metrics it reports)
CELLS = {f"{CONFIG}-stream": ("poisson-rt", "tdnnf-stream-rt", "stream_"),
         f"{CONFIG}-batch": ("batch32-closed", "tdnnf-batch32", "batch_")}

# appended to the base family's files: the new argument is read by both, and
# the family's CPU size is its own (a hidden width no other family uses)
REFERENCE_TAIL = '''

TINY_ARGS = dict(TINY_ARGS, hidden_dim=24, label_delay=0)
_base_weights = weights


def weights(args, seed):
    if args["label_delay"]:
        raise ValueError("this layout has no label delay")
    return _base_weights(args, seed)
'''
WRITER_TAIL = '''

_base_write = write


def write(model_dir, args, seed):
    if args["label_delay"]:
        raise ValueError("this layout has no label delay")
    return _base_write(model_dir, args, seed)
'''


@contextlib.contextmanager
def checkout(root):
    """Import ``benchmark`` from ``root``, as a run in a checkout of it does:
    the harness finds a family's files by importing them by name."""
    def ours():
        return [k for k in sys.modules if k == "benchmark" or k.startswith("benchmark.")]

    saved = {k: sys.modules.pop(k) for k in ours()}
    sys.path.insert(0, str(root))
    try:
        yield
    finally:
        sys.path.remove(str(root))
        for k in ours():
            del sys.modules[k]
        sys.modules.update(saved)


@pytest.fixture(scope="module")
def grown(tmp_path_factory):
    """A CPU-size copy of the benchmark with the family, its configuration
    and its cells added; returns (root, the digests the copy had before)."""
    root = copy_bench(tmp_path_factory.mktemp("grown"), waiting=True)
    b = root / "benchmark"
    shrink(b)
    before = digests(root)

    (b / "reference" / "nets" / f"{FAMILY}.py").write_text(
        (b / "reference" / "nets" / f"{BASE}.py").read_text() + REFERENCE_TAIL)
    (b / "models" / f"{FAMILY}.py").write_text(
        (b / "models" / f"{BASE}.py").read_text() + WRITER_TAIL)
    config = json.loads((b / "configs" / "tdnnf-minilibri1h-grammar13789.json").read_text())
    config.update(name=CONFIG, description="a TDNN-LSTM family added as files",
                  model={"family": FAMILY, "args": CARD_ARGS}, assumed={}, reduced=[])
    (b / "configs" / f"{CONFIG}.json").write_text(json.dumps(config))
    for cell, (_, like, _) in CELLS.items():
        (b / "workloads" / f"{cell}.json").write_text(json.dumps(
            {"why": "a cell of the added family", "check": json.loads(
                (b / "workloads" / f"{like}.json").read_text())["check"]}))

    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": CONFIG, "source": config["source"],
                             "file": f"benchmark/configs/{CONFIG}.json", "reduced": [],
                             "why": "a TDNN-LSTM family added as files"})
    for cell, (traffic, _, prefix) in CELLS.items():
        bench["workloads"].append({"name": cell, "config": CONFIG, "traffic": traffic,
                                   "chips": 1, "why": "a cell of the added family"})
        for m in bench["end_to_end"]:
            if m["name"].startswith(prefix):
                m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    shrink(b)
    return root, before


def test_family_is_new_files_only(grown):
    root, before = grown
    b = root / "benchmark"
    after = digests(root)
    assert all(after[k] == v for k, v in before.items())  # nothing edited
    assert set(after) - set(before) == {
        f"benchmark/reference/nets/{FAMILY}.py", f"benchmark/models/{FAMILY}.py",
        f"benchmark/configs/{CONFIG}.json"} | {f"benchmark/workloads/{c}.json" for c in CELLS}
    check_coverage(b)
    # shrunk to the family's own CPU size
    config = json.loads((b / "configs" / f"{CONFIG}.json").read_text())
    assert config["model"]["args"] == tiny_args(b, FAMILY)
    assert tiny_args(b, FAMILY) != tiny_args(b, BASE)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_family_cell_runs(grown, cell):
    root, before = grown
    with checkout(root):
        from benchmark.harness import main

        res = main.run(tiny_cell(root, cell), 7, 2.0, False, "cpu")
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    bench = json.loads((root / "BENCHMARK.json").read_text())
    assert set(res["metrics"]) == {m["name"] for m in bench["end_to_end"]
                                   if m["name"].startswith(CELLS[cell][2])} | {"setup_s"}
    assert all(digests(root)[k] == v for k, v in before.items())


def test_family_throwaway_cell(tmp_path, grown):
    """The throwaway check of ``test_bench_extend.py`` on a copy of the grown
    benchmark, under one traffic kind (the cells above run both)."""
    root = tmp_path / "grown"
    shutil.copytree(grown[0], root)
    with checkout(root):
        run_throwaway_cell(root, FAMILY, "batch_closed")
