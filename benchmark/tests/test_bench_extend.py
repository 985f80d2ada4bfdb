"""A later PR adds a cell, a configuration, a model family, a traffic mix and
a per-layer metric with new files and new entries alone: no file of the
benchmark changes, and the harness finds and runs them by name. Each model
family the benchmark has a reference for (``reference/nets/``) runs under
each traffic kind (``traffic/<kind>.py``), so a cell of any pairing is data.

The checks take the benchmark's directory, so that
``test_bench_new_family.py`` runs them on a copy with a family added."""

import hashlib
import json

import pytest

from conftest import ROOT, copy_bench, shrink, tiny_args, tiny_cell

from benchmark.harness.spec import BENCH_DIR, load_module

# what each file of a family gives, by the family's folder
CONTRACT = {"reference/nets": ("weights", "window", "zero_state", "forward", "products",
                               "TINY_ARGS"),
            "models": ("write",)}
KINDS = {"batch_closed": ({"kind": "batch_closed", "batch": 2, "min_s": 1.0, "max_s": 1.5,
                           "distinct_batches": 1}, "tdnnf-batch32", "batch_"),
         "poisson_stream": ({"kind": "poisson_stream", "rate_per_s": 3.0, "slots": 6,
                             "push_samples": 1024, "min_s": 1.0, "max_s": 1.5,
                             "prefill_s": 2.0, "chunk_out_frames": 7, "tape_s": 20.0},
                            "tdnnf-stream-rt", "stream_")}
# shrink's output for the flagship's configuration, as it was before each
# family carried its own CPU size
TDNNF_TINY_SHA256 = "439181ba06802621d3cbabaa27ac6a5aaf2426fb10793d25e8dfca899cab4e9b"


def stems(folder):
    return {p.stem for p in folder.glob("*.py")} - {"__init__"}


def families(bench_dir):
    return sorted(stems(bench_dir / "reference" / "nets"))


FAMILIES = families(BENCH_DIR)


def digests(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "benchmark").rglob("*")) if p.is_file()}


def check_coverage(bench_dir):
    """Every family has a writer and a reference that give the whole
    contract, every writer a reference, and every traffic kind a driver."""
    found = families(bench_dir)
    assert found and stems(bench_dir / "models") == set(found)
    for family in found:
        for folder, names in CONTRACT.items():
            module = load_module(bench_dir / folder / f"{family}.py")
            missing = [n for n in names if not hasattr(module, n)]
            assert not missing, (folder, family, missing)
    assert set(KINDS) == stems(bench_dir / "drivers")


def run_throwaway_cell(root, family, kind):
    """A configuration of ``family`` at its ``TINY_ARGS``, a mix of
    ``kind``, a cell and two metrics added to the benchmark under ``root``
    as new files and entries, and the cell run on the CPU."""
    from benchmark.harness import main

    before = digests(root)
    old = json.loads((root / "BENCHMARK.json").read_text())
    b = root / "benchmark"
    mix, like, prefix = KINDS[kind]

    config = json.loads(next((b / "configs").glob("*.json")).read_text())
    config["name"] = f"throwaway-{family}"
    config["model"] = {"family": family, "args": tiny_args(b, family)}
    (b / "configs" / f"throwaway-{family}.json").write_text(json.dumps(config))
    (b / "traffic" / "throwaway-mix.json").write_text(json.dumps(mix))
    (b / "workloads" / "throwaway-cell.json").write_text(json.dumps(
        {"why": "a throwaway", "check": json.loads(
            (b / "workloads" / f"{like}.json").read_text())["check"]}))
    (b / "metrics" / "answers.throwaway.py").write_text(
        "def read(record):\n"
        "    return len(record.get('calls') or record.get('latency_s') or []) or None\n")
    (b / "metrics" / "nothing.throwaway.py").write_text(
        "def read(record):\n    return None\n")

    new = json.loads(json.dumps(old))
    new["configs"].append({"name": f"throwaway-{family}", "source": config["source"],
                           "file": f"benchmark/configs/throwaway-{family}.json",
                           "reduced": [], "why": "a throwaway"})
    new["workloads"].append({"name": "throwaway-cell", "config": f"throwaway-{family}",
                             "traffic": "throwaway-mix", "chips": 1, "why": "a throwaway"})
    e2e = [m["name"] for m in new["end_to_end"] if m["name"].startswith(prefix)]
    for m in new["end_to_end"]:
        if m["name"] in e2e:
            m["workloads"].append("throwaway-cell")
    for name in ("answers.throwaway", "nothing.throwaway"):
        new["per_layer"].append({"name": name, "unit": "n", "better": "higher",
                                 "source": "program_counter", "layer": "pipeline",
                                 "moves": e2e[0], "workloads": ["throwaway-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(new))

    after = digests(root)
    assert all(after[k] == v for k, v in before.items())  # nothing edited
    assert set(after) - set(before) == {
        f"benchmark/configs/throwaway-{family}.json", "benchmark/traffic/throwaway-mix.json",
        "benchmark/workloads/throwaway-cell.json", "benchmark/metrics/answers.throwaway.py",
        "benchmark/metrics/nothing.throwaway.py"}

    cell = tiny_cell(root, "throwaway-cell")
    res = main.run(cell, 5, 2.0, False, "cpu")
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == set(e2e) | {"setup_s"}
    res = main.run(cell, 6, 2.0, True, "cpu")
    assert res["correct"], res["checks"]
    # a reader that finds nothing is left out of the line
    assert res["metrics"]["answers.throwaway"]["value"] > 0
    assert "nothing.throwaway" not in res["metrics"]


def test_every_family_and_kind_is_covered():
    check_coverage(BENCH_DIR)


def test_shrink_keeps_the_tdnnf_cpu_size(tmp_path):
    root = copy_bench(tmp_path)
    shrink(root / "benchmark")
    path = root / "benchmark" / "configs" / "tdnnf-minilibri1h-grammar13789.json"
    assert hashlib.sha256(path.read_bytes()).hexdigest() == TDNNF_TINY_SHA256
    assert (ROOT / "benchmark" / "configs" / path.name).read_bytes() != path.read_bytes()


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("family", FAMILIES)
def test_throwaway_cell_from_files(tmp_path, family, kind):
    root = copy_bench(tmp_path, waiting=True)
    shrink(root / "benchmark")
    run_throwaway_cell(root, family, kind)
