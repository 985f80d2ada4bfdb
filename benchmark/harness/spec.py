"""Where everything of a cell lives, found by the names in ``BENCHMARK.json``.

- ``BENCHMARK.json`` (the repository's root): the cells, their
  configurations and traffic, the metrics.
- ``benchmark/configs/<config>.json``: the model family and its sizes (the
  family names the model directory's writer, ``benchmark/models/<family>.py``,
  and the reference's net, ``benchmark/reference/nets/<family>.py``), the
  grammar's trainer and its arguments, the precision, the host's threads,
  and the source, assumed and reduced keys.
- ``benchmark/traffic/<traffic>.json``: a traffic mix, ``kind`` and that
  kind's parameters; ``benchmark/traffic/<kind>.py`` generates it from the
  seed and ``benchmark/drivers/<kind>.py`` drives the system with it.
- ``benchmark/workloads/<cell>.json``: the cell's comparison (sample sizes
  and each compared number's limit, with the readings it was set from).
- ``benchmark/metrics/<metric>.py``: the reader of one per-layer metric.
- ``benchmark/waiting/<cell>.json``: the ``BENCHMARK.json`` entries of a
  cell held back, with why (the harness does not read them; the tests do).

A later cell, configuration, model family, mix or metric is new files and
new entries; nothing here names one. A model family is its writer,
``benchmark/models/<family>.py``, and its reference,
``benchmark/reference/nets/<family>.py``.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parent.parent
REPO_ROOT = BENCH_DIR.parent


def load_json(path: Path) -> Dict:
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def load_module(path: Path) -> ModuleType:
    """Import ``path`` under a name of its own (metric readers have dots in
    their file names)."""
    name = "bench_" + re.sub(r"\W", "_", str(Path(path).resolve().with_suffix("")))
    mod = sys.modules.get(name)
    if mod is None:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    entry: Dict  # the cell's entry in BENCHMARK.json
    config: Dict
    traffic: Dict
    workload: Dict
    bench: Dict  # the whole BENCHMARK.json
    bench_dir: Path = BENCH_DIR

    @property
    def kind(self) -> str:
        return self.traffic["kind"]

    def driver(self) -> ModuleType:
        return load_module(self.bench_dir / "drivers" / f"{self.kind}.py")

    def generator(self) -> ModuleType:
        return load_module(self.bench_dir / "traffic" / f"{self.kind}.py")

    def end_to_end(self) -> List[Dict]:
        """The end-to-end metrics this cell reports: those listing it, and
        those that list no cells."""
        return [m for m in self.bench["end_to_end"]
                if "workloads" not in m or self.name in m["workloads"]]

    def per_layer(self) -> List[Dict]:
        """The per-layer metrics this cell reports: those listing it, and
        those without a list that move an end-to-end metric it reports."""
        mine = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m else m["moves"] in mine)]


def load_cell(name: str, bench_path: Path = REPO_ROOT / "BENCHMARK.json",
              bench_dir: Path = BENCH_DIR) -> Cell:
    bench = load_json(bench_path)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(entries)}")
    entry = entries[name]
    return Cell(
        name=name, entry=entry,
        config=load_json(bench_dir / "configs" / f"{entry['config']}.json"),
        traffic=load_json(bench_dir / "traffic" / f"{entry['traffic']}.json"),
        workload=load_json(bench_dir / "workloads" / f"{name}.json"),
        bench=bench, bench_dir=bench_dir,
    )
