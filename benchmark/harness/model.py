"""A cell's model directory and decode graph, written afresh in every run.

The configuration's ``model.family`` names the writer
(``benchmark/models/<family>.py``) and ``model.args`` its sizes; the
weights' seed is the run's ``--seed``. The grammar's trainer is named by
``module:function`` with its arguments, its seed the configuration's (the
graph is part of the deployment, not of the input).
"""

from __future__ import annotations

import importlib
import sys
import time
from pathlib import Path
from typing import Dict, List, Tuple

# RandomState takes seeds below 2**32; the run's seed may be larger
SEED_MODULUS = 2 ** 32 - 1


def resolve(ref: str):
    module, _, name = ref.partition(":")
    return getattr(importlib.import_module(module), name)


def weight_seed(seed: int) -> int:
    return seed % SEED_MODULUS


class Steps:
    """Seconds of each step of a set-up, printed on standard error."""

    def __init__(self):
        self.t = time.perf_counter()
        self.done: List[Tuple[str, float]] = []

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.done.append((name, now - self.t))
        self.t = now

    def report(self) -> None:
        print("setup: " + ", ".join(f"{n} {s:.2f} s" for n, s in self.done), file=sys.stderr)


def build(config: Dict, seed: int, workdir: Path, steps: Steps) -> Tuple[Path, Path]:
    """Write the model directory and train the graph under ``workdir``;
    returns (model_dir, graph_dir). Raises when the trained graph differs
    in size from the configuration's."""
    from benchmark import models

    model = config["model"]
    model_dir = Path(workdir) / "model"
    models.load(model["family"]).write(model_dir, model["args"], weight_seed(seed))
    steps.mark("model directory")
    graph = config["graph"]
    graph_dir = Path(resolve(graph["trainer"])(Path(workdir) / "train", model_dir, **graph["args"]))
    steps.mark("grammar")
    return model_dir, graph_dir


def check_graph(config: Dict, graph) -> None:
    """The trained graph must be the configuration's: a change in the
    grammar compiler that grows or shrinks it changes the cell."""
    want = config["graph"]
    got = {"states": graph.num_states, "arcs": graph.num_arcs}
    if any(want.get(k) is not None and want[k] != v for k, v in got.items()):
        raise RuntimeError(f"trained graph {got} differs from the configuration's "
                           f"{ {k: want.get(k) for k in got} }")
