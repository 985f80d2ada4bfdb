"""Warm start: pay a serving process's one-time costs before its first
answer.

Replaces the JAX package's ``utils/aot.py`` (StableHLO programs exported
with ``jax.export``) and ``utils/compile_cache.py`` (XLA's persistent
compilation cache). Neither has a meaning for hand-written CUDA: the port
traces and lowers nothing. What a fresh process pays before its first
transcript here is

- the kernels' nvcc builds (cached on disk by source hash under
  ``csrc/build/``, ``ops/_build.py``) and their library loads;
- the CUDA context and the cuBLAS handles of the AM's products;
- the tables the kernels keep per graph or frontend (``kernel_cache``), the
  pitch tables, and the AM's plan for each output bucket
  (``AcousticModel.compiled``);
- on the stream scheduler's device route, one CUDA-graph capture per tick
  body and PCM width (``pipeline/device_tick.py`` ``TickRunner``).

``warmup()`` on the transcriber and the scheduler pays all of that for
given shapes. ``save_aot()`` keeps the JAX package's name and return value:
it warms, then records the warmed shapes with the configuration and the
kernel library names in a manifest, ``<aot_dir>/warmup.json`` (default
``aot_dir``: ``<graph_dir>/aot``, as in the JAX package). A constructor
that finds a manifest whose configuration equals its own warms those shapes
before it returns; a manifest of another configuration is ignored, as the
JAX package ignores a blob of another shape. Warming runs the same code as
serving, so it never changes an answer. The JAX package's compile-cache
environment switches have no counterpart.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Sequence

import torch

from ..ops import _build

MANIFEST = "warmup.json"
FORMAT = 1


def file_digest(path: Path) -> str:
    """sha256 of a file's bytes ("" when it is missing)."""
    path = Path(path)
    if not path.is_file():
        return ""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def base_config(am, graph_dir: Path, device: torch.device) -> Dict:
    """What every warmed configuration shares: the model and graph files'
    digests, the frontend, the AM's compute dtype, the device type and the
    torch version."""
    model = am._resolved_model_dir / "model"
    return {
        "format": FORMAT,
        "model": file_digest(model / "final.mdl"),
        "graph": file_digest(Path(graph_dir) / "graph.npz"),
        "frontend": dataclasses.asdict(am.frontend_config),
        "compute_dtype": "bfloat16" if am.bf16 else "float32",
        "device": device.type,
        "torch": torch.__version__,
    }


def library_names(kernels: Iterable[str]) -> List[str]:
    """The kernel libraries' file names (source and flags hashed), which
    the manifest records."""
    return [_build.library_path(k).name for k in sorted(set(kernels))]


def load_kernels(kernels: Iterable[str], device: torch.device) -> None:
    """Build (one nvcc a source, all at once) and load the kernels'
    libraries; on the CPU nothing is built, the plain twins run there."""
    names = sorted(set(kernels))
    if device.type != "cuda" or not names:
        return
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(_build.load, names))


def _plain(config: Dict) -> Dict:
    """The configuration as the manifest stores it (tuples as lists)."""
    return json.loads(json.dumps(config))


class Manifest:
    """``<aot_dir>/warmup.json``: per configuration kind (``"batch"`` or
    ``"scheduler"``), the configuration and the shapes warmed for it."""

    def __init__(self, aot_dir):
        self.dir = Path(aot_dir)
        self.path = self.dir / MANIFEST

    def _read(self) -> Dict:
        try:
            return json.loads(self.path.read_text(encoding="utf-8"))
        except (OSError, ValueError):
            return {}

    def shapes(self, kind: str, config: Callable[[], Dict], kernels: Sequence[str]) -> List:
        """The shapes warmed for the configuration ``config()`` (called
        only when the manifest holds an entry of this kind) and the kernel
        libraries of ``kernels``; empty when the manifest holds none, holds
        another configuration, or was written for other kernel sources
        (whose first load would run nvcc)."""
        entry = self._read().get(kind) if self.path.is_file() else None
        if (not entry or entry.get("kernels") != library_names(kernels)
                or entry.get("config") != _plain(config())):
            return []
        return entry.get("shapes", [])

    def add(self, kind: str, config: Dict, kernels: Sequence[str], shape) -> Path:
        """Record ``shape`` as warmed for ``config`` and ``kernels`` (an
        entry of another configuration or other kernel libraries is
        replaced), atomically."""
        config, libraries = _plain(config), library_names(kernels)
        data = self._read()
        entry = data.get(kind)
        if not entry or entry.get("config") != config or entry.get("kernels") != libraries:
            entry = {"config": config, "kernels": libraries, "shapes": []}
        shape = list(shape)
        if shape not in entry["shapes"]:
            entry["shapes"].append(shape)
        data[kind] = entry
        self.dir.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_name(f"{MANIFEST}.{os.getpid()}.tmp")
        tmp.write_text(json.dumps(data, indent=1, sort_keys=True), encoding="utf-8")
        os.replace(tmp, self.path)
        return self.dir


def counters(target) -> Dict[str, int]:
    """What a first call could still pay on ``target`` (a transcriber or a
    scheduler): nvcc runs and kernel libraries loaded in this process, the
    AM's bucket plans, and the scheduler's tick bodies run once per key (on
    a card: captured)."""
    out = {"nvcc_runs": _build.nvcc_runs, "libraries": len(_build.loaded()),
           "bucket_plans": len(target.am._buckets)}
    runner = getattr(target, "_runner", None)
    if runner is not None:
        out["captures"] = len(runner.warm_keys)
    return out
