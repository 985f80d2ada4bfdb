"""One run of one cell: set up, measure for ``--seconds``, compare with the
plain reference, print one result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The run needs as many CUDA devices as the cell asks for and exits with 2,
printing no result, without them. With ``--trace 0`` the result's metrics
are the cell's end-to-end metrics; with ``--trace 1`` its per-layer
metrics, with ``device.busy_s`` and ``device.window_s`` and a
``breakdown``. ``correct`` is the comparison of what the timed path
produced with the reference, after the window, on a sample drawn from the
seed; every compared number is printed beside its limit on standard error
and, under ``checks``, last in the result line. A run in which JAX or the
JAX package was loaded (``harness/guard.py``) exits with 3 and prints no
result.

``--control tf32`` runs the system with TF32 products, the precision below
the float32 with TF32 off that the configurations state; its comparison must
read not correct (``benchmark/tests/test_bench_control.py``). ``--control
bf16`` runs a batch cell's AM in bfloat16 (the program's own path), the
control a CPU can run.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

from benchmark.harness import guard
from benchmark.harness.spec import Cell, load_cell, load_module

EXIT_NO_DEVICE = 2
EXIT_FORBIDDEN = 3


@dataclass
class Check:
    """One compared number: ``value`` must not exceed ``limit``."""

    name: str
    value: float
    limit: float

    def __post_init__(self):
        self.value, self.limit = float(self.value), float(self.limit)

    @property
    def ok(self) -> bool:
        return self.value <= self.limit  # NaN fails


def device_info(device) -> Dict:
    import torch

    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}


def layer_metrics(cell: Cell, record: Dict) -> Dict:
    """Each per-layer metric this cell reports, by its reader
    (``metrics/<name>.py``); a reader that finds nothing is left out."""
    out = {}
    for m in cell.per_layer():
        value = load_module(cell.bench_dir / "metrics" / f"{m['name']}.py").read(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
        control: Optional[str] = None, t_start: Optional[float] = None,
        workdir: Optional[Path] = None) -> Dict:
    """One run; returns the result line's object."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    dev = torch.device(device)
    own_dir = workdir is None
    workdir = Path(tempfile.mkdtemp(prefix="bench-")) if own_dir else Path(workdir)
    try:
        driver = cell.driver().Driver(cell, seed, seconds, dev, control, workdir)
        driver.setup()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        setup_s = time.perf_counter() - t_start
        driver.window(trace)
        end_to_end = dict(driver.end_to_end())
        end_to_end["setup_s"] = setup_s
        if trace:
            driver.trace_extras()
        info = device_info(dev)
        if trace:
            info["busy_s"] = driver.record["busy_s"]
            info["window_s"] = driver.record["window_s"]
        driver.release()
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        checks: List[Check] = driver.check()
    finally:
        if own_dir:
            shutil.rmtree(workdir, ignore_errors=True)
    if trace:
        metrics = layer_metrics(cell, driver.record)
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end()}
        metrics = {k: {"value": float(end_to_end[k]), "unit": units[k]} for k in units}
    result = {
        "correct": bool(checks) and all(c.ok for c in checks),
        "attempted": int(driver.attempted),
        "failed": int(driver.failed),
        "metrics": metrics,
        "device": info,
    }
    if trace and driver.breakdown is not None:
        result["breakdown"] = driver.breakdown
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return result


THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def host_threads(n: Optional[int]) -> None:
    """The configuration's deployment setting ``host_threads``: the
    process's host thread pools hold ``n`` threads. Set before torch is
    imported, as the pools are made then."""
    if n:
        for var in THREAD_VARS:
            os.environ[var] = str(int(n))


def main(argv: Optional[List[str]] = None, t_start: Optional[float] = None,
         out: Callable[[str], None] = print) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("tf32", "bf16"), default=None)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    host_threads(cell.config.get("host_threads"))
    import torch

    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return EXIT_NO_DEVICE
    result = run(cell, args.seed, args.seconds, bool(args.trace), "cuda", args.control, t_start)
    found = guard.forbidden_modules()
    if found:
        print(f"benchmark: forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return EXIT_FORBIDDEN
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    out(json.dumps(result))
    return 0
