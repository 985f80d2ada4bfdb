"""Cost of the windowed decode relaxation on the card: the port's counterpart
of ``examples/pallas_windowed_cost.py``.

Every arc of a decode graph bucketed into a (destination 128-block,
source 128-window) step; per frame and step, 128 candidates gathered from
the source window of alpha merge (cost, arc id)-lexicographically into the
destination block (``ops/windowed_relax_cuda.py``, kernel
``csrc/windowed_relax.cu``). The step tables are random, drawn as the
example draws them. On a GPU the per-step cost does depend on the indices:
lanes of a warp whose ``idx`` fall into one shared-memory bank serialise.
Uniformly random indices are about the worst a graph's arcs give; at this
shape they cost about 4% over conflict-free ones (``chip_smoke.py`` times
both).

Usage (on a CUDA card)::

    python -m rhasspy_speech_torch.examples.windowed_cost [NSTEP] [BT]

Shapes are the example's: B=512 streams, T=116 frames, S_pad=14,208
states, P=3,072 pdfs (the example's unread ``am`` block; no input here),
NSTEP=1,280 steps and BT=32 by default. The kernel runs one CTA per
stream and shares each read of the step tables among the C CTAs of a
thread-block cluster; ``windowed_relax`` chooses C from the batch and the
card, and the run prints it. BT does not set C: it remains the accounting
unit of the "us/step" figure, as in the example: the time of one step over
BT streams, ms / T / (B / BT) / NSTEP * 1e3. The example multiplies the
same quotient by 1e6, so the figure it prints under "us/step" is in ns.

The tables are checked and laid out as the kernel's schedule once, before
the clock starts; the CUDA events time the kernel launches alone.
"""

from __future__ import annotations

import subprocess
import sys
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..ops.windowed_relax_cuda import prepare_steps, select_cluster, windowed_relax

S_PAD = 14208
P = 3072
T = 116
B = 512
NSTEP = 1280
BT = 32
DEVICE = "cuda"
WARMUP_RUNS = 3  # the card's clocks ramp up over the first tens of ms of load
TIMED_RUNS = 5
NUM_ARCS = 37658  # the flagship graph's arc count: the arc ids' range


def make_step_tables(nstep: int, s_pad: int, seed: int = 0):
    """(dbase, sbase [NSTEP] int32, idx [NSTEP, 128] int32, w [NSTEP, 128]
    f32, arc [NSTEP, 128] int32), the example's NumPy draws in its order."""
    rng = np.random.RandomState(seed)
    dbase = (rng.randint(0, s_pad // 128, nstep) * 128).astype(np.int32)
    sbase = (rng.randint(0, s_pad // 128, nstep) * 128).astype(np.int32)
    idx = rng.randint(0, 128, (nstep, 128)).astype(np.int32)
    w = rng.rand(nstep, 128).astype(np.float32)
    arc = rng.randint(0, NUM_ARCS, (nstep, 128)).astype(np.int32)
    return dbase, sbase, idx, w, arc


def card_line() -> str:
    """``name, power limit`` of card 0 as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    """Run the relaxation once and ``WARMUP_RUNS`` times more, then time
    ``TIMED_RUNS`` runs with CUDA events; return {"alpha", "bp", "tables", "steps", "cluster", "ms", "us_per_step"}."""
    argv = sys.argv[1:] if argv is None else list(argv)
    nstep = int(argv[0]) if len(argv) > 0 else NSTEP
    bt = int(argv[1]) if len(argv) > 1 else BT
    if B % bt:
        raise ValueError(f"B={B} is not a multiple of BT={bt}")
    dev = resolve_device(DEVICE)
    tables = tuple(torch.as_tensor(x, device=dev) for x in make_step_tables(nstep, S_PAD))
    steps = prepare_steps(*tables, S_PAD)

    t0 = time.time()
    alpha, bp = windowed_relax(steps, T, B)
    torch.cuda.synchronize(dev)
    print(f"build+run {time.time() - t0:.1f}s")
    for _ in range(WARMUP_RUNS):
        windowed_relax(steps, T, B)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TIMED_RUNS):
        windowed_relax(steps, T, B)
    stop.record()
    torch.cuda.synchronize(dev)
    ms = start.elapsed_time(stop) / TIMED_RUNS
    us = ms / T / (B // bt) / nstep * 1e3
    cluster = select_cluster(steps, B)
    print(f"NSTEP={nstep} B={B} BT={bt} T={T}: {ms:.3f} ms "
          f"({us:.4f} us/step), clusters of {cluster} CTAs, on {card_line()}")
    return {"alpha": alpha, "bp": bp, "tables": tables, "steps": steps, "cluster": cluster,
            "ms": ms, "us_per_step": us}


if __name__ == "__main__":
    main()
