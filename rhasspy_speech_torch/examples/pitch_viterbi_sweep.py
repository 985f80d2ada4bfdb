"""The pitch-lag Viterbi kernel (``csrc/pitch_viterbi.cu``) swept over its
cluster sizes on the card, at the shapes the port's paths give it.

For each shape -- the batch call's [32, 296, 417], the scheduler tick's
[32, 196, 417] and a stream push's [1, 196, 417] (Kaldi's default lags at
16 kHz) -- and each cluster size C, the kernel is held bit-equal to its
plain twin on tie-heavy costs (a grid of 40 values), then timed with CUDA
events on seeded continuous costs; its ``clocks`` buffer splits a launch
into the forward pass and rank 0's final argmin plus traceback. The C
that ``select_plan`` picks for the shape is marked. ``--variants`` adds
lane counts a strip to the sweep (``plan_pitch_viterbi(NL, C, lanes=...)``).

``--parent DIR`` also builds ``DIR``'s ``pitch_viterbi.cu`` and
``path_walk.cu`` (another checkout of this repository whose two kernels
have the C interfaces of their first versions, one CTA a stream and
global arc tables: the commit before their redesign, unpacked by ``git
archive``) and times them in turns with this checkout's kernels in the
same process: K5 at the three shapes, and K4 on a seeded ring of 32 slots
x 100 frames over 803 states (the flagship graph's size, streamed) and
over 13,789 states with 31,288 arcs (chased).

Usage (on a CUDA card)::

    python -m rhasspy_speech_torch.examples.pitch_viterbi_sweep [--parent DIR] [--variants 8,16]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import tempfile
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..ops import _build
from ..ops.path_walk_cuda import path_walk, path_walk_torch, walk_start, walk_tables
from ..ops.pitch import PitchConfig, make_lags
from ..ops.pitch_viterbi_cuda import (
    CLUSTER_SIZES,
    pitch_viterbi,
    pitch_viterbi_torch,
    plan_pitch_viterbi,
    select_plan,
    transition_costs,
)
from ..utils.timing import cuda_ms, device_ms

SHAPES = (("batch", 32, 296), ("tick", 32, 196), ("push", 1, 196))
SEED = 0
ITERS = 20


def costs(B: int, T: int, NL: int, dev: torch.device, seed: int, levels: int = 0) -> torch.Tensor:
    """Seeded [B, T, NL] local costs: continuous in [0, 2), or on a grid of
    ``levels`` values (many exact ties)."""
    rng = np.random.RandomState(seed)
    if levels:
        a = rng.randint(0, levels, size=(B, T, NL)) * 0.125
    else:
        a = rng.rand(B, T, NL) * 2.0
    return torch.as_tensor(a.astype(np.float32), device=dev)


def k5_sweep(dev: torch.device, variants: Sequence[int] = (),
             shapes=SHAPES) -> List[Dict[str, object]]:
    """One row per (shape, cluster size, layout): bit-equality with the
    twin, ms, and the split of rank 0's cycles into the min-plus pass, the
    merge, the wait for the frame's fwd and the traceback. The layouts are
    ``plan_pitch_viterbi``'s default and each lane count of ``variants``
    that fits."""
    cfg = PitchConfig()
    NL = make_lags(cfg).shape[0]
    dist = torch.as_tensor(transition_costs(NL, cfg.delta_pitch, cfg.penalty_factor), device=dev)
    rows = []
    for label, B, T in shapes:
        tied = costs(B, T, NL, dev, SEED + 1, levels=40)
        want = pitch_viterbi_torch(tied, dist)
        local = costs(B, T, NL, dev, SEED)
        chosen = select_plan(B, NL, dev)
        for C in CLUSTER_SIZES:
            plans = [plan_pitch_viterbi(NL, C)]
            for k in variants:
                try:
                    p = plan_pitch_viterbi(NL, C, lanes=k)
                except ValueError:  # more threads than a block holds
                    continue
                if p not in plans:
                    plans.append(p)
            for plan in plans:
                equal = torch.equal(pitch_viterbi(tied, dist, plan=plan), want)
                ms = cuda_ms(lambda: pitch_viterbi(local, dist, plan=plan), ITERS)
                clocks = torch.zeros((B, C, 4), dtype=torch.int64, device=dev)
                pitch_viterbi(local, dist, plan=plan, clocks=clocks)
                torch.cuda.synchronize()
                fwd, back, pas, merge = clocks[:, 0].double().mean(dim=0).tolist()
                total = fwd + back
                rows.append({
                    "shape": label, "B": B, "T": T, "NL": NL, "cluster": C,
                    "lanes": plan.lanes, "threads": plan.threads,
                    "smem_bytes": plan.smem_bytes, "chosen": plan == chosen,
                    "bit_equal": equal, "ms": ms,
                    "us_per_frame": ms * 1e3 / max(T - 1, 1),
                    "traceback_share": back / total if total else 0.0,
                    "pass_share": pas / total if total else 0.0,
                    "merge_share": merge / total if total else 0.0,
                    "wait_share": (fwd - pas - merge) / total if total else 0.0,
                })
    return rows


def k5_row_text(r: Dict[str, object]) -> str:
    return (f"K5 {r['shape']} [{r['B']}, {r['T']}, {r['NL']}] C={r['cluster']} "
            f"lanes={r['lanes']} threads={r['threads']} "
            f"smem={r['smem_bytes']}: {r['ms']:.4f} ms ({r['us_per_frame']:.3f} us a frame); "
            f"rank 0's cycles: pass {100 * r['pass_share']:.1f}%, merge "
            f"{100 * r['merge_share']:.1f}%, wait {100 * r['wait_share']:.1f}%, traceback "
            f"{100 * r['traceback_share']:.1f}%; bit-equal {r['bit_equal']}"
            f"{'  <- chosen' if r['chosen'] else ''}")


def _parent_lib(parent: Path, name: str) -> ctypes.CDLL:
    src = parent / "rhasspy_speech_torch" / "csrc" / f"{name}.cu"
    out = Path(tempfile.mkdtemp()) / f"libparent_{name}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the parent's {name}.cu:\n{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.rss_error_string.argtypes = [ctypes.c_int]
    lib.rss_error_string.restype = ctypes.c_char_p
    return lib


def parent_k5(parent: Path, dev: torch.device) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """The parent's K5 (one CTA a stream; C ABI ``local, dist, B, T, NL,
    bp, states, device, stream``)."""
    lib = _parent_lib(parent, "pitch_viterbi")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.rss_pitch_viterbi_launch.argtypes = [P, P, I, I, I, P, P, I, P]
    lib.rss_pitch_viterbi_launch.restype = I

    def run(local: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
        B, T, NL = local.shape
        states = torch.empty((B, T), dtype=torch.int32, device=dev)
        bp = torch.empty((B, max(T - 1, 1), NL), dtype=torch.int16, device=dev)
        err = lib.rss_pitch_viterbi_launch(local.data_ptr(), dist.data_ptr(), B, T, NL,
                                           bp.data_ptr(), states.data_ptr(), dev.index,
                                           torch.cuda.current_stream(dev).cuda_stream)
        _build.check(lib, err, "parent pitch Viterbi launch")
        return states

    return run


def parent_k4(parent: Path, dev: torch.device):
    """The parent's K4 (int32 arc sources and uint8 silence flags read from
    global memory; C ABI ``ring, stride, S, frames, start, costs, arc_src,
    arc_sil, N, width, stats, out, device, stream``)."""
    lib = _parent_lib(parent, "path_walk")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.rss_path_walk_launch.argtypes = [P, I, I] + [P] * 5 + [I] * 3 + [P, I, P]
    lib.rss_path_walk_launch.restype = I

    def run(ring, frames, start, cost, tables, width, stats):
        N, F_ring, S = ring.shape
        out = torch.empty((N, width + 8), dtype=torch.int16, device=dev)
        err = lib.rss_path_walk_launch(ring.data_ptr(), F_ring, S, frames.data_ptr(),
                                       start.data_ptr(), cost.data_ptr(),
                                       tables.arc_src.data_ptr(), tables.arc_sil.data_ptr(), N,
                                       width, int(stats), out.data_ptr(), dev.index,
                                       torch.cuda.current_stream(dev).cuda_stream)
        _build.check(lib, err, "parent path walk launch")
        return out

    return run


def seeded_ring(dev: torch.device, S: int, A: int, N: int = 32, frames: int = 100,
                F_ring: int = 400, seed: int = SEED):
    """A scheduler-like ring: N slots of ``frames`` decoded frames of
    seeded arcs (bp + 3) over S states, its walk starts and the tables."""
    rng = np.random.RandomState(seed)
    arc_src = torch.as_tensor(rng.randint(0, S, size=A).astype(np.int32), device=dev)
    arc_sil = torch.as_tensor((rng.rand(A) < 0.3).astype(np.uint8), device=dev)
    ring = torch.as_tensor(rng.randint(3, 3 + A, size=(N, F_ring, S)).astype(np.int16), device=dev)
    fr = torch.full((N,), frames, dtype=torch.int32, device=dev)
    alpha = torch.as_tensor(rng.rand(N, S).astype(np.float32), device=dev)
    start, cost = walk_start(alpha, torch.zeros(S, device=dev))
    return ring, fr, start, cost, walk_tables(arc_src, arc_sil, S)


def ab(name: str, new: Callable[[], torch.Tensor], old: Callable[[], torch.Tensor],
       check: Callable[[torch.Tensor], bool]) -> Dict[str, object]:
    """Both versions held to the check, then timed in turns: old, new, new,
    old."""
    ok_new, ok_old = check(new()), check(old())
    t = [device_ms(old), device_ms(new), device_ms(new), device_ms(old)]
    row = {"name": name, "bit_equal_new": ok_new, "bit_equal_parent": ok_old,
           "parent_ms": (t[0] + t[3]) / 2, "ms": (t[1] + t[2]) / 2, "turns_ms": t}
    print(f"A/B {name}: parent {t[0]:.4f} / {t[3]:.4f} ms, this checkout {t[1]:.4f} / "
          f"{t[2]:.4f} ms (bit-equal to the twin: {ok_new}, parent {ok_old})")
    return row


def parent_compare(parent: Path, dev: torch.device):
    """K5 at the three shapes and K4 on two seeded rings, parent against
    this checkout."""
    cfg = PitchConfig()
    NL = make_lags(cfg).shape[0]
    dist = torch.as_tensor(transition_costs(NL, cfg.delta_pitch, cfg.penalty_factor), device=dev)
    k5_old = parent_k5(parent, dev)
    rows = []
    for label, B, T in SHAPES:
        local = costs(B, T, NL, dev, SEED)
        want = pitch_viterbi_torch(local, dist)
        rows.append(ab(f"K5 {label} [{B}, {T}, {NL}]", lambda: pitch_viterbi(local, dist),
                       lambda: k5_old(local, dist), lambda s: torch.equal(s, want)))
    k4_old = parent_k4(parent, dev)
    for S, A in ((803, 1964), (13789, 31288)):
        args = seeded_ring(dev, S, A)
        want = path_walk_torch(*args, 400, True)
        rows.append(ab(f"K4 seeded ring [32, 400, {S}], {A} arcs, 100 frames a slot",
                       lambda: path_walk(*args, 400, True), lambda: k4_old(*args, 400, True),
                       lambda o: torch.equal(o, want)))
    return rows


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--variants", default="",
                    help="lanes a strip to add, of 8,16,32 (e.g. 8,16)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("pitch_viterbi_sweep: needs a CUDA device")
    dev = torch.device("cuda", 0)
    variants = [int(x) for x in args.variants.split(",") if x]
    rows = k5_sweep(dev, variants)
    for r in rows:
        print(k5_row_text(r))
    out = {"k5_sweep": rows, "device": torch.cuda.get_device_name(0)}
    if args.parent is not None:
        out["parent"] = parent_compare(args.parent, dev)
    print(json.dumps(out))
    if not all(r["bit_equal"] for r in rows) or not all(
            r["bit_equal_new"] and r["bit_equal_parent"] for r in out.get("parent", [])):
        raise SystemExit("pitch_viterbi_sweep: a kernel differs from its twin")
    return out


if __name__ == "__main__":
    main()
