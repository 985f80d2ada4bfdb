"""Split the stream scheduler's serving tick into its device execute, its
upload and its host side, at the flagship's width (the port's
``examples/tick_device_profile.py``).

A tick's host-clock time folds together the host's bookkeeping, the upload,
the device body and the harvest. This probe separates them on the
scheduler's device route (``pipeline/scheduler.py``, the tick captured as a
CUDA graph by ``pipeline/device_tick.py:TickRunner``):

- **A. Device time a captured tick.** CUDA events around ``M`` back-to-back
  replays of the steady-state fused tick's graph (every lane decoding a
  full chunk), the state carried from replay to replay; and around ``M``
  ``TickRunner.run`` calls of the same tick (the pinned upload's copy plus
  the replay), whose launches by ``TickRunner``'s own count give each
  replay's kernel launches.
- **B. The upload.** CUDA events around ``M`` copies of the tick's pinned
  upload (``_prep_features_device``'s PCM and meta batch) into the graph's
  static input, on their own.
- **C. The host side of ``step()``**, on the host clock, from the
  scheduler's own stage timers (``utils/metrics.py``) over a serving run:
  ``prep`` (the drain into the upload batch, the ready loop, the endpoint
  rules, with any wait for their row), ``launch`` (the run call: upload
  copy and replay enqueued, the packed download enqueued, the slot
  bookkeeping), ``pace`` (waiting on the tick in flight) and ``harvest``
  (finalized streams' words, with any wait for their rows, and the
  finalize), each tick's p50; and the wait for the card after ``step()``
  returns. Beside it, the scheduler's tick records
  (``utils/metrics.py:tick_means``): the fused tick's device stages between
  its stamps (feed, i-vector, AM, K2, walk), their mean ms over the run.

It also prints the captured tick's p50 / p90 (host clock, each ``step()``
ended by a synchronize, over ticks that decoded a chunk) beside the eager
body's (``TickRunner.capture = False``) over the same traffic: ``lanes``
streams of seeded noise fed in 1,024-sample pushes, stream i from round
i % 4.

Usage::

    python -m rhasspy_speech_torch.examples.tick_device_profile [--lanes 32] [--M 30]
        [--wire i16|mulaw|adpcm] [--no-endpoint] [--graph flagship|big|seeded30000]
        [--device cuda|cpu]

Graphs: ``flagship`` (``testing/flagship.py:build_flagship_graph``, 803
states), ``big`` (``testing/big_grammar.py``'s 13,789 states), and
``seeded30000`` (``testing/decode_graphs.py:device_route_graph``: 30,000
states, every one final, K2's halo body), each under a flagship-width
model (TDNN-F 768 x 9, 40-dim MFCC, 100-dim i-vector, 512-Gaussian UBM,
3,072 pdfs; ``--hidden`` etc. narrow it, the pdfs stay). ``--model-dir``
reuses a flagship-format model directory of 3,072 pdfs (``big`` and
``seeded30000`` read its ``model/phones.txt`` as
``write_big_grammar_model_dir`` writes it) and ``--graph-dir`` a graph
directory in place of building ``--graph``.
On the CPU the bodies run eagerly: A and B are not measured (null).
The last line of the output is one JSON object, which ``main`` returns.
"""

from __future__ import annotations

import json
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..fst.core import SymbolTable
from ..ops.viterbi_cuda import select_plan
from ..pipeline.artifacts import LangArtifacts
from ..pipeline.device_tick import WIRES
from ..pipeline.endpoint import EndpointConfig
from ..pipeline.scheduler import StreamScheduler
from ..testing.big_grammar import train_big_grammar, write_big_grammar_model_dir
from ..testing.decode_graphs import device_route_graph
from ..testing.flagship import build_flagship_graph, write_flagship_model_dir
from ..utils.metrics import get_metrics, reset_metrics, tick_means
from ..utils.timing import cuda_ms, p50_p90
from ._common import device_info, parser, sync

GRAPHS = ("flagship", "big", "seeded30000")
PDFS = 3072  # the flagship's
SEED = 0
PUSH = 1024  # samples a feed
STAGGER = 4  # stream i starts feeding at round i % 4
WARM_TICKS = 4
# the host side of step() by the scheduler's stage timers
HOST_STAGES = {
    "prep": ("stream_features", "stream_ready", "stream_ep_apply", "stream_wait_ep"),
    "launch": ("stream_issue_fused", "stream_issue_feed", "stream_download", "stream_book"),
    "pace": ("stream_wait_pace",),
    "harvest": ("stream_harvest", "stream_wait_fin", "stream_finalize"),
}


def build_dirs(root: Path, args) -> tuple:
    """(model dir, graph dir) of the flags."""
    widths = dict(hidden_dim=args.hidden, num_tdnnf_layers=args.layers,
                  ivector_dim=args.ivector_dim, ubm_gauss=args.ubm_gauss, seed=SEED + 7)
    if args.graph == "flagship":
        graph, g_fuzzy, lang = build_flagship_graph(order=3, with_fuzzy=True, num_pdfs=PDFS)
        max_phone = max(pid for (p, pid) in lang.phones if pid != 0 and not p.startswith("#"))
        model_dir = args.model_dir
        if model_dir is None:
            model_dir = write_flagship_model_dir(root / "model", num_pdfs=graph.num_pdfs,
                                                 max_phone=max_phone, **widths)
            # the phone table a trained model dir carries (endpointing's silence pdfs)
            with open(model_dir / "model" / "phones.txt", "w", encoding="utf-8") as f:
                lang.phones.write_text(f)
        graph_dir = args.graph_dir or root / "graph"
        if not args.graph_dir:
            LangArtifacts(words=lang.words, g_fuzzy=g_fuzzy, graph=graph,
                          phones=lang.phones).save(graph_dir)
        return model_dir, graph_dir
    model_dir = args.model_dir or write_big_grammar_model_dir(root / "model", num_pdfs=PDFS,
                                                             **widths)
    if args.graph_dir:
        return model_dir, args.graph_dir
    if args.graph == "big":
        return model_dir, train_big_grammar(root / "train", model_dir, seed=SEED)
    graph_dir = root / "graph_seeded30000"
    LangArtifacts(words=SymbolTable(), graph=device_route_graph(SEED + 7, num_pdfs=PDFS)).save(
        graph_dir)
    return model_dir, graph_dir


def stage_seconds() -> Dict[str, float]:
    return {k: s.seconds for k, s in get_metrics().stages.items()}


def serve(sched, pcms: List[np.ndarray], dev: torch.device) -> List[dict]:
    """The traffic through ``sched``; per tick: host ms of ``step()``, ms
    waiting for the card after it, slots decoded, and each host stage's ms."""
    sids = [sched.open_stream() for _ in pcms]
    if min(sids) < 0:
        raise RuntimeError("the scheduler refused a stream")
    ticks = []

    def tick():
        before = stage_seconds()
        t0 = time.perf_counter()
        lanes = sched.step()
        t1 = time.perf_counter()
        sync(dev)
        t2 = time.perf_counter()
        after = stage_seconds()
        stages = {g: 1000.0 * sum(after.get(n, 0.0) - before.get(n, 0.0) for n in names)
                  for g, names in HOST_STAGES.items()}
        ticks.append({"step_ms": (t1 - t0) * 1000.0, "wait_ms": (t2 - t1) * 1000.0,
                      "lanes": lanes, **stages})

    pushes = [-(-p.shape[0] // PUSH) for p in pcms]
    for r in range(max(n + i % STAGGER for i, n in enumerate(pushes))):
        for i, (sid, pcm) in enumerate(zip(sids, pcms)):
            k = r - i % STAGGER
            if 0 <= k < pushes[i]:
                sched.feed(sid, pcm[k * PUSH : (k + 1) * PUSH])
                if k == pushes[i] - 1:
                    sched.finish(sid)
        tick()
    for _ in range(200):
        if all(sched.poll(sid) is not None for sid in sids):
            break
        tick()
    if any(sched.poll(sid) is None for sid in sids):
        raise RuntimeError("a served stream never finished")
    for sid in sids:
        sched.close(sid)
    return ticks


def tick_percentiles(ticks: List[dict]) -> tuple:
    return p50_p90([t["step_ms"] + t["wait_ms"] for t in ticks if t["lanes"] > 0])


def device_split(sched, M: int, dev: torch.device) -> dict:
    """Probes A and B on the steady-state fused tick; each replay's
    launches by TickRunner's own count."""
    runner = sched._runner
    recorded = {}
    original = runner.run

    def recording(key, body, st, inputs):
        recorded.update(key=key, body=body, inputs=list(inputs))
        return original(key, body, st, inputs)

    runner.run = recording
    try:
        lanes = steady_tick_lanes(sched)
    finally:
        runner.run = original
    if lanes != sched.max_streams or recorded.get("key", ("",))[0] != "fused":
        raise RuntimeError(f"the steady tick decoded {lanes} of {sched.max_streams} lanes "
                           f"in body {recorded.get('key')}")
    key, body, inputs = recorded["key"], recorded["body"], recorded["inputs"]
    st = sched._st
    headroom = sched._ring_frames - int(st.offs.max()) - (2 * M + 2) * sched._chunk_out
    if headroom < 0:
        raise RuntimeError(f"{M} replays would write past the {sched._ring_frames}-frame ring")
    before = dict(runner.launches)
    out = {"key": list(key), "upload_bytes": sum(x.numel() * x.element_size() for x in inputs),
           "exec_ms": None, "run_ms": None, "h2d_ms": None}
    if dev.type == "cuda":
        graph, static, _ = runner.graphs[key]
        out["exec_ms"] = cuda_ms(graph.replay, M)
        out["h2d_ms"] = cuda_ms(
            lambda: [s.copy_(x, non_blocking=True) for s, x in zip(static, inputs)], M)
        before = dict(runner.launches)
        out["run_ms"] = cuda_ms(lambda: runner.run(key, body, st, inputs), M)
        runs = M + 1
    else:
        for _ in range(M):
            runner.run(key, body, st, inputs)
        runs = M
    out["launches_per_replay"] = {k: (runner.launches[k] - before[k]) / runs
                                  for k in sched.kernel_launches}
    return out


def steady_tick_lanes(sched) -> int:
    """Every lane mid-utterance and decoding a full chunk: ``WARM_TICKS``
    ticks, each lane fed a chunk's samples before each. Returns the slots
    the last tick decoded."""
    chunk = sched._chunk_in * sched._frame_shift
    rng = np.random.RandomState(1)
    sids = [sched.open_stream() for _ in range(sched.max_streams)]
    if min(sids) < 0:
        raise RuntimeError("the scheduler refused a stream")
    pcm = np.round(1000.0 * rng.randn(chunk)).astype(np.float32)
    for sid in sids:
        sched.feed(sid, pcm)
        sched.feed(sid, pcm)
    lanes = 0
    for _ in range(WARM_TICKS):
        for sid in sids:
            sched.feed(sid, pcm)
        lanes = sched.step()
    sync(sched.device)
    return lanes


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    p = parser(__doc__)
    p.add_argument("--lanes", type=int, default=32)
    p.add_argument("--M", type=int, default=30, help="replays a timed probe")
    p.add_argument("--wire", choices=WIRES, default="i16")
    p.add_argument("--no-endpoint", action="store_true",
                   help="no endpointing: the tick walks no trailing silence")
    p.add_argument("--graph", choices=GRAPHS, default="big")
    p.add_argument("--model-dir", type=Path, default=None)
    p.add_argument("--graph-dir", type=Path, default=None)
    p.add_argument("--seconds", type=float, default=3.0, help="audio a served stream")
    p.add_argument("--hidden", type=int, default=768)
    p.add_argument("--layers", type=int, default=9)
    p.add_argument("--ivector-dim", type=int, default=100)
    p.add_argument("--ubm-gauss", type=int, default=512)
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    dev = resolve_device(args.device)
    with tempfile.TemporaryDirectory(prefix="rss_tick_profile_") as tmp:
        t0 = time.time()
        model_dir, graph_dir = build_dirs(Path(tmp), args)
        sched = StreamScheduler(
            model_dir, graph_dir, max_streams=args.lanes, max_fuzzy_cost=1.0,
            endpointing=None if args.no_endpoint else EndpointConfig(), wire=args.wire,
            device=dev)
        if not (sched._device_bp and sched._device_feats):
            raise RuntimeError("the profile needs the scheduler's fused device route")
        g = sched.device_graph
        build_s = time.time() - t0
        rng = np.random.RandomState(SEED)
        n = int(16000 * args.seconds)
        pcms = [(1000.0 * rng.randn(n)).astype(np.float32) for _ in range(args.lanes)]

        serve(sched, pcms, dev)  # warm-up: each body's first call and capture
        reset_metrics()
        ticks = serve(sched, pcms, dev)
        stages = tick_means(get_metrics().ticks)
        captured = tick_percentiles(ticks)
        sched._runner.capture = False
        eager = tick_percentiles(serve(sched, pcms, dev))
        sched._runner.capture = True
        split = device_split(sched, args.M, dev)

    chunk_ticks = [t for t in ticks if t["lanes"] > 0]
    host = {k: p50_p90([t[k] for t in chunk_ticks])[0]
            for k in ("step_ms", "wait_ms", *HOST_STAGES)}
    out = {
        "graph": args.graph, "states": g.num_states, "arcs": g.num_arcs, "lanes": args.lanes,
        "M": args.M, "wire": args.wire, "endpoint": not args.no_endpoint,
        "k2_body": _k2_body(sched), "build_s": build_s,
        "device_exec_ms": split["exec_ms"], "run_ms": split["run_ms"], "h2d_ms": split["h2d_ms"],
        "upload_bytes": split["upload_bytes"], "launches_per_replay": split["launches_per_replay"],
        "captured_p50_ms": captured[0], "captured_p90_ms": captured[1],
        "eager_p50_ms": eager[0], "eager_p90_ms": eager[1],
        "host_p50_ms": host, "tick_stages_ms": stages, "ticks": len(chunk_ticks),
        **device_info(dev),
    }
    print(f"{args.graph}: {g.num_states} states, {g.num_arcs} arcs, K2 body {out['k2_body']}; "
          f"{args.lanes} lanes, wire {args.wire}, endpointing {out['endpoint']}; on {out['card']}")
    print(f"A. device time a captured tick: {_ms(split['exec_ms'])} ms (replays); with its upload "
          f"(TickRunner.run) {_ms(split['run_ms'])} ms; launches a replay "
          f"{split['launches_per_replay']}")
    print(f"B. upload ({split['upload_bytes']} B pinned, H2D): {_ms(split['h2d_ms'])} ms")
    print(f"C. host side of step(), p50 a tick with a chunk (ms): {host}; the tick's stages "
          f"by its stamps, mean ms: {stages}")
    print(f"tick p50 / p90: captured {captured[0]:.3f} / {captured[1]:.3f} ms, eager "
          f"{eager[0]:.3f} / {eager[1]:.3f} ms over {len(chunk_ticks)} ticks")
    print(json.dumps(out))
    return out


def _k2_body(sched) -> str:
    if sched.device.type != "cuda":
        return "twin"
    return select_plan(sched.device_graph, sched.max_streams)[0].body


def _ms(x: Optional[float]) -> str:
    return "not measured (no card)" if x is None else f"{x:.4f}"


if __name__ == "__main__":
    main()
