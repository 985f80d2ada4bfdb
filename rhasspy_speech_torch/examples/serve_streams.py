"""Serving example: many concurrent PCM streams through the batched
scheduler with endpointing (the port's ``examples/serve_streams.py``).

Builds a synthetic voice-assistant profile, trains its grammar graph, then
simulates N concurrent realtime microphones feeding 64 ms chunks. One
``StreamScheduler.step()`` a tick drives every stream; endpointing
(``EndpointConfig()``) closes utterances. On a card the profile takes the
scheduler's device route: each tick is one captured body (K1 into the
feature rings, the AM, K2 with the carried alpha, K4's path walk; on
``--wire adpcm`` K6 decodes the upload first).

Usage::

    python -m rhasspy_speech_torch.examples.serve_streams [N] [--wire i16|mulaw|adpcm] [--device cuda|cpu]

``--wire mulaw`` serves over the 8-bit G.711 wire and ``--wire adpcm`` over
4-bit IMA ADPCM (both lossy; see ``ops/mulaw.py``, ``ops/adpcm.py``). Prints
each stream's transcript, the tick p50 / p90 (host clock over ticks that
decoded a chunk, each ``step()`` ended by a synchronize on a card; the
server starts cold, so the first tick of each PCM width captures its
graph), the fleet's real-time factor and ``utils/metrics.py``'s counters;
``main`` returns them with the scheduler's own count of kernel launches.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time
from typing import Dict, Optional, Sequence

from ..device import resolve_device
from ..pipeline.device_tick import WIRES
from ..pipeline.endpoint import EndpointConfig
from ..pipeline.scheduler import StreamScheduler
from ..testing import build_synthetic_profile, synthesize_sentence
from ..utils.metrics import get_metrics, reset_metrics
from ..utils.timing import p50_p90
from ._common import device_info, parser, sync, train_sentences

LEXICON = {
    "turn": ["t", "er", "n"], "on": ["aa", "n"], "off": ["ao", "f"],
    "the": ["dh", "ah"], "light": ["l", "ay", "t"], "fan": ["f", "ae", "n"],
    "never": ["n", "eh", "v", "er"], "mind": ["m", "ay", "n", "d"],
}
SENTENCES = ["turn (on|off) [the] (light|fan)", "never mind"]
UTTERANCES = [
    "turn on the light", "turn off the fan", "never mind",
    "turn on fan", "turn off light",
]
CHUNK = 1024  # 64 ms a feed


def utterances(profile, num_streams: int):
    """(texts, PCM) of the example's streams: stream i says UTTERANCES[i % 5]."""
    texts = [UTTERANCES[i % len(UTTERANCES)] for i in range(num_streams)]
    return texts, [synthesize_sentence(profile, t, seed=i) for i, t in enumerate(texts)]


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    p = parser(__doc__)
    p.add_argument("num_streams", nargs="?", type=int, default=16)
    p.add_argument("--wire", choices=WIRES, default="i16")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    dev = resolve_device(args.device)
    n = args.num_streams
    with tempfile.TemporaryDirectory(prefix="rss_serve_") as root:
        profile = build_synthetic_profile(os.path.join(root, "model"), LEXICON)
        (lang,) = train_sentences(profile.model_dir, os.path.join(root, "train"), SENTENCES)
        sched = StreamScheduler(profile.model_dir, lang, max_streams=n,
                                endpointing=EndpointConfig(), wire=args.wire, device=dev)
        texts, pcms = utterances(profile, n)
        reset_metrics()
        sids = [sched.open_stream() for _ in range(n)]
        offsets = [0] * n
        finished = [False] * n
        tick_ms = []
        t0 = time.perf_counter()
        while any(sched.poll(s) is None for s in sids):
            for i, sid in enumerate(sids):
                if offsets[i] < pcms[i].shape[0]:
                    sched.feed(sid, pcms[i][offsets[i] : offsets[i] + CHUNK])
                    offsets[i] += CHUNK
                elif not finished[i]:
                    sched.finish(sid)
                    finished[i] = True
            t_tick = time.perf_counter()
            lanes = sched.step()
            sync(dev)
            if lanes:
                tick_ms.append((time.perf_counter() - t_tick) * 1000.0)
        wall = time.perf_counter() - t0
        results = [sched.poll(sid) for sid in sids]
        launches = sched.kernel_launches

    correct = 0
    for i, (sid, result) in enumerate(zip(sids, results)):
        ok = result == [texts[i]]
        correct += ok
        print(f"stream {sid:3d}: {'OK ' if ok else 'ERR'} {result}")
    audio_s = sum(pcm.shape[0] for pcm in pcms) / 16000.0
    p50, p90 = p50_p90(tick_ms)
    out = {
        "transcripts": results, "texts": texts, "exact": correct, "wire": args.wire,
        "device_route": bool(sched._device_bp), "ticks": len(tick_ms),
        "tick_p50_ms": p50, "tick_p90_ms": p90, "wall_s": wall, "audio_s": audio_s,
        "fleet_rtf": wall / audio_s, "kernel_launches": launches,
        "metrics": get_metrics().summary(), **device_info(dev),
    }
    print(f"\n{correct}/{n} exact on the {args.wire} wire; {audio_s:.1f} s of audio in "
          f"{wall:.2f} s wall (fleet RTF {out['fleet_rtf']:.5f}); tick p50 / p90 {p50:.3f} / "
          f"{p90:.3f} ms over {len(tick_ms)} ticks; launches {launches}; on {out['card']}")
    print("metrics:", out["metrics"])
    return out


if __name__ == "__main__":
    main()
