"""Multi-device serving example: one batch decode sharded over a stream mesh
(the port's ``examples/serve_multichip.py``).

Builds a synthetic profile, trains a grammar graph, then decodes a batch of
utterances with ``parallel.ShardedWavTranscriber``: the single transcriber's
API, with each mesh entry decoding its block of the batch (K1, the AM, K2 on
each card; no traffic between them). The sharded transcripts must equal a
single-device transcriber's, or the run raises.

Usage::

    python -m rhasspy_speech_torch.examples.serve_multichip [num_utts] [--devices cuda:0,cuda:1] [--device cuda|cpu]

Without ``--devices`` the mesh takes every card (``make_stream_mesh()``);
``--devices cpu,cpu,cpu,cpu`` builds a mesh of CPU entries. ``--device`` is
the single-device transcriber's. ``main`` returns the transcripts, the
wall time of the warm sharded call and the mesh's size.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time
from typing import Dict, Optional, Sequence

from ..device import resolve_device
from ..parallel import ShardedWavTranscriber, make_stream_mesh
from ..pipeline import Nnet3WavTranscriber
from ..testing import build_synthetic_profile, synthesize_sentence
from ._common import device_info, parser, sync, train_sentences

LEXICON = {
    "turn": ["t", "er", "n"], "on": ["aa", "n"], "off": ["ao", "f"], "the": ["dh", "ah"],
    "light": ["l", "ay", "t"], "fan": ["f", "ae", "n"], "never": ["n", "eh", "v", "er"],
    "mind": ["m", "ay", "n", "d"],
}
SENTENCES = ["turn (on|off) [the] (light|fan)", "never mind"]
UTTS = ["turn on the light", "turn off the fan", "never mind", "turn on fan"]


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    p = parser(__doc__)
    p.add_argument("num_utts", nargs="?", type=int, default=12)
    p.add_argument("--devices", default=None,
                   help="comma-separated mesh entries (default: every card)")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    dev = resolve_device(args.device)
    mesh = make_stream_mesh(devices=args.devices.split(",") if args.devices else None)
    with tempfile.TemporaryDirectory(prefix="rss_multichip_") as root:
        profile = build_synthetic_profile(os.path.join(root, "model"), LEXICON)
        (lang,) = train_sentences(profile.model_dir, os.path.join(root, "train"), SENTENCES)
        print(f"mesh: {mesh.size} entries {[str(d) for d in mesh.devices]}")
        texts = [UTTS[i % len(UTTS)] for i in range(args.num_utts)]
        pcms = [synthesize_sentence(profile, t, seed=i) for i, t in enumerate(texts)]
        audio_s = sum(pcm.shape[0] for pcm in pcms) / 16000.0

        sharded = ShardedWavTranscriber(profile.model_dir, lang, mesh=mesh)
        sharded.transcribe_pcm_batch(pcms)  # warm: every replica at the timed shape
        for d in mesh.devices:
            sync(d)
        t0 = time.perf_counter()
        got = sharded.transcribe_pcm_batch(pcms)
        for d in mesh.devices:
            sync(d)
        wall = time.perf_counter() - t0
        single = Nnet3WavTranscriber(profile.model_dir, lang, device=dev).transcribe_pcm_batch(pcms)

    ok = sum(1 for g, t in zip(got, texts) if g == [t])
    print(f"{ok}/{args.num_utts} exact; {audio_s:.1f} s of audio in {wall:.3f} s wall "
          f"({audio_s / wall:.1f}x realtime) across {mesh.size} shards")
    if single != got:
        raise RuntimeError(f"sharded transcripts differ from the single device's: {got} vs {single}")
    print("sharded results identical to the single device's")
    return {"transcripts": got, "single": single, "texts": texts, "exact": ok,
            "mesh": [str(d) for d in mesh.devices], "wall_s": wall, "audio_s": audio_s,
            **device_info(dev)}


if __name__ == "__main__":
    main()
