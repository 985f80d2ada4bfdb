"""Command-line interface: train and transcribe without writing code.

Counterpart of ``rhasspy_speech_tpu/cli.py``, with the same subcommands and
flags but ``metrics`` (the registry of a fresh process is empty; a serving
process reads its own, ``utils/metrics.py``, as
``examples/serve_streams.py`` prints it); ``transcribe`` and ``warmup``
also take ``--device`` (default
``cuda``, which raises without a card; ``--device cpu`` runs the kernels'
plain twins). ``warmup`` writes the warm-start manifest
(``utils/warmup.py``) in place of the JAX package's AOT programs.

  python -m rhasspy_speech_torch.cli train --language en \\
      --sentences sentences.yaml --model-dir model/ --train-dir train/
  python -m rhasspy_speech_torch.cli transcribe --model-dir model/ \\
      --graph-dir train/lang_grammar utterance.wav [more.wav ...]
"""

from __future__ import annotations

import argparse
import json
import sys


def _cmd_train(args) -> int:
    from .const import LangSuffix
    from .pipeline.train import train_model_sync

    suffixes = [LangSuffix(s) for s in args.lang_suffixes.split(",")]
    train_model_sync(
        args.language,
        args.sentences,
        args.train_dir,
        args.model_dir,
        lang_suffixes=suffixes,
        rescore_order=args.rescore_order,
        smoothing=args.smoothing,
    )
    print(f"trained {args.train_dir} ({args.lang_suffixes})")
    return 0


def _cmd_transcribe(args) -> int:
    from .pipeline import Nnet3WavTranscriber

    t = Nnet3WavTranscriber(
        args.model_dir,
        args.graph_dir,
        acoustic_scale=args.acoustic_scale,
        silence_weight=args.silence_weight,
        device=args.device,
    )
    results = t.transcribe_batch(
        args.wav,
        lang_dir=args.lang_dir,
        nbest=args.nbest,
        max_fuzzy_cost=args.max_fuzzy_cost,
        require_fuzzy=args.require_fuzzy,
    )
    for path, texts in zip(args.wav, results):
        row = {"wav": str(path), "text": texts[0] if texts else "",
               "nbest": texts}
        if args.confidence:
            row["confidence"] = round(t.confidence(path), 4)
        print(json.dumps(row))
    return 0


def _cmd_warmup(args) -> int:
    """Warm the serving path for a batch shape and record it in the
    warm-start manifest (utils/warmup.py): a later serving process built on
    the same files pays its kernel builds, library loads, plans and tick
    captures in its constructor, before its first answer."""
    import numpy as np

    from .pipeline import Nnet3WavTranscriber

    t = Nnet3WavTranscriber(args.model_dir, args.graph_dir, device=args.device)
    samples = int(args.seconds * 16000)
    pcm = [np.zeros(samples, dtype=np.float32) for _ in range(args.batch)]
    out = t.save_aot(pcm, nbest=args.nbest)
    print(f"warmed batch={args.batch} x {args.seconds}s -> {out}")
    if args.streams:
        from .pipeline.scheduler import StreamScheduler

        endpointing = None
        if args.endpointing:
            from .pipeline.endpoint import EndpointConfig

            endpointing = EndpointConfig()
        # the manifest keys on the whole configuration, so the warmup
        # configuration must match the serving one: expose it all here
        sched = StreamScheduler(
            args.model_dir, args.graph_dir, max_streams=args.streams,
            endpointing=endpointing,
            silence_weight=args.silence_weight,
            chunk_out_frames=args.chunk_out_frames,
            pool_capacity_samples=int(args.pool_seconds * 16000),
            compute_dtype=args.dtype or None,
            wire=args.wire,
            device=args.device,
        )
        out = sched.save_aot(seconds=args.seconds)
        print(f"warmed serving ticks for {args.streams} lanes -> {out}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="rhasspy_speech_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p_train = sub.add_parser("train", help="compile decode graphs")
    p_train.add_argument("--language", required=True)
    p_train.add_argument("--sentences", required=True,
                         help="sentences/intents YAML path")
    p_train.add_argument("--model-dir", required=True)
    p_train.add_argument("--train-dir", required=True)
    p_train.add_argument("--lang-suffixes", default="grammar,arpa")
    p_train.add_argument("--rescore-order", type=int, default=5)
    p_train.add_argument("--smoothing", default="witten_bell",
                         choices=["witten_bell", "kneser_ney", "absolute", "katz"])
    p_train.set_defaults(func=_cmd_train)

    p_tr = sub.add_parser("transcribe", help="decode WAV files")
    p_tr.add_argument("wav", nargs="+")
    p_tr.add_argument("--model-dir", required=True)
    p_tr.add_argument("--graph-dir", required=True)
    p_tr.add_argument("--lang-dir", default=None)
    p_tr.add_argument("--nbest", type=int, default=1)
    p_tr.add_argument("--max-fuzzy-cost", type=float, default=None)
    p_tr.add_argument("--require-fuzzy", action="store_true")
    p_tr.add_argument("--acoustic-scale", type=float, default=1.0)
    p_tr.add_argument("--silence-weight", type=float, default=None,
                      help="enable decoder-driven silence weighting of "
                           "i-vector stats (e.g. 0.0)")
    p_tr.add_argument("--confidence", action="store_true",
                      help="also report a decoder-native confidence score")
    p_tr.add_argument("--device", default="cuda",
                      help="cuda (the default; raises without a card) or cpu")
    p_tr.set_defaults(func=_cmd_transcribe)

    p_w = sub.add_parser(
        "warmup",
        help="warm the serving path for a batch shape and record it in the "
             "warm-start manifest (fast second-process start)",
    )
    p_w.add_argument("--model-dir", required=True)
    p_w.add_argument("--graph-dir", required=True)
    p_w.add_argument("--batch", type=int, default=8)
    p_w.add_argument("--seconds", type=float, default=3.0)
    p_w.add_argument("--nbest", type=int, default=1)
    p_w.add_argument("--streams", type=int, default=0,
                     help="also warm the StreamScheduler serving ticks for "
                          "this many lanes (the flags below must match the "
                          "serving configuration: the manifest keys on it)")
    p_w.add_argument("--endpointing", action="store_true",
                     help="warm the endpointing-enabled serving programs")
    p_w.add_argument("--silence-weight", type=float, default=None)
    p_w.add_argument("--chunk-out-frames", type=int, default=7)
    p_w.add_argument("--wire", default="i16",
                     choices=("i16", "mulaw", "adpcm"),
                     help="serving wire format: raw int16 PCM, the "
                     "8-bit G.711 mu-law wire (half the per-tick upload "
                     "bytes; lossy wire, exact pipeline — ops/mulaw.py), "
                     "or the 4-bit block-ADPCM wire (half mu-law's "
                     "bytes again — ops/adpcm.py)")
    p_w.add_argument("--pool-seconds", type=float, default=60.0)
    p_w.add_argument("--dtype", default="",
                     help="compute dtype, e.g. bfloat16")
    p_w.add_argument("--device", default="cuda",
                     help="cuda (the default; raises without a card) or cpu")
    p_w.set_defaults(func=_cmd_warmup)

    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
