"""Roofline accounting of the flagship batch step on the card (the port's
``examples/decode_roofline.py``).

For B streams of ``seconds`` of audio at the flagship's widths it reports,
a stage: its device time (``ms``, ``utils/timing.py:device_ms``: the calls
queued behind long matrix products, so the card runs them back to back and
the events around them time the card alone, for every stage alike), the
span of the same calls issued back to back by the host (``span_ms``, CUDA
events; ``idle_share`` = 1 - ``ms`` / ``span_ms`` is the card idle while the
host issues the stage's operations), the bytes and operations the stage's
function needs (``utils/roofline.py``, the method of ``chip_smoke.py``'s
kernel table: each input read once, each output written once), the rates
they imply over ``ms`` and the share of the card's roofline (bound /
``ms``). Stages:

- ``mfcc``: K1 (``ops/mfcc_cuda.py``), [B, samples] PCM -> 40 cepstra;
- ``am_forward``: the TDNN-F forward (768 x 9, 100-dim i-vector, 3,072
  pdfs; cuBLAS f32, TF32 off), counted as 2 x the multiply-adds of the
  compiled plan's matrix-product components plus its weights, features,
  i-vectors and log-probs moved once; ``am_forward_bf16`` beside it with
  ``--bf16`` (bf16 products accumulated in f32; its operations against the
  bf16 peak);
- ``decode``: K2 (``ops/viterbi_cuda.py``) on the AM's log-probs over
  ``testing/big_grammar.py``'s 13,789-state graph, in whichever body
  ``select_plan`` picks.

The JAX script's ``decode_fwd`` stage (an alpha-only scan) has no
counterpart: K2 always writes its backpointers, and the port adds no mode
without them. In its place the ``decode`` stage reports the backpointers'
share of K2's counted bytes.

Peaks are an H100 SXM's at 700 W (3.35 TB/s HBM, 67 TFLOP/s f32, 989
TFLOP/s dense bf16), each overridable by a flag. On the CPU every stage
runs once and nothing is timed (ms and shares null).

Usage::

    python -m rhasspy_speech_torch.examples.decode_roofline [B] [seconds] [--bf16] [--iters 5]
        [--peak-gbs 3350] [--peak-tflops 67] [--peak-bf16-tflops 989] [--device cuda|cpu]

``--graph-dir`` reuses a trained big-grammar graph directory; ``--hidden``,
``--layers``, ``--ivector-dim`` narrow the AM, which always emits the
flagship's 3,072 pdfs (the graph reads the first of them). The last line of the output
is one JSON object, which ``main`` returns.
"""

from __future__ import annotations

import json
import sys
import tempfile
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..models.nnet3 import compile_nnet3
from ..ops.decoder import DecodeGraph
from ..ops.frontend import FrontendConfig, make_frontend_params, num_frames
from ..ops.mfcc_cuda import mfcc_batch
from ..ops.viterbi_cuda import select_plan, viterbi_decode
from ..pipeline.artifacts import LangArtifacts
from ..testing.big_grammar import train_big_grammar, write_big_grammar_model_dir
from ..testing.tdnnf import build_tdnnf_spec
from ..utils.roofline import (
    BF16_OPS_PER_S,
    F32_OPS_PER_S,
    HBM_BYTES_PER_S,
    am_work,
    bound,
    mfcc_work,
    viterbi_bytes,
    viterbi_work,
)
from ..utils.timing import cuda_ms, device_ms
from ._common import device_info, parser

PDFS = 3072  # the flagship's
SEED = 0


def big_graph(root: Path):
    """The generated grammar's decode graph, trained against a narrow
    flagship-format model dir: the graph depends on its phones, tree and
    transition model, not on the net's widths."""
    model_dir = write_big_grammar_model_dir(root / "model", num_pdfs=PDFS, hidden_dim=8,
                                            num_tdnnf_layers=1, ivector_dim=4, ubm_gauss=2)
    return LangArtifacts.load(train_big_grammar(root / "train", model_dir, seed=SEED)).graph


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    p = parser(__doc__)
    p.add_argument("B", nargs="?", type=int, default=32)
    p.add_argument("seconds", nargs="?", type=float, default=3.0)
    p.add_argument("--bf16", action="store_true", help="also the AM forward in bf16")
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--peak-gbs", type=float, default=HBM_BYTES_PER_S / 1e9)
    p.add_argument("--peak-tflops", type=float, default=F32_OPS_PER_S / 1e12)
    p.add_argument("--peak-bf16-tflops", type=float, default=BF16_OPS_PER_S / 1e12)
    p.add_argument("--graph-dir", type=Path, default=None)
    p.add_argument("--hidden", type=int, default=768)
    p.add_argument("--layers", type=int, default=9)
    p.add_argument("--ivector-dim", type=int, default=100)
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    dev = resolve_device(args.device)
    B = args.B
    peak_bytes = args.peak_gbs * 1e9

    if args.graph_dir is None:
        with tempfile.TemporaryDirectory(prefix="rss_roofline_") as tmp:
            graph = big_graph(Path(tmp))
    else:
        graph = LangArtifacts.load(args.graph_dir).graph
    dg = DecodeGraph.from_dense(graph, dev)

    cfg = FrontendConfig(num_mel_bins=40, num_ceps=40)
    params = make_frontend_params(cfg, dev)
    n_samples = int(16000 * args.seconds)
    T = num_frames(cfg, n_samples)
    n_out = -(-T // 3)
    spec = build_tdnnf_spec(num_pdfs=PDFS, input_dim=cfg.num_ceps,
                            ivector_dim=args.ivector_dim, hidden_dim=args.hidden,
                            num_tdnnf_layers=args.layers)
    model = compile_nnet3(spec, num_out_frames=n_out, subsampling=3, device=dev)
    lo, hi = model.ranges["input"]
    idx = torch.as_tensor(np.clip(np.arange(lo, hi), 0, T - 1), device=dev)

    rng = np.random.RandomState(SEED)
    pcm = torch.as_tensor((1000.0 * rng.randn(B, n_samples)).astype(np.float32), device=dev)
    ivec = torch.as_tensor(rng.randn(B, args.ivector_dim).astype(np.float32), device=dev)
    with torch.no_grad():
        feats = mfcc_batch(params, pcm)
        am_in = feats[:, idx].contiguous()
        lp = model(am_in, ivec)
    lengths = torch.full((B,), n_out, dtype=torch.int32, device=dev)

    f32_ops = args.peak_tflops * 1e12
    stages = {
        "mfcc": (lambda: mfcc_batch(params, pcm), mfcc_work(params, B, n_samples, T), f32_ops),
        "am_forward": (lambda: model(am_in, ivec),
                       am_work(model, B, tuple(am_in.shape[1:]), args.ivector_dim), f32_ops),
    }
    if args.bf16:
        model16 = model.cast(torch.bfloat16)
        stages["am_forward_bf16"] = (
            lambda: model16(am_in, ivec),
            am_work(model16, B, tuple(am_in.shape[1:]), args.ivector_dim),
            args.peak_bf16_tflops * 1e12)
    stages["decode"] = (lambda: viterbi_decode(dg, lp, 1.0, lengths),
                        viterbi_work(dg, B, n_out, lp.shape[2], lengths), f32_ops)
    parts = viterbi_bytes(dg, B, n_out, lp.shape[2], lengths)
    body = select_plan(dg, B)[0].body if dev.type == "cuda" else "twin"

    print(f"B={B} T={T} n_out={n_out} graph S={graph.num_states} A={graph.num_arcs} "
          f"P={lp.shape[2]} K2 body {body}; peaks {args.peak_gbs:.0f} GB/s, "
          f"{args.peak_tflops:.0f} TFLOP/s f32, {args.peak_bf16_tflops:.0f} bf16; on "
          f"{device_info(dev)['card']}")
    results = {}
    with torch.no_grad():
        for name, (fn, (nbytes, nops), ops_per_s) in stages.items():
            bound_ms, bound_by = bound(nbytes, nops, peak_bytes, ops_per_s)
            r = {"bytes": nbytes, "ops": nops, "bound_ms": bound_ms, "bound_by": bound_by,
                 "ms": None, "span_ms": None, "idle_share": None, "gbs": None,
                 "hbm_frac": None, "tflops": None, "ops_frac": None, "share": None}
            if dev.type == "cuda":
                ms, span = device_ms(fn, args.iters), cuda_ms(fn, args.iters)
                r.update(ms=ms, span_ms=span, idle_share=max(0.0, 1 - ms / span),
                         gbs=nbytes / ms / 1e6, tflops=nops / ms / 1e9, share=bound_ms / ms)
                r["hbm_frac"] = r["gbs"] * 1e9 / peak_bytes
                r["ops_frac"] = r["tflops"] * 1e12 / ops_per_s
                print(f"{name:16s} {ms:9.4f} ms on the card, span {span:9.4f} ms | "
                      f"{nbytes / 1e6:9.2f} MB -> {r['gbs']:7.1f} GB/s ({100 * r['hbm_frac']:5.2f}% "
                      f"of HBM) | {nops / 1e9:9.3f} GOP -> {r['tflops']:7.3f} TOP/s "
                      f"({100 * r['ops_frac']:5.2f}% of peak) | bound {bound_ms:.4f} ms "
                      f"({bound_by}), share {100 * r['share']:.2f}%")
            else:
                fn()
                print(f"{name:16s} not timed (no card) | {nbytes / 1e6:9.2f} MB | "
                      f"{nops / 1e9:9.3f} GOP | bound {bound_ms:.4f} ms ({bound_by})")
            results[name] = r
    bp_share = parts["backpointers"] / sum(parts.values())
    results["decode"]["backpointer_share"] = bp_share
    print(f"decode: backpointers are {100 * bp_share:.1f}% of K2's counted bytes "
          f"({parts['backpointers'] / 1e6:.2f} of {sum(parts.values()) / 1e6:.2f} MB)")
    out = {"B": B, "T": T, "n_out": n_out, "states": graph.num_states, "arcs": graph.num_arcs,
           "pdfs": lp.shape[2], "k2_body": body, "stages": results, **device_info(dev)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
