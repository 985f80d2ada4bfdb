#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

Drives batch WAV transcription (``Nnet3WavTranscriber.transcribe_pcm_batch``)
at the full width of the benchmarked model -- TDNN-F 768 x 9, 40-dim MFCC,
100-dim i-vector from a 512-Gaussian UBM, 3,072 pdfs, random weights from a
seed -- over the flagship decode graph, and checks both hand-written
kernels against their plain PyTorch twins:

1. builds ``csrc/mfcc.cu`` and ``csrc/viterbi.cu`` with nvcc for sm_90a;
2. transcribes 32 seeded 3 s utterances with the launch counters zeroed
   just before and read just after, and requires both kernels to have run;
3. recomputes the same batch through the plain twins on the card and
   requires equal transcripts;
4. compares the MFCC kernel with its twin (rtol 2e-3 / atol 3e-2, the JAX
   package's tolerance for its own DFT-as-matmul kernel against rfft) and
   the Viterbi kernel with its twin bit for bit, on the main path's shapes
   and on a seeded folded graph of ~14,200 states / 38,000 arcs / 3,072
   pdfs (alpha beyond 48 KB of shared memory);
5. checks the card's log-probs against the CPU twins on 2 utterances
   (rtol 1e-3 / atol 1e-2: f32 sums ordered differently through eleven
   768-wide layers), times each kernel beside its twin with CUDA events,
   and prints the main path's wall time stage by stage.

Run from the repository root: ``python3 chip_smoke.py``. The last line is
``{"ok": true, "device": {...}}``; any failure raises and exits non-zero.
Without a CUDA device it exits 2 before printing any result.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: torch.cuda.is_available() is false; nothing run", file=sys.stderr)
    sys.exit(2)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from rhasspy_speech_torch import Nnet3WavTranscriber  # noqa: E402
from rhasspy_speech_torch.host import (  # noqa: E402
    NEG_INF_F32,
    DenseGraph,
    LangArtifacts,
    build_flagship_graph,
    write_flagship_model_dir,
)
from rhasspy_speech_torch.ops import _build  # noqa: E402
from rhasspy_speech_torch.ops import decoder as twin_decoder  # noqa: E402
from rhasspy_speech_torch.ops.frontend import mfcc_batch_torch  # noqa: E402
from rhasspy_speech_torch.ops.ivector import extract_ivectors  # noqa: E402
from rhasspy_speech_torch.ops.mfcc_cuda import mfcc_batch  # noqa: E402
from rhasspy_speech_torch.ops.viterbi_cuda import viterbi_decode  # noqa: E402

SEED = 0
BATCH = 32
SECONDS = 3.0
HIDDEN, LAYERS, NUM_PDFS, IVEC_DIM, UBM_GAUSS = 768, 9, 3072, 100, 512
MFCC_RTOL, MFCC_ATOL = 2e-3, 3e-2
CPU_RTOL, CPU_ATOL = 1e-3, 1e-2


def check(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def cuda_ms(fn, iters=10):
    """Mean milliseconds per call on the card (CUDA events, after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def big_folded_graph(rng, num_states=14200, extra_arcs=9600, num_pdfs=NUM_PDFS):
    """Chain + self-loops + random arcs (~38,000), pdf a function of the
    source state, two hub states: the BENCH_r05 graph's size class."""
    S = num_states
    src = np.concatenate([np.arange(S), np.arange(S), rng.randint(S, size=extra_arcs)])
    dst = np.concatenate([(np.arange(S) + 1) % S, np.arange(S), rng.randint(S, size=extra_arcs)])
    hub_src = rng.randint(S, size=400)
    src = np.concatenate([src, hub_src])
    dst = np.concatenate([dst, np.where(np.arange(400) % 2, S - 1, S // 2)])
    A = src.size
    init = np.full(S, NEG_INF_F32, np.float32)
    init[0] = 0.0
    final = np.full(S, NEG_INF_F32, np.float32)
    final[S - 1] = 0.0
    return DenseGraph(
        num_states=S, arc_src=src.astype(np.int32), arc_dst=dst.astype(np.int32),
        arc_pdf=rng.randint(num_pdfs, size=S)[src].astype(np.int32),
        arc_wseq=np.zeros(A, np.int32), arc_weight=rng.rand(A).astype(np.float32),
        final_weight=final, final_wseq=np.zeros(S, np.int32), init_weight=init,
        init_wseq=np.zeros(S, np.int32), word_seqs=[()], num_pdfs=num_pdfs,
    )


def decode_outputs_equal(a, b):
    """All five decode outputs (trace, final, cost, alpha, bps) identical."""
    for x, y in zip(a, b):
        if x.dtype == torch.uint16:
            x, y = x.to(torch.int32), y.to(torch.int32)
        if not torch.equal(x, y):
            return False
    return True


def stage_ms(t, pcms, fuzzy):
    """The main path once more, stage by stage, each stage ended by a
    synchronize: where the batch's wall time goes."""
    out = {}
    last = time.perf_counter()

    def mark(name):
        nonlocal last
        torch.cuda.synchronize()
        now = time.perf_counter()
        out[name] = round((now - last) * 1000.0, 3)
        last = now

    pcm, feat_lengths, lengths, n_out = t._pad_batch(pcms)
    mark("pad_upload")
    feats = t.am.features(pcm)
    mark("mfcc")
    extract_ivectors(feats, t.am.ivector_params, lengths=feat_lengths)
    mark("ivector_alone")
    log_probs = t.am.log_probs(feats, n_out, feat_lengths=feat_lengths)
    mark("ivector_and_am")
    trace, final_state, cost = t._decode_traces(log_probs, lengths)
    mark("decode_and_copy")
    words = twin_decoder.traces_to_words_batch(t.artifacts.graph, trace, final_state, cost)
    mark("word_assembly")
    t._texts([[] if w is None else [(w, c)] for w, c in words], None, require_fuzzy=False, **fuzzy)
    mark("fuzzy_tail")
    return out


def build_profile(root):
    graph, g_fuzzy, lang = build_flagship_graph(order=3, with_fuzzy=True, num_pdfs=NUM_PDFS)
    max_phone = max(pid for (p, pid) in lang.phones if pid != 0 and not p.startswith("#"))
    model_dir = write_flagship_model_dir(
        os.path.join(root, "model"), num_pdfs=graph.num_pdfs, max_phone=max_phone,
        hidden_dim=HIDDEN, num_tdnnf_layers=LAYERS, ivector_dim=IVEC_DIM,
        ubm_gauss=UBM_GAUSS, seed=SEED + 7,
    )
    graph_dir = os.path.join(root, "graph")
    LangArtifacts(words=lang.words, g_fuzzy=g_fuzzy, graph=graph, phones=lang.phones).save(graph_dir)
    return model_dir, graph_dir, graph


def main():
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; card: {smi}")

    t0 = time.time()
    for name in ("mfcc", "viterbi"):
        print(f"built {_build.build(name).name}")
    print(f"kernel build {time.time() - t0:.1f} s")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        t0 = time.time()
        model_dir, graph_dir, graph = build_profile(root)
        t = Nnet3WavTranscriber(model_dir, graph_dir, device=dev)
        print(f"profile: {graph.num_states} states, {graph.num_arcs} arcs, "
              f"{graph.num_pdfs} pdfs; AM TDNN-F {HIDDEN}x{LAYERS}, ivector {IVEC_DIM}, "
              f"UBM {UBM_GAUSS}; built in {time.time() - t0:.1f} s")

        rng = np.random.RandomState(SEED)
        n = int(16000 * SECONDS)
        pcms = [(1000.0 * rng.randn(n)).astype(np.float32) for _ in range(BATCH)]
        fuzzy = dict(max_fuzzy_cost=1.0e9)  # the fuzzy tail runs for every hypothesis

        # warm-up at the measured shape: library loads, cuBLAS and cuFFT
        # plans, and the caching allocator's first device allocations
        for _ in range(2):
            t.transcribe_pcm_batch(pcms, **fuzzy)
        torch.cuda.synchronize()

        # -- the main path, counted ------------------------------------------
        mfcc_batch.launches = 0
        viterbi_decode.launches = 0
        t0 = time.time()
        main_texts = t.transcribe_pcm_batch(pcms, **fuzzy)
        torch.cuda.synchronize()
        main_s = time.time() - t0
        launches = {"mfcc": mfcc_batch.launches, "viterbi": viterbi_decode.launches}
        print(f"main path: {BATCH} x {SECONDS} s in {main_s * 1000:.1f} ms; launches {launches}")
        check(launches["mfcc"] > 0 and launches["viterbi"] > 0, f"kernels not launched: {launches}")
        check(len(main_texts) == BATCH and all(len(x) == 1 for x in main_texts),
              f"expected one transcript per utterance, got {main_texts[:3]}")
        print(f"main path stages (ms, host clock, synchronized): {stage_ms(t, pcms, fuzzy)}")

        # -- the same batch through the plain twins on the card ---------------
        pcm, feat_lengths, lengths, n_out = t._pad_batch(pcms)
        feats_plain = mfcc_batch_torch(t.am.frontend_params, pcm)
        lp_plain = t.am.log_probs(feats_plain, n_out, feat_lengths=feat_lengths)
        res = twin_decoder.viterbi_decode(t.device_graph, lp_plain, t.acoustic_scale, lengths)
        arrs = [r.cpu().numpy() for r in res]
        words = twin_decoder.traces_to_words_batch(t.artifacts.graph, *arrs)
        plain_texts = t._texts(
            [[] if w is None else [(w, c)] for w, c in words], None, require_fuzzy=False, **fuzzy
        )
        check(plain_texts == main_texts, "transcripts differ between kernels and plain twins")
        print(f"transcripts equal to the plain twins' path; first: {main_texts[0]}")

        # -- K1: MFCC kernel vs twin at the main path's shape ------------------
        feats_k = mfcc_batch(t.am.frontend_params, pcm)
        torch.cuda.synchronize()
        check(feats_k.shape == feats_plain.shape and bool(torch.isfinite(feats_k).all()),
              "mfcc kernel output shape or finiteness")
        k1_err = float((feats_k - feats_plain).abs().max())
        check(torch.allclose(feats_k, feats_plain, rtol=MFCC_RTOL, atol=MFCC_ATOL),
              f"mfcc kernel vs twin: max |d| {k1_err}")
        k1_ms = cuda_ms(lambda: mfcc_batch(t.am.frontend_params, pcm))
        k1_plain_ms = cuda_ms(lambda: mfcc_batch_torch(t.am.frontend_params, pcm))
        print(f"K1 mfcc [{BATCH}, {pcm.shape[1]}] -> {tuple(feats_k.shape)}: max |d| {k1_err:.3e}; "
              f"kernel {k1_ms:.4f} ms, plain {k1_plain_ms:.4f} ms")

        # -- K2: Viterbi kernel vs twin, bit for bit ---------------------------
        lp_k = t.am.log_probs(feats_k, n_out, feat_lengths=feat_lengths)
        g = t.device_graph
        compact = g.num_arcs <= twin_decoder._COMPACT_BP_MAX_ARC

        def twin(graph, lp, lens):
            alpha, bps = twin_decoder.viterbi(graph, lp, t.acoustic_scale, lens, compact_bp=compact)
            return twin_decoder.backtrace(graph, alpha, bps) + (alpha, bps)

        got = viterbi_decode(g, lp_k, t.acoustic_scale, lengths, return_forward=True)
        want = twin(g, lp_k, lengths)
        torch.cuda.synchronize()
        check(decode_outputs_equal(got, want), "viterbi kernel differs from its twin (flagship graph)")
        k2_err = float((got[3] - want[3]).abs().max())
        k2_ms = cuda_ms(lambda: viterbi_decode(g, lp_k, t.acoustic_scale, lengths))
        k2_plain_ms = cuda_ms(lambda: twin(g, lp_k, lengths), iters=3)
        print(f"K2 viterbi {tuple(lp_k.shape)} on {g.num_states} states: bit-exact; "
              f"kernel {k2_ms:.4f} ms, plain {k2_plain_ms:.4f} ms")

        big = twin_decoder.DecodeGraph.from_dense(big_folded_graph(np.random.RandomState(SEED + 1)), dev)
        lp_big = torch.as_tensor(
            np.random.RandomState(SEED + 2).randn(BATCH, n_out, NUM_PDFS).astype(np.float32), device=dev
        )
        big_compact = big.num_arcs <= twin_decoder._COMPACT_BP_MAX_ARC
        got = viterbi_decode(big, lp_big, 1.0, lengths, return_forward=True)
        alpha, bps = twin_decoder.viterbi(big, lp_big, 1.0, lengths, compact_bp=big_compact)
        want = twin_decoder.backtrace(big, alpha, bps) + (alpha, bps)
        torch.cuda.synchronize()
        check(decode_outputs_equal(got, want), "viterbi kernel differs from its twin (large graph)")
        big_ms = cuda_ms(lambda: viterbi_decode(big, lp_big, 1.0, lengths))
        big_plain_ms = cuda_ms(
            lambda: twin_decoder.backtrace(big, *twin_decoder.viterbi(
                big, lp_big, 1.0, lengths, compact_bp=big_compact)), iters=3)
        print(f"K2 viterbi {tuple(lp_big.shape)} on {big.num_states} states / {big.num_arcs} arcs "
              f"(alpha {2 * 4 * big.num_states} B of shared memory): bit-exact; "
              f"kernel {big_ms:.4f} ms, plain {big_plain_ms:.4f} ms")

        # -- the card against the CPU twins on a small input -------------------
        tc = Nnet3WavTranscriber(model_dir, graph_dir, device="cpu")
        lp_cpu, _ = tc._acoustic_batch(pcms[:2])
        lp_dev, _ = t._acoustic_batch(pcms[:2])
        cpu_err = float((lp_dev.cpu() - lp_cpu).abs().max())
        check(torch.allclose(lp_dev.cpu(), lp_cpu, rtol=CPU_RTOL, atol=CPU_ATOL),
              f"card log-probs vs CPU twins: max |d| {cpu_err}")
        check(tc.transcribe_pcm_batch(pcms[:2], **fuzzy) == main_texts[:2],
              "CPU twins transcribe differently")
        print(f"card vs CPU twins on 2 utterances: log-probs max |d| {cpu_err:.3e}, transcripts equal")

    kernels = [
        {"name": "mfcc", "route": "cuda", "source": "rhasspy_speech_torch/csrc/mfcc.cu",
         "replaces": "rhasspy_speech_tpu/ops/pallas_mfcc.py:122",
         "launches": launches["mfcc"], "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "viterbi", "route": "cuda", "source": "rhasspy_speech_torch/csrc/viterbi.cu",
         "replaces": "rhasspy_speech_tpu/ops/pallas_decoder.py:370",
         "launches": launches["viterbi"], "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain_ms},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
