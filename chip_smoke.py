#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

Drives batch WAV transcription (``Nnet3WavTranscriber.transcribe_pcm_batch``)
at the full width of the benchmarked model -- TDNN-F 768 x 9, 40-dim MFCC,
100-dim i-vector from a 512-Gaussian UBM, 3,072 pdfs, random weights from a
seed -- over the flagship decode graph, then its n-best, silence-weighting
and lattice paths, and the windowed-relaxation entry point, and checks the
three hand-written kernels against their plain PyTorch twins:

1. builds ``csrc/mfcc.cu``, ``csrc/viterbi.cu`` and
   ``csrc/windowed_relax.cu`` with nvcc for sm_90a, in parallel;
2. transcribes 32 seeded 3 s utterances (1-best) with the launch counters
   zeroed just before and read just after, and requires the MFCC and
   Viterbi kernels to have run;
3. recomputes the same batch through the plain twins on the card and
   requires equal transcripts;
4. compares the MFCC kernel with its twin (rtol 2e-3 / atol 3e-2, the JAX
   package's tolerance for its own DFT-as-matmul kernel against rfft) and
   the Viterbi kernel with its twin bit for bit, at B=32 and B=1, on the
   flagship graph and on a seeded folded graph of 14,200 states / 38,400
   arcs / 3,072 pdfs (``testing/decode_graphs.py``), and times the Viterbi
   kernel at each cluster size that fits;
5. checks the card's log-probs against the CPU twins on 2 utterances
   (rtol 1e-3 / atol 1e-2: f32 sums ordered differently through eleven
   768-wide layers), times each kernel beside its twin with CUDA events,
   and prints the main path's wall time stage by stage;
6. n-best (k=5) on the same batch: the MFCC kernel ran, transcripts equal
   the plain twins' path, and given the same log-probs the card's k-best
   outputs are bit-equal to the CPU's on 2 utterances;
7. silence weighting (``silence_weight=0.01``, with ``model/phones.txt``
   written from the graph's phone table): the first pass went through the
   Viterbi kernel and the silence-weighted second pass ran; transcripts
   equal the CPU's on 2 utterances;
8. lattices and confidence on 2 utterances, at a lattice beam of 4: given
   the same log-probs the card's tropical forward-backward is bit-equal to
   the CPU's, and the confidences agree with the CPU's within 1e-2 (the
   log-probs differ by up to 1e-2; a lattice arc flipping across the beam
   moves a confidence by at most exp(-4) of a rival's share). The beam is
   4, not the default 8, because on noise through a random model the
   default beam keeps ~10,000 arcs and the host's lattice determinization
   then takes tens of seconds per utterance;
9. the windowed relaxation at the example's shape (B=512, T=116,
   S_pad=14,208, NSTEP=1,280) through
   ``rhasspy_speech_torch.examples.windowed_cost.main``, counted, bit-equal
   to its plain version on every stream; then timed and held bit-equal at
   every thread-block cluster size the card accepts, at the example's
   shape and at a batch (13) that no cluster size divides; timed once more
   with indices that cause no shared-memory bank conflicts; and bit-equal
   again on small tables and initial alphas that differ per stream;
10. checks that no module of ``jax`` or ``rhasspy_speech_tpu`` was imported
   (the card's machine has JAX installed; the port must not reach it).

Each kernel's entry in the ``kernels`` line carries ``bound_ms``, the least
time the card could take for the same work: the larger of its bytes (each
input read once, each output written once) at 3.35 TB/s and its f32
operations at 67 TFLOP/s, NVIDIA's H100 SXM peaks at 700 W. The Viterbi
kernel's log-probs count only where this run's decode reads them: the
32-byte sectors of the graph's pdfs in each stream's active frames.

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
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: torch.cuda.is_available() is false; nothing run", file=sys.stderr)
    sys.exit(2)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from rhasspy_speech_torch import Nnet3WavTranscriber  # noqa: E402
from rhasspy_speech_torch.pipeline.artifacts import LangArtifacts  # noqa: E402
from rhasspy_speech_torch.testing.decode_graphs import random_decode_graph  # noqa: E402
from rhasspy_speech_torch.testing.flagship import (  # noqa: E402
    build_flagship_graph,
    write_flagship_model_dir,
)
from rhasspy_speech_torch.ops import _build  # noqa: E402
from rhasspy_speech_torch.ops import decoder as twin_decoder  # noqa: E402
from rhasspy_speech_torch.ops import windowed_relax_cuda as k3  # noqa: E402
from rhasspy_speech_torch.examples import windowed_cost  # noqa: E402
from rhasspy_speech_torch.ops.frontend import mfcc_batch_torch  # noqa: E402
from rhasspy_speech_torch.ops.ivector import extract_ivectors  # noqa: E402
from rhasspy_speech_torch.ops.lattice import forward_backward  # noqa: E402
from rhasspy_speech_torch.ops.mfcc_cuda import mel_bands, mfcc_batch  # noqa: E402
from rhasspy_speech_torch.ops.viterbi_cuda import (  # noqa: E402
    CLUSTER_SIZES,
    MAX_SLICE_STATES,
    launch,
    max_clusters,
    plan_viterbi,
    select_plan,
    smem_layout,
    viterbi_decode,
)
from rhasspy_speech_torch.ops.windowed_relax_cuda import (  # noqa: E402
    prepare_steps,
    windowed_relax,
    windowed_relax_torch,
)

K3_ODD_BATCH = 13  # no cluster size above 1 divides it

SEED = 0
BATCH = 32
SECONDS = 3.0
HIDDEN, LAYERS, NUM_PDFS, IVEC_DIM, UBM_GAUSS = 768, 9, 3072, 100, 512
MFCC_RTOL, MFCC_ATOL = 2e-3, 3e-2
CPU_RTOL, CPU_ATOL = 1e-3, 1e-2
NBEST = 5
SILENCE_WEIGHT = 0.01
CONF_ATOL = 1e-2
LATTICE_BEAM = 4.0
KERNELS = ("mfcc", "viterbi", "windowed_relax")
HBM_BYTES_PER_S, F32_OPS_PER_S = 3.35e12, 67e12  # H100 SXM, 700 W


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


def bound(nbytes, nops):
    """(bound_ms, bound_by): the larger of the bytes' time at the card's
    memory rate and the f32 operations' time at its peak rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, nops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mfcc_work(params, B, S, T):
    """(bytes, f32 operations) of the MFCC kernel's function at a
    power-of-two window: PCM in, cepstra out; per frame the DC removal,
    pre-emphasis and window (and energy), the real FFT as an N/2-point
    complex FFT (10 operations a radix-2 butterfly) and its split, the mel
    bands, log, DCT and lifter."""
    cfg = params.cfg
    L, H, M, C = cfg.frame_length, cfg.padded_window_size // 2, cfg.num_mel_bins, cfg.num_ceps
    check(H & (H - 1) == 0, f"mfcc_work counts a power-of-two window, got N={2 * H}")
    mel_terms = int(mel_bands(params.mel_weights.cpu().numpy())[0][-1])
    per_frame = (
        5 * L + (2 * L if cfg.use_energy else 0)
        + 10 * (H // 2) * (H.bit_length() - 1) + 14 * (H + 1)
        + 2 * mel_terms + M + 2 * M * C + C
    )
    return 4 * B * S + 4 * B * T * C, B * T * per_frame


def viterbi_work(graph, B, T, P, lengths):
    """(bytes, f32 operations) of one decode. In: the lengths, the graph's
    tables (packed source, arc id and weight per arc, row pointers, initial
    and final weights, and the per-state pdf when folded or the per-arc pdf
    when not), and of each stream's active frames only the log-probs at the
    pdfs the graph reads, counted as the 32-byte sectors that hold them
    (the card reads no less). Out: backpointers for every frame (STAY past
    a stream's end), final alpha, traces, final state and cost. Operations:
    per active frame an add, a min and a compare per arc and the fold per
    state."""
    S, A = graph.num_states, graph.num_arcs
    pdfs = (graph.src_pdf if graph.folded else graph.in_pdf).long()
    # sectors a row touches, by the row's start offset in floats mod 8
    # (torch allocations start on a sector)
    sectors = [int(torch.unique((pdfs + o) // 8).numel()) for o in range(8)]
    lens = lengths.clamp(max=T).tolist()
    lp_bytes = 32 * sum(sectors[((b * T + t) * P) % 8] for b in range(B) for t in range(lens[b]))
    bp_bytes = 2 if A <= twin_decoder._COMPACT_BP_MAX_ARC else 4
    tables = 8 * A + 4 * (S + 1) + 8 * S + (2 * S if graph.folded else 4 * A)
    nbytes = (4 * B + tables + lp_bytes + bp_bytes * T * B * S + 4 * B * S + 4 * B * T
              + 8 * B)
    return nbytes, sum(lens) * (3 * A + 2 * S)


def windowed_relax_work(T, B, S, nstep):
    """(bytes, f32 operations) of the windowed relaxation: step tables in,
    uint16 backpointers and alpha out; 3 operations a lane a step."""
    nbytes = 8 * nstep + 12 * nstep * 128 + 2 * T * B * S + 4 * B * S
    return nbytes, 3 * T * B * nstep * 128


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
    """The flagship graph and a random full-width model. The model dir
    gets ``model/phones.txt`` from the graph's phone table, as a trained
    Kaldi model dir has it: silence weighting finds its silence pdfs
    there."""
    graph, g_fuzzy, lang = build_flagship_graph(order=3, with_fuzzy=True, num_pdfs=NUM_PDFS)
    max_phone = max(pid for (p, pid) in lang.phones if pid != 0 and not p.startswith("#"))
    model_dir = write_flagship_model_dir(
        os.path.join(root, "model"), num_pdfs=graph.num_pdfs, max_phone=max_phone,
        hidden_dim=HIDDEN, num_tdnnf_layers=LAYERS, ivector_dim=IVEC_DIM,
        ubm_gauss=UBM_GAUSS, seed=SEED + 7,
    )
    with open(os.path.join(model_dir, "model", "phones.txt"), "w", encoding="utf-8") as f:
        lang.phones.write_text(f)
    graph_dir = os.path.join(root, "graph")
    LangArtifacts(words=lang.words, g_fuzzy=g_fuzzy, graph=graph, phones=lang.phones).save(graph_dir)
    return model_dir, graph_dir, graph


def zero_counts():
    for fn in (mfcc_batch, viterbi_decode, windowed_relax):
        fn.launches = 0


def read_counts():
    return {"mfcc": mfcc_batch.launches, "viterbi": viterbi_decode.launches,
            "windowed_relax": windowed_relax.launches}


def viterbi_phase(t, lp_k, lengths, dev):
    """K2 against its twin, bit for bit, on the flagship graph (the main
    path's log-probs) and on the 14,200-state graph (seeded log-probs), at
    B=32 and B=1; times the kernel as ``viterbi_decode`` runs it and at
    every cluster size that fits. Returns the main path shape's numbers."""
    big = twin_decoder.DecodeGraph.from_dense(random_decode_graph(np.random.RandomState(SEED + 1)), dev)
    lp_big = torch.as_tensor(
        np.random.RandomState(SEED + 2).randn(*lp_k.shape).astype(np.float32), device=dev)
    max_smem = _build.load("viterbi").rss_viterbi_max_smem(dev.index)
    out = {}
    for name, g, lp, scale in (("flagship", t.device_graph, lp_k, t.acoustic_scale),
                               ("14200", big, lp_big, 1.0)):
        compact = g.num_arcs <= twin_decoder._COMPACT_BP_MAX_ARC

        def twin(lp_b, lens):
            alpha, bps = twin_decoder.viterbi(g, lp_b, scale, lens, compact_bp=compact)
            return twin_decoder.backtrace(g, alpha, bps) + (alpha, bps)

        for B in (BATCH, 1):
            lp_b, lens = lp[:B].contiguous(), lengths[:B].contiguous()
            got = viterbi_decode(g, lp_b, scale, lens, return_forward=True)
            want = twin(lp_b, lens)
            torch.cuda.synchronize()
            check(decode_outputs_equal(got, want),
                  f"viterbi kernel differs from its twin ({name} graph, B={B})")
            plan, resident = select_plan(g, B)
            ms = cuda_ms(lambda: viterbi_decode(g, lp_b, scale, lens))
            plain_ms = cuda_ms(lambda: twin(lp_b, lens), iters=3)
            sweep = {}
            for c in CLUSTER_SIZES:
                p = plan_viterbi(g, c)
                if p.max_states > MAX_SLICE_STATES:
                    continue
                res = smem_layout(g.num_states, p, g.folded, True)[1] <= max_smem
                sweep[f"C={c}{'' if res else ' L2 tables'} x{max_clusters(g, p, res)}"] = round(
                    cuda_ms(lambda: launch(g, p, res, lp_b, scale, lens)), 4)
            nbytes, nops = viterbi_work(g, B, lp_b.shape[1], lp_b.shape[2], lens)
            bound_ms, bound_by = bound(nbytes, nops)
            print(f"K2 viterbi {tuple(lp_b.shape)} on {name} graph ({g.num_states} states, "
                  f"{g.num_arcs} arcs): bit-exact; cluster {plan.cluster} (tables "
                  f"{'in shared memory' if resident else 'in L2'}); kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); by cluster size "
                  f"(x clusters the card runs at once) {sweep}")
            out[(name, B)] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                              "bound_by": bound_by,
                              "max_abs_err": float((got[3] - want[3]).abs().max())}
    return out[("flagship", BATCH)]


def nbest_phase(t, tc, pcms, fuzzy):
    """n-best at full width; returns the plain k-best's time on the card."""
    zero_counts()
    t0 = time.time()
    texts = t.transcribe_pcm_batch(pcms, nbest=NBEST, **fuzzy)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = read_counts()
    print(f"n-best (k={NBEST}): {BATCH} x {SECONDS} s in {wall * 1000:.1f} ms; launches {counts}")
    check(counts["mfcc"] > 0, f"n-best path did not launch the MFCC kernel: {counts}")
    check(len(texts) == BATCH and all(len(x) == 1 for x in texts),
          f"expected one fuzzy transcript per utterance, got {texts[:3]}")

    pcm, feat_lengths, lengths, n_out = t._pad_batch(pcms)
    lp_plain = t.am.log_probs(mfcc_batch_torch(t.am.frontend_params, pcm), n_out,
                              feat_lengths=feat_lengths)
    plain = t._texts(t._decode_nbest(lp_plain, lengths, NBEST), None, require_fuzzy=False, **fuzzy)
    check(plain == texts, "n-best transcripts differ between kernels and plain twins")

    lp2, lens2 = lp_plain[:2].contiguous(), lengths[:2]
    dev_out = twin_decoder.viterbi_kbest_decode(t.device_graph, lp2, NBEST, t.acoustic_scale, lens2)
    cpu_out = twin_decoder.viterbi_kbest_decode(tc.device_graph, lp2.cpu(), NBEST,
                                                tc.acoustic_scale, lens2.cpu())
    check(all(torch.equal(d.cpu(), c) for d, c in zip(dev_out, cpu_out)),
          "k-best outputs differ between the card and the CPU")
    kbest_ms = cuda_ms(lambda: twin_decoder.viterbi_kbest_decode(
        t.device_graph, lp_plain, NBEST, t.acoustic_scale, lengths), iters=2)
    print(f"n-best transcripts equal the plain twins' path; k-best bit-equal to the CPU's on 2 "
          f"utterances; plain k-best decode {tuple(lp_plain.shape)} k={NBEST}: {kbest_ms:.4f} ms; "
          f"first: {texts[0]}")
    return kbest_ms


def silence_phase(model_dir, graph_dir, dev, pcms, fuzzy):
    """silence_weight at full width: the first pass on the Viterbi kernel,
    then the silence-weighted second pass."""
    t = Nnet3WavTranscriber(model_dir, graph_dir, device=dev, silence_weight=SILENCE_WEIGHT)
    sil_pdfs = t._get_silence_pdfs()
    check(len(sil_pdfs) > 0, "no silence pdfs found from model/phones.txt")
    t.transcribe_pcm_batch(pcms, **fuzzy)  # warm-up
    weights = []
    log_probs = t.am.log_probs

    def recording(*args, **kwargs):
        weights.append(kwargs.get("ivector_frame_weights"))
        return log_probs(*args, **kwargs)

    t.am.log_probs = recording
    zero_counts()
    t0 = time.time()
    texts = t.transcribe_pcm_batch(pcms, **fuzzy)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = read_counts()
    t.am.log_probs = log_probs
    check(len(weights) == 2 and weights[0] is None and weights[1] is not None,
          "the silence-weighted second pass did not run")
    check(counts["viterbi"] >= 2 and counts["mfcc"] > 0,
          f"silence weighting: first pass and decode should both launch the Viterbi kernel: {counts}")
    w = weights[1]
    sil_share = float((w == SILENCE_WEIGHT).float().mean())
    print(f"silence weighting ({len(sil_pdfs)} silence pdfs): {BATCH} x {SECONDS} s in "
          f"{wall * 1000:.1f} ms; launches {counts}; frames weighted {SILENCE_WEIGHT}: "
          f"{sil_share:.4f} of {tuple(w.shape)}")
    tc = Nnet3WavTranscriber(model_dir, graph_dir, device="cpu", silence_weight=SILENCE_WEIGHT)
    check(tc.transcribe_pcm_batch(pcms[:2], **fuzzy) == texts[:2],
          "silence-weighted transcripts differ between the card and the CPU")

    # weighted i-vector stats on the card against the CPU, with weights
    # that are not all 1 whatever the first pass found
    pcm, feat_lengths, _, _ = t._pad_batch(pcms[:2])
    feats = t.am.features(pcm)
    fw = torch.ones(feats.shape[:2], device=dev)
    fw[:, ::3] = SILENCE_WEIGHT
    ivec = extract_ivectors(feats, t.am.ivector_params, feat_lengths, frame_weights=fw)
    ivec_cpu = extract_ivectors(feats.cpu(), tc.am.ivector_params, feat_lengths.cpu(),
                                frame_weights=fw.cpu())
    plain = extract_ivectors(feats, t.am.ivector_params, feat_lengths)
    iv_err = float((ivec.cpu() - ivec_cpu).abs().max())
    check(torch.allclose(ivec.cpu(), ivec_cpu, rtol=CPU_RTOL, atol=CPU_ATOL),
          f"weighted i-vectors on the card vs the CPU: max |d| {iv_err}")
    check(not torch.allclose(ivec, plain, rtol=CPU_RTOL, atol=CPU_ATOL),
          "frame weights left the i-vectors unchanged")
    print(f"silence-weighted transcripts equal the CPU's on 2 utterances; weighted i-vectors "
          f"vs CPU max |d| {iv_err:.3e}")
    return wall


def lattice_phase(t, tc, pcms):
    """get_lattice_pcm and confidence_pcm on 2 utterances, card against
    CPU."""
    for i, pcm in enumerate(pcms[:2]):
        zero_counts()
        t0 = time.time()
        lat = t.get_lattice_pcm(pcm)
        conf = t.confidence_pcm(pcm)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = read_counts()
        check(counts["mfcc"] > 0, f"lattice path did not launch the MFCC kernel: {counts}")
        check(lat is not None and lat.num_arcs() > 0, "empty lattice")
        _words, best = lat.shortest_path_words(t.artifacts.graph)
        check(abs(best - lat.best_cost) <= 1e-3 * max(1.0, abs(best)),
              f"lattice best path {best} vs forward-backward best {lat.best_cost}")

        lp = t._utterance_log_probs(pcm)
        fb_dev = forward_backward(t.device_graph, lp, t.acoustic_scale)
        fb_cpu = forward_backward(tc.device_graph, lp.cpu(), tc.acoustic_scale)
        check(all(torch.equal(d.cpu(), c) for d, c in zip(fb_dev, fb_cpu)),
              "forward-backward differs between the card and the CPU")
        conf_cpu = tc.confidence_pcm(pcm)
        check(0.0 <= conf <= 1.0 and abs(conf - conf_cpu) <= CONF_ATOL,
              f"confidence {conf} on the card vs {conf_cpu} on the CPU")
        fb_ms = cuda_ms(lambda: forward_backward(t.device_graph, lp, t.acoustic_scale), iters=3)
        print(f"lattice utt {i}: {lat.num_nodes} nodes, {lat.num_arcs()} arcs; lattice + "
              f"confidence {wall * 1000:.1f} ms; forward-backward {tuple(lp.shape)} bit-equal to "
              f"the CPU's, {fb_ms:.4f} ms on the card; confidence {conf:.6f} (CPU {conf_cpu:.6f})")


def relax_outputs_equal(got, want):
    """alpha and the uint16 backpointers identical."""
    return torch.equal(got[0], want[0]) and torch.equal(got[1].to(torch.int32), want[1].to(torch.int32))


def windowed_relax_phase(dev):
    """K3 through its entry point at the example's shape, then against its
    plain version at every cluster size; returns (launches, max |d|, kernel
    ms, plain ms, (bound ms, bound by))."""
    zero_counts()
    out = windowed_cost.main([])
    torch.cuda.synchronize()
    launches = read_counts()["windowed_relax"]
    check(launches > 0, "windowed_cost.main did not launch the windowed_relax kernel")
    tables, steps = out["tables"], out["steps"]
    B, S = out["alpha"].shape
    T = out["bp"].shape[0]
    want = windowed_relax_torch(*tables, T, B, S)
    torch.cuda.synchronize()
    check(relax_outputs_equal((out["alpha"], out["bp"]), want),
          "windowed_relax differs from its plain version")
    err = float((out["alpha"] - want[0]).abs().max())
    plain_ms = cuda_ms(lambda: windowed_relax_torch(*tables, T, B, S), iters=2)
    chosen = k3.select_cluster(steps, B)
    check(chosen == out["cluster"], f"entry point reported cluster {out['cluster']}, not {chosen}")
    print(f"K3 windowed_relax B={B} T={T} S_pad={S} NSTEP={tables[0].shape[0]} "
          f"({steps.num_rounds} rounds): bit-equal on every stream; kernel {out['ms']:.4f} ms "
          f"({out['us_per_step']:.6f} us/step) in clusters of {chosen}, plain {plain_ms:.4f} ms")

    # every cluster size the card accepts: the example's shape, timed, and
    # a batch the cluster size does not divide, on tables with exact ties
    dbase, sbase, idx, w, arc = windowed_cost.make_step_tables(100, 1024, seed=3)
    odd = [torch.as_tensor(x, device=dev) for x in
           (dbase, sbase, idx, (np.round(w * 4) / 4).astype(np.float32), (arc % 300).astype(np.int32))]
    odd_a0 = torch.as_tensor(
        (np.round(np.random.RandomState(4).rand(K3_ODD_BATCH, 1024) * 8) / 8).astype(np.float32),
        device=dev)
    odd_steps = prepare_steps(*odd, 1024)
    odd_want = windowed_relax_torch(*odd, 5, K3_ODD_BATCH, 1024, alpha0=odd_a0)
    sizes = [c for c in k3.CLUSTER_SIZES if k3.max_clusters(steps, c) > 0]
    check(chosen in sizes, f"chosen cluster size {chosen} not among the accepted {sizes}")
    for c in sizes:
        before = windowed_relax.launches
        got = k3.launch(steps, T, B, None, c)
        got_odd = k3.launch(odd_steps, 5, K3_ODD_BATCH, odd_a0, c)
        torch.cuda.synchronize()
        check(windowed_relax.launches == before + 2, "windowed_relax launch count")
        check(relax_outputs_equal(got, want),
              f"windowed_relax differs from its plain version in clusters of {c}")
        check(relax_outputs_equal(got_odd, odd_want),
              f"windowed_relax differs from its plain version in clusters of {c}, B={K3_ODD_BATCH}")
        del got
        ms = cuda_ms(lambda: k3.launch(steps, T, B, None, c), iters=5)
        print(f"K3 windowed_relax C={c} x{k3.max_clusters(steps, c)} (clusters the card runs at "
              f"once): bit-equal at B={B} and at B={K3_ODD_BATCH}; {ms:.4f} ms"
              f"{' (chosen)' if c == chosen else ''}")
    del want

    # the same tables with idx[i, j] = j: every lane of a warp gathers from
    # its own shared-memory bank, where random idx collide about 3.5-fold
    idx_lane = torch.arange(k3.LANES, dtype=tables[2].dtype, device=dev).expand_as(tables[2]).contiguous()
    lane_steps = prepare_steps(tables[0], tables[1], idx_lane, tables[3], tables[4], S)
    random_ms = cuda_ms(lambda: k3.launch(steps, T, B, None, chosen), iters=5)
    lane_ms = cuda_ms(lambda: k3.launch(lane_steps, T, B, None, chosen), iters=5)
    print(f"K3 windowed_relax C={chosen}: {random_ms:.4f} ms with the example's random idx, "
          f"{lane_ms:.4f} ms with bank-conflict-free idx (idx[i, j] = j)")
    del lane_steps, idx_lane

    # tables and initial alphas that differ per stream, with exact ties
    Bs, s_pad, nstep = 8, 1024, 100
    per = [windowed_cost.make_step_tables(nstep, s_pad, seed=40 + i) for i in range(Bs)]
    dbase, sbase, idx, w, arc = (np.stack(x) for x in zip(*per))
    w = (np.round(w * 4) / 4).astype(np.float32)
    arc = (arc % 11).astype(np.int32)
    alpha0 = (np.round(np.random.RandomState(9).rand(Bs, s_pad) * 8) / 8).astype(np.float32)
    small = [torch.as_tensor(x, device=dev) for x in (dbase, sbase, idx, w, arc)]
    a0 = torch.as_tensor(alpha0, device=dev)
    before = windowed_relax.launches
    got = windowed_relax(prepare_steps(*small, s_pad), 4, Bs, alpha0=a0)
    check(windowed_relax.launches == before + 1, "windowed_relax launch count (per-stream tables)")
    ref = windowed_relax_torch(*small, 4, Bs, s_pad, alpha0=a0)
    check(relax_outputs_equal(got, ref),
          "windowed_relax differs from its plain version on per-stream tables")
    check(not torch.equal(got[1][:, 0], got[1][:, 1]), "per-stream case: streams should differ")
    print(f"K3 windowed_relax per-stream tables [{Bs}, {nstep}, 128], S_pad={s_pad}: bit-equal")
    k3_bound = bound(*windowed_relax_work(T, B, S, tables[0].shape[0]))
    print(f"K3 bound {k3_bound[0]:.4f} ms ({k3_bound[1]})")
    return launches, err, out["ms"], plain_ms, k3_bound


def main():
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; card: {smi}")

    t0 = time.time()
    with ThreadPoolExecutor(len(KERNELS)) as pool:  # one nvcc per source, all at once
        for path in pool.map(_build.build, KERNELS):
            print(f"built {path.name}")
    print(f"kernel build {time.time() - t0:.1f} s")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        t0 = time.time()
        model_dir, graph_dir, graph = build_profile(root)
        t = Nnet3WavTranscriber(model_dir, graph_dir, device=dev, lattice_beam=LATTICE_BEAM)
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
        zero_counts()
        t0 = time.time()
        main_texts = t.transcribe_pcm_batch(pcms, **fuzzy)
        torch.cuda.synchronize()
        main_s = time.time() - t0
        launches = read_counts()
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
        k1_bound = bound(*mfcc_work(t.am.frontend_params, BATCH, pcm.shape[1], feats_k.shape[1]))
        print(f"K1 mfcc [{BATCH}, {pcm.shape[1]}] -> {tuple(feats_k.shape)}: max |d| {k1_err:.3e}; "
              f"kernel {k1_ms:.4f} ms, plain {k1_plain_ms:.4f} ms, bound {k1_bound[0]:.4f} ms "
              f"({k1_bound[1]})")

        # -- K2: Viterbi kernel vs twin, bit for bit ---------------------------
        lp_k = t.am.log_probs(feats_k, n_out, feat_lengths=feat_lengths)
        k2 = viterbi_phase(t, lp_k, lengths, dev)

        # -- the card against the CPU twins on a small input -------------------
        tc = Nnet3WavTranscriber(model_dir, graph_dir, device="cpu", lattice_beam=LATTICE_BEAM)
        lp_cpu, _ = tc._acoustic_batch(pcms[:2])
        lp_dev, _ = t._acoustic_batch(pcms[:2])
        cpu_err = float((lp_dev.cpu() - lp_cpu).abs().max())
        check(torch.allclose(lp_dev.cpu(), lp_cpu, rtol=CPU_RTOL, atol=CPU_ATOL),
              f"card log-probs vs CPU twins: max |d| {cpu_err}")
        check(tc.transcribe_pcm_batch(pcms[:2], **fuzzy) == main_texts[:2],
              "CPU twins transcribe differently")
        print(f"card vs CPU twins on 2 utterances: log-probs max |d| {cpu_err:.3e}, transcripts equal")

        # -- n-best, silence weighting, lattices --------------------------------
        nbest_phase(t, tc, pcms, fuzzy)
        silence_phase(model_dir, graph_dir, dev, pcms, fuzzy)
        lattice_phase(t, tc, pcms)

    # -- K3: the windowed relaxation's entry point ----------------------------
    k3_launches, k3_err, k3_ms, k3_plain_ms, k3_bound = windowed_relax_phase(dev)

    # no single PyTorch call computes Kaldi's MFCC, a Viterbi pass or the
    # windowed relaxation: library_ms is null for all three
    kernels = [
        {"name": "mfcc", "route": "cuda", "source": "rhasspy_speech_torch/csrc/mfcc.cu",
         "replaces": "rhasspy_speech_tpu/ops/pallas_mfcc.py:122",
         "launches": launches["mfcc"], "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain_ms,
         "bound_ms": k1_bound[0], "bound_by": k1_bound[1], "library_ms": None},
        {"name": "viterbi", "route": "cuda", "source": "rhasspy_speech_torch/csrc/viterbi.cu",
         "replaces": "rhasspy_speech_tpu/ops/pallas_decoder.py:370",
         "launches": launches["viterbi"], "max_abs_err": k2["max_abs_err"], "ms": k2["ms"],
         "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
         "library_ms": None},
        {"name": "windowed_relax", "route": "cuda", "source": "rhasspy_speech_torch/csrc/windowed_relax.cu",
         "replaces": "examples/pallas_windowed_cost.py:59",
         "launches": k3_launches, "max_abs_err": k3_err, "ms": k3_ms, "plain_ms": k3_plain_ms,
         "bound_ms": k3_bound[0], "bound_by": k3_bound[1], "library_ms": None},
    ]
    loaded = sorted(m for m in sys.modules if m.partition(".")[0] in ("jax", "jaxlib", "rhasspy_speech_tpu"))
    check(not loaded, f"the port imported JAX or the JAX package: {loaded[:5]}")
    print("no module of jax or rhasspy_speech_tpu was imported")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
