"""The batch cells: ``Nnet3WavTranscriber.transcribe_pcm_batch`` driven in a
closed loop by one client (``traffic/batch_closed.py``).

The window sends the mix's batches in turn, back to back, until
``--seconds`` have passed. End to end: ``batch_xrt``, the audio seconds
transcribed over the window's wall seconds, and ``batch_call_p95_ms``, the
95th percentile of every call's wall time.

For the comparison the benchmark taps the timed calls (``harness/hooks.py``)
on a sample of them drawn from the seed (reservoir sampling, decided before
each call, so a call that is not kept costs one Python frame a tap): the
i-vectors the call extracted, the AM's log-likelihoods, the decoder's
traces, final states and costs, and the transcripts. After the window the
reference (``reference/``) recomputes each kept call from its PCM alone.

Traced runs (``--trace 1``) add, after the window, a profiled segment of
the same calls (``PROFILED_SECONDS``) with a span around each stage of the
call, and the device time of one MFCC (K1) and one Viterbi (K2) launch at a
kept call's shapes, timed behind matrix products (``harness/timing.py``).
``busy_s`` and ``window_s`` are the segment's: the union of the device
intervals the profiler recorded inside it, over its length. Where
torch.profiler records no device event for the ctypes-launched K1 or K2,
their launches in the segment times that time are added; a busy time
longer than the segment then raises, as that count is too high.
"""

from __future__ import annotations

import math
import sys
import time
from typing import Dict, List, Optional

import numpy as np

from benchmark.counts import roofline
from benchmark.harness import hooks, model as hmodel, timing, trace as htrace
from benchmark.harness.gcwatch import GcWatch
from benchmark.reference import decode as rdecode, frontend as rfront, ivector as rivec, nets, weights

SPAN_STAGES = (("_pad_batch", "pad_upload"), ("_decode_traces", "decode_k2"),
               ("_texts", "words_fuzzy"))
AM_STAGES = (("features", "features_k1"), ("log_probs", "ivector_am"))
PROFILED_SECONDS = 2.0


class Driver:
    def __init__(self, cell, seed: int, seconds: float, device, control: Optional[str], workdir):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.device, self.control, self.workdir = device, control, workdir
        self.params = cell.traffic
        self.limits = cell.workload["check"]["limits"]
        self.keep = int(cell.workload["check"]["sample_calls"])
        self.record: Dict = {}
        self.breakdown = None
        self.attempted = self.failed = 0
        self.hooks = hooks.Hooks()
        self.sample: List[Dict] = []
        self._cur: Optional[Dict] = None

    # -- set-up ---------------------------------------------------------------

    def setup(self) -> None:
        import torch

        steps = hmodel.Steps()
        self.model_dir, self.graph_dir = hmodel.build(self.cell.config, self.seed, self.workdir,
                                                      steps)
        self.graph = rdecode.Graph(self.graph_dir)
        hmodel.check_graph(self.cell.config, self.graph)
        gen = self.cell.generator()
        steps.mark("graph check")
        self.batches = [[p.astype(np.float32) for p in b] for b in gen.make(self.params, self.seed)]
        self.audio = [sum(p.shape[0] for p in b) / 16000.0 for b in self.batches]
        dtype = self.cell.config["compute_dtype"]
        if self.control == "tf32":
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
        elif self.control == "bf16":
            dtype = "bfloat16"
        steps.mark("traffic")
        from rhasspy_speech_torch.pipeline import transcribe as ptr

        self.ptr = ptr
        self.tr = ptr.Nnet3WavTranscriber(self.model_dir, self.graph_dir, compute_dtype=dtype,
                                          device=self.device)
        steps.mark("transcriber")
        for b in self.batches:  # every shape the window sends, once
            self.tr.transcribe_pcm_batch(b)
        steps.mark("warm-up")
        steps.report()
        self._tap()

    def _tap(self) -> None:
        """Taps that keep a kept call's i-vectors, log-probs and traces."""
        def keep(key):
            def make(orig):
                def wrapper(*a, **k):
                    out = orig(*a, **k)
                    if self._cur is not None:
                        self._cur[key] = out
                    return out
                return wrapper
            return make

        self.hooks.wrap(self.ptr, "extract_ivectors", keep("ivec"))
        self.hooks.wrap(self.tr.am, "log_probs", keep("log_probs"))
        self.hooks.wrap(self.tr, "_decode_traces", keep("decode"))

    # -- the window -------------------------------------------------------------

    def _call(self, i: int, rng: np.random.RandomState) -> float:
        """Call ``i`` of the window; returns its wall seconds."""
        slot = i if i < self.keep else rng.randint(i + 1)
        self._cur = {} if slot < self.keep else None
        batch = self.batches[i % len(self.batches)]
        t0 = time.perf_counter()
        texts = self.tr.transcribe_pcm_batch(batch)
        dt = time.perf_counter() - t0
        self.attempted += len(batch)
        self.failed += sum(1 for t in texts if not t)
        if self._cur is not None:
            self._cur.update(batch=i % len(self.batches), texts=texts)
            if slot < len(self.sample):
                self.sample[slot] = self._cur
            else:
                self.sample.append(self._cur)
            self._cur = None
        return dt

    def window(self, trace: bool) -> None:
        rng = np.random.RandomState((self.seed + 1) % (2 ** 32 - 1))
        calls: List[float] = []
        audio = 0.0
        t0 = time.perf_counter()
        i = 0
        with GcWatch() as gcw:
            while True:
                calls.append(self._call(i, rng))
                audio += self.audio[i % len(self.batches)]
                i += 1
                if time.perf_counter() - t0 >= self.seconds:
                    break
        wall = time.perf_counter() - t0
        gcw.report(wall)
        model = self.cell.config["model"]
        per_frame = roofline.am_flops_per_frame(model["family"], model["args"])
        frames = sum(self._out_frames(p.shape[0]) for j in range(i)
                     for p in self.batches[j % len(self.batches)])
        self.record.update(calls=calls, audio_s=audio, wall_s=wall,
                           am_flops=per_frame * frames, on_card=self.device.type == "cuda")

    @staticmethod
    def _out_frames(samples: int) -> int:
        return -(-rfront.Mfcc().num_frames(samples) // 3)

    def end_to_end(self) -> Dict[str, float]:
        calls = np.asarray(self.record["calls"])
        return {"batch_xrt": self.record["audio_s"] / self.record["wall_s"],
                "batch_call_p95_ms": float(np.percentile(calls, 95) * 1e3)}

    # -- traced extras ----------------------------------------------------------

    def trace_extras(self) -> None:
        import torch

        from rhasspy_speech_torch.ops.mfcc_cuda import mfcc_batch
        from rhasspy_speech_torch.ops.viterbi_cuda import viterbi_decode

        self.hooks.undo()
        if self.device.type != "cuda":
            # no device to trace: nothing is read under a device metric's name
            self.record.update(busy_s=None, window_s=None)
            self.breakdown = {"device_ops": [], "idle_gaps": []}
            self._tap()
            return
        spans = hooks.Hooks()
        for attr, name in SPAN_STAGES:
            spans.span(self.tr, attr, name)
        for attr, name in AM_STAGES:
            spans.span(self.tr.am, attr, name)
        spans.span(self.ptr, "extract_ivectors", "ivector")
        names = [n for _a, n in SPAN_STAGES + AM_STAGES] + ["ivector", "call"]
        k1_before, k2_before = mfcc_batch.launches, viterbi_decode.launches
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0, i = time.perf_counter(), 0
            while time.perf_counter() - t0 < PROFILED_SECONDS:
                with torch.profiler.record_function("call"):
                    self.tr.transcribe_pcm_batch(self.batches[i % len(self.batches)])
                i += 1
            torch.cuda.synchronize(self.device)
        spans.undo()
        k1_n, k2_n = mfcc_batch.launches - k1_before, viterbi_decode.launches - k2_before
        dev, by_name, host = htrace.profiler_intervals(prof, names)
        calls = [iv for n, iv in host if n == "call"]
        lo, hi = min(s for s, _ in calls), max(e for _, e in calls)

        # K1 and K2 alone, at a kept call's shapes
        kept = self.sample[0]
        batch = self.batches[kept["batch"]]
        S = max(max(p.shape[0] for p in batch), 400)
        pcm = np.zeros((len(batch), S), np.float32)
        for j, p in enumerate(batch):
            pcm[j, : p.shape[0]] = p
        pcm_t = torch.as_tensor(pcm, device=self.device)
        fp = self.tr.am.frontend_params
        k1_ms = timing.device_ms(lambda: mfcc_batch(fp, pcm_t))
        lp = kept["log_probs"]
        lengths = [self._out_frames(p.shape[0]) for p in batch]
        len_t = torch.as_tensor(lengths, dtype=torch.int32, device=self.device)
        k2_ms = timing.device_ms(lambda: viterbi_decode(self.tr.device_graph, lp, lengths=len_t))
        cfg = rfront.Mfcc()
        T = cfg.num_frames(S)
        _w, mel, _d, _l = rfront.tables(cfg)
        k1_bound, _ = roofline.bound(*roofline.mfcc_work(
            cfg.padded, cfg.frame_length, cfg.num_mel_bins, cfg.num_ceps,
            roofline.mel_terms(mel), len(batch), S, T))
        g = self.graph
        k2_bound, _ = roofline.bound(*roofline.viterbi_work(
            g.arc_src, g.arc_dst, g.arc_pdf, g.num_states, len(batch), lp.shape[1],
            lp.shape[2], lengths))

        # the device's work inside the segment; what the profiler did not
        # see is added as launches x device time
        device_ops = dict(by_name)
        busy = htrace.busy_seconds([(max(s, lo), min(e, hi)) for s, e in dev if e > lo and s < hi])
        for frag, label, n, ms in (("mfcc", "K1 mfcc_kernel (device_ms x launches)", k1_n, k1_ms),
                                   ("viterbi", "K2 viterbi_kernel (device_ms x launches)",
                                    k2_n, k2_ms)):
            if htrace.seen(by_name, frag) is None:
                device_ops[label] = n * ms * 1e-3
                busy += n * ms * 1e-3
        print(f"trace: the profiler saw K1 {htrace.seen(by_name, 'mfcc') is not None}, "
              f"K2 {htrace.seen(by_name, 'viterbi') is not None}; {k1_n} and {k2_n} launches "
              f"in the segment; K1 {k1_ms:.4f} ms, K2 {k2_ms:.4f} ms alone", file=sys.stderr)
        window = hi - lo
        if busy > window:
            raise RuntimeError(f"device busy {busy!r} s over a {window!r} s segment: the "
                               "launches x device time added for K1/K2 count too much")
        self.record.update(
            busy_s=busy, window_s=window, k1_ms=k1_ms, k2_ms=k2_ms,
            k1_bound_ms=k1_bound, k2_bound_ms=k2_bound)
        self.breakdown = {"device_ops": htrace.top(device_ops),
                          "idle_gaps": htrace.idle_gaps(dev, host, lo, hi)}
        self._tap()

    # -- after the window -------------------------------------------------------

    def release(self) -> None:
        self.hooks.undo()
        self.tr = None

    def check(self) -> List:
        import torch

        from benchmark.harness.main import Check

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        model = self.cell.config["model"]
        args = model["args"]
        wseed = hmodel.weight_seed(self.seed)
        family = nets.load(model["family"])
        net = family.weights(args, wseed)
        ex = rivec.make_extractor(weights.extractor(
            wseed, args["num_ceps"], args["ivector_dim"], args["ubm_gauss"]), self.device)
        mf = rfront.Mfcc()
        iv_gaps: List[float] = []
        lp_gaps: List[float] = []
        cost_gap = 0.0
        faults = 0
        for kept in self.sample:
            batch = self.batches[kept["batch"]]
            B = len(batch)
            S = max(max(p.shape[0] for p in batch), mf.frame_length)
            pcm = torch.zeros((B, S), dtype=torch.float64, device=self.device)
            for j, p in enumerate(batch):
                pcm[j, : p.shape[0]] = torch.as_tensor(p, device=self.device)
            with torch.no_grad():
                feats = rfront.mfcc(mf, pcm)
                T = feats.shape[1]
                n_frames = torch.as_tensor([mf.num_frames(p.shape[0]) for p in batch],
                                           device=self.device)
                n_out = [self._out_frames(p.shape[0]) for p in batch]
                ivec = rivec.utterance_ivectors(ex, feats, n_frames)
                N = max(n_out)
                lo, hi = family.window(args, N)
                idx = torch.arange(lo, hi, device=self.device).clamp(0, T - 1)
                lp, _ = family.forward(net, feats[:, idx], ivec,
                                       family.zero_state(net, B, feats), N)
                best = rdecode.best_costs(self.graph, lp, torch.as_tensor(n_out, device=self.device))
            iv_p = kept["ivec"].double()
            iv_gaps += ((iv_p - ivec).abs().amax(1) / ivec.abs().amax(1)).tolist()
            lp_p = kept["log_probs"]
            trace, final_state, cost = kept["decode"]
            lp_np = lp.cpu().numpy()
            best_np = best.cpu().numpy()
            for b in range(B):
                n = n_out[b]
                lp_gaps.append(float((lp_p[b, :n].double() - lp[b, :n]).abs().max()))
                text = kept["texts"][b]
                if not math.isfinite(best_np[b]):
                    if text:
                        faults += 1
                        print(f"fault: call {kept['batch']} row {b}: {text} where the "
                              "reference has no path", file=sys.stderr)
                    continue
                c_path, words = rdecode.judge_path(self.graph, trace[b, :n].astype(np.int64),
                                                   int(final_state[b]), lp_np[b, :n])
                if c_path is None or text != [rdecode.transcript(self.graph, words)]:
                    faults += 1
                    print(f"fault: call {kept['batch']} row {b}: " + (
                        "its path is no path of the graph" if c_path is None else
                        f"{text} but its path reads {rdecode.transcript(self.graph, words)!r}"),
                        file=sys.stderr)
                    continue
                cost_gap = max(cost_gap, abs(float(cost[b]) - best_np[b]) / n,
                               (c_path - best_np[b]) / n)
        print(f"widest: ivector_rel {max(iv_gaps)!r}, logprob_abs {max(lp_gaps)!r}",
              file=sys.stderr)
        # the i-vector's and log-likelihoods' gaps as the median over the
        # utterances of each one's largest: an utterance's widest gap jumps
        # where its top-5 Gaussian selection flips on a tie to rounding
        values = {"ivector_rel_median": float(np.median(iv_gaps)),
                  "logprob_abs_median": float(np.median(lp_gaps)), "cost_per_frame": cost_gap,
                  "answer_faults": float(faults)}
        return [Check(k, v, float(self.limits[k])) for k, v in values.items()]
