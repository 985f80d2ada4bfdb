"""The stream cells: ``StreamScheduler`` driven by an open loop of utterances
that arrive by a Poisson process and are spoken in real time
(``traffic/poisson_stream.py``).

The client is the plainest server loop: it admits every stream whose
arrival is due (``open_stream``; a refusal counts as failed), feeds every
push that is due by the wall clock (``feed``; ``finish`` with the last
push), calls ``step()``, and collects every finished stream's transcript
with ``poll(block=False)`` (then ``close``). It sleeps until the next
arrival or push is due only when ``step()`` decoded nothing and no
transcript is pending.

Arrivals start ``prefill_s`` before the window (set-up), so the number of
streams is steady inside it. Before them the set-up's heap is frozen
(``gc.freeze``), so that a full collection of Python's cyclic collector
inside the window walks only what serving made. A stream's latency runs
from when its last push and ``finish()`` were due to when ``poll``
returned its transcript;
``stream_final_p50_ms`` / ``stream_final_p95_ms`` are over every stream
whose audio ends inside the window. After the window no stream is
admitted, and the loop runs on (at most a minute) until each of those
streams has its transcript.

For the comparison the benchmark taps the scheduler (``harness/hooks.py``):
each finalized stream's packed row as the timed path landed it (its best
path, one arc a frame, its final state and its final cost), and the
feature rows each of its chunks found on hand when its i-vector window was
staged (on the host route, or handed to a device route's tick). That count
is the scheduler's own decision, taken under the arrival timing, and the
window's splice clamps at it, so the reference follows it (and checks it
against the readiness rule); everything else the reference derives from
the PCM alone.
"""

from __future__ import annotations

import gc
import math
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from benchmark.counts import roofline
from benchmark.harness import hooks, model as hmodel, trace as htrace
from benchmark.harness.gcwatch import GcWatch
from benchmark.reference import decode as rdecode, frontend as rfront, ivector as rivec, nets, weights

RATE = 16000
WAIT_AFTER_S = 60.0
TICK_LABEL = "tick body (upload + replay)"
STAT_COLS = 8  # a packed row's columns after its trace (final state, flags, costs)


@dataclass
class Utt:
    arrival: float
    pcm: np.ndarray
    sid: int = -1
    gen: int = -1
    pushed: int = 0
    refused: bool = False
    result: Optional[List[str]] = None
    error: Optional[str] = None
    t_result: float = math.nan
    pushes: int = 0
    push_samples: int = 0
    lags: List[float] = field(default_factory=list)

    @property
    def end(self) -> float:
        """When the last push and ``finish()`` are due."""
        return self.arrival + self.pcm.shape[0] / RATE

    def due(self, k: int) -> float:
        return self.arrival + min((k + 1) * self.push_samples, self.pcm.shape[0]) / RATE


class Driver:
    def __init__(self, cell, seed: int, seconds: float, device, control: Optional[str], workdir):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.device, self.control, self.workdir = device, control, workdir
        self.params = cell.traffic
        self.limits = cell.workload["check"]["limits"]
        self.keep = int(cell.workload["check"]["sample_streams"])
        self.chunk_out = int(self.params["chunk_out_frames"])
        self.chunk_in = self.chunk_out * nets.SUBSAMPLING
        self.record: Dict = {}
        self.breakdown = None
        self.attempted = self.failed = 0
        self.hooks = hooks.Hooks()
        self.rows: Dict = {}  # (sid, gen) -> (trace row, stat columns)
        self.haves: Dict = {}  # (sid, gen) -> {chunk t0: feature rows on hand}
        self.trace = False

    # -- set-up ---------------------------------------------------------------

    def setup(self) -> None:
        import torch

        steps = hmodel.Steps()
        self.model_dir, self.graph_dir = hmodel.build(self.cell.config, self.seed, self.workdir,
                                                      steps)
        self.graph = rdecode.Graph(self.graph_dir)
        hmodel.check_graph(self.cell.config, self.graph)
        steps.mark("graph check")
        P = int(self.params["push_samples"])
        self.utts = [Utt(a, pcm, pushes=-(-pcm.shape[0] // P), push_samples=P)
                     for a, pcm in self.cell.generator().make(self.params, self.seed, self.seconds)]
        if self.control == "tf32":
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
        steps.mark("traffic")
        from rhasspy_speech_torch.pipeline.scheduler import StreamScheduler

        self.sched = StreamScheduler(
            self.model_dir, self.graph_dir, max_streams=int(self.params["slots"]),
            compute_dtype=self.cell.config["compute_dtype"], wire="i16",
            chunk_out_frames=self.chunk_out, device=self.device)
        steps.mark("scheduler")
        self.sched.warmup(seconds=float(self.params["max_s"]))
        steps.mark("warm-up")
        self._tap()
        # The set-up's heap (model, grammar, captured ticks, traffic) goes
        # into the permanent generation, as a server freezes its start-up
        # heap: a full collection while streams are served then walks only
        # what serving made, instead of stalling the loop for 0.1-0.3 s
        gc.collect()
        gc.freeze()
        self.next = 0
        self.feeding: List[Utt] = []
        self.awaiting: List[Utt] = []
        self.t0 = time.perf_counter() + float(self.params["prefill_s"])
        self._loop(until=0.0, admit=True)
        steps.mark("arrivals before the window")
        steps.report()

    def _tap(self) -> None:
        sched = self.sched

        def harvest(orig):
            def wrapper(block=True):
                pending = list(sched._pending_finalize)
                orig(block=block)
                left = {id(e) for e in sched._pending_finalize}
                for entry in pending:
                    if id(entry) in left:
                        continue
                    group, gens, frames, fetch = entry
                    packed = fetch.get(block=False)
                    F = packed.shape[1] - STAT_COLS
                    for sid, gen, n in zip(group, gens, frames):
                        self.rows[(sid, gen)] = (packed[sid, :n].copy(), packed[sid, F:].copy())
            return wrapper

        def keep(sid, t0, have):
            self.haves.setdefault((sid, sched.slots[sid].gen), {})[int(t0)] = int(have)

        def stage(orig):  # the host route stages each chunk's window
            def wrapper(sid, t0, have, *rest):
                keep(sid, t0, have)
                return orig(sid, t0, have, *rest)
            return wrapper

        def route(orig):  # the device routes take every slot's chunk at once
            def wrapper(first, n_valid, chunk_t0, chunk_have, *rest):
                for sid in np.flatnonzero(np.asarray(n_valid) > 0):
                    keep(int(sid), chunk_t0[sid], chunk_have[sid])
                return orig(first, n_valid, chunk_t0, chunk_have, *rest)
            return wrapper

        self.hooks.wrap(sched, "_harvest_finalizes", harvest)
        self.hooks.wrap(sched, "_stage_ivector_stats", stage)
        self.hooks.wrap(sched, "_step_fused", route)
        self.hooks.wrap(sched, "_step_chunk", route)

    # -- the client loop ---------------------------------------------------------

    def clock(self) -> float:
        return time.perf_counter() - self.t0

    def _loop(self, until: float, admit: bool, done=None) -> None:
        sched = self.sched
        rec = self.record
        while True:
            now = self.clock()
            if now >= until or (done is not None and done()):
                return
            while admit and self.next < len(self.utts) and self.utts[self.next].arrival <= now:
                u = self.utts[self.next]
                self.next += 1
                sid = sched.open_stream()
                if sid < 0:
                    u.refused = True
                    continue
                u.sid, u.gen = sid, sched.slots[sid].gen
                self.feeding.append(u)
            still = []
            for u in self.feeding:
                while u.pushed < u.pushes and u.due(u.pushed) <= now:
                    P = u.push_samples
                    sched.feed(u.sid, u.pcm[u.pushed * P:(u.pushed + 1) * P])
                    u.lags.append(now - u.due(u.pushed))
                    u.pushed += 1
                if u.pushed == u.pushes:
                    sched.finish(u.sid)
                    self.awaiting.append(u)
                else:
                    still.append(u)
            self.feeding = still
            if self.trace:
                frames0 = sum(s.out_frames for s in sched.slots)
                h0 = time.perf_counter()
                lanes = sched.step()
                h1 = time.perf_counter()
                if lanes:
                    rec["step_host_s"] += h1 - h0
                    rec["ticks"] += 1
                    rec["lanes"] += lanes
                    rec["frames"] += sum(s.out_frames for s in sched.slots) - frames0
                rec["host_spans"].append(("step()" if lanes else "step() idle", (h0, h1)))
            else:
                lanes = sched.step()
            waiting = []
            for u in self.awaiting:
                res = sched.poll(u.sid, block=False)
                if res is None:
                    waiting.append(u)
                    continue
                u.t_result = self.clock()
                u.result, u.error = res, sched.error(u.sid)
                sched.close(u.sid)
            self.awaiting = waiting
            if lanes == 0 and not self.awaiting:
                nxt = [u.due(u.pushed) for u in self.feeding]
                if admit and self.next < len(self.utts):
                    nxt.append(self.utts[self.next].arrival)
                wake = min(nxt + [until])
                pause = wake - self.clock()
                if pause > 0:
                    s0 = time.perf_counter()
                    time.sleep(pause)
                    if self.trace:
                        rec["host_spans"].append(("client sleep", (s0, time.perf_counter())))

    # -- the window -------------------------------------------------------------

    def window(self, trace: bool) -> None:
        import torch

        self.trace = trace
        rec = self.record
        rec.update(step_host_s=0.0, ticks=0, lanes=0, frames=0, host_spans=[], dev=[])
        timed = trace and self.device.type == "cuda"
        if timed:
            self._time_device()
        w0 = self.clock()
        with GcWatch() as gcw:
            self._loop(until=self.seconds, admit=True)
        w1 = self.clock()
        gcw.report(w1 - w0)
        if timed:
            torch.cuda.synchronize(self.device)
        self.trace = False
        rec.update(window_s=w1 - w0, bounds=(w0, w1), slots=self.sched.max_streams)
        inside = [u for u in self.utts[: self.next] if 0.0 <= u.end < self.seconds]
        self.inside = inside
        self._loop(until=self.seconds + WAIT_AFTER_S, admit=False,
                   done=lambda: all(u.refused or u.result is not None for u in inside))
        self.attempted = len(inside)
        self.failed = sum(1 for u in inside if u.refused or not u.result or u.error)
        lat = [u.t_result - u.end for u in inside if u.result]
        rec["latency_s"] = lat
        lags = [lag for u in self.utts[: self.next] for lag in u.lags]
        rec["feed_lag_p99_ms"] = float(np.percentile(lags, 99) * 1e3) if lags else math.nan
        rec["concurrency_mean"] = self._concurrency()
        refused = sum(1 for u in self.utts[: self.next] if u.refused)
        print(f"stream: rate {self.params['rate_per_s']}/s, {len(inside)} streams ended in the "
              f"window, {refused} refused of {self.next} arrived, {self.failed} failed, "
              f"concurrency {rec['concurrency_mean']:.1f}, feed lag p99 "
              f"{rec['feed_lag_p99_ms']:.2f} ms", file=sys.stderr)

    def _concurrency(self) -> float:
        """Mean streams open over the window (each from arrival to result)."""
        total = 0.0
        for u in self.utts[: self.next]:
            if u.refused:
                continue
            stop = u.t_result if u.result is not None else self.seconds
            total += max(0.0, min(stop, self.seconds) - max(u.arrival, 0.0))
        return total / self.seconds

    def _time_device(self) -> None:
        """CUDA events around each tick's device program (its upload and the
        replay of the captured body) and around each host-featurizer MFCC
        call, placed on the host clock from one event recorded after a
        synchronize."""
        import torch

        sched = self.sched
        dev = self.record["dev"]
        torch.cuda.synchronize(self.device)
        base = torch.cuda.Event(enable_timing=True)
        base.record()
        self.record["base"] = (base, time.perf_counter())

        def timed(label):
            def make(orig):
                def wrapper(*a, **k):
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    e0.record()
                    out = orig(*a, **k)
                    e1.record()
                    dev.append((label, e0, e1))
                    return out
                return wrapper
            return make

        self.timing_hooks = hooks.Hooks()
        self.timing_hooks.wrap(sched._runner, "run", timed(TICK_LABEL))
        self.timing_hooks.wrap(sched, "_features", timed("host featurizer (upload, K1, download)"))

    def end_to_end(self) -> Dict[str, float]:
        lat = np.asarray(self.record["latency_s"]) * 1e3
        if lat.size == 0:
            return {"stream_final_p95_ms": math.nan, "stream_final_p50_ms": math.nan}
        return {"stream_final_p95_ms": float(np.percentile(lat, 95)),
                "stream_final_p50_ms": float(np.percentile(lat, 50))}

    # -- traced extras ----------------------------------------------------------

    def trace_extras(self) -> None:
        rec = self.record
        cfg = self.cell.config
        rec["frame_flops"] = roofline.am_flops_per_frame(cfg["model"]["family"],
                                                         cfg["model"]["args"])
        if self.device.type != "cuda":
            rec.update(busy_s=None, window_s=None)
            self.breakdown = {"device_ops": [], "idle_gaps": []}
            return
        self.timing_hooks.undo()
        base, host0 = rec.pop("base")
        intervals, by_label = [], {}
        self.replays = 0
        for label, e0, e1 in rec.pop("dev"):
            self.replays += label == TICK_LABEL
            s = host0 + base.elapsed_time(e0) * 1e-3
            e = host0 + base.elapsed_time(e1) * 1e-3
            intervals.append((s, e))
            by_label[label] = by_label.get(label, 0.0) + (e - s)
        rec["replay_s"] = by_label.get(TICK_LABEL, 0.0)
        rec["replays"] = self.replays
        lo, hi = (self.t0 + w for w in rec["bounds"])
        busy = htrace.busy_seconds([(max(s, lo), min(e, hi)) for s, e in intervals
                                    if e > lo and s < hi])
        rec["busy_s"] = busy
        self.breakdown = {"device_ops": htrace.top(by_label),
                          "idle_gaps": htrace.idle_gaps(intervals, rec["host_spans"], lo, hi)}
        rec["host_spans"] = None

    # -- after the window -------------------------------------------------------

    def release(self) -> None:
        self.hooks.undo()
        self.sched = None
        gc.unfreeze()

    def check(self) -> List:
        import torch

        from benchmark.harness.main import Check

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        done = [u for u in self.inside if u.result is not None and (u.sid, u.gen) in self.rows]
        self.reasons: List[str] = []
        lost = [u for u in self.inside if u.result and (u.sid, u.gen) not in self.rows]
        faults = len(lost)
        self.reasons += [f"stream {u.sid}/{u.gen}: a transcript with no landed row" for u in lost]
        rng = np.random.RandomState((self.seed + 2) % (2 ** 32 - 1))
        pick = [done[i] for i in rng.permutation(len(done))[: self.keep]]
        if done:
            longest = max(done, key=lambda u: u.pcm.shape[0])
            if longest not in pick:
                pick.append(longest)
        cost_gap, f = self._compare(pick)
        for r in self.reasons[:8]:
            print("fault:", r, file=sys.stderr)
        values = {"cost_per_frame": cost_gap, "answer_faults": float(faults + f)}
        return [Check(k, v, float(self.limits[k])) for k, v in values.items()]

    def _compare(self, pick: List[Utt]):
        import torch

        if not pick:
            return math.nan, 0
        dev = self.device
        model = self.cell.config["model"]
        args = model["args"]
        wseed = hmodel.weight_seed(self.seed)
        family = nets.load(model["family"])
        net = family.weights(args, wseed)
        lo, hi = family.window(args, self.chunk_out)
        C = self.chunk_in
        ex = rivec.make_extractor(weights.extractor(
            wseed, args["num_ceps"], args["ivector_dim"], args["ubm_gauss"]), dev)
        mf = rfront.Mfcc()
        faults = 0
        B = len(pick)
        with torch.no_grad():
            feats = [rfront.mfcc(mf, torch.as_tensor(u.pcm, device=dev)[None])[0] for u in pick]
            Ts = [f.shape[0] for f in feats]
            K = max(-(-T // C) for T in Ts)
            ivecs = torch.zeros((K, B, ex.U.shape[1]), dtype=torch.float64, device=dev)
            for b, (u, f) in enumerate(zip(pick, feats)):
                haves = self.haves.get((u.sid, u.gen), {})
                bad = self._ivectors(ex, f, haves, ivecs[:, b], C, hi)
                if bad:
                    faults += 1
                    self.reasons.append(f"stream {u.sid}/{u.gen}: rows on hand {bad} "
                                        f"break the readiness rule (T={f.shape[0]})")
            state = family.zero_state(net, B, feats[0])
            outs = []
            span = torch.arange(lo, hi, device=dev)
            for k in range(K):
                win = torch.stack([f[(k * C + span).clamp(0, T - 1)] for f, T in zip(feats, Ts)])
                out, state = family.forward(net, win, ivecs[k], state, self.chunk_out)
                outs.append(out)
            lp = torch.cat(outs, dim=1)  # [B, chunk_out K, P]
            n_out = torch.as_tensor([-(-T // 3) for T in Ts], device=dev)
            best = rdecode.best_costs(self.graph, lp, n_out).cpu().numpy()
        lp_np = lp.cpu().numpy()
        gap = 0.0
        for b, u in enumerate(pick):
            n = int(n_out[b])
            trace, stats = self.rows[(u.sid, u.gen)]
            why = None
            if trace.shape[0] != n:
                why = f"{trace.shape[0]} frames decoded, {n} due"
            elif stats[1] == 0 or (trace.astype(np.int64) - 2 < 0).any():
                if u.result or math.isfinite(best[b]):
                    why = f"no path reported (has_final {stats[1]}), reference best {best[b]}"
                else:
                    continue
            if why:
                faults += 1
                self.reasons.append(f"stream {u.sid}/{u.gen}: {why}")
                continue
            c_path, words = rdecode.judge_path(self.graph, trace.astype(np.int64) - 2,
                                               int(stats[0]), lp_np[b, :n])
            if c_path is None or u.result != [rdecode.transcript(self.graph, words)]:
                faults += 1
                self.reasons.append(f"stream {u.sid}/{u.gen}: " + (
                    "its path is no path of the graph" if c_path is None else
                    f"transcript {u.result} but its path reads "
                    f"{rdecode.transcript(self.graph, words)!r}"))
                continue
            bits = np.uint32(stats[4]) | (np.uint32(stats[5]) << np.uint32(16))
            c_port = float(np.array([bits], dtype=np.uint32).view(np.float32)[0])
            gap = max(gap, abs(c_port - best[b]) / n, (c_path - best[b]) / n)
        return gap, faults

    @staticmethod
    def _ivectors(ex, f, haves: Dict[int, int], out, C: int, hi: int) -> int:
        """Each chunk's i-vector into ``out`` [K, dim]: the solve over the
        statistics of the chunks before it, chunk j's frames being those of
        ``[C j, C j + C)`` below the rows on hand when it was staged, each
        spliced within those rows. Returns (start, rows on hand) of each
        chunk whose rows on hand break the scheduler's readiness rule: a
        chunk other than the last needs its AM window, ``hi`` rows past its
        start, or all the stream's rows once it has finished."""
        import torch

        T = f.shape[0]
        K = out.shape[0]
        last = torch.full((1,), T - 1, device=f.device)
        x_all, post_all = rivec.frame_posteriors(ex, f[None], last)
        gamma = torch.zeros((1, post_all.shape[-1]), dtype=f.dtype, device=f.device)
        X = torch.zeros((1, post_all.shape[-1], x_all.shape[-1]), dtype=f.dtype, device=f.device)
        bad = []
        chunks = -(-T // C)
        for k in range(K):
            out[k] = rivec.solve(ex, gamma, X)[0]
            if k >= chunks - 1:
                continue
            t0 = k * C
            have = haves.get(t0)
            if have is None or have > T or (have < t0 + hi and have != T):
                bad.append((t0, have))
                have = T if have is None else min(max(have, 1), T)
            x, post = x_all, post_all
            if have < t0 + C + rivec.SPLICE + 1:
                x, post = rivec.frame_posteriors(ex, f[None], torch.full_like(last, have - 1))
            end = min(t0 + C, have)
            p = post[:, t0:end]
            gamma = gamma + p.sum(1)
            X = X + torch.einsum("bti,btd->bid", p, x[:, t0:end])
        return bad
