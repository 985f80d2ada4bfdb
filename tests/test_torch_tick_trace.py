"""The stream scheduler's own trace (``utils/metrics.py``): its tick
records with the body's device stamps (``pipeline/device_tick.py``), its
stream records from ``finish()`` to the transcript, on the fused device
route and on the host feature route (``snip_edges=false``, the chunk body).

On the CPU the bodies run eagerly and stamp the host's clock. On the card
(``cuda``) a captured tick's stamps increase and span no more than a
replay timed by CUDA events. This file imports no JAX, so its card test
runs where the port does.
"""

import json
import time

import numpy as np
import pytest
import torch

from rhasspy_speech_torch.examples._common import train_sentences
from rhasspy_speech_torch.examples.serve_streams import LEXICON, SENTENCES, UTTERANCES
from rhasspy_speech_torch.ops.tick_stamp_cuda import calibrate
from rhasspy_speech_torch.pipeline import scheduler as sched_mod
from rhasspy_speech_torch.pipeline.device_tick import STAMPS, STAMPS_TAKEN
from rhasspy_speech_torch.pipeline.scheduler import StreamScheduler
from rhasspy_speech_torch.testing import build_synthetic_profile, synthesize_sentence
from rhasspy_speech_torch.utils.metrics import (
    TICK_STAGES,
    finalize_means,
    get_metrics,
    tick_means,
)

PUSH = 1024
SLOTS = 4
STAGGER = 3  # stream i starts at round 3 i: finishes fall on different ticks


def _trained(root, snip_edges=True):
    profile = build_synthetic_profile(root / "model", LEXICON, with_ivector=True,
                                      with_context=True, with_ivector_cmvn=True)
    if not snip_edges:  # centred frames: the features stay on the host
        fj = profile.model_dir / "model" / "frontend.json"
        cfg = json.loads(fj.read_text(encoding="utf-8"))
        fj.write_text(json.dumps({**cfg, "snip_edges": False}), encoding="utf-8")
    (graph_dir,) = train_sentences(profile.model_dir, root / "train", SENTENCES)
    texts = [UTTERANCES[i % len(UTTERANCES)] for i in range(SLOTS)]
    pcms = [synthesize_sentence(profile, t, seed=200 + i) for i, t in enumerate(texts)]
    return profile, graph_dir, texts, pcms


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    return _trained(tmp_path_factory.mktemp("torch_tick_trace"))


def _sched(trained, device="cpu", device_feats=True, **kw):
    profile, graph_dir, _texts, _pcms = trained
    s = StreamScheduler(profile.model_dir, graph_dir, max_streams=SLOTS, device=device, **kw)
    assert s._device_bp and s._device_feats == device_feats
    return s


def _serve(scheds, pcms, on_tick=None):
    """Each scheduler serves every PCM as the benchmark's client does: pushes
    of PUSH samples, ``finish()`` with the last, a ``step()`` a round and a
    non-blocking ``poll()`` after it, the stream closed once it has its
    transcript. Returns each scheduler's transcripts."""
    sids = [[s.open_stream() for _ in pcms] for s in scheds]
    assert min(min(row) for row in sids) >= 0
    pushes = [-(-p.shape[0] // PUSH) for p in pcms]
    results = [[None] * len(pcms) for _ in scheds]
    for r in range(400):
        for s, row, out in zip(scheds, sids, results):
            for i, (sid, pcm) in enumerate(zip(row, pcms)):
                k = r - STAGGER * i
                if 0 <= k < pushes[i]:
                    s.feed(sid, pcm[k * PUSH : (k + 1) * PUSH])
                    if k == pushes[i] - 1:
                        s.finish(sid)
            s.step()
            for i, sid in enumerate(row):
                if out[i] is None:
                    out[i] = s.poll(sid, block=False)
                    if out[i] is not None:
                        s.close(sid)
        if on_tick is not None:
            on_tick()
        if all(x is not None for out in results for x in out):
            return results
    raise AssertionError("a stream never got its transcript")


def _mine(s):
    m = get_metrics()
    return ([t for t in m.ticks if t.src == s._trace_src],
            [r for r in m.streams if r.src == s._trace_src])


@pytest.fixture(scope="module")
def served(trained):
    _profile, _graph_dir, texts, pcms = trained
    s = _sched(trained)
    (got,) = _serve([s], pcms)
    assert got == [[t] for t in texts]
    s.step()  # lands the last rows' stamps
    return s


def _check_stamps(ticks, error_s=None):
    """Each record's stamps: the ones its body takes, in order, after its
    issue and, run eagerly (``error_s`` None), inside its step; on the card
    (the body runs on past its step) after its issue within the clock's
    ``error_s``. None for a feed-only body."""
    for t in ticks:
        assert 0.0 <= t.wait_s <= t.t_return - t.t_enter
        if not STAMPS_TAKEN[t.key]:
            assert t.stamps is None, t
            continue
        assert t.stamps is not None and len(t.stamps) == STAMPS, t
        taken = [t.stamps[i] for i in STAMPS_TAKEN[t.key]]
        assert None not in taken and taken == sorted(taken), t
        assert all(t.stamps[i] is None for i in range(STAMPS) if i not in STAMPS_TAKEN[t.key])
        if error_s is None:
            assert t.t_enter <= t.t_issue <= taken[0] and taken[-1] <= t.t_return, t
        else:
            assert taken[0] >= t.t_issue - error_s, (t, error_s)


def test_each_tick_has_its_stamps_in_order(served):
    ticks, _streams = _mine(served)
    assert len(ticks) == served._ticks_issued and [t.tick for t in ticks] == list(range(len(ticks)))
    assert {t.key for t in ticks} >= {"fused", "feed"}
    _check_stamps(ticks)
    assert sum(t.lanes for t in ticks) > 0
    # a feed-only body downloads nothing: one download a body of another key
    assert served._runner.downloads == sum(1 for t in ticks if t.key != "feed")


def test_finalize_spans_tile_finish_to_transcript(served):
    _ticks, streams = _mine(served)
    assert len(streams) == SLOTS and all(r.complete for r in streams)
    for r in streams:
        flush, device, result = r.spans()
        assert min(flush, device, result) >= 0.0, r
        assert abs(flush + device + result - (r.t_result - r.t_finish)) <= 1e-9, r


def test_flush_tick_follows_finish(served):
    ticks, streams = _mine(served)
    by_index = {t.tick: t for t in ticks}
    for r in streams:
        assert r.tick_flush >= r.tick_finish >= 0, r
        flush = by_index[r.tick_flush]
        assert flush.t_issue == r.t_flush and flush.stamps[5] == r.s5
        assert flush.key in ("fused", "finalize")
    assert finalize_means(streams)["ticks"] >= 0


def test_summary_reports_the_splits(served):
    ticks, streams = _mine(served)
    means = tick_means(ticks)
    fused = means["fused"]
    assert fused["ticks"] > 0 and means["decoding_steps"] > 0 and "chunk" not in means
    # the stages tile the body, s0 -> s5
    assert sum(fused[k] for k in TICK_STAGES) == pytest.approx(fused["body"], abs=1e-3)
    fin = finalize_means(streams)
    assert fin["streams"] == SLOTS
    assert fin["flush"] + fin["device"] + fin["result"] == pytest.approx(fin["total"], abs=1e-3)
    summary = get_metrics().summary()
    assert summary["tick_ms"] and summary["finalize_ms"]
    assert {"stream_issue_fused", "stream_wait_pace", "stream_harvest"} <= set(summary["stages"])
    assert "stream_chunk" not in summary["stages"]


def test_stamps_stay_outside_the_checked_state(served):
    """A body run twice from copies of one state leaves equal states (what
    a replay is checked against) while its stamps move on."""
    s = served
    recorded = {}
    run = s._runner.run

    def recording(key, body, st, inputs):
        if key[0] == "fused":
            recorded.update(body=body, inputs=[x.clone() for x in inputs], st=st.clone())
        return run(key, body, st, inputs)

    s._runner.run = recording
    try:
        _serve([s], [np.ones(4 * PUSH, np.float32)])
    finally:
        s._runner.run = run
    a, b = recorded["st"].clone(), recorded["st"].clone()
    recorded["body"](a, *recorded["inputs"])
    first = s._tick.stamps.clone()
    recorded["body"](b, *recorded["inputs"])
    second = s._tick.stamps.clone()
    assert "stamps" not in a.tensors()
    assert all(torch.equal(x, b.tensors()[k]) for k, x in a.tensors().items())
    assert int(second[0]) >= int(first[5]) > int(first[0])


def test_two_schedulers_keep_their_own_records(trained):
    _profile, _graph_dir, texts, pcms = trained
    scheds = [_sched(trained), _sched(trained, chunk_out_frames=14)]
    assert scheds[0]._trace_src != scheds[1]._trace_src
    got = _serve(scheds, pcms)
    assert got == [[[t] for t in texts]] * 2
    for s in scheds:
        ticks, streams = _mine(s)
        assert len(ticks) == s._ticks_issued > 0
        assert sorted(r.sid for r in streams) == list(range(SLOTS))
        assert all(r.complete for r in streams)


def test_chunk_route_stamps_its_stages(tmp_path):
    """The host feature route: the chunk body takes s0 and s2 .. s5, and the
    summary splits it from s0 (no feed stage on the card)."""
    trained = _trained(tmp_path, snip_edges=False)
    _profile, _graph_dir, texts, pcms = trained
    s = _sched(trained, device_feats=False)
    assert _serve([s], pcms) == [[[t] for t in texts]]
    s.step()
    ticks, streams = _mine(s)
    assert {t.key for t in ticks} <= {"chunk", "finalize"} and any(t.key == "chunk" for t in ticks)
    _check_stamps(ticks)
    chunk = tick_means(ticks)["chunk"]
    assert chunk["ticks"] > 0 and "feed" not in chunk
    assert sum(chunk[k] for k in TICK_STAGES[1:]) == pytest.approx(chunk["body"], abs=1e-3)
    assert len(streams) == SLOTS and all(r.complete for r in streams)


def test_host_route_keeps_no_records(trained, monkeypatch):
    monkeypatch.setattr(sched_mod, "_BP_RING_MAX_ARC", -1)
    profile, graph_dir, texts, pcms = trained
    s = StreamScheduler(profile.model_dir, graph_dir, max_streams=SLOTS, device="cpu")
    assert not s._device_bp
    before = (len(get_metrics().ticks), len(get_metrics().streams))
    assert _serve([s], pcms) == [[[t] for t in texts]]
    assert (len(get_metrics().ticks), len(get_metrics().streams)) == before


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the captured tick stamps the card's clock)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_captured_tick_stamps_on_the_card(trained, cuda):
    """Each replay checked against the body run eagerly (stamps present);
    the landed stamps in order, after their body's issue on the host clock;
    and one replay's stamps span no more than its CUDA-event time."""
    _profile, _graph_dir, texts, pcms = trained
    s = _sched(trained, device=cuda)
    s.warmup(seconds=1.0)

    def check():
        s._runner.check_next = True

    (got,) = _serve([s], pcms, on_tick=check)
    assert got == [[t] for t in texts]
    runner = s._runner
    assert runner.checks and all(all(eq.values()) for _key, eq in runner.checks)
    s.step()
    torch.cuda.synchronize(cuda)
    s.step()
    ticks, streams = _mine(s)
    # one stamp launch a stamp taken, warm-up's ticks included
    assert runner.launches["tick_stamp"] == sum(len(STAMPS_TAKEN[t.key]) for t in ticks) > 0
    # 100 us of slack past the calibration's error
    _check_stamps(ticks, s._clock.error_s + 1e-4)
    fused = [t for t in ticks if t.key == "fused" and t.stamps is not None]
    assert fused and all(r.complete for r in streams)
    assert all(t.stamps[5] > t.stamps[0] for t in fused)
    key = next(k for k in runner.graphs if k[0] == "fused")
    graph = runner.graphs[key][0]
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.cuda.device(cuda):
        e0.record()
        graph.replay()
        e1.record()
    torch.cuda.synchronize(cuda)
    st = s._tick.stamps.cpu().tolist()
    assert st == sorted(st) and st[5] > st[0]
    # 2 us for the two clocks' resolution
    assert (st[5] - st[0]) * 1e-6 <= e0.elapsed_time(e1) + 2e-3
    # a calibration does not wait for the work queued on the card (~0.1 s)
    with torch.cuda.device(cuda):
        torch.cuda._sleep(200_000_000)
        t0 = time.perf_counter()
        clock = calibrate(cuda)
        took = time.perf_counter() - t0
        torch.cuda.synchronize(cuda)
    assert took < 0.02 and clock.error_s < 1e-3, (took, clock)
