"""A recurrent nnet3 model on the port's stream scheduler, both routes,
against the JAX package, on the CPU.

The profile of tests/test_torch_recurrent_routes.py (the synthetic profile
with ``recurrent_delay=3``, an i-vector extractor, an AM context over the
tap and its CMVN stats: the device route unless forced onto the host
route). The scheduler's per-lane recurrence rows must follow the JAX
scheduler's tick for tick on both routes (rtol / atol 1e-4, f32 sums in
other orders), with transcripts equal to the JAX scheduler's and the
spoken sentences; a reopened lane must start from zero: after its first
tick its rows equal a fresh scheduler's, and a lane never opened keeps
zero rows. The device route's rows follow the JAX scheduler's too at 32
slots with 1, 8 and 9 staggered streams, where the port's AM runs over 8-
and 16-row lane buckets. On the card the captured tick carries the rows as
the CPU run does.
"""

import numpy as np
import pytest

from rhasspy_speech_tpu.pipeline.scheduler import StreamScheduler as JaxScheduler

import torch

from rhasspy_speech_torch.pipeline import scheduler as sched_mod
from rhasspy_speech_torch.pipeline.scheduler import StreamScheduler

from test_torch_recurrent_routes import TEXTS, trained  # noqa: F401 (the module's fixture)
from test_torch_scheduler import STAGGER_SLOTS, STAGGERED, _feed_interleaved, _feed_staggered

ROW_TOL = dict(rtol=1e-4, atol=1e-4)
ROUTES = ("host", "device")


def _rows(s):
    return s._st.rec if s._device_bp else s._am_state


def _force(route, monkeypatch):
    if route == "host":
        monkeypatch.setattr(sched_mod, "_BP_RING_MAX_ARC", -1)


@pytest.mark.parametrize("route", ROUTES)
def test_scheduler_rows_follow_jax(trained, monkeypatch, route):
    profile, graph_dir, pcms = trained
    _force(route, monkeypatch)
    port = StreamScheduler(profile.model_dir, graph_dir, max_streams=4, device="cpu")
    assert port._recurrent and port._device_bp == (route == "device")
    jax_sched = JaxScheduler(profile.model_dir, graph_dir, max_streams=4)
    assert jax_sched._recurrent
    ticks = []

    def compare():
        rows, jrows = _rows(port), jax_sched._am_state
        assert set(rows) == set(jrows) == {"rec.b"}
        for k in rows:
            np.testing.assert_allclose(rows[k].numpy(), np.asarray(jrows[k]), **ROW_TOL)
        # the fourth lane is never opened: its rows stay zero
        assert not rows["rec.b"][3].any()
        ticks.append(bool(rows["rec.b"].any()))

    got, want = _feed_interleaved([port, jax_sched], pcms, on_tick=compare)
    assert got == want == [[t] for t in TEXTS]
    assert len(ticks) > 10 and any(ticks)


@pytest.mark.parametrize("streams", STAGGERED)
def test_lane_buckets_rows_follow_jax(trained, streams):
    """The device route at 32 slots with ``streams`` staggered streams
    (tests/test_torch_scheduler.py: ``_feed_staggered``): the port's AM
    continues each lane's rows over 8- and 16-row lane buckets, the JAX
    scheduler's over every slot. After every tick the rows follow the JAX
    scheduler's and the slots never opened keep zero rows; the transcripts
    equal the JAX scheduler's and the spoken sentences."""
    profile, graph_dir, pcms = trained
    pcms = [pcms[i % len(pcms)] for i in range(streams)]
    port = StreamScheduler(profile.model_dir, graph_dir, max_streams=STAGGER_SLOTS, device="cpu")
    assert port._recurrent and port._device_bp
    jax_sched = JaxScheduler(profile.model_dir, graph_dir, max_streams=STAGGER_SLOTS)
    ticks = []

    def compare():
        rows, jrows = _rows(port), jax_sched._am_state
        for k in rows:
            np.testing.assert_allclose(rows[k].numpy(), np.asarray(jrows[k]), **ROW_TOL)
            assert not rows[k][streams:].any()
        ticks.append(bool(rows["rec.b"].any()))

    (got, want), buckets = _feed_staggered([port, jax_sched], pcms, on_tick=compare)
    assert got == want == [[TEXTS[i % len(TEXTS)]] for i in range(streams)]
    assert buckets == ({8, 16} if streams > 8 else {8})
    assert len(ticks) > 5 and any(ticks)


@pytest.mark.parametrize("route", ROUTES)
def test_reopened_lane_starts_from_zero(trained, monkeypatch, route):
    """A slot whose first stream left non-zero rows is closed and reopened:
    after the new stream's first decoding tick its rows equal those of a
    fresh scheduler's slot after the same tick, and its transcript is the
    spoken sentence."""
    profile, graph_dir, pcms = trained
    _force(route, monkeypatch)

    def first_tick_rows(s, sid, pcm):
        s.feed(sid, pcm)
        s.finish(sid)
        while not s.slots[sid].out_frames:
            s.step()
        return {k: v[sid].clone() for k, v in _rows(s).items()}

    def finish(s, sid):
        for _ in range(200):
            if s.poll(sid) is not None:
                break
            s.step()
        return s.poll(sid)

    s = StreamScheduler(profile.model_dir, graph_dir, max_streams=2, device="cpu")
    a = s.open_stream()
    first_tick_rows(s, a, pcms[0])
    assert finish(s, a) == [TEXTS[0]]
    assert _rows(s)["rec.b"][a].abs().max() > 0
    s.close(a)
    assert s.open_stream() == a
    got = first_tick_rows(s, a, pcms[2])
    fresh = StreamScheduler(profile.model_dir, graph_dir, max_streams=2, device="cpu")
    want = first_tick_rows(fresh, fresh.open_stream(), pcms[2])
    for k in want:
        assert torch.equal(got[k], want[k])
    assert finish(s, a) == [TEXTS[2]]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the captured tick runs only on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_captured_tick_carries_rows_like_the_cpu(trained, cuda):
    """On the card the device route's tick is a captured CUDA graph: every
    replay is bit-equal to the eager body on copies of its state (the
    recurrence rows among it), and the transcripts and final rows equal the
    CPU run's."""
    profile, graph_dir, pcms = trained
    runs = {}
    for dev in ("cpu", cuda):
        s = StreamScheduler(profile.model_dir, graph_dir, max_streams=4, device=dev)
        assert s._device_bp and s._device_feats and s._recurrent

        def check_next(s=s):
            s._runner.check_next = True

        texts = _feed_interleaved([s], pcms, on_tick=check_next)[0]
        runs[str(dev)] = (texts, {k: v.cpu() for k, v in s._st.rec.items()}, s._runner.checks)
    (cpu_texts, cpu_rows, _), (texts, rows, checks) = runs["cpu"], runs[str(cuda)]
    assert texts == cpu_texts == [[t] for t in TEXTS]
    assert checks and all(all(eq.values()) for _key, eq in checks)
    assert any(name.startswith("rec.") for name in checks[0][1])
    for k in cpu_rows:
        np.testing.assert_allclose(rows[k].numpy(), cpu_rows[k].numpy(), **ROW_TOL)
