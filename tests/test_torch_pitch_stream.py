"""Pitch on the port's streaming routes: both routes of the stream
scheduler, on the CPU. The single stream's check is in
tests/test_torch_pitch_stream_single.py, the featurizer's in
tests/test_torch_pitch_stream_featurizer.py and
tests/test_torch_pitch_stream_batched.py: with the suite on several workers
each part takes minutes, so each has a file.

- The scheduler's host route (forced) against its device route
  (``_pitch_device``, the pitch lane of the fused tick): at one push a tick
  the two routes see the same pitch windows, so the device feature ring's
  rows equal the host route's within atol 1e-4 (the same f32 arithmetic in
  a batch of another width); transcripts equal each other, the batch
  transcriber's and the spoken sentences, for nnet3 and for a GMM whose
  Gaussians read the pitch columns. A pitch stream with trailing silence
  and no ``finish()`` endpoints with ``EndpointConfig()`` on both routes
  (the port's counterpart of tests/test_stream_ivector.py::
  test_scheduler_pitch_with_device_endpointing). The JAX scheduler is not
  run: its compiles would cost tier-1 minutes.
- The device tick keeps its own pitch tables when the shared table cache
  evicts their entry.
"""

import numpy as np
import pytest

import torch

from rhasspy_speech_torch.const import LangSuffix
from rhasspy_speech_torch.ops import pitch as tp
from rhasspy_speech_torch.pipeline import Nnet3WavTranscriber
from rhasspy_speech_torch.pipeline import lang_dir_name
from rhasspy_speech_torch.pipeline import scheduler as sched_mod
from rhasspy_speech_torch.pipeline.endpoint import EndpointConfig
from rhasspy_speech_torch.pipeline.scheduler import StreamScheduler
from rhasspy_speech_torch.pipeline.train import train_model_sync
from rhasspy_speech_torch.testing import build_synthetic_profile, synthesize_sentence
from rhasspy_speech_torch.testing.synthetic import _silence_wave
from rhasspy_speech_torch.testing.feature_tolerance import (
    assert_mfcc_close,
    frames_of,
    mfcc_allowance,
)

from test_torch_scheduler import LEXICON, _gmm_with_pitch

PITCH_ATOL = 1e-3
ROUTE_ATOL = 1e-4
TEXTS = ["turn on the light", "never mind"]
SENTENCES = ["turn (on|off) [the] (light|fan) [never mind]", "never mind"]
PUSH = 2048


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while these tests run. They issue many small
    tensor ops (the pitch Viterbi's plain twin steps frame by frame); with
    the suite's workers each holding a thread a core, idle OpenMP threads
    spin against the busy ones and stretch each test tens of times over.
    The tests check the same values either way."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _allowance(cfg, pcm):
    """Both featurizers' MFCC rows against each other: rows are the frames
    of the whole PCM."""
    return mfcc_allowance(cfg, frames_of(cfg, pcm), sides=2)


def _check_rows(got, want, C, allow):
    assert got.shape == want.shape
    assert_mfcc_close(got[:, :C], want[:, :C], allow)
    np.testing.assert_allclose(got[:, C:], want[:, C:], atol=PITCH_ATOL)


def _train(root, profile):
    intents = {"language": "en", "intents": {"Main": {"data": [{"sentences": SENTENCES}]}}}
    train_model_sync("en", intents, root / "train", profile.model_dir,
                     lang_suffixes=[LangSuffix.GRAMMAR])
    return root / "train" / lang_dir_name(LangSuffix.GRAMMAR)


@pytest.fixture(scope="module")
def nnet3_pitch(tmp_path_factory):
    """An nnet3 pitch profile whose AM context covers the i-vector tap:
    the scheduler's fused route with the pitch lane."""
    root = tmp_path_factory.mktemp("torch_pitch_stream")
    profile = build_synthetic_profile(root / "model", LEXICON, with_ivector=True,
                                      with_pitch=True, with_context=True)
    graph_dir = _train(root, profile)
    pcms = [synthesize_sentence(profile, t, seed=60 + i) for i, t in enumerate(TEXTS)]
    return profile, graph_dir, pcms


@pytest.fixture(scope="module")
def gmm_pitch(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_pitch_gmm")
    profile = _gmm_with_pitch(root / "model")
    graph_dir = _train(root, profile)
    pcms = [synthesize_sentence(profile, t, seed=70 + i) for i, t in enumerate(TEXTS)]
    return profile, graph_dir, pcms


def _run_scheduler(sched, pcms, finish=True, ticks=300):
    """One push of PUSH samples a stream a tick; returns the transcripts
    and the slots."""
    sids = [sched.open_stream() for _ in pcms]
    offs = [0] * len(pcms)
    for _ in range(ticks):
        for i, sid in enumerate(sids):
            if offs[i] < pcms[i].shape[0]:
                sched.feed(sid, pcms[i][offs[i] : offs[i] + PUSH])
                offs[i] += PUSH
                if finish and offs[i] >= pcms[i].shape[0]:
                    sched.finish(sid)
        sched.step()
        if all(sched.poll(s, block=False) is not None for s in sids):
            break
    return [sched.poll(s) for s in sids], sids


def _host_scheduler(monkeypatch, *args, **kwargs):
    with monkeypatch.context() as m:
        m.setattr(sched_mod, "_BP_RING_MAX_ARC", -1)
        return StreamScheduler(*args, **kwargs)


@pytest.mark.parametrize("family", ["nnet3", "gmm"])
def test_scheduler_routes_agree(request, monkeypatch, family):
    profile, graph_dir, pcms = request.getfixturevalue(f"{family}_pitch")
    dev = StreamScheduler(profile.model_dir, graph_dir, max_streams=2, device="cpu",
                          pool_capacity_samples=16000 * 8)
    host = _host_scheduler(monkeypatch, profile.model_dir, graph_dir, max_streams=2,
                           device="cpu", pool_capacity_samples=16000 * 8)
    assert dev._device_feats and dev._pitch_device
    assert not host._device_bp and not host._pitch_device
    got, sids = _run_scheduler(dev, pcms)
    want, hsids = _run_scheduler(host, pcms)
    batch = Nnet3WavTranscriber(profile.model_dir, graph_dir, device="cpu").transcribe_pcm_batch(pcms)
    assert got == want == batch == [[t] for t in TEXTS]
    for sid, hsid in zip(sids, hsids):
        rows = host.slots[hsid].feats
        assert rows.shape[1] == dev._featurizer.feat_dim
        ring = dev._feats_ring[sid, : rows.shape[0]].numpy()
        np.testing.assert_allclose(ring, rows, atol=ROUTE_ATOL)
        assert int(dev._pitch_done[sid]) == rows.shape[0] == int(dev._feat_counts[sid])


def test_scheduler_pitch_endpointing_both_routes(nnet3_pitch, monkeypatch):
    """Trailing silence and no ``finish()``: the endpoint rules close
    each stream on both routes, to the spoken sentence."""
    profile, graph_dir, pcms = nnet3_pitch
    rng = np.random.RandomState(5)
    pcms = [np.concatenate([p, _silence_wave(16000 * 2, rng)]).astype(np.float32) for p in pcms]
    kw = dict(max_streams=2, device="cpu", endpointing=EndpointConfig())
    dev = StreamScheduler(profile.model_dir, graph_dir, **kw)
    host = _host_scheduler(monkeypatch, profile.model_dir, graph_dir, **kw)
    assert dev._pitch_device and dev._ep_device and not host._device_bp
    for sched in (dev, host):
        got, _sids = _run_scheduler(sched, pcms, finish=False, ticks=150)
        assert got == [[t] for t in TEXTS]


def test_tick_keeps_its_pitch_tables_past_cache_eviction(nnet3_pitch, monkeypatch):
    """The device tick holds its pitch lane's constant tables: after more
    batch lengths than the shared table cache keeps, they are the same
    tensor objects, and the tick's pitch lane reads those, not a new
    cache entry (a captured graph reads them by address)."""
    profile, graph_dir, pcms = nnet3_pitch
    sched = StreamScheduler(profile.model_dir, graph_dir, max_streams=2, device="cpu")
    tick = sched._tick
    cfg, Wp = tick.cfg.pitch, tick.cfg.pitch_window
    held = dict(tick.pitch_tables)
    cpu = torch.device("cpu")
    for n in range(Wp + 1, Wp + 2 + tp.pitch_tables.cache_info().maxsize):
        tp.pitch_tables(cfg, n, cpu)
    assert tp.pitch_tables(cfg, Wp, cpu) is not tick.pitch_tables  # evicted, made anew
    assert all(tick.pitch_tables[k] is v for k, v in held.items())
    seen = []
    real = tp.pitch_local

    def spy(cfg_, pcm, tab=None):
        seen.append(tab)
        return real(cfg_, pcm, tab)

    monkeypatch.setattr(tp, "pitch_local", spy)
    got, _sids = _run_scheduler(sched, pcms[:1])
    assert got == [[TEXTS[0]]]
    assert seen and all(tab is tick.pitch_tables for tab in seen)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the captured tick runs on the card)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_captured_pitch_tick_on_the_card(nnet3_pitch, cuda):
    """On the card the pitch lane runs inside the captured tick: at most
    one launch of each kernel a tick (K5 included), every replay bit-equal
    to the body run eagerly on copies of its inputs, the CPU run's
    transcripts."""
    profile, graph_dir, pcms = nnet3_pitch
    card = StreamScheduler(profile.model_dir, graph_dir, max_streams=2, device=cuda)
    assert card._pitch_device
    per_tick, last = [], card.kernel_launches
    sids = [card.open_stream() for _ in pcms]
    offs = [0] * len(pcms)
    for _ in range(300):
        for i, sid in enumerate(sids):
            if offs[i] < pcms[i].shape[0]:
                card.feed(sid, pcms[i][offs[i] : offs[i] + PUSH])
                offs[i] += PUSH
                if offs[i] >= pcms[i].shape[0]:
                    card.finish(sid)
        card._runner.check_next = True
        card.step()
        now = card.kernel_launches
        per_tick.append({k: now[k] - last[k] for k in now})
        last = now
        if all(card.poll(s, block=False) is not None for s in sids):
            break
    cpu = StreamScheduler(profile.model_dir, graph_dir, max_streams=2, device="cpu")
    want, _sids = _run_scheduler(cpu, pcms)
    assert [card.poll(s) for s in sids] == want == [[t] for t in TEXTS]
    # each kernel at most once a tick (the stamps, one a stamp the body takes)
    assert all(max(v for k, v in t.items() if k != "tick_stamp") <= 1 for t in per_tick)
    assert all(v > 0 for v in card.kernel_launches.values())
    assert card._runner.checks and all(all(eq.values()) for _key, eq in card._runner.checks)
