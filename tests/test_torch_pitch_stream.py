"""Pitch on the port's streaming routes: the featurizer, the single stream
and both routes of the stream scheduler, on the CPU.

- The featurizer's rows (40 MFCC + 3 pitch columns) equal the JAX
  featurizer's push by push, over several chunkings of 2.5 s of a voiced
  signal (the sliding 2 s pitch window moves): the same row counts, the
  MFCC columns within ``testing/feature_tolerance.py``'s allowance for two
  f32 front ends (rtol 1e-4 / atol 2e-3, widened only on ill-conditioned
  frames), the pitch columns within atol 1e-3 (tests/test_torch_pitch.py's
  tolerance). The scheduler's batched path through the featurizer gives
  ``push``'s rows bit for bit.
- The single stream's transcript equals the JAX stream transcriber's and
  the spoken sentence on an nnet3 pitch profile, its rows within the same
  tolerances.
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

import types

import numpy as np
import pytest

from rhasspy_speech_tpu.ops import frontend as jfe
from rhasspy_speech_tpu.ops import pitch as jp
from rhasspy_speech_tpu.pipeline import streaming_features as jsf
from rhasspy_speech_tpu.pipeline.stream import Nnet3StreamTranscriber as JaxStreamTranscriber

import torch

from rhasspy_speech_torch.const import LangSuffix
from rhasspy_speech_torch.ops import frontend as tfe
from rhasspy_speech_torch.ops import pitch as tp
from rhasspy_speech_torch.ops.mfcc_cuda import mfcc_batch
from rhasspy_speech_torch.pipeline import Nnet3StreamTranscriber, Nnet3WavTranscriber
from rhasspy_speech_torch.pipeline import lang_dir_name
from rhasspy_speech_torch.pipeline import scheduler as sched_mod
from rhasspy_speech_torch.pipeline import streaming_features as tsf
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
CHUNKINGS = {
    "4000": [4000] * 10,
    "uneven": [160, 3360, 7, 4000, 1, 20000, 9000],
    "one_push": [40000],
}


def _voiced(n, seed=9):
    """A voiced signal whose f0 glides 110 -> 180 Hz, with harmonics and
    noise."""
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 16000.0
    f0 = 110.0 + 70.0 * t / t[-1]
    phase = 2 * np.pi * np.cumsum(f0) / 16000.0
    sig = 3000 * np.sin(phase) + 1500 * np.sin(2 * phase) + 800 * np.sin(3 * phase)
    return (sig + 200 * rng.randn(n)).astype(np.float32)


def _allowance(cfg, pcm):
    """Both featurizers' MFCC rows against each other: rows are the frames
    of the whole PCM."""
    return mfcc_allowance(cfg, frames_of(cfg, pcm), sides=2)


def _check_rows(got, want, C, allow):
    assert got.shape == want.shape
    assert_mfcc_close(got[:, :C], want[:, :C], allow)
    np.testing.assert_allclose(got[:, C:], want[:, C:], atol=PITCH_ATOL)


def _featurizers():
    cfg_j, cfg_t = jfe.FrontendConfig(), tfe.FrontendConfig()
    jam = types.SimpleNamespace(frontend_config=cfg_j, frontend_params=jfe.make_frontend_params(cfg_j),
                                pitch_config=jp.PitchConfig())
    tam = types.SimpleNamespace(frontend_config=cfg_t, device=torch.device("cpu"),
                                frontend_params=tfe.make_frontend_params(cfg_t, "cpu"),
                                pitch_config=tp.PitchConfig())
    return tsf.StreamFeaturizer(tam), jsf.StreamFeaturizer(jam)


@pytest.mark.parametrize("chunking", sorted(CHUNKINGS))
def test_featurizer_pitch_rows_equal_jax(chunking):
    pcm = _voiced(40000)
    tfz, jfz = _featurizers()
    assert tfz.has_pitch and tfz.feat_dim == 43 and tfz.pitch_window == jfz.pitch_window
    ts, js = tfz.new_state(), jfz.new_state()
    allow = _allowance(tfz.am.frontend_config, pcm)
    off, total = 0, 0
    for n in CHUNKINGS[chunking] + [None]:  # None: the flush
        chunk = pcm[off : off + n] if n is not None else np.zeros(0, np.float32)
        flush = n is None
        got, want = tfz.push(ts, chunk, flush=flush), jfz.push(js, chunk, flush=flush)
        _check_rows(got, want, 40, allow.rows(slice(total, total + got.shape[0])))
        assert ts.pitch_done == js.pitch_done and ts.total_samples == js.total_samples
        off += 0 if n is None else n
        total += got.shape[0]
    assert total == tfe.num_frames(tfz.am.frontend_config, off)


def test_batched_path_equals_push():
    """The scheduler's batched path (``prepare_mfcc_buf`` / ``commit_mfcc``
    and ``push_with_base`` for the MFCC rows, then ``pitch_window_array``,
    one pitch call, ``consume_pitch_rows`` and ``merge_pitch``, as
    ``_drain_pitch_all`` runs them) gives ``push``'s rows."""
    pcm = _voiced(24000, seed=3)
    tfz, _ = _featurizers()
    a, b = tfz.new_state(), tfz.new_state()
    got, want = [], []
    for off in range(0, pcm.shape[0], 3000):
        chunk = pcm[off : off + 3000]
        want.append(tfz.push(a, chunk))
        r = tfz.prepare_mfcc_buf(b, chunk)
        base = np.zeros((0, 40), np.float32)
        if r is not None:
            buf, k = r
            base = mfcc_batch(tfz.stream_params, torch.as_tensor(buf[None]))[0][:k].numpy()
            tfz.commit_mfcc(b, buf, k)
        got.append(tfz.push_with_base(b, chunk, base))
        window = tfz.pitch_window_array(b) if b.mfcc_pending.shape[0] else None
        if window is not None:
            rows = tp.pitch_batch(tfz.am.pitch_config, torch.as_tensor(window[None]))[0].numpy()
            got.append(tfz.merge_pitch(b, tfz.consume_pitch_rows(b, rows)))
    got.append(tfz.push(b, np.zeros(0, np.float32), flush=True))
    want.append(tfz.push(a, np.zeros(0, np.float32), flush=True))
    np.testing.assert_array_equal(np.concatenate(got), np.concatenate(want))


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


def test_single_stream_equals_jax(nnet3_pitch):
    profile, graph_dir, pcms = nnet3_pitch
    st = Nnet3StreamTranscriber(profile.model_dir, graph_dir, device="cpu")
    jst = JaxStreamTranscriber(profile.model_dir, graph_dir)
    state, jstate = st.start_stream(), jst.start_stream()
    for off in range(0, pcms[0].shape[0], 1024):
        st.process_chunk(state, pcms[0][off : off + 1024])
        jst.process_chunk(jstate, pcms[0][off : off + 1024])
    got, want = st.finish_stream(state), jst.finish_stream(jstate)
    assert got == want == [TEXTS[0]]
    C = st.am.frontend_config.num_ceps
    assert state.feats.shape[1] == C + 3
    allow = _allowance(st.am.frontend_config, pcms[0]).rows(slice(0, state.feats.shape[0]))
    _check_rows(state.feats, np.asarray(jstate.feats), C, allow)


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
    assert all(max(t.values()) <= 1 for t in per_tick)
    assert all(v > 0 for v in card.kernel_launches.values())
    assert card._runner.checks and all(all(eq.values()) for _key, eq in card._runner.checks)
