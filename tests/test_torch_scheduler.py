"""The port's batched streaming scheduler against the JAX package's and
against the port's batch transcriber, end to end on the CPU.

A synthetic profile with an i-vector extractor (the port's own copy of
``testing/synthetic.py``) is trained once, with the lexicon and grammar of
tests/test_torch_stream.py. Six utterances are fed interleaved in
1,024-sample pushes to 8 slots of both packages' ``StreamScheduler``, with
a tick after each round: transcripts must equal the JAX scheduler's, the
port's batch transcripts and the spoken sentences, plain, with
``silence_weight`` and with ``chunk_out_frames=14``. The plain run steps the
two schedulers in lockstep and holds every tick's state: alpha within atol
1e-2, the i-vector statistics within rtol 1e-4 (atol 1e-4 on gamma's
near-zero entries and 1e-3 on X's, whose small entries cancel sums of
hundreds) and the i-vectors solved from them within 2e-3, the tolerances
tests/test_torch_stream.py holds one stream to; a slot that decoded nothing, had
nothing to fold and was not reopened keeps its alpha and statistics bit
for bit. The same holds at 32 slots with 1, 8 and 9 staggered streams
(opened two a round, fed a chunk a round), where the port's AM runs over
8- and 16-row lane buckets. Six JAX schedulers are built in all.
"""

import numpy as np
import pytest

from rhasspy_speech_tpu.ops.ivector import solve_ivector as jax_solve_ivector
from rhasspy_speech_tpu.pipeline.scheduler import StreamScheduler as JaxScheduler

import jax.numpy as jnp
import torch

from rhasspy_speech_torch.const import LangSuffix
from rhasspy_speech_torch.io.gmm_am import read_am_diag_gmm, write_am_diag_gmm
from rhasspy_speech_torch.io.ivector import DiagGmm
from rhasspy_speech_torch.ops.ivector import solve_ivector
from rhasspy_speech_torch.parallel import make_stream_mesh
from rhasspy_speech_torch.pipeline import Nnet3WavTranscriber, lang_dir_name
from rhasspy_speech_torch.pipeline import scheduler as sched_mod
from rhasspy_speech_torch.pipeline.endpoint import EndpointConfig
from rhasspy_speech_torch.pipeline.scheduler import StreamScheduler
from rhasspy_speech_torch.pipeline.train import train_model_sync
from rhasspy_speech_torch.testing import build_synthetic_profile, synthesize_sentence
from rhasspy_speech_torch.testing.synthetic import _silence_wave, build_synthetic_gmm_profile

from test_torch_pipeline import LEXICON
from test_torch_stream import SENTENCES

COST_ATOL = 1e-2
# Viterbi costs (alpha, final costs) sum a run's ~100 frames of AM
# log-probs, which the two packages compute in different f32 BLAS orders
# (and each order rounds by the host's CPU): each frame's add rounds at
# 2^-24 of the running cost, ~6e-6 of it over 100 frames, where atol 1e-2
# alone is ~3 ulps at 4e4. The largest relative gap seen is 2.3e-6.
COST_RTOL = 1e-5
STATS_RTOL = GAMMA_ATOL = 1e-4
X_ATOL = 1e-3
IV_TOL = 2e-3
TEXTS = ["turn on the light", "never mind", "turn off the fan", "turn on fan",
         "turn off light never mind", "never mind"]
SLOTS = 8
PUSH = 1024
# the lane-bucket runs: a 32-slot scheduler and 1, 8 or 9 staggered
# streams, so the port's AM runs at 8 rows and (9 streams) at 16
STAGGER_SLOTS = 32
STAGGERED = (1, 8, 9)
OPTIONS = {"plain": {}, "silence_weight": dict(silence_weight=0.01),
           "chunk14": dict(chunk_out_frames=14)}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_sched")
    profile = build_synthetic_profile(root / "model", LEXICON, with_ivector=True)
    intents = {"language": "en", "intents": {"Main": {"data": [{"sentences": SENTENCES}]}}}
    train_model_sync("en", intents, root / "train", profile.model_dir,
                     lang_suffixes=[LangSuffix.GRAMMAR])
    graph_dir = root / "train" / lang_dir_name(LangSuffix.GRAMMAR)
    pcms = [synthesize_sentence(profile, t, seed=100 + i) for i, t in enumerate(TEXTS)]
    batch = Nnet3WavTranscriber(profile.model_dir, graph_dir, device="cpu").transcribe_pcm_batch(pcms)
    assert batch == [[t] for t in TEXTS]
    return root, profile, graph_dir, pcms


def _port(trained, **kw):
    _root, profile, graph_dir, _pcms = trained
    return StreamScheduler(profile.model_dir, graph_dir, device="cpu", **kw)


def _feed_interleaved(scheds, pcms, on_tick=None):
    """Open a stream a PCM in each scheduler, feed them round by round in
    PUSH-sample pushes with a tick after each round, finish them and step
    until every transcript is in; returns each scheduler's transcripts."""
    sids = [[s.open_stream() for _ in pcms] for s in scheds]
    assert all(sid >= 0 for row in sids for sid in row)
    for off in range(0, max(p.shape[0] for p in pcms), PUSH):
        for s, row in zip(scheds, sids):
            for sid, pcm in zip(row, pcms):
                if off < pcm.shape[0]:
                    s.feed(sid, pcm[off : off + PUSH])
        for s in scheds:
            s.step()
        if on_tick is not None:
            on_tick()
    for s, row in zip(scheds, sids):
        for sid in row:
            s.finish(sid)
    for _ in range(200):
        if all(s.poll(sid) is not None for s, row in zip(scheds, sids) for sid in row):
            break
        for s in scheds:
            s.step()
        if on_tick is not None:
            on_tick()
    return [[s.poll(sid) for sid in row] for s, row in zip(scheds, sids)]


def _feed_staggered(scheds, pcms, on_tick=None):
    """Stream ``i`` opens in each scheduler at round ``i // 2`` and is fed a
    chunk's samples a round (``_chunk_in`` frames), a tick after each round,
    and finished with its last push; then steps until every transcript is
    in. Past its first push every open stream decodes a chunk a tick, so a
    tick's lanes rise to the open streams and fall as each ends. Returns
    each scheduler's transcripts and the AM lane buckets the first one ran
    (its runner's keys of the chunk-decoding bodies)."""
    push = scheds[0]._chunk_in * scheds[0]._frame_shift
    sids = [[None] * len(pcms) for _ in scheds]
    offs = [0] * len(pcms)
    rnd = 0
    while any(off < pcm.shape[0] for off, pcm in zip(offs, pcms)):
        for i, pcm in enumerate(pcms):
            if i // 2 > rnd or offs[i] >= pcm.shape[0]:
                continue
            for s, row in zip(scheds, sids):
                if row[i] is None:
                    row[i] = s.open_stream()
                    assert row[i] >= 0
                s.feed(row[i], pcm[offs[i] : offs[i] + push])
                if offs[i] + push >= pcm.shape[0]:
                    s.finish(row[i])
            offs[i] += push
        for s in scheds:
            s.step()
        if on_tick is not None:
            on_tick()
        rnd += 1
    for _ in range(200):
        if all(s.poll(sid) is not None for s, row in zip(scheds, sids) for sid in row):
            break
        for s in scheds:
            s.step()
        if on_tick is not None:
            on_tick()
    texts = [[s.poll(sid) for sid in row] for s, row in zip(scheds, sids)]
    buckets = {k[-1] for k in scheds[0]._runner.warm_keys if k[0] in ("fused", "chunk")}
    return texts, buckets


class _TickRecorder:
    """Holds the port's tick state against the JAX scheduler's after every
    tick, and the port's idle slots against their state before it."""

    def __init__(self, port, jax_sched):
        self.port, self.jax = port, jax_sched
        self.ticks = self.idle_checked = 0
        self.snapshot()

    def snapshot(self):
        p = self.port
        self.before = (p._alpha.clone(), p._iv_gamma.clone(), p._iv_X.clone(),
                       [s.out_frames for s in p.slots],
                       [s.iv_pending_w is None or not s.iv_pending_w.any() for s in p.slots],
                       p._pending_reset.copy())

    def __call__(self):
        p, j = self.port, self.jax
        np.testing.assert_allclose(p._alpha.numpy(), np.asarray(j._alpha), rtol=COST_RTOL,
                                   atol=COST_ATOL)
        gamma, X = p._iv_gamma.numpy(), p._iv_X.numpy()
        jgamma, jX = np.asarray(j._iv_gamma), np.asarray(j._iv_X)
        np.testing.assert_allclose(gamma, jgamma, rtol=STATS_RTOL, atol=GAMMA_ATOL)
        np.testing.assert_allclose(X, jX, rtol=STATS_RTOL, atol=X_ATOL)
        ivp, jivp = p._ivp, j._ivp
        np.testing.assert_allclose(
            solve_ivector(p._iv_gamma, p._iv_X, ivp).numpy(),
            np.asarray(jax_solve_ivector(jnp.asarray(jgamma), jnp.asarray(jX), jivp)),
            rtol=IV_TOL, atol=IV_TOL)
        alpha0, gamma0, X0, out0, nothing_pending, reset = self.before
        for sid, st in enumerate(p.slots):
            if st.out_frames == out0[sid] and nothing_pending[sid] and not reset[sid]:
                assert torch.equal(p._alpha[sid], alpha0[sid])
                assert torch.equal(p._iv_gamma[sid], gamma0[sid])
                assert torch.equal(p._iv_X[sid], X0[sid])
                self.idle_checked += 1
        self.ticks += 1
        self.snapshot()


@pytest.fixture(scope="module")
def lockstep(trained):
    """The plain option: the port and the JAX scheduler stepped in
    lockstep, every tick's state recorded."""
    _root, profile, graph_dir, pcms = trained
    port = _port(trained, max_streams=SLOTS)
    jax_sched = JaxScheduler(profile.model_dir, graph_dir, max_streams=SLOTS)
    rec = _TickRecorder(port, jax_sched)
    got, want = _feed_interleaved([port, jax_sched], pcms, on_tick=rec)
    return got, want, rec


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_many_streams_equal_jax_and_batch(trained, lockstep, name):
    _root, profile, graph_dir, pcms = trained
    if name == "plain":
        got, want, _rec = lockstep
    else:
        port = _port(trained, max_streams=SLOTS, **OPTIONS[name])
        jax_sched = JaxScheduler(profile.model_dir, graph_dir, max_streams=SLOTS, **OPTIONS[name])
        got, want = _feed_interleaved([port, jax_sched], pcms)
    assert got == want == [[t] for t in TEXTS]


def test_tick_state_equals_jax(lockstep):
    _got, _want, rec = lockstep
    assert rec.ticks > 10 and rec.idle_checked > rec.ticks


@pytest.mark.parametrize("streams", STAGGERED)
def test_lane_buckets_equal_jax(trained, streams):
    """The chunk body (this profile's features stay on the host) at 32
    slots with ``streams`` staggered streams (``_feed_staggered``): the
    port's AM runs over 8- and 16-row lane buckets, the JAX scheduler's
    over every slot. Every tick's alpha, i-vector statistics and i-vectors
    follow the JAX scheduler's, idle slots keep theirs bit for bit, and
    the transcripts equal the JAX scheduler's and the spoken sentences."""
    _root, profile, graph_dir, pcms = trained
    pcms = [pcms[i % len(pcms)] for i in range(streams)]
    port = _port(trained, max_streams=STAGGER_SLOTS)
    assert port._device_bp and not port._device_feats
    jax_sched = JaxScheduler(profile.model_dir, graph_dir, max_streams=STAGGER_SLOTS)
    rec = _TickRecorder(port, jax_sched)
    (got, want), buckets = _feed_staggered([port, jax_sched], pcms, on_tick=rec)
    assert got == want == [[TEXTS[i % len(TEXTS)]] for i in range(streams)]
    assert buckets == ({8, 16} if streams > 8 else {8})
    assert rec.ticks > 5 and rec.idle_checked > rec.ticks


def test_one_device_step_a_tick(trained):
    """A tick makes at most one MFCC call and one device step; the decode
    of that step is the Viterbi kernel's wrapper, which runs the plain
    decoder on the CPU and the kernel on a card."""
    _root, _profile, _graph_dir, pcms = trained
    s = _port(trained, max_streams=SLOTS)
    assert s._kernels()[:2] == ["mfcc", "viterbi"]
    sid = s.open_stream()
    per_tick = []
    for off in range(0, pcms[0].shape[0], PUSH):
        s.feed(sid, pcms[0][off : off + PUSH])
        before = s.device_dispatches
        decoded = s.step()
        per_tick.append((s.device_dispatches - before, decoded))
    # every push completes a frame: one MFCC call a tick, plus the device
    # step on a tick that decodes
    assert per_tick == [(1 + (lanes > 0), lanes) for _n, lanes in per_tick]
    assert any(lanes for _n, lanes in per_tick)


def test_endpointing_without_finish(trained):
    """Streams with >= 1 s of trailing silence endpoint without finish():
    the transcript is the spoken sentence and the batch transcript."""
    _root, profile, graph_dir, _pcms = trained
    rng = np.random.RandomState(0)
    texts = ["never mind", "turn on the light"]
    pcms = [np.concatenate([synthesize_sentence(profile, t, seed=77 + i),
                            _silence_wave(16000 + 8000 * i, rng)]).astype(np.float32)
            for i, t in enumerate(texts)]
    s = _port(trained, max_streams=2, endpointing=EndpointConfig())
    assert s._silence_pdfs, "silence pdfs must be derived from the model"
    sids = [s.open_stream() for _ in texts]
    for sid, pcm in zip(sids, pcms):
        s.feed(sid, pcm)
    for _ in range(100):
        if all(s.poll(sid) is not None for sid in sids):
            break
        s.step()
    assert not any(s.pool.is_finished(sid) for sid in sids)
    batch = Nnet3WavTranscriber(profile.model_dir, graph_dir, device="cpu").transcribe_pcm_batch(pcms)
    assert [s.poll(sid) for sid in sids] == batch == [[t] for t in texts]


def _decode_one(s, sid, pcm):
    s.feed(sid, pcm)
    s.finish(sid)
    for _ in range(100):
        if s.poll(sid) is not None:
            break
        s.step()
    return s.poll(sid)


def test_admission_limit_and_slot_recycling(trained, monkeypatch):
    """Two slots admit two streams; a closed slot is the next one opened,
    and its second stream decodes chunk for chunk like a fresh
    scheduler's (on the host route, whose backpointers come to the host;
    tests/test_torch_scheduler_device.py holds the device route's)."""
    _root, profile, _graph_dir, pcms = trained
    monkeypatch.setattr(sched_mod, "_BP_RING_MAX_ARC", -1)
    s = _port(trained, max_streams=2)
    assert not s._device_bp
    a, b = s.open_stream(), s.open_stream()
    assert a >= 0 and b >= 0 and s.open_stream() == -1
    assert s.active_streams == 2
    assert _decode_one(s, a, pcms[0]) == [TEXTS[0]]
    s.close(a)
    assert s.active_streams == 1
    assert s.open_stream() == a
    assert _decode_one(s, a, pcms[2]) == [TEXTS[2]]
    fresh = _port(trained, max_streams=2)
    sid = fresh.open_stream()
    assert _decode_one(fresh, sid, pcms[2]) == [TEXTS[2]]
    assert len(s.slots[a].bps) == len(fresh.slots[sid].bps)
    assert all(np.array_equal(x, y) for x, y in zip(s.slots[a].bps, fresh.slots[sid].bps))
    assert torch.equal(s._alpha[a], fresh._alpha[sid])
    assert torch.equal(s._iv_gamma[a], fresh._iv_gamma[sid])


def test_close_ticket_survives_recycle(trained):
    """A done stream closed before anyone polled it: its ticket redeems its
    transcript once, and the recycled slot decodes its next stream."""
    _root, profile, _graph_dir, pcms = trained
    s = _port(trained, max_streams=1)
    sid = s.open_stream()
    s.feed(sid, pcms[0])
    s.finish(sid)
    for _ in range(100):
        s.step()
        if s.slots[sid].done:
            break
    ticket = s.close(sid)
    sid2 = s.open_stream()
    assert sid2 == sid
    assert _decode_one(s, sid2, pcms[1]) == [TEXTS[1]]
    assert s.take_result(ticket, block=True) == [TEXTS[0]]
    assert s.take_result(ticket) is None
    # a finished stream's ticket redeems at once, an unfinished one's nothing
    assert s.take_result(s.close(sid2)) == [TEXTS[1]]
    sid3 = s.open_stream()
    assert s.take_result(s.close(sid3)) is None


def test_feed_many_feeds_each_row_to_its_slot(trained):
    """``feed_many`` (int16 rows, one call) gives each slot what ``feed``
    would have."""
    _root, _profile, _graph_dir, pcms = trained
    s = _port(trained, max_streams=2)
    sids = np.asarray([s.open_stream(), s.open_stream()], dtype=np.int32)
    n = min(pcms[1].shape[0], pcms[5].shape[0])
    rows = np.stack([pcms[1][:n], pcms[5][:n]]).round().astype(np.int16)
    assert list(s.feed_many(sids, rows)) == [n, n]
    for sid in sids:
        s.finish(int(sid))
    s.run_until_idle()
    assert [s.poll(int(sid)) for sid in sids] == [[TEXTS[1]], [TEXTS[5]]]


def test_burst_feed_drains_over_several_ticks(trained):
    """A stream fed all at once drains at most the drain cap a tick, over
    several ticks, to the spoken sentence."""
    _root, _profile, _graph_dir, pcms = trained
    rng = np.random.RandomState(1)
    pcm = np.concatenate([_silence_wave(8000, rng), pcms[4], _silence_wave(16000, rng)])
    pcm = pcm.astype(np.float32)
    s = _port(trained, max_streams=2)
    assert pcm.shape[0] > 2 * s._drain_cap
    sid = s.open_stream()
    s.feed(sid, pcm)
    s.finish(sid)
    left = []
    for _ in range(3):
        s.step()
        left.append(s.pool.available(sid))
    assert left[0] == pcm.shape[0] - s._drain_cap
    assert left[0] - s._drain_cap <= left[1] < left[0] and left[2] < left[1]
    s.run_until_idle()
    assert s.poll(sid) == [TEXTS[4]]


def test_decoder_choice_past_the_kernels_reach(trained, tmp_path):
    """On a graph past the replicated body's reach (the trained graph padded
    with unreachable states to 29,100 states, within the device route's
    ring limits) the scheduler's tick decode is the same ``viterbi_decode``
    call, its kernels name the large bodies' library, and it transcribes
    the same."""
    from rhasspy_speech_torch.testing.decode_graphs import padded_graph_dir

    _root, profile, graph_dir, pcms = trained
    s = StreamScheduler(profile.model_dir, padded_graph_dir(graph_dir, tmp_path / "g", 29100),
                        max_streams=2, device="cpu")
    assert s.graph.num_states == 29100 and s._device_bp
    assert "viterbi_large" in s._kernels() and "viterbi" not in s._kernels()
    assert _decode_one(s, s.open_stream(), pcms[3]) == [TEXTS[3]]


def _gmm_with_pitch(model_dir):
    """The synthetic GMM profile as a pitch model: ``--add-pitch=true`` in
    conf/online.conf, and each pdf's Gaussian widened over [MFCC | pitch]
    and their deltas (the layout ``add_deltas`` gives): the pitch statics
    get seeded means and variance 4, so the pitch columns move the
    log-likelihoods; their deltas, like the MFCC deltas, variance 1e6."""
    profile = build_synthetic_gmm_profile(model_dir, LEXICON)
    mdl = str(profile.model_dir / "model" / "final.mdl")
    transition_model, gmms = read_am_diag_gmm(mdl)
    rng = np.random.RandomState(5)
    wide = []
    for g in gmms:
        D = g.dim // 3
        mean, var = g.means()[0], 1.0 / g.inv_vars[0]
        means, variances = [], []
        for k in range(3):
            means += [mean[k * D : (k + 1) * D], 0.3 * rng.randn(3) if k == 0 else np.zeros(3)]
            variances += [var[k * D : (k + 1) * D], np.full(3, 4.0 if k == 0 else 1.0e6)]
        wide.append(DiagGmm.from_means_vars(
            g.weights, np.concatenate(means)[None], np.concatenate(variances)[None]))
    write_am_diag_gmm(mdl, transition_model, wide)
    conf = profile.model_dir / "model" / "conf"
    conf.mkdir(parents=True, exist_ok=True)
    (conf / "online.conf").write_text("--add-pitch=true\n", encoding="utf-8")
    return profile


NOT_PORTED = {
    "mesh": dict(mesh="cpu2"),
    "mulaw": dict(wire="mulaw"),
    "adpcm": dict(wire="adpcm"),
}


@pytest.mark.parametrize("case", sorted(NOT_PORTED))
def test_options_not_ported_raise(trained, case):
    """``mesh=`` and the mu-law and ADPCM wires answer now
    (tests/test_torch_parallel.py, test_torch_mulaw.py and
    test_torch_adpcm.py hold them to the JAX package): on this profile,
    whose features stay on the host, a wire is ignored as the JAX
    scheduler ignores it, and a mesh of two CPU entries splits the slots
    into two blocks; each transcribes a stream to its sentence."""
    _root, profile, graph_dir, pcms = trained
    kw = dict(NOT_PORTED[case])
    if kw.get("mesh") == "cpu2":
        kw["mesh"] = make_stream_mesh(devices=["cpu"] * 2)
    sched = StreamScheduler(profile.model_dir, graph_dir, max_streams=2, device="cpu", **kw)
    assert not sched._device_feats and sched._wire == "i16"
    sid = sched.open_stream()
    sched.feed(sid, pcms[0])
    sched.finish(sid)
    sched.run_until_idle()
    assert sched.poll(sid) == [TEXTS[0]]


def test_unknown_wire_raises(trained):
    _root, profile, graph_dir, _pcms = trained
    with pytest.raises(ValueError, match="wire"):
        StreamScheduler(profile.model_dir, graph_dir, wire="f32", device="cpu")


def test_pcm_bucket():
    cap = sched_mod._DRAIN_CAP
    assert [sched_mod._pcm_bucket(n) for n in (0, 1600, 1601, 2401, cap, cap + 1)] == [
        1600, 1600, 2400, 3200, cap, cap]
