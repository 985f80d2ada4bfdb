"""The port's stream scheduler on its device route against the JAX
package's, end to end on the CPU.

One synthetic profile with an i-vector extractor, an AM context that
covers the i-vector tap's splice and the extractor's global CMVN stats
(``with_ivector``, ``with_context``, ``with_ivector_cmvn``) sends both
packages down the device route in full: features in a device ring, the tap
window cut from the AM window and normalized from the cumulative ring, the
backpointers in a device ring walked once a tick. Six utterances go to 8
slots in 1,024-sample pushes, a tick after each round, as in
tests/test_torch_scheduler.py.

- The route flags equal the JAX scheduler's for five options (read from
  the constructors: five JAX schedulers are built, three of them run).
- The plain option runs in lockstep with the JAX scheduler. After every
  tick: alpha within atol 1e-2 and rtol 1e-5; the feature ring's live rows
  within ``testing/feature_tolerance.py``'s allowance for two f32 front
  ends (rtol 1e-4 / atol 2e-3, widened only on ill-conditioned frames;
  slot ``i`` holds utterance ``i``, its ring row ``r`` frame ``r``); the backpointer
  ring's live frames equal; in the tick's packed rows the arc trace, final
  state, has-final, trailing silence and contains-nonsilence equal and
  both costs within atol 1e-2 and rtol 1e-5
  (tests/test_torch_scheduler.py: COST_RTOL); the i-vector statistics
  within the tolerances of tests/test_torch_scheduler.py (rtol 1e-4, atol
  1e-4 on gamma and 1e-3 on X) when the port's fold takes the JAX side's
  carried tap window, and the i-vectors solved from each side's own
  statistics within 2e-3. (Each side's own tap windows differ by the
  features' CPU tolerance, and on this profile's extractor that moves a
  frame's posteriors by up to 3e-4, past that file's statistics
  tolerance.) The JAX side's packed row is read synchronously from its
  tick output. A tick makes at most one device program, one upload and one
  download.
- The same lockstep, the i-vector statistics left out, at 32 slots with 1,
  8 and 9 staggered streams (opened two a round, fed a chunk a round),
  where the port's AM runs over 8- and 16-row lane buckets and the JAX
  scheduler's over every slot.
- With ``silence_weight`` and with ``endpointing`` (streams with trailing
  silence, never finished) the transcripts equal the JAX scheduler's, the
  port's batch transcripts and the spoken sentences. Which tick an
  endpoint fires on is not asserted: the JAX scheduler reads its
  statistics on fetch threads.
- The JAX package's own scheduler cases, ported: the walk's endpoint
  columns equal the host walk over the batch decode of the same prefix, a
  reopened slot resets its device state, an overlong stream is quarantined
  while the tick goes on, a closed stream's ticket redeems its result
  whether it had landed or not, and a burst-fed stream drains under the
  cap.
"""

import numpy as np
import pytest

from rhasspy_speech_tpu.ops.ivector import solve_ivector as jax_solve_ivector
from rhasspy_speech_tpu.pipeline.endpoint import EndpointConfig as JaxEndpointConfig
from rhasspy_speech_tpu.pipeline.scheduler import StreamScheduler as JaxScheduler

import jax.numpy as jnp
import torch

from rhasspy_speech_torch.const import LangSuffix
from rhasspy_speech_torch.ops.decoder import viterbi as plain_viterbi
from rhasspy_speech_torch.ops.path_walk_cuda import PACKED_STAT_COLS
from rhasspy_speech_torch.ops.ivector import solve_ivector, window_stats
from rhasspy_speech_torch.pipeline import Nnet3WavTranscriber, lang_dir_name
from rhasspy_speech_torch.pipeline.endpoint import (
    EndpointConfig,
    EndpointRule,
    trailing_silence_frames,
)
from rhasspy_speech_torch.pipeline.scheduler import StreamScheduler
from rhasspy_speech_torch.pipeline.train import train_model_sync
from rhasspy_speech_torch.testing import build_synthetic_profile, synthesize_sentence
from rhasspy_speech_torch.testing.synthetic import _silence_wave
from rhasspy_speech_torch.testing.feature_tolerance import (
    assert_mfcc_close,
    frames_of,
    mfcc_allowance,
)

from test_torch_pipeline import LEXICON
from test_torch_stream import SENTENCES
from test_torch_scheduler import (
    COST_ATOL,
    COST_RTOL,
    GAMMA_ATOL,
    IV_TOL,
    PUSH,
    SLOTS,
    STAGGER_SLOTS,
    STAGGERED,
    STATS_RTOL,
    TEXTS,
    X_ATOL,
    _feed_interleaved,
    _feed_staggered,
)

SW = 0.01
FLAGS = ("_bp_compact", "_device_bp", "_device_feats", "_iv_inline", "_iv_cmvn_device",
         "_sw_device", "_ep_device", "_ring_frames", "_feat_ring_frames")
OPTIONS = {
    "plain": ({}, {}),
    "silence_weight": (dict(silence_weight=SW), dict(silence_weight=SW)),
    "endpointing": (dict(endpointing=EndpointConfig()), dict(endpointing=JaxEndpointConfig())),
    "both": (dict(silence_weight=SW, endpointing=EndpointConfig()),
             dict(silence_weight=SW, endpointing=JaxEndpointConfig())),
    "chunk14": (dict(chunk_out_frames=14), dict(chunk_out_frames=14)),
}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_sched_device")
    profile = build_synthetic_profile(root / "model", LEXICON, with_ivector=True,
                                      with_context=True, with_ivector_cmvn=True)
    intents = {"language": "en", "intents": {"Main": {"data": [{"sentences": SENTENCES}]}}}
    train_model_sync("en", intents, root / "train", profile.model_dir,
                     lang_suffixes=[LangSuffix.GRAMMAR])
    graph_dir = root / "train" / lang_dir_name(LangSuffix.GRAMMAR)
    pcms = [synthesize_sentence(profile, t, seed=100 + i) for i, t in enumerate(TEXTS)]
    batch = Nnet3WavTranscriber(profile.model_dir, graph_dir, device="cpu").transcribe_pcm_batch(pcms)
    assert batch == [[t] for t in TEXTS]
    return profile, graph_dir, pcms


def _port(trained, **kw):
    profile, graph_dir, _pcms = trained
    kw.setdefault("max_streams", SLOTS)
    return StreamScheduler(profile.model_dir, graph_dir, device="cpu", **kw)


@pytest.fixture(scope="module")
def jax_scheds(trained):
    """One JAX scheduler an option (constructed; only three are run)."""
    profile, graph_dir, _pcms = trained
    return {name: JaxScheduler(profile.model_dir, graph_dir, max_streams=SLOTS, **jkw)
            for name, (_kw, jkw) in OPTIONS.items()}


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_route_flags_equal_jax(trained, jax_scheds, name):
    port = _port(trained, **OPTIONS[name][0])
    j = jax_scheds[name]
    assert {f: getattr(port, f) for f in FLAGS} == {f: getattr(j, f) for f in FLAGS}
    assert port._device_bp and port._device_feats


class _Lockstep:
    """Holds the port's device state against the JAX scheduler's after
    every tick (the i-vector statistics too, with ``ivector``)."""

    def __init__(self, port, j, pcms, ivector=True):
        self.port, self.jax, self.ivector = port, j, ivector
        cfg = port.am.frontend_config
        self.allow = [mfcc_allowance(cfg, frames_of(cfg, pcm), sides=2) for pcm in pcms]
        self.ticks = self.packed_ticks = self.ring_frames = self.feat_rows = 0
        self.last = (port.device_dispatches, port._runner.uploads, port._runner.downloads)
        self.prev = self.jax_state()

    def jax_state(self):
        j = self.jax
        return (np.asarray(j._iv_gamma), np.asarray(j._iv_X), np.array(j._iv_carry),
                j._iv_pending_n.copy(), j._pending_reset.copy())

    def fold(self, carry, pending_n):
        """The port's fold of one tick's carried tap windows: (gamma, X)
        increments."""
        p = self.port
        w = (torch.arange(p._chunk_in)[None, :] < torch.as_tensor(pending_n)[:, None]).float()
        gamma, X = window_stats(torch.as_tensor(carry), w, p._ivp, p._chunk_in)
        return gamma.numpy(), X.numpy()

    def check_ivector(self):
        p, j = self.port, self.jax
        gamma, X, carry, pending_n, reset = self.prev
        jgamma, jX = np.asarray(j._iv_gamma), np.asarray(j._iv_X)
        if j._tick_packed is not None:  # the tick folded
            dg, dX = self.fold(carry, pending_n)
            gamma = np.where(reset[:, None], 0.0, gamma) + dg
            X = np.where(reset[:, None, None], 0.0, X) + dX
        np.testing.assert_allclose(gamma, jgamma, rtol=STATS_RTOL, atol=GAMMA_ATOL)
        np.testing.assert_allclose(X, jX, rtol=STATS_RTOL, atol=X_ATOL)
        np.testing.assert_allclose(
            solve_ivector(p._iv_gamma, p._iv_X, p._ivp).numpy(),
            np.asarray(jax_solve_ivector(jnp.asarray(jgamma), jnp.asarray(jX), j._ivp)),
            rtol=IV_TOL, atol=IV_TOL)
        self.prev = self.jax_state()

    def __call__(self):
        p, j = self.port, self.jax
        np.testing.assert_allclose(p._alpha.numpy(), np.asarray(j._alpha), rtol=COST_RTOL,
                                   atol=COST_ATOL)
        if self.ivector:
            self.check_ivector()
        offs = p._offs.numpy()
        np.testing.assert_array_equal(offs, np.asarray(j._offs))
        np.testing.assert_array_equal(p._feat_counts, j._feat_counts)
        ring, jring = p._ring.numpy().view(np.uint16), np.asarray(j._ring)
        feats, jfeats = p._feats_ring.numpy(), np.asarray(j._feats_ring)
        for sid in range(p.max_streams):
            np.testing.assert_array_equal(ring[sid, : offs[sid]], jring[sid, : offs[sid]])
            n = int(p._feat_counts[sid])
            if n:
                allow = self.allow[sid].rows(slice(0, n))
                assert_mfcc_close(feats[sid, :n], jfeats[sid, :n], allow, f"slot {sid}")
            self.ring_frames += int(offs[sid])
            self.feat_rows += n
        assert (p._tick_fetch is None) == (j._tick_packed is None)
        if j._tick_packed is not None:
            got, want = p._tick_fetch.get(), np.asarray(j._tick_packed)
            F = p._ring_frames
            np.testing.assert_array_equal(got[:, : F + 4], want[:, : F + 4])
            for col in (F + 4, F + 6):
                bits = [(a[:, col].astype(np.uint32) | (a[:, col + 1].astype(np.uint32) << 16))
                        .view(np.float32) for a in (got, want)]
                np.testing.assert_allclose(bits[0], bits[1], rtol=COST_RTOL, atol=COST_ATOL)
            self.packed_ticks += 1
        now = (p.device_dispatches, p._runner.uploads, p._runner.downloads)
        assert all(b - a <= 1 for a, b in zip(self.last, now)), (self.last, now)
        self.last = now
        self.ticks += 1


@pytest.fixture(scope="module")
def lockstep(trained, jax_scheds):
    _profile, _graph_dir, pcms = trained
    port = _port(trained)
    rec = _Lockstep(port, jax_scheds["plain"], pcms)
    got, want = _feed_interleaved([port, jax_scheds["plain"]], pcms, on_tick=rec)
    return got, want, rec


def test_lockstep_transcripts(lockstep):
    got, want, _rec = lockstep
    assert got == want == [[t] for t in TEXTS]


def test_lockstep_every_tick(lockstep):
    _got, _want, rec = lockstep
    assert rec.ticks > 10 and rec.packed_ticks > 5
    assert rec.ring_frames > 0 and rec.feat_rows > 0


@pytest.mark.parametrize("streams", STAGGERED)
def test_lane_buckets_lockstep_with_jax(trained, streams):
    """32 slots and ``streams`` staggered streams
    (tests/test_torch_scheduler.py: ``_feed_staggered``): the port's fused
    tick runs its AM over 8- and 16-row lane buckets, gathering the lanes
    and scattering their log-probs, the JAX scheduler's over every slot.
    Every tick is held as in the lockstep run but for the i-vector
    statistics (alpha, the rings, the packed rows' traces and costs), and
    the transcripts equal the JAX scheduler's and the spoken sentences.
    (The statistics are left out: a stream's last tick, when it folds a
    whole chunk's 21 frames, moves them past this file's tolerances, at 8
    slots with the AM over every slot as well.)"""
    profile, graph_dir, pcms = trained
    pcms = [pcms[i % len(pcms)] for i in range(streams)]
    port = _port(trained, max_streams=STAGGER_SLOTS)
    jax_sched = JaxScheduler(profile.model_dir, graph_dir, max_streams=STAGGER_SLOTS)
    rec = _Lockstep(port, jax_sched, pcms, ivector=False)
    (got, want), buckets = _feed_staggered([port, jax_sched], pcms, on_tick=rec)
    assert got == want == [[TEXTS[i % len(TEXTS)]] for i in range(streams)]
    assert buckets == ({8, 16} if streams > 8 else {8})
    assert rec.ticks > 5 and rec.packed_ticks > 3


def test_silence_weighting_equals_jax(trained, jax_scheds):
    _profile, _graph_dir, pcms = trained
    port = _port(trained, silence_weight=SW)
    weighed = []
    on_tick = lambda: weighed.append(int((port._sw_w == np.float32(SW)).sum()))  # noqa: E731
    got, want = _feed_interleaved([port, jax_scheds["silence_weight"]], pcms, on_tick=on_tick)
    assert got == want == [[t] for t in TEXTS]
    assert sum(weighed) > 0


def test_endpointing_without_finish_equals_jax(trained, jax_scheds):
    profile, graph_dir, _pcms = trained
    rng = np.random.RandomState(0)
    texts = TEXTS[:4]
    pcms = [np.concatenate([synthesize_sentence(profile, t, seed=77 + i),
                            _silence_wave(16000 + 4000 * i, rng)]).astype(np.float32)
            for i, t in enumerate(texts)]
    port = _port(trained, endpointing=EndpointConfig())
    scheds = [port, jax_scheds["endpointing"]]
    sids = [[s.open_stream() for _ in pcms] for s in scheds]
    for off in range(0, max(p.shape[0] for p in pcms), PUSH):
        for s, row in zip(scheds, sids):
            for sid, pcm in zip(row, pcms):
                if off < pcm.shape[0]:
                    s.feed(sid, pcm[off : off + PUSH])
            s.step()
    for _ in range(200):
        if all(s.poll(sid) is not None for s, row in zip(scheds, sids) for sid in row):
            break
        for s in scheds:
            s.step()
    got, want = [[s.poll(sid) for sid in row] for s, row in zip(scheds, sids)]
    assert not any(port.pool.is_finished(sid) for sid in sids[0])
    batch = Nnet3WavTranscriber(profile.model_dir, graph_dir, device="cpu").transcribe_pcm_batch(pcms)
    assert got == want == batch == [[t] for t in texts]


def test_device_endpoint_signals_match_host_walk(trained):
    """The walk's endpoint columns (trailing silence, contains-nonsilence)
    equal the host walk (``trailing_silence_frames``, uncapped) over the
    batch decode of the same prefix, tick by tick, with rules that never
    fire (the JAX package's own case, tests/test_scheduler.py:219)."""
    profile, graph_dir, _pcms = trained
    cfg = EndpointConfig(rules=(EndpointRule(False, 1e9, float("inf"), 1e9),))
    s = _port(trained, max_streams=2, endpointing=cfg)
    assert s._ep_device and s._device_bp and s._silence_pdfs
    pcm = np.concatenate([synthesize_sentence(profile, "never mind", seed=5),
                          _silence_wave(16000, np.random.RandomState(1))]).astype(np.float32)
    am = s.am
    feats = am.features(torch.as_tensor(pcm[None]))
    n_out = feats.shape[1] // am.subsampling
    lp = am.log_probs(feats, n_out)
    graph = s.graph
    sid = s.open_stream()
    s.feed(sid, pcm)
    checked = 0
    for _ in range(60):
        s.step()
        if not s._ep_stats_pending:
            continue
        fetch, _gens, out_snap = s._ep_stats_pending[-1]
        T = int(out_snap[sid])
        if T <= 0 or T > n_out:
            continue
        alpha, bp = plain_viterbi(s.device_graph, lp[:, :T])
        alpha = alpha.numpy()[0]
        totals = alpha + graph.final_weight
        best = int(np.argmin(totals if totals.min() < 1.0e29 else alpha))
        want = trailing_silence_frames([bp.numpy()[:, 0, :]], best, graph.arc_pdf, graph.arc_src,
                                       s._silence_pdfs, max_back=10**9)
        p = fetch.get()
        F = p.shape[1] - PACKED_STAT_COLS
        assert (int(p[sid, F + 2]), bool(p[sid, F + 3])) == want, (T, want)
        checked += 1
    assert checked >= 5 and not s.slots[sid].done


def _decode_one(s, sid, pcm):
    s.feed(sid, pcm)
    s.finish(sid)
    for _ in range(100):
        if s.poll(sid) is not None:
            break
        s.step()
    return s.poll(sid)


def test_reopened_slot_resets_device_state(trained):
    """A recycled slot decodes like a fresh scheduler's: alpha, the ring's
    frames and the packed row's trace equal (no stale state leaks)."""
    _profile, _graph_dir, pcms = trained
    s = _port(trained, max_streams=1)
    for i in (0, 1, 2):
        sid = s.open_stream()
        assert sid == 0
        assert _decode_one(s, sid, pcms[i]) == [TEXTS[i]]
        s.close(sid)
    fresh = _port(trained, max_streams=1)
    assert _decode_one(fresh, fresh.open_stream(), pcms[2]) == [TEXTS[2]]
    n = int(fresh._offs[0])
    assert n > 0 and int(s._offs[0]) == n
    assert torch.equal(s._alpha, fresh._alpha)
    assert torch.equal(s._ring[0, :n], fresh._ring[0, :n])
    assert torch.equal(s._iv_gamma, fresh._iv_gamma)


def test_overlong_stream_quarantined_not_fatal(trained):
    """A stream outliving the rings sized from pool_capacity_samples is
    finalized with error() set; the other slot decodes its sentence."""
    profile, _graph_dir, pcms = trained
    s = _port(trained, max_streams=2, pool_capacity_samples=16000 * 2)
    long_pcm = np.tile(pcms[0], 6)
    assert long_pcm.shape[0] > 16000 * 4
    a, b = s.open_stream(), s.open_stream()
    offs, src = {a: 0, b: 0}, {a: long_pcm, b: pcms[1]}
    for _ in range(3000):
        fed_any = False
        for sid in (a, b):
            if offs[sid] < src[sid].shape[0]:
                offs[sid] += s.feed(sid, src[sid][offs[sid] : offs[sid] + PUSH])
                fed_any = True
        s.step()
        if not fed_any:
            break
    for sid in (a, b):
        s.finish(sid)
    for _ in range(300):
        if all(s.poll(sid) is not None for sid in (a, b)):
            break
        s.step()
    assert s.error(a) is not None and "pool_capacity_samples" in s.error(a)
    assert s.poll(a) is not None
    assert s.error(b) is None and s.poll(b) == [TEXTS[1]]


@pytest.mark.parametrize("landed", [False, True], ids=["in_flight", "landed"])
def test_close_ticket_survives_recycle(trained, landed):
    """A done stream closed before (or after) its result landed: its
    ticket redeems the transcript once, and the recycled slot decodes its
    next stream."""
    _profile, _graph_dir, pcms = trained
    s = _port(trained, max_streams=1)
    sid = s.open_stream()
    s.feed(sid, pcms[0])
    s.finish(sid)
    for _ in range(100):
        s.step()
        if s.slots[sid].done:
            break
    assert s.slots[sid].done
    if landed:
        assert s.poll(sid) == [TEXTS[0]]
    else:
        assert s.slots[sid].result is None  # lands on a later step or poll
    ticket = s.close(sid)
    sid2 = s.open_stream()
    assert sid2 == sid
    assert _decode_one(s, sid2, pcms[1]) == [TEXTS[1]]
    assert s.take_result(ticket, block=True) == [TEXTS[0]]
    assert s.take_result(ticket) is None


def test_burst_fed_stream_drains_under_the_cap(trained):
    """A stream fed past the drain cap in one push drains at most the cap a
    tick, and run_until_idle consumes everything the scheduler owns."""
    profile, _graph_dir, pcms = trained
    rng = np.random.RandomState(1)
    pcm = np.concatenate([_silence_wave(8000, rng), pcms[4], _silence_wave(16000, rng)])
    pcm = pcm.astype(np.float32)
    s = _port(trained, max_streams=2, pool_capacity_samples=16000 * 8)
    assert pcm.shape[0] > 2 * s._drain_cap
    sid = s.open_stream()
    assert s.feed(sid, pcm) == pcm.shape[0]
    s.finish(sid)
    left = [pcm.shape[0]]
    for _ in range(3):
        s.step()
        left.append(s.pool.available(sid))
        assert left[-2] - left[-1] <= s._drain_cap
    assert left[1] < left[0] and left[2] < left[1]
    s.run_until_idle()
    assert s.pool.available(sid) == 0
    assert s.poll(sid) == [TEXTS[4]]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the captured tick runs on the card)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["plain", "silence_weight", "endpointing"])
def test_captured_tick_on_the_card(trained, cuda, name):
    """On the card the tick runs as captured CUDA graphs: at most one MFCC,
    one Viterbi and one path-walk launch a tick by the scheduler's own
    count, a replay bit-equal to the body run eagerly on copies of its
    inputs, and the transcripts of the CPU run."""
    profile, graph_dir, pcms = trained
    kw = dict(OPTIONS[name][0])
    if name == "endpointing":
        rng = np.random.RandomState(0)
        pcms = [np.concatenate([p, _silence_wave(16000, rng)]).astype(np.float32) for p in pcms]
    scheds = [StreamScheduler(profile.model_dir, graph_dir, max_streams=SLOTS, device=d, **kw)
              for d in (cuda, "cpu")]
    card = scheds[0]
    per_tick = []

    def on_tick():
        now = card.kernel_launches
        per_tick.append({k: now[k] - before[k] for k in now})
        before.update(now)
        card._runner.check_next = True

    before = card.kernel_launches
    sids = [[s.open_stream() for _ in pcms] for s in scheds]
    for off in range(0, max(p.shape[0] for p in pcms), PUSH):
        for s, row in zip(scheds, sids):
            for sid, pcm in zip(row, pcms):
                if off < pcm.shape[0]:
                    s.feed(sid, pcm[off : off + PUSH])
                    if name != "endpointing" and off + PUSH >= pcm.shape[0]:
                        s.finish(sid)
            s.step()
        on_tick()
    for _ in range(200):
        if all(s.poll(sid) is not None for s, row in zip(scheds, sids) for sid in row):
            break
        for s in scheds:
            s.step()
        on_tick()
    got, want = [[s.poll(sid) for sid in row] for s, row in zip(scheds, sids)]
    assert got == want == [[t] for t in TEXTS]
    # each kernel at most once a tick (the stamps, one a stamp the body takes)
    assert card._runner.graphs and all(
        max(v for k, v in t.items() if k != "tick_stamp") <= 1 for t in per_tick)
    assert all(card.kernel_launches[k] > 0 for k in ("mfcc", "viterbi", "path_walk"))
    assert card._runner.checks and all(all(eq.values()) for _key, eq in card._runner.checks)
