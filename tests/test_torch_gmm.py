"""The port's diagonal-GMM acoustic model against the JAX package's, on the
CPU, down to end-to-end transcripts.

- ``GmmAm.log_likes`` on the same seeded parameters (pdfs of 1 to 4
  components, one pdf all padding) and features: rtol 1e-5 / atol 1e-3
  (f32 products of 39-wide rows summed in another order, then a
  logsumexp; values reach ~1e3 and, on the all-padding pdf, -1e30). Rows
  run in blocks: with the block cut to a few rows the result is the same
  within rtol 1e-6.
- ``GmmChunkModel`` on edge-clamped windows, as the stream transcriber and
  the scheduler cut them: equal to the JAX ``GmmChunkModel`` (same
  tolerance) and to the batch log-likelihoods of the same frames (rtol
  1e-6 / atol 1e-4: the same terms over fewer rows).
- ``AcousticModel.log_probs`` of a GMM model dir equal to the JAX
  package's on the same features (same tolerance as ``log_likes``).
- On the synthetic GMM profile (``build_synthetic_gmm_profile``: one
  Gaussian a pdf over MFCC + deltas, 20 cepstra), batch transcripts equal
  the JAX package's and the spoken sentences; the port's stream
  transcriber and its scheduler, on the device route and forced onto the
  host route, give the batch transcripts.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from rhasspy_speech_tpu.models.gmm import GmmAm as JaxGmmAm
from rhasspy_speech_tpu.models.gmm import GmmChunkModel as JaxGmmChunkModel
from rhasspy_speech_tpu.pipeline import Nnet3WavTranscriber as JaxTranscriber
from rhasspy_speech_tpu.pipeline.transcribe import AcousticModel as JaxAcousticModel

import torch

from rhasspy_speech_torch import Nnet3StreamTranscriber, Nnet3WavTranscriber
from rhasspy_speech_torch.const import LangSuffix
from rhasspy_speech_torch.io.ivector import DiagGmm
from rhasspy_speech_torch.models import gmm as gmm_mod
from rhasspy_speech_torch.models.gmm import NEG_HUGE, GmmAm, GmmChunkModel
from rhasspy_speech_torch.ops.deltas import add_deltas
from rhasspy_speech_torch.pipeline import lang_dir_name
from rhasspy_speech_torch.pipeline import scheduler as sched_mod
from rhasspy_speech_torch.pipeline.scheduler import StreamScheduler
from rhasspy_speech_torch.pipeline.transcribe import AcousticModel
from rhasspy_speech_torch.pipeline.train import train_model_sync
from rhasspy_speech_torch.testing.synthetic import build_synthetic_gmm_profile, synthesize_sentence

from test_torch_pipeline import LEXICON

LL_RTOL, LL_ATOL = 1e-5, 1e-3
GRAMMAR = ["turn (on|off) [the] (light|fan)", "never mind"]
SPOKEN = ["turn on the light", "turn off the fan", "never mind", "turn on fan"]
PUSH = 1024


def _random_gmms(rng, pdfs=6, dim=39):
    gmms = []
    for p in range(pdfs):
        n = 1 + p % 4
        gmms.append(DiagGmm.from_means_vars(
            rng.dirichlet(np.ones(n)), rng.randn(n, dim), 0.5 + rng.rand(n, dim)))
    return gmms


def _padded(rng):
    """The JAX package's padded arrays, with pdf 2 all padding."""
    jam = JaxGmmAm.from_diag_gmms(_random_gmms(rng))
    jam.gconsts[2] = NEG_HUGE
    jam.means_invvars[2] = 0.0
    jam.inv_vars[2] = 0.0
    return jam, GmmAm.from_numpy(jam.gconsts, jam.means_invvars, jam.inv_vars, device="cpu")


def test_log_likes_match_jax(monkeypatch):
    rng = np.random.RandomState(0)
    jam, am = _padded(rng)
    x = rng.randn(3, 11, 39).astype(np.float32)
    want = np.asarray(jam.log_likes(jnp.asarray(x)))
    got = am.log_likes(torch.as_tensor(x)).numpy()
    assert got.shape == want.shape == (3, 11, 6)
    np.testing.assert_allclose(got, want, rtol=LL_RTOL, atol=LL_ATOL)
    assert (got[..., 2] < -1e29).all()
    # rows in blocks of 4 (9 blocks): each row's arithmetic is the same
    monkeypatch.setattr(gmm_mod, "BLOCK_ELEMS", 4 * am.num_pdfs * am.num_comps)
    np.testing.assert_allclose(am.log_likes(torch.as_tensor(x)).numpy(), got, rtol=1e-6)


def test_chunk_model_windows_match_jax_and_batch():
    rng = np.random.RandomState(1)
    jam, am = _padded(rng)
    feats = rng.randn(1, 30, 13).astype(np.float32)
    batch = am.log_likes(add_deltas(torch.as_tensor(feats))).numpy()[0]
    model, jmodel = GmmChunkModel(am, 7), JaxGmmChunkModel(jam, 7)
    lo, hi = model.ranges["input"]
    assert (lo, hi) == (-4, 11) and model.right_context == 4 and not model.recurrent
    assert model.cast(torch.bfloat16) is model
    for t0, have in ((0, 30), (7, 30), (14, 30), (21, 30), (28, 30), (7, 18)):
        idx = np.clip(np.arange(t0 + lo, t0 + hi), 0, have - 1)
        windows = feats[:, idx]
        got = model(torch.as_tensor(windows)).numpy()[0]
        want = np.asarray(jmodel.forward(jnp.asarray(windows)))[0]
        np.testing.assert_allclose(got, want, rtol=LL_RTOL, atol=LL_ATOL)
        if have == 30:  # the utterance's own edges: the batch rows
            n = min(7, 30 - t0)
            np.testing.assert_allclose(got[:n], batch[t0 : t0 + n], rtol=1e-6, atol=1e-4)
    with pytest.raises(ValueError, match="i-vector"):
        model(torch.as_tensor(feats[:, :15]), torch.zeros(1, 4))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_gmm")
    profile = build_synthetic_gmm_profile(root / "model", LEXICON)
    intents = {"language": "en", "intents": {"Main": {"data": [{"sentences": GRAMMAR}]}}}
    train_model_sync("en", intents, root / "train", profile.model_dir,
                     lang_suffixes=[LangSuffix.GRAMMAR])
    graph_dir = root / "train" / lang_dir_name(LangSuffix.GRAMMAR)
    pcms = [synthesize_sentence(profile, s, seed=60 + i) for i, s in enumerate(SPOKEN)]
    batch = Nnet3WavTranscriber(profile.model_dir, graph_dir, device="cpu").transcribe_pcm_batch(pcms)
    return profile, graph_dir, pcms, batch


def test_am_log_probs_match_jax(trained):
    profile, _graph_dir, pcms, _batch = trained
    am = AcousticModel(profile.model_dir, device="cpu")
    jam = JaxAcousticModel(profile.model_dir)
    assert am.gmm is not None and am.spec is None and am.subsampling == jam.subsampling == 1
    assert not am._has_ivector and am.frontend_config.num_ceps == 20
    feats = np.array(jam.features(jnp.asarray(pcms[0][None])))
    want = np.asarray(jam.log_probs(jnp.asarray(feats), feats.shape[1] + 5))
    got = am.log_probs(torch.as_tensor(feats), feats.shape[1] + 5).numpy()
    assert got.shape == want.shape == (1, feats.shape[1] + 5, am.num_pdfs)
    np.testing.assert_allclose(got, want, rtol=LL_RTOL, atol=LL_ATOL)
    with pytest.raises(ValueError, match="no nnet3 plan"):
        am.compiled(7)


def test_batch_transcripts_equal_jax(trained):
    profile, graph_dir, pcms, batch = trained
    assert batch == [[s] for s in SPOKEN]
    assert JaxTranscriber(profile.model_dir, graph_dir).transcribe_pcm_batch(pcms) == batch


def test_stream_transcriber_equals_batch(trained):
    profile, graph_dir, pcms, batch = trained
    st = Nnet3StreamTranscriber(profile.model_dir, graph_dir, device="cpu")
    assert isinstance(st._chunk_model, GmmChunkModel) and st._chunk_in == 7
    assert [st.transcribe_pcm(p, chunk_samples=PUSH) for p in pcms] == batch


@pytest.mark.parametrize("route", ["device", "host"])
def test_scheduler_equals_batch(trained, monkeypatch, route):
    profile, graph_dir, pcms, batch = trained
    if route == "host":
        monkeypatch.setattr(sched_mod, "_BP_RING_MAX_ARC", -1)
    s = StreamScheduler(profile.model_dir, graph_dir, max_streams=3, device="cpu",
                        pool_capacity_samples=16000 * 10)
    assert s._device_bp == s._device_feats == (route == "device")
    assert s._ivp is None and s._chunk_in == 7 and (s._win_lo, s._win_hi) == (-4, 11)
    sids = [s.open_stream() for _ in pcms[:3]]
    for off in range(0, max(p.shape[0] for p in pcms[:3]), PUSH):
        for sid, pcm in zip(sids, pcms[:3]):
            if off < pcm.shape[0]:
                s.feed(sid, pcm[off : off + PUSH])
        s.step()
    for sid in sids:
        s.finish(sid)
    s.run_until_idle()
    assert [s.poll(sid) for sid in sids] == batch[:3]
    # a recycled slot decodes the next stream from the start
    s.close(sids[1])
    sid = s.open_stream()
    for off in range(0, pcms[3].shape[0], PUSH):
        s.feed(sid, pcms[3][off : off + PUSH])
        s.step()
    s.finish(sid)
    s.run_until_idle()
    assert s.poll(sid) == batch[3]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the MFCC, Viterbi and path-walk kernels run on the card)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_gmm_on_the_card(trained, cuda):
    """On the card: batch transcripts equal the CPU's; a stream makes one
    MFCC launch a push and one Viterbi launch a chunk; the scheduler's
    captured device route makes at most one MFCC, Viterbi and path-walk
    launch a tick, each replay bit-equal to the eager body, and gives the
    batch transcripts."""
    from rhasspy_speech_torch.ops.mfcc_cuda import mfcc_batch
    from rhasspy_speech_torch.ops.viterbi_cuda import viterbi_decode

    profile, graph_dir, pcms, batch = trained
    t = Nnet3WavTranscriber(profile.model_dir, graph_dir, device=cuda)
    before = (mfcc_batch.launches, viterbi_decode.launches)
    assert t.transcribe_pcm_batch(pcms) == batch
    assert mfcc_batch.launches > before[0] and viterbi_decode.launches > before[1]
    st = Nnet3StreamTranscriber(profile.model_dir, graph_dir, device=cuda)
    state = st.start_stream()
    before = (mfcc_batch.launches, viterbi_decode.launches)
    pushes = 0
    for off in range(0, pcms[0].shape[0], PUSH):
        st.process_chunk(state, pcms[0][off : off + PUSH])
        pushes += 1
    assert st.finish_stream(state) == batch[0]
    assert mfcc_batch.launches - before[0] == pushes
    assert viterbi_decode.launches - before[1] == len(state.bps)
    s = StreamScheduler(profile.model_dir, graph_dir, max_streams=4, device=cuda,
                        pool_capacity_samples=16000 * 10)
    assert s._device_bp and s._device_feats
    per_tick, last = [], s.kernel_launches
    sids = [s.open_stream() for _ in pcms]
    for off in range(0, max(p.shape[0] for p in pcms), PUSH):
        for sid, pcm in zip(sids, pcms):
            if off < pcm.shape[0]:
                s.feed(sid, pcm[off : off + PUSH])
        s._runner.check_next = True
        s.step()
        now = s.kernel_launches
        per_tick.append({k: now[k] - last[k] for k in now})
        last = now
    for sid in sids:
        s.finish(sid)
    s.run_until_idle()
    assert [s.poll(sid) for sid in sids] == batch
    # each kernel at most once a tick (the stamps, one a stamp the body takes)
    assert all(max(v for k, v in t.items() if k != "tick_stamp") <= 1 for t in per_tick)
    assert all(v > 0 for v in s.kernel_launches.values())
    assert s._runner.checks and all(all(eq.values()) for _key, eq in s._runner.checks)
