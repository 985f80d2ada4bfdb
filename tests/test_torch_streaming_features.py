"""The port's incremental feature assembly against the JAX package's.

``StreamFeaturizer`` rows over uneven chunkings, for ``snip_edges`` true and
false, against the JAX featurizer's rows at the same chunking and against
the port's batch rows, within ``testing/feature_tolerance.py``'s allowance
for two f32 front ends on the batch frames of the whole PCM (rtol 1e-4 /
atol 2e-3, widened only on ill-conditioned frames), as
tests/test_torch_frontend.py holds the port's MFCC against the JAX
package's. A framing fault shifts whole windows and misses that by orders
of magnitude. The host functions copied
from the JAX module (``_reflect_idx``, ``stage_ivector_window``,
``silence_weights_from_chunk``, ``online_cmvn_numpy``) must equal their
originals exactly.
"""

import types

import numpy as np
import pytest

from rhasspy_speech_tpu.ops import frontend as jfe
from rhasspy_speech_tpu.ops import pitch as jp
from rhasspy_speech_tpu.pipeline import streaming_features as jsf

import torch

from rhasspy_speech_torch.ops import frontend as tfe
from rhasspy_speech_torch.ops import pitch as tp
from rhasspy_speech_torch.ops.mfcc_cuda import mfcc_batch
from rhasspy_speech_torch.pipeline import streaming_features as tsf
from rhasspy_speech_torch.testing.feature_tolerance import (
    assert_mfcc_close,
    frames_of,
    mfcc_allowance,
)

CFG = dict(num_mel_bins=23, num_ceps=13)


def _jax_am(snip):
    cfg = jfe.FrontendConfig(snip_edges=snip, **CFG)
    return types.SimpleNamespace(frontend_config=cfg, frontend_params=jfe.make_frontend_params(cfg),
                                 pitch_config=None)


def _torch_am(snip):
    cfg = tfe.FrontendConfig(snip_edges=snip, **CFG)
    return types.SimpleNamespace(frontend_config=cfg, device=torch.device("cpu"),
                                 frontend_params=tfe.make_frontend_params(cfg, "cpu"))


def _allowance(am, pcm):
    cfg = am.frontend_config
    return mfcc_allowance(cfg, frames_of(cfg, pcm), sides=2)


def _stream_rows(fz, pcm, chunks):
    state = fz.new_state()
    rows, off = [], 0
    for c in chunks:
        rows.append(fz.push(state, pcm[off : off + c]))
        off += c
    rows.append(fz.push(state, pcm[off:], flush=True))
    return np.concatenate([np.zeros((0, fz.num_ceps), np.float32)] + rows, axis=0)


@pytest.mark.parametrize("snip", [True, False], ids=["snip", "no_snip"])
@pytest.mark.parametrize(
    "n_samples,chunks",
    [
        (16000, [1024] * 10),
        (16000, [160, 3360, 7, 4000, 1]),
        (4321, [4321]),
        (399, [399]),  # under one frame window
        (100, [100]),  # shorter than the reflection prefix
        (80, [80]),  # exactly one centered frame (snip_edges=false)
        (16013, [16013]),
    ],
)
def test_featurizer_matches_jax_and_batch(snip, n_samples, chunks):
    pcm = (1000.0 * np.random.RandomState(7).randn(n_samples)).astype(np.float32)
    am = _torch_am(snip)
    got = _stream_rows(tsf.StreamFeaturizer(am), pcm, chunks)
    want = _stream_rows(jsf.StreamFeaturizer(_jax_am(snip)), pcm, chunks)
    assert got.shape == want.shape == (tfe.num_frames(am.frontend_config, n_samples), 13)
    allow = _allowance(am, pcm)
    assert_mfcc_close(got, want, allow)
    if got.shape[0]:
        batch = mfcc_batch(am.frontend_params, torch.as_tensor(pcm[None]))[0].numpy()
        assert_mfcc_close(got, batch, allow)


def test_prepare_commit_contract_matches_batch():
    """The batched-MFCC path (``prepare_mfcc_buf`` / ``commit_mfcc``) sees
    virtual-signal buffers and lands the batch rows."""
    am = _torch_am(False)
    fz = tsf.StreamFeaturizer(am)
    pcm = (1000.0 * np.random.RandomState(3).randn(9000)).astype(np.float32)
    state, rows = fz.new_state(), []
    for off in range(0, 9000, 2048):
        chunk = pcm[off : off + 2048]
        r = fz.prepare_mfcc_buf(state, chunk)
        if r is None:
            continue
        buf, n = r
        feats = mfcc_batch(fz.stream_params, torch.as_tensor(buf[None]))[0][:n].numpy()
        fz.commit_mfcc(state, buf, n)
        rows.append(feats)
    rows.append(fz.push(state, np.zeros(0, np.float32), flush=True))
    got = np.concatenate(rows, axis=0)
    want = mfcc_batch(am.frontend_params, torch.as_tensor(pcm[None]))[0].numpy()
    assert got.shape == want.shape
    assert_mfcc_close(got, want, _allowance(am, pcm))


@pytest.mark.parametrize("snip", [True, False], ids=["snip", "no_snip"])
def test_push_with_base_equals_original(snip):
    """The scheduler's batched path: the same PCM and the same batched rows
    through the JAX featurizer's ``push_with_base`` and the port's give the
    same rows and sample counts, and the rows equal the batch rows."""
    pcm = (1000.0 * np.random.RandomState(8).randn(7000)).astype(np.float32)
    am = _torch_am(snip)
    tfz, jfz = tsf.StreamFeaturizer(am), jsf.StreamFeaturizer(_jax_am(snip))
    tstate, jstate = tfz.new_state(), jfz.new_state()
    rows, off = [], 0
    for n in (100, 1024, 7, 3000, 1024, 1845):
        chunk = pcm[off : off + n]
        off += n
        r, jr = tfz.prepare_mfcc_buf(tstate, chunk), jfz.prepare_mfcc_buf(jstate, chunk)
        base = np.zeros((0, 13), np.float32)
        if r is not None:
            buf, k = r
            np.testing.assert_array_equal(buf, jr[0])
            assert k == jr[1]
            base = mfcc_batch(tfz.stream_params, torch.as_tensor(buf[None]))[0][:k].numpy()
            tfz.commit_mfcc(tstate, buf, k)
            jfz.commit_mfcc(jstate, *jr)
        got = tfz.push_with_base(tstate, chunk, base)
        np.testing.assert_array_equal(got, jfz.push_with_base(jstate, chunk, base))
        assert tstate.total_samples == jstate.total_samples == off
        rows.append(got)
    rows.append(tfz.push(tstate, np.zeros(0, np.float32), flush=True))
    want = mfcc_batch(am.frontend_params, torch.as_tensor(pcm[None]))[0].numpy()
    assert_mfcc_close(np.concatenate(rows, axis=0), want, _allowance(am, pcm))
    # a pitch featurizer pairs the MFCC rows with the pitch rows it is
    # given, as the JAX featurizer does; both refuse pitch with
    # snip_edges=false
    pam, jpam = _torch_am(snip), _jax_am(snip)
    pam.pitch_config, jpam.pitch_config = tp.PitchConfig(), jp.PitchConfig()
    if not snip:
        with pytest.raises(NotImplementedError, match="snip_edges"):
            tsf.StreamFeaturizer(pam)
        return
    pfz, jpfz = tsf.StreamFeaturizer(pam), jsf.StreamFeaturizer(jpam)
    ps, jps = pfz.new_state(), jpfz.new_state()
    pitch = np.random.RandomState(9).randn(5, 3).astype(np.float32)
    merged = []
    for chunk, mfcc_rows, pitch_rows in ((pcm[:800], want[:5], pitch[:3]),
                                         (pcm[800:900], want[:0], pitch[3:])):
        got = pfz.push_with_base(ps, chunk, mfcc_rows, pitch_rows=pitch_rows)
        np.testing.assert_array_equal(
            got, jpfz.push_with_base(jps, chunk, mfcc_rows, pitch_rows=pitch_rows))
        merged.append(got)
    assert [m.shape[0] for m in merged] == [3, 2]
    np.testing.assert_array_equal(np.concatenate(merged), np.concatenate([want[:5], pitch], axis=1))


def test_copied_reflect_idx_equals_original():
    for n in (1, 3, 80, 400):
        idx = np.arange(-2 * n - 3, 3 * n + 3)
        np.testing.assert_array_equal(tsf._reflect_idx(idx, n), jsf._reflect_idx(idx, n))


@pytest.mark.parametrize("with_stats", [True, False])
def test_copied_ivector_window_and_cmvn_equal_original(with_stats):
    rng = np.random.RandomState(5)
    feats = (rng.randn(70, 6) * 3 + 2).astype(np.float32)
    stats = None
    if with_stats:
        stats = np.concatenate([np.full((1, 6), 150.0), [[60.0]]], axis=1)
        stats = np.concatenate([stats, np.zeros((1, 7))], axis=0)
    np.testing.assert_array_equal(
        tsf.online_cmvn_numpy(feats, stats, cmn_window=20, global_frames=7),
        jsf.online_cmvn_numpy(feats, stats, cmn_window=20, global_frames=7))
    for t0, have in ((0, 30), (21, 70), (63, 66), (63, 70)):
        got = tsf.stage_ivector_window(feats, t0, 21, have, 3, 3, stats)
        want = jsf.stage_ivector_window(feats, t0, 21, have, 3, 3, stats)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("k_best", [1, 3])
def test_copied_silence_weights_from_chunk_equals_original(k_best):
    rng = np.random.RandomState(6)
    S, A, Tc = 9, 30, 7
    arc_pdf, arc_src = rng.randint(0, 8, size=A), rng.randint(0, S, size=A)
    sil = np.asarray([1, 4, 5])
    shape = (Tc, S) if k_best == 1 else (Tc, S, k_best)
    bp = rng.randint(-2, A * k_best, size=shape).astype(np.int32)
    alpha = rng.rand(*shape[1:]).astype(np.float32)
    np.testing.assert_array_equal(
        tsf.silence_weights_from_chunk(bp, alpha, arc_pdf, arc_src, sil, k_best=k_best),
        jsf.silence_weights_from_chunk(bp, alpha, arc_pdf, arc_src, sil, k_best=k_best))
    assert tsf.silence_weights_from_chunk(bp, alpha, arc_pdf, arc_src, np.zeros(0, np.int64)) is None
    assert tsf.silence_weights_from_chunk(bp[:0], alpha, arc_pdf, arc_src, sil) is None
