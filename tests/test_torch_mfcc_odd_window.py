"""K1's odd padded window (``round_to_power_of_two=false`` with an odd
frame, e.g. ``--frame-length=25.0625`` = 401 samples), which the kernel
computes by Bluestein's algorithm, two frames at a time.

On the CPU: the port's MFCC (the kernel's plain twin) against the JAX
package's ``mfcc_batch`` at N = 401 and N = 399, at K1's stated tolerance
(rtol 2e-3 / atol 3e-2, the JAX package's for its own DFT-as-matmul kernel
against rfft); the kernel's Bluestein path emulated in float32 NumPy from
the wrapper's own table (``bluestein_table``: packing, chirp, Q, the
radix-2 stages, split, the unpaired last frame) against ``np.fft.rfft`` at
N in {201, 399, 401, 511}; and a synthetic profile with a 401-sample window
through the batch, stream and scheduler routes, whose transcripts equal the
JAX batch transcriber's and the spoken sentences. On a card (marker
``cuda``): the kernel against its twin at the same tolerance, at those four
N, with an odd frame count, with and without the dither's noise.
"""

import dataclasses
import json

import numpy as np
import pytest

import jax.numpy as jnp

from rhasspy_speech_tpu.ops.frontend import FrontendConfig as JaxFrontendConfig
from rhasspy_speech_tpu.ops.frontend import make_frontend_params as jax_frontend_params
from rhasspy_speech_tpu.ops.frontend import mfcc_batch as jax_mfcc_batch
from rhasspy_speech_tpu.pipeline import Nnet3WavTranscriber as JaxTranscriber

import torch

from rhasspy_speech_torch.const import LangSuffix
from rhasspy_speech_torch.ops.frontend import FrontendConfig, frame_indices, make_frontend_params
from rhasspy_speech_torch.ops.mfcc_cuda import bluestein_size, bluestein_table, mfcc_batch
from rhasspy_speech_torch.pipeline import Nnet3WavTranscriber, lang_dir_name
from rhasspy_speech_torch.pipeline.scheduler import StreamScheduler
from rhasspy_speech_torch.pipeline.stream import Nnet3StreamTranscriber
from rhasspy_speech_torch.pipeline.train import train_model_sync
from rhasspy_speech_torch.testing import build_synthetic_profile, synthesize_sentence

from test_torch_pipeline import LEXICON, SENTENCES, SPOKEN

RTOL, ATOL = 2e-3, 3e-2
# (frame length ms, snip_edges): 401 and 399 samples at 16 kHz
ODD = {"401": (25.0625, True), "399": (24.9375, False)}
# the Bluestein path's windows: frame length ms = N / 16 at 16 kHz
BLUESTEIN_N = (201, 399, 401, 511)
# Bluestein in f32 against the float64 rfft, as a share of the pair's
# largest bin power: the even window's bound (tests/test_torch_mfcc_fft.py);
# the measured max is 4.1e-7 at N = 511 (two radix-2 FFTs of log2(Q) = 10
# stages and the chirp products, each rounding at ~2^-24 of the pair's
# largest amplitude).
BLUESTEIN_ATOL = 2e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _speech_like(seed, B=3, S=24000):
    rng = np.random.RandomState(seed)
    t = np.arange(S) / 16000.0
    tone = 3000.0 * np.sin(2 * np.pi * (180.0 + 40.0 * rng.rand(B, 1)) * t[None, :])
    return (tone + 600.0 * rng.randn(B, S)).astype(np.float32)


def _config(key):
    ms, snip = ODD[key]
    return dict(frame_length_ms=ms, round_to_power_of_two=False, snip_edges=snip)


def _windowed(cfg, pcm):
    """[B, S] PCM -> [B * T, L] float32 frames after the time-domain steps
    (DC removal, pre-emphasis, window), as the twin computes them."""
    frames = torch.as_tensor(pcm)[:, torch.as_tensor(frame_indices(cfg, pcm.shape[1]))]
    frames = frames - frames.mean(dim=-1, keepdim=True)
    frames = frames - cfg.preemph_coeff * torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
    window = make_frontend_params(cfg, "cpu").window
    return (frames * window).reshape(-1, cfg.frame_length).numpy()


def bluestein_power(frames, n):
    """[F, L] float32 frames -> [F, n // 2 + 1] power spectra of the
    n-point DFT, in the kernel's order and float32 arithmetic: frames 2p and
    2p + 1 packed as z = x1 + i x2 (an odd F leaves the last beside zeros),
    times the chirp, a radix-2 DIF FFT over Q (bit-reversed out), times the
    chirp's bit-reversed spectrum, a radix-2 DIT inverse (natural out), Z_k
    = w_k c_k, and the split X1 = (Z_k + conj Z_{n-k}) / 2, X2 = (Z_k -
    conj Z_{n-k}) / 2i."""
    f32 = np.float32
    F, L = frames.shape
    Q = bluestein_size(n)
    logq = Q.bit_length() - 1
    t = bluestein_table(n)
    twc, tws = t[:Q], t[Q : 2 * Q]
    chc, chs = t[2 * Q : 2 * Q + n], t[2 * Q + n : 2 * Q + 2 * n]
    spr, spi = t[2 * Q + 2 * n : 3 * Q + 2 * n], t[3 * Q + 2 * n :]
    pairs = (F + 1) // 2
    x1, x2 = frames[0::2], np.zeros((pairs, L), f32)
    x2[: F // 2] = frames[1::2]
    re, im = np.zeros((pairs, Q), f32), np.zeros((pairs, Q), f32)
    re[:, :L] = x1 * chc[:L] + x2 * chs[:L]
    im[:, :L] = x2 * chc[:L] - x1 * chs[:L]
    q = np.arange(Q // 2)

    def butterflies(lm):
        m = 1 << lm
        p = q & (m - 1)
        i0 = ((q >> lm) << (lm + 1)) + p
        return i0, i0 + m, twc[m + p], tws[m + p]

    for lm in range(logq - 1, -1, -1):
        i0, i1, c, s = butterflies(lm)
        ar, ai, br, bi = re[:, i0], im[:, i0], re[:, i1], im[:, i1]
        dr, di = ar - br, ai - bi
        re[:, i0], im[:, i0] = ar + br, ai + bi
        re[:, i1], im[:, i1] = dr * c + di * s, di * c - dr * s
    re, im = re * spr - im * spi, re * spi + im * spr
    for lm in range(logq):
        i0, i1, c, s = butterflies(lm)
        br, bi = re[:, i1], im[:, i1]
        tr, ti = br * c - bi * s, bi * c + br * s
        ar, ai = re[:, i0], im[:, i0]
        re[:, i0], im[:, i0] = ar + tr, ai + ti
        re[:, i1], im[:, i1] = ar - tr, ai - ti
    k = np.arange(n // 2 + 1)
    k2 = np.where(k == 0, 0, n - k)
    zr, zi = re[:, k] * chc[k] + im[:, k] * chs[k], im[:, k] * chc[k] - re[:, k] * chs[k]
    yr, yi = re[:, k2] * chc[k2] + im[:, k2] * chs[k2], im[:, k2] * chc[k2] - re[:, k2] * chs[k2]
    half = f32(0.5)
    power = np.empty((2 * pairs, n // 2 + 1), f32)
    power[0::2] = (half * (zr + yr)) ** 2 + (half * (zi - yi)) ** 2
    power[1::2] = (half * (zi + yi)) ** 2 + (half * (zr - yr)) ** 2
    return power[:F]


@pytest.mark.parametrize("n", BLUESTEIN_N)
def test_bluestein_emulation_matches_rfft(n):
    """The kernel's odd-window spectrum, emulated from the wrapper's own
    table, against the float64 rfft of the same windowed frames; an odd
    frame count leaves the last frame unpaired."""
    cfg = FrontendConfig(frame_length_ms=n / 16.0, round_to_power_of_two=False)
    assert cfg.padded_window_size == cfg.frame_length == n
    assert bluestein_size(n) >= 2 * n - 1
    frames = _windowed(cfg, _speech_like(n, B=1, S=n + 160 * 8))
    assert frames.shape == (9, n)
    got = bluestein_power(frames, n)
    spec = np.fft.rfft(frames.astype(np.float64), n=n, axis=-1)
    want = spec.real ** 2 + spec.imag ** 2
    pair_max = np.repeat(want.reshape(-1)[: 8 * want.shape[1]].reshape(4, -1).max(axis=1), 2)
    scale = np.append(pair_max, want[8].max())[:, None]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=BLUESTEIN_ATOL)


@pytest.mark.parametrize("key", sorted(ODD))
def test_twin_matches_jax(key):
    cfg = FrontendConfig(**_config(key))
    assert cfg.padded_window_size == int(key) and cfg.padded_window_size % 2
    pcm = _speech_like(int(key))
    got = mfcc_batch(make_frontend_params(cfg, "cpu"), torch.as_tensor(pcm)).numpy()
    jcfg = JaxFrontendConfig(**_config(key))
    want = np.asarray(jax_mfcc_batch(jax_frontend_params(jcfg), jnp.asarray(pcm)))
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def odd_profile(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_odd_window")
    frontend = dataclasses.replace(FrontendConfig(), **_config("401"))
    profile = build_synthetic_profile(root / "model", LEXICON, frontend=frontend)
    # the profile's frontend.json keeps the mel fields only: add the window
    path = profile.model_dir / "model" / "frontend.json"
    conf = json.loads(path.read_text(encoding="utf-8"))
    conf.update(frame_length_ms=frontend.frame_length_ms, round_to_power_of_two=False)
    path.write_text(json.dumps(conf), encoding="utf-8")
    intents = {"language": "en", "intents": {"Main": {"data": [{"sentences": SENTENCES}]}}}
    train_model_sync("en", intents, root / "train", profile.model_dir,
                     lang_suffixes=[LangSuffix.GRAMMAR])
    graph_dir = root / "train" / lang_dir_name(LangSuffix.GRAMMAR)
    pcms = [synthesize_sentence(profile, t, seed=40 + i) for i, t in enumerate(SPOKEN)]
    return profile, graph_dir, pcms


def test_routes_with_odd_window(odd_profile):
    """Batch, stream and scheduler (fused device-feature route) with a
    401-sample window transcribe the spoken sentences, as the JAX batch
    transcriber does."""
    profile, graph_dir, pcms = odd_profile
    t = Nnet3WavTranscriber(profile.model_dir, graph_dir, device="cpu")
    assert t.am.frontend_config.padded_window_size == 401
    want = [[s] for s in SPOKEN]
    assert t.transcribe_pcm_batch(pcms) == want
    assert JaxTranscriber(profile.model_dir, graph_dir).transcribe_pcm_batch(pcms) == want
    st = Nnet3StreamTranscriber(profile.model_dir, graph_dir, device="cpu")
    assert [st.transcribe_pcm(p, chunk_samples=1024) for p in pcms] == want
    sched = StreamScheduler(profile.model_dir, graph_dir, max_streams=4, device="cpu")
    assert sched._device_feats
    sids = []
    for p in pcms:
        sid = sched.open_stream()
        sched.feed(sid, p)
        sched.finish(sid)
        sids.append(sid)
    sched.run_until_idle()
    assert [sched.poll(sid) for sid in sids] == want


@pytest.mark.cuda
@pytest.mark.parametrize("key", sorted(ODD))
def test_kernel_matches_twin(cuda, key):
    cfg = FrontendConfig(**_config(key))
    pcm = torch.as_tensor(_speech_like(int(key) + 1))
    want = mfcc_batch(make_frontend_params(cfg, "cpu"), pcm)
    before = mfcc_batch.launches
    got = mfcc_batch(make_frontend_params(cfg, cuda), pcm.to(cuda))
    torch.cuda.synchronize()
    assert mfcc_batch.launches == before + 1
    torch.testing.assert_close(got.cpu(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dither", [False, True], ids=["plain", "dither"])
@pytest.mark.parametrize("n", BLUESTEIN_N)
def test_bluestein_kernel_matches_twin(cuda, n, dither):
    """The Bluestein kernel against its twin at every odd N of the CPU
    emulation, with an odd frame count (the last frame unpaired), with and
    without the dither's noise."""
    cfg = FrontendConfig(frame_length_ms=n / 16.0, round_to_power_of_two=False,
                         dither=1.0 if dither else 0.0)
    S = n + 160 * 20
    pcm = torch.as_tensor(_speech_like(n + 2, B=3, S=S))
    T = 21
    assert (S - n) // 160 + 1 == T
    noise = None
    if dither:
        noise = torch.as_tensor(np.random.RandomState(n).randn(3, T, n).astype(np.float32))
    want = mfcc_batch(make_frontend_params(cfg, "cpu"), pcm, noise)
    before = mfcc_batch.launches
    got = mfcc_batch(make_frontend_params(cfg, cuda), pcm.to(cuda),
                     None if noise is None else noise.to(cuda))
    torch.cuda.synchronize()
    assert mfcc_batch.launches == before + 1
    assert got.shape == want.shape == (3, T, cfg.num_ceps)
    torch.testing.assert_close(got.cpu(), want, rtol=RTOL, atol=ATOL)
