"""The port's G.711 mu-law serving wire against the JAX package's: the
codec contract on the port's copy, the device decode (``decode_u8_torch``,
one 256-entry ``index_select``) bit-equal to the JAX package's
``decode_u8_jnp`` on the same seeded bytes, the native drain's in-copy
encoder byte-equal to the NumPy codec, and the stream scheduler over the
8-bit wire on the CPU: transcripts equal to the JAX scheduler's on the same
synthetic profile and wire, and to the spoken sentences.

The trained synthetic profile (``wire_profile``) is shared with
tests/test_torch_adpcm.py.
"""

import numpy as np
import pytest

import jax

from rhasspy_speech_tpu.ops import mulaw as jax_mulaw
from rhasspy_speech_tpu.pipeline.scheduler import StreamScheduler as JaxScheduler

import torch

from rhasspy_speech_torch.const import LangSuffix
from rhasspy_speech_torch.ops import mulaw
from rhasspy_speech_torch.pipeline import lang_dir_name
from rhasspy_speech_torch.pipeline.scheduler import StreamScheduler
from rhasspy_speech_torch.pipeline.train import train_model_sync
from rhasspy_speech_torch.testing import build_synthetic_profile, synthesize_sentence

from test_torch_pipeline import LEXICON, SENTENCES

WIRE_TEXTS = ["turn on the light", "never mind", "turn off the fan"]
PITCH_LEXICON = {k: LEXICON[k] for k in ("turn", "on", "off", "light")}
PITCH_INTENTS = {"language": "en", "intents": {"M": {"data": [
    {"sentences": ["turn (on|off) light"]}]}}}


@pytest.fixture(scope="module")
def wire_profile(tmp_path_factory):
    """A synthetic profile without an i-vector extractor (so the fused
    device-feature route, the only route with a wire) and its grammar."""
    root = tmp_path_factory.mktemp("torch_wire")
    profile = build_synthetic_profile(root / "model", LEXICON)
    intents = {"language": "en", "intents": {"Main": {"data": [{"sentences": SENTENCES}]}}}
    train_model_sync("en", intents, root / "train", profile.model_dir,
                     lang_suffixes=[LangSuffix.GRAMMAR])
    return profile, root / "train" / lang_dir_name(LangSuffix.GRAMMAR)


def pitch_profile(tmp_path):
    """A synthetic pitch profile with an i-vector and an AM context over
    its tap: the fused route with the pitch lane."""
    profile = build_synthetic_profile(tmp_path / "model", PITCH_LEXICON, with_ivector=True,
                                      with_pitch=True, with_context=True)
    train_model_sync("en", PITCH_INTENTS, str(tmp_path / "train"), profile.model_dir,
                     lang_suffixes=[LangSuffix.GRAMMAR])
    return profile, tmp_path / "train" / lang_dir_name(LangSuffix.GRAMMAR)


def run_interleaved(sched, pcms, push=4096):
    """Feed every stream ``push`` samples a round, a tick after each round,
    then finish and drain: (transcripts, ticks that decoded, device
    programs those ticks made)."""
    sids = [sched.open_stream() for _ in pcms]
    offsets = [0] * len(pcms)
    ticks = dispatches = 0
    while any(offsets[i] < p.shape[0] for i, p in enumerate(pcms)):
        for i, sid in enumerate(sids):
            if offsets[i] < pcms[i].shape[0]:
                sched.feed(sid, pcms[i][offsets[i] : offsets[i] + push])
                offsets[i] += push
        before = sched.device_dispatches
        if sched.step():
            ticks += 1
            dispatches += sched.device_dispatches - before
    for sid in sids:
        sched.finish(sid)
    for _ in range(200):
        if all(sched.poll(sid) is not None for sid in sids):
            break
        sched.step()
    return [sched.poll(sid) for sid in sids], ticks, dispatches


def run_whole(sched, pcms):
    """Feed each stream whole, finish, run until idle: the transcripts."""
    sids = []
    for pcm in pcms:
        sid = sched.open_stream()
        sched.feed(sid, pcm)
        sched.finish(sid)
        sids.append(sid)
    sched.run_until_idle()
    return [sched.poll(sid) for sid in sids]


def test_codec_contract():
    x = np.arange(-32768, 32768, dtype=np.int16)
    enc = mulaw.encode_i16(x)
    dec = mulaw.decode_u8(enc)
    np.testing.assert_array_equal(enc, jax_mulaw.encode_i16(x))
    np.testing.assert_array_equal(mulaw.decode_table(), jax_mulaw.decode_table())

    # truncating-quantizer error bound: below one segment step inside the
    # clip range (bias 0x84, clip 32635)
    mag = np.minimum(np.abs(x.astype(np.int32)), 32635) + 0x84
    exp = (np.floor(np.log2(mag)).astype(np.int32) - 7).clip(0, 7)
    step = (1 << (exp + 3)).astype(np.float32)
    inr = np.abs(x) <= 32635
    assert (np.abs(dec - x)[inr] < step[inr]).all()

    # decoded-value stability: re-encoding a decoded sample reproduces the
    # same decoded value for every codeword; the one collision is -0
    b = np.arange(256, dtype=np.uint8)
    d1 = mulaw.decode_u8(b)
    assert (mulaw.decode_u8(mulaw.encode_f32(d1)) == d1).all()
    assert b[mulaw.encode_f32(d1) != b].tolist() == [0x7F]

    assert mulaw.decode_u8(mulaw.encode_i16(np.int16(0).reshape(1)))[0] == 0.0
    assert (
        mulaw.decode_u8(mulaw.encode_i16(np.int16(-1000).reshape(1)))[0]
        == -mulaw.decode_u8(mulaw.encode_i16(np.int16(1000).reshape(1)))[0]
    )


def test_device_decode_matches_jax():
    """The same seeded bytes through the JAX package's device decode and
    the port's: bit-equal, and equal to the NumPy table."""
    rng = np.random.RandomState(5)
    b = np.concatenate([np.arange(256, dtype=np.uint8),
                        rng.randint(0, 256, 32 * 415 - 256).astype(np.uint8)]).reshape(32, 415)
    want = np.asarray(jax.jit(jax_mulaw.decode_u8_jnp)(b))
    got = mulaw.decode_u8_torch(torch.as_tensor(b))
    assert got.dtype == torch.float32 and tuple(got.shape) == b.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), mulaw.decode_u8(b))


def test_native_encode_matches_python():
    """The native drain's in-copy G.711 encoder agrees byte for byte with
    the NumPy codec (the device decodes with its table)."""
    from rhasspy_speech_torch.native.runtime import StreamPool, get_runtime

    lib = get_runtime().lib
    if lib is None or not hasattr(lib, "rss_pool_read_all_mulaw"):
        pytest.skip("native runtime without the mu-law drain")
    pool = StreamPool(2, capacity_samples=16000)
    a = pool.open()
    b = pool.open()
    rng = np.random.RandomState(3)
    pcm_a = (rng.randn(4000) * 8000).astype(np.int16)
    pcm_b = (rng.randn(3000) * 300).astype(np.float32)  # not int16-exact
    pool.feed(a, pcm_a)
    pool.feed(b, pcm_b)
    out = np.zeros((2, 4100), dtype=np.uint8)
    pool.read_into(out, np.array([7, 0], dtype=np.int64), np.array([4000, 3000], dtype=np.int64))
    np.testing.assert_array_equal(out[0, 7:4007], mulaw.encode_i16(pcm_a))
    np.testing.assert_array_equal(out[1, :3000], mulaw.encode_f32(pcm_b))
    assert (out[0, :7] == 0).all() and (out[0, 4007:] == 0).all()


def test_scheduler_mulaw_wire(wire_profile):
    """Interleaved feeding over the 8-bit wire: transcripts equal the JAX
    scheduler's on the same wire and the spoken sentences, and a decoding
    tick is still one device program."""
    profile, graph_dir = wire_profile
    pcms = [synthesize_sentence(profile, t, seed=300 + i) for i, t in enumerate(WIRE_TEXTS)]
    sched = StreamScheduler(profile.model_dir, graph_dir, max_streams=4, wire="mulaw",
                            device="cpu")
    assert sched._wire == "mulaw" and sched._device_feats
    got, ticks, dispatches = run_interleaved(sched, pcms)
    assert got == [[t] for t in WIRE_TEXTS], got
    assert 0 < ticks and dispatches <= ticks
    jax_sched = JaxScheduler(profile.model_dir, graph_dir, max_streams=4, wire="mulaw")
    assert jax_sched._wire_mulaw
    assert run_interleaved(jax_sched, pcms)[0] == got


def test_scheduler_mulaw_pitch_ivector(tmp_path):
    """The 8-bit wire beside the tick's pitch lane and inline i-vector (the
    decoded PCM feeds the device pitch history ring)."""
    profile, graph_dir = pitch_profile(tmp_path)
    sched = StreamScheduler(profile.model_dir, graph_dir, max_streams=4, wire="mulaw",
                            device="cpu")
    assert sched._wire == "mulaw" and sched._pitch_device
    texts = ["turn on light", "turn off light"]
    pcms = [synthesize_sentence(profile, t, seed=40 + i) for i, t in enumerate(texts)]
    assert run_whole(sched, pcms) == [[t] for t in texts]


def test_scheduler_mulaw_invalid_wire(wire_profile):
    profile, graph_dir = wire_profile
    with pytest.raises(ValueError, match="wire"):
        StreamScheduler(profile.model_dir, graph_dir, max_streams=1, wire="opus", device="cpu")
