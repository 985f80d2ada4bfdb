"""The port's Coqui STT (CTC) backend against the JAX package's, on the CPU.

- The synthetic CTC profile (``build_synthetic_ctc_profile``: one Gaussian
  class a character, 20 cepstra) the port writes equals the JAX package's
  file for file; ``train_model`` on it with ``"type": "coqui"`` writes
  ``token2sen.fst`` and both symbol tables equal to the JAX package's as
  text.
- ``transcribe_pcm`` and the stream triple (``start_stream`` /
  ``process_chunk`` / ``finish_stream``, 1,024-sample chunks) give the JAX
  package's text and the spelled text; ``compute_probs`` equals the JAX
  package's within rtol 1e-4 / atol 1e-6 (features within the MFCC's CPU
  tolerance, tests/test_torch_frontend.py, through one affine layer and a
  softmax), and the streamed probs equal ``compute_probs`` within the JAX
  package's streaming tolerance (rtol 2e-5 / atol 2e-6,
  tests/test_coqui.py).
- A DeepSpeech-shaped model dir that ships only ``model.tflite`` (three
  dense layers over +-4 spliced frames, an LSTM, a post layer; converted to
  ``model.npz`` on first load): the same two tolerances against the JAX
  transcriber and between stream and batch.
- The async contract of the reference (one implicit stream, int16 bytes
  in, prob rows out, the error classes) holds as in the JAX package.
"""

import asyncio
import json

import numpy as np
import pytest
import torch

from rhasspy_speech_tpu.pipeline.coqui import CoquiSttTranscriber as JaxTranscriber
from rhasspy_speech_tpu.pipeline.train import train_model_sync as jax_train_model_sync
from rhasspy_speech_tpu.testing.synthetic import (
    build_synthetic_ctc_profile as jax_build_synthetic_ctc_profile,
)

from rhasspy_speech_torch import train_model_sync
from rhasspy_speech_torch.io.tflite import build_tflite
from rhasspy_speech_torch.pipeline.coqui import (
    CoquiSttError,
    CoquiSttTranscriber,
    StreamAlreadyStartedError,
    StreamNotStartedError,
)
from rhasspy_speech_torch.testing.synthetic import build_synthetic_ctc_profile, synthesize_ctc_text

SENTENCES = ["turn (on|off) light", "stop"]
CHARS = sorted(set("turnonofflightstop"))
TEXTS = ["turn on light", "stop", "turn off light"]
PRUNE = 30.0  # synthetic char boundaries are harsher than speech (tests/test_coqui.py)
PROB_RTOL, PROB_ATOL = 1e-4, 1e-6
STREAM_RTOL, STREAM_ATOL = 2e-5, 2e-6
CHUNK = 1024
INTENTS = {"language": "en", "intents": {"Main": {"data": [{"sentences": SENTENCES}]}}}
ARTIFACTS = ("token2sen.fst", "tokens_with_blank.txt", "output.txt")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_coqui")
    profile = build_synthetic_ctc_profile(root / "model", CHARS)
    jax_build_synthetic_ctc_profile(root / "jax_model", CHARS)
    for d in (root / "model", root / "jax_model"):
        (d / "config.json").write_text(json.dumps({"type": "coqui"}), encoding="utf-8")
    train_model_sync("en", INTENTS, root / "train", profile.model_dir)
    jax_train_model_sync("en", INTENTS, root / "jax_train", profile.model_dir)
    return root, profile


def _stream(t, pcm):
    state = t.start_stream()
    for off in range(0, pcm.shape[0], CHUNK):
        t.process_chunk(state, pcm[off : off + CHUNK])
    return state


def test_profile_and_artifacts_equal_jax(trained):
    root, _profile = trained
    for name in ("alphabet.txt", "frontend.json"):
        assert (root / "model" / name).read_bytes() == (root / "jax_model" / name).read_bytes()
    with np.load(root / "model" / "model.npz") as a, np.load(root / "jax_model" / "model.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    for name in ARTIFACTS:
        got = (root / "train" / name).read_text(encoding="utf-8")
        assert got and got == (root / "jax_train" / name).read_text(encoding="utf-8"), name


@pytest.mark.parametrize("i", range(len(TEXTS)))
def test_transcribe_and_stream_equal_jax(trained, i):
    root, profile = trained
    t = CoquiSttTranscriber(root / "model", root / "train", device="cpu")
    jt = JaxTranscriber(root / "model", root / "jax_train")
    pcm = synthesize_ctc_text(profile, TEXTS[i], seed=i)
    probs = t.compute_probs(pcm)
    np.testing.assert_allclose(probs, jt.compute_probs(pcm), rtol=PROB_RTOL, atol=PROB_ATOL)
    assert t.transcribe_pcm(pcm, prune_threshold=PRUNE) == TEXTS[i]
    assert jt.transcribe_pcm(pcm, prune_threshold=PRUNE) == TEXTS[i]
    state = _stream(t, pcm)
    assert t.finish_stream(state, prune_threshold=PRUNE) == TEXTS[i]
    np.testing.assert_allclose(np.concatenate(state.probs), probs, rtol=STREAM_RTOL, atol=STREAM_ATOL)


def test_deepspeech_tflite_model_dir_equals_jax(trained, tmp_path):
    """A tflite-only DeepSpeech-shaped dir: probs against the JAX package's
    and stream against batch."""
    root, profile = trained
    rng = np.random.RandomState(5)
    n_in, ctx, hidden = 20, 4, 24
    labels = len(profile.chars) + 1
    shapes = {
        "layer_1/weights": (n_in * (2 * ctx + 1), hidden), "layer_1/bias": (hidden,),
        "layer_2/weights": (hidden, hidden), "layer_2/bias": (hidden,),
        "layer_3/weights": (hidden, hidden), "layer_3/bias": (hidden,),
        "lstm/kernel": (2 * hidden, 4 * hidden), "lstm/bias": (4 * hidden,),
        "layer_5/weights": (hidden, hidden), "layer_5/bias": (hidden,),
        "layer_6/weights": (hidden, labels), "layer_6/bias": (labels,),
    }
    weights = {k: (0.1 * rng.randn(*s)).astype(np.float32) for k, s in shapes.items()}
    model_dir = tmp_path / "deepspeech"
    model_dir.mkdir()
    (model_dir / "model.tflite").write_bytes(
        build_tflite(weights, input_shape=[1, 16, 2 * ctx + 1, n_in]))
    for name in ("alphabet.txt", "frontend.json"):
        (model_dir / name).write_bytes((root / "model" / name).read_bytes())
    t = CoquiSttTranscriber(model_dir, root / "train", device="cpu")
    assert (model_dir / "model.npz").exists() and t.model.has_lstm and t.model.context == ctx
    jt = JaxTranscriber(model_dir, root / "jax_train")
    pcm = synthesize_ctc_text(profile, "turn off light", seed=7)
    probs = t.compute_probs(pcm)
    np.testing.assert_allclose(probs, jt.compute_probs(pcm), rtol=PROB_RTOL, atol=PROB_ATOL)
    state = _stream(t, pcm)
    t.finish_stream(state)
    np.testing.assert_allclose(np.concatenate(state.probs), probs, rtol=STREAM_RTOL, atol=STREAM_ATOL)


def test_async_stream_contract(trained):
    root, profile = trained
    t = CoquiSttTranscriber(root / "model", root / "train", device="cpu")
    pcm = synthesize_ctc_text(profile, "stop", seed=21)
    data = pcm.astype(np.int16).tobytes()

    async def drive():
        with pytest.raises(StreamNotStartedError):
            await t.async_process_chunk(b"\x00\x00")
        await t.async_start_stream()
        with pytest.raises(StreamAlreadyStartedError):
            await t.async_start_stream()
        with pytest.raises(CoquiSttError, match="whole 16-bit"):
            await t.async_process_chunk(b"\x00\x00\x00")
        for off in range(0, len(data), 2 * CHUNK):
            await t.async_process_chunk(data[off : off + 2 * CHUNK])
        rows = await t.async_finish_stream()
        with pytest.raises(StreamNotStartedError):
            await t.async_finish_stream()
        await t.async_start_stream()
        await t.stop()
        await t.async_start_stream()  # stop() dropped the open stream
        await t.stop()
        return rows

    rows = asyncio.run(drive())
    assert rows and len(rows[0]) == t.model.num_labels
    assert t.decode_probs(np.asarray(rows), prune_threshold=PRUNE) == "stop"
    want = t.compute_probs(pcm.astype(np.int16).astype(np.float32))
    np.testing.assert_allclose(np.asarray(rows), want, rtol=STREAM_RTOL, atol=STREAM_ATOL)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the MFCC kernel runs on the card)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_coqui_on_the_card(trained, cuda):
    """On the card: probs equal the CPU's (rtol 1e-3 / atol 1e-4: the MFCC
    kernel against its twin, through an affine layer and a softmax), the
    streamed probs equal compute_probs within the streaming tolerance, one
    MFCC launch a push that completes a frame, and the spelled texts
    decode to themselves, batch and streamed."""
    from rhasspy_speech_torch.ops.mfcc_cuda import mfcc_batch

    root, profile = trained
    t = CoquiSttTranscriber(root / "model", root / "train", device=cuda)
    tc = CoquiSttTranscriber(root / "model", root / "train", device="cpu")
    for i, text in enumerate(TEXTS):
        pcm = synthesize_ctc_text(profile, text, seed=i)
        before = mfcc_batch.launches
        probs = t.compute_probs(pcm)
        assert mfcc_batch.launches == before + 1
        np.testing.assert_allclose(probs, tc.compute_probs(pcm), rtol=1e-3, atol=1e-4)
        assert t.transcribe_pcm(pcm, prune_threshold=PRUNE) == text
        before, framed = mfcc_batch.launches, 0
        state = t.start_stream()
        for off in range(0, pcm.shape[0], CHUNK):
            chunk = pcm[off : off + CHUNK]
            framed += state.sample_tail.shape[0] + chunk.shape[0] >= t.frontend_config.frame_length
            t.process_chunk(state, chunk)
        assert mfcc_batch.launches - before == framed > 0
        assert t.finish_stream(state, prune_threshold=PRUNE) == text
        np.testing.assert_allclose(np.concatenate(state.probs), probs, rtol=STREAM_RTOL,
                                   atol=STREAM_ATOL)
