"""The full-width model directories of ``testing/full_width.py``, written at
reduced sizes on the CPU (the published shapes run on the card, in
chip_smoke.py), read by the port and by the JAX package alike.

- tri1 (GMM): 1 to 10 Gaussians a pdf summing to the total; the model
  dir's ``conf/mfcc.conf`` gives 13 cepstra from 23 mel bins up to
  Nyquist; the port's log-probs of seeded noise equal the JAX package's
  within rtol 1e-5 / atol 5e-2 and have a trained model's scale (finite,
  between -1e3 and 0). The atol is wider than tests/test_torch_gmm.py's:
  a log-likelihood near -70 here is the f32 sum of terms near 1e4 (the
  gconst, x . mu/var and x^2 . 1/var of noise's c0 and its deltas), whose
  ulps alone reach 1e-3 each.
- DeepSpeech (Coqui): the ``model.tflite`` converts to the CTC layout
  (three dense layers over +-9 frames of 26 cepstra, an LSTM with the
  forget bias baked in, a post layer, 29 labels) bit-equal to the JAX
  conversion; the alphabet loads as 28 characters + blank; probs equal the
  JAX transcriber's within tests/test_torch_coqui.py's tolerance (rtol 1e-4
  / atol 1e-6).
"""

import numpy as np

import jax.numpy as jnp

from rhasspy_speech_tpu.io.tflite import convert_coqui_tflite as jax_convert
from rhasspy_speech_tpu.pipeline.coqui import CoquiSttTranscriber as JaxCoqui
from rhasspy_speech_tpu.pipeline.transcribe import AcousticModel as JaxAcousticModel

import torch

from rhasspy_speech_torch import train_model_sync
from rhasspy_speech_torch.io.transition_model import KaldiTransitionModel
from rhasspy_speech_torch.pipeline.coqui import BLANK, CoquiSttTranscriber
from rhasspy_speech_torch.pipeline.transcribe import AcousticModel
from rhasspy_speech_torch.testing.full_width import (
    DEEPSPEECH_ALPHABET,
    gauss_counts,
    write_deepspeech_model_dir,
    write_tri1_model_dir,
)

PCM = (1000.0 * np.random.RandomState(0).randn(24000)).astype(np.float32)


def test_tri1_model_dir(tmp_path):
    counts = gauss_counts(np.random.RandomState(1), 2000, 10000, 10)
    assert counts.sum() == 10000 and counts.min() == 1 and counts.max() == 10
    model_dir = write_tri1_model_dir(tmp_path, KaldiTransitionModel.from_monophone_chain(6),
                                     "<eps> 0\n", seed=2, num_pdfs=40, num_gauss=200)
    am = AcousticModel(model_dir, device="cpu")
    cfg = am.frontend_config
    assert (cfg.num_ceps, cfg.num_mel_bins, cfg.high_freq, cfg.use_energy) == (13, 23, 0.0, False)
    assert (am.gmm.num_pdfs, am.gmm.dim, am.subsampling) == (40, 39, 1)
    feats = am.features(torch.as_tensor(PCM[None]))
    got = am.log_probs(feats, feats.shape[1]).numpy()
    jam = JaxAcousticModel(model_dir)
    want = np.asarray(jam.log_probs(jnp.asarray(feats.numpy()), feats.shape[1]))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=5e-2)
    assert np.isfinite(got).all() and -1e3 < got.min() and got.max() < 0.0


def test_deepspeech_model_dir(tmp_path):
    model_dir = write_deepspeech_model_dir(tmp_path / "model", seed=3, n_hidden=24)
    intents = {"language": "en", "intents": {"M": {"data": [{"sentences": ["turn on light"]}]}}}
    train_model_sync("en", intents, tmp_path / "train", model_dir)
    t = CoquiSttTranscriber(model_dir, tmp_path / "train", device="cpu")
    m = t.model
    assert (m.num_labels, m.context, m.has_lstm, m.lstm_hidden) == (29, 9, True, 24)
    assert tuple(m.params["dense1_w"].shape) == (26 * 19, 24)
    assert float(m.params["lstm_forget_bias"]) == 0.0
    assert [t.idx2char[i] for i in sorted(t.idx2char)][-1] == BLANK
    assert len(t.idx2char) == len(DEEPSPEECH_ALPHABET) + 1
    assert t.frontend_config.padded_window_size == 512 and t.frontend_config.frame_shift == 320
    theirs = jax_convert(model_dir / "model.tflite")
    for k, v in theirs.params.items():
        np.testing.assert_array_equal(m.params[k].numpy(), np.asarray(v))
    jt = JaxCoqui(model_dir, tmp_path / "train")
    np.testing.assert_allclose(t.compute_probs(PCM), jt.compute_probs(PCM), rtol=1e-4, atol=1e-6)
