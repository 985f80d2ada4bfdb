"""The port's TFLite reader, writer and Coqui converter against the JAX
package's, on the CPU.

``rhasspy_speech_torch/io/tflite.py`` is a copy of the JAX package's module
(tests/test_torch_host_layers.py holds it to the original apart from the
converter's two edits). Here: the port's ``build_tflite`` writes the same
bytes as the original, both readers read them to the same tensors; a
DeepSpeech-named flatbuffer converts to parameters bit-equal to the JAX
conversion's, with the same context and LSTM flags; the ``model.npz`` each
side writes loads on the other; and the converted model's forward equals
the JAX converted model's within tests/test_torch_ctc.py's tolerance.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from rhasspy_speech_tpu.io import tflite as jt
from rhasspy_speech_tpu.models.ctc import CtcModel as JaxCtcModel

import torch

from rhasspy_speech_torch.io import tflite as tt
from rhasspy_speech_torch.models.ctc import CtcModel

LSTM = "cudnn_lstm/rnn/multi_rnn_cell/cell_0/cudnn_compatible_lstm_cell/"


def _deepspeech_weights(rng, n_input=26, context=4, hidden=12, labels=7):
    d_in = n_input * (2 * context + 1)
    shapes = {
        "layer_1/weights": (d_in, hidden), "layer_1/bias": (hidden,),
        "layer_2/weights": (hidden, hidden), "layer_2/bias": (hidden,),
        "layer_3/weights": (hidden, hidden), "layer_3/bias": (hidden,),
        LSTM + "kernel": (2 * hidden, 4 * hidden), LSTM + "bias": (4 * hidden,),
        "layer_5/weights": (hidden, hidden), "layer_5/bias": (hidden,),
        "layer_6/weights": (hidden, labels), "layer_6/bias": (labels,),
    }
    return {k: (0.3 * rng.randn(*s)).astype(np.float32) for k, s in shapes.items()}


def test_flatbuffer_round_trip_equals_original(tmp_path):
    rng = np.random.RandomState(0)
    weights = {
        "layer_1/weights": rng.randn(26, 16).astype(np.float32),
        "layer_1/bias": rng.randn(16).astype(np.float32),
        "some/int/tensor": np.arange(12, dtype=np.int32).reshape(3, 4),
    }
    blob = tt.build_tflite(weights, input_shape=[1, 8, 19, 26], alphabet="ab\n")
    assert blob == jt.build_tflite(weights, input_shape=[1, 8, 19, 26], alphabet="ab\n")
    path = tmp_path / "m.tflite"
    path.write_bytes(blob)
    ours, theirs = tt.read_tflite(path), jt.read_tflite(path)
    assert (ours.inputs, ours.outputs, ours.description) == (
        theirs.inputs, theirs.outputs, theirs.description)
    assert [(t.name, t.shape, t.type_code) for t in ours.tensors] == [
        (t.name, t.shape, t.type_code) for t in theirs.tensors]
    named = ours.by_name()
    for name, arr in weights.items():
        np.testing.assert_array_equal(named[name].data, arr)
    assert named["input_node"].data is None
    assert named["metadata_alphabet"].data.tobytes() == b"ab\n"
    bad = tmp_path / "bad.tflite"
    bad.write_bytes(b"\x00\x00\x00\x00NOPE rest of file")
    with pytest.raises(ValueError, match="TFL3"):
        tt.read_tflite(bad)


@pytest.mark.parametrize("lstm", [True, False], ids=["deepspeech", "affine"])
def test_convert_coqui_tflite_bit_equal_to_jax(tmp_path, lstm):
    rng = np.random.RandomState(1)
    weights = _deepspeech_weights(rng, context=3, hidden=10, labels=5)
    if not lstm:
        weights = {k: v for k, v in weights.items() if k.startswith("layer_1/")}
    path = tmp_path / "model.tflite"
    path.write_bytes(tt.build_tflite(weights, input_shape=[1, 12, 7, 26], alphabet="a\nb\n"))
    ours = tt.convert_coqui_tflite(path, npz_path=tmp_path / "ours.npz",
                                   alphabet_path=tmp_path / "alphabet.txt", device="cpu")
    theirs = jt.convert_coqui_tflite(path, npz_path=tmp_path / "theirs.npz")
    assert isinstance(ours, CtcModel) and ours.device == torch.device("cpu")
    assert (ours.num_labels, ours.context, ours.has_lstm) == (
        theirs.num_labels, theirs.context, theirs.has_lstm)
    assert set(ours.params) == set(theirs.params)
    for k, v in theirs.params.items():
        np.testing.assert_array_equal(ours.params[k].numpy(), np.asarray(v))
    assert (tmp_path / "alphabet.txt").read_text(encoding="utf-8") == "a\nb\n"
    # each side's model.npz loads on the other
    feats = rng.randn(2, 12, 26).astype(np.float32)
    want = np.asarray(theirs.forward(jnp.asarray(feats)))
    for model in (ours, CtcModel.load(str(tmp_path / "theirs.npz"), device="cpu")):
        np.testing.assert_allclose(model.forward(torch.as_tensor(feats)).numpy(), want,
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(JaxCtcModel.load(str(tmp_path / "ours.npz")).forward(jnp.asarray(feats))),
        want, rtol=1e-6)
