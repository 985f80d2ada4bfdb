"""The port's CTC model against the JAX package's, on the CPU.

At the widths of the JAX package's own streaming test
(tests/test_coqui.py: 12 features, +-2 context, a 16-wide dense layer, an
LSTM of 10 cells, a 14-wide post layer, 8 labels; 23 frames):

- ``forward`` equals the JAX ``forward`` on the same seeded parameters and
  features within rtol 1e-5 / atol 1e-6 (f32 products summed in another
  order, carried through 23 LSTM steps and a softmax), with the LSTM's
  default forget bias (1.0) and with a converted model's (0.0), and for
  the synthetic profiles' single affine layer;
- ``forward_stream`` over windows of 5 frames spliced from true neighbours
  with the carry passed on reproduces ``forward`` within the JAX test's
  tolerance (rtol 2e-5 / atol 2e-6);
- ``save`` / ``load`` round-trips through ``model.npz``, which the JAX
  ``CtcModel.load`` reads to the same forward, and the NumPy-built model
  the synthetic CTC profile saves loads in the port.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from rhasspy_speech_tpu.models.ctc import CtcModel as JaxCtcModel

import torch

from rhasspy_speech_torch.models.ctc import CtcModel

RTOL, ATOL = 1e-5, 1e-6
STREAM_RTOL, STREAM_ATOL = 2e-5, 2e-6
D, H, L, CTX, T = 12, 10, 8, 2, 23


def _params(rng, lstm=True, forget_bias=None):
    Ds = D * (2 * CTX + 1)
    if not lstm:
        return {"out_w": (rng.randn(D, L) * 0.3).astype(np.float32),
                "out_b": (rng.randn(L) * 0.1).astype(np.float32)}
    p = {
        "dense1_w": rng.randn(Ds, 16) * 0.3,
        "dense1_b": rng.randn(16) * 0.1,
        "lstm_kernel": rng.randn(16 + H, 4 * H) * 0.2,
        "lstm_bias": rng.randn(4 * H) * 0.1,
        "post1_w": rng.randn(H, 14) * 0.3,
        "post1_b": rng.randn(14) * 0.1,
        "out_w": rng.randn(14, L) * 0.3,
        "out_b": rng.randn(L) * 0.1,
    }
    if forget_bias is not None:
        p["lstm_forget_bias"] = np.asarray(forget_bias)
    return {k: np.asarray(v, np.float32) for k, v in p.items()}


def _pair(params, context):
    jax_model = JaxCtcModel(params={k: jnp.asarray(v) for k, v in params.items()},
                            num_labels=L, context=context, has_lstm="lstm_kernel" in params)
    return jax_model, CtcModel.from_numpy(params, context, device="cpu")


@pytest.mark.parametrize("case", ["lstm_default_forget_bias", "lstm_converted_forget_bias",
                                  "affine"])
def test_forward_matches_jax(case):
    rng = np.random.RandomState(7)
    lstm = case != "affine"
    params = _params(rng, lstm, 0.0 if case == "lstm_converted_forget_bias" else None)
    context = CTX if lstm else 0
    jax_model, model = _pair(params, context)
    assert model.has_lstm == lstm and model.num_labels == L and model.context == context
    feats = rng.randn(2, T, D).astype(np.float32)
    want = np.asarray(jax_model.forward(jnp.asarray(feats)))
    got = model.forward(torch.as_tensor(feats)).numpy()
    assert got.shape == want.shape == (2, T, L)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)


def test_forward_stream_reproduces_forward():
    rng = np.random.RandomState(7)
    jax_model, model = _pair(_params(rng), CTX)
    feats = rng.randn(1, T, D).astype(np.float32)
    want = model.forward(torch.as_tensor(feats)).numpy()[0]
    state = model.init_state(1)
    assert [tuple(s.shape) for s in state] == [(1, H), (1, H)]
    jstate = jax_model.init_state(1)
    got, jgot = [], []
    W = 5
    for emitted in range(0, T, W):
        take = min(W, T - emitted)
        base = np.arange(emitted, emitted + take)
        idx = np.clip(base[:, None] + np.arange(-CTX, CTX + 1)[None, :], 0, T - 1)
        spliced = feats[0][idx].reshape(take, -1)
        if take < W:
            spliced = np.pad(spliced, ((0, W - take), (0, 0)))
        probs, state = model.forward_stream(torch.as_tensor(spliced[None]), state)
        got.append(probs.numpy()[0, :take])
        jprobs, jstate = jax_model.forward_stream(jnp.asarray(spliced[None]), jstate)
        jgot.append(np.asarray(jprobs)[0, :take])
    got = np.concatenate(got)
    np.testing.assert_allclose(got, want, rtol=STREAM_RTOL, atol=STREAM_ATOL)
    np.testing.assert_allclose(got, np.concatenate(jgot), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(state[0].numpy(), np.asarray(jstate[0]), rtol=RTOL, atol=ATOL)


def test_save_load_round_trip(tmp_path):
    rng = np.random.RandomState(3)
    params = _params(rng, forget_bias=0.0)
    feats = rng.randn(1, T, D).astype(np.float32)
    model = CtcModel.from_numpy(params, CTX, device="cpu")
    model.save(str(tmp_path / "model.npz"))
    loaded = CtcModel.load(str(tmp_path / "model.npz"), device="cpu")
    assert (loaded.context, loaded.has_lstm, loaded.lstm_hidden) == (CTX, True, H)
    assert set(loaded.params) == set(params)
    want = model.forward(torch.as_tensor(feats)).numpy()
    np.testing.assert_array_equal(loaded.forward(torch.as_tensor(feats)).numpy(), want)
    jax_loaded = JaxCtcModel.load(str(tmp_path / "model.npz"))
    np.testing.assert_allclose(np.asarray(jax_loaded.forward(jnp.asarray(feats))), want,
                               rtol=RTOL, atol=ATOL)
    # the synthetic profile's form: NumPy parameters, saved without a device
    affine = _params(rng, lstm=False)
    CtcModel(params=affine, num_labels=L).save(str(tmp_path / "affine.npz"))
    back = CtcModel.load(str(tmp_path / "affine.npz"), device="cpu")
    assert (back.context, back.has_lstm, back.init_state(2)) == (0, False, ())
    np.testing.assert_array_equal(back.params["out_w"].numpy(), affine["out_w"])
