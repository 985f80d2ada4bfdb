"""Recurrent nnet3 plans in the port against the JAX package, on the CPU.

``tests/test_nnet3_forward.py``'s LSTM cases (``test_lstm_recurrent_forward``
to ``test_lstm_delay3_chunked_state_matches_whole``, and
``test_switch_descriptor_recurrent``) run through both packages on the same
seeded input, the port with the JAX plan's weights; the copied plan's
recurrent fields must equal the original's; the TDNN-LSTM model dir of
``testing/full_width.py`` at a narrow width gives the same log-probs in
both packages from the same file. Tolerance rtol / atol 2e-4, the JAX
package's own for these cases against NumPy.
"""

import io

import numpy as np
import pytest

import jax.numpy as jnp

from rhasspy_speech_tpu.io import write_nnet3
from rhasspy_speech_tpu.io.nnet3_file import ComponentSpec, NodeSpec, parse_descriptor
from rhasspy_speech_tpu.models import nnet3 as jn
from rhasspy_speech_tpu.pipeline.transcribe import AcousticModel as JaxAcousticModel
from tests.test_nnet3_forward import _lstmp_spec

import torch

from rhasspy_speech_torch.io.kaldi_io import KaldiReader
from rhasspy_speech_torch.io.nnet3_file import read_nnet3
from rhasspy_speech_torch.models import nnet3 as tn
from rhasspy_speech_torch.pipeline.transcribe import AcousticModel
from rhasspy_speech_torch.testing.feature_tolerance import (
    assert_mfcc_close,
    frames_of,
    mfcc_allowance,
)
from rhasspy_speech_torch.testing.full_width import build_tdnn_lstm_spec, write_tdnn_lstm_model_dir

TOL = dict(rtol=2e-4, atol=2e-4)
PLAN_FIELDS = ("recurrent", "recurrence", "carried", "carry_depths", "step_input_range",
               "rec_stride", "left_context", "right_context")


def _pair(spec, n_out, sub):
    """(JAX plan, port module with the JAX plan's weights); the plans'
    ranges, order and recurrent fields must agree."""
    jm = jn.compile_nnet3(spec, n_out, subsampling=sub)
    plan = tn.plan_nnet3(spec, n_out, subsampling=sub)
    assert plan.ranges == jm.ranges
    assert [n.name for n in plan.order] == [n.name for n in jm.order]
    for f in PLAN_FIELDS:
        assert getattr(plan, f) == getattr(jm, f), f
    params = {k: {p: np.asarray(v) for p, v in d.items()} for k, d in jm.params.items()}
    return jm, tn.CompiledNnet3(plan, tn.params_from_numpy(params, "cpu"))


def _frames(m):
    lo, hi = m.ranges["input"]
    return hi - lo


def _whole(spec, n_out, sub, seed, B=2, D=6):
    jm, tm = _pair(spec, n_out, sub)
    feats = np.random.RandomState(seed).randn(B, _frames(jm), D).astype(np.float32)
    want = np.asarray(jm.forward(jnp.asarray(feats)))
    got = tm(torch.as_tensor(feats)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    return feats, got


def _chunked(spec, n_whole, n_chunk, sub, seed, B=2, D=6):
    """The port's chunked forward with carried state equals its whole
    forward and the JAX package's chunked one, chunk by chunk."""
    feats, whole = _whole(spec, n_whole, sub, seed, B, D)
    jc, tc = _pair(spec, n_chunk, sub)
    win = _frames(jc)
    js, ts = jc.init_state(B), tc.init_state(B)
    outs = []
    for c in range(n_whole // n_chunk):
        window = feats[:, c * n_chunk * sub : c * n_chunk * sub + win]
        if window.shape[1] < win:
            window = np.concatenate(
                [window, np.zeros((B, win - window.shape[1], D), np.float32)], axis=1)
        jo, js = jc.forward_with_state(jnp.asarray(window), js)
        to, ts = tc.forward_with_state(torch.as_tensor(window), ts)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
        assert set(ts) == set(js)
        for k in ts:
            assert ts[k].shape == js[k].shape
            np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]), **TOL)
        outs.append(to.numpy())
    np.testing.assert_allclose(np.concatenate(outs, axis=1), whole, **TOL)


# case -> (delay, whole outputs, chunk outputs or None, subsampling)
LSTM_CASES = {
    "lstm_recurrent_forward": (-1, 6, None, 1),
    "recurrence_delay_not_multiple_of_subsampling": (-1, 5, None, 3),
    "recurrence_substride_chunked_matches_whole": (-1, 12, 4, 3),
    "lstm_chunked_state_matches_whole": (-1, 12, 4, 1),
    "lstm_delay3_deinterleaves": (-3, 12, None, 1),
    "lstm_delay3_chunked_state_matches_whole": (-3, 12, 4, 1),
}


@pytest.mark.parametrize("case", sorted(LSTM_CASES))
def test_lstm_cases_match_jax(case):
    delay, n_whole, n_chunk, sub = LSTM_CASES[case]
    spec = _lstmp_spec(np.random.RandomState(8), delay=delay)
    if n_chunk is None:
        _whole(spec, n_whole, sub, seed=len(case))
    else:
        _chunked(spec, n_whole, n_chunk, sub, seed=len(case))


def test_lstm_delay3_deinterleaves_in_the_port():
    """A delay -3 recurrence at subsampling 1 is three interleaved delay -1
    sequences (the JAX package's own check, on the port)."""
    spec3 = _lstmp_spec(np.random.RandomState(13), delay=-3)
    spec1 = _lstmp_spec(np.random.RandomState(13), delay=-1)
    m3 = tn.compile_nnet3(spec3, 12, subsampling=1, device="cpu")
    m1 = tn.compile_nnet3(spec1, 4, subsampling=1, device="cpu")
    assert m3.plan.carry_depths == (3, 3)
    feats = torch.as_tensor(np.random.RandomState(14).randn(2, _frames(m3), 6).astype(np.float32))
    got = m3(feats).numpy()
    for j in range(3):
        np.testing.assert_allclose(got[:, j::3], m1(feats[:, j::3]).numpy(), **TOL)


def test_switch_descriptor_recurrent():
    """Switch inside the stepwise evaluator selects by the absolute step
    time: even frames the LSTM's output, odd frames a zero affine."""
    spec = _lstmp_spec(np.random.RandomState(22))
    spec.components["W_zero"] = ComponentSpec("W_zero", "NaturalGradientAffineComponent", {
        "LinearParams": np.zeros((3, 4), np.float32), "BiasParams": np.zeros(3, np.float32)})
    nodes = list(spec.nodes)
    out_idx = next(i for i, nd in enumerate(nodes) if nd.kind == "output")
    nodes.insert(out_idx, NodeSpec(kind="component", name="W_zero", component="W_zero",
                                   input=parse_descriptor("r_t")))
    nodes[out_idx + 1] = NodeSpec(kind="output", name="output",
                                  input=parse_descriptor("Switch(W_out, W_zero)"))
    spec.nodes = nodes
    _feats, got = _whole(spec, 8, 1, seed=23)
    assert np.all(got[:, 1::2] == 0.0) and np.abs(got[:, 0::2]).max() > 0.0


@pytest.mark.parametrize("desc", ["Round(W_out, 1)", "Failover(W_out, W_out)"])
def test_round_and_failover_raise_in_a_recurrent_step(desc):
    """The stepwise evaluator answers no Round or Failover, in either
    package."""
    spec = _lstmp_spec(np.random.RandomState(24))
    nodes = list(spec.nodes)
    out_idx = next(i for i, nd in enumerate(nodes) if nd.kind == "output")
    nodes[out_idx] = NodeSpec(kind="output", name="output", input=parse_descriptor(desc))
    spec.nodes = nodes
    jm, tm = _pair(spec, 4, 1)
    feats = np.random.RandomState(25).randn(1, _frames(jm), 6).astype(np.float32)
    kind = desc.partition("(")[0].lower()
    with pytest.raises(NotImplementedError, match=f"descriptor '{kind}' inside a recurrent graph"):
        jm.forward(jnp.asarray(feats))
    with pytest.raises(NotImplementedError, match=f"descriptor '{kind}' inside a recurrent graph"):
        tm(torch.as_tensor(feats))


def test_non_negative_back_edge_raises_naming_the_delay():
    spec = _lstmp_spec(np.random.RandomState(3), delay=1)
    with pytest.raises(NotImplementedError, match=r"recurrent offsets \[1\]"):
        jn.compile_nnet3(spec, 4, subsampling=1)
    with pytest.raises(NotImplementedError, match=r"recurrent offsets \[1\]"):
        tn.plan_nnet3(spec, 4, subsampling=1)


def _narrow_tdnn_lstm(**kw):
    return build_tdnn_lstm_spec(num_pdfs=24, input_dim=8, ivector_dim=5, hidden_dim=16,
                                cell_dim=16, proj_dim=4, seed=2, **kw)


def test_tdnn_lstm_plan_and_chunks_match_jax():
    """The TDNN-LSTM layout at cell 16: plans equal, a 7-frame chunk
    stream with carried state equals the whole forward in both packages."""
    spec = _narrow_tdnn_lstm()
    jm, tm = _pair(spec, 14, 3)
    assert tm.plan.carried == tuple(f"lstm{i}.{x}_trunc" for i in (1, 2, 3) for x in "cr")
    rng = np.random.RandomState(4)
    feats = rng.randn(2, _frames(jm), 8).astype(np.float32)
    ivec = rng.randn(2, 5).astype(np.float32)
    want = np.asarray(jm.forward(jnp.asarray(feats), jnp.asarray(ivec)))
    got = tm(torch.as_tensor(feats), torch.as_tensor(ivec)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    jc, tc = _pair(spec, 7, 3)
    state = tc.init_state(2)
    outs = []
    for c in range(2):
        window = feats[:, c * 21 : c * 21 + _frames(jc)]
        out, state = tc.forward_with_state(torch.as_tensor(window), state, torch.as_tensor(ivec))
        outs.append(out.numpy())
    np.testing.assert_allclose(np.concatenate(outs, axis=1), got, **TOL)


@pytest.mark.parametrize("layout", ["mid_splice", "output_delay"])
def test_published_tdnn_lstm_offsets_raise_in_both(layout):
    """The recipe's tdnn4-7 splice (-3, 0, 3) and its label delay of 5 make
    nodes after an LSTM read its carried state at other times than the
    step's: the JAX package's stepwise evaluator refuses them, and so does
    the port (the reason ``testing/full_width.py`` splices at 0)."""
    kw = {"mid_splice": dict(mid_splice=(-3, 0, 3)), "output_delay": dict(output_delay=5)}[layout]
    spec = _narrow_tdnn_lstm(**kw)
    jm = jn.compile_nnet3(spec, 7, subsampling=3)
    tm = tn.compile_nnet3(spec, 7, subsampling=3, device="cpu")
    rng = np.random.RandomState(0)
    feats = rng.randn(1, _frames(jm), 8).astype(np.float32)
    ivec = rng.randn(1, 5).astype(np.float32)
    with pytest.raises(NotImplementedError, match="back-reference"):
        jm.forward(jnp.asarray(feats), jnp.asarray(ivec))
    with pytest.raises(NotImplementedError, match="back-reference"):
        tm(torch.as_tensor(feats), torch.as_tensor(ivec))


def test_tdnn_lstm_model_dir_matches_jax(tmp_path):
    """``write_tdnn_lstm_model_dir`` at cell 16: both packages' acoustic
    models read the same file and give the same log-probs over one bucket,
    i-vector extractor included."""
    model_dir = write_tdnn_lstm_model_dir(
        tmp_path / "m", num_pdfs=24, max_phone=5, hidden_dim=16, cell_dim=16, proj_dim=4,
        ivector_dim=10, ubm_gauss=8, num_ceps=13)
    am = AcousticModel(model_dir, device="cpu")
    jam = JaxAcousticModel(model_dir)
    assert am.compiled(16).plan.recurrent and jam.compiled(16).model.recurrent
    pcm = (1000.0 * np.random.RandomState(5).randn(1, 8000)).astype(np.float32)
    feats = am.features(torch.as_tensor(pcm))
    jfeats = jam.features(pcm)
    cfg = am.frontend_config
    assert_mfcc_close(feats, jfeats, mfcc_allowance(cfg, frames_of(cfg, pcm), sides=2))
    got = am.log_probs(torch.as_tensor(np.array(jfeats)), 16).numpy()
    want = np.asarray(jam.log_probs(jfeats, 16))
    np.testing.assert_allclose(got, want, **TOL)


def test_file_roundtrip_through_the_ports_reader():
    spec = _lstmp_spec(np.random.RandomState(9))
    buf = io.BytesIO()
    write_nnet3(buf, spec)
    buf.seek(0)
    mine = tn.compile_nnet3(read_nnet3(KaldiReader(buf)), 4, subsampling=1, device="cpu")
    jm = jn.compile_nnet3(spec, 4, subsampling=1)
    feats = np.random.RandomState(10).randn(1, _frames(jm), 6).astype(np.float32)
    np.testing.assert_allclose(mine(torch.as_tensor(feats)).numpy(),
                               np.asarray(jm.forward(jnp.asarray(feats))), **TOL)
