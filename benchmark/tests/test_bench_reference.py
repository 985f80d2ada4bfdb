"""The reference's frozen copies equal what they copy: the seeded writers'
weights, and Kaldi's MFCCs as the port's float64 function computes them."""

import numpy as np
import torch

from benchmark.reference import frontend, weights


def _spec_array(spec, comp, key):
    return np.asarray(spec.components[comp].attrs[key], dtype=np.float64)


def _bn(spec, name):
    a = spec.components[name].attrs
    scale = 1.0 / np.sqrt(np.asarray(a["StatsVar"], np.float64) + a["Epsilon"])
    return scale, -np.asarray(a["StatsMean"], np.float64) * scale


TINY_TDNNF = {"num_ceps": 40, "ivector_dim": 8, "ubm_gauss": 8, "num_pdfs": 50,
              "lda_offsets": [-1, 0, 1], "tdnn1_dim": 32, "tdnnf_dim": 32, "bottleneck_dim": 8,
              "bypass_scale": 0.66, "time_strides": [1, 1, 1, 0, 3, 3, 3],
              "prefinal_l_dim": 12, "prefinal_big_dim": 32, "prefinal_small_dim": 12}


def test_tdnnf_model_file_holds_the_references_weights(tmp_path):
    """The benchmark's writer puts the reference's draws in the model file,
    and the port's forward of that file agrees with the reference's, over
    the window the reference works out from the layers."""
    from benchmark.models import tdnnf as writer
    from benchmark.reference.nets import tdnnf
    from rhasspy_speech_torch.io.nnet3_file import read_am_nnet3
    from rhasspy_speech_torch.pipeline.transcribe import AcousticModel

    d = writer.write(tmp_path / "m", TINY_TDNNF, 1234)
    _tm, spec = read_am_nnet3(str(d / "model" / "final.mdl"))
    net = tdnnf.draw(TINY_TDNNF, 1234, xent=True)
    assert np.array_equal(net["lda"][0], _spec_array(spec, "lda", "LinearParams"))
    for i, layer in enumerate(net["layers"], start=2):
        assert np.array_equal(layer["linear"], _spec_array(spec, f"tdnnf{i}.linear", "LinearParams"))
        assert np.array_equal(layer["affine"][0], _spec_array(spec, f"tdnnf{i}.affine", "LinearParams"))
        assert np.array_equal(layer["bn"][1], _spec_array(spec, f"tdnnf{i}.batchnorm", "StatsVar"))
    assert np.array_equal(net["prefinal-l"], _spec_array(spec, "prefinal-l", "Params"))
    assert np.array_equal(net["output"][0], _spec_array(spec, "output.affine", "LinearParams"))
    assert np.array_equal(net["output-xent"][0],
                          _spec_array(spec, "output-xent.affine", "LinearParams"))

    model = AcousticModel(d, device="cpu").compiled(20)
    lo, hi = tdnnf.window(TINY_TDNNF, 20)
    assert model.ranges["input"] == (lo, hi) == (-13, 71)
    gen = torch.Generator().manual_seed(0)
    x, iv = torch.randn(2, hi - lo, 40, generator=gen), torch.randn(2, 8, generator=gen)
    want, state = tdnnf.forward(tdnnf.weights(TINY_TDNNF, 1234), x.double(), iv.double(), None, 20)
    got = model(x, iv).double()
    assert state is None and got.shape == want.shape == (2, 20, 50)
    # float32 rounding over 7 layers, against outputs of order 1
    assert float((got - want).abs().max()) < 1e-5 * float(want.abs().max())


def test_tdnn_lstm_weights_equal_the_writers():
    from benchmark.reference.nets import tdnn_lstm
    from rhasspy_speech_torch.testing.full_width import build_tdnn_lstm_spec

    kw = dict(num_pdfs=50, ivector_dim=8, hidden_dim=16, cell_dim=12, proj_dim=4)
    spec = build_tdnn_lstm_spec(input_dim=40, seed=77, **kw)
    net = tdnn_lstm.weights(dict(kw, num_ceps=40), 77)
    for name in ("tdnn1", "tdnn2", "tdnn3", "tdnn4", "tdnn5", "tdnn6", "tdnn7"):
        assert np.array_equal(net[name]["affine"][0], _spec_array(spec, f"{name}.affine", "LinearParams"))
    for name in ("lstm1", "lstm2", "lstm3"):
        assert np.array_equal(net[name]["W_all"][0], _spec_array(spec, f"{name}.W_all", "LinearParams"))
        assert np.array_equal(net[name]["peep"], _spec_array(spec, f"{name}.lstm_nonlin", "Params"))
        assert np.array_equal(net[name]["W_rp"][0], _spec_array(spec, f"{name}.W_rp", "LinearParams"))
    assert np.array_equal(net["output"][0], _spec_array(spec, "output.affine", "LinearParams"))


def test_tdnn_lstm_forward_steps_as_the_port(tmp_path):
    """A whole utterance in one forward equals two chunks with the state
    carried, and the port's plan over the same window."""
    from benchmark.models import tdnn_lstm as writer
    from benchmark.reference.nets import tdnn_lstm
    from rhasspy_speech_torch.pipeline.transcribe import AcousticModel

    args = {"num_ceps": 40, "ivector_dim": 8, "ubm_gauss": 8, "num_pdfs": 30,
            "hidden_dim": 16, "cell_dim": 12, "proj_dim": 4}
    d = writer.write(tmp_path / "m", args, 5)
    net = tdnn_lstm.weights(args, 5)
    lo, hi = tdnn_lstm.window(args, 14)
    assert (lo, hi) == (-4, 44) and tdnn_lstm.window(args, 7) == (-4, 23)
    gen = torch.Generator().manual_seed(1)
    x, iv = torch.randn(2, hi - lo, 40, generator=gen).double(), torch.randn(2, 8, generator=gen).double()
    whole, _ = tdnn_lstm.forward(net, x, iv, tdnn_lstm.zero_state(net, 2, x), 14)
    first, st = tdnn_lstm.forward(net, x[:, :27], iv, tdnn_lstm.zero_state(net, 2, x), 7)
    second, _ = tdnn_lstm.forward(net, x[:, 21:48], iv, st, 7)
    assert torch.allclose(whole, torch.cat([first, second], 1), rtol=0, atol=1e-12)
    got = AcousticModel(d, device="cpu").compiled(14)(x.float(), iv.float()).double()
    assert float((got - whole).abs().max()) < 1e-5 * float(whole.abs().max())


def test_extractor_equals_the_writers(tmp_path):
    from rhasspy_speech_torch.io.ivector import DiagGmm, IvectorExtractor
    from rhasspy_speech_torch.io.kaldi_io import read_kaldi_object
    from rhasspy_speech_torch.testing.flagship import write_flagship_model_dir

    d = write_flagship_model_dir(tmp_path / "m", num_pdfs=20, max_phone=5, hidden_dim=8,
                                 num_tdnnf_layers=1, ivector_dim=6, ubm_gauss=4, seed=9)
    w = weights.extractor(9, num_ceps=40, ivector_dim=6, ubm_gauss=4)
    ubm = DiagGmm.load(str(d / "extractor" / "final.dubm"))
    assert np.allclose(ubm.inv_vars, 1.0 / w["variances"], rtol=1e-6)
    assert np.allclose(ubm.means_invvars, w["means"] / w["variances"], rtol=1e-6)
    ie = IvectorExtractor.load(str(d / "extractor" / "final.ie"))
    assert np.array_equal(ie.M, w["M"]) and ie.prior_offset == w["prior_offset"]
    assert np.array_equal(np.asarray(read_kaldi_object(str(d / "extractor" / "final.mat"))), w["lda"])


def test_mfcc_equals_kaldis_in_float64():
    from rhasspy_speech_torch.ops.frontend import FrontendConfig, mfcc_numpy

    rng = np.random.RandomState(4)
    pcm = (rng.randn(2, 8000) * 3000).astype(np.float32)
    got = frontend.mfcc(frontend.Mfcc(), torch.as_tensor(pcm)).numpy()
    for b in range(2):
        want = mfcc_numpy(FrontendConfig(), pcm[b].astype(np.float64))
        assert np.allclose(got[b], want, rtol=1e-10, atol=1e-10)
