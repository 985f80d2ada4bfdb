"""The port's public constructors put their tensors on the card unless asked
for the CPU: with no device given and no card they raise (no silent CPU
fallback), and with ``device="cpu"`` they build CPU tensors.

``torch.cuda.is_available`` is patched to false, so the tests say the same
on a machine with a card.
"""

import numpy as np
import pytest
import torch

from rhasspy_speech_torch.io.ivector import DiagGmm, IvectorExtractor
from rhasspy_speech_torch.models import nnet3
from rhasspy_speech_torch.models.ctc import CtcModel
from rhasspy_speech_torch.models.gmm import GmmAm
from rhasspy_speech_torch.ops import frontend, ivector
from rhasspy_speech_torch import Nnet3StreamTranscriber, Nnet3WavTranscriber
from rhasspy_speech_torch.ops.decoder import DecodeGraph
from rhasspy_speech_torch.ops.frontier import FrontierGraph
from rhasspy_speech_torch.pipeline.coqui import CoquiSttTranscriber
from rhasspy_speech_torch.pipeline.scheduler import StreamScheduler
from rhasspy_speech_torch.testing.decode_graphs import random_decode_graph
from rhasspy_speech_torch.testing.tdnnf import build_tdnnf_spec


def _ivector_system():
    rng = np.random.RandomState(0)
    gauss, dim, ivec, base, splice = 4, 5, 3, 2, 3
    inv_vars = (0.5 + rng.rand(gauss, dim)).astype(np.float32)
    dubm = DiagGmm(gconsts=rng.randn(gauss).astype(np.float32),
                   weights=np.full(gauss, 1.0 / gauss, np.float32),
                   means_invvars=rng.randn(gauss, dim).astype(np.float32), inv_vars=inv_vars)
    extractor = IvectorExtractor(
        w=np.zeros((0, 0), np.float32), w_vec=dubm.weights,
        M=rng.randn(gauss, dim, ivec).astype(np.float32),
        sigma_inv=np.tile(np.eye(dim, dtype=np.float32), (gauss, 1, 1)), prior_offset=2.0)
    lda = rng.randn(dim, base * (2 * splice + 1) + 1).astype(np.float32)
    return dubm, extractor, lda


def _tensors(x):
    """Every tensor reachable from a constructor's result."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, torch.nn.Module):
        return list(x.parameters()) + list(x.buffers())
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    if hasattr(x, "__dataclass_fields__"):
        return [t for f in x.__dataclass_fields__ for t in _tensors(getattr(x, f))]
    if isinstance(x, GmmAm):
        return [x.gconsts, x.means_invvars, x.inv_vars]
    return []


def _ivector_values():
    params = ivector.make_ivector_params(*_ivector_system(), device="cpu")
    return {f: (getattr(params, f).numpy() if isinstance(getattr(params, f), torch.Tensor)
                else getattr(params, f)) for f in params.__dataclass_fields__}


CONSTRUCTORS = {
    "params_from_numpy": lambda **kw: nnet3.params_from_numpy(
        {"affine": {"w": np.ones((2, 3)), "b": np.zeros(2)}}, **kw),
    "compile_nnet3": lambda **kw: nnet3.compile_nnet3(
        build_tdnnf_spec(num_pdfs=6, input_dim=5, ivector_dim=0, hidden_dim=8,
                         bottleneck_dim=4, num_tdnnf_layers=2, seed=1), 3, **kw),
    "DecodeGraph.from_dense": lambda **kw: DecodeGraph.from_dense(
        random_decode_graph(np.random.RandomState(2), 20, 15, 5, hubs=0), **kw),
    "FrontierGraph.from_dense": lambda **kw: FrontierGraph.from_dense(
        random_decode_graph(np.random.RandomState(3), 20, 15, 5, hubs=0), **kw),
    "ivector_params_from_numpy": lambda **kw: ivector.ivector_params_from_numpy(
        _ivector_values(), **kw),
    "make_ivector_params": lambda **kw: ivector.make_ivector_params(*_ivector_system(), **kw),
    "make_frontend_params": lambda **kw: frontend.make_frontend_params(
        frontend.FrontendConfig(), **kw),
    "GmmAm.from_numpy": lambda **kw: GmmAm.from_numpy(
        np.zeros((2, 3), np.float32), np.ones((2, 3, 4), np.float32), np.ones((2, 3, 4), np.float32),
        **kw),
    "CtcModel.from_numpy": lambda **kw: CtcModel.from_numpy(
        {"out_w": np.ones((4, 3)), "out_b": np.zeros(3)}, **kw),
}


@pytest.mark.parametrize("name", sorted(CONSTRUCTORS))
def test_constructor_defaults_to_the_card_and_raises_without_one(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        CONSTRUCTORS[name]()


@pytest.mark.parametrize("name", sorted(CONSTRUCTORS))
@pytest.mark.parametrize("device", ["cpu", torch.device("cpu")], ids=["str", "torch.device"])
def test_constructor_runs_on_the_cpu_when_asked(monkeypatch, name, device):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tensors = _tensors(CONSTRUCTORS[name](device=device))
    assert tensors and all(t.device.type == "cpu" for t in tensors)


@pytest.mark.parametrize("cls", [Nnet3WavTranscriber, Nnet3StreamTranscriber, StreamScheduler,
                                 CoquiSttTranscriber], ids=lambda c: c.__name__)
def test_transcriber_defaults_to_the_card_and_raises_without_one(monkeypatch, tmp_path, cls):
    """The device is resolved before a file is read: without a card the
    default raises, whatever the directories hold."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        cls(tmp_path / "model", tmp_path / "graph")
    with pytest.raises(RuntimeError, match="cuda"):
        cls(tmp_path / "model", tmp_path / "graph", device="cuda:0")


def test_frontier_graph_refuses_a_base_on_another_device(monkeypatch):
    dense = random_decode_graph(np.random.RandomState(4), 20, 15, 5, hubs=0)
    base = DecodeGraph.from_dense(dense, device="cpu")
    assert FrontierGraph.from_dense(dense, device="cpu", base=base).base is base
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        FrontierGraph.from_dense(dense, base=base)
