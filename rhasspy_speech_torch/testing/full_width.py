"""Full-width model directories of the two other acoustic-model families,
written from a seed (no download): the published shapes, random weights.

- ``write_tri1_model_dir``: Kaldi's delta-feature triphone GMM system, tri1
  of ``egs/mini_librispeech/s5/run.sh`` (``steps/train_deltas.sh
  --boost-silence 1.25 2000 10000``, ``conf/mfcc.conf`` with
  ``--use-energy=false``): 2,000 pdfs and 10,000 diagonal Gaussians (1 to
  10 a pdf, mean 5) over 13 cepstra from 23 mel bins at 25 ms / 10 ms plus
  deltas and delta-deltas, 39 dimensions. ``model/conf/mfcc.conf`` spells
  out Kaldi's ``MfccOptions`` defaults, because the port's
  ``FrontendConfig`` defaults are the hires ones. The transition model is
  the caller's (the decode graph's, e.g. the flagship graph's monophone
  chain): pdfs past the graph's are scored every frame and never read, as
  a chain model computes all its outputs. Means and variances are drawn
  around the statistics of MFCC + deltas of seeded noise, so the
  log-likelihoods have a trained model's scale.
- ``write_deepspeech_model_dir``: Coqui STT / DeepSpeech 0.9 English, from
  Coqui STT's training flags (``n_hidden`` 2048, ``n_input`` 26,
  ``n_context`` 9, ``feature_win_len`` 32 ms, ``feature_win_step`` 20 ms,
  ``n_steps`` 16): ``layer_1..3`` dense 2,048 over the 494-wide spliced
  input, an LSTM of 2,048 cells (kernel [4096, 8192]), ``layer_5`` 2,048,
  ``layer_6`` 29 (28 characters + blank): 47.2 M parameters, 189 MB in
  f32. It is written as a ``model.tflite`` with the tensor names Coqui's
  export carries (``layer_N/weights``, ``cudnn_lstm/.../kernel``), so the
  transcriber's TFLite load path converts it, beside ``alphabet.txt`` and
  a ``frontend.json`` of 26 cepstra from 40 mel bins at 32 ms / 20 ms.
- ``write_pitch_model_dir``: a chain model with Kaldi pitch features, the
  layout of Kaldi's aishell s5 chain recipe (``local/nnet3/
  run_ivector_common.sh``: 40 hires MFCC + 3 pitch columns for the
  network, ``utils/data/limit_feature_dim.sh 0:39`` for the i-vector over
  the MFCCs alone) at the flagship's widths: TDNN-F 768 x 9, 3,072 pdfs, a
  43-dim input, a 100-dim i-vector from a 512-Gaussian UBM over the 40
  MFCCs. ``model/conf/online.conf`` says ``--add-pitch=true`` and
  ``model/conf/pitch.conf`` is the recipe's (Kaldi's pitch defaults at
  16 kHz). The network's input transform is the flagship's (identity plus
  seeded noise), so the pitch columns carry non-zero random weights.
- ``write_tdnn_lstm_model_dir``: a Kaldi TDNN-LSTM chain model, the layout
  of ``egs/swbd/s5c/local/chain/tuning/run_tdnn_lstm_1e.sh``
  (``build_tdnn_lstm_spec``): 40 hires MFCC + a 100-dim i-vector into a
  fixed-affine ``lda`` over ``Append(-2,-1,0,1,2,ReplaceIndex(ivector, t,
  0))``; ``relu-batchnorm-layer`` tdnn1-3 at 1,024 (tdnn2 and tdnn3 over
  ``Append(-1,0,1)``); three ``fast-lstmp-layer``s (cell 1,024, recurrent
  and non-recurrent projections 256, ``delay=-3``) with tdnn4-7 at 1,024,
  two between each pair; the output affine over lstm3; frame subsampling
  3; the flagship's pdfs, extractor and graph. Each LSTM is wired as
  Kaldi's ``XconfigFastLstmpLayer`` wires it: ``W_all`` over ``Append(input,
  IfDefined(Offset(r_trunc, -3)))``, ``lstm_nonlin`` over ``Append(W_all,
  IfDefined(Offset(c_trunc, -3)))``, dim-ranges ``c`` / ``m``, ``W_rp``
  (cell -> 512), and a BackpropTruncation node over ``Append(c, r)`` with
  dim-ranges ``c_trunc`` / ``r_trunc``. Two time offsets differ from the
  recipe, because the stepwise evaluator of a recurrent plan (the JAX
  package's, and so the port's) reads a carried recurrence only at the
  step's own time: tdnn4-7 splice ``Append(0,0,0)`` where the recipe has
  ``Append(-3,0,3)`` (the same widths and products, no time context), and
  the output has no ``output-delay`` (the recipe's label delay is 5).
  About 35 M parameters.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Union

import numpy as np

from ..io.gmm_am import write_am_diag_gmm
from ..io.ivector import DiagGmm
from ..io.tflite import build_tflite
from ..io.transition_model import KaldiTransitionModel
from ..ops.deltas import delta_kernels
from ..io.nnet3_file import write_nnet3
from ..ops.frontend import FrontendConfig, frontend_from_mfcc_conf, mfcc_numpy
from ..io.nnet3_file import ComponentSpec, NodeSpec, Nnet3Spec, parse_descriptor
from .flagship import write_flagship_model_dir
from .tdnnf import _affine, _batchnorm, _relu, build_tdnnf_spec

TRI1_PDFS = 2000
TRI1_GAUSS = 10000
TRI1_MAX_GAUSS = 10
# Kaldi's MfccOptions defaults: 23 mel bins, 13 cepstra, 20 Hz to Nyquist
TRI1_MFCC_CONF = (
    "--use-energy=false\n--num-mel-bins=23\n--num-ceps=13\n--low-freq=20\n--high-freq=0\n"
)

# aishell s5 conf/pitch.conf; the rest are Kaldi's PitchExtractionOptions
PITCH_CONF = "--sample-frequency=16000\n"
PITCH_DIMS = 3

DEEPSPEECH_ALPHABET = [" "] + [chr(c) for c in range(ord("a"), ord("z") + 1)] + ["'"]
DEEPSPEECH_LSTM = "cudnn_lstm/rnn/multi_rnn_cell/cell_0/cudnn_compatible_lstm_cell/"


def gauss_counts(rng: np.random.RandomState, pdfs: int, total: int, most: int) -> np.ndarray:
    """Per-pdf Gaussian counts in [1, most] summing to ``total``."""
    counts = rng.randint(1, most + 1, size=pdfs)
    while counts.sum() != total:
        i = rng.randint(pdfs)
        step = 1 if counts.sum() < total else -1
        if 1 <= counts[i] + step <= most:
            counts[i] += step
    return counts


def _deltas_numpy(feats: np.ndarray) -> np.ndarray:
    """[T, D] -> [T, 3D], add-deltas with edge clamping (float64)."""
    T = feats.shape[0]
    outs = []
    for kernel in delta_kernels(2, 2):
        offset = (kernel.shape[0] - 1) // 2
        outs.append(sum(c * feats[np.clip(np.arange(T) + i - offset, 0, T - 1)]
                        for i, c in enumerate(kernel) if c != 0.0))
    return np.concatenate(outs, axis=1)


def write_tri1_model_dir(
    model_dir: Union[str, Path],
    transition_model: KaldiTransitionModel,
    phones_text: str,
    seed: int = 0,
    num_pdfs: int = TRI1_PDFS,
    num_gauss: int = TRI1_GAUSS,
) -> Path:
    """Write model/final.mdl (the transition model + an AmDiagGmm),
    model/phones.txt (``phones_text``), model/conf/mfcc.conf and
    config.json; returns ``model_dir``."""
    model_dir = Path(model_dir)
    (model_dir / "model" / "conf").mkdir(parents=True, exist_ok=True)
    conf = model_dir / "model" / "conf" / "mfcc.conf"
    conf.write_text(TRI1_MFCC_CONF, encoding="utf-8")
    rng = np.random.RandomState(seed)
    noise = 1000.0 * rng.randn(16000)
    feats = _deltas_numpy(mfcc_numpy(frontend_from_mfcc_conf(conf), noise))
    mu, sd = feats.mean(axis=0), feats.std(axis=0) + 1e-3
    dim = feats.shape[1]
    gmms = []
    for n in gauss_counts(rng, num_pdfs, num_gauss, TRI1_MAX_GAUSS):
        means = mu + 0.5 * sd * rng.randn(n, dim)
        variances = (sd * sd) * rng.uniform(0.5, 1.5, size=(n, dim))
        gmms.append(DiagGmm.from_means_vars(rng.dirichlet(np.ones(n)), means, variances))
    write_am_diag_gmm(str(model_dir / "model" / "final.mdl"), transition_model, gmms)
    (model_dir / "model" / "phones.txt").write_text(phones_text, encoding="utf-8")
    with open(model_dir / "config.json", "w", encoding="utf-8") as f:
        json.dump({"type": "gmm", "lexicon": {"casing": "lower"},
                   "sil_phone": "SIL", "spn_phone": "SPN"}, f)
    return model_dir


def deepspeech_weights(
    rng: np.random.RandomState, n_hidden: int = 2048, n_input: int = 26, n_context: int = 9,
    labels: int = len(DEEPSPEECH_ALPHABET) + 1,
) -> dict:
    """The DeepSpeech graph's named weights, random: each layer scaled by
    its fan-in, the output layer widened so the softmax is peaked (a few
    characters a frame carry the mass, as a trained model's do)."""
    d_in = n_input * (2 * n_context + 1)
    shapes = {
        "layer_1": (d_in, n_hidden), "layer_2": (n_hidden, n_hidden),
        "layer_3": (n_hidden, n_hidden), "layer_5": (n_hidden, n_hidden),
        "layer_6": (n_hidden, labels),
    }
    out = {}
    for name, (fan_in, width) in shapes.items():
        gain = 8.0 if name == "layer_6" else 1.0
        out[f"{name}/weights"] = (rng.randn(fan_in, width) * (gain / np.sqrt(fan_in))).astype(np.float32)
        out[f"{name}/bias"] = (0.1 * rng.randn(width)).astype(np.float32)
    out[DEEPSPEECH_LSTM + "kernel"] = (
        rng.randn(2 * n_hidden, 4 * n_hidden) / np.sqrt(2 * n_hidden)).astype(np.float32)
    out[DEEPSPEECH_LSTM + "bias"] = (0.1 * rng.randn(4 * n_hidden)).astype(np.float32)
    return out


def write_deepspeech_model_dir(
    model_dir: Union[str, Path],
    seed: int = 0,
    n_hidden: int = 2048,
    n_input: int = 26,
    n_context: int = 9,
    n_steps: int = 16,
) -> Path:
    """Write model.tflite, alphabet.txt, frontend.json and config.json;
    returns ``model_dir``."""
    model_dir = Path(model_dir)
    model_dir.mkdir(parents=True, exist_ok=True)
    weights = deepspeech_weights(np.random.RandomState(seed), n_hidden, n_input, n_context)
    (model_dir / "model.tflite").write_bytes(
        build_tflite(weights, input_shape=[1, n_steps, 2 * n_context + 1, n_input],
                     description="DeepSpeech 0.9 English shapes, random weights"))
    (model_dir / "alphabet.txt").write_text(
        "# DeepSpeech English alphabet\n" + "".join(c + "\n" for c in DEEPSPEECH_ALPHABET),
        encoding="utf-8")
    frontend = FrontendConfig(num_ceps=n_input, frame_length_ms=32.0, frame_shift_ms=20.0)
    with open(model_dir / "frontend.json", "w", encoding="utf-8") as f:
        json.dump({"num_mel_bins": frontend.num_mel_bins, "num_ceps": frontend.num_ceps,
                   "frame_length_ms": frontend.frame_length_ms,
                   "frame_shift_ms": frontend.frame_shift_ms}, f)
    with open(model_dir / "config.json", "w", encoding="utf-8") as f:
        json.dump({"type": "coqui"}, f)
    return model_dir


def write_pitch_model_dir(
    model_dir: Union[str, Path],
    num_pdfs: int,
    max_phone: int,
    hidden_dim: int = 768,
    num_tdnnf_layers: int = 9,
    ivector_dim: int = 100,
    ubm_gauss: int = 512,
    num_ceps: int = 40,
    seed: int = 11,
) -> Path:
    """Write the flagship model dir (``testing/flagship.py``: extractor
    over ``num_ceps`` MFCCs, ``frontend.json``, ``config.json``), then its
    ``model/final.mdl`` again with a network over ``num_ceps + 3`` inputs
    (weights from ``seed``), and the pitch confs; returns ``model_dir``."""
    model_dir = write_flagship_model_dir(
        model_dir, num_pdfs=num_pdfs, max_phone=max_phone, hidden_dim=hidden_dim,
        num_tdnnf_layers=num_tdnnf_layers, ivector_dim=ivector_dim, ubm_gauss=ubm_gauss,
        num_ceps=num_ceps, seed=seed,
    )
    spec = build_tdnnf_spec(
        num_pdfs=num_pdfs, input_dim=num_ceps + PITCH_DIMS, ivector_dim=ivector_dim,
        hidden_dim=hidden_dim, num_tdnnf_layers=num_tdnnf_layers, seed=seed,
    )
    with open(model_dir / "model" / "final.mdl", "wb") as f:
        write_nnet3(f, spec, transition_model=KaldiTransitionModel.from_monophone_chain(max_phone))
    conf = model_dir / "model" / "conf"
    conf.mkdir(parents=True, exist_ok=True)
    (conf / "online.conf").write_text("--add-pitch=true\n", encoding="utf-8")
    (conf / "pitch.conf").write_text(PITCH_CONF, encoding="utf-8")
    return model_dir


# run_tdnn_lstm_1e.sh's widths
TDNN_LSTM_DIM = 1024
TDNN_LSTM_CELL = 1024
TDNN_LSTM_PROJ = 256  # recurrent and non-recurrent projection, each
TDNN_LSTM_DELAY = -3
# the recipe's tdnn4-7 splice: Append(-3,0,3), here at offset 0 (module docstring)
TDNN_LSTM_MID_SPLICE = (0, 0, 0)


def build_tdnn_lstm_spec(
    num_pdfs: int,
    input_dim: int = 40,
    ivector_dim: int = 100,
    hidden_dim: int = TDNN_LSTM_DIM,
    cell_dim: int = TDNN_LSTM_CELL,
    proj_dim: int = TDNN_LSTM_PROJ,
    mid_splice=TDNN_LSTM_MID_SPLICE,
    output_delay: int = 0,
    seed: int = 0,
) -> Nnet3Spec:
    """The TDNN-LSTM network of ``run_tdnn_lstm_1e.sh`` (module docstring),
    random weights from ``seed``; ``mid_splice`` and ``output_delay`` are
    tdnn4-7's splice and the output's delay (``(-3, 0, 3)`` and 5 give the
    recipe's, which neither package's stepwise evaluator runs)."""
    rng = np.random.RandomState(seed)
    comps = {}
    nodes = [NodeSpec(kind="input", name="ivector", dim=ivector_dim),
             NodeSpec(kind="input", name="input", dim=input_dim)]

    def node(name, desc, comp=None):
        nodes.append(NodeSpec(kind="component", name=name, component=comp or name,
                              input=parse_descriptor(desc)))

    def dim_range(name, src, offset, dim):
        nodes.append(NodeSpec(kind="dim-range", name=name, input_node=src, dim=dim,
                              dim_offset=offset))

    def splice(src, offsets):
        return "Append(" + ", ".join(f"Offset({src}, {o})" if o else src for o in offsets) + ")"

    lda_dim = 5 * input_dim + ivector_dim
    comps["lda"] = ComponentSpec("lda", "FixedAffineComponent", {
        "LinearParams": np.eye(lda_dim, dtype=np.float32)
        + 0.01 * rng.randn(lda_dim, lda_dim).astype(np.float32),
        "BiasParams": np.zeros(lda_dim, dtype=np.float32),
    })
    node("lda", splice("input", (-2, -1, 0, 1, 2))[:-1] + ", ReplaceIndex(ivector, t, 0))")

    def relu_bn(name, desc, in_dim):
        comps[f"{name}.affine"] = _affine(rng, f"{name}.affine", in_dim, hidden_dim)
        comps[f"{name}.relu"] = _relu(f"{name}.relu", hidden_dim)
        comps[f"{name}.batchnorm"] = _batchnorm(rng, f"{name}.batchnorm", hidden_dim)
        node(f"{name}.affine", desc)
        node(f"{name}.relu", f"{name}.affine")
        node(f"{name}.batchnorm", f"{name}.relu")
        return f"{name}.batchnorm"

    def lstmp(name, src, in_dim):
        d = TDNN_LSTM_DELAY
        comps[f"{name}.W_all"] = _affine(rng, f"{name}.W_all", in_dim + proj_dim, 4 * cell_dim)
        comps[f"{name}.lstm_nonlin"] = ComponentSpec(f"{name}.lstm_nonlin", "LstmNonlinearityComponent", {
            "LearningRate": 0.001,
            "Params": (0.1 * rng.randn(3, cell_dim)).astype(np.float32),
            "ValueAvg": np.zeros((0, 0), np.float32), "DerivAvg": np.zeros((0, 0), np.float32),
            "Count": 0.0,
        })
        comps[f"{name}.W_rp"] = _affine(rng, f"{name}.W_rp", cell_dim, 2 * proj_dim)
        comps[f"{name}.cr_trunc"] = ComponentSpec(f"{name}.cr_trunc", "BackpropTruncationComponent", {
            "Dim": cell_dim + proj_dim, "Scale": 1.0, "ClippingThreshold": 30.0,
            "ZeroingThreshold": 15.0, "ZeroingInterval": 20, "RecurrenceInterval": -d,
        })
        node(f"{name}.W_all", f"Append({src}, IfDefined(Offset({name}.r_trunc, {d})))")
        node(f"{name}.lstm_nonlin", f"Append({name}.W_all, IfDefined(Offset({name}.c_trunc, {d})))")
        dim_range(f"{name}.c", f"{name}.lstm_nonlin", 0, cell_dim)
        dim_range(f"{name}.m", f"{name}.lstm_nonlin", cell_dim, cell_dim)
        node(f"{name}.W_rp", f"{name}.m")
        dim_range(f"{name}.r", f"{name}.W_rp", 0, proj_dim)
        node(f"{name}.cr_trunc", f"Append({name}.c, {name}.r)")
        dim_range(f"{name}.c_trunc", f"{name}.cr_trunc", 0, cell_dim)
        dim_range(f"{name}.r_trunc", f"{name}.cr_trunc", cell_dim, proj_dim)
        return f"{name}.W_rp"

    prev = relu_bn("tdnn1", "lda", lda_dim)
    prev = relu_bn("tdnn2", splice(prev, (-1, 0, 1)), 3 * hidden_dim)
    prev = relu_bn("tdnn3", splice(prev, (-1, 0, 1)), 3 * hidden_dim)
    prev = lstmp("lstm1", prev, hidden_dim)
    k = len(mid_splice)
    for i, lstm in ((4, "lstm2"), (6, "lstm3")):
        prev = relu_bn(f"tdnn{i}", splice(prev, mid_splice), k * 2 * proj_dim)
        prev = relu_bn(f"tdnn{i + 1}", splice(prev, mid_splice), k * hidden_dim)
        prev = lstmp(lstm, prev, hidden_dim)
    comps["output.affine"] = _affine(rng, "output.affine", 2 * proj_dim, num_pdfs)
    node("output.affine", prev)
    nodes.append(NodeSpec(kind="output", name="output", input=parse_descriptor(
        f"Offset(output.affine, {output_delay})" if output_delay else "output.affine")))
    return Nnet3Spec(nodes=nodes, components=comps)


def write_tdnn_lstm_model_dir(
    model_dir: Union[str, Path],
    num_pdfs: int,
    max_phone: int,
    hidden_dim: int = TDNN_LSTM_DIM,
    cell_dim: int = TDNN_LSTM_CELL,
    proj_dim: int = TDNN_LSTM_PROJ,
    ivector_dim: int = 100,
    ubm_gauss: int = 512,
    num_ceps: int = 40,
    seed: int = 13,
) -> Path:
    """Write the flagship model dir (``testing/flagship.py``: extractor,
    ``frontend.json``, ``config.json``), then its ``model/final.mdl`` again
    with the TDNN-LSTM network (``build_tdnn_lstm_spec``, weights from
    ``seed``); returns ``model_dir``."""
    model_dir = write_flagship_model_dir(
        model_dir, num_pdfs=num_pdfs, max_phone=max_phone, hidden_dim=64,
        num_tdnnf_layers=1, ivector_dim=ivector_dim, ubm_gauss=ubm_gauss,
        num_ceps=num_ceps, seed=seed,
    )
    spec = build_tdnn_lstm_spec(
        num_pdfs=num_pdfs, input_dim=num_ceps, ivector_dim=ivector_dim,
        hidden_dim=hidden_dim, cell_dim=cell_dim, proj_dim=proj_dim, seed=seed,
    )
    with open(model_dir / "model" / "final.mdl", "wb") as f:
        write_nnet3(f, spec, transition_model=KaldiTransitionModel.from_monophone_chain(max_phone))
    return model_dir
