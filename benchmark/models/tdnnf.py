"""A TDNN-F model directory in the layout of Kaldi's ``tdnnf-layer`` xconfig
(``reference/nets/tdnnf.py``): the nnet3 network, with the components and
node names the xconfig gives them and the cross-entropy branch, written
from the weights ``reference/nets/tdnnf.py:draw`` draws from the seed; the
i-vector extractor, the frontend's and the lexicon's settings and the
phones are the port's big-grammar model directory's
(``testing/big_grammar.py:write_big_grammar_model_dir``)."""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List

import numpy as np

from benchmark.reference.nets.tdnnf import draw, layer_offsets


def write(model_dir: Path, args: Dict, seed: int) -> Path:
    from rhasspy_speech_torch.io.nnet3_file import (ComponentSpec, Nnet3Spec, NodeSpec,
                                                    parse_descriptor, write_nnet3)
    from rhasspy_speech_torch.io.transition_model import KaldiTransitionModel
    from rhasspy_speech_torch.testing.big_grammar import PHONES, write_big_grammar_model_dir

    # the extractor, settings and phones; its small network is replaced below
    model_dir = Path(write_big_grammar_model_dir(
        model_dir, num_pdfs=args["num_pdfs"], hidden_dim=8, num_tdnnf_layers=0,
        ivector_dim=args["ivector_dim"], ubm_gauss=args["ubm_gauss"],
        num_ceps=args["num_ceps"], seed=seed))
    net = draw(args, seed, xent=True)
    comps: Dict[str, ComponentSpec] = {}
    nodes: List[NodeSpec] = [NodeSpec(kind="input", name="ivector", dim=args["ivector_dim"]),
                             NodeSpec(kind="input", name="input", dim=args["num_ceps"])]

    def node(name, ctype, attrs, inp):
        comps[name] = ComponentSpec(name, ctype, attrs)
        nodes.append(NodeSpec(kind="component", name=name, component=name,
                              input=parse_descriptor(inp)))
        return name

    def natural_affine(name, wb, inp):
        w, b = wb
        return node(name, "NaturalGradientAffineComponent", {
            "LearningRate": 0.001, "LinearParams": w, "BiasParams": b, "RankIn": 20,
            "RankOut": 80, "UpdatePeriod": 4, "NumSamplesHistory": 2000.0, "Alpha": 4.0}, inp)

    def linear(name, w, inp):
        return node(name, "LinearComponent", {"Params": w, "OrthonormalConstraint": -1.0}, inp)

    def tdnn(name, wb, offsets, inp):
        w, b = wb
        return node(name, "TdnnComponent", {
            "LearningRate": 0.001, "TimeOffsets": np.asarray(offsets, dtype=np.int64),
            "LinearParams": w, "BiasParams": np.zeros(0, np.float32) if b is None else b,
            "OrthonormalConstraint": -1.0 if b is None else 0.0, "UseNaturalGradient": True,
            "NumSamplesHistory": 2000.0, "AlphaInOut": (4.0, 4.0), "RankInOut": (20, 80)}, inp)

    def relu(name, dim, inp):
        return node(name, "RectifiedLinearComponent", {
            "Dim": dim, "ValueAvg": np.zeros(0, np.float32), "DerivAvg": np.zeros(0, np.float32),
            "Count": 0.0}, inp)

    def batchnorm(name, stats, inp):
        mean, var = stats
        return node(name, "BatchNormComponent", {
            "Dim": mean.shape[0], "BlockDim": mean.shape[0], "Epsilon": 1.0e-3,
            "TargetRms": 1.0, "TestMode": True, "Count": 1000.0, "StatsMean": mean,
            "StatsVar": var}, inp)

    def dropout(name, dim, inp):
        return node(name, "GeneralDropoutComponent", {
            "Dim": dim, "BlockDim": dim, "TimePeriod": 0, "DropoutProportion": 0.0,
            "TestMode": True, "Continuous": True}, inp)

    offs = args["lda_offsets"]
    spliced = ", ".join([f"Offset(input, {o})" if o else "input" for o in offs]
                        + ["ReplaceIndex(ivector, t, 0)"])
    w, b = net["lda"]
    prev = node("lda", "FixedAffineComponent", {"LinearParams": w, "BiasParams": b},
                f"Append({spliced})")
    D = args["tdnn1_dim"]
    prev = natural_affine("tdnn1.affine", net["tdnn1"], prev)
    prev = relu("tdnn1.relu", D, prev)
    prev = batchnorm("tdnn1.batchnorm", net["tdnn1.bn"], prev)
    prev = dropout("tdnn1.dropout", D, prev)
    F = args["tdnnf_dim"]
    for i, layer in enumerate(net["layers"], start=2):
        name = f"tdnnf{i}"
        lin_offs, aff_offs = layer_offsets(layer["stride"])
        x = tdnn(f"{name}.linear", (layer["linear"], None), lin_offs, prev)
        x = tdnn(f"{name}.affine", layer["affine"], aff_offs, x)
        x = relu(f"{name}.relu", F, x)
        x = batchnorm(f"{name}.batchnorm", layer["bn"], x)
        x = dropout(f"{name}.dropout", F, x)
        prev = node(f"{name}.noop", "NoOpComponent", {"Dim": F},
                    f"Sum(Scale({float(args['bypass_scale'])}, {prev}), {x})")
    prefinal_l = linear("prefinal-l", net["prefinal-l"], prev)
    big, small = args["prefinal_big_dim"], args["prefinal_small_dim"]
    for branch, out in (("chain", "output"), ("xent", "output-xent")):
        p = net[f"prefinal-{branch}"]
        x = natural_affine(f"prefinal-{branch}.affine", p["affine"], prefinal_l)
        x = relu(f"prefinal-{branch}.relu", big, x)
        x = batchnorm(f"prefinal-{branch}.batchnorm1", p["bn1"], x)
        x = linear(f"prefinal-{branch}.linear", p["linear"], x)
        x = batchnorm(f"prefinal-{branch}.batchnorm2", p["bn2"], x)
        x = natural_affine(f"{out}.affine", net[out], x)
        if out == "output-xent":
            x = node(f"{out}.log-softmax", "LogSoftmaxComponent",
                     {"Dim": args["num_pdfs"]}, x)
        nodes.append(NodeSpec(kind="output", name=out, input=parse_descriptor(x)))
    spec = Nnet3Spec(nodes=nodes, components=comps)
    with open(model_dir / "model" / "final.mdl", "wb") as f:
        write_nnet3(f, spec, transition_model=KaldiTransitionModel.from_monophone_chain(
            len(PHONES)))
    return model_dir
