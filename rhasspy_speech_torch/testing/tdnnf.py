"""Realistic-size TDNN-F chain model builder (random weights).

Mirrors the layer structure of the zamia-style factorized TDNN chain models
the reference downloads (kaldi xconfig: lda -> relu-batchnorm layer ->
tdnnf-layer xN with bottleneck linear + affine, time-stride 1 then 3 ->
prefinal -> output; nnet3/nnet-tdnn-component.cc TdnnComponent), so
benchmarks exercise honest acoustic-model FLOPs through the real parser and
forward compiler.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..io.nnet3_file import ComponentSpec, NodeSpec, Nnet3Spec, parse_descriptor


def _affine(rng, name: str, in_dim: int, out_dim: int) -> ComponentSpec:
    scale = 1.0 / np.sqrt(in_dim)
    return ComponentSpec(
        name,
        "NaturalGradientAffineComponent",
        {
            "LearningRate": 0.001,
            "LinearParams": (rng.randn(out_dim, in_dim) * scale).astype(np.float32),
            "BiasParams": np.zeros(out_dim, dtype=np.float32),
            "RankIn": 20,
            "RankOut": 80,
            "UpdatePeriod": 4,
            "NumSamplesHistory": 2000.0,
            "Alpha": 4.0,
        },
    )


def _relu(name: str, dim: int) -> ComponentSpec:
    return ComponentSpec(
        name,
        "RectifiedLinearComponent",
        {
            "Dim": dim,
            "ValueAvg": np.zeros(0, dtype=np.float32),
            "DerivAvg": np.zeros(0, dtype=np.float32),
            "Count": 0.0,
        },
    )


def _batchnorm(rng, name: str, dim: int) -> ComponentSpec:
    return ComponentSpec(
        name,
        "BatchNormComponent",
        {
            "Dim": dim,
            "BlockDim": dim,
            "Epsilon": 1.0e-3,
            "TargetRms": 1.0,
            "TestMode": True,
            "Count": 1000.0,
            "StatsMean": (0.05 * rng.randn(dim)).astype(np.float32),
            "StatsVar": (1.0 + 0.1 * rng.rand(dim)).astype(np.float32),
        },
    )


def _tdnn(rng, name: str, in_dim: int, out_dim: int, offsets: List[int],
          bias: bool) -> ComponentSpec:
    scale = 1.0 / np.sqrt(in_dim * len(offsets))
    return ComponentSpec(
        name,
        "TdnnComponent",
        {
            "LearningRate": 0.001,
            "TimeOffsets": np.asarray(offsets, dtype=np.int64),
            "LinearParams": (
                rng.randn(out_dim, in_dim * len(offsets)) * scale
            ).astype(np.float32),
            "BiasParams": (
                np.zeros(out_dim, dtype=np.float32)
                if bias
                else np.zeros(0, dtype=np.float32)
            ),
            "OrthonormalConstraint": -1.0 if not bias else 0.0,
            "UseNaturalGradient": True,
            "NumSamplesHistory": 2000.0,
            "AlphaInOut": (4.0, 4.0),
            "RankInOut": (20, 80),
        },
    )


def build_tdnnf_spec(
    num_pdfs: int,
    input_dim: int = 40,
    ivector_dim: int = 0,
    hidden_dim: int = 768,
    bottleneck_dim: int = 96,
    num_tdnnf_layers: int = 9,
    seed: int = 0,
) -> Nnet3Spec:
    """A factorized-TDNN chain net: early layers stride 1, later stride 3."""
    rng = np.random.RandomState(seed)
    comps = {}
    nodes: List[NodeSpec] = [NodeSpec(kind="input", name="input", dim=input_dim)]
    if ivector_dim:
        nodes.insert(0, NodeSpec(kind="input", name="ivector", dim=ivector_dim))

    # Input splice + lda-like fixed affine over (t-1, t, t+1) + ivector
    splice_dim = input_dim * 3 + ivector_dim
    comps["lda"] = ComponentSpec(
        "lda",
        "FixedAffineComponent",
        {
            "LinearParams": np.eye(splice_dim, dtype=np.float32)
            + 0.01 * rng.randn(splice_dim, splice_dim).astype(np.float32),
            "BiasParams": np.zeros(splice_dim, dtype=np.float32),
        },
    )
    lda_input = "Append(Offset(input, -1), input, Offset(input, 1)"
    if ivector_dim:
        lda_input += ", ReplaceIndex(ivector, t, 0)"
    lda_input += ")"
    nodes.append(
        NodeSpec(kind="component", name="lda", component="lda",
                 input=parse_descriptor(lda_input))
    )

    # tdnn1: affine + relu + batchnorm
    comps["tdnn1.affine"] = _affine(rng, "tdnn1.affine", splice_dim, hidden_dim)
    comps["tdnn1.relu"] = _relu("tdnn1.relu", hidden_dim)
    comps["tdnn1.batchnorm"] = _batchnorm(rng, "tdnn1.batchnorm", hidden_dim)
    nodes += [
        NodeSpec(kind="component", name="tdnn1.affine", component="tdnn1.affine",
                 input=parse_descriptor("lda")),
        NodeSpec(kind="component", name="tdnn1.relu", component="tdnn1.relu",
                 input=parse_descriptor("tdnn1.affine")),
        NodeSpec(kind="component", name="tdnn1.batchnorm",
                 component="tdnn1.batchnorm",
                 input=parse_descriptor("tdnn1.relu")),
    ]

    prev = "tdnn1.batchnorm"
    for i in range(2, 2 + num_tdnnf_layers):
        stride = 1 if i <= 4 else 3
        name = f"tdnnf{i}"
        comps[f"{name}.linear"] = _tdnn(
            rng, f"{name}.linear", hidden_dim, bottleneck_dim,
            [-stride, 0], bias=False,
        )
        comps[f"{name}.affine"] = _tdnn(
            rng, f"{name}.affine", bottleneck_dim, hidden_dim,
            [0, stride], bias=True,
        )
        comps[f"{name}.relu"] = _relu(f"{name}.relu", hidden_dim)
        comps[f"{name}.batchnorm"] = _batchnorm(rng, f"{name}.batchnorm", hidden_dim)
        nodes += [
            NodeSpec(kind="component", name=f"{name}.linear",
                     component=f"{name}.linear", input=parse_descriptor(prev)),
            NodeSpec(kind="component", name=f"{name}.affine",
                     component=f"{name}.affine",
                     input=parse_descriptor(f"{name}.linear")),
            NodeSpec(kind="component", name=f"{name}.relu",
                     component=f"{name}.relu",
                     input=parse_descriptor(f"{name}.affine")),
            NodeSpec(kind="component", name=f"{name}.batchnorm",
                     component=f"{name}.batchnorm",
                     input=parse_descriptor(f"{name}.relu")),
        ]
        prev = f"{name}.batchnorm"

    # prefinal + output
    comps["prefinal.affine"] = _affine(rng, "prefinal.affine", hidden_dim, hidden_dim)
    comps["prefinal.relu"] = _relu("prefinal.relu", hidden_dim)
    comps["output.affine"] = _affine(rng, "output.affine", hidden_dim, num_pdfs)
    nodes += [
        NodeSpec(kind="component", name="prefinal.affine",
                 component="prefinal.affine", input=parse_descriptor(prev)),
        NodeSpec(kind="component", name="prefinal.relu", component="prefinal.relu",
                 input=parse_descriptor("prefinal.affine")),
        NodeSpec(kind="component", name="output.affine", component="output.affine",
                 input=parse_descriptor("prefinal.relu")),
        NodeSpec(kind="output", name="output",
                 input=parse_descriptor("output.affine")),
    ]

    return Nnet3Spec(nodes=nodes, components=comps)
