"""A small nnet3 graph that holds every component type the port forwards.

``build_all_components_spec`` gives one branch a type: a seeded
NaturalGradientAffine adapter from the shared input to the width the type
takes, then the component; the output appends every branch. The
TdnnComponent splices offsets -1, 0, 1, so the plan carries context.
``chip_smoke.py`` runs it on the card against the port on the CPU, and
``tests/test_torch_nnet3_components.py`` the port against the JAX package.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np

from ..io.nnet3_file import ComponentSpec, NodeSpec, Nnet3Spec, parse_descriptor

INPUT_DIM = 12


def _branches(rng: np.random.RandomState) -> Dict[str, Tuple[int, Callable[[], dict]]]:
    """Component type -> (input width, attrs)."""

    def f32(*shape, scale=1.0):
        return (scale * rng.randn(*shape)).astype(np.float32)

    def sub_affine():
        return ComponentSpec("sub0", "NaturalGradientAffineComponent",
                             {"LinearParams": f32(8, 6, scale=0.4), "BiasParams": f32(8)})

    affine = lambda: {"LinearParams": f32(5, 6, scale=0.4), "BiasParams": f32(5)}  # noqa: E731
    return {
        "AffineComponent": (6, affine),
        "NaturalGradientAffineComponent": (6, affine),
        "FixedAffineComponent": (6, affine),
        "LinearComponent": (6, lambda: {"Params": f32(5, 6, scale=0.4)}),
        "TdnnComponent": (6, lambda: {"TimeOffsets": np.array([-1, 0, 1], np.int64),
                                      "LinearParams": f32(5, 18, scale=0.3),
                                      "BiasParams": f32(5)}),
        "RectifiedLinearComponent": (6, lambda: {"Dim": 6}),
        "SigmoidComponent": (6, lambda: {"Dim": 6}),
        "TanhComponent": (6, lambda: {"Dim": 6}),
        "LogSoftmaxComponent": (6, lambda: {"Dim": 6}),
        "SoftmaxComponent": (6, lambda: {"Dim": 6}),
        "BatchNormComponent": (6, lambda: {
            "Dim": 6, "BlockDim": 3, "Epsilon": 1e-3, "TargetRms": 1.0, "TestMode": True,
            "StatsMean": f32(3), "StatsVar": (np.abs(f32(3)) + 0.5).astype(np.float32)}),
        "NormalizeComponent": (8, lambda: {"InputDim": 8, "OutputDim": 10, "BlockDim": 4,
                                           "TargetRms": 0.5, "AddLogStddev": True}),
        "SumBlockComponent": (12, lambda: {"InputDim": 12, "OutputDim": 4, "Scale": 0.5}),
        "PerElementScaleComponent": (5, lambda: {"Params": f32(5)}),
        "NaturalGradientPerElementScaleComponent": (5, lambda: {"Params": f32(5)}),
        "PerElementOffsetComponent": (5, lambda: {"Dim": 5, "Offsets": f32(5)}),
        "PnormComponent": (12, lambda: {"InputDim": 12, "OutputDim": 4}),
        "ElementwiseProductComponent": (12, lambda: {"InputDim": 12, "OutputDim": 4}),
        "SumGroupComponent": (10, lambda: {"Sizes": [3, 1, 6]}),
        "PermuteComponent": (5, lambda: {"ColumnMap": [4, 2, 0, 1, 3]}),
        "FixedScaleComponent": (6, lambda: {"Scales": f32(6)}),
        "FixedBiasComponent": (6, lambda: {"Bias": f32(6)}),
        "ConstantComponent": (4, lambda: {"Output": f32(4), "IsUpdatable": True,
                                          "UseNaturalGradient": True}),
        "ConstantFunctionComponent": (7, lambda: {"InputDim": 7, "Output": f32(4),
                                                  "IsUpdatable": False,
                                                  "UseNaturalGradient": False}),
        "RepeatedAffineComponent": (12, lambda: {"NumRepeats": 3, "LinearParams": f32(2, 4),
                                                 "BiasParams": f32(6)}),
        "NaturalGradientRepeatedAffineComponent": (12, lambda: {
            "NumRepeats": 3, "LinearParams": f32(2, 4), "BiasParams": f32(6)}),
        "BlockAffineComponent": (6, lambda: {"NumBlocks": 2, "LinearParams": f32(8, 3),
                                             "BiasParams": f32(8)}),
        "ScaleAndOffsetComponent": (8, lambda: {
            "Dim": 8, "Scales": np.array([0.5, 0.0, -1e-6, 2.0], np.float32),
            "Offsets": f32(4)}),
        "DropoutComponent": (5, lambda: {"Dim": 5, "DropoutProportion": 0.25, "TestMode": True}),
        "DropoutMaskComponent": (3, lambda: {"OutputDim": 3, "DropoutProportion": 0.4,
                                             "TestMode": True}),
        "CompositeComponent": (6, lambda: {"MaxRowsProcess": 2048, "Components": [
            sub_affine(),
            ComponentSpec("sub1", "RectifiedLinearComponent", {"Dim": 8}),
            ComponentSpec("sub2", "PnormComponent", {"InputDim": 8, "OutputDim": 4}),
        ]}),
        "LstmNonlinearityComponent": (20, lambda: {"Params": f32(3, 4, scale=0.3)}),
        "NoOpComponent": (6, lambda: {"Dim": 6}),
        "GeneralDropoutComponent": (6, lambda: {"Dim": 6, "BlockDim": 6, "TimePeriod": 0,
                                                "DropoutProportion": 0.5, "TestMode": True,
                                                "Continuous": True}),
        "SpecAugmentTimeMaskComponent": (6, lambda: {"Dim": 6}),
        "BackpropTruncationComponent": (6, lambda: {"Dim": 6, "Scale": 1.0}),
        "ClipGradientComponent": (6, lambda: {"Dim": 6}),
    }


def build_all_components_spec(seed: int = 0) -> Nnet3Spec:
    """The all-types graph (module docstring), weights from ``seed``."""
    rng = np.random.RandomState(seed)
    comps: Dict[str, ComponentSpec] = {}
    nodes = [NodeSpec(kind="input", name="input", dim=INPUT_DIM)]
    outs = []
    for i, (ctype, (in_dim, attrs)) in enumerate(sorted(_branches(rng).items())):
        a, c = f"adapt{i}", f"comp{i}"
        comps[a] = ComponentSpec(a, "NaturalGradientAffineComponent", {
            "LinearParams": (rng.randn(in_dim, INPUT_DIM) / np.sqrt(INPUT_DIM)).astype(np.float32),
            "BiasParams": (0.1 * rng.randn(in_dim)).astype(np.float32)})
        comps[c] = ComponentSpec(c, ctype, attrs())
        nodes.append(NodeSpec(kind="component", name=a, component=a,
                              input=parse_descriptor("input")))
        nodes.append(NodeSpec(kind="component", name=c, component=c, input=parse_descriptor(a)))
        outs.append(c)
    nodes.append(NodeSpec(kind="output", name="output",
                          input=parse_descriptor(f"Append({', '.join(outs)})")))
    return Nnet3Spec(nodes=nodes, components=comps)
