"""Every nnet3 component type the port forwards, against the JAX package.

One case a component configuration: ``tests/test_nnet3_components.py``'s
cases from ``test_pnorm`` to ``test_composite_sequential``, plus a case for
each type the port forwards that those do not reach (the activations,
Normalize with and without AddLogStddev, SumBlock, the per-element scale
and offset, LstmNonlinearity, the test-time identities). The one-component
net is written with the JAX package's writer and read back with the
port's; the same seeded input goes through ``rhasspy_speech_tpu.models.
compile_nnet3`` and the port, the port once with the JAX plan's weights
(``params_from_numpy``) and once with its own extraction, at rtol / atol
2e-4 (``tests/test_torch_nnet3.py``'s tolerance).
"""

import io

import numpy as np
import pytest

import jax.numpy as jnp

from rhasspy_speech_tpu.io import write_nnet3
from rhasspy_speech_tpu.io.nnet3_file import (
    SUPPORTED_TYPES,
    ComponentSpec,
    NodeSpec,
    Nnet3Spec,
    parse_descriptor,
)
from rhasspy_speech_tpu.models import compile_nnet3

import torch

from rhasspy_speech_torch.io.kaldi_io import KaldiReader
from rhasspy_speech_torch.io.nnet3_file import read_nnet3
from rhasspy_speech_torch.models import nnet3 as tn

RNG = np.random.RandomState(77)


def _f32(*shape):
    return RNG.randn(*shape).astype(np.float32)


def _ng_affine(name, w, b):
    return ComponentSpec(name, "NaturalGradientAffineComponent",
                         {"LearningRate": 0.01, "LinearParams": w, "BiasParams": b})


# case -> (component, input dim)
CASES = {
    "pnorm": (ComponentSpec("c", "PnormComponent", {"InputDim": 12, "OutputDim": 4}), 12),
    "elementwise_product": (
        ComponentSpec("c", "ElementwiseProductComponent", {"InputDim": 12, "OutputDim": 4}), 12),
    "sum_group_uniform": (ComponentSpec("c", "SumGroupComponent", {"Sizes": [5, 5]}), 10),
    "sum_group_ragged": (ComponentSpec("c", "SumGroupComponent", {"Sizes": [3, 1, 6]}), 10),
    "permute": (ComponentSpec("c", "PermuteComponent", {"ColumnMap": [4, 2, 0, 1, 3]}), 5),
    "fixed_scale": (ComponentSpec("c", "FixedScaleComponent", {"Scales": _f32(6)}), 6),
    "fixed_bias": (ComponentSpec("c", "FixedBiasComponent", {"Bias": _f32(6)}), 6),
    "constant": (ComponentSpec("c", "ConstantComponent", {
        "LearningRate": 0.01, "Output": _f32(4), "IsUpdatable": True,
        "UseNaturalGradient": True}), 4),
    "constant_function": (ComponentSpec("c", "ConstantFunctionComponent", {
        "InputDim": 7, "Output": _f32(4), "IsUpdatable": False,
        "UseNaturalGradient": False}), 7),
    "repeated_affine": (ComponentSpec("c", "RepeatedAffineComponent", {
        "NumRepeats": 3, "LinearParams": _f32(2, 4), "BiasParams": _f32(6)}), 12),
    "natural_gradient_repeated_affine": (ComponentSpec(
        "c", "NaturalGradientRepeatedAffineComponent",
        {"NumRepeats": 3, "LinearParams": _f32(2, 4), "BiasParams": _f32(6)}), 12),
    "block_affine": (ComponentSpec("c", "BlockAffineComponent", {
        "NumBlocks": 2, "LinearParams": _f32(8, 3), "BiasParams": _f32(8)}), 6),
    "scale_and_offset": (ComponentSpec("c", "ScaleAndOffsetComponent", {
        "LearningRate": 0.01, "Dim": 4,
        "Scales": np.array([0.5, 0.0, -1e-6, 2.0], np.float32),
        "Offsets": np.array([1.0, -1.0, 0.25, 0.0], np.float32),
        "UseNaturalGradient": True, "Rank": 20}), 4),
    "scale_and_offset_blocks": (ComponentSpec("c", "ScaleAndOffsetComponent", {
        "Dim": 8, "Scales": np.array([0.5, 0.0, -1e-6, 2.0], np.float32),
        "Offsets": np.array([1.0, -1.0, 0.25, 0.0], np.float32)}), 8),
    "dropout": (ComponentSpec("c", "DropoutComponent", {
        "Dim": 5, "DropoutProportion": 0.25, "TestMode": True, "DropoutPerFrame": False}), 5),
    "dropout_mask": (ComponentSpec("c", "DropoutMaskComponent", {
        "OutputDim": 3, "DropoutProportion": 0.4, "TestMode": True}), 3),
    "dropout_mask_continuous": (ComponentSpec("c", "DropoutMaskComponent", {
        "OutputDim": 3, "DropoutProportion": 0.4, "TestMode": True, "Continuous": True}), 3),
    "general_dropout": (ComponentSpec("c", "GeneralDropoutComponent", {
        "Dim": 6, "BlockDim": 6, "TimePeriod": 0, "DropoutProportion": 0.5,
        "TestMode": True, "Continuous": True}), 6),
    "natural_gradient_per_element_scale": (ComponentSpec(
        "c", "NaturalGradientPerElementScaleComponent",
        {"LearningRate": 0.001, "Params": _f32(5), "RankInOut": (4, 4), "UpdatePeriod": 10,
         "NumSamplesHistory": 2000.0, "Alpha": 4.0}), 5),
    "composite_sequential": (ComponentSpec("c", "CompositeComponent", {
        "MaxRowsProcess": 2048, "Components": [
            _ng_affine("sub0", _f32(8, 5), _f32(8)),
            ComponentSpec("sub1", "RectifiedLinearComponent", {"Dim": 8}),
            ComponentSpec("sub2", "PnormComponent", {"InputDim": 8, "OutputDim": 4}),
        ]}), 5),
    # the types those cases do not reach
    "sigmoid": (ComponentSpec("c", "SigmoidComponent", {"Dim": 6}), 6),
    "tanh": (ComponentSpec("c", "TanhComponent", {"Dim": 6}), 6),
    "softmax": (ComponentSpec("c", "SoftmaxComponent", {"Dim": 6}), 6),
    "log_softmax": (ComponentSpec("c", "LogSoftmaxComponent", {"Dim": 6}), 6),
    "relu": (ComponentSpec("c", "RectifiedLinearComponent", {"Dim": 6}), 6),
    "normalize": (ComponentSpec("c", "NormalizeComponent", {
        "InputDim": 8, "OutputDim": 8, "BlockDim": 4, "TargetRms": 0.5}), 8),
    "normalize_log_stddev": (ComponentSpec("c", "NormalizeComponent", {
        "InputDim": 8, "OutputDim": 10, "BlockDim": 4, "TargetRms": 1.0,
        "AddLogStddev": True}), 8),
    "sum_block": (ComponentSpec("c", "SumBlockComponent", {
        "InputDim": 12, "OutputDim": 4, "Scale": 0.5}), 12),
    "per_element_scale": (ComponentSpec("c", "PerElementScaleComponent", {
        "LearningRate": 0.01, "Params": _f32(5)}), 5),
    "per_element_offset": (ComponentSpec("c", "PerElementOffsetComponent", {
        "Dim": 5, "Offsets": _f32(5)}), 5),
    "lstm_nonlinearity": (ComponentSpec("c", "LstmNonlinearityComponent", {
        "LearningRate": 0.01, "Params": 0.3 * _f32(3, 4),
        "ValueAvg": np.zeros((0, 0), np.float32), "DerivAvg": np.zeros((0, 0), np.float32),
        "Count": 0.0}), 20),
    "affine": (ComponentSpec("c", "AffineComponent", {
        "LinearParams": _f32(4, 6), "BiasParams": _f32(4)}), 6),
    "natural_gradient_affine": (_ng_affine("c", _f32(4, 6), _f32(4)), 6),
    "fixed_affine": (ComponentSpec("c", "FixedAffineComponent", {
        "LinearParams": _f32(4, 6), "BiasParams": _f32(4)}), 6),
    "linear": (ComponentSpec("c", "LinearComponent", {"Params": _f32(4, 6)}), 6),
    "tdnn": (ComponentSpec("c", "TdnnComponent", {
        "TimeOffsets": np.array([0], np.int64), "LinearParams": _f32(4, 6),
        "BiasParams": _f32(4)}), 6),
    "batchnorm": (ComponentSpec("c", "BatchNormComponent", {
        "Dim": 6, "BlockDim": 3, "Epsilon": 1e-3, "TargetRms": 1.0, "TestMode": True,
        "StatsMean": _f32(3), "StatsVar": (np.abs(_f32(3)) + 0.5).astype(np.float32)}), 6),
    "noop": (ComponentSpec("c", "NoOpComponent", {"Dim": 6}), 6),
    "spec_augment_time_mask": (ComponentSpec("c", "SpecAugmentTimeMaskComponent", {
        "Dim": 6, "SpecAugmentMaxProportion": 0.0, "SpecAugmentMaxRegions": 1}), 6),
    "backprop_truncation": (ComponentSpec("c", "BackpropTruncationComponent", {
        "Dim": 6, "Scale": 1.0}), 6),
    "clip_gradient": (ComponentSpec("c", "ClipGradientComponent", {"Dim": 6}), 6),
}


def _spec(comp, in_dim):
    nodes = [
        NodeSpec(kind="input", name="input", dim=in_dim),
        NodeSpec(kind="component", name="c", component="c", input=parse_descriptor("input")),
        NodeSpec(kind="output", name="output", input=parse_descriptor("c")),
    ]
    return Nnet3Spec(nodes=nodes, components={"c": comp})


@pytest.mark.parametrize("case", sorted(CASES))
def test_component_matches_jax(case):
    comp, in_dim = CASES[case]
    spec = _spec(comp, in_dim)
    buf = io.BytesIO()
    write_nnet3(buf, spec)
    buf.seek(0)
    port_spec = read_nnet3(KaldiReader(buf))
    B, T = 2, 3
    x = np.random.RandomState(sum(map(ord, case))).randn(B, T, in_dim).astype(np.float32)
    jm = compile_nnet3(spec, num_out_frames=T, subsampling=1)
    want = np.asarray(jm.forward(jnp.asarray(x)))
    plan = tn.plan_nnet3(port_spec, T, subsampling=1)
    assert plan.ranges == jm.ranges
    carried = tn.CompiledNnet3(plan, tn.params_from_numpy(
        {k: {p: np.asarray(v) for p, v in d.items()} for k, d in jm.params.items()}, "cpu"))
    got = carried(torch.as_tensor(x)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    own = tn.compile_nnet3(port_spec, T, subsampling=1, device="cpu")(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(own, want, rtol=2e-4, atol=2e-4)


def test_supported_set_is_the_jax_packages():
    """The port forwards the 37 types the JAX package forwards, and every
    one of them has a case above."""
    assert tn.SUPPORTED_COMPONENTS == SUPPORTED_TYPES
    assert len(tn.SUPPORTED_COMPONENTS) == 37
    assert {comp.type for comp, _d in CASES.values()} == tn.SUPPORTED_COMPONENTS


def test_unknown_type_raises_at_plan():
    spec = _spec(ComponentSpec("c", "FrobnicatorComponent", {"Dim": 3}), 3)
    with pytest.raises(NotImplementedError, match="FrobnicatorComponent"):
        tn.plan_nnet3(spec, 2, subsampling=1)


def test_all_types_graph_matches_jax():
    """``testing/component_graph.py``'s graph (every type on a branch of
    its own, a spliced TdnnComponent among them), written by the port and
    read by the JAX package: the port's forward equals the JAX package's.
    chip_smoke.py runs the same graph on the card against the CPU."""
    from rhasspy_speech_tpu.io import read_nnet3 as jax_read_nnet3
    from rhasspy_speech_tpu.io.kaldi_io import KaldiReader as JaxReader

    from rhasspy_speech_torch.io.nnet3_file import write_nnet3 as port_write_nnet3
    from rhasspy_speech_torch.testing.component_graph import INPUT_DIM, build_all_components_spec

    spec = build_all_components_spec(seed=4)
    assert {c.type for n, c in spec.components.items() if n.startswith("comp")} == \
        tn.SUPPORTED_COMPONENTS
    buf = io.BytesIO()
    port_write_nnet3(buf, spec)
    buf.seek(0)
    jm = compile_nnet3(jax_read_nnet3(JaxReader(buf)), num_out_frames=5, subsampling=1)
    tm = tn.compile_nnet3(spec, 5, subsampling=1, device="cpu")
    assert tm.ranges == jm.ranges and tm.ranges["input"] == (-1, 6)
    x = np.random.RandomState(12).randn(3, 7, INPUT_DIM).astype(np.float32)
    np.testing.assert_allclose(tm(torch.as_tensor(x)).numpy(), np.asarray(jm.forward(jnp.asarray(x))),
                               rtol=2e-4, atol=2e-4)
