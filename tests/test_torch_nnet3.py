"""The port's nnet3 forward against the JAX package's ``CompiledNnet3``.

Both run with identical weights (the JAX plan's parameters through
``params_from_numpy``) on the same seeded inputs. Tolerance rtol / atol
2e-4: the JAX package's own for its TDNN-F forward against NumPy (one
matmul per time offset, summed in another order than a single product).
The copied plan must give equal ``ranges`` and node order.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from rhasspy_speech_tpu.io.nnet3_file import ComponentSpec, Nnet3Spec, NodeSpec, parse_descriptor
from rhasspy_speech_tpu.models import nnet3 as jn
from rhasspy_speech_tpu.testing.tdnnf import build_tdnnf_spec

import torch

from rhasspy_speech_torch.models import nnet3 as tn


def _compare(spec, n_out, sub, ivec_dim=0, seed=0):
    jm = jn.compile_nnet3(spec, n_out, subsampling=sub)
    plan = tn.plan_nnet3(spec, n_out, subsampling=sub)
    assert plan.ranges == jm.ranges
    assert [n.name for n in plan.order] == [n.name for n in jm.order]
    tm = tn.CompiledNnet3(plan, tn.params_from_numpy(
        {k: {p: np.asarray(v) for p, v in d.items()} for k, d in jm.params.items()}, "cpu"
    ))
    rng = np.random.RandomState(seed)
    feats = rng.randn(2, jm.num_input_frames, spec.input_dim).astype(np.float32)
    ivec = rng.randn(2, ivec_dim).astype(np.float32) if ivec_dim else None
    want = np.asarray(jm.forward(jnp.asarray(feats), None if ivec is None else jnp.asarray(ivec)))
    got = tm(torch.as_tensor(feats), None if ivec is None else torch.as_tensor(ivec)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    # the port's own parameter extraction matches the carried-over one
    own = tn.compile_nnet3(spec, n_out, subsampling=sub, device="cpu")(
        torch.as_tensor(feats), None if ivec is None else torch.as_tensor(ivec)
    ).numpy()
    np.testing.assert_array_equal(own, got)


@pytest.mark.parametrize("ivec_dim", [0, 10])
def test_tdnnf_forward_matches_jax(ivec_dim):
    spec = build_tdnnf_spec(num_pdfs=30, input_dim=13, ivector_dim=ivec_dim,
                            hidden_dim=64, bottleneck_dim=16, num_tdnnf_layers=4, seed=3)
    _compare(spec, n_out=7, sub=3, ivec_dim=ivec_dim)


def test_synthetic_profile_forward_matches_jax(tmp_path):
    from rhasspy_speech_tpu.io.nnet3_file import read_am_nnet3
    from rhasspy_speech_tpu.testing import build_synthetic_profile

    profile = build_synthetic_profile(
        tmp_path / "m", {"on": ["aa", "n"], "off": ["ao", "f"]}, with_ivector=True
    )
    _tm, spec = read_am_nnet3(str(profile.model_dir / "model" / "final.mdl"))
    _compare(spec, n_out=5, sub=3, ivec_dim=spec.ivector_dim, seed=1)


def _desc_spec():
    """Exercises sum, scale, const, round, switch, ifdefined, failover and
    the uncollapsed batchnorm."""
    rng = np.random.RandomState(9)

    def affine(name, i, o):
        return ComponentSpec(name, "NaturalGradientAffineComponent", {
            "LinearParams": rng.randn(o, i).astype(np.float32),
            "BiasParams": rng.randn(o).astype(np.float32)})

    comps = {
        "a": affine("a", 4, 4),
        "bn": ComponentSpec("bn", "BatchNormComponent", {
            "Dim": 4, "BlockDim": 2, "Epsilon": 1e-3, "TargetRms": 1.0,
            "StatsMean": rng.randn(2).astype(np.float32),
            "StatsVar": (rng.rand(2) + 0.5).astype(np.float32)}),
        "b": affine("b", 4 * 3 + 2, 5),
        "relu": ComponentSpec("relu", "RectifiedLinearComponent", {"Dim": 5}),
        "lsm": ComponentSpec("lsm", "LogSoftmaxComponent", {"Dim": 5}),
        "noop": ComponentSpec("noop", "NoOpComponent", {"Dim": 5}),
    }
    nodes = [
        NodeSpec(kind="input", name="input", dim=4),
        NodeSpec(kind="component", name="a", component="a",
                 input=parse_descriptor("Sum(input, Scale(0.5, Offset(input, 1)))")),
        NodeSpec(kind="component", name="bn", component="bn", input=parse_descriptor("a")),
        NodeSpec(kind="component", name="b", component="b", input=parse_descriptor(
            "Append(Switch(bn, Offset(bn, -1)), Round(bn, 3), "
            "IfDefined(Offset(bn, 30)), Const(0.25, 2))")),
        NodeSpec(kind="component", name="relu", component="relu", input=parse_descriptor("b")),
        NodeSpec(kind="component", name="lsm", component="lsm",
                 input=parse_descriptor("Failover(Offset(relu, 100), relu)")),
        NodeSpec(kind="component", name="noop", component="noop", input=parse_descriptor("lsm")),
        NodeSpec(kind="output", name="output", input=parse_descriptor("noop")),
    ]
    return Nnet3Spec(nodes=nodes, components=comps)


def test_descriptor_kinds_match_jax():
    _compare(_desc_spec(), n_out=6, sub=1)


def test_unported_graphs_raise():
    """Every type the JAX package forwards is ported now, and recurrent
    graphs plan (tests/test_torch_nnet3_components.py,
    tests/test_torch_nnet3_recurrent.py); a type neither package forwards
    and a back-edge to the present or the future still raise, as in the
    JAX package."""
    spec = _desc_spec()
    spec.components["relu"] = ComponentSpec("relu", "FrobnicatorComponent", {"Dim": 5})
    with pytest.raises(NotImplementedError, match="FrobnicatorComponent"):
        tn.plan_nnet3(spec, 4, subsampling=1)
    for delay in (0, 1):
        rec = _desc_spec()
        rec.nodes[1] = NodeSpec(kind="component", name="a", component="a", input=parse_descriptor(
            f"Sum(input, IfDefined(Offset(b, {delay})))"))
        with pytest.raises(NotImplementedError, match=rf"recurrent offsets \[{delay}\]"):
            jn.compile_nnet3(rec, 4, subsampling=1)
        with pytest.raises(NotImplementedError, match=rf"recurrent offsets \[{delay}\]"):
            tn.plan_nnet3(rec, 4, subsampling=1)
    # a past back-edge plans, here refused because b is needed beyond the
    # step's own time, as in the JAX package
    rec = _desc_spec()
    rec.nodes[1] = NodeSpec(kind="component", name="a", component="a",
                            input=parse_descriptor("Sum(input, IfDefined(Offset(b, -1)))"))
    for plan in (jn.compile_nnet3, tn.plan_nnet3):
        with pytest.raises(NotImplementedError, match="carried node 'b'"):
            plan(rec, 4, subsampling=1)
