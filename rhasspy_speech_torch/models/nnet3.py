"""nnet3 graph -> batched PyTorch forward, feed-forward and recurrent.

Counterpart of ``rhasspy_speech_tpu/models/nnet3.py``. The plan -- per-node
time ranges for a fixed output window, batchnorms collapsed into the next
linear component, the back-edges of a recurrent graph, parameters extracted
as NumPy -- is copied from there (``_desc_ranges``, ``_collect_back_refs``,
``_prune_back_edges``, ``collapse_batchnorms``, ``_extract_params``,
``plan_nnet3``), because that module imports JAX; the tests hold the copy's
``ranges`` and recurrent fields equal to the original's. ``CompiledNnet3``
is an ``nn.Module`` that evaluates the planned graph as a chain of batched
tensor ops over ``[streams, frames, dim]``; the matmuls are
``torch.matmul``, as the JAX package leaves them to XLA.

Every descriptor kind (node, offset, append, sum, switch, scale, const,
replace_index, round, ifdefined, failover; round and failover raise inside
a recurrent graph, as in the JAX package) and every component type the JAX
package forwards (``SUPPORTED_COMPONENTS``, Kaldi's factory inventory less
the types the file reader rejects) is ported. A graph whose descriptors
read a node defined later in config order is recurrent (an LSTM's
``IfDefined(Offset(r, -3))``): it is planned for one step and evaluated one
step per ``rec_stride`` input frames, carrying a ring of each
back-referenced node's last values (``init_state``, ``forward_with_state``),
as the JAX package's ``lax.scan`` does, here as a Python loop over steps.
``cast(torch.bfloat16)`` gives a plan that computes in bf16; its forward
takes and returns f32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..device import cached_index, resolve_device
from ..io.nnet3_file import ComponentSpec, Descriptor, Nnet3Spec, NodeSpec

_AFFINE = ("AffineComponent", "NaturalGradientAffineComponent", "FixedAffineComponent")
_NOOP = (
    "NoOpComponent",
    "GeneralDropoutComponent",
    "SpecAugmentTimeMaskComponent",
    "BackpropTruncationComponent",
    "ClipGradientComponent",
)
_PER_ELEMENT_SCALE = ("PerElementScaleComponent", "NaturalGradientPerElementScaleComponent")
_CONSTANT = ("ConstantComponent", "ConstantFunctionComponent")
_REPEATED_AFFINE = ("RepeatedAffineComponent", "NaturalGradientRepeatedAffineComponent")
# the types _component_forward answers: the JAX package's forwardable set
SUPPORTED_COMPONENTS = frozenset(
    _AFFINE
    + _NOOP
    + _PER_ELEMENT_SCALE
    + _CONSTANT
    + _REPEATED_AFFINE
    + (
        "LinearComponent",
        "TdnnComponent",
        "RectifiedLinearComponent",
        "SigmoidComponent",
        "TanhComponent",
        "LogSoftmaxComponent",
        "SoftmaxComponent",
        "BatchNormComponent",
        "NormalizeComponent",
        "SumBlockComponent",
        "PerElementOffsetComponent",
        "PnormComponent",
        "ElementwiseProductComponent",
        "SumGroupComponent",
        "PermuteComponent",
        "FixedScaleComponent",
        "FixedBiasComponent",
        "BlockAffineComponent",
        "ScaleAndOffsetComponent",
        "DropoutComponent",
        "DropoutMaskComponent",
        "CompositeComponent",
        "LstmNonlinearityComponent",
    )
)

# ---------------------------------------------------------------------------
# Planning: per-node time ranges (copied from the JAX package)
# ---------------------------------------------------------------------------


def _accumulate(acc: Dict[str, Tuple[int, int]], name: str, lo: int, hi: int) -> None:
    if hi <= lo:
        return
    cur = acc.get(name)
    if cur is None:
        acc[name] = (lo, hi)
    else:
        acc[name] = (min(cur[0], lo), max(cur[1], hi))


def _desc_ranges(
    desc: Descriptor, lo: int, hi: int, acc: Dict[str, Tuple[int, int]]
) -> None:
    kind = desc[0]
    if kind == "node":
        _accumulate(acc, desc[1], lo, hi)
    elif kind == "offset":
        _desc_ranges(desc[1], lo + desc[2], hi + desc[2], acc)
    elif kind in ("append", "sum", "switch"):
        for sub in desc[1]:
            _desc_ranges(sub, lo, hi, acc)
    elif kind == "scale":
        _desc_ranges(desc[2], lo, hi, acc)
    elif kind == "const":
        pass
    elif kind == "replace_index":
        _desc_ranges(desc[1], desc[3], desc[3] + 1, acc)
    elif kind == "round":
        m = desc[2]
        new_lo = (lo // m) * m
        new_hi = ((hi - 1) // m) * m + 1
        _desc_ranges(desc[1], new_lo, new_hi, acc)
    elif kind == "ifdefined":
        _desc_ranges(desc[1], lo, hi, acc)
    elif kind == "failover":
        _desc_ranges(desc[1], lo, hi, acc)
        _desc_ranges(desc[2], lo, hi, acc)
    else:
        raise ValueError(f"unknown descriptor kind {kind}")


def _collect_node_refs(desc: Descriptor, out: set) -> None:
    kind = desc[0]
    if kind == "node":
        out.add(desc[1])
    elif kind in ("append", "sum", "switch"):
        for sub in desc[1]:
            _collect_node_refs(sub, out)
    elif kind in ("offset", "ifdefined"):
        _collect_node_refs(desc[1], out)
    elif kind == "scale":
        _collect_node_refs(desc[2], out)
    elif kind in ("replace_index", "round"):
        _collect_node_refs(desc[1], out)
    elif kind == "failover":
        _collect_node_refs(desc[1], out)
        _collect_node_refs(desc[2], out)


def collapse_batchnorms(
    spec: Nnet3Spec, protected: Tuple[str, ...] = ()
) -> Nnet3Spec:
    """Kaldi CollapseModel for inference: each BatchNormComponent whose
    output feeds exactly one linear-family component through a plain node
    reference is folded into that component's weights and deleted. Shared,
    block-wise, multi-consumer or ``protected`` BN nodes stay."""
    import dataclasses as _dc

    nodes = list(spec.nodes)
    comps = dict(spec.components)
    did_fold = False
    linear_types = {"LinearComponent", "TdnnComponent", *_AFFINE}
    changed = True
    while changed:
        changed = False
        refs: Dict[str, List[int]] = {}
        for i, n in enumerate(nodes):
            out: set = set()
            if n.input is not None:
                _collect_node_refs(n.input, out)
            if n.kind == "dim-range":
                out.add(n.input_node)
            for name in out:
                refs.setdefault(name, []).append(i)
        comp_uses: Dict[str, int] = {}
        for n in nodes:
            if n.kind == "component":
                comp_uses[n.component] = comp_uses.get(n.component, 0) + 1
        for i, bn_node in enumerate(nodes):
            if bn_node.kind != "component" or bn_node.name in protected:
                continue
            comp = comps.get(bn_node.component)
            if comp is None or comp.type != "BatchNormComponent":
                continue
            if comp_uses.get(bn_node.component, 0) != 1:
                continue
            dim = comp.attrs["Dim"]
            if comp.attrs.get("BlockDim", dim) != dim:
                continue
            users = refs.get(bn_node.name, [])
            if len(users) != 1:
                continue
            c_node = nodes[users[0]]
            if c_node.kind != "component" or c_node.input != ("node", bn_node.name):
                continue
            c_comp = comps[c_node.component]
            if c_comp.type not in linear_types:
                continue
            if comp_uses.get(c_node.component, 0) != 1:
                continue
            bn = _extract_params(comp)
            scale, offset = bn["scale"], bn["offset"]
            key = "Params" if c_comp.type == "LinearComponent" else "LinearParams"
            W = np.array(c_comp.attrs[key], dtype=np.float32)  # [out, in_tot]
            if W.shape[1] % dim != 0:
                continue
            extra_b = np.zeros(W.shape[0], np.float32)
            for blk in range(W.shape[1] // dim):
                sl = slice(blk * dim, (blk + 1) * dim)
                extra_b += W[:, sl] @ offset
                W[:, sl] = W[:, sl] * scale[None, :]
            attrs = dict(c_comp.attrs)
            attrs[key] = W
            old_b = attrs.get("BiasParams")
            if old_b is not None and getattr(old_b, "shape", (0,))[0]:
                attrs["BiasParams"] = old_b.astype(np.float32) + extra_b
            else:
                attrs["BiasParams"] = extra_b
            comps[c_node.component] = ComponentSpec(c_comp.name, c_comp.type, attrs)
            nodes[users[0]] = _dc.replace(c_node, input=bn_node.input)
            del nodes[i]
            comps.pop(bn_node.component, None)
            changed = True
            did_fold = True
            break
    if not did_fold:
        return spec
    return Nnet3Spec(
        nodes=nodes,
        components=comps,
        left_context=spec.left_context,
        right_context=spec.right_context,
        priors=spec.priors,
    )


def _collect_back_refs(desc: Descriptor, out: set, cur_off: int) -> None:
    """Collect (node name, accumulated time offset) for every reference."""
    kind = desc[0]
    if kind == "node":
        out.add((desc[1], cur_off))
    elif kind in ("append", "sum", "switch"):
        for sub in desc[1]:
            _collect_back_refs(sub, out, cur_off)
    elif kind == "offset":
        _collect_back_refs(desc[1], out, cur_off + desc[2])
    elif kind == "ifdefined":
        _collect_back_refs(desc[1], out, cur_off)
    elif kind == "scale":
        _collect_back_refs(desc[2], out, cur_off)
    elif kind in ("replace_index", "round"):
        _collect_back_refs(desc[1], out, cur_off)
    elif kind == "failover":
        _collect_back_refs(desc[1], out, cur_off)
        _collect_back_refs(desc[2], out, cur_off)


def _prune_back_edges(desc: Descriptor, later_names: set):
    """Copy of a descriptor with references to later-defined nodes removed
    (for range planning; those reads come from the carried state). Returns
    None when the whole descriptor is a back-edge."""
    kind = desc[0]
    if kind == "node":
        return None if desc[1] in later_names else desc
    if kind in ("append", "sum", "switch"):
        kept = [s for s in (_prune_back_edges(s, later_names) for s in desc[1]) if s is not None]
        return (kind, kept) if kept else None
    if kind == "offset":
        sub = _prune_back_edges(desc[1], later_names)
        return None if sub is None else ("offset", sub, desc[2])
    if kind == "ifdefined":
        sub = _prune_back_edges(desc[1], later_names)
        return None if sub is None else ("ifdefined", sub)
    if kind == "scale":
        sub = _prune_back_edges(desc[2], later_names)
        return None if sub is None else ("scale", desc[1], sub)
    if kind in ("replace_index", "round"):
        sub = _prune_back_edges(desc[1], later_names)
        return None if sub is None else (kind, sub) + tuple(desc[2:])
    if kind == "failover":
        a = _prune_back_edges(desc[1], later_names)
        b = _prune_back_edges(desc[2], later_names)
        if a is None:
            return b
        if b is None:
            return a
        return ("failover", a, b)
    if kind == "const":
        return desc
    raise ValueError(kind)


def _component_time_offsets(comp: ComponentSpec) -> List[int]:
    if comp.type == "TdnnComponent":
        return [int(x) for x in comp.attrs["TimeOffsets"]]
    return [0]


def _desc_dim(desc: Descriptor, node_dims: Dict[str, int]) -> int:
    kind = desc[0]
    if kind == "node":
        return node_dims[desc[1]]
    if kind == "append":
        return sum(_desc_dim(s, node_dims) for s in desc[1])
    if kind in ("sum", "switch"):
        return _desc_dim(desc[1][0], node_dims)
    if kind == "scale":
        return _desc_dim(desc[2], node_dims)
    if kind == "const":
        return desc[2]
    if kind in ("offset", "replace_index", "round", "ifdefined", "failover"):
        return _desc_dim(desc[1], node_dims)
    raise ValueError(kind)


def _extract_params(comp: ComponentSpec) -> Dict[str, np.ndarray]:
    """Inference parameters of a component, as NumPy arrays (the JAX
    package's extraction)."""
    t, a = comp.type, comp.attrs
    if t in _AFFINE:
        return {"w": a["LinearParams"].T.copy(), "b": a["BiasParams"]}
    if t in ("LinearComponent", "TdnnComponent"):
        out = {"w": a["Params" if t == "LinearComponent" else "LinearParams"].T.copy()}
        if a.get("BiasParams") is not None and np.asarray(a["BiasParams"]).shape[0]:
            out["b"] = a["BiasParams"]
        return out
    if t == "BatchNormComponent":
        eps = a.get("Epsilon", 1.0e-3)
        target_rms = a.get("TargetRms", 1.0)
        scale = target_rms / np.sqrt(a["StatsVar"] + eps)
        return {
            "scale": scale.astype(np.float32),
            "offset": (-a["StatsMean"] * scale).astype(np.float32),
        }
    if t in _PER_ELEMENT_SCALE:
        return {"scale": a["Params"]}
    if t == "PerElementOffsetComponent":
        return {"offset": a["Offsets"]}
    if t == "LstmNonlinearityComponent":
        return {"lstm_params": a["Params"]}  # [3, C]: w_ic, w_fc, w_oc
    if t == "FixedScaleComponent":
        return {"scale": a["Scales"]}
    if t == "FixedBiasComponent":
        return {"offset": a["Bias"]}
    if t in _CONSTANT:
        return {"const": a["Output"]}
    if t in _REPEATED_AFFINE or t == "BlockAffineComponent":
        return {"w": a["LinearParams"], "b": a["BiasParams"]}
    if t == "ScaleAndOffsetComponent":
        # cu::EnsureNonzero with the component's epsilon (1e-4), applied
        # once at load (nnet-simple-component.h:1921)
        eps = 1.0e-4
        s = np.asarray(a["Scales"], dtype=np.float32)
        s = np.where(np.abs(s) >= eps, s, np.where(s >= 0.0, eps, -eps))
        return {"scale": s.astype(np.float32), "offset": a["Offsets"]}
    if t == "CompositeComponent":
        return {
            f"sub{i}:{k}": v
            for i, sub in enumerate(a["Components"])
            for k, v in _extract_params(sub).items()
        }
    return {}


@dataclass
class Nnet3Plan:
    """An nnet3 graph planned for a fixed output window: per-node [lo, hi)
    time ranges on the output clock (before subsampling), evaluation order,
    node dims and NumPy parameters.

    A recurrent plan (``recurrent``) covers one step at output time 0:
    ``carried`` names the back-referenced nodes, each carried as a ring of
    its last ``carry_depths`` step values; ``recurrence`` is the largest
    delay; the stepwise evaluator runs one step per ``rec_stride`` input
    frames (the gcd of the subsampling and the delays), reading
    ``step_input_range`` of the input a step, and ``ranges['input']`` is the
    whole window a call reads."""

    spec: Nnet3Spec
    num_out_frames: int
    subsampling: int
    output_name: str
    ranges: Dict[str, Tuple[int, int]]
    order: List[NodeSpec]
    node_dims: Dict[str, int]
    params: Dict[str, Dict[str, np.ndarray]] = field(default_factory=dict)
    ivector_period: int = 0
    recurrent: bool = False
    recurrence: int = 0
    carried: Tuple[str, ...] = ()
    carry_depths: Tuple[int, ...] = ()
    step_input_range: Tuple[int, int] = (0, 0)
    rec_stride: int = 0

    @property
    def left_context(self) -> int:
        if self.recurrent:
            return -self.step_input_range[0]
        return -self.ranges["input"][0]

    @property
    def right_context(self) -> int:
        last_out_t = (self.num_out_frames - 1) * self.subsampling
        return self.ranges["input"][1] - 1 - last_out_t


def plan_nnet3(
    spec: Nnet3Spec,
    num_out_frames: int,
    subsampling: int = 3,
    output_name: str = "output",
    ivector_period: int = 0,
    collapse: bool = True,
) -> Nnet3Plan:
    """Plan per-node time ranges for output times {0, sub, ..., sub*(N-1)},
    or for one step of a recurrent graph (the JAX package's
    compile_nnet3)."""
    if collapse:
        spec = collapse_batchnorms(spec, protected=(output_name,))
    node_by_name = {n.name: n for n in spec.nodes}
    if output_name not in node_by_name:
        raise KeyError(f"no output node {output_name!r}")
    for comp in spec.components.values():
        if comp.type not in SUPPORTED_COMPONENTS:
            raise NotImplementedError(f"component type {comp.type} has no forward")

    # back-edges (references to nodes defined LATER in config order) mark
    # LSTM-style recurrences, with their time offsets
    seen_names: set = set()
    back_refs: Dict[str, set] = {}
    for node in spec.nodes:
        if node.kind in ("component", "output") and node.input is not None:
            refs: set = set()
            _collect_back_refs(node.input, refs, 0)
            for name, off in refs:
                if name not in seen_names and name != node.name:
                    back_refs.setdefault(name, set()).add(off)
        seen_names.add(node.name)

    recurrent = bool(back_refs)
    recurrence = 0
    carry_depths: Dict[str, int] = {}
    rec_stride = subsampling
    if recurrent:
        offsets = {off for offs in back_refs.values() for off in offs}
        bad = [o for o in offsets if o >= 0]
        if bad:
            raise NotImplementedError(
                f"recurrent offsets {sorted(offsets)} — each delay must be negative "
                f"(a non-negative back-edge references the future); got {sorted(bad)}"
            )
        # a delay that is not a multiple of the subsampling drops the step
        # stride to the gcd: subsampling / rec_stride steps an output frame
        for o in offsets:
            rec_stride = math.gcd(rec_stride, -o)
        recurrence = max(-o for o in offsets)
        for name, offs in back_refs.items():
            carry_depths[name] = max(-o for o in offs) // rec_stride

    node_dims: Dict[str, int] = {}
    for node in spec.nodes:
        if node.kind in ("input", "dim-range"):
            node_dims[node.name] = node.dim
        elif node.kind == "component":
            node_dims[node.name] = spec.components[node.component].output_dim
        elif node.kind == "output":
            node_dims[node.name] = _desc_dim(node.input, node_dims)

    # backward range planning; a recurrent graph plans ONE step (output
    # time 0) without its back-edges, which read the carried state
    ranges: Dict[str, Tuple[int, int]] = {}
    if recurrent:
        last_t = 0
        for name in back_refs:
            ranges[name] = (0, 1)
    else:
        last_t = (num_out_frames - 1) * subsampling
    _accumulate(ranges, output_name, 0, last_t + 1)

    names_after: Dict[str, set] = {}
    if recurrent:
        suffix: set = set()
        for node in reversed(spec.nodes):
            names_after[node.name] = set(suffix)
            suffix.add(node.name)

    def plan_desc(desc: Descriptor, lo: int, hi: int, later: set) -> None:
        if later:
            desc = _prune_back_edges(desc, later)
        if desc is not None:
            _desc_ranges(desc, lo, hi, ranges)

    for node in reversed(spec.nodes):
        if node.name not in ranges or node.kind == "input":
            continue
        lo, hi = ranges[node.name]
        later = names_after.get(node.name, set())
        if node.kind == "component":
            offs = _component_time_offsets(spec.components[node.component])
            plan_desc(node.input, lo + offs[0], hi + offs[-1], later)
        elif node.kind == "output":
            plan_desc(node.input, lo, hi, later)
        elif node.kind == "dim-range":
            _accumulate(ranges, node.input_node, lo, hi)

    if recurrent:
        for name in back_refs:
            if ranges.get(name) != (0, 1):
                raise NotImplementedError(
                    f"carried node {name!r} needed over {ranges.get(name)} within one "
                    "step (only the step time is supported)"
                )

    params = {name: _extract_params(comp) for name, comp in spec.components.items()}
    order = [n for n in spec.nodes if n.name in ranges or n.kind == "input"]

    step_input_range = (0, 0)
    if recurrent:
        # the caller gathers the whole window from ranges['input']; with
        # rec_stride < subsampling a chunk also runs the sub-steps up to the
        # next chunk's step grid (subsampling - rec_stride more frames)
        step_input_range = ranges["input"]
        lo, hi = step_input_range
        extra = subsampling - rec_stride if rec_stride < subsampling else 0
        ranges = dict(ranges)
        ranges["input"] = (lo, (num_out_frames - 1) * subsampling + hi + extra)

    return Nnet3Plan(
        spec=spec,
        num_out_frames=num_out_frames,
        subsampling=subsampling,
        output_name=output_name,
        ranges=ranges,
        order=order,
        node_dims=node_dims,
        params=params,
        ivector_period=ivector_period,
        recurrent=recurrent,
        recurrence=recurrence,
        carried=tuple(sorted(back_refs)),
        carry_depths=tuple(carry_depths[n] for n in sorted(back_refs)),
        step_input_range=step_input_range,
        rec_stride=rec_stride,
    )


def params_from_numpy(
    params: Dict[str, Dict[str, np.ndarray]], device: Union[str, torch.device] = "cuda"
) -> Dict[str, Dict[str, torch.Tensor]]:
    """Component name -> {parameter name -> f32 tensor} on ``device`` (the
    card by default; ``"cpu"`` when asked); takes a plan's NumPy parameters
    or the JAX package's ``CompiledNnet3.params`` through ``np.asarray``."""
    device = resolve_device(device)
    return {
        name: {
            k: torch.as_tensor(np.array(v, dtype=np.float32), device=device)
            for k, v in comp.items()
        }
        for name, comp in params.items()
    }


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _component_forward(
    comp: ComponentSpec, p: Dict[str, torch.Tensor], x: torch.Tensor, offs: List[int]
) -> torch.Tensor:
    """Forward one component (Kaldi's test-mode Propagate). For
    TdnnComponent, ``x`` covers [lo + min_off, hi + max_off) and the result
    [lo, hi)."""
    t, a = comp.type, comp.attrs
    if t in _AFFINE:
        return x @ p["w"] + p["b"]
    if t == "LinearComponent":
        y = x @ p["w"]
        return y + p["b"] if "b" in p else y
    if t == "TdnnComponent":
        # one matmul per time offset, summed: the [B, T, len(offs)*D]
        # splice never materializes
        T_out = x.shape[1] - (offs[-1] - offs[0])
        D = x.shape[-1]
        y = None
        for i, o in enumerate(offs):
            xi = x[:, o - offs[0] : o - offs[0] + T_out]
            yi = xi @ p["w"][i * D : (i + 1) * D]
            y = yi if y is None else y + yi
        return y + p["b"] if "b" in p else y
    if t == "RectifiedLinearComponent":
        return torch.clamp_min(x, 0.0)
    if t == "SigmoidComponent":
        return torch.sigmoid(x)
    if t == "TanhComponent":
        return torch.tanh(x)
    if t == "LogSoftmaxComponent":
        return torch.log_softmax(x, dim=-1)
    if t == "SoftmaxComponent":
        return torch.softmax(x, dim=-1)
    if t == "BatchNormComponent":
        dim = a["Dim"]
        block = a.get("BlockDim", dim)
        if block != dim:
            xb = x.reshape(x.shape[:-1] + (dim // block, block))
            return (xb * p["scale"] + p["offset"]).reshape(x.shape)
        return x * p["scale"] + p["offset"]
    if t == "NormalizeComponent":
        # each block scaled to RMS target_rms; AddLogStddev appends
        # 0.5 * log(sumsq / block) a block (Kaldi's NormalizePerRow)
        block = a.get("BlockDim", a["InputDim"])
        nblocks = x.shape[-1] // block
        xb = x.reshape(x.shape[:-1] + (nblocks, block))
        sumsq = (xb * xb).sum(dim=-1, keepdim=True).clamp_min(1.0e-20)
        y = xb * (a.get("TargetRms", 1.0) * math.sqrt(block) * torch.rsqrt(sumsq))
        if a.get("AddLogStddev", False):
            y = torch.cat([y, 0.5 * torch.log(sumsq / block)], dim=-1)
            return y.reshape(x.shape[:-1] + (nblocks * (block + 1),))
        return y.reshape(x.shape)
    if t == "SumBlockComponent":
        in_dim, out_dim = a["InputDim"], a["OutputDim"]
        xb = x.reshape(x.shape[:-1] + (in_dim // out_dim, out_dim))
        return a.get("Scale", 1.0) * xb.sum(dim=-2)
    if t in _PER_ELEMENT_SCALE or t == "FixedScaleComponent":
        return x * p["scale"]
    if t in ("PerElementOffsetComponent", "FixedBiasComponent"):
        return x + p["offset"]
    if t == "PnormComponent":
        # GroupPnorm p=2 over consecutive groups
        in_dim, out_dim = a["InputDim"], a["OutputDim"]
        xb = x.reshape(x.shape[:-1] + (out_dim, in_dim // out_dim))
        return torch.sqrt((xb * xb).sum(dim=-1).clamp_min(0.0))
    if t == "ElementwiseProductComponent":
        # product over input_dim / output_dim consecutive blocks
        in_dim, out_dim = a["InputDim"], a["OutputDim"]
        return x.reshape(x.shape[:-1] + (in_dim // out_dim, out_dim)).prod(dim=-2)
    if t == "SumGroupComponent":
        # sums over consecutive column ranges of the given sizes
        sizes = [int(s) for s in a["Sizes"]]
        if len(set(sizes)) == 1:
            return x.reshape(x.shape[:-1] + (len(sizes), sizes[0])).sum(dim=-1)
        bounds = np.concatenate([[0], np.cumsum(sizes)])
        return torch.stack(
            [x[..., bounds[i] : bounds[i + 1]].sum(dim=-1) for i in range(len(sizes))], dim=-1
        )
    if t == "PermuteComponent":
        # out column i = in column column_map[i]
        return x[..., cached_index(np.asarray(a["ColumnMap"], dtype=np.int64), x.device)]
    if t in _CONSTANT:
        # a learned constant row; the input's values are ignored
        c = p["const"]
        return c.expand(x.shape[:-1] + (c.shape[0],))
    if t in _REPEATED_AFFINE:
        # one [od_r, id_r] affine shared by NumRepeats blocks
        w = p["w"]
        reps = a["NumRepeats"]
        y = x.reshape(x.shape[:-1] + (reps, w.shape[1])) @ w.T
        return y.reshape(x.shape[:-1] + (reps * w.shape[0],)) + p["b"]
    if t == "BlockAffineComponent":
        # block i uses rows [i*od_b, (i+1)*od_b) of the stacked parameters
        w = p["w"]
        blocks = a["NumBlocks"]
        wb = w.reshape(blocks, w.shape[0] // blocks, w.shape[1])
        xb = x.reshape(x.shape[:-1] + (blocks, w.shape[1]))
        y = torch.einsum("...ri,roi->...ro", xb, wb)
        return y.reshape(x.shape[:-1] + (w.shape[0],)) + p["b"]
    if t == "ScaleAndOffsetComponent":
        # scales bounded away from zero at load; repeated over blocks when
        # Dim is a multiple of the stored dim
        scale, offset = p["scale"], p["offset"]
        if a["Dim"] != scale.shape[0]:
            xb = x.reshape(x.shape[:-1] + (a["Dim"] // scale.shape[0], scale.shape[0]))
            return (xb * scale + offset).reshape(x.shape)
        return x * scale + offset
    if t == "DropoutComponent":
        # test mode scales by (1 - proportion), not identity
        prop = float(a.get("DropoutProportion", 0.0))
        return x if prop == 0.0 else x * (1.0 - prop)
    if t == "DropoutMaskComponent":
        # test mode: 1.0 in continuous mode, else (1 - proportion)
        prop = float(a.get("DropoutProportion", 0.0))
        fill = 1.0 if a.get("Continuous") else 1.0 - prop
        return torch.full(x.shape[:-1] + (a["OutputDim"],), fill, dtype=x.dtype, device=x.device)
    if t == "CompositeComponent":
        # the sub-components in sequence
        for i, sub in enumerate(a["Components"]):
            prefix = f"sub{i}:"
            sub_p = {k[len(prefix):]: v for k, v in p.items() if k.startswith(prefix)}
            x = _component_forward(sub, sub_p, x, [])
        return x
    if t == "LstmNonlinearityComponent":
        # input (i, f, c, o, c_prev) parts of C; params (w_ic, w_fc, w_oc);
        # output (c_t, m_t); the output gate peeks at the new c_t
        w = p["lstm_params"]
        C = w.shape[1]
        i_part, f_part, c_part, o_part, c_prev = (x[..., k * C : (k + 1) * C] for k in range(5))
        i_t = torch.sigmoid(i_part + w[0] * c_prev)
        f_t = torch.sigmoid(f_part + w[1] * c_prev)
        c_t = f_t * c_prev + i_t * torch.tanh(c_part)
        o_t = torch.sigmoid(o_part + w[2] * c_t)
        return torch.cat([c_t, o_t * torch.tanh(c_t)], dim=-1)
    if t in _NOOP:
        return x
    raise NotImplementedError(f"component type {t} has no forward")


def _pad_time(x: torch.Tensor, before: int, after: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, 0, before, after))


class CompiledNnet3(nn.Module):
    """The planned forward as a module; parameters are buffers, so
    ``.to(device)`` moves them. ``dtype`` is the compute dtype: the forward
    takes f32 features and i-vectors, computes in ``dtype`` and returns f32
    (``cast``)."""

    def __init__(
        self,
        plan: Nnet3Plan,
        params: Dict[str, Dict[str, torch.Tensor]],
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.plan = plan
        self.dtype = dtype
        self._keys: Dict[str, Dict[str, str]] = {}
        for i, (name, comp) in enumerate(sorted(params.items())):
            self._keys[name] = {}
            for k, v in comp.items():
                buf = f"c{i}_{k}"
                self.register_buffer(buf, v)
                self._keys[name][k] = buf

    @property
    def ranges(self) -> Dict[str, Tuple[int, int]]:
        return self.plan.ranges

    @property
    def right_context(self) -> int:
        return self.plan.right_context

    @property
    def recurrent(self) -> bool:
        return self.plan.recurrent

    def component_params(self, name: str) -> Dict[str, torch.Tensor]:
        return {k: getattr(self, buf) for k, buf in self._keys.get(name, {}).items()}

    def cast(self, dtype: torch.dtype) -> "CompiledNnet3":
        """A copy of this plan with its parameters in ``dtype`` (e.g.
        ``torch.bfloat16``: cuBLAS bf16 products, accumulated in f32 with
        the flag ``device.py`` sets). The copy's forward still takes and
        returns f32."""
        params = {
            name: {k: getattr(self, buf).to(dtype) for k, buf in keys.items()}
            for name, keys in self._keys.items()
        }
        return CompiledNnet3(self.plan, params, dtype)

    def _computable_range(self, desc: Descriptor) -> Tuple[int, int]:
        kind = desc[0]
        if kind == "node":
            return self.plan.ranges[desc[1]]
        if kind == "offset":
            lo, hi = self._computable_range(desc[1])
            return lo - desc[2], hi - desc[2]
        if kind in ("append", "sum", "switch"):
            los, his = zip(*(self._computable_range(s) for s in desc[1]))
            return max(los), min(his)
        if kind == "scale":
            return self._computable_range(desc[2])
        if kind in ("const", "replace_index", "ifdefined"):
            return (-(10**9), 10**9)
        if kind == "round":
            return self._computable_range(desc[1])
        if kind == "failover":
            return self._computable_range(desc[2])
        raise ValueError(kind)

    def forward(self, feats: torch.Tensor, ivector: Optional[torch.Tensor] = None) -> torch.Tensor:
        """feats [B, num_input_frames, feat_dim] (feats[:, 0] is input time
        ranges['input'][0]); ivector [B, K] (one per stream) or [B, n, K]
        every ivector_period frames from t=0. Returns
        [B, num_out_frames, output_dim] f32. A recurrent plan starts from
        zero state."""
        feats = feats.to(self.dtype)
        if ivector is not None:
            ivector = ivector.to(self.dtype)
        if self.plan.recurrent:
            return self._forward_recurrent(feats, ivector)[0].to(torch.float32)
        return self._forward_plain(feats, ivector).to(torch.float32)

    def _forward_plain(self, feats: torch.Tensor, ivector: Optional[torch.Tensor]) -> torch.Tensor:
        plan = self.plan
        B = feats.shape[0]
        dev = feats.device
        values: Dict[str, torch.Tensor] = {}
        origins: Dict[str, int] = {}

        def read(name: str, lo: int, hi: int) -> torch.Tensor:
            org = origins[name]
            return values[name][:, lo - org : hi - org]

        eval_desc = self._desc_evaluator(read, B, feats.dtype, dev)

        in_lo, in_hi = plan.ranges["input"]
        if feats.shape[1] != in_hi - in_lo:
            raise ValueError(
                f"feats must have {in_hi - in_lo} frames (got {feats.shape[1]}): "
                f"left_context={plan.left_context}, chunk={plan.num_out_frames}x"
                f"{plan.subsampling}, right_context={plan.right_context}"
            )
        values["input"] = feats
        origins["input"] = in_lo

        if "ivector" in plan.ranges:
            if ivector is None:
                raise ValueError("model requires an ivector input")
            iv_lo, iv_hi = plan.ranges["ivector"]
            if ivector.dim() == 2:
                ivector = ivector[:, None, :]
            period = plan.ivector_period if plan.ivector_period > 0 else max(iv_hi - iv_lo, 1)
            ts = np.arange(iv_lo, iv_hi)
            idx = np.clip(np.maximum(ts, 0) // period, 0, ivector.shape[1] - 1)
            values["ivector"] = ivector[:, cached_index(idx, dev)]
            origins["ivector"] = iv_lo

        for node in plan.order:
            if node.kind == "input":
                continue
            lo, hi = plan.ranges[node.name]
            values[node.name] = self._node_value(node, lo, hi, eval_desc, values, origins)
            origins[node.name] = lo

        out = values[plan.output_name]
        idx = np.arange(plan.num_out_frames) * plan.subsampling - origins[plan.output_name]
        return out[:, cached_index(idx, dev)]

    def _desc_evaluator(self, read, B: int, dtype: torch.dtype, dev, step_t0: Optional[int] = None):
        """The descriptor evaluator ``eval_desc(desc, lo, hi)`` over node
        values that ``read(name, lo, hi)`` returns. ``step_t0`` is a
        recurrent step's absolute input-clock time (``i * rec_stride``),
        None in the plain forward. Inside a step ``Switch`` selects by
        ``step_t0 + t``, ``IfDefined`` passes through (a carried node's zero
        initial rows stand for the undefined frames) and ``Round`` and
        ``Failover`` raise, as in the JAX package's step."""
        step = step_t0 is not None

        def eval_desc(desc: Descriptor, lo: int, hi: int) -> torch.Tensor:
            kind = desc[0]
            if kind == "node":
                return read(desc[1], lo, hi)
            if kind == "offset":
                return eval_desc(desc[1], lo + desc[2], hi + desc[2])
            if kind == "append":
                return torch.cat([eval_desc(s, lo, hi) for s in desc[1]], dim=-1)
            if kind == "sum":
                parts = [eval_desc(s, lo, hi) for s in desc[1]]
                out = parts[0]
                for part in parts[1:]:
                    out = out + part
                return out
            if kind == "switch":
                # value at time t from sub-descriptor t mod n
                parts = [eval_desc(s, lo, hi) for s in desc[1]]
                sel = cached_index(((step_t0 or 0) + np.arange(lo, hi)) % len(parts), dev)
                out = parts[0]
                for i in range(1, len(parts)):
                    out = torch.where((sel == i)[None, :, None], parts[i], out)
                return out
            if kind == "scale":
                return desc[1] * eval_desc(desc[2], lo, hi)
            if kind == "const":
                return torch.full((B, hi - lo, desc[2]), desc[1], dtype=dtype, device=dev)
            if kind == "replace_index":
                one = eval_desc(desc[1], desc[3], desc[3] + 1)
                return one.expand(one.shape[0], hi - lo, one.shape[2])
            if kind == "ifdefined":
                if step:
                    return eval_desc(desc[1], lo, hi)
                # frames outside the sub-descriptor's computable range read 0
                sub_lo, sub_hi = self._computable_range(desc[1])
                ov_lo, ov_hi = max(lo, sub_lo), min(hi, sub_hi)
                if ov_hi <= ov_lo:
                    dim = _desc_dim(desc[1], self.plan.node_dims)
                    return torch.zeros((B, hi - lo, dim), dtype=dtype, device=dev)
                return _pad_time(eval_desc(desc[1], ov_lo, ov_hi), ov_lo - lo, hi - ov_hi)
            if step:
                raise NotImplementedError(f"descriptor {kind!r} inside a recurrent graph")
            if kind == "round":
                m = desc[2]
                src = (np.arange(lo, hi) // m) * m
                sub_lo, sub_hi = int(src.min()), int(src.max()) + 1
                arr = eval_desc(desc[1], sub_lo, sub_hi)
                return arr[:, cached_index(src - sub_lo, dev)]
            if kind == "failover":
                sub_lo, sub_hi = self._computable_range(desc[1])
                if sub_lo <= lo and hi <= sub_hi:
                    return eval_desc(desc[1], lo, hi)
                return eval_desc(desc[2], lo, hi)
            raise ValueError(kind)

        return eval_desc

    def _node_value(self, node: NodeSpec, lo: int, hi: int, eval_desc, values, origins):
        """A component, output or dim-range node over [lo, hi)."""
        if node.kind == "component":
            comp = self.plan.spec.components[node.component]
            offs = _component_time_offsets(comp)
            x = eval_desc(node.input, lo + offs[0], hi + offs[-1])
            return _component_forward(comp, self.component_params(node.component), x, offs)
        if node.kind == "output":
            return eval_desc(node.input, lo, hi)
        if node.kind == "dim-range":
            src_lo = origins[node.input_node]
            return values[node.input_node][
                :, lo - src_lo : hi - src_lo, node.dim_offset : node.dim_offset + node.dim
            ]
        raise ValueError(node.kind)  # pragma: no cover

    # -- recurrent plans --------------------------------------------------------

    def init_state(
        self, batch: int, dtype: Optional[torch.dtype] = None
    ) -> Dict[str, torch.Tensor]:
        """Zero recurrence state (Kaldi zero-initializes recurrences): per
        carried node a [batch, depth, dim] ring of its last ``depth`` step
        values, on the parameters' device, in the compute dtype unless
        ``dtype`` says otherwise."""
        plan = self.plan
        dev = next(iter(self.buffers())).device
        return {
            name: torch.zeros((batch, depth, plan.node_dims[name]),
                              dtype=dtype or self.dtype, device=dev)
            for name, depth in zip(plan.carried, plan.carry_depths)
        }

    def forward_with_state(
        self,
        feats: torch.Tensor,
        state: Dict[str, torch.Tensor],
        ivector: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Recurrent forward continuing from ``state`` (e.g. the previous
        streaming chunk's); returns (f32 output, new state)."""
        feats = feats.to(self.dtype)
        if ivector is not None:
            ivector = ivector.to(self.dtype)
        out, new_state = self._forward_recurrent(feats, ivector, carry0=state, return_state=True)
        return out.to(torch.float32), new_state

    def _forward_recurrent(
        self,
        feats: torch.Tensor,
        ivector: Optional[torch.Tensor] = None,
        carry0: Optional[Dict[str, torch.Tensor]] = None,
        return_state: bool = False,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One step per ``rec_stride`` input frames, carrying a ring of each
        back-referenced node's last ``depth`` step values; with a stride
        below the subsampling, subsampling / rec_stride steps an output
        frame of which every such step's output is emitted (Kaldi's looped
        compiler computes at the input frame rate the same way). Chunked
        calls (``return_state``) run the sub-steps past the last output too,
        so the carry lands on the next chunk's step grid."""
        plan = self.plan
        s = plan.subsampling
        g = plan.rec_stride or s
        spo = s // g  # steps an output frame
        lo, hi = plan.step_input_range
        win = hi - lo
        B = feats.shape[0]
        extra = s - g if spo > 1 else 0
        expected = (plan.num_out_frames - 1) * s + win + extra
        if feats.shape[1] != expected:
            raise ValueError(f"feats must have {expected} frames (got {feats.shape[1]})")
        ivec_row = None
        if "ivector" in plan.ranges:
            if ivector is None:
                raise ValueError("model requires an ivector input")
            ivec_row = ivector[:, 0] if ivector.dim() == 3 else ivector  # [B, D]
        carry = carry0 if carry0 is not None else self.init_state(B, feats.dtype)
        num_steps = (
            plan.num_out_frames * spo if (return_state and spo > 1)
            else (plan.num_out_frames - 1) * spo + 1
        )
        outs = []
        for i in range(num_steps):
            out_i, carry = self._step(i, feats[:, i * g : i * g + win], ivec_row, carry)
            outs.append(out_i)
        return torch.stack(outs[::spo], dim=1), carry

    def _step(
        self,
        i: int,
        window: torch.Tensor,
        ivec_row: Optional[torch.Tensor],
        carry: Dict[str, torch.Tensor],
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Step ``i``: the graph at step time 0 over ``window`` (input times
        ``step_input_range``); returns (the output row, the new carry)."""
        plan = self.plan
        g = plan.rec_stride or plan.subsampling
        B, dev, dtype = window.shape[0], window.device, window.dtype
        depths = dict(zip(plan.carried, plan.carry_depths))
        values: Dict[str, torch.Tensor] = {"input": window}
        origins: Dict[str, int] = {"input": plan.step_input_range[0]}
        if ivec_row is not None:
            iv_lo, iv_hi = plan.ranges["ivector"]
            values["ivector"] = ivec_row[:, None, :].expand(B, iv_hi - iv_lo, ivec_row.shape[-1])
            origins["ivector"] = iv_lo

        def read(name: str, lo_t: int, hi_t: int) -> torch.Tensor:
            if name not in values and name in depths:
                depth = depths[name]
                j = -lo_t // g  # steps back
                if hi_t != lo_t + 1 or lo_t >= 0 or (-lo_t) % g != 0 or j > depth:
                    raise NotImplementedError(
                        f"back-reference to {name!r} at times [{lo_t},{hi_t}) (carry "
                        f"holds the last {depth} step(s) at stride {g})"
                    )
                return carry[name][:, depth - j][:, None, :]
            org = origins[name]
            return values[name][:, lo_t - org : hi_t - org]

        eval_desc = self._desc_evaluator(read, B, dtype, dev, step_t0=i * g)

        for node in plan.order:
            if node.kind == "input":
                continue
            n_lo, n_hi = plan.ranges[node.name]
            values[node.name] = self._node_value(node, n_lo, n_hi, eval_desc, values, origins)
            origins[node.name] = n_lo

        new_carry = {
            name: torch.cat([carry[name][:, 1:], values[name][:, -origins[name]][:, None]], dim=1)
            for name in plan.carried
        }
        return values[plan.output_name][:, -origins[plan.output_name]], new_carry


def compile_nnet3(
    spec: Nnet3Spec,
    num_out_frames: int,
    subsampling: int = 3,
    output_name: str = "output",
    ivector_period: int = 0,
    collapse: bool = True,
    device: Union[str, torch.device] = "cuda",
) -> CompiledNnet3:
    """Plan ``spec`` for ``num_out_frames`` outputs and build its module on
    ``device`` with the plan's own parameters."""
    plan = plan_nnet3(spec, num_out_frames, subsampling, output_name, ivector_period, collapse)
    return CompiledNnet3(plan, params_from_numpy(plan.params, device))
