"""nnet3 graph -> batched PyTorch forward (feed-forward graphs).

Counterpart of ``rhasspy_speech_tpu/models/nnet3.py``. The plan -- per-node
time ranges for a fixed output window, batchnorms collapsed into the next
linear component, parameters extracted as NumPy -- is copied from there
(``_desc_ranges``, ``collapse_batchnorms``, ``_extract_params``,
``plan_nnet3``), because that module imports JAX; the tests hold the copy's
``ranges`` equal to the original's. ``CompiledNnet3`` is an ``nn.Module``
that evaluates the planned graph as a chain of batched tensor ops over
``[streams, frames, dim]``; the matmuls are ``torch.matmul``, as the JAX
package leaves them to XLA.

Supported: the descriptor kinds node, offset, append, sum, switch, scale,
const, replace_index, round, ifdefined and failover, and the component
types the TDNN-F (``testing/tdnnf.py``) and the synthetic profile
(``testing/synthetic.py``) use. Recurrent graphs and the other component
types raise ``NotImplementedError`` (ROADMAP Queue 1, item 4).
"""

from __future__ import annotations

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
SUPPORTED_COMPONENTS = frozenset(
    _AFFINE
    + _NOOP
    + (
        "LinearComponent",
        "TdnnComponent",
        "RectifiedLinearComponent",
        "BatchNormComponent",
        "LogSoftmaxComponent",
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
    """Inference parameters of a supported component, as NumPy arrays
    (the JAX package's extraction for these types)."""
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
    return {}


@dataclass
class Nnet3Plan:
    """A feed-forward nnet3 graph planned for a fixed output window:
    per-node [lo, hi) time ranges on the output clock (before
    subsampling), evaluation order, node dims and NumPy parameters."""

    spec: Nnet3Spec
    num_out_frames: int
    subsampling: int
    output_name: str
    ranges: Dict[str, Tuple[int, int]]
    order: List[NodeSpec]
    node_dims: Dict[str, int]
    params: Dict[str, Dict[str, np.ndarray]] = field(default_factory=dict)
    ivector_period: int = 0

    @property
    def left_context(self) -> int:
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
    """Plan per-node time ranges for output times {0, sub, ..., sub*(N-1)}
    (the JAX package's compile_nnet3 for feed-forward graphs)."""
    if collapse:
        spec = collapse_batchnorms(spec, protected=(output_name,))
    node_by_name = {n.name: n for n in spec.nodes}
    if output_name not in node_by_name:
        raise KeyError(f"no output node {output_name!r}")

    seen = set()
    for node in spec.nodes:
        if node.kind in ("component", "output") and node.input is not None:
            refs: set = set()
            _collect_node_refs(node.input, refs)
            later = {r for r in refs if r not in seen and r != node.name}
            if later:
                raise NotImplementedError(
                    f"recurrent nnet3 graphs are not ported (node {node.name!r} "
                    f"reads {sorted(later)} from a later node; ROADMAP Queue 1, item 4)"
                )
        seen.add(node.name)
    for comp in spec.components.values():
        if comp.type not in SUPPORTED_COMPONENTS:
            raise NotImplementedError(
                f"component type {comp.type} is not ported (ROADMAP Queue 1, item 4)"
            )

    node_dims: Dict[str, int] = {}
    for node in spec.nodes:
        if node.kind in ("input", "dim-range"):
            node_dims[node.name] = node.dim
        elif node.kind == "component":
            node_dims[node.name] = spec.components[node.component].output_dim
        elif node.kind == "output":
            node_dims[node.name] = _desc_dim(node.input, node_dims)

    ranges: Dict[str, Tuple[int, int]] = {}
    _accumulate(ranges, output_name, 0, (num_out_frames - 1) * subsampling + 1)
    for node in reversed(spec.nodes):
        if node.name not in ranges or node.kind == "input":
            continue
        lo, hi = ranges[node.name]
        if node.kind == "component":
            offs = _component_time_offsets(spec.components[node.component])
            _desc_ranges(node.input, lo + offs[0], hi + offs[-1], ranges)
        elif node.kind == "output":
            _desc_ranges(node.input, lo, hi, ranges)
        elif node.kind == "dim-range":
            _accumulate(ranges, node.input_node, lo, hi)

    params = {name: _extract_params(comp) for name, comp in spec.components.items()}
    order = [n for n in spec.nodes if n.name in ranges or n.kind == "input"]
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
    """Forward one component. For TdnnComponent, ``x`` covers
    [lo + min_off, hi + max_off) and the result [lo, hi)."""
    t = comp.type
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
    if t == "LogSoftmaxComponent":
        return torch.log_softmax(x, dim=-1)
    if t == "BatchNormComponent":
        dim = comp.attrs["Dim"]
        block = comp.attrs.get("BlockDim", dim)
        if block != dim:
            xb = x.reshape(x.shape[:-1] + (dim // block, block))
            return (xb * p["scale"] + p["offset"]).reshape(x.shape)
        return x * p["scale"] + p["offset"]
    if t in _NOOP:
        return x
    raise NotImplementedError(f"component type {t} is not ported (ROADMAP Queue 1, item 4)")


def _pad_time(x: torch.Tensor, before: int, after: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, 0, before, after))


class CompiledNnet3(nn.Module):
    """The planned forward as a module; parameters are buffers, so
    ``.to(device)`` moves them."""

    def __init__(self, plan: Nnet3Plan, params: Dict[str, Dict[str, torch.Tensor]]):
        super().__init__()
        self.plan = plan
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

    def component_params(self, name: str) -> Dict[str, torch.Tensor]:
        return {k: getattr(self, buf) for k, buf in self._keys.get(name, {}).items()}

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
        [B, num_out_frames, output_dim]."""
        plan = self.plan
        B = feats.shape[0]
        dev = feats.device
        values: Dict[str, torch.Tensor] = {}
        origins: Dict[str, int] = {}

        def eval_desc(desc: Descriptor, lo: int, hi: int) -> torch.Tensor:
            kind = desc[0]
            if kind == "node":
                org = origins[desc[1]]
                return values[desc[1]][:, lo - org : hi - org]
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
                sel = cached_index(np.arange(lo, hi) % len(parts), dev)
                out = parts[0]
                for i in range(1, len(parts)):
                    out = torch.where((sel == i)[None, :, None], parts[i], out)
                return out
            if kind == "scale":
                return desc[1] * eval_desc(desc[2], lo, hi)
            if kind == "const":
                return torch.full((B, hi - lo, desc[2]), desc[1], dtype=feats.dtype, device=dev)
            if kind == "replace_index":
                one = eval_desc(desc[1], desc[3], desc[3] + 1)
                return one.expand(one.shape[0], hi - lo, one.shape[2])
            if kind == "round":
                m = desc[2]
                src = (np.arange(lo, hi) // m) * m
                sub_lo, sub_hi = int(src.min()), int(src.max()) + 1
                arr = eval_desc(desc[1], sub_lo, sub_hi)
                return arr[:, cached_index(src - sub_lo, dev)]
            if kind == "ifdefined":
                # frames outside the sub-descriptor's computable range read 0
                sub_lo, sub_hi = self._computable_range(desc[1])
                ov_lo, ov_hi = max(lo, sub_lo), min(hi, sub_hi)
                if ov_hi <= ov_lo:
                    dim = _desc_dim(desc[1], plan.node_dims)
                    return torch.zeros((B, hi - lo, dim), dtype=feats.dtype, device=dev)
                return _pad_time(eval_desc(desc[1], ov_lo, ov_hi), ov_lo - lo, hi - ov_hi)
            if kind == "failover":
                sub_lo, sub_hi = self._computable_range(desc[1])
                if sub_lo <= lo and hi <= sub_hi:
                    return eval_desc(desc[1], lo, hi)
                return eval_desc(desc[2], lo, hi)
            raise ValueError(kind)

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
            if node.kind == "component":
                comp = plan.spec.components[node.component]
                offs = _component_time_offsets(comp)
                x = eval_desc(node.input, lo + offs[0], hi + offs[-1])
                y = _component_forward(comp, self.component_params(node.component), x, offs)
            elif node.kind == "output":
                y = eval_desc(node.input, lo, hi)
            elif node.kind == "dim-range":
                src_lo = origins[node.input_node]
                y = values[node.input_node][
                    :, lo - src_lo : hi - src_lo, node.dim_offset : node.dim_offset + node.dim
                ]
            else:  # pragma: no cover
                raise ValueError(node.kind)
            values[node.name] = y
            origins[node.name] = lo

        out = values[plan.output_name]
        idx = np.arange(plan.num_out_frames) * plan.subsampling - origins[plan.output_name]
        return out[:, cached_index(idx, dev)]


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
