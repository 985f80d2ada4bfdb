"""nnet3 model-file parsing: config graph + components -> Nnet3Spec.

Parses the reference's final.mdl contents (kaldi/src/nnet3/nnet-nnet.cc
Nnet::{Read,Write}: "<Nnet3>", text config lines terminated by a blank line,
"<NumComponents>", per-component "<ComponentName> name <Type> ... </Type>",
"</Nnet3>"; kaldi/src/nnet3/am-nnet-simple.cc AmNnetSimple::Read adds
<LeftContext>/<RightContext>/<Priors> after the nnet).

Components are read generically: each serialized field is "<Tag>" followed by
a self-describing payload, so a per-tag kind table covers every component
version without per-version parsers. Unknown tags raise with the tag name.

The output is a declarative ``Nnet3Spec`` (nodes + descriptor ASTs + numpy
parameter dict); the JAX forward compiler lives in models/nnet3.py.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .kaldi_io import KaldiFormatError, KaldiReader, KaldiWriter
from .transition_model import KaldiTransitionModel

# ---------------------------------------------------------------------------
# Descriptors
# ---------------------------------------------------------------------------

# AST: tuples (kind, ...) — see nnet3/nnet-descriptor.h for semantics
#   ("node", name)
#   ("offset", sub, t_offset)
#   ("append", [subs])
#   ("sum", [subs])
#   ("scale", alpha, sub)
#   ("const", value, dim)
#   ("replace_index", sub, var_name, value)
#   ("round", sub, modulus)
#   ("ifdefined", sub)
#   ("failover", sub, sub2)
#   ("switch", [subs])
Descriptor = Tuple

_TOKEN_RE = re.compile(r"\s*([A-Za-z_][A-Za-z0-9_.\-]*|-?\d+\.?\d*(?:[eE][+-]?\d+)?|[(),])")

_FUNCS = {
    "Append",
    "Sum",
    "Failover",
    "IfDefined",
    "Offset",
    "Switch",
    "Round",
    "ReplaceIndex",
    "Scale",
    "Const",
}


def _tokenize_descriptor(text: str) -> List[str]:
    tokens = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if not m:
            if text[pos:].strip() == "":
                break
            raise KaldiFormatError(f"bad descriptor text at {text[pos:pos+30]!r}")
        tokens.append(m.group(1))
        pos = m.end()
    return tokens


class _DescParser:
    def __init__(self, tokens: List[str]):
        self.tokens = tokens
        self.pos = 0

    def peek(self) -> Optional[str]:
        return self.tokens[self.pos] if self.pos < len(self.tokens) else None

    def next(self) -> str:
        tok = self.peek()
        if tok is None:
            raise KaldiFormatError("descriptor ended unexpectedly")
        self.pos += 1
        return tok

    def expect(self, tok: str) -> None:
        got = self.next()
        if got != tok:
            raise KaldiFormatError(f"descriptor: expected {tok!r}, got {got!r}")

    def parse(self) -> Descriptor:
        tok = self.next()
        if tok in _FUNCS and self.peek() == "(":
            self.expect("(")
            if tok == "Offset":
                sub = self.parse()
                self.expect(",")
                t_off = int(self.next())
                # optional x offset (unused in practice; must be absent or 0)
                if self.peek() == ",":
                    self.next()
                    x_off = int(self.next())
                    if x_off != 0:
                        raise KaldiFormatError("Offset with x!=0 unsupported")
                self.expect(")")
                return ("offset", sub, t_off)
            if tok in ("Append", "Sum", "Switch"):
                subs = [self.parse()]
                while self.peek() == ",":
                    self.next()
                    subs.append(self.parse())
                self.expect(")")
                return (tok.lower(), subs)
            if tok == "Scale":
                alpha = float(self.next())
                self.expect(",")
                sub = self.parse()
                self.expect(")")
                return ("scale", alpha, sub)
            if tok == "Const":
                value = float(self.next())
                self.expect(",")
                dim = int(self.next())
                self.expect(")")
                return ("const", value, dim)
            if tok == "ReplaceIndex":
                sub = self.parse()
                self.expect(",")
                var = self.next()
                self.expect(",")
                value = int(self.next())
                self.expect(")")
                return ("replace_index", sub, var, value)
            if tok == "Round":
                sub = self.parse()
                self.expect(",")
                modulus = int(self.next())
                self.expect(")")
                return ("round", sub, modulus)
            if tok == "IfDefined":
                sub = self.parse()
                self.expect(")")
                return ("ifdefined", sub)
            if tok == "Failover":
                sub = self.parse()
                self.expect(",")
                sub2 = self.parse()
                self.expect(")")
                return ("failover", sub, sub2)
        # plain node reference
        return ("node", tok)


def parse_descriptor(text: str) -> Descriptor:
    parser = _DescParser(_tokenize_descriptor(text))
    result = parser.parse()
    if parser.peek() is not None:
        raise KaldiFormatError(f"trailing descriptor tokens: {parser.tokens[parser.pos:]}")
    return result


def descriptor_to_string(d: Descriptor) -> str:
    kind = d[0]
    if kind == "node":
        return d[1]
    if kind == "offset":
        return f"Offset({descriptor_to_string(d[1])}, {d[2]})"
    if kind in ("append", "sum", "switch"):
        inner = ", ".join(descriptor_to_string(s) for s in d[1])
        return f"{kind.capitalize()}({inner})"
    if kind == "scale":
        return f"Scale({d[1]}, {descriptor_to_string(d[2])})"
    if kind == "const":
        return f"Const({d[1]}, {d[2]})"
    if kind == "replace_index":
        return f"ReplaceIndex({descriptor_to_string(d[1])}, {d[2]}, {d[3]})"
    if kind == "round":
        return f"Round({descriptor_to_string(d[1])}, {d[2]})"
    if kind == "ifdefined":
        return f"IfDefined({descriptor_to_string(d[1])})"
    if kind == "failover":
        return f"Failover({descriptor_to_string(d[1])}, {descriptor_to_string(d[2])})"
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Nodes
# ---------------------------------------------------------------------------


@dataclass
class NodeSpec:
    kind: str  # "input" | "component" | "output" | "dim-range"
    name: str
    dim: int = -1  # input-node dim / dim-range dim
    component: str = ""  # component-node: component name
    input: Optional[Descriptor] = None  # component/output nodes
    objective: str = "linear"  # output nodes
    input_node: str = ""  # dim-range nodes
    dim_offset: int = 0  # dim-range nodes


def _parse_config_line(line: str) -> Tuple[str, Dict[str, str]]:
    parts = line.strip().split(None, 1)
    head = parts[0]
    kv: Dict[str, str] = {}
    rest = parts[1] if len(parts) > 1 else ""
    # key=value pairs where value may contain commas/parens but no spaces
    # (nnet3 descriptor text in config lines may contain spaces inside
    # parens, e.g. "Append(Offset(input, -1), input)")
    pos = 0
    while pos < len(rest):
        m = re.match(r"\s*([a-zA-Z0-9ـ_.\-]+)=", rest[pos:])
        if not m:
            break
        key = m.group(1)
        vstart = pos + m.end()
        depth = 0
        vend = vstart
        while vend < len(rest):
            c = rest[vend]
            if c == "(":
                depth += 1
            elif c == ")":
                depth -= 1
            elif c == " " and depth == 0:
                break
            vend += 1
        kv[key] = rest[vstart:vend]
        pos = vend
    return head, kv


# ---------------------------------------------------------------------------
# Components — generic tag-table reader
# ---------------------------------------------------------------------------

# kinds: i=int, f=float, b=bool, v=vector, m=matrix, iv=int-vector,
# i2=two ints, f2=two floats
_TAG_KINDS: Dict[str, str] = {
    "<LearningRate>": "f",
    "<LearningRateFactor>": "f",
    "<MaxChange>": "f",
    "<L2Regularize>": "f",
    "<IsGradient>": "b",
    "<LinearParams>": "m",
    "<BiasParams>": "v",
    # matrix for Linear/LstmNonlinearity, vector for PerElementScale
    "<Params>": "vm",
    "<OrthonormalConstraint>": "f",
    "<UseNaturalGradient>": "b",
    "<RankIn>": "i",
    "<RankOut>": "i",
    "<RankInOut>": "i2",
    "<Alpha>": "f",
    "<AlphaInOut>": "f2",
    "<NumSamplesHistory>": "f",
    "<UpdatePeriod>": "i",
    "<TimeOffsets>": "iv",
    "<Dim>": "i",
    "<InputDim>": "i",
    "<OutputDim>": "i",
    "<BlockDim>": "i",
    "<ValueAvg>": "vm",
    "<DerivAvg>": "vm",
    "<ValueSum>": "v",
    "<DerivSum>": "v",
    "<OderivRms>": "v",
    "<Count>": "f",
    "<OderivCount>": "f",
    "<NumDimsSelfRepaired>": "i",
    "<NumDimsProcessed>": "i",
    "<SelfRepairLowerThreshold>": "f",
    "<SelfRepairUpperThreshold>": "f",
    "<SelfRepairScale>": "f",
    "<Epsilon>": "f",
    "<TargetRms>": "f",
    "<TestMode>": "b",
    "<StatsMean>": "v",
    "<StatsVar>": "v",
    "<Scale>": "f",
    "<BackpropScale>": "f",
    "<AddLogStddev>": "b",
    "<Offsets>": "v",
    "<DropoutProportion>": "f",
    "<DropoutPerFrame>": "b",
    "<TimePeriod>": "i",
    "<SpecAugmentMaxProportion>": "f",
    "<SpecAugmentMaxRegions>": "i",
    "<Continuous>": "b",
    "<GradientScale>": "f",
    "<ZeroingThreshold>": "f",
    "<ZeroingInterval>": "i",
    "<RecurrenceInterval>": "i",
    "<NumElementsZeroed>": "f",
    "<NumElementsProcessed>": "f",
    "<NumZeroed>": "f",
    "<NumProcessed>": "f",
    "<ClippingThreshold>": "f",
    "<NumClipped>": "f",
    "<NumBackpropped>": "f",
    "<NumElementsClipped>": "f",
    "<SelfRepairConfig>": "v",
    "<SelfRepairProb>": "v",
    "<UseDropout>": "b",
    # full-inventory audit additions (nnet-simple-component.h /
    # nnet-general-component.h serialization):
    "<Sizes>": "iv",  # SumGroupComponent
    "<ColumnMap>": "iv",  # PermuteComponent
    "<Scales>": "v",  # FixedScaleComponent / ScaleAndOffsetComponent
    "<Bias>": "v",  # FixedBiasComponent
    "<Output>": "v",  # Constant(Function)Component
    "<IsUpdatable>": "b",  # Constant(Function)Component
    "<NumRepeats>": "i",  # RepeatedAffineComponent
    "<NumBlocks>": "i",  # BlockAffineComponent
    "<Rank>": "i",  # ScaleAndOffsetComponent preconditioner rank
}

# Tags whose payload differs per component type. Kind "flag": the tag's
# PRESENCE is the value (no payload bytes follow) — GeneralDropoutComponent
# and DropoutMaskComponent write <TestMode>/<Continuous> this way
# (nnet-general-component.cc GeneralDropoutComponent::Write: bare
# WriteToken, read back via PeekToken), while BatchNormComponent's
# <TestMode> carries a bool payload. Reading a phantom payload here would
# desync the stream one byte into the next tag.
_TYPE_TAG_OVERRIDES: Dict[Tuple[str, str], str] = {
    ("GeneralDropoutComponent", "<TestMode>"): "flag",
    ("GeneralDropoutComponent", "<Continuous>"): "flag",
    ("DropoutMaskComponent", "<Continuous>"): "flag",
}

# ---------------------------------------------------------------------------
# Component-type registry (full factory inventory audit)
#
# Every type constructible by Component::NewComponentOfType
# (kaldi/src/nnet3/nnet-component-itf.cc GenerateRandomSimpleComponent /
# NewComponentOfType switch) is classified here. Reading a REJECTED or
# unknown type raises at load time with the type name — no component a
# model can contain is in an unknown state (silently mis-executed).
# ---------------------------------------------------------------------------

# Types with a faithful inference forward in models/nnet3.py.
SUPPORTED_TYPES = {
    "AffineComponent",
    "NaturalGradientAffineComponent",
    "FixedAffineComponent",
    "LinearComponent",
    "TdnnComponent",
    "BatchNormComponent",
    "NormalizeComponent",
    "RectifiedLinearComponent",
    "SigmoidComponent",
    "TanhComponent",
    "SoftmaxComponent",
    "LogSoftmaxComponent",
    "SumBlockComponent",
    "PerElementScaleComponent",
    "NaturalGradientPerElementScaleComponent",
    "PerElementOffsetComponent",
    "LstmNonlinearityComponent",
    "PnormComponent",
    "ElementwiseProductComponent",
    "SumGroupComponent",
    "PermuteComponent",
    "FixedScaleComponent",
    "FixedBiasComponent",
    "ConstantComponent",
    "ConstantFunctionComponent",
    "RepeatedAffineComponent",
    "NaturalGradientRepeatedAffineComponent",
    "BlockAffineComponent",
    "ScaleAndOffsetComponent",
    "DropoutComponent",  # test-mode scale by (1 - proportion)
    "DropoutMaskComponent",  # test-mode constant mask
    "CompositeComponent",  # sequential sub-component apply
    # identity at test time (stats/training-only semantics):
    "NoOpComponent",
    "GeneralDropoutComponent",
    "SpecAugmentTimeMaskComponent",
    "BackpropTruncationComponent",
    "ClipGradientComponent",
}

# Types with no inference path in this build: reading one raises loudly at
# load time, naming the type. None appears in the published TDNN/TDNN-F/
# LSTM model family this framework targets.
REJECTED_TYPES = {
    "TimeHeightConvolutionComponent": (
        "2-D convolution (nnet-convolutional-component.h:212) — CNN front "
        "ends are outside the published TDNN/TDNN-F/LSTM family"
    ),
    "RestrictedAttentionComponent": (
        "self-attention (nnet-attention-component.h:106) is not used by "
        "any rhasspy-speech model"
    ),
    "StatisticsExtractionComponent": (
        "x-vector statistics layer (nnet-general-component.h:201); no "
        "speaker-embedding path in this framework"
    ),
    "StatisticsPoolingComponent": (
        "x-vector statistics layer (nnet-general-component.h:337); no "
        "speaker-embedding path in this framework"
    ),
    "DistributeComponent": (
        "row-distributing reshape (nnet-general-component.h:56) used only "
        "by multi-tower training configs"
    ),
    "ConvolutionComponent": (
        "legacy nnet2-style convolution (nnet-combined-component.h:114)"
    ),
    "MaxpoolingComponent": (
        "legacy CNN maxpooling (nnet-combined-component.h:488)"
    ),
    "GruNonlinearityComponent": (
        "GRU cell (nnet-combined-component.h:713); no published "
        "rhasspy-speech model uses GRUs"
    ),
    "OutputGruNonlinearityComponent": (
        "GRU cell (nnet-combined-component.h:979); no published "
        "rhasspy-speech model uses GRUs"
    ),
}


def check_component_type(type_name: str) -> None:
    """Raise a loud, specific error for component types outside the
    supported inventory (audit: every factory type is either supported,
    or rejected here by name at model-load time)."""
    if type_name in SUPPORTED_TYPES:
        return
    reason = REJECTED_TYPES.get(type_name)
    if reason is not None:
        raise KaldiFormatError(
            f"component type {type_name} is not supported by this build: "
            f"{reason}"
        )
    raise KaldiFormatError(
        f"unknown nnet3 component type {type_name}; the supported "
        f"inventory is {sorted(SUPPORTED_TYPES)}"
    )

@dataclass
class ComponentSpec:
    name: str
    type: str  # Kaldi type token without angle brackets
    attrs: Dict[str, Any] = field(default_factory=dict)

    @property
    def input_dim(self) -> int:
        t = self.type
        a = self.attrs
        if t in ("AffineComponent", "NaturalGradientAffineComponent",
                 "FixedAffineComponent"):
            return a["LinearParams"].shape[1]
        if t == "LinearComponent":
            return a["Params"].shape[1]
        if t == "TdnnComponent":
            return a["LinearParams"].shape[1] // len(a["TimeOffsets"])
        if t == "SumBlockComponent":
            return a["InputDim"]
        if t == "NormalizeComponent":
            return a["InputDim"]
        if t == "PerElementScaleComponent":
            return a["Params"].shape[0]
        if t == "PerElementOffsetComponent":
            return a["Offsets"].shape[0]
        if t == "LstmNonlinearityComponent":
            cell = a["Params"].shape[1]
            return 5 * cell + (3 if a.get("UseDropout") else 0)
        if t in ("PerElementScaleComponent",
                 "NaturalGradientPerElementScaleComponent"):
            return a["Params"].shape[0]
        if t == "SumGroupComponent":
            return int(sum(a["Sizes"]))
        if t == "PermuteComponent":
            return len(a["ColumnMap"])
        if t == "FixedScaleComponent":
            return a["Scales"].shape[0]
        if t == "FixedBiasComponent":
            return a["Bias"].shape[0]
        if t == "ConstantComponent":
            return a["Output"].shape[0]
        if t in ("RepeatedAffineComponent",
                 "NaturalGradientRepeatedAffineComponent"):
            return a["LinearParams"].shape[1] * a["NumRepeats"]
        if t == "BlockAffineComponent":
            return a["LinearParams"].shape[1] * a["NumBlocks"]
        if t == "DropoutMaskComponent":
            return a["OutputDim"]
        if t == "CompositeComponent":
            return a["Components"][0].input_dim
        if "Dim" in a:
            return a["Dim"]
        if "InputDim" in a:
            return a["InputDim"]
        raise KaldiFormatError(f"cannot infer input dim of {t}")

    @property
    def output_dim(self) -> int:
        t = self.type
        a = self.attrs
        if t in ("AffineComponent", "NaturalGradientAffineComponent",
                 "FixedAffineComponent"):
            return a["LinearParams"].shape[0]
        if t == "LinearComponent":
            return a["Params"].shape[0]
        if t == "TdnnComponent":
            return a["LinearParams"].shape[0]
        if t == "SumBlockComponent":
            return a["OutputDim"]
        if t == "NormalizeComponent":
            return a["InputDim"] + (1 if a.get("AddLogStddev") else 0)
        if t == "LstmNonlinearityComponent":
            return 2 * a["Params"].shape[1]
        if t in ("PnormComponent", "ElementwiseProductComponent"):
            return a["OutputDim"]
        if t == "SumGroupComponent":
            return len(a["Sizes"])
        if t == "ConstantFunctionComponent":
            return a["Output"].shape[0]
        if t in ("RepeatedAffineComponent",
                 "NaturalGradientRepeatedAffineComponent"):
            return a["LinearParams"].shape[0] * a["NumRepeats"]
        if t == "BlockAffineComponent":
            return a["LinearParams"].shape[0]
        if t == "CompositeComponent":
            return a["Components"][-1].output_dim
        return self.input_dim


def _read_composite_body(r: KaldiReader) -> Dict[str, Any]:
    """CompositeComponent body (nnet-simple-component.cc
    CompositeComponent::Read): optional <LearningRateFactor>/<IsGradient>/
    <LearningRate>, <MaxRowsProcess>, <NumComponents>, then each
    sub-component serialized with its own <Type>...</Type> envelope."""
    attrs: Dict[str, Any] = {}
    tag = r.read_token()
    if tag == "<LearningRateFactor>":
        attrs["LearningRateFactor"] = r.read_float()
        tag = r.read_token()
    if tag == "<IsGradient>":
        attrs["IsGradient"] = r.read_bool()
        tag = r.read_token()
    if tag == "<LearningRate>":
        attrs["LearningRate"] = r.read_float()
        tag = r.read_token()
    if tag != "<MaxRowsProcess>":
        raise KaldiFormatError(
            f"CompositeComponent: expected <MaxRowsProcess>, got {tag!r}"
        )
    attrs["MaxRowsProcess"] = r.read_int()
    r.expect_token("<NumComponents>")
    n = r.read_int()
    if not 0 <= n <= 100000:
        raise KaldiFormatError(f"CompositeComponent: bad sub count {n}")
    subs: List[ComponentSpec] = []
    for i in range(n):
        sub_type = r.read_token()
        if not (sub_type.startswith("<") and sub_type.endswith("Component>")):
            raise KaldiFormatError(
                f"CompositeComponent: bad sub type token {sub_type!r}"
            )
        check_component_type(sub_type[1:-1])
        sub_attrs = _read_component_body(r, sub_type)
        subs.append(
            ComponentSpec(name=f"sub{i}", type=sub_type[1:-1], attrs=sub_attrs)
        )
    attrs["Components"] = subs
    r.expect_token("</CompositeComponent>")
    return attrs


def _read_component_body(r: KaldiReader, type_token: str) -> Dict[str, Any]:
    """Read `<Tag> payload` pairs until the closing `</Type>` token."""
    type_name = type_token[1:-1]
    if type_name == "CompositeComponent":
        return _read_composite_body(r)
    close = "</" + type_token[1:]
    attrs: Dict[str, Any] = {}
    while True:
        tag = r.read_token()
        if tag == close:
            return attrs
        kind = _TYPE_TAG_OVERRIDES.get((type_name, tag)) or _TAG_KINDS.get(tag)
        if kind is None:
            raise KaldiFormatError(
                f"unknown tag {tag!r} in component {type_token}; "
                "add it to _TAG_KINDS"
            )
        key = tag[1:-1]
        if kind == "flag":
            attrs[key] = True
        elif kind == "i":
            attrs[key] = r.read_int()
        elif kind == "f":
            attrs[key] = r.read_float()
        elif kind == "b":
            attrs[key] = r.read_bool()
        elif kind == "v":
            attrs[key] = r.read_vector()
        elif kind == "m":
            attrs[key] = r.read_matrix()
        elif kind == "vm":
            attrs[key] = r.read_vector_or_matrix()
        elif kind == "iv":
            attrs[key] = r.read_int_vector()
        elif kind == "i2":
            attrs[key] = (r.read_int(), r.read_int())
        elif kind == "f2":
            attrs[key] = (r.read_float(), r.read_float())
        else:  # pragma: no cover
            raise AssertionError(kind)


# ---------------------------------------------------------------------------
# Nnet3Spec
# ---------------------------------------------------------------------------


@dataclass
class Nnet3Spec:
    nodes: List[NodeSpec]
    components: Dict[str, ComponentSpec]
    left_context: int = 0
    right_context: int = 0
    priors: Optional[np.ndarray] = None

    def node(self, name: str) -> NodeSpec:
        for n in self.nodes:
            if n.name == name:
                return n
        raise KeyError(name)

    @property
    def input_dim(self) -> int:
        return self.node("input").dim

    @property
    def ivector_dim(self) -> int:
        for n in self.nodes:
            if n.kind == "input" and n.name == "ivector":
                return n.dim
        return 0

    @property
    def output_names(self) -> List[str]:
        return [n.name for n in self.nodes if n.kind == "output"]


def _read_config_section(stream) -> List[str]:
    """Read text config lines up to (and including) the blank separator."""
    lines: List[str] = []
    # Skip the newline that follows the "<Nnet3> " token
    while True:
        raw = stream.readline()
        if raw in (b"", b"\n", b"\r\n"):
            if lines:
                break
            if raw == b"":
                raise KaldiFormatError("EOF in nnet3 config section")
            continue  # leading blank line(s)
        line = raw.decode("utf-8").strip()
        if line and not line.startswith("#"):
            lines.append(line)
    return lines


def read_nnet3(r: KaldiReader) -> Nnet3Spec:
    r.expect_token("<Nnet3>")
    lines = _read_config_section(r._s)

    nodes: List[NodeSpec] = []
    for line in lines:
        head, kv = _parse_config_line(line)
        if head == "input-node":
            nodes.append(NodeSpec(kind="input", name=kv["name"], dim=int(kv["dim"])))
        elif head == "component-node":
            nodes.append(
                NodeSpec(
                    kind="component",
                    name=kv["name"],
                    component=kv["component"],
                    input=parse_descriptor(kv["input"]),
                )
            )
        elif head == "output-node":
            nodes.append(
                NodeSpec(
                    kind="output",
                    name=kv["name"],
                    input=parse_descriptor(kv["input"]),
                    objective=kv.get("objective", "linear"),
                )
            )
        elif head == "dim-range-node":
            nodes.append(
                NodeSpec(
                    kind="dim-range",
                    name=kv["name"],
                    input_node=kv["input-node"],
                    dim=int(kv["dim"]),
                    dim_offset=int(kv["dim-offset"]),
                )
            )
        else:
            raise KaldiFormatError(f"unknown nnet3 config line {head!r}")

    r.expect_token("<NumComponents>")
    num_components = r.read_int()
    components: Dict[str, ComponentSpec] = {}
    for _ in range(num_components):
        r.expect_token("<ComponentName>")
        name = r.read_token()
        type_token = r.read_token()
        if not (type_token.startswith("<") and type_token.endswith("Component>")):
            raise KaldiFormatError(f"bad component type token {type_token!r}")
        check_component_type(type_token[1:-1])
        attrs = _read_component_body(r, type_token)
        components[name] = ComponentSpec(
            name=name, type=type_token[1:-1], attrs=attrs
        )
    r.expect_token("</Nnet3>")
    return Nnet3Spec(nodes=nodes, components=components)


def read_am_nnet3(path: str) -> Tuple[KaldiTransitionModel, Nnet3Spec]:
    """Read a final.mdl: TransitionModel + AmNnetSimple
    (am-nnet-simple.cc:  nnet, <LeftContext>, <RightContext>, <Priors>)."""
    with open(path, "rb") as f:
        r = KaldiReader(f)
        tm = KaldiTransitionModel.read(r)
        nnet = read_nnet3(r)
        try:
            tok = r.read_token()
        except KaldiFormatError:
            tok = ""
        if tok == "<LeftContext>":
            nnet.left_context = r.read_int()
            r.expect_token("<RightContext>")
            nnet.right_context = r.read_int()
            r.expect_token("<Priors>")
            start = r.peek_token_start()
            if start in ("F", "D"):
                nnet.priors = r.read_vector()
        return tm, nnet


# ---------------------------------------------------------------------------
# Writer (synthetic models / tests)
# ---------------------------------------------------------------------------


def _write_component(w: KaldiWriter, comp: ComponentSpec) -> None:
    open_tok = f"<{comp.type}>"
    w.write_token(open_tok)
    if comp.type == "CompositeComponent":
        w.write_token("<MaxRowsProcess>")
        w.write_int(comp.attrs.get("MaxRowsProcess", 4096))
        w.write_token("<NumComponents>")
        subs = comp.attrs["Components"]
        w.write_int(len(subs))
        for sub in subs:
            _write_component(w, sub)
        w.write_token("</CompositeComponent>")
        return
    for key, value in comp.attrs.items():
        tag = f"<{key}>"
        kind = (
            _TYPE_TAG_OVERRIDES.get((comp.type, tag)) or _TAG_KINDS.get(tag)
        )
        if kind is None:
            raise KaldiFormatError(f"unknown attr {key} for writing")
        if kind == "flag":
            if value:
                w.write_token(tag)
            continue
        w.write_token(tag)
        if kind == "i":
            w.write_int(value)
        elif kind == "f":
            w.write_float(value)
        elif kind == "b":
            w.write_bool(value)
        elif kind == "v":
            w.write_vector(np.asarray(value, dtype=np.float32))
        elif kind in ("m", "vm"):
            arr = np.asarray(value, dtype=np.float32)
            if arr.ndim == 1:
                w.write_vector(arr)
            else:
                w.write_matrix(arr)
        elif kind == "iv":
            w.write_int_vector(value)
        elif kind == "i2":
            w.write_int(value[0])
            w.write_int(value[1])
        elif kind == "f2":
            w.write_float(value[0])
            w.write_float(value[1])
    w.write_token(f"</{comp.type}>")


def _node_config_line(node: NodeSpec) -> str:
    if node.kind == "input":
        return f"input-node name={node.name} dim={node.dim}"
    if node.kind == "component":
        return (
            f"component-node name={node.name} component={node.component} "
            f"input={descriptor_to_string(node.input)}"
        )
    if node.kind == "output":
        return (
            f"output-node name={node.name} "
            f"input={descriptor_to_string(node.input)} objective={node.objective}"
        )
    if node.kind == "dim-range":
        return (
            f"dim-range-node name={node.name} input-node={node.input_node} "
            f"dim-offset={node.dim_offset} dim={node.dim}"
        )
    raise ValueError(node.kind)


def write_nnet3(stream, spec: Nnet3Spec, transition_model=None) -> None:
    """Write a binary model file readable by read_nnet3/read_am_nnet3.

    If transition_model is given, writes a full .mdl (TransitionModel +
    nnet + contexts + priors)."""
    w = KaldiWriter(stream)
    if transition_model is not None:
        transition_model.write(w)
    w.write_token("<Nnet3>")
    w.write_raw(b"\n")
    for node in spec.nodes:
        w.write_raw(_node_config_line(node).encode("utf-8") + b"\n")
    w.write_raw(b"\n")
    w.write_token("<NumComponents>")
    w.write_int(len(spec.components))
    for name, comp in spec.components.items():
        w.write_token("<ComponentName>")
        w.write_token(name)
        _write_component(w, comp)
    w.write_token("</Nnet3>")
    if transition_model is not None:
        w.write_token("<LeftContext>")
        w.write_int(spec.left_context)
        w.write_token("<RightContext>")
        w.write_int(spec.right_context)
        w.write_token("<Priors>")
        if spec.priors is not None:
            w.write_vector(np.asarray(spec.priors, dtype=np.float32))
        else:
            w.write_vector(np.zeros(0, dtype=np.float32))
