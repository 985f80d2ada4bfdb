"""TFLite flatbuffer reading + Coqui STT model conversion (no TF needed).

The reference runs real Coqui `model.tflite` files through the TFLite
interpreter (coqui_stt/native_client/tflitemodelstate.h:34,
stt_onlyprobs.cpp:12-84). Here the same weights are pulled straight out of
the flatbuffer and laid into the JAX CTC model's npz layout
(models/ctc.py), so a Coqui export dir (model.tflite + alphabet.txt) loads
without any out-of-repo conversion step.

Implements just enough of the flatbuffer wire format for the stable TFLite
schema (tensorflow/lite/schema/schema.fbs, file identifier TFL3):

- root: uoffset32 at byte 0 to the Model table; identifier at bytes 4-8;
- table: int32 soffset to its vtable; vtable = [u16 vtable_size,
  u16 table_size, u16 field offsets by field id];
- scalars inline; tables/vectors/strings as forward uoffset32 from the
  reference location; vectors/strings prefixed by a u32 length.

A spec-faithful fixture writer (:func:`build_tflite`) backs the round-trip
tests — it emits real flatbuffers, byte-layout rules included, so the
reader is exercised against the format rather than a mock.
"""

from __future__ import annotations

import re
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

# TensorType enum (schema.fbs)
TENSOR_DTYPES = {
    0: np.dtype(np.float32),
    1: np.dtype(np.float16),
    2: np.dtype(np.int32),
    3: np.dtype(np.uint8),
    4: np.dtype(np.int64),
    5: np.dtype("S1"),  # STRING (buffer holds a string table; kept raw)
    6: np.dtype(np.bool_),
    7: np.dtype(np.int16),
    9: np.dtype(np.int8),
    10: np.dtype(np.float64),
}
DTYPE_CODES = {v: k for k, v in TENSOR_DTYPES.items()}

FILE_IDENTIFIER = b"TFL3"


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------


class _Table:
    """Cursor over one flatbuffer table."""

    def __init__(self, data: bytes, pos: int) -> None:
        self.data = data
        self.pos = pos
        soffset = struct.unpack_from("<i", data, pos)[0]
        self.vtable = pos - soffset
        self.vtable_size = struct.unpack_from("<H", data, self.vtable)[0]

    def _field_pos(self, field_id: int) -> Optional[int]:
        entry = 4 + 2 * field_id
        if entry + 2 > self.vtable_size:
            return None
        rel = struct.unpack_from("<H", self.data, self.vtable + entry)[0]
        return self.pos + rel if rel else None

    def scalar(self, field_id: int, fmt: str, default):
        pos = self._field_pos(field_id)
        if pos is None:
            return default
        return struct.unpack_from(fmt, self.data, pos)[0]

    def _indirect(self, field_id: int) -> Optional[int]:
        pos = self._field_pos(field_id)
        if pos is None:
            return None
        return pos + struct.unpack_from("<I", self.data, pos)[0]

    def table(self, field_id: int) -> Optional["_Table"]:
        pos = self._indirect(field_id)
        return None if pos is None else _Table(self.data, pos)

    def _vector(self, field_id: int) -> Optional[Tuple[int, int]]:
        pos = self._indirect(field_id)
        if pos is None:
            return None
        length = struct.unpack_from("<I", self.data, pos)[0]
        return pos + 4, length

    def scalar_vector(self, field_id: int, dtype: np.dtype) -> Optional[np.ndarray]:
        vec = self._vector(field_id)
        if vec is None:
            return None
        start, length = vec
        return np.frombuffer(self.data, dtype=dtype, count=length, offset=start)

    def table_vector(self, field_id: int) -> List["_Table"]:
        vec = self._vector(field_id)
        if vec is None:
            return []
        start, length = vec
        tables = []
        for i in range(length):
            ref = start + 4 * i
            target = ref + struct.unpack_from("<I", self.data, ref)[0]
            tables.append(_Table(self.data, target))
        return tables

    def string(self, field_id: int) -> Optional[str]:
        vec = self._vector(field_id)
        if vec is None:
            return None
        start, length = vec
        return self.data[start : start + length].decode("utf-8")


@dataclass
class TfliteTensor:
    name: str
    shape: Tuple[int, ...]
    type_code: int
    data: Optional[np.ndarray]  # None when the buffer is empty (activations)

    @property
    def raw_bytes(self) -> Optional[bytes]:
        return None if self.data is None else self.data.tobytes()


@dataclass
class TfliteModel:
    tensors: List[TfliteTensor]
    inputs: List[int]
    outputs: List[int]
    description: str = ""

    def by_name(self) -> Dict[str, TfliteTensor]:
        return {t.name: t for t in self.tensors}


def read_tflite(path: Union[str, Path]) -> TfliteModel:
    """Parse a .tflite file's first subgraph: named tensors with weights."""
    data = Path(path).read_bytes()
    if len(data) < 8:
        raise ValueError("tflite file too short")
    if data[4:8] != FILE_IDENTIFIER:
        raise ValueError(
            f"not a TFLite flatbuffer (identifier {data[4:8]!r} != TFL3)"
        )
    root = _Table(data, struct.unpack_from("<I", data, 0)[0])

    version = root.scalar(0, "<i", 0)
    if version != 3:
        raise ValueError(f"unsupported TFLite schema version {version}")

    subgraphs = root.table_vector(2)
    if not subgraphs:
        raise ValueError("tflite model has no subgraphs")
    buffers = root.table_vector(4)
    graph = subgraphs[0]

    raw_buffers: List[Optional[bytes]] = []
    for buf in buffers:
        vec = buf._vector(0)
        if vec is None or vec[1] == 0:
            raw_buffers.append(None)
        else:
            start, length = vec
            raw_buffers.append(data[start : start + length])

    tensors: List[TfliteTensor] = []
    for t in graph.table_vector(0):
        shape_vec = t.scalar_vector(0, np.dtype("<i4"))
        shape = tuple(int(x) for x in shape_vec) if shape_vec is not None else ()
        type_code = t.scalar(1, "<b", 0)
        buffer_idx = t.scalar(2, "<I", 0)
        name = t.string(3) or ""

        arr = None
        raw = raw_buffers[buffer_idx] if buffer_idx < len(raw_buffers) else None
        if raw is not None:
            dtype = TENSOR_DTYPES.get(type_code)
            if dtype is None or type_code == 5:
                arr = np.frombuffer(raw, dtype=np.uint8)
            else:
                arr = np.frombuffer(raw, dtype=dtype)
                if shape and int(np.prod(shape)) == arr.size:
                    arr = arr.reshape(shape)
        tensors.append(TfliteTensor(name, shape, type_code, arr))

    inputs_vec = graph.scalar_vector(1, np.dtype("<i4"))
    outputs_vec = graph.scalar_vector(2, np.dtype("<i4"))
    return TfliteModel(
        tensors=tensors,
        inputs=[int(x) for x in inputs_vec] if inputs_vec is not None else [],
        outputs=[int(x) for x in outputs_vec] if outputs_vec is not None else [],
        description=root.string(3) or "",
    )


# ---------------------------------------------------------------------------
# Coqui STT (DeepSpeech) weight mapping
# ---------------------------------------------------------------------------

_LAYER_RE = re.compile(r"(?:^|/)layer_(\d+)/(weights|bias)(?::0)?$")
_LSTM_RE = re.compile(r"lstm.*/(kernel|bias)(?::0)?$")


def coqui_params_from_tflite(
    model: TfliteModel,
) -> Tuple[Dict[str, np.ndarray], int, Optional[str]]:
    """Map a Coqui STT graph's named weight tensors onto the CTC model's
    parameter layout (models/ctc.py).

    DeepSpeech topology (stt.cc:62-138): layer_1..3 dense+relu over
    context-spliced MFCC windows, a unidirectional cudnn-compatible LSTM,
    layer_5 dense+relu, layer_6 output logits. Returns (params, context,
    alphabet text if embedded)."""
    named = model.by_name()

    lstm_kernel = lstm_bias = None
    layer_weights: Dict[int, np.ndarray] = {}
    layer_biases: Dict[int, np.ndarray] = {}
    for tensor in model.tensors:
        if tensor.data is None:
            continue
        m = _LAYER_RE.search(tensor.name)
        if m:
            idx = int(m.group(1))
            target = layer_weights if m.group(2) == "weights" else layer_biases
            target[idx] = np.asarray(tensor.data, dtype=np.float32)
            continue
        m = _LSTM_RE.search(tensor.name)
        if m:
            arr = np.asarray(tensor.data, dtype=np.float32)
            if m.group(1) == "kernel":
                lstm_kernel = arr
            else:
                lstm_bias = arr

    if not layer_weights:
        raise ValueError(
            "no layer_N/weights tensors found — not a Coqui STT export?"
        )
    indices = sorted(layer_weights)
    for idx in indices:
        if idx not in layer_biases:
            raise ValueError(f"layer_{idx} has weights but no bias")

    out_idx = indices[-1]
    pre, post = [], []
    for idx in indices[:-1]:
        # Layers numbered after the LSTM slot (DeepSpeech's layer_5) run
        # post-LSTM; without an LSTM every hidden layer is a pre-dense.
        if lstm_kernel is not None and idx >= 5:
            post.append(idx)
        else:
            pre.append(idx)

    params: Dict[str, np.ndarray] = {}
    for i, idx in enumerate(pre, start=1):
        params[f"dense{i}_w"] = layer_weights[idx]
        params[f"dense{i}_b"] = layer_biases[idx]
    for i, idx in enumerate(post, start=1):
        params[f"post{i}_w"] = layer_weights[idx]
        params[f"post{i}_b"] = layer_biases[idx]
    params["out_w"] = layer_weights[out_idx]
    params["out_b"] = layer_biases[out_idx]
    if lstm_kernel is not None:
        if lstm_bias is None:
            raise ValueError("LSTM kernel present but no bias tensor")
        params["lstm_kernel"] = lstm_kernel
        params["lstm_bias"] = lstm_bias
        # CudnnCompatibleLSTMCell bakes the forget bias into the weights
        # (TF's BasicLSTMCell adds 1.0 at run time instead — the synthetic
        # models' convention and ctc.py's default).
        params["lstm_forget_bias"] = np.asarray(0.0, dtype=np.float32)

    # Context from the input node: [1, n_steps, 2*context+1, n_input]
    context = 0
    for idx in model.inputs:
        shape = model.tensors[idx].shape
        if len(shape) == 4 and shape[2] % 2 == 1:
            context = (shape[2] - 1) // 2
            break

    alphabet = None
    meta = named.get("metadata_alphabet")
    if meta is not None and meta.data is not None:
        alphabet = bytes(meta.data.tobytes()).decode("utf-8", errors="replace")

    return params, context, alphabet


def convert_coqui_tflite(
    tflite_path: Union[str, Path],
    npz_path: Optional[Union[str, Path]] = None,
    alphabet_path: Optional[Union[str, Path]] = None,
    device="cuda",
):
    """model.tflite → CtcModel on ``device`` (optionally persisting
    model.npz and an embedded alphabet). Returns the loaded
    :class:`~..models.ctc.CtcModel`."""
    from ..models.ctc import CtcModel

    model = read_tflite(tflite_path)
    params, context, alphabet = coqui_params_from_tflite(model)

    ctc = CtcModel.from_numpy(params, context, device)
    if npz_path is not None:
        ctc.save(str(npz_path))
    if alphabet_path is not None and alphabet is not None:
        Path(alphabet_path).write_text(alphabet, encoding="utf-8")
    return ctc


# ---------------------------------------------------------------------------
# Fixture writer (spec-faithful, for round-trip tests)
# ---------------------------------------------------------------------------


class _Builder:
    """Minimal flatbuffer builder: the file is assembled back-to-front, so
    every reference is a forward uoffset as the format requires."""

    def __init__(self) -> None:
        self.buf = bytearray()

    def _prepend(self, data: bytes) -> int:
        """Prepend raw bytes; returns the object's distance-from-file-end
        (its 'rpos'). uoffset from a later field = field_rpos - target_rpos."""
        self.buf[:0] = data
        return len(self.buf)

    def _align(self, size: int, extra: int = 0) -> None:
        while (len(self.buf) + extra) % size:
            self.buf[:0] = b"\0"

    def scalar_vector(self, values: Sequence, fmt: str, elem_size: int) -> int:
        body = b"".join(struct.pack(fmt, v) for v in values)
        self._align(max(4, elem_size), extra=len(body) + 4)
        return self._prepend(struct.pack("<I", len(values)) + body)

    def byte_vector(self, data: bytes) -> int:
        self._align(4, extra=len(data) + 4)
        return self._prepend(struct.pack("<I", len(data)) + data)

    def string(self, text: str) -> int:
        raw = text.encode("utf-8")
        self._align(4, extra=len(raw) + 1 + 4)
        return self._prepend(struct.pack("<I", len(raw)) + raw + b"\0")

    def offset_vector(self, rpos_list: Sequence[int]) -> int:
        self._align(4, extra=4 * len(rpos_list) + 4)
        total = 4 + 4 * len(rpos_list)
        parts = [struct.pack("<I", len(rpos_list))]
        base = len(self.buf) + total  # rpos of the vector start
        for i, target in enumerate(rpos_list):
            field_rpos = base - 4 - 4 * i
            parts.append(struct.pack("<I", field_rpos - target))
        return self._prepend(b"".join(parts))

    def table(self, fields: Dict[int, Tuple[str, object]]) -> int:
        """fields: id -> (kind, value); kind in int8/int32/uint32/offset."""
        sizes = {"int8": 1, "int32": 4, "uint32": 4, "offset": 4}
        max_id = max(fields) if fields else -1

        # Lay out the table body: soffset32 then fields in id order.
        slots: Dict[int, int] = {}
        cursor = 4
        for fid in sorted(fields):
            size = sizes[fields[fid][0]]
            cursor = (cursor + size - 1) // size * size
            slots[fid] = cursor
            cursor += size
        table_size = (cursor + 3) // 4 * 4

        self._align(4, extra=table_size)
        body = bytearray(table_size)
        struct.pack_into("<i", body, 0, 0)  # soffset patched below
        for fid, (kind, value) in fields.items():
            at = slots[fid]
            if kind == "int8":
                struct.pack_into("<b", body, at, value)
            elif kind == "int32":
                struct.pack_into("<i", body, at, value)
            elif kind == "uint32":
                struct.pack_into("<I", body, at, value)
            else:  # offset: uoffset from this field to the target rpos
                field_rpos = len(self.buf) + table_size - at
                struct.pack_into("<I", body, at, field_rpos - value)
        table_rpos = self._prepend(bytes(body))

        vt_len = 4 + 2 * (max_id + 1)
        vt = bytearray(vt_len)
        struct.pack_into("<H", vt, 0, vt_len)
        struct.pack_into("<H", vt, 2, table_size)
        for fid, at in slots.items():
            struct.pack_into("<H", vt, 4 + 2 * fid, at)
        self._align(2, extra=vt_len)
        vt_rpos = self._prepend(bytes(vt))

        # Patch the table's soffset = table_pos - vtable_pos (abs) which in
        # rpos terms is vt_rpos - table_rpos (vtable sits at a lower abs).
        table_at = len(self.buf) - table_rpos
        struct.pack_into("<i", self.buf, table_at, vt_rpos - table_rpos)
        return table_rpos

    def finish(self, root_rpos: int) -> bytes:
        # Alignment was maintained in rpos (distance-from-end) terms; keep
        # it true in absolute terms by padding the front to a 4 multiple
        # (the 8-byte header is itself 4-aligned).
        while len(self.buf) % 4:
            self.buf[:0] = b"\0"
        total = len(self.buf) + 8
        root_abs = total - root_rpos  # uoffset stored at byte 0
        return struct.pack("<I", root_abs) + FILE_IDENTIFIER + bytes(self.buf)


def build_tflite(
    weights: Dict[str, np.ndarray],
    input_shape: Sequence[int],
    description: str = "fixture",
    alphabet: Optional[str] = None,
) -> bytes:
    """Assemble a real (schema v3) .tflite flatbuffer holding the named
    weight tensors plus an input-node activation tensor — the round-trip
    fixture for the converter tests."""
    b = _Builder()

    entries = list(weights.items())
    if alphabet is not None:
        entries.append(
            ("metadata_alphabet", np.frombuffer(alphabet.encode(), np.uint8))
        )

    # Buffers (buffer 0 is the canonical empty buffer)
    buffer_rpos = [b.table({})]
    for _name, arr in entries:
        data_rpos = b.byte_vector(np.ascontiguousarray(arr).tobytes())
        buffer_rpos.append(b.table({0: ("offset", data_rpos)}))
    buffers_vec = b.offset_vector(buffer_rpos)

    tensor_rpos = []
    for i, (name, arr) in enumerate(entries):
        arr = np.asarray(arr)
        type_code = DTYPE_CODES.get(arr.dtype, 0) if arr.dtype != np.uint8 else 3
        shape_rpos = b.scalar_vector(arr.shape, "<i", 4)
        name_rpos = b.string(name)
        tensor_rpos.append(
            b.table(
                {
                    0: ("offset", shape_rpos),
                    1: ("int8", type_code),
                    2: ("uint32", i + 1),
                    3: ("offset", name_rpos),
                }
            )
        )
    # Input activation tensor (buffer 0: no data)
    in_shape_rpos = b.scalar_vector(input_shape, "<i", 4)
    in_name_rpos = b.string("input_node")
    input_index = len(tensor_rpos)
    tensor_rpos.append(
        b.table(
            {
                0: ("offset", in_shape_rpos),
                1: ("int8", 0),
                2: ("uint32", 0),
                3: ("offset", in_name_rpos),
            }
        )
    )
    tensors_vec = b.offset_vector(tensor_rpos)
    inputs_vec = b.scalar_vector([input_index], "<i", 4)
    outputs_vec = b.scalar_vector([], "<i", 4)

    subgraph = b.table(
        {
            0: ("offset", tensors_vec),
            1: ("offset", inputs_vec),
            2: ("offset", outputs_vec),
        }
    )
    subgraphs_vec = b.offset_vector([subgraph])
    desc_rpos = b.string(description)

    model = b.table(
        {
            0: ("int32", 3),  # schema version
            2: ("offset", subgraphs_vec),
            3: ("offset", desc_rpos),
            4: ("offset", buffers_vec),
        }
    )
    return b.finish(model)
