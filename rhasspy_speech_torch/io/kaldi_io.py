"""Kaldi binary stream format: tokens, basic types, vectors, matrices.

Byte layout follows the reference implementation exactly:
- kaldi/src/base/io-funcs.cc:134-152 (WriteToken: ASCII + trailing space),
- kaldi/src/base/io-funcs.cc:51-59 (WriteBasicType: size byte + raw LE value;
  bool is a single 'T'/'F' char),
- kaldi/src/base/io-funcs-inl.h WriteIntegerVector (elem-size byte + raw
  int32 count + raw data),
- kaldi/src/matrix/kaldi-vector.cc / kaldi-matrix.cc ("FV"/"DV"/"FM"/"DM"
  token + dims + raw row-major data),
- kaldi/src/base/io-funcs-inl.h:291-296 (binary streams start "\\0B").

Only binary mode is implemented: every published model artifact the
reference consumes is binary. Text-mode files raise with a clear message.
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Union

import numpy as np


class KaldiFormatError(ValueError):
    pass


class KaldiReader:
    """Sequential reader over a Kaldi binary stream."""

    def __init__(self, stream: BinaryIO, check_header: bool = True):
        self._s = stream
        if check_header:
            head = stream.read(2)
            if head != b"\x00B":
                raise KaldiFormatError(
                    f"not a Kaldi binary stream (got {head!r}); "
                    "text-format files are not supported"
                )

    # -- low level ---------------------------------------------------------

    def read_bytes(self, n: int) -> bytes:
        data = self._s.read(n)
        if len(data) != n:
            raise KaldiFormatError(f"unexpected EOF (wanted {n}, got {len(data)})")
        return data

    def peek_byte(self) -> int:
        pos = self._s.tell()
        b = self._s.read(1)
        self._s.seek(pos)
        if not b:
            return -1
        return b[0]

    def peek_token_start(self) -> str:
        """First character of the next token (after the conventional single
        space that terminates the previous token), like Kaldi PeekToken."""
        pos = self._s.tell()
        b = self._s.read(1)
        if b == b" ":
            b = self._s.read(1)
        self._s.seek(pos)
        return b.decode("latin-1") if b else ""

    # -- tokens ------------------------------------------------------------

    def read_token(self) -> str:
        chars = []
        while True:
            b = self._s.read(1)
            if not b:
                if chars:
                    break
                raise KaldiFormatError("EOF while reading token")
            if b in b" \n\t\r":
                if chars:
                    break
                continue  # skip leading whitespace
            chars.append(b)
        return b"".join(chars).decode("utf-8")

    def expect_token(self, token: str) -> None:
        got = self.read_token()
        if got != token:
            raise KaldiFormatError(f"expected token {token!r}, got {got!r}")

    # -- basic types -------------------------------------------------------

    def read_int(self) -> int:
        size = self.read_bytes(1)[0]
        if size == 4:
            return struct.unpack("<i", self.read_bytes(4))[0]
        if size == 8:
            return struct.unpack("<q", self.read_bytes(8))[0]
        if size == 2:
            return struct.unpack("<h", self.read_bytes(2))[0]
        if size == 1:
            return struct.unpack("<b", self.read_bytes(1))[0]
        raise KaldiFormatError(f"bad int size byte {size}")

    def read_float(self) -> float:
        size = self.read_bytes(1)[0]
        if size == 4:
            return struct.unpack("<f", self.read_bytes(4))[0]
        if size == 8:
            return struct.unpack("<d", self.read_bytes(8))[0]
        raise KaldiFormatError(f"bad float size byte {size}")

    def read_bool(self) -> bool:
        b = self.read_bytes(1)
        if b == b"T":
            return True
        if b == b"F":
            return False
        raise KaldiFormatError(f"bad bool byte {b!r}")

    def read_int_vector(self) -> np.ndarray:
        elem_size = self.read_bytes(1)[0]
        count = struct.unpack("<i", self.read_bytes(4))[0]
        if count < 0:
            raise KaldiFormatError(f"bad vector count {count}")
        dtype = {4: "<i4", 8: "<i8", 2: "<i2", 1: "<i1"}.get(elem_size)
        if dtype is None:
            raise KaldiFormatError(f"bad int vector elem size {elem_size}")
        return np.frombuffer(self.read_bytes(elem_size * count), dtype=dtype).astype(
            np.int64
        )

    # -- vectors / matrices --------------------------------------------------

    def read_vector(self) -> np.ndarray:
        token = self.read_token()
        if token == "FV":
            dtype, width = "<f4", 4
        elif token == "DV":
            dtype, width = "<f8", 8
        else:
            raise KaldiFormatError(f"expected FV/DV, got {token!r}")
        dim = self.read_int()
        return np.frombuffer(self.read_bytes(width * dim), dtype=dtype).astype(
            np.float64 if width == 8 else np.float32
        )

    def read_vector_or_matrix(self) -> np.ndarray:
        """Dispatch on the next object token: FV/DV -> vector, FM/DM/CM* ->
        matrix (some tags hold either depending on the component, e.g.
        <ValueAvg> is a vector in NonlinearComponent but a matrix in
        LstmNonlinearityComponent)."""
        pos = self._s.tell()
        token = self.read_token()
        self._s.seek(pos)
        if token in ("FV", "DV"):
            return self.read_vector()
        return self.read_matrix()

    def read_packed_matrix(self) -> np.ndarray:
        """Symmetric/triangular packed matrix ('FP'/'DP',
        matrix/packed-matrix.cc:240-251) expanded to a full symmetric
        [d, d] array."""
        token = self.read_token()
        if token == "FP":
            dtype, width = "<f4", 4
        elif token == "DP":
            dtype, width = "<f8", 8
        else:
            raise KaldiFormatError(f"expected FP/DP, got {token!r}")
        dim = self.read_int()
        n = dim * (dim + 1) // 2
        data = np.frombuffer(self.read_bytes(width * n), dtype=dtype)
        out = np.zeros((dim, dim), dtype=np.float64 if width == 8 else np.float32)
        idx = 0
        for j in range(dim):
            out[j, : j + 1] = data[idx : idx + j + 1]
            idx += j + 1
        out = out + out.T - np.diag(np.diag(out))
        return out

    def read_matrix(self) -> np.ndarray:
        token = self.read_token()
        if token in ("CM", "CM2", "CM3"):
            return self._read_compressed_matrix(token)
        if token == "FM":
            dtype, width = "<f4", 4
        elif token == "DM":
            dtype, width = "<f8", 8
        else:
            raise KaldiFormatError(f"expected FM/DM/CM*, got {token!r}")
        rows = self.read_int()
        cols = self.read_int()
        data = np.frombuffer(self.read_bytes(width * rows * cols), dtype=dtype)
        out = data.reshape(rows, cols)
        return out.astype(np.float64 if width == 8 else np.float32)

    def _read_compressed_matrix(self, token: str) -> np.ndarray:
        """CompressedMatrix (matrix/compressed-matrix.cc Write/CopyToMat):
        'CM' = one byte with per-column percentile headers (piecewise
        linear), 'CM2' = uint16 linear, 'CM3' = uint8 linear. The header
        omits the leading 'format' int when written."""
        min_value = struct.unpack("<f", self.read_bytes(4))[0]
        value_range = struct.unpack("<f", self.read_bytes(4))[0]
        rows = struct.unpack("<i", self.read_bytes(4))[0]
        cols = struct.unpack("<i", self.read_bytes(4))[0]
        if rows == 0 or cols == 0:
            return np.zeros((rows, cols), dtype=np.float32)
        if token == "CM2":
            data = np.frombuffer(self.read_bytes(2 * rows * cols), dtype="<u2")
            return (
                min_value + value_range * data.astype(np.float32) / 65535.0
            ).reshape(rows, cols)
        if token == "CM3":
            data = np.frombuffer(self.read_bytes(rows * cols), dtype=np.uint8)
            return (
                min_value + value_range * data.astype(np.float32) / 255.0
            ).reshape(rows, cols)
        # 'CM': per-column uint16 percentile headers, then uint8 data stored
        # column-major
        headers = np.frombuffer(self.read_bytes(8 * cols), dtype="<u2").reshape(
            cols, 4
        )
        p = min_value + value_range * headers.astype(np.float32) / 65535.0
        p0, p25, p75, p100 = p[:, 0], p[:, 1], p[:, 2], p[:, 3]
        bytes_cm = np.frombuffer(self.read_bytes(rows * cols), dtype=np.uint8)
        v = bytes_cm.reshape(cols, rows).astype(np.float32)  # column-major
        # CharToFloat (compressed-matrix.cc:490-500)
        low = p0[:, None] + (p25 - p0)[:, None] * v / 64.0
        mid = p25[:, None] + (p75 - p25)[:, None] * (v - 64.0) / 128.0
        high = p75[:, None] + (p100 - p75)[:, None] * (v - 192.0) / 63.0
        out = np.where(v <= 64, low, np.where(v <= 192, mid, high))
        return out.T.astype(np.float32)


class KaldiWriter:
    """Sequential writer producing Kaldi binary streams (for synthetic test
    models and artifact export)."""

    def __init__(self, stream: BinaryIO, write_header: bool = True):
        self._s = stream
        if write_header:
            stream.write(b"\x00B")

    def write_token(self, token: str) -> None:
        self._s.write(token.encode("utf-8") + b" ")

    def write_int(self, value: int) -> None:
        self._s.write(b"\x04" + struct.pack("<i", int(value)))

    def write_float(self, value: float) -> None:
        self._s.write(b"\x04" + struct.pack("<f", float(value)))

    def write_double(self, value: float) -> None:
        self._s.write(b"\x08" + struct.pack("<d", float(value)))

    def write_bool(self, value: bool) -> None:
        self._s.write(b"T" if value else b"F")

    def write_int_vector(self, values) -> None:
        arr = np.asarray(values, dtype="<i4")
        self._s.write(b"\x04" + struct.pack("<i", arr.shape[0]))
        self._s.write(arr.tobytes())

    def write_vector(self, vec: np.ndarray) -> None:
        vec = np.asarray(vec)
        if vec.dtype == np.float64:
            self.write_token("DV")
            self._s.write(b"\x04" + struct.pack("<i", vec.shape[0]))
            self._s.write(vec.astype("<f8").tobytes())
        else:
            self.write_token("FV")
            self._s.write(b"\x04" + struct.pack("<i", vec.shape[0]))
            self._s.write(vec.astype("<f4").tobytes())

    def write_matrix(self, mat: np.ndarray) -> None:
        mat = np.asarray(mat)
        if mat.dtype == np.float64:
            self.write_token("DM")
        else:
            self.write_token("FM")
        self.write_int(mat.shape[0])
        self.write_int(mat.shape[1])
        if mat.dtype == np.float64:
            self._s.write(np.ascontiguousarray(mat, dtype="<f8").tobytes())
        else:
            self._s.write(np.ascontiguousarray(mat, dtype="<f4").tobytes())

    def write_compressed_matrix(self, mat: np.ndarray, method: str = "CM") -> None:
        """Write a CompressedMatrix ('CM' percentile/piecewise or 'CM2'
        uint16 linear), mirroring matrix/compressed-matrix.cc CompressColumn
        / FloatToUint16."""
        mat = np.asarray(mat, dtype=np.float32)
        rows, cols = mat.shape
        min_value = float(mat.min()) if mat.size else 0.0
        value_range = float(mat.max() - min_value) if mat.size else 0.0
        if value_range == 0.0:
            value_range = 1.0e-5

        def to_u16(x):
            f = np.clip((x - min_value) / value_range, 0.0, 1.0)
            return (f * 65535 + 0.499).astype(np.uint16)

        self.write_token(method)
        self._s.write(struct.pack("<ffii", min_value, value_range, rows, cols))
        if method == "CM2":
            self._s.write(to_u16(mat).astype("<u2").tobytes())
            return
        if method != "CM":
            raise KaldiFormatError(f"unsupported compression method {method}")
        headers = np.zeros((cols, 4), dtype="<u2")
        data = np.zeros((cols, rows), dtype=np.uint8)
        for j in range(cols):
            col = np.sort(mat[:, j])
            if rows >= 5:
                q = rows // 4
                percs = np.array([col[0], col[q], col[3 * q], col[-1]])
            else:
                percs = np.array([col[0], col[0], col[-1], col[-1]])
            u16 = [int(v) for v in to_u16(percs)]
            # Kaldi separates equal percentiles by at least 1 and leaves
            # headroom at the top so saturated columns stay strictly
            # monotonic (ComputeColHeader): p0<=65532, p25<=65533, p75<=65534.
            u16[0] = min(u16[0], 65532)
            u16[1] = min(max(u16[1], u16[0] + 1), 65533)
            u16[2] = min(max(u16[2], u16[1] + 1), 65534)
            u16[3] = min(max(u16[3], u16[2] + 1), 65535)
            headers[j] = u16
            p = min_value + value_range * np.asarray(u16, dtype=np.float64) / 65535.0
            p0, p25, p75, p100 = p
            x = mat[:, j].astype(np.float64)
            low = np.clip((x - p0) / max(p25 - p0, 1e-20) * 64 + 0.5, 0, 64)
            midv = 64 + np.clip((x - p25) / max(p75 - p25, 1e-20) * 128 + 0.5, 0, 128)
            high = 192 + np.clip((x - p75) / max(p100 - p75, 1e-20) * 63 + 0.5, 0, 63)
            data[j] = np.where(
                x < p25, low, np.where(x < p75, midv, high)
            ).astype(np.uint8)
        self._s.write(headers.tobytes())
        self._s.write(data.tobytes())

    def write_packed_matrix(self, mat: np.ndarray) -> None:
        """Write a symmetric [d, d] array as an FP packed matrix."""
        mat = np.asarray(mat)
        dim = mat.shape[0]
        rows = [mat[j, : j + 1] for j in range(dim)]
        flat = np.concatenate(rows) if rows else np.zeros(0)
        self.write_token("FP")
        self.write_int(dim)
        self._s.write(flat.astype("<f4").tobytes())

    def write_raw(self, data: bytes) -> None:
        self._s.write(data)


def read_kaldi_object(path: str) -> Union[np.ndarray]:
    """Read a standalone Kaldi object file (e.g. final.mat = one matrix)."""
    with open(path, "rb") as f:
        reader = KaldiReader(f)
        start = reader.peek_token_start()
        if start in ("F", "D", "C"):
            pos = f.tell()
            token = reader.read_token()
            f.seek(pos)
            if token in ("FM", "DM", "CM"):
                return reader.read_matrix()
            if token in ("FV", "DV"):
                return reader.read_vector()
        raise KaldiFormatError(f"cannot infer object type in {path}")
