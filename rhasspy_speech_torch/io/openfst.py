"""OpenFST binary VectorFst read/write.

Byte layout per the reference implementation:
- openfst/src/lib/fst.cc FstHeader::{Read,Write}: magic 2125659606,
  fsttype/arctype strings, version/flags i32, properties u64,
  start/numstates/numarcs i64,
- openfst/src/lib/symbol-table.cc SymbolTableImpl::{Read,Write}: magic
  2125658996, name, available_key i64, size i64, then (symbol, key) pairs,
- openfst/src/include/fst/vector-fst.h VectorFstImpl::Read: per state a
  float final weight, i64 narcs, then (i32 ilabel, i32 olabel, f32 weight,
  i32 nextstate) arcs.

Needed to load real artifacts the reference ships as OpenFST binaries —
g2p.fst G2P models (script/export_voice2json_profile.py:55-60) and any
user-supplied FSTs — and to export ours back.
"""

from __future__ import annotations

import struct
from typing import BinaryIO

from ..fst.core import INF, Fst, SymbolTable

FST_MAGIC = 2125659606
SYMBOL_MAGIC = 2125658996

FLAG_HAS_ISYMBOLS = 0x1
FLAG_HAS_OSYMBOLS = 0x2

NO_STATE = -1


class OpenFstFormatError(ValueError):
    pass


def _read_exact(f: BinaryIO, n: int) -> bytes:
    data = f.read(n)
    if len(data) != n:
        raise OpenFstFormatError(
            f"unexpected EOF (wanted {n} bytes, got {len(data)})"
        )
    return data


def _read_i32(f: BinaryIO) -> int:
    return struct.unpack("<i", _read_exact(f, 4))[0]


def _read_i64(f: BinaryIO) -> int:
    return struct.unpack("<q", _read_exact(f, 8))[0]


def _read_u64(f: BinaryIO) -> int:
    return struct.unpack("<Q", _read_exact(f, 8))[0]


def _read_f32(f: BinaryIO) -> float:
    return struct.unpack("<f", _read_exact(f, 4))[0]


def _read_string(f: BinaryIO) -> str:
    n = _read_i32(f)
    if n < 0:
        raise OpenFstFormatError(f"bad string length {n}")
    try:
        return _read_exact(f, n).decode("utf-8")
    except UnicodeDecodeError as e:
        raise OpenFstFormatError(f"bad string payload: {e}") from e


def _write_i32(f: BinaryIO, v: int) -> None:
    f.write(struct.pack("<i", v))


def _write_i64(f: BinaryIO, v: int) -> None:
    f.write(struct.pack("<q", v))


def _write_u64(f: BinaryIO, v: int) -> None:
    f.write(struct.pack("<Q", v))


def _write_f32(f: BinaryIO, v: float) -> None:
    f.write(struct.pack("<f", v))


def _write_string(f: BinaryIO, s: str) -> None:
    data = s.encode("utf-8")
    _write_i32(f, len(data))
    f.write(data)


def read_symbol_table(f: BinaryIO) -> SymbolTable:
    magic = _read_i32(f)
    if magic != SYMBOL_MAGIC:
        raise OpenFstFormatError(f"bad symbol table magic {magic}")
    _name = _read_string(f)
    _available_key = _read_i64(f)
    size = _read_i64(f)
    table = SymbolTable(eps=None)
    for _ in range(size):
        sym = _read_string(f)
        key = _read_i64(f)
        table.add(sym, int(key))
    return table


def write_symbol_table(f: BinaryIO, table: SymbolTable, name: str = "") -> None:
    _write_i32(f, SYMBOL_MAGIC)
    _write_string(f, name)
    max_key = max((k for _s, k in table), default=-1)
    _write_i64(f, max_key + 1)  # available_key
    _write_i64(f, len(table))
    for sym, key in sorted(table, key=lambda kv: kv[1]):
        _write_string(f, sym)
        _write_i64(f, key)


INF_OPENFST = float("inf")


def read_openfst(f: BinaryIO) -> Fst:
    """Read a binary VectorFst (tropical or log arcs) into our Fst."""
    magic = _read_i32(f)
    if magic != FST_MAGIC:
        raise OpenFstFormatError(f"bad FST magic {magic}")
    fsttype = _read_string(f)
    arctype = _read_string(f)
    _version = _read_i32(f)
    flags = _read_i32(f)
    _properties = _read_u64(f)
    start = _read_i64(f)
    numstates = _read_i64(f)
    _numarcs = _read_i64(f)

    if fsttype not in ("vector",):
        raise OpenFstFormatError(
            f"unsupported fst type {fsttype!r} (only 'vector')"
        )
    if arctype not in ("standard", "log"):
        raise OpenFstFormatError(f"unsupported arc type {arctype!r}")

    isymbols = osymbols = None
    if flags & FLAG_HAS_ISYMBOLS:
        isymbols = read_symbol_table(f)
    if flags & FLAG_HAS_OSYMBOLS:
        osymbols = read_symbol_table(f)

    fst = Fst(isymbols=isymbols, osymbols=osymbols)
    if numstates != NO_STATE:
        if numstates < 0:
            raise OpenFstFormatError(f"bad state count {numstates}")
        # bound a corrupt count by the remaining bytes when seekable
        # (each state record is at least 12 bytes: final f32 + narcs i64)
        try:
            pos = f.tell()
            f.seek(0, 2)
            remaining = f.tell() - pos
            f.seek(pos)
            if numstates > remaining // 12 + 1:
                raise OpenFstFormatError(
                    f"state count {numstates} exceeds file size"
                )
        except OSError:
            # unseekable stream: no size to bound against — refuse counts
            # large enough that pre-allocating would hang on corrupt input
            if numstates > 2**26:
                raise OpenFstFormatError(
                    f"state count {numstates} too large to validate on an "
                    "unseekable stream"
                )
        fst.add_states(numstates)
    state = 0
    while numstates == NO_STATE or state < numstates:
        data = f.read(4)
        if len(data) < 4:
            if numstates == NO_STATE:
                break
            raise OpenFstFormatError(
                f"unexpected EOF at state {state}/{numstates}"
            )
        final = struct.unpack("<f", data)[0]
        if numstates == NO_STATE:
            while fst.num_states <= state:
                fst.add_state()
        if final != INF_OPENFST:
            fst.finals[state] = final
        narcs = _read_i64(f)
        if narcs < 0 or narcs > 2**40:
            raise OpenFstFormatError(f"bad arc count {narcs}")
        raw = f.read(16 * narcs)
        if len(raw) != 16 * narcs:
            raise OpenFstFormatError(
                f"unexpected EOF in arcs of state {state} "
                f"(wanted {16 * narcs} bytes, got {len(raw)})"
            )
        for i in range(narcs):
            il, ol, w, ns = struct.unpack_from("<iifi", raw, 16 * i)
            fst.add_arc(state, il, ol, w, ns)
        state += 1
    fst.start = start if start != NO_STATE else -1
    return fst


def write_openfst(f: BinaryIO, fst: Fst, arctype: str = "standard",
                  write_symbols: bool = True) -> None:
    flags = 0
    if write_symbols and fst.isymbols is not None:
        flags |= FLAG_HAS_ISYMBOLS
    if write_symbols and fst.osymbols is not None:
        flags |= FLAG_HAS_OSYMBOLS
    _write_i32(f, FST_MAGIC)
    _write_string(f, "vector")
    _write_string(f, arctype)
    _write_i32(f, 2)  # kFileVersion for VectorFst
    _write_i32(f, flags)
    _write_u64(f, 0)  # properties: none asserted
    _write_i64(f, fst.start if fst.start >= 0 else NO_STATE)
    _write_i64(f, fst.num_states)
    _write_i64(f, fst.num_arcs)
    if flags & FLAG_HAS_ISYMBOLS:
        write_symbol_table(f, fst.isymbols)
    if flags & FLAG_HAS_OSYMBOLS:
        write_symbol_table(f, fst.osymbols)
    for state in range(fst.num_states):
        final = fst.finals[state]
        _write_f32(f, final if final != INF else INF_OPENFST)
        _write_i64(f, len(fst.arcs[state]))
        for il, ol, w, ns in fst.arcs[state]:
            f.write(struct.pack("<iifi", il, ol, float(w), ns))


def load_openfst(path: str) -> Fst:
    with open(path, "rb") as f:
        return read_openfst(f)


def save_openfst(path: str, fst: Fst, arctype: str = "standard") -> None:
    with open(path, "wb") as f:
        write_openfst(f, fst, arctype=arctype)
