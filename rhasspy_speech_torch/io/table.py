"""Kaldi Table I/O: ark/scp reading and ark writing for matrices/vectors.

Covers the rspecifier/wspecifier data interchange the reference's binaries
use everywhere (kaldi/src/util/kaldi-table*.h; ark format: ``key<space>``
then a binary object with its own "\\0B" header; scp format: ``key path:offset``
lines). Lets users exchange feature/posterior matrices with existing Kaldi
tooling (e.g. validating our MFCCs against compute-mfcc-feats output).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterator, Tuple, Union

import numpy as np

from .kaldi_io import KaldiFormatError, KaldiReader, KaldiWriter


def read_ark(path: Union[str, Path]) -> Iterator[Tuple[str, np.ndarray]]:
    """Iterate (key, matrix-or-vector) from a binary ark file."""
    with open(path, "rb") as f:
        while True:
            # key is a whitespace-terminated token; EOF before a key ends
            key_chars = []
            while True:
                b = f.read(1)
                if not b:
                    if key_chars:
                        raise KaldiFormatError("EOF inside ark key")
                    return
                if b == b" ":
                    break
                if b in b"\n\t\r":
                    continue
                key_chars.append(b)
            key = b"".join(key_chars).decode("utf-8")
            r = KaldiReader(f)  # consumes the \0B header
            start = r.peek_token_start()
            if start in ("F", "D", "C"):
                pos = f.tell()
                token = r.read_token()
                f.seek(pos)
                if token in ("FM", "DM", "CM", "CM2", "CM3"):
                    yield key, r.read_matrix()
                    continue
                if token in ("FV", "DV"):
                    yield key, r.read_vector()
                    continue
            raise KaldiFormatError(f"unsupported ark object for key {key!r}")


def read_ark_dict(path: Union[str, Path]) -> Dict[str, np.ndarray]:
    return dict(read_ark(path))


def write_ark(path: Union[str, Path], items) -> None:
    """Write (key, array) pairs as a binary ark (matrices for 2-D arrays,
    vectors for 1-D)."""
    with open(path, "wb") as f:
        for key, arr in items:
            f.write(key.encode("utf-8") + b" ")
            w = KaldiWriter(f)
            arr = np.asarray(arr)
            if arr.ndim == 2:
                w.write_matrix(arr)
            elif arr.ndim == 1:
                w.write_vector(arr)
            else:
                raise KaldiFormatError(f"cannot write {arr.ndim}-D array")


def read_scp(path: Union[str, Path]) -> Iterator[Tuple[str, np.ndarray]]:
    """Iterate (key, object) through an scp file (``key path:offset``)."""
    scp_dir = Path(path).parent
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            key, loc = line.split(None, 1)
            if ":" in loc:
                data_path, offset = loc.rsplit(":", 1)
                offset = int(offset)
            else:
                data_path, offset = loc, 0
            if not Path(data_path).is_absolute():
                data_path = str(scp_dir / data_path)
            with open(data_path, "rb") as df:
                df.seek(offset)
                r = KaldiReader(df)
                pos = df.tell()
                token = r.read_token()
                df.seek(pos)
                if token in ("FM", "DM", "CM", "CM2", "CM3"):
                    yield key, r.read_matrix()
                elif token in ("FV", "DV"):
                    yield key, r.read_vector()
                else:
                    raise KaldiFormatError(
                        f"unsupported scp object {token!r} for {key!r}"
                    )
