"""Kaldi AmDiagGmm final.mdl I/O (GMM acoustic models).

Format (gmm/am-diag-gmm.cc Read/Write): after the TransitionModel —

    <DIMENSION> int32  <NUMPDFS> int32  then NUMPDFS x <DiagGMM> objects

Each DiagGmm is the same object the i-vector UBM uses (io/ivector.DiagGmm,
gmm/diag-gmm.cc): gconsts / weights / means_invvars / inv_vars.
"""

from __future__ import annotations

from typing import List, Tuple

from .ivector import DiagGmm
from .kaldi_io import KaldiReader, KaldiWriter
from .transition_model import KaldiTransitionModel


def read_am_diag_gmm(path: str) -> Tuple[KaldiTransitionModel, List[DiagGmm]]:
    with open(path, "rb") as f:
        r = KaldiReader(f)
        tm = KaldiTransitionModel.read(r)
        r.expect_token("<DIMENSION>")
        dim = r.read_int()
        r.expect_token("<NUMPDFS>")
        num_pdfs = r.read_int()
        gmms = [DiagGmm.read(r) for _ in range(num_pdfs)]
    for g in gmms:
        if g.dim != dim:
            raise ValueError(
                f"DiagGmm dim {g.dim} != model <DIMENSION> {dim}"
            )
    return tm, gmms


def write_am_diag_gmm(
    path: str, tm: KaldiTransitionModel, gmms: List[DiagGmm]
) -> None:
    with open(path, "wb") as f:
        w = KaldiWriter(f)
        tm.write(w)
        w.write_token("<DIMENSION>")
        w.write_int(gmms[0].dim)
        w.write_token("<NUMPDFS>")
        w.write_int(len(gmms))
        for g in gmms:
            g.write(w)


def is_gmm_model(path: str) -> bool:
    """True when final.mdl carries an AmDiagGmm (vs <Nnet3>)."""
    with open(path, "rb") as f:
        r = KaldiReader(f)
        KaldiTransitionModel.read(r)
        try:
            tok = r.read_token()
        except Exception:
            return False
    return tok == "<DIMENSION>"
