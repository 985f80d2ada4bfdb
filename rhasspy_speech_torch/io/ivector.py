"""Parsers for the online i-vector extractor artifacts.

Covers the files prepare_online_decoding.sh wires into online.conf
(steps/online/nnet3/prepare_online_decoding.sh:85-160):
- final.dubm: DiagGmm (kaldi/src/gmm/diag-gmm.cc DiagGmm::Write),
- final.ie: IvectorExtractor (kaldi/src/ivector/ivector-extractor.cc Write),
- final.mat / global_cmvn.stats: plain Kaldi matrices,
- the conf files (key=value / --key=value text).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Union

import numpy as np

from .kaldi_io import KaldiReader, KaldiWriter


@dataclass
class DiagGmm:
    """Diagonal-covariance GMM (stored in Kaldi's natural parameterization:
    means*inv_vars and inv_vars)."""

    gconsts: np.ndarray  # [I]
    weights: np.ndarray  # [I]
    means_invvars: np.ndarray  # [I, D]
    inv_vars: np.ndarray  # [I, D]

    @property
    def num_gauss(self) -> int:
        return self.weights.shape[0]

    @property
    def dim(self) -> int:
        return self.inv_vars.shape[1]

    def means(self) -> np.ndarray:
        return self.means_invvars / self.inv_vars

    @staticmethod
    def read(r: KaldiReader) -> "DiagGmm":
        r.expect_token("<DiagGMM>")
        r.expect_token("<GCONSTS>")
        gconsts = r.read_vector()
        r.expect_token("<WEIGHTS>")
        weights = r.read_vector()
        r.expect_token("<MEANS_INVVARS>")
        means_invvars = r.read_matrix()
        r.expect_token("<INV_VARS>")
        inv_vars = r.read_matrix()
        r.expect_token("</DiagGMM>")
        return DiagGmm(gconsts, weights, means_invvars, inv_vars)

    def write(self, w: KaldiWriter) -> None:
        w.write_token("<DiagGMM>")
        w.write_token("<GCONSTS>")
        w.write_vector(self.gconsts.astype(np.float32))
        w.write_token("<WEIGHTS>")
        w.write_vector(self.weights.astype(np.float32))
        w.write_token("<MEANS_INVVARS>")
        w.write_matrix(self.means_invvars.astype(np.float32))
        w.write_token("<INV_VARS>")
        w.write_matrix(self.inv_vars.astype(np.float32))
        w.write_token("</DiagGMM>")

    @staticmethod
    def from_means_vars(
        weights: np.ndarray, means: np.ndarray, variances: np.ndarray
    ) -> "DiagGmm":
        inv_vars = 1.0 / variances
        means_invvars = means * inv_vars
        # gconst_i = log w_i - 0.5 (D log(2pi) + sum log var + mu^T invvar mu)
        d = means.shape[1]
        gconsts = (
            np.log(weights)
            - 0.5
            * (
                d * np.log(2 * np.pi)
                + np.sum(np.log(variances), axis=1)
                + np.sum(means * means_invvars, axis=1)
            )
        )
        return DiagGmm(
            gconsts.astype(np.float32),
            weights.astype(np.float32),
            means_invvars.astype(np.float32),
            inv_vars.astype(np.float32),
        )

    @staticmethod
    def load(path: str) -> "DiagGmm":
        with open(path, "rb") as f:
            return DiagGmm.read(KaldiReader(f))


@dataclass
class IvectorExtractor:
    """T-matrix i-vector extractor (ivector-extractor.h:108-310)."""

    w: np.ndarray  # [I, ivec_dim] or [0, 0] (weights projection; unused here)
    w_vec: np.ndarray  # [I] Gaussian weights
    M: np.ndarray  # [I, D, ivec_dim]
    sigma_inv: np.ndarray  # [I, D, D] (expanded from packed symmetric)
    prior_offset: float

    @property
    def num_gauss(self) -> int:
        return self.M.shape[0]

    @property
    def feat_dim(self) -> int:
        return self.M.shape[1]

    @property
    def ivector_dim(self) -> int:
        return self.M.shape[2]

    @staticmethod
    def read(r: KaldiReader) -> "IvectorExtractor":
        r.expect_token("<IvectorExtractor>")
        r.expect_token("<w>")
        w = r.read_matrix()
        r.expect_token("<w_vec>")
        w_vec = r.read_vector()
        r.expect_token("<M>")
        count = r.read_int()
        M = np.stack([r.read_matrix() for _ in range(count)])
        r.expect_token("<SigmaInv>")
        sigma_inv = np.stack([r.read_packed_matrix() for _ in range(count)])
        r.expect_token("<IvectorOffset>")
        prior_offset = r.read_float()
        r.expect_token("</IvectorExtractor>")
        return IvectorExtractor(w, w_vec, M, sigma_inv, prior_offset)

    def write(self, w: KaldiWriter) -> None:
        w.write_token("<IvectorExtractor>")
        w.write_token("<w>")
        w.write_matrix(self.w.astype(np.float32))
        w.write_token("<w_vec>")
        w.write_vector(self.w_vec.astype(np.float32))
        w.write_token("<M>")
        w.write_int(self.M.shape[0])
        for i in range(self.M.shape[0]):
            w.write_matrix(self.M[i].astype(np.float32))
        w.write_token("<SigmaInv>")
        for i in range(self.sigma_inv.shape[0]):
            w.write_packed_matrix(self.sigma_inv[i])
        w.write_token("<IvectorOffset>")
        w.write_float(self.prior_offset)
        w.write_token("</IvectorExtractor>")

    @staticmethod
    def load(path: str) -> "IvectorExtractor":
        with open(path, "rb") as f:
            return IvectorExtractor.read(KaldiReader(f))


def parse_conf(path_or_text: Union[str, "object"], is_text: bool = False) -> Dict[str, str]:
    """Parse a Kaldi conf file: lines of --key=value (or key=value).

    Values keep their raw string form; booleans are 'true'/'false'."""
    if is_text:
        text = path_or_text
    else:
        with open(path_or_text, "r", encoding="utf-8") as f:
            text = f.read()
    out: Dict[str, str] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("--"):
            line = line[2:]
        if "=" in line:
            key, value = line.split("=", 1)
            out[key.strip()] = value.strip()
    return out


@dataclass
class OnlineIvectorConfig:
    """Hyperparameters from ivector_extractor.conf
    (prepare_online_decoding.sh:28-41 defaults)."""

    num_gselect: int = 5
    min_post: float = 0.025
    posterior_scale: float = 0.1
    max_count: float = 100.0
    ivector_period: int = 10
    splice_left: int = 3
    splice_right: int = 3

    @staticmethod
    def from_conf(conf: Dict[str, str]) -> "OnlineIvectorConfig":
        cfg = OnlineIvectorConfig()
        if "num-gselect" in conf:
            cfg.num_gselect = int(conf["num-gselect"])
        if "min-post" in conf:
            cfg.min_post = float(conf["min-post"])
        if "posterior-scale" in conf:
            cfg.posterior_scale = float(conf["posterior-scale"])
        if "max-count" in conf:
            cfg.max_count = float(conf["max-count"])
        if "ivector-period" in conf:
            cfg.ivector_period = int(conf["ivector-period"])
        return cfg
