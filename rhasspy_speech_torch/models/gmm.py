"""Diagonal-GMM acoustic model: batched per-pdf log-likelihoods.

Counterpart of ``rhasspy_speech_tpu/models/gmm.py``. Per-frame
log-likelihoods for every pdf's diagonal GMM in two matrix products over a
component-padded parameter block (gmm/diag-gmm.cc LogLikelihoods: gconst
already folds the weight, normalizer and -0.5 mu^2/var terms):

    ll[b,t,p,c] = gconst[p,c] + x . (mu/var)[p,c] - 0.5 x^2 . (1/var)[p,c]
    ll[b,t,p]   = logsumexp_c ll[b,t,p,c]

Both contractions are [rows, D] x [D, P*C] products through cuBLAS (TF32
off, ``device.py``); padded components carry gconst = ``NEG_HUGE``. The
rows go through in blocks whose [rows, P*C] intermediate stays within
``BLOCK_ELEMS`` floats (256 MB): at a Kaldi tri1 model's 2,000 pdfs x 10
components a 32 x 3 s batch would otherwise hold 768 MB several times over.
Every element's arithmetic is the unblocked formula's.

Feature pipeline for GMM models: MFCC + delta-deltas (``ops/deltas.py``),
no i-vector, no frame subsampling.
"""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from ..ops.deltas import add_deltas

NEG_HUGE = -1.0e30
BLOCK_ELEMS = 1 << 26


class GmmAm:
    """Component-padded parameters for all pdfs, on one device:
    ``gconsts`` [P*C], ``means_invvars`` and ``inv_vars`` [P*C, D]."""

    def __init__(self, gconsts: np.ndarray, means_invvars: np.ndarray, inv_vars: np.ndarray,
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        P, C, D = means_invvars.shape
        self.num_pdfs, self.num_comps, self.dim = P, C, D

        def f32(a: np.ndarray) -> torch.Tensor:
            return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

        self.gconsts = f32(gconsts).reshape(P * C)
        self.means_invvars = f32(means_invvars).reshape(P * C, D)
        self.inv_vars = f32(inv_vars).reshape(P * C, D)

    @staticmethod
    def from_numpy(gconsts: np.ndarray, means_invvars: np.ndarray, inv_vars: np.ndarray,
                   device: Union[str, torch.device] = "cuda") -> "GmmAm":
        """From the padded arrays ``[P, C]``, ``[P, C, D]``, ``[P, C, D]``
        (the JAX package's ``GmmAm`` fields)."""
        return GmmAm(gconsts, means_invvars, inv_vars, device)

    @staticmethod
    def from_diag_gmms(gmms: List["object"], device: Union[str, torch.device] = "cuda") -> "GmmAm":
        """Pad a list of io.ivector.DiagGmm (one per pdf) to [P, Cmax]."""
        P = len(gmms)
        C = max(g.num_gauss for g in gmms)
        D = gmms[0].dim
        gconsts = np.full((P, C), NEG_HUGE, dtype=np.float32)
        miv = np.zeros((P, C, D), dtype=np.float32)
        iv = np.zeros((P, C, D), dtype=np.float32)
        for p, g in enumerate(gmms):
            n = g.num_gauss
            gconsts[p, :n] = g.gconsts
            miv[p, :n] = g.means_invvars
            iv[p, :n] = g.inv_vars
        return GmmAm(gconsts, miv, iv, device)

    def _block(self, x: torch.Tensor) -> torch.Tensor:
        """[rows, D] -> [rows, P]."""
        ll = (self.gconsts[None, :] + x @ self.means_invvars.T
              - (0.5 * (x * x)) @ self.inv_vars.T)  # [rows, P*C]
        ll = ll.view(x.shape[0], self.num_pdfs, self.num_comps)
        m = ll.max(dim=-1).values
        finite = torch.isfinite(m)
        safe = torch.where(finite, m, 0.0)
        out = safe + torch.log(torch.exp(ll - safe[..., None]).sum(dim=-1))
        return torch.where(finite, out, NEG_HUGE)

    def log_likes(self, feats: torch.Tensor) -> torch.Tensor:
        """[B, T, D] -> [B, T, P] log p(x | pdf)."""
        B, T, D = feats.shape
        x = feats.reshape(B * T, D)
        step = max(1, BLOCK_ELEMS // (self.num_pdfs * self.num_comps))
        parts = [self._block(x[i : i + step]) for i in range(0, B * T, step)]
        out = parts[0] if len(parts) == 1 else torch.cat(parts)
        return out.view(B, T, self.num_pdfs)


class GmmChunkModel:
    """The streaming chunk-model contract (``ranges``, ``left_context`` /
    ``right_context``, ``recurrent``, ``cast``, and a call on ``(windows,
    ivector)``) over deltas + delta-deltas + :meth:`GmmAm.log_likes`, as the
    stream transcriber and the scheduler's ticks call a compiled nnet3 plan.

    The window carries +-4 context frames (delta window 2 per order x order
    2), so the sliced center chunk's deltas are exact mid-utterance, and
    the callers' edge-clamped windows replicate boundary rows exactly like
    ``add_deltas``' own indexing at utterance edges. A GMM reads no
    i-vector."""

    recurrent = False

    def __init__(self, gmm: GmmAm, chunk_out: int, order: int = 2, window: int = 2):
        self.gmm = gmm
        self._ctx = order * window
        self._chunk = chunk_out
        self._order = order
        self._window = window
        self.ranges = {"input": (-self._ctx, chunk_out + self._ctx)}
        self.left_context = self._ctx
        self.right_context = self._ctx

    def cast(self, dtype) -> "GmmChunkModel":
        """Log-likelihoods stay f32."""
        return self

    def __call__(self, windows: torch.Tensor, ivector: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[N, W, D] windows -> [N, chunk, P] log-likelihoods."""
        if ivector is not None:
            raise ValueError("a GMM acoustic model reads no i-vector")
        full = add_deltas(windows, order=self._order, window=self._window)
        return self.gmm.log_likes(full[:, self._ctx : self._ctx + self._chunk])
