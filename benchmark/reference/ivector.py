"""Kaldi's online i-vector extraction in float64 PyTorch, written from
ivector-extractor.cc and online-ivector-feature.cc.

Per frame: the base MFCCs spliced over +-3 frames (clamped at the edges of
the frames on hand), the LDA with its offset column, the diagonal UBM's
log-likelihoods, the top ``num_gselect`` Gaussians' posteriors pruned below
``min_post`` of their sum, renormalised and scaled by ``posterior_scale``.
The zeroth and first order statistics of the frames used are scaled down to
``max_count`` in all, then the i-vector is the posterior mean
``(I + sum_i gamma_i M_i' S_i M_i)^-1 (sum_i M_i' S_i x_i + prior e_0)``
with the prior offset taken off its first element. The options are
``prepare_online_decoding.sh``'s defaults, which the model directories use
(they carry no ``ivector_extractor.conf``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import torch

NUM_GSELECT = 5
MIN_POST = 0.025
POSTERIOR_SCALE = 0.1
MAX_COUNT = 100.0
SPLICE = 3


@dataclass
class Extractor:
    lda: torch.Tensor  # [D, 7 C + 1]
    gconsts: torch.Tensor  # [I]
    means_invvars: torch.Tensor  # [I, D]
    inv_vars: torch.Tensor  # [I, D]
    sigma_inv_m: torch.Tensor  # [I, D, K]
    U: torch.Tensor  # [I, K, K]
    prior_offset: float


def make_extractor(w: Dict, device, dtype=torch.float64) -> Extractor:
    """The extraction constants from ``weights.extractor``'s draws."""
    def t(a):
        return torch.as_tensor(a, device=device).to(dtype)

    means, var, weights = t(w["means"]), t(w["variances"]), t(w["weights"])
    inv_vars = 1.0 / var
    means_invvars = means * inv_vars
    d = means.shape[1]
    gconsts = torch.log(weights) - 0.5 * (
        d * math.log(2 * math.pi) + torch.log(var).sum(1) + (means * means_invvars).sum(1))
    M = t(w["M"])  # Sigma^-1 is the identity
    return Extractor(lda=t(w["lda"]), gconsts=gconsts, means_invvars=means_invvars,
                     inv_vars=inv_vars, sigma_inv_m=M, U=torch.einsum("idk,idl->ikl", M, M),
                     prior_offset=float(w["prior_offset"]))


def frame_posteriors(ex: Extractor, feats: torch.Tensor, last: torch.Tensor):
    """Per frame of ``feats`` [B, T, C]: (LDA features [B, T, D], pruned
    posteriors [B, T, I]); frame ``t``'s splice reads rows clamped to
    ``[0, last[b]]``."""
    B, T, C = feats.shape
    t = torch.arange(T, device=feats.device)
    parts = []
    for off in range(-SPLICE, SPLICE + 1):
        idx = torch.minimum((t + off).clamp_min(0)[None, :], last[:, None])  # [B, T]
        parts.append(torch.gather(feats, 1, idx[:, :, None].expand(B, T, C)))
    spliced = torch.cat(parts, dim=-1)
    x = spliced @ ex.lda[:, :-1].T + ex.lda[:, -1]
    ll = ex.gconsts + x @ ex.means_invvars.T - 0.5 * (x * x) @ ex.inv_vars.T
    top, top_idx = torch.topk(ll, NUM_GSELECT, dim=-1)
    p = torch.exp(top - top[..., :1])
    p = torch.where(p >= MIN_POST * p.sum(-1, keepdim=True), p, 0.0)
    p = p / p.sum(-1, keepdim=True) * POSTERIOR_SCALE
    post = torch.zeros_like(ll).scatter_add(-1, top_idx, p)
    return x, post


def solve(ex: Extractor, gamma: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Statistics gamma [B, I], X [B, I, D] -> i-vectors [B, K]."""
    tot = gamma.sum(-1, keepdim=True)
    scale = torch.clamp(MAX_COUNT / tot.clamp_min(1e-10), max=1.0)
    gamma, X = gamma * scale, X * scale[..., None]
    K = ex.U.shape[1]
    linear = torch.einsum("bid,idk->bk", X, ex.sigma_inv_m)
    linear[:, 0] += ex.prior_offset
    quad = torch.einsum("bi,ikl->bkl", gamma, ex.U) + torch.eye(K, dtype=gamma.dtype,
                                                                 device=gamma.device)
    ivec = torch.linalg.solve(quad, linear[..., None])[..., 0]
    ivec[:, 0] -= ex.prior_offset
    return ivec


def utterance_ivectors(ex: Extractor, feats: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """The batch transcriber's i-vector: one a stream from the statistics
    of its first ``lengths[b]`` frames, every frame's splice clamped to the
    ``feats`` rows on hand (the padded batch's)."""
    B, T, _ = feats.shape
    last = torch.full((B,), T - 1, device=feats.device)
    x, post = frame_posteriors(ex, feats, last)
    mask = (torch.arange(T, device=feats.device)[None, :] < lengths[:, None]).to(post.dtype)
    post = post * mask[..., None]
    return solve(ex, post.sum(1), torch.einsum("bti,btd->bid", post, x))
