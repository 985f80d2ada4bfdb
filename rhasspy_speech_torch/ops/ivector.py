"""Batched whole-utterance i-vector extraction in PyTorch.

Counterpart of ``rhasspy_speech_tpu/ops/ivector.py`` (Kaldi
OnlineIvectorFeature, --online=false): splice(+-3) -> LDA -> diag-UBM
log-likes -> top-k gselect posteriors (min_post prune, renorm,
posterior_scale) -> zeroth/first-order stats (max_count rescaling) ->
per-stream Cholesky solve, prior offset subtracted from ivector[0].
``splice_frames`` and ``apply_lda`` are the two halves of ``splice_lda`` as
separate functions (the streaming transcriber splices a chunk's window and
keeps the chunk's rows); ``extract_ivectors_online`` is the periodic mode.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from ..device import cached_index, resolve_device
from ..io.ivector import DiagGmm, IvectorExtractor, OnlineIvectorConfig


@dataclass(frozen=True)
class IvectorParams:
    """Extraction constants on one device (f32)."""

    gconsts: torch.Tensor  # [I]
    means_invvars: torch.Tensor  # [I, D]
    inv_vars: torch.Tensor  # [I, D]
    sigma_inv_m: torch.Tensor  # [I, D, K] == Sigma_i^-1 M_i
    U: torch.Tensor  # [I, K, K] == M_i^T Sigma_i^-1 M_i
    prior_offset: float
    lda: torch.Tensor  # [out_dim, spliced_dim (+1 if offset)]
    splice_left: int
    splice_right: int
    num_gselect: int
    min_post: float
    posterior_scale: float
    max_count: float
    ivector_period: int

    @property
    def ivector_dim(self) -> int:
        return self.U.shape[1]


_TENSOR_FIELDS = ("gconsts", "means_invvars", "inv_vars", "sigma_inv_m", "U", "lda")


def ivector_params_from_numpy(
    values: Mapping[str, Any], device: Union[str, torch.device] = "cuda"
) -> IvectorParams:
    """IvectorParams on ``device`` from a mapping of its field names to
    NumPy arrays and scalars -- e.g. the JAX package's IvectorParams fields
    through ``np.asarray`` -- so both packages compute with identical
    constants."""
    device = resolve_device(device)
    kwargs = {}
    for f in dataclasses.fields(IvectorParams):
        v = values[f.name]
        if f.name in _TENSOR_FIELDS:
            v = torch.as_tensor(np.array(v, dtype=np.float32), device=device)
        kwargs[f.name] = v
    return IvectorParams(**kwargs)


def make_ivector_params(
    dubm: DiagGmm,
    extractor: IvectorExtractor,
    lda_mat: np.ndarray,
    cfg: Optional[OnlineIvectorConfig] = None,
    device: Union[str, torch.device] = "cuda",
) -> IvectorParams:
    cfg = cfg or OnlineIvectorConfig()
    sigma_inv_m = np.einsum("ide,iek->idk", extractor.sigma_inv, extractor.M)
    U = np.einsum("idk,idl->ikl", extractor.M, sigma_inv_m)
    return ivector_params_from_numpy(
        dict(
            gconsts=dubm.gconsts,
            means_invvars=dubm.means_invvars,
            inv_vars=dubm.inv_vars,
            sigma_inv_m=sigma_inv_m,
            U=U,
            prior_offset=float(extractor.prior_offset),
            lda=lda_mat,
            splice_left=cfg.splice_left,
            splice_right=cfg.splice_right,
            num_gselect=cfg.num_gselect,
            min_post=cfg.min_post,
            posterior_scale=cfg.posterior_scale,
            max_count=cfg.max_count,
            ivector_period=cfg.ivector_period,
        ),
        device,
    )


def splice_frames(feats: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """[B, T, D] -> [B, T, D * (left + 1 + right)] with edge clamping
    (OnlineSpliceFrames)."""
    T = feats.shape[1]
    parts = []
    for off in range(-left, right + 1):
        idx = cached_index(np.clip(np.arange(T) + off, 0, T - 1), feats.device)
        parts.append(feats[:, idx])
    return torch.cat(parts, dim=-1)


def apply_lda(spliced: torch.Tensor, params: IvectorParams) -> torch.Tensor:
    """LDA/affine transform; final.mat may have a trailing offset column."""
    lda = params.lda
    in_dim = spliced.shape[-1]
    if lda.shape[1] == in_dim + 1:
        return spliced @ lda[:, :in_dim].T + lda[:, in_dim]
    return spliced @ lda.T


def splice_lda(feats: torch.Tensor, params: IvectorParams) -> torch.Tensor:
    """splice(+-ctx) -> LDA as one matmul per splice offset, summed (the
    [B, T, D*(l+1+r)] splice never materializes); edge frames clamp."""
    left, right = params.splice_left, params.splice_right
    T, D = feats.shape[1], feats.shape[-1]
    lda = params.lda
    n_blocks = left + 1 + right
    out = None
    for i, off in enumerate(range(-left, right + 1)):
        idx = cached_index(np.clip(np.arange(T) + off, 0, T - 1), feats.device)
        y = feats[:, idx] @ lda[:, i * D : (i + 1) * D].T
        out = y if out is None else out + y
    if lda.shape[1] == n_blocks * D + 1:
        out = out + lda[:, n_blocks * D]
    return out


def gmm_log_likes(lda_feats: torch.Tensor, params: IvectorParams) -> torch.Tensor:
    """[B, T, D] -> [B, T, I] (DiagGmm::LogLikelihoods)."""
    x = lda_feats
    lin = x @ params.means_invvars.T
    quad = (x * x) @ params.inv_vars.T
    return params.gconsts[None, None, :] + lin - 0.5 * quad


def gselect_posteriors(log_likes: torch.Tensor, params: IvectorParams) -> torch.Tensor:
    """Dense pruned posteriors [B, T, I], zero outside the top k.

    Top-k is k rounds of argmax + mask, which takes the first index on
    ties as the JAX package does (torch.topk gives no tie order)."""
    I = log_likes.shape[-1]
    k = min(params.num_gselect, I)
    masked = log_likes
    vals, idxs = [], []
    for _ in range(k):
        i = torch.argmax(masked, dim=-1)
        vals.append(masked.gather(-1, i[..., None])[..., 0])
        idxs.append(i)
        masked = masked.scatter(-1, i[..., None], float("-inf"))
    top_ll = torch.stack(vals, dim=-1)  # [B, T, k]
    top_idx = torch.stack(idxs, dim=-1)
    p = torch.exp(top_ll - top_ll[..., :1])
    tot = p.sum(dim=-1, keepdim=True)
    p = torch.where(p >= params.min_post * tot, p, 0.0)
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    p = p * params.posterior_scale
    return torch.zeros_like(log_likes).scatter_add(-1, top_idx, p)


def accumulate_stats(
    lda_feats: torch.Tensor,
    post: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
    frame_weights: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zeroth/first-order stats: gamma [B, I], X [B, I, D]; ``lengths``
    masks padding frames, ``frame_weights`` [B, T] scales frames."""
    if lengths is not None:
        T = lda_feats.shape[1]
        t = torch.arange(T, device=post.device)
        post = post * (t[None, :] < lengths[:, None]).to(post.dtype)[:, :, None]
    if frame_weights is not None:
        post = post * frame_weights[:, :, None]
    gamma = post.sum(dim=1)
    X = torch.einsum("bti,btd->bid", post, lda_feats)
    return gamma, X


def window_stats(
    wins: torch.Tensor, weights: torch.Tensor, params: IvectorParams, chunk_in: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk's statistics from its tap windows [B, left + chunk_in +
    right, D] (the splice clamps at the window's edges), frame ``t``
    weighted by ``weights[:, t]`` [B, chunk_in]: (gamma [B, I], X [B, I,
    Dl]) to add to a stream's running statistics."""
    sl = params.splice_left
    spliced = splice_frames(wins, sl, params.splice_right)[:, sl : sl + chunk_in]
    lda_feats = apply_lda(spliced, params)
    post = gselect_posteriors(gmm_log_likes(lda_feats, params), params)
    return accumulate_stats(lda_feats, post, frame_weights=weights)


def solve_ivector(gamma: torch.Tensor, X: torch.Tensor, params: IvectorParams) -> torch.Tensor:
    """[B, I], [B, I, D] -> [B, K] i-vectors (prior offset subtracted):
    (I + sum_i gamma_i U_i) is symmetric positive definite, so a Cholesky
    solve."""
    if params.max_count > 0:
        tot = gamma.sum(dim=-1, keepdim=True)
        scale = torch.clamp(params.max_count / tot.clamp_min(1e-10), max=1.0)
        gamma = gamma * scale
        X = X * scale[..., None]
    K = params.ivector_dim
    linear = torch.einsum("bid,idk->bk", X, params.sigma_inv_m)
    linear[:, 0] += params.prior_offset
    quad = torch.einsum("bi,ikl->bkl", gamma, params.U)
    quad = quad + torch.eye(K, dtype=quad.dtype, device=quad.device)[None]
    # cholesky_ex and two triangular solves check nothing on the host, so a
    # CUDA graph can capture the solve (the stream scheduler's tick does)
    chol = torch.linalg.cholesky_ex(quad)[0]
    y = torch.linalg.solve_triangular(chol, linear[..., None], upper=False)
    ivec = torch.linalg.solve_triangular(chol.mT, y, upper=True)[..., 0]
    ivec[:, 0] -= params.prior_offset
    return ivec


def extract_ivectors(
    feats: torch.Tensor,
    params: IvectorParams,
    lengths: Optional[torch.Tensor] = None,
    frame_weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Whole-utterance mode: [B, T, D] base features -> [B, K] i-vectors."""
    lda_feats = splice_lda(feats, params)
    ll = gmm_log_likes(lda_feats, params)
    post = gselect_posteriors(ll, params)
    gamma, X = accumulate_stats(lda_feats, post, lengths, frame_weights)
    return solve_ivector(gamma, X, params)


def extract_ivectors_online(feats: torch.Tensor, params: IvectorParams) -> torch.Tensor:
    """Periodic mode: an estimate every ``ivector_period`` frames from the
    stats of all frames seen so far. [B, T, D] -> [B, ceil(T / period), K]."""
    spliced = splice_frames(feats, params.splice_left, params.splice_right)
    lda_feats = apply_lda(spliced, params)
    ll = gmm_log_likes(lda_feats, params)
    post = gselect_posteriors(ll, params)

    gamma_t = torch.cumsum(post, dim=1)  # [B, T, I]
    X_t = torch.cumsum(post[..., None] * lda_feats[:, :, None, :], dim=1)
    T = feats.shape[1]
    period = params.ivector_period
    marks = torch.as_tensor(
        np.minimum(np.arange(0, T, period) + period - 1, T - 1), device=feats.device
    )
    gammas = gamma_t[:, marks]  # [B, P, I]
    Xs = X_t[:, marks]  # [B, P, I, D]
    B, P = gammas.shape[0], gammas.shape[1]
    flat = solve_ivector(
        gammas.reshape(B * P, -1), Xs.reshape(B * P, Xs.shape[2], Xs.shape[3]), params
    )
    return flat.reshape(B, P, -1)
