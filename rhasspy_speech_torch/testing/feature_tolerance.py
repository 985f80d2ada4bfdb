"""How far two f32 MFCC front ends may honestly differ, grounded in float64.

A fixed ``rtol / atol`` cannot hold two correct f32 front ends together on
every frame. The error of an f32 FFT follows the energy of the whole frame,
not of the bin, so where a frame's power lies many decades above one of its
mel bands, that band's log carries a large relative error and the cepstra
built from it an absolute one, on any f32 FFT. ``mfcc_allowance`` gives each
element of ``[..., T, num_ceps]`` its own bound: ``RTOL / ATOL`` (1e-4 /
2e-3), widened only where the rounding of an f32 FFT, as derived below from the
frame itself in float64, exceeds ``atol``.

Derivation. One rounding in round to nearest (unit roundoff ``eps32 / 2``)
errs by a uniform share of the rounded value: relative variance ``eps32^2 /
12``. Let ``y`` be frame ``f`` after DC removal (dither included), ``w`` the
window, ``a`` the pre-emphasis coefficient, ``x = w (y - a y_prev)`` the
frame as it enters the N-point FFT, ``E_f = sum x^2`` its energy (by
Parseval, the mean of its N-point power spectrum), ``E_y = sum (w y)^2``,
``X`` its spectrum and ``p = |X|^2``.

1. The FFT rounds each output of each of its ``S`` radix-2 stages at most
   four times (two products and a sum in the twiddle product, one sum in
   the butterfly). The stages are unitary up to scale, so the roundings'
   variances add: ``||dX||^2 = (4 S / 12) eps32^2 ||X||^2``. Rounding noise
   spreads evenly over the bins and ``||X||^2 = N E_f``, so each bin errs by
   ``E|dX_k|^2 = (4 S / 12) eps32^2 E_f``: the frame's energy sets it, not
   the bin's. (On seeded white frames the f32 FFTs of PyTorch and JAX on the
   CPU err by 0.08-0.10 ``eps32^2 S E_f``, inside the 0.33 counted here.)
2. ``S = log2 N`` for a power of two. Any other N is transformed by
   Bluestein's algorithm, a forward and an inverse radix-2 FFT of
   ``M = 2^ceil(log2(2N - 1))`` points (the MFCC kernel's odd window;
   library FFTs do the same for a large prime factor), so ``S = 2 log2 M``.
3. Before the FFT, five roundings a sample, each white noise that the FFT
   carries into every bin: the DC removal (of ``y``, then through the
   pre-emphasis, white gain ``1 + a^2``), the product ``a y_prev``
   (``a^2``), the pre-emphasis sum, the window product and the window's own
   f32 value (each of ``x``). Pre-emphasis damps a voiced frame's low
   frequencies, so ``E_y`` can be ten times ``E_f`` and more:
   ``E|dX_k|^2 += (eps32^2 / 12) ((1 + 2 a^2) E_y + 3 E_f)``.
4. ``dp_k = 2 Re(conj(X_k) dX_k)`` to first order, of variance
   ``2 p_k E|dX_k|^2``. A mel band ``mel_b = sum_k w_kb p_k`` sums
   independent bin errors: ``sd(mel_b) = sqrt(2 v_f sum_k w_kb^2 p_k)``, with
   ``v_f = E|dX_k|^2`` from steps 1 and 3. (With ``w <= 1`` and ``E_f ~ 2 P_f
   / N``, ``P_f`` the sum of the half spectrum, the log's relative error
   grows as ``sqrt(P_f / mel_b)``, the frame's conditioning.)
5. The log turns that into ``sd(log mel_b) = sd(mel_b) / max(mel_b,
   eps32)`` (the floor the front ends apply). Neighbouring bands share bins,
   so their errors correlate; the cepstrum ``c_k = L_k sum_b D_bk log
   mel_b`` is bounded by the triangle inequality, not in quadrature.

So, for one f32 side::

    scaled[f, k] = KAPPA |L_k| sum_b |D_bk| sqrt(2 v_f sum_j w_jb^2 p_fj) / max(mel_fb, eps32)
    v_f = (eps32^2 / 12) ((4 S + 3) E_f + (1 + 2 a^2) E_y)

``KAPPA = 4`` is a 4-sigma margin on each band's log error (a sum of many
bin errors, so close to Gaussian); nothing in it is fitted. The allowance
of an element is then::

    allow[f, k] = RTOL |want[f, k]| + max(ATOL, sides * scaled[f, k])

``sides`` is 1 against float64 and 2 where both sides are f32 (their
errors are independent, each within its own term). Where the scaled term
is below ``ATOL`` the allowance is exactly ``RTOL |want| + ATOL``: no
well-conditioned element is allowed more than that fixed bound. The energy
column (``use_energy``) keeps the fixed bound. What the scaled term
leaves to ``ATOL``: the f32 mel and DCT products, the log and the lifter,
whose rounding does not grow with the conditioning, and errors coherent
with a strong band (a rounded coefficient), which stay near ``eps32`` of
that band.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.frontend import (
    FrontendConfig,
    frame_indices,
    make_dct_matrix,
    make_lifter_coeffs,
    make_mel_matrix,
    window_function,
)

RTOL = 1e-4
ATOL = 2e-3
EPS_F32 = float(np.finfo(np.float32).eps)
KAPPA = 4.0


def fft_stages(n: int) -> float:
    """Radix-2 stages an f32 FFT of ``n`` points rounds through (step 2)."""
    if n & (n - 1) == 0:
        return float(np.log2(n))
    m = 1
    while m < 2 * n - 1:
        m *= 2
    return 2.0 * np.log2(m)


def _numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def frames_of(cfg: FrontendConfig, pcm, noise=None) -> np.ndarray:
    """[..., S] PCM (and the ``[..., T, frame_length]`` standard normal
    dither noise the front end was given, if any) -> the float64 frames
    ``[..., T, frame_length]`` each front end cuts before DC removal."""
    pcm = _numpy(pcm).astype(np.float64)
    frames = pcm[..., frame_indices(cfg, pcm.shape[-1])]
    if noise is not None:
        frames = frames + cfg.dither * _numpy(noise).astype(np.float64)
    return frames


@dataclass(frozen=True)
class MfccAllowance:
    """Per-element allowance of one comparison. ``floor`` is ``max(ATOL,
    sides * scaled)`` [..., T, num_ceps]; the bound of ``want`` adds
    ``RTOL |want|``. ``conditioning`` [..., T] is each frame's half-spectrum
    power over its weakest mel band; ``reference`` the float64 MFCCs."""

    floor: np.ndarray
    scaled: np.ndarray
    conditioning: np.ndarray
    reference: np.ndarray

    def bound(self, want) -> np.ndarray:
        return RTOL * np.abs(_numpy(want)) + self.floor

    def rows(self, idx) -> "MfccAllowance":
        """The allowance of frames ``idx`` (the last frame axis)."""
        return MfccAllowance(
            self.floor[..., idx, :], self.scaled[..., idx, :],
            self.conditioning[..., idx], self.reference[..., idx, :],
        )


def mfcc_allowance(cfg: FrontendConfig, frames, *, sides: int = 1) -> MfccAllowance:
    """The allowance of f32 MFCCs of ``frames`` [..., T, frame_length]
    (``frames_of``) against float64 (``sides=1``) or against another f32
    front end (``sides=2``)."""
    frames = _numpy(frames).astype(np.float64)
    if cfg.remove_dc_offset:
        frames = frames - frames.mean(axis=-1, keepdims=True)
    if cfg.use_energy and cfg.raw_energy:
        log_e = np.log(np.maximum((frames * frames).sum(-1), EPS_F32))
    window = window_function(cfg)
    energy_y = ((frames * window) ** 2).sum(-1)  # E_y
    a = cfg.preemph_coeff
    if a != 0.0:
        prev = np.concatenate([frames[..., :1], frames[..., :-1]], axis=-1)
        frames = frames - a * prev
    frames = frames * window
    energy = (frames * frames).sum(-1)  # E_f
    if cfg.use_energy and not cfg.raw_energy:
        log_e = np.log(np.maximum(energy, EPS_F32))

    n = cfg.padded_window_size
    spec = np.fft.rfft(frames, n=n, axis=-1)
    power = spec.real**2 + spec.imag**2
    mel_w = make_mel_matrix(cfg)
    mel = power @ mel_w
    mel_floor = np.maximum(mel, EPS_F32)
    dct = make_dct_matrix(cfg.num_ceps, cfg.num_mel_bins)
    lifter = (
        make_lifter_coeffs(cfg.cepstral_lifter, cfg.num_ceps)
        if cfg.cepstral_lifter != 0.0 else np.ones(cfg.num_ceps)
    )
    reference = (np.log(mel_floor) @ dct) * lifter

    v = EPS_F32**2 / 12.0 * ((4.0 * fft_stages(n) + 3.0) * energy + (1.0 + 2.0 * a * a) * energy_y)
    sd_log = np.sqrt(2.0 * v[..., None] * (power @ (mel_w * mel_w))) / mel_floor
    scaled = KAPPA * (sd_log @ np.abs(dct)) * np.abs(lifter)
    if cfg.use_energy:
        if cfg.energy_floor > 0.0:
            log_e = np.maximum(log_e, np.log(cfg.energy_floor))
        reference[..., 0] = log_e
        scaled[..., 0] = 0.0
    conditioning = power.sum(-1) / np.maximum(mel.min(-1), np.finfo(np.float64).tiny)
    return MfccAllowance(np.maximum(ATOL, sides * scaled), scaled, conditioning, reference)


def worst(got, want, allow: MfccAllowance) -> Tuple[float, Tuple[int, ...]]:
    """The largest ``|got - want| / bound`` and its index."""
    got, want = _numpy(got).astype(np.float64), _numpy(want).astype(np.float64)
    if got.shape != want.shape or got.shape != allow.floor.shape:
        raise ValueError(f"shapes differ: {got.shape}, {want.shape}, {allow.floor.shape}")
    if got.size == 0:
        return 0.0, ()
    ratio = np.abs(got - want) / allow.bound(want)
    ratio = np.where(np.isnan(ratio), np.inf, ratio)
    idx = np.unravel_index(int(np.argmax(ratio)), ratio.shape)
    return float(ratio[idx]), tuple(int(i) for i in idx)


def assert_mfcc_close(got, want, allow: MfccAllowance, msg: Optional[str] = None) -> None:
    """Every element of ``got`` within ``allow`` of ``want``; else name the
    worst element, its frame's conditioning and its ratio to the bound."""
    ratio, idx = worst(got, want, allow)
    if ratio <= 1.0:
        return
    g = float(_numpy(got)[idx])
    w = float(_numpy(want)[idx])
    raise AssertionError(
        f"{msg + ': ' if msg else ''}MFCC {idx} got {g!r} want {w!r}: |d| {abs(g - w):.4e} "
        f"against {float(allow.bound(want)[idx]):.4e} allowed (ratio {ratio:.3f}; scaled term "
        f"{float(allow.scaled[idx]):.4e}, frame conditioning "
        f"{float(allow.conditioning[idx[:-1]]):.3e})"
    )
