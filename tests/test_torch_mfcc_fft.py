"""The MFCC kernel's FFT and mel tables, on the CPU.

``csrc/mfcc.cu`` computes each frame's power spectrum as an N/2-point
complex FFT of the packed pairs x[2n] + i x[2n+1] (for a power of two a
bit-reversed load and radix-2 DIT stages, otherwise mixed-radix Stockham
stages; twiddles from ``fft_twiddles``), then splits it into the real
FFT's N/2 + 1 bins, and sums each mel filter over its nonzero band only
(``mel_bands`` of ``FrontendParams.mel_weights``). The kernel runs only on
the card; this emulates its index arithmetic in float32 and holds it to
``torch.fft.rfft`` and to the dense mel matrix.
"""

import dataclasses

import numpy as np
import pytest
import torch

from rhasspy_speech_torch.ops.frontend import FrontendConfig, make_frontend_params
from rhasspy_speech_torch.ops.mfcc_cuda import _tables, fft_twiddles, mel_bands


def radix2_fft(x, twc, tws):
    """The power-of-two path: bit-reversed load, radix-2 DIT in place."""
    f32 = np.float32
    H = x.shape[1] // 2
    log2_half = H.bit_length() - 1
    rev = [int(format(i, f"0{log2_half}b")[::-1], 2) if log2_half else 0 for i in range(H)]
    re = np.zeros((x.shape[0], H), f32)
    im = np.zeros((x.shape[0], H), f32)
    re[:, rev] = x[:, 0::2]
    im[:, rev] = x[:, 1::2]
    lm2, m = 0, 1
    while m < H:
        q = np.arange(H // 2)
        p = q & (m - 1)
        i0 = ((q >> lm2) << (lm2 + 1)) + p
        i1 = i0 + m
        k = p * (H >> lm2)
        c, s = twc[k], tws[k]
        br, bi = re[:, i1], im[:, i1]
        tr = c * br + s * bi
        ti = c * bi - s * br
        ar, ai = re[:, i0].copy(), im[:, i0].copy()
        re[:, i0], im[:, i0] = ar + tr, ai + ti
        re[:, i1], im[:, i1] = ar - tr, ai - ti
        lm2, m = lm2 + 1, m << 1
    return re, im


def stockham_fft(x, twc, tws):
    """The other path: natural-order load, one Stockham stage per prime
    factor R of H, each output a direct R-point sum."""
    H = x.shape[1] // 2
    re, im = x[:, 0::2].copy(), x[:, 1::2].copy()
    ns, rest = 1, H
    while rest > 1:
        R = next(r for r in range(2, rest + 1) if rest % r == 0)
        hr = H // R
        tstep = hr // ns
        q = np.arange(H)
        u, j = q // hr, q % hr
        k = j % ns
        step = k * tstep + u * hr
        assert (step < H).all()
        ar = np.zeros_like(re)
        ai = np.zeros_like(im)
        e = np.zeros(H, np.int64)
        for t in range(R):
            xr, xi = re[:, j + t * hr], im[:, j + t * hr]
            c, s = twc[2 * e], tws[2 * e]
            ar += xr * c + xi * s
            ai += xi * c - xr * s
            e = (e + step) % H
        o = (j - k) * R + k + u * ns
        assert sorted(o) == list(range(H))
        re, im = np.empty_like(re), np.empty_like(im)
        re[:, o], im[:, o] = ar, ai
        ns, rest = ns * R, rest // R
    return re, im


def kernel_power_spectrum(x, n):
    """[F, n] float32 frames -> [F, n/2 + 1] power, in the kernel's order."""
    f32 = np.float32
    H = n // 2
    twc, tws = fft_twiddles(n)
    re, im = (radix2_fft if H & (H - 1) == 0 else stockham_fft)(x, twc, tws)
    k = np.arange(1, H)
    ar, ai, br, bi = re[:, k], im[:, k], re[:, H - k], im[:, H - k]
    er, ei = f32(0.5) * (ar + br), f32(0.5) * (ai - bi)
    o_r, oi = f32(0.5) * (ai + bi), f32(-0.5) * (ar - br)
    xr = er + (o_r * twc[k] + oi * tws[k])
    xi = ei + (oi * twc[k] - o_r * tws[k])
    power = np.empty((x.shape[0], H + 1), f32)
    power[:, 0] = (re[:, 0] + im[:, 0]) ** 2
    power[:, H] = (re[:, 0] - im[:, 0]) ** 2
    power[:, 1:H] = xr * xr + xi * xi
    return power


@pytest.mark.parametrize("n", [4, 8, 64, 256, 512, 6, 200, 400, 510])
def test_fft_order_and_twiddles_match_rfft(n):
    rng = np.random.RandomState(n)
    frames = np.zeros((6, n), np.float32)
    frames[:, : max(2, n * 25 // 32)] = (rng.randn(6, max(2, n * 25 // 32)) * 3000).astype(np.float32)
    got = kernel_power_spectrum(frames, n)
    spec = torch.fft.rfft(torch.as_tensor(frames, dtype=torch.float64), n=n, dim=-1)
    want = (spec.real ** 2 + spec.imag ** 2).numpy()
    scale = want.max(axis=1, keepdims=True)
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=2e-6)


def test_twiddle_table():
    tw = fft_twiddles(512)
    assert tw.shape == (2, 512) and tw.dtype == np.float32
    ang = 2 * np.pi * np.arange(512) / 512
    np.testing.assert_array_equal(tw[0], np.cos(ang).astype(np.float32))
    np.testing.assert_array_equal(tw[1], np.sin(ang).astype(np.float32))


@pytest.mark.parametrize(
    "cfg", [FrontendConfig(), FrontendConfig(num_mel_bins=23, low_freq=64.0, high_freq=-200.0)]
)
def test_mel_bands_rebuild_the_dense_matrix(cfg):
    dense = make_frontend_params(cfg, "cpu").mel_weights.numpy()
    ptr, first, vals = mel_bands(dense)
    rebuilt = np.zeros_like(dense)
    for m in range(cfg.num_mel_bins):
        rebuilt[first[m]:first[m] + ptr[m + 1] - ptr[m], m] = vals[ptr[m]:ptr[m + 1]]
    np.testing.assert_array_equal(rebuilt, dense)
    # a band sum over the nonzero bins equals the dense product's sum
    power = np.random.RandomState(0).rand(3, dense.shape[0]).astype(np.float32)
    band = np.stack([
        (power[:, first[m]:first[m] + ptr[m + 1] - ptr[m]] * vals[ptr[m]:ptr[m + 1]]).sum(-1)
        for m in range(cfg.num_mel_bins)], axis=-1)
    np.testing.assert_allclose(band, power @ dense, rtol=1e-5)


def test_kernel_tables_come_from_the_params():
    """The kernel's mel bands are cut from the same ``mel_weights`` the
    plain version multiplies by, and are made once per params."""
    params = make_frontend_params(FrontendConfig(), "cpu")
    mel = params.mel_weights.clone()
    mel[:, 3] *= 2.0
    other = dataclasses.replace(params, mel_weights=mel, kernel_cache={})
    tw, ptr, first, vals = _tables(other)
    want = mel_bands(mel.numpy())
    for got, w in zip((ptr, first, vals), want):
        np.testing.assert_array_equal(got.numpy(), w)
    np.testing.assert_array_equal(tw.numpy(), fft_twiddles(512))
    assert _tables(other)[3] is vals
    assert not np.array_equal(_tables(params)[3].numpy(), vals.numpy())
