"""Seeded ADPCM wire bytes that push the decode's two recurrences into
their clamps, for holding the decode kernel (K6) against its plain twin."""

from __future__ import annotations

import numpy as np

from ..ops.adpcm import block_bytes


def saturating_wire(rows: int, nb: int, block: int, seed: int = 0) -> np.ndarray:
    """uint8 [rows, nb * bpb]: block j of row r takes payload kind (r + j) %
    5 -- nibbles all 0x7 (the step index up to 88, the sample up to 32767),
    all 0xF (down to -32768), all 0 (the index held at 0), 0x7 and 0xF
    alternating, seeded random nibbles -- under headers whose first samples
    sit at and near both rails and whose indices are 0, 24, 88, 87 and one
    past the table (clipped by the decoder)."""
    bpb = block_bytes(block)
    rng = np.random.RandomState(seed)
    payload = np.stack([
        np.full(bpb - 3, 0x77), np.full(bpb - 3, 0xFF), np.zeros(bpb - 3),
        np.where(np.arange(bpb - 3) % 2, 0x7F, 0xF7), rng.randint(0, 256, bpb - 3),
    ]).astype(np.uint8)
    out = np.zeros((rows, nb, bpb), np.uint8)
    out[:, :, 3:] = payload[(np.arange(rows)[:, None] + np.arange(nb)[None, :]) % 5]
    g = np.arange(rows * nb).reshape(rows, nb)
    first = np.array([32767, -32768, 0, -1, 32000, -31000, 5])[g % 7] & 0xFFFF
    out[:, :, 0], out[:, :, 1] = first & 0xFF, first >> 8
    out[:, :, 2] = np.array([0, 24, 88, 200, 87])[g % 5]
    return out.reshape(rows, nb * bpb)
