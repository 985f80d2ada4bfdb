"""G.711 mu-law PCM codec for the serving wire (``wire="mulaw"``).

Counterpart of ``rhasspy_speech_tpu/ops/mulaw.py``. The stream scheduler's
fused device route uploads the fleet's PCM batch every tick; the mu-law
wire halves those bytes: the host encodes each sample to its ITU-T G.711
8-bit codeword on the drain (the native pool's ``read_into`` into a uint8
batch, or ``encode_f32`` here), and the captured tick decodes it back with
one 256-entry ``index_select`` (``decode_u8_torch``) before the MFCC
kernel. No kernel of its own: the gather is one PyTorch launch.

Contract: the WIRE is lossy (mu-law is the standard telephony operating
point, ~38 dB SNR); everything after it is exact. Decoded values are
stable: ``decode(encode(decode(b))) == decode(b)`` for every byte (the one
codeword that re-encodes differently is negative zero, 0x7F -> 0xFF, both
decoding to 0.0), so the frame-overlap tails the scheduler carries across
ticks re-encode to the same sample values and features never drift.

Encode/decode follow the G.711 segment layout (bias 0x84, clip 32635,
8 segments x 16 steps, complemented codewords). The NumPy codec is the JAX
package's, unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import cached_index

_BIAS = 0x84
_CLIP = 32635

_DECODE_TABLE: np.ndarray | None = None
_ENCODE_LUT: np.ndarray | None = None


def decode_table() -> np.ndarray:
    """[256] float32: mu-law codeword -> int16-scale sample value."""
    global _DECODE_TABLE
    if _DECODE_TABLE is None:
        b = np.arange(256, dtype=np.int32) ^ 0xFF  # complement
        sign = (b & 0x80) != 0
        exp = (b >> 4) & 0x07
        mant = b & 0x0F
        mag = (((mant << 3) + _BIAS) << exp) - _BIAS
        _DECODE_TABLE = np.where(sign, -mag, mag).astype(np.float32)
    return _DECODE_TABLE


def _encode_lut() -> np.ndarray:
    """[65536] uint8 LUT indexed by the int16 bit pattern (as uint16)."""
    global _ENCODE_LUT
    if _ENCODE_LUT is None:
        x = np.arange(65536, dtype=np.uint16).view(np.int16).astype(np.int32)
        sign = np.where(x < 0, 0x80, 0).astype(np.int32)
        mag = np.minimum(np.abs(x), _CLIP) + _BIAS
        # segment = position of the highest set bit above bit 7
        exp = (np.floor(np.log2(mag)).astype(np.int32) - 7).clip(0, 7)
        mant = (mag >> (exp + 3)) & 0x0F
        _ENCODE_LUT = (~(sign | (exp << 4) | mant) & 0xFF).astype(np.uint8)
    return _ENCODE_LUT


def encode_i16(x: np.ndarray) -> np.ndarray:
    """int16 samples -> uint8 mu-law codewords (any shape)."""
    return _encode_lut()[np.ascontiguousarray(x, dtype=np.int16).view(np.uint16)]


def encode_f32(x: np.ndarray) -> np.ndarray:
    """float32 int16-scale samples -> uint8 codewords (round-half-away,
    matching the native runtime's lrintf-free cast semantics: values are
    clipped to the int16 range first)."""
    xi = np.clip(np.rint(x), -32768, 32767).astype(np.int16)
    return encode_i16(xi)


def decode_u8(b: np.ndarray) -> np.ndarray:
    """uint8 codewords -> float32 int16-scale samples (NumPy)."""
    return decode_table()[b]


def decode_u8_torch(b: torch.Tensor) -> torch.Tensor:
    """uint8 codewords (any shape, any device) -> float32 samples: one
    256-entry ``index_select`` from the table, uploaded once per device (a
    captured tick reads it by address)."""
    table = cached_index(decode_table(), b.device)
    return table.index_select(0, b.reshape(-1).to(torch.int64)).reshape(b.shape)
