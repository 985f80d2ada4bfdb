"""ADPCM wire decode kernel wrapper (``csrc/adpcm_decode.cu``, K6): the
stream scheduler's ``wire="adpcm"`` decode inside the captured tick.

The kernel has no TPU original: it stands in for the ``lax.scan`` of the
JAX package's ``decode_blocks_jnp`` (``rhasspy_speech_tpu/ops/adpcm.py``),
which XLA fuses into the serving tick. Unfused in PyTorch, that recurrence
is about a dozen launches a step for 159 steps; the kernel is one launch,
a warp a block, both recurrences a scan of clamped adds.

``adpcm_decode`` launches the kernel for wire bytes on a CUDA device and
runs the plain twin ``ops.adpcm.decode_blocks_torch`` for bytes on the
CPU; it never falls back from one to the other. ``adpcm_decode.launches``
counts kernel launches. Kernel and twin are bit-equal.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .adpcm import block_bytes, decode_blocks_torch

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load("adpcm_decode")
    if lib.rss_adpcm_decode_launch.argtypes is None:
        lib.rss_adpcm_decode_launch.argtypes = [_P, _I, _I, _I, _I, _P, _I, _I, _P]
        lib.rss_adpcm_decode_launch.restype = _I
    return lib


def adpcm_decode(wire: torch.Tensor, block: int) -> torch.Tensor:
    """uint8 wire bytes [N, W] (rows may be a column slice of a wider
    batch: the row stride is read from the tensor) -> float32 samples [N,
    nb * block], nb = W // block_bytes(block)."""
    dev = wire.device
    if dev.type == "cpu":
        return decode_blocks_torch(wire, block)
    if dev.type != "cuda":
        raise ValueError(f"adpcm_decode: unsupported device {dev}")
    if wire.dtype != torch.uint8 or wire.dim() != 2 or wire.stride(1) != 1:
        raise ValueError("adpcm_decode: wire must be [N, W] uint8 with unit column stride")
    if block < 2:
        raise ValueError(f"adpcm_decode: block {block} < 2")
    N = wire.shape[0]
    nb = wire.shape[1] // block_bytes(block)
    out = torch.empty((N, nb * block), dtype=torch.float32, device=dev)
    if N * nb == 0:
        return out
    lib = _lib()
    err = lib.rss_adpcm_decode_launch(
        wire.data_ptr(), wire.stride(0) if N > 1 else wire.shape[1], N, nb, block,
        out.data_ptr(), nb * block, dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, err, "adpcm decode kernel launch")
    adpcm_decode.launches += 1
    return out


adpcm_decode.launches = 0
