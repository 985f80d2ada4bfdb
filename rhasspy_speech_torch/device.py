"""Device resolution: the port runs where it is told, or raises."""

from __future__ import annotations

import contextlib
from typing import Dict, Union

import numpy as np
import torch

# The AM matmuls and the feature math are held to the JAX package's f32
# numerics; TF32 keeps about three decimal digits (ARCHITECTURE.md, "MXU
# precision", records the damage to log-mel features). A bf16 AM
# (compute_dtype="bfloat16") accumulates its products in f32, as the JAX
# package's do, so cuBLAS may not reduce them in bf16. The switches are
# stated here, so importing the port fixes them for the process.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and
    ``torch.cuda.is_available()`` is false (no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() "
                "is false; pass device='cpu' to run the plain versions"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def on_device(device: torch.device):
    """A context in which ``device`` is the current CUDA device (nothing
    for the CPU). Calls that take no device (an event's record, a stream,
    a graph capture) act on the current device, which is cuda:0 unless set:
    work for another card runs inside this."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


_INDEX_CACHE: Dict[tuple, torch.Tensor] = {}


def cached_index(values: np.ndarray, device: torch.device) -> torch.Tensor:
    """``torch.as_tensor(values, device=device)``, made once per distinct
    array and device: a forward pass that indexes with constant arrays
    uploads nothing after its first call, so a CUDA graph can capture it."""
    arr = np.ascontiguousarray(values)
    key = (arr.dtype.str, arr.shape, arr.tobytes(), str(device))
    out = _INDEX_CACHE.get(key)
    if out is None:
        out = _INDEX_CACHE[key] = torch.as_tensor(arr, device=device)
    return out
