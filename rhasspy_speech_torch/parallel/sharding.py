"""Stream-parallel sharding over a mesh of devices.

Counterpart of ``rhasspy_speech_tpu/parallel/sharding.py``. The scale-out
axis is concurrent streams: decode state is independent per stream, so the
batch dimension splits into contiguous shards, one per device, and the
decode graph and the acoustic model are replicated. No collective is
needed: outputs are gathered in order on the host side of the call.

``StreamMesh`` is a 1-D mesh: an ordered tuple of torch devices and an axis
name. The JAX package's mesh partitions one compiled program over its
devices; here each device runs its own shard's calls, from a host thread of
its own with its device current.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import on_device, resolve_device


@dataclass(frozen=True)
class StreamMesh:
    """An ordered tuple of devices along one axis (the same device may
    appear more than once: a mesh of CPU entries stands in for cards in
    tests)."""

    devices: Tuple[torch.device, ...]
    axis_name: str = "streams"

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        return {self.axis_name: self.size}

    def bounds(self, n: int) -> List[Tuple[int, int]]:
        """Contiguous [lo, hi) row blocks of ``n`` rows, one per device;
        ``n`` must be a multiple of the mesh size."""
        if n % self.size:
            raise ValueError(f"{n} rows do not split evenly over a mesh of {self.size}")
        per = n // self.size
        return [(i * per, (i + 1) * per) for i in range(self.size)]

    def map(self, fn: Callable, items: Sequence) -> list:
        """``fn(device, item)`` for device i and item i, one host thread per
        device with that device current; results in mesh order."""
        if len(items) != self.size:
            raise ValueError(f"{len(items)} items for a mesh of {self.size}")

        def run(device, item):
            with on_device(device):
                return fn(device, item)

        if self.size == 1:
            return [run(self.devices[0], items[0])]
        with ThreadPoolExecutor(self.size) as pool:
            return list(pool.map(run, self.devices, items))


def make_stream_mesh(
    n_devices: Optional[int] = None,
    axis_name: str = "streams",
    devices: Optional[Sequence[Union[str, torch.device]]] = None,
) -> StreamMesh:
    """1-D mesh over every CUDA device (or the first ``n_devices``), or
    over ``devices``.

    Unlike the JAX package, which falls back to its (virtual) CPU devices
    when the default platform has too few, this raises when too few cards
    exist: a caller that wants CPU shards passes them explicitly, e.g.
    ``devices=["cpu"] * 4``."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_stream_mesh: no CUDA device; pass devices= (e.g. ['cpu'] * n) "
                "for a mesh of CPU entries"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(f"need {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("a stream mesh needs at least one device")
    return StreamMesh(tuple(devices), axis_name)


def shard_streams(mesh: StreamMesh, *arrays, axis_name: str = "streams"):
    """Split each array's leading (stream) dimension into the mesh's
    contiguous shards: per array, a list of tensors, shard i on device i
    (one list for one array, else a tuple of lists)."""
    if axis_name != mesh.axis_name:
        raise ValueError(f"mesh axis is {mesh.axis_name!r}, not {axis_name!r}")
    out = []
    for arr in arrays:
        t = torch.as_tensor(np.asarray(arr)) if not isinstance(arr, torch.Tensor) else arr
        out.append([t[lo:hi].to(dev) for dev, (lo, hi) in zip(mesh.devices,
                                                            mesh.bounds(t.shape[0]))])
    return out[0] if len(out) == 1 else tuple(out)


def _replicate(x, device: torch.device):
    return x.to(device) if isinstance(x, torch.Tensor) else x


def _gather(parts: list, device: torch.device):
    """Shards' outputs (a tensor, or a tuple / list of tensors, each
    batch-major) concatenated in mesh order on ``device``."""
    first = parts[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([p.to(device) for p in parts], dim=0)
    return type(first)(_gather([p[i] for p in parts], device) for i in range(len(first)))


def sharded_decode_fn(
    mesh: StreamMesh,
    decode_fn: Callable,
    axis_name: str = "streams",
    num_batch_args: int = 1,
) -> Callable:
    """``decode_fn`` with its first ``num_batch_args`` arguments split into
    the mesh's contiguous stream shards and every other tensor operand
    replicated on each device. Each device runs its shard from a host
    thread of its own; the outputs (batch-major) are gathered in order on
    the mesh's first device."""
    if axis_name != mesh.axis_name:
        raise ValueError(f"mesh axis is {mesh.axis_name!r}, not {axis_name!r}")

    def wrapper(*args):
        batch = [shard_streams(mesh, a) for a in args[:num_batch_args]]
        rest = args[num_batch_args:]

        def run(device, i):
            return decode_fn(*(b[i] for b in batch), *(_replicate(a, device) for a in rest))

        return _gather(mesh.map(run, list(range(mesh.size))), mesh.devices[0])

    return wrapper
