"""Multi-device scaling: stream-parallel decode over a mesh of devices."""

from .sharding import (
    StreamMesh,
    make_stream_mesh,
    shard_streams,
    sharded_decode_fn,
)
from .transcriber import ShardedWavTranscriber

__all__ = [
    "ShardedWavTranscriber",
    "StreamMesh",
    "make_stream_mesh",
    "shard_streams",
    "sharded_decode_fn",
]
