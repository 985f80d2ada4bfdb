"""Multi-device batch transcription: the stream-sharded serving facade.

Counterpart of ``rhasspy_speech_tpu/parallel/transcriber.py``.
``ShardedWavTranscriber`` is ``Nnet3WavTranscriber`` with its batch decode
split over a stream mesh: the batch is padded to a multiple of the mesh
size with empty 1,600-sample streams (their results are dropped), cut into
contiguous shards, and each shard runs the whole batch path (MFCC,
i-vector, AM, decode, word assembly) on a replica placed on its device,
from one host thread per device with that device current. Results come back in
input order, equal to the single-device transcriber's.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..device import on_device
from ..pipeline.transcribe import Nnet3WavTranscriber
from .sharding import StreamMesh, make_stream_mesh

_FILLER_SAMPLES = 1600


class ShardedWavTranscriber(Nnet3WavTranscriber):
    """Nnet3WavTranscriber whose batch decodes shard over a device mesh
    (default: every CUDA device). The transcriber itself is the replica on
    the mesh's first device; the other methods (lattices, confidence,
    rescoring) run there."""

    def __init__(self, *args, mesh: Optional[StreamMesh] = None, **kwargs):
        if "device" in kwargs:
            raise TypeError("ShardedWavTranscriber places its replicas on the mesh's devices")
        self.mesh = mesh if mesh is not None else make_stream_mesh()
        self.replicas: Optional[List[Nnet3WavTranscriber]] = None  # set below
        with on_device(self.mesh.devices[0]):
            super().__init__(*args, device=self.mesh.devices[0], **kwargs)
        self._shard_count = self.mesh.size
        # one replica per further mesh entry (an entry equal to an earlier
        # one still gets its own replica: a CPU mesh runs shards in threads)
        self.replicas = [self]
        for dev in self.mesh.devices[1:]:
            with on_device(dev):
                self.replicas.append(Nnet3WavTranscriber(*args, device=dev, **kwargs))

    def _decode_batch(
        self, pcm_batch: List[np.ndarray], nbest: int
    ) -> List[List[Tuple[List[int], float]]]:
        if self.replicas is None:  # the constructor's own warm-up, on this replica
            return super()._decode_batch(pcm_batch, nbest)
        n = self._shard_count
        pad = (-len(pcm_batch)) % n
        if pad:
            pcm_batch = list(pcm_batch) + [np.zeros(_FILLER_SAMPLES, dtype=np.float32)] * pad
        bounds = self.mesh.bounds(len(pcm_batch))
        shards = [(rep, pcm_batch[lo:hi]) for rep, (lo, hi) in zip(self.replicas, bounds)]
        # each replica's own (unsharded) batch decode, this one's included
        parts = self.mesh.map(
            lambda _dev, job: Nnet3WavTranscriber._decode_batch(*job, nbest), shards)
        out = [r for part in parts for r in part]
        return out[: len(out) - pad] if pad else out
