"""rhasspy_speech_torch: the PyTorch + CUDA port of rhasspy_speech_tpu.

Batch WAV transcription (PCM -> MFCC -> i-vector -> TDNN-F -> dense 1-best
Viterbi -> words -> fuzzy match) runs on one CUDA device through two
hand-written Hopper kernels (``csrc/mfcc.cu``, ``csrc/viterbi.cu``); every
kernel has a plain PyTorch twin that runs for CPU tensors. The host layers
(grammar, lang, graph, io, training) come from ``rhasspy_speech_tpu``
through ``host.py``, without importing JAX.
"""

from .host import LangSuffix, train_model, train_model_sync
from .pipeline import (
    AcousticModel,
    KaldiNnet3WavTranscriber,
    Nnet3WavTranscriber,
)

__all__ = [
    "AcousticModel",
    "KaldiNnet3WavTranscriber",
    "LangSuffix",
    "Nnet3WavTranscriber",
    "train_model",
    "train_model_sync",
]
