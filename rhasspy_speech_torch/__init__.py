"""rhasspy_speech_torch: the PyTorch + CUDA port of rhasspy_speech_tpu.

Batch WAV transcription (PCM -> MFCC -> i-vector -> TDNN-F -> Viterbi ->
words -> fuzzy match; ``Nnet3WavTranscriber``) and single-stream streaming
transcription (``Nnet3StreamTranscriber``: one MFCC launch a push, one
Viterbi launch a 7-frame chunk with the alpha carried on the device) and
many streams at once (``pipeline.scheduler.StreamScheduler``: one MFCC and
one Viterbi launch a tick over every stream slot, captured as a CUDA graph
with one path-walk launch) run on one CUDA device through four hand-written
Hopper kernels (``csrc/mfcc.cu``, ``csrc/viterbi.cu``, ``csrc/path_walk.cu``
and ``csrc/windowed_relax.cu``, the last reached through
``examples/windowed_cost.py``); every kernel has a plain PyTorch twin that
runs for CPU tensors. Kaldi GMM models (MFCC + deltas -> diagonal-GMM
log-likelihoods, ``models/gmm.py``) take the same three paths, and Coqui
STT CTC models (``models/ctc.py``, ``io/tflite.py``) train and transcribe
through ``pipeline/coqui.py``. The host layers
(grammar, FST, lang, lexicon, graph, io, native, training) are the port's
own copies of the JAX package's host modules, which hold no JAX code; the
port imports nothing of the JAX package.
"""

from .const import LangSuffix, ModelType, WordCasing
from .tools import KaldiTools
from .pipeline import (
    AcousticModel,
    KaldiNnet3StreamTranscriber,
    KaldiNnet3WavTranscriber,
    Nnet3StreamTranscriber,
    Nnet3WavTranscriber,
)
from .parallel import ShardedWavTranscriber
from .pipeline.train import train_model, train_model_sync

__version__ = "0.2.0"

__all__ = [
    "AcousticModel",
    "KaldiNnet3StreamTranscriber",
    "KaldiNnet3WavTranscriber",
    "KaldiTools",
    "LangSuffix",
    "ModelType",
    "Nnet3StreamTranscriber",
    "Nnet3WavTranscriber",
    "ShardedWavTranscriber",
    "WordCasing",
    "train_model",
    "train_model_sync",
    "__version__",
]
