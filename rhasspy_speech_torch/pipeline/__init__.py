"""Transcription pipelines of the port."""

from .stream import KaldiNnet3StreamTranscriber, Nnet3StreamTranscriber
from .transcribe import (
    AcousticModel,
    KaldiNnet3WavTranscriber,
    Nnet3WavTranscriber,
    read_wav,
)

__all__ = [
    "AcousticModel",
    "KaldiNnet3StreamTranscriber",
    "KaldiNnet3WavTranscriber",
    "Nnet3StreamTranscriber",
    "Nnet3WavTranscriber",
    "read_wav",
]
