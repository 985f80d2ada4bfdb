"""Transcription pipelines of the port."""

from .transcribe import (
    AcousticModel,
    KaldiNnet3WavTranscriber,
    Nnet3WavTranscriber,
    read_wav,
)

__all__ = ["AcousticModel", "KaldiNnet3WavTranscriber", "Nnet3WavTranscriber", "read_wav"]
