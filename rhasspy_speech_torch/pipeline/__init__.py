"""Transcription pipelines of the port."""

from .artifacts import LangArtifacts, lang_dir_name
from .fuzzy import get_fuzzy_text, rescore_nbest
from .stream import KaldiNnet3StreamTranscriber, Nnet3StreamTranscriber
from .train import train_model
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
    "LangArtifacts",
    "Nnet3StreamTranscriber",
    "Nnet3WavTranscriber",
    "get_fuzzy_text",
    "lang_dir_name",
    "read_wav",
    "rescore_nbest",
    "train_model",
]
