"""API-compatibility shim for the reference's KaldiTools.

The reference threads a KaldiTools object (paths to the Kaldi/OpenFST/
OpenGrm/Phonetisaurus installations, reference: rhasspy_speech/tools.py:12-64)
through every trainer and transcriber so they can spawn subprocesses. This
framework runs everything in-process — on the GPU for the numeric path, host
Python/C++ for graph compilation — so the tool paths are meaningless; the
class exists so `from rhasspy_speech import KaldiTools`-style code keeps
importing and constructing, and a loud error fires if someone tries to
actually exec a subprocess through it.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Union


@dataclass
class KaldiTools:
    """Accepted anywhere the reference accepted it; never spawns processes."""

    kaldi_dir: Optional[Path] = None
    openfst_dir: Optional[Path] = None
    opengrm_dir: Optional[Path] = None
    phonetisaurus_bin: Optional[Path] = None

    @staticmethod
    def from_tools_dir(tools_dir: Union[str, Path]) -> "KaldiTools":
        tools_dir = Path(tools_dir).absolute()
        return KaldiTools(
            kaldi_dir=tools_dir / "kaldi",
            openfst_dir=tools_dir / "openfst",
            opengrm_dir=tools_dir / "opengrm",
            phonetisaurus_bin=tools_dir / "phonetisaurus",
        )

    def _no_subprocesses(self, *args, **kwargs):
        raise RuntimeError(
            "rhasspy_speech_torch runs in-process; there are no tool "
            "subprocesses to execute (see COMPONENTS.md)"
        )

    async_run = _no_subprocesses
    async_run_shell = _no_subprocesses
    async_run_pipeline = _no_subprocesses
