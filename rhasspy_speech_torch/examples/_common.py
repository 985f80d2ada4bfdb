"""What the example scripts share: the ``--device`` flag, the card's name and
power limit, WAV writing and training a synthetic profile's graph. Their
timers are ``utils/timing.py``'s."""

from __future__ import annotations

import argparse
import subprocess
import wave
from pathlib import Path
from typing import Dict, List, Sequence, Union

import numpy as np
import torch

from ..const import LangSuffix
from ..pipeline.artifacts import lang_dir_name
from ..pipeline.train import train_model_sync


def parser(doc: str) -> argparse.ArgumentParser:
    """An argument parser with ``--device`` (default ``cuda``)."""
    p = argparse.ArgumentParser(description=doc.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    return p


def card_line(dev: torch.device) -> str:
    """``name, power limit`` of the card as nvidia-smi prints them, or
    ``cpu``."""
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", f"--id={dev.index or 0}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def write_wav(path: Union[str, Path], pcm: np.ndarray) -> Path:
    """16 kHz mono int16 WAV of ``pcm``."""
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.astype(np.int16).tobytes())
    return Path(path)


def train_sentences(model_dir: Union[str, Path], train_dir: Union[str, Path],
                    sentences: Sequence[str],
                    suffixes: Sequence[LangSuffix] = (LangSuffix.GRAMMAR,)) -> List[Path]:
    """Train ``sentences`` (one intent) against ``model_dir``; the lang dir
    of each suffix."""
    intents = {"language": "en", "intents": {"Main": {"data": [{"sentences": list(sentences)}]}}}
    train_model_sync("en", intents, train_dir, model_dir, lang_suffixes=list(suffixes))
    return [Path(train_dir) / lang_dir_name(s) for s in suffixes]


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_info(dev: torch.device) -> Dict[str, object]:
    """Where the numbers of a run were taken."""
    return {"device": str(dev), "card": card_line(dev)}
