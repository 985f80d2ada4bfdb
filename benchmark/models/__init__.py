"""The model directory's writer of each model family
(``benchmark/models/<family>.py``), found by the configuration's
``model.family``: ``write(model_dir, args, seed)`` writes a model directory
the port loads (``model/final.mdl``, the i-vector extractor, the frontend's
and the lexicon's settings, ``model/phones.txt``) with weights drawn from
``seed``, as ``reference/nets/<family>.py:weights`` draws them."""

from __future__ import annotations

import importlib
from types import ModuleType


def load(family: str) -> ModuleType:
    return importlib.import_module(f"{__name__}.{family}")
