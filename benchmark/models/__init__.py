"""The model directory's writer of each model family
(``benchmark/models/<family>.py``), found by the configuration's
``model.family``: ``write(model_dir, args, seed)`` writes a model directory
the port loads (``model/final.mdl``, the i-vector extractor, the frontend's
and the lexicon's settings, ``model/phones.txt``) with weights drawn from
``seed``, as ``reference/nets/<family>.py:weights`` draws them.

A family is this writer and its reference, ``reference/nets/<family>.py``,
which gives ``weights``, ``window``, ``zero_state``, ``forward``,
``products`` and the family's arguments at CPU size, ``TINY_ARGS`` (see
``reference/nets/__init__.py``). A new family is these two files alone: no
other file of the benchmark names a family, and the tests find each by its
file (``benchmark/tests/test_bench_extend.py``)."""

from __future__ import annotations

import importlib
from types import ModuleType


def load(family: str) -> ModuleType:
    return importlib.import_module(f"{__name__}.{family}")
