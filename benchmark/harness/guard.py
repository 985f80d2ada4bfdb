"""The check that no run loads JAX or the JAX package.

A module counts by its top-level name, the part before the first dot,
compared whole: ``rhasspy_speech_torch`` begins with the JAX package's
name ``rhasspy_speech_t...`` and is not it, and neither is a module named
``rhasspy_speech_tpu_x``.
"""

from __future__ import annotations

import sys
from typing import Iterable, List, Optional

FORBIDDEN = frozenset(("jax", "jaxlib", "flax", "rhasspy_speech_tpu"))


def forbidden_modules(names: Optional[Iterable[str]] = None) -> List[str]:
    """The forbidden top-level names among ``names`` (default: the modules
    this process has loaded), sorted."""
    names = sys.modules if names is None else names
    return sorted({n.split(".", 1)[0] for n in names} & FORBIDDEN)
