"""Host-side WFST library (tropical semiring).

Compile-time graph algebra for decode-graph construction; the runtime
decode product is dense tensors (see graph/dense.py).
"""

from .core import EPS_ID, INF, Arc, Fst, SymbolTable
from .determinize import (
    DeterminizeError,
    determinize,
    determinize_star,
    minimize,
    minimize_encoded,
)
from .ops import (
    compose,
    prune,
    push,
    rmepsilon,
    shortest_distance,
    shortest_path,
    weighted_language,
)

__all__ = [
    "Arc",
    "DeterminizeError",
    "EPS_ID",
    "Fst",
    "INF",
    "SymbolTable",
    "compose",
    "determinize",
    "determinize_star",
    "minimize",
    "minimize_encoded",
    "prune",
    "push",
    "rmepsilon",
    "shortest_distance",
    "shortest_path",
    "weighted_language",
]
