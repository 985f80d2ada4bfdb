"""The port's one doorway into ``rhasspy_speech_tpu``'s host layers.

The grammar, FST, lang, graph, lexicon, io and native layers of the JAX
package, and ``pipeline/{artifacts,fuzzy,train}.py`` and
``testing/{flagship,tdnnf}.py``, contain no JAX code. Their package
``__init__`` files do import JAX, though: ``rhasspy_speech_tpu/__init__.py``
pulls in the transcriber, ``pipeline/__init__.py`` the JAX pipeline and
``testing/__init__.py`` the JAX frontend. So this module picks one of two
ways in:

- In a process that has already imported JAX or the JAX package (the test
  suite compares the two packages in one process), it imports the real
  package, so the JAX package never sees a stand-in.
- Otherwise it registers bare package modules (``__path__`` only) for
  ``rhasspy_speech_tpu``, ``rhasspy_speech_tpu.pipeline`` and
  ``rhasspy_speech_tpu.testing``. The host modules then load from the real
  files without running the ``__init__`` files that import JAX, even on a
  machine where JAX is installed.

The choice is made once, at the first import of the port, so a process
that needs the JAX package as well imports it (or JAX) first; a later
``import rhasspy_speech_tpu`` would otherwise find the bare stand-in.

Every host name the port uses is re-exported here.
"""

from __future__ import annotations

import importlib.util
import sys
import types

_PKG = "rhasspy_speech_tpu"
# packages whose __init__ imports JAX; their children are host code
_BARE = (_PKG, f"{_PKG}.pipeline", f"{_PKG}.testing")


def _real_package_wanted() -> bool:
    """True in a process that already holds JAX or the JAX package (a
    ``None`` entry in ``sys.modules`` marks a blocked import)."""
    return sys.modules.get("jax") is not None or sys.modules.get(_PKG) is not None


def _register_bare_packages() -> None:
    spec = importlib.util.find_spec(_PKG)
    if spec is None or not spec.submodule_search_locations:
        raise ImportError(f"the host layers need the {_PKG} sources on sys.path")
    root = list(spec.submodule_search_locations)[0]
    for name in _BARE:
        if name in sys.modules:
            continue
        mod = types.ModuleType(name)
        mod.__path__ = [root + name[len(_PKG):].replace(".", "/")]
        mod.__package__ = name
        sys.modules[name] = mod
        parent, _, child = name.rpartition(".")
        if parent:
            setattr(sys.modules[parent], child, mod)


if _real_package_wanted():
    import rhasspy_speech_tpu  # noqa: F401
else:
    _register_bare_packages()

from rhasspy_speech_tpu.const import LangSuffix  # noqa: E402
from rhasspy_speech_tpu.fst.core import EPS_ID, Fst, SymbolTable  # noqa: E402
from rhasspy_speech_tpu.fst.determinize import determinize  # noqa: E402
from rhasspy_speech_tpu.fst.ops import rmepsilon, shortest_path  # noqa: E402
from rhasspy_speech_tpu.grammar.fst import decode_meta  # noqa: E402
from rhasspy_speech_tpu.graph.dense import NEG_INF_F32, DenseGraph  # noqa: E402
from rhasspy_speech_tpu.io.ivector import (  # noqa: E402
    DiagGmm,
    IvectorExtractor,
    OnlineIvectorConfig,
    parse_conf,
)
from rhasspy_speech_tpu.io.gmm_am import is_gmm_model  # noqa: E402
from rhasspy_speech_tpu.io.kaldi_io import read_kaldi_object  # noqa: E402
from rhasspy_speech_tpu.io.lattice_io import (  # noqa: E402
    compact_lattice_from_decode,
    determinize_lattice_phone_pruned,
)
from rhasspy_speech_tpu.io.nnet3_file import (  # noqa: E402
    ComponentSpec,
    Descriptor,
    Nnet3Spec,
    NodeSpec,
    read_am_nnet3,
)
from rhasspy_speech_tpu.pipeline.artifacts import (  # noqa: E402
    LangArtifacts,
    lang_dir_name,
)
from rhasspy_speech_tpu.pipeline.endpoint import silence_pdfs_from_model  # noqa: E402
from rhasspy_speech_tpu.pipeline.fuzzy import get_fuzzy_text, rescore_nbest  # noqa: E402
from rhasspy_speech_tpu.pipeline.rescore import rescore_lattice, rescore_tail  # noqa: E402
from rhasspy_speech_tpu.pipeline.train import (  # noqa: E402
    train_model,
    train_model_sync,
)
from rhasspy_speech_tpu.testing.flagship import (  # noqa: E402
    build_flagship_graph,
    write_flagship_model_dir,
)

__all__ = [
    "ComponentSpec",
    "DenseGraph",
    "Descriptor",
    "DiagGmm",
    "EPS_ID",
    "Fst",
    "IvectorExtractor",
    "LangArtifacts",
    "LangSuffix",
    "NEG_INF_F32",
    "Nnet3Spec",
    "NodeSpec",
    "OnlineIvectorConfig",
    "SymbolTable",
    "build_flagship_graph",
    "compact_lattice_from_decode",
    "decode_meta",
    "determinize",
    "determinize_lattice_phone_pruned",
    "get_fuzzy_text",
    "is_gmm_model",
    "lang_dir_name",
    "parse_conf",
    "read_am_nnet3",
    "read_kaldi_object",
    "rescore_lattice",
    "rescore_nbest",
    "rescore_tail",
    "rmepsilon",
    "shortest_path",
    "silence_pdfs_from_model",
    "train_model",
    "train_model_sync",
    "write_flagship_model_dir",
]
