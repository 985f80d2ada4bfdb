"""On-disk training artifacts (the train_dir layout).

Mirrors the reference's artifact roles (kaldi.py:38-70: data/lang_<suffix>/
{G.fst, G.fuzzy.fst, words.txt}, graph_<suffix>/HCLG.fst) with TPU-native
formats: FSTs as text (host-side compose/rescore inputs), the decode graph
as DenseGraph npz tensors ready for device upload.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Union

from ..const import LangSuffix
from ..fst.core import Fst, SymbolTable
from ..graph.dense import DenseGraph


def lang_dir_name(suffix: LangSuffix) -> str:
    return f"lang_{suffix.value}"


@dataclass
class LangArtifacts:
    """One compiled lang: symbols + word FSTs + dense decode graph."""

    words: SymbolTable
    g_fst: Optional[Fst] = None
    g_fuzzy: Optional[Fst] = None
    graph: Optional[DenseGraph] = None  # None for rescore-only langs
    # Deterministic phones→words lexicon (Ldet.fst role) + the phone table,
    # consumed by the lattice-level rescore chain (transcribe_wav.py:131-142)
    ldet: Optional[Fst] = None
    phones: Optional[SymbolTable] = None

    def save(self, lang_dir: Union[str, Path]) -> None:
        lang_dir = Path(lang_dir)
        lang_dir.mkdir(parents=True, exist_ok=True)
        with open(lang_dir / "words.txt", "w", encoding="utf-8") as f:
            self.words.write_text(f)
        if self.g_fst is not None:
            with open(lang_dir / "g.fst", "w", encoding="utf-8") as f:
                self.g_fst.write_text(f)
        if self.g_fuzzy is not None:
            with open(lang_dir / "g_fuzzy.fst", "w", encoding="utf-8") as f:
                self.g_fuzzy.write_text(f)
        if self.graph is not None:
            self.graph.save(str(lang_dir / "graph.npz"))
        if self.ldet is not None:
            with open(lang_dir / "ldet.fst", "w", encoding="utf-8") as f:
                self.ldet.write_text(f)
        if self.phones is not None:
            with open(lang_dir / "phones.txt", "w", encoding="utf-8") as f:
                self.phones.write_text(f)

    @staticmethod
    def load(lang_dir: Union[str, Path]) -> "LangArtifacts":
        lang_dir = Path(lang_dir)
        with open(lang_dir / "words.txt", "r", encoding="utf-8") as f:
            words = SymbolTable.read_text(f)
        g_fst = g_fuzzy = graph = None
        # FSTs are stored with numeric labels (write_text); parse without
        # symbol tables, then attach the word table for display/use.
        if (lang_dir / "g.fst").exists():
            with open(lang_dir / "g.fst", "r", encoding="utf-8") as f:
                g_fst = Fst.from_text(f)
            g_fst.isymbols = g_fst.osymbols = words
        if (lang_dir / "g_fuzzy.fst").exists():
            with open(lang_dir / "g_fuzzy.fst", "r", encoding="utf-8") as f:
                g_fuzzy = Fst.from_text(f)
            g_fuzzy.isymbols = g_fuzzy.osymbols = words
        graph_path = lang_dir / "graph.npz"
        if graph_path.exists():
            graph = DenseGraph.load(str(graph_path))
        ldet = phones = None
        if (lang_dir / "phones.txt").exists():
            with open(lang_dir / "phones.txt", "r", encoding="utf-8") as f:
                phones = SymbolTable.read_text(f)
        if (lang_dir / "ldet.fst").exists():
            with open(lang_dir / "ldet.fst", "r", encoding="utf-8") as f:
                ldet = Fst.from_text(f)
            ldet.isymbols = phones
            ldet.osymbols = words
        return LangArtifacts(
            words=words,
            g_fst=g_fst,
            g_fuzzy=g_fuzzy,
            graph=graph,
            ldet=ldet,
            phones=phones,
        )
