"""ContextDependency ("tree") parsing: phone-in-context -> pdf id.

Byte-exact read/write of Kaldi's decision-tree format
(kaldi/src/tree/context-dep.cc ContextDependency::{Read,Write};
kaldi/src/tree/event-map.cc EventMap::Read and the CE/TE/SE node formats;
util/const-integer-set-inl.h:77-84 for SE yes-sets).

An event is {key: value}: keys 0..N-1 are context window positions (phone
ids, 0 = epsilon padding at utterance edges), key -1 (kPdfClass) is the
HMM state's pdf-class. ``ContextDependencyTree.compute`` answers the pdf id
exactly like ContextDependency::Compute (context-dep.cc:34-52).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .kaldi_io import KaldiFormatError, KaldiReader, KaldiWriter

PDF_CLASS_KEY = -1  # kaldi kPdfClass


# EventMap AST:
#   None (NULL)
#   ("ce", answer)
#   ("te", key, [children])
#   ("se", key, frozenset(yes_values), yes_child, no_child)
EventMapNode = Union[None, Tuple]


def read_event_map(r: KaldiReader) -> EventMapNode:
    token = r.read_token()
    if token == "NULL":
        return None
    if token == "CE":
        return ("ce", r.read_int())
    if token == "TE":
        key = r.read_int()
        size = r.read_int()
        r.expect_token("(")
        children = [read_event_map(r) for _ in range(size)]
        r.expect_token(")")
        return ("te", key, children)
    if token == "SE":
        key = r.read_int()
        yes_set = frozenset(int(x) for x in r.read_int_vector())
        r.expect_token("{")
        yes = read_event_map(r)
        no = read_event_map(r)
        r.expect_token("}")
        return ("se", key, yes_set, yes, no)
    raise KaldiFormatError(f"unknown EventMap node token {token!r}")


def write_event_map(w: KaldiWriter, node: EventMapNode) -> None:
    if node is None:
        w.write_token("NULL")
        return
    kind = node[0]
    if kind == "ce":
        w.write_token("CE")
        w.write_int(node[1])
    elif kind == "te":
        w.write_token("TE")
        w.write_int(node[1])
        w.write_int(len(node[2]))
        w.write_token("(")
        for child in node[2]:
            write_event_map(w, child)
        w.write_token(")")
    elif kind == "se":
        w.write_token("SE")
        w.write_int(node[1])
        w.write_int_vector(sorted(node[2]))
        w.write_token("{")
        write_event_map(w, node[3])
        write_event_map(w, node[4])
        w.write_token("}")
    else:  # pragma: no cover
        raise ValueError(kind)


def _map_lookup(node: EventMapNode, event: Dict[int, int]) -> Optional[int]:
    while node is not None:
        kind = node[0]
        if kind == "ce":
            return node[1]
        if kind == "te":
            value = event.get(node[1])
            if value is None or not (0 <= value < len(node[2])):
                return None
            node = node[2][value]
        elif kind == "se":
            value = event.get(node[1])
            if value is None:
                return None
            node = node[3] if value in node[2] else node[4]
        else:  # pragma: no cover
            raise ValueError(kind)
    return None


@dataclass
class ContextDependencyTree:
    """Parsed tree: context width N, central position P, EventMap root."""

    N: int
    P: int
    root: EventMapNode

    @staticmethod
    def read(r: KaldiReader) -> "ContextDependencyTree":
        r.expect_token("ContextDependency")
        n = r.read_int()
        p = r.read_int()
        r.expect_token("ToPdf")
        root = read_event_map(r)
        r.expect_token("EndContextDependency")
        return ContextDependencyTree(N=n, P=p, root=root)

    def write(self, w: KaldiWriter) -> None:
        w.write_token("ContextDependency")
        w.write_int(self.N)
        w.write_int(self.P)
        w.write_token("ToPdf")
        write_event_map(w, self.root)
        w.write_token("EndContextDependency")

    @staticmethod
    def load(path: str) -> "ContextDependencyTree":
        with open(path, "rb") as f:
            return ContextDependencyTree.read(KaldiReader(f))

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            self.write(KaldiWriter(f))

    def compute(
        self, phone_window: Sequence[int], pdf_class: int
    ) -> Optional[int]:
        """(phones in context window, pdf-class) -> pdf id or None.

        phone_window has N entries; position P is the phone being modeled;
        0 entries are epsilon padding (utterance edges)."""
        if len(phone_window) != self.N:
            raise ValueError(f"window must have {self.N} phones")
        event = {PDF_CLASS_KEY: pdf_class}
        for i, phone in enumerate(phone_window):
            event[i] = int(phone)
        return _map_lookup(self.root, event)

    @staticmethod
    def monophone_from_tuples(
        tuples: np.ndarray, max_phone: int, n: int = 1, p: int = 0
    ) -> "ContextDependencyTree":
        """Build a context-independent tree answering a TransitionModel's
        (phone, pdf-class) -> pdf mapping (for tests / synthetic models)."""
        by_phone: Dict[int, List[Optional[int]]] = {}
        for row in tuples:
            phone, hmm_state, fwd, slf = (int(x) for x in row)
            classes = by_phone.setdefault(phone, [])
            # chain tuples: pdf-class 0 = forward, 1 = self-loop per state 0
            while len(classes) < 2 * (hmm_state + 1):
                classes.append(None)
            classes[2 * hmm_state] = fwd
            classes[2 * hmm_state + 1] = slf
        table: List[EventMapNode] = [None] * (max_phone + 1)
        for phone, classes in by_phone.items():
            # pdf-class c maps: forward classes are even-slot convention in
            # the chain topology (class 0 -> fwd, class 1 -> self of state 0)
            children: List[EventMapNode] = [
                ("ce", pdf) if pdf is not None else None for pdf in classes
            ]
            table[phone] = ("te", PDF_CLASS_KEY, children)
        return ContextDependencyTree(N=n, P=p, root=("te", p, table))
