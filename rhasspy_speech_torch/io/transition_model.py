"""Kaldi HmmTopology + TransitionModel parsing (final.mdl header).

Byte-exact read/write of the formats in
kaldi/src/hmm/hmm-topology.cc HmmTopology::Write (binary branch) and
kaldi/src/hmm/transition-model.cc TransitionModel::{Read,Write,ComputeDerived}.

The decode path needs just two derived tables: ``id2pdf`` (transition-id ->
pdf-id, HCLG input labels -> acoustic-model output rows) and per-id
self-loop flags/log-probs for graph weights.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

from .kaldi_io import KaldiFormatError, KaldiReader, KaldiWriter

K_NO_PDF = -1


@dataclass
class TopologyState:
    """One HMM state: pdf classes and outgoing (next_state, prob) arcs."""

    forward_pdf_class: int
    self_loop_pdf_class: int
    transitions: List[Tuple[int, float]] = field(default_factory=list)


# One topology entry = list of states (last is non-emitting with no pdf)
TopologyEntry = List[TopologyState]


@dataclass
class KaldiHmmTopology:
    phones: np.ndarray  # sorted phone ids
    phone2idx: np.ndarray  # phone id -> entry index (-1 if absent)
    entries: List[TopologyEntry] = field(default_factory=list)

    def entry_for_phone(self, phone: int) -> TopologyEntry:
        idx = int(self.phone2idx[phone])
        if idx < 0:
            raise KeyError(f"no topology for phone {phone}")
        return self.entries[idx]

    @property
    def is_hmm(self) -> bool:
        """True if every state has self_loop_pdf_class == forward_pdf_class
        (classic topology; chain topologies are not 'hmm')."""
        for entry in self.entries:
            for st in entry:
                if st.forward_pdf_class != st.self_loop_pdf_class:
                    return False
        return True

    @staticmethod
    def read(r: KaldiReader) -> "KaldiHmmTopology":
        r.expect_token("<Topology>")
        phones = r.read_int_vector()
        phone2idx = r.read_int_vector()
        first = r.read_int()
        if first == -1:
            extended = True
            num_entries = r.read_int()
        else:
            extended = False
            num_entries = first
        entries: List[TopologyEntry] = []
        for _ in range(num_entries):
            num_states = r.read_int()
            entry: TopologyEntry = []
            for _ in range(num_states):
                fwd = r.read_int()
                self_loop = r.read_int() if extended else fwd
                if fwd == K_NO_PDF:
                    self_loop = K_NO_PDF
                num_trans = r.read_int()
                trans = []
                for _ in range(num_trans):
                    dst = r.read_int()
                    prob = r.read_float()
                    trans.append((dst, prob))
                entry.append(TopologyState(fwd, self_loop, trans))
            entries.append(entry)
        r.expect_token("</Topology>")
        return KaldiHmmTopology(phones=phones, phone2idx=phone2idx, entries=entries)

    def write(self, w: KaldiWriter) -> None:
        w.write_token("<Topology>")
        w.write_int_vector(self.phones)
        w.write_int_vector(self.phone2idx)
        if not self.is_hmm:
            w.write_int(-1)
        w.write_int(len(self.entries))
        extended = not self.is_hmm
        for entry in self.entries:
            w.write_int(len(entry))
            for st in entry:
                w.write_int(st.forward_pdf_class)
                if extended:
                    w.write_int(st.self_loop_pdf_class)
                w.write_int(len(st.transitions))
                for dst, prob in st.transitions:
                    w.write_int(dst)
                    w.write_float(prob)
        w.write_token("</Topology>")

    @staticmethod
    def chain(phone_ids: List[int]) -> "KaldiHmmTopology":
        """Kaldi chain topology (gen_topo.py): one emitting state with
        distinct forward/self-loop pdf classes, then the final state."""
        max_phone = max(phone_ids)
        phone2idx = np.full(max_phone + 1, -1, dtype=np.int64)
        for p in phone_ids:
            phone2idx[p] = 0
        entry: TopologyEntry = [
            TopologyState(0, 1, [(0, 0.5), (1, 0.5)]),
            TopologyState(K_NO_PDF, K_NO_PDF, []),
        ]
        return KaldiHmmTopology(
            phones=np.asarray(sorted(phone_ids), dtype=np.int64),
            phone2idx=phone2idx,
            entries=[entry],
        )

    @staticmethod
    def bakis3(phone_ids: List[int]) -> "KaldiHmmTopology":
        """Classic 3-state left-to-right topology (gen_topo.pl defaults)."""
        max_phone = max(phone_ids)
        phone2idx = np.full(max_phone + 1, -1, dtype=np.int64)
        for p in phone_ids:
            phone2idx[p] = 0
        entry: TopologyEntry = [
            TopologyState(0, 0, [(0, 0.75), (1, 0.25)]),
            TopologyState(1, 1, [(1, 0.75), (2, 0.25)]),
            TopologyState(2, 2, [(2, 0.75), (3, 0.25)]),
            TopologyState(K_NO_PDF, K_NO_PDF, []),
        ]
        return KaldiHmmTopology(
            phones=np.asarray(sorted(phone_ids), dtype=np.int64),
            phone2idx=phone2idx,
            entries=[entry],
        )


@dataclass
class KaldiTransitionModel:
    topology: KaldiHmmTopology
    # tuples[i] = (phone, hmm_state, forward_pdf, self_loop_pdf); transition
    # state i+1 corresponds to tuples[i]
    tuples: np.ndarray  # int64 [num_tstates, 4]
    log_probs: np.ndarray  # float32 [num_tids + 1], element 0 unused

    # Derived (filled by _compute_derived)
    id2pdf: np.ndarray = field(default=None)  # int32 [num_tids + 1]
    id2tstate: np.ndarray = field(default=None)
    id2self_loop: np.ndarray = field(default=None)  # bool [num_tids + 1]
    num_pdfs: int = 0

    def __post_init__(self):
        if self.id2pdf is None:
            self._compute_derived()

    def _compute_derived(self) -> None:
        num_tstates = self.tuples.shape[0]
        state2id = np.zeros(num_tstates + 2, dtype=np.int64)
        cur = 1
        for ts in range(1, num_tstates + 2):
            state2id[ts] = cur
            if ts <= num_tstates:
                phone, hmm_state = int(self.tuples[ts - 1, 0]), int(
                    self.tuples[ts - 1, 1]
                )
                entry = self.topology.entry_for_phone(phone)
                cur += len(entry[hmm_state].transitions)
        num_tids = cur - 1
        id2pdf = np.zeros(num_tids + 1, dtype=np.int32)
        id2tstate = np.zeros(num_tids + 1, dtype=np.int32)
        id2self = np.zeros(num_tids + 1, dtype=bool)
        num_pdfs = 0
        for ts in range(1, num_tstates + 1):
            phone, hmm_state, fwd_pdf, self_pdf = (
                int(x) for x in self.tuples[ts - 1]
            )
            num_pdfs = max(num_pdfs, fwd_pdf + 1, self_pdf + 1)
            entry = self.topology.entry_for_phone(phone)
            for k, (dst, _prob) in enumerate(entry[hmm_state].transitions):
                tid = int(state2id[ts]) + k
                id2tstate[tid] = ts
                is_self = dst == hmm_state
                id2self[tid] = is_self
                id2pdf[tid] = self_pdf if is_self else fwd_pdf
        self.id2pdf = id2pdf
        self.id2tstate = id2tstate
        self.id2self_loop = id2self
        self.num_pdfs = num_pdfs
        self._state2id = state2id

    @property
    def num_transition_ids(self) -> int:
        return self.id2pdf.shape[0] - 1

    @property
    def is_hmm(self) -> bool:
        return self.topology.is_hmm and bool(
            np.all(self.tuples[:, 2] == self.tuples[:, 3])
        )

    @staticmethod
    def read(r: KaldiReader) -> "KaldiTransitionModel":
        r.expect_token("<TransitionModel>")
        topo = KaldiHmmTopology.read(r)
        token = r.read_token()
        if token not in ("<Triples>", "<Tuples>"):
            raise KaldiFormatError(f"expected <Triples>/<Tuples>, got {token!r}")
        size = r.read_int()
        tuples = np.zeros((size, 4), dtype=np.int64)
        for i in range(size):
            tuples[i, 0] = r.read_int()
            tuples[i, 1] = r.read_int()
            tuples[i, 2] = r.read_int()
            tuples[i, 3] = r.read_int() if token == "<Tuples>" else tuples[i, 2]
        end = r.read_token()
        if end not in ("</Triples>", "</Tuples>"):
            raise KaldiFormatError(f"expected closing tuples token, got {end!r}")
        r.expect_token("<LogProbs>")
        log_probs = r.read_vector().astype(np.float32)
        r.expect_token("</LogProbs>")
        r.expect_token("</TransitionModel>")
        return KaldiTransitionModel(topology=topo, tuples=tuples, log_probs=log_probs)

    def write(self, w: KaldiWriter) -> None:
        is_hmm = self.is_hmm
        w.write_token("<TransitionModel>")
        self.topology.write(w)
        w.write_token("<Triples>" if is_hmm else "<Tuples>")
        w.write_int(self.tuples.shape[0])
        for i in range(self.tuples.shape[0]):
            w.write_int(int(self.tuples[i, 0]))
            w.write_int(int(self.tuples[i, 1]))
            w.write_int(int(self.tuples[i, 2]))
            if not is_hmm:
                w.write_int(int(self.tuples[i, 3]))
        w.write_token("</Triples>" if is_hmm else "</Tuples>")
        w.write_token("<LogProbs>")
        w.write_vector(self.log_probs.astype(np.float32))
        w.write_token("</LogProbs>")
        w.write_token("</TransitionModel>")

    @staticmethod
    def from_monophone_chain(num_phones: int) -> "KaldiTransitionModel":
        """Synthetic chain transition model: phones 1..num_phones, one tuple
        per phone with distinct forward/self-loop pdfs (pdfs numbered
        2*(phone-1), 2*(phone-1)+1). Used for tests and synthetic models."""
        topo = KaldiHmmTopology.chain(list(range(1, num_phones + 1)))
        tuples = np.zeros((num_phones, 4), dtype=np.int64)
        for i in range(num_phones):
            tuples[i] = (i + 1, 0, 2 * i, 2 * i + 1)
        # 2 transitions per tuple; log_probs = log(0.5)
        num_tids = 2 * num_phones
        log_probs = np.full(num_tids + 1, np.log(0.5), dtype=np.float32)
        log_probs[0] = 0.0
        return KaldiTransitionModel(topology=topo, tuples=tuples, log_probs=log_probs)
