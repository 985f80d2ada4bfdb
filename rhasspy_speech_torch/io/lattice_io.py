"""Kaldi lattice binary I/O: Lattice / CompactLattice (+ ark archives).

Format parity with lat/kaldi-lattice.cc (reference kaldi):
- A binary (Compact)Lattice is an OpenFST VectorFst serialization whose arc
  type is one of "lattice4"/"lattice8" (weight = graph_cost, acoustic_cost
  as f32/f64 pairs; fstext/lattice-weight.h:84-87,141-145) or
  "compactlattice44"/"compactlattice48" (that pair + an int32-counted string
  of int32 transition-ids; lattice-weight.h:471-474,532-543).
- Ark archives frame each entry as ``key`` + ' ' + "\\0B" + object
  (kaldi-lattice.cc:62-70 via Table I/O), exactly like matrix arks.

CompactLattice here is an ACCEPTOR over word ids whose weights carry
(graph_cost, acoustic_cost, transition-id string) — the exchange format the
reference pipes between latgen / lattice-* binaries (transcribe_wav.py:45-202).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import BinaryIO, Dict, Iterator, List, Optional, Tuple, Union

from .openfst import (
    FST_MAGIC,
    NO_STATE,
    OpenFstFormatError,
    _read_exact,
    _read_i32,
    _read_i64,
    _read_string,
    _read_u64,
    _write_i32,
    _write_i64,
    _write_string,
    _write_u64,
)

# weight = (graph_cost, acoustic_cost, transition_ids)
CompactWeight = Tuple[float, float, Tuple[int, ...]]
# arc = (word_label, graph_cost, acoustic_cost, transition_ids, nextstate)
CompactArc = Tuple[int, float, float, Tuple[int, ...], int]

_FLOAT_FMT = {"4": ("<f", 4), "8": ("<d", 8)}


@dataclass
class KaldiCompactLattice:
    """A CompactLattice: word acceptor, weights (graph, acoustic, tid string)."""

    start: int = -1
    arcs: List[List[CompactArc]] = field(default_factory=list)
    finals: Dict[int, CompactWeight] = field(default_factory=dict)

    @property
    def num_states(self) -> int:
        return len(self.arcs)

    def num_arcs(self) -> int:
        return sum(len(a) for a in self.arcs)

    def add_state(self) -> int:
        self.arcs.append([])
        return len(self.arcs) - 1

    def to_fst(self, acoustic_scale: float = 1.0):
        """Collapse to a host Fst acceptor over words with combined cost
        graph + acoustic_scale * acoustic (lattice-scale semantics), for the
        generic toolbox (compose/shortest_path/nbest)."""
        from ..fst.core import Fst

        fst = Fst()
        fst.add_states(self.num_states)
        fst.start = self.start
        for s, arcs in enumerate(self.arcs):
            for word, g, a, _tids, ns in arcs:
                fst.add_arc(s, word, word, g + acoustic_scale * a, ns)
        for s, (g, a, _tids) in self.finals.items():
            fst.set_final(s, g + acoustic_scale * a)
        return fst


def determinize_compact_lattice(
    clat: KaldiCompactLattice,
    max_states: int = 200_000,
) -> KaldiCompactLattice:
    """Weighted determinization of an ACYCLIC CompactLattice: one out-arc
    per word per state, epsilon-free — every word sequence appears on at
    most one path, carrying its best (min total cost) weight.

    The role of Kaldi's DeterminizeLatticePruned over CompactLattices
    (lat/determinize-lattice-pruned.cc; invoked by lattice-determinize and
    GetLattice, online-nnet3-decoding.cc:66-77): Kaldi tools consuming
    exported arks expect one occurrence per word sequence. Weights follow
    the LatticeWeight order (total = graph + acoustic, ties by graph,
    lattice-weight.h:84-87); transition-id strings concatenate along paths
    and ride the subset residuals (decode exports carry empty strings, so
    this is exercised degenerately but handled generally).

    Classic subset construction with weight/string residuals — decode
    lattices are frame-ordered DAGs, so the construction terminates;
    ``max_states`` guards against pathological growth.
    """

    def order_key(w: Tuple[float, float]) -> Tuple[float, float]:
        return (w[0] + w[1], w[0])

    def eps_closure(
        elems: Dict[int, Tuple[float, float, Tuple[int, ...]]]
    ) -> Dict[int, Tuple[float, float, Tuple[int, ...]]]:
        """Relax word-0 (epsilon) arcs to a fixpoint (input is acyclic)."""
        out = dict(elems)
        changed = True
        guard = 0
        while changed:
            changed = False
            guard += 1
            if guard > clat.num_states + 2:
                raise ValueError("epsilon cycle in compact lattice")
            for s, (g, a, tids) in list(out.items()):
                for word, ag, aa, atids, ns in clat.arcs[s]:
                    if word != 0:
                        continue
                    cand = (g + ag, a + aa, tids + atids)
                    cur = out.get(ns)
                    if cur is None or order_key(cand[:2]) < order_key(cur[:2]):
                        out[ns] = cand
                        changed = True
        return out

    def normalize(elems):
        """-> (base_weight (g, a, tids), residual dict, hashable key)."""
        base_g, base_a, _ = min(
            elems.values(), key=lambda w: order_key(w[:2])
        )
        tid_lists = [w[2] for w in elems.values()]
        prefix = tid_lists[0]
        for t in tid_lists[1:]:
            n = 0
            for x, y in zip(prefix, t):
                if x != y:
                    break
                n += 1
            prefix = prefix[:n]
            if not prefix:
                break
        # Residuals are quantized to the same 1e-5 grid used for the
        # subset key, so a merged subset's stored residuals and its key
        # agree exactly: two subsets that merge are identical up to the
        # quantization step (path costs perturbed by at most 0.5e-5 per
        # determinized arc — well inside Kaldi's own kDelta ~1e-3 weight
        # tolerance, fst/float-weight.h). Float noise exactly on a grid
        # boundary can still split equal subsets; growth stays bounded by
        # ``max_states``.
        norm = {
            s: (round(g - base_g, 5), round(a - base_a, 5), t[len(prefix):])
            for s, (g, a, t) in elems.items()
        }
        key = tuple(
            sorted((s, g, a, t) for s, (g, a, t) in norm.items())
        )
        return (base_g, base_a, prefix), norm, key

    out = KaldiCompactLattice()
    if clat.start < 0:
        return out

    start_elems = eps_closure({clat.start: (0.0, 0.0, ())})
    # The start subset keeps absolute residuals (an FST has no initial
    # weight to carry a normalization base), so it never merges with a
    # normalized subset: key it with a sentinel.
    start_id = out.add_state()
    out.start = start_id
    subsets = {("__start__",): start_id}
    # store the ACTUAL residuals per subset id (start: absolute)
    todo = [(start_id, start_elems)]

    while todo:
        sid, elems = todo.pop()
        # final weight: best completion over elements
        best_final = None
        for s, (g, a, tids) in elems.items():
            f = clat.finals.get(s)
            if f is None:
                continue
            cand = (g + f[0], a + f[1], tids + f[2])
            if best_final is None or order_key(cand[:2]) < order_key(
                best_final[:2]
            ):
                best_final = cand
        if best_final is not None:
            out.finals[sid] = best_final

        # group non-eps transitions by word
        by_word: Dict[int, Dict[int, Tuple[float, float, Tuple[int, ...]]]] = {}
        for s, (g, a, tids) in elems.items():
            for word, ag, aa, atids, ns in clat.arcs[s]:
                if word == 0:
                    continue
                cand = (g + ag, a + aa, tids + atids)
                bucket = by_word.setdefault(word, {})
                cur = bucket.get(ns)
                if cur is None or order_key(cand[:2]) < order_key(cur[:2]):
                    bucket[ns] = cand
        for word in sorted(by_word):
            nxt = eps_closure(by_word[word])
            (bg, ba, btids), norm, key = normalize(nxt)
            nid = subsets.get(key)
            if nid is None:
                if len(subsets) >= max_states:
                    raise ValueError(
                        "determinization exceeded max_states="
                        f"{max_states}"
                    )
                nid = out.add_state()
                subsets[key] = nid
                todo.append((nid, norm))
            out.arcs[sid].append((word, bg, ba, btids, nid))
    return out


def insert_phone_labels(
    clat: KaldiCompactLattice,
    transition_model,
) -> Tuple[KaldiCompactLattice, int]:
    """Tag phone boundaries with synthetic labels (Kaldi's
    DeterminizeLatticeInsertPhones, lat/determinize-lattice-pruned.cc:
    1296-1349): every transition-id that starts a phone (hmm-state 0 and
    not a self-loop) gets a label ``first_phone_label + phone`` inserted
    into the word sequence at its position. Returns (tagged lattice,
    first_phone_label). Arcs out of the start state skip the boundary at
    string position 0, as the reference does (:1313-1314 ``state ==
    fst->Start() continue`` — in its expanded per-tid form only the first
    transition-id of a start arc leaves the start state).

    A compact arc bundles a word with a multi-phone tid string, so
    tagging splits it into a chain: the original word keeps the head
    segment, each boundary's phone label carries the tids up to the next
    boundary (when the boundary is the arc's first tid the word arc keeps
    that tid and the phone arc is empty — mirroring the reference's
    extra-arc insertion after an occupied word arc, :1333-1341)."""
    tm = transition_model

    def phone_start(tid: int) -> int:
        """Phone id if ``tid`` starts a phone, else 0."""
        if tid <= 0 or tid >= tm.id2tstate.shape[0]:
            return 0
        if bool(tm.id2self_loop[tid]):
            return 0
        ts = int(tm.id2tstate[tid])
        phone, hmm_state = int(tm.tuples[ts - 1, 0]), int(
            tm.tuples[ts - 1, 1]
        )
        return phone if hmm_state == 0 else 0

    first_phone_label = 1 + max(
        (arc[0] for arcs in clat.arcs for arc in arcs), default=0
    )
    out = KaldiCompactLattice(start=clat.start)
    for _ in range(clat.num_states):
        out.add_state()
    out.finals = dict(clat.finals)
    for s, arcs in enumerate(clat.arcs):
        for word, g, a, tids, ns in arcs:
            bounds = [
                (i, p)
                for i, t in enumerate(tids)
                for p in (phone_start(int(t)),)
                if p and not (s == clat.start and i == 0)
            ]
            if not bounds:
                out.arcs[s].append((word, g, a, tids, ns))
                continue
            # segment cut points: word arc takes [0, c0) (at least the
            # boundary tid itself when it sits at position 0), phone arc
            # j takes [c_j, c_{j+1})
            cuts = [i if i > 0 else 1 for i, _ in bounds]
            cur = s
            prev = 0
            labels = [word] + [first_phone_label + p for _, p in bounds]
            segs = []
            for c in cuts:
                segs.append(tids[prev:c])
                prev = c
            segs.append(tids[prev:])
            # segs[0] rides the word arc; when the first boundary was at
            # position 0 its phone arc gets segs[1] starting AFTER the
            # boundary tid (which stayed on the word arc)
            for k, lab in enumerate(labels):
                last = k == len(labels) - 1
                nxt = ns if last else out.add_state()
                if k == 0:
                    out.arcs[cur].append((lab, g, a, segs[0], nxt))
                else:
                    out.arcs[cur].append((lab, 0.0, 0.0, segs[k], nxt))
                cur = nxt
    return out, first_phone_label


def delete_phone_labels(
    clat: KaldiCompactLattice, first_phone_label: int
) -> None:
    """Turn inserted phone labels back into epsilons in place
    (DeterminizeLatticeDeletePhones, determinize-lattice-pruned.cc:
    1352-1375)."""
    for s, arcs in enumerate(clat.arcs):
        clat.arcs[s] = [
            (0 if word >= first_phone_label else word, g, a, tids, ns)
            for (word, g, a, tids, ns) in arcs
        ]


def determinize_lattice_phone_pruned(
    clat: KaldiCompactLattice,
    transition_model,
    max_states: int = 200_000,
) -> KaldiCompactLattice:
    """Two-pass phone-then-word lattice determinization — Kaldi's
    DeterminizeLatticePhonePruned (lat/determinize-lattice-pruned.cc:
    1416-1473, the GetLattice path online-nnet3-decoding.cc:66-77).

    Pass 1 determinizes at the (word + phone)-sequence level after
    tagging phone boundaries, then deletes the tags: transition-id
    timing variants of the same phone sequence (different self-loop
    counts — the dominant alignment ambiguity in decode lattices) merge
    early, each keeping its best path's alignment, which bounds subset
    growth in pass 2. Pass 2 re-determinizes at the word level: one
    epsilon-free path per word sequence at its best cost, carrying the
    best path's transition-ids (both passes keep strings in the subset
    identity, exactly the reference's SubsetEqual :450-468).

    Lattices without transition-id strings (this package's decode
    exports fold epsilon closures at graph build time and retain no
    frame alignments) have no phone boundaries to tag: the phone pass
    degenerates and a single word-level pass runs."""
    tagged, first_phone_label = insert_phone_labels(clat, transition_model)
    if tagged.num_arcs() == clat.num_arcs():
        # no boundary was tagged: the phone pass would equal the word
        # pass; run word-level determinization once
        return determinize_compact_lattice(clat, max_states=max_states)
    det1 = determinize_compact_lattice(tagged, max_states=max_states)
    delete_phone_labels(det1, first_phone_label)
    return determinize_compact_lattice(det1, max_states=max_states)


def _read_compact_weight(f: BinaryIO, fmt: str, size: int) -> CompactWeight:
    g, a = (
        struct.unpack(fmt, _read_exact(f, size))[0],
        struct.unpack(fmt, _read_exact(f, size))[0],
    )
    n = _read_i32(f)
    if n < 0 or n > 2**24:
        raise OpenFstFormatError(f"bad lattice string size {n}")
    tids = tuple(
        struct.unpack_from("<%di" % n, _read_exact(f, 4 * n))
    ) if n else ()
    return float(g), float(a), tids


def _read_plain_weight(f: BinaryIO, fmt: str, size: int) -> Tuple[float, float]:
    g = struct.unpack(fmt, _read_exact(f, size))[0]
    a = struct.unpack(fmt, _read_exact(f, size))[0]
    return float(g), float(a)


_F32_INF = float("inf")


def read_lattice(f: BinaryIO) -> KaldiCompactLattice:
    """Read one binary (Compact)Lattice; plain lattices (arc types
    lattice4/8, ilabel=transition-id, olabel=word) are converted to the
    compact form the way ConvertToCompactLattice does (word acceptor with
    per-arc singleton tid strings; kaldi-lattice.cc:304-346)."""
    magic = _read_i32(f)
    if magic != FST_MAGIC:
        raise OpenFstFormatError(f"bad FST magic {magic}")
    fsttype = _read_string(f)
    arctype = _read_string(f)
    _version = _read_i32(f)
    _flags = _read_i32(f)
    _properties = _read_u64(f)
    start = _read_i64(f)
    numstates = _read_i64(f)
    _numarcs = _read_i64(f)
    if fsttype != "vector":
        raise OpenFstFormatError(f"unsupported lattice fst type {fsttype!r}")
    compact = arctype.startswith("compactlattice")
    plain = arctype.startswith("lattice") and not compact
    if not (compact or plain):
        raise OpenFstFormatError(f"not a lattice arc type: {arctype!r}")
    fsz = arctype[-1] if plain else arctype[-2]
    if fsz not in _FLOAT_FMT:
        raise OpenFstFormatError(f"bad lattice arc type {arctype!r}")
    fmt, size = _FLOAT_FMT[fsz]
    if compact and arctype[-1] != "4":
        raise OpenFstFormatError(
            f"unsupported lattice int width in {arctype!r}"
        )
    if numstates < 0 or numstates > 2**40:
        raise OpenFstFormatError(f"bad state count {numstates}")
    # bound a corrupt count by the remaining bytes when seekable (each
    # state record is at least 12 bytes: final weight + arc count)
    try:
        pos = f.tell()
        f.seek(0, 2)
        remaining = f.tell() - pos
        f.seek(pos)
        if numstates > remaining // 12 + 1:
            raise OpenFstFormatError(
                f"state count {numstates} exceeds file size"
            )
    except OSError:
        if numstates > 2**26:
            raise OpenFstFormatError(
                f"state count {numstates} too large to validate on an "
                "unseekable stream"
            )

    lat = KaldiCompactLattice(start=int(start) if start != NO_STATE else -1)
    for _ in range(numstates):
        lat.add_state()
    for s in range(numstates):
        if compact:
            fw = _read_compact_weight(f, fmt, size)
            if not (fw[0] == _F32_INF and fw[1] == _F32_INF):
                lat.finals[s] = fw
        else:
            g, a = _read_plain_weight(f, fmt, size)
            if not (g == _F32_INF and a == _F32_INF):
                lat.finals[s] = (g, a, ())
        narcs = _read_i64(f)
        if narcs < 0 or narcs > 2**40:
            raise OpenFstFormatError(f"bad arc count {narcs}")
        for _ in range(narcs):
            il = _read_i32(f)
            ol = _read_i32(f)
            if compact:
                g, a, tids = _read_compact_weight(f, fmt, size)
                ns = _read_i32(f)
                lat.arcs[s].append((il, g, a, tids, ns))
            else:
                g, a = _read_plain_weight(f, fmt, size)
                ns = _read_i32(f)
                # plain lattice: ilabel = transition-id, olabel = word
                lat.arcs[s].append((ol, g, a, (il,) if il else (), ns))
    return lat


def write_compact_lattice(f: BinaryIO, lat: KaldiCompactLattice) -> None:
    """Write binary arc type compactlattice44 (the format every Kaldi
    lattice tool consumes)."""
    _write_i32(f, FST_MAGIC)
    _write_string(f, "vector")
    _write_string(f, "compactlattice44")
    _write_i32(f, 2)  # version
    _write_i32(f, 0)  # flags: no symbol tables
    _write_u64(f, 0)  # properties
    _write_i64(f, lat.start if lat.start >= 0 else NO_STATE)
    _write_i64(f, lat.num_states)
    _write_i64(f, lat.num_arcs())

    def w_weight(g: float, a: float, tids: Tuple[int, ...]) -> None:
        f.write(struct.pack("<f", g))
        f.write(struct.pack("<f", a))
        _write_i32(f, len(tids))
        for t in tids:
            _write_i32(f, t)

    for s in range(lat.num_states):
        if s in lat.finals:
            w_weight(*lat.finals[s])
        else:
            w_weight(_F32_INF, _F32_INF, ())
        _write_i64(f, len(lat.arcs[s]))
        for word, g, a, tids, ns in lat.arcs[s]:
            _write_i32(f, word)
            _write_i32(f, word)
            w_weight(g, a, tids)
            _write_i32(f, ns)


def read_lattice_ark(
    path: Union[str, Path]
) -> Iterator[Tuple[str, KaldiCompactLattice]]:
    """Iterate (utterance key, lattice) from a binary lattice ark."""
    with open(path, "rb") as f:
        while True:
            key_chars: List[bytes] = []
            while True:
                c = f.read(1)
                if not c:
                    if key_chars:
                        raise OpenFstFormatError("EOF inside ark key")
                    return
                if c == b" ":
                    break
                key_chars.append(c)
            key = b"".join(key_chars).decode("utf-8")
            header = f.read(2)
            if header != b"\x00B":
                raise OpenFstFormatError(
                    f"entry {key!r}: not in binary mode (got {header!r})"
                )
            yield key, read_lattice(f)


def write_lattice_ark(
    path: Union[str, Path],
    items: Iterator[Tuple[str, KaldiCompactLattice]],
) -> None:
    with open(path, "wb") as f:
        for key, lat in items:
            f.write(key.encode("utf-8") + b" \x00B")
            write_compact_lattice(f, lat)


def compact_lattice_from_decode(
    lattice,  # ops.lattice.Lattice
    graph,  # graph.dense.DenseGraph
) -> KaldiCompactLattice:
    """Export a decode lattice (ops/lattice.py) as a word-level
    CompactLattice. Transition-id strings are left empty: the dense TPU
    graph folds epsilon closures at build time, so frame-level alignments
    are not retained — word-level rescoring/composition tools still apply."""
    out = KaldiCompactLattice()
    # + a superfinal state so multi-word word sequences can be spelled out
    for _ in range(lattice.num_nodes):
        out.add_state()

    def emit_words(src: int, words: Tuple[int, ...], g_cost: float,
                   dst: Optional[int], a_cost: float = 0.0) -> None:
        """Chain of single-word arcs from src, ending at dst (or final)."""
        cur = src
        seq = [w for w in words if w != 0]
        if dst is None and not seq:
            out.finals[cur] = (g_cost, a_cost, ())
            return
        for i, w in enumerate(seq):
            last = i == len(seq) - 1
            if last and dst is not None:
                nxt = dst
            else:
                nxt = out.add_state()
            first = i == 0
            out.arcs[cur].append(
                (w, g_cost if first else 0.0, a_cost if first else 0.0, (), nxt)
            )
            cur = nxt
        if dst is None:
            out.finals[cur] = (0.0, 0.0, ())
        elif not seq:
            out.arcs[cur].append((0, g_cost, a_cost, (), dst))

    start = out.add_state()
    out.start = start
    for n in lattice.starts:
        state = lattice.node_frame_state[n][1]
        words = graph.words_of(int(graph.init_wseq[state]))
        emit_words(start, tuple(words), float(graph.init_weight[state]), n)
    for src, dst, wseq, g_cost, a_cost, _arc in lattice.arcs:
        emit_words(src, tuple(graph.words_of(wseq)), g_cost, dst, a_cost)
    for n, fcost in lattice.finals.items():
        state = lattice.node_frame_state[n][1]
        words = tuple(graph.words_of(int(graph.final_wseq[state])))
        if words:
            tail = out.add_state()
            emit_words(n, words, fcost, tail)
            out.finals[tail] = (0.0, 0.0, ())
        else:
            out.finals[n] = (fcost, 0.0, ())
    return out
