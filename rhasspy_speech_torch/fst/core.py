"""Weighted FST core: mutable FST, symbol tables, text I/O, basic ops.

Our replacement for the OpenFST operations the reference shells out to
(rhasspy_speech/kaldi.py:321-341, transcribe_util.py:47-60,
coqui_stt.py:182-206 invoke fstcompile/fstcompose/fstdeterminize/fstminimize/
fstarcsort/fstproject/fstshortestpath/fstrmepsilon/fsttopsort/fstpush/
fstprune/fstprint). Everything here is host-side compile-time code; the
decode-time product is dense tensors (graph/dense.py).

Weights are tropical (min, +) log-costs, matching OpenFST's default
StdArc/TropicalWeight: ZERO = +inf (impossible), ONE = 0.0.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Optional, TextIO, Tuple

INF = math.inf
EPS_ID = 0

# Arc = (ilabel, olabel, weight, nextstate)
Arc = Tuple[int, int, float, int]


class SymbolTable:
    """Bidirectional symbol <-> id table. Id 0 is conventionally <eps>."""

    def __init__(self, eps: Optional[str] = "<eps>") -> None:
        self._sym_to_id: Dict[str, int] = {}
        self._id_to_sym: Dict[int, str] = {}
        if eps is not None:
            self.add(eps, 0)

    def add(self, symbol: str, symbol_id: Optional[int] = None) -> int:
        existing = self._sym_to_id.get(symbol)
        if existing is not None:
            return existing
        if symbol_id is None:
            symbol_id = (max(self._id_to_sym) + 1) if self._id_to_sym else 0
        self._sym_to_id[symbol] = symbol_id
        self._id_to_sym[symbol_id] = symbol
        return symbol_id

    def find(self, symbol: str) -> Optional[int]:
        return self._sym_to_id.get(symbol)

    def find_id(self, symbol_id: int) -> Optional[str]:
        return self._id_to_sym.get(symbol_id)

    def __contains__(self, symbol: str) -> bool:
        return symbol in self._sym_to_id

    def __len__(self) -> int:
        return len(self._sym_to_id)

    def __iter__(self) -> Iterator[Tuple[str, int]]:
        return iter(self._sym_to_id.items())

    @staticmethod
    def read_text(fileobj: TextIO) -> "SymbolTable":
        table = SymbolTable(eps=None)
        for line in fileobj:
            line = line.strip()
            if not line:
                continue
            parts = line.split()
            table.add(parts[0], int(parts[1]))
        return table

    def write_text(self, fileobj: TextIO) -> None:
        for symbol_id in sorted(self._id_to_sym):
            print(self._id_to_sym[symbol_id], symbol_id, file=fileobj)


@dataclass
class Fst:
    """Mutable WFST over the tropical semiring."""

    arcs: List[List[Arc]] = field(default_factory=list)
    finals: List[float] = field(default_factory=list)  # INF = non-final
    start: int = -1
    isymbols: Optional[SymbolTable] = None
    osymbols: Optional[SymbolTable] = None

    # -- construction -------------------------------------------------------

    def add_state(self) -> int:
        self.arcs.append([])
        self.finals.append(INF)
        if self.start < 0:
            self.start = len(self.arcs) - 1
        return len(self.arcs) - 1

    def add_states(self, n: int) -> None:
        for _ in range(n):
            self.add_state()

    def add_arc(
        self, state: int, ilabel: int, olabel: int, weight: float, nextstate: int
    ) -> None:
        self.arcs[state].append((ilabel, olabel, weight, nextstate))

    def set_final(self, state: int, weight: float = 0.0) -> None:
        self.finals[state] = weight

    def is_final(self, state: int) -> bool:
        return self.finals[state] != INF

    @property
    def num_states(self) -> int:
        return len(self.arcs)

    @property
    def num_arcs(self) -> int:
        return sum(len(a) for a in self.arcs)

    def final_states(self) -> Iterator[int]:
        for state, weight in enumerate(self.finals):
            if weight != INF:
                yield state

    def copy(self) -> "Fst":
        return Fst(
            arcs=[list(a) for a in self.arcs],
            finals=list(self.finals),
            start=self.start,
            isymbols=self.isymbols,
            osymbols=self.osymbols,
        )

    def to_dot(self, max_states: int = 200) -> str:
        """Graphviz source for debugging (fstdraw equivalent)."""
        def sym(table, label):
            if label == EPS_ID:
                return "ε"
            if table is not None:
                name = table.find_id(label)
                if name is not None:
                    return name
            return str(label)

        lines = ["digraph FST {", "  rankdir=LR;"]
        n = min(self.num_states, max_states)
        for state in range(n):
            shape = "doublecircle" if self.finals[state] != INF else "circle"
            lines.append(f'  {state} [shape={shape}];')
            for il, ol, w, ns in self.arcs[state]:
                if ns >= max_states:
                    continue
                label = f"{sym(self.isymbols, il)}:{sym(self.osymbols, ol)}"
                if w:
                    label += f"/{w:.3g}"
                lines.append(f'  {state} -> {ns} [label="{label}"];')
        lines.append("}")
        return "\n".join(lines)

    def write_text(self, fileobj: TextIO) -> None:
        """Emit OpenFST text format (fstprint, numeric labels). The start
        state is printed first, as fstcompile requires."""
        if self.start < 0:
            return
        order = [self.start] + [s for s in range(self.num_states) if s != self.start]
        for state in order:
            for ilabel, olabel, weight, nextstate in self.arcs[state]:
                print(
                    state, nextstate, ilabel, olabel, _format_weight(weight),
                    file=fileobj,
                )
        for state in order:
            if self.finals[state] != INF:
                print(state, _format_weight(self.finals[state]), file=fileobj)

    # -- sorting / projection / relabeling ---------------------------------

    def arcsort(self, sort_type: str = "ilabel") -> "Fst":
        key_idx = 0 if sort_type == "ilabel" else 1
        for state_arcs in self.arcs:
            state_arcs.sort(key=lambda a: (a[key_idx], a[0], a[1], a[3]))
        return self

    def project(self, project_type: str = "input") -> "Fst":
        idx = 0 if project_type == "input" else 1
        for state_arcs in self.arcs:
            for i, arc in enumerate(state_arcs):
                label = arc[idx]
                state_arcs[i] = (label, label, arc[2], arc[3])
        if project_type == "input":
            self.osymbols = self.isymbols
        else:
            self.isymbols = self.osymbols
        return self

    def invert(self) -> "Fst":
        for state_arcs in self.arcs:
            for i, (il, ol, w, ns) in enumerate(state_arcs):
                state_arcs[i] = (ol, il, w, ns)
        self.isymbols, self.osymbols = self.osymbols, self.isymbols
        return self

    def relabel(
        self,
        ipairs: Optional[Dict[int, int]] = None,
        opairs: Optional[Dict[int, int]] = None,
    ) -> "Fst":
        for state_arcs in self.arcs:
            for i, (il, ol, w, ns) in enumerate(state_arcs):
                if ipairs:
                    il = ipairs.get(il, il)
                if opairs:
                    ol = opairs.get(ol, ol)
                state_arcs[i] = (il, ol, w, ns)
        return self

    def rm_symbols(self, labels: Iterable[int], side: str = "input") -> "Fst":
        """Replace the given labels with epsilon (fstrmsymbols semantics)."""
        label_set = set(labels)
        idx = 0 if side == "input" else 1
        for state_arcs in self.arcs:
            for i, arc in enumerate(state_arcs):
                if arc[idx] in label_set:
                    new = list(arc)
                    new[idx] = EPS_ID
                    state_arcs[i] = (new[0], new[1], new[2], new[3])
        return self

    def add_self_loops(
        self, pairs: List[Tuple[int, int]], states: Optional[Iterable[int]] = None
    ) -> "Fst":
        """Add (ilabel, olabel) self loops (fstaddselfloops semantics: at
        every final state and every state with a non-eps output arc)."""
        if states is None:
            target_states = set(self.final_states())
            for state, state_arcs in enumerate(self.arcs):
                if any(arc[1] != EPS_ID for arc in state_arcs):
                    target_states.add(state)
        else:
            target_states = set(states)

        for state in target_states:
            for ilabel, olabel in pairs:
                self.add_arc(state, ilabel, olabel, 0.0, state)
        return self

    # -- structural ops -----------------------------------------------------

    def connect(self) -> "Fst":
        """Remove states not both accessible and co-accessible."""
        if self.start < 0:
            return self

        # Forward reachability
        accessible = {self.start}
        stack = [self.start]
        while stack:
            state = stack.pop()
            for _, _, _, ns in self.arcs[state]:
                if ns not in accessible:
                    accessible.add(ns)
                    stack.append(ns)

        # Backward reachability from finals
        incoming: Dict[int, List[int]] = {}
        for state in accessible:
            for _, _, _, ns in self.arcs[state]:
                incoming.setdefault(ns, []).append(state)

        coaccessible = {s for s in accessible if self.finals[s] != INF}
        stack = list(coaccessible)
        while stack:
            state = stack.pop()
            for pred in incoming.get(state, []):
                if pred not in coaccessible:
                    coaccessible.add(pred)
                    stack.append(pred)

        keep = accessible & coaccessible
        return self._restrict(keep)

    def _restrict(self, keep: set) -> "Fst":
        if self.start not in keep:
            self.arcs = []
            self.finals = []
            self.start = -1
            return self

        old_to_new = {}
        order = sorted(keep)
        for new_id, old_id in enumerate(order):
            old_to_new[old_id] = new_id

        new_arcs: List[List[Arc]] = []
        new_finals: List[float] = []
        for old_id in order:
            new_arcs.append(
                [
                    (il, ol, w, old_to_new[ns])
                    for (il, ol, w, ns) in self.arcs[old_id]
                    if ns in keep
                ]
            )
            new_finals.append(self.finals[old_id])

        self.arcs = new_arcs
        self.finals = new_finals
        self.start = old_to_new[self.start]
        return self

    def topsort(self) -> "Fst":
        """Topologically sort states (raises on cycles)."""
        if self.start < 0:
            return self

        order: List[int] = []
        WHITE, GRAY, BLACK = 0, 1, 2
        color = [WHITE] * self.num_states
        stack: List[Tuple[int, int]] = [(self.start, 0)]
        color[self.start] = GRAY
        while stack:
            state, arc_idx = stack.pop()
            if arc_idx < len(self.arcs[state]):
                stack.append((state, arc_idx + 1))
                ns = self.arcs[state][arc_idx][3]
                if color[ns] == GRAY:
                    raise ValueError("FST has a cycle; cannot topsort")
                if color[ns] == WHITE:
                    color[ns] = GRAY
                    stack.append((ns, 0))
            else:
                color[state] = BLACK
                order.append(state)

        order.reverse()
        # Unreachable states go to the end
        seen = set(order)
        order.extend(s for s in range(self.num_states) if s not in seen)

        old_to_new = {old: new for new, old in enumerate(order)}
        new_arcs = [
            [(il, ol, w, old_to_new[ns]) for (il, ol, w, ns) in self.arcs[old]]
            for old in order
        ]
        new_finals = [self.finals[old] for old in order]
        self.arcs = new_arcs
        self.finals = new_finals
        self.start = old_to_new[self.start]
        return self

    # -- text I/O (OpenFST-compatible AT&T format) --------------------------

    @staticmethod
    def from_text(
        fileobj: TextIO,
        isymbols: Optional[SymbolTable] = None,
        osymbols: Optional[SymbolTable] = None,
        acceptor: bool = False,
        keep_state_numbering: bool = True,
    ) -> "Fst":
        """Compile a text FST (fstcompile). Unknown symbols are added to the
        tables when provided; otherwise labels are parsed as integers."""
        fst = Fst(isymbols=isymbols, osymbols=osymbols)
        state_map: Dict[str, int] = {}

        def get_state(token: str) -> int:
            if keep_state_numbering and token.isdigit():
                sid = int(token)
                while fst.num_states <= sid:
                    fst.add_state()
                if fst.start < 0:
                    fst.start = sid
                return sid
            if token not in state_map:
                state_map[token] = fst.add_state()
            return state_map[token]

        def get_label(token: str, table: Optional[SymbolTable]) -> int:
            if table is not None:
                label = table.find(token)
                if label is None:
                    label = table.add(token)
                return label
            return int(token)

        first_state: Optional[int] = None
        for line in fileobj:
            line = line.strip()
            if not line:
                continue
            parts = line.split()
            if len(parts) == 1:
                get_state(parts[0])
                fst.set_final(state_map.get(parts[0], int(parts[0])), 0.0)
                continue
            if len(parts) == 2:
                state = get_state(parts[0])
                fst.set_final(state, float(parts[1]))
                continue

            src = get_state(parts[0])
            dst = get_state(parts[1])
            if first_state is None:
                first_state = src
                fst.start = src
            ilabel = get_label(parts[2], isymbols)
            if acceptor:
                olabel = ilabel
                weight = float(parts[3]) if len(parts) > 3 else 0.0
            else:
                olabel = get_label(parts[3], osymbols)
                weight = float(parts[4]) if len(parts) > 4 else 0.0
            fst.add_arc(src, ilabel, olabel, weight, dst)

        if fst.start < 0 and fst.num_states > 0:
            fst.start = 0
        return fst

    def to_text(
        self,
        fileobj: TextIO,
        use_symbols: bool = True,
        acceptor: bool = False,
    ) -> None:
        """Print in AT&T format (fstprint). States are renumbered so the
        start state prints first, as OpenFST does."""
        if self.start < 0:
            return

        order = [self.start] + [s for s in range(self.num_states) if s != self.start]
        remap = {old: new for new, old in enumerate(order)}

        def isym(label: int) -> str:
            if use_symbols and self.isymbols is not None:
                found = self.isymbols.find_id(label)
                if found is not None:
                    return found
            return str(label)

        def osym(label: int) -> str:
            if use_symbols and self.osymbols is not None:
                found = self.osymbols.find_id(label)
                if found is not None:
                    return found
            return str(label)

        for old in order:
            for il, ol, w, ns in self.arcs[old]:
                fields = [str(remap[old]), str(remap[ns]), isym(il)]
                if not acceptor:
                    fields.append(osym(ol))
                if w != 0.0:
                    fields.append(_format_weight(w))
                print("\t".join(fields), file=fileobj)

        for old in order:
            if self.finals[old] != INF:
                if self.finals[old] != 0.0:
                    print(
                        f"{remap[old]}\t{_format_weight(self.finals[old])}",
                        file=fileobj,
                    )
                else:
                    print(remap[old], file=fileobj)

    # -- language enumeration (for tests) -----------------------------------

    def paths(
        self, max_paths: int = 100000
    ) -> List[Tuple[List[int], List[int], float]]:
        """Enumerate all accepted (input, output, weight) paths. Only valid
        for acyclic FSTs (raises RecursionError-equivalent guard otherwise)."""
        results: List[Tuple[List[int], List[int], float]] = []
        if self.start < 0:
            return results

        stack: List[Tuple[int, List[int], List[int], float, frozenset]] = [
            (self.start, [], [], 0.0, frozenset([self.start]))
        ]
        while stack:
            state, ipath, opath, weight, visited = stack.pop()
            if self.finals[state] != INF:
                results.append((ipath, opath, weight + self.finals[state]))
                if len(results) > max_paths:
                    raise ValueError("Too many paths")
            for il, ol, w, ns in self.arcs[state]:
                if ns in visited:
                    continue  # cut cycles: enumerate only simple paths
                new_ipath = ipath + ([il] if il != EPS_ID else [])
                new_opath = opath + ([ol] if ol != EPS_ID else [])
                stack.append((ns, new_ipath, new_opath, weight + w, visited | {ns}))
                if len(stack) > 10 * max_paths:
                    raise ValueError("Path explosion (cyclic FST?)")
        return results


def _format_weight(w: float) -> str:
    if w == int(w) and abs(w) < 1e15:
        return str(w)
    return repr(w)
