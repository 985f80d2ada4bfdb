"""In-memory textual FST used by the grammar compiler.

The *external contracts* follow the reference's template-FST layer
(rhasspy_speech/hassil_fst.py:28-34,849-876): word arcs carry
``WORD_PENALTY``, ``<space>`` tokens mark word boundaries in the char-level
build, and output-side metadata rides as base32 ``__output:`` /
``__sentence_output:`` labels that survive decoding and are resolved by
:func:`decode_meta`. Those labels are the public output format of the whole
system, so the encode/decode scheme is kept bit-identical.

The *implementation* is our own design:

- word merging (:meth:`Fst.remove_spaces`) is an anchor-graph construction —
  every ``<space>`` arc of the char-level FST becomes one state ("anchor") of
  the word-level FST, and word arcs are discovered by walking char segments
  between anchors with a small cursor record — rather than a recursive
  per-arc walk;
- pruning is reverse reachability from the final states in one pass;
- language enumeration (:meth:`to_strings` / :meth:`to_tokens`) is an
  explicit-stack traversal, safe for full-scale grammars (thousands of
  sentences) where recursion would overflow.
"""

from __future__ import annotations

import base64
import json
import re
from collections import defaultdict
from dataclasses import dataclass, field
from enum import Enum, auto
from typing import Dict, List, Optional, Set, TextIO, Tuple

EPS = "<eps>"
SPACE = "<space>"
BEGIN_OUTPUT = "__begin_output:"
END_OUTPUT = "__end_output"
SENTENCE_OUTPUT = "__sentence_output:"
OUTPUT_PREFIX = "__output:"
WORD_PENALTY = 0.03


class SuppressOutput(Enum):
    """Output-suppression mode while merging char/word chunks."""

    DISABLED = auto()
    UNTIL_END = auto()
    UNTIL_SPACE = auto()


@dataclass
class FstArc:
    to_state: int
    in_label: str = EPS
    out_label: str = EPS
    log_prob: Optional[float] = None


@dataclass
class _Cursor:
    """Walk position inside one char segment during space removal.

    ``node`` is the char-FST state whose outgoing arcs are explored next;
    ``emit_at`` is the word-FST state new arcs hang off; ``fragment``
    accumulates the spoken word since the last boundary; ``pending_out`` is an
    output label waiting to be released at the next boundary; ``mode`` is the
    output-suppression mode.
    """

    node: int
    emit_at: int
    fragment: str = ""
    pending_out: Optional[str] = None
    mode: SuppressOutput = SuppressOutput.DISABLED


@dataclass
class Fst:
    arcs: Dict[int, List[FstArc]] = field(default_factory=lambda: defaultdict(list))
    states: Set[int] = field(default_factory=lambda: {0})
    final_states: Set[int] = field(default_factory=set)
    words: Set[str] = field(default_factory=set)
    output_words: Set[str] = field(default_factory=set)
    start: int = 0
    current_state: int = 0

    # -- construction -------------------------------------------------------

    def next_state(self) -> int:
        self.states.add(self.current_state)
        self.current_state += 1
        return self.current_state

    def add_edge(
        self,
        from_state: int,
        to_state: int,
        in_label: Optional[str] = None,
        out_label: Optional[str] = None,
        log_prob: Optional[float] = None,
    ) -> None:
        in_label = EPS if in_label is None else in_label
        out_label = in_label if out_label is None else out_label

        for label in (in_label, out_label):
            if (not label) or (" " in label):
                raise ValueError(
                    f"Bad FST label {label!r} (empty or contains whitespace) "
                    f"on arc {in_label!r}:{out_label!r}"
                )

        if in_label != EPS:
            self.words.add(in_label)
        if out_label != EPS:
            self.output_words.add(out_label)

        self.states.add(from_state)
        self.states.add(to_state)
        self.arcs[from_state].append(FstArc(to_state, in_label, out_label, log_prob))

    def next_edge(
        self,
        from_state: int,
        in_label: Optional[str] = None,
        out_label: Optional[str] = None,
        log_prob: Optional[float] = None,
    ) -> int:
        to_state = self.next_state()
        self.add_edge(from_state, to_state, in_label, out_label, log_prob)
        return to_state

    def accept(self, state: int) -> None:
        self.states.add(state)
        self.final_states.add(state)

    # -- serialization ------------------------------------------------------

    def _arc_lines(self):
        for state in self.arcs:
            for arc in self.arcs[state]:
                head = f"{state} {arc.to_state} {arc.in_label} {arc.out_label}"
                yield head if arc.log_prob is None else f"{head} {arc.log_prob}"
        for state in self.final_states:
            yield str(state)

    def write(self, fst_file: TextIO, symbols_file: Optional[TextIO] = None) -> None:
        """Write AT&T-style text FST lines (and optionally a symbol table)."""
        for line in self._arc_lines():
            fst_file.write(line + "\n")

        if symbols_file is not None:
            symbols: Dict[str, int] = {EPS: 0}
            for state_arcs in self.arcs.values():
                for arc in state_arcs:
                    symbols.setdefault(arc.in_label, len(symbols))
                    symbols.setdefault(arc.out_label, len(symbols))
            for symbol, symbol_id in symbols.items():
                symbols_file.write(f"{symbol} {symbol_id}\n")

    # -- space removal ------------------------------------------------------

    def remove_spaces(self) -> "Fst":
        """Build the word-level FST from this char-level one.

        Anchor-graph construction: the word FST has one state per ``<space>``
        arc of this FST (plus one lane state per sentence-start arc). A word
        arc connects two anchors when some char path joins them; its input is
        the concatenated chars, its output follows the metadata-marker rules
        (``__begin_output``/``__end_output`` suppress spoken output and
        release a recorded ``__output:`` label instead; word-level overrides —
        e.g. number words carrying digit outputs — release at the next
        boundary). Every non-empty word arc gets :data:`WORD_PENALTY`.
        """
        merged = Fst()
        # Identity of a <space> arc (src, dst, index) -> its anchor state.
        anchors: Dict[Tuple[int, int, int], int] = {}

        for head in self.arcs[self.start]:
            # One lane per sentence; keeps the sentence weight (if any).
            lane = merged.next_edge(merged.start, log_prob=head.log_prob)
            self._merge_segments(head.to_state, lane, merged, anchors)

        return merged

    def _merge_segments(
        self,
        node: int,
        lane: int,
        merged: "Fst",
        anchors: Dict[Tuple[int, int, int], int],
    ) -> None:
        stack: List[_Cursor] = [_Cursor(node=node, emit_at=lane)]
        while stack:
            cursor = stack.pop()
            followups: List[_Cursor] = []
            for idx, arc in enumerate(self.arcs[cursor.node]):
                nxt = self._step_segment(cursor, arc, idx, merged, anchors)
                if nxt is not None:
                    followups.append(nxt)
            stack.extend(reversed(followups))  # preserve arc order (pre-order)

    def _step_segment(
        self,
        cursor: _Cursor,
        arc: FstArc,
        arc_idx: int,
        merged: "Fst",
        anchors: Dict[Tuple[int, int, int], int],
    ) -> Optional[_Cursor]:
        """Advance one char arc; emit a word arc at boundaries.

        Returns the continuation cursor, or None when the walk stops here
        (boundary already expanded from an earlier visit).
        """
        if arc.in_label == SPACE:
            spoken = cursor.fragment or EPS
            if cursor.mode is SuppressOutput.DISABLED:
                written, pending = spoken, cursor.pending_out
            else:
                written, pending = cursor.pending_out or EPS, None
            weight = WORD_PENALTY if spoken != EPS else None

            key = (cursor.node, arc.to_state, arc_idx)
            known = anchors.get(key)
            if known is not None:
                merged.add_edge(cursor.emit_at, known, spoken, written, weight)
                return None  # segment graph beyond this anchor already built

            landing = merged.next_edge(cursor.emit_at, spoken, written, weight)
            anchors[key] = landing
            if arc.to_state in self.final_states:
                merged.final_states.add(landing)

            mode = cursor.mode
            if mode is SuppressOutput.UNTIL_SPACE:
                mode = SuppressOutput.DISABLED
            return _Cursor(arc.to_state, landing, "", pending, mode)

        fragment = cursor.fragment
        pending = cursor.pending_out
        mode = cursor.mode
        emit_at = cursor.emit_at

        if arc.in_label != EPS:
            fragment += arc.in_label
            if (
                mode is SuppressOutput.DISABLED
                and arc.out_label not in (EPS, arc.in_label)
            ):
                # Word-level output override (e.g. number words -> digits)
                mode = SuppressOutput.UNTIL_SPACE
                pending = arc.out_label

        marker = arc.out_label
        if marker.startswith(BEGIN_OUTPUT):
            mode = SuppressOutput.UNTIL_END
        elif marker.startswith(END_OUTPUT):
            mode = SuppressOutput.UNTIL_SPACE
        elif marker.startswith(SENTENCE_OUTPUT):
            # Sentence-level outputs are interposed on the word FST directly.
            emit_at = merged.next_edge(emit_at, EPS, marker)
        elif marker.startswith(OUTPUT_PREFIX):
            pending = marker

        return _Cursor(arc.to_state, emit_at, fragment, pending, mode)

    # -- pruning ------------------------------------------------------------

    def prune(self) -> None:
        """Drop states that cannot reach any final state (dead branches)."""
        # Reverse adjacency
        incoming: Dict[int, List[int]] = defaultdict(list)
        for state, state_arcs in self.arcs.items():
            for arc in state_arcs:
                incoming[arc.to_state].append(state)

        alive: Set[int] = set(self.final_states)
        frontier = list(self.final_states)
        while frontier:
            state = frontier.pop()
            for pred in incoming[state]:
                if pred not in alive:
                    alive.add(pred)
                    frontier.append(pred)

        dead = self.states - alive
        if not dead:
            return

        self.states = alive
        for state in dead:
            self.arcs.pop(state, None)

        for state in self.states:
            state_arcs = self.arcs[state]
            if any(arc.to_state in dead for arc in state_arcs):
                self.arcs[state] = [a for a in state_arcs if a.to_state not in dead]

    # -- enumeration --------------------------------------------------------

    def to_strings(self, add_spaces: bool) -> List[str]:
        """Enumerate the input language (normalized text strings)."""
        strings: List[str] = []
        stack: List[Tuple[int, str]] = [(self.start, "")]
        while stack:
            state, text = stack.pop()
            if state in self.final_states:
                text_norm = " ".join(text.strip().split())
                if text_norm:
                    strings.append(text_norm)

            for arc in reversed(self.arcs[state]):
                if arc.in_label == SPACE:
                    arc_text = text + " "
                elif arc.in_label != EPS:
                    arc_text = (text + " " + arc.in_label) if add_spaces else (
                        text + arc.in_label
                    )
                else:
                    arc_text = text
                stack.append((arc.to_state, arc_text))

        return strings

    def to_tokens(self, only_connected: bool = True) -> List[List[str]]:
        """Enumerate input token paths; dead-end paths included on request.

        Explicit-stack traversal (full-scale grammars exceed Python's
        recursion limit).
        """
        tokens: List[List[str]] = []
        stack: List[Tuple[int, Tuple[str, ...]]] = [(self.start, ())]
        while stack:
            state, path = stack.pop()
            if path and state in self.final_states:
                tokens.append(list(path))

            state_arcs = self.arcs[state]
            if path and (not state_arcs) and (not only_connected):
                tokens.append(list(path))  # dead-end path
                continue

            for arc in reversed(state_arcs):
                if (arc.in_label == EPS) or (arc.in_label == SPACE and not path):
                    stack.append((arc.to_state, path))
                else:
                    stack.append((arc.to_state, path + (arc.in_label.strip(),)))

        for path in tokens:
            if path and path[-1] == SPACE:
                path.pop()

        return tokens


# ---------------------------------------------------------------------------
# Metadata labels: base32 payloads on the FST output side
# ---------------------------------------------------------------------------

_META_B32 = "([0-9A-Z=]+)"


def encode_meta(text: str, prefix: str = OUTPUT_PREFIX) -> str:
    """Encode output metadata as a single FST-safe label."""
    return prefix + base64.b32encode(text.encode("utf-8")).strip().decode("utf-8")


def decode_meta_single(text: str) -> str:
    return base64.b32decode(text.encode("utf-8")).strip().decode("utf-8")


def decode_meta(text: str) -> str:
    """Resolve metadata labels in decoded text to the final output string.

    ``__output:<b32 json>`` labels substitute their slot text (recording slot
    values); a trailing ``__sentence_output:<b32>`` label replaces the whole
    sentence, with ``{slot}`` placeholders filled from the recorded slots.
    """
    slots: Dict[str, str] = {}

    def handle_output(match: re.Match) -> str:
        data = json.loads(decode_meta_single(match.group(1)))
        slot_value = data["text"]
        slot_name = data.get("list")
        if slot_name:
            slots[slot_name] = slot_value
        return slot_value

    text = re.sub(re.escape(OUTPUT_PREFIX) + _META_B32, handle_output, text)

    sentence_match = re.search(re.escape(SENTENCE_OUTPUT) + _META_B32, text)
    if sentence_match is None:
        return text

    return decode_meta_single(sentence_match.group(1)).format(**slots)
