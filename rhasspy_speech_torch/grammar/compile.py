"""Template → grammar-FST compiler.

Produces the same surface behavior as the reference compiler
(rhasspy_speech/hassil_fst.py:374-846, intent_fst.py:26-47):
alternatives/optionals become branch/merge states, text slot lists expand with
context filtering and output-value metadata, range lists expand through the
number engine, output overrides ride the FST output side as base32 meta
labels, and wildcard lists leave dead marker branches for :meth:`Fst.prune`.

The design is our own two-pass compiler:

1. **Resolve** (:class:`_Resolver`): the parsed template tree — which still
   contains list references, rule references, and raw text — is lowered to a
   closed intermediate form (:class:`_Lit` / :class:`_Cat` / :class:`_Union` /
   :class:`_Capture` / :class:`_Dead`). All name resolution, context
   filtering, number expansion, and G2P word splitting happen here; the IR
   contains only speakable tokens and output annotations.
2. **Emit** (:class:`_Emitter`): the IR is walked once to lay down char-level
   states and arcs, including the ``<space>``/meta-marker conventions the
   word merger (:meth:`Fst.remove_spaces`) consumes.

Quirks of the reference that are deliberately preserved (pinned by the parity
tests): an empty alternative item adds no skip arc unless the group is marked
optional; sentence-level output suppression applies only to literal chunks
reached without crossing a sequence node; casing applies to the spoken side
only, so re-cased tokens carry their original casing as an output override.
"""

from __future__ import annotations

import json
import logging
import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, TextIO, Tuple, Union

from ..const import WordCasing
from ..lexicon.g2p import LexiconDatabase, split_words
from .expression import (
    Expression,
    ListReference,
    RangeSlotList,
    RuleReference,
    Sequence,
    SequenceType,
    SlotList,
    TextChunk,
    TextSlotList,
)
from .fst import (
    BEGIN_OUTPUT,
    END_OUTPUT,
    EPS,
    SENTENCE_OUTPUT,
    SPACE,
    Fst,
    encode_meta,
)
from .intents import (
    IntentData,
    Intents,
    check_excluded_context,
    check_required_context,
)
from .numbers import NumberEngine

_LOGGER = logging.getLogger(__name__)


@dataclass
class NumToWords:
    """Number engine plus a per-compile cache of expanded ranges."""

    engine: NumberEngine
    cache: Dict[tuple, "_Union"] = field(default_factory=dict)


@dataclass
class G2PInfo:
    lexicon: LexiconDatabase
    casing_func: Callable[[str], str] = field(default=lambda s: s)


@dataclass
class ExpressionWithOutput:
    """An expression whose decoded output text differs from its spoken text."""

    expression: Expression
    output_text: str
    list_name: Optional[str] = None


# ---------------------------------------------------------------------------
# Intermediate form
# ---------------------------------------------------------------------------


@dataclass
class _Token:
    """One speakable word: spoken form plus the output label it decodes to
    (None mirrors the spoken form; EPS suppresses it)."""

    spoken: str
    written: Optional[str] = None


@dataclass
class _Lit:
    """A literal run of tokens from one text chunk."""

    tokens: List[_Token]
    pad_left: bool = False
    pad_right: bool = False
    lone_space: bool = False


@dataclass
class _Cat:
    parts: List["_Node"]


@dataclass
class _Union:
    choices: List["_Node"]
    skippable: bool = False


@dataclass
class _Capture:
    """A region whose decoded output is replaced by a meta payload."""

    inner: "_Node"
    payload: str  # pre-encoded __output: meta label


@dataclass
class _Dead:
    """A branch that can never match; an optional marker arc records why
    (wildcard lists show up in ``to_tokens(only_connected=False)``)."""

    marker: Optional[str] = None


_Node = Union[_Lit, _Cat, _Union, _Capture, _Dead]


# ---------------------------------------------------------------------------
# Pass 1: resolve templates to the closed IR
# ---------------------------------------------------------------------------


class _Resolver:
    """Resolves one intent-data block's expressions into IR nodes."""

    def __init__(
        self,
        intents: Intents,
        intent_data: IntentData,
        slot_lists: Optional[Dict[str, SlotList]],
        num_to_words: Optional[NumToWords],
        g2p_info: Optional[G2PInfo],
    ) -> None:
        self.intents = intents
        self.data = intent_data
        self.extra_lists = slot_lists or {}
        self.numbers = num_to_words
        self.g2p = g2p_info

    # -- dispatch ------------------------------------------------------------

    def resolve(self, expression: Union[Expression, ExpressionWithOutput]) -> _Node:
        if isinstance(expression, ExpressionWithOutput):
            payload: Dict[str, str] = {"text": expression.output_text}
            if expression.list_name:
                payload["list"] = expression.list_name
            return _Capture(
                inner=self.resolve(expression.expression),
                payload=encode_meta(json.dumps(payload)),
            )
        if isinstance(expression, TextChunk):
            return self._chunk(expression)
        if isinstance(expression, Sequence):
            return self._sequence(expression)
        if isinstance(expression, ListReference):
            return self._list_reference(expression)
        if isinstance(expression, RuleReference):
            return self._rule_reference(expression)
        return _Lit(tokens=[])  # unknown node: matches the empty string

    # -- literals ------------------------------------------------------------

    def _chunk(self, chunk: TextChunk) -> _Lit:
        raw = chunk.original_text or ""
        if raw == " ":
            return _Lit(tokens=[], lone_space=True)

        stripped = raw.strip()
        if not stripped:
            return _Lit(tokens=[])

        if self.g2p is not None:
            engine = self.numbers.engine if self.numbers is not None else None
            pieces = split_words(stripped, self.g2p.lexicon, engine)
        else:
            pieces = stripped.split()

        tokens: List[_Token] = []
        for piece in pieces:
            if isinstance(piece, str):
                spoken, written = piece, piece
            else:
                spoken, written = piece[0], piece[1] or EPS
            if self.g2p is not None:
                spoken = self.g2p.casing_func(spoken)
            tokens.append(_Token(spoken, None if written == spoken else written))

        return _Lit(
            tokens=tokens,
            pad_left=raw.startswith(" "),
            pad_right=raw.endswith(" "),
        )

    # -- structure -----------------------------------------------------------

    def _sequence(self, seq: Sequence) -> _Node:
        resolved = [self.resolve(item) for item in seq.items]
        if seq.type == SequenceType.ALTERNATIVE:
            return _Union(choices=resolved, skippable=seq.is_optional)
        return _Cat(parts=resolved)

    def _rule_reference(self, ref: RuleReference) -> _Node:
        body = self.data.expansion_rules.get(ref.rule_name)
        if body is None:
            body = self.intents.expansion_rules.get(ref.rule_name)
        if body is None:
            raise ValueError(f"Missing expansion rule <{ref.rule_name}>")
        return self.resolve(body)

    # -- slot lists ----------------------------------------------------------

    def _find_list(self, name: str) -> Optional[SlotList]:
        for table in (self.extra_lists, self.data.slot_lists, self.intents.slot_lists):
            found = table.get(name)
            if found is not None:
                return found
        return None

    def _list_reference(self, ref: ListReference) -> _Node:
        slot_list = self._find_list(ref.list_name)

        if isinstance(slot_list, TextSlotList):
            return self._text_list(ref, slot_list)
        if isinstance(slot_list, RangeSlotList):
            return self._range_list(ref, slot_list)

        # Wildcard/unknown list: leave a dead marker branch.
        return _Dead(marker=f"{{{ref.list_name}}}")

    def _value_allowed(self, context: Optional[Dict]) -> bool:
        required = self.data.requires_context
        if required is not None and not check_required_context(
            required, context, allow_missing_keys=True
        ):
            return False
        excluded = self.data.excludes_context
        if excluded is not None and not check_excluded_context(excluded, context):
            return False
        return True

    def _text_list(self, ref: ListReference, slot_list: TextSlotList) -> _Node:
        choices: List[_Node] = []
        for value in slot_list.values:
            if not self._value_allowed(value.context):
                continue

            decoded: Optional[str] = None
            if isinstance(value.text_in, TextChunk):
                decoded = value.text_in.text
            elif value.value_out is not None:
                decoded = str(value.value_out)

            wrapped: Union[Expression, ExpressionWithOutput] = value.text_in
            if decoded:
                wrapped = ExpressionWithOutput(
                    value.text_in, output_text=decoded, list_name=ref.slot_name
                )
            choices.append(self.resolve(wrapped))

        if not choices:
            return _Dead()
        return _Union(choices=choices)

    def _range_list(self, ref: ListReference, slot_list: RangeSlotList) -> _Node:
        if self.numbers is None:
            return _Dead()

        # Unlike the reference (hassil_fst.py:600-607) the cache key includes
        # the slot name: the payload records it, so two same-bounds ranges
        # bound to different slots must not share IR.
        key = (ref.slot_name, slot_list.start, slot_list.stop + 1, slot_list.step)
        cached = self.numbers.cache.get(key)
        if cached is not None:
            return cached

        choices: List[_Node] = []
        for number in range(slot_list.start, slot_list.stop + 1, slot_list.step):
            digits = str(number)
            result = self.numbers.engine.format_number(number)
            spellings = {w.replace("-", " ") for w in result.text_by_ruleset.values()}
            for spelling in spellings:
                payload = {"text": digits}
                if ref.slot_name:
                    payload["list"] = ref.slot_name
                choices.append(
                    _Capture(
                        inner=self._chunk(TextChunk(text=spelling)),
                        payload=encode_meta(json.dumps(payload)),
                    )
                )

        node = _Union(choices=choices) if choices else _Dead()
        if isinstance(node, _Union):
            self.numbers.cache[key] = node
        return node


# ---------------------------------------------------------------------------
# Pass 2: emit the char-level FST
# ---------------------------------------------------------------------------


class _Emitter:
    """Walks the IR once, laying down char-level states and arcs."""

    def __init__(self, fst: Fst) -> None:
        self.fst = fst

    def emit(self, node: _Node, state: int, suppress: bool = False) -> Optional[int]:
        """Emit ``node`` starting at ``state``; returns the end state, or
        None when the branch is dead (emission stops, prune() cleans up)."""
        if isinstance(node, _Lit):
            return self._emit_lit(node, state, suppress)

        if isinstance(node, _Cat):
            # Sequence nodes do not forward suppression (reference quirk).
            for part in node.parts:
                next_state = self.emit(part, state)
                if next_state is None:
                    return None
                state = next_state
            return state

        if isinstance(node, _Union):
            fork = state
            join = self.fst.next_state()
            for choice in node.choices:
                tail = self.emit(choice, fork)
                if tail is None or tail == fork:
                    # Dead or empty choice: contributes no join arc.
                    continue
                self.fst.add_edge(tail, join)
            if node.skippable:
                self.fst.add_edge(fork, join)
            return join

        if isinstance(node, _Capture):
            state = self.fst.next_edge(state, EPS, BEGIN_OUTPUT)
            state = self.fst.next_edge(state, EPS, node.payload)
            inner_end = self.emit(node.inner, state, suppress)
            if inner_end is None:
                return None
            return self.fst.next_edge(inner_end, EPS, END_OUTPUT)

        # _Dead: record the marker (if any) and kill the branch.
        if node.marker is not None:
            self.fst.next_edge(state, node.marker, node.marker)
        return None

    def _emit_lit(self, lit: _Lit, state: int, suppress: bool) -> int:
        if lit.lone_space:
            return self.fst.next_edge(state, SPACE)
        if not lit.tokens:
            return state

        if lit.pad_left:
            state = self.fst.next_edge(state, SPACE)

        for idx, token in enumerate(lit.tokens):
            if idx:
                state = self.fst.next_edge(state, SPACE)
            written = EPS if suppress else token.written
            state = self.fst.next_edge(state, token.spoken, written)

        if lit.pad_right:
            state = self.fst.next_edge(state, SPACE)
        return state


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------


def expression_to_fst(
    expression: Union[Expression, ExpressionWithOutput],
    state: int,
    fst: Fst,
    intent_data: IntentData,
    intents: Intents,
    slot_lists: Optional[Dict[str, SlotList]] = None,
    num_to_words: Optional[NumToWords] = None,
    g2p_info: Optional[G2PInfo] = None,
    suppress_output: bool = False,
) -> Optional[int]:
    """Lower one expression; returns the end state or None for dead branches."""
    resolver = _Resolver(intents, intent_data, slot_lists, num_to_words, g2p_info)
    return _Emitter(fst).emit(resolver.resolve(expression), state, suppress_output)


def get_count(e: Expression, intents: Intents, intent_data: IntentData) -> int:
    """Number of sentences the expression expands to."""
    if isinstance(e, Sequence):
        counts = (get_count(item, intents, intent_data) for item in e.items)
        if e.type == SequenceType.ALTERNATIVE:
            return sum(counts)
        return math.prod(counts)

    if isinstance(e, ListReference):
        slot_list = intent_data.slot_lists.get(e.list_name) or intents.slot_lists.get(
            e.list_name
        )
        if isinstance(slot_list, TextSlotList):
            return sum(
                get_count(v.text_in, intents, intent_data) for v in slot_list.values
            )
        if isinstance(slot_list, RangeSlotList):
            return len(range(slot_list.start, slot_list.stop + 1, slot_list.step))

    if isinstance(e, RuleReference):
        rule_body = intent_data.expansion_rules.get(
            e.rule_name
        ) or intents.expansion_rules.get(e.rule_name)
        if rule_body:
            return get_count(rule_body, intents, intent_data)

    return 1


def intents_to_fst(
    intents: Intents,
    slot_lists: Optional[Dict[str, SlotList]] = None,
    number_language: Optional[str] = None,
    exclude_intents: Optional[Set[str]] = None,
    include_intents: Optional[Set[str]] = None,
    g2p_info: Optional[G2PInfo] = None,
) -> Fst:
    """Compile all (selected) intents into one char-level grammar FST."""
    num_to_words: Optional[NumToWords] = None
    if number_language:
        try:
            num_to_words = NumToWords(engine=NumberEngine.for_language(number_language))
        except ValueError:
            _LOGGER.exception("Unable to convert numbers to words")

    def selected(name: str) -> bool:
        if exclude_intents is not None and name in exclude_intents:
            return False
        if include_intents is not None and name not in include_intents:
            return False
        return True

    chosen = [it for it in intents.intents.values() if selected(it.name)]

    total_sentences = sum(
        get_count(sentence, intents, data)
        for intent in chosen
        for data in intent.data
        for sentence in data.sentences
    )
    _LOGGER.debug("Total sentences: %s", total_sentences)

    fst = Fst()
    final = fst.next_state()
    emitter = _Emitter(fst)

    for intent in chosen:
        for data in intent.data:
            resolver = _Resolver(intents, data, slot_lists, num_to_words, g2p_info)

            sentence_output: Optional[str] = None
            if data.metadata is not None:
                sentence_output = data.metadata.get("output")

            for sentence in data.sentences:
                head = fst.next_edge(fst.start, SPACE, SPACE)
                if sentence_output:
                    head = fst.next_edge(
                        head, EPS, encode_meta(sentence_output, SENTENCE_OUTPUT)
                    )

                tail = emitter.emit(
                    resolver.resolve(sentence),
                    head,
                    suppress=(sentence_output is not None),
                )
                if tail is not None:
                    fst.add_edge(tail, final, SPACE, SPACE)

    fst.accept(final)
    return fst


# ---------------------------------------------------------------------------
# Context wrapper (reference: intent_fst.py:17-47)
# ---------------------------------------------------------------------------


@dataclass
class IntentsToFstContext:
    """Compiled grammar: text FST stream + vocab + output-only meta labels."""

    fst_file: TextIO
    lexicon: LexiconDatabase
    vocab: Set[str] = field(default_factory=set)
    meta_labels: Set[str] = field(default_factory=set)
    word_casing: WordCasing = WordCasing.LOWER


def compile_intents(
    intents: Intents,
    fst_file: TextIO,
    lexicon: LexiconDatabase,
    number_language: Optional[str] = None,
    word_casing: WordCasing = WordCasing.LOWER,
) -> IntentsToFstContext:
    """Compile templates to a written text FST plus vocab/meta-label sets."""
    fst = intents_to_fst(
        intents,
        number_language=number_language,
        g2p_info=G2PInfo(lexicon, WordCasing.get_function(word_casing)),
    ).remove_spaces()
    fst.prune()

    context = IntentsToFstContext(
        fst_file=fst_file, lexicon=lexicon, word_casing=word_casing
    )
    fst.write(context.fst_file)
    context.fst_file.seek(0)
    context.vocab = set(fst.words)
    context.meta_labels = fst.output_words - fst.words
    return context
