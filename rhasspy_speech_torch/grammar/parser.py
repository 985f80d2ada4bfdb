"""Parser for sentence-template syntax.

Grammar (the same surface syntax the reference consumes via ``hassil``):

    template     := item*
    item         := text | group | optional | list_ref | rule_ref
    group        := "(" alternative ")"
    optional     := "[" alternative "]"        # adds an empty alternative
    alternative  := sequence ("|" sequence)*
    list_ref     := "{" name (":" slot)? "}"
    rule_ref     := "<" name ">"

Text chunks preserve their original whitespace; the grammar compiler uses
leading/trailing spaces to place word boundaries (see grammar/compile.py).
"""

from __future__ import annotations

from typing import List

from .expression import (
    Expression,
    Sentence,
    Sequence,
    SequenceType,
    TextChunk,
    ListReference,
    RuleReference,
)

GROUP_START = "("
GROUP_END = ")"
OPT_START = "["
OPT_END = "]"
LIST_START = "{"
LIST_END = "}"
RULE_START = "<"
RULE_END = ">"
ALT_SEP = "|"
ESCAPE = "\\"

_TEMPLATE_CHARS = frozenset("(){}<>[]|")


class ParseError(Exception):
    pass


def is_template(text: str) -> bool:
    """True if the text contains template syntax (needs expansion)."""
    return any(c in _TEMPLATE_CHARS for c in text)


class _Scanner:
    __slots__ = ("text", "pos")

    def __init__(self, text: str) -> None:
        self.text = text
        self.pos = 0

    def peek(self) -> str:
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def advance(self) -> str:
        c = self.text[self.pos]
        self.pos += 1
        return c

    @property
    def done(self) -> bool:
        return self.pos >= len(self.text)


def parse_sentence(text: str) -> Sentence:
    """Parse one template line into a Sentence (a GROUP sequence)."""
    scanner = _Scanner(text)
    items = _parse_sequence_items(scanner, stop_chars="")
    if not scanner.done:
        raise ParseError(f"Unbalanced '{scanner.peek()}' at {scanner.pos}: {text}")

    return Sentence(items=items, type=SequenceType.GROUP, text=text)


def _parse_sequence_items(scanner: _Scanner, stop_chars: str) -> List[Expression]:
    items: List[Expression] = []
    text_parts: List[str] = []

    def flush_text() -> None:
        if text_parts:
            chunk_text = "".join(text_parts)
            items.append(TextChunk(text=chunk_text))
            text_parts.clear()

    while not scanner.done:
        c = scanner.peek()
        if c in stop_chars:
            break

        if c == ESCAPE:
            scanner.advance()
            if not scanner.done:
                text_parts.append(scanner.advance())
            continue

        if c == GROUP_START:
            scanner.advance()
            flush_text()
            items.append(_parse_alternative(scanner, GROUP_END, is_optional=False))
            _expect(scanner, GROUP_END)
        elif c == OPT_START:
            scanner.advance()
            flush_text()
            items.append(_parse_alternative(scanner, OPT_END, is_optional=True))
            _expect(scanner, OPT_END)
        elif c == LIST_START:
            scanner.advance()
            flush_text()
            items.append(_parse_reference(scanner, LIST_END, kind="list"))
        elif c == RULE_START:
            scanner.advance()
            flush_text()
            items.append(_parse_reference(scanner, RULE_END, kind="rule"))
        elif c in (GROUP_END, OPT_END, LIST_END, RULE_END):
            raise ParseError(f"Unexpected '{c}' at {scanner.pos}: {scanner.text}")
        else:
            text_parts.append(scanner.advance())

    flush_text()
    return items


def _parse_alternative(
    scanner: _Scanner, end_char: str, is_optional: bool
) -> Sequence:
    alternatives: List[Expression] = []
    saw_separator = False

    while True:
        items = _parse_sequence_items(scanner, stop_chars=end_char + ALT_SEP)
        if len(items) == 1:
            alternatives.append(items[0])
        else:
            alternatives.append(Sequence(items=items, type=SequenceType.GROUP))

        if scanner.peek() == ALT_SEP:
            scanner.advance()
            saw_separator = True
            continue

        break

    if is_optional:
        # Optionals always admit the empty string.
        alternatives.append(TextChunk(text=""))
        return Sequence(
            items=alternatives, type=SequenceType.ALTERNATIVE, is_optional=True
        )

    if not saw_separator:
        # Plain parenthesized group
        only = alternatives[0]
        if isinstance(only, Sequence) and only.type == SequenceType.GROUP:
            return only
        return Sequence(items=[only], type=SequenceType.GROUP)

    return Sequence(items=alternatives, type=SequenceType.ALTERNATIVE)


def _parse_reference(scanner: _Scanner, end_char: str, kind: str) -> Expression:
    name_parts: List[str] = []
    while not scanner.done and scanner.peek() != end_char:
        name_parts.append(scanner.advance())

    _expect(scanner, end_char)
    name = "".join(name_parts).strip()
    if not name:
        raise ParseError(f"Empty {kind} reference in: {scanner.text}")

    if kind == "rule":
        return RuleReference(rule_name=name)

    if ":" in name:
        list_name, slot_name = name.split(":", maxsplit=1)
        return ListReference(list_name=list_name.strip(), slot_name=slot_name.strip())

    return ListReference(list_name=name)


def _expect(scanner: _Scanner, char: str) -> None:
    if scanner.done or scanner.peek() != char:
        raise ParseError(f"Expected '{char}' at {scanner.pos}: {scanner.text}")
    scanner.advance()
