"""Expression tree for sentence templates.

This is our stand-in for the external ``hassil`` package the reference builds
on (see rhasspy_speech/hassil_fst.py:13-23 for the symbols it
imports). We implement the same data model natively: templates like
``turn (on|off) [the] {name}`` parse into a tree of TextChunk / Sequence /
ListReference / RuleReference nodes, which the grammar compiler lowers into an
FST and the sampler enumerates into sentences.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum, auto
from typing import Any, Dict, List, Optional, Union


class SequenceType(Enum):
    GROUP = auto()
    ALTERNATIVE = auto()


@dataclass
class Expression:
    """Base class for template expression nodes."""


@dataclass
class TextChunk(Expression):
    """Literal text. ``original_text`` preserves surrounding whitespace,
    which drives word-boundary (<space>) placement in the FST."""

    text: str = ""
    original_text: Optional[str] = None

    def __post_init__(self) -> None:
        if self.original_text is None:
            self.original_text = self.text

    @property
    def is_empty(self) -> bool:
        return not self.text.strip()


@dataclass
class Sequence(Expression):
    """Group (concatenation) or alternative (union) of sub-expressions."""

    items: List[Expression] = field(default_factory=list)
    type: SequenceType = SequenceType.GROUP
    is_optional: bool = False

    @property
    def text_chunk_count(self) -> int:
        return sum(1 for item in self.items if isinstance(item, TextChunk))


@dataclass
class ListReference(Expression):
    """``{list}`` or ``{list:slot}``."""

    list_name: str = ""
    slot_name: Optional[str] = None

    def __post_init__(self) -> None:
        if not self.slot_name:
            self.slot_name = self.list_name


@dataclass
class RuleReference(Expression):
    """``<rule>`` expansion-rule reference."""

    rule_name: str = ""


@dataclass
class Sentence(Sequence):
    """A parsed top-level template (a GROUP sequence with its source text)."""

    text: Optional[str] = None


# ---------------------------------------------------------------------------
# Slot lists
# ---------------------------------------------------------------------------


@dataclass
class SlotList:
    name: Optional[str] = None


@dataclass
class TextSlotValue:
    """One value of a text slot list: spoken form, output value, context."""

    text_in: Expression = field(default_factory=TextChunk)
    value_out: Optional[Any] = None
    context: Optional[Dict[str, Any]] = None
    metadata: Optional[Dict[str, Any]] = None


@dataclass
class TextSlotList(SlotList):
    values: List[TextSlotValue] = field(default_factory=list)


@dataclass
class RangeSlotList(SlotList):
    start: int = 0
    stop: int = 0
    step: int = 1


@dataclass
class WildcardSlotList(SlotList):
    """Open-ended wildcard list; cannot be expanded (pruned from grammars)."""


SlotListType = Union[TextSlotList, RangeSlotList, WildcardSlotList]
