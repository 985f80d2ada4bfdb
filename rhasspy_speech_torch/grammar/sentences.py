"""Sentence sampler: YAML templates → (input text, output text) pairs.

Same capability as the reference sampler
(rhasspy_speech/sentences.py:29-337): expands ``sentences``
with ``lists`` (including ``range`` via the number engine) and
``expansion_rules`` into every possible (spoken, output) pair, carrying slot
values for ``{slot}`` substitution in output templates and honoring
requires/excludes context filters. Feeds the sentences DB used for
transcript scoring.

The expansion itself is our own design: a :class:`_Expander` lowers each
expression node to a list of :class:`_Expansion` records, building group
products by left-folding partial expansions instead of recursively zipping
generators. Whitespace is re-normalized at every group level (matching the
reference's observable behavior for nested groups).
"""

from __future__ import annotations

import logging
import re
import time
from collections.abc import Sequence as ABCSequence
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Tuple

from .expression import (
    Expression,
    ListReference,
    RuleReference,
    Sentence,
    Sequence,
    SequenceType,
    SlotList,
    TextChunk,
    TextSlotList,
    TextSlotValue,
)
from .intents import check_excluded_context, check_required_context
from .numbers import NumberEngine
from .parser import is_template, parse_sentence

_LOGGER = logging.getLogger(__name__)

_WHITESPACE = re.compile(r"\s+")


class MissingListError(Exception):
    pass


class MissingRuleError(Exception):
    pass


def _squash(text: str) -> str:
    """Collapse whitespace runs and strip edges (skipped optionals otherwise
    leave dangling spaces)."""
    return _WHITESPACE.sub(" ", text).strip()


@dataclass
class _Expansion:
    """One concrete expansion: spoken text, decoded output, slot values.

    ``written`` keeps the raw value type (list ``out:`` values may be ints);
    consumers stringify at join time.
    """

    spoken: str = ""
    written: Any = ""
    slots: Dict[str, Any] = field(default_factory=dict)


class _Expander:
    """Expands expression trees against slot lists and expansion rules."""

    def __init__(
        self,
        slot_lists: Optional[Dict[str, SlotList]] = None,
        expansion_rules: Optional[Dict[str, Sentence]] = None,
        requires_context: Optional[Dict[str, Any]] = None,
        excludes_context: Optional[Dict[str, Any]] = None,
    ) -> None:
        self.slot_lists = slot_lists or {}
        self.expansion_rules = expansion_rules or {}
        self.requires_context = requires_context
        self.excludes_context = excludes_context

    def expand(self, expression: Expression) -> List[_Expansion]:
        if isinstance(expression, TextChunk):
            text = expression.original_text
            return [_Expansion(spoken=text, written=text)]

        if isinstance(expression, Sequence):
            if expression.type == SequenceType.ALTERNATIVE:
                flat: List[_Expansion] = []
                for item in expression.items:
                    flat.extend(self.expand(item))
                return flat
            if expression.type == SequenceType.GROUP:
                return self._expand_group(expression.items)
            raise ValueError(f"Unexpected sequence type: {expression}")

        if isinstance(expression, ListReference):
            return self._expand_list(expression)

        if isinstance(expression, RuleReference):
            rule = self.expansion_rules.get(expression.rule_name)
            if rule is None:
                raise MissingRuleError(
                    f"Missing expansion rule <{expression.rule_name}>"
                )
            return self.expand(rule)

        raise ValueError(f"Unexpected expression: {expression}")

    def _expand_group(self, items: Iterable[Expression]) -> List[_Expansion]:
        # Left fold: the running list holds every partial product so far.
        partials: List[_Expansion] = [_Expansion()]
        for item in items:
            grown: List[_Expansion] = []
            branches = self.expand(item)
            for partial in partials:
                for branch in branches:
                    grown.append(
                        _Expansion(
                            spoken=partial.spoken + branch.spoken,
                            written=self._join_written(
                                partial.written, branch.written
                            ),
                            slots={**partial.slots, **branch.slots},
                        )
                    )
            partials = grown

        for partial in partials:
            partial.spoken = _squash(partial.spoken)
            partial.written = _squash(str(partial.written))
        return partials

    @staticmethod
    def _join_written(left: Any, right: Any) -> str:
        parts = [str(x) for x in (left, right) if x is not None]
        return "".join(parts)

    def _expand_list(self, ref: ListReference) -> List[_Expansion]:
        slot_list = self.slot_lists.get(ref.list_name)
        if slot_list is None:
            raise MissingListError(f"Missing slot list {{{ref.list_name}}}")
        if not isinstance(slot_list, TextSlotList):
            raise ValueError(f"Unexpected slot list type: {slot_list}")

        values = [v for v in slot_list.values if self._value_allowed(v.context)]
        if not values:
            _LOGGER.warning("No values for list: %s", ref.list_name)

        results: List[_Expansion] = []
        for value in values:
            for inner in self.expand(value.text_in):
                written = value.value_out or inner.written
                results.append(
                    _Expansion(
                        spoken=inner.spoken,
                        written=written,
                        slots={**inner.slots, ref.list_name: written},
                    )
                )
        return results

    def _value_allowed(self, context: Optional[Dict[str, Any]]) -> bool:
        if self.requires_context and not check_required_context(
            self.requires_context, context, allow_missing_keys=True
        ):
            return False
        if self.excludes_context and not check_excluded_context(
            self.excludes_context, context
        ):
            return False
        return True


def sample_expression_with_output(
    expression: Expression,
    slot_lists: Optional[Dict[str, SlotList]] = None,
    expansion_rules: Optional[Dict[str, Sentence]] = None,
    list_values: Optional[Dict[str, Any]] = None,
    requires_context: Optional[Dict[str, Any]] = None,
    excludes_context: Optional[Dict[str, Any]] = None,
) -> Iterable[Tuple[str, Optional[str], Dict[str, Any]]]:
    """Yield (input text, output text, slot values) for every expansion."""
    expander = _Expander(
        slot_lists, expansion_rules, requires_context, excludes_context
    )
    seed = list_values or {}
    for expansion in expander.expand(expression):
        yield (
            expansion.spoken,
            expansion.written,
            {**seed, **expansion.slots},
        )


# ---------------------------------------------------------------------------
# YAML entry point
# ---------------------------------------------------------------------------


def generate_sentences(
    sentences_yaml: Dict[str, Any], number_engine: Optional[NumberEngine] = None
) -> Iterable[Tuple[str, str]]:
    """Yield every (input text, output text) pair from a sentences YAML dict.

    YAML shape::

        sentences:
          - same text in and out
          - in: text in
            out: different text out
          - in: [multiple, templates]
            out: shared out
        lists:
          <name>: {values: [...] | range: {from,to,step}}
        expansion_rules:
          <name>: template
    """
    started = time.monotonic()

    slot_lists: Dict[str, SlotList] = {}
    for slot_name, slot_info in sentences_yaml.get("lists", {}).items():
        loaded = _load_slot_list(slot_name, slot_info, number_engine)
        if loaded is not None:
            slot_lists[slot_name] = loaded

    expansion_rules: Dict[str, Sentence] = {
        name: parse_sentence(text)
        for name, text in sentences_yaml.get("expansion_rules", {}).items()
    }

    emitted = 0
    for spec in sentences_yaml["sentences"]:
        for pair in _expand_template_spec(spec, slot_lists, expansion_rules):
            yield pair
            emitted += 1

    _LOGGER.info(
        "Generated %s sentence(s) in %0.2f second(s)",
        emitted,
        time.monotonic() - started,
    )


def _expand_template_spec(
    spec: Any,
    slot_lists: Dict[str, SlotList],
    expansion_rules: Dict[str, Sentence],
) -> Iterable[Tuple[str, str]]:
    """Expand one entry of the ``sentences:`` list."""
    if isinstance(spec, str):
        templates: List[str] = [spec]
        fixed_output: Optional[str] = None
        requires_context = excludes_context = None
    else:
        raw_in = spec["in"]
        templates = [raw_in] if isinstance(raw_in, str) else raw_in
        fixed_output = spec.get("out")
        requires_context = spec.get("requires_context")
        excludes_context = spec.get("excludes_context")

    for template in templates:
        if not is_template(template):
            yield (template, template if fixed_output is None else fixed_output)
            continue

        expander = _Expander(
            slot_lists, expansion_rules, requires_context, excludes_context
        )
        for expansion in expander.expand(parse_sentence(template)):
            if fixed_output is None:
                out_text = str(expansion.written or expansion.spoken)
            else:
                out_text = fixed_output  # may be empty
            if expansion.slots:
                out_text = out_text.format(**expansion.slots)
            yield (expansion.spoken, out_text)


def _load_slot_list(
    slot_name: str, slot_info: Any, number_engine: Optional[NumberEngine]
) -> Optional[TextSlotList]:
    if isinstance(slot_info, ABCSequence) and not isinstance(slot_info, str):
        slot_info = {"values": slot_info}

    slot_range = slot_info.get("range")
    if slot_range:
        return _load_range_list(slot_name, slot_range, number_engine)

    raw_values = slot_info.get("values")
    if not raw_values:
        _LOGGER.warning("No values for list %s, skipping", slot_name)
        return None

    values: List[TextSlotValue] = []
    for raw in raw_values:
        if isinstance(raw, str):
            raw = {"in": raw}

        text_in = str(raw["in"])
        if not text_in:
            continue
        value_out = raw.get("out")
        context = raw.get("context")

        if is_template(text_in):
            expander = _Expander()
            for expansion in expander.expand(parse_sentence(text_in)):
                values.append(
                    TextSlotValue(
                        text_in=TextChunk(text=expansion.spoken),
                        value_out=value_out or expansion.spoken,
                        context=context,
                    )
                )
        else:
            values.append(
                TextSlotValue(
                    text_in=TextChunk(text=text_in),
                    value_out=value_out or text_in,
                    context=context,
                )
            )

    return TextSlotList(name=slot_name, values=values)


def _load_range_list(
    slot_name: str, slot_range: Dict[str, Any], number_engine: Optional[NumberEngine]
) -> TextSlotList:
    assert number_engine is not None, "Can't expand ranges without a number engine"
    lo = int(slot_range["from"])
    hi = int(slot_range["to"])
    step = int(slot_range.get("step", 1))

    values: List[TextSlotValue] = []
    for number in range(lo, hi + 1, step):
        result = number_engine.format_number(number)
        spellings = {s.replace("-", " ") for s in result.text_by_ruleset.values()}
        values.extend(
            TextSlotValue(text_in=TextChunk(text=s), value_out=number)
            for s in spellings
        )
    return TextSlotList(name=slot_name, values=values)
