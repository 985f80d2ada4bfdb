"""Intents model: YAML → parsed intent/template structures.

Replaces the reference's dependency on ``hassil.intents``
(rhasspy_speech/hassil_fst.py:22). Supported YAML shape::

    language: en
    intents:
      IntentName:
        data:
          - sentences: ["turn (on|off) [the] {name}"]
            metadata: {output: "..."}        # optional
            requires_context: {...}          # optional
            excludes_context: {...}          # optional
            lists: {...}                     # optional, intent-scoped
            expansion_rules: {...}           # optional, intent-scoped
    lists:
      name:
        values: [tv, light]                  # or [{in: ..., out: ..., context: ...}]
      brightness:
        range: {from: 0, to: 100, step: 10}  # via `range` key or explicit type
      item:
        wildcard: true
    expansion_rules:
      rule_name: "template"
"""

from __future__ import annotations

import collections.abc
from dataclasses import dataclass, field
from typing import Any, Dict, IO, List, Optional, Union

import yaml

from .expression import (
    RangeSlotList,
    Sentence,
    SlotList,
    TextChunk,
    TextSlotList,
    TextSlotValue,
    WildcardSlotList,
)
from .parser import parse_sentence


@dataclass
class IntentData:
    """One block under an intent's ``data`` list."""

    sentences: List[Sentence] = field(default_factory=list)
    slot_lists: Dict[str, SlotList] = field(default_factory=dict)
    expansion_rules: Dict[str, Sentence] = field(default_factory=dict)
    metadata: Optional[Dict[str, Any]] = None
    requires_context: Optional[Dict[str, Any]] = None
    excludes_context: Optional[Dict[str, Any]] = None


@dataclass
class Intent:
    name: str
    data: List[IntentData] = field(default_factory=list)


@dataclass
class Intents:
    language: Optional[str] = None
    intents: Dict[str, Intent] = field(default_factory=dict)
    slot_lists: Dict[str, SlotList] = field(default_factory=dict)
    expansion_rules: Dict[str, Sentence] = field(default_factory=dict)

    @staticmethod
    def from_yaml(yaml_file: Union[IO[str], str]) -> "Intents":
        return Intents.from_dict(yaml.safe_load(yaml_file))

    @staticmethod
    def from_dict(input_dict: Dict[str, Any]) -> "Intents":
        intents: Dict[str, Intent] = {}
        for intent_name, intent_dict in input_dict.get("intents", {}).items():
            data_blocks: List[IntentData] = []
            for data_dict in intent_dict.get("data", []):
                # sentences may be template strings or {in, out} dicts (the
                # sentences-YAML convenience); dict-form entries become their
                # own data block carrying the output as metadata, which the
                # compiler emits as a __sentence_output meta label.
                plain: List[str] = []
                in_out: List[Dict[str, Any]] = []
                for s in data_dict.get("sentences", []):
                    (in_out if isinstance(s, dict) else plain).append(s)

                slot_lists = _parse_slot_lists(data_dict.get("lists", {}))
                rules = {
                    name: parse_sentence(text)
                    for name, text in data_dict.get(
                        "expansion_rules", {}
                    ).items()
                }
                common = dict(
                    slot_lists=slot_lists,
                    expansion_rules=rules,
                    requires_context=data_dict.get("requires_context"),
                    excludes_context=data_dict.get("excludes_context"),
                )
                if plain:
                    data_blocks.append(
                        IntentData(
                            sentences=[parse_sentence(s) for s in plain],
                            metadata=data_dict.get("metadata"),
                            **common,
                        )
                    )
                for entry in in_out:
                    metadata = dict(data_dict.get("metadata") or {})
                    if "out" in entry:
                        metadata["output"] = entry["out"]
                    data_blocks.append(
                        IntentData(
                            sentences=[parse_sentence(entry["in"])],
                            metadata=metadata or None,
                            **common,
                        )
                    )

            intents[intent_name] = Intent(name=intent_name, data=data_blocks)

        return Intents(
            language=input_dict.get("language"),
            intents=intents,
            slot_lists=_parse_slot_lists(input_dict.get("lists", {})),
            expansion_rules={
                name: parse_sentence(text)
                for name, text in input_dict.get("expansion_rules", {}).items()
            },
        )


def _parse_slot_lists(lists_dict: Dict[str, Any]) -> Dict[str, SlotList]:
    slot_lists: Dict[str, SlotList] = {}
    for list_name, list_info in lists_dict.items():
        slot_lists[list_name] = parse_slot_list(list_name, list_info)
    return slot_lists


def parse_slot_list(list_name: str, list_info: Any) -> SlotList:
    if isinstance(list_info, collections.abc.Sequence) and not isinstance(
        list_info, str
    ):
        list_info = {"values": list_info}

    if list_info.get("wildcard"):
        return WildcardSlotList(name=list_name)

    range_info = list_info.get("range")
    if range_info is not None:
        return RangeSlotList(
            name=list_name,
            start=int(range_info.get("from", 0)),
            stop=int(range_info.get("to", 0)),
            step=int(range_info.get("step", 1)),
        )

    values: List[TextSlotValue] = []
    for value_info in list_info.get("values", []):
        if isinstance(value_info, str):
            value_info = {"in": value_info}

        text_in = str(value_info["in"])
        values.append(
            TextSlotValue(
                text_in=(
                    parse_sentence(text_in)
                    if _is_template(text_in)
                    else TextChunk(text=text_in)
                ),
                value_out=value_info.get("out"),
                context=value_info.get("context"),
                metadata=value_info.get("metadata"),
            )
        )

    return TextSlotList(name=list_name, values=values)


def _is_template(text: str) -> bool:
    from .parser import is_template

    return is_template(text)


# ---------------------------------------------------------------------------
# Context checks (reference: hassil.util.check_*_context, used by
# hassil_fst.py:537-551 and sentences.py:340-426)
# ---------------------------------------------------------------------------


def _unpack_context_value(value: Any) -> Any:
    if isinstance(value, collections.abc.Mapping):
        return value.get("value")
    return value


def check_required_context(
    required_context: Dict[str, Any],
    match_context: Optional[Dict[str, Any]],
    allow_missing_keys: bool = False,
) -> bool:
    """True if match_context satisfies every required key/value."""
    for required_key, required_value in required_context.items():
        if (not match_context) or (required_key not in match_context):
            if allow_missing_keys:
                continue
            return False

        required_value = _unpack_context_value(required_value)
        actual_value = _unpack_context_value(match_context[required_key])

        if (not isinstance(required_value, str)) and isinstance(
            required_value, collections.abc.Collection
        ):
            if actual_value not in required_value:
                return False
        elif (required_value is not None) and (actual_value != required_value):
            return False

    return True


def check_excluded_context(
    excluded_context: Dict[str, Any], match_context: Optional[Dict[str, Any]]
) -> bool:
    """True if match_context avoids every excluded key/value."""
    for excluded_key, excluded_value in excluded_context.items():
        if (not match_context) or (excluded_key not in match_context):
            continue

        excluded_value = _unpack_context_value(excluded_value)
        actual_value = _unpack_context_value(match_context[excluded_key])

        if (not isinstance(excluded_value, str)) and isinstance(
            excluded_value, collections.abc.Collection
        ):
            if actual_value in excluded_value:
                return False
        elif actual_value == excluded_value:
            return False

    return True
