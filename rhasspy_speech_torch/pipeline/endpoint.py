"""Endpointing: decide when an open stream's utterance has ended.

Kaldi's OnlineEndpoint rules (kaldi/src/online2/online-endpoint.h:88-127):
an endpoint fires when ANY rule matches; each rule constrains
(must_contain_nonsilence, min_trailing_silence, max_relative_cost,
min_utterance_length). The reference ships the capability but its decode
binaries run with --do-endpointing=false; here it's wired into the batched
scheduler so serving deployments can close streams without an explicit EOF.

Signals per stream, derived from decode state (not raw energy):
- trailing_silence: seconds of best-path frames that emit silence pdfs,
- relative_cost: best final-state cost minus best overall cost,
- utterance_length: seconds decoded so far.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Set

import numpy as np


@dataclass(frozen=True)
class EndpointRule:
    """One OnlineEndpointRule (online-endpoint.h:52-86)."""

    must_contain_nonsilence: bool = True
    min_trailing_silence: float = 1.0  # seconds
    max_relative_cost: float = float("inf")
    min_utterance_length: float = 0.0  # seconds

    def matches(
        self,
        contains_nonsilence: bool,
        trailing_silence: float,
        relative_cost: float,
        utterance_length: float,
    ) -> bool:
        if self.must_contain_nonsilence and not contains_nonsilence:
            return False
        if trailing_silence < self.min_trailing_silence:
            return False
        if relative_cost > self.max_relative_cost:
            return False
        if utterance_length < self.min_utterance_length:
            return False
        return True


@dataclass(frozen=True)
class EndpointConfig:
    """The five default rules (online-endpoint.h:101-127).

    Detection timing depends on the scheduler's endpoint lane: on the
    device lane (compact graphs; the default fused serving tick) the
    rules run against the PREVIOUS tick's landed signal stats, so
    detection lags one chunk (~0.21 s at the default chunk_out_frames=7)
    and the finalized transcript includes the chunk decoded past the
    endpoint. The host lane (non-compact graphs) detects in the same
    tick. The rule thresholds below are in audio seconds either way —
    only the moment of firing differs by one chunk."""

    rules: Sequence[EndpointRule] = (
        # rule1: 5s of silence even with nothing decoded
        EndpointRule(False, 5.0, float("inf"), 0.0),
        # rule2: 0.5s trailing silence with a confident final state
        EndpointRule(True, 0.5, 2.0, 0.0),
        # rule3: 1.0s trailing silence with a plausible final state
        EndpointRule(True, 1.0, 8.0, 0.0),
        # rule4: 2.0s trailing silence regardless of final-state cost
        EndpointRule(True, 2.0, float("inf"), 0.0),
        # rule5: hard utterance-length cap
        EndpointRule(False, 0.0, float("inf"), 20.0),
    )

    def should_endpoint(
        self,
        contains_nonsilence: bool,
        trailing_silence: float,
        relative_cost: float,
        utterance_length: float,
    ) -> bool:
        return any(
            r.matches(
                contains_nonsilence, trailing_silence, relative_cost,
                utterance_length,
            )
            for r in self.rules
        )


def silence_pdfs_from_model(transition_model, model_phones) -> Set[int]:
    """pdf ids belonging to silence/noise phones (names starting SIL/SPN/
    NSN/LAU/SPN variants), from the parsed final.mdl tables."""
    silence_names = ("SIL", "SPN", "NSN", "LAU")
    sil_phone_ids = {
        pid
        for name, pid in model_phones
        if any(name.startswith(s) for s in silence_names)
    }
    pdfs: Set[int] = set()
    for row in transition_model.tuples:
        phone, _state, fwd, slf = (int(x) for x in row)
        if phone in sil_phone_ids:
            pdfs.add(fwd)
            pdfs.add(slf)
    return pdfs


def trailing_silence_frames(
    bps: List[np.ndarray],
    best_state: int,
    arc_pdf: np.ndarray,
    arc_src: np.ndarray,
    silence_pdfs: Set[int],
    max_back: int = 400,
) -> tuple:
    """Walk the best path backwards over the accumulated per-chunk
    backpointers; returns (trailing_silence_frames, contains_nonsilence)."""
    count = 0
    state = best_state
    contains_nonsilence = False
    walked = 0
    still_trailing = True
    for chunk in reversed(bps):
        for t in range(chunk.shape[0] - 1, -1, -1):
            arc = int(chunk[t, state])
            if arc < 0:
                return count, contains_nonsilence
            pdf = int(arc_pdf[arc])
            if pdf in silence_pdfs:
                if still_trailing:
                    count += 1
            else:
                still_trailing = False
                contains_nonsilence = True
            state = int(arc_src[arc])
            walked += 1
            if walked >= max_back:
                # enough context for every rule threshold either way
                return count, contains_nonsilence or not still_trailing
    return count, contains_nonsilence
