"""WFST algorithms: compose, rmepsilon, shortest distance/path, push, prune.

Replaces the OpenFST CLI algorithms the reference invokes (see
rhasspy_speech/kaldi.py, transcribe_util.py, coqui_stt.py and
kaldi/egs mkgraph.sh). Tropical semiring throughout.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Tuple

from .core import EPS_ID, INF, Arc, Fst


# ---------------------------------------------------------------------------
# Composition (with epsilon filter and optional phi/failure matching)
# ---------------------------------------------------------------------------


def ilabel_index(fst: Fst) -> List[Dict[int, List[Arc]]]:
    """Per-state arcs-by-input-label index for composition. Build once and
    pass to :func:`compose` when composing many small FSTs against one big
    one (the fuzzy-match serving path) — rebuilding it per call costs
    O(arcs) each time."""
    index: List[Dict[int, List[Arc]]] = []
    for arcs in fst.arcs:
        table: Dict[int, List[Arc]] = {}
        for arc in arcs:
            table.setdefault(arc[0], []).append(arc)
        index.append(table)
    return index


def compose(
    fst1: Fst,
    fst2: Fst,
    phi_label: Optional[int] = None,
    fst2_index: Optional[List[Dict[int, List[Arc]]]] = None,
) -> Fst:
    """Compose two FSTs (fst1 output side matched to fst2 input side).

    Uses the standard 3-state epsilon filter to avoid redundant epsilon
    paths. When ``phi_label`` is given, arcs in fst2 with that input label
    act as failure transitions: taken (without consuming) only when fst2's
    state has no arc matching the incoming label — OpenFST PhiMatcher /
    Kaldi lattice-compose --phi-label semantics, used for ARPA backoff.
    ``fst2_index`` is an optional precomputed :func:`ilabel_index` of fst2.
    """
    result = Fst(isymbols=fst1.isymbols, osymbols=fst2.osymbols)
    if fst1.start < 0 or fst2.start < 0:
        return result

    # fst2 arcs indexed by input label per state
    fst2_by_ilabel = fst2_index if fst2_index is not None else ilabel_index(fst2)

    def phi_resolve(s2: int, label: int) -> Tuple[List[Tuple[float, Arc]], float]:
        """Follow phi chains in fst2 from s2 until `label` matches.
        Returns (list of (accumulated phi weight, matching arc)), and is
        only used when phi_label is set."""
        matches: List[Tuple[float, Arc]] = []
        weight = 0.0
        state = s2
        seen = set()
        while True:
            direct = fst2_by_ilabel[state].get(label)
            if direct:
                matches.extend((weight, arc) for arc in direct)
                return matches, weight
            phi_arcs = fst2_by_ilabel[state].get(phi_label)
            if not phi_arcs or state in seen:
                return matches, weight
            seen.add(state)
            # Deterministic backoff assumed (single phi arc), like ARPA G
            phi_arc = phi_arcs[0]
            weight += phi_arc[2]
            state = phi_arc[3]

    def phi_final(s2: int) -> Tuple[float, int]:
        """Follow phi chains to a final state (for final-weight matching)."""
        weight = 0.0
        state = s2
        seen = set()
        while fst2.finals[state] == INF:
            phi_arcs = fst2_by_ilabel[state].get(phi_label)
            if not phi_arcs or state in seen:
                return INF, state
            seen.add(state)
            phi_arc = phi_arcs[0]
            weight += phi_arc[2]
            state = phi_arc[3]
        return weight, state

    # Composition state: (s1, s2, filter)
    state_map: Dict[Tuple[int, int, int], int] = {}
    queue: List[Tuple[int, int, int]] = []

    def get_state(key: Tuple[int, int, int]) -> int:
        sid = state_map.get(key)
        if sid is None:
            sid = result.add_state()
            state_map[key] = sid
            queue.append(key)
        return sid

    get_state((fst1.start, fst2.start, 0))

    while queue:
        key = queue.pop()
        s1, s2, flt = key
        src = state_map[key]

        # Final weight
        if fst1.finals[s1] != INF:
            if fst2.finals[s2] != INF:
                result.finals[src] = min(
                    result.finals[src], fst1.finals[s1] + fst2.finals[s2]
                )
            elif phi_label is not None:
                w2, _ = phi_final(s2)
                if w2 != INF:
                    result.finals[src] = min(
                        result.finals[src], fst1.finals[s1] + w2
                    )

        for il1, ol1, w1, ns1 in fst1.arcs[s1]:
            if ol1 == EPS_ID:
                # fst1 moves alone (eps-output) — allowed in filter 0, 1
                if flt in (0, 1):
                    dst = get_state((ns1, s2, 1))
                    result.add_arc(src, il1, EPS_ID, w1, dst)
                # matched eps move together with fst2 eps-input arcs
                if flt == 0:
                    for arc2 in fst2_by_ilabel[s2].get(EPS_ID, []):
                        dst = get_state((ns1, arc2[3], 0))
                        result.add_arc(src, il1, arc2[1], w1 + arc2[2], dst)
                continue

            # Real label: match against fst2 (with phi backoff if enabled)
            matched = fst2_by_ilabel[s2].get(ol1)
            if matched:
                for il2, ol2, w2, ns2 in matched:
                    dst = get_state((ns1, ns2, 0))
                    result.add_arc(src, il1, ol2, w1 + w2, dst)
            elif phi_label is not None and ol1 != phi_label:
                phi_matches, _ = phi_resolve(s2, ol1)
                for phi_w, (il2, ol2, w2, ns2) in phi_matches:
                    dst = get_state((ns1, ns2, 0))
                    result.add_arc(src, il1, ol2, w1 + phi_w + w2, dst)

        # fst2 moves alone (eps-input) — allowed in filter 0, 2
        if flt in (0, 2):
            for il2, ol2, w2, ns2 in fst2_by_ilabel[s2].get(EPS_ID, []):
                dst = get_state((s1, ns2, 2))
                result.add_arc(src, EPS_ID, ol2, w2, dst)

    return result.connect()


# ---------------------------------------------------------------------------
# Epsilon removal
# ---------------------------------------------------------------------------


def rmepsilon(fst: Fst) -> Fst:
    """Remove arcs where both labels are epsilon (fstrmepsilon)."""
    if fst.start < 0:
        return fst

    result = Fst(isymbols=fst.isymbols, osymbols=fst.osymbols)
    result.add_states(fst.num_states)
    result.start = fst.start

    for state in range(fst.num_states):
        # Epsilon-closure distances from `state` (Dijkstra over eps arcs)
        closure: Dict[int, float] = {state: 0.0}
        heap: List[Tuple[float, int]] = [(0.0, state)]
        while heap:
            dist, q = heapq.heappop(heap)
            if dist > closure.get(q, INF):
                continue
            for il, ol, w, ns in fst.arcs[q]:
                if il == EPS_ID and ol == EPS_ID:
                    nd = dist + w
                    if nd < closure.get(ns, INF):
                        closure[ns] = nd
                        heapq.heappush(heap, (nd, ns))

        final_weight = fst.finals[state]
        for q, dist in closure.items():
            if fst.finals[q] != INF:
                final_weight = min(final_weight, dist + fst.finals[q])
            for il, ol, w, ns in fst.arcs[q]:
                if il == EPS_ID and ol == EPS_ID:
                    continue
                result.add_arc(state, il, ol, dist + w, ns)

        result.finals[state] = final_weight

    return result.connect()


# ---------------------------------------------------------------------------
# Shortest distance / shortest path / n-best
# ---------------------------------------------------------------------------


def shortest_distance(fst: Fst, reverse: bool = False) -> List[float]:
    """Tropical shortest distances from the start (or to the finals when
    reverse=True). Queue-based relaxation; tolerates negative arc weights
    (no negative cycles)."""
    n = fst.num_states
    dist = [INF] * n
    if fst.start < 0:
        return dist

    if not reverse:
        adj = fst.arcs
        sources = [(fst.start, 0.0)]

        def edges(s):
            for _, _, w, ns in adj[s]:
                yield w, ns

    else:
        radj: List[List[Tuple[float, int]]] = [[] for _ in range(n)]
        for s in range(n):
            for _, _, w, ns in fst.arcs[s]:
                radj[ns].append((w, s))
        sources = [(s, fst.finals[s]) for s in range(n) if fst.finals[s] != INF]

        def edges(s):
            yield from radj[s]

    in_queue = [False] * n
    from collections import deque

    queue = deque()
    for s, d in sources:
        dist[s] = min(dist[s], d)
        queue.append(s)
        in_queue[s] = True

    relaxations = 0
    max_relaxations = 10 * (n + 1) * max(1, fst.num_arcs)
    while queue:
        s = queue.popleft()
        in_queue[s] = False
        d = dist[s]
        for w, ns in edges(s):
            nd = d + w
            if nd < dist[ns] - 1e-12:
                dist[ns] = nd
                if not in_queue[ns]:
                    queue.append(ns)
                    in_queue[ns] = True
            relaxations += 1
            if relaxations > max_relaxations:
                raise ValueError("shortest_distance: negative cycle suspected")

    return dist


def shortest_path(fst: Fst, nshortest: int = 1, unique: bool = False) -> Fst:
    """N-shortest paths as an FST (union of linear paths), like
    fstshortestpath / the lattice-to-nbest core.

    Uses the reverse-distance-guided search (Mohri & Riley): expand partial
    paths ordered by (cost so far + distance-to-final); the first N complete
    paths popped are the N best. ``unique`` dedupes by input-label sequence
    — exact when the input FST is deterministic (as in OpenFST, whose
    --unique requires determinized input); on nondeterministic input a
    widened per-state expansion bound makes it best-effort.
    """
    result = Fst(isymbols=fst.isymbols, osymbols=fst.osymbols)
    if fst.start < 0:
        return result

    to_final = shortest_distance(fst, reverse=True)
    if to_final[fst.start] == INF:
        return result

    super_start = result.add_state()
    result.start = super_start

    # Heap entries: (priority, counter, state, cost, parent_entry_id)
    # parent chain reconstructs the path; entries stored in a list.
    entries: List[Tuple[int, Optional[int], Arc]] = []  # (state, parent, arc)
    heap: List[Tuple[float, int, int, float, Optional[int]]] = []
    counter = 0

    heapq.heappush(heap, (to_final[fst.start], counter, fst.start, 0.0, None))

    found = 0
    seen_inputs = set()
    # Per-state pop counts bound the search (each state need be expanded at
    # most nshortest times). With unique dedup on nondeterministic input,
    # duplicate-sequence paths burn pops, so widen the bound.
    pop_bound = nshortest * 8 + 32 if unique else nshortest
    pops: Dict[int, int] = {}

    # Stopping at a final state costs finals[state], which can exceed the
    # pop priority (cost + to_final[state] uses the CHEAPEST continuation,
    # final or not) — so completion must compete in the heap as its own
    # event (state = -1 sentinel) rather than emit at pop time, or a costly
    # "stop here" path would be emitted before cheaper paths still pending.
    DONE = -1

    while heap and found < nshortest:
        _, _, state, cost, parent = heapq.heappop(heap)
        if state == DONE:
            # Completed path: parent chain ends at the final state's entry.
            path_arcs: List[Arc] = []
            final_state = None
            entry = parent
            while entry is not None:
                e_state, e_parent, e_arc = entries[entry]
                if e_arc is None:  # completion marker holds the final state
                    final_state = e_state
                else:
                    path_arcs.append(e_arc)
                entry = e_parent
            path_arcs.reverse()

            if unique:
                iseq = tuple(a[0] for a in path_arcs if a[0] != EPS_ID)
                if iseq in seen_inputs:
                    continue
                seen_inputs.add(iseq)

            current = super_start
            for il, ol, w, _ns in path_arcs:
                nxt = result.add_state()
                result.add_arc(current, il, ol, w, nxt)
                current = nxt
            result.set_final(current, fst.finals[final_state])
            found += 1
            continue

        pops[state] = pops.get(state, 0) + 1
        if pops[state] > pop_bound:
            continue

        if fst.finals[state] != INF:
            counter += 1
            entries.append((state, parent, None))
            heapq.heappush(
                heap,
                (
                    cost + fst.finals[state],
                    counter,
                    DONE,
                    cost + fst.finals[state],
                    len(entries) - 1,
                ),
            )

        for arc in fst.arcs[state]:
            il, ol, w, ns = arc
            if to_final[ns] == INF:
                continue
            counter += 1
            entries.append((state, parent, arc))
            entry_id = len(entries) - 1
            new_cost = cost + w
            heapq.heappush(
                heap, (new_cost + to_final[ns], counter, ns, new_cost, entry_id)
            )

    return result


# ---------------------------------------------------------------------------
# Weight pushing and pruning
# ---------------------------------------------------------------------------


def push(fst: Fst, to_initial: bool = True) -> Fst:
    """Push weights toward the initial state (fstpush --push_weights).
    Total path weights are preserved (the total rides on the start arcs)."""
    if fst.start < 0:
        return fst

    potential = shortest_distance(fst, reverse=True)
    result = fst.copy()

    for state in range(result.num_states):
        v_s = potential[state]
        if v_s == INF:
            continue
        offset = 0.0 if state == result.start else -v_s
        new_arcs: List[Arc] = []
        for il, ol, w, ns in result.arcs[state]:
            v_ns = potential[ns]
            if v_ns == INF:
                continue
            new_arcs.append((il, ol, w + v_ns + offset, ns))
        result.arcs[state] = new_arcs
        if result.finals[state] != INF:
            result.finals[state] = result.finals[state] + offset

    return result


def prune(fst: Fst, weight_threshold: float) -> Fst:
    """Keep only states/arcs on paths within threshold of the best path
    (fstprune --weight)."""
    if fst.start < 0:
        return fst

    forward = shortest_distance(fst)
    backward = shortest_distance(fst, reverse=True)
    best = backward[fst.start]
    if best == INF:
        result = fst.copy()
        result.arcs = []
        result.finals = []
        result.start = -1
        return result

    limit = best + weight_threshold
    result = fst.copy()
    keep = {
        s
        for s in range(result.num_states)
        if forward[s] + backward[s] <= limit + 1e-9
    }
    for state in list(keep):
        result.arcs[state] = [
            (il, ol, w, ns)
            for (il, ol, w, ns) in result.arcs[state]
            if ns in keep and forward[state] + w + backward[ns] <= limit + 1e-9
        ]
    return result._restrict(keep)


# ---------------------------------------------------------------------------
# Equivalence helper (tests/verification)
# ---------------------------------------------------------------------------


def weighted_language(fst: Fst, max_paths: int = 100000):
    """Map input-label sequence -> (min weight, set of output sequences).
    Simple-path enumeration; for acyclic test FSTs."""
    lang: Dict[Tuple[int, ...], float] = {}
    for ipath, opath, weight in fst.paths(max_paths):
        key = tuple(ipath)
        if key not in lang or weight < lang[key]:
            lang[key] = weight
    return lang
