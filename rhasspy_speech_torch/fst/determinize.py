"""Weighted determinization and minimization.

Covers the roles of OpenFST fstdeterminize/fstminimize and Kaldi's
fstdeterminizestar/fstminimizeencoded (mkgraph.sh:100-142,
kaldi.py:321-341, transcribe_wav.py:131-142):

- :func:`determinize` — subset construction over the tropical semiring with
  gallic (output-string) residuals, so transducers determinize too; output
  strings longer than one symbol are factored into epsilon-input chains.
  Epsilon is treated as an ordinary symbol (OpenFST behavior).
- :func:`determinize_star` — same, but input-epsilon arcs are folded into
  subset closure (Kaldi DeterminizeStar: determinizes and removes input
  epsilons in one pass).
- :func:`minimize` / :func:`minimize_encoded` — Moore partition refinement
  on (ilabel, olabel, weight)-encoded arcs, optionally after weight pushing.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from .core import EPS_ID, INF, Fst
from .ops import push as push_weights

# Subset member: (state, weight residual, output-string residual)
Member = Tuple[int, float, Tuple[int, ...]]


class DeterminizeError(Exception):
    pass


def determinize(
    fst: Fst, max_states: int = 1_000_000, star: bool = False
) -> Fst:
    """Determinize a (possibly weighted, possibly transducing) FST."""
    result = Fst(isymbols=fst.isymbols, osymbols=fst.osymbols)
    if fst.start < 0:
        return result

    def closure(members: List[Member]) -> List[Member]:
        """Input-epsilon closure (star mode only), collecting outputs."""
        if not star:
            return _dedupe(members)
        best: Dict[Tuple[int, Tuple[int, ...]], float] = {}
        stack = list(members)
        for q, w, ostr in members:
            key = (q, ostr)
            if w < best.get(key, INF):
                best[key] = w
        guard = 0
        while stack:
            q, w, ostr = stack.pop()
            if w > best.get((q, ostr), INF):
                continue
            for il, ol, aw, ns in fst.arcs[q]:
                if il != EPS_ID:
                    continue
                new_ostr = ostr + ((ol,) if ol != EPS_ID else ())
                nw = w + aw
                key = (ns, new_ostr)
                if nw < best.get(key, INF) - 1e-12:
                    best[key] = nw
                    stack.append((ns, nw, new_ostr))
                guard += 1
                if guard > 10 * max_states:
                    raise DeterminizeError("epsilon-closure explosion")
        return _dedupe([(q, w, ostr) for (q, ostr), w in best.items()])

    def normalize(members: List[Member]) -> Tuple[float, Tuple[int, ...], Tuple]:
        """Extract common weight and output prefix; return canonical key."""
        members = _dedupe(members)
        common_w = min(w for _, w, _ in members)
        common_prefix = _lcp([ostr for _, _, ostr in members])
        plen = len(common_prefix)
        normalized = tuple(
            sorted((q, round(w - common_w, 9), ostr[plen:]) for q, w, ostr in members)
        )
        return common_w, common_prefix, normalized

    start_members = closure([(fst.start, 0.0, ())])
    start_w, start_prefix, start_key = normalize(start_members)

    subsets: Dict[Tuple, int] = {}
    subset_members: List[Tuple] = []
    queue: List[Tuple] = []

    def get_subset(key: Tuple) -> int:
        sid = subsets.get(key)
        if sid is None:
            sid = result.add_state()
            if sid >= max_states:
                raise DeterminizeError("determinize: state limit exceeded")
            subsets[key] = sid
            subset_members.append(key)
            queue.append(key)
        return sid

    real_start = result.add_state()
    result.start = real_start
    start_sid = get_subset(start_key)
    # Entry chain carries the start residuals (weight + any output prefix)
    _emit_chain(result, real_start, EPS_ID, start_prefix, start_w, start_sid)

    while queue:
        key = queue.pop()
        src = subsets[key]
        members = [(q, w, ostr) for (q, w, ostr) in key]

        # Final handling: residual outputs become eps-input chains
        final_strings: Dict[Tuple[int, ...], float] = {}
        for q, w, ostr in members:
            if fst.finals[q] != INF:
                total = w + fst.finals[q]
                if total < final_strings.get(ostr, INF):
                    final_strings[ostr] = total
        for ostr, weight in final_strings.items():
            if not ostr:
                result.finals[src] = min(result.finals[src], weight)
            else:
                final_state = result.add_state()
                result.set_final(final_state, 0.0)
                _emit_chain(result, src, EPS_ID, ostr, weight, final_state)

        # Group transitions by input label
        by_label: Dict[int, List[Member]] = {}
        for q, w, ostr in members:
            for il, ol, aw, ns in fst.arcs[q]:
                if star and il == EPS_ID:
                    continue  # folded into closure
                new_ostr = ostr + ((ol,) if ol != EPS_ID else ())
                by_label.setdefault(il, []).append((ns, w + aw, new_ostr))

        for label in sorted(by_label):
            targets = closure(by_label[label])
            arc_w, out_prefix, target_key = normalize(targets)
            dst = get_subset(target_key)
            _emit_chain(result, src, label, out_prefix, arc_w, dst)

    return result.connect()


def determinize_star(fst: Fst, max_states: int = 1_000_000) -> Fst:
    """Kaldi-style determinization with input-epsilon removal."""
    return determinize(fst, max_states=max_states, star=True)


def _dedupe(members: List[Member]) -> List[Member]:
    best: Dict[Tuple[int, Tuple[int, ...]], float] = {}
    for q, w, ostr in members:
        key = (q, ostr)
        if w < best.get(key, INF):
            best[key] = w
    return [(q, w, ostr) for (q, ostr), w in best.items()]


def _lcp(strings: List[Tuple[int, ...]]) -> Tuple[int, ...]:
    if not strings:
        return ()
    prefix = strings[0]
    for s in strings[1:]:
        limit = min(len(prefix), len(s))
        i = 0
        while i < limit and prefix[i] == s[i]:
            i += 1
        prefix = prefix[:i]
        if not prefix:
            break
    return prefix


def _emit_chain(
    fst: Fst,
    src: int,
    ilabel: int,
    out_string: Tuple[int, ...],
    weight: float,
    dst: int,
) -> None:
    """Emit an arc whose output is a string, factoring extra symbols into a
    chain of epsilon-input arcs (OpenFST FactorWeight equivalent)."""
    outputs = list(out_string) if out_string else [EPS_ID]
    current = src
    for i, out in enumerate(outputs):
        is_last = i == len(outputs) - 1
        il = ilabel if i == 0 else EPS_ID
        w = weight if i == 0 else 0.0
        nxt = dst if is_last else fst.add_state()
        fst.add_arc(current, il, out, w, nxt)
        current = nxt


# ---------------------------------------------------------------------------
# Minimization
# ---------------------------------------------------------------------------


def minimize_encoded(fst: Fst) -> Fst:
    """Minimize by Moore partition refinement with (ilabel, olabel, weight)
    treated as one encoded label (Kaldi fstminimizeencoded). Assumes a
    deterministic machine; always language- and weight-preserving."""
    if fst.start < 0 or fst.num_states == 0:
        return fst.copy()

    n = fst.num_states
    # Initial partition: final weight class
    final_keys: Dict[float, int] = {}
    block = [0] * n
    for s in range(n):
        key = fst.finals[s]
        if key not in final_keys:
            final_keys[key] = len(final_keys)
        block[s] = final_keys[key]

    num_blocks = len(final_keys)
    while True:
        signatures: Dict[Tuple, int] = {}
        new_block = [0] * n
        for s in range(n):
            sig = (
                block[s],
                tuple(
                    sorted(
                        (il, ol, round(w, 9), block[ns])
                        for (il, ol, w, ns) in fst.arcs[s]
                    )
                ),
            )
            if sig not in signatures:
                signatures[sig] = len(signatures)
            new_block[s] = signatures[sig]

        if len(signatures) == num_blocks:
            block = new_block
            break
        num_blocks = len(signatures)
        block = new_block

    result = Fst(isymbols=fst.isymbols, osymbols=fst.osymbols)
    result.add_states(num_blocks)
    result.start = block[fst.start]

    emitted = [False] * num_blocks
    for s in range(n):
        b = block[s]
        if emitted[b]:
            continue
        emitted[b] = True
        seen_arcs = set()
        for il, ol, w, ns in fst.arcs[s]:
            arc = (il, ol, w, block[ns])
            if arc not in seen_arcs:
                seen_arcs.add(arc)
                result.add_arc(b, il, ol, w, block[ns])
        result.finals[b] = fst.finals[s]

    return result.connect()


def minimize(fst: Fst) -> Fst:
    """fstminimize equivalent: weight pushing then encoded minimization,
    yielding the canonical minimal weighted machine."""
    return minimize_encoded(push_weights(fst))
