"""N-gram language modeling: counts → Witten-Bell ARPA → G.fst.

Replaces the OpenGrm pipeline the reference shells out to
(rhasspy_speech/kaldi.py:274-309: ``ngramcount --order=N |
ngrammake --method=witten_bell | ngramprint --ARPA`` then format_lm.sh /
``arpa2fst --disambig-symbol=#0``).

- :func:`count_ngrams` computes *expected* n-gram counts over all paths of
  the compiled grammar FST, weighting each path by exp(-cost) (OpenGrm
  counts from an FST behave this way; the grammar's 0.03/word penalties
  yield slightly fractional counts).
- :func:`witten_bell` builds an interpolated Witten-Bell model (K=1,
  OpenGrm's default method) in backoff form.
- :func:`arpa_to_fst` compiles ARPA into the backoff word acceptor with #0
  backoff arcs, Kaldi G.fst conventions (log-e weights, <s>/</s> folded
  into start state and final weights).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, TextIO, Tuple

from ..fst.core import EPS_ID, INF, Fst, SymbolTable

BOS = "<s>"
EOS = "</s>"

NgramCounts = Dict[Tuple[str, ...], float]


def count_ngrams(
    fst: Fst,
    order: int,
    symbols: Optional[SymbolTable] = None,
) -> NgramCounts:
    """Expected n-gram counts (orders 1..order) over an acyclic word FST.

    Each path contributes exp(-path_cost). Sentences are padded with <s>
    and </s>. Input labels are counted; epsilons are skipped.
    """
    symbols = symbols or fst.isymbols
    assert symbols is not None, "need a symbol table to count words"
    if fst.start < 0:
        return {}

    # Backward mass: sum over suffix paths of exp(-cost)
    topo = fst.copy().topsort()
    n = topo.num_states
    backward = [0.0] * n
    for state in range(n - 1, -1, -1):
        mass = math.exp(-topo.finals[state]) if topo.finals[state] != INF else 0.0
        for _, _, w, ns in topo.arcs[state]:
            mass += math.exp(-w) * backward[ns]
        backward[state] = mass

    counts: NgramCounts = {}

    def bump(ngram: Tuple[str, ...], amount: float) -> None:
        counts[ngram] = counts.get(ngram, 0.0) + amount

    # Forward pass with word contexts: state -> {context: mass}
    contexts: List[Dict[Tuple[str, ...], float]] = [dict() for _ in range(n)]
    contexts[topo.start][(BOS,)] = 1.0

    for state in range(n):
        state_ctx = contexts[state]
        if not state_ctx:
            continue

        final_w = topo.finals[state]
        if final_w != INF:
            final_mass = math.exp(-final_w)
            for ctx, mass in state_ctx.items():
                amount = mass * final_mass
                # </s> with all context suffixes
                for k in range(len(ctx) + 1):
                    bump(ctx[k:] + (EOS,), amount)

        for il, _, w, ns in topo.arcs[state]:
            arc_mass = math.exp(-w)
            if il == EPS_ID:
                for ctx, mass in state_ctx.items():
                    tail = backward[ns]
                    del tail  # epsilon: context unchanged, no count
                    contexts[ns][ctx] = contexts[ns].get(ctx, 0.0) + mass * arc_mass
                continue

            word = symbols.find_id(il)
            assert word is not None, il
            for ctx, mass in state_ctx.items():
                amount = mass * arc_mass * backward[ns]
                # Count the word with every context suffix (orders 1..order)
                for k in range(len(ctx) + 1):
                    ngram = ctx[k:] + (word,)
                    if len(ngram) <= order:
                        bump(ngram, amount)

                new_ctx = (ctx + (word,))[-(order - 1):] if order > 1 else ()
                contexts[ns][new_ctx] = contexts[ns].get(new_ctx, 0.0) + mass * arc_mass

    # <s> unigram context count (for ARPA completeness)
    total_sentences = backward[topo.start]
    bump((BOS,), total_sentences)

    return counts


# ---------------------------------------------------------------------------
# Witten-Bell smoothing → ARPA
# ---------------------------------------------------------------------------


@dataclass
class ArpaModel:
    order: int
    # per order (1-based): ngram -> (log10 prob, log10 backoff or None)
    ngrams: List[Dict[Tuple[str, ...], Tuple[float, Optional[float]]]] = field(
        default_factory=list
    )

    def write(self, fileobj: TextIO) -> None:
        print("\\data\\", file=fileobj)
        for n in range(1, self.order + 1):
            print(f"ngram {n}={len(self.ngrams[n - 1])}", file=fileobj)
        for n in range(1, self.order + 1):
            print(f"\n\\{n}-grams:", file=fileobj)
            for ngram in sorted(self.ngrams[n - 1]):
                logp, backoff = self.ngrams[n - 1][ngram]
                text = " ".join(ngram)
                if backoff is not None and backoff != 0.0:
                    print(f"{logp:.6f}\t{text}\t{backoff:.6f}", file=fileobj)
                else:
                    print(f"{logp:.6f}\t{text}", file=fileobj)
        print("\n\\end\\", file=fileobj)

    @staticmethod
    def read(fileobj: TextIO) -> "ArpaModel":
        ngrams: List[Dict[Tuple[str, ...], Tuple[float, Optional[float]]]] = []
        current: Optional[int] = None
        order = 0
        for line in fileobj:
            line = line.strip()
            if not line or line.startswith("\\data\\") or line.startswith("ngram "):
                continue
            if line.startswith("\\end\\"):
                break
            if line.startswith("\\") and line.endswith("-grams:"):
                current = int(line[1:].split("-")[0])
                order = max(order, current)
                while len(ngrams) < current:
                    ngrams.append({})
                continue
            if current is None:
                continue
            parts = line.split()
            logp = float(parts[0])
            rest = parts[1:]
            backoff: Optional[float] = None
            if len(rest) == current + 1:
                backoff = float(rest[-1])
                rest = rest[:-1]
            ngrams[current - 1][tuple(rest)] = (logp, backoff)
        return ArpaModel(order=order, ngrams=ngrams)


_LOG10_MIN = -99.0


def witten_bell(counts: NgramCounts, order: int) -> ArpaModel:
    """Interpolated Witten-Bell in backoff ARPA form (OpenGrm default)."""
    by_order: List[Dict[Tuple[str, ...], float]] = [dict() for _ in range(order)]
    for ngram, count in counts.items():
        if len(ngram) <= order:
            by_order[len(ngram) - 1][ngram] = count

    # Histories and their statistics per order
    vocab = {ng[0] for ng in by_order[0]}
    vocab.discard(BOS)
    v_size = max(1, len(vocab))

    # Interpolated probabilities, computed bottom-up
    probs: List[Dict[Tuple[str, ...], float]] = [dict() for _ in range(order)]

    # Unigrams: histories is the empty context
    c_total = sum(c for ng, c in by_order[0].items() if ng[0] != BOS)
    t_total = len([ng for ng in by_order[0] if ng[0] != BOS])
    denom = c_total + t_total
    for ngram, count in by_order[0].items():
        word = ngram[0]
        if word == BOS:
            continue
        probs[0][ngram] = (count + t_total * (1.0 / v_size)) / denom

    for n in range(2, order + 1):
        level = by_order[n - 1]
        hist_count: Dict[Tuple[str, ...], float] = {}
        hist_types: Dict[Tuple[str, ...], int] = {}
        for ngram, count in level.items():
            hist = ngram[:-1]
            hist_count[hist] = hist_count.get(hist, 0.0) + count
            hist_types[hist] = hist_types.get(hist, 0) + 1

        for ngram, count in level.items():
            hist = ngram[:-1]
            t = hist_types[hist]
            denom = hist_count[hist] + t
            lower = probs[n - 2].get(ngram[1:], 1.0 / v_size)
            probs[n - 1][ngram] = (count + t * lower) / denom

    # Backoff weights: alpha(h) = T(h) / (c(h) + T(h))
    model = ArpaModel(order=order, ngrams=[dict() for _ in range(order)])

    def log10_safe(p: float) -> float:
        return math.log10(p) if p > 0 else _LOG10_MIN

    for n in range(1, order + 1):
        level = by_order[n - 1]
        # histories of order n (i.e. n-grams that serve as contexts for n+1)
        next_hist_count: Dict[Tuple[str, ...], float] = {}
        next_hist_types: Dict[Tuple[str, ...], int] = {}
        if n < order:
            for ngram, count in by_order[n].items():
                hist = ngram[:-1]
                next_hist_count[hist] = next_hist_count.get(hist, 0.0) + count
                next_hist_types[hist] = next_hist_types.get(hist, 0) + 1

        for ngram in level:
            if n == 1 and ngram[0] == BOS:
                logp = _LOG10_MIN  # <s> is context-only
            else:
                logp = log10_safe(probs[n - 1].get(ngram, 0.0))

            backoff: Optional[float] = None
            if n < order and (ngram in next_hist_count or ngram[-1] != EOS):
                c_h = next_hist_count.get(ngram, 0.0)
                t_h = next_hist_types.get(ngram, 0)
                if t_h > 0:
                    backoff = log10_safe(t_h / (c_h + t_h))
                elif ngram[-1] != EOS:
                    backoff = 0.0

            model.ngrams[n - 1][ngram] = (logp, backoff)

    return model


def _interpolated_discount_model(
    counts: NgramCounts,
    order: int,
    discount: Optional[float],
    use_continuation: bool,
) -> ArpaModel:
    """Shared core of kneser_ney / absolute_discounting: subtract-D
    interpolation in backoff ARPA form over an effective-count table
    (continuation counts below the top order for KN, raw counts for
    absolute discounting).

    The interpolation weight of a history is sum_s min(c_s, D) / c(h) —
    equal to the textbook D*T(h)/c(h) when every seen count exceeds D,
    but still exactly normalizing when counts are fractional and below D
    (expected counts from a weighted grammar FST routinely are)."""
    by_order: List[Dict[Tuple[str, ...], float]] = [dict() for _ in range(order)]
    for ngram, count in counts.items():
        if len(ngram) <= order:
            by_order[len(ngram) - 1][ngram] = count

    vocab = {ng[0] for ng in by_order[0]}
    vocab.discard(BOS)
    v_size = max(1, len(vocab))

    if discount is None:
        # Ney's estimate from counts-of-counts at the highest order when the
        # counts are near-integers; 0.75 otherwise (weighted FST counts).
        top = list(by_order[order - 1].values()) or list(by_order[0].values())
        if top and all(abs(c - round(c)) < 1e-6 for c in top):
            n1 = sum(1 for c in top if round(c) == 1)
            n2 = sum(1 for c in top if round(c) == 2)
            discount = n1 / (n1 + 2.0 * n2) if (n1 + 2 * n2) > 0 else 0.75
        else:
            discount = 0.75
    D = float(discount)

    # Effective counts per level
    eff: List[Dict[Tuple[str, ...], float]] = [dict() for _ in range(order)]
    eff[order - 1] = dict(by_order[order - 1])
    if use_continuation:
        for n in range(order - 1, 0, -1):
            # continuation count of an n-gram = #distinct words preceding
            # it among the (n+1)-grams
            cont: Dict[Tuple[str, ...], float] = {}
            for ngram in by_order[n]:
                cont[ngram[1:]] = cont.get(ngram[1:], 0.0) + 1.0
            # n-grams with no observed left extension (e.g. starting with
            # <s>) keep their raw counts
            for ngram, c in by_order[n - 1].items():
                eff[n - 1][ngram] = cont.get(
                    ngram, c if ngram[0] == BOS else 0.0
                )
            for ngram, c in cont.items():
                eff[n - 1].setdefault(ngram, c)
    else:
        for n in range(order - 1):
            eff[n] = dict(by_order[n])

    probs: List[Dict[Tuple[str, ...], float]] = [dict() for _ in range(order)]

    # Unigrams, discounted + interpolated to uniform
    z = sum(c for ng, c in eff[0].items() if ng[0] != BOS)
    z = max(z, 1e-10)
    lam0 = sum(min(c, D) for ng, c in eff[0].items() if ng[0] != BOS) / z
    for ngram, c in eff[0].items():
        if ngram[0] == BOS:
            continue
        probs[0][ngram] = max(c - D, 0.0) / z + lam0 * (1.0 / v_size)

    for n in range(2, order + 1):
        level = eff[n - 1]
        hist_count: Dict[Tuple[str, ...], float] = {}
        hist_min: Dict[Tuple[str, ...], float] = {}
        for ngram, c in level.items():
            hist = ngram[:-1]
            hist_count[hist] = hist_count.get(hist, 0.0) + c
            hist_min[hist] = hist_min.get(hist, 0.0) + min(c, D)
        for ngram, c in level.items():
            hist = ngram[:-1]
            denom = max(hist_count[hist], 1e-10)
            lam = hist_min[hist] / denom
            lower = probs[n - 2].get(ngram[1:], 1.0 / v_size)
            probs[n - 1][ngram] = max(c - D, 0.0) / denom + lam * lower

    model = ArpaModel(order=order, ngrams=[dict() for _ in range(order)])

    def log10_safe(p: float) -> float:
        return math.log10(p) if p > 0 else _LOG10_MIN

    for n in range(1, order + 1):
        level = by_order[n - 1]
        next_eff = eff[n] if n < order else {}
        next_hist_count: Dict[Tuple[str, ...], float] = {}
        next_hist_min: Dict[Tuple[str, ...], float] = {}
        for ngram, c in next_eff.items():
            hist = ngram[:-1]
            next_hist_count[hist] = next_hist_count.get(hist, 0.0) + c
            next_hist_min[hist] = next_hist_min.get(hist, 0.0) + min(c, D)
        for ngram in level:
            if n == 1 and ngram[0] == BOS:
                logp = _LOG10_MIN
            else:
                logp = log10_safe(probs[n - 1].get(ngram, 0.0))
            backoff: Optional[float] = None
            if n < order and (ngram in next_hist_count or ngram[-1] != EOS):
                c_h = next_hist_count.get(ngram, 0.0)
                m_h = next_hist_min.get(ngram, 0.0)
                if m_h > 0:
                    backoff = log10_safe(m_h / max(c_h, 1e-10))
                elif ngram[-1] != EOS:
                    backoff = 0.0
            model.ngrams[n - 1][ngram] = (logp, backoff)

    return model


def kneser_ney(
    counts: NgramCounts, order: int, discount: Optional[float] = None
) -> ArpaModel:
    """Interpolated Kneser-Ney in backoff ARPA form (ngrammake
    --method=kneser_ney, ngrammake-main.cc:78).

    Highest order uses raw counts; lower orders use continuation (distinct
    left-context) counts. Interpolated probabilities are stored directly,
    with mass-exact backoff weights — the "interpolated model in backoff
    form" every ARPA consumer (including pipeline/fuzzy.lm_score's phi
    walk) evaluates correctly."""
    return _interpolated_discount_model(
        counts, order, discount, use_continuation=True
    )


def absolute_discounting(
    counts: NgramCounts, order: int, discount: Optional[float] = None
) -> ArpaModel:
    """Interpolated absolute discounting (ngrammake --method=absolute,
    ngrammake-main.cc:78): Kneser-Ney's subtract-D-and-interpolate recipe
    applied to RAW counts at every order (no continuation counts)."""
    return _interpolated_discount_model(
        counts, order, discount, use_continuation=False
    )


def katz(
    counts: NgramCounts, order: int, cutoff: int = 5
) -> ArpaModel:
    """Katz backoff with Good-Turing discounting (ngrammake --method=katz,
    ngrammake-main.cc:78; include/ngram/ngram-katz.h).

    Counts r <= ``cutoff`` are discounted by the Good-Turing ratio
    d_r = (r*/r - A) / (1 - A) with r* = (r+1) n_{r+1} / n_r and
    A = (k+1) n_{k+1} / n_1 (count-of-count bins over rounded counts);
    invalid ratios fall back to 1 (no discount). Backoff weights are
    computed to normalize exactly:
    alpha(h) = (1 - sum_seen p) / (1 - sum_seen p_lower)."""
    by_order: List[Dict[Tuple[str, ...], float]] = [dict() for _ in range(order)]
    for ngram, count in counts.items():
        if len(ngram) <= order:
            by_order[len(ngram) - 1][ngram] = count

    vocab = {ng[0] for ng in by_order[0]}
    vocab.discard(BOS)
    v_size = max(1, len(vocab))

    def gt_ratios(level: Dict[Tuple[str, ...], float]) -> Dict[int, float]:
        n_r: Dict[int, int] = {}
        for c in level.values():
            r = int(round(c))
            if 1 <= r <= cutoff + 1:
                n_r[r] = n_r.get(r, 0) + 1
        d: Dict[int, float] = {}
        n1 = n_r.get(1, 0)
        nk1 = n_r.get(cutoff + 1, 0)
        if n1 <= 0:
            return d
        A = (cutoff + 1) * nk1 / n1
        if A >= 1.0:
            return d
        for r in range(1, cutoff + 1):
            nr = n_r.get(r, 0)
            nr1 = n_r.get(r + 1, 0)
            if nr <= 0:
                continue
            r_star = (r + 1) * nr1 / nr
            dr = (r_star / r - A) / (1.0 - A)
            if 0.0 < dr <= 1.0:
                d[r] = dr
        return d

    def discounted(c: float, d: Dict[int, float]) -> float:
        r = int(round(c))
        return c * d.get(r, 1.0) if r <= cutoff else c

    probs: List[Dict[Tuple[str, ...], float]] = [dict() for _ in range(order)]

    # Unigrams: GT-discounted ML, leftover mass spread uniformly (closed
    # vocabulary, so there are no unseen unigrams to receive it)
    d1 = gt_ratios({ng: c for ng, c in by_order[0].items() if ng[0] != BOS})
    z = sum(c for ng, c in by_order[0].items() if ng[0] != BOS)
    z = max(z, 1e-10)
    disc_total = 0.0
    for ngram, c in by_order[0].items():
        if ngram[0] == BOS:
            continue
        p = discounted(c, d1) / z
        probs[0][ngram] = p
        disc_total += p
    leftover = max(0.0, 1.0 - disc_total)
    for ngram in probs[0]:
        probs[0][ngram] += leftover / v_size

    for n in range(2, order + 1):
        level = by_order[n - 1]
        d_n = gt_ratios(level)
        hist_count: Dict[Tuple[str, ...], float] = {}
        for ngram, c in level.items():
            hist = ngram[:-1]
            hist_count[hist] = hist_count.get(hist, 0.0) + c
        for ngram, c in level.items():
            denom = max(hist_count[ngram[:-1]], 1e-10)
            probs[n - 1][ngram] = discounted(c, d_n) / denom

    model = ArpaModel(order=order, ngrams=[dict() for _ in range(order)])

    def log10_safe(p: float) -> float:
        return math.log10(p) if p > 0 else _LOG10_MIN

    # Backoff weights from exact normalization over each history
    seen_by_hist: List[Dict[Tuple[str, ...], List[Tuple[str, ...]]]] = [
        dict() for _ in range(order)
    ]
    for n in range(2, order + 1):
        for ngram in by_order[n - 1]:
            seen_by_hist[n - 1].setdefault(ngram[:-1], []).append(ngram)

    for n in range(1, order + 1):
        level = by_order[n - 1]
        for ngram in level:
            if n == 1 and ngram[0] == BOS:
                logp = _LOG10_MIN
            else:
                logp = log10_safe(probs[n - 1].get(ngram, 0.0))
            backoff: Optional[float] = None
            if n < order and ngram[-1] != EOS:
                seen = seen_by_hist[n].get(ngram, [])
                p_seen = sum(probs[n].get(s, 0.0) for s in seen)
                lower_seen = sum(
                    probs[n - 1].get(s[1:], 1.0 / v_size) for s in seen
                )
                num = max(0.0, 1.0 - p_seen)
                den = 1.0 - lower_seen
                # Fractional expected counts can push lower_seen to/past 1.0;
                # the lower order then has no leftover mass, so emit "no
                # backoff" instead of dividing by an epsilon floor (which
                # would produce an absurd positive backoff weight).
                if num <= 0 or den <= 1e-10:
                    backoff = _LOG10_MIN
                else:
                    backoff = log10_safe(num / den)
            model.ngrams[n - 1][ngram] = (logp, backoff)

    return model


# ---------------------------------------------------------------------------
# ARPA → G.fst
# ---------------------------------------------------------------------------

_LN10 = math.log(10.0)


def arpa_to_fst(
    arpa: ArpaModel,
    words: SymbolTable,
    backoff_word: str = "#0",
) -> Fst:
    """Compile ARPA to the Kaldi-style backoff acceptor G.fst.

    States are histories; backoff arcs carry the #0 disambiguation symbol on
    the input side and epsilon output (format_lm.sh:55 / arpa2fst
    --disambig-symbol=#0). Weights are -ln(prob).
    """
    fst = Fst(isymbols=words, osymbols=words)
    backoff_id = words.find(backoff_word)
    assert backoff_id is not None, f"{backoff_word} missing from words.txt"

    state_of: Dict[Tuple[str, ...], int] = {}

    def get_state(hist: Tuple[str, ...]) -> int:
        sid = state_of.get(hist)
        if sid is None:
            sid = fst.add_state()
            state_of[hist] = sid
        return sid

    unigram_state = get_state(())
    start_state = get_state((BOS,)) if (BOS,) in arpa.ngrams[0] else unigram_state
    fst.start = start_state

    def backoff_target(hist: Tuple[str, ...]) -> Tuple[str, ...]:
        return hist[1:]

    def history_exists(hist: Tuple[str, ...]) -> bool:
        if not hist:
            return True
        n = len(hist)
        if n > arpa.order - 1:
            return False
        entry = arpa.ngrams[n - 1].get(hist)
        return entry is not None and entry[1] is not None

    def extend_history(hist: Tuple[str, ...], word: str) -> Tuple[str, ...]:
        new_hist = hist + (word,)
        while len(new_hist) > arpa.order - 1 or not history_exists(new_hist):
            if not new_hist:
                break
            new_hist = new_hist[1:]
        return new_hist

    for n in range(1, arpa.order + 1):
        for ngram, (logp, _backoff) in arpa.ngrams[n - 1].items():
            hist, word = ngram[:-1], ngram[-1]
            if n == 1 and word == BOS:
                continue
            src = get_state(hist)
            weight = -logp * _LN10
            if word == EOS:
                fst.finals[src] = min(fst.finals[src], weight)
                continue
            word_id = words.find(word)
            assert word_id is not None, f"LM word missing from table: {word}"
            dst = get_state(extend_history(hist, word))
            fst.add_arc(src, word_id, word_id, weight, dst)

    # Backoff arcs
    for n in range(1, arpa.order):
        for ngram, (_logp, backoff) in arpa.ngrams[n - 1].items():
            if backoff is None:
                continue
            if ngram not in state_of:
                continue
            src = state_of[ngram]
            dst = get_state(backoff_target(ngram))
            fst.add_arc(src, backoff_id, EPS_ID, -backoff * _LN10, dst)

    return fst.connect().arcsort("ilabel")


def make_arpa_from_fst(
    grammar_fst: Fst,
    order: int = 3,
    symbols: Optional[SymbolTable] = None,
    method: str = "witten_bell",
) -> ArpaModel:
    """ngramcount | ngrammake --method=<method> | ngramprint --ARPA.

    witten_bell is the reference's choice (kaldi.py:274-291);
    kneser_ney / absolute / katz are the other ngrammake methods
    (ngrammake-main.cc:78)."""
    counts = count_ngrams(grammar_fst, order, symbols=symbols)
    if method == "witten_bell":
        return witten_bell(counts, order)
    if method == "kneser_ney":
        return kneser_ney(counts, order)
    if method == "absolute":
        return absolute_discounting(counts, order)
    if method == "katz":
        return katz(counts, order)
    raise ValueError(f"unknown smoothing method {method!r}")
