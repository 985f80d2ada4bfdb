"""Context-dependent HCLG expansion (triphone models).

Covers mkgraph.sh:113-151 for context-size N trees: instead of
materializing C (fstcomposecontext) and Ha then composing, LG phone arcs are
expanded in place while tracking the phone context window — the composed
result is identical, and the delayed-context trick (a phone's HMM is emitted
once its right neighbor is known) falls out of the traversal state:

  expansion state = (LG state, left phone, pending phone)

When an arc introduces phone p, the pending phone c (with left l) gains its
right context p, so c's HMM chain (pdfs from the ContextDependency tree,
transition costs from the HmmTopology) is emitted, and p becomes pending.
Word labels/weights ride the arc that introduces the phone, as graph-only
epsilon arcs; the dense builder folds them (graph/dense.py).

Supports arbitrary (N, P): the expansion state carries the last P emitted
phones (left history, 0-padded) and a FIFO of up to R = N-1-P phones still
awaiting right context. A phone's HMM is emitted when the R-th phone after
it arrives (or at finality, with 0/eps right padding) — the general form of
fstcomposecontext's delayed-context construction
(kaldi/src/fstext/context-fst.cc). N=3/P=1 triphone, N=2 biphones, and N=1
monophone are the common special cases; wider windows (e.g. N=5
quinphone) traverse the same way with longer tuples. Output convention
matches graph/hclg.py: ilabel = pdf + 1, olabel = word id.
"""

from __future__ import annotations

from typing import Dict, Set, Tuple

import math

from ..fst.core import EPS_ID, INF, Fst, SymbolTable
from ..io.transition_model import K_NO_PDF, KaldiTransitionModel
from ..io.tree import ContextDependencyTree
from ..lang.lexicon_fst import Lang
from .transitions import Transition, TransitionTable


def make_hclg_from_tree(
    lang: Lang,
    lg: Fst,
    tree: ContextDependencyTree,
    ktm: KaldiTransitionModel,
    model_phones: SymbolTable,
    transition_scale: float = 1.0,
    self_loop_scale: float = 1.0,
    transitions: Optional[TransitionTable] = None,
) -> Tuple[Fst, int]:
    """Expand LG (lang-phone ilabels -> words) into HCLG (pdf+1 -> words)
    using a real decision tree. Returns (hclg, num_pdfs)."""
    if not (0 <= tree.P < tree.N):
        raise ValueError(f"invalid tree N={tree.N} P={tree.P}")
    n_left = tree.P  # phones of left history carried in the state
    n_right = tree.N - 1 - tree.P  # phones of lookahead (pending FIFO depth)

    disambig: Set[int] = set(lang.disambig_phone_ids)

    # lang phone id -> model phone id (names must agree)
    lang_to_model: Dict[int, int] = {}
    for name, pid in lang.phones:
        if pid == 0 or name.startswith("#"):
            continue
        mid = model_phones.find(name)
        if mid is None:
            raise KeyError(f"phone {name!r} missing from model phones.txt")
        lang_to_model[pid] = mid

    def topo_entry(model_phone: int):
        return ktm.topology.entry_for_phone(model_phone)

    hclg = Fst()
    # expansion states: (lg_state, left history tuple, pending phone FIFO)
    state_ids: Dict[Tuple[int, Tuple[int, ...], Tuple], int] = {}

    def get_state(key) -> int:
        sid = state_ids.get(key)
        if sid is None:
            sid = hclg.add_state()
            state_ids[key] = sid
        return sid

    def expand_phone(
        src: int,
        hist: Tuple[int, ...],
        phone: int,
        right: Tuple[int, ...],
        dst: int,
        lang_phone: int = 0,
    ) -> None:
        """Emit phone's HMM chain from hclg state src to dst with context
        window hist + (phone,) + right; model phone ids, 0 = eps padding.
        ``lang_phone`` tags the chain for transition-table metadata."""
        entry = topo_entry(phone)
        window = hist + (phone,) + right
        current = src
        emitted_entry = False
        for j, st in enumerate(entry):
            if st.forward_pdf_class == K_NO_PDF:
                continue  # final non-emitting state
            fwd_pdf = tree.compute(window, st.forward_pdf_class)
            self_class = (
                st.self_loop_pdf_class
                if st.self_loop_pdf_class != K_NO_PDF
                else st.forward_pdf_class
            )
            self_pdf = tree.compute(window, self_class)
            if fwd_pdf is None or self_pdf is None:
                raise ValueError(
                    f"tree has no pdf for phone {phone} window {window}"
                )
            fwd_prob = sum(p for d, p in st.transitions if d != j) or 1.0
            self_prob = sum(p for d, p in st.transitions if d == j)
            fwd_cost = -transition_scale * math.log(fwd_prob)
            self_cost = (
                -self_loop_scale * math.log(self_prob) if self_prob > 0 else 0.0
            )
            fwd_il = fwd_pdf + 1
            self_il = self_pdf + 1
            if transitions is not None:
                fwd_il = transitions.ilabel(
                    Transition(
                        pdf=fwd_pdf,
                        phone=lang_phone,
                        is_self_loop=False,
                        is_entry=not emitted_entry,
                        trans_cost=-math.log(fwd_prob),
                    )
                )
                self_il = transitions.ilabel(
                    Transition(
                        pdf=self_pdf,
                        phone=lang_phone,
                        is_self_loop=True,
                        is_entry=False,
                        trans_cost=(
                            -math.log(self_prob) if self_prob > 0 else 0.0
                        ),
                    )
                )
            emitted_entry = True
            loop_state = hclg.add_state()
            hclg.add_arc(current, fwd_il, EPS_ID, fwd_cost, loop_state)
            hclg.add_arc(loop_state, self_il, EPS_ID, self_cost, loop_state)
            current = loop_state
        hclg.add_arc(current, EPS_ID, EPS_ID, 0.0, dst)

    # hist: last n_left model phones emitted (0-padded, oldest first);
    # pending: FIFO of (model phone, lang phone) awaiting right context
    empty_hist: Tuple[int, ...] = (0,) * n_left
    start_key = (lg.start, empty_hist, ())
    hclg.start = get_state(start_key)

    def push_hist(hist: Tuple[int, ...], phone: int) -> Tuple[int, ...]:
        return (hist + (phone,))[-n_left:] if n_left else ()

    # worklist traversal
    stack = [start_key]
    seen = {start_key}
    num_pdfs = ktm.num_pdfs
    while stack:
        key = stack.pop()
        lg_state, hist, pending = key
        src = state_ids[key]

        # finality: flush pending phones with eps right padding
        if lg.finals[lg_state] != INF:
            cur, h = src, hist
            for i, (qm, ql) in enumerate(pending):
                tail = tuple(m for m, _ in pending[i + 1 :])
                right = tail + (0,) * (n_right - len(tail))
                end = hclg.add_state()
                expand_phone(cur, h, qm, right, end, lang_phone=ql)
                h = push_hist(h, qm)
                cur = end
            hclg.set_final(cur, lg.finals[lg_state])

        for ilabel, olabel, weight, ns in lg.arcs[lg_state]:
            if ilabel == EPS_ID or ilabel in disambig:
                new_key = (ns, hist, pending)
                dst = get_state(new_key)
                hclg.add_arc(src, EPS_ID, olabel, weight, dst)
            else:
                p_model = lang_to_model[ilabel]
                if len(pending) < n_right:
                    # lookahead not yet satisfied: queue the phone, let the
                    # word label/weight ride ahead as a graph-only eps arc
                    new_key = (ns, hist, pending + ((p_model, ilabel),))
                    dst = get_state(new_key)
                    hclg.add_arc(src, EPS_ID, olabel, weight, dst)
                else:
                    # p completes the oldest pending phone's right context
                    # (when n_right == 0, p itself expands immediately)
                    if n_right:
                        head_m, head_l = pending[0]
                        right = tuple(m for m, _ in pending[1:]) + (p_model,)
                        new_pending = pending[1:] + ((p_model, ilabel),)
                    else:
                        head_m, head_l = p_model, ilabel
                        right = ()
                        new_pending = ()
                    new_key = (ns, push_hist(hist, head_m), new_pending)
                    dst = get_state(new_key)
                    mid = hclg.add_state()
                    expand_phone(src, hist, head_m, right, mid, lang_phone=head_l)
                    hclg.add_arc(mid, EPS_ID, olabel, weight, dst)
            if new_key not in seen:
                seen.add(new_key)
                stack.append(new_key)

    return hclg.connect(), num_pdfs
