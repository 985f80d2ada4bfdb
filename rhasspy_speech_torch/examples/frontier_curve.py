"""Frontier accuracy against K on a triphone-expanded order-N ARPA graph (the
port's ``examples/frontier_curve.py``).

Builds an order-N ARPA decode graph through the triphone machinery
(``graph/context.py:make_hclg_from_tree``, ``graph/dense.py:dense_from_hclg``)
from ``testing/big_grammar.py``'s generated intents (the JAX script reads
the upstream ``test_en.yaml``, which the repository does not carry), then
decodes seeded random log-probs with the exact decode (K2,
``ops/viterbi_cuda.py``) and the top-K frontier (``ops/frontier.py:
viterbi_topk``, beam 24, at least 200 states a frame) at each K, and reports
per-K cost regret and best-path agreement (the share of streams whose
frontier cost is within 1e-3 of the exact cost).

Usage::

    python -m rhasspy_speech_torch.examples.frontier_curve [order] [T] [B] [--k 64,256,...] [--device cuda|cpu]

``--areas``, ``--devices``, ``--scenes`` size the generated grammar (its
defaults: 260, 160, 130). A K past the graph's states is cut to them.
``main`` returns the graph's size, the exact costs and, per K, the frontier
costs, the regret's largest and mean values and the agreement.
"""

from __future__ import annotations

import io
import re
import sys
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..grammar import Intents, compile_intents
from ..graph.context import make_hclg_from_tree
from ..graph.dense import NEG_INF_F32, dense_from_hclg
from ..io.transition_model import KaldiTransitionModel
from ..io.tree import ContextDependencyTree
from ..lang import make_grammar_g, make_lg, prepare_lang
from ..lang.ngram import arpa_to_fst, make_arpa_from_fst
from ..lexicon import LexiconDatabase
from ..ops.decoder import DecodeGraph
from ..ops.frontier import FrontierGraph, viterbi_topk
from ..ops.viterbi_cuda import viterbi_decode
from ..testing.big_grammar import big_grammar_intents
from ._common import device_info, parser

KS = (64, 256, 1024, 4096, 7000, 20000)
BEAM, MIN_ACTIVE = 24.0, 200
AGREE_TOL = 1e-3


def build_graph(order: int, intents: dict):
    """The intents' grammar as an order-``order`` ARPA LM, through a
    spelled lexicon (a word's pronunciation is its letters), LG and a
    triphone tree (N = 3, P = 1) over a monophone-chain transition model,
    into a ``DenseGraph``."""
    ctx = compile_intents(Intents.from_dict(intents), io.StringIO(), LexiconDatabase(),
                          number_language="en")

    def pron(w):
        return [c for c in re.sub(r"[^a-z0-9]", "", w.lower())] or ["x"]

    lang = prepare_lang([(w, pron(w)) for w in sorted(ctx.vocab)], silence_phones=["SIL", "SPN"])
    ctx.fst_file.seek(0)
    g_grammar = make_grammar_g(ctx.fst_file, lang.words)
    arpa = make_arpa_from_fst(g_grammar, order=order, symbols=lang.words)
    lg = make_lg(lang, arpa_to_fst(arpa, lang.words))
    max_phone = max(pid for (p, pid) in lang.phones if pid != 0 and not p.startswith("#"))
    ktm = KaldiTransitionModel.from_monophone_chain(max_phone)
    tree = ContextDependencyTree.monophone_from_tuples(ktm.tuples, max_phone=max_phone, n=3, p=1)
    hclg, num_pdfs = make_hclg_from_tree(lang, lg, tree, ktm, lang.phones)
    return dense_from_hclg(hclg, num_pdfs)


def log_probs(graph, B: int, T: int, seed: int = 0) -> np.ndarray:
    """[B, T, P] f32 seeded standard-normal log-probs, the JAX script's draw."""
    return np.random.RandomState(seed).randn(B, T, graph.num_pdfs).astype(np.float32)


def frontier_costs(fg: FrontierGraph, graph, lp: torch.Tensor, k: int) -> np.ndarray:
    """Each stream's best frontier cost at ``k``: the last frame's alphas
    plus the final weights, NEG_INF_F32 where no state is kept."""
    states_t, alphas_t, _arcs = viterbi_topk(fg, lp, k, beam=BEAM, min_active=MIN_ACTIVE)
    last = states_t[-1].cpu().numpy()
    alphas = alphas_t[-1].cpu().numpy()
    totals = np.where(last >= 0, alphas + graph.final_weight[np.maximum(last, 0)], NEG_INF_F32)
    return totals.min(axis=1)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    p = parser(__doc__)
    p.add_argument("order", nargs="?", type=int, default=5)
    p.add_argument("T", nargs="?", type=int, default=50)
    p.add_argument("B", nargs="?", type=int, default=4)
    p.add_argument("--k", default=",".join(map(str, KS)), help="comma-separated K values")
    p.add_argument("--areas", type=int, default=260)
    p.add_argument("--devices", type=int, default=160)
    p.add_argument("--scenes", type=int, default=130)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    dev = resolve_device(args.device)

    t0 = time.time()
    intents = big_grammar_intents(args.seed, areas=args.areas, devices=args.devices,
                                  scenes=args.scenes)
    graph = build_graph(args.order, intents)
    print(f"order-{args.order} graph: {graph.num_states} states / {graph.num_arcs} arcs / "
          f"{graph.num_pdfs} pdfs, built in {time.time() - t0:.1f} s")
    lp = torch.as_tensor(log_probs(graph, args.B, args.T), device=dev)
    dg = DecodeGraph.from_dense(graph, dev)
    exact = viterbi_decode(dg, lp)[2].cpu().numpy()
    fg = FrontierGraph.from_dense(graph, dev, base=dg)

    ks = list(dict.fromkeys(min(int(k), graph.num_states) for k in args.k.split(",")))
    curve = []
    print(f"{'K':>7} {'max regret':>12} {'mean regret':>12} {'path match':>11}")
    for k in ks:
        cost = frontier_costs(fg, graph, lp, k)
        regret = cost - exact
        agree = float((regret <= AGREE_TOL).mean())
        curve.append({"k": k, "cost": cost, "max_regret": float(regret.max()),
                      "mean_regret": float(regret.mean()), "agreement": agree})
        print(f"{k:>7} {regret.max():>12.4f} {regret.mean():>12.4f} {agree:>10.0%}")
    return {"states": graph.num_states, "arcs": graph.num_arcs, "pdfs": graph.num_pdfs,
            "exact_cost": exact, "curve": curve, **device_info(dev)}


if __name__ == "__main__":
    main()
