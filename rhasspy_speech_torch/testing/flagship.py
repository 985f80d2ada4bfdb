"""Flagship-size on-disk profile for serving benchmarks.

Writes a complete model dir (Kaldi-format final.mdl with a TDNN-F chain
net + transition model, i-vector extractor files, frontend config) at the
sizes of the published zamia-style models, with random weights (honest
FLOPs — no real model is downloadable in this environment). The streaming
benchmark drives the REAL serving stack (AcousticModel / StreamScheduler)
against this dir, so every file format and load path is exercised.

Numerics mirror bench.py's in-memory build_ivector_params so the batch and
streaming benches run the same acoustic front.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Union

import numpy as np

from ..io.kaldi_io import KaldiWriter
from ..io.nnet3_file import write_nnet3
from ..io.transition_model import KaldiTransitionModel
from .tdnnf import build_tdnnf_spec


def write_flagship_model_dir(
    model_dir: Union[str, Path],
    num_pdfs: int,
    max_phone: int,
    hidden_dim: int = 768,
    num_tdnnf_layers: int = 9,
    ivector_dim: int = 100,
    ubm_gauss: int = 512,
    num_ceps: int = 40,
    seed: int = 7,
    with_ivector_cmvn: bool = False,
) -> Path:
    """Write model/final.mdl + extractor/ + frontend.json + config.json.

    The transition model covers phones 1..max_phone (the decode graph's
    inventory); the nnet emits ``num_pdfs`` posteriors (>= the tree's pdf
    count, like a real chain model computing all pdfs every frame).
    """
    model_dir = Path(model_dir)
    (model_dir / "model").mkdir(parents=True, exist_ok=True)

    ktm = KaldiTransitionModel.from_monophone_chain(max_phone)
    spec = build_tdnnf_spec(
        num_pdfs=num_pdfs,
        input_dim=num_ceps,
        ivector_dim=ivector_dim,
        hidden_dim=hidden_dim,
        num_tdnnf_layers=num_tdnnf_layers,
        seed=seed,
    )
    with open(model_dir / "model" / "final.mdl", "wb") as f:
        write_nnet3(f, spec, transition_model=ktm)

    with open(model_dir / "model" / "frontend.json", "w", encoding="utf-8") as f:
        json.dump({"num_mel_bins": num_ceps, "num_ceps": num_ceps}, f)

    # i-vector extractor at flagship sizes; same constructions (and seed)
    # as bench.py build_ivector_params.
    from ..io.ivector import DiagGmm, IvectorExtractor

    rng = np.random.RandomState(seed)
    splice = 3
    lda_out = num_ceps
    spliced_dim = num_ceps * (2 * splice + 1)
    means = rng.randn(ubm_gauss, lda_out) * 2.0
    variances = 0.5 + rng.rand(ubm_gauss, lda_out)
    weights = rng.dirichlet(np.ones(ubm_gauss))
    dubm = DiagGmm.from_means_vars(weights, means, variances)
    M = (rng.randn(ubm_gauss, lda_out, ivector_dim) * 0.1).astype(np.float32)
    sigma_inv = np.broadcast_to(
        np.eye(lda_out, dtype=np.float32), (ubm_gauss, lda_out, lda_out)
    ).copy()
    extractor = IvectorExtractor(
        w=np.zeros((0, 0), dtype=np.float32),
        w_vec=weights.astype(np.float32),
        M=M,
        sigma_inv=sigma_inv,
        prior_offset=4.0,
    )
    lda = (rng.randn(lda_out, spliced_dim + 1) * 0.05).astype(np.float32)

    ext_dir = model_dir / "extractor"
    ext_dir.mkdir(exist_ok=True)
    with open(ext_dir / "final.dubm", "wb") as f:
        dubm.write(KaldiWriter(f))
    with open(ext_dir / "final.ie", "wb") as f:
        extractor.write(KaldiWriter(f))
    with open(ext_dir / "final.mat", "wb") as f:
        KaldiWriter(f).write_matrix(lda)
    if with_ivector_cmvn:
        # standard production i-vector config: online CMVN on the tap
        # (BENCH_IVEC_CMVN=1 turns this on in the streaming bench)
        from ..ops.cmvn import matrix_from_stats

        stats = matrix_from_stats(
            np.full(num_ceps, 500.0), np.full(num_ceps, 2600.0), 100.0
        )
        with open(ext_dir / "global_cmvn.stats", "wb") as f:
            KaldiWriter(f).write_matrix(stats.astype(np.float64))

    with open(model_dir / "config.json", "w", encoding="utf-8") as f:
        json.dump(
            {"type": "kaldi", "lexicon": {"casing": "lower"},
             "sil_phone": "SIL", "spn_phone": "SPN"},
            f,
        )
    return model_dir


def build_flagship_graph(order: int = 3, with_fuzzy: bool = True,
                         num_pdfs: int = 0):
    """Build the flagship decode graph: the FULL test_en.yaml grammar
    (3,763 sentences) -> order-N ARPA G (Witten-Bell) -> LG ->
    triphone-machinery HCLG expansion (graph/context.py N=3/P=1 windows)
    -> dense decode tensors. Shared by bench.py, the frontier-curve
    example, and the frontier regression tests so they all measure the
    same graph class.

    Returns (graph, g_fuzzy_or_None, lang). Raising ``num_pdfs`` pads the
    pdf axis like a real chain model that computes all its outputs.
    """
    import io as _io
    import re as _re

    from ..grammar import Intents, compile_intents
    from ..graph.context import make_hclg_from_tree
    from ..graph.dense import dense_from_hclg
    from ..io.tree import ContextDependencyTree
    from ..lang import make_grammar_g, make_lg, prepare_lang
    from ..lang.graphs import compile_text_fst, make_fuzzy_g
    from ..lang.ngram import arpa_to_fst, make_arpa_from_fst
    from ..lexicon import LexiconDatabase

    # test_en.yaml lives in the upstream checkout, which the repository
    # does not carry: the port builds the fallback grammar (ROADMAP Queue 3, R1)
    sentences = ["turn (on|off) [the] (light|fan)", "never mind"]
    lists = {}

    intents = Intents.from_dict(
        {
            "language": "en",
            "intents": {"All": {"data": [{"sentences": sentences}]}},
            "lists": lists,
        }
    )
    ctx = compile_intents(
        intents, _io.StringIO(), LexiconDatabase(), number_language="en"
    )

    def pron(w):
        return [c for c in _re.sub(r"[^a-z0-9]", "", w.lower())] or ["x"]

    entries = [(w, pron(w)) for w in sorted(ctx.vocab)]
    lang = prepare_lang(entries, silence_phones=["SIL", "SPN"])

    ctx.fst_file.seek(0)
    g_grammar = make_grammar_g(ctx.fst_file, lang.words)
    arpa = make_arpa_from_fst(g_grammar, order=order, symbols=lang.words)
    g_arpa = arpa_to_fst(arpa, lang.words)
    g_fuzzy = None
    if with_fuzzy:
        ctx.fst_file.seek(0)
        g_text = compile_text_fst(ctx.fst_file, lang.words)
        g_fuzzy = make_fuzzy_g(g_text, ctx.vocab, lang.words, self_loops=True)
    lg = make_lg(lang, g_arpa)

    max_real_phone = max(
        pid for (p, pid) in lang.phones if pid != 0 and not p.startswith("#")
    )
    ktm = KaldiTransitionModel.from_monophone_chain(max_real_phone)
    tree = ContextDependencyTree.monophone_from_tuples(
        ktm.tuples, max_phone=max_real_phone, n=3, p=1
    )
    hclg, tree_pdfs = make_hclg_from_tree(lang, lg, tree, ktm, lang.phones)
    graph = dense_from_hclg(hclg, tree_pdfs)
    if num_pdfs:
        graph.num_pdfs = max(num_pdfs, tree_pdfs)
    return graph, g_fuzzy, lang
