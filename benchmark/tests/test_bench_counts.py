"""The frozen counts equal the figures PERF.md quotes."""

import numpy as np

from conftest import ROOT

from benchmark.counts import roofline
from benchmark.harness.spec import load_json
from benchmark.reference import frontend


def test_k1_bound_at_the_main_shape():
    # PERF.md section 6: K1's bound 0.0029 ms at [32, 48000] -> [32, 298, 40]
    cfg = frontend.Mfcc()
    _w, mel, _d, _l = frontend.tables(cfg)
    T = cfg.num_frames(48000)
    assert T == 298
    ms, by = roofline.bound(*roofline.mfcc_work(
        cfg.padded, cfg.frame_length, cfg.num_mel_bins, cfg.num_ceps,
        roofline.mel_terms(mel), 32, 48000, T))
    assert by == "operations" and round(ms, 4) == 0.0029


def test_k2_counts_match_the_ports():
    import torch

    from rhasspy_speech_torch.graph.dense import DenseGraph
    from rhasspy_speech_torch.ops.decoder import DecodeGraph
    from rhasspy_speech_torch.utils import roofline as port

    rng = np.random.RandomState(0)
    S, A, P = 50, 200, 40
    src = np.sort(rng.randint(S, size=A)).astype(np.int32)
    pdf_of = rng.randint(P, size=S)
    g = DenseGraph(num_states=S, arc_src=src, arc_dst=rng.randint(S, size=A).astype(np.int32),
                   arc_pdf=pdf_of[src].astype(np.int32), arc_wseq=np.zeros(A, np.int32),
                   arc_weight=np.zeros(A, np.float32), final_weight=np.zeros(S, np.float32),
                   final_wseq=np.zeros(S, np.int32), init_weight=np.zeros(S, np.float32),
                   init_wseq=np.zeros(S, np.int32), word_seqs=[()], num_pdfs=P)
    lengths = [7, 3, 5]
    want = port.viterbi_work(DecodeGraph.from_dense(g, "cpu"), 3, 7, P, torch.tensor(lengths))
    got = roofline.viterbi_work(g.arc_src, g.arc_dst, g.arc_pdf, S, 3, 7, P, lengths)
    assert got == want


def _params(x, skip=False) -> int:
    """Updatable parameters: matrices and biases, not the fixed lda nor the
    batch norms' statistics."""
    if isinstance(x, dict):
        return sum(_params(v, k == "lda" or k.startswith("bn") or k.endswith(".bn"))
                   for k, v in x.items())
    if isinstance(x, (list, tuple)):
        return sum(_params(v, skip) for v in x)
    return x.size if isinstance(x, np.ndarray) and not skip else 0


def test_am_operations():
    from benchmark.reference.nets import tdnn_lstm, tdnnf

    config = load_json(ROOT / "benchmark" / "configs" / "tdnnf-minilibri1h-grammar13789.json")
    args = config["model"]["args"]
    # the recipe's logged Num-params, both output branches
    assert _params(tdnnf.draw(args, 0, xent=True)) == 5207856
    # every product at every input frame would be 0.90 GFLOP an audio
    # second; the stride-3 layers run at the output rate, so the useful count
    # is 0.417 (100 input frames, 33.3 output frames)
    per_second = roofline.am_flops_per_frame("tdnnf", args) * 100 / 3
    every = 2 * sum(i * o for _, i, o, _ in tdnnf.products(args)) * 100
    assert 0.417e9 < per_second < 0.418e9 and 0.89e9 < every < 0.90e9
    rows = roofline.needed_rows(tdnnf.products(args), 3)
    assert rows["tdnnf3.affine"] == 3 and rows["tdnnf4.linear"] == 2 and rows["tdnnf5.linear"] == 1
    lstm = {"num_pdfs": 3072, "num_ceps": 40, "ivector_dim": 100, "hidden_dim": 1024,
            "cell_dim": 1024, "proj_dim": 256}
    layers = tdnn_lstm.products(lstm)
    assert abs(sum(i * o for _, i, o, _ in layers) - 35.0e6) < 0.1e6
    rows = roofline.needed_rows(layers, 3)
    assert rows["tdnn2"] == 3 and rows["tdnn3"] == 1 and rows["lstm1.W_all"] == 1
