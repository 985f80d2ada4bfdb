"""``rhasspy_speech_torch/utils/roofline.py``: the work counts behind every
bound the repository states (``chip_smoke.py``'s kernel table and
``examples/decode_roofline.py``), held to counts made by hand at tiny
shapes, and PERF.md's K1 bound at the main path's shape reproduced from the
flagship frontend's parameters."""

import numpy as np
import pytest
import torch

from rhasspy_speech_torch.graph.dense import NEG_INF_F32, DenseGraph
from rhasspy_speech_torch.io.nnet3_file import ComponentSpec, Nnet3Spec, NodeSpec
from rhasspy_speech_torch.models.nnet3 import compile_nnet3
from rhasspy_speech_torch.ops.decoder import DecodeGraph
from rhasspy_speech_torch.ops.frontend import FrontendConfig, make_frontend_params, num_frames
from rhasspy_speech_torch.utils import roofline


def test_bound_takes_the_larger_time():
    assert roofline.bound(3.35e9, 1.0) == (pytest.approx(1.0), "bytes")
    assert roofline.bound(1.0, 67e9) == (pytest.approx(1.0), "operations")
    assert roofline.bound(1.0, 989e9, ops_per_s=roofline.BF16_OPS_PER_S) == (
        pytest.approx(1.0), "operations")


def test_mfcc_work_by_hand():
    """One 400-sample frame at N = 512, 23 mel bins, 13 cepstra: the frame
    ops (DC, pre-emphasis, window: 5 a sample), a 256-point complex FFT at
    10 operations a radix-2 butterfly (128 x 8) and its split (14 a bin, 257
    bins), 2 a mel weight, the log, the DCT (2 a term) and the lifter."""
    params = make_frontend_params(FrontendConfig(num_mel_bins=23, num_ceps=13), "cpu")
    nnz = int(np.count_nonzero(params.mel_weights.numpy()))
    nbytes, nops = roofline.mfcc_work(params, 1, 400, 1)
    assert nbytes == 4 * 400 + 4 * 13
    assert nops == 5 * 400 + (10 * 128 * 8 + 14 * 257) + 2 * nnz + 23 + 2 * 23 * 13 + 13


def test_mfcc_work_rejects_other_windows():
    cfg = FrontendConfig(frame_length_ms=24.0, round_to_power_of_two=False)  # N = 384
    with pytest.raises(ValueError):
        roofline.mfcc_work(make_frontend_params(cfg, "cpu"), 1, 400, 1)


def test_k1_bound_at_the_main_path_shape():
    """PERF.md section 6's K1 bound: 0.0029 ms at [32, 48000] -> [32, 298,
    40], bound by operations, on the flagship frontend."""
    params = make_frontend_params(FrontendConfig(num_mel_bins=40, num_ceps=40), "cpu")
    T = num_frames(params.cfg, 48000)
    assert T == 298
    ms, by = roofline.bound(*roofline.mfcc_work(params, 32, 48000, T))
    assert by == "operations" and round(ms, 4) == 0.0029


def _tiny_graph():
    """3 states, 4 arcs (two self-loops, 0 -> 1, 1 -> 2), pdfs 0-7 of 8."""
    return DenseGraph(
        num_states=3, arc_src=np.array([0, 0, 1, 1], np.int32),
        arc_dst=np.array([0, 1, 1, 2], np.int32), arc_pdf=np.array([0, 0, 7, 7], np.int32),
        arc_wseq=np.zeros(4, np.int32), arc_weight=np.zeros(4, np.float32),
        final_weight=np.array([NEG_INF_F32, NEG_INF_F32, 0.0], np.float32),
        final_wseq=np.zeros(3, np.int32),
        init_weight=np.array([0.0, NEG_INF_F32, NEG_INF_F32], np.float32),
        init_wseq=np.zeros(3, np.int32), word_seqs=[()], num_pdfs=8,
    )


def test_viterbi_work_by_hand():
    """B=2, T=3, one stream 2 frames long: the log-probs read are one
    32-byte sector (pdfs 0 and 7) an active frame; uint16 backpointers for
    every frame."""
    g = DecodeGraph.from_dense(_tiny_graph(), "cpu")
    lengths = torch.tensor([3, 2])
    parts = roofline.viterbi_bytes(g, 2, 3, 8, lengths)
    tables = 8 * 4 + 4 * 4 + 8 * 3 + (2 * 3 if g.folded else 4 * 4)
    assert parts == {"lengths": 8, "graph": tables, "log_probs": 32 * 5, "backpointers": 2 * 3 * 2 * 3,
                     "alpha": 4 * 2 * 3, "traces": 4 * 2 * 3, "final_state_and_cost": 16}
    assert roofline.viterbi_work(g, 2, 3, 8, lengths) == (sum(parts.values()), 5 * (3 * 4 + 2 * 3))


def test_windowed_relax_and_pitch_work_by_hand():
    assert roofline.windowed_relax_work(2, 3, 256, 5) == (
        8 * 5 + 12 * 5 * 128 + 2 * 2 * 3 * 256 + 4 * 3 * 256, 3 * 2 * 3 * 5 * 128)
    assert roofline.pitch_work(2, 4, 10) == (4 * 2 * 4 * 10 + 40 + 4 * 2 * 4, 2 * 2 * 3 * 100)


def test_am_work_by_hand():
    """One affine component 4 -> 3 over 2 frames of 5 streams: 2 x 5 x 2 x
    12 operations; its 15 parameters, the features and the log-probs moved
    once."""
    spec = Nnet3Spec(
        nodes=[NodeSpec(kind="input", name="input", dim=4),
               NodeSpec(kind="component", name="affine", component="affine", input=("node", "input")),
               NodeSpec(kind="output", name="output", input=("node", "affine"))],
        components={"affine": ComponentSpec("affine", "AffineComponent", {
            "LinearParams": np.ones((3, 4), np.float32), "BiasParams": np.zeros(3, np.float32)})},
    )
    model = compile_nnet3(spec, num_out_frames=2, subsampling=1, device="cpu")
    assert roofline.am_work(model, 5, (2, 4), 0) == (15 * 4 + 4 * 5 * 2 * 4 + 4 * 5 * 2 * 3,
                                                     2 * 5 * 2 * 12)
    assert roofline.am_work(model.cast(torch.bfloat16), 5, (2, 4), 0)[0] == (
        15 * 2 + 4 * 5 * 2 * 4 + 4 * 5 * 2 * 3)
