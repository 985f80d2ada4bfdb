"""The port's example scripts (``rhasspy_speech_torch/examples/``) on the CPU
at tiny arguments: each ``main(argv)`` with ``--device cpu`` returns what it
printed, and importing an example loads no module of ``jax``, ``jaxlib``,
``rhasspy_speech_tpu`` or the repository's ``bench.py``. Without a card,
``--device cuda`` (the default) raises before any work. The results are
held to the JAX package's in tests/test_torch_examples_vs_jax.py."""

import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rhasspy_speech_torch.examples import (
    decode_roofline,
    frontier_curve,
    inspect_utterance,
    rescore_oov,
    serve_multichip,
    serve_streams,
    tick_device_profile,
)
from rhasspy_speech_torch.io.lattice_io import read_lattice_ark
from rhasspy_speech_torch.ops.viterbi_cuda import H100_MAX_SMEM, alpha_fits
from rhasspy_speech_torch.pipeline.scheduler import StreamScheduler
from rhasspy_speech_torch.utils import roofline

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = ("serve_streams", "serve_multichip", "inspect_utterance", "rescore_oov",
            "tick_device_profile", "decode_roofline", "frontier_curve")
CPU = ["--device", "cpu"]
# a TDNN-F of the flagship's depth (its context covers the i-vector tap, so
# the scheduler keeps its features on the device route) at narrow widths
NARROW = ["--hidden", "32", "--layers", "9", "--ivector-dim", "8"]


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_imports_no_jax(name):
    code = (f"import sys; sys.path.insert(0, {str(REPO)!r}); "
            f"import rhasspy_speech_torch.examples.{name}; "
            "print(sorted(m for m in sys.modules if m.partition('.')[0] in "
            "('jax', 'jaxlib', 'rhasspy_speech_tpu', 'bench')))")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         cwd=REPO)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_raises_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda runs")
    module = sys.modules[f"rhasspy_speech_torch.examples.{name}"]
    with pytest.raises(RuntimeError, match="cuda"):
        module.main([])


@pytest.mark.parametrize("wire", ["i16", "mulaw", "adpcm"])
def test_serve_streams(wire):
    out = serve_streams.main(["3", "--wire", wire] + CPU)
    assert out["device_route"] and out["wire"] == wire and out["device"] == "cpu"
    assert len(out["transcripts"]) == 3 and all(r is not None for r in out["transcripts"])
    if wire != "adpcm":  # ADPCM is a lossy 4-bit wire
        assert out["exact"] == 3 and out["transcripts"] == [[t] for t in out["texts"]]
    assert out["ticks"] > 0 and out["tick_p50_ms"] <= out["tick_p90_ms"]
    assert out["fleet_rtf"] == pytest.approx(out["wall_s"] / out["audio_s"])
    assert out["metrics"]["utterances"] == 3 and "stream_issue_fused" in out["metrics"]["stages"]
    assert out["metrics"]["tick_ms"]["fused"]["ticks"] > 0
    expected = {"mfcc", "viterbi", "path_walk", "tick_stamp"}
    expected |= {"adpcm_decode"} if wire == "adpcm" else set()
    assert set(out["kernel_launches"]) == expected  # all 0: the CPU runs the twins


def test_serve_multichip():
    out = serve_multichip.main(["4", "--devices", "cpu,cpu"] + CPU)
    assert out["mesh"] == ["cpu", "cpu"]
    assert out["transcripts"] == out["single"] == [[t] for t in out["texts"]]
    assert out["exact"] == 4


def test_inspect_utterance(tmp_path):
    ark = tmp_path / "lat.ark"
    out = inspect_utterance.main(["--ark", str(ark)] + CPU)
    assert out["transcript"] == [inspect_utterance.TEXT]
    assert 0.0 <= out["confidence"] <= 1.0
    assert out["nbest"][0][0] == inspect_utterance.TEXT.split()
    costs = [c for _w, c in out["nbest"]]
    assert costs == sorted(costs)
    (key, lat), = list(read_lattice_ark(ark))
    assert key == "utt-0"
    assert (lat.num_states, lat.num_arcs()) == (out["lattice_states"], out["lattice_arcs"])


def test_rescore_oov():
    out = rescore_oov.main(CPU)
    assert out["rescored"][0] == rescore_oov.RECOVERED
    assert all("read" not in text for text in out["first_pass"])


def test_tick_device_profile():
    out = tick_device_profile.main(["--lanes", "2", "--M", "2", "--graph", "flagship", "--seconds",
                                    "0.5", "--ubm-gauss", "4", "--no-endpoint"] + NARROW + CPU)
    assert out["graph"] == "flagship" and out["lanes"] == 2 and not out["endpoint"]
    assert out["states"] == 803 and out["k2_body"] == "twin"
    # no card: the device probes are not measured
    assert out["device_exec_ms"] is None and out["run_ms"] is None and out["h2d_ms"] is None
    assert out["upload_bytes"] > 0 and out["ticks"] > 0
    assert set(out["launches_per_replay"]) == {"mfcc", "viterbi", "path_walk", "tick_stamp"}
    assert 0 < out["captured_p50_ms"] <= out["captured_p90_ms"]
    assert 0 < out["eager_p50_ms"] <= out["eager_p90_ms"]
    assert set(out["host_p50_ms"]) == {"step_ms", "wait_ms", "prep", "launch", "pace", "harvest"}
    assert out["tick_stages_ms"]["fused"]["ticks"] > 0 and out["tick_stages_ms"]["fused"]["am"] > 0


def test_tick_device_profile_seeded30000_graph(tmp_path):
    """The ``seeded30000`` graph (30,000 states, every one final) under a
    big-grammar model dir keeps the scheduler on its fused device route,
    past K2's replicated body (served on the card by chip_smoke.py)."""
    args = argparse.Namespace(graph="seeded30000", model_dir=None, graph_dir=None, hidden=32,
                              layers=9, ivector_dim=8, ubm_gauss=4)
    model_dir, graph_dir = tick_device_profile.build_dirs(tmp_path, args)
    sched = StreamScheduler(model_dir, graph_dir, max_streams=2, device="cpu")
    g = sched.graph
    assert (g.num_states, g.num_arcs) == (30000, 62400) and (g.final_weight == 0.0).all()
    assert sched._device_bp and sched._device_feats
    assert not alpha_fits(g.num_states, H100_MAX_SMEM)


def test_tick_device_profile_refuses_host_route():
    """A net too shallow to cover the i-vector tap keeps the features on
    the host: the profile, which times the fused tick, raises."""
    with pytest.raises(RuntimeError, match="fused device route"):
        tick_device_profile.main(["--lanes", "2", "--graph", "flagship", "--hidden", "32",
                                  "--layers", "2", "--ivector-dim", "8", "--ubm-gauss", "4"] + CPU)


def test_decode_roofline():
    out = decode_roofline.main(["2", "1.0", "--bf16"] + NARROW[:2] + ["--layers", "2",
                                                                       "--ivector-dim", "8"] + CPU)
    assert out["states"] == 13789 and out["n_out"] == -(-out["T"] // 3)
    stages = out["stages"]
    assert list(stages) == ["mfcc", "am_forward", "am_forward_bf16", "decode"]
    for r in stages.values():
        assert r["ms"] is None and r["span_ms"] is None and r["share"] is None  # no card
        assert r["bytes"] > 0 and r["ops"] > 0
        assert r["bound_ms"] == roofline.bound(r["bytes"], r["ops"], ops_per_s=(
            roofline.BF16_OPS_PER_S if r is stages["am_forward_bf16"] else roofline.F32_OPS_PER_S))[0]
    assert stages["am_forward_bf16"]["ops"] == stages["am_forward"]["ops"]
    assert stages["am_forward_bf16"]["bytes"] < stages["am_forward"]["bytes"]
    assert 0.0 < stages["decode"]["backpointer_share"] < 1.0


def test_frontier_curve():
    out = frontier_curve.main(["3", "20", "2", "--k", "2,8", "--areas", "3", "--devices", "2",
                               "--scenes", "2"] + CPU)
    assert [c["k"] for c in out["curve"]] == [2, 8]
    assert out["exact_cost"].shape == (2,) and np.isfinite(out["exact_cost"]).all()
    for c in out["curve"]:
        # the frontier never beats the exact decode
        assert (c["cost"] >= out["exact_cost"] - 1e-3).all()
        assert 0.0 <= c["agreement"] <= 1.0
