"""Whole runs of each cell on the CPU at a tiny size: the result line, the
comparison with the reference, its control and the faults it must catch.

Each test drives ``harness.main.run`` past the look for a card (the CLI
refuses to run without one, ``test_cli_needs_a_card``), on the port's
plain twins."""

import json

import pytest
import torch

from conftest import tiny_cell

from benchmark.harness import main

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run(root, cell, trace=False, control=None, seed=2 ** 31 + 7):
    return main.run(tiny_cell(root, cell), seed, 1.5, trace, "cpu", control)


def test_cli_needs_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    lines = []
    rc = main.main(["--workload", "tdnnf-stream-rt", "--seed", "1", "--seconds", "1"],
                   out=lines.append)
    assert rc == main.EXIT_NO_DEVICE and lines == []


@pytest.mark.parametrize("trace", [False, True])
def test_batch_result_line(tiny_bench, trace):
    res = run(tiny_bench, "tdnnf-batch32", trace)
    assert list(res) == KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    if trace:
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        # no device metric is read from a CPU run
        assert res["metrics"] == {}
    else:
        assert set(res["metrics"]) == {"batch_xrt", "batch_call_p95_ms", "setup_s"}
    json.dumps(res)


def test_stream_result_line(tiny_bench):
    res = run(tiny_bench, "tdnnf-stream-rt")
    assert list(res) == KEYS + ["checks"]
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0
    assert set(res["metrics"]) == {"stream_final_p95_ms", "stream_final_p50_ms", "setup_s"}


def test_batch_control_fails(tiny_bench):
    """The AM in bfloat16 (the program's own path) reads not correct."""
    res = run(tiny_bench, "tdnnf-batch32", control="bf16")
    assert res["correct"] is False
    assert not all(c["value"] <= c["limit"] for c in res["checks"].values())


def _alter_text(orig):
    def wrapper(self, *a, **k):
        out = orig(self, *a, **k)
        return [[t[0] + " lights"] + t[1:] if t else t for t in out]
    return wrapper


def _half_log_probs(orig):
    """Half of the batch left out: the AM's rows for the second half are the
    first half's."""
    def wrapper(self, *a, **k):
        out = orig(self, *a, **k)
        h = out.shape[0] // 2
        if h:
            out = out.clone()
            out[h:2 * h] = out[:h]
        return out
    return wrapper


def test_batch_faults_fail(tiny_bench, monkeypatch):
    from rhasspy_speech_torch.pipeline import transcribe as ptr

    with monkeypatch.context() as m:
        m.setattr(ptr.Nnet3WavTranscriber, "_texts", _alter_text(ptr.Nnet3WavTranscriber._texts))
        res = run(tiny_bench, "tdnnf-batch32")
        assert res["correct"] is False and res["checks"]["answer_faults"]["value"] > 0
    with monkeypatch.context() as m:
        m.setattr(ptr.AcousticModel, "log_probs", _half_log_probs(ptr.AcousticModel.log_probs))
        res = run(tiny_bench, "tdnnf-batch32")
        assert res["correct"] is False


def test_stream_faults_fail(tiny_bench, monkeypatch):
    from rhasspy_speech_torch.models.nnet3 import CompiledNnet3
    from rhasspy_speech_torch.pipeline import device_tick, scheduler
    from rhasspy_speech_torch.pipeline.scheduler import StreamScheduler

    decode = scheduler.viterbi_decode

    def unchanged(graph, log_probs, *a, **k):
        # the decoder's carried state (every slot's alpha) returned as it came
        out = list(decode(graph, log_probs, *a, **k))
        out[3] = k["alpha0"].clone()
        return tuple(out)

    forward = CompiledNnet3.forward

    def half(self, feats, ivector=None):
        # every other lane's outputs are its neighbour's (the slots a few
        # streams hold are the lowest free ones)
        out = forward(self, feats, ivector).clone()
        out[1::2] = out[0::2][: out[1::2].shape[0]]
        return out

    words = StreamScheduler._words_to_result

    def altered(self, ids):
        return [t + " lights" for t in words(self, ids)]

    faults = (((scheduler, "viterbi_decode"), (device_tick, "viterbi_decode")), unchanged), \
        (((CompiledNnet3, "forward"),), half), (((StreamScheduler, "_words_to_result"),), altered)
    for targets, fn in faults:
        with monkeypatch.context() as m:
            for owner, name in targets:
                m.setattr(owner, name, fn)
            res = run(tiny_bench, "tdnnf-stream-rt")
            assert res["correct"] is False, (fn.__name__, res["checks"])
