"""The port's command line (``rhasspy_speech_torch.cli``), in process, on
the CPU (``--device cpu``): the cases of tests/test_cli.py. The transcript
equals the JAX package's CLI on the same files, and ``warmup`` writes the
warm-start manifest in place of the JAX package's AOT programs."""

import json
import wave

import numpy as np
import yaml

from rhasspy_speech_tpu.cli import main as jax_main

from rhasspy_speech_torch.cli import main
from rhasspy_speech_torch.testing import build_synthetic_profile, synthesize_sentence

LEXICON = {"open": ["ow", "p"], "door": ["d", "ao", "r"]}


def _train(tmp_path, sentence):
    profile = build_synthetic_profile(tmp_path / "model", LEXICON)
    sentences = tmp_path / "sentences.yaml"
    sentences.write_text(yaml.safe_dump({
        "language": "en",
        "intents": {"M": {"data": [{"sentences": [sentence]}]}},
    }))
    rc = main([
        "train", "--language", "en", "--sentences", str(sentences),
        "--model-dir", str(tmp_path / "model"),
        "--train-dir", str(tmp_path / "train"),
        "--lang-suffixes", "grammar",
    ])
    assert rc == 0
    assert (tmp_path / "train" / "lang_grammar" / "graph.npz").exists()
    return profile


def test_cli_train_and_transcribe(tmp_path, capsys):
    profile = _train(tmp_path, "open [door]")
    pcm = synthesize_sentence(profile, "open door", seed=1)
    wav = tmp_path / "u.wav"
    with wave.open(str(wav), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.astype(np.int16).tobytes())

    args = ["transcribe", str(wav), "--model-dir", str(tmp_path / "model"),
            "--graph-dir", str(tmp_path / "train" / "lang_grammar")]
    capsys.readouterr()
    assert main(args + ["--device", "cpu"]) == 0
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert record["text"] == "open door"
    assert jax_main(args) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == record


def test_cli_warmup(tmp_path, capsys):
    _train(tmp_path, "open door")
    graph_dir = tmp_path / "train" / "lang_grammar"
    rc = main([
        "warmup", "--model-dir", str(tmp_path / "model"), "--graph-dir", str(graph_dir),
        "--batch", "2", "--seconds", "1.0", "--streams", "2", "--device", "cpu",
    ])
    assert rc == 0
    manifest = json.loads((graph_dir / "aot" / "warmup.json").read_text(encoding="utf-8"))
    assert manifest["batch"]["shapes"] == [[2, 16000, 1]]
    assert manifest["batch"]["config"]["device"] == "cpu"
    assert {n.split("-")[0] for n in manifest["batch"]["kernels"]} == {"libmfcc", "libviterbi"}
    assert manifest["scheduler"]["shapes"] == [[1.0]]
    assert manifest["scheduler"]["config"]["max_streams"] == 2
    assert "libpath_walk" in {n.split("-")[0] for n in manifest["scheduler"]["kernels"]}
