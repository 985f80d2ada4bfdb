"""The port's public names and signatures against the JAX package's.

``rhasspy_speech_torch``, ``rhasspy_speech_torch.pipeline`` and
``rhasspy_speech_torch.parallel`` export every name the JAX package's
``__all__`` lists. The transcriber, the stream scheduler and the Coqui
transcriber take the reference's arguments in the reference's order, then
``device``; ``ShardedWavTranscriber`` takes the reference's ``mesh``.
``aot_dir`` and ``save_aot`` answer (the warm-start manifest,
``utils/warmup.py``), and ``aot_dir=None`` changes nothing.
"""

import dataclasses
import inspect

import pytest

import rhasspy_speech_tpu
import rhasspy_speech_tpu.parallel
import rhasspy_speech_tpu.pipeline
from rhasspy_speech_tpu.pipeline.coqui import CoquiSttTranscriber as JaxCoqui
from rhasspy_speech_tpu.pipeline.scheduler import StreamScheduler as JaxScheduler

import rhasspy_speech_torch
import rhasspy_speech_torch.parallel
import rhasspy_speech_torch.pipeline
from rhasspy_speech_torch.const import LangSuffix
from rhasspy_speech_torch.pipeline import Nnet3WavTranscriber, lang_dir_name
from rhasspy_speech_torch.pipeline.coqui import CoquiSttTranscriber
from rhasspy_speech_torch.pipeline.scheduler import StreamScheduler
from rhasspy_speech_torch.pipeline.train import train_model_sync
from rhasspy_speech_torch.testing import build_synthetic_profile, synthesize_sentence

from test_torch_pipeline import LEXICON

@pytest.mark.parametrize("ref,port", [
    (rhasspy_speech_tpu, rhasspy_speech_torch),
    (rhasspy_speech_tpu.pipeline, rhasspy_speech_torch.pipeline),
    (rhasspy_speech_tpu.parallel, rhasspy_speech_torch.parallel),
], ids=["package", "pipeline", "parallel"])
def test_exports_cover_the_reference(ref, port):
    missing = set(ref.__all__) - set(port.__all__)
    assert not missing, missing
    for name in port.__all__:
        assert hasattr(port, name), name


def test_version_and_public_types_equal_the_reference():
    assert rhasspy_speech_torch.__version__ == rhasspy_speech_tpu.__version__
    for name in ("LangSuffix", "ModelType", "WordCasing"):
        ours, theirs = getattr(rhasspy_speech_torch, name), getattr(rhasspy_speech_tpu, name)
        assert [(m.name, m.value) for m in ours] == [(m.name, m.value) for m in theirs]
    ours, theirs = rhasspy_speech_torch.KaldiTools, rhasspy_speech_tpu.KaldiTools
    assert [f.name for f in dataclasses.fields(ours)] == [f.name for f in dataclasses.fields(theirs)]
    assert ours.from_tools_dir("/t") == ours(**dataclasses.asdict(theirs.from_tools_dir("/t")))
    with pytest.raises(RuntimeError, match="in-process"):
        ours().async_run("ls")


@pytest.mark.parametrize("ours,theirs", [
    (Nnet3WavTranscriber, rhasspy_speech_tpu.Nnet3WavTranscriber),
    (StreamScheduler, JaxScheduler),
    (CoquiSttTranscriber, JaxCoqui),
], ids=["transcriber", "scheduler", "coqui"])
def test_signature_is_the_reference_plus_device(ours, theirs):
    want = list(inspect.signature(theirs.__init__).parameters.items())
    got = list(inspect.signature(ours.__init__).parameters.items())
    assert [n for n, _ in got] == [n for n, _ in want] + ["device"]
    assert [p.default for _, p in got[:-1]] == [p.default for _, p in want]
    assert got[-1][1].default == "cuda"


@pytest.fixture(scope="module")
def profile_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_api")
    profile = build_synthetic_profile(root / "model", LEXICON)
    intents = {"language": "en", "intents": {"Main": {"data": [{"sentences": ["never mind"]}]}}}
    train_model_sync("en", intents, root / "train", profile.model_dir,
                     lang_suffixes=[LangSuffix.GRAMMAR])
    return profile, root / "train" / lang_dir_name(LangSuffix.GRAMMAR)


def test_sharded_transcriber_takes_the_reference_mesh():
    ours = inspect.signature(rhasspy_speech_torch.ShardedWavTranscriber.__init__).parameters
    theirs = inspect.signature(rhasspy_speech_tpu.ShardedWavTranscriber.__init__).parameters
    assert list(ours) == list(theirs) and ours["mesh"].default is None


def test_aot_store_raises_and_none_changes_nothing(profile_dirs, tmp_path):
    """An empty ``aot_dir`` warms nothing, ``save_aot`` writes the manifest
    there and returns the directory; ``aot_dir=None`` reads
    ``<graph_dir>/aot`` (empty here) and changes nothing. No error names
    item 17 any more."""
    profile, graph_dir = profile_dirs
    t = Nnet3WavTranscriber(profile.model_dir, graph_dir, aot_dir=tmp_path, device="cpu")
    assert not t.am._buckets
    pcm = synthesize_sentence(profile, "never mind", seed=5)
    assert t.transcribe_pcm_batch([pcm]) == [["never mind"]]
    assert t.save_aot([pcm]) == tmp_path
    assert [p.name for p in tmp_path.iterdir()] == ["warmup.json"]
    t0 = Nnet3WavTranscriber(profile.model_dir, graph_dir, aot_dir=None, device="cpu")
    assert not t0.am._buckets
    assert t0.transcribe_pcm_batch([pcm]) == [["never mind"]]
