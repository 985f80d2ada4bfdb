"""Warm start in the port (``utils/warmup.py``), in place of the JAX
package's AOT program store: the cases of tests/test_aot.py, on the CPU.

- ``save_aot`` round trip: a fresh transcriber built beside the manifest
  warms the recorded shape in its constructor and transcribes as the first
  one did, and as the JAX package's transcriber does.
- Shape and configuration keying: the manifest gives a configuration only
  its own shapes; a transcriber of another configuration warms nothing, nor
  does one whose kernel libraries differ from the manifest's.
- The scheduler's ``save_aot`` round trip: a fresh scheduler warms the tick
  bodies in its constructor and serves the same shapes to the spoken
  sentence.
- After a warm construction, the first call adds nothing to the counters of
  what a first call pays (nvcc runs, libraries loaded, AM bucket plans,
  tick bodies run once per key: captures on a card).
"""

import json

import numpy as np
import pytest

from rhasspy_speech_tpu.pipeline import Nnet3WavTranscriber as JaxTranscriber

from rhasspy_speech_torch.const import LangSuffix
from rhasspy_speech_torch.pipeline import Nnet3WavTranscriber, lang_dir_name
from rhasspy_speech_torch.pipeline.scheduler import StreamScheduler
from rhasspy_speech_torch.pipeline.train import train_model_sync
from rhasspy_speech_torch.testing import build_synthetic_profile, synthesize_sentence
from rhasspy_speech_torch.utils.warmup import Manifest, counters

LEX = {
    "turn": ["t", "er", "n"],
    "on": ["aa", "n"],
    "off": ["ao", "f"],
    "light": ["l", "ay", "t"],
}
CHUNK = 21 * 160


@pytest.fixture(scope="module")
def aot_profile(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_warm")
    profile = build_synthetic_profile(tmp / "m", LEX)
    train_model_sync(
        "en",
        {"language": "en", "intents": {"M": {"data": [{"sentences": ["turn (on|off) light"]}]}}},
        tmp / "t", profile.model_dir, lang_suffixes=[LangSuffix.GRAMMAR],
    )
    return profile, tmp / "t" / lang_dir_name(LangSuffix.GRAMMAR)


def _batch(profile):
    pcms = [synthesize_sentence(profile, "turn on light", seed=3),
            synthesize_sentence(profile, "turn off light", seed=4)]
    n = max(p.shape[0] for p in pcms) + 160
    return [np.pad(p, (0, n - p.shape[0])) for p in pcms]


def _sched_pcm(profile):
    """Whole chunks of int16-exact samples, as the warm drive feeds."""
    pcm = synthesize_sentence(profile, "turn on light", seed=6)
    return np.round(pcm[: pcm.shape[0] // CHUNK * CHUNK])


def _serve(sched, pcm):
    sid = sched.open_stream()
    for off in range(0, pcm.shape[0], CHUNK):
        sched.feed(sid, pcm[off : off + CHUNK])
        sched.step()
    sched.finish(sid)
    sched.run_until_idle()
    return sched.poll(sid)


def test_save_aot_roundtrip(aot_profile, tmp_path):
    profile, lang = aot_profile
    pcms = _batch(profile)
    aot = tmp_path / "aot"
    t1 = Nnet3WavTranscriber(profile.model_dir, lang, aot_dir=aot, device="cpu")
    want = t1.transcribe_pcm_batch(pcms)
    assert t1.save_aot(pcms) == aot
    manifest = json.loads((aot / "warmup.json").read_text(encoding="utf-8"))
    assert manifest["batch"]["shapes"] == [[2, pcms[0].shape[0], 1]]

    t2 = Nnet3WavTranscriber(profile.model_dir, lang, aot_dir=aot, device="cpu")
    assert len(t2.am._buckets) == 1  # warmed in the constructor
    got = t2.transcribe_pcm_batch(pcms)
    assert got == want == JaxTranscriber(profile.model_dir, lang).transcribe_pcm_batch(pcms)
    assert got[0] == ["turn on light"]


def test_manifest_shape_keying(aot_profile, tmp_path):
    profile, lang = aot_profile
    store = Manifest(tmp_path / "aot")
    cfg = {"kind": "x", "n": 1}
    store.add("batch", cfg, ["mfcc"], (2, 16000, 1))
    store.add("batch", cfg, ["mfcc"], (2, 16000, 1))
    assert store.shapes("batch", lambda: cfg, ["mfcc"]) == [[2, 16000, 1]]
    assert store.shapes("batch", lambda: {"kind": "x", "n": 2}, ["mfcc"]) == []
    assert store.shapes("scheduler", lambda: cfg, ["mfcc"]) == []
    # another configuration replaces the entry
    store.add("batch", {"kind": "x", "n": 2}, ["mfcc"], (4, 8000, 1))
    assert store.shapes("batch", lambda: cfg, ["mfcc"]) == []

    pcms = _batch(profile)
    aot = tmp_path / "aot2"
    Nnet3WavTranscriber(profile.model_dir, lang, aot_dir=aot, device="cpu").save_aot(pcms)
    other = Nnet3WavTranscriber(profile.model_dir, lang, aot_dir=aot, device="cpu",
                                decode_memory_budget=1 << 28)
    assert len(other.am._buckets) == 0  # another configuration: nothing warmed
    same = Nnet3WavTranscriber(profile.model_dir, lang, aot_dir=aot, device="cpu")
    before = counters(same)
    # a shorter batch lands in another output bucket: a new plan, not the
    # manifest's
    same.transcribe_pcm_batch([p[:8000] for p in pcms])
    assert counters(same)["bucket_plans"] == before["bucket_plans"] + 1


def test_manifest_of_other_kernel_sources_is_ignored(aot_profile, tmp_path):
    """A manifest written for other kernel libraries (a source changed
    since) warms nothing: their first load would run nvcc, which a warm
    start is to spare."""
    profile, lang = aot_profile
    store = Manifest(tmp_path / "aot")
    cfg = {"kind": "x", "n": 1}
    store.add("batch", cfg, ["mfcc"], (2, 16000, 1))
    assert store.shapes("batch", lambda: cfg, ["mfcc", "viterbi"]) == []
    # the other libraries' entry is replaced, not extended
    store.add("batch", cfg, ["mfcc", "viterbi"], (4, 8000, 1))
    assert store.shapes("batch", lambda: cfg, ["mfcc", "viterbi"]) == [[4, 8000, 1]]

    pcms = _batch(profile)
    aot = tmp_path / "aot2"
    Nnet3WavTranscriber(profile.model_dir, lang, aot_dir=aot, device="cpu").save_aot(pcms)
    path = aot / "warmup.json"
    manifest = json.loads(path.read_text(encoding="utf-8"))
    assert manifest["batch"]["kernels"] and all(
        name.startswith("lib") and name.endswith(".so") for name in manifest["batch"]["kernels"])
    manifest["batch"]["kernels"][0] = "libmfcc-0000000000000000.so"
    path.write_text(json.dumps(manifest), encoding="utf-8")
    stale = Nnet3WavTranscriber(profile.model_dir, lang, aot_dir=aot, device="cpu")
    assert len(stale.am._buckets) == 0


def test_scheduler_save_aot_roundtrip(aot_profile):
    profile, lang = aot_profile
    pcm = _sched_pcm(profile)
    s1 = StreamScheduler(profile.model_dir, lang, max_streams=2, device="cpu")
    assert s1._aot is not None
    aot_dir = s1.save_aot(seconds=pcm.shape[0] / 16000.0)
    assert (aot_dir / "warmup.json").is_file()
    try:
        s2 = StreamScheduler(profile.model_dir, lang, max_streams=2, device="cpu")
        assert s2._runner.warm_keys  # the tick bodies ran in the constructor
        assert not s2._retired and s2.active_streams == 0
        assert _serve(s2, pcm) == ["turn on light"]
    finally:
        (aot_dir / "warmup.json").unlink()


def test_warm_first_call_adds_nothing(aot_profile, tmp_path):
    profile, lang = aot_profile
    pcms = _batch(profile)
    aot = tmp_path / "aot"
    Nnet3WavTranscriber(profile.model_dir, lang, aot_dir=aot, device="cpu").save_aot(pcms)
    t = Nnet3WavTranscriber(profile.model_dir, lang, aot_dir=aot, device="cpu")
    before = counters(t)
    t.transcribe_pcm_batch(pcms)
    assert counters(t) == before

    pcm = _sched_pcm(profile)
    aot_dir = StreamScheduler(profile.model_dir, lang, max_streams=2,
                              device="cpu").save_aot(seconds=pcm.shape[0] / 16000.0)
    try:
        s = StreamScheduler(profile.model_dir, lang, max_streams=2, device="cpu")
        before = counters(s)
        assert before["captures"] > 0
        assert _serve(s, pcm) == ["turn on light"]
        assert counters(s) == before
        cold = StreamScheduler(profile.model_dir, lang, max_streams=2, device="cpu",
                               endpointing=None, chunk_out_frames=14)
        assert counters(cold)["captures"] == 0  # another configuration
    finally:
        (aot_dir / "warmup.json").unlink()
