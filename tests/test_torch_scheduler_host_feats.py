"""The stream scheduler's device route with ``snip_edges=false``, on the CPU.

With centred frames (``snip_edges=false``) the scheduler keeps the
backpointers in the device ring, walked once a tick, but its features on
the host: the featurizer reflects a stream's first samples, which the
fused tick's feature ring does not do (``_device_feats`` false, the
``_step_chunk`` body). With the extractor's CMVN stats the i-vector tap
window is staged on the host too (``_iv_carry_device`` false).

Two synthetic profiles are rewritten to ``snip_edges=false``: the GMM
profile, and the nnet3 profile with an i-vector extractor, an AM context
over its tap and the extractor's CMVN stats. Four spoken sentences with
1 s of trailing silence go to 4 slots in 1,024-sample pushes, never
finished, with endpointing (and, on the nnet3 profile, with
``silence_weight`` too, which that profile's tap keeps on the device
route). The route flags equal the JAX scheduler's; transcripts equal the
host route's (forced) and the spoken sentences; every stream's endpoint
fires exactly one tick after the host route's, the lag rule on the CPU
(``pipeline/scheduler.py``).
"""

import json

import numpy as np
import pytest

from rhasspy_speech_tpu.pipeline.endpoint import EndpointConfig as JaxEndpointConfig
from rhasspy_speech_tpu.pipeline.scheduler import StreamScheduler as JaxScheduler

from rhasspy_speech_torch.const import LangSuffix
from rhasspy_speech_torch.pipeline import lang_dir_name
from rhasspy_speech_torch.pipeline import scheduler as sched_mod
from rhasspy_speech_torch.pipeline.endpoint import EndpointConfig
from rhasspy_speech_torch.pipeline.scheduler import StreamScheduler
from rhasspy_speech_torch.pipeline.train import train_model_sync
from rhasspy_speech_torch.testing import build_synthetic_profile
from rhasspy_speech_torch.testing.synthetic import (
    _silence_wave,
    build_synthetic_gmm_profile,
    synthesize_sentence,
)

from test_torch_pipeline import LEXICON

GRAMMAR = ["turn (on|off) [the] (light|fan)", "never mind"]
SPOKEN = ["turn on the light", "never mind", "turn off the fan", "turn on fan"]
FLAGS = ("_device_bp", "_device_feats", "_ep_device", "_sw_device", "_iv_inline",
         "_iv_cmvn_device")
PUSH = 1024
BUILDERS = {
    "gmm": lambda d: build_synthetic_gmm_profile(d, LEXICON),
    "nnet3": lambda d: build_synthetic_profile(d, LEXICON, with_ivector=True, with_context=True,
                                               with_ivector_cmvn=True),
}


@pytest.fixture(scope="module")
def profiles(tmp_path_factory):
    """kind -> (model dir, graph dir, speech), built on first use."""
    cache = {}

    def get(kind):
        if kind not in cache:
            root = tmp_path_factory.mktemp(f"host_feats_{kind}")
            profile = BUILDERS[kind](root / "model")
            fj = profile.model_dir / "model" / "frontend.json"
            cfg = json.loads(fj.read_text(encoding="utf-8"))
            fj.write_text(json.dumps({**cfg, "snip_edges": False}), encoding="utf-8")
            intents = {"language": "en", "intents": {"Main": {"data": [{"sentences": GRAMMAR}]}}}
            train_model_sync("en", intents, root / "train", profile.model_dir,
                             lang_suffixes=[LangSuffix.GRAMMAR])
            rng = np.random.RandomState(0)
            pcms = [np.concatenate([synthesize_sentence(profile, t, seed=100 + i),
                                    _silence_wave(16000, rng)]).astype(np.float32)
                    for i, t in enumerate(SPOKEN)]
            cache[kind] = (profile.model_dir, root / "train" / lang_dir_name(LangSuffix.GRAMMAR), pcms)
        return cache[kind]

    return get


def _endpoint_run(s, pcms):
    """(transcripts, the tick each stream's endpoint fired on)."""
    sids = [s.open_stream() for _ in pcms]
    fired = [None] * len(sids)
    ticks = 0

    def tick():
        nonlocal ticks
        s.step()
        ticks += 1
        for i, sid in enumerate(sids):
            if fired[i] is None and s.slots[sid].done:
                fired[i] = ticks

    for off in range(0, max(p.shape[0] for p in pcms), PUSH):
        for sid, pcm in zip(sids, pcms):
            if off < pcm.shape[0]:
                s.feed(sid, pcm[off : off + PUSH])
        tick()
    for _ in range(100):
        if all(s.poll(sid) is not None for sid in sids):
            break
        tick()
    assert not any(s.pool.is_finished(sid) for sid in sids)
    return [s.poll(sid) for sid in sids], fired


@pytest.mark.parametrize("kind,sw", [("gmm", None), ("nnet3", None), ("nnet3", 0.01)],
                         ids=["gmm", "nnet3", "nnet3_silence_weight"])
def test_host_features_device_ring_equals_host_route(profiles, monkeypatch, kind, sw):
    model_dir, graph_dir, pcms = profiles(kind)
    kw = dict(max_streams=len(pcms), silence_weight=sw, pool_capacity_samples=16000 * 10)
    s = StreamScheduler(model_dir, graph_dir, endpointing=EndpointConfig(), device="cpu", **kw)
    j = JaxScheduler(model_dir, graph_dir, endpointing=JaxEndpointConfig(), **kw)
    assert {f: getattr(s, f) for f in FLAGS} == {f: getattr(j, f) for f in FLAGS}
    assert s._device_bp and s._ep_device and not s._device_feats and not s._featurizer.snip
    assert s._sw_device == (sw is not None)
    if kind == "nnet3":
        assert s._iv_inline and s._iv_cmvn_device and not s._iv_carry_device
    texts, fired = _endpoint_run(s, pcms)
    monkeypatch.setattr(sched_mod, "_BP_RING_MAX_ARC", -1)
    host = StreamScheduler(model_dir, graph_dir, endpointing=EndpointConfig(), device="cpu", **kw)
    assert not host._device_bp
    host_texts, host_fired = _endpoint_run(host, pcms)
    assert texts == host_texts == [[t] for t in SPOKEN]
    assert fired == [f + 1 for f in host_fired]
