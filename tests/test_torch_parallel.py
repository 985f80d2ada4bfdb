"""Stream-parallel sharding in the port (``rhasspy_speech_torch.parallel``
and ``StreamScheduler(mesh=...)``) on the CPU, over meshes of 2 and 4
``"cpu"`` entries: the cases of tests/test_parallel.py.

- The mesh's shape; ``make_stream_mesh()`` without a card raises instead of
  falling back to CPU devices (a CPU mesh is asked for with ``devices=``).
- ``shard_streams`` places contiguous shards; a sharded decode equals the
  unsharded one.
- ``ShardedWavTranscriber`` (a batch that is no multiple of the mesh,
  padded) and the scheduler under a mesh (on the i16, mu-law and ADPCM
  wires) equal the unsharded port and the JAX package's single-device
  transcripts, also with endpointing and silence weighting.
- Admission fills the blocks evenly; a quarantine on one block does not
  stall the others.
"""

import numpy as np
import pytest

from rhasspy_speech_tpu.pipeline import Nnet3WavTranscriber as JaxTranscriber
from rhasspy_speech_tpu.pipeline.scheduler import StreamScheduler as JaxScheduler

import torch

from rhasspy_speech_torch import ShardedWavTranscriber
from rhasspy_speech_torch.const import LangSuffix
from rhasspy_speech_torch.ops.decoder import DecodeGraph, traces_to_words_batch
from rhasspy_speech_torch.ops.viterbi_cuda import viterbi_decode
from rhasspy_speech_torch.parallel import make_stream_mesh, shard_streams, sharded_decode_fn
from rhasspy_speech_torch.pipeline import Nnet3WavTranscriber, lang_dir_name
from rhasspy_speech_torch.pipeline.endpoint import EndpointConfig
from rhasspy_speech_torch.pipeline.scheduler import MeshScheduler, StreamScheduler
from rhasspy_speech_torch.pipeline.train import train_model_sync
from rhasspy_speech_torch.testing import build_synthetic_profile, synthesize_sentence
from rhasspy_speech_torch.testing.decode_graphs import random_decode_graph
from rhasspy_speech_torch.testing.synthetic import _silence_wave

LEXICON = {
    "turn": ["t", "er", "n"],
    "on": ["aa", "n"],
    "off": ["ao", "f"],
    "light": ["l", "ay", "t"],
    "fan": ["f", "ae", "n"],
}
TEXTS = ["turn on light", "turn off fan", "turn on fan"]


def cpu_mesh(n):
    return make_stream_mesh(devices=["cpu"] * n)


def _train(root, lexicon, sentence, **profile_kw):
    profile = build_synthetic_profile(root / "model", lexicon, **profile_kw)
    train_model_sync("en", {"language": "en", "intents": {"M": {"data": [
        {"sentences": [sentence]}]}}}, root / "train", profile.model_dir,
        lang_suffixes=[LangSuffix.GRAMMAR])
    return profile, root / "train" / lang_dir_name(LangSuffix.GRAMMAR)


@pytest.fixture(scope="module")
def plain(tmp_path_factory):
    return _train(tmp_path_factory.mktemp("torch_parallel"), LEXICON, "turn (on|off) (light|fan)")


@pytest.mark.parametrize("n", [2, 4])
def test_mesh_shape(n):
    mesh = cpu_mesh(n)
    assert mesh.shape == {"streams": n} and mesh.size == n
    assert all(d == torch.device("cpu") for d in mesh.devices)
    assert make_stream_mesh(2, devices=["cpu"] * 4).size == 2
    with pytest.raises(ValueError, match="need 5 devices"):
        make_stream_mesh(5, devices=["cpu"] * 4)
    if not torch.cuda.is_available():
        # no silent fall back to CPU devices
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_stream_mesh()


def test_shard_streams_placement():
    mesh = cpu_mesh(4)
    x = np.random.RandomState(0).randn(16, 4).astype(np.float32)
    shards = shard_streams(mesh, x)
    assert [tuple(s.shape) for s in shards] == [(4, 4)] * 4
    np.testing.assert_array_equal(torch.cat(shards).numpy(), x)
    a, b = shard_streams(mesh, x, x[:, :2])
    assert tuple(b[3].shape) == (4, 2)
    with pytest.raises(ValueError, match="split evenly"):
        shard_streams(mesh, x[:6])


def test_sharded_decode_equals_unsharded():
    rng = np.random.RandomState(0)
    dense = random_decode_graph(rng, num_states=40, extra_arcs=60, num_pdfs=12, hubs=0)
    graph = DecodeGraph.from_dense(dense, "cpu")
    B, T = 8, 10
    lp = np.log(rng.dirichlet(np.ones(dense.num_pdfs), size=(B, T))).astype(np.float32)
    plain_out = viterbi_decode(graph, torch.as_tensor(lp))
    for n in (2, 4):
        f = sharded_decode_fn(cpu_mesh(n), lambda x, g: viterbi_decode(g, x))
        sharded = f(lp, graph)
        for a, b in zip(plain_out, sharded):
            assert torch.equal(a, b)
    w1 = traces_to_words_batch(dense, *(t.numpy() for t in plain_out))
    w2 = traces_to_words_batch(dense, *(t.numpy() for t in sharded))
    assert [w for w, _ in w1] == [w for w, _ in w2]


def test_sharded_transcriber_matches_single_chip(plain):
    profile, lang = plain
    pcms = [synthesize_sentence(profile, t, seed=100 + i) for i, t in enumerate(TEXTS)]
    single = Nnet3WavTranscriber(profile.model_dir, lang, device="cpu")
    sharded = ShardedWavTranscriber(profile.model_dir, lang, mesh=cpu_mesh(4))
    assert sharded._shard_count == 4 and len(sharded.replicas) == 4
    want = single.transcribe_pcm_batch(pcms)
    assert sharded.transcribe_pcm_batch(pcms) == want  # B = 3, padded to 4
    assert want == JaxTranscriber(profile.model_dir, lang).transcribe_pcm_batch(pcms)
    assert [g[0] for g in want] == TEXTS
    kw = dict(nbest=3, max_fuzzy_cost=2.0)
    want_n = single.transcribe_pcm_batch(pcms, **kw)
    assert sharded.transcribe_pcm_batch(pcms, **kw) == want_n
    assert [g[0] for g in want_n] == TEXTS


def _run_whole(sched, pcms):
    sids = [sched.open_stream() for _ in pcms]
    for sid, pcm in zip(sids, pcms):
        sched.feed(sid, pcm)
        sched.finish(sid)
    for _ in range(200):
        if all(sched.poll(sid) is not None for sid in sids):
            break
        sched.step()
    return [sched.poll(sid) for sid in sids]


def test_sharded_scheduler_matches_unsharded(plain):
    profile, lang = plain
    with pytest.raises(ValueError, match="multiple of the mesh size"):
        StreamScheduler(profile.model_dir, lang, max_streams=6, mesh=cpu_mesh(4), device="cpu")
    pcms = [synthesize_sentence(profile, t, seed=300 + i) for i, t in enumerate(TEXTS)]
    want = _run_whole(StreamScheduler(profile.model_dir, lang, max_streams=4, device="cpu"), pcms)
    assert want == [[t] for t in TEXTS]
    assert _run_whole(JaxScheduler(profile.model_dir, lang, max_streams=4), pcms) == want
    for wire in ("i16", "mulaw", "adpcm"):
        sched = StreamScheduler(profile.model_dir, lang, max_streams=4, mesh=cpu_mesh(2),
                                wire=wire)
        assert isinstance(sched, MeshScheduler) and len(sched.shards) == 2
        assert sched._device_feats and sched._wire == wire
        assert _run_whole(sched, pcms) == want, wire


def test_sharded_scheduler_endpoint_and_silence_weighting(tmp_path):
    """Endpointing and silence weighting ride each block's device tick:
    a never-finished stream endpoints to the same transcript as without a
    mesh."""
    lexicon = {k: LEXICON[k] for k in ("turn", "on", "light")}
    profile, lang = _train(tmp_path, lexicon, "turn on light", with_ivector=True,
                           with_context=True)
    speech = synthesize_sentence(profile, "turn on light", seed=11)
    pcm = np.concatenate([speech, _silence_wave(16000 * 3, np.random.RandomState(2))])

    def run(sched):
        assert sched._ep_device and sched._sw_device and sched._device_feats
        sid = sched.open_stream()
        sched.feed(sid, pcm)
        for _ in range(150):
            if sched.poll(sid) is not None:
                break
            sched.step()
        return sched.poll(sid)

    kw = dict(max_streams=4, endpointing=EndpointConfig(), silence_weight=0.01)
    single = run(StreamScheduler(profile.model_dir, lang, device="cpu", **kw))
    assert run(StreamScheduler(profile.model_dir, lang, mesh=cpu_mesh(2), **kw)) == single
    assert single == ["turn on light"]


def test_mesh_balanced_admission(plain):
    profile, lang = plain
    sched = StreamScheduler(profile.model_dir, lang, max_streams=8, mesh=cpu_mesh(4))
    per = 2
    sids = [sched.open_stream() for _ in range(4)]
    assert sorted(s // per for s in sids) == list(range(4)), sids
    more = [sched.open_stream() for _ in range(4)]
    assert sorted(s // per for s in more) == list(range(4)), more
    assert sched.open_stream() == -1 and sched.active_streams == 8
    sched.close(sids[1])
    reopened = sched.open_stream()
    assert reopened // per == sids[1] // per


def test_mesh_quarantine_does_not_stall_other_shards(plain):
    profile, lang = plain
    # the pool and rings hold ~1 s: a 4x longer stream overruns them
    sched = StreamScheduler(profile.model_dir, lang, max_streams=8, mesh=cpu_mesh(4),
                            pool_capacity_samples=16000)
    text = "turn on light"
    good = [synthesize_sentence(profile, text, seed=400 + i) for i in range(3)]
    runaway = np.tile(synthesize_sentence(profile, text, seed=499), 4)
    bad_sid = sched.open_stream()
    good_sids = [sched.open_stream() for _ in good]
    assert len({s // 2 for s in [bad_sid] + good_sids}) == 4  # one a block
    off_b, offs = 0, [0] * len(good)
    for _ in range(600):
        if off_b < runaway.shape[0]:
            off_b += sched.feed(bad_sid, runaway[off_b : off_b + 4096])
            if off_b >= runaway.shape[0]:
                sched.finish(bad_sid)
        for i, sid in enumerate(good_sids):
            if offs[i] < good[i].shape[0]:
                offs[i] += sched.feed(sid, good[i][offs[i] : offs[i] + 4096])
                if offs[i] >= good[i].shape[0]:
                    sched.finish(sid)
        sched.step()
        done = all(sched.poll(s, block=False) is not None for s in good_sids)
        if done and sched.poll(bad_sid, block=False) is not None and off_b >= runaway.shape[0]:
            break
    assert sched.error(bad_sid) is not None, "the runaway stream must be quarantined"
    for sid in good_sids:
        assert sched.poll(sid) == [text], sched.poll(sid)


def test_mesh_scheduler_forwards_the_scheduler_api(plain):
    """The mesh scheduler holds one scheduler a block and answers the
    scheduler's calls by slot id: ``feed_many`` across blocks,
    ``run_until_idle``, ``close`` tickets redeemed by ``take_result``, and
    no warm-start manifest."""
    profile, lang = plain
    sched = StreamScheduler(profile.model_dir, lang, max_streams=4, mesh=cpu_mesh(2))
    assert not isinstance(sched, StreamScheduler)
    assert all(isinstance(s, StreamScheduler) for s in sched.shards)
    pcms = [synthesize_sentence(profile, t, seed=500 + i) for i, t in enumerate(TEXTS[:2])]
    n = max(p.shape[0] for p in pcms)
    rows = np.stack([np.round(np.pad(p, (0, n - p.shape[0]))) for p in pcms]).astype(np.int16)
    sids = [sched.open_stream() for _ in pcms]
    assert sorted(s // 2 for s in sids) == [0, 1]
    assert list(sched.feed_many(np.asarray(sids), rows)) == [n, n]
    for sid in sids:
        sched.finish(sid)
    sched.run_until_idle()
    tickets = [sched.close(sid) for sid in sids]
    assert [sched.take_result(t, block=True) for t in tickets] == [[t] for t in TEXTS[:2]]
    assert sched.active_streams == 0 and len(sched.slots) == 4
    with pytest.raises(RuntimeError, match="no mesh"):
        sched.save_aot()
