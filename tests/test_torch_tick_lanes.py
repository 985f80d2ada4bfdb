"""The stream tick's chunk AM over its lane bucket (``pipeline/device_tick.py``:
``am_rows``, ``lane_list``, ``DeviceTick._am``), on the CPU.

- The bucket rule and the lane list at every lane count of 256 slots and of
  a 4-way mesh block (64 slots).
- One recorded tick (every slot decoding a chunk, mid-utterance) of four
  routes, run again from its state with 1, 8, 9 (past a bucket's edge) and
  every lane decoding, once at the tick's bucket and once over every slot:
  the fused body on the i-vector profile, the chunk body on the host
  feature route (``snip_edges=false``), the fused body on a recurrent net
  (``recurrent_delay=3``) and on a GMM. The rings, offsets and packed rows
  are equal, alpha within the scheduler tests' cost tolerance, the
  decoded lanes' log-probs within 1e-5 (zero on the slots the bucket
  skips); a recurrent net's rows of the slots that decode nothing are
  bit-unchanged. Over every slot the AM gathers and scatters nothing.
- ``warmup()`` runs every bucket at the chunk-sized feeds' width, and the
  dribble's and the burst's widths at 8 and 32 rows; a bucket without a
  captured graph at the tick's width takes the smallest larger one with.
"""

import numpy as np
import pytest
import torch

from rhasspy_speech_torch.examples._common import train_sentences
from rhasspy_speech_torch.examples.serve_streams import LEXICON, SENTENCES, UTTERANCES
from rhasspy_speech_torch.pipeline import scheduler as sched_mod
from rhasspy_speech_torch.pipeline.device_tick import (
    AM_ROWS_MIN,
    DeviceTick,
    am_buckets,
    am_rows,
    lane_list,
)
from rhasspy_speech_torch.pipeline.scheduler import StreamScheduler
from rhasspy_speech_torch.testing import build_synthetic_profile, synthesize_sentence
from rhasspy_speech_torch.testing.synthetic import build_synthetic_gmm_profile

from test_torch_scheduler import COST_ATOL, COST_RTOL
from test_torch_tick_trace import _trained

N = 32
LANES = (1, 8, 9, N)
PUSH = 1024
LP_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [256, 64], ids=["slots256", "mesh4_block64"])
def test_bucket_rule_and_lane_list(n):
    rng = np.random.RandomState(n)
    for lanes in range(n + 1):
        rows = am_rows(lanes, n)
        assert lanes <= rows <= n and rows in am_buckets(n)
        if rows < n:
            # the smallest power of two >= the lanes, at least the floor
            assert rows == max(AM_ROWS_MIN, 1 << max(lanes - 1, 0).bit_length())
        else:
            assert lanes > n // 2  # a full tick gathers nothing
        n_valid = np.zeros(n, dtype=np.int32)
        active = np.sort(rng.choice(n, lanes, replace=False))
        n_valid[active] = rng.randint(1, 8, size=lanes)
        order = lane_list(n_valid)
        assert order.dtype == np.int32 and sorted(order.tolist()) == list(range(n))
        assert order[:lanes].tolist() == active.tolist()
        assert (n_valid[order[lanes:rows]] == 0).all()
    assert am_buckets(n) == [8 << i for i in range(n.bit_length() - 3)]


def _gmm_trained(root):
    profile = build_synthetic_gmm_profile(root / "model", LEXICON)
    (graph_dir,) = train_sentences(profile.model_dir, root / "train", SENTENCES)
    return profile, graph_dir


def _recurrent_trained(root):
    profile = build_synthetic_profile(root / "model", LEXICON, recurrent_delay=3,
                                      with_ivector=True, with_context=True,
                                      with_ivector_cmvn=True)
    (graph_dir,) = train_sentences(profile.model_dir, root / "train", SENTENCES)
    return profile, graph_dir


ROUTES = {
    "fused": lambda root: _trained(root)[:2],
    "chunk": lambda root: _trained(root, snip_edges=False)[:2],
    "recurrent": _recurrent_trained,
    "gmm": _gmm_trained,
}


def _meta(tick, kind, inputs):
    """The recorded tick's slot scalars: [N, 12] of the fused upload, or the
    chunk body's [N, 5]."""
    if kind == "chunk":
        return inputs[1].numpy().copy()
    return tick.unpack(inputs[0])[1].numpy().copy()


def _with_lanes(tick, kind, inputs, meta):
    """The recorded inputs with ``meta``'s n_valid and its lane list."""
    if kind == "chunk":
        meta[:, 4] = lane_list(meta[:, 0])
        return [inputs[0], torch.from_numpy(meta), *inputs[2:]]
    meta[:, 10] = lane_list(meta[:, 0])
    upload = inputs[0].clone()
    StreamScheduler._write_meta_cols(upload.numpy(), meta)
    return [upload]


@pytest.fixture(scope="module", params=sorted(ROUTES))
def recorded(request, tmp_path_factory):
    """(route, scheduler, its body, the state before, the inputs) of the
    second tick at which all N slots decode a chunk: N streams fed in
    lockstep, PUSH samples a round and a tick after each."""
    kind = request.param
    profile, graph_dir = ROUTES[kind](tmp_path_factory.mktemp(f"tick_lanes_{kind}"))
    s = StreamScheduler(profile.model_dir, graph_dir, max_streams=N, device="cpu")
    assert s._device_bp and s._device_feats == (kind != "chunk")
    assert bool(s._tick.cfg.pitch) is False and bool(s._st.rec) == (kind == "recurrent")
    pcms = [synthesize_sentence(profile, UTTERANCES[i % len(UTTERANCES)], seed=500 + i)
            for i in range(N)]
    runner, full = s._runner, []
    run = runner.run

    def spy(key, body, st, inputs):
        if key[0] in ("fused", "chunk") and (_meta(s._tick, key[0], inputs)[:, 0] > 0).all():
            full.append((body, st.clone(), [x.clone() for x in inputs]))
        return run(key, body, st, inputs)

    runner.run = spy
    sids = [s.open_stream() for _ in range(N)]
    for off in range(0, min(p.shape[0] for p in pcms), PUSH):
        for sid, pcm in zip(sids, pcms):
            s.feed(sid, pcm[off : off + PUSH])
        s.step()
        if len(full) == 2:
            break
    runner.run = run
    assert len(full) == 2, "no second tick with every slot decoding"
    return (kind, s, *full[1])


def _run(s, body, st, inputs, rows):
    """The body from a copy of ``st`` at ``rows``: (state after, log-probs)."""
    out = st.clone()
    s._tick.probe = {}
    try:
        body(out, *inputs, rows=rows)
        log_probs = s._tick.probe["viterbi"][0]
    finally:
        s._tick.probe = None
    return out, log_probs


class _Calls(torch.overrides.TorchFunctionMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.names.append(getattr(func, "__name__", str(func)))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("lanes", LANES)
def test_bucket_equals_every_slot(recorded, lanes, monkeypatch):
    kind, s, body, st, inputs = recorded
    meta = _meta(s._tick, kind, inputs)
    rng = np.random.RandomState(lanes)
    active = np.zeros(N, dtype=bool)
    active[rng.choice(N, lanes, replace=False)] = True
    meta[~active, 0] = 0
    inputs = _with_lanes(s._tick, kind, inputs, meta)
    rows = am_rows(lanes, N)
    assert rows == {1: 8, 8: 8, 9: 16, N: N}[lanes]

    am, calls = DeviceTick._am, {}

    def counted(self, *args):
        with _Calls() as mode:
            out = am(self, *args)
        calls[args[-1]] = mode.names
        return out

    monkeypatch.setattr(DeviceTick, "_am", counted)
    ref, ref_lp = _run(s, body, st, inputs, N)
    got, got_lp = _run(s, body, st, inputs, rows)
    gathers = {"index_select", "index_copy_"}
    assert not gathers & set(calls[N])  # over every slot: no gather, no scatter
    if rows < N:
        assert gathers <= set(calls[rows])
    for name in ("ring", "offs", "packed"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
    torch.testing.assert_close(got.alpha, ref.alpha, rtol=COST_RTOL, atol=COST_ATOL)
    on = torch.from_numpy(active)
    torch.testing.assert_close(got_lp[on], ref_lp[on], **LP_TOL)
    ran = torch.zeros(N, dtype=torch.bool)
    ran[torch.from_numpy(lane_list(meta[:, 0])[:rows]).long()] = True
    assert not got_lp[~ran].any()  # the slots the bucket skips read zero
    if kind == "recurrent":
        reset = torch.from_numpy(meta[:, 1] != 0)
        for k, before in st.rec.items():
            kept = torch.where(reset[:, None, None], 0.0, before)
            assert torch.equal(got.rec[k][~on], kept[~on]), k  # idle and padding lanes
            assert torch.equal(ref.rec[k][~on], kept[~on]), k
            torch.testing.assert_close(got.rec[k][on], ref.rec[k][on], **LP_TOL)
            assert not torch.equal(got.rec[k][on], kept[on])


@pytest.fixture(scope="module")
def warm(tmp_path_factory):
    """A 32-slot scheduler on the fused route after ``warmup()``."""
    profile, graph_dir = ROUTES["fused"](tmp_path_factory.mktemp("tick_lanes_warm"))
    s = StreamScheduler(profile.model_dir, graph_dir, max_streams=N, device="cpu")
    s.warmup(seconds=0.5)
    return s


def _widths(s, rows):
    return {k[1] for k in s._runner.warm_keys if k[0] == "fused" and k[3] == rows}


def test_warmup_runs_every_bucket_at_the_feeds_width(warm):
    """Silence in chunk-sized feeds through 8, 16 and 32 streams in turn:
    each bucket's fused body at the feeds' PCM width (the chunk's samples
    after a frame's carried tail); the dribble's and the burst's widths
    through one stream and every slot (8 and 32 rows)."""
    s = warm
    chunk, fz = s._chunk_in * s._frame_shift, s._featurizer
    widths = {sched_mod._pcm_bucket(chunk + tail) for tail in
              range(fz.frame_len - fz.frame_shift, fz.frame_len)}
    assert len(widths) == 1
    width = widths.pop() + s._meta_cols
    assert am_buckets(N) == [8, 16, 32]
    assert all(width in _widths(s, rows) for rows in am_buckets(N))
    burst = sched_mod._pcm_bucket(2 * s._drain_cap) + s._meta_cols
    others = _widths(s, 8) | _widths(s, N)
    assert {1600 + s._meta_cols, burst} <= others - {width, s._meta_cols}
    assert _widths(s, 8) == _widths(s, N) == _widths(s, 16) | others
    assert s.active_streams == 0


def test_a_new_key_first_takes_a_warm_larger_bucket(warm, monkeypatch):
    """A tick whose bucket has no captured graph at its width takes the
    smallest larger bucket whose graph at that width is captured, each time
    it is met (the rule keeps no state); without such a graph, and on the
    CPU, where nothing is captured, its own bucket."""
    s = warm
    head = ("fused", 1600 + s._meta_cols, "int16")
    assert not s._runner.graphs
    assert [s._am_bucket(head, lanes) for lanes in (3, 9, 17)] == [8, 16, N]
    monkeypatch.setattr(s._runner, "graphs", {(*head, 8): None, (*head, N): None})
    for _ in range(2):
        assert [s._am_bucket(head, lanes) for lanes in (3, 9, 17)] == [8, N, N]
    assert s._am_bucket(("fused", 99_999, "int16"), 9) == 16  # no graph at that width
