"""The pitch-lag Viterbi (``ops/pitch_viterbi_cuda.py``) against the JAX
package's scans, bit for bit.

``pitch_viterbi_torch`` (the plain twin, what the wrapper runs on the CPU)
must equal a NumPy transcription of the reference's forward and reverse
scans (``rhasspy_speech_tpu/ops/pitch.py:246-275``) exactly, on seeded
``local`` arrays quantized so that many candidates tie: the backpointer is
the first j that reaches the minimum, as ``jnp.argmin`` takes it. Given
the same ``local``, the states equal those of the reference's
own ``jax.lax.scan`` code and the ``pitch_track`` pitch of the JAX
package. A NumPy emulation of the kernel's schedule (register strips of
outputs against interleaved blocks of candidates, one lane each, the
value-only minimum with the lane's first block reaching it, the
lexicographic merge of the lanes in shuffle rounds, the rescan of one
block) read from the same plan function as the wrapper must equal the
twin and the JAX scan at every cluster size and lane count, also with a
plateau transition table that makes ties across lanes common; the
cluster chooser picks its documented plans against a stubbed card. On the
card (marker ``cuda``) the kernel must equal the twin bit for bit at
every cluster size, at the batch, tick and push shapes of the chip run
(B = 32, T = 296 and 196; B = 1, T = 196; NL = 417) and on small ones.
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from rhasspy_speech_tpu.ops import pitch as jp

import torch

from rhasspy_speech_torch.ops import pitch as tp
from rhasspy_speech_torch.ops import pitch_viterbi_cuda as k5
from rhasspy_speech_torch.ops.pitch_viterbi_cuda import (
    BLOCK,
    CLUSTER_SIZES,
    MAX_LAGS,
    STRIP,
    choose_cluster,
    pitch_viterbi,
    pitch_viterbi_torch,
    plan_pitch_viterbi,
    transition_costs,
)

NL_DEFAULT = tp.make_lags(tp.PitchConfig()).shape[0]
CFG = tp.PitchConfig()


def _dist(nl):
    return transition_costs(nl, CFG.delta_pitch, CFG.penalty_factor)


def plateau_dist(nl, width=50):
    """A transition table of steps of ``width`` lags: with costs on a grid,
    the minimum over j ties across many candidates, blocks and chunks, so
    every tie-break of the schedule shows."""
    return (np.arange(nl) // width * 0.125).astype(np.float32)


def reference_scan(local, dist):
    """The reference's scans in NumPy f32: ``fwd' = loc_t + min_j(fwd[j] +
    trans[i, j])``, ``np.argmin`` (first index) for the backpointers and the
    last state, then the traceback."""
    B, T, NL = local.shape
    idx = np.arange(NL)
    trans = dist[np.abs(idx[:, None] - idx[None, :])]
    fwd = local[:, 0]
    bps = []
    for t in range(1, T):
        scores = fwd[:, None, :] + trans[None, :, :]
        bp = np.argmin(scores, axis=-1)
        fwd = local[:, t] + np.take_along_axis(scores, bp[:, :, None], axis=2)[:, :, 0]
        bps.append(bp)
    states = np.zeros((B, T), np.int64)
    s = np.argmin(fwd, axis=-1)
    states[:, T - 1] = s
    for t in range(T - 2, -1, -1):
        s = np.take_along_axis(bps[t], s[:, None], axis=1)[:, 0]
        states[:, t] = s
    return states


def jax_scan(local, dist):
    """``pitch_track``'s Viterbi lines as the JAX package writes them."""
    NL = local.shape[2]
    idx = np.arange(NL)
    trans = jnp.asarray(dist[np.abs(idx[:, None] - idx[None, :])])
    local_t = jnp.swapaxes(jnp.asarray(local), 0, 1)

    def step(fwd, loc_t):
        scores = fwd[:, None, :] + trans[None, :, :]
        best = jnp.min(scores, axis=-1)
        bp = jnp.argmin(scores, axis=-1).astype(jnp.int32)
        return loc_t + best, bp

    fwd_final, bps = jax.lax.scan(step, local_t[0], local_t[1:])
    last_state = jnp.argmin(fwd_final, axis=-1).astype(jnp.int32)

    def back(state, bp_t):
        prev = jnp.take_along_axis(bp_t, state[:, None], axis=1)[:, 0]
        return prev, prev

    _, prevs = jax.lax.scan(back, last_state, bps[::-1])
    states = jnp.concatenate([prevs[::-1], last_state[None]], axis=0)
    return np.asarray(jnp.swapaxes(states, 0, 1))


def tied_local(seed, B, T, NL, levels=12):
    """Seeded costs on a grid of ``levels`` values: many exact ties."""
    rng = np.random.RandomState(seed)
    return (rng.randint(0, levels, size=(B, T, NL)) * 0.125).astype(np.float32)


CASES = {
    "ties_small": (0, 3, 9, 7, 4),
    "ties_default_lags": (1, 2, 12, NL_DEFAULT, 12),
    "one_frame": (2, 2, 1, 11, 3),
    "two_lags": (3, 4, 6, 2, 2),
    "continuous": (4, 2, 20, 64, 0),
    "one_stream_ties": (5, 1, 10, 13, 3),
}


def _case(name):
    seed, B, T, NL, levels = CASES[name]
    if levels:
        return tied_local(seed, B, T, NL, levels), _dist(NL)
    rng = np.random.RandomState(seed)
    return rng.rand(B, T, NL).astype(np.float32) * 2.0, _dist(NL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_twin_equals_reference_scan(name):
    local, dist = _case(name)
    got = pitch_viterbi_torch(torch.as_tensor(local), torch.as_tensor(dist))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), reference_scan(local, dist))
    # the wrapper runs the twin for CPU tensors and launches nothing
    before = pitch_viterbi.launches
    np.testing.assert_array_equal(
        pitch_viterbi(torch.as_tensor(local), torch.as_tensor(dist)).numpy(), got.numpy())
    assert pitch_viterbi.launches == before


@pytest.mark.parametrize("name", ["ties_small", "ties_default_lags", "continuous"])
def test_twin_equals_jax_scan(name):
    local, dist = _case(name)
    got = pitch_viterbi_torch(torch.as_tensor(local), torch.as_tensor(dist)).numpy()
    np.testing.assert_array_equal(got, jax_scan(local, dist))


def test_transition_table_holds_the_reference_matrix():
    """``dist[|i - j|]`` is exactly the reference's f32 ``trans[i, j]``."""
    lags = jp.make_lags(jp.PitchConfig())
    idx = np.arange(lags.shape[0])
    factor = math.log(1.0 + CFG.delta_pitch) ** 2 * CFG.penalty_factor
    want = ((idx[:, None] - idx[None, :]) ** 2 * factor).astype(np.float32)
    dist = _dist(lags.shape[0])
    np.testing.assert_array_equal(dist[np.abs(idx[:, None] - idx[None, :])], want)


def test_pitch_track_states_equal_jax_on_the_same_local():
    """The port's local costs through the reference's scans give the same
    states as the port's tracker, and the same pitch as the JAX
    package's ``pitch_track`` on these tones."""
    t = np.arange(12000) / 16000.0
    pcm = np.stack([0.5 * np.sin(2 * np.pi * f * t) for f in (95.0, 260.0)]).astype(np.float32)
    local, _phi = tp.pitch_local(CFG, torch.as_tensor(pcm))
    dist = _dist(local.shape[2])
    states = jax_scan(local.numpy(), dist)
    pitch, _nccf = tp.pitch_track(CFG, torch.as_tensor(pcm))
    lags = tp.make_lags(CFG).astype(np.float32)
    np.testing.assert_array_equal(pitch.numpy(), 1.0 / lags[states])
    jpitch, _ = jp.pitch_track(jp.PitchConfig(), jnp.asarray(pcm))
    np.testing.assert_array_equal(pitch.numpy(), np.asarray(jpitch))


def _lex_min(m, b, om, ob):
    """The kernel's lex_min over arrays: (min, block) of the lower minimum,
    the lower block on equal minima."""
    take = (om < m) | ((om == m) & (ob < b))
    return np.where(take, om, m), np.where(take, ob, b)


def emulate_kernel(local, dist, plan):
    """``csrc/pitch_viterbi.cu``'s schedule in NumPy f32, for one plan, all
    strips at once: per step, lane mk of a strip (one of ``plan.lanes``
    consecutive lanes) takes the value-only minimum of each of the strip's
    8 outputs over its blocks mk, mk + lanes, ..., keeping its first block
    that reached it; the lanes merge in registers (three reduce-scatter
    rounds by lane bit leave lane mk output mk % 8, then the groups of 8
    exchange that pair), with the lexicographic (min, block) minimum; the
    E = lanes / 8 lanes of an output rescan the winning block for the first
    j whose sum equals the minimum; fwd' = local + sum at that j. Then the
    first argmin and the traceback."""
    B, T, NL = local.shape
    NLp, K = plan.lags_pad, plan.lanes
    NB, OFF, E = NLp // BLOCK, NLp - 1, K // STRIP
    assert plan.slice_strips * plan.cluster >= NB
    x = np.arange(2 * NLp)
    d = np.abs(x - OFF)
    distS = np.where(d < NL, dist[np.minimum(d, NL - 1)], np.float32(np.inf)).astype(np.float32)
    i = (np.arange(NB) * STRIP)[:, None] + np.arange(STRIP)[None, :]  # [strip, q]
    lanes = np.arange(K)
    states = np.zeros((B, T), np.int64)
    for b in range(B):
        cur = np.full(NLp, np.inf, np.float32)
        cur[:NL] = local[b, 0]
        bps = []
        for t in range(1, T):
            # the pass: m, bb [strip, lane, q]
            m = np.full((NB, K, STRIP), np.inf, np.float32)
            bb = np.broadcast_to(lanes[None, :, None], m.shape).copy()
            for step in range(-(-NB // K)):
                jb = lanes + K * step  # each lane's block at this step
                live = jb < NB
                mm = m.copy()
                for u in range(BLOCK):
                    j = np.minimum(jb * BLOCK + u, NLp - 1)
                    sums = cur[j][None, :, None] + distS[i[:, None, :] - j[None, :, None] + OFF]
                    mm = np.where(live[None, :, None], np.minimum(mm, sums), mm)
                bb = np.where(mm < m, jb[None, :, None], bb)
                m = mm
            # three reduce-scatter rounds: position k <- output k + n * bit
            n = STRIP // 2
            while n >= 1:
                upper = ((lanes & n) != 0)[None, :, None]
                lo_m, hi_m = m[:, :, :n], m[:, :, n : 2 * n]
                lo_b, hi_b = bb[:, :, :n], bb[:, :, n : 2 * n]
                send_m, send_b = np.where(upper, lo_m, hi_m), np.where(upper, lo_b, hi_b)
                keep_m, keep_b = np.where(upper, hi_m, lo_m), np.where(upper, hi_b, lo_b)
                m, bb = _lex_min(keep_m, keep_b, send_m[:, lanes ^ n], send_b[:, lanes ^ n])
                n //= 2
            M, J = m[:, :, 0], bb[:, :, 0]  # [strip, lane]: output lane % 8
            off = STRIP  # the E groups of 8 exchange their pair
            while off < K:
                M, J = _lex_min(M, J, M[:, lanes ^ off], J[:, lanes ^ off])
                off *= 2
            out = i[:, lanes % STRIP]  # [strip, lane]
            for e in range(E):  # the twins agree
                same = (lanes // STRIP) == e
                np.testing.assert_array_equal(M[:, same], M[:, lanes < STRIP])
                np.testing.assert_array_equal(J[:, same], J[:, lanes < STRIP])
            # the rescan by the E lanes of each output
            first = np.full(M.shape, BLOCK)
            for u in range(BLOCK):
                j = J * BLOCK + u
                mine = ((u % E) == lanes // STRIP)[None, :]  # lane e tries u = e, e + E, ..
                hit = (cur[np.minimum(j, NLp - 1)] + distS[out - j + OFF] == M) & (first == BLOCK)
                first = np.where(hit & mine, u, first)
            # min over the E lanes of each output
            first = first.reshape(NB, E, STRIP).min(axis=1)
            M, J = M[:, :STRIP], J[:, :STRIP]
            assert (first < BLOCK).all()
            jstar = (J * BLOCK + first).reshape(-1)
            flat = i.reshape(-1)
            nxt = np.full(NLp, np.inf, np.float32)
            nxt[:NL] = local[b, t] + (cur[jstar] + distS[flat - jstar + OFF])[:NL]
            bps.append(jstar[:NL])
            cur = nxt
        s = int(np.argmin(cur[:NL]))
        states[b, T - 1] = s
        for t in range(T - 2, -1, -1):
            s = int(bps[t][s])
            states[b, t] = s
    return states


EMU_CASES = {  # seed, B, T, NL, levels, transition table
    "default_lags_levels2": (11, 1, 5, NL_DEFAULT, 2, _dist),
    "default_lags_levels12": (12, 2, 4, NL_DEFAULT, 12, _dist),
    "default_lags_levels40": (13, 1, 6, NL_DEFAULT, 40, _dist),
    "default_lags_plateau": (18, 2, 5, NL_DEFAULT, 2, plateau_dist),
    "lags_13_t2": (14, 3, 2, 13, 3, _dist),
    "lags_37_t1": (15, 2, 1, 37, 12, _dist),
    "lags_7": (16, 2, 9, 7, 2, _dist),
    "lags_90": (17, 2, 8, 90, 40, _dist),
    "lags_90_plateau": (19, 2, 8, 90, 3, lambda nl: plateau_dist(nl, 9)),
}


@pytest.mark.parametrize("cluster", CLUSTER_SIZES)
@pytest.mark.parametrize("name", sorted(EMU_CASES))
def test_schedule_emulation_equals_twin_and_jax(name, cluster):
    seed, B, T, NL, levels, table = EMU_CASES[name]
    local, dist = tied_local(seed, B, T, NL, levels), table(NL)
    plan = plan_pitch_viterbi(NL, cluster)
    got = emulate_kernel(local, dist, plan)
    want = pitch_viterbi_torch(torch.as_tensor(local), torch.as_tensor(dist)).numpy()
    np.testing.assert_array_equal(got, want)
    if cluster == 1:
        np.testing.assert_array_equal(got, jax_scan(local, dist))


@pytest.mark.parametrize("lanes", k5.LANE_CHUNKS)
def test_schedule_emulation_other_lane_counts(lanes):
    local, dist = tied_local(21, 1, 4, NL_DEFAULT, 2), plateau_dist(NL_DEFAULT)
    plan = plan_pitch_viterbi(NL_DEFAULT, 4, lanes=lanes)
    assert plan.lanes == lanes
    np.testing.assert_array_equal(
        emulate_kernel(local, dist, plan),
        pitch_viterbi_torch(torch.as_tensor(local), torch.as_tensor(dist)).numpy())


@pytest.mark.parametrize("cluster", CLUSTER_SIZES)
@pytest.mark.parametrize("num_lags", [1, 7, 13, NL_DEFAULT, 1000, 2048, MAX_LAGS])
def test_plan_covers_every_lag(num_lags, cluster):
    if num_lags > 1024 * cluster:  # a CTA's strips would need > 1,024 threads
        with pytest.raises(ValueError, match="threads"):
            plan_pitch_viterbi(num_lags, cluster)
        return
    plan = plan_pitch_viterbi(num_lags, cluster)
    nb = plan.lags_pad // BLOCK
    assert plan.lags_pad % STRIP == 0 and plan.lags_pad >= num_lags > plan.lags_pad - STRIP
    assert plan.slice_strips * cluster >= nb > (plan.slice_strips - 1) * cluster
    assert plan.lanes in k5.LANE_CHUNKS
    assert plan.threads % 32 == 0 and plan.threads <= k5.MAX_THREADS
    assert plan.slice_strips * plan.lanes <= plan.threads
    assert plan.smem_bytes <= 227 * 1024


def _stub(counts):
    return lambda plan: counts[plan.cluster]


def h100_clusters(plan):
    """Clusters an H100 runs at once, as ``cudaOccupancyMaxActiveClusters``
    reports them for the kernel's 64-register threads: 132 SMs, each
    holding as many CTAs as its 65,536 registers allow."""
    return 132 * (65536 // (64 * plan.threads)) // plan.cluster


@pytest.mark.parametrize("batch,cluster,lanes", [(1, 8, 32), (32, 8, 16), (64, 8, 16)])
def test_chooser_picks_documented_cluster(batch, cluster, lanes):
    plan = choose_cluster(batch, NL_DEFAULT, h100_clusters)
    assert (plan.cluster, plan.lanes) == (cluster, lanes)
    assert plan == plan_pitch_viterbi(NL_DEFAULT, cluster, lanes=lanes)
    # the same inputs give the same plan (a captured tick replays it)
    assert choose_cluster(batch, NL_DEFAULT, h100_clusters) == plan


def test_chooser_counts_waves():
    """At 2,000 streams the clusters of 8 need more waves than the card's
    clusters of 2 at 8 lanes a strip."""
    plan = choose_cluster(2000, NL_DEFAULT, h100_clusters)
    waves = -(-2000 // h100_clusters(plan))
    for c, lanes in k5.FRAME_US:
        other = plan_pitch_viterbi(NL_DEFAULT, c, lanes=lanes)
        assert waves * k5.frame_us(plan, 2000) <= (
            -(-2000 // h100_clusters(other)) * k5.frame_us(other, 2000))


def test_chooser_skips_sizes_the_card_cannot_run_and_raises_past_the_limit():
    assert choose_cluster(1, NL_DEFAULT, _stub({1: 132, 2: 66, 4: 0, 8: 0})).cluster == 2
    with pytest.raises(ValueError, match="no cluster size"):
        choose_cluster(1, NL_DEFAULT, _stub({c: 0 for c in CLUSTER_SIZES}))
    with pytest.raises(ValueError, match="lags"):
        choose_cluster(1, MAX_LAGS + 1, h100_clusters)
    with pytest.raises(ValueError, match="cluster size"):
        plan_pitch_viterbi(NL_DEFAULT, 3)
    # 4,096 lags: only clusters of 4 and 8 have the threads
    assert choose_cluster(1, MAX_LAGS, h100_clusters).cluster in (4, 8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 296), (32, 196), (1, 196), (3, 7), (1, 1)])
def test_kernel_equals_twin(cuda, shape):
    B, T = shape
    local, dist = tied_local(7, B, T, NL_DEFAULT, levels=40), _dist(NL_DEFAULT)
    lt, dt = torch.as_tensor(local, device=cuda), torch.as_tensor(dist, device=cuda)
    before = pitch_viterbi.launches
    got = pitch_viterbi(lt, dt)
    torch.cuda.synchronize()
    assert pitch_viterbi.launches == before + 1
    assert torch.equal(got, pitch_viterbi_torch(lt, dt))


@pytest.mark.cuda
@pytest.mark.parametrize("table", ["kaldi", "plateau"])
@pytest.mark.parametrize("cluster", CLUSTER_SIZES)
@pytest.mark.parametrize("shape", [(32, 296, 40), (32, 196, 2), (1, 196, 12), (3, 7, 12),
                                   (1, 1, 12)])
def test_kernel_equals_twin_at_every_cluster(cuda, shape, cluster, table):
    B, T, levels = shape
    local = tied_local(8, B, T, NL_DEFAULT, levels)
    dist = _dist(NL_DEFAULT) if table == "kaldi" else plateau_dist(NL_DEFAULT)
    lt, dt = torch.as_tensor(local, device=cuda), torch.as_tensor(dist, device=cuda)
    plan = plan_pitch_viterbi(NL_DEFAULT, cluster)
    clocks = torch.zeros((B, cluster, 4), dtype=torch.int64, device=cuda)
    got = pitch_viterbi(lt, dt, plan=plan, clocks=clocks)
    torch.cuda.synchronize()
    assert torch.equal(got, pitch_viterbi_torch(lt, dt))
    assert (clocks[:, :, 0] > 0).all() and (clocks[:, 0, 1] > 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", CLUSTER_SIZES)
@pytest.mark.parametrize("num_lags", [7, 13, 90])
def test_kernel_equals_twin_on_small_lags(cuda, num_lags, cluster):
    local, dist = tied_local(9, 3, 11, num_lags, 3), plateau_dist(num_lags, 4)
    lt, dt = torch.as_tensor(local, device=cuda), torch.as_tensor(dist, device=cuda)
    got = pitch_viterbi(lt, dt, plan=plan_pitch_viterbi(num_lags, cluster))
    torch.cuda.synchronize()
    assert torch.equal(got, pitch_viterbi_torch(lt, dt))
