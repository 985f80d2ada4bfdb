"""The windowed-relaxation kernel's table preparation, on the CPU.

``ops/windowed_relax_cuda.py`` packs the step tables, deals the
destination blocks to a CTA's 128-thread groups and lays the steps out as
a schedule of rounds in Python, once per set of tables;
``csrc/windowed_relax.cu`` only runs on the card. These tests hold the
schedule to what the kernel assumes, and hold an emulation of the kernel's
walk -- stage by stage through a ring filled piece by piece by the CTAs of
a cluster, round by round, a (cost, arc id) pair per lane carried in
registers from a block's first step to its last -- bit-equal to the plain
version ``windowed_relax_torch``, which equals the Pallas kernel in
interpret mode (``tests/test_torch_windowed_relax.py``).
"""

import numpy as np
import pytest
import torch

from rhasspy_speech_torch.examples import windowed_cost
from rhasspy_speech_torch.ops.windowed_relax_cuda import (
    CLUSTER_SIZES,
    FIRST,
    GROUPS,
    LANES,
    LAST,
    MAX_ARC,
    NOOP_WEIGHT,
    NOOP_WORD,
    MIN_STAGES,
    ROUND_BYTES,
    ROUNDS_PER_STAGE,
    choose_cluster,
    pack_candidates,
    prepare_steps,
    ring_layout,
    stage_pieces,
    windowed_relax_torch,
)

H100_MAX_SMEM = 232448  # bytes of shared memory a block may opt into
CAND_WORDS = GROUPS * LANES * 2


def lex_less(c, a, bc, bi):
    """The kernel's merge rule; ``a`` and ``bi`` are packed words."""
    return (c < bc) | ((c == bc) & (a < bi))


def unpack_round(words):
    """(word uint32 [G, 128], weight f32 [G, 128], sbase [G], dbase [G],
    flags [G]) of one round's int32 words; the round stores the bases as
    byte offsets, 4 * sbase and 4 * dbase | flags."""
    cand = words[:CAND_WORDS].reshape(GROUPS, LANES, 2)
    meta = words[CAND_WORDS:].reshape(GROUPS, 2)
    assert (meta[:, 0] % (4 * LANES) == 0).all()
    return (cand[..., 0].view(np.uint32), cand[..., 1].view(np.float32),
            meta[:, 0] // 4, (meta[:, 1] & 0x7FFFFFFF & ~(4 * LANES - 1)) // 4,
            meta[:, 1] & (FIRST | (4 * LANES - 1)))


def emulate_kernel(steps, T, B, alpha0, cluster, layout):
    """csrc/windowed_relax.cu's walk: (alpha [B, S] f32, bp [T, B, S]
    int64, writes [T, B, S] count of backpointer stores)."""
    S, L = steps.s_pad, steps.num_rounds
    K, R = layout.rounds_per_stage, layout.stages
    stage_bytes = K * ROUND_BYTES
    assert L % K == 0  # the schedule is padded to whole stages
    num_stages = L // K
    tables = steps.schedule.numpy().view(np.uint8).reshape(steps.schedule.shape[0], -1)
    alpha = np.zeros((B, S), np.float32) if alpha0 is None else alpha0.astype(np.float32).copy()
    bp = np.zeros((T, B, S), np.int64)
    writes = np.zeros((T, B, S), np.int64)
    lanes = np.arange(LANES)
    for first in range(0, B, cluster):
        # CTA q of the cluster takes stream first + q; a CTA past the batch
        # walks the last stream's alpha and stores nothing
        streams = [min(first + q, B - 1) for q in range(cluster)]
        live = [first + q < B for q in range(cluster)]
        table = tables[first if steps.per_stream else 0]
        rings = np.zeros((cluster, R * stage_bytes), np.uint8)
        cur = [alpha[b].copy() for b in streams]
        for t in range(T):
            nxt = [np.full(S, np.nan, np.float32) for _ in streams]
            bc = np.zeros((cluster, GROUPS, LANES), np.float32)
            bi = np.zeros((cluster, GROUPS, LANES), np.int64)
            for sf in range(num_stages):
                slot = (t * num_stages + sf) % R  # the ring wraps across frames
                for lo, hi in stage_pieces(stage_bytes, cluster):  # rank q's multicast copy
                    src = sf * stage_bytes + lo
                    rings[:, slot * stage_bytes + lo:slot * stage_bytes + hi] = table[src:src + hi - lo]
                for q, b in enumerate(streams):
                    stage = rings[q, slot * stage_bytes:(slot + 1) * stage_bytes].view(np.int32)
                    for r in range(K):
                        word, wt, sbase, dbase, flags = unpack_round(
                            stage[r * ROUND_BYTES // 4:(r + 1) * ROUND_BYTES // 4])
                        for g in range(GROUPS):
                            d = dbase[g] + lanes
                            if flags[g] & FIRST:
                                bc[q, g] = cur[q][d] + np.float32(0.5)
                                bi[q, g] = 0
                            with np.errstate(invalid="ignore"):
                                c = cur[q][sbase[g] + (word[g] & (LANES - 1))] + wt[g]
                            a = word[g].astype(np.int64)  # compared packed, as the kernel does
                            take = lex_less(c, a, bc[q, g], bi[q, g])
                            bc[q, g] = np.where(take, c, bc[q, g])
                            bi[q, g] = np.where(take, a, bi[q, g])
                            if flags[g] & LAST:
                                nxt[q][d] = bc[q, g]
                                if live[q]:
                                    bp[t, b, d] = (bi[q, g] >> 7) & 0xFFFF
                                    writes[t, b, d] += 1
            cur = nxt
        for q, b in enumerate(streams):
            if live[q]:
                alpha[b] = cur[q]
    return alpha, bp, writes


def assert_emulation_equals_plain(tables, T, B, s_pad, alpha0=None, clusters=CLUSTER_SIZES):
    tt = [torch.as_tensor(x) for x in tables]
    steps = prepare_steps(*tt, s_pad)
    want_alpha, want_bp = windowed_relax_torch(
        *tt, T, B, s_pad, alpha0=None if alpha0 is None else torch.as_tensor(alpha0))
    layout = ring_layout(s_pad, H100_MAX_SMEM)
    for c in (1,) if steps.per_stream else clusters:
        alpha, bp, writes = emulate_kernel(steps, T, B, alpha0, c, layout)
        assert (writes == 1).all()  # every destination, every frame, exactly once
        np.testing.assert_array_equal(alpha, want_alpha.numpy())
        np.testing.assert_array_equal(bp, want_bp.to(torch.int64).numpy())
    return steps


def quantised(tables, arcs=7):
    """Weights on a grid of 1/4 and few arc ids: many exact cost ties."""
    dbase, sbase, idx, w, arc = tables
    return dbase, sbase, idx, (np.round(w * 4) / 4).astype(np.float32), (arc % arcs).astype(np.int32)


def test_packed_word_round_trips_and_orders_ties_like_the_arc_id():
    rng = np.random.RandomState(0)
    arc = np.concatenate([rng.randint(0, MAX_ARC, 500), [0, 1, MAX_ARC - 1, 1 << 24, 65535, 65536]])
    idx = np.concatenate([rng.randint(0, LANES, 500), [0, 127, 127, 0, 127, 0]])
    word = pack_candidates(torch.as_tensor(idx), torch.as_tensor(arc))
    assert word.dtype == torch.int32
    bits = word.numpy().view(np.uint32)
    np.testing.assert_array_equal(bits & (LANES - 1), idx)
    np.testing.assert_array_equal(bits >> 7, arc)
    # ties: whatever idx rides in the low bits, word >> 7 compares as arc
    # does, and so do the whole words wherever the arc ids differ
    a, b = bits[:-1] >> 7, bits[1:] >> 7
    np.testing.assert_array_equal(a < b, arc[:-1] < arc[1:])
    differ = arc[:-1] != arc[1:]
    np.testing.assert_array_equal((bits[:-1] < bits[1:])[differ], (arc[:-1] < arc[1:])[differ])
    # the uint16 backpointer keeps the arc id's low 16 bits
    np.testing.assert_array_equal((bits >> 7) & 0xFFFF, arc & 0xFFFF)


@pytest.mark.parametrize("per_stream", [False, True], ids=["shared", "per_stream"])
def test_schedule_holds_every_step_exactly_once(per_stream):
    nstep, s_pad, TB = 150, 2048, 3
    per = [windowed_cost.make_step_tables(nstep, s_pad, seed=20 + i) for i in range(TB)]
    tables = [np.stack(x) for x in zip(*per)] if per_stream else list(per[0])
    steps = prepare_steps(*(torch.as_tensor(x) for x in tables), s_pad)
    sched = steps.schedule.numpy()
    longest = 0
    assert sched.shape == (TB if per_stream else 1, steps.num_rounds, ROUND_BYTES // 4)
    for tb in range(sched.shape[0]):
        dbase, sbase, idx, w, arc = (x[tb] if per_stream else x for x in tables)
        want = sorted(zip(dbase.tolist(), sbase.tolist(), map(bytes, idx.astype(np.uint8)),
                          map(bytes, w), map(bytes, arc)))
        got, owner, load = [], {}, np.zeros(GROUPS, int)
        open_block = [None] * GROUPS
        for r in range(steps.num_rounds):
            word, wt, sb, db, flags = unpack_round(sched[tb, r])
            for g in range(GROUPS):
                noop = (word[g] == np.uint32(NOOP_WORD & 0xFFFFFFFF)).all()
                if noop:
                    assert (wt[g].view(np.int32) == NOOP_WEIGHT).all()
                if flags[g] & FIRST:
                    assert open_block[g] is None
                    assert owner.setdefault(int(db[g]), g) == g and load[g] == r
                    open_block[g] = int(db[g])
                if open_block[g] is None:  # padding after the group's last block
                    assert noop and flags[g] == 0
                    continue
                assert db[g] == open_block[g]  # a block's steps are consecutive rounds
                load[g] += 1
                if not noop:
                    got.append((int(db[g]), int(sb[g]), bytes((word[g] & 127).astype(np.uint8)),
                                bytes(wt[g]), bytes((word[g] >> 7).astype(np.int32))))
                if flags[g] & LAST:
                    open_block[g] = None
        assert open_block == [None] * GROUPS
        assert sorted(got) == want
        # each destination block in one group only, and every block somewhere
        assert sorted(owner) == list(range(0, s_pad, LANES))
        # the serpentine deal of blocks sorted by steps keeps the groups within
        # one block's steps of each other
        counts = np.maximum(np.bincount(dbase // LANES, minlength=s_pad // LANES), 1)
        assert load.max() - load.min() <= counts.max()
        longest = max(longest, load.max())
    # the longest row of any stream, rounded up to whole stages
    assert longest <= steps.num_rounds < longest + ROUNDS_PER_STAGE
    assert steps.num_rounds % ROUNDS_PER_STAGE == 0


def test_noop_step_never_wins():
    """+inf weight alone would win a tie against a destination at +inf whose
    arc id is larger; the no-op's packed word is the largest there is."""
    word = int(np.uint32(NOOP_WORD & 0xFFFFFFFF))
    assert word >> 7 == MAX_ARC - 1 and word & 127 == LANES - 1
    w = np.int32(NOOP_WEIGHT).view(np.float32)
    assert np.isposinf(w)
    inf = np.float32(np.inf)
    with np.errstate(invalid="ignore"):
        for alpha_src in (np.float32(0), np.float32(-3.5), inf, -inf, np.float32(np.nan)):
            c = alpha_src + w
            for bc in (np.float32(0.5), np.float32(-1e30), inf, -inf):
                for arc, idx in ((0, 0), (1, 127), (65535, 3), (MAX_ARC - 1, 0), (MAX_ARC - 1, 127)):
                    assert not lex_less(c, word, bc, (arc << 7) | idx)
    # a real candidate at +inf with a lower arc id does win such a tie
    assert lex_less(inf, (3 << 7) | 100, inf, (5 << 7) | 2)


def test_noop_rounds_leave_infinite_and_arc_zero_destinations_alone():
    """A block without steps and padded groups, on alpha with +inf and with
    arc id 0 candidates: bit-equal to the plain version."""
    s_pad, nstep = 1024, 6
    dbase, sbase, idx, w, arc = windowed_cost.make_step_tables(nstep, s_pad, seed=3)
    dbase[:] = [0, 0, 0, 128, 128, 256]  # blocks 3..7 get no step
    arc[0] = 0
    arc[3, ::2] = 0
    alpha0 = np.random.RandomState(1).rand(3, s_pad).astype(np.float32)
    alpha0[:, ::5] = np.inf
    alpha0[1] = np.inf
    steps = assert_emulation_equals_plain((dbase, sbase, idx, w, arc), 3, 3, s_pad, alpha0)
    # the longest row is block 0's three steps, rounded up to a whole stage
    assert steps.num_rounds == ROUNDS_PER_STAGE


@pytest.mark.parametrize("nstep,s_pad", [(60, 1024), (300, 512), (7, 256)])
def test_emulation_equals_plain_shared_tables(nstep, s_pad):
    """The example's tables; B = 5 is no multiple of 2, 4 or 8, so the
    last cluster has CTAs without a stream. 300 steps on 4 blocks wrap the
    ring several times a frame; 7 steps leave most groups empty."""
    tables = windowed_cost.make_step_tables(nstep, s_pad, seed=1)
    assert_emulation_equals_plain(tables, 3, 5, s_pad)


def test_emulation_equals_plain_per_stream_tables():
    B, s_pad = 3, 512
    per = [windowed_cost.make_step_tables(25, s_pad, seed=50 + i) for i in range(B)]
    tables = [np.stack(x) for x in zip(*per)]
    alpha0 = (np.random.RandomState(2).rand(B, s_pad) * 3).astype(np.float32)
    steps = assert_emulation_equals_plain(tables, 3, B, s_pad, alpha0)
    assert steps.per_stream and steps.schedule.shape[0] == B


def test_emulation_equals_plain_with_many_exact_ties():
    tables = quantised(windowed_cost.make_step_tables(80, 512, seed=4))
    alpha0 = (np.round(np.random.RandomState(5).rand(6, 512) * 8) / 8).astype(np.float32)
    assert_emulation_equals_plain(tables, 4, 6, 512, alpha0, clusters=(1, 4))


def test_emulation_equals_plain_with_unequal_blocks():
    """One block with 40 steps, one with none, the rest with a few."""
    s_pad, nstep = 1280, 70
    dbase, sbase, idx, w, arc = quantised(windowed_cost.make_step_tables(nstep, s_pad, seed=6), 50)
    blocks = np.concatenate([np.full(40, 2), np.random.RandomState(7).choice([0, 1, 3, 4, 6, 7, 8, 9], 30)])
    dbase = (blocks * LANES).astype(np.int32)  # block 5 gets no step
    steps = assert_emulation_equals_plain((dbase, sbase, idx, w, arc), 3, 3, s_pad, clusters=(1, 2))
    assert steps.num_rounds == 40  # the 40-step block is one group's whole row
    assert 40 % ROUNDS_PER_STAGE == 0


@pytest.mark.parametrize("nbytes", [ROUND_BYTES, ROUNDS_PER_STAGE * ROUND_BYTES, 7 * ROUND_BYTES])
@pytest.mark.parametrize("cluster", CLUSTER_SIZES)
def test_stage_pieces_cover_the_stage_in_16_byte_chunks(nbytes, cluster):
    pieces = stage_pieces(nbytes, cluster)
    assert len(pieces) == cluster and pieces[0][0] == 0 and pieces[-1][1] == nbytes
    for (lo, hi), (nlo, _) in zip(pieces, pieces[1:] + [(nbytes, None)]):
        assert hi == nlo and lo % 16 == 0 and hi % 16 == 0 and hi > lo


def test_ring_fits_beside_alpha_at_the_example_shape():
    """S_pad = 14,208: alpha's two buffers take 113,664 B, three stages of
    four rounds 99,072 B, the barriers 48 B, of the 232,448 B a block of an
    H100 may use."""
    layout = ring_layout(windowed_cost.S_PAD, H100_MAX_SMEM)
    assert (layout.rounds_per_stage, layout.stages) == (4, 3) == (ROUNDS_PER_STAGE, MIN_STAGES)
    assert layout.ring == 113664 and layout.barriers == layout.ring + 3 * 4 * ROUND_BYTES
    assert layout.nbytes == layout.barriers + 16 * 3 <= H100_MAX_SMEM
    assert layout.ring % 16 == 0 and layout.barriers % 16 == 0
    assert ring_layout(256, H100_MAX_SMEM).stages == 4  # capped
    with pytest.raises(ValueError, match="shared memory"):
        ring_layout(16768, H100_MAX_SMEM)


def test_choose_cluster():
    # the example's batch on a card that places 132 CTAs singly or in pairs
    # and 120 in clusters of 4 or 8: four waves at C <= 2, five above
    h100 = {1: 132, 2: 66, 4: 30, 8: 15}
    assert choose_cluster(512, False, h100.__getitem__) == 2
    assert choose_cluster(120, False, h100.__getitem__) == 4  # one wave at any size
    assert choose_cluster(130, False, h100.__getitem__) == 2  # one wave at C <= 2 only
    assert choose_cluster(512, True, h100.__getitem__) == 1  # per-stream tables
    assert choose_cluster(16, False, {1: 132, 2: 66, 4: 0, 8: 0}.__getitem__) == 2
    assert choose_cluster(16, False, {1: 132, 2: 0, 4: 0, 8: 15}.__getitem__) == 1
    with pytest.raises(RuntimeError, match="runs no CTA"):
        choose_cluster(4, False, lambda c: 0)
