"""The scheduler's whole-path walk (``ops/path_walk_cuda.py``) against a
NumPy transcription of the JAX scheduler's ``walk_step``
(``rhasspy_speech_tpu/pipeline/scheduler.py``, the scan at the end of
``batch_chunk``), which walks every slot over the ring's full depth.

Seeded rings of ``bp + 3`` entries hold slots with no frames, slots whose
frames are all STAY (1) or dead (2), a slot decoded to ``F - 1`` frames and
slots of random arcs; every packed column must equal the transcription's
exactly, with the endpoint statistics on and off, and the cost columns must
reassemble to the f32 costs bit for bit. The packed arc table the kernel
stages in shared memory (``walk_tables``) must hold ``arc_src`` and
``arc_sil`` exactly, and is refused past 65,535 states. On the card (marker
``cuda``) the kernel must equal its plain twin bit for bit, also on a graph
whose arc table is past 48 KB, and with the ring streamed through shared
memory in several chunks and chased directly.
"""

import numpy as np
import pytest
import torch

from rhasspy_speech_torch.ops.path_walk_cuda import (
    CHUNK_BYTES,
    MAX_ARCS,
    MAX_SMEM,
    MAX_STATES,
    PACKED_STAT_COLS,
    path_walk,
    path_walk_torch,
    walk_chunks,
    walk_start,
    walk_tables,
)

F, S, A = 40, 12, 30


def reference_walk(ring, frames, start, costs, arc_src, arc_sil, stats):
    """``walk_step`` over frames F - 1 .. 0 for every slot, then the packed
    stat columns, as the JAX scheduler builds them."""
    N = ring.shape[0]
    width = ring.shape[1]
    out = np.zeros((N, width + PACKED_STAT_COLS), np.int64)
    for n in range(N):
        state, trail, nonsil, done = int(start[n]), 0, False, False
        for f in range(width - 1, -1, -1):
            e = int(ring[n, f, state]) - 3
            active = f < frames[n]
            is_real = active and e >= 0
            emit = e if active else -2
            if stats:
                sil = bool(arc_sil[max(e, 0)]) if is_real else False
                if is_real and sil and not done:
                    trail += 1
                done = done or (active and not (is_real and sil))
                nonsil = nonsil or (is_real and not sil)
            if is_real:
                state = int(arc_src[max(e, 0)])
            out[n, f] = (emit + 2) & 0xFFFF
        cb = int(np.float32(costs[n, 0]).view(np.uint32))
        rb = int(np.float32(costs[n, 1]).view(np.uint32))
        out[n, width:] = [start[n], costs[n, 0] < 1.0e29, min(trail, 65535), nonsil,
                          cb & 0xFFFF, cb >> 16, rb & 0xFFFF, rb >> 16]
    return out


def seeded_case(seed, S=S, A=A):
    rng = np.random.RandomState(seed)
    arc_src = rng.randint(0, S, size=A).astype(np.int32)
    arc_sil = (rng.rand(A) < 0.4).astype(np.uint8)
    frames = np.array([0, 5, 9, 7, F - 1, 23, 31, 1], np.int32)
    N = frames.shape[0]
    ring = rng.randint(3, 3 + A, size=(N, F, S))
    ring[rng.rand(N, F, S) < 0.1] = 2  # dead entries
    ring[1] = 1  # STAY everywhere
    ring[2] = 2  # dead everywhere
    for n in range(N):  # rows past a slot's frames: no frame (0) or stale
        ring[n, frames[n]:] = 0 if n % 2 else ring[n, frames[n]:]
    alpha = rng.rand(N, S).astype(np.float32) * 50
    final = np.where(rng.rand(S) < 0.3, 0.5, 1.0e30).astype(np.float32)
    final[0] = 0.25
    alpha[6, final < 1.0e29] = 1.0e30  # no final state reachable
    alpha[7, :] = 1.0e30  # every state dead
    return ring, frames, alpha, final, arc_src, arc_sil


def as_torch(ring, frames, alpha, final, arc_src, arc_sil):
    start, costs = walk_start(torch.as_tensor(alpha), torch.as_tensor(final))
    tables = walk_tables(torch.as_tensor(arc_src), torch.as_tensor(arc_sil), alpha.shape[1])
    return (torch.as_tensor(ring.astype(np.int32)).to(torch.int16), torch.as_tensor(frames),
            start, costs, tables)


def unpack_tables(tables):
    """(sources, silence flags) read back from the kernel's packed table."""
    raw = tables.packed.numpy()
    A = tables.arc_src.shape[0]
    src = raw[: 2 * A].view("<u2").astype(np.int64)
    words = raw[16 * tables.src_vec :].view("<u4")
    e = np.arange(A)
    sil = (words[e >> 5] >> (e & 31).astype(np.uint32)) & 1
    return src, sil.astype(np.uint8)


@pytest.mark.parametrize("stats", [True, False], ids=["endpoint_stats", "no_stats"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_walk_equals_reference_transcription(seed, stats):
    case = seeded_case(seed)
    ring, frames, alpha, final, arc_src, arc_sil = case
    args = as_torch(*case)
    got = path_walk(*args, F, stats).numpy().view(np.uint16)
    start, costs = args[2].numpy(), args[3].numpy()
    want = reference_walk(ring, frames, start, costs, arc_src, arc_sil, stats)
    np.testing.assert_array_equal(got.astype(np.int64), want)
    # a slot with no frames, all-STAY and all-dead slots
    assert not got[0, :F].any()
    assert (got[1, :frames[1]] == 0).all() and (got[2, :frames[2]] == 1).all()
    if stats:
        assert got[2, F + 2] == 0 and got[2, F + 3] == 0


def test_walk_start_and_cost_halves():
    ring, frames, alpha, final, arc_src, arc_sil = seeded_case(3)
    start, costs = walk_start(torch.as_tensor(alpha), torch.as_tensor(final))
    totals = alpha + final[None, :]
    for n in range(alpha.shape[0]):
        reach = totals[n].min() < 1.0e29
        assert int(start[n]) == int(np.argmin(totals[n] if reach else alpha[n]))
        want_rel = totals[n].min() - alpha[n].min() if reach else np.inf
        assert costs[n, 1].item() == np.float32(want_rel)
    packed = path_walk(*as_torch(ring, frames, alpha, final, arc_src, arc_sil), F, True)
    p = packed.numpy().view(np.uint16)
    for col, which in ((F + 4, 0), (F + 6, 1)):
        bits = p[:, col].astype(np.uint32) | (p[:, col + 1].astype(np.uint32) << 16)
        np.testing.assert_array_equal(bits.view(np.float32), costs[:, which].numpy())
    assert list(p[:, F + 1]) == [int(totals[n].min() < 1.0e29) for n in range(len(frames))]


@pytest.mark.parametrize("num_states,num_arcs", [(12, 30), (803, 1964), (13789, 31288),
                                                  (MAX_STATES, MAX_ARCS), (5, 0)])
def test_walk_tables_hold_sources_and_silence(num_states, num_arcs):
    rng = np.random.RandomState(num_arcs)
    arc_src = rng.randint(0, num_states, size=num_arcs).astype(np.int32)
    if num_arcs:
        arc_src[-1] = num_states - 1  # the largest source id
    arc_sil = (rng.rand(num_arcs) < 0.3).astype(np.uint8)
    tables = walk_tables(torch.as_tensor(arc_src), torch.as_tensor(arc_sil), num_states)
    assert tables.packed.dtype == torch.uint8 and tables.smem_bytes % 16 == 0
    assert tables.smem_bytes == tables.packed.numel() <= 2 * num_arcs + num_arcs // 8 + 32
    src, sil = unpack_tables(tables)
    np.testing.assert_array_equal(src, arc_src)
    np.testing.assert_array_equal(sil, arc_sil)
    # the device route's largest graph fits an H100 block's shared memory,
    # with the streamed ring chunks where a row is small
    assert tables.smem_bytes <= 139 * 1024
    frames, chunk = walk_chunks(num_states, tables)
    assert tables.smem_bytes + 2 * chunk <= MAX_SMEM and chunk % 16 == 0
    assert (frames > 0) == (num_states <= 4096) == (chunk > 0)
    assert frames == 0 or frames * num_states * 2 <= min(CHUNK_BYTES, chunk - 16)


def test_walk_tables_refuse_past_uint16():
    src, sil = torch.zeros(4, dtype=torch.int32), torch.zeros(4, dtype=torch.uint8)
    walk_tables(src, sil, MAX_STATES)
    with pytest.raises(ValueError, match="states"):
        walk_tables(src, sil, MAX_STATES + 1)
    with pytest.raises(ValueError, match="arcs"):
        walk_tables(torch.zeros(MAX_ARCS + 1, dtype=torch.int32),
                    torch.zeros(MAX_ARCS + 1, dtype=torch.uint8), 10)
    with pytest.raises(ValueError, match="source"):
        walk_tables(torch.tensor([0, 10], dtype=torch.int32), sil[:2], 10)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel tests run on the card)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("stats", [True, False], ids=["endpoint_stats", "no_stats"])
def test_kernel_equals_twin(cuda, stats):
    args = as_torch(*seeded_case(4))
    want = path_walk_torch(*args, F, stats)
    before = path_walk.launches
    got = path_walk(*_to(args, cuda), F, stats)
    torch.cuda.synchronize()
    assert path_walk.launches == before + 1
    assert torch.equal(got.cpu(), want)


def _to(args, dev):
    ring, frames, start, costs, tables = args
    return (ring.to(dev), frames.to(dev), start.to(dev), costs.to(dev),
            walk_tables(tables.arc_src.to(dev), tables.arc_sil.to(dev), ring.shape[2]))


@pytest.mark.cuda
@pytest.mark.parametrize("stats", [True, False], ids=["endpoint_stats", "no_stats"])
@pytest.mark.parametrize("states,arcs,chunks", [(900, 31288, 2), (4000, 300, 5), (5000, 300, 0)],
                         ids=["past_48kb_of_arcs", "five_chunks", "direct_chase"])
def test_kernel_equals_twin_streamed_and_chased(cuda, stats, states, arcs, chunks):
    """31,288 arcs (the 13,789-state grammar's count): 66 KB of staged
    table, past the 48 KB a block gets without opting in, the ring in two
    streamed chunks; 4,000 states: five chunks of 8 rows; 5,000 states: a
    row past 8 a chunk, so the ring is chased in global memory."""
    case = seeded_case(5, S=states, A=arcs)
    args = as_torch(*case)
    assert (args[4].smem_bytes > 48 * 1024) == (arcs > 24000)
    frames, _bytes = walk_chunks(states, args[4])
    assert (-(-(F - 1) // frames) if frames else 0) == chunks
    want = path_walk_torch(*args, F, stats)
    got = path_walk(*_to(args, cuda), F, stats)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
