"""The scheduler's whole-path walk (``ops/path_walk_cuda.py``) against a
NumPy transcription of the JAX scheduler's ``walk_step``
(``rhasspy_speech_tpu/pipeline/scheduler.py``, the scan at the end of
``batch_chunk``), which walks every slot over the ring's full depth.

Seeded rings of ``bp + 3`` entries hold slots with no frames, slots whose
frames are all STAY (1) or dead (2), a slot decoded to ``F - 1`` frames and
slots of random arcs; every packed column must equal the transcription's
exactly, with the endpoint statistics on and off, and the cost columns must
reassemble to the f32 costs bit for bit. On the card (marker ``cuda``) the
kernel must equal its plain twin bit for bit.
"""

import numpy as np
import pytest
import torch

from rhasspy_speech_torch.ops.path_walk_cuda import (
    PACKED_STAT_COLS,
    path_walk,
    path_walk_torch,
    walk_start,
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


def seeded_case(seed):
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
    return (torch.as_tensor(ring.astype(np.int32)).to(torch.int16), torch.as_tensor(frames),
            start, costs, torch.as_tensor(arc_src), torch.as_tensor(arc_sil))


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
    got = path_walk(*[a.to(cuda) for a in args], F, stats)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
