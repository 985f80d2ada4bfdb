"""The pitch-lag Viterbi (``ops/pitch_viterbi_cuda.py``) against the JAX
package's scans, bit for bit.

``pitch_viterbi_torch`` (the plain twin, what the wrapper runs on the CPU)
must equal a NumPy transcription of the reference's forward and reverse
scans (``rhasspy_speech_tpu/ops/pitch.py:246-275``) exactly, on seeded
``local`` arrays quantized so that many candidates tie: the backpointer is
the first j that reaches the minimum, as ``jnp.argmin`` takes it. Given
the same ``local``, the states equal those of the reference's
own ``jax.lax.scan`` code and the ``pitch_track`` pitch of the JAX
package. On the card (marker ``cuda``) the kernel must equal the twin bit
for bit, at the batch and tick shapes of the chip run (B = 32, T = 296 and
196, NL = 417) and on small ones.
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from rhasspy_speech_tpu.ops import pitch as jp

import torch

from rhasspy_speech_torch.ops import pitch as tp
from rhasspy_speech_torch.ops.pitch_viterbi_cuda import (
    pitch_viterbi,
    pitch_viterbi_torch,
    transition_costs,
)

NL_DEFAULT = tp.make_lags(tp.PitchConfig()).shape[0]
CFG = tp.PitchConfig()


def _dist(nl):
    return transition_costs(nl, CFG.delta_pitch, CFG.penalty_factor)


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


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 296), (32, 196), (1, 196), (3, 7)])
def test_kernel_equals_twin(cuda, shape):
    B, T = shape
    local, dist = tied_local(7, B, T, NL_DEFAULT, levels=40), _dist(NL_DEFAULT)
    lt, dt = torch.as_tensor(local, device=cuda), torch.as_tensor(dist, device=cuda)
    before = pitch_viterbi.launches
    got = pitch_viterbi(lt, dt)
    torch.cuda.synchronize()
    assert pitch_viterbi.launches == before + 1
    assert torch.equal(got, pitch_viterbi_torch(lt, dt))
