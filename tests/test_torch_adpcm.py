"""The port's 4-bit block-ADPCM serving wire against the JAX package's: the
codec contract on the port's copy (quality, stability, causality), the
device decode's plain twin (``decode_blocks_torch``) bit-equal to the JAX
package's ``decode_blocks_jnp`` on the same seeded bytes, the native
encoder byte-equal to the NumPy codec, and the stream scheduler over the
wire on the CPU: transcripts equal to the JAX scheduler's on the same
synthetic profile and wire, to the spoken sentences, and whatever the
arrival timing. K6 (``ops/adpcm_cuda.py``) decodes a block as a warp scan
of clamped adds: a NumPy emulation of that scan (32 lanes, each lane's
maps composed, two scans) is bit-equal to the twin and to the JAX decode
on seeded and saturating bytes at block sizes of 1 to 10 steps a lane. On
a card the kernel is bit-equal to the twin on the same bytes (marker
``cuda``).
"""

import numpy as np
import pytest

import jax

from rhasspy_speech_tpu.ops import adpcm as jax_adpcm
from rhasspy_speech_tpu.pipeline.scheduler import StreamScheduler as JaxScheduler

import torch

from rhasspy_speech_torch.ops import adpcm
from rhasspy_speech_torch.ops.adpcm import INDEX_TABLE, STEP_TABLE, block_bytes
from rhasspy_speech_torch.ops.adpcm_cuda import adpcm_decode
from rhasspy_speech_torch.pipeline.scheduler import StreamScheduler
from rhasspy_speech_torch.testing import synthesize_sentence
from rhasspy_speech_torch.testing.adpcm_wires import saturating_wire

from test_torch_mulaw import WIRE_TEXTS, pitch_profile, run_interleaved, run_whole, wire_profile  # noqa: F401

BLOCK = 160
# 1, 2, 3, 5 and 10 steps a lane of K6's scan
SCAN_BLOCKS = (2, 33, 80, 160, 321)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _encode(x: np.ndarray, block: int = BLOCK):
    """One-lane helper: pad to whole blocks, return (bytes, recon)."""
    n = x.shape[0]
    w = -(-n // block) * block
    samples = np.zeros((1, w), dtype=np.float32)
    samples[0, :n] = x
    out = np.zeros((1, (w // block) * adpcm.block_bytes(block)), np.uint8)
    adpcm.encode_blocks(samples, np.array([n]), block, out)
    return out, samples  # recon in place


def _seeded_wire(seed, N=4, nb=5, block=BLOCK):
    """Seeded ADPCM bytes [N, nb * bpb] (full, partial and empty lanes)."""
    rng = np.random.RandomState(seed)
    samples = (rng.randn(N, nb * block) * 5000).astype(np.float32)
    samples[1] = np.clip(np.cumsum(rng.randn(nb * block)) * 9000, -40000, 40000)
    out = np.zeros((N, nb * adpcm.block_bytes(block)), np.uint8)
    lens = np.array([nb * block, 3 * block + block // 9, 0, block] + [nb * block] * (N - 4))
    adpcm.encode_blocks(samples, lens, block, out)
    return out


_K_BIG, _K_SAT = 1 << 29, 1 << 20  # csrc/adpcm_decode.cu's kBig, kSat
_IDENTITY = (0, -_K_BIG, _K_BIG)


def _then(f, g):
    """The clamped add x -> min(max(x + a, l), h) f, then g."""
    return (np.clip(f[0] + g[0], -_K_SAT, _K_SAT), np.clip(f[1] + g[0], g[1], g[2]),
            np.clip(f[2] + g[0], g[1], g[2]))


def _exclusive_scan(f):
    """[M, 32] lane maps -> each lane's composition of the lanes below it,
    by the kernel's 5 rounds of __shfl_up_sync."""
    lane = np.arange(32)
    for off in (1, 2, 4, 8, 16):
        up = _then(tuple(np.roll(x, off, axis=1) for x in f), f)
        f = tuple(np.where(lane >= off, u, x) for u, x in zip(up, f))
    return tuple(np.where(lane == 0, i, np.roll(x, 1, axis=1)) for i, x in zip(_IDENTITY, f))


def scan_decode(wire, block):
    """K6's decode in NumPy: one warp a block, lane j owning steps 1 + jK ..
    (j + 1)K, K = ceil((block - 1) / 32); the lanes' index maps composed and
    scanned from the header's index, the predictor maps (their increments
    from the walked indices) composed and scanned from the header's sample,
    then each lane's samples. int64 arithmetic, held inside int32."""
    bpb = block_bytes(block)
    N, nb = wire.shape[0], wire.shape[1] // bpb
    blk = wire[:, : nb * bpb].reshape(N * nb, bpb).astype(np.int64)
    pred0 = blk[:, 0] | (blk[:, 1] << 8)
    pred0 = (pred0 - 2 * (pred0 & 0x8000))[:, None]
    idx0 = np.minimum(blk[:, 2], 88)[:, None]
    nib = np.zeros((N * nb, block), np.int64)
    nib[:, 1::2] = (blk[:, 3:] & 0xF)[:, : (block // 2)]
    nib[:, 2::2] = (blk[:, 3:] >> 4)[:, : (block - 1) // 2]
    K = -(-(block - 1) // 32)
    t0 = 1 + K * np.arange(32)
    steps = [(np.minimum(t0 + i, block - 1), t0 + i < block) for i in range(K)]
    step_table = STEP_TABLE.astype(np.int64)

    def walk(idx):
        """Each step's (nibble, code, increment, valid), the index walked."""
        for t, valid in steps:
            n = nib[:, t]
            code = n & 7
            step = step_table[idx]
            dq = (step >> 3) + np.where(code & 4, step, 0) + np.where(code & 2, step >> 1, 0) \
                + np.where(code & 1, step >> 2, 0)
            yield t, valid, code, np.where(n & 8, -dq, dq)
            idx = np.where(valid, np.clip(idx + INDEX_TABLE[code], 0, 88), idx)

    def compose(maps):
        f = tuple(np.broadcast_to(np.int64(x), (N * nb, 32)) for x in _IDENTITY)
        for valid, g in maps:
            f = tuple(np.where(valid, a, b) for a, b in zip(_then(f, g), f))
        assert all(np.abs(x).max() < 2 ** 31 for x in f)
        return f

    def apply(f, x):
        return np.clip(x + f[0], f[1], f[2])

    idx_maps = compose((v, (INDEX_TABLE[nib[:, t] & 7], 0, 88)) for t, v in steps)
    idx_start = apply(_exclusive_scan(idx_maps), idx0)
    pred_maps = compose((v, (d, -32768, 32767)) for _t, v, _c, d in walk(idx_start))
    pred = apply(_exclusive_scan(pred_maps), pred0)
    out = np.zeros((N * nb, block), np.int64)
    out[:, 0] = pred0[:, 0]
    rows = np.arange(N * nb)[:, None]
    for t, valid, _code, d in walk(idx_start):
        pred = np.where(valid, np.clip(pred + d, -32768, 32767), pred)
        out[rows, np.where(valid, t, 0)] = np.where(valid, pred, out[:, :1])
    return out.reshape(N, nb * block).astype(np.float32)


def test_codec_quality_and_exact_integers():
    """Speech-scale signal reconstructs with usable SNR; the reconstruction
    is exact integers and equals the JAX package's."""
    rng = np.random.RandomState(0)
    t = np.arange(16000, dtype=np.float32) / 16000.0
    x = (
        6000 * np.sin(2 * np.pi * 220 * t)
        + 2500 * np.sin(2 * np.pi * 800 * t + 1.0)
        + 400 * rng.randn(16000)
    ).astype(np.float32)
    enc, recon = _encode(x)
    r = recon[0, : x.shape[0]]
    assert (r == np.rint(r)).all()
    err = x - r
    snr = 10 * np.log10(float(np.mean(x**2)) / float(np.mean(err**2)))
    assert snr > 18.0, snr
    np.testing.assert_array_equal(adpcm.decode_blocks(enc, BLOCK), recon)
    np.testing.assert_array_equal(jax_adpcm.decode_blocks(enc, BLOCK), recon)


def test_stability_reencode_recon():
    """Re-encoding decoded values reproduces both the bytes and the decoded
    values, also at the int16 rails."""
    rng = np.random.RandomState(1)
    sigs = [
        (rng.randn(5 * BLOCK) * 3000).astype(np.float32),
        np.clip(np.cumsum(rng.randn(5 * BLOCK)) * 9000, -40000, 40000).astype(np.float32),
        np.zeros(2 * BLOCK, dtype=np.float32),
        np.full(2 * BLOCK, 32767.0, dtype=np.float32),
        np.full(2 * BLOCK, -32768.0, dtype=np.float32),
    ]
    for x in sigs:
        enc1, recon1 = _encode(x)
        enc2, recon2 = _encode(recon1[0])
        np.testing.assert_array_equal(recon2, recon1)
        np.testing.assert_array_equal(enc2, enc1)


def test_causality_partial_block_extension():
    """Nibbles already emitted for a partly filled block do not change when
    the block fills on a later tick."""
    rng = np.random.RandomState(2)
    x = (rng.randn(3 * BLOCK) * 4000).astype(np.float32)
    for k in (BLOCK + 1, BLOCK + 37, 2 * BLOCK + 159):
        _enc_k, recon_k = _encode(x[:k])
        _enc_f, recon_f = _encode(x)
        np.testing.assert_array_equal(recon_f[0, :k], recon_k[0, :k])


def test_device_decode_matches_jax():
    """The same seeded bytes through the JAX package's device decode and
    the port's plain twin (and the wrapper on CPU tensors): bit-equal, and
    equal to the NumPy decode; also at the tick's shape, [32, 5 x 83]."""
    for seed, N in ((3, 4), (4, 32)):
        out = _seeded_wire(seed, N=N)
        want = np.asarray(jax.jit(jax_adpcm.decode_blocks_jnp, static_argnums=1)(out, BLOCK))
        got = adpcm.decode_blocks_torch(torch.as_tensor(out), BLOCK)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), adpcm.decode_blocks(out, BLOCK))
        np.testing.assert_array_equal(adpcm_decode(torch.as_tensor(out), BLOCK).numpy(), want)


@pytest.mark.parametrize("block", SCAN_BLOCKS)
def test_scan_emulation_bit_equal(block):
    """K6's scan, emulated, against the twin and the JAX decode: bit-equal
    on seeded wire bytes and on bytes that saturate both recurrences."""
    decode_jax = jax.jit(jax_adpcm.decode_blocks_jnp, static_argnums=1)
    for wire in (_seeded_wire(block, N=5, nb=3, block=block), saturating_wire(5, 4, block)):
        got = scan_decode(wire, block)
        want = adpcm.decode_blocks_torch(torch.as_tensor(wire), block).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, np.asarray(decode_jax(wire, block)))
    if block >= 33:  # the saturating bytes reach both of the sample's clamps
        assert got.max() == 32767 and got.min() == -32768


def test_native_encode_matches_python():
    """The native drain encoder agrees byte for byte, and reconstruction
    for reconstruction, with the NumPy codec."""
    from rhasspy_speech_torch.native import runtime as rt

    lib = rt.get_runtime().lib
    if lib is None or not hasattr(lib, "rss_adpcm_encode_blocks"):
        pytest.skip("native runtime without the ADPCM encoder")
    rng = np.random.RandomState(4)
    W = 6 * BLOCK
    samples = (rng.randn(3, W) * 6000).astype(np.float32)
    samples[1] = np.clip(np.cumsum(rng.randn(W)) * 9000, -40000, 40000)
    lens = np.array([W, 4 * BLOCK + 31, 0], dtype=np.int64)
    nb = W // BLOCK
    ref_s = samples.copy()
    ref_o = np.zeros((3, nb * adpcm.block_bytes(BLOCK) + 5), np.uint8)
    adpcm.encode_blocks(ref_s, lens, BLOCK, ref_o[:, :-5])
    nat_s = samples.copy()
    nat_o = np.zeros_like(ref_o)
    rt.adpcm_encode_into(nat_s, lens, BLOCK, nat_o[:, :-5])
    np.testing.assert_array_equal(nat_o, ref_o)
    np.testing.assert_array_equal(nat_s, ref_s)


def test_scheduler_adpcm_wire(wire_profile):  # noqa: F811
    """Interleaved feeding over the 4-bit wire: transcripts equal the JAX
    scheduler's on the same wire and the spoken sentences, and a decoding
    tick is still one device program."""
    profile, graph_dir = wire_profile
    pcms = [synthesize_sentence(profile, t, seed=500 + i) for i, t in enumerate(WIRE_TEXTS)]
    sched = StreamScheduler(profile.model_dir, graph_dir, max_streams=4, wire="adpcm",
                            device="cpu")
    assert sched._wire == "adpcm" and sched._device_feats
    got, ticks, dispatches = run_interleaved(sched, pcms)
    assert got == [[t] for t in WIRE_TEXTS], got
    assert 0 < ticks and dispatches <= ticks
    jax_sched = JaxScheduler(profile.model_dir, graph_dir, max_streams=4, wire="adpcm")
    assert jax_sched._wire_adpcm
    assert run_interleaved(jax_sched, pcms)[0] == got


def test_scheduler_adpcm_arrival_invariance(wire_profile):  # noqa: F811
    """Arrival timing does not change transcripts: random dribbles and
    bursts move the drain boundaries, so the frame-overlap tails re-encode
    at other cut points, and the decoded stream stays the same."""
    profile, graph_dir = wire_profile
    texts = ["turn on the light", "never mind"]
    pcms = {t: synthesize_sentence(profile, t, seed=700 + i) for i, t in enumerate(texts)}

    def once(feed_plan):
        sched = StreamScheduler(profile.model_dir, graph_dir, max_streams=2, wire="adpcm",
                                device="cpu")
        sids = {t: sched.open_stream() for t in texts}
        offs = {t: 0 for t in texts}
        rng = np.random.RandomState(feed_plan)
        for _ in range(600):
            for t in texts:
                pcm = pcms[t]
                if offs[t] < len(pcm):
                    n = len(pcm) if feed_plan is None else int(rng.choice([400, 1024, 3360, 20000]))
                    sched.feed(sids[t], pcm[offs[t] : offs[t] + n])
                    offs[t] += n
                    if offs[t] >= len(pcm):
                        sched.finish(sids[t])
            sched.step()
            if all(sched.poll(sids[t]) is not None for t in texts):
                break
        return {t: sched.poll(sids[t]) for t in texts}

    want = once(None)
    assert want == {t: [t] for t in texts}, want
    for seed in (11, 12):
        assert once(seed) == want, seed


def test_scheduler_adpcm_pitch_ivector(tmp_path):
    """The 4-bit wire beside the tick's pitch lane and inline i-vector."""
    profile, graph_dir = pitch_profile(tmp_path)
    sched = StreamScheduler(profile.model_dir, graph_dir, max_streams=4, wire="adpcm",
                            device="cpu")
    assert sched._wire == "adpcm" and sched._pitch_device
    texts = ["turn on light", "turn off light"]
    pcms = [synthesize_sentence(profile, t, seed=60 + i) for i, t in enumerate(texts)]
    assert run_whole(sched, pcms) == [[t] for t in texts]


@pytest.mark.cuda
def test_decode_kernel_bit_equal(cuda):
    """K6 against its twin on the card, at the tick's shape and on a column
    slice of a wider batch (the upload's meta columns follow the wire)."""
    out = _seeded_wire(7, N=32)
    want = adpcm.decode_blocks_torch(torch.as_tensor(out), BLOCK)
    wide = np.zeros((32, out.shape[1] + 48), np.uint8)
    wide[:, : out.shape[1]] = out
    before = adpcm_decode.launches
    for wire in (torch.as_tensor(out, device=cuda),
                 torch.as_tensor(wide, device=cuda)[:, : out.shape[1]]):
        got = adpcm_decode(wire, BLOCK)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)
    assert adpcm_decode.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("block", SCAN_BLOCKS)
def test_decode_kernel_scan_cases(cuda, block):
    """K6 against its twin at every block size of the emulation, on seeded
    and saturating bytes, with block counts that leave the last CTA (4
    blocks) partly filled, and on a column slice of a wider batch."""
    before = adpcm_decode.launches
    for wire in (_seeded_wire(block + 1, N=5, nb=3, block=block), saturating_wire(5, 3, block)):
        assert (wire.shape[0] * wire.shape[1] // block_bytes(block)) % 4
        want = adpcm.decode_blocks_torch(torch.as_tensor(wire), block)
        wide = np.zeros((wire.shape[0], wire.shape[1] + 13), np.uint8)
        wide[:, : wire.shape[1]] = wire
        for dev_wire in (torch.as_tensor(wire, device=cuda),
                         torch.as_tensor(wide, device=cuda)[:, : wire.shape[1]]):
            got = adpcm_decode(dev_wire, block)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), want)
    assert adpcm_decode.launches == before + 4
