"""The pitch featurizer's batched path on the CPU: the scheduler's batched
path through the featurizer gives ``push``'s rows bit for bit.

With tests/test_torch_pitch_stream_featurizer.py it holds what was the
featurizer's part of tests/test_torch_pitch_stream.py: with the suite on
several workers each part takes minutes, so each has a file.
"""

import types

import numpy as np

from rhasspy_speech_tpu.ops import frontend as jfe
from rhasspy_speech_tpu.ops import pitch as jp
from rhasspy_speech_tpu.pipeline import streaming_features as jsf

import torch

from rhasspy_speech_torch.ops import frontend as tfe
from rhasspy_speech_torch.ops import pitch as tp
from rhasspy_speech_torch.ops.mfcc_cuda import mfcc_batch
from rhasspy_speech_torch.pipeline import streaming_features as tsf

from test_torch_pitch_stream import one_torch_thread  # noqa: F401 (an autouse fixture)


def _voiced(n, seed=9):
    """A voiced signal whose f0 glides 110 -> 180 Hz, with harmonics and
    noise."""
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 16000.0
    f0 = 110.0 + 70.0 * t / t[-1]
    phase = 2 * np.pi * np.cumsum(f0) / 16000.0
    sig = 3000 * np.sin(phase) + 1500 * np.sin(2 * phase) + 800 * np.sin(3 * phase)
    return (sig + 200 * rng.randn(n)).astype(np.float32)


def _featurizers():
    cfg_j, cfg_t = jfe.FrontendConfig(), tfe.FrontendConfig()
    jam = types.SimpleNamespace(frontend_config=cfg_j, frontend_params=jfe.make_frontend_params(cfg_j),
                                pitch_config=jp.PitchConfig())
    tam = types.SimpleNamespace(frontend_config=cfg_t, device=torch.device("cpu"),
                                frontend_params=tfe.make_frontend_params(cfg_t, "cpu"),
                                pitch_config=tp.PitchConfig())
    return tsf.StreamFeaturizer(tam), jsf.StreamFeaturizer(jam)


def test_batched_path_equals_push():
    """The scheduler's batched path (``prepare_mfcc_buf`` / ``commit_mfcc``
    and ``push_with_base`` for the MFCC rows, then ``pitch_window_array``,
    one pitch call, ``consume_pitch_rows`` and ``merge_pitch``, as
    ``_drain_pitch_all`` runs them) gives ``push``'s rows."""
    pcm = _voiced(24000, seed=3)
    tfz, _ = _featurizers()
    a, b = tfz.new_state(), tfz.new_state()
    got, want = [], []
    for off in range(0, pcm.shape[0], 3000):
        chunk = pcm[off : off + 3000]
        want.append(tfz.push(a, chunk))
        r = tfz.prepare_mfcc_buf(b, chunk)
        base = np.zeros((0, 40), np.float32)
        if r is not None:
            buf, k = r
            base = mfcc_batch(tfz.stream_params, torch.as_tensor(buf[None]))[0][:k].numpy()
            tfz.commit_mfcc(b, buf, k)
        got.append(tfz.push_with_base(b, chunk, base))
        window = tfz.pitch_window_array(b) if b.mfcc_pending.shape[0] else None
        if window is not None:
            rows = tp.pitch_batch(tfz.am.pitch_config, torch.as_tensor(window[None]))[0].numpy()
            got.append(tfz.merge_pitch(b, tfz.consume_pitch_rows(b, rows)))
    got.append(tfz.push(b, np.zeros(0, np.float32), flush=True))
    want.append(tfz.push(a, np.zeros(0, np.float32), flush=True))
    np.testing.assert_array_equal(np.concatenate(got), np.concatenate(want))
