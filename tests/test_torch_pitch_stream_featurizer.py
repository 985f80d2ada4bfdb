"""The pitch featurizer's rows against the JAX featurizer's on the CPU.

Its rows (40 MFCC + 3 pitch columns) equal the JAX featurizer's push by
push, over several chunkings of 2.5 s of a voiced signal (the sliding 2 s
pitch window moves): the same row counts, the MFCC columns within
``testing/feature_tolerance.py``'s allowance for two f32 front ends (rtol
1e-4 / atol 2e-3, widened only on ill-conditioned frames), the pitch
columns within atol 1e-3 (tests/test_torch_pitch.py's tolerance).
"""

import numpy as np
import pytest

from rhasspy_speech_torch.ops import frontend as tfe

from test_torch_pitch_stream import _allowance, _check_rows, one_torch_thread  # noqa: F401
from test_torch_pitch_stream_batched import _featurizers, _voiced

CHUNKINGS = {
    "4000": [4000] * 10,
    "uneven": [160, 3360, 7, 4000, 1, 20000, 9000],
    "one_push": [40000],
}


@pytest.mark.parametrize("chunking", sorted(CHUNKINGS))
def test_featurizer_pitch_rows_equal_jax(chunking):
    pcm = _voiced(40000)
    tfz, jfz = _featurizers()
    assert tfz.has_pitch and tfz.feat_dim == 43 and tfz.pitch_window == jfz.pitch_window
    ts, js = tfz.new_state(), jfz.new_state()
    allow = _allowance(tfz.am.frontend_config, pcm)
    off, total = 0, 0
    for n in CHUNKINGS[chunking] + [None]:  # None: the flush
        chunk = pcm[off : off + n] if n is not None else np.zeros(0, np.float32)
        flush = n is None
        got, want = tfz.push(ts, chunk, flush=flush), jfz.push(js, chunk, flush=flush)
        _check_rows(got, want, 40, allow.rows(slice(total, total + got.shape[0])))
        assert ts.pitch_done == js.pitch_done and ts.total_samples == js.total_samples
        off += 0 if n is None else n
        total += got.shape[0]
    assert total == tfe.num_frames(tfz.am.frontend_config, off)
