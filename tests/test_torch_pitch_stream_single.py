"""Pitch on the port's single stream, on the CPU: the transcript equals the
JAX stream transcriber's and the spoken sentence on an nnet3 pitch profile
(``nnet3_pitch``, tests/test_torch_pitch_stream.py), its rows (40 MFCC + 3
pitch columns) the JAX stream's: the MFCC columns within
``testing/feature_tolerance.py``'s allowance for two f32 front ends (rtol
1e-4 / atol 2e-3, widened only on ill-conditioned frames), the pitch columns
within atol 1e-3 (tests/test_torch_pitch.py's tolerance).
"""

import numpy as np

from rhasspy_speech_tpu.pipeline.stream import Nnet3StreamTranscriber as JaxStreamTranscriber

from rhasspy_speech_torch.pipeline import Nnet3StreamTranscriber

from test_torch_pitch_stream import (  # noqa: F401 (fixtures)
    TEXTS,
    _allowance,
    _check_rows,
    nnet3_pitch,
    one_torch_thread,
)


def test_single_stream_equals_jax(nnet3_pitch):
    profile, graph_dir, pcms = nnet3_pitch
    st = Nnet3StreamTranscriber(profile.model_dir, graph_dir, device="cpu")
    jst = JaxStreamTranscriber(profile.model_dir, graph_dir)
    state, jstate = st.start_stream(), jst.start_stream()
    for off in range(0, pcms[0].shape[0], 1024):
        st.process_chunk(state, pcms[0][off : off + 1024])
        jst.process_chunk(jstate, pcms[0][off : off + 1024])
    got, want = st.finish_stream(state), jst.finish_stream(jstate)
    assert got == want == [TEXTS[0]]
    C = st.am.frontend_config.num_ceps
    assert state.feats.shape[1] == C + 3
    allow = _allowance(st.am.frontend_config, pcms[0]).rows(slice(0, state.feats.shape[0]))
    _check_rows(state.feats, np.asarray(jstate.feats), C, allow)
