"""A recurrent nnet3 model on the port's batch and stream routes, against
the JAX package, on the CPU (tests/test_torch_recurrent_scheduler.py holds
the scheduler's routes on the same profile).

The synthetic profile with ``recurrent_delay=3`` (``testing/synthetic.py``:
an LSTM-style back-edge at delay 3 whose contribution to the output is
exactly zero, so transcripts stay the spoken sentences while every
recurrent path runs) with an i-vector extractor, an AM context over the
i-vector tap and its CMVN stats, so the scheduler takes its device route
unless forced onto the host route. Batch transcripts must equal the JAX
package's and the spoken sentences; a stream's chunked log-probs must equal
the whole utterance's (rtol / atol 2e-4).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from rhasspy_speech_tpu.pipeline import Nnet3WavTranscriber as JaxTranscriber
from rhasspy_speech_tpu.pipeline.stream import Nnet3StreamTranscriber as JaxStream

import torch

from rhasspy_speech_torch.const import LangSuffix
from rhasspy_speech_torch.pipeline import Nnet3WavTranscriber, lang_dir_name
from rhasspy_speech_torch.pipeline.stream import Nnet3StreamTranscriber
from rhasspy_speech_torch.pipeline.train import train_model_sync
from rhasspy_speech_torch.testing import build_synthetic_profile, synthesize_sentence

from test_torch_pipeline import LEXICON
from test_torch_stream import SENTENCES

TEXTS = ["turn on the light", "never mind", "turn off the fan"]
LP_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_recurrent")
    profile = build_synthetic_profile(root / "model", LEXICON, recurrent_delay=3,
                                      with_ivector=True, with_context=True,
                                      with_ivector_cmvn=True)
    intents = {"language": "en", "intents": {"Main": {"data": [{"sentences": SENTENCES}]}}}
    train_model_sync("en", intents, root / "train", profile.model_dir,
                     lang_suffixes=[LangSuffix.GRAMMAR])
    graph_dir = root / "train" / lang_dir_name(LangSuffix.GRAMMAR)
    pcms = [synthesize_sentence(profile, t, seed=300 + i) for i, t in enumerate(TEXTS)]
    return profile, graph_dir, pcms


def test_batch_transcripts_and_log_probs_equal_jax(trained):
    profile, graph_dir, pcms = trained
    t = Nnet3WavTranscriber(profile.model_dir, graph_dir, device="cpu")
    jt = JaxTranscriber(profile.model_dir, graph_dir)
    assert t.am.compiled(16).plan.recurrent and t.am.compiled(16).plan.recurrence == 3
    assert t.transcribe_pcm_batch(pcms) == jt.transcribe_pcm_batch(pcms) == [[x] for x in TEXTS]
    # the log-probs of the padded batch at its own bucket (the JAX package
    # reuses the program it compiled for the call)
    pcm, feat_lengths, _lengths, bucket = t._pad_batch(pcms)
    feats = jt.am.features(pcm.numpy())
    got = t.am.log_probs(torch.as_tensor(np.array(feats)), bucket, feat_lengths=feat_lengths)
    want = jt.am.log_probs(feats, bucket, feat_lengths=jnp.asarray(feat_lengths.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LP_TOL)


def test_stream_chunks_equal_the_whole_utterance(trained):
    """Each chunk's log-probs continue the recurrence from the last chunk's
    carry (zero at start_stream): concatenated, the valid frames equal the
    batch forward over the stream's own features; transcripts equal the
    JAX stream transcriber's."""
    profile, graph_dir, pcms = trained
    st = Nnet3StreamTranscriber(profile.model_dir, graph_dir, device="cpu")
    chunks = []
    decode = st._decode_chunk

    def keep(state, log_probs, n_valid):
        chunks.append(log_probs[0, :n_valid].clone())
        return decode(state, log_probs, n_valid)

    st._decode_chunk = keep
    state = st.start_stream()
    assert set(state.am_state) == {"rec.b"}
    assert not state.am_state["rec.b"].any()
    for off in range(0, pcms[1].shape[0], 1024):
        st.process_chunk(state, pcms[1][off : off + 1024])
    st.finish_nbest(state)
    got = torch.cat(chunks).numpy()
    T = state.feats.shape[0]
    whole = st.am.log_probs(torch.as_tensor(state.feats[None]), T)[0].numpy()
    assert got.shape == whole.shape and state.am_state["rec.b"].abs().max() > 0
    np.testing.assert_allclose(got, whole, **LP_TOL)
    jst = JaxStream(profile.model_dir, graph_dir)
    assert st.transcribe_pcm(pcms[0], chunk_samples=1024) == jst.transcribe_pcm(
        pcms[0], chunk_samples=1024) == [TEXTS[0]]
