#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

Drives batch WAV transcription (``Nnet3WavTranscriber.transcribe_pcm_batch``)
at the full width of the benchmarked model -- TDNN-F 768 x 9, 40-dim MFCC,
100-dim i-vector from a 512-Gaussian UBM, 3,072 pdfs, random weights from a
seed -- over the flagship decode graph, then its n-best, silence-weighting
and lattice paths, the windowed-relaxation entry point and the stream
scheduler, then the two other acoustic-model families at full width (a
Kaldi tri1 GMM system and a DeepSpeech-width Coqui STT model), a chain
model with Kaldi pitch features and a TDNN-LSTM chain model, then bf16
compute, dither and every nnet3 component type, the mu-law and ADPCM
serving wires, an odd MFCC window, the command line with a warm start, and
the stream mesh, and checks the six hand-written kernels (K2 in three
bodies) against their plain PyTorch twins:

1. builds ``csrc/mfcc.cu``, ``csrc/viterbi.cu``, ``csrc/viterbi_large.cu``,
   ``csrc/windowed_relax.cu``, ``csrc/path_walk.cu``, ``csrc/pitch_viterbi.cu``,
   ``csrc/adpcm_decode.cu`` and ``csrc/tick_stamp.cu`` with nvcc for sm_90a,
   in parallel, and maps the card's clock onto the host's
   (``ops/tick_stamp_cuda.py:calibrate``), again at the run's end: the
   drift between the two clocks over the run is printed;
2. transcribes 32 seeded 3 s utterances (1-best) with the launch counters
   zeroed just before and read just after, and requires the MFCC and
   Viterbi kernels to have run;
3. recomputes the same batch through the plain twins on the card and
   requires equal transcripts;
4. compares the MFCC kernel with its twin (rtol 2e-3 / atol 3e-2, the JAX
   package's tolerance for its own DFT-as-matmul kernel against rfft) and
   holds it, and prints its twin's ratio, against float64 within
   ``testing/feature_tolerance.py``'s allowance on the main path's PCM and
   on int16 tone bursts at gains over 4 decades (phase 22 does the same at
   N = 401), and compares
   the Viterbi kernel with its twin bit for bit, at B=32 and B=1, on the
   flagship graph and on a seeded folded graph of 14,200 states / 38,400
   arcs / 3,072 pdfs (``testing/decode_graphs.py``), and times the Viterbi
   kernel at each cluster size that fits;
5. checks the card's log-probs against the CPU twins on 2 utterances
   (rtol 1e-3 / atol 1e-2: f32 sums ordered differently through eleven
   768-wide layers), times each kernel beside its twin with CUDA events,
   and prints the main path's wall time stage by stage;
6. n-best (k=5) on the same batch: the MFCC kernel ran, transcripts equal
   the plain twins' path, and given the same log-probs the card's k-best
   outputs are bit-equal to the CPU's on 2 utterances;
7. silence weighting (``silence_weight=0.01``, with ``model/phones.txt``
   written from the graph's phone table): the first pass went through the
   Viterbi kernel and the silence-weighted second pass ran; transcripts
   equal the CPU's on 2 utterances;
8. lattices and confidence on 2 utterances, at a lattice beam of 4: given
   the same log-probs the card's tropical forward-backward is bit-equal to
   the CPU's, and the confidences agree with the CPU's within 1e-2 (the
   log-probs differ by up to 1e-2; a lattice arc flipping across the beam
   moves a confidence by at most exp(-4) of a rival's share). The beam is
   4, not the default 8, because on noise through a random model the
   default beam keeps ~10,000 arcs and the host's lattice determinization
   then takes tens of seconds per utterance;
9. the windowed relaxation at the example's shape (B=512, T=116,
   S_pad=14,208, NSTEP=1,280) through
   ``rhasspy_speech_torch.examples.windowed_cost.main``, counted, bit-equal
   to its plain version on every stream; then timed and held bit-equal at
   every thread-block cluster size the card accepts, at the example's
   shape and at a batch (13) that no cluster size divides; timed once more
   with indices that cause no shared-memory bank conflicts; and bit-equal
   again on small tables and initial alphas that differ per stream;
10. the big-graph decoders: trains a generated template grammar
   (``testing/big_grammar.py``, more than 7,000 states) against a full-width
   model, transcribes the 32 utterances with ``decode_memory_budget`` values
   that route to the checkpointed decoder (1-best; transcripts and costs
   equal to the dense run's) and to the frontier decoder (n-best; at a
   batch of 32 the budget leaves a few hundred of the graph's states a
   frame, a beam search: held bit-equal to the same decode on CPU tensors
   never cheaper than the dense decode, and at least 12 of the 32 must
   reach a final state; with n-best 12 on 4 utterances a call the same
   rule leaves every state, and each top hypothesis, its cost and the
   transcript equal the dense run's). The checkpointed route launches K2
   twice a segment (forward, then the recompute), counted. On seeded
   log-probs the checkpointed route through K2 and the twin's are bit-equal
   to K2's dense decode, and ``viterbi_topk`` with K = S equals the dense
   decode by both dedup strategies. Each decoder is timed at B=32 with CUDA
   events. Then K2 past one SM's shared memory (``csrc/viterbi_large.cu``):
   its halo body on a seeded 40,000-state graph at [32, 112, 3072] and [1,
   112, 3072], bit-equal to the twin (traces, final states, costs, alpha,
   backpointers) and timed beside the twin's scan with its bound and share,
   and at every cluster size and body that fits; the generated grammar
   trained past the replicated body's reach (``PAST_REACH_SIZES``: 37,072
   states, 86,216 arcs) through ``transcribe_pcm_batch`` (plan "dense", one
   halo-body launch counted, traces and transcripts equal to the twin
   route's), 8 utterances streamed (one halo launch a 7-frame chunk with
   ``alpha0``, each held bit-equal to ``viterbi(alpha0=...)``) and the
   scheduler's host route at 8 slots (one launch a tick with a chunk, each
   held the same; at least 6 of 8 transcripts equal the stream's); the
   scheduler's captured device route at 32 slots on a seeded 30,000-state
   graph of 62,400 arcs (halo body; replays bit-equal to the eager body; K4
   on its ring against its twin); and the global body on a seeded graph
   past the halo body's reach (16 slices each one state past two alpha
   buffers, 8 slices where the card runs no cluster of 16) through the
   transcriber, counted, and at [8, 112, 3072] bit-equal to the twin and
   timed beside it;
11. streaming: 8 utterances streamed in 1,024-sample chunks through
   ``Nnet3StreamTranscriber`` (one with ``silence_weight``, one with
   ``nbest=3``, two through ``async_transcribe``), the launch counters
   showing one MFCC launch a push and one Viterbi launch a chunk; streamed
   feature rows bit-equal to the batch rows; transcripts equal to the same
   streams on CPU tensors, and, for a copy of the model without its
   i-vector extractor, to ``transcribe_pcm_batch`` (with the extractor the
   stream's i-vector is the online estimate from the chunks so far and the
   batch's the whole utterance's, so on noise through a random model their
   transcripts may differ: at least 6 of the 8 must agree, and the count
   is printed); the Viterbi kernel with a
   carried alpha against ``viterbi(alpha0=...)`` bit for bit at T=7, B=1 and
   B=32 on both graphs; a chunk's milliseconds stage by stage and the
   stream's real-time factor;
12. the stream scheduler (``pipeline.scheduler.StreamScheduler``, 32 slots)
   on its device route (feature and backpointer rings on the card, the
   tick captured as CUDA graphs): the 32 utterances fed interleaved in
   1,024-sample pushes (stream i from round i % 4, a tick after each
   round), on the flagship graph and on the 13,789-state generated grammar.
   By the scheduler's own count (captured launches times replays) every
   tick makes at most one MFCC, one Viterbi and one path-walk launch, one
   stamp launch a stamp its bodies take (``device_tick.STAMPS_TAKEN``), one
   upload and one download, and all three kernels run; every replay of the
   counted run is bit-equal to the tick body run eagerly on copies of its
   state and inputs; K2 at the tick's shapes (the first tick with an idle
   slot, the first with a partial chunk) is bit-equal to the plain
   decoder; at least 30 of 32 transcripts equal the single stream's and the
   host route's (forced, as the CPU tests force it); the path walk (K4) on
   each graph's ring at the run's end is bit-equal to its twin and timed
   beside its bound; one replay of the flagship's captured fused tick,
   timed by CUDA events, takes six stamp launches and stamps s0 .. s5 in
   order, spanning no more than the events' time and lying, on the host
   clock, between the replay's issue and its synchronize (within the
   calibration's error); after a warm-up, every AM lane bucket (8, 16 and
   32 rows) has a captured fused graph, and each captured fused graph
   replays once checked bit-equal to its body run eagerly, with its node
   count and its replay's device time (CUDA events, median of 10, the state
   put back before each) printed; one tick with every slot decoding run
   again from its state with 1, 8 and 9 slots decoding, at the tick's lane
   bucket and at every slot: rings, offsets and packed traces equal, alpha
   and the packed costs within rtol 1e-5 / atol 1e-2, the decoding slots'
   log-probs within 1e-4, a recurrent AM's idle rows bit-unchanged; tick ms
   p50 / p90 (host clock) captured, eager and on
   the host route, bytes down a tick, graphs captured, the fleet's
   real-time factor, and the host-side stages in a synchronized pass. Then
   the port's synthetic speech profile (``testing/synthetic.py``, with an
   AM context over the i-vector tap and the extractor's CMVN stats, so on
   the device route): 8 spoken sentences with trailing silence and no
   ``finish()`` must all endpoint to the spoken sentence and the batch
   transcript on both routes, plain and with ``silence_weight`` (which must
   weigh at least one frame), each stream's endpoint tick printed beside
   the host route's;
13. the Kaldi GMM family at the width of mini_librispeech's tri1
   (``testing/full_width.py``: 2,000 pdfs, 10,000 diagonal Gaussians, 13
   cepstra from 23 mel bins + deltas and delta-deltas; the flagship graph's
   transition model) over the flagship graph and the generated grammar:
   the 32 utterances through ``transcribe_pcm_batch``, counted (one MFCC
   and one Viterbi launch), transcripts equal to the plain twins' path, K1
   held to its twin at 13 / 23 and K2 bit-equal to its twin at [32, 304,
   2000] (298 frames a stream), the call's stages with the deltas and the
   GMM log-likelihoods on their own, the log-likelihoods timed beside
   their bound; 8 utterances streamed (one MFCC launch a push, one Viterbi
   launch a 7-frame chunk; feature rows bit-equal to the batch rows; all 8
   transcripts equal the batch's); the scheduler's device route on both
   graphs, captured, as in 12 with all 32 transcripts equal to the single
   stream's and the host route's; the synthetic GMM profile's spoken
   sentences endpointing to themselves on both routes;
14. the Coqui STT family: a DeepSpeech 0.9 English-width model (2,048
   hidden, an LSTM of 2,048 cells, 29 labels; 47.2 M parameters) written as
   ``model.tflite`` and converted on load; ``transcribe_pcm`` on 4 of the
   utterances, counted (one MFCC launch each); probs on the card against
   the port on the CPU on one (atol 1e-3); the stream triple in 1,024-sample
   chunks, its probs equal to ``compute_probs`` within the JAX package's
   streaming tolerance (rtol 2e-5 / atol 2e-6); K1 held to its twin at 26
   cepstra from 40 mel bins over 512 / 320-sample frames; ``compute_probs``
   and ``decode_probs`` ms beside the LSTM's bytes bound, the stream's
   real-time factor; and the synthetic CTC profile's spelled texts decoding
   to themselves on the card, batch and streamed;
15. checks that no module of ``jax`` or ``rhasspy_speech_tpu`` was imported
   (the card's machine has JAX installed; the port must not reach it),
   every module the run loaded included (the pitch modules of 16 too);
16. Kaldi pitch features: a chain model in the layout of Kaldi's aishell
   s5 recipe at the flagship's widths (``testing/full_width.py:
   write_pitch_model_dir``: TDNN-F 768 x 9 over 40 MFCC + 3 pitch inputs,
   the i-vector over the MFCCs) on the flagship graph and the same 32
   utterances: the batch call counted (one K1, one K2 and one K5 launch),
   transcripts and pitch columns equal to the plain twins' path, K5
   bit-equal to its twin at [32, 296, 417] (and below at a push's [1, 196,
   417] and the tick's [32, 196, 417]), each timed beside its bound and the
   downsample + NCCF + interpolation; the card
   against CPU tensors on 2 utterances (MFCC columns at K1's tolerance, at
   most 2% of the frames taking another lag, the POV and delta columns of
   the others within 1e-3) and on the tone and sweep fixtures (lags
   equal); the call's stages with ``pitch`` on its own beside the
   pitch-free call's; 8 utterances streamed (at most one K5 launch a push;
   rows and transcripts against the same streams on CPU tensors; chunk ms
   and RTF); the scheduler's captured device route with the pitch lane as
   in 12 (at most one K1, K2, K4 and K5 launch a tick, replays bit-equal,
   at least 30 of 32 transcripts equal to the single stream's and the host
   route's, tick times), K5 bit-equal on the tick's probed windows, and one
   voiced stream at one push a tick whose feature-ring rows equal the
   featurizer's within the JAX package's bound (rtol 2e-2 / atol 5e-3).
   K5 is printed with the cluster size and lanes its chooser took and the
   split of rank 0's cycles (min-plus pass, merge, wait, traceback); then
   the sweep of ``examples/pitch_viterbi_sweep.py`` holds K5 bit-equal to
   its twin at every cluster size and lane count at the three shapes on
   tie-heavy costs and times each; the tick's p50 / p90, the stream's
   real-time factor, the batch pitch stage and K5 and K4 are printed
   beside their figures before the redesign (PERF.md);
17. the TDNN-LSTM chain model of Kaldi's swbd ``run_tdnn_lstm_1e.sh``
   (``testing/full_width.py:write_tdnn_lstm_model_dir``: three LSTMP layers
   of cell 1,024 with projections 256 + 256 and delay -3, TDNN layers of
   1,024, ~35 M parameters, random weights from a seed) on the flagship
   graph: the 32 utterances through ``transcribe_pcm_batch``, counted (one
   K1 and one K2 launch), transcripts equal to the plain twins' path, K1
   and K2 on the call's inputs against their twins; log-probs on the card
   against CPU tensors on 2 utterances (atol 1e-4: above the 2.2e-6 the
   H100 measured, below a bf16 forward's ~5.7e-3, which 18 holds outside
   it); one stream counted (one K1 a push, one K2 with ``alpha0`` a chunk) whose
   chunked log-probs equal the whole utterance's forward on a copy without
   the extractor (rtol / atol 2e-4); the scheduler at 32 slots on its
   device route, captured, as in 12 (its AM window stops short of the
   i-vector tap, so K1 runs a tick in the host featurizer and the captured
   body holds the recurrent AM, K2 and K4; replays bit-equal with the
   recurrence rows among the state), its chunk AM at each lane bucket
   against every slot as in 12; the AM stage by CUDA events and host
   clock, the batch call's stages, the stream's RTF and the tick's p50 /
   p90;
18. bf16 (``compute_dtype="bfloat16"``): the flagship's batch call counted
   (one K1, one K2) with log-probs within ``tests/test_bf16.py``'s bounds
   of f32 (|d| <= 5% of the f32 spread, argmax agreement >= 90%, flips only
   on near-ties), the TDNN-LSTM's batch forward within the same bounds and
   outside 17's card-vs-CPU bound, the AM forward in bf16 and f32 by CUDA
   events on both models, the captured
   tick in bf16 (K1, K2, K4 counted, replays bit-equal), and the synthetic
   speech profile's batch and scheduler transcripts in bf16 equal to f32's
   and the spoken sentences;
19. dither: a copy of the flagship model dir with ``--dither=1.0``: the
   batch call counted (K1 with the call's noise), two calls' features
   differ, a fresh transcriber's kernels and plain twins transcribe alike,
   K1 with noise against its twin with the same noise and timed beside the
   undithered launch; the stream's feature rows, the tick's feature rings
   and the synthetic Coqui profile's probs equal the undithered ones;
20. every nnet3 component type: ``testing/component_graph.py``'s graph (a
   branch a type, 37 types) on the card against CPU tensors (rtol / atol
   2e-4);
21. the serving wires: the flagship scheduler at 32 slots, captured, on
   ``wire="i16"``, ``"mulaw"`` and ``"adpcm"`` (replays bit-equal to the
   eager body, every kernel of the tick counted; the tick's p50 / p90 of
   each in this call); the ADPCM decode kernel (K6, a warp scan a block)
   bit-equal to its twin on the tick's probed wire bytes and on a
   saturating probe of that shape, and timed by device time; the synthetic
   speech profile's sentences scheduled on both wires equal to the batch
   transcripts of the wire's decoded audio (mu-law: all 8 the spoken
   sentence; ADPCM, a lossy 4-bit wire: at least 7);
22. an odd MFCC window: a copy of the flagship model dir with
   ``--round-to-power-of-two=false --frame-length=25.0625`` (N = 401): the
   batch call counted, transcripts equal to the plain twins' path, K1
   (Bluestein's algorithm) against its twin at [32, 48000] (K1's
   tolerance) and against float64 (as in 4.) and timed in one call beside
   its twin, the N = 512 launch
   and ``torch.fft.rfft`` of the frames; one stream and the scheduler
   launch K1 on it too;
23. the command line and warm start: ``cli.main(["transcribe", ...])`` on
   the 32 utterances written as WAVs; a cold process serves them once
   (batch, then the scheduler at 32 slots) and runs ``cli warmup``, which
   writes the manifest; a second process built from it must add no nvcc
   run, library, AM plan or tick capture on its first calls and return the
   cold process's transcripts; both processes' time to first transcript;
24. the stream mesh over the card (``make_stream_mesh()``):
   ``ShardedWavTranscriber`` equals the single transcriber, and the
   scheduler with ``mesh=`` equals the mesh-free scheduler of 21, each
   block's replays bit-equal to its eager body;
25. the port's example scripts (``rhasspy_speech_torch/examples/``) on the
   card, each through its ``main(argv)``, its results checked and its
   kernel launches counted (the wrappers' counts zeroed before each, or
   the scheduler's own count of captured launches times replays):
   ``serve_streams`` at 8 streams on the i16 and ADPCM wires (K1, K2, K4,
   and K6 on ADPCM; every stream's transcript the spoken sentence on i16,
   at least 7 of 8 on ADPCM); ``serve_multichip`` over a mesh of the one
   card (K1, K2; sharded transcripts equal the single device's);
   ``inspect_utterance`` (K1, K2; the spoken transcript, its n-best and
   lattice) and ``rescore_oov`` (K1: its n-best first pass and its lattice
   are plain PyTorch; the recovered transcript); ``frontier_curve`` at
   order 3 and two K (K2; the frontier never cheaper than the exact
   decode); ``tick_device_profile``
   at full width and 32 lanes on the 13,789-state grammar and the seeded
   30,000-state graph (K1, K2, K4 in each replay; device, upload and host
   split) and ``decode_roofline`` at B=32 (K1, K2; each stage's share of
   the roofline), their JSON lines printed before the last line.

``python3 chip_smoke.py --mesh`` runs only phase 24, over every card the
machine has (e.g. four), after the flagship build and a mesh-free scheduler
run on the first card.

Each kernel's entry in the ``kernels`` line carries ``bound_ms``, the least
time the card could take for the same work: the larger of its bytes (each
input read once, each output written once) at 3.35 TB/s and its f32
operations at 67 TFLOP/s, NVIDIA's H100 SXM peaks at 700 W (K6's integer
steps counted at that rate too). The Viterbi
kernel's log-probs count only where this run's decode reads them: the
32-byte sectors of the graph's pdfs in each stream's active frames; the
path walk's ring reads one 32-byte sector a frame walked.

Run from the repository root: ``python3 chip_smoke.py``. The last line is
``{"ok": true, "device": {...}}``; any failure raises and exits non-zero.
Without a CUDA device it exits 2 before printing any result.
"""

import asyncio
import contextlib
import ctypes
import dataclasses
import functools
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import wave
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: torch.cuda.is_available() is false; nothing run", file=sys.stderr)
    sys.exit(2)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from rhasspy_speech_torch import (  # noqa: E402
    LangSuffix,
    Nnet3StreamTranscriber,
    Nnet3WavTranscriber,
    ShardedWavTranscriber,
    cli,
)
from rhasspy_speech_torch.ops import adpcm as adpcm_codec, mulaw as mulaw_codec  # noqa: E402
from rhasspy_speech_torch.ops.adpcm import block_bytes, decode_blocks_torch  # noqa: E402
from rhasspy_speech_torch.ops.adpcm_cuda import adpcm_decode  # noqa: E402
from rhasspy_speech_torch.ops.frontend import frame_indices, make_frontend_params  # noqa: E402
from rhasspy_speech_torch.parallel import make_stream_mesh  # noqa: E402
from rhasspy_speech_torch.pipeline.artifacts import LangArtifacts, lang_dir_name  # noqa: E402
from rhasspy_speech_torch.pipeline.endpoint import EndpointConfig  # noqa: E402
from rhasspy_speech_torch.pipeline import scheduler as sched_mod  # noqa: E402
from rhasspy_speech_torch.pipeline.scheduler import StreamScheduler  # noqa: E402
from rhasspy_speech_torch.pipeline.train import train_model_sync  # noqa: E402
from rhasspy_speech_torch.testing import build_synthetic_profile, synthesize_sentence  # noqa: E402
from rhasspy_speech_torch.testing.synthetic import (  # noqa: E402
    _silence_wave,
    build_synthetic_ctc_profile,
    build_synthetic_gmm_profile,
    synthesize_ctc_text,
)
from rhasspy_speech_torch.testing.full_width import (  # noqa: E402
    TDNN_LSTM_CELL,
    TDNN_LSTM_DIM,
    TDNN_LSTM_PROJ,
    TRI1_GAUSS as GMM_GAUSS,
    write_deepspeech_model_dir,
    write_pitch_model_dir,
    write_tdnn_lstm_model_dir,
    write_tri1_model_dir,
)
from rhasspy_speech_torch.testing.component_graph import (  # noqa: E402
    INPUT_DIM as COMPONENT_INPUT_DIM,
    build_all_components_spec,
)
from rhasspy_speech_torch.models.nnet3 import SUPPORTED_COMPONENTS, compile_nnet3  # noqa: E402
from rhasspy_speech_torch.io.kaldi_io import KaldiReader  # noqa: E402
from rhasspy_speech_torch.io.transition_model import KaldiTransitionModel  # noqa: E402
from rhasspy_speech_torch.models import gmm as gmm_mod  # noqa: E402
from rhasspy_speech_torch.ops.deltas import add_deltas  # noqa: E402
from rhasspy_speech_torch.pipeline.coqui import CoquiSttTranscriber  # noqa: E402
from rhasspy_speech_torch.pipeline.transcribe import AcousticModel  # noqa: E402
from rhasspy_speech_torch.device import cached_index  # noqa: E402
from rhasspy_speech_torch.fst.core import SymbolTable  # noqa: E402
from rhasspy_speech_torch.ops import pitch as pitch_mod  # noqa: E402
from rhasspy_speech_torch.ops.pitch import (  # noqa: E402
    make_lags,
    pitch_batch,
    pitch_local,
    pitch_track,
)
from rhasspy_speech_torch.ops.pitch_viterbi_cuda import (  # noqa: E402
    LANE_CHUNKS,
    pitch_viterbi,
    pitch_viterbi_torch,
    select_plan as select_pitch_plan,
    transition_costs,
)
from rhasspy_speech_torch.examples import pitch_viterbi_sweep  # noqa: E402
from rhasspy_speech_torch.testing.big_grammar import (  # noqa: E402
    train_big_grammar,
    write_big_grammar_model_dir,
)
from rhasspy_speech_torch.testing.adpcm_wires import saturating_wire  # noqa: E402
from rhasspy_speech_torch.testing.decode_graphs import device_route_graph, random_decode_graph  # noqa: E402
from rhasspy_speech_torch.testing.flagship import (  # noqa: E402
    build_flagship_graph,
    write_flagship_model_dir,
)
from rhasspy_speech_torch.ops import _build  # noqa: E402
from rhasspy_speech_torch.ops import decoder as twin_decoder  # noqa: E402
from rhasspy_speech_torch.ops import frontier  # noqa: E402
from rhasspy_speech_torch.ops import windowed_relax_cuda as k3  # noqa: E402
from rhasspy_speech_torch.examples import (  # noqa: E402
    decode_roofline,
    frontier_curve,
    inspect_utterance,
    rescore_oov,
    serve_multichip,
    serve_streams,
    tick_device_profile,
    windowed_cost,
)
from rhasspy_speech_torch.ops.frontend import mfcc_batch_torch  # noqa: E402
from rhasspy_speech_torch.testing.feature_tolerance import (  # noqa: E402
    frames_of,
    mfcc_allowance,
    worst,
)
from rhasspy_speech_torch.ops.ivector import extract_ivectors  # noqa: E402
from rhasspy_speech_torch.ops.lattice import forward_backward  # noqa: E402
from rhasspy_speech_torch.ops.mfcc_cuda import mfcc_batch  # noqa: E402
from rhasspy_speech_torch.ops.tick_stamp_cuda import calibrate  # noqa: E402
from rhasspy_speech_torch.pipeline.device_tick import (  # noqa: E402
    STAMPS, STAMPS_TAKEN, am_buckets, am_rows, lane_list)
from rhasspy_speech_torch.utils.metrics import TICK_STAGES  # noqa: E402
from rhasspy_speech_torch.utils.timing import cuda_ms, device_ms, p50_p90  # noqa: E402
from rhasspy_speech_torch.utils.roofline import (  # noqa: E402
    HBM_BYTES_PER_S,
    bound,
    mfcc_work,
    pitch_work,
    viterbi_work,
    windowed_relax_work,
)
from rhasspy_speech_torch.ops.path_walk_cuda import path_walk, path_walk_torch, walk_start  # noqa: E402
from rhasspy_speech_torch.ops.viterbi_cuda import (  # noqa: E402
    CLUSTER_SIZES,
    LARGE_CLUSTER_SIZES,
    MAX_SLICE_STATES,
    alpha_fits,
    card_smem,
    large_smem_layout,
    launch,
    max_alpha_states,
    max_clusters,
    plan_global,
    plan_halo,
    plan_viterbi,
    select_plan,
    smem_layout,
    viterbi_decode,
    viterbi_decode_checkpointed as k2_checkpointed,
)
from rhasspy_speech_torch.pipeline import stream as stream_mod  # noqa: E402
from rhasspy_speech_torch.ops.windowed_relax_cuda import (  # noqa: E402
    prepare_steps,
    windowed_relax,
    windowed_relax_torch,
)

K3_ODD_BATCH = 13  # no cluster size above 1 divides it

SEED = 0
BATCH = 32
SECONDS = 3.0
HIDDEN, LAYERS, NUM_PDFS, IVEC_DIM, UBM_GAUSS = 768, 9, 3072, 100, 512
MFCC_RTOL, MFCC_ATOL = 2e-3, 3e-2
CPU_RTOL, CPU_ATOL = 1e-3, 1e-2
NBEST = 5
SILENCE_WEIGHT = 0.01
CONF_ATOL = 1e-2
LATTICE_BEAM = 4.0
FRONTIER_NBEST = 3
FRONTIER_MIN_FINISHED = 12  # of 32 utterances whose beam must reach a final state
FRONTIER_EXACT_BATCH = 4  # utterances a call in the exact (K = S) frontier run
STREAMS_MIN_EQUAL = 6  # of 8 streamed transcripts that must equal the batch's
HALO_STATES = 40000  # alpha's two buffers exceed an SM's shared memory: the halo body
# the generated grammar's slot lists trained past the replicated body's reach
# (37,072 states, 86,216 arcs: int32 backpointers, the scheduler's host route)
PAST_REACH_SIZES = dict(areas=980, devices=630, scenes=490)
DEVICE_ROUTE_STATES = 30000  # a seeded graph past the reach within the ring's 65,532 arcs
DEVICE_ROUTE_EXTRA_ARCS = 2000
LARGE_STREAMS = 8  # streams of the past-reach stream and scheduler checks
STREAMS = 8
STREAM_CHUNK = 1024  # samples a push
STREAM_NBEST = 3
CHUNK_FRAMES = 7
SCHED_STAGGER = 4  # stream i starts feeding at round i % 4
SCHED_MIN_EQUAL = 30  # of 32 scheduled transcripts that must equal the single stream's
SPEECH_LEXICON = {
    "turn": ["t", "er", "n"], "on": ["aa", "n"], "off": ["ao", "f"], "the": ["dh", "ah"],
    "light": ["l", "ay", "t"], "fan": ["f", "ae", "n"], "never": ["n", "eh", "v", "er"],
    "mind": ["m", "ay", "n", "d"],
}
SPEECH_GRAMMAR = ["turn (on|off) [the] (light|fan) [never mind]", "never mind"]
SPEECH_TEXTS = ["turn on the light", "never mind", "turn off the fan", "turn on fan",
                "turn off light never mind", "turn on the fan", "turn off the light", "never mind"]
COQUI_UTTS = 4
# DeepSpeech probs, card vs CPU: the MFCC kernel against its twin (max |d|
# ~2e-4 on cepstra of magnitude ~10-50), then cuBLAS against the CPU's f32
# sums over rows 494 to 4,096 wide and 149 LSTM steps, into a softmax
COQUI_CPU_ATOL = 1e-3
STREAM_RTOL, STREAM_ATOL = 2e-5, 2e-6  # tests/test_coqui.py's streaming tolerance
COQUI_CHARS = sorted(set("turnonofflightstop"))
COQUI_SENTENCES = ["turn (on|off) light", "stop"]
COQUI_TEXTS = ["turn on light", "stop", "turn off light"]
COQUI_PRUNE = 30.0  # synthetic char boundaries are harsher than speech (tests/test_coqui.py)
KERNELS = ("mfcc", "viterbi", "viterbi_large", "windowed_relax", "path_walk", "pitch_viterbi",
           "adpcm_decode", "tick_stamp")
# Pitch, card vs CPU tensors: the POV feature and the delta of frames whose
# lags agree within 1e-3 (tests/test_torch_pitch.py's tolerance against the
# JAX package; f32 sums in another order, the POV's 0.15 power amplifying
# NCCF differences near 1). On the seeded noise at most 2% of the frames
# (batch) or rows (stream) may take another lag, for near ties in a
# 300-frame min-plus recursion: the H100 took another lag on none of 592
# frames and 2,384 rows (PERF.md); the tone and sweep fixtures allow none
PITCH_ATOL = 1e-3
PITCH_LAG_SHARE = 0.02
# TDNN-LSTM log-probs, card vs CPU tensors, both f32: the H100 measured max
# |d| 2.2e-6 after 112 recurrent steps (PERF.md), and a bf16 forward in the
# f32 one's place differs by ~5.7e-3 (phase 18 holds it outside this bound),
# so the bound lies between the two
LSTM_CPU_RTOL, LSTM_CPU_ATOL = 0.0, 1e-4
# a stream's chunks against the whole utterance's forward, both on the card:
# the same steps at the same shapes, tests/test_torch_nnet3_recurrent.py's
# tolerance
LSTM_STREAM_TOL = 2e-4
BF16_SPREAD_SHARE, BF16_MIN_AGREE = 0.05, 0.9  # tests/test_bf16.py's bf16 bounds
# the all-types graph, card vs CPU: one or two small f32 products a branch,
# tests/test_torch_nnet3_components.py's tolerance
ALL_TYPES_TOL = 2e-4
# the chunk AM at a lane bucket against the AM over every slot, both on the
# card from one state: cuBLAS may take another algorithm at M = 8 or 16 than
# at M = 32, f32 sums in another order (~1e-6 of log-probs of magnitude
# ~10-40); alpha and the packed costs add one chunk of them to the same
# carried costs (tests/test_torch_scheduler.py's cost tolerance)
BUCKET_LP_ATOL = 1e-4
COST_RTOL, COST_ATOL = 1e-5, 1e-2
BUCKET_LANES = (1, 8, 9)
SUMMARY = {}  # this run's figures of the same names
PHASE_S = {}  # each phase's seconds in this run


@contextlib.contextmanager
def phase(name):
    """Record the seconds the block takes in PHASE_S[name]."""
    t0 = time.time()
    yield
    PHASE_S[name] = round(time.time() - t0, 1)


def check(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def tone_bursts(seed=SEED):
    """[1, S] PCM: two tones (300 and 1,200 Hz) rounded to int16 at gains
    over 4 decades, each followed by 0.15 s of silence at the synthetic
    profile's level. The tones' frames reach 10^10 above their weakest mel
    band, where an f32 FFT's rounding dominates the log-mel error."""
    rng = np.random.RandomState(seed)
    t = np.arange(3200) / 16000.0
    parts = []
    for gain in 10.0 ** np.linspace(-3.3, 0.7, 9):
        phase = 2 * np.pi * rng.rand(2)
        tones = 4000 * np.sin(2 * np.pi * 300 * t + phase[0]) + 1500 * np.sin(2 * np.pi * 1200 * t + phase[1])
        parts += [np.round(gain * tones), 20.0 * rng.randn(2400)]
    return np.concatenate(parts).astype(np.float32)[None]


def k1_against_float64(params, inputs):
    """K1 and its twin against float64 on each named [B, S] PCM batch of
    ``inputs``: each one's worst ratio to testing/feature_tolerance.py's
    allowance (rtol 1e-4 / atol 2e-3, widened where an f32 FFT's rounding,
    scaled by the frame's power over a weak mel band, exceeds atol), printed
    beside K1's largest |d|; K1 must lie within it. Returns {name: (K1's
    worst ratio, the twin's, K1's max |d|)}."""
    cfg = params.cfg
    out = {}
    for name, pcm in inputs.items():
        pcm = torch.as_tensor(pcm, device=params.device)
        allow = mfcc_allowance(cfg, frames_of(cfg, pcm))
        feats_k, feats_p = mfcc_batch(params, pcm), mfcc_batch_torch(params, pcm)
        (rk, at), (rp, _) = worst(feats_k, allow.reference, allow), worst(feats_p, allow.reference, allow)
        err = float(np.abs(feats_k.cpu().numpy() - allow.reference).max())
        print(f"K1 vs float64 at N = {cfg.padded_window_size}, {name} {list(pcm.shape)}: K1 max |d| "
              f"{err:.3e}, worst ratio to the allowance {rk:.4f} (at {at}, frame conditioning "
              f"{float(allow.conditioning[at[:-1]]):.2e}); its twin {rp:.4f}")
        check(rk <= 1.0, f"K1 vs float64 at N = {cfg.padded_window_size}, {name}: worst ratio "
              f"{rk:.4f} to the allowance")
        out[name] = (rk, rp, err)
    return out


def decode_outputs_equal(a, b):
    """All five decode outputs (trace, final, cost, alpha, bps) identical."""
    for x, y in zip(a, b):
        if x.dtype == torch.uint16:
            x, y = x.to(torch.int32), y.to(torch.int32)
        if not torch.equal(x, y):
            return False
    return True


def stage_ms(t, pcms, fuzzy):
    """The main path once more, stage by stage, each stage ended by a
    synchronize: where the batch's wall time goes."""
    out = {}
    last = time.perf_counter()

    def mark(name):
        nonlocal last
        torch.cuda.synchronize()
        now = time.perf_counter()
        out[name] = round((now - last) * 1000.0, 3)
        last = now

    pcm, feat_lengths, lengths, n_out = t._pad_batch(pcms)
    mark("pad_upload")
    feats = mfcc_batch(t.am.frontend_params, pcm)
    mark("mfcc")
    if t.am.pitch_config is not None:
        feats = t.am._append_pitch(feats, pcm)
        mark("pitch")
    extract_ivectors(feats[..., : t.am.frontend_config.num_ceps], t.am.ivector_params,
                     lengths=feat_lengths)
    mark("ivector_alone")
    log_probs = t.am.log_probs(feats, n_out, feat_lengths=feat_lengths)
    mark("ivector_and_am")
    trace, final_state, cost = t._decode_traces(log_probs, lengths)
    mark("decode_and_copy")
    words = twin_decoder.traces_to_words_batch(t.artifacts.graph, trace, final_state, cost)
    mark("word_assembly")
    t._texts([[] if w is None else [(w, c)] for w, c in words], None, require_fuzzy=False, **fuzzy)
    mark("fuzzy_tail")
    return out


def build_profile(root):
    """The flagship graph and a random full-width model. The model dir
    gets ``model/phones.txt`` from the graph's phone table, as a trained
    Kaldi model dir has it: silence weighting finds its silence pdfs
    there."""
    graph, g_fuzzy, lang = build_flagship_graph(order=3, with_fuzzy=True, num_pdfs=NUM_PDFS)
    max_phone = max(pid for (p, pid) in lang.phones if pid != 0 and not p.startswith("#"))
    model_dir = write_flagship_model_dir(
        os.path.join(root, "model"), num_pdfs=graph.num_pdfs, max_phone=max_phone,
        hidden_dim=HIDDEN, num_tdnnf_layers=LAYERS, ivector_dim=IVEC_DIM,
        ubm_gauss=UBM_GAUSS, seed=SEED + 7,
    )
    with open(os.path.join(model_dir, "model", "phones.txt"), "w", encoding="utf-8") as f:
        lang.phones.write_text(f)
    graph_dir = os.path.join(root, "graph")
    LangArtifacts(words=lang.words, g_fuzzy=g_fuzzy, graph=graph, phones=lang.phones).save(graph_dir)
    return model_dir, graph_dir, graph


def zero_counts():
    for fn in (mfcc_batch, viterbi_decode, windowed_relax, path_walk, pitch_viterbi, adpcm_decode):
        fn.launches = 0
    viterbi_decode.body_launches = dict.fromkeys(viterbi_decode.body_launches, 0)


def body_counts():
    """K2's launches by body since the last ``zero_counts``."""
    return dict(viterbi_decode.body_launches)


def read_counts():
    return {"mfcc": mfcc_batch.launches, "viterbi": viterbi_decode.launches,
            "windowed_relax": windowed_relax.launches, "path_walk": path_walk.launches,
            "pitch_viterbi": pitch_viterbi.launches, "adpcm_decode": adpcm_decode.launches}


def viterbi_phase(t, lp_k, lengths, dev):
    """K2 against its twin, bit for bit, on the flagship graph (the main
    path's log-probs) and on the 14,200-state graph (seeded log-probs), at
    B=32 and B=1; times the kernel as ``viterbi_decode`` runs it and at
    every cluster size that fits. Returns the main path shape's numbers."""
    big = twin_decoder.DecodeGraph.from_dense(random_decode_graph(np.random.RandomState(SEED + 1)), dev)
    lp_big = torch.as_tensor(
        np.random.RandomState(SEED + 2).randn(*lp_k.shape).astype(np.float32), device=dev)
    max_smem = _build.load("viterbi").rss_viterbi_max_smem(dev.index)
    out = {}
    for name, g, lp, scale in (("flagship", t.device_graph, lp_k, t.acoustic_scale),
                               ("14200", big, lp_big, 1.0)):
        compact = g.num_arcs <= twin_decoder._COMPACT_BP_MAX_ARC

        def twin(lp_b, lens):
            alpha, bps = twin_decoder.viterbi(g, lp_b, scale, lens, compact_bp=compact)
            return twin_decoder.backtrace(g, alpha, bps) + (alpha, bps)

        for B in (BATCH, 1):
            lp_b, lens = lp[:B].contiguous(), lengths[:B].contiguous()
            got = viterbi_decode(g, lp_b, scale, lens, return_forward=True)
            want = twin(lp_b, lens)
            torch.cuda.synchronize()
            check(decode_outputs_equal(got, want),
                  f"viterbi kernel differs from its twin ({name} graph, B={B})")
            plan, resident = select_plan(g, B)
            ms = cuda_ms(lambda: viterbi_decode(g, lp_b, scale, lens))
            plain_ms = cuda_ms(lambda: twin(lp_b, lens), iters=3)
            sweep = {}
            for c in CLUSTER_SIZES:
                p = plan_viterbi(g, c)
                if p.max_states > MAX_SLICE_STATES:
                    continue
                res = smem_layout(g.num_states, p, g.folded, True)[1] <= max_smem
                sweep[f"C={c}{'' if res else ' L2 tables'} x{max_clusters(g, p, res)}"] = round(
                    cuda_ms(lambda: launch(g, p, res, lp_b, scale, lens)), 4)
            nbytes, nops = viterbi_work(g, B, lp_b.shape[1], lp_b.shape[2], lens)
            bound_ms, bound_by = bound(nbytes, nops)
            print(f"K2 viterbi {tuple(lp_b.shape)} on {name} graph ({g.num_states} states, "
                  f"{g.num_arcs} arcs): bit-exact; cluster {plan.cluster} (tables "
                  f"{'in shared memory' if resident else 'in L2'}); kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); by cluster size "
                  f"(x clusters the card runs at once) {sweep}")
            out[(name, B)] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                              "bound_by": bound_by,
                              "max_abs_err": float((got[3] - want[3]).abs().max())}
    return out[("flagship", BATCH)]


def nbest_phase(t, tc, pcms, fuzzy):
    """n-best at full width; returns the plain k-best's time on the card."""
    zero_counts()
    t0 = time.time()
    texts = t.transcribe_pcm_batch(pcms, nbest=NBEST, **fuzzy)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = read_counts()
    print(f"n-best (k={NBEST}): {BATCH} x {SECONDS} s in {wall * 1000:.1f} ms; launches {counts}")
    check(counts["mfcc"] > 0, f"n-best path did not launch the MFCC kernel: {counts}")
    check(len(texts) == BATCH and all(len(x) == 1 for x in texts),
          f"expected one fuzzy transcript per utterance, got {texts[:3]}")

    pcm, feat_lengths, lengths, n_out = t._pad_batch(pcms)
    lp_plain = t.am.log_probs(mfcc_batch_torch(t.am.frontend_params, pcm), n_out,
                              feat_lengths=feat_lengths)
    plain = t._texts(t._decode_nbest(lp_plain, lengths, NBEST), None, require_fuzzy=False, **fuzzy)
    check(plain == texts, "n-best transcripts differ between kernels and plain twins")

    lp2, lens2 = lp_plain[:2].contiguous(), lengths[:2]
    dev_out = twin_decoder.viterbi_kbest_decode(t.device_graph, lp2, NBEST, t.acoustic_scale, lens2)
    cpu_out = twin_decoder.viterbi_kbest_decode(tc.device_graph, lp2.cpu(), NBEST,
                                                tc.acoustic_scale, lens2.cpu())
    check(all(torch.equal(d.cpu(), c) for d, c in zip(dev_out, cpu_out)),
          "k-best outputs differ between the card and the CPU")
    kbest_ms = cuda_ms(lambda: twin_decoder.viterbi_kbest_decode(
        t.device_graph, lp_plain, NBEST, t.acoustic_scale, lengths), iters=2)
    print(f"n-best transcripts equal the plain twins' path; k-best bit-equal to the CPU's on 2 "
          f"utterances; plain k-best decode {tuple(lp_plain.shape)} k={NBEST}: {kbest_ms:.4f} ms; "
          f"first: {texts[0]}")
    return kbest_ms


def silence_phase(model_dir, graph_dir, dev, pcms, fuzzy):
    """silence_weight at full width: the first pass on the Viterbi kernel,
    then the silence-weighted second pass."""
    t = Nnet3WavTranscriber(model_dir, graph_dir, device=dev, silence_weight=SILENCE_WEIGHT)
    sil_pdfs = t._get_silence_pdfs()
    check(len(sil_pdfs) > 0, "no silence pdfs found from model/phones.txt")
    t.transcribe_pcm_batch(pcms, **fuzzy)  # warm-up
    weights = []
    log_probs = t.am.log_probs

    def recording(*args, **kwargs):
        weights.append(kwargs.get("ivector_frame_weights"))
        return log_probs(*args, **kwargs)

    t.am.log_probs = recording
    zero_counts()
    t0 = time.time()
    texts = t.transcribe_pcm_batch(pcms, **fuzzy)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = read_counts()
    t.am.log_probs = log_probs
    check(len(weights) == 2 and weights[0] is None and weights[1] is not None,
          "the silence-weighted second pass did not run")
    check(counts["viterbi"] >= 2 and counts["mfcc"] > 0,
          f"silence weighting: first pass and decode should both launch the Viterbi kernel: {counts}")
    w = weights[1]
    sil_share = float((w == SILENCE_WEIGHT).float().mean())
    print(f"silence weighting ({len(sil_pdfs)} silence pdfs): {BATCH} x {SECONDS} s in "
          f"{wall * 1000:.1f} ms; launches {counts}; frames weighted {SILENCE_WEIGHT}: "
          f"{sil_share:.4f} of {tuple(w.shape)}")
    tc = Nnet3WavTranscriber(model_dir, graph_dir, device="cpu", silence_weight=SILENCE_WEIGHT)
    check(tc.transcribe_pcm_batch(pcms[:2], **fuzzy) == texts[:2],
          "silence-weighted transcripts differ between the card and the CPU")

    # weighted i-vector stats on the card against the CPU, with weights
    # that are not all 1 whatever the first pass found
    pcm, feat_lengths, _, _ = t._pad_batch(pcms[:2])
    feats = t.am.features(pcm)
    fw = torch.ones(feats.shape[:2], device=dev)
    fw[:, ::3] = SILENCE_WEIGHT
    ivec = extract_ivectors(feats, t.am.ivector_params, feat_lengths, frame_weights=fw)
    ivec_cpu = extract_ivectors(feats.cpu(), tc.am.ivector_params, feat_lengths.cpu(),
                                frame_weights=fw.cpu())
    plain = extract_ivectors(feats, t.am.ivector_params, feat_lengths)
    iv_err = float((ivec.cpu() - ivec_cpu).abs().max())
    check(torch.allclose(ivec.cpu(), ivec_cpu, rtol=CPU_RTOL, atol=CPU_ATOL),
          f"weighted i-vectors on the card vs the CPU: max |d| {iv_err}")
    check(not torch.allclose(ivec, plain, rtol=CPU_RTOL, atol=CPU_ATOL),
          "frame weights left the i-vectors unchanged")
    print(f"silence-weighted transcripts equal the CPU's on 2 utterances; weighted i-vectors "
          f"vs CPU max |d| {iv_err:.3e}")
    return wall


def lattice_phase(t, tc, pcms):
    """get_lattice_pcm and confidence_pcm on 2 utterances, card against
    CPU."""
    for i, pcm in enumerate(pcms[:2]):
        zero_counts()
        t0 = time.time()
        lat = t.get_lattice_pcm(pcm)
        conf = t.confidence_pcm(pcm)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = read_counts()
        check(counts["mfcc"] > 0, f"lattice path did not launch the MFCC kernel: {counts}")
        check(lat is not None and lat.num_arcs() > 0, "empty lattice")
        _words, best = lat.shortest_path_words(t.artifacts.graph)
        check(abs(best - lat.best_cost) <= 1e-3 * max(1.0, abs(best)),
              f"lattice best path {best} vs forward-backward best {lat.best_cost}")

        lp = t._utterance_log_probs(pcm)
        fb_dev = forward_backward(t.device_graph, lp, t.acoustic_scale)
        fb_cpu = forward_backward(tc.device_graph, lp.cpu(), tc.acoustic_scale)
        check(all(torch.equal(d.cpu(), c) for d, c in zip(fb_dev, fb_cpu)),
              "forward-backward differs between the card and the CPU")
        conf_cpu = tc.confidence_pcm(pcm)
        check(0.0 <= conf <= 1.0 and abs(conf - conf_cpu) <= CONF_ATOL,
              f"confidence {conf} on the card vs {conf_cpu} on the CPU")
        fb_ms = cuda_ms(lambda: forward_backward(t.device_graph, lp, t.acoustic_scale), iters=3)
        print(f"lattice utt {i}: {lat.num_nodes} nodes, {lat.num_arcs()} arcs; lattice + "
              f"confidence {wall * 1000:.1f} ms; forward-backward {tuple(lp.shape)} bit-equal to "
              f"the CPU's, {fb_ms:.4f} ms on the card; confidence {conf:.6f} (CPU {conf_cpu:.6f})")


def relax_outputs_equal(got, want):
    """alpha and the uint16 backpointers identical."""
    return torch.equal(got[0], want[0]) and torch.equal(got[1].to(torch.int32), want[1].to(torch.int32))


def windowed_relax_phase(dev):
    """K3 through its entry point at the example's shape, then against its
    plain version at every cluster size; returns (launches, max |d|, kernel
    ms, plain ms, (bound ms, bound by))."""
    zero_counts()
    out = windowed_cost.main([])
    torch.cuda.synchronize()
    launches = read_counts()["windowed_relax"]
    check(launches > 0, "windowed_cost.main did not launch the windowed_relax kernel")
    tables, steps = out["tables"], out["steps"]
    B, S = out["alpha"].shape
    T = out["bp"].shape[0]
    want = windowed_relax_torch(*tables, T, B, S)
    torch.cuda.synchronize()
    check(relax_outputs_equal((out["alpha"], out["bp"]), want),
          "windowed_relax differs from its plain version")
    err = float((out["alpha"] - want[0]).abs().max())
    plain_ms = cuda_ms(lambda: windowed_relax_torch(*tables, T, B, S), iters=2)
    chosen = k3.select_cluster(steps, B)
    check(chosen == out["cluster"], f"entry point reported cluster {out['cluster']}, not {chosen}")
    print(f"K3 windowed_relax B={B} T={T} S_pad={S} NSTEP={tables[0].shape[0]} "
          f"({steps.num_rounds} rounds): bit-equal on every stream; kernel {out['ms']:.4f} ms "
          f"({out['us_per_step']:.6f} us/step) in clusters of {chosen}, plain {plain_ms:.4f} ms")

    # every cluster size the card accepts: the example's shape, timed, and
    # a batch the cluster size does not divide, on tables with exact ties
    dbase, sbase, idx, w, arc = windowed_cost.make_step_tables(100, 1024, seed=3)
    odd = [torch.as_tensor(x, device=dev) for x in
           (dbase, sbase, idx, (np.round(w * 4) / 4).astype(np.float32), (arc % 300).astype(np.int32))]
    odd_a0 = torch.as_tensor(
        (np.round(np.random.RandomState(4).rand(K3_ODD_BATCH, 1024) * 8) / 8).astype(np.float32),
        device=dev)
    odd_steps = prepare_steps(*odd, 1024)
    odd_want = windowed_relax_torch(*odd, 5, K3_ODD_BATCH, 1024, alpha0=odd_a0)
    sizes = [c for c in k3.CLUSTER_SIZES if k3.max_clusters(steps, c) > 0]
    check(chosen in sizes, f"chosen cluster size {chosen} not among the accepted {sizes}")
    for c in sizes:
        before = windowed_relax.launches
        got = k3.launch(steps, T, B, None, c)
        got_odd = k3.launch(odd_steps, 5, K3_ODD_BATCH, odd_a0, c)
        torch.cuda.synchronize()
        check(windowed_relax.launches == before + 2, "windowed_relax launch count")
        check(relax_outputs_equal(got, want),
              f"windowed_relax differs from its plain version in clusters of {c}")
        check(relax_outputs_equal(got_odd, odd_want),
              f"windowed_relax differs from its plain version in clusters of {c}, B={K3_ODD_BATCH}")
        del got
        ms = cuda_ms(lambda: k3.launch(steps, T, B, None, c), iters=5)
        print(f"K3 windowed_relax C={c} x{k3.max_clusters(steps, c)} (clusters the card runs at "
              f"once): bit-equal at B={B} and at B={K3_ODD_BATCH}; {ms:.4f} ms"
              f"{' (chosen)' if c == chosen else ''}")
    del want

    # the same tables with idx[i, j] = j: every lane of a warp gathers from
    # its own shared-memory bank, where random idx collide about 3.5-fold
    idx_lane = torch.arange(k3.LANES, dtype=tables[2].dtype, device=dev).expand_as(tables[2]).contiguous()
    lane_steps = prepare_steps(tables[0], tables[1], idx_lane, tables[3], tables[4], S)
    random_ms = cuda_ms(lambda: k3.launch(steps, T, B, None, chosen), iters=5)
    lane_ms = cuda_ms(lambda: k3.launch(lane_steps, T, B, None, chosen), iters=5)
    print(f"K3 windowed_relax C={chosen}: {random_ms:.4f} ms with the example's random idx, "
          f"{lane_ms:.4f} ms with bank-conflict-free idx (idx[i, j] = j)")
    del lane_steps, idx_lane

    # tables and initial alphas that differ per stream, with exact ties
    Bs, s_pad, nstep = 8, 1024, 100
    per = [windowed_cost.make_step_tables(nstep, s_pad, seed=40 + i) for i in range(Bs)]
    dbase, sbase, idx, w, arc = (np.stack(x) for x in zip(*per))
    w = (np.round(w * 4) / 4).astype(np.float32)
    arc = (arc % 11).astype(np.int32)
    alpha0 = (np.round(np.random.RandomState(9).rand(Bs, s_pad) * 8) / 8).astype(np.float32)
    small = [torch.as_tensor(x, device=dev) for x in (dbase, sbase, idx, w, arc)]
    a0 = torch.as_tensor(alpha0, device=dev)
    before = windowed_relax.launches
    got = windowed_relax(prepare_steps(*small, s_pad), 4, Bs, alpha0=a0)
    check(windowed_relax.launches == before + 1, "windowed_relax launch count (per-stream tables)")
    ref = windowed_relax_torch(*small, 4, Bs, s_pad, alpha0=a0)
    check(relax_outputs_equal(got, ref),
          "windowed_relax differs from its plain version on per-stream tables")
    check(not torch.equal(got[1][:, 0], got[1][:, 1]), "per-stream case: streams should differ")
    print(f"K3 windowed_relax per-stream tables [{Bs}, {nstep}, 128], S_pad={s_pad}: bit-equal")
    k3_bound = bound(*windowed_relax_work(T, B, S, tables[0].shape[0]))
    print(f"K3 bound {k3_bound[0]:.4f} ms ({k3_bound[1]})")
    return launches, err, out["ms"], plain_ms, k3_bound


def hyps_text_and_cost(t, hyps):
    """[(transcript, cost)] of each utterance's best hypothesis (None
    where the decode found no complete path)."""
    return [None if not h else (t._ids_to_text(h[0][0]), h[0][1]) for h in hyps]


def big_graph_phase(root, dev, pcms):
    """The checkpointed and frontier decoders and the dense branch past the
    kernel's reach, on a generated grammar of deployment size."""
    t0 = time.time()
    model_dir = write_big_grammar_model_dir(
        os.path.join(root, "big_model"), num_pdfs=NUM_PDFS, hidden_dim=HIDDEN,
        num_tdnnf_layers=LAYERS, ivector_dim=IVEC_DIM, ubm_gauss=UBM_GAUSS, seed=SEED + 7)
    graph_dir = train_big_grammar(os.path.join(root, "big_train"), model_dir, seed=SEED)
    dense_t = Nnet3WavTranscriber(model_dir, graph_dir, device=dev)
    g = dense_t.artifacts.graph
    S, A = g.num_states, g.num_arcs
    print(f"generated grammar: {S} states, {A} arcs, {int(g.arc_pdf.max()) + 1} pdfs read of "
          f"{NUM_PDFS}, max out-degree {dense_t._graph_out_degree()}; model and graph built in "
          f"{time.time() - t0:.1f} s")
    check(S > 7000, f"the generated grammar compiled to {S} states, expected more than 7,000")
    check(select_plan(dense_t.device_graph, BATCH)[0].body == "replicated",
          "the generated graph should be within K2's replicated body's reach")

    log_probs, lengths = dense_t._acoustic_batch(pcms)
    N = log_probs.shape[1]

    def run(t, nbest):
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        texts = t.transcribe_pcm_batch(pcms, nbest=nbest)
        torch.cuda.synchronize()
        return texts, (time.time() - t0) * 1000.0, read_counts(), t.last_decode_plan

    # -- dense (K2), then checkpointed by a budget one dense stream exceeds --
    dense_texts, dense_ms, counts, plan = run(dense_t, 1)
    check(plan[0] == "dense" and counts["viterbi"] > 0, f"dense run: plan {plan}, launches {counts}")
    dense_best = hyps_text_and_cost(dense_t, dense_t._decode_batch(pcms, 1))
    check(all(h is not None for h in dense_best), "dense decode found no path for an utterance")
    ckpt_t = Nnet3WavTranscriber(model_dir, graph_dir, device=dev,
                                 decode_memory_budget=N * S * 2 - 1)
    ckpt_texts, ckpt_ms, counts, plan = run(ckpt_t, 1)
    check(plan[0] == "checkpointed", f"expected the checkpointed decoder, got {plan}")
    ckpt_launches = 2 * -(-N // 32) * -(-BATCH // plan[1])  # forward and back, a segment
    check(counts["viterbi"] == ckpt_launches,
          f"the checkpointed route made {counts['viterbi']} K2 launches, expected {ckpt_launches}")
    check(ckpt_texts == dense_texts, "checkpointed transcripts differ from the dense run's")
    ckpt_best = hyps_text_and_cost(ckpt_t, ckpt_t._decode_batch(pcms, 1))
    check(ckpt_best == dense_best, "checkpointed words or costs differ from the dense run's")
    print(f"checkpointed route (sub-batches of {plan[1]}, {counts['viterbi']} K2 launches): "
          f"{BATCH} x {SECONDS} s in {ckpt_ms:.1f} ms (dense route {dense_ms:.1f} ms); transcripts "
          f"and costs equal the dense run's; first: {ckpt_texts[0]}")

    # -- frontier (n-best) at the batch: a beam of K states a frame ---------
    k = FRONTIER_NBEST
    budget = N * S * k * 4 + A * k * 4 - 1  # one dense k-best stream exceeds it
    front_t = Nnet3WavTranscriber(model_dir, graph_dir, device=dev, decode_memory_budget=budget,
                                  max_active=10**6)
    front_texts, front_ms, counts, plan = run(front_t, k)
    check(plan[0] == "frontier", f"expected the frontier decoder, got {plan}")
    K = plan[1]
    check(len(front_texts) == BATCH, "frontier route: one n-best list per utterance")
    hyps = front_t._decode_frontier(log_probs, lengths, k, K)
    kw = dict(acoustic_scale=front_t.acoustic_scale, scratch_bytes=budget, beam=front_t.beam,
              min_active=front_t.min_active)
    tri = frontier.viterbi_topk_cached(front_t._frontier_graph, log_probs[:4], K,
                                       lengths=lengths[:4], **kw)
    tri_cpu = frontier.viterbi_topk_cached(
        frontier.FrontierGraph.from_dense(g, "cpu"), log_probs[:4].cpu(), K,
        lengths=lengths[:4].cpu(), **kw)
    check(all(torch.equal(a.cpu(), b) for a, b in zip(tri, tri_cpu)),
          "frontier decode (states, alphas, arcs) differs between the card and CPU tensors")
    found = [(h[0][1], d[1]) for h, d in zip(hyps, dense_best) if h]
    check(all(np.float32(c) >= np.float32(d) for c, d in found),
          "a frontier hypothesis is cheaper than the exact decode's")
    check(len(found) >= FRONTIER_MIN_FINISHED,
          f"only {len(found)} of {BATCH} frontier decodes (K={K}) reach a final state, expected "
          f"at least {FRONTIER_MIN_FINISHED}")
    regret = [c - d for c, d in found]
    print(f"frontier route (K={K} of {S} states, beam {front_t.beam}, n-best {k}): {BATCH} x "
          f"{SECONDS} s in {front_ms:.1f} ms; states, alphas and arcs bit-equal to CPU tensors on 4 "
          f"utterances; "
          f"{len(found)} of {BATCH} utterances end in a final state, {sum(r <= 0 for r in regret)} "
          f"at the exact cost, mean regret {float(np.mean(regret)) if regret else 0.0:.3f}")

    # with n-best >= 3 x the batch the same rule leaves every state (K = S):
    # the frontier route is then exact, held to the dense k-best's best
    # hypothesis (words, cost) and transcript, several utterances a call
    eb = FRONTIER_EXACT_BATCH
    ek = 3 * eb
    exact_t = Nnet3WavTranscriber(
        model_dir, graph_dir, device=dev, max_active=10**6, beam=float("inf"),
        decode_memory_budget=N * S * ek * 4 + A * ek * 4 - 1)
    want = dense_t._decode_batch(pcms[:eb], ek)
    check(dense_t.last_decode_plan[0] == "dense", f"dense k-best plan {dense_t.last_decode_plan}")
    got = exact_t._decode_batch(pcms[:eb], ek)
    check(exact_t.last_decode_plan == ("frontier", S),
          f"exact frontier plan {exact_t.last_decode_plan}, expected K = {S}")
    for i in range(eb):
        check(bool(got[i]) and got[i][0] == want[i][0],
              f"frontier (K = S) top hypothesis {got[i][:1]} differs from the dense k-best's "
              f"{want[i][:1]} (utterance {i})")
    exact_texts = exact_t.transcribe_pcm_batch(pcms[:eb], nbest=ek)
    dense_k_texts = dense_t.transcribe_pcm_batch(pcms[:eb], nbest=ek)
    check([x[0] for x in exact_texts] == [x[0] for x in dense_k_texts],
          "frontier (K = S) transcripts differ from the dense run's")
    check([x[0] for x in exact_texts] == [x[0] for x in dense_texts[:eb]],
          "frontier (K = S) transcripts differ from the dense 1-best run's")
    print(f"frontier route, {eb} utterances a call, n-best {ek} (K = S = {S}): top hypothesis, "
          f"its cost and the transcript equal the dense k-best's on all {eb}")

    # -- the decoders on seeded log-probs, against K2 and the dense decode --
    dg = dense_t.device_graph
    rng = np.random.RandomState(SEED + 3)
    lp = torch.as_tensor(rng.randn(BATCH, N, NUM_PDFS).astype(np.float32), device=dev)
    lens = torch.as_tensor(rng.randint(N // 2, N + 1, size=BATCH), dtype=torch.int32, device=dev)
    k2 = [x.cpu().numpy() for x in viterbi_decode(dg, lp, 1.0, lens)]
    zero_counts()
    ck = k2_checkpointed(dg, lp, 1.0, lengths=lens)
    ck_launches = read_counts()["viterbi"]
    check(ck_launches == 2 * -(-N // 32), f"the checkpointed route made {ck_launches} K2 launches")
    check(all(np.array_equal(a, b) for a, b in zip(ck, k2)),
          "the checkpointed route through K2 differs from the dense decode")
    ck_twin = twin_decoder.viterbi_decode_checkpointed(dg, lp, 1.0, lengths=lens)
    check(all(np.array_equal(a, b) for a, b in zip(ck_twin, k2)),
          "the twin's viterbi_decode_checkpointed differs from the Viterbi kernel")
    fg = frontier.FrontierGraph.from_dense(g, dev, base=dg)
    for name, scratch in (("dense dedup", 2 << 30), ("sort dedup", 0)):
        tri = [x.cpu().numpy() for x in frontier.viterbi_topk(
            fg, lp[:2], S, 1.0, lens[:2], scratch_bytes=scratch)]
        for b in range(2):
            want = twin_decoder.trace_to_words(g, *k2, b)
            got = frontier.topk_backtrace(g, *tri, b)
            check(got[0] == want[0] and np.float32(got[1]) == np.float32(want[1]),
                  f"viterbi_topk (K = S, {name}) differs from the dense decode on stream {b}")
    ms = {
        "K2": cuda_ms(lambda: viterbi_decode(dg, lp, 1.0, lens), iters=5),
        "plain scan": cuda_ms(lambda: twin_decoder.viterbi_decode(dg, lp, 1.0, lens), iters=2),
        "checkpointed (K2)": cuda_ms(lambda: k2_checkpointed(dg, lp, 1.0, lengths=lens), iters=2),
        "checkpointed (twin)": cuda_ms(
            lambda: twin_decoder.viterbi_decode_checkpointed(dg, lp, 1.0, lengths=lens), iters=2),
        f"frontier K={K} dense dedup": cuda_ms(lambda: frontier.viterbi_topk(
            fg, lp, K, 1.0, lens, beam=24.0, min_active=200), iters=2),
        f"frontier K={K} sort dedup": cuda_ms(lambda: frontier.viterbi_topk(
            fg, lp, K, 1.0, lens, scratch_bytes=0, beam=24.0, min_active=200), iters=2),
        f"frontier K=S={S} B=1 dense dedup": cuda_ms(lambda: frontier.viterbi_topk(
            fg, lp[:1], S, 1.0, lens[:1]), iters=1),
    }
    print(f"decoders on seeded log-probs {tuple(lp.shape)}, {S} states: checkpointed through K2 "
          f"({ck_launches} launches) and the twin's bit-equal to K2's dense decode; viterbi_topk (K = S) equal to the dense decode by both dedups; ms at B={BATCH} "
          f"(CUDA events): { {n: round(v, 3) for n, v in ms.items()} }")
    del lp, fg, dense_t, ckpt_t, front_t, exact_t
    return model_dir, graph_dir


def k2_numbers(name, g, lp, lens, scale=1.0, twin_iters=2):
    """K2 on graph ``g`` against its twin, bit for bit (all five outputs),
    timed by CUDA events beside the twin's per-frame scan in this call,
    with its bound and share. Returns the kernels-line numbers and the
    plan."""
    compact = g.num_arcs <= twin_decoder._COMPACT_BP_MAX_ARC

    def twin():
        alpha, bps = twin_decoder.viterbi(g, lp, scale, lens, compact_bp=compact)
        return twin_decoder.backtrace(g, alpha, bps) + (alpha, bps)

    got = viterbi_decode(g, lp, scale, lens, return_forward=True)
    want = twin()
    torch.cuda.synchronize()
    check(decode_outputs_equal(got, want), f"K2 differs from its twin ({name}, B={lp.shape[0]})")
    err = float((got[3] - want[3]).abs().max())
    del got, want
    plan, resident = select_plan(g, lp.shape[0])
    ms = cuda_ms(lambda: viterbi_decode(g, lp, scale, lens), iters=5)
    plain_ms = cuda_ms(twin, iters=twin_iters)
    bound_ms, bound_by = bound(*viterbi_work(g, *lp.shape, lens))
    print(f"K2 {plan.body} body {tuple(lp.shape)} on {name} ({g.num_states} states, {g.num_arcs} "
          f"arcs): bit-exact (traces, final states, costs, alpha, backpointers); cluster "
          f"{plan.cluster}, tables {'in shared memory' if resident else 'in L2'}; kernel {ms:.4f} ms, "
          f"plain scan {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), share "
          f"{bound_ms / ms:.4f}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err": err}, plan


class HeldToTwin:
    """``viterbi_decode`` as a module calls it, each call's alpha and
    backpointers held bit-equal to ``viterbi(alpha0=...)`` on the same
    inputs (the twin launches nothing)."""

    def __init__(self, module):
        self.module, self.real, self.held = module, module.viterbi_decode, []

    def __call__(self, graph, lp, scale, lengths, return_forward=False, alpha0=None):
        out = self.real(graph, lp, scale, lengths, return_forward=return_forward, alpha0=alpha0)
        want = twin_decoder.viterbi(graph, lp, scale, lengths, alpha0=alpha0,
                                    compact_bp=graph.num_arcs <= twin_decoder._COMPACT_BP_MAX_ARC)
        self.held.append(decode_outputs_equal(out[3:], want))
        return out

    def __enter__(self):
        self.module.viterbi_decode = self
        return self

    def __exit__(self, *exc):
        self.module.viterbi_decode = self.real


def large_graph_phase(root, dev, pcms, model_dir, graph_dir):
    """K2 past one SM's shared memory: the halo body at 40,000 states; a
    trained grammar past the replicated body's reach through the batch
    transcriber, the stream transcriber and the scheduler's host route; the
    captured device route at 30,000 states with K4; the global body at a
    seeded graph the halo body cannot hold. Returns the kernels-line entries
    of the halo and global bodies."""
    fuzzy = dict(max_fuzzy_cost=1.0e9)
    words = LangArtifacts.load(graph_dir).words
    rng = np.random.RandomState(SEED + 6)
    N = 112
    lp = torch.as_tensor(rng.randn(BATCH, N, NUM_PDFS).astype(np.float32), device=dev)
    lens = torch.as_tensor(rng.randint(N // 2, N + 1, size=BATCH), dtype=torch.int32, device=dev)

    # -- the halo body at 40,000 states, B = 32 and 1, T = 112 ---------------
    g40 = twin_decoder.DecodeGraph.from_dense(
        random_decode_graph(np.random.RandomState(SEED + 4), HALO_STATES, num_pdfs=NUM_PDFS), dev)
    smem = card_smem(dev, HALO_STATES)
    check(not alpha_fits(HALO_STATES, smem), f"{HALO_STATES} states should be past the replicated body")
    halo40 = {}
    for B in (BATCH, 1):
        halo40[B], plan = k2_numbers("a seeded 40,000-state graph", g40, lp[:B].contiguous(),
                                     lens[:B].contiguous(), twin_iters=3)
        check(plan.body == "halo", f"40,000 states at B={B}: the {plan.body} body, expected halo")
    sweep = {}
    for c in LARGE_CLUSTER_SIZES:
        p = plan_halo(g40, c)
        if not alpha_fits(p.max_local, smem):
            continue
        for res in (True, False):
            n = max_clusters(g40, p, res)
            if n and (not res or large_smem_layout(p, g40.folded, True)[1] <= smem):
                sweep[f"halo C={c}{'' if res else ' L2 tables'} x{n}"] = round(
                    cuda_ms(lambda: launch(g40, p, res, lp, 1.0, lens), iters=3), 4)
    for c in (8, 16):
        p = plan_global(g40, c)
        n = max_clusters(g40, p, False)
        if n:
            sweep[f"global C={c} x{n}"] = round(cuda_ms(lambda: launch(g40, p, False, lp, 1.0, lens),
                                                        iters=3), 4)
    print(f"K2 at 40,000 states [{BATCH}, {N}, {NUM_PDFS}] by body and cluster size (x clusters the "
          f"card runs at once; halo: local space of the largest CTA {plan_halo(g40, 8).max_local} "
          f"states at C = 8): {sweep}")
    c_max = 16 if max_clusters(g40, plan_halo(g40, 16), False) > 0 else 8
    del g40

    # -- a trained grammar past the reach: batch, stream, scheduler ----------
    t0 = time.time()
    past_dir = train_big_grammar(os.path.join(root, "past_train"), model_dir, seed=SEED,
                                 **PAST_REACH_SIZES)
    t = Nnet3WavTranscriber(model_dir, past_dir, device=dev)
    gp = t.artifacts.graph
    S, A = gp.num_states, gp.num_arcs
    print(f"generated grammar {PAST_REACH_SIZES}: {S} states, {A} arcs; trained in "
          f"{time.time() - t0:.1f} s")
    check(not alpha_fits(S, card_smem(dev, S)) and A > 65532,
          f"the past-reach grammar has {S} states, {A} arcs: expected past "
          f"{max_alpha_states(card_smem(dev, 1))} states and 65,532 arcs")
    t.transcribe_pcm_batch(pcms, **fuzzy)  # warm-up
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.time()
    texts = t.transcribe_pcm_batch(pcms, **fuzzy)
    torch.cuda.synchronize()
    batch_ms = (time.time() - t0) * 1000.0
    counts, bodies = read_counts(), body_counts()
    check(t.last_decode_plan == ("dense", BATCH), f"past-reach plan {t.last_decode_plan}")
    check(counts["viterbi"] == bodies["halo"] == 1 and counts["mfcc"] == 1,
          f"past-reach batch launches {counts}, by body {bodies}")
    halo_launches = bodies["halo"]
    log_probs, lengths = t._acoustic_batch(pcms)
    got = t._decode_traces(log_probs, lengths)
    want = [r.cpu().numpy() for r in twin_decoder.viterbi_decode(
        t.device_graph, log_probs, t.acoustic_scale, lengths)]
    check(all(np.array_equal(a, b) for a, b in zip(got, want)),
          "past-reach traces differ between K2 and the twin route")
    twin_words = twin_decoder.traces_to_words_batch(gp, *want)
    twin_texts = t._texts([[] if w is None else [(w, c)] for w, c in twin_words], None,
                          require_fuzzy=False, **fuzzy)
    check(twin_texts == texts, "past-reach transcripts differ from the twin route's")
    halo_main, plan = k2_numbers(f"the trained grammar", t.device_graph, log_probs, lengths,
                                 t.acoustic_scale)
    check(plan.body == "halo", f"the trained past-reach grammar took the {plan.body} body")
    print(f"past-reach batch: {BATCH} x {SECONDS} s in {batch_ms:.1f} ms, plan {t.last_decode_plan}, "
          f"launches {counts}, by body {bodies}; transcripts equal the twin route's; first: "
          f"{texts[0]}")

    st = Nnet3StreamTranscriber(model_dir, past_dir, device=dev)
    utts = pcms[:LARGE_STREAMS]
    with HeldToTwin(stream_mod) as held:
        stream_pcm(st, utts[0], **fuzzy)  # warm-up
        zero_counts()
        held.held.clear()
        streamed = [stream_pcm(st, p, **fuzzy) for p in utts]
        torch.cuda.synchronize()
        counts, bodies = read_counts(), body_counts()
    chunks = sum(len(state.bps) for _texts, state, _n in streamed)
    check(counts["viterbi"] == bodies["halo"] == chunks == len(held.held) and all(held.held),
          f"past-reach stream: {counts['viterbi']} K2 launches ({bodies}) for {chunks} chunks, "
          f"{sum(held.held)} of {len(held.held)} chunks bit-equal to viterbi(alpha0=...)")
    stream_texts = [x[0] for x in streamed]
    print(f"past-reach stream: {LARGE_STREAMS} utterances in {STREAM_CHUNK}-sample pushes, {chunks} "
          f"7-frame chunks, one halo-body launch each with alpha0, every chunk's alpha and "
          f"backpointers bit-equal to viterbi(alpha0=...); {stream_texts[:2]}")

    sched = StreamScheduler(model_dir, past_dir, max_streams=LARGE_STREAMS, device=dev, **fuzzy)
    check(not sched._device_bp, "past 65,532 arcs the scheduler should take the host route")
    with HeldToTwin(sched_mod) as held:
        sched_run(sched, utts)  # warm-up
        zero_counts()
        held.held.clear()
        sched_texts, ticks, wall = sched_run(sched, utts)
        torch.cuda.synchronize()
        counts, bodies = read_counts(), body_counts()
    chunk_ticks = sum(1 for tk in ticks if tk[1] > 0)
    check(counts["viterbi"] == bodies["halo"] == chunk_ticks == len(held.held) and all(held.held),
          f"past-reach scheduler: {counts['viterbi']} K2 launches ({bodies}) for {chunk_ticks} ticks "
          f"with a chunk, {sum(held.held)} of {len(held.held)} bit-equal to viterbi(alpha0=...)")
    same = sum(a == b for a, b in zip(sched_texts, stream_texts))
    check(same >= STREAMS_MIN_EQUAL, f"past-reach scheduler: only {same} of {LARGE_STREAMS} "
          f"transcripts equal the stream transcriber's: {sched_texts} vs {stream_texts}")
    print(f"past-reach scheduler, host route, {LARGE_STREAMS} slots: {chunk_ticks} ticks with a chunk, "
          f"one halo-body launch each, each bit-equal to viterbi(alpha0=...); {same} of "
          f"{LARGE_STREAMS} transcripts equal the stream transcriber's; fleet wall "
          f"{wall * 1000:.1f} ms; tick ms p50 / p90 {tick_ms(ticks)}")
    del t, st, sched

    # -- the captured device route past the reach, K4 beside it --------------
    dense30 = device_route_graph(SEED + 7, DEVICE_ROUTE_STATES, DEVICE_ROUTE_EXTRA_ARCS, NUM_PDFS)
    dir30 = os.path.join(root, "graph_device_route")
    LangArtifacts(words=words, graph=dense30).save(dir30)
    sched = StreamScheduler(model_dir, dir30, max_streams=BATCH, device=dev, **fuzzy)
    check(sched._device_bp and dense30.num_arcs <= 65532,
          f"{DEVICE_ROUTE_STATES} states, {dense30.num_arcs} arcs: not on the device route")
    check(select_plan(sched.device_graph, BATCH)[0].body == "halo", "the tick should take the halo body")
    sched_run(sched, pcms)  # warm-up: each tick body's first call, then its capture
    runner = sched._runner

    def on_tick():
        runner.check_next = True

    runner.check_next = True
    zero_counts()
    runner.launches = dict.fromkeys(runner.launches, 0)
    n_checks = len(runner.checks)
    _texts, ticks, wall = sched_run(sched, pcms, on_tick)
    runner.check_next = False
    torch.cuda.synchronize()
    counts = sched.kernel_launches
    checks = runner.checks[n_checks:]
    chunk_ticks = sum(1 for tk in ticks if tk[1] > 0)
    check(counts["viterbi"] == chunk_ticks and counts["path_walk"] > 0 and counts["mfcc"] > 0,
          f"{DEVICE_ROUTE_STATES}-state device route: launches {counts} for {chunk_ticks} ticks")
    check(len(checks) > 0 and all(all(eq.values()) for _k, eq in checks),
          f"{DEVICE_ROUTE_STATES}-state device route: a replay differs from the eager tick body")
    print(f"scheduler on a seeded {DEVICE_ROUTE_STATES}-state graph ({dense30.num_arcs} arcs), device "
          f"route, captured, {BATCH} slots: launches {counts} over {len(ticks)} ticks; {len(checks)} "
          f"replays bit-equal to the eager tick body; tick ms p50 / p90, each tick checked (an "
          f"eager run on copies of the state first), {tick_ms(ticks)}")
    k4_30 = path_walk_numbers(f"{DEVICE_ROUTE_STATES}", sched, dev)
    k4_30["launches"] = counts["path_walk"]
    del sched

    # -- the global body past the halo body's reach ------------------------
    S_glob = c_max * (max_alpha_states(card_smem(dev, HALO_STATES)) + 1)
    dense_g = random_decode_graph(np.random.RandomState(SEED + 8), S_glob, num_pdfs=NUM_PDFS)
    dir_g = os.path.join(root, "graph_global")
    LangArtifacts(words=words, graph=dense_g).save(dir_g)
    tg = Nnet3WavTranscriber(model_dir, dir_g, device=dev)
    check(select_plan(tg.device_graph, LARGE_STREAMS)[0].body == "global",
          f"{S_glob} states should take the global body")
    tg.transcribe_pcm_batch(utts)  # warm-up
    torch.cuda.synchronize()
    zero_counts()
    tg.transcribe_pcm_batch(utts)
    torch.cuda.synchronize()
    counts, bodies = read_counts(), body_counts()
    check(counts["viterbi"] == bodies["global"] > 0, f"global-body batch launches {counts}, {bodies}")
    global_launches = bodies["global"]
    glob, plan = k2_numbers(f"a seeded graph past the halo body ({c_max} x "
                            f"{max_alpha_states(card_smem(dev, HALO_STATES)) + 1} states)",
                            tg.device_graph, lp[:LARGE_STREAMS].contiguous(),
                            lens[:LARGE_STREAMS].contiguous(), twin_iters=1)
    check(plan.body == "global", f"the global-size graph took the {plan.body} body")
    print(f"global body: {LARGE_STREAMS} utterances through the transcriber on {S_glob} states: "
          f"launches {counts}, by body {bodies}, plan {tg.last_decode_plan}; K2 cluster "
          f"{plan.cluster}")
    del tg

    entry = {"route": "cuda", "replaces": "rhasspy_speech_tpu/ops/pallas_decoder.py:370",
             "library_ms": None}
    return [
        {"name": "viterbi_halo", "source": "rhasspy_speech_torch/csrc/viterbi_large.cu",
         "launches": halo_launches, **entry, **halo_main},
        {"name": "viterbi_halo_40000", "source": "rhasspy_speech_torch/csrc/viterbi_large.cu",
         "launches": halo_launches, **entry, **halo40[BATCH]},
        {"name": "viterbi_global", "source": "rhasspy_speech_torch/csrc/viterbi_large.cu",
         "launches": global_launches, **entry, **glob},
        {"name": "path_walk_30000", "source": "rhasspy_speech_torch/csrc/path_walk.cu",
         "replaces": "rhasspy_speech_tpu/pipeline/scheduler.py:838", "route": "cuda",
         "library_ms": None, **k4_30},
    ]


def carried_alpha_phase(t, lp_k, lengths, dev):
    """K2 with a carried alpha against ``viterbi(alpha0=...)``, bit for bit
    (alpha and backpointers), at T=7, B=1 and B=32 on the flagship graph and
    on the 14,200-state graph; the alpha is one a decode of 20 earlier
    frames left. Returns the numbers of the stream chunk's shape (flagship
    graph, B=1)."""
    big = twin_decoder.DecodeGraph.from_dense(
        random_decode_graph(np.random.RandomState(SEED + 1), num_pdfs=NUM_PDFS), dev)
    lp_big = torch.as_tensor(
        np.random.RandomState(SEED + 5).randn(BATCH, 27, NUM_PDFS).astype(np.float32), device=dev)
    out = {}
    for name, g, lp, scale in (("flagship", t.device_graph, lp_k, t.acoustic_scale),
                               ("14200", big, lp_big, 1.0)):
        compact = g.num_arcs <= twin_decoder._COMPACT_BP_MAX_ARC
        for B in (1, BATCH):
            alpha0 = viterbi_decode(g, lp[:B, :20].contiguous(), scale, return_forward=True)[3]
            chunk = lp[:B, 20 : 20 + CHUNK_FRAMES].contiguous()
            lens = torch.full((B,), CHUNK_FRAMES, dtype=torch.int32, device=dev)
            if B > 1:
                lens[1::3] = 2
                lens[2::5] = 0
            got = viterbi_decode(g, chunk, scale, lens, return_forward=True, alpha0=alpha0)
            want = twin_decoder.viterbi(g, chunk, scale, lens, compact_bp=compact, alpha0=alpha0)
            torch.cuda.synchronize()
            check(decode_outputs_equal(got[3:], want),
                  f"K2 with a carried alpha differs from viterbi(alpha0=...) ({name} graph, B={B})")
            check(not torch.equal(got[3], alpha0), "the chunk should move alpha")
            def call():
                return viterbi_decode(g, chunk, scale, lens, return_forward=True, alpha0=alpha0)

            ms, call_ms = device_ms(call), cuda_ms(call, iters=20)
            plain_ms = cuda_ms(lambda: twin_decoder.viterbi(
                g, chunk, scale, lens, compact_bp=compact, alpha0=alpha0), iters=3)
            nbytes, nops = viterbi_work(g, B, CHUNK_FRAMES, chunk.shape[2], lens)
            bound_ms, bound_by = bound(nbytes + 4 * B * g.num_states, nops)  # + the alpha read
            plan, _ = select_plan(g, B)
            print(f"K2 carried alpha {tuple(chunk.shape)} on {name} graph ({g.num_states} states): "
                  f"bit-exact (alpha, bps); cluster {plan.cluster}; kernel {ms:.4f} ms of device "
                  f"time (queued behind other work; {call_ms:.4f} ms a call launched back to back, "
                  f"the host's rate), plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by})")
            out[(name, B)] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                              "bound_by": bound_by,
                              "max_abs_err": float((got[3] - want[0]).abs().max())}
    return out[("flagship", 1)]


def timed_stage(fn, seconds, name):
    """``fn`` wrapped to add its host-clock seconds, ended by a device
    synchronize, to ``seconds[name]``."""
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        seconds[name] = seconds.get(name, 0.0) + (time.perf_counter() - t0)
        return out

    return wrapper


def stream_pcm(st, pcm, **kwargs):
    """One utterance through start_stream / process_chunk / finish_stream;
    returns (texts, state, pushes)."""
    state = st.start_stream()
    pushes = 0
    for off in range(0, pcm.shape[0], STREAM_CHUNK):
        st.process_chunk(state, pcm[off : off + STREAM_CHUNK])
        pushes += 1
    return st.finish_stream(state, **kwargs), state, pushes


async def _audio(pcm):
    data = np.clip(pcm, -32768, 32767).astype(np.int16)
    for off in range(0, data.shape[0], STREAM_CHUNK):
        yield data[off : off + STREAM_CHUNK].tobytes()


def stream_phase(root, model_dir, graph_dir, t, dev, pcms, fuzzy):
    """Single-stream streaming at full width; returns the launch counts of
    one streamed utterance and the push shape's K1 numbers."""
    utts = pcms[:STREAMS]
    st = Nnet3StreamTranscriber(model_dir, graph_dir, device=dev)
    stream_pcm(st, utts[0], **fuzzy)  # warm-up: the chunk plan's first calls

    # -- one utterance, counted: one K1 launch a push, one K2 launch a chunk --
    zero_counts()
    texts0, state, pushes = stream_pcm(st, utts[0], **fuzzy)
    torch.cuda.synchronize()
    counts = read_counts()
    chunks = -(-state.feats.shape[0] // st._chunk_in)
    check(counts["mfcc"] == pushes and counts["viterbi"] == chunks == len(state.bps),
          f"stream launches {counts}: expected {pushes} MFCC (one a push) and {chunks} Viterbi "
          f"(one a chunk)")
    batch_rows = t.am.features(torch.as_tensor(utts[0][None], device=dev))[0]
    check(torch.equal(torch.as_tensor(state.feats, device=dev), batch_rows),
          "streamed feature rows differ from the batch rows")
    print(f"stream: {SECONDS} s in {STREAM_CHUNK}-sample pushes: launches {counts} for {pushes} "
          f"pushes and {chunks} chunks; {state.feats.shape[0]} streamed feature rows bit-equal to "
          f"the batch rows; {texts0}")

    # -- 8 utterances: plain, silence_weight, nbest, async --------------------
    st_sil = Nnet3StreamTranscriber(model_dir, graph_dir, device=dev, silence_weight=SILENCE_WEIGHT)
    st_nbest = Nnet3StreamTranscriber(model_dir, graph_dir, device=dev, nbest=STREAM_NBEST)
    streamed = []
    for i, pcm in enumerate(utts):
        if i == 1:
            streamed.append(stream_pcm(st_sil, pcm, **fuzzy)[0])
        elif i == 2:
            streamed.append(stream_pcm(st_nbest, pcm, **fuzzy)[0])
        elif i in (3, 4):
            streamed.append(asyncio.run(st.async_transcribe(_audio(pcm), **fuzzy)))
        else:
            streamed.append(st.transcribe_pcm(pcm, chunk_samples=STREAM_CHUNK, **fuzzy))
    check(all(len(x) == 1 for x in streamed), f"expected one transcript a stream, got {streamed}")
    check(streamed[0] == texts0, "the same stream transcribed twice differs")
    batch_texts = t.transcribe_pcm_batch(utts, **fuzzy)
    same = sum(a == b for a, b in zip(streamed, batch_texts))
    check(same >= STREAMS_MIN_EQUAL,
          f"only {same} of {STREAMS} streamed transcripts equal the batch's, expected at least "
          f"{STREAMS_MIN_EQUAL}: {streamed} vs {batch_texts}")
    stc = Nnet3StreamTranscriber(model_dir, graph_dir, device="cpu")
    for i in (0, 5):
        check(stc.transcribe_pcm(utts[i], chunk_samples=STREAM_CHUNK, **fuzzy) == streamed[i],
              f"stream {i} transcribed differently on CPU tensors")
    print(f"streams: {STREAMS} x {SECONDS} s (1 with silence_weight={SILENCE_WEIGHT}, 1 with "
          f"nbest={STREAM_NBEST}, 2 through async_transcribe): one transcript each; 2 equal to "
          f"the same streams on CPU tensors; {same} of {STREAMS} equal to the batch transcripts "
          f"(online against whole-utterance i-vectors)")

    # without the extractor both paths read a zero i-vector: the stream must
    # equal the batch
    bare = os.path.join(root, "model_no_extractor")
    os.makedirs(bare)
    os.symlink(os.path.join(model_dir, "model"), os.path.join(bare, "model"))
    shutil.copy(os.path.join(model_dir, "config.json"), bare)
    st_bare = Nnet3StreamTranscriber(bare, graph_dir, device=dev)
    t_bare = Nnet3WavTranscriber(bare, graph_dir, device=dev)
    check(st_bare.am.ivector_params is None, "the bare model dir should carry no extractor")
    want = t_bare.transcribe_pcm_batch(utts, **fuzzy)
    got = [st_bare.transcribe_pcm(p, chunk_samples=STREAM_CHUNK, **fuzzy) for p in utts]
    check(got == want, f"streamed transcripts differ from the batch transcripts: {got} vs {want}")
    print(f"streams without the extractor: {STREAMS} streamed transcripts equal "
          f"transcribe_pcm_batch's; first: {got[0]}")
    del st_bare, t_bare, st_sil, st_nbest, stc

    # -- what a chunk costs, stage by stage; the stream's real-time factor ----
    stage_s = {}
    stage_names = ("_upload", "_fold_ivector", "_acoustic", "_decode_chunk", "_download")
    for name in stage_names:
        setattr(st, name, timed_stage(getattr(st, name), stage_s, name.lstrip("_")))
    _texts, state, pushes = stream_pcm(st, utts[5], **fuzzy)
    for name in stage_names:
        delattr(st, name)  # back to the class's methods
    check(_texts == streamed[5], "the stream timed stage by stage transcribed differently")
    stages = {k: round(v * 1000.0 / len(state.bps), 4) for k, v in stage_s.items()}
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st.transcribe_pcm(utts[5], chunk_samples=STREAM_CHUNK, **fuzzy)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fs = st._featurizer.new_state()
    for off in range(0, utts[5].shape[0], STREAM_CHUNK):
        st._featurizer.push(fs, utts[5][off : off + STREAM_CHUNK])
    push_ms = (time.perf_counter() - t0) * 1000.0 / pushes
    print(f"stream chunk ({CHUNK_FRAMES} output frames, 210 ms of audio; ms a chunk, host clock, "
          f"each stage synchronized): {stages}; a push (upload, K1, download): {push_ms:.4f} ms; "
          f"one {SECONDS} s stream without the synchronizes: {min(walls) * 1000:.1f} ms "
          f"(min of 3; real-time factor {min(walls) / SECONDS:.5f})")

    # -- K1 at a push's shape against its plain version ------------------------
    n = STREAM_CHUNK + 240  # a push plus a carried tail
    push = torch.as_tensor(utts[0][None, :n], device=dev)
    params = st._featurizer.stream_params
    got, want = mfcc_batch(params, push), mfcc_batch_torch(params, push)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(torch.allclose(got, want, rtol=MFCC_RTOL, atol=MFCC_ATOL),
          f"mfcc kernel vs twin at a push's shape: max |d| {err}")
    check(torch.equal(got[0], batch_rows[: got.shape[1]]),
          "a frame's MFCC depends on how many frames the call holds")
    call_ms = cuda_ms(lambda: mfcc_batch(params, push), iters=20)
    k1 = {"ms": device_ms(lambda: mfcc_batch(params, push)),
          "plain_ms": cuda_ms(lambda: mfcc_batch_torch(params, push)), "max_abs_err": err}
    k1["bound_ms"], k1["bound_by"] = bound(*mfcc_work(params, 1, n, got.shape[1]))
    print(f"K1 mfcc at a push's shape [1, {n}] -> {tuple(got.shape)}: max |d| {err:.3e}, rows "
          f"bit-equal to the batch call's; kernel {k1['ms']:.4f} ms of device time ({call_ms:.4f} "
          f"ms a call launched back to back), plain {k1['plain_ms']:.4f} ms, "
          f"bound {k1['bound_ms']:.6f} ms ({k1['bound_by']})")
    return counts, k1


def sched_run(sched, pcms, on_tick=None):
    """The phase's traffic through ``sched``: stream i fed from round i %
    SCHED_STAGGER in STREAM_CHUNK pushes and finished after its last, a
    tick after each round, then ticks until every transcript is in.
    Returns (transcripts, [(tick ms, slots decoded, {kernel: launches by
    the scheduler's own count}, uploads, downloads)], wall seconds)."""
    sids = [sched.open_stream() for _ in pcms]
    check(all(sid >= 0 for sid in sids), "the scheduler refused a stream")
    ticks = []
    # a mesh scheduler keeps a runner a block: its uploads are not counted
    runner = getattr(sched, "_runner", None) if sched._device_bp else None

    def tick():
        k0 = sched.kernel_launches
        io0 = (runner.uploads, runner.downloads) if runner else (0, 0)
        t0 = time.perf_counter()
        lanes = sched.step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1000.0
        k1 = sched.kernel_launches
        io1 = (runner.uploads, runner.downloads) if runner else (0, 0)
        launched = {k: k1[k] - k0[k] for k in k1}
        if runner:
            taken = sum(len(STAMPS_TAKEN[r.key]) for r in sched._step_ticks)
            check(launched["tick_stamp"] == taken, f"a tick made {launched['tick_stamp']} stamp "
                  f"launches for {taken} stamps taken by its bodies")
        ticks.append((ms, lanes, launched, io1[0] - io0[0], io1[1] - io0[1]))
        if on_tick is not None:
            on_tick()

    t0 = time.perf_counter()
    pushes = [-(-p.shape[0] // STREAM_CHUNK) for p in pcms]
    for r in range(max(n + i % SCHED_STAGGER for i, n in enumerate(pushes))):
        for i, (sid, pcm) in enumerate(zip(sids, pcms)):
            k = r - i % SCHED_STAGGER
            if 0 <= k < pushes[i]:
                sched.feed(sid, pcm[k * STREAM_CHUNK : (k + 1) * STREAM_CHUNK])
                if k == pushes[i] - 1:
                    sched.finish(sid)
        tick()
    for _ in range(200):
        if all(sched.poll(sid) is not None for sid in sids):
            break
        tick()
    wall = time.perf_counter() - t0
    texts = [sched.poll(sid) for sid in sids]
    check(all(x is not None for x in texts), "a scheduled stream never finished")
    for sid in sids:
        sched.close(sid)
    return texts, ticks, wall


def host_route_scheduler(*args, **kwargs):
    """A StreamScheduler forced onto the host route (the compact-backpointer
    limit set below any graph), as the CPU tests force it."""
    saved = sched_mod._BP_RING_MAX_ARC
    sched_mod._BP_RING_MAX_ARC = -1
    try:
        sched = StreamScheduler(*args, **kwargs)
    finally:
        sched_mod._BP_RING_MAX_ARC = saved
    check(not sched._device_bp, "the forced scheduler is not on the host route")
    return sched


def tick_ms(ticks):
    return p50_p90([t[0] for t in ticks if t[1] > 0])


def path_walk_numbers(name, sched, dev):
    """K4 on the scheduler's ring as the run left it (every slot's frames
    decoded so far, walked from its alpha) against its plain twin bit for
    bit, timed, with its bound: one 32-byte ring sector read a step, the
    packed rows written."""
    st, tk = sched._st, sched._tick
    start, costs = walk_start(st.alpha, sched.device_graph.final_weight)
    args = (st.ring, st.offs, start, costs, tk.walk_tables, sched._ring_frames,
            sched._ep_device)
    got = path_walk(*args)
    want = path_walk_torch(*args)
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"{name}: path walk kernel differs from its twin")
    steps = int(st.offs.sum())
    out = {"ms": device_ms(lambda: path_walk(*args)), "plain_ms": cuda_ms(lambda: path_walk_torch(*args), iters=3),
           "max_abs_err": float((got.to(torch.int32) - want.to(torch.int32)).abs().max())}
    out["bound_ms"], out["bound_by"] = bound(32 * steps + got.numel() * 2, 6 * steps)
    print(f"K4 path_walk on {name} ({sched.device_graph.num_states} states), ring "
          f"{list(st.ring.shape)}, {steps} frames walked over {st.offs.shape[0]} slots, arc table "
          f"{tk.walk_tables.smem_bytes} B staged: bit-equal to its twin; kernel {out['ms']:.4f} ms "
          f"of device time, plain "
          f"{out['plain_ms']:.4f} ms, bound {out['bound_ms']:.6f} ms ({out['bound_by']})")
    return out


def sched_graph_part(name, model_dir, graph_dir, dev, pcms, fuzzy, min_equal=SCHED_MIN_EQUAL,
                     host_feats=False):
    """The scheduler at 32 slots on one graph, on the device route and
    captured: counted run with every replay held bit-equal to the eager
    body, the kernels' inputs at the tick's shapes probed; transcripts
    against the single stream and the host route (at least ``min_equal``
    of 32 equal); tick times captured and eager; stage times. With
    ``host_feats`` the route keeps the features on the host (the AM window
    does not cover the i-vector tap): K1 runs a tick in the host featurizer,
    counted by its wrapper, and the captured body takes the host's windows
    (up to four uploads a tick).
    Returns (launch counts, probes, scheduler)."""
    sched = StreamScheduler(model_dir, graph_dir, max_streams=BATCH, device=dev, **fuzzy)
    g = sched.device_graph
    check(sched._device_bp and sched._device_feats != host_feats,
          f"{name}: not on the device route {'with host' if host_feats else 'with device'} features")
    sched_run(sched, pcms)  # warm-up: each tick body's first call, then its capture
    runner = sched._runner

    # -- counted: at most one K1, K2 and K4 launch, one upload and one
    # download a tick; every replay bit-equal to the eager body -------------
    probes = {}

    def on_tick():
        p = sched._tick.probe
        if p and "viterbi" in p:
            lens = p["viterbi"][1]
            kind = ("partial" if bool(((lens > 0) & (lens < sched._chunk_out)).any())
                    else "idle" if bool((lens == 0).any()) else None)
            if kind is not None and kind not in probes:
                probes[kind] = p["viterbi"]
            probes.setdefault("pcm", p.get("mfcc"))
            if p.get("pitch") is not None:
                probes.setdefault("pitch", p["pitch"])
        sched._tick.probe = {}
        runner.check_next = True

    sched._tick.probe = {}
    runner.check_next = True
    # the scheduler's counts (and the wrappers') to 0 just before the
    # counted run, read just after
    zero_counts()
    runner.launches = dict.fromkeys(runner.launches, 0)
    n_checks = len(runner.checks)
    texts, ticks, _wall = sched_run(sched, pcms, on_tick)
    sched._tick.probe, runner.check_next = None, False
    torch.cuda.synchronize()
    counts = sched.kernel_launches
    if host_feats:
        counts["mfcc"] = read_counts()["mfcc"]  # the host featurizer's, outside the graphs
    checks = runner.checks[n_checks:]
    check(all(max(v for k, v in t[2].items() if k != "tick_stamp") <= 1 for t in ticks),
          f"{name}: a tick launched more than one MFCC, Viterbi, path-walk or pitch-Viterbi kernel")
    max_up = 4 if host_feats else 1
    check(all(t[3] <= max_up and t[4] <= 1 for t in ticks),
          f"{name}: a tick made more than {max_up} uploads or one download")
    check(all(v > 0 for v in counts.values()), f"{name}: kernels not launched: {counts}")
    chunk_ticks = sum(1 for t in ticks if t[1] > 0)
    check(counts["viterbi"] == chunk_ticks, f"{name}: {counts['viterbi']} Viterbi launches for {chunk_ticks} "
          "ticks with a chunk")
    check(len(checks) > 0 and all(all(eq.values()) for _k, eq in checks),
          f"{name}: a replay differs from the eager tick body: {[c for c in checks if not all(c[1].values())][:2]}")
    check(len(texts) == BATCH and all(len(x) == 1 for x in texts), f"{name}: transcripts {texts[:3]}")
    print(f"scheduler {name}: {len(checks)} replays of {len(runner.graphs)} captured tick graphs "
          f"each bit-equal to the tick body run eagerly on copies of its inputs "
          f"(every state tensor: {', '.join(checks[0][1])})")

    # -- K2 at the tick's shapes against the plain decoder, bit for bit ------
    check("idle" in probes and "partial" in probes, f"{name}: no tick with idle slots or partial chunks")
    compact = g.num_arcs <= twin_decoder._COMPACT_BP_MAX_ARC
    for kind in ("idle", "partial"):
        lp, lens, alpha0 = probes[kind]
        want = twin_decoder.viterbi(g, lp, sched.acoustic_scale, lens, compact_bp=compact, alpha0=alpha0)
        full = viterbi_decode(g, lp, sched.acoustic_scale, lens, return_forward=True, alpha0=alpha0)
        torch.cuda.synchronize()
        check(decode_outputs_equal(full[3:], want), f"{name}: K2 at the tick's shape differs ({kind})")
        what = "an idle slot" if kind == "idle" else "a partial chunk"
        print(f"scheduler {name}: K2 on the first tick with {what} (lengths {lens.tolist()}): alpha "
              f"and backpointers bit-equal to the plain decoder's")

    # -- transcripts against the single stream and the host route -------------
    st = Nnet3StreamTranscriber(model_dir, graph_dir, device=dev)
    single = [st.transcribe_pcm(p, chunk_samples=STREAM_CHUNK, **fuzzy) for p in pcms]
    same = sum(a == b for a, b in zip(texts, single))
    check(same >= min_equal, f"{name}: only {same} of {BATCH} scheduled transcripts equal the "
          f"single stream's: {texts} vs {single}")
    host = host_route_scheduler(model_dir, graph_dir, max_streams=BATCH, device=dev, **fuzzy)
    host_texts, host_ticks, host_wall = sched_run(host, pcms)
    same_host = sum(a == b for a, b in zip(texts, host_texts))
    check(same_host >= min_equal, f"{name}: only {same_host} of {BATCH} device-route transcripts "
          f"equal the host route's: {texts} vs {host_texts}")
    del host

    # -- tick times captured and eager, bytes down, fleet RTF; stages --------
    d0, b0 = runner.downloads, runner.download_bytes
    _texts, ticks, wall = sched_run(sched, pcms)
    down = (runner.download_bytes - b0) / max(runner.downloads - d0, 1)
    runner.capture = False
    _texts, eager_ticks, eager_wall = sched_run(sched, pcms)
    runner.capture = True
    (c50, c90), (e50, e90), (h50, h90) = tick_ms(ticks), tick_ms(eager_ticks), tick_ms(host_ticks)
    idle_ms = np.asarray([t[0] for t in ticks if t[1] == 0])
    work = [t for t in ticks if t[1] > 0]
    stage_s, calls = {}, {}
    names = ("_drain_features_all", "_prep_features_device", "_apply_endpoint_stats", "_step_fused",
             "_step_chunk", "_feed_only_dispatch", "_finalize_device", "_harvest_finalizes")
    for n in names:
        fn = timed_stage(getattr(sched, n), stage_s, n.lstrip("_"))

        def counted(*args, _fn=fn, _n=n.lstrip("_"), **kwargs):
            calls[_n] = calls.get(_n, 0) + 1
            return _fn(*args, **kwargs)

        setattr(sched, n, counted)
    sched_run(sched, pcms)
    for n in names:
        delattr(sched, n)
    stages = {k: f"{v * 1000.0 / calls[k]:.4f} x{calls[k]}" for k, v in stage_s.items()}
    print(f"scheduler {name} ({g.num_states} states), {BATCH} slots, {BATCH} x {SECONDS} s fed in "
          f"{STREAM_CHUNK}-sample pushes, device route: launches {counts} over {len(ticks)} ticks "
          f"({len(work)} with a chunk); {same} of {BATCH} transcripts equal the single stream's, "
          f"{same_host} the host route's; tick ms (host clock) captured p50 {c50:.3f} p90 {c90:.3f}, "
          f"eager p50 {e50:.3f} p90 {e90:.3f}, host route p50 {h50:.3f} p90 {h90:.3f} (captured ticks "
          f"without a chunk: p50 {np.percentile(idle_ms, 50):.3f}); bytes down a tick with a download "
          f"{down:.0f}; tick graphs captured {len(runner.graphs)}; slots a tick with a chunk: mean "
          f"{np.mean([t[1] for t in work]):.2f}, max {max(t[1] for t in work)}; fleet wall captured "
          f"{wall * 1000:.1f} ms (real-time factor {wall / (BATCH * SECONDS):.5f}), eager "
          f"{eager_wall * 1000:.1f} ms ({eager_wall / (BATCH * SECONDS):.5f}), host route "
          f"{host_wall * 1000:.1f} ms ({host_wall / (BATCH * SECONDS):.5f})")
    print(f"scheduler {name} stages (ms a call x calls, host clock, each synchronized): {stages}")
    SUMMARY[name] = {"tick_p50": c50, "tick_p90": c90}
    return counts, probes, sched


def tick_stamp_numbers(sched):
    """One replay of the captured fused tick on the card: the runner's count
    of its stamp launches (one a stamp), once more bracketed by CUDA events
    and host clock reads, its stamps in order, their span within the
    events' time and, mapped by the scheduler's clock, within the host
    bracket. The slots' state is put back after."""
    runner, st = sched._runner, sched._st
    key = next(k for k in runner.graphs if k[0] == "fused")
    graph, static, recorded = runner.graphs[key]
    check(recorded["tick_stamp"] == len(STAMPS_TAKEN["fused"]) == STAMPS,
          f"the fused tick's graph holds {recorded['tick_stamp']} stamp launches")
    saved = st.clone()
    before = runner.launches["tick_stamp"]
    runner.run(key, functools.partial(sched._tick.body_fused, rows=key[3]), st,
               [x.clone() for x in static])
    check(runner.launches["tick_stamp"] - before == STAMPS,
          f"a fused replay counted {runner.launches['tick_stamp'] - before} stamp launches")
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    e0.record()
    graph.replay()
    e1.record()
    torch.cuda.synchronize()
    h1 = time.perf_counter()
    for name, t in st.tensors().items():
        t.copy_(saved.tensors()[name])
    ns = sched._tick.stamps.cpu().tolist()
    event_ms = e0.elapsed_time(e1)
    span_ms = (ns[-1] - ns[0]) * 1e-6
    check(ns == sorted(ns) and ns[-1] > ns[0], f"the fused tick's stamps out of order: {ns}")
    # 2 us for the two clocks' resolution
    check(span_ms <= event_ms + 2e-3, f"the stamps span {span_ms:.4f} ms of a {event_ms:.4f} ms replay")
    clock = sched._clock
    host = [clock.host(x) for x in ns]
    check(h0 - clock.error_s <= host[0] and host[-1] <= h1 + clock.error_s,
          f"the stamps on the host clock {host[0]:.6f} .. {host[-1]:.6f} leave the replay's "
          f"{h0:.6f} .. {h1:.6f} (error {clock.error_s:.2e} s)")
    stages = {n: round((ns[i + 1] - ns[i]) * 1e-6, 4) for i, n in enumerate(TICK_STAGES)}
    print(f"fused tick stamps: {STAMPS} launches a replay by the runner's count; one replay "
          f"{event_ms:.4f} ms by CUDA events, stamps s0 -> s5 {span_ms:.4f} ms "
          f"({100 * span_ms / event_ms:.1f}%), stages ms {stages}; on the host clock inside the "
          f"replay's {1e3 * (h1 - h0):.4f} ms bracket (calibration error {1e6 * clock.error_s:.1f} us)")


def graph_nodes(body, st, static):
    """Nodes of ``body`` captured once more into a kept graph of its own
    (never replayed), by libcuda's ``cuGraphGetNodes``; None where this
    PyTorch keeps no captured graph."""
    try:
        graph = torch.cuda.CUDAGraph(keep_graph=True)
    except TypeError:
        return None
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.graph(graph, stream=side):
        body(st, *static)
    lib = ctypes.CDLL("libcuda.so.1")
    lib.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)]
    lib.cuGraphGetNodes.restype = ctypes.c_int
    count = ctypes.c_size_t(0)
    rc = lib.cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(count))
    check(rc == 0, f"cuGraphGetNodes returned {rc}")
    del graph
    return count.value


def bucket_numbers(name, sched, warm_s=1.0):
    """Every AM lane bucket of the scheduler's fused tick on the card:
    ``warmup()`` captures each (``device_tick.am_buckets``); then each
    captured fused graph (a width and a bucket) replays once with the
    runner's check (bit-equal to its body run eagerly on copies of its
    state and last inputs), and prints its node count and its replay's
    device time by CUDA events (median of 10, the slots' state put back
    before each). The state is put back after."""
    runner, st, tick = sched._runner, sched._st, sched._tick
    sched.warmup(warm_s)
    keys = sorted(k for k in runner.graphs if k[0] == "fused")
    buckets = am_buckets(sched.max_streams)
    check({k[3] for k in keys} == set(buckets),
          f"{name}: captured buckets {sorted({k[3] for k in keys})}, not {buckets}")
    saved = st.clone()
    n_checks = len(runner.checks)
    rows_out = []
    for key in keys:
        graph, static, recorded = runner.graphs[key]
        body = functools.partial(tick.body_fused, rows=key[3])
        runner.check_next = True
        runner.run(key, body, st, [x.clone() for x in static])
        ms = []
        for _ in range(10):
            for field_name, t in st.tensors().items():
                t.copy_(saved.tensors()[field_name])
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            graph.replay()
            e1.record()
            torch.cuda.synchronize()
            ms.append(e0.elapsed_time(e1))
        for field_name, t in st.tensors().items():
            t.copy_(saved.tensors()[field_name])
        nodes = graph_nodes(body, st.clone(), static)
        launches = {k: v for k, v in recorded.items() if v}
        rows_out.append({"rows": key[3], "width": key[1], "dtype": key[2], "nodes": nodes,
                         "replay_ms": round(float(np.median(ms)), 4), "launches": launches})
    torch.cuda.synchronize()
    checks = runner.checks[n_checks:]
    check(len(checks) == len(keys) and all(all(eq.values()) for _k, eq in checks),
          f"{name}: a bucket's replay differs from its eager body: "
          f"{[c for c in checks if not all(c[1].values())][:2]}")
    print(f"scheduler {name} AM lane buckets {buckets}, {len(keys)} captured fused graphs, each "
          f"replay bit-equal to its eager body: "
          f"{json.dumps(rows_out)}")
    return rows_out


def buckets_against_all_slots(name, sched, pcms):
    """The chunk AM at each lane bucket against the AM over every slot, on
    the card, from one state and one set of inputs: a tick at which every
    slot decodes a chunk (all streams fed STREAM_CHUNK a round in lockstep,
    the second such tick) is kept with the state before it and run again
    eagerly with 1, 8 and 9 slots decoding (the others' n_valid set to 0,
    the lane list rebuilt), at the tick's bucket and at every slot. The
    rings, the offsets and the packed rows' traces are equal; alpha and the
    packed costs agree within the cost tolerance and the decoding slots'
    log-probs within BUCKET_LP_ATOL; a recurrent AM's rows of the slots
    that decode nothing are bit-unchanged. The streams are drained and
    closed after."""
    N, tick, runner = sched.max_streams, sched._tick, sched._runner
    kept, run, probe = [], runner.run, sched._tick.probe

    def meta_of(kind, inputs):
        if kind == "chunk":
            return inputs[1].numpy().copy()
        return tick.unpack(inputs[0])[1].numpy().copy()

    def spy(key, body, st, inputs):
        if key[0] in ("fused", "chunk") and (meta_of(key[0], inputs)[:, 0] > 0).all():
            kept.append((key[0], body.func, st.clone(), [x.clone() for x in inputs]))
        return run(key, body, st, inputs)

    runner.run = spy
    sids = [sched.open_stream() for _ in range(N)]
    check(all(sid >= 0 for sid in sids), f"{name}: the scheduler refused a stream")
    try:
        for off in range(0, min(p.shape[0] for p in pcms), STREAM_CHUNK):
            for sid, pcm in zip(sids, pcms):
                sched.feed(sid, pcm[off : off + STREAM_CHUNK])
            sched.step()
            if len(kept) == 2:
                break
    finally:
        runner.run = run
    sched._warm_drain(sids)
    check(len(kept) == 2, f"{name}: no second tick with every slot decoding")
    kind, body, st0, inputs = kept[1]
    F = sched._ring_frames
    rng = np.random.RandomState(SEED + 21)
    worst = {"log_probs": 0.0, "alpha": 0.0}

    def once(inputs, rows):
        st = st0.clone()
        tick.probe = {}
        try:
            body(st, *[x.to(sched.device) for x in inputs], rows=rows)
            log_probs = tick.probe["viterbi"][0]
        finally:
            tick.probe = probe
        torch.cuda.synchronize()
        return st, log_probs

    for lanes in BUCKET_LANES:
        meta = meta_of(kind, inputs)
        active = np.zeros(N, dtype=bool)
        active[rng.choice(N, lanes, replace=False)] = True
        meta[~active, 0] = 0
        if kind == "chunk":
            meta[:, 4] = lane_list(meta[:, 0])
            these = [inputs[0], torch.from_numpy(meta), *inputs[2:]]
        else:
            meta[:, 10] = lane_list(meta[:, 0])
            upload = inputs[0].clone()
            StreamScheduler._write_meta_cols(upload.numpy(), meta)
            these = [upload]
        rows = am_rows(lanes, N)
        ref, ref_lp = once(these, N)
        got, got_lp = once(these, rows)
        for field_name in ("ring", "offs"):
            check(torch.equal(getattr(got, field_name), getattr(ref, field_name)),
                  f"{name}: {lanes} lanes at {rows} rows: {field_name} differs from every slot's")
        pk, rpk = (x.packed.cpu().numpy().view(np.uint16) for x in (got, ref))
        check(np.array_equal(pk[:, : F + 4], rpk[:, : F + 4]),
              f"{name}: {lanes} lanes at {rows} rows: the packed traces differ")
        for col in (F + 4, F + 6):
            a, b = [(x[:, col].astype(np.uint32) | (x[:, col + 1].astype(np.uint32) << 16))
                    .view(np.float32) for x in (pk, rpk)]
            check(np.allclose(a, b, rtol=COST_RTOL, atol=COST_ATOL),
                  f"{name}: {lanes} lanes at {rows} rows: packed costs differ")
        check(torch.allclose(got.alpha, ref.alpha, rtol=COST_RTOL, atol=COST_ATOL),
              f"{name}: {lanes} lanes at {rows} rows: alpha differs")
        on = torch.from_numpy(active).to(sched.device)
        lp_d = float((got_lp[on] - ref_lp[on]).abs().max())
        check(lp_d <= BUCKET_LP_ATOL, f"{name}: {lanes} lanes at {rows} rows: log-probs |d| {lp_d}")
        worst["log_probs"] = max(worst["log_probs"], lp_d)
        fin = torch.isfinite(ref.alpha) & (ref.alpha.abs() < 1e29)
        worst["alpha"] = max(worst["alpha"], float((got.alpha - ref.alpha)[fin].abs().max()))
        if st0.rec:
            reset = torch.from_numpy(meta[:, 1] != 0).to(sched.device)
            for k, before in st0.rec.items():
                kept_rows = torch.where(reset[:, None, None], 0.0, before)
                check(torch.equal(got.rec[k][~on], kept_rows[~on]),
                      f"{name}: {lanes} lanes at {rows} rows: idle rows of {k} changed")
    print(f"scheduler {name} ({kind} body{', recurrent' if st0.rec else ''}): the AM at lane "
          f"buckets against every slot from one state, {BUCKET_LANES} lanes at rows "
          f"{[am_rows(n, N) for n in BUCKET_LANES]}: rings, offsets and packed traces equal; "
          f"max |d| log-probs {worst['log_probs']:.3e}, alpha {worst['alpha']:.3e}")
    return worst


def sched_kernel_numbers(sched, probes, dev):
    """K1 and K2 at the tick's shapes against their plain versions: K1 on
    the first probed tick's PCM, K2 on the tick with idle slots."""
    params = sched._featurizer.stream_params
    samples = probes["pcm"]
    got, want = mfcc_batch(params, samples), mfcc_batch_torch(params, samples)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(torch.allclose(got, want, rtol=MFCC_RTOL, atol=MFCC_ATOL),
          f"mfcc kernel vs twin at the tick's shape: max |d| {err}")
    k1 = {"ms": device_ms(lambda: mfcc_batch(params, samples)),
          "plain_ms": cuda_ms(lambda: mfcc_batch_torch(params, samples)), "max_abs_err": err}
    k1["bound_ms"], k1["bound_by"] = bound(*mfcc_work(params, *samples.shape, got.shape[1]))
    g = sched.device_graph
    lp, lens, alpha0 = probes["idle"]
    compact = g.num_arcs <= twin_decoder._COMPACT_BP_MAX_ARC
    out = viterbi_decode(g, lp, sched.acoustic_scale, lens, return_forward=True, alpha0=alpha0)
    want = twin_decoder.viterbi(g, lp, sched.acoustic_scale, lens, compact_bp=compact, alpha0=alpha0)
    torch.cuda.synchronize()
    k2 = {"ms": device_ms(lambda: viterbi_decode(g, lp, sched.acoustic_scale, lens,
                                                 return_forward=True, alpha0=alpha0)),
          "plain_ms": cuda_ms(lambda: twin_decoder.viterbi(
              g, lp, sched.acoustic_scale, lens, compact_bp=compact, alpha0=alpha0), iters=3),
          "max_abs_err": float((out[3] - want[0]).abs().max())}
    nbytes, nops = viterbi_work(g, *lp.shape, lens)
    k2["bound_ms"], k2["bound_by"] = bound(nbytes + 4 * lp.shape[0] * g.num_states, nops)  # + alpha0
    for name, k, shape in (("K1 mfcc", k1, f"{list(samples.shape)} -> {list(got.shape)}"),
                           ("K2 viterbi", k2, f"{list(lp.shape)} with alpha0, lengths {lens.tolist()}")):
        print(f"{name} at the tick's shape {shape}: max |d| {k['max_abs_err']:.3e}; kernel "
              f"{k['ms']:.4f} ms of device time, plain {k['plain_ms']:.4f} ms, bound "
              f"{k['bound_ms']:.6f} ms ({k['bound_by']})")
    return k1, k2


def speech_endpoints(sched, pcms):
    """The speech streams fed in STREAM_CHUNK pushes, never finished, a
    tick after each round, until every transcript is in. Returns
    (transcripts, the tick each stream's endpoint fired on, ticks, input
    frames weighed as silence on the device)."""
    sids = [sched.open_stream() for _ in pcms]
    fired = [None] * len(sids)
    ticks = weighed = 0

    def tick():
        nonlocal ticks, weighed
        sched.step()
        ticks += 1
        for i, sid in enumerate(sids):
            if fired[i] is None and sched.slots[sid].done:
                fired[i] = ticks
        if sched._device_bp and sched._sw_device:
            weighed += int((sched._sw_w == np.float32(SILENCE_WEIGHT)).sum())

    for off in range(0, max(p.shape[0] for p in pcms), STREAM_CHUNK):
        for sid, pcm in zip(sids, pcms):
            if off < pcm.shape[0]:
                sched.feed(sid, pcm[off : off + STREAM_CHUNK])
        tick()
    for _ in range(200):
        if all(sched.poll(sid) is not None for sid in sids):
            break
        tick()
    check(not any(sched.pool.is_finished(sid) for sid in sids), "a speech stream was finished")
    texts = [sched.poll(sid) for sid in sids]
    for sid in sids:
        sched.close(sid)
    return texts, fired, ticks, weighed


@functools.lru_cache(maxsize=None)
def trained_speech_profile(root, gmm=False):
    """The port's synthetic speech profile (an AM context that covers the
    i-vector tap, and the extractor's CMVN stats), or with ``gmm`` its GMM
    profile (no i-vector), with its grammar trained: (profile, graph dir),
    built once a run."""
    kind = "gmm_speech" if gmm else "speech"
    if gmm:
        profile = build_synthetic_gmm_profile(os.path.join(root, f"{kind}_model"), SPEECH_LEXICON)
    else:
        profile = build_synthetic_profile(os.path.join(root, f"{kind}_model"), SPEECH_LEXICON,
                                          with_ivector=True, with_context=True,
                                          with_ivector_cmvn=True)
    intents = {"language": "en", "intents": {"Main": {"data": [{"sentences": SPEECH_GRAMMAR}]}}}
    train_model_sync("en", intents, os.path.join(root, f"{kind}_train"), profile.model_dir,
                     lang_suffixes=[LangSuffix.GRAMMAR])
    return profile, os.path.join(root, f"{kind}_train", lang_dir_name(LangSuffix.GRAMMAR))


def speech_part(root, dev, gmm=False):
    """The port's synthetic speech profile (an AM context that covers the
    i-vector tap, and the extractor's CMVN stats: the device route in full),
    or with ``gmm`` its GMM profile (no i-vector): 8 spoken sentences with
    trailing silence, never finished, must endpoint to the spoken sentence
    and the batch transcript, plain and (nnet3) with silence_weight; each
    stream's endpoint tick beside the host route's."""
    kind = "gmm_speech" if gmm else "speech"
    profile, graph_dir = trained_speech_profile(root, gmm)
    rng = np.random.RandomState(SEED + 11)
    pcms = [np.concatenate([synthesize_sentence(profile, text, seed=SEED + i),
                            _silence_wave(16000 + 2000 * i, rng)]).astype(np.float32)
            for i, text in enumerate(SPEECH_TEXTS)]
    spoken = [[t] for t in SPEECH_TEXTS]
    batch = Nnet3WavTranscriber(profile.model_dir, graph_dir, device=dev).transcribe_pcm_batch(pcms)
    check(batch == spoken, f"{kind} profile: batch transcripts {batch}")
    for kw in ({},) if gmm else ({}, {"silence_weight": SILENCE_WEIGHT}):
        args = (profile.model_dir, graph_dir)
        kwargs = dict(max_streams=len(pcms), endpointing=EndpointConfig(), device=dev, **kw)
        sched = StreamScheduler(*args, **kwargs)
        check(sched._device_bp and sched._device_feats and sched._ep_device
              and sched._sw_device == bool(kw), f"{kind} profile {kw}: not on the device route")
        before = sched.kernel_launches
        texts, fired, ticks, weighed = speech_endpoints(sched, pcms)
        counts = {k: v - before[k] for k, v in sched.kernel_launches.items()}
        host_texts, host_fired, _t, _w = speech_endpoints(host_route_scheduler(*args, **kwargs), pcms)
        check(texts == batch, f"{kind} profile {kw}: endpointed transcripts {texts} vs batch {batch}")
        check(host_texts == batch, f"{kind} profile {kw}: host-route transcripts {host_texts}")
        check(all(v > 0 for v in counts.values()), f"{kind} profile: launches {counts}")
        if kw:
            check(weighed > 0, "silence weighting weighed no frame")
        print(f"scheduler on the synthetic {kind} profile {kw or '(plain)'}, device route: "
              f"{len(pcms)} streams with 1-2 s of trailing silence, never finished, all endpointed "
              f"within {ticks} ticks to the spoken sentences and the batch transcripts; launches "
              f"{counts}; input frames weighed {SILENCE_WEIGHT} as silence on the device: {weighed}; "
              f"endpoint tick per stream, device route {fired}, host route {host_fired}")


def scheduler_phase(model_dir, graph_dir, big_dirs, root, dev, pcms, fuzzy):
    """The stream scheduler at full width on both graphs, then on speech;
    returns the launch counts and K1 / K2 / K4 numbers of the flagship
    graph's tick, and K4's on the big graph."""
    counts, probes, sched = sched_graph_part("flagship", model_dir, graph_dir, dev, pcms, fuzzy)
    k1, k2 = sched_kernel_numbers(sched, probes, dev)
    k4 = path_walk_numbers("flagship", sched, dev)
    tick_stamp_numbers(sched)
    bucket_numbers("flagship", sched)
    buckets_against_all_slots("flagship", sched, pcms)
    del sched, probes
    big_counts, big_probes, big = sched_graph_part("13789", *big_dirs, dev, pcms, {})
    lp, lens, alpha0 = big_probes["idle"]
    big_ms = device_ms(lambda: viterbi_decode(big.device_graph, lp, big.acoustic_scale, lens,
                                              return_forward=True, alpha0=alpha0))
    plan, _ = select_plan(big.device_graph, lp.shape[0])
    print(f"K2 at the tick's shape on {big.device_graph.num_states} states {list(lp.shape)}: "
          f"{big_ms:.4f} ms of device time in clusters of {plan.cluster}")
    k4_big = path_walk_numbers("13789", big, dev)
    k4_big["launches"] = big_counts["path_walk"]
    del big, big_probes
    speech_part(root, dev)
    return counts, k1, k2, k4, k4_big


def gmm_stage_ms(t, pcms, fuzzy):
    """The GMM batch call once more, stage by stage, each stage ended by a
    synchronize: ``AcousticModel.log_probs``' two steps, the deltas and the
    log-likelihoods, are stages of their own."""
    out = {}
    last = time.perf_counter()

    def mark(name):
        nonlocal last
        torch.cuda.synchronize()
        now = time.perf_counter()
        out[name] = round((now - last) * 1000.0, 3)
        last = now

    pcm, _feat_lengths, lengths, n_out = t._pad_batch(pcms)
    mark("pad_upload")
    feats = t.am.features(pcm)
    mark("mfcc")
    full = add_deltas(feats, order=2)
    idx = torch.as_tensor(np.clip(np.arange(n_out), 0, feats.shape[1] - 1), device=pcm.device)
    full = full[:, idx]
    mark("deltas")
    log_probs = t.am.gmm.log_likes(full)
    mark("gmm_log_likes")
    trace, final_state, cost = t._decode_traces(log_probs, lengths)
    mark("decode_and_copy")
    words = twin_decoder.traces_to_words_batch(t.artifacts.graph, trace, final_state, cost)
    mark("word_assembly")
    t._texts([[] if w is None else [(w, c)] for w, c in words], None, require_fuzzy=False, **fuzzy)
    mark("fuzzy_tail")
    return out, full


def gmm_batch_part(tri1_dir, graph_dir, dev, pcms, fuzzy):
    """The tri1 model's batch call, counted; transcripts against the plain
    twins' path; K1 at 13 / 23 and K2 at [32, 304, 2000] (298 frames a
    stream) against their twins; the GMM log-likelihoods timed beside their
    bound. Returns (launches, K1 numbers, K2 numbers, the transcriber)."""
    t = Nnet3WavTranscriber(tri1_dir, graph_dir, device=dev)
    cfg = t.am.frontend_config
    check(t.am.gmm is not None and t.am.subsampling == 1 and t.am.ivector_params is None
          and (cfg.num_ceps, cfg.num_mel_bins) == (13, 23), "tri1: not the GMM route at 13 / 23")
    gmm = t.am.gmm
    for _ in range(2):  # warm-up at the measured shape
        t.transcribe_pcm_batch(pcms, **fuzzy)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.time()
    texts = t.transcribe_pcm_batch(pcms, **fuzzy)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_counts()
    check(launches["mfcc"] == 1 and launches["viterbi"] == 1, f"tri1 batch launches {launches}")
    check(len(texts) == BATCH and all(len(x) == 1 for x in texts), f"tri1 transcripts {texts[:3]}")
    stages, full = gmm_stage_ms(t, pcms, fuzzy)
    print(f"tri1 GMM ({gmm.num_pdfs} pdfs, {GMM_GAUSS} Gaussians padded to {gmm.num_comps} a pdf, "
          f"{gmm.dim} dims) batch: {BATCH} x {SECONDS} s in {wall * 1000:.1f} ms; launches "
          f"{launches}; stages (ms, host clock, synchronized): {stages}")

    pcm, _fl, lengths, n_out = t._pad_batch(pcms)
    feats_plain = mfcc_batch_torch(t.am.frontend_params, pcm)
    lp_plain = t.am.log_probs(feats_plain, n_out)
    res = twin_decoder.viterbi_decode(t.device_graph, lp_plain, t.acoustic_scale, lengths)
    words = twin_decoder.traces_to_words_batch(t.artifacts.graph, *[r.cpu().numpy() for r in res])
    plain_texts = t._texts([[] if w is None else [(w, c)] for w, c in words], None,
                           require_fuzzy=False, **fuzzy)
    check(plain_texts == texts, "tri1: transcripts differ between kernels and plain twins")

    params = t.am.frontend_params
    feats_k = mfcc_batch(params, pcm)
    torch.cuda.synchronize()
    k1_err = float((feats_k - feats_plain).abs().max())
    check(torch.allclose(feats_k, feats_plain, rtol=MFCC_RTOL, atol=MFCC_ATOL),
          f"tri1: mfcc kernel vs twin at 13 / 23: max |d| {k1_err}")
    k1 = {"max_abs_err": k1_err, "ms": cuda_ms(lambda: mfcc_batch(params, pcm)),
          "plain_ms": cuda_ms(lambda: mfcc_batch_torch(params, pcm))}
    k1["bound_ms"], k1["bound_by"] = bound(*mfcc_work(params, BATCH, pcm.shape[1], feats_k.shape[1]))

    g, scale = t.device_graph, t.acoustic_scale
    lp = t.am.log_probs(feats_k, n_out)
    compact = g.num_arcs <= twin_decoder._COMPACT_BP_MAX_ARC

    def twin():
        alpha, bps = twin_decoder.viterbi(g, lp, scale, lengths, compact_bp=compact)
        return twin_decoder.backtrace(g, alpha, bps) + (alpha, bps)

    got = viterbi_decode(g, lp, scale, lengths, return_forward=True)
    want = twin()
    torch.cuda.synchronize()
    check(decode_outputs_equal(got, want), "tri1: K2 differs from its twin at the batch shape")
    k2 = {"max_abs_err": float((got[3] - want[3]).abs().max()),
          "ms": cuda_ms(lambda: viterbi_decode(g, lp, scale, lengths)),
          "plain_ms": cuda_ms(twin, iters=2)}
    k2["bound_ms"], k2["bound_by"] = bound(*viterbi_work(g, *lp.shape, lengths))

    ll_ms = cuda_ms(lambda: gmm.log_likes(full))
    rows = full.shape[0] * full.shape[1]
    ll_bound = bound(4 * (rows * gmm.dim + rows * gmm.num_pdfs + GMM_GAUSS * (2 * gmm.dim + 1)),
                     2 * 2 * rows * GMM_GAUSS * gmm.dim)
    for name, k, shape in (("K1 mfcc", k1, f"{list(pcm.shape)} -> {list(feats_k.shape)}"),
                           ("K2 viterbi", k2, f"{list(lp.shape)}, lengths {int(lengths.max())}")):
        print(f"tri1 {name} {shape}: max |d| {k['max_abs_err']:.3e}; kernel {k['ms']:.4f} ms, "
              f"plain {k['plain_ms']:.4f} ms, bound {k['bound_ms']:.6f} ms ({k['bound_by']})")
    print(f"tri1 GMM log-likelihoods {list(full.shape)} -> [{full.shape[0]}, {full.shape[1]}, "
          f"{gmm.num_pdfs}] (cuBLAS f32, row blocks of {gmm_mod.BLOCK_ELEMS // (gmm.num_pdfs * gmm.num_comps)}): "
          f"{ll_ms:.4f} ms (CUDA events), bound {ll_bound[0]:.4f} ms ({ll_bound[1]}, "
          f"{GMM_GAUSS} Gaussians); transcripts equal the plain twins' path; first: {texts[0]}")
    return launches, k1, k2, t


def gmm_stream_part(tri1_dir, graph_dir, t, dev, pcms):
    """The tri1 model streamed: one K1 launch a push and one K2 launch a
    chunk on one utterance, counted; feature rows bit-equal to the batch
    rows; 8 streamed transcripts equal to the batch's; a chunk's stages and
    the stream's real-time factor."""
    utts = pcms[:STREAMS]
    st = Nnet3StreamTranscriber(tri1_dir, graph_dir, device=dev)
    check(st._chunk_in == CHUNK_FRAMES, "tri1 stream: chunk frames")
    stream_pcm(st, utts[0])  # warm-up
    zero_counts()
    texts0, state, pushes = stream_pcm(st, utts[0])
    torch.cuda.synchronize()
    counts = read_counts()
    chunks = -(-state.feats.shape[0] // st._chunk_in)
    check(counts["mfcc"] == pushes and counts["viterbi"] == chunks == len(state.bps),
          f"tri1 stream launches {counts} for {pushes} pushes and {chunks} chunks")
    batch_rows = t.am.features(torch.as_tensor(utts[0][None], device=dev))[0]
    check(torch.equal(torch.as_tensor(state.feats, device=dev), batch_rows),
          "tri1: streamed feature rows differ from the batch rows")
    streamed = [texts0] + [st.transcribe_pcm(p, chunk_samples=STREAM_CHUNK) for p in utts[1:]]
    batch = t.transcribe_pcm_batch(utts)
    same = sum(a == b for a, b in zip(streamed, batch))
    check(same == STREAMS, f"tri1: streamed transcripts {streamed} vs batch {batch}")
    stage_s = {}
    names = ("_upload", "_acoustic", "_decode_chunk", "_download")
    for name in names:
        setattr(st, name, timed_stage(getattr(st, name), stage_s, name.lstrip("_")))
    _texts, state, _p = stream_pcm(st, utts[-1])
    for name in names:
        delattr(st, name)
    stages = {k: round(v * 1000.0 / len(state.bps), 4) for k, v in stage_s.items()}
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st.transcribe_pcm(utts[-1], chunk_samples=STREAM_CHUNK)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    print(f"tri1 stream: launches {counts} for {pushes} pushes and {chunks} chunks; feature rows "
          f"bit-equal to the batch rows; {same} of {STREAMS} streamed transcripts equal the "
          f"batch's; ms a chunk (host clock, each stage synchronized) {stages}; one {SECONDS} s "
          f"stream {min(walls) * 1000:.1f} ms (min of 3; real-time factor {min(walls) / SECONDS:.5f})")
    return counts


def gmm_phase(root, model_dir, graph_dir, big_dirs, dev, pcms, fuzzy):
    """The Kaldi tri1 GMM system at full width (testing/full_width.py) over
    the flagship graph (a) and the generated grammar (c): batch, one
    stream, the scheduler's captured device route, and the synthetic GMM
    profile's speech endpointing. Returns the kernels-line entries."""
    t0 = time.time()
    with open(os.path.join(model_dir, "model", "final.mdl"), "rb") as f:
        ktm = KaldiTransitionModel.read(KaldiReader(f))
    with open(os.path.join(model_dir, "model", "phones.txt"), encoding="utf-8") as f:
        phones_text = f.read()
    tri1_dir = write_tri1_model_dir(os.path.join(root, "tri1"), ktm, phones_text, seed=SEED + 21)
    print(f"tri1 model dir (the flagship graph's transition model) written in {time.time() - t0:.1f} s")
    launches, k1, k2, t = gmm_batch_part(tri1_dir, graph_dir, dev, pcms, fuzzy)
    stream_counts = gmm_stream_part(tri1_dir, graph_dir, t, dev, pcms)
    del t
    counts, probes, sched = sched_graph_part("tri1 flagship", tri1_dir, graph_dir, dev, pcms, fuzzy,
                                             min_equal=BATCH)
    k1_tick, k2_tick = sched_kernel_numbers(sched, probes, dev)
    k4 = path_walk_numbers("tri1 flagship", sched, dev)
    del sched, probes
    big_counts, _probes, big = sched_graph_part("tri1 13789", tri1_dir, big_dirs[1], dev, pcms, {},
                                                min_equal=BATCH)
    del big, _probes
    print(f"tri1 scheduler launches: flagship graph {counts}, 13,789-state graph {big_counts}; "
          f"one streamed utterance {stream_counts}")
    speech_part(root, dev, gmm=True)
    entry = {"route": "cuda", "library_ms": None}
    return [
        {"name": "mfcc_tri1", "source": "rhasspy_speech_torch/csrc/mfcc.cu",
         "replaces": "rhasspy_speech_tpu/ops/pallas_mfcc.py:122", "launches": launches["mfcc"],
         **entry, **k1},
        {"name": "viterbi_tri1", "source": "rhasspy_speech_torch/csrc/viterbi.cu",
         "replaces": "rhasspy_speech_tpu/ops/pallas_decoder.py:370", "launches": launches["viterbi"],
         **entry, **k2},
        {"name": "mfcc_tri1_sched_tick", "source": "rhasspy_speech_torch/csrc/mfcc.cu",
         "replaces": "rhasspy_speech_tpu/ops/pallas_mfcc.py:122", "launches": counts["mfcc"],
         **entry, **k1_tick},
        {"name": "viterbi_tri1_sched_tick", "source": "rhasspy_speech_torch/csrc/viterbi.cu",
         "replaces": "rhasspy_speech_tpu/ops/pallas_decoder.py:370", "launches": counts["viterbi"],
         **entry, **k2_tick},
        {"name": "path_walk_tri1", "source": "rhasspy_speech_torch/csrc/path_walk.cu",
         "replaces": "rhasspy_speech_tpu/pipeline/scheduler.py:838", "launches": counts["path_walk"],
         **entry, **k4},
    ]


def coqui_deepspeech_part(root, dev, pcms):
    """The DeepSpeech-width model through model.tflite: transcribe_pcm on 4
    utterances, counted; probs against the CPU port on one; the stream
    triple against compute_probs; K1 at 26 / 40 (512 / 320) against its
    twin. Returns the kernels-line entries' numbers."""
    t0 = time.time()
    ds_dir = write_deepspeech_model_dir(os.path.join(root, "deepspeech"), seed=SEED + 31)
    size = os.path.getsize(os.path.join(ds_dir, "model.tflite"))
    intents = {"language": "en", "intents": {"Main": {"data": [{"sentences": SPEECH_GRAMMAR}]}}}
    train_dir = os.path.join(root, "deepspeech_train")
    train_model_sync("en", intents, train_dir, ds_dir)
    built = time.time() - t0
    t0 = time.time()
    t = CoquiSttTranscriber(ds_dir, train_dir, device=dev)
    loaded = time.time() - t0
    m = t.model
    n_params = sum(int(v.numel()) for v in m.params.values())
    check(os.path.exists(os.path.join(ds_dir, "model.npz")), "the tflite model was not converted")
    check((m.num_labels, m.context, m.has_lstm, m.lstm_hidden) == (29, 9, True, 2048)
          and tuple(m.params["lstm_kernel"].shape) == (4096, 8192), "DeepSpeech shapes")
    print(f"DeepSpeech model.tflite ({size / 1e6:.1f} MB, {n_params / 1e6:.2f} M parameters) written "
          f"and a grammar trained in {built:.1f} s; converted to model.npz and loaded on the card in "
          f"{loaded:.1f} s")
    utts = pcms[:COQUI_UTTS]
    t.transcribe_pcm(utts[0])  # warm-up
    torch.cuda.synchronize()
    zero_counts()
    texts = [t.transcribe_pcm(p) for p in utts]
    torch.cuda.synchronize()
    launches = read_counts()
    check(launches["mfcc"] == COQUI_UTTS, f"DeepSpeech transcribe_pcm launches {launches}")
    probs_ms, decode_ms = [], []
    for p in utts:
        torch.cuda.synchronize()
        a = time.perf_counter()
        probs = t.compute_probs(p)
        b = time.perf_counter()
        t.decode_probs(probs)
        probs_ms.append((b - a) * 1000.0)
        decode_ms.append((time.perf_counter() - b) * 1000.0)
    probs = t.compute_probs(utts[0])
    check(probs.shape == (149, 29) and np.isfinite(probs).all(), f"probs {probs.shape}")
    tc = CoquiSttTranscriber(ds_dir, train_dir, device="cpu")
    cpu_err = float(np.abs(probs - tc.compute_probs(utts[0])).max())
    check(cpu_err <= COQUI_CPU_ATOL, f"DeepSpeech probs, card vs CPU: max |d| {cpu_err}")
    del tc
    def stream_probs(pcm):
        """The stream triple's acoustic side (pushes, then the flush of the
        frame tail): (state, pushes, pushes that completed a frame)."""
        state = t.start_stream()
        framed = pushes = 0
        for off in range(0, pcm.shape[0], STREAM_CHUNK):
            chunk = pcm[off : off + STREAM_CHUNK]
            framed += state.sample_tail.shape[0] + chunk.shape[0] >= t.frontend_config.frame_length
            t.process_chunk(state, chunk)
            pushes += 1
        t._advance(state, final=True)
        return state, pushes, framed

    stream_probs(utts[1])  # warm-up: the 16-frame window's shapes
    torch.cuda.synchronize()
    zero_counts()
    state, pushes, framed = stream_probs(utts[0])
    text = t.finish_stream(state)
    stream_counts = read_counts()
    check(stream_counts["mfcc"] == framed > 0, f"DeepSpeech stream launches {stream_counts}")
    check(text == texts[0], f"DeepSpeech stream text {text!r} vs transcribe_pcm's {texts[0]!r}")
    streamed = np.concatenate(state.probs)
    check(np.allclose(streamed, probs, rtol=STREAM_RTOL, atol=STREAM_ATOL),
          f"streamed probs vs compute_probs: max |d| {float(np.abs(streamed - probs).max())}")
    walls = []
    for _ in range(3):
        a = time.perf_counter()
        stream_probs(utts[0])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - a)
    stream_s = min(walls)
    T = probs.shape[0]
    lstm_bytes = 4 * (int(m.params["lstm_kernel"].numel()) + int(m.params["lstm_bias"].numel()))
    rest = 4 * n_params - lstm_bytes
    bound_batch = (T * lstm_bytes + rest) / HBM_BYTES_PER_S * 1e3
    bound_window = (CoquiSttTranscriber.STREAM_WINDOW * lstm_bytes + rest) / HBM_BYTES_PER_S * 1e3
    windows = -(-T // CoquiSttTranscriber.STREAM_WINDOW)
    print(f"DeepSpeech transcribe_pcm x {COQUI_UTTS} ({SECONDS} s each): launches {launches}; "
          f"compute_probs ms (host clock) {[round(x, 3) for x in probs_ms]}, bound {bound_batch:.3f} "
          f"ms (the LSTM kernel, {lstm_bytes / 1e6:.1f} MB, read each of {T} steps; the rest once); "
          f"decode_probs ms {[round(x, 3) for x in decode_ms]}; probs card vs CPU max |d| "
          f"{cpu_err:.3e} (atol {COQUI_CPU_ATOL}); texts {texts}")
    print(f"DeepSpeech stream: {pushes} pushes, launches {stream_counts}; probs equal compute_probs "
          f"(rtol {STREAM_RTOL} / atol {STREAM_ATOL}, max |d| "
          f"{float(np.abs(streamed - probs).max()):.3e}); pushes and flush without the decode "
          f"{stream_s * 1000:.1f} ms (min of 3; real-time factor {stream_s / SECONDS:.5f}; "
          f"{windows} windows of {CoquiSttTranscriber.STREAM_WINDOW} frames, bound "
          f"{bound_window:.3f} ms a window), with finish_stream's decode_probs real-time factor "
          f"{(stream_s + min(decode_ms) / 1000.0) / SECONDS:.5f}")

    params = t.frontend_params
    one = torch.as_tensor(utts[0][None], device=dev)
    got, want = mfcc_batch(params, one), mfcc_batch_torch(params, one)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(torch.allclose(got, want, rtol=MFCC_RTOL, atol=MFCC_ATOL),
          f"mfcc kernel vs twin at 26 / 40 (512 / 320): max |d| {err}")
    k1 = {"max_abs_err": err, "ms": device_ms(lambda: mfcc_batch(params, one)),
          "plain_ms": cuda_ms(lambda: mfcc_batch_torch(params, one))}
    k1["bound_ms"], k1["bound_by"] = bound(*mfcc_work(params, 1, one.shape[1], got.shape[1]))
    n = STREAM_CHUNK + 320  # a push and a carried tail
    push = one[:, :n].contiguous()
    gp, wp = mfcc_batch(params, push), mfcc_batch_torch(params, push)
    torch.cuda.synchronize()
    perr = float((gp - wp).abs().max())
    check(torch.allclose(gp, wp, rtol=MFCC_RTOL, atol=MFCC_ATOL), f"mfcc at a push: max |d| {perr}")
    k1_push = {"max_abs_err": perr, "ms": device_ms(lambda: mfcc_batch(params, push)),
               "plain_ms": cuda_ms(lambda: mfcc_batch_torch(params, push))}
    k1_push["bound_ms"], k1_push["bound_by"] = bound(*mfcc_work(params, 1, n, gp.shape[1]))
    for name, k, shape in (("", k1, f"{list(one.shape)} -> {list(got.shape)}"),
                           (" at a push", k1_push, f"{list(push.shape)} -> {list(gp.shape)}")):
        print(f"K1 mfcc at 26 / 40, 512 / 320{name} {shape}: max |d| {k['max_abs_err']:.3e}; kernel "
              f"{k['ms']:.4f} ms of device time, plain {k['plain_ms']:.4f} ms, bound "
              f"{k['bound_ms']:.6f} ms ({k['bound_by']})")
    return launches, k1, stream_counts, k1_push


@functools.lru_cache(maxsize=None)
def trained_ctc_profile(root):
    """The synthetic CTC profile with its grammar trained: (profile, train
    dir), built once a run."""
    profile = build_synthetic_ctc_profile(os.path.join(root, "ctc_model"), COQUI_CHARS)
    with open(os.path.join(profile.model_dir, "config.json"), "w", encoding="utf-8") as f:
        json.dump({"type": "coqui"}, f)
    train_dir = os.path.join(root, "ctc_train")
    train_model_sync("en", {"language": "en", "intents": {"Main": {"data": [
        {"sentences": COQUI_SENTENCES}]}}}, train_dir, profile.model_dir)
    return profile, train_dir


def coqui_synthetic_part(root, dev):
    """The synthetic CTC profile on the card: spelled texts decode to
    themselves, batch and streamed."""
    profile, train_dir = trained_ctc_profile(root)
    t = CoquiSttTranscriber(profile.model_dir, train_dir, device=dev)
    for i, text in enumerate(COQUI_TEXTS):
        pcm = synthesize_ctc_text(profile, text, seed=SEED + 40 + i)
        got = t.transcribe_pcm(pcm, prune_threshold=COQUI_PRUNE)
        state = t.start_stream()
        for off in range(0, pcm.shape[0], STREAM_CHUNK):
            t.process_chunk(state, pcm[off : off + STREAM_CHUNK])
        streamed = t.finish_stream(state, prune_threshold=COQUI_PRUNE)
        check(got == streamed == text, f"synthetic CTC profile: {got!r} / {streamed!r} vs {text!r}")
    print(f"synthetic CTC profile on the card: {len(COQUI_TEXTS)} spelled texts decode to "
          f"themselves, batch and streamed: {COQUI_TEXTS}")


def coqui_phase(root, dev, pcms):
    """Coqui STT: the DeepSpeech-width model, then the synthetic profile."""
    launches, k1, stream_counts, k1_push = coqui_deepspeech_part(root, dev, pcms)
    coqui_synthetic_part(root, dev)
    entry = {"route": "cuda", "source": "rhasspy_speech_torch/csrc/mfcc.cu",
             "replaces": "rhasspy_speech_tpu/ops/pallas_mfcc.py:122", "library_ms": None}
    return [
        {"name": "mfcc_deepspeech", "launches": launches["mfcc"], **entry, **k1},
        {"name": "mfcc_deepspeech_stream_push", "launches": stream_counts["mfcc"], **entry,
         **k1_push},
    ]


def plain_pitch(fn, *args):
    """``fn(*args)`` with ``ops.pitch`` calling the pitch-Viterbi twin: the
    plain path, on the same device."""
    saved = pitch_mod.pitch_viterbi
    pitch_mod.pitch_viterbi = pitch_viterbi_torch
    try:
        return fn(*args)
    finally:
        pitch_mod.pitch_viterbi = saved


def k5_numbers(label, cfg, pcm):
    """K5 on the local costs of ``pcm``'s pitch tracks: bit-equal to its
    twin, timed beside the twin, its bound and the local costs' own time
    (downsample, NCCF, interpolation)."""
    local, _phi = pitch_local(cfg, pcm)
    dist = cached_index(transition_costs(local.shape[2], cfg.delta_pitch, cfg.penalty_factor),
                        pcm.device)
    got, want = pitch_viterbi(local, dist), pitch_viterbi_torch(local, dist)
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"{label}: the pitch-Viterbi kernel differs from its twin")
    out = {"ms": cuda_ms(lambda: pitch_viterbi(local, dist)),
           "plain_ms": cuda_ms(lambda: pitch_viterbi_torch(local, dist), iters=3),
           "max_abs_err": float((got - want).abs().max())}
    out["bound_ms"], out["bound_by"] = bound(*pitch_work(*local.shape))
    plan = select_pitch_plan(local.shape[0], local.shape[2], pcm.device)
    clocks = torch.zeros((local.shape[0], plan.cluster, 4), dtype=torch.int64, device=pcm.device)
    pitch_viterbi(local, dist, clocks=clocks)
    torch.cuda.synchronize()
    fwd, back, pas, merge = clocks[:, 0].double().mean(dim=0).tolist()
    local_ms = cuda_ms(lambda: pitch_local(cfg, pcm))
    batch_ms = cuda_ms(lambda: pitch_batch(cfg, pcm))
    print(f"K5 pitch_viterbi {label} {list(local.shape)}: states bit-equal to the twin; kernel "
          f"{out['ms']:.4f} ms in clusters of {plan.cluster}, "
          f"{plan.lanes} lanes a strip, {plan.threads} threads; rank 0's cycles: min-plus pass "
          f"{100 * pas / (fwd + back):.1f}%, merge {100 * merge / (fwd + back):.1f}%, wait "
          f"{100 * (fwd - pas - merge) / (fwd + back):.1f}%, final argmin + traceback "
          f"{100 * back / (fwd + back):.1f}%; share of the bound "
          f"{100 * out['bound_ms'] / out['ms']:.1f}%; plain {out['plain_ms']:.4f} ms, bound "
          f"{out['bound_ms']:.6f} ms ({out['bound_by']}); downsample + NCCF + interpolation "
          f"{local_ms:.4f} ms; whole pitch_batch {batch_ms:.4f} ms (CUDA events)")
    return out


def k5_sweep():
    """K5 at every cluster size and lane count at the three shapes, on
    seeded tie-heavy costs (bit-equal to the twin) and continuous ones
    (timed): ``examples/pitch_viterbi_sweep.py``."""
    rows = pitch_viterbi_sweep.k5_sweep(torch.device("cuda", 0), variants=LANE_CHUNKS)
    for r in rows:
        print(pitch_viterbi_sweep.k5_row_text(r))
    check(all(r["bit_equal"] for r in rows), "K5: a cluster size differs from the twin")
    check(all(sum(r["chosen"] for r in rows if r["shape"] == lab) == 1
              for lab, _b, _t in pitch_viterbi_sweep.SHAPES), "K5: the chosen plan is not in the sweep")
    print(f"K5 sweep: {len(rows)} (shape, cluster size, lanes) launches bit-equal to the twin on "
          f"tie-heavy costs; chosen: " + "; ".join(
              f"{r['shape']} C={r['cluster']} lanes={r['lanes']} {r['ms']:.4f} ms"
              for r in rows if r["chosen"]))


def lag_states(cfg, pcm):
    """Each frame's lag index, read back from pitch_track's Hz."""
    pitch, _nccf = pitch_track(cfg, pcm)
    lags = torch.as_tensor(make_lags(cfg).astype(np.float32), device=pcm.device)
    return torch.argmin((1.0 / pitch[:, :, None] - lags).abs(), dim=2)


def pitch_batch_part(pitch_dir, graph_dir, dev, pcms, fuzzy, plain_stages):
    """The pitch model's batch call: counted (one K1, K2 and K5 launch),
    transcripts equal to the plain twins' path, K5 bit-equal at the batch
    and tick shapes, the card against CPU tensors (2 utterances, the tone
    and sweep fixtures), stages beside the pitch-free call's."""
    t = Nnet3WavTranscriber(pitch_dir, graph_dir, device=dev)
    cfg = t.am.pitch_config
    C = t.am.frontend_config.num_ceps
    in_dim = next(n.dim for n in t.am.spec.nodes if n.kind == "input" and n.name == "input")
    check(cfg is not None and in_dim == C + 3, "the pitch model dir does not load as a pitch model")
    for _ in range(2):
        t.transcribe_pcm_batch(pcms, **fuzzy)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.time()
    texts = t.transcribe_pcm_batch(pcms, **fuzzy)
    torch.cuda.synchronize()
    wall_ms = (time.time() - t0) * 1000.0
    launches = read_counts()
    check(launches["mfcc"] == 1 and launches["viterbi"] == 1 and launches["pitch_viterbi"] == 1,
          f"pitch batch call launches {launches}: expected one K1, one K2 and one K5")
    check(len(texts) == BATCH and all(len(x) == 1 for x in texts), f"pitch transcripts {texts[:3]}")
    print(f"pitch batch: {BATCH} x {SECONDS} s in {wall_ms:.1f} ms; launches {launches}")

    # -- the same batch through the plain twins on the card -------------------
    pcm, feat_lengths, lengths, n_out = t._pad_batch(pcms)
    feats_plain = plain_pitch(t.am._append_pitch, mfcc_batch_torch(t.am.frontend_params, pcm), pcm)
    lp_plain = t.am.log_probs(feats_plain, n_out, feat_lengths=feat_lengths)
    res = twin_decoder.viterbi_decode(t.device_graph, lp_plain, t.acoustic_scale, lengths)
    words = twin_decoder.traces_to_words_batch(t.artifacts.graph, *[r.cpu().numpy() for r in res])
    plain_texts = t._texts([[] if w is None else [(w, c)] for w, c in words], None,
                           require_fuzzy=False, **fuzzy)
    check(plain_texts == texts, "pitch: transcripts differ between the kernels and the plain twins")
    feats = t.am.features(pcm)
    check(feats.shape[2] == C + 3 and torch.equal(feats[..., C:], feats_plain[..., C:]),
          "pitch: the kernel's pitch columns differ from the twin's")
    print(f"pitch batch: transcripts equal to the plain twins' path; pitch columns {list(feats.shape)} "
          f"bit-equal; first: {texts[0]}")

    # -- K5 at the batch's shape (the tick's is held in the scheduler part) ---
    k5 = k5_numbers("batch", cfg, pcm)

    # -- the card against CPU tensors ------------------------------------------
    am_cpu = AcousticModel(pitch_dir, device="cpu")
    two = pcm[:2]
    f_dev, f_cpu = t.am.features(two).cpu(), am_cpu.features(two.cpu())
    s_dev, s_cpu = lag_states(cfg, two).cpu(), lag_states(cfg, two.cpu())
    same = s_dev == s_cpu
    err_mfcc = float((f_dev[..., :C] - f_cpu[..., :C]).abs().max())
    check(torch.allclose(f_dev[..., :C], f_cpu[..., :C], rtol=MFCC_RTOL, atol=MFCC_ATOL),
          f"pitch: MFCC columns card vs CPU max |d| {err_mfcc}")
    share = 1.0 - float(same.float().mean())
    check(share <= PITCH_LAG_SHARE, f"pitch: {share:.3f} of the frames take another lag on the card")
    # per-frame columns (POV feature, delta) on frames whose lag and whose
    # neighbours' lags agree (the delta spans +-2 frames)
    Tp = s_dev.shape[1]
    pf_dev, pf_cpu = pitch_batch(cfg, two), pitch_batch(cfg, two.cpu())
    ok = same.clone()
    for d in (-2, -1, 1, 2):
        ok &= same[:, (torch.arange(Tp) + d).clamp(0, Tp - 1)]
    err_pitch = float((pf_dev.cpu()[ok][:, [0, 2]] - pf_cpu[ok][:, [0, 2]]).abs().max())
    check(err_pitch <= PITCH_ATOL, f"pitch: POV / delta columns card vs CPU max |d| {err_pitch}")
    print(f"pitch card vs CPU tensors on 2 utterances: MFCC columns max |d| {err_mfcc:.3e}; "
          f"{share * 100:.2f}% of {same.numel()} frames take another lag; POV and delta columns on "
          f"the frames whose lags agree max |d| {err_pitch:.3e} (atol {PITCH_ATOL})")
    t_ = np.arange(16000) / 16000.0
    fixtures = [0.5 * np.sin(2 * np.pi * f0 * t_) for f0 in (80.0, 120.0, 200.0, 333.0)]
    f0 = 100.0 * np.exp(np.log(3.0) * t_)
    fixtures.append(0.5 * np.sin(2 * np.pi * np.cumsum(f0) / 16000.0))
    fx = torch.as_tensor(np.stack(fixtures).astype(np.float32))
    check(torch.equal(lag_states(cfg, fx.to(dev)).cpu(), lag_states(cfg, fx)),
          "pitch: the card's lags differ from the CPU's on the tone and sweep fixtures")
    print("pitch: lags on the tone (80-333 Hz) and sweep (100 -> 300 Hz) fixtures equal the CPU's")

    stages = stage_ms(t, pcms, fuzzy)
    print(f"pitch batch stages (ms, host clock, synchronized): {stages}; the pitch-free flagship "
          f"call's: {plain_stages}")
    SUMMARY["pitch_stage_ms"] = stages["pitch"]
    return launches, k5


def pitch_stream_part(pitch_dir, graph_dir, dev, pcms, fuzzy):
    """8 utterances streamed in STREAM_CHUNK pushes: at most one K5 launch
    a push, rows and transcripts against the same streams on CPU tensors;
    chunk ms and RTF; K5 at a push's shape. Returns (one utterance's
    launches, K5's numbers)."""
    utts = pcms[:STREAMS]
    st = Nnet3StreamTranscriber(pitch_dir, graph_dir, device=dev)
    stc = Nnet3StreamTranscriber(pitch_dir, graph_dir, device="cpu")
    C = st.am.frontend_config.num_ceps
    stream_pcm(st, utts[0], **fuzzy)  # warm-up
    texts, rows_err, lag_rows, n_rows = [], 0.0, 0, 0
    for i, pcm in enumerate(utts):
        pitch_viterbi.launches = 0
        k0 = (mfcc_batch.launches, viterbi_decode.launches)
        got, state, pushes = stream_pcm(st, pcm, **fuzzy)
        torch.cuda.synchronize()
        check(pitch_viterbi.launches <= pushes + 1 and mfcc_batch.launches - k0[0] == pushes,
              f"pitch stream {i}: {pitch_viterbi.launches} K5 launches for {pushes} pushes")
        if i == 0:
            counts = {"mfcc": mfcc_batch.launches - k0[0], "viterbi": viterbi_decode.launches - k0[1],
                      "pitch_viterbi": pitch_viterbi.launches}
        want, cstate, _ = stream_pcm(stc, pcm, **fuzzy)
        check(got == want, f"pitch stream {i}: {got} on the card, {want} on CPU tensors")
        check(state.feats.shape == cstate.feats.shape, f"pitch stream {i}: row counts differ")
        check(np.allclose(state.feats[:, :C], cstate.feats[:, :C], rtol=MFCC_RTOL, atol=MFCC_ATOL),
              f"pitch stream {i}: MFCC columns differ from the CPU's")
        d = np.abs(state.feats[:, C:] - cstate.feats[:, C:]).max(axis=1)
        lag_rows += int((d > PITCH_ATOL).sum())
        n_rows += d.shape[0]
        rows_err = max(rows_err, float(d[d <= PITCH_ATOL].max(initial=0.0)))
        texts.append(got)
    check(lag_rows <= PITCH_LAG_SHARE * n_rows,
          f"pitch streams: {lag_rows} of {n_rows} rows' pitch columns differ past {PITCH_ATOL}")
    stage_s = {}
    names = ("_extract_feats", "_upload", "_fold_ivector", "_acoustic", "_decode_chunk", "_download")
    for name in names:
        setattr(st, name, timed_stage(getattr(st, name), stage_s, name.lstrip("_")))
    _t, state, pushes = stream_pcm(st, utts[-1], **fuzzy)
    for name in names:
        delattr(st, name)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st.transcribe_pcm(utts[-1], chunk_samples=STREAM_CHUNK, **fuzzy)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    feats_ms = stage_s.pop("extract_feats") * 1000.0 / pushes
    stages = {k: round(v * 1000.0 / len(state.bps), 4) for k, v in stage_s.items()}
    print(f"pitch streams: {STREAMS} x {SECONDS} s in {STREAM_CHUNK}-sample pushes; one utterance's "
          f"launches {counts} for {-(-utts[0].shape[0] // STREAM_CHUNK)} pushes; transcripts equal "
          f"the same streams on CPU tensors ({texts[0]}); MFCC columns within rtol {MFCC_RTOL} / "
          f"atol {MFCC_ATOL}; {lag_rows} of {n_rows} rows' pitch columns past atol {PITCH_ATOL} (a "
          f"lag taken differently), the rest max |d| {rows_err:.3e}; a push's features (K1 + K5 "
          f"window) {feats_ms:.4f} ms; chunk stages (ms a chunk, synchronized) {stages}; one "
          f"{SECONDS} s stream {min(walls) * 1000:.1f} ms (min of 3; real-time factor "
          f"{min(walls) / SECONDS:.5f})")
    SUMMARY["pitch_stream_rtf"] = min(walls) / SECONDS
    window = torch.as_tensor(utts[0][None, : st._featurizer.pitch_window], device=dev)
    return counts, k5_numbers("push", st.am.pitch_config, window)


def pitch_ring_check(sched, dev):
    """One voiced stream at one push a tick: the device feature ring's rows
    (MFCC and the pitch lane's columns) against the featurizer's own rows
    on the card, within the JAX package's bound for the same comparison
    (rtol 2e-2 / atol 5e-3, tests/test_stream_ivector.py)."""
    n = int(16000 * SECONDS)
    tt = np.arange(n) / 16000.0
    phase = 2 * np.pi * np.cumsum(110.0 + 70.0 * tt / tt[-1]) / 16000.0
    pcm = (3000 * np.sin(phase) + 1500 * np.sin(2 * phase)
           + 200 * np.random.RandomState(SEED + 5).randn(n)).astype(np.float32)
    fz = sched._featurizer
    hs = fz.new_state()
    host = []
    sid = sched.open_stream()
    for off in range(0, n, STREAM_CHUNK):
        chunk = pcm[off : off + STREAM_CHUNK]
        check(sched.feed(sid, chunk) == chunk.shape[0], "the ring check's push was refused")
        sched.step()
        host.append(fz.push(hs, chunk))
    sched.finish(sid)
    host.append(fz.push(hs, np.zeros(0, np.float32), flush=True))
    for _ in range(200):
        if sched.poll(sid) is not None:
            break
        sched.step()
    want = np.concatenate([r for r in host if r.shape[0]])
    got = sched._feats_ring[sid, : want.shape[0]].cpu().numpy()
    sched.close(sid)
    err = np.abs(got - want).max(axis=0)
    check(np.allclose(got, want, rtol=2e-2, atol=5e-3),
          f"pitch: the feature ring's rows differ from the featurizer's: max |d| by column {err}")
    print(f"pitch lane: {want.shape[0]} feature-ring rows of one voiced stream at one push a tick "
          f"equal the featurizer's within rtol 2e-2 / atol 5e-3 (max |d| MFCC {err[:-3].max():.3e}, "
          f"pitch columns {err[-3:].tolist()})")


def pitch_phase(root, model_dir, graph_dir, graph, dev, pcms, fuzzy, plain_stages):
    """Phase 16: the pitch model (testing/full_width.write_pitch_model_dir,
    TDNN-F 768 x 9 over 43 inputs) on the flagship graph: batch, stream and
    the scheduler's captured device route. Returns the kernels-line
    entries."""
    t0 = time.time()
    with open(os.path.join(model_dir, "model", "phones.txt"), encoding="utf-8") as f:
        phones = SymbolTable.read_text(f)
    max_phone = max(pid for (p, pid) in phones if pid != 0 and not p.startswith("#"))
    pitch_dir = write_pitch_model_dir(
        os.path.join(root, "pitch_model"), num_pdfs=graph.num_pdfs, max_phone=max_phone,
        hidden_dim=HIDDEN, num_tdnnf_layers=LAYERS, ivector_dim=IVEC_DIM, ubm_gauss=UBM_GAUSS,
        seed=SEED + 11,
    )
    shutil.copy(os.path.join(model_dir, "model", "phones.txt"), os.path.join(pitch_dir, "model"))
    print(f"pitch model dir (TDNN-F {HIDDEN}x{LAYERS} over 40 MFCC + 3 pitch, ivector {IVEC_DIM} "
          f"over the MFCCs) written in {time.time() - t0:.1f} s")
    launches, k5 = pitch_batch_part(pitch_dir, graph_dir, dev, pcms, fuzzy, plain_stages)
    stream_counts, k5_push = pitch_stream_part(pitch_dir, graph_dir, dev, pcms, fuzzy)
    counts, probes, sched = sched_graph_part("pitch flagship", pitch_dir, graph_dir, dev, pcms, fuzzy)
    check(sched._pitch_device and counts.get("pitch_viterbi", 0) > 0,
          f"pitch: the scheduler has no pitch lane on the card ({counts})")
    check("pitch" in probes, "pitch: no tick probed the pitch lane's windows")
    cfg = sched.am.pitch_config
    k5_tick = k5_numbers("tick", cfg, probes["pitch"])
    pitch_ring_check(sched, dev)
    del sched, probes
    k5_sweep()
    tick = SUMMARY["pitch flagship"]
    print(f"pitch lane: captured tick p50 / p90 {tick['tick_p50']:.3f} / "
          f"{tick['tick_p90']:.3f} ms; pitch stream real-time factor "
          f"{SUMMARY['pitch_stream_rtf']:.5f}; batch pitch stage {SUMMARY['pitch_stage_ms']:.3f} ms; "
          f"K5 batch / tick / push {k5['ms']:.4f} / {k5_tick['ms']:.4f} / {k5_push['ms']:.4f} ms")
    entry = {"route": "cuda", "source": "rhasspy_speech_torch/csrc/pitch_viterbi.cu",
             "replaces": "rhasspy_speech_tpu/ops/pitch.py:255", "library_ms": None}
    return [
        {"name": "pitch_viterbi", "launches": launches["pitch_viterbi"], **entry, **k5},
        {"name": "pitch_viterbi_stream_push", "launches": stream_counts["pitch_viterbi"], **entry,
         **k5_push},
        {"name": "pitch_viterbi_sched_tick", "launches": counts["pitch_viterbi"], **entry, **k5_tick},
    ]


def linked_copy(src, dst, frontend=None):
    """A model dir at ``dst`` whose files link to ``src``'s, with
    ``model/frontend.json`` rewritten with ``frontend``'s keys when given."""
    for sub in ("model", "extractor"):
        if os.path.isdir(os.path.join(src, sub)):
            os.makedirs(os.path.join(dst, sub))
            for name in os.listdir(os.path.join(src, sub)):
                os.symlink(os.path.join(src, sub, name), os.path.join(dst, sub, name))
    shutil.copy(os.path.join(src, "config.json"), dst)
    if frontend is not None:
        path = os.path.join(dst, "model", "frontend.json")
        with open(path, encoding="utf-8") as f:
            cfg = json.load(f)
        os.unlink(path)
        with open(path, "w", encoding="utf-8") as f:
            json.dump({**cfg, **frontend}, f)
    return dst


def plain_texts_of(t, pcms, fuzzy):
    """The batch through the plain twins on the card: features by the MFCC
    twin, the same AM, the plain Viterbi decode."""
    pcm, feat_lengths, lengths, n_out = t._pad_batch(pcms)
    feats_plain = mfcc_batch_torch(t.am.frontend_params, pcm, t.am.dither_noise(pcm))
    lp_plain = t.am.log_probs(feats_plain, n_out, feat_lengths=feat_lengths)
    res = twin_decoder.viterbi_decode(t.device_graph, lp_plain, t.acoustic_scale, lengths)
    words = twin_decoder.traces_to_words_batch(t.artifacts.graph, *[r.cpu().numpy() for r in res])
    return t._texts([[] if w is None else [(w, c)] for w, c in words], None,
                    require_fuzzy=False, **fuzzy)


def counted_batch(t, pcms, fuzzy, what):
    """Two warm-up calls, then one counted call: (transcripts, wall ms,
    launches), requiring one K1 and one K2 launch."""
    for _ in range(2):
        t.transcribe_pcm_batch(pcms, **fuzzy)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    texts = t.transcribe_pcm_batch(pcms, **fuzzy)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1000.0
    launches = read_counts()
    check(launches["mfcc"] == 1 and launches["viterbi"] == 1,
          f"{what}: launches {launches}, expected one K1 and one K2")
    check(len(texts) == len(pcms) and all(len(x) == 1 for x in texts), f"{what}: {texts[:3]}")
    return texts, wall_ms, launches


def batch_kernel_numbers(t, pcms, what):
    """K1 and K2 on this batch call's own inputs against their plain
    versions, timed, with their bounds."""
    pcm, feat_lengths, lengths, n_out = t._pad_batch(pcms)
    params = t.am.frontend_params
    noise = t.am.dither_noise(pcm)
    feats = mfcc_batch(params, pcm, noise)
    want = mfcc_batch_torch(params, pcm, noise)
    torch.cuda.synchronize()
    err = float((feats - want).abs().max())
    check(torch.allclose(feats, want, rtol=MFCC_RTOL, atol=MFCC_ATOL),
          f"{what}: mfcc kernel vs twin max |d| {err}")
    k1 = {"ms": cuda_ms(lambda: mfcc_batch(params, pcm, noise)),
          "plain_ms": cuda_ms(lambda: mfcc_batch_torch(params, pcm, noise)), "max_abs_err": err}
    nbytes, nops = mfcc_work(params, *pcm.shape, feats.shape[1])
    noise_bytes = 0 if noise is None else 4 * noise.numel()
    k1["bound_ms"], k1["bound_by"] = bound(nbytes + noise_bytes, nops + 2 * noise_bytes // 4)
    lp = t.am.log_probs(feats, n_out, feat_lengths=feat_lengths)
    g = t.device_graph
    got = viterbi_decode(g, lp, t.acoustic_scale, lengths, return_forward=True)
    compact = g.num_arcs <= twin_decoder._COMPACT_BP_MAX_ARC
    alpha, bps = twin_decoder.viterbi(g, lp, t.acoustic_scale, lengths, compact_bp=compact)
    want2 = twin_decoder.backtrace(g, alpha, bps) + (alpha, bps)
    torch.cuda.synchronize()
    check(decode_outputs_equal(got, want2), f"{what}: viterbi kernel differs from its twin")
    k2 = {"ms": cuda_ms(lambda: viterbi_decode(g, lp, t.acoustic_scale, lengths)),
          "plain_ms": cuda_ms(lambda: twin_decoder.viterbi(g, lp, t.acoustic_scale, lengths,
                                                           compact_bp=compact), iters=3),
          "max_abs_err": float((got[3] - want2[3]).abs().max())}
    k2["bound_ms"], k2["bound_by"] = bound(*viterbi_work(g, *lp.shape, lengths))
    print(f"{what}: K1 {list(pcm.shape)} -> {list(feats.shape)}"
          f"{'' if noise is None else ' with noise ' + str(list(noise.shape))}: max |d| {err:.3e}, "
          f"kernel {k1['ms']:.4f} ms, plain {k1['plain_ms']:.4f} ms, bound {k1['bound_ms']:.4f} ms "
          f"({k1['bound_by']}); K2 {list(lp.shape)}: bit-equal, kernel {k2['ms']:.4f} ms, plain "
          f"{k2['plain_ms']:.4f} ms, bound {k2['bound_ms']:.4f} ms ({k2['bound_by']})")
    return k1, k2


def am_inputs(t, pcms):
    """The batch's AM inputs at its bucket: (model, windows, i-vectors)."""
    pcm, feat_lengths, _lengths, n_out = t._pad_batch(pcms)
    feats = t.am.features(pcm)
    model = t.am.compiled(n_out)
    lo, hi = model.ranges["input"]
    idx = cached_index(np.clip(np.arange(lo, hi), 0, feats.shape[1] - 1), feats.device)
    ivec = extract_ivectors(feats[..., : t.am.frontend_config.num_ceps], t.am.ivector_params,
                            lengths=feat_lengths)
    return model, feats[:, idx].contiguous(), ivec


def device_busy(fn):
    """One call of ``fn`` under torch.profiler, tracing the card alone:
    (device events, their summed device ms, the call's wall ms), or None
    where the trace holds no device event. The events are read from the
    raw trace: parsing it into ``prof.events()`` took ~15 s of host time
    for a TDNN-LSTM forward's 15,239 kernels."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1000.0
    evs = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_user_annotation()]
    if not evs:
        return None
    return len(evs), sum(e.duration_ns() for e in evs) / 1e6, wall


def am_inputs_call(t, pcms, _cache={}):
    """One AM forward of the batch's bucket (inputs made once a model)."""
    key = id(t)
    if key not in _cache:
        _cache[key] = am_inputs(t, pcms)
    model, x, ivec = _cache[key]
    return model(x, ivec)


def am_ms(t, pcms, iters=5):
    """The AM forward of the batch's bucket: (CUDA-event ms, host-clock ms
    of one call ended by a synchronize)."""
    model, x, ivec = am_inputs(t, pcms)
    ev = cuda_ms(lambda: model(x, ivec), iters=iters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model(x, ivec)
    torch.cuda.synchronize()
    return ev, (time.perf_counter() - t0) * 1000.0


def within_bf16_bounds(out16, out32, what):
    """tests/test_bf16.py's bounds: |d| <= 5% of the f32 spread, the argmax
    equal on >= 90% of the rows, flips only where the f32 gap is within the
    same bound. Returns (max |d|, spread, agreement)."""
    spread = float(out32.max() - out32.min())
    delta = float((out16 - out32).abs().max())
    top32, top16 = out32.argmax(-1), out16.argmax(-1)
    agree = float((top32 == top16).float().mean())
    flipped = top32 != top16
    gap = 0.0
    if bool(flipped.any()):
        picked = torch.gather(out32, -1, top16[..., None])[..., 0]
        gap = float((out32.max(-1).values - picked)[flipped].max())
    check(delta <= BF16_SPREAD_SHARE * spread and agree >= BF16_MIN_AGREE
          and gap <= BF16_SPREAD_SHARE * spread,
          f"{what}: bf16 log-probs |d| {delta} of spread {spread}, argmax agreement {agree}, "
          f"largest flipped gap {gap}")
    return delta, spread, agree


def lstm_matches_cpu(lp_dev, lp_cpu):
    """The TDNN-LSTM's card log-probs within LSTM_CPU_RTOL / LSTM_CPU_ATOL
    of the CPU's."""
    return torch.allclose(lp_dev.cpu(), lp_cpu, rtol=LSTM_CPU_RTOL, atol=LSTM_CPU_ATOL)


def tdnn_lstm_batch_part(lstm_dir, graph_dir, dev, pcms, fuzzy):
    """The TDNN-LSTM batch call: counted (one K1, one K2), transcripts equal
    to the plain twins' path, K1 and K2 on its inputs, log-probs against
    CPU tensors on 2 utterances, the AM timed by CUDA events and host
    clock, the call's stages. Returns (the transcriber, launches, K1's and
    K2's numbers, the CPU's log-probs of the 2 utterances)."""
    t = Nnet3WavTranscriber(lstm_dir, graph_dir, device=dev)
    texts, wall_ms, launches = counted_batch(t, pcms, fuzzy, "TDNN-LSTM batch")
    check(plain_texts_of(t, pcms, fuzzy) == texts,
          "TDNN-LSTM: transcripts differ between the kernels and the plain twins")
    k1, k2 = batch_kernel_numbers(t, pcms, "TDNN-LSTM batch")
    # one CPU forward: its transcripts, and the log-probs it decoded
    tc = Nnet3WavTranscriber(lstm_dir, graph_dir, device="cpu")
    kept = []
    acoustic = tc._acoustic_batch

    def keep(batch):
        out = acoustic(batch)
        kept.append(out[0])
        return out

    tc._acoustic_batch = keep
    check(tc.transcribe_pcm_batch(pcms[:2], **fuzzy) == texts[:2],
          "TDNN-LSTM: CPU tensors transcribe differently")
    lp_cpu = kept[0]
    lp_dev, _ = t._acoustic_batch(pcms[:2])
    err = float((lp_dev.cpu() - lp_cpu).abs().max())
    check(lstm_matches_cpu(lp_dev, lp_cpu), f"TDNN-LSTM log-probs, card vs CPU: max |d| {err}")
    model, x, iv = am_inputs(t, pcms)
    ev, host = am_ms(t, pcms, iters=3)
    busy = device_busy(lambda: model(x, iv))
    busy_text = ("not measured (no device events in the trace)" if busy is None else
                 f"{busy[0]} device events ({busy[0] / model.plan.num_out_frames:.1f} a step), "
                 f"{busy[1]:.3f} ms of device time in a {busy[2]:.3f} ms call (idle share "
                 f"{1.0 - busy[1] / busy[2]:.3f})")
    stages = stage_ms(t, pcms, fuzzy)
    print(f"TDNN-LSTM batch: {BATCH} x {SECONDS} s in {wall_ms:.1f} ms; launches {launches}; "
          f"transcripts equal to the plain twins' path; log-probs [2, {lp_dev.shape[1]}, "
          f"{lp_dev.shape[2]}] card vs CPU max |d| {err:.3e} (rtol {LSTM_CPU_RTOL} / atol "
          f"{LSTM_CPU_ATOL}), transcripts equal; AM forward of the bucket "
          f"({model.plan.num_out_frames} recurrent steps, batch {BATCH}): {ev:.3f} ms by CUDA "
          f"events, {host:.3f} ms host clock; torch.profiler: {busy_text}; stages (ms, "
          f"synchronized): {stages}")
    SUMMARY["lstm_batch_ms"], SUMMARY["lstm_am_ms"] = wall_ms, (ev, host)
    return t, launches, k1, k2, lp_cpu


def tdnn_lstm_stream_part(root, lstm_dir, graph_dir, dev, pcms, fuzzy):
    """One stream of the TDNN-LSTM: counted (one K1 a push, one K2 a
    chunk); on a copy without the extractor (both paths read a zero
    i-vector) the chunks' log-probs equal the whole utterance's forward;
    the stream's real-time factor with the extractor. Returns the counts."""
    bare = linked_copy(lstm_dir, os.path.join(root, "lstm_no_extractor"))
    shutil.rmtree(os.path.join(bare, "extractor"))
    st = Nnet3StreamTranscriber(bare, graph_dir, device=dev)
    check(st._chunk_model.recurrent and st._ivp is None, "TDNN-LSTM stream: expected a bare "
          "recurrent model")
    stream_pcm(st, pcms[0], **fuzzy)
    chunks = []
    decode = st._decode_chunk

    def keep(state, log_probs, n_valid):
        chunks.append(log_probs[0, :n_valid].clone())
        return decode(state, log_probs, n_valid)

    st._decode_chunk = keep
    zero_counts()
    _texts, state, pushes = stream_pcm(st, pcms[0], **fuzzy)
    torch.cuda.synchronize()
    counts = read_counts()
    del st._decode_chunk
    check(counts["mfcc"] == pushes and counts["viterbi"] == len(chunks) == len(state.bps),
          f"TDNN-LSTM stream launches {counts} for {pushes} pushes and {len(chunks)} chunks")
    got = torch.cat(chunks)
    T = state.feats.shape[0]
    whole = st.am.log_probs(torch.as_tensor(state.feats[None], device=dev), -(-T // 3))[0]
    err = float((got - whole).abs().max())
    check(got.shape == whole.shape and torch.allclose(got, whole, rtol=LSTM_STREAM_TOL,
                                                      atol=LSTM_STREAM_TOL),
          f"TDNN-LSTM stream: chunked log-probs vs whole max |d| {err}")
    st_iv = Nnet3StreamTranscriber(lstm_dir, graph_dir, device=dev)
    st_iv.transcribe_pcm(pcms[5], chunk_samples=STREAM_CHUNK, **fuzzy)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st_iv.transcribe_pcm(pcms[5], chunk_samples=STREAM_CHUNK, **fuzzy)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    rtf = min(walls) / SECONDS
    print(f"TDNN-LSTM stream: {pushes} pushes, {len(chunks)} chunks, launches {counts}; chunked "
          f"log-probs {list(got.shape)} equal to the whole utterance's forward, max |d| {err:.3e} "
          f"(atol {LSTM_STREAM_TOL}); with the extractor one {SECONDS} s stream "
          f"{min(walls) * 1000:.1f} ms (min of 3; real-time factor {rtf:.5f})")
    SUMMARY["lstm_stream_rtf"] = rtf
    return counts


def tdnn_lstm_phase(root, model_dir, graph_dir, graph, dev, pcms, fuzzy):
    """Phase 17: the TDNN-LSTM chain model (testing/full_width.
    write_tdnn_lstm_model_dir at run_tdnn_lstm_1e.sh's widths) on the
    flagship graph: batch, stream and the scheduler's captured device route.
    Returns (kernels-line entries, the f32 batch transcriber, the CPU's
    log-probs of 2 utterances)."""
    t0 = time.time()
    with open(os.path.join(model_dir, "model", "phones.txt"), encoding="utf-8") as f:
        phones = SymbolTable.read_text(f)
    max_phone = max(pid for (p, pid) in phones if pid != 0 and not p.startswith("#"))
    lstm_dir = write_tdnn_lstm_model_dir(
        os.path.join(root, "lstm_model"), num_pdfs=graph.num_pdfs, max_phone=max_phone,
        ivector_dim=IVEC_DIM, ubm_gauss=UBM_GAUSS, seed=SEED + 13)
    shutil.copy(os.path.join(model_dir, "model", "phones.txt"), os.path.join(lstm_dir, "model"))
    print(f"TDNN-LSTM model dir (cell {TDNN_LSTM_CELL}, projections {TDNN_LSTM_PROJ} + "
          f"{TDNN_LSTM_PROJ}, TDNN {TDNN_LSTM_DIM}, delay -3, ivector {IVEC_DIM}) written in "
          f"{time.time() - t0:.1f} s")
    with phase("tdnn-lstm batch"):
        t, launches, k1, k2, lp_cpu = tdnn_lstm_batch_part(lstm_dir, graph_dir, dev, pcms, fuzzy)
    with phase("tdnn-lstm stream"):
        stream_counts = tdnn_lstm_stream_part(root, lstm_dir, graph_dir, dev, pcms, fuzzy)
    with phase("tdnn-lstm scheduler"):
        counts, _probes, sched = sched_graph_part("tdnn_lstm", lstm_dir, graph_dir, dev, pcms,
                                                  fuzzy, host_feats=True)
    rec = sched._st.rec
    check(sched._recurrent and set(rec) == set(sched._chunk_model.plan.carried),
          "TDNN-LSTM scheduler: no recurrence rows in the tick state")
    buckets_against_all_slots("tdnn_lstm", sched, pcms)
    k4 = path_walk_numbers("tdnn_lstm", sched, dev)
    print(f"TDNN-LSTM scheduler: recurrence rows {[list(v.shape) for v in rec.values()]}; K1 "
          f"{counts['mfcc']} launches in the host featurizer (the AM window ends at input frame "
          f"{sched._win_hi}, short of the i-vector tap's {sched._chunk_in + sched._ivp.splice_right}: "
          f"features stay on the host), K2 and K4 in the captured body; stream launches "
          f"{stream_counts}")
    del sched
    entry = {"route": "cuda", "library_ms": None}
    k1_src = {"source": "rhasspy_speech_torch/csrc/mfcc.cu",
              "replaces": "rhasspy_speech_tpu/ops/pallas_mfcc.py:122"}
    k2_src = {"source": "rhasspy_speech_torch/csrc/viterbi.cu",
              "replaces": "rhasspy_speech_tpu/ops/pallas_decoder.py:370"}
    return [
        {"name": "mfcc_tdnn_lstm", "launches": launches["mfcc"], **entry, **k1_src, **k1},
        {"name": "viterbi_tdnn_lstm", "launches": launches["viterbi"], **entry, **k2_src, **k2},
        {"name": "path_walk_tdnn_lstm_sched_tick", "launches": counts["path_walk"], **entry,
         "source": "rhasspy_speech_torch/csrc/path_walk.cu",
         "replaces": "rhasspy_speech_tpu/pipeline/scheduler.py:838", **k4},
    ], t, lp_cpu


def bf16_sched_part(model_dir, graph_dir, dev, pcms, fuzzy):
    """The flagship's scheduler at 32 slots in bf16, captured: counted,
    every replay bit-equal to the eager body, transcripts against the f32
    scheduler's, tick times."""
    sched = StreamScheduler(model_dir, graph_dir, max_streams=BATCH, device=dev,
                            compute_dtype="bfloat16", **fuzzy)
    check(sched._bf16 and sched._device_bp and sched._device_feats,
          "bf16 scheduler: not a bf16 AM on the device route")
    sched_run(sched, pcms)
    runner = sched._runner
    runner.launches = dict.fromkeys(runner.launches, 0)
    n_checks = len(runner.checks)

    def on_tick():
        runner.check_next = True

    runner.check_next = True
    texts, ticks, _wall = sched_run(sched, pcms, on_tick)
    runner.check_next = False
    torch.cuda.synchronize()
    counts = sched.kernel_launches
    checks = runner.checks[n_checks:]
    check(all(counts[k] > 0 for k in ("mfcc", "viterbi", "path_walk")),
          f"bf16 scheduler: launches {counts}")
    check(checks and all(all(eq.values()) for _k, eq in checks),
          "bf16 scheduler: a replay differs from the eager tick body")
    f32 = StreamScheduler(model_dir, graph_dir, max_streams=BATCH, device=dev, **fuzzy)
    f32_texts, _t, _w = sched_run(f32, pcms)
    same = sum(a == b for a, b in zip(texts, f32_texts))
    p50, p90 = tick_ms(sched_run(sched, pcms)[1])
    print(f"bf16 scheduler (flagship, {BATCH} slots, captured): launches {counts}; {len(checks)} "
          f"replays bit-equal to the eager body; {same} of {BATCH} transcripts equal the f32 "
          f"scheduler's (random weights on noise); tick p50 {p50:.3f} p90 {p90:.3f} ms (host clock)")
    return counts


def bf16_phase(root, model_dir, lstm32, lstm_cpu, graph_dir, dev, pcms, fuzzy):
    """Phase 18: compute_dtype="bfloat16" on the flagship's batch call
    (counted; log-probs within tests/test_bf16.py's bounds of f32) and its
    captured tick, the AM forward in bf16 and f32 by CUDA events (flagship
    and TDNN-LSTM, whose batch forward also stays within the bounds, and
    outside phase 17's card-vs-CPU bound of ``lstm_cpu``, the CPU's f32
    log-probs of 2 utterances; ``lstm32`` is phase 17's f32 transcriber),
    and the synthetic speech profile's transcripts equal to f32's."""
    t32 = Nnet3WavTranscriber(model_dir, graph_dir, device=dev)
    t16 = Nnet3WavTranscriber(model_dir, graph_dir, device=dev, compute_dtype="bfloat16")
    texts16, _wall, launches16 = counted_batch(t16, pcms, fuzzy, "bf16 batch")
    texts32 = t32.transcribe_pcm_batch(pcms, **fuzzy)
    walls = {}
    for _ in range(3):  # in turns, host clock, each call synchronized
        for name, tt in (("f32", t32), ("bf16", t16)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tt.transcribe_pcm_batch(pcms, **fuzzy)
            torch.cuda.synchronize()
            walls.setdefault(name, []).append((time.perf_counter() - t0) * 1000.0)
    lp32, _ = t32._acoustic_batch(pcms)
    lp16, _ = t16._acoustic_batch(pcms)
    check(lp16.dtype == torch.float32, "bf16 log-probs must come back in f32")
    delta, spread, agree = within_bf16_bounds(lp16, lp32, "flagship")
    same = sum(a == b for a, b in zip(texts16, texts32))
    times = {}
    for name, a32 in (("flagship", t32), ("tdnn_lstm", lstm32)):
        a16 = t16 if name == "flagship" else Nnet3WavTranscriber(
            lstm32.model_dir, graph_dir, device=dev, compute_dtype="bfloat16")
        # CUDA events in turns (f32, bf16, bf16, f32), then each forward's
        # device time from the profiler: a host-bound forward's events time
        # the host's dispatch, the trace the card's own work. The
        # TDNN-LSTM's forward takes ~0.35 s: one timed call a turn
        ev = {"f32": [], "bf16": []}
        for dt, a in (("f32", a32), ("bf16", a16), ("bf16", a16), ("f32", a32)):
            ev[dt].append(am_ms(a, pcms, iters=3 if name == "flagship" else 1)[0])
        busy = {dt: device_busy(lambda a=a: am_inputs_call(a, pcms))
                for dt, a in (("f32", a32), ("bf16", a16))}
        times[name] = {dt: (round(min(ev[dt]), 4),
                            "not measured" if busy[dt] is None else round(busy[dt][1], 4))
                       for dt in ev}
        if name == "tdnn_lstm":
            lstm16, _ = a16._acoustic_batch(pcms[:4])
            lstm32, _ = a32._acoustic_batch(pcms[:4])
            lstm_bounds = within_bf16_bounds(lstm16, lstm32, "TDNN-LSTM")
            lstm16_2, _ = a16._acoustic_batch(pcms[:2])
            cpu_d = float((lstm16_2.cpu() - lstm_cpu).abs().max())
            check(not lstm_matches_cpu(lstm16_2, lstm_cpu),
                  f"the TDNN-LSTM card-vs-CPU bound passes a bf16 forward (max |d| {cpu_d})")
    print(f"bf16 batch (flagship): {BATCH} x {SECONDS} s, calls in turns (ms, host clock) "
          f"f32 {[round(w, 2) for w in walls['f32']]} bf16 {[round(w, 2) for w in walls['bf16']]}; "
          f"launches "
          f"{launches16}; log-probs max |d| {delta:.4f} of an f32 spread {spread:.2f}, argmax "
          f"agreement {agree:.4f}; {same} of {BATCH} transcripts equal f32's (random weights on "
          f"noise); TDNN-LSTM bf16 on 4 utterances: |d| {lstm_bounds[0]:.4f} of {lstm_bounds[1]:.2f}, "
          f"agreement {lstm_bounds[2]:.4f}, against the CPU's f32 max |d| {cpu_d:.4f} (outside "
          f"phase 17's atol {LSTM_CPU_ATOL}); AM forward (ms: CUDA events, min of 2 in turns; "
          f"device time by torch.profiler): {times}")
    SUMMARY["am_f32_bf16"] = times
    with phase("bf16 scheduler"):
        counts = bf16_sched_part(model_dir, graph_dir, dev, pcms, fuzzy)
    # the synthetic speech profile: bf16 transcripts equal f32's and the
    # spoken sentences, batch and scheduler
    profile, sgraph = trained_speech_profile(root)
    speech = [synthesize_sentence(profile, text, seed=SEED + 60 + i)
              for i, text in enumerate(SPEECH_TEXTS)]
    spoken = [[x] for x in SPEECH_TEXTS]
    got = {}
    for dt in (None, "bfloat16"):
        tb = Nnet3WavTranscriber(profile.model_dir, sgraph, device=dev, compute_dtype=dt)
        s = StreamScheduler(profile.model_dir, sgraph, max_streams=len(speech), device=dev,
                            compute_dtype=dt)
        got[dt] = (tb.transcribe_pcm_batch(speech), sched_run(s, speech)[0])
    check(got["bfloat16"] == got[None] == (spoken, spoken),
          f"synthetic profile: bf16 transcripts {got['bfloat16']} vs f32 {got[None]}")
    print(f"bf16 on the synthetic speech profile: {len(speech)} sentences, batch and scheduler "
          f"transcripts equal f32's and the spoken sentences")
    return launches16, counts


def dither_phase(root, model_dir, graph_dir, dev, pcms, fuzzy):
    """Phase 19: the flagship with --dither=1.0: the batch call counted (K1
    with the call's noise), two calls differ, K1 with noise against its twin
    with the same noise; the stream's and the tick's feature rows and the
    synthetic Coqui profile's probs equal the undithered ones. Returns the
    kernels-line entry."""
    dith = linked_copy(model_dir, os.path.join(root, "dither_model"), {"dither": 1.0})
    t = Nnet3WavTranscriber(dith, graph_dir, device=dev)
    check(t.am.frontend_config.dither == 1.0, "the dithered model dir does not dither")
    texts, wall_ms, launches = counted_batch(t, pcms, fuzzy, "dithered batch")
    pcm = t._pad_batch(pcms[:2])[0]
    check(not torch.allclose(t.am.features(pcm), t.am.features(pcm)),
          "two dithered calls gave the same features")
    check(plain_texts_of(Nnet3WavTranscriber(dith, graph_dir, device=dev), pcms, fuzzy)
          == Nnet3WavTranscriber(dith, graph_dir, device=dev).transcribe_pcm_batch(pcms, **fuzzy),
          "dithered: a fresh transcriber's kernels and plain twins transcribe differently")
    k1, _k2 = batch_kernel_numbers(t, pcms, "dithered batch")
    pcm = t._pad_batch(pcms)[0]
    plain_k1 = cuda_ms(lambda: mfcc_batch(t.am.frontend_params, pcm))
    # the other routes run undithered
    st = {d: Nnet3StreamTranscriber(d, graph_dir, device=dev) for d in (model_dir, dith)}
    rows = {d: stream_pcm(s, pcms[0], **fuzzy)[1].feats for d, s in st.items()}
    check(np.array_equal(rows[model_dir], rows[dith]), "dithered stream rows differ")
    ring = {}
    for d in (model_dir, dith):
        s = StreamScheduler(d, graph_dir, max_streams=2, device=dev, **fuzzy)
        check(s._device_feats, "dither: the scheduler should keep features on the device")
        sched_run(s, pcms[:2])
        ring[d] = s._st.feats_ring.clone()
    check(torch.equal(ring[model_dir], ring[dith]), "dithered tick feature rings differ")
    profile, train_dir = trained_ctc_profile(root)
    fj = os.path.join(profile.model_dir, "frontend.json")
    with open(fj, encoding="utf-8") as f:
        cfg = json.load(f)
    speech = synthesize_ctc_text(profile, COQUI_TEXTS[0], seed=SEED + 70)
    probs = {}
    for d in (0.0, 1.0):
        with open(fj, "w", encoding="utf-8") as f:
            json.dump({**cfg, "dither": d}, f)
        c = CoquiSttTranscriber(profile.model_dir, train_dir, device=dev)
        check(c.frontend_config.dither == d, "the Coqui frontend did not read its dither")
        probs[d] = c.compute_probs(speech)
    with open(fj, "w", encoding="utf-8") as f:
        json.dump(cfg, f)
    check(np.array_equal(probs[0.0], probs[1.0]), "dithered Coqui probs differ")
    print(f"dithered batch (flagship, --dither=1.0): {BATCH} x {SECONDS} s in {wall_ms:.1f} ms; "
          f"launches {launches}; two calls' features differ; a fresh transcriber's kernels and "
          f"plain twins transcribe alike; K1 with noise {k1['ms']:.4f} ms against {plain_k1:.4f} "
          f"without (CUDA events); stream rows, tick feature rings and Coqui probs equal the "
          f"undithered ones")
    return {"name": "mfcc_dither", "route": "cuda", "source": "rhasspy_speech_torch/csrc/mfcc.cu",
            "replaces": "rhasspy_speech_tpu/ops/pallas_mfcc.py:122", "library_ms": None,
            "launches": launches["mfcc"], **k1}


def all_types_phase(dev):
    """Phase 20: testing/component_graph.py's graph (every component type
    the port forwards, on a branch of its own) on the card against the port
    on CPU tensors."""
    spec = build_all_components_spec(seed=SEED + 5)
    T, B = 64, 8
    md = compile_nnet3(spec, T, subsampling=1, device=dev)
    mc = compile_nnet3(spec, T, subsampling=1, device="cpu")
    lo, hi = md.ranges["input"]
    x = torch.as_tensor(np.random.RandomState(SEED + 6).randn(B, hi - lo, COMPONENT_INPUT_DIM)
                        .astype(np.float32))
    got = md(x.to(dev)).cpu()
    want = mc(x)
    err = float((got - want).abs().max())
    check(got.shape == want.shape and bool(torch.isfinite(got).all())
          and torch.allclose(got, want, rtol=ALL_TYPES_TOL, atol=ALL_TYPES_TOL),
          f"all-types graph, card vs CPU: max |d| {err}")
    types = {c.type for n, c in spec.components.items() if n.startswith("comp")}
    check(types == SUPPORTED_COMPONENTS, "the all-types graph misses a type")
    print(f"all-types graph: {len(types)} component types, [{B}, {hi - lo}, "
          f"{COMPONENT_INPUT_DIM}] -> {list(got.shape)}, card vs CPU max |d| {err:.3e} "
          f"(rtol / atol {ALL_TYPES_TOL})")

WIRES = ("i16", "mulaw", "adpcm")
# of the 8 speech sentences, how many must decode to themselves over the
# lossy wire: every one on mu-law; on ADPCM "turn off light never mind" (a
# CPU run at this seed) loses its tail, as the batch path does on the same
# decoded audio
WIRE_MIN_SPOKEN = {"mulaw": 8, "adpcm": 7}
ODD_FRAME_MS = 25.0625  # 401 samples at 16 kHz
CLI_CHUNK = 21 * 160  # the warm drive's feed: a 7-frame chunk's audio

# The second and third processes of phase 23: construct the transcriber and
# the scheduler from the files given (warm from the manifest, if there is
# one of their configuration), serve the WAVs once, and report the time to
# the first transcript from the process's start and what the first calls
# added to the counters of utils/warmup.py; with "save", then run the CLI's
# warmup, which writes the manifest.
_SERVE_PROCESS = """
import time
t_start = time.time()
import contextlib, io, json, sys
repo, model_dir, graph_dir, wavs, save = sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4:-1], sys.argv[-1]
sys.path.insert(0, repo)
import numpy as np
import torch
from rhasspy_speech_torch import Nnet3WavTranscriber, cli
from rhasspy_speech_torch.pipeline.scheduler import StreamScheduler
from rhasspy_speech_torch.pipeline.transcribe import read_wav
from rhasspy_speech_torch.utils.warmup import counters
pcms = [read_wav(w) for w in wavs]
out = {}
t0 = time.time()
t = Nnet3WavTranscriber(model_dir, graph_dir)
out["construct_s"] = time.time() - t0
c0 = counters(t)
t0 = time.time()
out["texts"] = t.transcribe_pcm_batch(pcms)
torch.cuda.synchronize()
out["first_call_ms"] = (time.time() - t0) * 1000.0
out["ttft_s"] = time.time() - t_start
c1 = counters(t)
out["batch_added"] = {k: c1[k] - c0[k] for k in c0}
t0 = time.time()
t.transcribe_pcm_batch(pcms)
torch.cuda.synchronize()
out["second_call_ms"] = (time.time() - t0) * 1000.0
t0 = time.time()
s = StreamScheduler(model_dir, graph_dir, max_streams=len(pcms))
out["sched_construct_s"] = time.time() - t0
c0 = counters(s)
sids = [s.open_stream() for _ in pcms]
t0 = time.time()
for off in range(0, max(p.shape[0] for p in pcms), %(chunk)d):
    for sid, p in zip(sids, pcms):
        if off < p.shape[0]:
            s.feed(sid, p[off : off + %(chunk)d])
    s.step()
for sid in sids:
    s.finish(sid)
s.run_until_idle()
out["sched_texts"] = [s.poll(sid) for sid in sids]
torch.cuda.synchronize()
out["sched_serve_ms"] = (time.time() - t0) * 1000.0
c1 = counters(s)
out["sched_added"] = {k: c1[k] - c0[k] for k in c0}
out["captures"] = c1["captures"]
del s
if save == "save":
    t0 = time.time()
    with contextlib.redirect_stdout(io.StringIO()) as said:
        rc = cli.main(["warmup", "--model-dir", model_dir, "--graph-dir", graph_dir,
                       "--batch", str(len(pcms)), "--seconds", str(pcms[0].shape[0] / 16000.0),
                       "--streams", str(len(pcms))])
    out["warmup_rc"], out["warmup_said"] = rc, said.getvalue().strip()
    out["warmup_s"] = time.time() - t0
out["imported"] = sorted(m for m in sys.modules if m.partition(".")[0] in ("jax", "jaxlib", "rhasspy_speech_tpu"))
print(json.dumps(out))
""" % {"chunk": CLI_CHUNK}


def wire_decoded(wire, pcm):
    """``pcm`` as the wire carries it: through the NumPy codec and back."""
    if wire == "mulaw":
        return mulaw_codec.decode_u8(mulaw_codec.encode_f32(pcm))
    n = pcm.shape[0]
    samples = np.zeros((1, -(-n // 160) * 160), dtype=np.float32)
    samples[0, :n] = pcm
    out = np.zeros((1, samples.shape[1] // 160 * block_bytes(160)), dtype=np.uint8)
    adpcm_codec.encode_blocks(samples, np.array([n]), 160, out)  # reconstructions in place
    return samples[0, :n]


def adpcm_numbers(wire_bytes):
    """K6 on the tick's probed wire bytes and on a saturating probe of the
    same shape against its twin (bit-equal), timed by device time beside the
    twin, with its bound: the bytes read, the f32 samples written; a dozen
    integer operations a decoded sample."""
    block = 160
    got = adpcm_decode(wire_bytes, block)
    want = decode_blocks_torch(wire_bytes, block)
    N, nb = wire_bytes.shape[0], wire_bytes.shape[1] // block_bytes(block)
    sat = torch.as_tensor(saturating_wire(N, nb, block, seed=SEED), device=wire_bytes.device)
    sat_got, sat_want = adpcm_decode(sat, block), decode_blocks_torch(sat, block)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "ADPCM decode kernel differs from its twin at the tick's shape")
    check(torch.equal(sat_got, sat_want), "ADPCM decode kernel differs from its twin on the "
          "saturating probe")
    check(float(sat_want.max()) == 32767.0 and float(sat_want.min()) == -32768.0,
          "the saturating probe missed a rail")
    out = {"ms": device_ms(lambda: adpcm_decode(wire_bytes, block)),
           "plain_ms": cuda_ms(lambda: decode_blocks_torch(wire_bytes, block), iters=3),
           "max_abs_err": float((got - want).abs().max())}
    out["bound_ms"], out["bound_by"] = bound(wire_bytes.numel() + 4 * got.numel(),
                                             12 * N * nb * (block - 1))
    print(f"K6 adpcm_decode (a warp scan a block) at the tick's shape {list(wire_bytes.shape)} bytes "
          f"({N} x {nb} blocks of {block_bytes(block)}) -> {list(got.shape)} f32: bit-equal to its "
          f"twin there and on a saturating probe of that shape; kernel {out['ms']:.4f} ms of device "
          f"time, plain "
          f"{out['plain_ms']:.4f} ms, bound {out['bound_ms']:.6f} ms ({out['bound_by']})")
    return out


def wire_part(wire, model_dir, graph_dir, dev, pcms, fuzzy):
    """The flagship scheduler at 32 slots on ``wire``, captured: a warm-up
    run, a counted run with every replay held bit-equal to the eager body
    (the ADPCM wire's bytes probed), then a timed run. Returns (launches,
    probed wire bytes or None, transcripts, tick ms p50 / p90)."""
    sched = StreamScheduler(model_dir, graph_dir, max_streams=BATCH, device=dev, wire=wire, **fuzzy)
    check(sched._device_feats and sched._wire == wire, f"wire {wire}: not on the fused route")
    sched_run(sched, pcms)
    runner, probe = sched._runner, {}

    def on_tick():
        p = sched._tick.probe
        if p and "adpcm_decode" in p:
            probe.setdefault("wire", p["adpcm_decode"])
        sched._tick.probe = {}
        runner.check_next = True

    sched._tick.probe = {}
    runner.check_next = True
    zero_counts()
    runner.launches = dict.fromkeys(runner.launches, 0)
    n_checks = len(runner.checks)
    texts, ticks, _wall = sched_run(sched, pcms, on_tick)
    sched._tick.probe, runner.check_next = None, False
    torch.cuda.synchronize()
    counts = sched.kernel_launches
    checks = runner.checks[n_checks:]
    check(all(v > 0 for v in counts.values()), f"wire {wire}: kernels not launched: {counts}")
    check(all(max(v for k, v in t[2].items() if k != "tick_stamp") <= 1 for t in ticks),
          f"wire {wire}: a kernel twice in a tick")
    check(all(t[3] <= 1 and t[4] <= 1 for t in ticks), f"wire {wire}: more than one upload or download")
    check(len(checks) > 0 and all(all(eq.values()) for _k, eq in checks),
          f"wire {wire}: a replay differs from the eager tick body")
    check(len(texts) == BATCH and all(len(x) == 1 for x in texts), f"wire {wire}: {texts[:3]}")
    _t, timed, _w = sched_run(sched, pcms)
    p50, p90 = tick_ms(timed)
    print(f"scheduler flagship on wire {wire}: launches {counts} over {len(ticks)} ticks, "
          f"{len(checks)} replays bit-equal to the eager body; tick ms (host clock, captured) "
          f"p50 {p50:.3f} p90 {p90:.3f}")
    return counts, probe.get("wire"), texts, (p50, p90)


def wires_phase(root, model_dir, graph_dir, dev, pcms, fuzzy):
    """Phase 21: the mu-law and ADPCM serving wires: the captured flagship
    scheduler on each beside i16 (ticks timed in the same call), K6 counted
    and bit-equal to its twin at the tick's shape, and the synthetic speech
    profile's spoken sentences on both wires. Returns (the K6 entry, the
    i16 run's transcripts)."""
    ticks, counts, texts = {}, {}, {}
    for wire in WIRES:
        counts[wire], probe, texts[wire], ticks[wire] = wire_part(wire, model_dir, graph_dir, dev,
                                                                 pcms, fuzzy)
        if wire == "adpcm":
            check(probe is not None, "no tick probed the ADPCM wire's bytes")
            k6 = adpcm_numbers(probe)
    profile, sgraph = trained_speech_profile(root)
    speech = [synthesize_sentence(profile, text, seed=SEED + 40 + i)
              for i, text in enumerate(SPEECH_TEXTS)]
    batch = Nnet3WavTranscriber(profile.model_dir, sgraph, device=dev)
    spoken = {}
    for wire in ("mulaw", "adpcm"):
        sched = StreamScheduler(profile.model_dir, sgraph, max_streams=len(speech), device=dev,
                                wire=wire)
        check(sched._device_feats and sched._wire == wire, f"speech profile: wire {wire} not taken")
        got, _ticks, _wall = sched_run(sched, speech)
        # the wire is lossy, the pipeline after it exact: the scheduler
        # equals the batch path fed the wire's decoded audio
        want = batch.transcribe_pcm_batch([wire_decoded(wire, x) for x in speech])
        check(got == want, f"speech profile on wire {wire}: {got} vs the decoded batch's {want}")
        spoken[wire] = sum(g == [t] for g, t in zip(got, SPEECH_TEXTS))
        check(spoken[wire] >= WIRE_MIN_SPOKEN[wire], f"speech profile on wire {wire}: only "
              f"{spoken[wire]} of {len(speech)} transcripts are the spoken sentence: {got}")
    print("wires: tick ms p50 / p90 (flagship, 32 slots, captured, this call): "
          + ", ".join(f"{w} {ticks[w][0]:.3f} / {ticks[w][1]:.3f}" for w in WIRES)
          + f"; the synthetic speech profile's {len(speech)} sentences, scheduled on each wire, "
          f"equal the batch transcripts of the wire's decoded audio, and the spoken sentences: "
          f"{spoken['mulaw']} on mulaw, {spoken['adpcm']} on adpcm")
    SUMMARY["wire_ticks"] = ticks
    return ({"name": "adpcm_decode_sched_tick", "route": "cuda",
             "source": "rhasspy_speech_torch/csrc/adpcm_decode.cu",
             "replaces": "rhasspy_speech_tpu/ops/adpcm.py:202", "library_ms": None,
             "launches": counts["adpcm"]["adpcm_decode"], **k6}, texts["i16"])


def odd_window_phase(root, model_dir, graph_dir, dev, pcms, fuzzy):
    """Phase 22: a copy of the flagship model dir with
    --round-to-power-of-two=false --frame-length=25.0625 (N = 401): the
    batch call counted, its transcripts equal to the plain twins' path, K1
    (Bluestein's algorithm) against its twin at [32, 48000] and against
    float64, and timed in one call beside the twin, the N = 512 launch and
    torch.fft.rfft of the [B * T, 401] frames (the spectrum step alone); one
    stream and the scheduler reach it too. Returns the kernels-line entry."""
    odd = linked_copy(model_dir, os.path.join(root, "odd_model"),
                      {"round_to_power_of_two": False, "frame_length_ms": ODD_FRAME_MS})
    t = Nnet3WavTranscriber(odd, graph_dir, device=dev)
    cfg = t.am.frontend_config
    check(cfg.padded_window_size == 401, f"odd window: N = {cfg.padded_window_size}")
    texts, wall_ms, launches = counted_batch(t, pcms, fuzzy, "odd-window batch")
    check(plain_texts_of(t, pcms, fuzzy) == texts, "odd window: kernels and plain twins differ")
    pcm = t._pad_batch(pcms)[0]
    params = t.am.frontend_params
    feats, want = mfcc_batch(params, pcm), mfcc_batch_torch(params, pcm)
    torch.cuda.synchronize()
    err = float((feats - want).abs().max())
    check(torch.allclose(feats, want, rtol=MFCC_RTOL, atol=MFCC_ATOL),
          f"odd window: K1 vs twin max |d| {err}")
    k1 = {"ms": cuda_ms(lambda: mfcc_batch(params, pcm)),
          "plain_ms": cuda_ms(lambda: mfcc_batch_torch(params, pcm)), "max_abs_err": err}
    k1["bound_ms"], k1["bound_by"] = bound(*mfcc_work(params, *pcm.shape, feats.shape[1]))
    p512 = make_frontend_params(dataclasses.replace(cfg, round_to_power_of_two=True,
                                                    frame_length_ms=25.0), dev)
    ms512 = cuda_ms(lambda: mfcc_batch(p512, pcm))
    k1_against_float64(params, {"odd-window batch": pcm, "tone bursts": tone_bursts()})
    # the spectrum step alone, as one library call: rfft of the [B * T, 401]
    # frames (not K1's whole function: no framing, window, mel or DCT)
    frames = pcm[:, cached_index(frame_indices(cfg, pcm.shape[1]), dev)].reshape(-1, cfg.frame_length)
    rfft_ms = cuda_ms(lambda: torch.fft.rfft(frames, n=cfg.padded_window_size, dim=-1))
    st = Nnet3StreamTranscriber(odd, graph_dir, device=dev)
    zero_counts()
    stream_pcm(st, pcms[0], **fuzzy)
    stream_k1 = read_counts()["mfcc"]
    sched = StreamScheduler(odd, graph_dir, max_streams=4, device=dev, **fuzzy)
    check(sched._device_feats, "odd window: the scheduler should keep features on the device")
    sched_run(sched, pcms[:4])
    sched_k1 = sched.kernel_launches["mfcc"]
    check(stream_k1 > 0 and sched_k1 > 0, f"odd window: K1 launches stream {stream_k1}, "
          f"scheduler {sched_k1}")
    print(f"odd window (N = 401, Bluestein over Q = 1024): batch {BATCH} x {SECONDS} s in "
          f"{wall_ms:.1f} ms, launches {launches}, transcripts equal to the plain twins' path; K1 "
          f"{list(pcm.shape)} -> {list(feats.shape)}: max |d| {err:.3e}; CUDA events, this call: "
          f"kernel {k1['ms']:.4f} ms, its twin {k1['plain_ms']:.4f} ms, K1 at N = 512 "
          f"{ms512:.4f} ms, torch.fft.rfft of the {list(frames.shape)} frames alone "
          f"{rfft_ms:.4f} ms; bound {k1['bound_ms']:.4f} ms ({k1['bound_by']}); K1 launches on one stream {stream_k1}, on the scheduler (4 slots) {sched_k1}")
    SUMMARY["k1_odd_vs_512"] = (k1["ms"], ms512)
    return {"name": "mfcc_odd_window", "route": "cuda", "source": "rhasspy_speech_torch/csrc/mfcc.cu",
            "replaces": "rhasspy_speech_tpu/ops/pallas_mfcc.py:122", "library_ms": None,
            "launches": launches["mfcc"], **k1}


def serve_process(model_dir, graph_dir, wavs, save):
    """One run of _SERVE_PROCESS in a process of its own: its report."""
    proc = subprocess.run(
        [sys.executable, "-c", _SERVE_PROCESS, os.path.dirname(os.path.abspath(__file__)),
         str(model_dir), str(graph_dir), *wavs, "save" if save else "-"],
        capture_output=True, text=True, timeout=600,
    )
    check(proc.returncode == 0, f"serving process failed: {proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def cli_warmup_phase(root, model_dir, graph_dir, dev, pcms):
    """Phase 23: ``cli.main(["transcribe", ...])`` on WAVs written from the
    seeded utterances, on the card; then a cold process (no manifest)
    serves them once and runs the CLI's ``warmup``, which writes the
    manifest, and a second process constructs from it: its first calls run
    no nvcc, load no library, make no AM plan and capture no tick, and
    return the cold process's transcripts. Each process's time to its first
    transcript is printed."""
    wav_dir = os.path.join(root, "cli_wavs")
    os.makedirs(wav_dir)
    wavs = []
    for i, pcm in enumerate(pcms):
        wavs.append(os.path.join(wav_dir, f"u{i:02d}.wav"))
        with wave.open(wavs[-1], "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes(np.clip(np.round(pcm), -32768, 32767).astype(np.int16).tobytes())
    cli_graph = shutil.copytree(graph_dir, os.path.join(root, "cli_graph"))
    zero_counts()
    with contextlib.redirect_stdout(io.StringIO()) as said:
        rc = cli.main(["transcribe", *wavs, "--model-dir", str(model_dir), "--graph-dir", cli_graph])
    launches = read_counts()
    rows = [json.loads(line) for line in said.getvalue().splitlines() if line.startswith("{")]
    check(rc == 0 and len(rows) == len(wavs) and [r["wav"] for r in rows] == wavs,
          f"cli transcribe: rc {rc}, {len(rows)} rows")
    check(launches["mfcc"] == 1 and launches["viterbi"] == 1, f"cli transcribe launches {launches}")
    cold = serve_process(model_dir, cli_graph, wavs, save=True)
    check(cold["warmup_rc"] == 0 and os.path.isfile(os.path.join(cli_graph, "aot", "warmup.json")),
          f"cli warmup: {cold.get('warmup_said')}")
    warm = serve_process(model_dir, cli_graph, wavs, save=False)
    for rep in (cold, warm):
        check(not rep["imported"], f"a serving process imported {rep['imported'][:3]}")
    check(warm["texts"] == cold["texts"] == [r["nbest"] for r in rows],
          "warm, cold and CLI batch transcripts differ")
    check(warm["sched_texts"] == cold["sched_texts"], "warm and cold scheduler transcripts differ")
    check(all(v == 0 for v in warm["batch_added"].values()),
          f"warm process: the first batch call added {warm['batch_added']}")
    check(all(v == 0 for v in warm["sched_added"].values()),
          f"warm process: the first scheduled streams added {warm['sched_added']}")
    print(f"cli transcribe: {len(rows)} WAVs on the card, launches {launches}; cli warmup wrote "
          f"{os.path.join(cli_graph, 'aot', 'warmup.json')} in {cold['warmup_s']:.1f} s")
    for name, rep in (("cold", cold), ("warm", warm)):
        print(f"{name} process: time to first transcript {rep['ttft_s']:.2f} s from its start "
              f"(transcriber constructed in {rep['construct_s']:.2f} s, first batch call "
              f"{rep['first_call_ms']:.1f} ms, second {rep['second_call_ms']:.1f} ms; the first "
              f"call added {rep['batch_added']}); scheduler constructed in "
              f"{rep['sched_construct_s']:.2f} s, {len(wavs)} streams served in "
              f"{rep['sched_serve_ms']:.1f} ms, adding {rep['sched_added']} "
              f"({rep['captures']} tick bodies captured in all)")
    SUMMARY["ttft"] = {"cold": cold["ttft_s"], "warm": warm["ttft_s"],
                       "cold_first_ms": cold["first_call_ms"], "warm_first_ms": warm["first_call_ms"]}


def mesh_phase(model_dir, graph_dir, dev, pcms, fuzzy, sched_texts):
    """Phase 24: ``ShardedWavTranscriber`` over ``make_stream_mesh()``
    (every card: the one of a plain run, all of them under ``--mesh``)
    equals the single transcriber on the 32 utterances, and the scheduler
    with ``mesh=`` equals the mesh-free scheduler's ``sched_texts``. Each
    block's tick state lives on its card and one replay a block a tick is
    held bit-equal to its eager body. Prints the wall time of a sharded
    and a single batch call, and of both schedulers' runs."""
    mesh = make_stream_mesh()
    check(mesh.size == torch.cuda.device_count(), f"mesh of {mesh.size}")
    single = Nnet3WavTranscriber(model_dir, graph_dir, device=dev)
    want = single.transcribe_pcm_batch(pcms, **fuzzy)
    sharded = ShardedWavTranscriber(model_dir, graph_dir, mesh=mesh)
    sharded.transcribe_pcm_batch(pcms, **fuzzy)
    zero_counts()
    got = sharded.transcribe_pcm_batch(pcms, **fuzzy)
    launches = read_counts()
    check(got == want, "the sharded transcriber differs from the single one")
    check(launches["mfcc"] == mesh.size and launches["viterbi"] == mesh.size,
          f"sharded transcriber launches {launches}")
    batch_s = {}
    for name, t in (("single", single), ("sharded", sharded), ("sharded again", sharded),
                    ("single again", single)):
        t0 = time.perf_counter()
        t.transcribe_pcm_batch(pcms, **fuzzy)
        for d in mesh.devices:
            torch.cuda.synchronize(d)
        batch_s[name] = round(time.perf_counter() - t0, 4)
    del sharded

    sched = StreamScheduler(model_dir, graph_dir, max_streams=BATCH, mesh=mesh, device=dev, **fuzzy)
    check(len(sched.shards) == mesh.size and sched._device_feats, "mesh scheduler route")
    check(all(shard.device == d and all(x.device == d for x in shard._st.tensors().values())
              for shard, d in zip(sched.shards, mesh.devices)), "a block's state is off its card")
    runners = [shard._runner for shard in sched.shards]

    def on_tick():
        for r in runners:
            r.check_next = True

    on_tick()
    texts, _ticks, _wall = sched_run(sched, pcms, on_tick)
    for r in runners:
        r.check_next = False
    checks = [eq for r in runners for _k, eq in r.checks]
    check(all(r.checks for r in runners) and all(all(eq.values()) for eq in checks),
          "mesh scheduler: a block's replay differs from its eager tick body")
    check(texts == sched_texts, "the mesh scheduler differs from the mesh-free one")
    check(all(v > 0 for v in sched.kernel_launches.values()), "mesh scheduler: kernels not launched")
    check(all(all(v > 0 for v in shard.kernel_launches.values()) for shard in sched.shards),
          "mesh scheduler: a block launched no kernel")
    plain = StreamScheduler(model_dir, graph_dir, max_streams=BATCH, device=dev, **fuzzy)
    sched_run(plain, pcms)  # its captures
    sched_s = {}
    for name, sc in (("mesh", sched), ("single", plain), ("single again", plain),
                     ("mesh again", sched)):
        sched_s[name] = round(sched_run(sc, pcms)[2], 4)
    print(f"mesh {[str(d) for d in mesh.devices]}: ShardedWavTranscriber transcripts equal the single "
          f"transcriber's ({BATCH} utterances, launches {launches}); the scheduler with mesh= "
          f"equals the mesh-free scheduler's {BATCH} transcripts, {len(checks)} block replays "
          f"bit-equal to the eager body")
    print(f"mesh wall s (host clock, synchronized): batch call {batch_s}; scheduler run "
          f"(captured) {sched_s}")


EXAMPLE_STREAMS = 8
FRONTIER_ARGS = ["3", "50", "4", "--k", "64,512"]  # order 3, T=50, B=4, two K


def counted(fn, *args):
    """``fn(*args)`` with the wrappers' launch counts zeroed just before and
    read just after: (its result, the counts)."""
    zero_counts()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, read_counts()


def launched(what, counts, kernels):
    check(all(counts[k] > 0 for k in kernels), f"{what}: no launch of {kernels}: {counts}")


def examples_phase(big_dirs):
    """Phase 25: every example of rhasspy_speech_torch/examples/ the JAX
    package's examples/ has, driven on the card through its main(argv)."""
    big_model, big_graph = (str(d) for d in big_dirs)
    for wire in ("i16", "adpcm"):
        r = serve_streams.main([str(EXAMPLE_STREAMS), "--wire", wire])
        launched(f"serve_streams on {wire}", r["kernel_launches"], list(r["kernel_launches"]))
        check(r["device_route"] and len(r["kernel_launches"]) == (5 if wire == "adpcm" else 4),
              f"serve_streams on {wire}: route or kernels {r['kernel_launches']}")
        need = EXAMPLE_STREAMS if wire == "i16" else WIRE_MIN_SPOKEN["adpcm"]
        check(r["exact"] >= need, f"serve_streams on {wire}: {r['exact']} of {EXAMPLE_STREAMS} exact")
        print(f"example serve_streams, {EXAMPLE_STREAMS} streams on {wire}: {r['exact']} exact, tick "
              f"p50 / p90 {r['tick_p50_ms']:.3f} / {r['tick_p90_ms']:.3f} ms, fleet RTF "
              f"{r['fleet_rtf']:.5f}, launches {r['kernel_launches']}")
    card = str(torch.device("cuda", torch.cuda.current_device()))
    r, counts = counted(serve_multichip.main, [str(EXAMPLE_STREAMS), "--devices", card])
    launched("serve_multichip", counts, ("mfcc", "viterbi"))
    check(r["transcripts"] == r["single"] and r["exact"] == EXAMPLE_STREAMS and r["mesh"] == [card],
          f"serve_multichip: {r['exact']} exact over mesh {r['mesh']}")
    print(f"example serve_multichip over {r['mesh']}: {r['exact']} exact, equal to one device's; "
          f"launches {counts}")
    r, counts = counted(inspect_utterance.main, [])
    launched("inspect_utterance", counts, ("mfcc", "viterbi"))
    check(r["transcript"] == [inspect_utterance.TEXT] and 0.0 <= r["confidence"] <= 1.0
          and r["nbest"][0][0] == inspect_utterance.TEXT.split(),
          f"inspect_utterance: {r['transcript']}, confidence {r['confidence']}, n-best {r['nbest']}")
    print(f"example inspect_utterance: {r['transcript']}, confidence {r['confidence']:.4f}, "
          f"{len(r['nbest'])} rivals, lattice {r['lattice_states']} states; launches {counts}")
    # its decodes are the k-best decode and the lattice's: plain PyTorch, no K2
    r, counts = counted(rescore_oov.main, [])
    launched("rescore_oov", counts, ("mfcc",))
    check(r["rescored"][0] == rescore_oov.RECOVERED, f"rescore_oov: {r['rescored']}")
    print(f"example rescore_oov: first pass {r['first_pass']}, rescored {r['rescored']}; "
          f"launches {counts}")
    r, counts = counted(frontier_curve.main, FRONTIER_ARGS)
    launched("frontier_curve", counts, ("viterbi",))
    check(np.isfinite(r["exact_cost"]).all() and all(
        (c["cost"] >= r["exact_cost"] - frontier_curve.AGREE_TOL).all() for c in r["curve"]),
        "frontier_curve: a frontier cost below the exact decode's")
    print(f"example frontier_curve on {r['states']} states: agreement "
          f"{[(c['k'], c['agreement']) for c in r['curve']]}; launches {counts}")
    for graph, dirs in (("big", ["--graph-dir", big_graph]), ("seeded30000", [])):
        r = tick_device_profile.main(["--graph", graph, "--no-endpoint", "--model-dir", big_model]
                                     + dirs)
        launched(f"tick_device_profile on {graph}", r["launches_per_replay"],
                 ("mfcc", "viterbi", "path_walk"))
        check(r["device_exec_ms"] > 0 and r["h2d_ms"] > 0 and r["run_ms"] > 0,
              f"tick_device_profile on {graph}: device split {r}")
    r, counts = counted(decode_roofline.main, ["32", "--bf16", "--graph-dir", big_graph])
    launched("decode_roofline", counts, ("mfcc", "viterbi"))
    check(all(0.0 < s["share"] <= 1.0 for s in r["stages"].values()),
          f"decode_roofline: a share outside (0, 1]: {r['stages']}")


def mesh_main():
    """``python3 chip_smoke.py --mesh``: only phase 24, over every card
    the machine has, against the mesh-free scheduler run here on the
    first card. The last line is the same ``{"ok": true, ...}`` object."""
    dev = torch.device("cuda", 0)
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(_build.build, KERNELS))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        model_dir, graph_dir, _graph = build_profile(root)
        rng = np.random.RandomState(SEED)
        pcms = [(1000.0 * rng.randn(int(16000 * SECONDS))).astype(np.float32) for _ in range(BATCH)]
        fuzzy = dict(max_fuzzy_cost=1.0e9)
        sched = StreamScheduler(model_dir, graph_dir, max_streams=BATCH, device=dev, **fuzzy)
        sched_texts = sched_run(sched, pcms)[0]
        del sched
        with phase("mesh"):
            mesh_phase(model_dir, graph_dir, dev, pcms, fuzzy, sched_texts)
    print(f"chip_smoke --mesh: {PHASE_S}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))


def main():
    run_t0 = time.time()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; card: {smi}")

    t0 = time.time()
    with ThreadPoolExecutor(len(KERNELS)) as pool:  # one nvcc per source, all at once
        for path in pool.map(_build.build, KERNELS):
            print(f"built {path.name}")
    print(f"kernel build {time.time() - t0:.1f} s")
    clock0 = calibrate(dev)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        t0 = time.time()
        model_dir, graph_dir, graph = build_profile(root)
        t = Nnet3WavTranscriber(model_dir, graph_dir, device=dev, lattice_beam=LATTICE_BEAM)
        print(f"profile: {graph.num_states} states, {graph.num_arcs} arcs, "
              f"{graph.num_pdfs} pdfs; AM TDNN-F {HIDDEN}x{LAYERS}, ivector {IVEC_DIM}, "
              f"UBM {UBM_GAUSS}; built in {time.time() - t0:.1f} s")

        rng = np.random.RandomState(SEED)
        n = int(16000 * SECONDS)
        pcms = [(1000.0 * rng.randn(n)).astype(np.float32) for _ in range(BATCH)]
        fuzzy = dict(max_fuzzy_cost=1.0e9)  # the fuzzy tail runs for every hypothesis

        # warm-up at the measured shape: library loads, cuBLAS and cuFFT
        # plans, and the caching allocator's first device allocations
        for _ in range(2):
            t.transcribe_pcm_batch(pcms, **fuzzy)
        torch.cuda.synchronize()

        # -- the main path, counted ------------------------------------------
        zero_counts()
        t0 = time.time()
        main_texts = t.transcribe_pcm_batch(pcms, **fuzzy)
        torch.cuda.synchronize()
        main_s = time.time() - t0
        launches = read_counts()
        print(f"main path: {BATCH} x {SECONDS} s in {main_s * 1000:.1f} ms; launches {launches}")
        check(launches["mfcc"] > 0 and launches["viterbi"] > 0, f"kernels not launched: {launches}")
        check(len(main_texts) == BATCH and all(len(x) == 1 for x in main_texts),
              f"expected one transcript per utterance, got {main_texts[:3]}")
        main_stages = stage_ms(t, pcms, fuzzy)
        print(f"main path stages (ms, host clock, synchronized): {main_stages}")

        # -- the same batch through the plain twins on the card ---------------
        pcm, feat_lengths, lengths, n_out = t._pad_batch(pcms)
        feats_plain = mfcc_batch_torch(t.am.frontend_params, pcm)
        lp_plain = t.am.log_probs(feats_plain, n_out, feat_lengths=feat_lengths)
        res = twin_decoder.viterbi_decode(t.device_graph, lp_plain, t.acoustic_scale, lengths)
        arrs = [r.cpu().numpy() for r in res]
        words = twin_decoder.traces_to_words_batch(t.artifacts.graph, *arrs)
        plain_texts = t._texts(
            [[] if w is None else [(w, c)] for w, c in words], None, require_fuzzy=False, **fuzzy
        )
        check(plain_texts == main_texts, "transcripts differ between kernels and plain twins")
        print(f"transcripts equal to the plain twins' path; first: {main_texts[0]}")

        # -- K1: MFCC kernel vs twin at the main path's shape ------------------
        feats_k = mfcc_batch(t.am.frontend_params, pcm)
        torch.cuda.synchronize()
        check(feats_k.shape == feats_plain.shape and bool(torch.isfinite(feats_k).all()),
              "mfcc kernel output shape or finiteness")
        k1_err = float((feats_k - feats_plain).abs().max())
        check(torch.allclose(feats_k, feats_plain, rtol=MFCC_RTOL, atol=MFCC_ATOL),
              f"mfcc kernel vs twin: max |d| {k1_err}")
        k1_ms = cuda_ms(lambda: mfcc_batch(t.am.frontend_params, pcm))
        k1_plain_ms = cuda_ms(lambda: mfcc_batch_torch(t.am.frontend_params, pcm))
        k1_bound = bound(*mfcc_work(t.am.frontend_params, BATCH, pcm.shape[1], feats_k.shape[1]))
        print(f"K1 mfcc [{BATCH}, {pcm.shape[1]}] -> {tuple(feats_k.shape)}: max |d| {k1_err:.3e}; "
              f"kernel {k1_ms:.4f} ms, plain {k1_plain_ms:.4f} ms, bound {k1_bound[0]:.4f} ms "
              f"({k1_bound[1]})")
        k1_against_float64(
            t.am.frontend_params, {"main path": pcm, "tone bursts": tone_bursts()})

        # -- K2: Viterbi kernel vs twin, bit for bit ---------------------------
        lp_k = t.am.log_probs(feats_k, n_out, feat_lengths=feat_lengths)
        k2 = viterbi_phase(t, lp_k, lengths, dev)

        # -- the card against the CPU twins on a small input -------------------
        tc = Nnet3WavTranscriber(model_dir, graph_dir, device="cpu", lattice_beam=LATTICE_BEAM)
        lp_cpu, _ = tc._acoustic_batch(pcms[:2])
        lp_dev, _ = t._acoustic_batch(pcms[:2])
        cpu_err = float((lp_dev.cpu() - lp_cpu).abs().max())
        check(torch.allclose(lp_dev.cpu(), lp_cpu, rtol=CPU_RTOL, atol=CPU_ATOL),
              f"card log-probs vs CPU twins: max |d| {cpu_err}")
        check(tc.transcribe_pcm_batch(pcms[:2], **fuzzy) == main_texts[:2],
              "CPU twins transcribe differently")
        print(f"card vs CPU twins on 2 utterances: log-probs max |d| {cpu_err:.3e}, transcripts equal")

        PHASE_S["main path"] = round(time.time() - run_t0, 1)

        # -- n-best, silence weighting, lattices --------------------------------
        with phase("nbest, silence, lattices"):
            nbest_phase(t, tc, pcms, fuzzy)
            silence_phase(model_dir, graph_dir, dev, pcms, fuzzy)
            lattice_phase(t, tc, pcms)

        # -- streaming: K1 a push, K2 with a carried alpha a chunk --------------
        with phase("stream"):
            k2_chunk = carried_alpha_phase(t, lp_k, lengths, dev)
            stream_counts, k1_push = stream_phase(root, model_dir, graph_dir, t, dev, pcms, fuzzy)
        del t, tc

        # -- the big-graph decoders ---------------------------------------------
        with phase("big graph"):
            big_dirs = big_graph_phase(root, dev, pcms)

        # -- K2 past one SM's shared memory: the halo and global bodies -------
        with phase("K2 past one SM"):
            large_entries = large_graph_phase(root, dev, pcms, *big_dirs)

        # -- the stream scheduler: one K1 and one K2 launch a tick --------------
        with phase("scheduler"):
            sched_counts, k1_tick, k2_tick, k4_tick, k4_big = scheduler_phase(
                model_dir, graph_dir, big_dirs, root, dev, pcms, fuzzy)

        # -- the Kaldi GMM family (tri1) on the batch, stream and scheduler
        # routes; the Coqui CTC family (DeepSpeech) ---------------------------
        with phase("gmm"):
            gmm_entries = gmm_phase(root, model_dir, graph_dir, big_dirs, dev, pcms, fuzzy)
        with phase("coqui"):
            coqui_entries = coqui_phase(root, dev, pcms)

        # -- Kaldi pitch features (K5) on the batch, stream and scheduler
        # routes ------------------------------------------------------------
        with phase("pitch"):
            pitch_entries = pitch_phase(root, model_dir, graph_dir, graph, dev, pcms, fuzzy,
                                        main_stages)

        # -- the TDNN-LSTM on the batch, stream and scheduler routes; bf16;
        # dither; every component type --------------------------------------
        with phase("tdnn-lstm"):
            lstm_entries, lstm32, lstm_cpu = tdnn_lstm_phase(root, model_dir, graph_dir, graph,
                                                             dev, pcms, fuzzy)
        with phase("bf16"):
            bf16_phase(root, model_dir, lstm32, lstm_cpu, graph_dir, dev, pcms, fuzzy)
        del lstm32
        with phase("dither"):
            dither_entry = dither_phase(root, model_dir, graph_dir, dev, pcms, fuzzy)
        with phase("all types"):
            all_types_phase(dev)

        # -- the serving wires (K6), K1's odd window, the CLI and warm start,
        # the mesh ------------------------------------------------------------
        with phase("wires"):
            k6_entry, i16_texts = wires_phase(root, model_dir, graph_dir, dev, pcms, fuzzy)
        with phase("odd window"):
            odd_entry = odd_window_phase(root, model_dir, graph_dir, dev, pcms, fuzzy)
        with phase("cli and warmup"):
            cli_warmup_phase(root, model_dir, graph_dir, dev, pcms)
        with phase("mesh"):
            mesh_phase(model_dir, graph_dir, dev, pcms, fuzzy, i16_texts)

        # -- K3: the windowed relaxation's entry point ------------------------
        with phase("windowed relaxation"):
            k3_launches, k3_err, k3_ms, k3_plain_ms, k3_bound = windowed_relax_phase(dev)

        # -- the example scripts ----------------------------------------------
        with phase("examples"):
            examples_phase(big_dirs)

    # no single PyTorch call computes Kaldi's MFCC, a Viterbi pass, the
    # windowed relaxation, a backpointer walk or a pitch-lag Viterbi:
    # library_ms is null for all five. The two "stream" entries are K1 and K2 at the streaming path's
    # shapes (a push, a 7-frame chunk with a carried alpha), their launches
    # counted over one streamed utterance; the two "sched_tick" entries at
    # the scheduler tick's ([32, L] PCM; [32, 7, P] with alpha0 and a length
    # per slot), their launches (and path_walk's) counted by the scheduler
    # over the flagship graph's captured run; path_walk_13789 is K4 on the
    # big graph's ring, its launches that graph's run's. K4 has no TPU
    # kernel: "replaces" names the XLA scan it stands in for. The "tri1"
    # entries are K1, K2 and K4 on the GMM family's batch call and
    # scheduler run, the "deepspeech" entries K1 at the Coqui frontend's
    # shapes (an utterance, a push), each counted over its own path's run.
    # The "pitch_viterbi" entries are K5 (no TPU kernel either: it stands in
    # for pitch_track's XLA scans) on the pitch model's batch call ([32,
    # 296, 417]), on a push's 2 s window ([1, 196, 417]; its launches one
    # streamed utterance's) and on the tick's probed windows ([32, 196,
    # 417]; its launches the scheduler's count). "viterbi_halo" is K2's halo
    # body on the trained past-reach grammar's batch call ([32, 112, 3072]),
    # "viterbi_halo_40000" the same body on the seeded 40,000-state graph,
    # both with the launches of that batch call; "viterbi_global" the global
    # body on the seeded graph past the halo body's reach ([8, 112, 3072]),
    # its launches the transcriber's call on that graph; path_walk_30000 is
    # K4 on the 30,000-state device route's ring, its launches that run's.
    kernels = [
        {"name": "mfcc", "route": "cuda", "source": "rhasspy_speech_torch/csrc/mfcc.cu",
         "replaces": "rhasspy_speech_tpu/ops/pallas_mfcc.py:122",
         "launches": launches["mfcc"], "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain_ms,
         "bound_ms": k1_bound[0], "bound_by": k1_bound[1], "library_ms": None},
        {"name": "viterbi", "route": "cuda", "source": "rhasspy_speech_torch/csrc/viterbi.cu",
         "replaces": "rhasspy_speech_tpu/ops/pallas_decoder.py:370",
         "launches": launches["viterbi"], "max_abs_err": k2["max_abs_err"], "ms": k2["ms"],
         "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
         "library_ms": None},
        {"name": "mfcc_stream_push", "route": "cuda", "source": "rhasspy_speech_torch/csrc/mfcc.cu",
         "replaces": "rhasspy_speech_tpu/ops/pallas_mfcc.py:122",
         "launches": stream_counts["mfcc"], "library_ms": None, **k1_push},
        {"name": "viterbi_stream_chunk", "route": "cuda",
         "source": "rhasspy_speech_torch/csrc/viterbi.cu",
         "replaces": "rhasspy_speech_tpu/ops/pallas_decoder.py:370",
         "launches": stream_counts["viterbi"], "library_ms": None, **k2_chunk},
        {"name": "mfcc_sched_tick", "route": "cuda", "source": "rhasspy_speech_torch/csrc/mfcc.cu",
         "replaces": "rhasspy_speech_tpu/ops/pallas_mfcc.py:122",
         "launches": sched_counts["mfcc"], "library_ms": None, **k1_tick},
        {"name": "viterbi_sched_tick", "route": "cuda",
         "source": "rhasspy_speech_torch/csrc/viterbi.cu",
         "replaces": "rhasspy_speech_tpu/ops/pallas_decoder.py:370",
         "launches": sched_counts["viterbi"], "library_ms": None, **k2_tick},
        {"name": "path_walk", "route": "cuda", "source": "rhasspy_speech_torch/csrc/path_walk.cu",
         "replaces": "rhasspy_speech_tpu/pipeline/scheduler.py:838",
         "launches": sched_counts["path_walk"], "library_ms": None, **k4_tick},
        {"name": "path_walk_13789", "route": "cuda", "source": "rhasspy_speech_torch/csrc/path_walk.cu",
         "replaces": "rhasspy_speech_tpu/pipeline/scheduler.py:838", "library_ms": None, **k4_big},
        {"name": "windowed_relax", "route": "cuda", "source": "rhasspy_speech_torch/csrc/windowed_relax.cu",
         "replaces": "examples/pallas_windowed_cost.py:59",
         "launches": k3_launches, "max_abs_err": k3_err, "ms": k3_ms, "plain_ms": k3_plain_ms,
         "bound_ms": k3_bound[0], "bound_by": k3_bound[1], "library_ms": None},
        *large_entries,
        *gmm_entries,
        *coqui_entries,
        *pitch_entries,
        *lstm_entries,
        dither_entry,
        k6_entry,
        odd_entry,
    ]
    clock1 = calibrate(dev)
    apart = clock1.base_s - clock0.base_s
    drift = clock1.base_s - clock0.host(clock1.base_ns)
    print(f"card clock against the host's over the run ({apart:.1f} s apart): drift "
          f"{1e6 * drift:.1f} us ({1e6 * drift / apart:.3f} ppm), calibration errors "
          f"{1e6 * clock0.error_s:.1f} / {1e6 * clock1.error_s:.1f} us")
    loaded = sorted(m for m in sys.modules if m.partition(".")[0] in ("jax", "jaxlib", "rhasspy_speech_tpu"))
    check(not loaded, f"the port imported JAX or the JAX package: {loaded[:5]}")
    print("no module of jax or rhasspy_speech_tpu was imported")
    print(f"chip_smoke: whole run {time.time() - run_t0:.1f} s; seconds a phase (the main "
          f"path's with the build): {PHASE_S}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:] == ["--mesh"]:
        mesh_main()
    elif sys.argv[1:]:
        sys.exit(f"usage: {sys.argv[0]} [--mesh]")
    else:
        main()
