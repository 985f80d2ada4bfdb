"""Batched streaming on one device: many PCM streams, one tick at a time.

Counterpart of ``rhasspy_speech_tpu/pipeline/scheduler.py``
(``StreamScheduler``), the reference's serving path for many streams. A
fixed pool of ``max_streams`` slots (the copied ``native.StreamPool``)
holds each stream's unread PCM, and one ``step()`` (a tick) runs one pass
over every slot. A slot is ready when its feature rows cover a chunk
(``21`` input frames at the default ``chunk_out_frames=7``) and the model's
right context, or when its stream is finished and rows are left (a partial
last chunk); its valid output frames ``n_valid`` are 0 when it has nothing
to do. Slots reopened since the last tick go back to the graph's initial
alpha and zero i-vector statistics inside the next device step.

**The route.** The scheduler picks one of three routes with the
reference's rule (the flags keep the reference's names):

- ``_bp_compact``: the graph has <= 65,532 arcs and <= 65,535 states, so a
  backpointer fits a uint16 ``bp + 3``;
- ``_iv_inline``: the AM window covers the i-vector tap's splice (the tap
  is a slice of the window), CMVN of the tap can run on the device
  (``_iv_cmvn_device``) or is not asked for, and silence weighting, if
  asked for, runs on the device (``_sw_device``);
- ``_ep_device``: endpointing rides the device walk;
- ``_device_bp``: compact, and endpointing and silence weighting (if asked
  for) on the device. Then each slot's backpointers stay on the device in
  a ring ``[N, F, S]`` (``F = _ring_frames``, sized from
  ``pool_capacity_samples``) and each tick ends with one whole-path walk
  (``ops.path_walk_cuda.path_walk``), whose packed row per slot is the
  tick's only download: the finalize trace and the endpoint statistics;
- ``_device_feats``: the device route, ``snip_edges=true`` and an inline
  tap (or no extractor). Then the features live in a device ring too and
  the tick is one fused body (``pipeline/device_tick.py``): one ``pcm_meta``
  upload, one MFCC launch, the chunk AM, one Viterbi launch, one path-walk
  launch. Without it the host featurizer keeps the features (one MFCC call
  a tick) and the device step takes the host's windows.

**Lane buckets.** On the device route the chunk AM runs over the tick's
lanes only: the host picks the bucket ``device_tick.am_rows(lanes, N)``
(a power of two, 8 to ``N``; on a card, where that bucket has no graph
at the tick's width and a larger one has, the smallest such,
``_am_bucket``) and writes the lane list
(``device_tick.lane_list``: the slots with a chunk first, ascending, then
the idle slots) into meta column 10 of the fused upload (column 4 of the
chunk body's meta). The runner's keys are ``("fused", width, dtype, rows)``
and ``("chunk", rows)``, each bucket its own captured graph; a tick's record
keeps its key's first part and the bucket in ``am_rows``.

Everything else takes the host route: each chunk's backpointers come to
the host, where the endpoint rules, the silence weights and the final
backtrace read them (a graph past 65,532 arcs; silence weighting whose tap
the AM window does not cover).

On the card the device route's tick runs as a captured CUDA graph, one per
body, PCM width and AM lane bucket (``device_tick.TickRunner``); on the CPU
the same bodies run eagerly with the kernels' plain twins.
``kernel_launches`` counts the kernels the ticks ran, captured launches
times replays. Every tick's decode
is one Viterbi kernel launch on the card whatever the graph's size (its
replicated, halo or global body, by the graph's states), on both routes.

**The lag rule.** On the device route, results and endpoint statistics
land asynchronously. A tick's packed row is copied into pinned host memory
behind the tick, and an event marks it landed. At most ``PIPELINE_DEPTH``
ticks are in flight: a tick waits for the tick two before it. A flushed
stream's transcript is assembled from the flushing tick's row on a later
``step()`` or on ``poll()``. The endpoint rules run at the start of each
tick on the newest landed row (the rows before it are dropped): on the CPU
everything lands at once, so a tick's statistics decide at the next tick,
always; on the card they decide as soon as their row has landed, one or
more ticks later. After ``PIPELINE_DEPTH + 2`` ticks in a row with nothing
landed, the oldest row is waited for.

A GMM model's chunk model is ``models.gmm.GmmChunkModel`` (deltas over
the window's +-4 context frames, the per-pdf log-likelihoods, no i-vector,
subsampling 1); it takes either route by the same rule.

**Pitch.** A pitch model's rows pair each MFCC row with 3 pitch columns,
as the reference pairs them. On the host route (and on the device route
with host features) the featurizer keeps them: one batched pitch call a
tick (``_drain_pitch_all``: ``[n, Wp]`` windows of the slots with unpaired
MFCC rows, one pitch-Viterbi launch on a card), and the finish-time flush
repeats the last pitch row over the MFCC tail. On the fused route
(``_pitch_device``, the reference's rule) the tick's pitch lane
(``device_tick.DeviceTick.feed_pitch``) keeps a PCM history ring a slot,
computes one sliding window a slot (one launch a tick) and writes the new
rows into the feature ring's pitch columns; the ready loop reads only rows
whose pitch is written (``_plan_pitch``).

**Recurrent plans and bf16.** A recurrent (TDNN-LSTM) chunk model keeps
per-slot recurrence rows ``[max_streams, depth, dim]`` (``_am_state`` on
the host route, ``TickState.rec`` on the device route): a reopened slot's
rows go back to zero in the next device step, and a slot with nothing to
decode (``n_valid == 0``) keeps its rows, as the reference's. With
``compute_dtype="bfloat16"`` the chunk AM of a model that is neither
recurrent nor a GMM computes in bf16 (``_bf16``; the reference keeps a
recurrent model's carried state in f32); decode costs stay f32.

**Wires.** ``wire="i16"`` uploads int16 (or f32) PCM; on the fused route
``"mulaw"`` uploads G.711 codewords (``ops/mulaw.py``, decoded in the tick
by one 256-entry gather) and ``"adpcm"`` 4-bit block-ADPCM in frame-shift
blocks (``ops/adpcm.py``, decoded in the tick by the ADPCM kernel K6,
``ops/adpcm_cuda.py``); the upload's meta columns then ride as bytes. The
carried frame tails are the decoded samples, which re-encode to themselves,
so features never drift across a tick boundary. The other routes read the
pool directly and ignore the wire.

**Mesh.** ``mesh=`` (``parallel.make_stream_mesh``) gives a
``MeshScheduler``: the slots in contiguous blocks, one block (one
scheduler, its own device tick and captures) per mesh device, admission
filling the blocks evenly.

**Tracing.** The device route keeps records in the process's registry
(``utils/metrics.py``), tagged with the scheduler's serial number: one
``TickRecord`` a tick body issued (its host stamps, ``step()``'s wait on
the card, and the body's device stamps, ``device_tick.STAMPS_TAKEN``,
placed on the host clock when its row lands, polled without waiting at
each ``step()``; a feed-only body takes none and downloads nothing), and
one ``StreamRecord`` a finalized stream (``finish()`` -> the flushing tick
issued -> that tick's body end -> the transcript set). The device clock is
mapped onto the host's (``ops/tick_stamp_cuda.py:calibrate``: five stamps
on a side stream, each waited for, the tick in flight not) at the top of
the first ``step()`` and again each ``CLOCK_PERIOD_S``; a row's stamps are
mapped when it lands.
``StageTimer`` names: on the
device route ``stream_harvest`` (assembling landed rows; the wait for them
is ``stream_wait_fin``), ``stream_features``, ``stream_ep_apply`` (its wait
``stream_wait_ep``), ``stream_ready``, ``stream_wait_pace``,
``stream_issue_fused`` / ``stream_issue_feed`` / ``stream_issue_chunk``
(the body's run call: upload copy and replay enqueued), ``stream_download``,
``stream_book`` and ``stream_finalize``; on the host route
``stream_features``, ``stream_ready``, ``stream_host_step`` (the device
step and its download) and ``stream_finalize``.

**Warm start.** ``warmup(seconds)`` builds and loads the kernels and
drives silence through the slots, which runs (captures, on a card) each
tick body the feeds give: chunk-sized feeds through 8, 16, ... and every
slot in turn (each AM lane bucket at the steady width; every slot on the
host route), then a dribble and a burst through one stream and every
slot; ``save_aot(seconds)`` also records the shape in
``<graph_dir>/aot/warmup.json``, and a scheduler of the same configuration
warms it in its constructor (``utils/warmup.py``; the fused route without a
mesh, as the reference gates its AOT store).
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import inspect
import logging
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple, Union

import numpy as np
import torch

from ..device import on_device, resolve_device
from ..fst.core import SymbolTable
from ..grammar.fst import decode_meta
from ..native import StreamPool
from ..native.runtime import adpcm_encode_into
from ..ops.cmvn import CmvnConfig, stats_from_matrix
from ..ops.decoder import DecodeGraph, backtrace_words
from ..ops.ivector import solve_ivector, window_stats
from ..ops.adpcm import block_bytes
from ..ops.mfcc_cuda import mfcc_batch
from ..ops.path_walk_cuda import PACKED_STAT_COLS
from ..ops.pitch import num_pitch_frames, pitch_batch
from ..ops.tick_stamp_cuda import calibrate
from ..ops.viterbi_cuda import libraries as viterbi_libraries, viterbi_decode
from ..utils.metrics import StageTimer, StreamRecord, TickRecord, get_metrics, new_source
from .artifacts import LangArtifacts
from .device_tick import (
    KERNELS,
    META_COLS,
    STAMPS_TAKEN,
    WIRES,
    DeviceTick,
    PackedFetch,
    TickConfig,
    TickRunner,
    TickState,
    am_buckets,
    am_rows,
    lane_list,
    meta_cols,
)
from .endpoint import EndpointConfig, silence_pdfs_from_model, trailing_silence_frames
from .fuzzy import get_fuzzy_text
from .streaming_features import (
    StreamFeaturizer,
    silence_weights_from_chunk,
    stage_ivector_window,
)
from ..utils.warmup import Manifest, base_config, load_kernels
from .transcribe import AcousticModel

_LOGGER = logging.getLogger(__name__)

CHUNK_OUT_FRAMES = 7

# Per-slot per-tick drain cap floor (samples): the scheduler's cap is the
# larger of this and twice a chunk's audio, so a burst-fed stream drains at
# about twice the rate its chunks consume it, and the MFCC call's width
# stays within a few buckets. Audio past the cap drains on later ticks.
_DRAIN_CAP = 12800

# The device route keeps backpointers as uint16 bp + 3 (0 no frame, 1
# unused, 2 dead), and the packed row keeps a state id in uint16.
_BP_RING_MAX_ARC = 65532
_BP_RING_MAX_STATE = 65535

# Ticks in flight on the device route before a tick waits for the oldest.
PIPELINE_DEPTH = 2
# Seconds the device clock's mapping onto the host's is kept: an H100's
# drifts ~4 ppm from the host's (PERF.md), ~4 us a second.
CLOCK_PERIOD_S = 1.0


def _pcm_bucket(n: int, cap: int = _DRAIN_CAP) -> int:
    """Padded PCM width of a tick's MFCC call: 800-sample (0.05 s) steps
    with a 1,600-sample floor, at most the drain cap. Steady serving keeps
    to one width, so to one captured tick."""
    n = min(n, cap)
    return max(1600, -(-n // 800) * 800)


@dataclass
class _SlotState:
    active: bool = False
    feats: Optional[np.ndarray] = None  # [T, D] feature rows (host features)
    feat_state: object = None  # StreamFeatState
    frames_consumed: int = 0  # input frames given to the AM so far
    out_frames: int = 0
    bps: List[np.ndarray] = field(default_factory=list)  # host route: [chunk][k, S] arc ids
    done: bool = False
    result: Optional[List[str]] = None
    # set when a ring-capacity quarantine finalized the stream; result
    # still carries the partial transcript
    error: Optional[str] = None
    flushed_feats: bool = False
    iv_pending_win: Optional[np.ndarray] = None
    iv_pending_w: Optional[np.ndarray] = None
    # bumped on open AND close: a result is delivered to the stream whose
    # ticket close() returned, never to the slot's next stream
    gen: int = 0


class StreamScheduler:
    """Admit / feed / step / poll interface over a fixed batch of stream
    slots (see the module docstring)."""

    # Device programs since construction: MFCC calls and chunk steps on the
    # host route, tick bodies (and the host featurizer's MFCC calls) on the
    # device route. A tick makes at most one MFCC call and one step.
    device_dispatches = 0

    def __new__(cls, *args, mesh=None, **kwargs):
        # a mesh gives the sharded scheduler (end of this module), which
        # holds one StreamScheduler a block
        if mesh is not None:
            return MeshScheduler(*args, mesh=mesh, **kwargs)
        return super().__new__(cls)

    def __init__(
        self,
        model_dir: Union[str, Path],
        graph_dir: Union[str, Path],
        max_streams: int = 32,
        acoustic_scale: float = 1.0,
        max_fuzzy_cost: Optional[float] = None,
        lang_dir: Optional[Union[str, Path]] = None,
        pool_capacity_samples: int = 16000 * 60,
        endpointing: Optional[EndpointConfig] = None,
        silence_weight: Optional[float] = None,
        mesh=None,
        chunk_out_frames: int = CHUNK_OUT_FRAMES,
        compute_dtype: Optional[str] = None,
        wire: str = "i16",
        device: Union[str, torch.device] = "cuda",
    ):
        if wire not in WIRES:
            raise ValueError(f"wire must be 'i16', 'mulaw' or 'adpcm', got {wire!r}")
        self.device = resolve_device(device)
        self._chunk_out = int(chunk_out_frames)
        self.am = AcousticModel(Path(model_dir), compute_dtype=compute_dtype, device=self.device)
        self.artifacts = LangArtifacts.load(graph_dir)
        if self.artifacts.graph is None:
            raise ValueError(f"no graph.npz in {graph_dir}")
        self.artifacts_dir = Path(graph_dir)
        self.graph = self.artifacts.graph
        self.device_graph = DecodeGraph.from_dense(self.graph, self.device)
        self.max_streams = max_streams
        self.acoustic_scale = acoustic_scale
        self.max_fuzzy_cost = max_fuzzy_cost
        self.silence_weight = silence_weight
        self.endpointing = endpointing
        self.fuzzy_lang = (
            LangArtifacts.load(lang_dir) if lang_dir is not None else self.artifacts
        )

        self.pool = StreamPool(max_streams, pool_capacity_samples)
        self.slots: List[_SlotState] = [_SlotState() for _ in range(max_streams)]
        self._featurizer = StreamFeaturizer(self.am)
        cm = self.am.chunk_model(self._chunk_out)
        self._recurrent = cm.recurrent
        # a recurrent model's carried state stays f32 (the reference's rule);
        # a GMM has no products to cast
        self._bf16 = self.am.bf16 and not self._recurrent and self.am.spec is not None
        self._chunk_model = cm.cast(torch.bfloat16) if self._bf16 else cm
        self._win_lo, self._win_hi = self._chunk_model.ranges["input"]
        self._chunk_in = self._chunk_out * self.am.subsampling
        cfg = self.am.frontend_config
        self._frame_shift = cfg.frame_shift
        chunk_samples = self._chunk_in * cfg.frame_shift
        self._drain_cap = max(_DRAIN_CAP, -(-2 * chunk_samples // 1600) * 1600)
        self._pending_drain = False

        self._has_ivector = self.am._has_ivector
        self._ivp = self.am.ivector_params if self._has_ivector else None

        self._silence_pdfs: set = set()
        if endpointing is not None or silence_weight is not None:
            phones_path = self.am._resolved_model_dir / "model" / "phones.txt"
            if phones_path.exists():
                with open(phones_path, "r", encoding="utf-8") as f:
                    model_phones = SymbolTable.read_text(f)
                self._silence_pdfs = silence_pdfs_from_model(self.am.transition_model, model_phones)
        self._silence_pdf_arr = np.fromiter(sorted(self._silence_pdfs), dtype=np.int64)
        self._weigh_silence = (
            silence_weight is not None
            and silence_weight != 1.0
            and self._ivp is not None
            and bool(self._silence_pdfs)
        )

        self._choose_route(pool_capacity_samples)
        # the serving wire: only the fused route uploads PCM (the host
        # featurizer reads the pool directly)
        self._wire = wire if self._device_feats else "i16"
        self._meta_cols = meta_cols(self._wire)
        if self._wire == "adpcm" and (self._frame_shift < 2 or 800 % self._frame_shift):
            # block == frame_shift keeps the blocks at the same absolute
            # sample positions every tick, and the 800-sample PCM buckets
            # must stay whole blocks
            raise ValueError(
                "wire='adpcm' needs a frame shift that divides the 800-sample PCM "
                f"bucket, got {self._frame_shift}; use wire='mulaw'"
            )

        self._pending_reset = np.zeros(max_streams, dtype=bool)
        ivp = self._ivp
        if ivp is not None:
            self._iv_win_shape = (
                ivp.splice_left + self._chunk_in + ivp.splice_right, cfg.num_ceps
            )
        self._fuzzy_cache: Dict[tuple, List[str]] = {}
        # results of closed streams, keyed by close()'s (sid, gen) ticket:
        # a serving loop recycles a done slot at once, and a result that
        # lands later still reaches its ticket. Bounded FIFO.
        self._retired: Dict[Tuple[int, int], List[str]] = {}
        self._retired_cap = max(64, 4 * max_streams)
        # slots whose stream would overrun a device ring this tick: they
        # finalize with what they have (see _quarantine)
        self._quarantined: Set[int] = set()
        if self._device_bp:
            self._init_device_route()
        else:
            # every slot's alpha, i-vector statistics and recurrence rows,
            # reset through _pending_reset
            self._alpha = self.device_graph.init_weight[None, :].repeat(max_streams, 1)
            self._am_state = (
                self._chunk_model.init_state(max_streams) if self._recurrent else {}
            )
            if ivp is not None:
                num_gauss, lda_dim = int(ivp.gconsts.shape[0]), int(ivp.lda.shape[0])
                self._iv_gamma = torch.zeros((max_streams, num_gauss), device=self.device)
                self._iv_X = torch.zeros((max_streams, num_gauss, lda_dim), device=self.device)
        # the warm-start manifest (utils/warmup.py), as the reference gates
        # its AOT store: the fused route (a mesh never reaches here)
        self._aot = Manifest(Path(graph_dir) / "aot") if self._device_feats else None
        if self._aot is not None:
            for (seconds,) in self._aot.shapes("scheduler", self._warm_config, self._kernels()):
                self.warmup(seconds)

    # -- warm start (utils/warmup.py) -------------------------------------------

    def _kernels(self) -> List[str]:
        """The kernels this scheduler's ticks launch on a card."""
        names = ["mfcc"] + viterbi_libraries(self.graph.num_states)
        if self._device_bp:
            names += ["path_walk", "tick_stamp"]
        if self._featurizer.has_pitch:
            names.append("pitch_viterbi")
        if self._wire == "adpcm":
            names.append("adpcm_decode")
        return names

    def _warm_config(self) -> Dict:
        cfg = base_config(self.am, self.artifacts_dir, self.device)
        cfg.update(
            max_streams=self.max_streams, chunk_out_frames=self._chunk_out,
            acoustic_scale=self.acoustic_scale, silence_weight=self.silence_weight,
            endpointing=(None if self.endpointing is None
                         else dataclasses.asdict(self.endpointing)),
            pool_capacity_samples=self.pool.capacity, wire=self._wire,
        )
        return cfg

    def warmup(self, seconds: float = 3.0) -> None:
        """Pay the first ticks' one-time costs: build and load the kernels,
        then drive silence through the slots as serving would, which runs
        (on a card: captures) the tick body of every PCM width and AM lane
        bucket the drives give: chunk-sized feeds of ``seconds``-long
        streams through every slot and, on the device route, through each
        smaller bucket's number of streams in turn up to the first tick
        that decodes
        (``device_tick.am_buckets``: 8, 16, ...), then a dribble of small
        feeds and a burst past the drain cap through one stream and through
        every slot. Every stream is closed after, and no result is kept."""
        load_kernels(self._kernels(), self.device)
        chunk_samples = self._chunk_in * self._frame_shift
        n_chunks = max(2, int(round(seconds * 16000 / chunk_samples)))
        N = self.max_streams

        def zeros(n):
            return np.zeros(n, dtype=np.float32)

        # (streams, feeds, whether to stop at the first tick that decodes):
        # a smaller bucket's drive needs only its first chunk at the steady
        # width, then the flush
        drives = [(streams, [zeros(chunk_samples)] * n_chunks, streams < N)
                  for streams in (am_buckets(N) if self._device_bp else [N])]
        # a dribble walks the small widths, a burst the largest and its rest
        for feeds in ([zeros(1200)] * 8, [zeros(2 * self._drain_cap + 1600), zeros(0)]):
            drives += [(1, feeds, False)]
            if self._device_bp and am_rows(1, N) < N:
                drives += [(N, feeds, False)]
        for streams, feeds, first in drives:
            sids = [self.open_stream() for _ in range(streams)]
            sids = [sid for sid in sids if sid >= 0]
            for pcm in feeds:
                for sid in sids:
                    self.feed(sid, pcm)
                if self.step() and first:
                    break
            self._warm_drain(sids)
        self._retired.clear()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _warm_drain(self, sids: List[int]) -> None:
        for sid in sids:
            self.finish(sid)
        self.run_until_idle()
        for sid in sids:
            self.poll(sid)
            self.close(sid)

    def save_aot(self, seconds: float = 3.0) -> Path:
        """Warm (``warmup``) and record ``seconds`` in the manifest under
        ``<graph_dir>/aot``; returns its directory. Only the fused route
        without a mesh keeps a manifest, as the reference's AOT store."""
        if self._aot is None:
            raise RuntimeError("a warm-start manifest needs the fused device-feature route and no mesh")
        self.warmup(seconds)
        return self._aot.add("scheduler", self._warm_config(), self._kernels(), (seconds,))

    def _choose_route(self, pool_capacity_samples: int) -> None:
        """The reference's route flags (module docstring)."""
        ivp = self._ivp
        self._bp_compact = (
            self.graph.num_arcs <= _BP_RING_MAX_ARC
            and self.graph.num_states <= _BP_RING_MAX_STATE
        )
        iv_inline_geom = (
            ivp is not None
            and self._win_lo <= -ivp.splice_left
            and self._win_hi >= self._chunk_in + ivp.splice_right
        )
        cmvn_stats = self.am.ivector_cmvn_stats
        self._iv_cmvn_device = iv_inline_geom and cmvn_stats is not None and self._bp_compact
        cmvn_ok = cmvn_stats is None or self._iv_cmvn_device
        no_sw = self.silence_weight in (None, 1.0)
        self._sw_device = not no_sw and iv_inline_geom and cmvn_ok and self._bp_compact
        self._iv_inline = iv_inline_geom and cmvn_ok and (no_sw or self._sw_device)
        self._ep_device = (
            self.endpointing is not None and (no_sw or self._sw_device) and self._bp_compact
        )
        self._device_bp = (
            (self.endpointing is None or self._ep_device)
            and (no_sw or self._sw_device)
            and self._bp_compact
        )
        self._ring_frames = (
            -(-pool_capacity_samples // (160 * self.am.subsampling)) + self._chunk_out + 32
        )
        self._device_feats = (
            self._device_bp
            and self._featurizer.snip  # snip_edges=false: host featurizer
            and (ivp is None or self._iv_inline)
        )
        # The pitch lane on the device (the reference's rule): one drain
        # must never advance the window past the rows one block write
        # covers; else the features stay on the host
        self._pitch_device = False
        fz = self._featurizer
        if self._device_feats and fz.has_pitch:
            t_w = num_pitch_frames(self.am.pitch_config, fz.pitch_window)
            if t_w >= 2 and self._drain_cap <= (t_w - 1) * fz.frame_shift:
                self._pitch_device = True
                self._pitch_t_w = t_w
            else:
                _LOGGER.warning(
                    "pitch window too short for the drain cap (t_w=%d, cap=%d); pitch "
                    "rides the host feature path", t_w, self._drain_cap,
                )
                self._device_feats = False
        cfg = self.am.frontend_config
        # slack past the valid rows covers the largest bucket's scratch rows
        scratch_rows = 1 + max(0, (self._drain_cap - cfg.frame_length) // cfg.frame_shift)
        self._feat_ring_frames = (
            pool_capacity_samples // 160 + self._win_hi + max(160, scratch_rows + 32)
        )

    def _init_device_route(self) -> None:
        """Every slot's device state, allocated once, and the tick's
        bodies."""
        N, dev, g = self.max_streams, self.device, self.device_graph
        ivp = self._ivp
        cfg = self.am.frontend_config
        fz = self._featurizer
        C, D = cfg.num_ceps, fz.feat_dim
        # the tap window is cut on the device; CMVN'd from the cumulative
        # ring, which only the fused route keeps (else the host stages it)
        self._iv_carry_device = self._iv_inline and (
            not self._iv_cmvn_device or self._device_feats
        )
        cmvn_device = self._iv_cmvn_device and self._device_feats

        def zeros(shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        F = self._ring_frames
        if ivp is not None:
            num_gauss, lda_dim = int(ivp.gconsts.shape[0]), int(ivp.lda.shape[0])
            gamma, X = zeros((N, num_gauss)), zeros((N, num_gauss, lda_dim))
        else:
            gamma, X = zeros((N, 1)), zeros((N, 1, 1))
        self._st = TickState(
            alpha=g.init_weight[None, :].repeat(N, 1),
            offs=zeros(N, torch.int32),
            # chunk_out rows of slack: a chunk writes all its rows at the
            # slot's offset, which the quarantine keeps <= F
            ring=zeros((N, F + self._chunk_out, g.num_states), torch.int16),
            packed=zeros((N, F + PACKED_STAT_COLS), torch.int16),
            gamma=gamma,
            X=X,
            iv_carry=zeros((N, *self._iv_win_shape) if self._iv_carry_device else (N, 1, 1)),
            sw_w=(torch.ones((N, self._chunk_in), device=dev) if self._sw_device
                  else zeros((N, 1))),
            feats_ring=zeros((N, self._feat_ring_frames, D) if self._device_feats else (N, 1, 1)),
            cum_ring=zeros((N, self._feat_ring_frames, C) if cmvn_device else (N, 1, 1)),
            # sample s of a slot at s + Wp (the window of a stream's start
            # reads the leading zeros); room for every feature-ring frame's
            # samples plus the largest PCM bucket
            pcm_ring=zeros(
                (N, fz.pitch_window + self._feat_ring_frames * fz.frame_shift + self._drain_cap)
                if self._pitch_device else (N, 1)
            ),
            rec=self._chunk_model.init_state(N) if self._recurrent else {},
        )
        # the reference's names for the state the tick updates in place
        st = self._st
        self._alpha, self._offs, self._ring = st.alpha, st.offs, st.ring
        self._iv_gamma, self._iv_X, self._iv_carry = st.gamma, st.X, st.iv_carry
        self._sw_w, self._feats_ring, self._cum_ring = st.sw_w, st.feats_ring, st.cum_ring

        sil_tab = np.zeros(max(self.graph.num_pdfs, 1), dtype=np.uint8)
        if self._ep_device or self._sw_device:
            for p in self._silence_pdfs:
                if 0 <= p < sil_tab.shape[0]:
                    sil_tab[p] = 1
        g_sum, g_count, g_cap, window = None, 0.0, 0.0, 0
        if cmvn_device:
            ccfg = CmvnConfig()
            s_sum, _s_sumsq, g_count = stats_from_matrix(self.am.ivector_cmvn_stats)
            g_sum = torch.as_tensor(s_sum, dtype=torch.float32, device=dev)
            g_cap = float(min(g_count, ccfg.global_frames)) if g_count > 0 else 0.0
            window = ccfg.cmn_window
        tick_cfg = TickConfig(
            N=N, ring_frames=F, chunk_out=self._chunk_out, chunk_in=self._chunk_in,
            win_lo=self._win_lo, win_hi=self._win_hi, num_ceps=C,
            acoustic_scale=self.acoustic_scale,
            carry_device=self._iv_carry_device, cmvn_device=cmvn_device,
            sw_device=self._sw_device,
            sw_factor=float(self.silence_weight) if self._sw_device else 1.0,
            ep_stats=self._ep_device, subsampling=self.am.subsampling,
            splice_left=ivp.splice_left if ivp is not None else 0,
            splice_right=ivp.splice_right if ivp is not None else 0,
            cmvn_window=window, cmvn_g_count=float(g_count), cmvn_g_cap=g_cap,
            pitch=self.am.pitch_config if self._pitch_device else None,
            pitch_window=fz.pitch_window if self._pitch_device else 0,
            wire=self._wire,
            adpcm_block=self._frame_shift if self._wire == "adpcm" else 0,
        )
        self._tick = DeviceTick(
            tick_cfg, g, self._chunk_model, ivp,
            self.am.spec.ivector_dim if self._has_ivector else None,
            self._featurizer.stream_params,
            g.arc_src.to(torch.int32),
            torch.as_tensor(sil_tab[self.graph.arc_pdf], device=dev),
            g_sum,
        )
        self._runner = TickRunner(dev)
        self._feat_counts = np.zeros(N, dtype=np.int32)
        self._iv_pending_n = np.zeros(N, dtype=np.int32)
        # the pitch lane's bookkeeping: samples in a slot's PCM ring, pitch
        # frames already final, and this tick's plan (_plan_pitch)
        self._pcm_total = np.zeros(N, dtype=np.int64)
        self._pitch_done = np.zeros(N, dtype=np.int64)
        self._pitch_plan = None
        self._fin_snap: Optional[np.ndarray] = None
        # per tick (packed fetch, slot gens, out_frames), oldest first
        self._ep_stats_pending: "collections.deque" = collections.deque()
        self._ep_stats_deferred = 0
        self._inflight: "collections.deque" = collections.deque()
        self._pending_finalize: list = []
        self._tick_fetch: Optional[PackedFetch] = None
        # tracing (module docstring): this scheduler's serial number, bodies
        # issued, the device clock on the host's, this step's records and
        # wait, open stream records, and fetches whose stamps have not landed
        self._trace_src = new_source()
        self._ticks_issued = 0
        self._clock = None
        self._t_enter = 0.0
        self._wait_s = 0.0
        self._step_ticks: List[TickRecord] = []
        self._tick_rec: Optional[TickRecord] = None
        self._stream_recs: Dict[Tuple[int, int], StreamRecord] = {}
        self._unlanded: "collections.deque" = collections.deque()

    @property
    def kernel_launches(self) -> Dict[str, int]:
        """Kernel launches the device route's ticks made (captured launches
        times replays), by the kernels the tick runs (``pitch_viterbi`` with
        the pitch lane only); all zero on the host route and on the CPU."""
        names = [k for k in KERNELS if (k != "pitch_viterbi" or self._pitch_device)
                 and (k != "adpcm_decode" or self._wire == "adpcm")]
        if not self._device_bp:
            return dict.fromkeys(names, 0)
        return {k: self._runner.launches[k] for k in names}

    # -- stream lifecycle ------------------------------------------------------

    def open_stream(self) -> int:
        """Admit a stream; its slot id, or -1 when every slot is taken."""
        sid = self.pool.open()
        if sid < 0:
            return -1
        state = self.slots[sid]
        state.active = True
        state.feats = np.zeros((0, self._featurizer.feat_dim), np.float32)
        state.feat_state = self._featurizer.new_state()
        state.frames_consumed = 0
        state.out_frames = 0
        state.bps = []
        state.done = False
        state.result = None
        state.error = None
        state.flushed_feats = False
        self._quarantined.discard(sid)
        if self._ivp is not None:
            state.iv_pending_win = np.zeros(self._iv_win_shape, np.float32)
            state.iv_pending_w = np.zeros(self._chunk_in, np.float32)
        if self._device_bp:
            self._feat_counts[sid] = 0
            self._iv_pending_n[sid] = 0
            self._pcm_total[sid] = 0
            self._pitch_done[sid] = 0
        state.gen += 1
        # the slot's device state goes back to the start in the next tick's
        # device step: admission launches nothing
        self._pending_reset[sid] = True
        return sid

    def feed(self, sid: int, pcm: np.ndarray) -> int:
        return self.pool.feed(sid, pcm)

    def feed_many(self, sids: np.ndarray, pcm: np.ndarray) -> np.ndarray:
        """Feed row k of ``pcm`` [count, n] int16 to slot ``sids[k]`` in one
        call (``StreamPool.feed_many``)."""
        return self.pool.feed_many(sids, pcm)

    def finish(self, sid: int) -> None:
        self.pool.finish(sid)
        state = self.slots[sid]
        if self._device_bp and state.active and not state.done:
            key = (sid, state.gen)
            if key not in self._stream_recs:
                rec = StreamRecord(self._trace_src, sid, state.gen, t_finish=time.perf_counter(),
                                   tick_finish=self._ticks_issued)
                self._stream_recs[key] = rec
                get_metrics().streams.append(rec)

    def poll(self, sid: int, block: bool = True) -> Optional[List[str]]:
        """The stream's transcript once it is decoded; None before. On the
        device route a finished stream's transcript lands a tick after its
        flush: ``block`` waits for it, ``block=False`` returns None until
        it has landed."""
        state = self.slots[sid]
        if not state.done:
            return None
        if state.result is None and self._device_bp and self._pending_finalize:
            self._harvest_finalizes(block=block)
        return state.result

    def close(self, sid: int) -> Tuple[int, int]:
        """Release the slot for reuse; returns a ``(sid, gen)`` ticket that
        ``take_result`` redeems for a finished stream's transcript, also one
        that lands after the close."""
        state = self.slots[sid]
        ticket = (sid, state.gen)
        if state.done and state.result is not None:
            self._retire(ticket, state.result)
        if self._device_bp and not state.done:
            self._stream_recs.pop(ticket, None)  # closed unflushed: no transcript
        state.gen += 1
        state.active = False
        self._quarantined.discard(sid)
        self.pool.close(sid)
        return ticket

    def _retire(self, ticket: Tuple[int, int], result: List[str]) -> None:
        if len(self._retired) >= self._retired_cap:
            # drop the oldest: a caller that never collects must not leak
            self._retired.pop(next(iter(self._retired)))
        self._retired[ticket] = result

    def take_result(
        self, ticket: Tuple[int, int], block: bool = False
    ) -> Optional[List[str]]:
        """A closed stream's transcript by close()'s ticket, once; None for
        a stream that had not finished, or (``block=False``) whose result
        has not landed yet."""
        res = self._retired.pop(ticket, None)
        if res is None and self._device_bp and self._pending_finalize:
            self._harvest_finalizes(block=block)
            res = self._retired.pop(ticket, None)
        return res

    def error(self, sid: int) -> Optional[str]:
        """Non-None when a ring-capacity quarantine finalized the stream
        (it outlived the device rings sized from ``pool_capacity_samples``);
        ``poll()`` still returns what it decoded before the cutoff."""
        return self.slots[sid].error

    def _quarantine(self, sid: int, what: str, capacity: int) -> None:
        """Finalize one overlong stream with what it has instead of raising
        out of the tick every slot shares."""
        msg = (
            f"stream {sid} exceeds the device {what} ({capacity} frames); "
            "it was force-finalized with the audio decoded so far — raise "
            "pool_capacity_samples to the longest expected utterance"
        )
        _LOGGER.error(msg)
        self.slots[sid].error = msg
        self._quarantined.add(sid)

    @property
    def active_streams(self) -> int:
        return sum(1 for s in self.slots if s.active and not s.done)

    # -- the tick --------------------------------------------------------------

    def step(self) -> int:
        """One tick over every slot; returns the number of slots that
        decoded a chunk."""
        if self._device_bp:
            return self._step_device()
        return self._step_host()

    def run_until_idle(self, max_steps: int = 10000) -> None:
        """Step until no slot has work. Streams waiting on more PCM (or an
        endpoint) stop the loop too; audio left in the pool past a tick's
        drain cap keeps it going."""
        for _ in range(max_steps):
            if self.step() == 0 and not self._pending_drain:
                return

    def _drain_features_all(self) -> None:
        """Move pool PCM into each slot's feature rows: ONE batched MFCC
        call over ``[max_streams, L]`` for every slot with a new frame (a
        frame's row does not depend on how many frames the call holds, so
        the rows equal the single-stream featurizer's); for a pitch model
        ONE batched pitch call (``_drain_pitch_all``); then the
        featurizer's flush for finished streams."""
        fz = self._featurizer
        pushed = []  # (sid, pcm, (buf, n_frames) or None)
        for sid, state in enumerate(self.slots):
            if not state.active or state.done:
                continue
            avail = self.pool.available(sid)
            if avail <= 0:
                continue
            # the buffer is the carried tail, the reflected prefix of a
            # stream's first frames (snip_edges=false) and the new samples
            fs = state.feat_state
            prefix = 0 if fz.snip or fs.virt_started else fz.prefix
            cap = self._drain_cap - fs.mfcc_tail.shape[0] - prefix
            if avail > cap:
                self._pending_drain = True
            pcm = self.pool.read(sid, min(avail, cap))
            pushed.append((sid, pcm, fz.prepare_mfcc_buf(fs, pcm)))
        base_rows = {}
        with_buf = [(sid, *r) for sid, _pcm, r in pushed if r is not None]
        if with_buf:
            width = _pcm_bucket(max(buf.shape[0] for _, buf, _ in with_buf), self._drain_cap)
            batch = np.zeros((self.max_streams, width), dtype=np.float32)
            for sid, buf, _n in with_buf:
                batch[sid, : buf.shape[0]] = buf
            feats = self._features(batch)
            for sid, buf, n in with_buf:
                base_rows[sid] = feats[sid, :n]
                fz.commit_mfcc(self.slots[sid].feat_state, buf, n)
        empty = np.zeros((0, fz.num_ceps), dtype=np.float32)
        for sid, pcm, _r in pushed:
            state = self.slots[sid]
            rows = fz.push_with_base(state.feat_state, pcm, base_rows.get(sid, empty))
            if rows.shape[0]:
                state.feats = np.concatenate([state.feats, rows], axis=0)
        if fz.has_pitch:
            self._drain_pitch_all()
        # finished streams: the featurizer's flush, once (a pitch model
        # repeats its last pitch row over an unpaired MFCC tail)
        for sid, state in enumerate(self.slots):
            if (
                state.active
                and not state.done
                and not state.flushed_feats
                and self.pool.is_finished(sid)
                and self.pool.available(sid) <= 0
            ):
                rows = fz.push(state.feat_state, np.zeros(0, np.float32), flush=True)
                if rows.shape[0]:
                    state.feats = np.concatenate([state.feats, rows], axis=0)
                state.flushed_feats = True

    def _drain_pitch_all(self) -> None:
        """ONE batched pitch call over ``[n, Wp]`` windows, one a slot with
        unpaired MFCC rows and a new pitch frame; the rows pair with the
        pending MFCC rows."""
        fz = self._featurizer
        want = []  # (sid, window)
        for sid, state in enumerate(self.slots):
            if not state.active or state.done or state.feat_state.mfcc_pending.shape[0] == 0:
                continue
            window = fz.pitch_window_array(state.feat_state)
            if window is not None:
                want.append((sid, window))
        if not want:
            return
        self.device_dispatches += 1
        batch = torch.as_tensor(np.stack([w for _s, w in want]), device=self.device)
        rows = pitch_batch(self.am.pitch_config, batch).cpu().numpy()
        for i, (sid, _w) in enumerate(want):
            state = self.slots[sid]
            new = fz.consume_pitch_rows(state.feat_state, rows[i])
            out = fz.merge_pitch(state.feat_state, new)
            if out.shape[0]:
                state.feats = np.concatenate([state.feats, out], axis=0)

    def _features(self, batch: np.ndarray) -> np.ndarray:
        """MFCC rows [N, T, C] of the tick's PCM batch [N, L]: upload, one
        ``mfcc_batch`` call, download."""
        self.device_dispatches += 1
        # stream_params: with snip_edges=false the buffers are in the
        # featurizer's virtual-signal space, framed as snip_edges=true
        samples = torch.as_tensor(batch, device=self.device)
        return mfcc_batch(self._featurizer.stream_params, samples).cpu().numpy()

    # -- the host route ---------------------------------------------------------

    def _ready(self):
        """Each slot's chunk: (windows [N, W, D], n_valid [N] int32, t0 [N],
        have [N], streams to finalize with nothing left to decode)."""
        N = self.max_streams
        W = self._win_hi - self._win_lo
        windows = np.zeros((N, W, self._featurizer.feat_dim), dtype=np.float32)
        n_valid = np.zeros(N, dtype=np.int32)
        chunk_t0 = np.zeros(N, dtype=np.int64)
        chunk_have = np.zeros(N, dtype=np.int64)
        flushed: List[int] = []
        need = self._chunk_in + max(self._win_hi - self._chunk_in, 0)
        for sid, state in enumerate(self.slots):
            if not state.active or state.done:
                continue
            t0 = state.frames_consumed
            have = state.feats.shape[0]
            finished = self.pool.is_finished(sid)
            tail = finished and state.flushed_feats
            if have < t0 + need and not (tail and t0 < have):
                if tail and t0 >= have:
                    flushed.append(sid)
                continue
            idx = np.clip(np.arange(t0 + self._win_lo, t0 + self._win_hi), 0, max(have - 1, 0))
            windows[sid] = state.feats[idx]
            real_out = self._chunk_out
            if finished:
                real_out = min(real_out, max(0, -(-(have - t0) // self.am.subsampling)))
            n_valid[sid] = real_out
            chunk_t0[sid] = t0
            chunk_have[sid] = have
        return windows, n_valid, chunk_t0, chunk_have, flushed

    def _upload(self, windows: np.ndarray, n_valid: np.ndarray):
        """The tick's windows, lengths and pending i-vector windows and
        weights, on the device."""
        def up(a):
            return torch.as_tensor(a, device=self.device)

        if self._ivp is None:
            return up(windows), up(n_valid), None, None
        iv_wins, iv_ws = self._pending_ivector_inputs()
        return up(windows), up(n_valid), up(iv_wins), up(iv_ws)

    def _pending_ivector_inputs(self) -> Tuple[np.ndarray, np.ndarray]:
        """Every slot's staged i-vector window [N, Wiv, C] and weights [N,
        chunk_in] (zeros for a slot with none)."""
        iv_wins = np.stack([s.iv_pending_win if s.iv_pending_win is not None
                            else np.zeros(self._iv_win_shape, np.float32) for s in self.slots])
        iv_ws = np.stack([s.iv_pending_w if s.iv_pending_w is not None
                          else np.zeros(self._chunk_in, np.float32) for s in self.slots])
        return iv_wins, iv_ws

    def _reset_lanes(self) -> None:
        """Slots reopened since the last device step start again from the
        graph's initial alpha (what a fresh single stream starts from), zero
        i-vector statistics and zero recurrence rows."""
        lanes = np.flatnonzero(self._pending_reset)
        if lanes.size:
            idx = torch.as_tensor(lanes, device=self.device)
            self._alpha[idx] = self.device_graph.init_weight
            if self._ivp is not None:
                self._iv_gamma[idx] = 0.0
                self._iv_X[idx] = 0.0
            for rows in self._am_state.values():
                rows[idx] = 0.0
            self._pending_reset[:] = False

    def _fold_ivector(
        self, iv_wins: Optional[torch.Tensor], iv_ws: Optional[torch.Tensor]
    ) -> Optional[torch.Tensor]:
        """Fold the previous tick's pending statistics into every slot's
        (gamma, X) and solve the i-vectors [N, D] (zeros for a model that
        reads one without an extractor; None for a model that reads none).
        A slot with a zero weight row keeps its statistics exactly."""
        if not self._has_ivector:
            return None
        ivp = self._ivp
        if ivp is None:
            return torch.zeros(
                (self.max_streams, self.am.spec.ivector_dim), dtype=torch.float32, device=self.device
            )
        gamma, X = window_stats(iv_wins, iv_ws, ivp, self._chunk_in)
        self._iv_gamma += gamma
        self._iv_X += X
        return solve_ivector(self._iv_gamma, self._iv_X, ivp)

    def _acoustic(
        self, windows: torch.Tensor, ivec: Optional[torch.Tensor], lengths: torch.Tensor
    ) -> torch.Tensor:
        """Every slot's chunk log-probs [N, chunk_out_frames, P]. A recurrent
        plan continues from every slot's rows; a slot with no valid frame
        (``lengths`` 0) keeps its old rows."""
        if not self._recurrent:
            return self._chunk_model(windows, ivec)
        log_probs, new = self._chunk_model.forward_with_state(windows, self._am_state, ivec)
        active = (lengths > 0)[:, None, None]
        self._am_state = {k: torch.where(active, v, self._am_state[k]) for k, v in new.items()}
        return log_probs

    def _decode(self, log_probs: torch.Tensor, lengths: torch.Tensor, rows: int) -> torch.Tensor:
        """Advance every slot's alpha over its ``lengths`` frames; returns
        the first ``rows`` frames' backpointers [rows, N, S] on the device
        (uint16 ``arc + 2`` or int32 arc ids; a slot's rows at or past its
        length are STAY)."""
        out = viterbi_decode(
            self.device_graph, log_probs, self.acoustic_scale, lengths,
            return_forward=True, alpha0=self._alpha,
        )
        self._alpha = out[3]
        return out[4][:rows]

    @staticmethod
    def _download(bps: torch.Tensor) -> np.ndarray:
        """The chunk's backpointers on the host, as stored (uint16 rows hold
        ``arc + 2``)."""
        if bps.dtype == torch.uint16:
            return bps.view(torch.int16).cpu().numpy().view(np.uint16)
        return bps.cpu().numpy()

    @torch.no_grad()
    def _device_step(self, windows: np.ndarray, n_valid: np.ndarray) -> np.ndarray:
        """Reset, i-vector fold, AM forward and one decode over every slot;
        returns the backpointers [max(n_valid), N, S] on the host."""
        windows_d, lengths, iv_wins, iv_ws = self._upload(windows, n_valid)
        self._reset_lanes()
        ivec = self._fold_ivector(iv_wins, iv_ws)
        log_probs = self._acoustic(windows_d, ivec, lengths)
        bps = self._decode(log_probs, lengths, int(n_valid.max()))
        self.device_dispatches += 1
        if self._ivp is not None:
            # every slot's pending statistics are folded now
            for s in self.slots:
                if s.iv_pending_w is not None:
                    s.iv_pending_w = np.zeros(self._chunk_in, np.float32)
        return self._download(bps)

    def _step_host(self) -> int:
        """The host route's tick: features, readiness, one device step,
        then per slot the kept backpointers, the staged i-vector window, the
        endpoint rules and the backtrace of a finished stream."""
        metrics = get_metrics()
        self._pending_drain = False
        with StageTimer("stream_features", metrics):
            self._drain_features_all()
        with StageTimer("stream_ready", metrics):
            windows, n_valid, chunk_t0, chunk_have, flushed = self._ready()
        lanes = int((n_valid > 0).sum())
        alpha_np = None
        if lanes:
            with StageTimer("stream_host_step", metrics):
                bps = self._device_step(windows, n_valid)
            if self.endpointing is not None or self._weigh_silence:
                alpha_np = self._alpha.cpu().numpy()
            for sid in np.flatnonzero(n_valid):
                state = self.slots[sid]
                k = int(n_valid[sid])
                rows = bps[:k, sid]
                rows = rows.astype(np.int32) - 2 if rows.dtype == np.uint16 else rows.copy()
                state.bps.append(rows)
                state.out_frames += k
                if self._ivp is not None:
                    self._stage_ivector_stats(
                        sid, int(chunk_t0[sid]), int(chunk_have[sid]), rows, alpha_np
                    )
                state.frames_consumed += self._chunk_in
                if (
                    self.pool.is_finished(sid)
                    and state.flushed_feats
                    and state.frames_consumed >= state.feats.shape[0]
                ):
                    flushed.append(sid)
                elif self.endpointing is not None and self._check_endpoint(sid, alpha_np[sid]):
                    _LOGGER.debug("endpoint fired for stream %d", sid)
                    flushed.append(sid)
        with StageTimer("stream_finalize", metrics):
            if flushed and alpha_np is None:
                alpha_np = self._alpha.cpu().numpy()
            for sid in flushed:
                self._finalize(sid, alpha_np)
        return lanes

    def _stage_ivector_stats(
        self, sid: int, t0: int, have: int, rows: Optional[np.ndarray],
        alpha_np: Optional[np.ndarray],
    ) -> None:
        """This slot's chunk (window, weights) for the next tick's fold
        (``pipeline/stream.py`` stages the same for one stream); with
        ``rows`` the chunk's backpointers, silence frames of its best path
        weigh ``silence_weight``."""
        state = self.slots[sid]
        ivp = self._ivp
        num_ceps = self.am.frontend_config.num_ceps
        win, w = stage_ivector_window(
            state.feats[:, :num_ceps], t0, self._chunk_in, have,
            ivp.splice_left, ivp.splice_right, self.am.ivector_cmvn_stats,
        )
        if self._weigh_silence and rows is not None:
            flags = silence_weights_from_chunk(
                rows, alpha_np[sid], self.graph.arc_pdf, self.graph.arc_src, self._silence_pdf_arr
            )
            if flags is not None and flags.shape[0]:
                sub = self.am.subsampling
                out_idx = np.minimum(np.arange(self._chunk_in) // sub, flags.shape[0] - 1)
                w = np.where(flags[out_idx], w * float(self.silence_weight), w)
        state.iv_pending_win = win
        state.iv_pending_w = w.astype(np.float32)

    def _check_endpoint(self, sid: int, alpha_row: np.ndarray) -> bool:
        """The endpoint rules on one stream after its chunk (host route:
        the walk looks back at most 400 frames, as the reference's host
        route does)."""
        state = self.slots[sid]
        totals = alpha_row + self.graph.final_weight
        best_final = float(totals.min())
        best_any = float(alpha_row.min())
        if best_final < 1.0e29:
            relative_cost = best_final - best_any
            best_state = int(np.argmin(totals))
        else:
            relative_cost = float("inf")
            best_state = int(np.argmin(alpha_row))
        trailing, nonsil = trailing_silence_frames(
            state.bps, best_state, self.graph.arc_pdf, self.graph.arc_src, self._silence_pdfs
        )
        out_frame_sec = self.am.subsampling * self._frame_shift / 16000.0
        return self.endpointing.should_endpoint(
            contains_nonsilence=nonsil,
            trailing_silence=trailing * out_frame_sec,
            relative_cost=relative_cost,
            utterance_length=state.out_frames * out_frame_sec,
        )

    def _finalize(self, sid: int, alpha_np: np.ndarray) -> None:
        """Backtrace a finished or endpointed stream into its transcript."""
        state = self.slots[sid]
        if state.done:
            return
        state.done = True
        get_metrics().add_audio(state.frames_consumed * self._frame_shift / 16000.0, utterances=1)
        if not state.bps:
            state.result = []
            return
        bp = np.concatenate(state.bps, axis=0)[:, None, :]
        words, _cost = backtrace_words(
            self.graph, alpha_np[sid][None, :], bp, 0, num_frames=bp.shape[0]
        )
        state.result = [] if words is None else self._words_to_result(words)

    # -- the device route ---------------------------------------------------------

    def _host_buffer(self, shape: Tuple[int, ...], dtype) -> Tuple[torch.Tensor, np.ndarray]:
        """A zeroed host array for an upload: pinned memory on the card (the
        copy runs behind the host), and the tensor that owns it."""
        t = torch.zeros(shape, dtype=dtype, pin_memory=self.device.type == "cuda")
        return t, t.numpy()

    @staticmethod
    def _write_meta_cols(batch: np.ndarray, meta: np.ndarray) -> None:
        """The [N, k <= 12] int32 meta pack into the batch's trailing
        columns as lo / hi 16-bit halves: META_COLS of them in the PCM dtype
        (int16 wraps modulo 2^16, which the tick masks off; f32 holds the
        halves exactly), or on a uint8 wire 2 * META_COLS bytes, each half
        as its lo / hi byte."""
        k = meta.shape[1]
        halves = np.zeros((batch.shape[0], META_COLS), dtype=np.int64)
        halves[:, 0 : 2 * k : 2] = meta & 0xFFFF
        halves[:, 1 : 2 * k : 2] = (meta >> 16) & 0xFFFF
        if batch.dtype == np.uint8:
            cols = batch[:, -2 * META_COLS :]
            cols[:, 0::2] = halves & 0xFF
            cols[:, 1::2] = halves >> 8
        else:
            batch[:, -META_COLS:] = halves.astype(batch.dtype)

    def _prep_features_device(self):
        """The fused route's drain: every slot's new PCM (after its carried
        frame tail) into one padded host batch ``[N, L + META_COLS]`` in one
        pool snapshot and one batched read; the tick's MFCC launch writes the
        rows into the device feature ring. Returns (batch tensor, batch
        array, write offsets before this drain, has-new mask), or None when
        no slot has a new frame. ``_feat_counts`` advances here, so the
        readiness loop sees the counts after the write."""
        pool = self.pool
        fz = self._featurizer
        N = self.max_streams
        counts, finished, exact = pool.snapshot()
        self._fin_snap = finished
        drain = np.zeros(N, dtype=np.int64)
        offs = np.zeros(N, dtype=np.int64)
        for sid, state in enumerate(self.slots):
            if state.active and not state.done and counts[sid] > 0:
                off = state.feat_state.mfcc_tail.shape[0]
                # tail + new stays within the largest PCM bucket; the rest
                # drains next tick
                drain[sid] = min(int(counts[sid]), self._drain_cap - off)
                offs[sid] = off
                if drain[sid] < counts[sid]:
                    self._pending_drain = True
        frame_len, shift = fz.frame_len, fz.frame_shift

        def frames_of(n: int) -> int:
            return 1 + (n - frame_len) // shift if n >= frame_len else 0

        prep = None
        sel = drain > 0
        if sel.any():
            # quarantine before touching the pool: a slot whose rows would
            # overrun the feature ring is finalized, its drain skipped
            buf_lens = offs + drain
            n_rows = frames_of(_pcm_bucket(int(buf_lens.max()), self._drain_cap))
            limit = self._feat_ring_frames - n_rows
            for sid in np.nonzero(sel)[0]:
                if self._feat_counts[sid] + frames_of(int(buf_lens[sid])) > limit:
                    self._quarantine(sid, "feature ring", self._feat_ring_frames)
                    drain[sid] = 0
                    sel[sid] = False
        if sel.any():
            buf_lens = offs + drain
            max_len = _pcm_bucket(int(buf_lens.max()), self._drain_cap)
            exact_all = bool(exact[sel].all())
            wire = self._wire
            samples = None
            if wire == "adpcm":
                # drain f32 samples, then block-encode them into the upload
                # in one call; the reconstructions land over ``samples``
                wire_w = max_len // shift * block_bytes(shift)
                samples = np.zeros((N, max_len), dtype=np.float32)
                batch_t, batch = self._host_buffer((N, wire_w + self._meta_cols), torch.uint8)
            else:
                dtype = (torch.uint8 if wire == "mulaw"
                         else torch.int16 if exact_all else torch.float32)
                batch_t, batch = self._host_buffer((N, max_len + self._meta_cols), dtype)
            lanes = np.nonzero(sel)[0]
            new_frames = np.zeros(N, dtype=np.int64)
            for sid in lanes:
                tail = self.slots[sid].feat_state.mfcc_tail
                if tail.shape[0]:
                    if wire == "adpcm":
                        samples[sid, : tail.shape[0]] = tail
                    elif wire == "mulaw":
                        batch[sid, : tail.shape[0]] = tail  # the carried codewords
                    else:
                        batch[sid, : tail.shape[0]] = tail.astype(np.int16) if exact_all else tail
                new_frames[sid] = frames_of(int(buf_lens[sid]))
            if wire == "adpcm":
                pool.read_into(samples, offs, drain)
                adpcm_encode_into(samples, np.where(sel, buf_lens, 0), shift, batch[:, :wire_w])
            else:
                # the mu-law wire encodes while it copies
                pool.read_into(batch, offs, drain)
            has_new = sel & (new_frames > 0)
            if has_new.any():
                prep = (batch_t, batch, self._feat_counts.copy(), has_new)
                # samples in the device PCM ring once the upload lands (a
                # slot without a new frame keeps its total: its samples
                # stay in the tail and ride the next upload)
                self._pcm_total[has_new] = (
                    self._feat_counts.astype(np.int64)[has_new] * shift + buf_lens[has_new]
                )
            for sid in lanes:
                # the carried tail is what the device saw, so features never
                # drift across the frame overlap: the reconstructed samples
                # (ADPCM), which re-encode to themselves next tick, or the
                # codewords themselves (mu-law: the reference carries their
                # decoded values and re-encodes them, which gives back the
                # same samples)
                n = int(new_frames[sid])
                if wire == "adpcm":
                    tail = samples[sid, n * shift : int(buf_lens[sid])].copy()
                else:
                    row_tail = batch[sid, n * shift : int(buf_lens[sid])]
                    if wire == "mulaw":
                        tail = row_tail.copy()
                    else:
                        tail = row_tail.astype(np.float32) if exact_all else row_tail.copy()
                self.slots[sid].feat_state.mfcc_tail = tail
                self._feat_counts[sid] += n
        for sid, state in enumerate(self.slots):
            if (
                state.active
                and not state.done
                and not state.flushed_feats
                and finished[sid]
                and drain[sid] == counts[sid]
            ):
                # everything available drained this tick (no capped
                # leftover): the finished stream's input is complete
                state.flushed_feats = True
        return prep

    def _pace(self, metrics) -> None:
        """Wait for the oldest tick in flight when PIPELINE_DEPTH are."""
        t0 = time.perf_counter()
        while len(self._inflight) >= PIPELINE_DEPTH:
            self._inflight.popleft().get()
        self._waited("stream_wait_pace", time.perf_counter() - t0, metrics)

    def _waited(self, stage: str, seconds: float, metrics) -> None:
        """``seconds`` the host was blocked on the card: a stage, and the
        current step's wait."""
        metrics.add_stage(stage, seconds)
        self._wait_s += seconds

    # -- tracing (module docstring) ----------------------------------------------

    def _issue(self, key: tuple, body, inputs, lanes: int, stage: Optional[str],
               metrics, rows: Optional[int] = None) -> TickRecord:
        """Run one tick body (``stage``, if given, times the run call) and
        open its record; ``rows``: its chunk AM's lane bucket."""
        rec = TickRecord(self._trace_src, self._ticks_issued, key[0], lanes, self._t_enter,
                         time.perf_counter(), am_rows=rows)
        self._ticks_issued += 1
        self._runner.run(key, body, self._st, inputs)
        if stage is not None:
            metrics.add_stage(stage, time.perf_counter() - rec.t_issue)
        self._step_ticks.append(rec)
        metrics.ticks.append(rec)
        return rec

    def _fetch(self, rec: TickRecord) -> PackedFetch:
        """The body's packed rows and stamps on their way to the host; its
        record gets the stamps when they land."""
        fetch = self._runner.download(self._st.packed, self._tick.stamps)
        fetch.on_land = functools.partial(self._landed, rec)
        self._unlanded.append(fetch)
        return fetch

    def _landed(self, rec: TickRecord, stamps: np.ndarray) -> None:
        host, taken = self._clock.host, STAMPS_TAKEN[rec.key]
        rec.stamps = tuple(host(ns) if i in taken else None for i, ns in enumerate(stamps))

    def _keep_clock(self) -> None:
        """The device clock mapped onto the host's afresh once the mapping is
        ``CLOCK_PERIOD_S`` old (the host's own clock on the CPU)."""
        if self._clock is None or (self.device.type == "cuda"
                                   and time.perf_counter() - self._clock.base_s > CLOCK_PERIOD_S):
            self._clock = calibrate(self.device)

    def _land_stamps(self) -> None:
        """Stamps of every fetch that has landed, oldest first, without
        waiting."""
        q = self._unlanded
        while q and q[0].ready():
            q.popleft().get()

    def _after_chunk(self, rec: TickRecord, metrics) -> PackedFetch:
        """Download the chunk tick's packed rows (the finalize traces and
        the endpoint statistics), marking the tick in flight."""
        self.device_dispatches += 1
        self._pending_reset[:] = False
        with StageTimer("stream_download", metrics):
            fetch = self._fetch(rec)
        self._tick_fetch, self._tick_rec = fetch, rec
        self._inflight.append(fetch)
        return fetch

    def _am_bucket(self, head: tuple, lanes: int) -> int:
        """The AM rows of a tick whose runner key starts with ``head``: the
        smallest bucket >= ``am_rows`` whose graph at that width is
        captured, else ``am_rows``. A tick at a width that warm-up met at a
        larger bucket alone (after a stall many lanes are ready at once, at
        new widths) then replays that graph in place of capturing one on
        the serving path; on the CPU nothing is captured, and the rows are
        ``am_rows``."""
        N = self.max_streams
        rows = bucket = am_rows(lanes, N)
        graphs = self._runner.graphs
        while (*head, bucket) not in graphs:
            if bucket == N:
                return rows
            bucket = min(2 * bucket, N)
        return bucket

    def _step_fused(self, prep, n_valid, chunk_t0, chunk_have, flushed, metrics) -> None:
        """The fused tick: ONE upload (the PCM batch with the slot scalars
        in its trailing columns), ONE device body (MFCC into the feature
        ring, AM windows, i-vector fold, decode, ring write, walk), ONE
        download (the packed rows)."""
        N = self.max_streams
        if prep is not None:
            batch_t, batch, counts_before, has_new = prep
        else:
            batch_t, batch = self._host_buffer(
                (N, self._meta_cols), torch.int16 if self._wire == "i16" else torch.uint8)
            counts_before = np.zeros(N, dtype=np.int32)
            has_new = np.zeros(N, dtype=bool)
        lanes = int((n_valid > 0).sum())
        head = ("fused", batch.shape[1], str(batch.dtype))
        rows = self._am_bucket(head, lanes)
        meta = np.zeros((N, 11), dtype=np.int32)
        meta[:, 0] = n_valid
        meta[:, 1] = self._pending_reset
        meta[:, 2] = chunk_t0
        meta[:, 3] = chunk_have
        meta[:, 4] = counts_before
        meta[:, 5] = has_new
        if self._ivp is not None:
            meta[:, 6] = self._iv_pending_n
        self._stage_pitch_meta(meta)
        meta[:, 10] = lane_list(n_valid)
        self._write_meta_cols(batch, meta)
        self._pace(metrics)
        rec = self._issue((*head, rows), functools.partial(self._tick.body_fused, rows=rows),
                          [batch_t], lanes, "stream_issue_fused", metrics, rows)
        self._commit_pitch_meta()
        fetch = self._after_chunk(rec, metrics)
        if self._ivp is not None:
            # everything staged was folded this tick
            self._iv_pending_n[:] = 0
        with StageTimer("stream_book", metrics):
            for sid, state in enumerate(self.slots):
                k = int(n_valid[sid])
                if k <= 0:
                    continue
                state.out_frames += k
                if self._ivp is not None:
                    t0 = int(chunk_t0[sid])
                    self._iv_pending_n[sid] = max(0, min(self._chunk_in, int(chunk_have[sid]) - t0))
                state.frames_consumed += self._chunk_in
                if (
                    self._fin_snap[sid]
                    and state.flushed_feats
                    and state.frames_consumed >= int(self._feat_counts[sid])
                ):
                    flushed.append(sid)
        self._queue_endpoint_stats(fetch)

    def _feed_only_dispatch(self, prep, metrics) -> None:
        """A tick with audio and no ready slot: only the feature rings are
        written, with the fused tick's upload layout."""
        batch_t, batch, counts, has_new = prep
        meta = np.zeros((batch.shape[0], 10), dtype=np.int32)
        meta[:, 4] = counts
        meta[:, 5] = has_new
        self._stage_pitch_meta(meta)
        self._write_meta_cols(batch, meta)
        self._issue(("feed", batch.shape[1], str(batch.dtype)), self._tick.body_feed,
                    [batch_t], 0, "stream_issue_feed", metrics)
        self._commit_pitch_meta()
        self.device_dispatches += 1

    def _plan_pitch(self) -> Optional[np.ndarray]:
        """This tick's pitch-lane plan (the reference's ``_plan_pitch``):
        each slot's window start sample, the absolute pitch frames the
        window reaches, and the flush mask (finished slots whose MFCC rows
        outrun their pitch rows: the block write repeats the newest row over
        them). Returns the pitch-matched frame count the ready loop reads,
        or None without the pitch lane."""
        if not self._pitch_device:
            return None
        shift = self._featurizer.frame_shift
        a = (self._pcm_total - self._featurizer.pitch_window) // shift * shift
        n_abs = a // shift + self._pitch_t_w
        matched = np.minimum(self._feat_counts.astype(np.int64),
                             np.maximum(self._pitch_done, n_abs))
        flush = np.zeros(self.max_streams, dtype=bool)
        for sid, state in enumerate(self.slots):
            if (
                state.active
                and not state.done
                and state.flushed_feats
                and bool(self._fin_snap[sid])
                and matched[sid] < int(self._feat_counts[sid])
            ):
                flush[sid] = True
                matched[sid] = int(self._feat_counts[sid])
        self._pitch_plan = (a, n_abs, flush)
        return matched

    def _stage_pitch_meta(self, meta: np.ndarray) -> None:
        """The plan into the upload's meta columns 7-9."""
        if self._pitch_device:
            a, _n_abs, flush = self._pitch_plan
            meta[:, 7] = a
            meta[:, 8] = self._pitch_done
            meta[:, 9] = flush

    def _commit_pitch_meta(self) -> None:
        """After a dispatch that carried the plan: the rows it promised are
        in the ring (in stream order)."""
        if self._pitch_device:
            _a, n_abs, flush = self._pitch_plan
            self._pitch_done = np.maximum(self._pitch_done, n_abs)
            self._pitch_done[flush] = self._feat_counts[flush]

    def _step_chunk(self, windows, n_valid, chunk_t0, chunk_have, flushed, metrics) -> None:
        """The device route with host features: the host's windows, the
        slot scalars and the staged i-vector inputs up, the chunk body, the
        packed rows down."""
        N = self.max_streams
        lanes = int((n_valid > 0).sum())
        rows = self._am_bucket(("chunk",), lanes)
        meta = np.stack([n_valid, self._pending_reset, chunk_t0, chunk_have, lane_list(n_valid)],
                        axis=1)
        inputs = [windows, meta.astype(np.int32)]
        if self._ivp is not None:
            iv_wins, iv_ws = self._pending_ivector_inputs()
            inputs.append(iv_ws)
            if not self._iv_carry_device:
                inputs.append(iv_wins)
        else:
            inputs.append(np.zeros((N, self._chunk_in), np.float32))
        host = []
        for a in inputs:
            t, arr = self._host_buffer(a.shape, torch.from_numpy(a).dtype)
            arr[...] = a
            host.append(t)
        self._pace(metrics)
        rec = self._issue(("chunk", rows), functools.partial(self._tick.body_chunk, rows=rows),
                          host, lanes, "stream_issue_chunk", metrics, rows)
        fetch = self._after_chunk(rec, metrics)
        if self._ivp is not None:
            for s in self.slots:
                if s.iv_pending_w is not None:
                    s.iv_pending_w = np.zeros(self._chunk_in, np.float32)
        for sid, state in enumerate(self.slots):
            k = int(n_valid[sid])
            if k <= 0:
                continue
            state.out_frames += k
            if self._ivp is not None:
                t0, have = int(chunk_t0[sid]), int(chunk_have[sid])
                if self._iv_carry_device:
                    # the window is cut on the device; only the weights of
                    # the chunk's real frames come from the host
                    state.iv_pending_w = (
                        np.arange(t0, t0 + self._chunk_in) < min(t0 + self._chunk_in, have)
                    ).astype(np.float32)
                else:
                    self._stage_ivector_stats(sid, t0, have, None, None)
            state.frames_consumed += self._chunk_in
            if (
                self.pool.is_finished(sid)
                and state.flushed_feats
                and state.frames_consumed >= state.feats.shape[0]
            ):
                flushed.append(sid)
        self._queue_endpoint_stats(fetch)

    def _queue_endpoint_stats(self, fetch: PackedFetch) -> None:
        """Keep the tick's statistics for a later tick's endpoint rules,
        with the slots' generations and their decoded frames after it."""
        if self._ep_device:
            self._ep_stats_pending.append((
                fetch,
                [s.gen for s in self.slots],
                np.array([s.out_frames for s in self.slots], dtype=np.int64),
            ))

    def _step_device(self) -> int:
        """The device route's tick (module docstring)."""
        self._t_enter = time.perf_counter()
        self._wait_s = 0.0
        self._step_ticks = []
        metrics = get_metrics()
        self._keep_clock()
        if self._unlanded:
            self._land_stamps()
        N = self.max_streams
        device_feats = self._device_feats
        windows = None
        if not device_feats:
            W = self._win_hi - self._win_lo
            windows = np.zeros((N, W, self._featurizer.feat_dim), dtype=np.float32)
        n_valid = np.zeros(N, dtype=np.int32)
        chunk_t0 = np.zeros(N, dtype=np.int64)
        chunk_have = np.zeros(N, dtype=np.int64)
        flushed: List[int] = []
        if self._pending_finalize:
            self._harvest_finalizes(block=False)
        prep = None
        self._pending_drain = False
        self._tick_fetch = self._tick_rec = None
        with StageTimer("stream_features", metrics):
            if device_feats:
                prep = self._prep_features_device()
            else:
                self._drain_features_all()
        pitch_matched = self._plan_pitch() if device_feats else None
        # self time: the wait for a row inside is stream_wait_ep
        t0, w0 = time.perf_counter(), self._wait_s
        ep_fired: Set[int] = (
            self._apply_endpoint_stats()
            if self._ep_device and self._ep_stats_pending
            else set()
        )
        metrics.add_stage("stream_ep_apply", time.perf_counter() - t0 - (self._wait_s - w0))
        need = self._chunk_in + max(self._win_hi - self._chunk_in, 0)
        with StageTimer("stream_ready", metrics):
            for sid, state in enumerate(self.slots):
                if not state.active or state.done:
                    continue
                if sid in self._quarantined:
                    flushed.append(sid)
                    continue
                if sid in ep_fired:
                    _LOGGER.debug("endpoint fired for stream %d", sid)
                    flushed.append(sid)
                    continue
                t0 = state.frames_consumed
                if device_feats:
                    # a pitch model's rows past the pitch-matched count have
                    # no pitch yet: not readable
                    have = int(self._feat_counts[sid] if pitch_matched is None
                               else pitch_matched[sid])
                    finished = bool(self._fin_snap[sid])
                else:
                    have = state.feats.shape[0]
                    finished = self.pool.is_finished(sid)
                if have < t0 + need and not (finished and state.flushed_feats and t0 < have):
                    if finished and state.flushed_feats and t0 >= have:
                        flushed.append(sid)
                    continue
                real_out = self._chunk_out
                if finished:
                    real_out = min(real_out, max(0, -(-(have - t0) // self.am.subsampling)))
                if state.out_frames + real_out > self._ring_frames:
                    # decoded past the ring, the walk would read overwritten
                    # rows: finalize with the frames so far instead
                    self._quarantine(sid, "backpointer ring", self._ring_frames)
                    flushed.append(sid)
                    continue
                if windows is not None:
                    idx = np.clip(np.arange(t0 + self._win_lo, t0 + self._win_hi), 0,
                                  max(have - 1, 0))
                    windows[sid] = state.feats[idx]
                n_valid[sid] = real_out
                chunk_t0[sid] = t0
                chunk_have[sid] = have
        lanes = int((n_valid > 0).sum())
        if device_feats:
            if lanes:
                self._step_fused(prep, n_valid, chunk_t0, chunk_have, flushed, metrics)
            elif prep is not None:
                self._feed_only_dispatch(prep, metrics)
        elif lanes:
            self._step_chunk(windows, n_valid, chunk_t0, chunk_have, flushed, metrics)
        with StageTimer("stream_finalize", metrics):
            self._finalize_device(flushed, metrics)
        t_return = time.perf_counter()
        for rec in self._step_ticks:
            rec.t_return, rec.wait_s = t_return, self._wait_s
        return lanes

    def _apply_endpoint_stats(self) -> Set[int]:
        """The endpoint rules on the newest landed tick's statistics
        (trailing-silence frames, contains-nonsilence, exact relative final
        cost from the packed row), for slots not recycled since (slot
        generation) and not finalized; the lag rule of the module
        docstring."""
        pending = self._ep_stats_pending
        newest = None
        for i in range(len(pending) - 1, -1, -1):
            if pending[i][0].ready():
                newest = i
                break
        if newest is None:
            if self._ep_stats_deferred >= PIPELINE_DEPTH + 2:
                newest = 0  # wait for the oldest
            else:
                self._ep_stats_deferred += 1
                return set()
        fetch, gens, out_snap = pending[newest]
        for _ in range(newest + 1):
            pending.popleft()
        t0 = time.perf_counter()
        p = fetch.get(block=True)
        self._waited("stream_wait_ep", time.perf_counter() - t0, get_metrics())
        self._ep_stats_deferred = 0
        F = p.shape[1] - PACKED_STAT_COLS
        trail, nonsil = p[:, F + 2], p[:, F + 3]
        rel = (p[:, F + 6].astype(np.uint32) | (p[:, F + 7].astype(np.uint32) << 16)).view(np.float32)
        fired: Set[int] = set()
        out_frame_sec = self.am.subsampling * self._frame_shift / 16000.0
        for sid, state in enumerate(self.slots):
            if not state.active or state.done or state.gen != gens[sid] or out_snap[sid] <= 0:
                continue
            if self.endpointing.should_endpoint(
                contains_nonsilence=bool(nonsil[sid]),
                trailing_silence=float(trail[sid]) * out_frame_sec,
                relative_cost=float(rel[sid]),
                utterance_length=float(out_snap[sid]) * out_frame_sec,
            ):
                fired.add(sid)
        return fired

    def _finalize_device(self, flushed: List[int], metrics) -> None:
        """Mark flushed streams done; their transcripts come from this
        tick's packed rows (the walk ran for every slot), or, on a tick
        that decoded nothing, from one walk alone. The rows are assembled
        when they land (``_harvest_finalizes``)."""
        todo = []
        for sid in flushed:
            state = self.slots[sid]
            if state.done:
                continue
            state.done = True
            get_metrics().add_audio(state.frames_consumed * self._frame_shift / 16000.0,
                                    utterances=1)
            if state.out_frames <= 0:
                state.result = []
                self._stream_recs.pop((sid, state.gen), None)
                continue
            todo.append(sid)
        if not todo:
            return
        fetch = self._tick_fetch
        if fetch is None:
            # timed as part of stream_finalize
            rec = self._issue(("finalize",), self._tick.body_finalize, [], 0, None, metrics)
            self.device_dispatches += 1
            fetch = self._tick_fetch = self._fetch(rec)
            self._tick_rec = rec
        for sid in todo:
            self._flush_record(sid, self._tick_rec)
        self._pending_finalize.append((
            todo,
            [self.slots[sid].gen for sid in todo],
            [self.slots[sid].out_frames for sid in todo],
            fetch,
        ))

    def _flush_record(self, sid: int, tick: TickRecord) -> None:
        """The stream's record learns its flushing tick (a stream flushed
        without ``finish()`` gets one here, with no finish stamp)."""
        key = (sid, self.slots[sid].gen)
        rec = self._stream_recs.get(key)
        if rec is None:
            rec = self._stream_recs[key] = StreamRecord(self._trace_src, *key)
            get_metrics().streams.append(rec)
        rec.tick_flush, rec.t_flush, rec.flush = tick.tick, tick.t_issue, tick

    def _harvest_finalizes(self, block: bool = True) -> None:
        """Words of every finalized stream whose packed row has landed
        (``block`` waits for the rest). A slot closed since its flush gets
        its result in the retired store, under close()'s ticket."""
        graph = self.graph
        metrics = get_metrics()
        # self time: a blocking wait for a row is stream_wait_fin
        t_start, w_start = time.perf_counter(), self._wait_s
        pending, self._pending_finalize = self._pending_finalize, []
        for entry in pending:
            group, gens, frames, fetch = entry
            if block:
                t0 = time.perf_counter()
                packed = fetch.get()
                self._waited("stream_wait_fin", time.perf_counter() - t0, metrics)
            else:
                packed = fetch.get(block=False)
            if packed is None:
                self._pending_finalize.append(entry)
                continue
            F = packed.shape[1] - PACKED_STAT_COLS
            for sid, gen, n in zip(group, gens, frames):
                res: Optional[List[str]] = None
                trace = packed[sid, :n].astype(np.int32) - 2
                if packed[sid, F + 1] == 0 or (trace == -1).any():
                    res = []  # no final state reached, or a dead frame
                else:
                    real = trace[trace >= 0]
                    first = int(graph.arc_src[real[0]]) if real.shape[0] else int(packed[sid, F])
                    words: List[int] = list(graph.words_of(int(graph.init_wseq[first])))
                    wseqs = graph.arc_wseq[real]
                    for wid in wseqs[wseqs != 0]:
                        words.extend(graph.words_of(int(wid)))
                    words.extend(graph.words_of(int(graph.final_wseq[int(packed[sid, F])])))
                    res = self._words_to_result(words)
                state = self.slots[sid]
                if state.gen != gen:
                    self._retire((sid, gen), res)
                else:
                    state.result = res
                rec = self._stream_recs.pop((sid, gen), None)
                if rec is not None:
                    stamps = rec.flush.stamps if rec.flush is not None else None
                    rec.s5, rec.flush = (None if stamps is None else stamps[5]), None
                    rec.t_result = time.perf_counter()
        metrics.add_stage("stream_harvest",
                          time.perf_counter() - t_start - (self._wait_s - w_start))

    # -- results -------------------------------------------------------------------

    _FUZZY_CACHE_MAX = 4096

    def _words_to_result(self, words: List[int]) -> List[str]:
        """Fuzzy tail and ``decode_meta``, memoized per word sequence."""
        key = tuple(words)
        cached = self._fuzzy_cache.get(key)
        if cached is not None:
            return list(cached)
        lang = self.fuzzy_lang
        result = None
        if lang.g_fuzzy is not None and self.max_fuzzy_cost is not None:
            fuzzy = get_fuzzy_text([words], lang.g_fuzzy, lang.words)
            if fuzzy is not None and fuzzy[1] <= self.max_fuzzy_cost:
                result = [decode_meta(fuzzy[0])]
        if result is None:
            text = []
            for wid in words:
                sym = self.artifacts.words.find_id(wid)
                if sym and sym not in ("<eps>", "#0", "<s>", "</s>"):
                    text.append(sym)
            result = [decode_meta(" ".join(text))]
        if len(self._fuzzy_cache) >= self._FUZZY_CACHE_MAX:
            self._fuzzy_cache.clear()
        self._fuzzy_cache[key] = result
        return list(result)


class MeshScheduler:
    """``StreamScheduler(mesh=...)``: the slots in contiguous blocks of
    ``max_streams / mesh.size``, one block per mesh device, each block a
    ``StreamScheduler`` of its own on its device (its own pool, device
    state, tick and captures), driven with that device current. Slot
    ``sid`` is slot ``sid % per`` of block ``sid // per``. A tick steps
    the blocks one after another from the calling thread; a block's step
    on the device route launches its tick and collects only what has
    landed, so it does not wait for its card. Admission fills the blocks
    evenly (the reference's ``_open_slot``), so at partial occupancy no
    card ticks empty slots while another holds them all. The constructor's
    ``device`` is not read: the devices are the mesh's. There is no
    warm-start manifest under a mesh, as the reference keeps no AOT store
    under one; ``warmup`` warms every block."""

    def __init__(self, *args, mesh, **kwargs):
        bound = inspect.signature(StreamScheduler.__init__).bind(None, *args, **kwargs)
        bound.apply_defaults()
        conf = dict(bound.arguments)
        for name in ("self", "mesh", "device"):
            conf.pop(name)
        N = conf["max_streams"]
        if N % mesh.size:
            raise ValueError(f"max_streams={N} must be a multiple of the mesh size {mesh.size}")
        self.mesh = mesh
        self.max_streams = N
        self._per = N // mesh.size
        conf["max_streams"] = self._per
        self.shards: List[StreamScheduler] = []
        for dev in mesh.devices:
            with on_device(dev):
                self.shards.append(StreamScheduler(**conf, device=dev))
        # every block takes the same route: the first block's flags
        first = self.shards[0]
        self._device_bp, self._device_feats = first._device_bp, first._device_feats
        self._ep_device, self._sw_device = first._ep_device, first._sw_device
        self._wire = first._wire

    def _call(self, sid: int, method: str, *args, **kwargs):
        """``method`` of the block holding slot ``sid``, on its slot there,
        with the block's device current."""
        shard = self.shards[sid // self._per]
        with on_device(shard.device):
            return getattr(shard, method)(sid % self._per, *args, **kwargs)

    @property
    def slots(self) -> List[_SlotState]:
        return [s for shard in self.shards for s in shard.slots]

    @property
    def device_dispatches(self) -> int:
        return sum(shard.device_dispatches for shard in self.shards)

    @property
    def kernel_launches(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for shard in self.shards:
            for k, v in shard.kernel_launches.items():
                out[k] = out.get(k, 0) + v
        return out

    @property
    def active_streams(self) -> int:
        return sum(shard.active_streams for shard in self.shards)

    def open_stream(self) -> int:
        """Admit a stream into the block with the fewest open slots (the
        lowest block on a tie); -1 when every slot is taken."""
        occupancy = [sum(s.active for s in shard.slots) for shard in self.shards]
        for b in sorted(range(len(self.shards)), key=lambda i: (occupancy[i], i)):
            local = self.shards[b].open_stream()
            if local >= 0:
                return b * self._per + local
        return -1

    def feed(self, sid: int, pcm: np.ndarray) -> int:
        return self._call(sid, "feed", pcm)

    def feed_many(self, sids: np.ndarray, pcm: np.ndarray) -> np.ndarray:
        sids = np.asarray(sids)
        out = np.zeros(sids.shape[0], dtype=np.int64)
        for b, shard in enumerate(self.shards):
            rows = np.flatnonzero(sids // self._per == b)
            if rows.size:
                out[rows] = shard.feed_many(sids[rows] % self._per, pcm[rows])
        return out

    def finish(self, sid: int) -> None:
        self._call(sid, "finish")

    def poll(self, sid: int, block: bool = True) -> Optional[List[str]]:
        return self._call(sid, "poll", block=block)

    def close(self, sid: int) -> Tuple[int, int]:
        return sid, self._call(sid, "close")[1]

    def take_result(
        self, ticket: Tuple[int, int], block: bool = False
    ) -> Optional[List[str]]:
        shard = self.shards[ticket[0] // self._per]
        with on_device(shard.device):
            return shard.take_result((ticket[0] % self._per, ticket[1]), block=block)

    def error(self, sid: int) -> Optional[str]:
        return self._call(sid, "error")

    def step(self) -> int:
        n = 0
        for shard in self.shards:
            with on_device(shard.device):
                n += shard.step()
        return n

    def run_until_idle(self, max_steps: int = 10000) -> None:
        for _ in range(max_steps):
            if self.step() == 0 and not any(shard._pending_drain for shard in self.shards):
                return

    def warmup(self, seconds: float = 3.0) -> None:
        for shard in self.shards:
            with on_device(shard.device):
                shard.warmup(seconds)

    def save_aot(self, seconds: float = 3.0) -> Path:
        raise RuntimeError("a warm-start manifest needs the fused device-feature route and no mesh")
