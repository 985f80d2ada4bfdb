"""Batched streaming on one device: many PCM streams, one tick at a time.

Counterpart of ``rhasspy_speech_tpu/pipeline/scheduler.py``
(``StreamScheduler``), the reference's serving path for many streams, on
its host-backpointer route: each chunk's backpointers come to the host,
where the endpoint rules, the silence weights and the final backtrace read
them. A fixed pool of ``max_streams`` slots (the copied
``native.StreamPool``) holds each stream's unread PCM, and one ``step()``
(a tick) runs one pass over every slot:

1. features: each slot's new PCM (at most the drain cap a tick) joins the
   samples its featurizer carries, and ONE call of
   ``ops.mfcc_cuda.mfcc_batch`` at ``[max_streams, L]`` computes every
   slot's new MFCC rows (row = slot; ``L = _pcm_bucket(longest buffer)``).
   A frame's row does not depend on how many frames the call holds, so
   the rows equal the single-stream featurizer's;
2. readiness: a slot is ready when its rows cover a chunk (``21`` input
   frames at the default ``chunk_out_frames=7``) and the model's right
   context, or when its stream is finished and rows are left (a partial
   last chunk). Every slot gets its window ``[W, D]``, clamped at the
   edges, and its valid output frames ``n_valid`` (0 for a slot with
   nothing to do);
3. the device step, the counterpart of the reference's ``batch_chunk``:
   slots reopened since the last tick go back to the graph's initial alpha
   and zero i-vector statistics; the previous tick's pending i-vector
   windows and weights fold into each slot's ``(gamma, X)`` (a zero weight
   row leaves a slot's statistics as they were, bit for bit); the chunk
   plan (``compile_nnet3(spec, chunk_out_frames)``) runs at ``[N, W, D]``;
   and ONE ``ops.viterbi_cuda.viterbi_decode`` launch decodes every slot
   with ``alpha0`` the carried alpha ``[N, S]`` and ``lengths = n_valid``
   (a slot with length 0 gets its alpha back untouched). ``chunk_decoder``
   is ``"dense"`` (that launch) or, for a graph past the Viterbi kernel's
   reach on the card, ``"scan"``: the plain ``ops.decoder.viterbi`` with
   ``alpha0``, and no kernel launch;
4. host side: each ready slot's backpointer rows ``[:n_valid]`` are kept;
   its i-vector window and weights are staged for the next tick's fold
   (with ``silence_weight``, silence frames of the chunk's best path weigh
   ``silence_weight``); with ``endpointing`` the endpoint rules run on the
   slot's best path; a finished or endpointed stream is backtraced into
   its transcript.

On the CPU the same calls run the kernels' plain twins. On the card a tick
with new audio makes one MFCC launch (a model with ``snip_edges=false``
adds one on the tick that flushes a stream's reflected tail), and a tick
with a ready slot one Viterbi launch within the kernel's reach, none past
it; a build or launch failure raises.

Endpoint timing: the port decides the endpoint on the tick's own
backpointers, as the reference's host route does. The reference's device
route decides it from statistics that land one or more chunks later, so
the tick on which an endpoint fires may differ from the port's; the
transcripts are the same.

Not here yet (ROADMAP Queue 1, items 12b and 12c): the device-resident
feature and backpointer rings, the whole-path walk and packed statistics,
endpointing and silence weighting on the device, the tick captured as one
CUDA graph, and the background fetches the reference needs on its TPU
transport. ``mesh`` and the ``mulaw`` / ``adpcm`` wires (item 16), a
bfloat16 AM and recurrent plans (item 4), GMM models (item 13) and pitch
features (item 14) raise ``NotImplementedError``.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..fst.core import SymbolTable
from ..grammar.fst import decode_meta
from ..models.nnet3 import compile_nnet3
from ..native import StreamPool
from ..ops import decoder as plain_decoder
from ..ops.decoder import _COMPACT_BP_MAX_ARC, DecodeGraph, backtrace_words
from ..ops.ivector import (
    apply_lda,
    gmm_log_likes,
    gselect_posteriors,
    solve_ivector,
    splice_frames,
)
from ..ops.mfcc_cuda import mfcc_batch
from ..ops.viterbi_cuda import kernel_states, viterbi_decode
from ..utils.metrics import StageTimer, get_metrics
from .artifacts import LangArtifacts
from .endpoint import EndpointConfig, silence_pdfs_from_model, trailing_silence_frames
from .fuzzy import get_fuzzy_text
from .streaming_features import (
    StreamFeaturizer,
    silence_weights_from_chunk,
    stage_ivector_window,
)
from .transcribe import AcousticModel, _not_ported, select_decoder

_LOGGER = logging.getLogger(__name__)

CHUNK_OUT_FRAMES = 7

# Per-slot per-tick drain cap floor (samples): the scheduler's cap is the
# larger of this and twice a chunk's audio, so a burst-fed stream drains at
# about twice the rate its chunks consume it, and the MFCC call's width
# stays within a few buckets. Audio past the cap drains on later ticks.
_DRAIN_CAP = 12800


def _pcm_bucket(n: int, cap: int = _DRAIN_CAP) -> int:
    """Padded PCM width of a tick's MFCC call: 800-sample (0.05 s) steps
    with a 1,600-sample floor, at most the drain cap. Steady serving keeps
    to one width, which a captured tick needs (ROADMAP item 12b)."""
    n = min(n, cap)
    return max(1600, -(-n // 800) * 800)


@dataclass
class _SlotState:
    active: bool = False
    feats: Optional[np.ndarray] = None  # [T, D] feature rows so far
    feat_state: object = None  # StreamFeatState
    frames_consumed: int = 0  # input frames given to the AM so far
    out_frames: int = 0
    bps: List[np.ndarray] = field(default_factory=list)  # [chunk][k, S] int32 arc ids
    done: bool = False
    result: Optional[List[str]] = None
    flushed_feats: bool = False
    iv_pending_win: Optional[np.ndarray] = None
    iv_pending_w: Optional[np.ndarray] = None
    # bumped on open AND close: a result is delivered to the stream whose
    # ticket close() returned, never to the slot's next stream
    gen: int = 0


class StreamScheduler:
    """Admit / feed / step / poll interface over a fixed batch of stream
    slots (see the module docstring)."""

    # Calls of the MFCC batch and of the device step since construction:
    # a tick makes at most one of each.
    device_dispatches = 0

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
        if mesh is not None:
            raise _not_ported("a stream mesh (mesh=)", "item 16")
        if wire in ("mulaw", "adpcm"):
            raise _not_ported(f"the {wire!r} serving wire", "item 16")
        if wire != "i16":
            raise ValueError(f"wire must be 'i16', 'mulaw' or 'adpcm', got {wire!r}")
        self.device = resolve_device(device)
        self._chunk_out = int(chunk_out_frames)
        # raises for bf16 (item 4), GMM (item 13) and pitch (item 14) models
        self.am = AcousticModel(Path(model_dir), compute_dtype=compute_dtype, device=self.device)
        self.artifacts = LangArtifacts.load(graph_dir)
        if self.artifacts.graph is None:
            raise ValueError(f"no graph.npz in {graph_dir}")
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
        # raises for a recurrent plan (item 4)
        self._chunk_model = compile_nnet3(
            self.am.spec, self._chunk_out, subsampling=self.am.subsampling, device=self.device
        )
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

        # the 1-best chunk decoder by the batch transcriber's rule: "dense"
        # (the Viterbi kernel on a card), or "scan" past the kernel's reach
        S = self.graph.num_states
        self.chunk_decoder = select_decoder(
            S, max_streams, self._chunk_out, 1, 7000, budget=1 << 62,
            num_arcs=self.graph.num_arcs,
            kernel_states=kernel_states(self.device),
        )[0]
        self._compact = self.graph.num_arcs <= _COMPACT_BP_MAX_ARC

        # device state of every slot, reset through _pending_reset
        self._alpha = self.device_graph.init_weight[None, :].repeat(max_streams, 1)
        self._pending_reset = np.zeros(max_streams, dtype=bool)
        ivp = self._ivp
        if ivp is not None:
            num_gauss, lda_dim = int(ivp.gconsts.shape[0]), int(ivp.lda.shape[0])
            self._iv_gamma = torch.zeros((max_streams, num_gauss), device=self.device)
            self._iv_X = torch.zeros((max_streams, num_gauss, lda_dim), device=self.device)
            self._iv_win_shape = (
                ivp.splice_left + self._chunk_in + ivp.splice_right, cfg.num_ceps
            )

        self._fuzzy_cache: Dict[tuple, List[str]] = {}
        # results of closed streams, keyed by close()'s (sid, gen) ticket
        self._retired: Dict[Tuple[int, int], List[str]] = {}
        self._retired_cap = max(64, 4 * max_streams)

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
        state.flushed_feats = False
        if self._ivp is not None:
            state.iv_pending_win = np.zeros(self._iv_win_shape, np.float32)
            state.iv_pending_w = np.zeros(self._chunk_in, np.float32)
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

    def poll(self, sid: int, block: bool = True) -> Optional[List[str]]:
        """The stream's transcript once it is decoded; None before. The
        backtrace runs in the tick that finishes the stream, so ``block``
        changes nothing here."""
        state = self.slots[sid]
        return state.result if state.done else None

    def close(self, sid: int) -> Tuple[int, int]:
        """Release the slot for reuse; returns a ``(sid, gen)`` ticket that
        ``take_result`` redeems for a finished stream's transcript."""
        state = self.slots[sid]
        ticket = (sid, state.gen)
        if state.done and state.result is not None:
            self._retire(ticket, state.result)
        state.gen += 1
        state.active = False
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
        """A closed stream's transcript by close()'s ticket, once; None
        for a ticket of a stream that had not finished."""
        return self._retired.pop(ticket, None)

    def error(self, sid: int) -> Optional[str]:
        """Always None: the reference reports a stream it cut off for
        outgrowing its device rings, and this route has no such ring."""
        return None

    @property
    def active_streams(self) -> int:
        return sum(1 for s in self.slots if s.active and not s.done)

    # -- the tick --------------------------------------------------------------

    def _drain_features_all(self) -> None:
        """Move pool PCM into each slot's feature rows: ONE batched MFCC
        call over ``[max_streams, L]`` for every slot with a new frame;
        then the featurizer's flush for finished streams."""
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

    def _features(self, batch: np.ndarray) -> np.ndarray:
        """MFCC rows [N, T, C] of the tick's PCM batch [N, L]: upload, one
        ``mfcc_batch`` call, download."""
        self.device_dispatches += 1
        # stream_params: with snip_edges=false the buffers are in the
        # featurizer's virtual-signal space, framed as snip_edges=true
        samples = torch.as_tensor(batch, device=self.device)
        return mfcc_batch(self._featurizer.stream_params, samples).cpu().numpy()

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
        iv_wins = np.stack([s.iv_pending_win if s.iv_pending_win is not None
                            else np.zeros(self._iv_win_shape, np.float32) for s in self.slots])
        iv_ws = np.stack([s.iv_pending_w if s.iv_pending_w is not None
                          else np.zeros(self._chunk_in, np.float32) for s in self.slots])
        return up(windows), up(n_valid), up(iv_wins), up(iv_ws)

    def _reset_lanes(self) -> None:
        """Slots reopened since the last device step start again from the
        graph's initial alpha (what a fresh single stream starts from) and
        zero i-vector statistics."""
        lanes = np.flatnonzero(self._pending_reset)
        if lanes.size:
            idx = torch.as_tensor(lanes, device=self.device)
            self._alpha[idx] = self.device_graph.init_weight
            if self._ivp is not None:
                self._iv_gamma[idx] = 0.0
                self._iv_X[idx] = 0.0
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
        sl, sr = ivp.splice_left, ivp.splice_right
        spliced = splice_frames(iv_wins, sl, sr)[:, sl : sl + self._chunk_in]
        lda_feats = apply_lda(spliced, ivp)
        post = gselect_posteriors(gmm_log_likes(lda_feats, ivp), ivp) * iv_ws[:, :, None]
        self._iv_gamma += post.sum(dim=1)
        self._iv_X += torch.einsum("nti,ntd->nid", post, lda_feats)
        return solve_ivector(self._iv_gamma, self._iv_X, ivp)

    def _acoustic(self, windows: torch.Tensor, ivec: Optional[torch.Tensor]) -> torch.Tensor:
        """Every slot's chunk log-probs [N, chunk_out_frames, P]."""
        return self._chunk_model(windows, ivec)

    def _decode(self, log_probs: torch.Tensor, lengths: torch.Tensor, rows: int) -> torch.Tensor:
        """Advance every slot's alpha over its ``lengths`` frames; returns
        the first ``rows`` frames' backpointers [rows, N, S] on the device
        (uint16 ``arc + 2`` or int32 arc ids; a slot's rows at or past its
        length are not defined)."""
        if self.chunk_decoder == "dense":
            out = viterbi_decode(
                self.device_graph, log_probs, self.acoustic_scale, lengths,
                return_forward=True, alpha0=self._alpha,
            )
            alpha, bps = out[3], out[4]
        else:
            alpha, bps = plain_decoder.viterbi(
                self.device_graph, log_probs, self.acoustic_scale, lengths,
                compact_bp=self._compact, alpha0=self._alpha,
            )
        self._alpha = alpha
        return bps[:rows]

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
        log_probs = self._acoustic(windows_d, ivec)
        bps = self._decode(log_probs, lengths, int(n_valid.max()))
        self.device_dispatches += 1
        if self._ivp is not None:
            # every slot's pending statistics are folded now
            for s in self.slots:
                if s.iv_pending_w is not None:
                    s.iv_pending_w = np.zeros(self._chunk_in, np.float32)
        return self._download(bps)

    def step(self) -> int:
        """One tick over every slot; returns the number of slots that
        decoded a chunk."""
        metrics = get_metrics()
        self._pending_drain = False
        with StageTimer("stream_features", metrics):
            self._drain_features_all()
        with StageTimer("stream_ready", metrics):
            windows, n_valid, chunk_t0, chunk_have, flushed = self._ready()
        lanes = int((n_valid > 0).sum())
        alpha_np = None
        if lanes:
            with StageTimer("stream_chunk", metrics):
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

    def run_until_idle(self, max_steps: int = 10000) -> None:
        """Step until no slot has work. Streams waiting on more PCM (or an
        endpoint) stop the loop too; audio left in the pool past a tick's
        drain cap keeps it going."""
        for _ in range(max_steps):
            if self.step() == 0 and not self._pending_drain:
                return

    # -- host side ---------------------------------------------------------------

    def _stage_ivector_stats(
        self, sid: int, t0: int, have: int, rows: np.ndarray, alpha_np: Optional[np.ndarray]
    ) -> None:
        """This slot's chunk (window, weights) for the next tick's fold
        (``pipeline/stream.py`` stages the same for one stream)."""
        state = self.slots[sid]
        ivp = self._ivp
        num_ceps = self.am.frontend_config.num_ceps
        win, w = stage_ivector_window(
            state.feats[:, :num_ceps], t0, self._chunk_in, have,
            ivp.splice_left, ivp.splice_right, self.am.ivector_cmvn_stats,
        )
        if self._weigh_silence:
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
        """The endpoint rules on one stream after its chunk."""
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
