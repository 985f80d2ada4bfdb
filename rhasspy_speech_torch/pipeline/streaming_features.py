"""Incremental per-stream feature assembly: base MFCC rows as PCM arrives.

Counterpart of ``rhasspy_speech_tpu/pipeline/streaming_features.py``. The
batch path (``AcousticModel.features``) computes MFCC over a whole utterance
at once; streaming needs the same rows to appear as PCM arrives. A frame
depends only on its own window of samples, so a buffer that carries each
push's unconsumed tail reproduces the batch rows: bit for bit on one
device, because both the MFCC kernel (one warp a frame) and its plain
version compute a frame from its window alone, whatever else the call
holds. ``StreamFeaturizer.push`` calls ``ops.mfcc_cuda.mfcc_batch`` on the
acoustic model's device, so on the card the MFCC kernel runs on every push
that completes a frame. The scheduler of many streams batches that call
instead: ``prepare_mfcc_buf`` gives each stream's buffer, one MFCC call
covers them all, and ``commit_mfcc`` and ``push_with_base`` take the rows
back.

Pitch features are not ported (ROADMAP Queue 1, item 14): ``AcousticModel``
refuses a pitch model, and the featurizer's pitch half
(``pitch_window_array``, ``consume_pitch_rows``, ``_extract_pitch``,
``merge_pitch``) raises ``NotImplementedError``.

``_reflect_idx``, the framing bookkeeping of ``StreamFeaturizer``,
``stage_ivector_window``, ``silence_weights_from_chunk`` and
``online_cmvn_numpy`` are NumPy code copied from the JAX module, which
imports JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..ops.frontend import make_frontend_params
from ..ops.mfcc_cuda import mfcc_batch


def _pitch_not_ported() -> NotImplementedError:
    return NotImplementedError(
        "streaming pitch features are not ported yet (ROADMAP Queue 1, item 14)"
    )

def _reflect_idx(idx: np.ndarray, n: int) -> np.ndarray:
    """Edge-reflected sample indices, the exact twin of
    ops/frontend.frame_indices' snip_edges=false reflection
    (feature-window.cc ExtractWindow:199-216)."""
    idx = np.asarray(idx)
    for _ in range(2):  # repeated reflection for pathological lengths
        idx = np.where(idx < 0, -idx - 1, idx)
        idx = np.where(idx >= n, 2 * n - 1 - idx, idx)
    return np.clip(idx, 0, max(n - 1, 0))


class StreamFeatState:
    """Per-stream incremental feature state."""

    def __init__(self, feat_dim: int, num_ceps: int):
        self.mfcc_tail = np.zeros(0, dtype=np.float32)  # < frame window
        self.total_samples = 0
        # snip_edges=false bookkeeping (see StreamFeaturizer): raw
        # samples consumed into the MFCC pipeline, whether the virtual
        # signal's reflected prefix has been materialized, the raw
        # signal's last samples (suffix reflection source), and whether
        # the flush suffix was already emitted
        self.raw_total = 0
        self.virt_started = False
        self.last_raw = np.zeros(0, dtype=np.float32)
        self.suffix_done = False


class StreamFeaturizer:
    """Turns PCM pushes into finalized [k, feat_dim] feature rows."""

    def __init__(self, am):
        self.am = am
        cfg = am.frontend_config
        self.frame_len = cfg.frame_length
        self.frame_shift = cfg.frame_shift
        self.num_ceps = cfg.num_ceps
        if getattr(am, "pitch_config", None) is not None:
            raise _pitch_not_ported()
        self.has_pitch = False
        self.snip = cfg.snip_edges
        # snip_edges=false: centered frames reflecting at the UTTERANCE
        # edges (feature-window.cc FirstSampleOfFrame:30-41,
        # ExtractWindow:199-216). Streamed as a VIRTUAL SIGNAL: a
        # reflected prefix of flen/2 - shift/2 samples is materialized
        # once at stream start and a reflected suffix once at flush;
        # standard snip framing over the virtual signal then yields
        # bit-identical centered frames (frame f of V starts at
        # f*shift = f*shift - prefix in the raw signal = the centered
        # start), so the whole tail-carry machinery below is unchanged.
        # MFCC over virtual buffers must use snip=TRUE framing — build a
        # twin params set; the batch path keeps the real config.
        self.prefix = (
            0 if self.snip else cfg.frame_length // 2 - cfg.frame_shift // 2
        )
        if self.snip:
            self.stream_params = am.frontend_params
        else:
            self.stream_params = make_frontend_params(
                dataclasses.replace(cfg, snip_edges=True), am.device
            )
        self.feat_dim = self.num_ceps

    def new_state(self) -> StreamFeatState:
        return StreamFeatState(self.feat_dim, self.num_ceps)

    # -- base MFCC -----------------------------------------------------------

    def _virt_buf(
        self, state: StreamFeatState, pcm: np.ndarray, flush: bool = False
    ) -> Optional[np.ndarray]:
        """snip_edges=false: the tail-carry buffer in VIRTUAL-signal
        space after appending this push. Materializes the reflected
        prefix once enough raw audio arrived (raw accumulates in
        mfcc_tail until then; returns None while accumulating) and the
        reflected suffix at flush, so every downstream consumer keeps
        the standard snip framing ``1 + (len - flen) // shift``. Exact
        twin of frame_indices' double reflection — pathological
        shorter-than-prefix utterances resolve at flush with the final
        length."""
        p = self.prefix
        pcm = pcm.astype(np.float32)
        if pcm.shape[0]:
            state.raw_total += int(pcm.shape[0])
            state.last_raw = np.concatenate(
                [state.last_raw, pcm]
            )[-self.frame_len :]
        N = state.raw_total
        if not state.virt_started:
            raw = np.concatenate([state.mfcc_tail, pcm])
            if raw.shape[0] < p and not flush:
                state.mfcc_tail = raw
                return None
            state.virt_started = True
            if raw.shape[0]:
                pre = raw[_reflect_idx(np.arange(-p, 0), N)]
            else:
                pre = raw
            buf = np.concatenate([pre, raw])
        else:
            buf = np.concatenate([state.mfcc_tail, pcm])
        if flush and not state.suffix_done:
            state.suffix_done = True
            T = (N + self.frame_shift // 2) // self.frame_shift
            if T > 0:
                s = (T - 1) * self.frame_shift + self.frame_len - p - N
                if s > 0:
                    idx = _reflect_idx(np.arange(N, N + s), N)
                    base = N - state.last_raw.shape[0]
                    buf = np.concatenate(
                        [buf, state.last_raw[idx - base]]
                    )
        return buf

    def _extract_mfcc(
        self, state: StreamFeatState, pcm: np.ndarray, flush: bool = False
    ) -> np.ndarray:
        """New exact base-MFCC rows from this push (possibly empty)."""
        if self.snip:
            buf = np.concatenate([state.mfcc_tail, pcm.astype(np.float32)])
        else:
            buf = self._virt_buf(state, pcm, flush)
            if buf is None:
                return np.zeros((0, self.num_ceps), dtype=np.float32)
        if buf.shape[0] < self.frame_len:
            state.mfcc_tail = buf
            return np.zeros((0, self.num_ceps), dtype=np.float32)
        n = 1 + (buf.shape[0] - self.frame_len) // self.frame_shift
        samples = torch.as_tensor(buf[None], device=self.am.device)
        rows = mfcc_batch(self.stream_params, samples)[0].cpu().numpy()
        state.mfcc_tail = buf[n * self.frame_shift :]
        return rows

    def prepare_mfcc_buf(self, state: StreamFeatState, pcm: np.ndarray):
        """Batched-MFCC path (a scheduler of many streams): return (buf,
        n_frames) for this push, or None when no complete frame yet. The
        caller batches the MFCC over streams (using ``stream_params``
        framing) and must call commit_mfcc afterwards."""
        if self.snip:
            buf = np.concatenate([state.mfcc_tail, pcm.astype(np.float32)])
        else:
            buf = self._virt_buf(state, pcm)
            if buf is None:
                return None
        if buf.shape[0] < self.frame_len:
            state.mfcc_tail = buf
            return None
        n = 1 + (buf.shape[0] - self.frame_len) // self.frame_shift
        return buf, n

    def commit_mfcc(self, state: StreamFeatState, buf: np.ndarray, n: int) -> None:
        state.mfcc_tail = buf[n * self.frame_shift :]

    def push_with_base(
        self,
        state: StreamFeatState,
        pcm: np.ndarray,
        base_rows: np.ndarray,
        pitch_rows: Optional[np.ndarray] = None,
        flush: bool = False,
    ) -> np.ndarray:
        """Scheduler path: the caller batched the MFCC across slots
        (``prepare_mfcc_buf`` / ``commit_mfcc``); returns the newly
        finalized feature rows, which without pitch are ``base_rows``."""
        if pitch_rows is not None:
            raise _pitch_not_ported()
        pcm = np.asarray(pcm, dtype=np.float32)
        if pcm.shape[0]:
            state.total_samples += pcm.shape[0]
        return base_rows

    # -- streaming pitch (not ported) -----------------------------------------

    def pitch_window_array(self, state: StreamFeatState) -> Optional[np.ndarray]:
        raise _pitch_not_ported()

    def consume_pitch_rows(self, state: StreamFeatState, rows: np.ndarray) -> np.ndarray:
        raise _pitch_not_ported()

    def _extract_pitch(self, state: StreamFeatState) -> np.ndarray:
        raise _pitch_not_ported()

    def merge_pitch(
        self, state: StreamFeatState, pitch_rows: np.ndarray, flush: bool = False
    ) -> np.ndarray:
        raise _pitch_not_ported()

    # -- assembly ---------------------------------------------------------------

    def push(
        self, state: StreamFeatState, pcm: np.ndarray, flush: bool = False
    ) -> np.ndarray:
        """Feed PCM (possibly empty), return newly finalized feature rows
        (a model without pitch has nothing to pair the MFCC rows with, so
        they are final as they come)."""
        pcm = np.asarray(pcm, dtype=np.float32)
        if pcm.shape[0]:
            state.total_samples += pcm.shape[0]
        if pcm.shape[0] or (flush and not self.snip):
            return self._extract_mfcc(state, pcm, flush=flush)
        return np.zeros((0, self.num_ceps), dtype=np.float32)


def stage_ivector_window(
    base_feats: np.ndarray,
    t0: int,
    chunk_in: int,
    have: int,
    splice_left: int,
    splice_right: int,
    cmvn_stats: Optional[np.ndarray],
):
    """Build one chunk's i-vector stats input: the CMVN'd base-MFCC window
    [t0 - splice_left, t0 + chunk_in + splice_right) with edge clamping,
    plus per-frame weights (0 past the real feature end).

    Shared by the single-stream transcriber and the batched scheduler."""
    t_end = min(t0 + chunk_in, have)
    feats = base_feats
    if cmvn_stats is not None:
        hist_end = min(t_end + splice_right, have)
        feats = online_cmvn_numpy(feats[:hist_end], cmvn_stats)
    idx = np.clip(
        np.arange(t0 - splice_left, t0 + chunk_in + splice_right),
        0,
        max(min(feats.shape[0], have) - 1, 0),
    )
    win = feats[idx].astype(np.float32)
    w = (np.arange(t0, t0 + chunk_in) < t_end).astype(np.float32)
    return win, w


def silence_weights_from_chunk(
    bp_chunk: np.ndarray,
    alpha: np.ndarray,
    arc_pdf: np.ndarray,
    arc_src: np.ndarray,
    silence_pdfs: np.ndarray,
    k_best: int = 1,
) -> Optional[np.ndarray]:
    """Per-output-frame silence flags from a traceback of the chunk's best
    path (OnlineSilenceWeighting::ComputeCurrentTraceback at chunk
    granularity, online-ivector-feature.h:511-512).

    bp_chunk: [Tc, S] (1-best) or [Tc, S, K] (k-best flat ids arc*K+k).
    alpha: [S] or [S, K] costs at chunk end."""
    if silence_pdfs.shape[0] == 0 or bp_chunk.shape[0] == 0:
        return None
    if alpha.ndim == 2:
        flat = int(np.argmin(alpha))
        s, kk = flat // k_best, flat % k_best
    else:
        s, kk = int(np.argmin(alpha)), 0
    flags = np.zeros(bp_chunk.shape[0], dtype=bool)
    for t in range(bp_chunk.shape[0] - 1, -1, -1):
        entry = int(
            bp_chunk[t, s] if bp_chunk.ndim == 2 else bp_chunk[t, s, kk]
        )
        if entry < 0:
            continue
        arc = entry // k_best if bp_chunk.ndim == 3 else entry
        kk = entry % k_best if bp_chunk.ndim == 3 else 0
        flags[t] = int(arc_pdf[arc]) in silence_pdfs
        s = int(arc_src[arc])
    return flags


def online_cmvn_numpy(
    feats: np.ndarray,
    global_stats: Optional[np.ndarray],
    cmn_window: int = 600,
    global_frames: int = 200,
) -> np.ndarray:
    """NumPy twin of ops/cmvn.online_cmvn (mean only) over [T, D] — used on
    the host side of streaming, where per-chunk device round-trips for a
    600-frame window would cost more than the arithmetic."""
    T, D = feats.shape
    cum = np.concatenate(
        [np.zeros((1, D), feats.dtype), np.cumsum(feats, axis=0)], axis=0
    )
    t = np.arange(T)
    lo = np.maximum(t + 1 - cmn_window, 0)
    window_sum = cum[t + 1] - cum[lo]
    count = (t + 1 - lo).astype(np.float64)[:, None]
    if global_stats is not None:
        g_sum = np.asarray(global_stats)[0, :-1]
        g_count = float(np.asarray(global_stats)[0, -1])
        if g_count > 0:
            take = np.minimum(
                np.maximum(cmn_window - count, 0.0),
                float(min(g_count, global_frames)),
            )
            window_sum = window_sum + (take / g_count) * g_sum[None, :]
            count = count + take
    return (feats - window_sum / count).astype(np.float32)
