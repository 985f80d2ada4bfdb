"""Incremental per-stream feature assembly: base MFCC + streaming pitch.

Counterpart of ``rhasspy_speech_tpu/pipeline/streaming_features.py``. The
batch path (``AcousticModel.features``) computes MFCC (and pitch) over a
whole utterance at once; streaming needs the same rows to appear as PCM
arrives. A frame's MFCCs depend only on its own window of samples, so a
buffer that carries each push's unconsumed tail reproduces the batch rows:
bit for bit on one device, because both the MFCC kernel (one warp a frame)
and its plain version compute a frame from its window alone, whatever else
the call holds. ``StreamFeaturizer.push`` calls ``ops.mfcc_cuda.mfcc_batch``
on the acoustic model's device, so on the card the MFCC kernel runs on
every push that completes a frame. The scheduler of many streams batches
that call instead: ``prepare_mfcc_buf`` gives each stream's buffer, one
MFCC call covers them all, and ``commit_mfcc`` and ``push_with_base`` take
the rows back.

Pitch is not causal (a lag Viterbi over the utterance and a +-75-frame
normalization window, pitch-functions.cc:1423-1540), so, like Kaldi's own
online pitch, the streamed rows approximate the batch rows, as the JAX
featurizer's do:

- pitch is recomputed over a sliding window of the last
  ``PITCH_WINDOW_SECONDS`` of audio (zero-padded at the stream's start),
  its start on the frame grid, so frames land where the batch path puts
  them: one ``ops.pitch.pitch_batch`` call over ``[1, Wp]`` a push that
  can release a pitch frame (one pitch-Viterbi kernel launch on a card);
- a frame's pitch is final the first time it is computed;
- a row is released once both its MFCC and its pitch exist (pitch lags
  the MFCCs by the NCCF's lag window), and a flush repeats the last pitch
  row over the MFCC tail, as the batch path does.

Pitch with ``snip_edges=false`` is refused, as the reference refuses it.
``_reflect_idx``, the framing and pitch-window bookkeeping of
``StreamFeaturizer``, ``stage_ivector_window``,
``silence_weights_from_chunk`` and ``online_cmvn_numpy`` are NumPy code
copied from the JAX module, which imports JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..ops.frontend import make_frontend_params
from ..ops.mfcc_cuda import mfcc_batch
from ..ops.pitch import num_pitch_frames, pitch_batch

PITCH_WINDOW_SECONDS = 2.0


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
        self.mfcc_pending = np.zeros((0, num_ceps), dtype=np.float32)
        self.pitch_samples = np.zeros(0, dtype=np.float32)
        self.pitch_start = 0  # absolute sample index of pitch_samples[0]
        self.pitch_done = 0  # absolute pitch frames consumed
        self.pitch_last: Optional[np.ndarray] = None  # last emitted row [3]
        self.pitch_queue = np.zeros((0, 3), dtype=np.float32)
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
        self.has_pitch = getattr(am, "pitch_config", None) is not None
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
            if self.has_pitch:
                # Kaldi pitch frames have their own (snip) framing; the
                # published model family never combines pitch with
                # snip_edges=false, so refuse rather than risk divergent
                # row pairing
                raise NotImplementedError(
                    "streaming pitch requires snip_edges=true framing"
                )
        self.feat_dim = self.num_ceps + (3 if self.has_pitch else 0)
        if self.has_pitch:
            self.pitch_window = (
                int(PITCH_WINDOW_SECONDS * cfg.samp_freq)
                // self.frame_shift
                * self.frame_shift
            )

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

    # -- streaming pitch -------------------------------------------------------

    def pitch_window_array(self, state: StreamFeatState) -> Optional[np.ndarray]:
        """Fixed-size [pitch_window] sample window ending at the last
        frame-aligned position, left zero-padded at stream start; None when
        no new pitch frame could be ready."""
        N = state.total_samples
        a = (N - self.pitch_window) // self.frame_shift * self.frame_shift
        end = a + self.pitch_window
        t_w = num_pitch_frames(self.am.pitch_config, self.pitch_window)
        n_frames_abs = a // self.frame_shift + t_w
        if n_frames_abs <= state.pitch_done:
            return None
        lo = max(a, state.pitch_start)
        real = state.pitch_samples[lo - state.pitch_start : end - state.pitch_start]
        pad = end - a - real.shape[0]
        if pad > 0:
            real = np.concatenate([np.zeros(pad, dtype=np.float32), real])
        return real

    def consume_pitch_rows(self, state: StreamFeatState, rows: np.ndarray) -> np.ndarray:
        """Take the not-yet-consumed rows out of a pitch_window_array
        result's [T_w, 3] features; advances pitch_done and trims the
        sample buffer."""
        N = state.total_samples
        a = (N - self.pitch_window) // self.frame_shift * self.frame_shift
        n_abs = a // self.frame_shift + rows.shape[0]
        local_lo = state.pitch_done - a // self.frame_shift
        new = rows[max(local_lo, 0) :]
        state.pitch_done = max(n_abs, state.pitch_done)
        if new.shape[0]:
            state.pitch_last = np.asarray(new[-1])
        # trim samples no longer needed (keep the window + alignment slack)
        keep_from = max(0, N - self.pitch_window - self.frame_shift)
        keep_from = keep_from // self.frame_shift * self.frame_shift
        if keep_from > state.pitch_start:
            state.pitch_samples = state.pitch_samples[keep_from - state.pitch_start :]
            state.pitch_start = keep_from
        return np.asarray(new, dtype=np.float32)

    def _extract_pitch(self, state: StreamFeatState) -> np.ndarray:
        """Single-stream path: compute + consume new pitch rows (one
        ``pitch_batch`` call over ``[1, pitch_window]``)."""
        window = self.pitch_window_array(state)
        if window is None:
            return np.zeros((0, 3), dtype=np.float32)
        samples = torch.as_tensor(window[None], device=self.am.device)
        rows = pitch_batch(self.am.pitch_config, samples)[0].cpu().numpy()
        return self.consume_pitch_rows(state, rows)

    # -- assembly ---------------------------------------------------------------

    def _merge(self, state: StreamFeatState, pitch_rows: np.ndarray, flush: bool) -> np.ndarray:
        """Pair pending MFCC rows with pitch rows -> finalized full rows."""
        if not self.has_pitch:
            out = state.mfcc_pending
            state.mfcc_pending = np.zeros((0, self.num_ceps), dtype=np.float32)
            return out
        if pitch_rows.shape[0]:
            state.pitch_queue = np.concatenate([state.pitch_queue, pitch_rows], axis=0)
        queue = state.pitch_queue
        k = min(state.mfcc_pending.shape[0], queue.shape[0])
        if flush and state.mfcc_pending.shape[0] > k:
            # repeat the last pitch row over the MFCC tail, as the batch
            # path does when the pitch stream yields fewer frames
            if queue.shape[0]:
                last = queue[-1]
            elif state.pitch_last is not None:
                last = state.pitch_last
            else:
                last = np.zeros(3, dtype=np.float32)
            extra = np.broadcast_to(last, (state.mfcc_pending.shape[0] - k, 3))
            queue = np.concatenate([queue, extra], axis=0)
            k = state.mfcc_pending.shape[0]
        if k == 0:
            state.pitch_queue = queue
            return np.zeros((0, self.feat_dim), dtype=np.float32)
        out = np.concatenate([state.mfcc_pending[:k], queue[:k]], axis=1).astype(np.float32)
        state.mfcc_pending = state.mfcc_pending[k:]
        state.pitch_queue = queue[k:]
        return out

    def push(
        self, state: StreamFeatState, pcm: np.ndarray, flush: bool = False
    ) -> np.ndarray:
        """Feed PCM (possibly empty), return newly finalized feature rows."""
        pcm = np.asarray(pcm, dtype=np.float32)
        if pcm.shape[0]:
            state.total_samples += pcm.shape[0]
            if self.has_pitch:
                state.pitch_samples = np.concatenate([state.pitch_samples, pcm])
        mfcc_rows = (
            self._extract_mfcc(state, pcm, flush=flush)
            if pcm.shape[0] or (flush and not self.snip)
            else np.zeros((0, self.num_ceps), dtype=np.float32)
        )
        if mfcc_rows.shape[0]:
            state.mfcc_pending = np.concatenate([state.mfcc_pending, mfcc_rows], axis=0)
        pitch_rows = (
            self._extract_pitch(state)
            if self.has_pitch and state.mfcc_pending.shape[0]
            else np.zeros((0, 3), dtype=np.float32)
        )
        return self._merge(state, pitch_rows, flush)

    def merge_pitch(
        self, state: StreamFeatState, pitch_rows: np.ndarray, flush: bool = False
    ) -> np.ndarray:
        """Emit rows newly matched by batched pitch results (scheduler)."""
        return self._merge(state, pitch_rows, flush)

    def push_with_base(
        self,
        state: StreamFeatState,
        pcm: np.ndarray,
        base_rows: np.ndarray,
        pitch_rows: Optional[np.ndarray] = None,
        flush: bool = False,
    ) -> np.ndarray:
        """Scheduler path: the caller batched the MFCC (and optionally the
        pitch windows) across slots (``prepare_mfcc_buf`` /
        ``commit_mfcc``); merge precomputed rows here."""
        pcm = np.asarray(pcm, dtype=np.float32)
        if pcm.shape[0]:
            state.total_samples += pcm.shape[0]
            if self.has_pitch:
                state.pitch_samples = np.concatenate([state.pitch_samples, pcm])
        if base_rows.shape[0]:
            state.mfcc_pending = np.concatenate([state.mfcc_pending, base_rows], axis=0)
        if pitch_rows is None:
            pitch_rows = np.zeros((0, 3), dtype=np.float32)
        return self._merge(state, pitch_rows, flush)


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
