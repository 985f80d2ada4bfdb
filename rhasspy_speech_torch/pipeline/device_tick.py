"""The stream scheduler's device route: the tick's device program.

Counterpart of the programs the JAX ``StreamScheduler`` builds with
``jax.jit`` (``batch_chunk``, ``batch_chunk_fused``, ``feed_only_merged``
and ``finalize_trace``, ``rhasspy_speech_tpu/pipeline/scheduler.py``). Every
slot's decode state lives on the device in a ``TickState`` allocated once:
alpha ``[N, S]``, the backpointer ring ``[N, F + chunk, S]`` (uint16
``bp + 3`` bits: 0 no frame, 2 dead, arc + 3), its write offsets, the
i-vector statistics and carried tap window, the silence weights, and on the
fused route the feature ring ``[N, FT, D]`` with its cumulative-sum twin for
the i-vector CMVN, for a pitch model a PCM history ring, and for a
recurrent AM its per-slot recurrence rows ``[N, depth, dim]`` (``rec``). A
tick's bodies update it in place:

- ``body_fused``: one ``pcm_meta`` upload ``[N, L + 24]`` (PCM and eleven
  int32 slot scalars as 16-bit halves; on the uint8 wires ``[N, W + 48]``,
  each half as two bytes) -> on the ``mulaw`` wire one 256-entry gather, on
  the ``adpcm`` wire one ADPCM decode launch (K6, ``ops/adpcm_cuda.py``) ->
  one MFCC launch writing the new rows into the feature
  rings -> for a pitch model, the pitch lane (``feed_pitch``: one
  pitch-Viterbi launch) -> AM windows gathered from the ring -> reset of
  reopened slots -> i-vector fold -> chunk AM -> one Viterbi launch with the
  carried alpha -> silence weights -> ring write -> one path-walk launch,
  whose packed row ``[N, F + 8]`` is the tick's only download;
- ``body_feed``: the feature rings only (a tick with audio and no chunk);
- ``body_chunk``: the chunk step on windows the host assembled (a model
  whose features stay on the host: ``snip_edges=false``, or an i-vector tap
  the AM's context does not cover);
- ``body_finalize``: the path walk alone, for a tick that flushes a stream
  and decodes nothing.

**Lane buckets.** The chunk AM runs over the tick's lanes alone, not over
every slot: the host picks ``rows = am_rows(lanes, N)`` (the smallest power
of two >= the slots with a chunk, at least ``AM_ROWS_MIN``, at most ``N``)
and sends the lane list (``lane_list``: the slots with a chunk in ascending
order, then the idle slots) in meta column 10 of the fused upload, or
column 4 of the chunk body's meta. ``DeviceTick.chunk`` gathers the first
``rows`` entries' windows and i-vectors, runs the AM on ``[rows, W, D]``
and scatters the log-probs into an ``[N, chunk_out, P]`` buffer whose
other rows are zero; an idle slot's ``n_valid`` is 0, so K2 reads none of
them. A recurrent AM continues from the gathered rows of ``rec`` and writes
back only the lanes with a chunk. Everything else (the reset, the i-vector
fold, K2, the silence weights, the ring write and K4) runs over every slot.
At ``rows == N`` nothing is gathered or scattered. The bucket is bound into
the body (``rows=``) and is part of the runner's key, so each bucket is its
own captured graph.

**Stamps.** Each body writes the time into ``DeviceTick.stamps`` (int64
ns, ``ops/tick_stamp_cuda.py``) at fixed points, captured into its graph so
that every replay stamps: s0 body start; s1 after ``feed_feats`` (unpack,
K1, feature-ring write); s2 after the AM windows, the slot reset and the
i-vector fold; s3 after the chunk AM; s4 after K2; s5 after the silence
weights, the ring re-encode and write and K4's walk (body end).
``body_fused`` takes all six, ``body_chunk`` all but s1, ``body_finalize``
s5 alone and ``body_feed`` none (``STAMPS_TAKEN``): what the scheduler's
records read (``pipeline/scheduler.py``). The buffer is no part of
``TickState``, so a replay checked against an eager run compares the state
alone; ``TickRunner.download`` copies the stamps behind the tick with its
packed rows, and ``PackedFetch`` hands them out when the row lands.
``tick_stamp`` launches are counted with the other kernels'.

``TickRunner.run`` executes a body. On the CPU it runs eagerly. On the card
the first call of each key (body, input shapes and lane bucket: ``("fused",
width, dtype, rows)``, ``("chunk", rows)``) runs eagerly on a side
stream -- that call IS the tick -- and then captures the body into a
``torch.cuda.CUDAGraph`` (one private memory pool per scheduler); every
later call copies the pinned inputs into the graph's static inputs and
replays it. A capture failure raises. The wrapper counters count host calls,
which under capture happen once, so the runner keeps the scheduler's own
count: the launches recorded in a graph times its replays.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import on_device
from ..ops.adpcm_cuda import adpcm_decode
from ..ops.ivector import solve_ivector, window_stats
from ..ops.mfcc_cuda import mfcc_batch
from ..ops.mulaw import decode_u8_torch
from ..ops.path_walk_cuda import path_walk, walk_start, walk_tables
from ..ops.pitch import PitchConfig, num_pitch_frames, pitch_batch, pitch_tables
from ..ops.pitch_viterbi_cuda import pitch_viterbi
from ..ops.tick_stamp_cuda import tick_stamp
from ..ops.viterbi_cuda import viterbi_decode

# trailing int16 / f32 columns of the pcm_meta upload: 12 int32 slots as
# lo / hi 16-bit halves (11 used: n_valid, reset, t0, have, feature-ring
# write offset, has new audio, pending i-vector frames, for the pitch lane
# the window's start sample, the pitch frames already final and the flush
# flag (zero without a pitch lane), and the lane list)
META_COLS = 24
# the fewest rows the chunk AM runs (``am_rows``)
AM_ROWS_MIN = 8
KERNELS = ("mfcc", "viterbi", "path_walk", "pitch_viterbi", "adpcm_decode", "tick_stamp")
WIRES = ("i16", "mulaw", "adpcm")
# the stamps a body writes (module docstring), by the body's key
STAMPS = 6
STAMPS_TAKEN = {"fused": (0, 1, 2, 3, 4, 5), "chunk": (0, 2, 3, 4, 5), "feed": (),
                "finalize": (5,)}


def kernel_counts() -> Dict[str, int]:
    return {"mfcc": mfcc_batch.launches, "viterbi": viterbi_decode.launches,
            "path_walk": path_walk.launches, "pitch_viterbi": pitch_viterbi.launches,
            "adpcm_decode": adpcm_decode.launches, "tick_stamp": tick_stamp.launches}


def am_rows(lanes: int, n: int) -> int:
    """The rows the chunk AM runs in a tick with ``lanes`` slots of ``n``
    to decode: the smallest power of two >= ``lanes``, at least
    ``AM_ROWS_MIN``, at most ``n``."""
    rows = AM_ROWS_MIN
    while rows < lanes:
        rows *= 2
    return min(rows, n)


def am_buckets(n: int) -> List[int]:
    """Every value of ``am_rows`` over ``n`` slots, ascending."""
    return sorted({am_rows(lanes, n) for lanes in range(n + 1)})


def lane_list(n_valid: np.ndarray) -> np.ndarray:
    """The tick's lane list ``[N]`` int32: the slots with a chunk
    (``n_valid > 0``) in ascending order, then the idle slots in ascending
    order. A permutation, so the first ``am_rows`` entries are distinct."""
    return np.argsort(np.asarray(n_valid) <= 0, kind="stable").astype(np.int32)


def meta_cols(wire: str) -> int:
    """Trailing columns of the upload that carry the meta pack: a uint8
    wire splits each 16-bit half into two bytes."""
    return META_COLS if wire == "i16" else 2 * META_COLS


@dataclass
class TickState:
    """Every slot's device state (dummies of one element where a route
    does not use a piece)."""

    alpha: torch.Tensor  # [N, S] f32
    offs: torch.Tensor  # [N] int32 decoded frames a slot (= ring rows)
    ring: torch.Tensor  # [N, F + chunk_out, S] int16 (uint16 bp + 3)
    packed: torch.Tensor  # [N, F + 8] int16 (uint16): the last walk's rows
    gamma: torch.Tensor  # [N, I] f32
    X: torch.Tensor  # [N, I, Dl] f32
    iv_carry: torch.Tensor  # [N, Wiv, C] f32: the tap window to fold next
    sw_w: torch.Tensor  # [N, chunk_in] f32: next fold's silence weights
    feats_ring: torch.Tensor  # [N, FT, D] f32
    cum_ring: torch.Tensor  # [N, FT, C] f32: cumulative feature sums
    pcm_ring: torch.Tensor  # [N, Wp + R] f32: sample s at s + Wp (pitch)
    # a recurrent AM's carried node -> [N, depth, dim] rows
    rec: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)

    def tensors(self) -> Dict[str, torch.Tensor]:
        """Every state tensor by name (the recurrence rows as ``rec.<node>``)."""
        out = {f.name: getattr(self, f.name) for f in dataclasses.fields(self) if f.name != "rec"}
        out.update({f"rec.{k}": v for k, v in self.rec.items()})
        return out

    def clone(self) -> "TickState":
        return TickState(**{f.name: getattr(self, f.name).clone()
                            for f in dataclasses.fields(self) if f.name != "rec"},
                         rec={k: v.clone() for k, v in self.rec.items()})


@dataclass(frozen=True)
class TickConfig:
    """What the bodies read besides the state: sizes, flags, tables."""

    N: int
    ring_frames: int  # F: the packed trace's width
    chunk_out: int
    chunk_in: int
    win_lo: int
    win_hi: int
    num_ceps: int
    acoustic_scale: float
    carry_device: bool  # the i-vector tap window is cut on the device
    cmvn_device: bool  # ... and normalized from the cumulative ring
    sw_device: bool
    sw_factor: float
    ep_stats: bool  # the walk counts trailing silence
    subsampling: int
    splice_left: int
    splice_right: int
    cmvn_window: int
    cmvn_g_count: float
    cmvn_g_cap: float
    pitch: Optional[PitchConfig] = None  # the pitch lane runs when set
    pitch_window: int = 0  # Wp: samples of the sliding pitch window
    wire: str = "i16"  # the upload's PCM: int16 / f32, mu-law or ADPCM bytes
    adpcm_block: int = 0  # samples an ADPCM block (the frame shift)


class DeviceTick:
    """The bodies of the scheduler's device tick over a ``TickState``."""

    def __init__(self, cfg: TickConfig, graph, chunk_model, ivp, ivector_dim: Optional[int],
                 stream_params, arc_src: torch.Tensor, arc_sil: torch.Tensor,
                 cmvn_g_sum: Optional[torch.Tensor]):
        self.cfg = cfg
        self.graph = graph
        self.chunk_model = chunk_model
        self.ivp = ivp
        self.ivector_dim = ivector_dim  # None: the AM reads no i-vector
        self.stream_params = stream_params
        self.arc_src = arc_src  # int32 [A]
        self.arc_sil = arc_sil  # uint8 [A]
        self.walk_tables = walk_tables(arc_src, arc_sil, graph.num_states)  # K4's, packed once
        self.cmvn_g_sum = cmvn_g_sum
        dev = graph.device
        self.lanes = torch.arange(cfg.N, device=dev)
        if cfg.pitch is not None:
            self.pitch_frames = num_pitch_frames(cfg.pitch, cfg.pitch_window)
            # the pitch lane's constant tensors, held here: a captured tick
            # reads them by address, whatever later evicts them from the
            # shared table cache
            self.pitch_tables = pitch_tables(cfg.pitch, cfg.pitch_window, dev)
        # filled by an eager run while set: each kernel's inputs at the
        # tick's shapes (chip_smoke.py times the kernels on them)
        self.probe: Optional[dict] = None
        # the last body's stamps (module docstring): outside the state, at
        # one address for every captured graph
        self.stamps = torch.zeros(STAMPS, dtype=torch.int64, device=dev)

    def _stamp(self, i: int) -> None:
        tick_stamp(self.stamps, i)

    # -- pieces ---------------------------------------------------------------

    def unpack(self, pcm_meta: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """[N, L + META_COLS] int16 or f32 (i16 wire), or [N, W + 2 *
        META_COLS] uint8 (mu-law or ADPCM wire) -> (PCM [N, L] f32, meta
        [N, 12] int32; negative scalars round-trip). The uint8 wires decode
        here: mu-law with one 256-entry gather, ADPCM with one launch of the
        decode kernel."""
        wire = self.cfg.wire
        cols = meta_cols(wire)
        enc = pcm_meta[:, -cols:].to(torch.int64)
        if wire != "i16":
            enc = enc[:, 0::2] | (enc[:, 1::2] << 8)
        meta = (enc[:, 0::2] & 0xFFFF) | ((enc[:, 1::2] & 0xFFFF) << 16)
        meta = torch.where(meta >= 1 << 31, meta - (1 << 32), meta).to(torch.int32)
        body = pcm_meta[:, :-cols]
        if body.shape[1] == 0:
            return body.to(torch.float32), meta
        if self.probe is not None and wire == "adpcm":
            self.probe["adpcm_decode"] = body.clone()
        if wire == "mulaw":
            return decode_u8_torch(body), meta
        if wire == "adpcm":
            return adpcm_decode(body, self.cfg.adpcm_block), meta
        return body.to(torch.float32), meta

    def _ring_write(self, ring: torch.Tensor, rows: torch.Tensor, at: torch.Tensor,
                    mask: torch.Tensor, col: int = 0) -> None:
        """rows [N, L, k] into ring [N, FT, D] at rows ``at`` [N, L] int64,
        columns ``col .. col + k``, where ``mask``; other slots, and the
        other columns, keep their values."""
        N, FT, D = ring.shape
        L, k = rows.shape[1], rows.shape[2]
        flat = (self.lanes[:, None] * FT + at).reshape(-1)
        view = ring.view(N * FT, D)
        cur = view.index_select(0, flat).view(N, L, D)
        new = rows if k == D else torch.cat([cur[..., :col], rows, cur[..., col + k:]], dim=-1)
        view.index_copy_(0, flat, torch.where(mask[:, None, None], new, cur).reshape(N * L, D))

    def feed_feats(self, st: TickState, pcm: torch.Tensor, meta: torch.Tensor) -> None:
        """One MFCC launch over the tick's PCM; each slot with new audio
        (meta column 5) gets its new rows in its feature ring's MFCC columns
        (and their running sums in the cumulative ring) at its frame count
        (column 4). Rows past a slot's real frames are scratch that a later
        write overwrites; reads clamp to the real count. A pitch model's
        pitch lane runs after, also on a tick with no audio: a flush
        completes a finished slot's pitch rows."""
        counts, has_new = meta[:, 4], meta[:, 5] != 0
        if pcm.shape[1] > 0:
            if self.probe is not None:
                self.probe["mfcc"] = pcm.clone()
            rows = mfcc_batch(self.stream_params, pcm)  # [N, Lf, C]
            FT = st.feats_ring.shape[1]
            at = (counts.to(torch.int64)[:, None]
                  + torch.arange(rows.shape[1], device=pcm.device)[None, :]).clamp(max=FT - 1)
            self._ring_write(st.feats_ring, rows, at, has_new)
            if self.cfg.cmvn_device:
                last = st.cum_ring[self.lanes, (counts.to(torch.int64) - 1).clamp_min(0)]
                prev = torch.where((counts > 0)[:, None], last, 0.0)
                self._ring_write(st.cum_ring, prev[:, None, :] + torch.cumsum(rows, dim=1),
                                 at, has_new)
        if self.cfg.pitch is not None:
            self.feed_pitch(st, pcm, meta)

    def feed_pitch(self, st: TickState, pcm: torch.Tensor, meta: torch.Tensor) -> None:
        """The pitch lane (the reference's ``feed_pitch``): the tick's PCM
        into each slot's history ring at its buffer's first sample, ONE
        sliding window a slot ending at its window start (meta column 7)
        plus ``Wp`` -> one ``pitch_batch`` over ``[N, Wp]`` (one
        pitch-Viterbi launch) -> a block of ``t_w`` rows into the feature
        ring's 3 pitch columns from the slot's pitch-done frame (column 8).
        Window rows past the newest repeat it: scratch for a live slot (the
        next, overlapping block rewrites them before the matched count lets
        the AM read them), and the flush semantics for a finished one
        (column 9), as the host featurizer repeats its last pitch row. Start
        indices clamp as ``jax.lax.dynamic_update_slice`` clamps them."""
        cfg = self.cfg
        Wp, t_w = cfg.pitch_window, self.pitch_frames
        shift = self.stream_params.cfg.frame_shift
        dev = meta.device
        a_samp = meta[:, 7].to(torch.int64)
        pdone = meta[:, 8].to(torch.int64)
        pflush = meta[:, 9] != 0
        ring = st.pcm_ring
        R = ring.shape[1]
        if pcm.shape[1] > 0:
            L = pcm.shape[1]
            start = (meta[:, 4].to(torch.int64) * shift + Wp).clamp(0, R - L)
            at = start[:, None] + torch.arange(L, device=dev)[None, :]
            cur = torch.gather(ring, 1, at)
            ring.scatter_(1, at, torch.where((meta[:, 5] != 0)[:, None], pcm, cur))
        w_at = (a_samp + Wp).clamp(0, R - Wp)[:, None] + torch.arange(Wp, device=dev)[None, :]
        win = torch.gather(ring, 1, w_at)
        if self.probe is not None:
            self.probe["pitch"] = win.clone()
        rows3 = pitch_batch(cfg.pitch, win, self.pitch_tables)  # [N, t_w, 3]
        a_frames = torch.div(a_samp, shift, rounding_mode="floor")
        arange_t = torch.arange(t_w, device=dev)[None, :]
        idx = ((pdone - a_frames)[:, None] + arange_t).clamp(0, t_w - 1)
        sel = torch.gather(rows3, 1, idx[:, :, None].expand(-1, -1, 3))
        wmask = (a_frames + t_w > pdone) | pflush
        FT = st.feats_ring.shape[1]
        at = pdone.clamp(0, FT - t_w)[:, None] + arange_t
        self._ring_write(st.feats_ring, sel, at, wmask, col=cfg.num_ceps)

    def gather_windows(self, st: TickState, t0s: torch.Tensor, haves: torch.Tensor) -> torch.Tensor:
        """AM windows [N, W, D] from the feature ring, edge-clamped as the
        host route clamps them."""
        cfg = self.cfg
        W = cfg.win_hi - cfg.win_lo
        idx = (t0s.to(torch.int64)[:, None] + cfg.win_lo
               + torch.arange(W, device=t0s.device)[None, :])
        idx = torch.minimum(idx.clamp_min(0), (haves.to(torch.int64) - 1).clamp_min(0)[:, None])
        D = st.feats_ring.shape[2]
        return torch.gather(st.feats_ring, 1, idx[:, :, None].expand(-1, -1, D))

    def _cmvn_tap(self, st: TickState, windows: torch.Tensor, t0s: torch.Tensor,
                  haves: torch.Tensor) -> torch.Tensor:
        """The next fold's tap window, CMVN'd from the cumulative ring: per
        row the sliding-window mean of two ring gathers, the deficit filled
        from the global stats (``stage_ivector_window`` with CMVN stats is
        the host twin)."""
        cfg = self.cfg
        sl, sr = cfg.splice_left, cfg.splice_right
        Wiv = sl + cfg.chunk_in + sr
        t0 = t0s.to(torch.int64)
        have = haves.to(torch.int64)
        t_end = torch.minimum(t0 + cfg.chunk_in, have)
        clamp = (torch.minimum(t_end + sr, have) - 1).clamp_min(0)[:, None]
        r = torch.minimum((t0[:, None] + torch.arange(Wiv, device=t0.device)[None, :] - sl)
                          .clamp_min(0), clamp)
        off = -sl - cfg.win_lo
        raw = windows[:, off : off + Wiv, : cfg.num_ceps]
        C = st.cum_ring.shape[2]
        cum_r = torch.gather(st.cum_ring, 1, r[:, :, None].expand(-1, -1, C))
        lo = (r - (cfg.cmvn_window - 1)).clamp_min(0)
        cum_lo = torch.gather(st.cum_ring, 1, (lo - 1).clamp_min(0)[:, :, None].expand(-1, -1, C))
        cum_lo = torch.where((lo > 0)[:, :, None], cum_lo, 0.0)
        wsum = cum_r - cum_lo
        cnt = (r - lo + 1).to(torch.float32)[:, :, None]
        if cfg.cmvn_g_cap > 0:
            take = (cfg.cmvn_window - cnt).clamp(0.0, cfg.cmvn_g_cap)
            mean = (wsum + (take / cfg.cmvn_g_count) * self.cmvn_g_sum[None, None, :]) / (cnt + take)
        else:
            mean = wsum / cnt
        return raw - mean

    def _silence_weights(self, bps: torch.Tensor, alpha: torch.Tensor,
                         n_valid: torch.Tensor) -> torch.Tensor:
        """OnlineSilenceWeighting's chunk traceback: the chunk's best path
        walked back from the best state, silence frames weighing
        ``sw_factor`` in the next fold, per input frame [N, chunk_in]."""
        cfg = self.cfg
        s_cur = torch.argmin(alpha, dim=1)
        sil = self.arc_sil.to(torch.bool)
        src = self.arc_src.to(torch.int64)
        flags = []
        for t in range(bps.shape[0] - 1, -1, -1):
            e = bps[t][self.lanes, s_cur]
            real = e >= 0
            safe = e.clamp_min(0)
            flags.append(real & sil[safe])
            s_cur = torch.where(real, src[safe], s_cur)
        flags = torch.stack(flags[::-1], dim=1)  # [N, chunk_out]
        kk = n_valid.to(torch.int64).clamp_min(1)
        out_idx = torch.minimum(
            torch.arange(cfg.chunk_in, device=alpha.device)[None, :] // cfg.subsampling,
            (kk - 1)[:, None])
        fsel = torch.gather(flags, 1, out_idx)
        return torch.where(fsel, cfg.sw_factor, 1.0)

    def _walk(self, st: TickState, alpha: torch.Tensor, frames: torch.Tensor) -> torch.Tensor:
        start, costs = walk_start(alpha, self.graph.final_weight)
        return path_walk(st.ring, frames, start, costs, self.walk_tables,
                         self.cfg.ring_frames, self.cfg.ep_stats)

    def _am(self, st: TickState, windows: torch.Tensor, ivec: Optional[torch.Tensor],
            n_valid: torch.Tensor, lanes: torch.Tensor, rows: int) -> torch.Tensor:
        """The chunk AM over the first ``rows`` entries of the lane list
        (module docstring) -> log-probs ``[N, chunk_out, P]``, zero on the
        slots it did not run; at ``rows == N`` over every slot as it is."""
        idx = None
        if rows < self.cfg.N:
            idx = lanes[:rows].to(torch.int64)
            windows = windows.index_select(0, idx)
            if ivec is not None:
                ivec = ivec.index_select(0, idx)
        if st.rec:
            # a recurrent AM continues from each lane's rows; an idle lane
            # (n_valid 0) keeps them
            rec = st.rec if idx is None else {k: v.index_select(0, idx) for k, v in st.rec.items()}
            log_probs, new = self.chunk_model.forward_with_state(windows, rec, ivec)
            active = (n_valid if idx is None else n_valid.index_select(0, idx)) > 0
            for k, v in new.items():
                kept = torch.where(active[:, None, None], v, rec[k])
                if idx is None:
                    st.rec[k].copy_(kept)
                else:
                    st.rec[k].index_copy_(0, idx, kept)
        else:
            log_probs = self.chunk_model(windows, ivec)
        if idx is None:
            return log_probs
        out = log_probs.new_zeros((self.cfg.N, *log_probs.shape[1:]))
        return out.index_copy_(0, idx, log_probs)

    def chunk(self, st: TickState, windows: torch.Tensor, n_valid: torch.Tensor,
              reset: torch.Tensor, t0s: torch.Tensor, haves: torch.Tensor,
              iv_wins: Optional[torch.Tensor], iv_ws: torch.Tensor, lanes: torch.Tensor,
              rows: int) -> None:
        """Reset, i-vector fold, decode, silence weights, ring write and
        walk over every slot (``batch_chunk``); the chunk AM over the lane
        bucket ``rows`` of the lane list ``lanes``."""
        cfg = self.cfg
        st.alpha.copy_(torch.where(reset[:, None], self.graph.init_weight[None, :], st.alpha))
        st.offs.copy_(torch.where(reset, 0, st.offs))
        for carried in st.rec.values():
            carried.copy_(torch.where(reset[:, None, None], 0.0, carried))
        ivec = None
        if self.ivector_dim is not None:
            if self.ivp is None:
                ivec = torch.zeros((cfg.N, self.ivector_dim), dtype=torch.float32,
                                   device=windows.device)
            else:
                ivp = self.ivp
                st.gamma.copy_(torch.where(reset[:, None], 0.0, st.gamma))
                st.X.copy_(torch.where(reset[:, None, None], 0.0, st.X))
                if cfg.sw_device:
                    iv_ws = iv_ws * st.sw_w
                if cfg.carry_device:
                    iv_wins = st.iv_carry
                d_gamma, d_X = window_stats(iv_wins, iv_ws, ivp, cfg.chunk_in)
                gamma, X = st.gamma + d_gamma, st.X + d_X
                ivec = solve_ivector(gamma, X, ivp)
                st.gamma.copy_(gamma)
                st.X.copy_(X)
                if cfg.cmvn_device:
                    st.iv_carry.copy_(self._cmvn_tap(st, windows, t0s, haves))
                elif cfg.carry_device:
                    off = -ivp.splice_left - cfg.win_lo
                    st.iv_carry.copy_(windows[:, off : off + st.iv_carry.shape[1], : cfg.num_ceps])
        self._stamp(2)
        log_probs = self._am(st, windows, ivec, n_valid, lanes, rows)
        self._stamp(3)
        if self.probe is not None:
            self.probe["viterbi"] = (log_probs.clone(), n_valid.clone(), st.alpha.clone())
        out = viterbi_decode(self.graph, log_probs, cfg.acoustic_scale, n_valid,
                             return_forward=True, alpha0=st.alpha)
        self._stamp(4)
        alpha, bps = out[3], out[4]
        b = bps.to(torch.int32)  # [k, N, S] arc + 2: 0 no frame, 1 dead
        if cfg.sw_device:
            st.sw_w.copy_(self._silence_weights(b - 2, alpha, n_valid))
        # the ring keeps bp + 3 (0 no frame, 2 dead): re-encoded, not copied
        enc = torch.where(b == 0, 0, b + 1).to(torch.int16).transpose(0, 1)  # [N, k, S]
        N, F_ring, S = st.ring.shape
        k = enc.shape[1]
        rows = st.offs.to(torch.int64)[:, None] + torch.arange(k, device=enc.device)[None, :]
        flat = (self.lanes[:, None] * F_ring + rows).reshape(-1)
        st.ring.view(N * F_ring, S).index_copy_(0, flat, enc.reshape(N * k, S))
        st.offs.copy_(st.offs + n_valid)
        st.alpha.copy_(alpha)
        st.packed.copy_(self._walk(st, st.alpha, st.offs))
        self._stamp(5)

    # -- the bodies -------------------------------------------------------------

    def body_fused(self, st: TickState, pcm_meta: torch.Tensor, rows: int) -> None:
        """``rows``: the AM's lane bucket (``am_rows``)."""
        self._stamp(0)
        pcm, meta = self.unpack(pcm_meta)
        n_valid, reset, t0s, haves = meta[:, 0], meta[:, 1] != 0, meta[:, 2], meta[:, 3]
        self.feed_feats(st, pcm, meta)
        self._stamp(1)
        iv_ws = (torch.arange(self.cfg.chunk_in, device=meta.device)[None, :]
                 < meta[:, 6:7]).to(torch.float32)
        windows = self.gather_windows(st, t0s, haves)
        self.chunk(st, windows, n_valid.contiguous(), reset, t0s, haves, None, iv_ws, meta[:, 10],
                   rows)

    def body_feed(self, st: TickState, pcm_meta: torch.Tensor) -> None:
        pcm, meta = self.unpack(pcm_meta)
        self.feed_feats(st, pcm, meta)

    def body_chunk(self, st: TickState, windows: torch.Tensor, meta: torch.Tensor,
                   iv_ws: torch.Tensor, iv_wins: Optional[torch.Tensor] = None, *,
                   rows: int) -> None:
        """meta [N, 5] int32: n_valid, reset, t0, have, the lane list;
        ``rows``: the AM's lane bucket (``am_rows``)."""
        self._stamp(0)
        self.chunk(st, windows, meta[:, 0].contiguous(), meta[:, 1] != 0, meta[:, 2],
                   meta[:, 3], iv_wins, iv_ws, meta[:, 4], rows)

    def body_finalize(self, st: TickState) -> None:
        st.packed.copy_(self._walk(st, st.alpha, st.offs))
        self._stamp(5)


class TickRunner:
    """Runs a body eagerly (CPU) or as a captured CUDA graph (card), and
    counts the kernel launches, uploads and downloads the ticks make."""

    def __init__(self, device: torch.device):
        self.device = device
        self.graphs: Dict[tuple, Tuple[torch.cuda.CUDAGraph, List[torch.Tensor], Dict[str, int]]] = {}
        self.launches = dict.fromkeys(KERNELS, 0)
        self.uploads = self.downloads = self.download_bytes = 0
        # keys whose body has run (on the card: been captured)
        self.warm_keys: set = set()
        # set to check the next replay: the body runs first eagerly on
        # copies of the state and inputs, and ``checks`` gets (key, {state
        # field: the replay's result bit-equal to the eager run's})
        self.check_next = False
        self.checks: List[Tuple[tuple, Dict[str, bool]]] = []
        # False runs every body eagerly on the card too (the captured
        # tick's eager baseline)
        self.capture = True
        self._pool = None

    def _count(self, before: Dict[str, int]) -> Dict[str, int]:
        now = kernel_counts()
        return {k: now[k] - before[k] for k in KERNELS}

    def _add(self, counts: Dict[str, int]) -> None:
        for k in KERNELS:
            self.launches[k] += counts[k]

    def run(self, key: tuple, body: Callable, st: TickState,
            inputs: Sequence[torch.Tensor]) -> None:
        """One tick of ``body(st, *inputs)``; ``inputs`` are host tensors
        (pinned on the card), each one upload."""
        self.uploads += len(inputs)
        self.warm_keys.add(key)
        with torch.no_grad(), on_device(self.device):
            if self.device.type != "cuda":
                body(st, *inputs)
            else:
                self._run_cuda(key, body, st, inputs)

    def _run_cuda(self, key, body, st, inputs) -> None:
        if not self.capture:
            before = kernel_counts()
            body(st, *[x.to(self.device, non_blocking=True) for x in inputs])
            self._add(self._count(before))
            return
        entry = self.graphs.get(key)
        if entry is None:
            self._capture(key, body, st, inputs)
            return
        graph, static, recorded = entry
        for s, x in zip(static, inputs):
            s.copy_(x, non_blocking=True)
        if self.check_next:
            self.check_next = False
            twin = st.clone()
            body(twin, *[s.clone() for s in static])
            graph.replay()
            eager = twin.tensors()
            self.checks.append((key, {name: torch.equal(t, eager[name])
                                      for name, t in st.tensors().items()}))
        else:
            graph.replay()
        self._add(recorded)

    def _capture(self, key, body, st, inputs) -> None:
        static = [torch.empty(x.shape, dtype=x.dtype, device=self.device) for x in inputs]
        for s, x in zip(static, inputs):
            s.copy_(x, non_blocking=True)
        # this key's first tick runs eagerly on a side stream (warm-up:
        # plans, tables and libraries load here), then the body is captured
        before = kernel_counts()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            body(st, *static)
        torch.cuda.current_stream(self.device).wait_stream(side)
        self._add(self._count(before))
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        before = kernel_counts()
        # a probe must not keep tensors of the graph's pool, which hold
        # nothing until a replay (a body may come with its lane bucket bound)
        owner = getattr(body, "func", body).__self__
        probe, owner.probe = owner.probe, None
        try:
            with torch.cuda.graph(graph, pool=self._pool, stream=side):
                body(st, *static)
        finally:
            owner.probe = probe
        self.graphs[key] = (graph, static, self._count(before))

    def download(self, packed: torch.Tensor, stamps: torch.Tensor) -> "PackedFetch":
        """The tick's packed rows and its stamps to the host: pinned
        non-blocking copies and one event the host polls (everything lands
        at once on the CPU). ``downloads`` and ``download_bytes`` count the
        packed rows alone."""
        self.downloads += 1
        self.download_bytes += packed.numel() * packed.element_size()
        if packed.device.type != "cuda":
            return PackedFetch(packed.numpy().view(np.uint16).copy(), None, None,
                               stamps.numpy().copy())
        with on_device(self.device):
            host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
            host.copy_(packed, non_blocking=True)
            host_stamps = torch.empty(stamps.shape, dtype=stamps.dtype, pin_memory=True)
            host_stamps.copy_(stamps, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        return PackedFetch(None, host, event, host_stamps)


class PackedFetch:
    """A tick's packed rows and stamps on their way to the host. ``on_land``,
    when set, is called once with the stamps (int64 ns) as the fetch is
    first seen landed by ``get``."""

    __slots__ = ("_arr", "_host", "_event", "_stamps", "on_land")

    def __init__(self, arr: Optional[np.ndarray], host: Optional[torch.Tensor], event, stamps):
        self._arr, self._host, self._event, self._stamps = arr, host, event, stamps
        self.on_land: Optional[Callable[[np.ndarray], None]] = None

    def ready(self) -> bool:
        return self._arr is not None or self._event.query()

    def get(self, block: bool = True) -> Optional[np.ndarray]:
        """[N, F + 8] uint16, or None while in flight when not blocking."""
        if self._arr is None:
            if not block and not self._event.query():
                return None
            self._event.synchronize()
            self._arr = self._host.numpy().view(np.uint16)
            self._stamps = self._stamps.numpy()
            self._host = self._event = None
        if self.on_land is not None:
            land, self.on_land = self.on_land, None
            land(self._stamps)
        return self._arr
