"""Streaming transcription on one device: chunked PCM -> frame-synchronous
decode.

Counterpart of ``rhasspy_speech_tpu/pipeline/stream.py``
(``Nnet3StreamTranscriber``): an in-process streaming state machine in place
of the reference's long-lived decoder subprocess.

- sample buffer: carries each push's unconsumed samples
  (``streaming_features.StreamFeaturizer``; on the card every push that
  completes a frame is one MFCC kernel launch),
- feature buffer: carries the model's left/right context frames,
- alpha [S] on the device: the Viterbi state carried across chunks,
- per-chunk backpointers accumulate on the host; final backtrace on EOF.

Chunking mirrors the reference decodable defaults: 21 input frames per chunk
with frame_subsampling_factor 3 -> 7 output frames per step.

A chunk step (``_chunk_step``; one jitted program in the JAX package) folds
the PREVIOUS chunk's i-vector statistics into the carried (gamma, X), solves
the current i-vector, runs the acoustic model on the chunk's context window
(a ``compile_nnet3(spec, 7, subsampling)`` plan), and decodes the chunk's up
to 7 frames. With ``nbest == 1`` on a CUDA device that decode is ONE launch
of the Viterbi kernel (``ops.viterbi_cuda.viterbi_decode`` with ``alpha0``
the carried alpha, ``lengths`` the chunk's valid frames, B = 1); the alpha
it returns stays on the device for the next chunk. On the CPU the same call
runs the plain ``ops.decoder.viterbi``. The kernel takes a graph of any size
on the card (its replicated, halo or global body, by the graph's states).
``nbest > 1`` carries alpha [S, K] through the plain ``kbest_step``.

Per chunk the host uploads the feature window, the pending i-vector window
and its weights, and downloads the chunk's backpointers (the silence
weights of the next fold are read from them), as the reference does. Each
of those stages is a method of its own (``_upload``, ``_fold_ivector``,
``_acoustic``, ``_decode_chunk``, ``_download``), so a caller can time them.

A GMM model's chunk model is ``models.gmm.GmmChunkModel`` (deltas over the
window's +-4 context frames, then the per-pdf log-likelihoods; no
i-vector): one MFCC launch a push and one Viterbi launch a 7-frame chunk,
as for nnet3.

A pitch model's rows come from the featurizer's sliding pitch window: a
push that can release a pitch frame runs one ``[1, Wp]`` window, so one
launch of the pitch-Viterbi kernel on a card. The i-vector taps the rows'
base MFCC columns.

A recurrent (TDNN-LSTM) plan carries its recurrence state
(``state.am_state``, ``CompiledNnet3.init_state``: zero at
``start_stream``) from chunk to chunk through ``forward_with_state``, so a
stream's log-probs equal the whole utterance's. The stream's AM runs in
f32, as the JAX package's does.
"""

from __future__ import annotations

import asyncio
import logging
from pathlib import Path
from typing import AsyncIterable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..fst.core import SymbolTable
from ..grammar.fst import decode_meta
from ..graph.dense import NEG_INF_F32
from ..ops.decoder import (
    DecodeGraph,
    backtrace_nbest,
    backtrace_words,
    kbest_step,
)
from ..ops.ivector import (
    apply_lda,
    gmm_log_likes,
    gselect_posteriors,
    solve_ivector,
    splice_frames,
)
from ..ops.lattice import build_lattice, forward_backward
from ..ops.viterbi_cuda import viterbi_decode
from .artifacts import LangArtifacts
from .endpoint import silence_pdfs_from_model
from .fuzzy import get_fuzzy_text, rescore_nbest
from .rescore import rescore_lattice, rescore_tail
from .streaming_features import (
    StreamFeaturizer,
    silence_weights_from_chunk,
    stage_ivector_window,
)
from .transcribe import AcousticModel

_LOGGER = logging.getLogger(__name__)

CHUNK_OUT_FRAMES = 7  # 21 input frames / subsampling 3


class StreamingDecoderState:
    """Per-stream state: sample/feature buffers + device alpha + host bps."""

    def __init__(self, feat_dim: int):
        self.feats = np.zeros((0, feat_dim), dtype=np.float32)
        self.feat_state = None  # StreamFeatState (MFCC assembly)
        self.frames_consumed = 0  # input frames fed to the AM so far
        self.alpha: Optional[torch.Tensor] = None  # [S], or [S, K] for n-best
        self.am_state: Dict[str, torch.Tensor] = {}  # a recurrent AM's carry
        self.bps: List[np.ndarray] = []  # [chunk][Tc, S] int32 (or [Tc, S, K])
        self.out_frames = 0
        # streaming i-vector: accumulated stats + the previous chunk's
        # pending contribution (accumulated one chunk late so decoder-
        # traceback silence weights can apply, matching the lag between
        # OnlineSilenceWeighting and the stats it modifies)
        self.iv_gamma: Optional[torch.Tensor] = None
        self.iv_X: Optional[torch.Tensor] = None
        self.iv_pending_win: Optional[np.ndarray] = None
        self.iv_pending_w: Optional[np.ndarray] = None


class Nnet3StreamTranscriber:
    """Reference-compatible streaming transcriber on one device."""

    def __init__(
        self,
        model_dir: Union[str, Path],
        graph_dir: Union[str, Path],
        tools: Optional[object] = None,  # unused; reference API parity
        max_active: int = 7000,  # unused; reference API parity
        lattice_beam: float = 8.0,
        acoustic_scale: float = 1.0,
        beam: float = 24.0,
        nbest: int = 1,
        silence_weight: Optional[float] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        self.device = resolve_device(device)
        self.model_dir = Path(model_dir)
        self.graph_dir = Path(graph_dir)
        self.acoustic_scale = acoustic_scale
        self.lattice_beam = lattice_beam
        self.nbest = max(1, nbest)
        self.silence_weight = silence_weight

        self.am = AcousticModel(self.model_dir, device=self.device)
        self.artifacts = LangArtifacts.load(self.graph_dir)
        if self.artifacts.graph is None:
            raise ValueError(f"no graph.npz in {graph_dir}")
        self.device_graph = DecodeGraph.from_dense(self.artifacts.graph, self.device)
        self._featurizer = StreamFeaturizer(self.am)
        self._chunk_model = self.am.chunk_model(CHUNK_OUT_FRAMES)
        self._rc = self._chunk_model.right_context
        self._chunk_in = CHUNK_OUT_FRAMES * self.am.subsampling
        self._has_ivector = self.am._has_ivector
        self._ivp = self.am.ivector_params if self._has_ivector else None
        # a chunk's valid frames as a [1] int32 tensor, made once per count
        self._chunk_lengths = [
            torch.full((1,), n, dtype=torch.int32, device=self.device)
            for n in range(CHUNK_OUT_FRAMES + 1)
        ]
        self._lang_cache: Dict[str, LangArtifacts] = {}
        self._silence_pdf_arr: Optional[np.ndarray] = None

    # -- streaming core ------------------------------------------------------

    def start_stream(self) -> StreamingDecoderState:
        state = StreamingDecoderState(self._featurizer.feat_dim)
        state.feat_state = self._featurizer.new_state()
        init = self.device_graph.init_weight
        if self.nbest == 1:
            state.alpha = init
        else:
            alpha = torch.full(
                (init.shape[0], self.nbest), NEG_INF_F32, dtype=torch.float32, device=self.device
            )
            alpha[:, 0] = init
            state.alpha = alpha
        if self._chunk_model.recurrent:
            state.am_state = self._chunk_model.init_state(1)
        ivp = self._ivp
        if ivp is not None:
            num_gauss, lda_dim = int(ivp.gconsts.shape[0]), int(ivp.lda.shape[0])
            state.iv_gamma = torch.zeros((num_gauss,), dtype=torch.float32, device=self.device)
            state.iv_X = torch.zeros((num_gauss, lda_dim), dtype=torch.float32, device=self.device)
            win = ivp.splice_left + self._chunk_in + ivp.splice_right
            state.iv_pending_win = np.zeros(
                (win, self.am.frontend_config.num_ceps), dtype=np.float32
            )
            state.iv_pending_w = np.zeros(self._chunk_in, dtype=np.float32)
        return state

    def _upload(
        self, state: StreamingDecoderState, window: np.ndarray
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
        """The chunk's feature window and the pending i-vector window and
        weights, on the device."""
        feats_window = torch.as_tensor(window, device=self.device)
        if self._ivp is None:
            return feats_window, None, None
        return (
            feats_window,
            torch.as_tensor(state.iv_pending_win, device=self.device),
            torch.as_tensor(state.iv_pending_w, device=self.device),
        )

    def _fold_ivector(
        self,
        state: StreamingDecoderState,
        iv_win: Optional[torch.Tensor],
        iv_w: Optional[torch.Tensor],
    ) -> Optional[torch.Tensor]:
        """Fold the previous chunk's statistics into the carried (gamma, X)
        and solve the current i-vector [1, D] (zeros for a model that reads
        one without an extractor; None for a model that reads none)."""
        if not self._has_ivector:
            return None
        ivp = self._ivp
        if ivp is None:
            return torch.zeros(
                (1, self.am.spec.ivector_dim), dtype=torch.float32, device=self.device
            )
        sl, sr = ivp.splice_left, ivp.splice_right
        spliced = splice_frames(iv_win[None], sl, sr)[:, sl : sl + self._chunk_in]
        lda_feats = apply_lda(spliced, ivp)
        post = gselect_posteriors(gmm_log_likes(lda_feats, ivp), ivp) * iv_w[None, :, None]
        state.iv_gamma = state.iv_gamma + post[0].sum(dim=0)
        state.iv_X = state.iv_X + torch.einsum("ti,td->id", post[0], lda_feats[0])
        return solve_ivector(state.iv_gamma[None], state.iv_X[None], ivp)

    def _acoustic(
        self, state: StreamingDecoderState, feats_window: torch.Tensor,
        ivec: Optional[torch.Tensor],
    ) -> torch.Tensor:
        """The chunk's log-probs [1, 7, P]; a recurrent plan continues from
        ``state.am_state`` and leaves its new carry there."""
        if self._chunk_model.recurrent:
            log_probs, state.am_state = self._chunk_model.forward_with_state(
                feats_window[None], state.am_state, ivec
            )
            return log_probs
        return self._chunk_model(feats_window[None], ivec)

    def _decode_chunk(
        self, state: StreamingDecoderState, log_probs: torch.Tensor, n_valid: int
    ) -> torch.Tensor:
        """Advance ``state.alpha`` over the chunk's ``n_valid`` frames;
        returns their backpointers on the device: [n_valid, S] (uint16
        ``arc + 2`` or int32 arc ids) or [n_valid, S, K] int32."""
        if self.nbest == 1:
            lengths = self._chunk_lengths[n_valid]
            alpha0 = state.alpha[None]
            out = viterbi_decode(
                self.device_graph, log_probs, self.acoustic_scale, lengths,
                return_forward=True, alpha0=alpha0,
            )
            state.alpha = out[3][0]
            return out[4][:n_valid, 0]
        am_costs = (-self.acoustic_scale) * log_probs[0]  # [7, P]
        alpha = state.alpha
        rows = []
        for t in range(n_valid):
            new_alpha, bp = kbest_step(self.device_graph, alpha[None], am_costs[t][None], self.nbest)
            alpha = new_alpha[0]
            rows.append(bp[0])
        state.alpha = alpha
        if rows:
            return torch.stack(rows)
        S = self.device_graph.num_states
        return torch.zeros((0, S, self.nbest), dtype=torch.int32, device=self.device)

    @staticmethod
    def _download(bp: torch.Tensor) -> np.ndarray:
        """A chunk's backpointers on the host, as the int32 arc ids the host
        backtrace and the silence weighting read."""
        if bp.dtype == torch.uint16:  # the compact rows hold arc + 2
            return bp.view(torch.int16).cpu().numpy().view(np.uint16).astype(np.int32) - 2
        return bp.cpu().numpy()

    @torch.no_grad()
    def _chunk_step(
        self, state: StreamingDecoderState, window: np.ndarray, n_valid: int
    ) -> np.ndarray:
        """One streaming step; updates ``state.alpha`` and the carried
        i-vector stats on the device and returns the chunk's backpointers
        on the host: int32 [n_valid, S] arc ids (-1 dead), or [n_valid, S,
        K] flat k-best ids."""
        feats_window, iv_win, iv_w = self._upload(state, window)
        ivec = self._fold_ivector(state, iv_win, iv_w)
        log_probs = self._acoustic(state, feats_window, ivec)
        return self._download(self._decode_chunk(state, log_probs, n_valid))

    def _extract_feats(self, state: StreamingDecoderState, pcm: np.ndarray) -> None:
        rows = self._featurizer.push(state.feat_state, pcm)
        if rows.shape[0]:
            state.feats = np.concatenate([state.feats, rows], axis=0)

    def _silence_pdfs_arr(self) -> np.ndarray:
        if self._silence_pdf_arr is None:
            pdfs: set = set()
            phones_path = self.am._resolved_model_dir / "model" / "phones.txt"
            if phones_path.exists():
                with open(phones_path, "r", encoding="utf-8") as f:
                    model_phones = SymbolTable.read_text(f)
                pdfs = set(silence_pdfs_from_model(self.am.transition_model, model_phones))
            self._silence_pdf_arr = (
                np.fromiter(pdfs, dtype=np.int64) if pdfs else np.zeros(0, np.int64)
            )
        return self._silence_pdf_arr

    def _stage_ivector_stats(
        self,
        state: StreamingDecoderState,
        t0: int,
        have: int,
        bp_np: np.ndarray,
    ) -> None:
        """Prepare this chunk's (window, weights) to be folded into the
        i-vector stats at the NEXT chunk step."""
        ivp = self._ivp
        num_ceps = self.am.frontend_config.num_ceps
        win, w = stage_ivector_window(
            state.feats[:, :num_ceps],
            t0,
            self._chunk_in,
            have,
            ivp.splice_left,
            ivp.splice_right,
            self.am.ivector_cmvn_stats,
        )
        if self.silence_weight is not None and self.silence_weight != 1.0:
            graph = self.artifacts.graph
            flags = silence_weights_from_chunk(
                bp_np,
                state.alpha.cpu().numpy(),
                graph.arc_pdf,
                graph.arc_src,
                self._silence_pdfs_arr(),
                k_best=self.nbest,
            )
            if flags is not None and flags.shape[0]:
                sub = self.am.subsampling
                out_idx = np.minimum(np.arange(self._chunk_in) // sub, flags.shape[0] - 1)
                w = np.where(flags[out_idx], w * float(self.silence_weight), w)
        state.iv_pending_win = win
        state.iv_pending_w = w.astype(np.float32)

    def _run_chunks(self, state: StreamingDecoderState, flush: bool) -> None:
        """Consume buffered features in fixed chunks while enough context."""
        while True:
            t0 = state.frames_consumed
            need_hi = t0 + self._chunk_in + self._rc
            have = state.feats.shape[0]
            if have < need_hi and not flush:
                return
            if flush and t0 >= have:
                return
            # window rows: input times [t0 - lc, t0 + chunk + rc), clamped
            lo, hi = self._chunk_model.ranges["input"]
            idx = np.clip(np.arange(t0 + lo, t0 + hi), 0, max(have - 1, 0))
            window = state.feats[idx]
            # frames past the real feature end are invalid when flushing
            real_out = min(CHUNK_OUT_FRAMES, max(0, -(-(have - t0) // self.am.subsampling)))
            bp_np = self._chunk_step(state, window, real_out)
            if bp_np.shape[0]:
                state.bps.append(bp_np)
                state.out_frames += bp_np.shape[0]
            if self._ivp is not None:
                self._stage_ivector_stats(state, t0, have, bp_np)
            state.frames_consumed += self._chunk_in
            if flush and state.frames_consumed >= have:
                return

    def process_chunk(self, state: StreamingDecoderState, pcm: np.ndarray) -> None:
        self._extract_feats(state, pcm)
        self._run_chunks(state, flush=False)

    def finish_nbest(self, state: StreamingDecoderState) -> List[tuple]:
        """Flush and return the n-best [(word ids, cost)] list."""
        rows = self._featurizer.push(state.feat_state, np.zeros(0, dtype=np.float32), flush=True)
        if rows.shape[0]:
            state.feats = np.concatenate([state.feats, rows], axis=0)
        self._run_chunks(state, flush=True)
        if not state.bps:
            return []
        alpha = state.alpha.cpu().numpy()[None]
        if self.nbest == 1:
            bp = np.concatenate(state.bps, axis=0)[:, None, :]
            words, cost = backtrace_words(
                self.artifacts.graph, alpha, bp, 0, num_frames=bp.shape[0]
            )
            return [] if words is None else [(words, cost)]
        bp = np.concatenate(state.bps, axis=0)[:, None, :, :]  # [T, 1, S, K]
        return backtrace_nbest(
            self.artifacts.graph, alpha, bp, 0, n=self.nbest, num_frames=bp.shape[0]
        )

    def finish_stream_rescore(
        self,
        state: StreamingDecoderState,
        old_lang_dir: Union[str, Path],
        new_lang_dir: Union[str, Path],
        nbest: Optional[int] = None,
        max_fuzzy_cost: Optional[float] = None,
        require_fuzzy: bool = False,
    ) -> List[str]:
        """Dual-graph stream rescore: flush the stream, rebuild the
        utterance's pruned lattice from the accumulated features, and remap
        it through the new lang dir's lexicon + LM (pipeline/rescore.py).
        Falls back to the n-best LM swap — which cannot leave the first
        pass's hypotheses — only for artifacts that predate lattice
        metadata."""
        n = nbest if nbest is not None else max(self.nbest, 5)
        old_lang = self._load_lang(old_lang_dir)
        new_lang = self._load_lang(new_lang_dir)
        graph = self.artifacts.graph

        first_pass = self.finish_nbest(state)  # flushes state.feats fully
        lattice_capable = (
            graph.has_phone_info and new_lang.ldet is not None and state.feats.shape[0] > 0
        )
        if lattice_capable:
            hyp_list = self._rescore_from_feats(state, graph, new_lang, n)
        else:
            _LOGGER.warning(
                "Artifacts lack lattice rescore metadata — stream rescore "
                "falls back to an n-best LM swap. Retrain to fix."
            )
            if not first_pass:
                return []
            if old_lang.g_fst is None or new_lang.g_fst is None:
                raise ValueError("the n-best LM swap needs G.fst in both lang dirs")
            hyp_list = rescore_nbest(
                first_pass, old_lang.g_fst, new_lang.g_fst, self.artifacts.words
            )

        return rescore_tail(hyp_list, old_lang, new_lang, max_fuzzy_cost, require_fuzzy)

    def _rescore_from_feats(self, state, graph, new_lang, n: int):
        """Whole-utterance lattice over the stream's accumulated features,
        remapped through the new lang (the second pass of stream rescore)."""
        feats = torch.as_tensor(state.feats[None], device=self.device)  # [1, T, D]
        T = state.feats.shape[0]
        n_out = max(1, -(-T // self.am.subsampling))
        log_probs = self.am.log_probs(
            feats, n_out, feat_lengths=torch.as_tensor([T], dtype=torch.int32, device=self.device)
        )
        alphas, betas = forward_backward(self.device_graph, log_probs, self.acoustic_scale)
        lat = build_lattice(
            graph,
            alphas.cpu().numpy(),
            betas.cpu().numpy(),
            log_probs.cpu().numpy(),
            0,
            lattice_beam=self.lattice_beam,
            acoustic_scale=self.acoustic_scale,
        )
        if lat is None:
            return []
        return rescore_lattice(lat, graph, self.artifacts.phones, new_lang, nbest=n)

    def _load_lang(self, lang_dir: Union[str, Path]) -> LangArtifacts:
        key = str(lang_dir)
        if key not in self._lang_cache:
            self._lang_cache[key] = LangArtifacts.load(lang_dir)
        return self._lang_cache[key]

    def finish_stream(
        self,
        state: StreamingDecoderState,
        lang_dir: Optional[Union[str, Path]] = None,
        max_fuzzy_cost: Optional[float] = None,
        require_fuzzy: bool = False,
    ) -> List[str]:
        nbest = self.finish_nbest(state)
        if not nbest:
            return []
        words, cost = nbest[0]
        _LOGGER.debug("stream decode cost %.3f", cost)

        lang = self.artifacts if lang_dir is None else self._load_lang(lang_dir)

        if lang.g_fuzzy is not None and max_fuzzy_cost is not None:
            fuzzy = get_fuzzy_text([ids for ids, _ in nbest], lang.g_fuzzy, lang.words)
            if fuzzy is not None and fuzzy[1] <= max_fuzzy_cost:
                return [decode_meta(fuzzy[0])]
            if require_fuzzy:
                return []
        text_words = []
        for wid in words:
            sym = self.artifacts.words.find_id(wid)
            if sym and sym not in ("<eps>", "#0", "<s>", "</s>"):
                text_words.append(sym)
        return [decode_meta(" ".join(text_words))]

    # -- public API ------------------------------------------------------------

    async def _feed(self, audio_stream: AsyncIterable[bytes]) -> StreamingDecoderState:
        """Start a stream and process s16le PCM chunks until EOF."""
        state = self.start_stream()
        async for chunk in audio_stream:
            if not chunk:
                continue
            pcm = np.frombuffer(chunk, dtype=np.int16).astype(np.float32)
            await asyncio.to_thread(self.process_chunk, state, pcm)
        return state

    async def async_transcribe(
        self,
        audio_stream: AsyncIterable[bytes],
        lang_dir: Optional[Union[str, Path]] = None,
        max_fuzzy_cost: Optional[float] = None,
        require_fuzzy: bool = False,
    ) -> List[str]:
        """Feed s16le PCM chunks; decode on EOF."""
        state = await self._feed(audio_stream)
        return await asyncio.to_thread(
            lambda: self.finish_stream(
                state,
                lang_dir=lang_dir,
                max_fuzzy_cost=max_fuzzy_cost,
                require_fuzzy=require_fuzzy,
            )
        )

    async def async_transcribe_rescore(
        self,
        audio_stream: AsyncIterable[bytes],
        old_lang_dir: Union[str, Path],
        new_lang_dir: Union[str, Path],
        nbest: int = 1,
        max_fuzzy_cost: Optional[float] = None,
        require_fuzzy: bool = False,
    ) -> List[str]:
        """Stream + dual-graph rescore."""
        state = await self._feed(audio_stream)
        return await asyncio.to_thread(
            lambda: self.finish_stream_rescore(
                state,
                old_lang_dir,
                new_lang_dir,
                nbest=nbest,
                max_fuzzy_cost=max_fuzzy_cost,
                require_fuzzy=require_fuzzy,
            )
        )

    def transcribe_pcm(
        self,
        pcm: np.ndarray,
        chunk_samples: int = 1024,
        **kwargs,
    ) -> List[str]:
        """Synchronous helper: stream a PCM array in fixed chunks
        (online2-cli-nnet3-decode-faster reads 1024-sample chunks)."""
        state = self.start_stream()
        for off in range(0, pcm.shape[0], chunk_samples):
            self.process_chunk(state, pcm[off : off + chunk_samples])
        return self.finish_stream(state, **kwargs)


# Reference-compatible alias (rhasspy_speech.KaldiNnet3StreamTranscriber)
KaldiNnet3StreamTranscriber = Nnet3StreamTranscriber
