"""Batch WAV transcription on one device: PCM -> MFCC -> i-vector ->
nnet3 forward -> dense 1-best Viterbi -> word assembly -> fuzzy match.

Counterpart of ``rhasspy_speech_tpu/pipeline/transcribe.py``'s batch path
(``Nnet3WavTranscriber.transcribe_pcm_batch`` -> ``_decode_batch``). On a
CUDA device the frontend is the MFCC kernel (``ops/mfcc_cuda.py``) and the
decoder the Viterbi kernel (``ops/viterbi_cuda.py``); on the CPU the same
calls run their plain twins. ``device="cuda"`` is the default and raises
where CUDA is absent.

Not ported yet, and raising ``NotImplementedError`` rather than answering
differently: n-best (nbest > 1), the checkpointed and frontier decoders,
silence weighting, GMM models, pitch features, bfloat16 compute, rescoring
and lattices (ROADMAP Queue 1).
"""

from __future__ import annotations

import asyncio
import json
import logging
import wave
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..host import (
    DiagGmm,
    IvectorExtractor,
    LangArtifacts,
    OnlineIvectorConfig,
    decode_meta,
    get_fuzzy_text,
    is_gmm_model,
    parse_conf,
    read_am_nnet3,
    read_kaldi_object,
)
from ..models.nnet3 import CompiledNnet3, compile_nnet3
from ..ops.cmvn import online_cmvn
from ..ops.decoder import _COMPACT_BP_MAX_ARC, DecodeGraph, traces_to_words_batch
from ..ops.frontend import (
    FrontendConfig,
    frontend_from_mfcc_conf,
    make_frontend_params,
    num_frames,
)
from ..ops.ivector import extract_ivectors, make_ivector_params
from ..ops.mfcc_cuda import mfcc_batch
from ..ops.viterbi_cuda import viterbi_decode

_LOGGER = logging.getLogger(__name__)

_BUCKET = 16  # output frames are padded to a multiple of this


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1, {item})")


def read_wav(path: Union[str, Path]) -> np.ndarray:
    """WAV -> 16 kHz mono float32 samples (Kaldi int16 range). Other rates
    and channel counts go through the native runtime's resampler."""
    with wave.open(str(path), "rb") as w:
        if w.getsampwidth() != 2:
            raise ValueError(f"{path}: expected 16-bit PCM, got {w.getsampwidth() * 8}-bit")
        if w.getframerate() == 16000 and w.getnchannels() == 1:
            return np.frombuffer(w.readframes(w.getnframes()), dtype=np.int16).astype(np.float32)
    from rhasspy_speech_tpu.native import load_wav

    return load_wav(str(path), target_rate=16000)


class AcousticModel:
    """A loaded nnet3 acoustic model, its MFCC frontend and i-vector
    extractor, on one device.

    model_dir layout: model/final.mdl, optional model/frontend.json or
    model/conf/mfcc*.conf, model/frame_subsampling_factor, and extractor/
    (final.ie, final.dubm, final.mat, optional global_cmvn.stats)."""

    def __init__(
        self,
        model_dir: Union[str, Path],
        frontend: Optional[FrontendConfig] = None,
        subsampling: Optional[int] = None,
        compute_dtype: Optional[str] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        self.device = resolve_device(device)
        if compute_dtype not in (None, "float32", "f32"):
            raise _not_ported(f"compute_dtype={compute_dtype!r}", "item 4 (bf16 AM)")
        model_dir = Path(model_dir)
        self.model_dir = model_dir
        mdl_path = model_dir / "model" / "final.mdl"
        if not mdl_path.exists() and (model_dir / "model" / "model" / "final.mdl").exists():
            model_dir = model_dir / "model"
            mdl_path = model_dir / "model" / "final.mdl"
        self._resolved_model_dir = model_dir
        if is_gmm_model(str(mdl_path)):
            raise _not_ported("GMM acoustic models", "item 13")
        self.transition_model, self.spec = read_am_nnet3(str(mdl_path))

        if subsampling is None:
            fsf = model_dir / "model" / "frame_subsampling_factor"
            subsampling = int(fsf.read_text().strip()) if fsf.exists() else 3
        self.subsampling = subsampling

        if frontend is None:
            frontend = FrontendConfig()
            frontend_path = model_dir / "model" / "frontend.json"
            if frontend_path.exists():
                with open(frontend_path, "r", encoding="utf-8") as f:
                    frontend = FrontendConfig(**json.load(f))
            else:
                for conf in (
                    model_dir / "model" / "conf" / "mfcc_hires.conf",
                    model_dir / "model" / "conf" / "mfcc.conf",
                    model_dir / "model" / "online" / "conf" / "mfcc.conf",
                ):
                    if conf.exists():
                        frontend = frontend_from_mfcc_conf(conf)
                        break
        self.frontend_config = frontend
        self.frontend_params = make_frontend_params(frontend, self.device)

        online_conf = model_dir / "model" / "conf" / "online.conf"
        if online_conf.exists() and "--add-pitch=true" in online_conf.read_text(
            encoding="utf-8"
        ).replace(" ", ""):
            raise _not_ported("pitch features", "item 14")

        self._buckets: Dict[int, CompiledNnet3] = {}
        self._has_ivector = any(n.kind == "input" and n.name == "ivector" for n in self.spec.nodes)
        self.ivector_params = None
        self.ivector_cmvn_stats = None
        ext_dir = model_dir / "extractor"
        if self._has_ivector and (ext_dir / "final.ie").exists():
            cfg = OnlineIvectorConfig()
            conf_path = ext_dir / "ivector_extractor.conf"
            if conf_path.exists():
                cfg = OnlineIvectorConfig.from_conf(parse_conf(str(conf_path)))
            self.ivector_params = make_ivector_params(
                DiagGmm.load(str(ext_dir / "final.dubm")),
                IvectorExtractor.load(str(ext_dir / "final.ie")),
                read_kaldi_object(str(ext_dir / "final.mat")),
                cfg,
                device=self.device,
            )
            cmvn_path = ext_dir / "global_cmvn.stats"
            if cmvn_path.exists():
                self.ivector_cmvn_stats = np.asarray(read_kaldi_object(str(cmvn_path)))
        self._log_priors = None
        if self.spec.priors is not None and self.spec.priors.shape[0]:
            self._log_priors = torch.log(
                torch.as_tensor(np.asarray(self.spec.priors), dtype=torch.float32, device=self.device)
            )

    @property
    def num_pdfs(self) -> int:
        return self.transition_model.num_pdfs

    def compiled(self, num_out_frames: int) -> CompiledNnet3:
        model = self._buckets.get(num_out_frames)
        if model is None:
            model = compile_nnet3(
                self.spec, num_out_frames, subsampling=self.subsampling, device=self.device
            )
            self._buckets[num_out_frames] = model
        return model

    def features(self, pcm: torch.Tensor) -> torch.Tensor:
        """[B, samples] f32 on this model's device -> [B, T, num_ceps]."""
        return mfcc_batch(self.frontend_params, pcm)

    @torch.no_grad()
    def log_probs(
        self,
        feats: torch.Tensor,
        num_out_frames: int,
        feat_lengths: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """[B, T, D] features -> [B, N, num_pdfs] pdf log-likelihood terms.
        Edge frames are replicated for context; ``feat_lengths`` [B] masks
        each stream's padding out of the i-vector stats; log-priors are
        subtracted when the model carries them."""
        model = self.compiled(num_out_frames)
        T = feats.shape[1]
        lo, hi = model.ranges["input"]
        idx = torch.as_tensor(np.clip(np.arange(lo, hi), 0, max(T - 1, 0)), device=feats.device)
        ivec = None
        if self._has_ivector:
            if self.ivector_params is not None:
                iv_feats = feats
                if self.ivector_cmvn_stats is not None:
                    iv_feats = online_cmvn(iv_feats, self.ivector_cmvn_stats)
                ivec = extract_ivectors(iv_feats, self.ivector_params, lengths=feat_lengths)
            else:
                ivec = feats.new_zeros((feats.shape[0], self.spec.ivector_dim))
        out = model(feats[:, idx], ivec)
        if self._log_priors is not None:
            out = out - self._log_priors[None, None, :]
        return out


# Backpointer byte budget for one dense decode call (sub-batches are sized
# to it).
DEFAULT_DECODE_BUDGET = 3 << 30


def select_decoder(
    num_states: int,
    batch: int,
    frames: int,
    k: int,
    max_active: int,
    budget: int = DEFAULT_DECODE_BUDGET,
    segment: int = 32,
    out_degree: Optional[int] = None,
    num_arcs: Optional[int] = None,
    min_sub_batch: int = 1,
) -> Tuple[str, int]:
    """Pick the decoder from the backpointer footprint (bytes), as the JAX
    package does: ("dense", sub_batch), ("checkpointed", sub_batch) or
    ("frontier", K). Only "dense" is ported."""
    min_sub = max(1, min(min_sub_batch, batch))
    bp_bytes = 2 if k == 1 and num_arcs is not None and num_arcs <= _COMPACT_BP_MAX_ARC else 4
    per_stream_dense = frames * num_states * k * bp_bytes
    if k > 1 and num_arcs is not None:
        per_stream_dense += num_arcs * k * 4
    if per_stream_dense * min_sub <= budget:
        return "dense", max(min_sub, min(batch, budget // per_stream_dense))
    n_seg = -(-frames // segment)
    per_stream_ckpt = (n_seg + segment) * num_states * 4
    if k == 1 and per_stream_ckpt * min_sub <= budget:
        return "checkpointed", max(min_sub, min(batch, budget // per_stream_ckpt))
    k_mem = budget // max(1, frames * batch * 3 * 4)
    if out_degree:
        k_mem = min(k_mem, budget // max(1, batch * out_degree * 4))
    return "frontier", max(1, min(max_active, num_states, k_mem))


class Nnet3WavTranscriber:
    """Reference-compatible WAV transcriber on one device.

    ``max_active``, ``beam``, ``min_active`` and ``lattice_beam`` only
    matter to decoders not ported yet; the dense decoder is exact."""

    def __init__(
        self,
        model_dir: Union[str, Path],
        graph_dir: Union[str, Path],
        tools: Optional[object] = None,  # unused; reference API parity
        max_active: int = 7000,
        lattice_beam: float = 8.0,
        acoustic_scale: float = 1.0,
        beam: float = 24.0,
        silence_weight: Optional[float] = None,
        decode_memory_budget: int = DEFAULT_DECODE_BUDGET,
        compute_dtype: Optional[str] = None,
        min_active: int = 200,
        device: Union[str, torch.device] = "cuda",
    ):
        if silence_weight is not None and silence_weight != 1.0:
            raise _not_ported("silence weighting", "item 9")
        self.device = resolve_device(device)
        self.model_dir = Path(model_dir)
        self.graph_dir = Path(graph_dir)
        self.acoustic_scale = acoustic_scale
        self.max_active = max_active
        self.lattice_beam = lattice_beam
        self.beam = beam
        self.min_active = min_active
        self.silence_weight = silence_weight
        self.decode_memory_budget = decode_memory_budget
        self.am = AcousticModel(self.model_dir, compute_dtype=compute_dtype, device=self.device)
        self.artifacts = LangArtifacts.load(self.graph_dir)
        if self.artifacts.graph is None:
            raise ValueError(f"no graph.npz in {graph_dir}")
        self.device_graph = DecodeGraph.from_dense(self.artifacts.graph, self.device)
        self._lang_cache: Dict[str, LangArtifacts] = {}

    def _lang(self, lang_dir: Optional[Union[str, Path]]) -> LangArtifacts:
        if lang_dir is None:
            return self.artifacts
        key = str(lang_dir)
        if key not in self._lang_cache:
            self._lang_cache[key] = LangArtifacts.load(lang_dir)
        return self._lang_cache[key]

    def _ids_to_text(self, word_ids: Sequence[int]) -> str:
        words = self.artifacts.words
        out = []
        for wid in word_ids:
            sym = words.find_id(wid)
            if sym is None or sym in ("<eps>", "#0", "<s>", "</s>"):
                continue
            out.append(sym)
        return " ".join(out)

    def _pad_batch(
        self, pcm_batch: List[np.ndarray]
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
        """PCM list -> (zero-padded PCM [B, S], feature frames [B], output
        frames [B], output frames padded to a multiple of 16), on this
        transcriber's device."""
        cfg = self.am.frontend_config
        n_frames = [num_frames(cfg, p.shape[0]) for p in pcm_batch]
        n_out = [-(-t // self.am.subsampling) for t in n_frames]
        bucket_out = -(-max(max(n_out), 1) // _BUCKET) * _BUCKET
        max_samples = max(max(p.shape[0] for p in pcm_batch), cfg.frame_length)
        pcm = np.zeros((len(pcm_batch), max_samples), dtype=np.float32)
        for i, p in enumerate(pcm_batch):
            pcm[i, : p.shape[0]] = p
        return (
            torch.as_tensor(pcm, device=self.device),
            torch.as_tensor(n_frames, dtype=torch.int32, device=self.device),
            torch.as_tensor(n_out, dtype=torch.int32, device=self.device),
            bucket_out,
        )

    def _acoustic_batch(self, pcm_batch: List[np.ndarray]) -> Tuple[torch.Tensor, torch.Tensor]:
        """PCM list -> (log_probs [B, N, P], output lengths [B] int32)."""
        pcm, feat_lengths, lengths, bucket_out = self._pad_batch(pcm_batch)
        feats = self.am.features(pcm)
        return self.am.log_probs(feats, bucket_out, feat_lengths=feat_lengths), lengths

    def _decode_traces(
        self, log_probs: torch.Tensor, lengths: torch.Tensor
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Dense decode in sub-batches sized to the backpointer budget:
        (arc_trace [B, N], final_state [B], total_cost [B]) on the host."""
        graph = self.artifacts.graph
        B, N = log_probs.shape[0], log_probs.shape[1]
        mode, sub = select_decoder(
            graph.num_states, B, N, 1, self.max_active, self.decode_memory_budget,
            num_arcs=graph.num_arcs,
        )
        if mode != "dense":
            raise _not_ported(f"the {mode} decoder (graph too big for dense)", "item 10")
        parts = []
        for start in range(0, B, sub):
            res = viterbi_decode(
                self.device_graph,
                log_probs[start : start + sub],
                acoustic_scale=self.acoustic_scale,
                lengths=lengths[start : start + sub],
            )
            parts.append([r.cpu().numpy() for r in res])
        return tuple(np.concatenate(p) for p in zip(*parts))

    def _decode_batch(
        self, pcm_batch: List[np.ndarray], nbest: int
    ) -> List[List[Tuple[List[int], float]]]:
        """PCM list -> per-utterance [(word ids, cost)] (empty when no
        complete path)."""
        if nbest > 1:
            raise _not_ported("nbest > 1", "item 7")
        trace, final_state, cost = self._decode_traces(*self._acoustic_batch(pcm_batch))
        assembled = traces_to_words_batch(self.artifacts.graph, trace, final_state, cost)
        return [[] if words is None else [(words, c)] for words, c in assembled]

    # -- public API ----------------------------------------------------------

    def transcribe(
        self,
        wav_path: Union[str, Path],
        lang_dir: Optional[Union[str, Path]] = None,
        nbest: int = 1,
        max_fuzzy_cost: Optional[float] = None,
        require_fuzzy: bool = False,
    ) -> List[str]:
        return self.transcribe_batch(
            [wav_path], lang_dir, nbest, max_fuzzy_cost, require_fuzzy
        )[0]

    def transcribe_batch(
        self,
        wav_paths: Sequence[Union[str, Path]],
        lang_dir: Optional[Union[str, Path]] = None,
        nbest: int = 1,
        max_fuzzy_cost: Optional[float] = None,
        require_fuzzy: bool = False,
    ) -> List[List[str]]:
        return self.transcribe_pcm_batch(
            [read_wav(p) for p in wav_paths], lang_dir, nbest, max_fuzzy_cost, require_fuzzy
        )

    def transcribe_pcm_batch(
        self,
        pcm_batch: Sequence[np.ndarray],
        lang_dir: Optional[Union[str, Path]] = None,
        nbest: int = 1,
        max_fuzzy_cost: Optional[float] = None,
        require_fuzzy: bool = False,
    ) -> List[List[str]]:
        """Transcripts per utterance; with the lang's G.fuzzy and
        ``max_fuzzy_cost`` set, the fuzzy-matched sentence replaces the
        decode when its cost is within budget (``require_fuzzy`` rejects
        the rest)."""
        nbest_lists = self._decode_batch(list(pcm_batch), nbest)
        return self._texts(nbest_lists, lang_dir, max_fuzzy_cost, require_fuzzy)

    def _texts(
        self,
        nbest_lists: List[List[Tuple[List[int], float]]],
        lang_dir: Optional[Union[str, Path]],
        max_fuzzy_cost: Optional[float],
        require_fuzzy: bool,
    ) -> List[List[str]]:
        """The host tail: fuzzy match (deduplicated per call) or the
        decoded words, through decode_meta."""
        lang = self._lang(lang_dir)
        out: List[List[str]] = []
        fuzzy_cache: Dict[tuple, Optional[Tuple[str, float]]] = {}
        for hyp_list in nbest_lists:
            texts: List[str] = []
            fuzzy_done = False
            if lang.g_fuzzy is not None and hyp_list:
                key = tuple(tuple(ids) for ids, _ in hyp_list)
                if key not in fuzzy_cache:
                    fuzzy_cache[key] = get_fuzzy_text(
                        [ids for ids, _ in hyp_list], lang.g_fuzzy, lang.words
                    )
                fuzzy = fuzzy_cache[key]
                if fuzzy is not None:
                    text, cost = fuzzy
                    _LOGGER.debug("Fuzzy: %r cost=%.3f", text, cost)
                    if max_fuzzy_cost is not None and cost <= max_fuzzy_cost:
                        texts = [decode_meta(text)]
                        fuzzy_done = True
            if not fuzzy_done and not require_fuzzy:
                texts = [decode_meta(self._ids_to_text(ids)) for ids, _ in hyp_list]
            out.append(texts)
        return out

    def transcribe_rescore(self, *args, **kwargs) -> List[str]:
        raise _not_ported("rescoring", "item 8")

    def get_lattice(self, *args, **kwargs):
        raise _not_ported("lattices", "item 8")

    def get_compact_lattice(self, *args, **kwargs):
        raise _not_ported("lattices", "item 8")

    def confidence(self, *args, **kwargs) -> float:
        raise _not_ported("lattice confidence", "item 8")

    async def async_transcribe(
        self,
        wav_path: Union[str, Path],
        lang_dir: Optional[Union[str, Path]] = None,
        nbest: int = 1,
        max_fuzzy_cost: Optional[float] = None,
        require_fuzzy: bool = False,
    ) -> List[str]:
        return await asyncio.to_thread(
            self.transcribe, wav_path, lang_dir, nbest, max_fuzzy_cost, require_fuzzy
        )

    async def async_transcribe_rescore(self, *args, **kwargs) -> List[str]:
        raise _not_ported("rescoring", "item 8")


# Reference-compatible alias (rhasspy_speech.KaldiNnet3WavTranscriber)
KaldiNnet3WavTranscriber = Nnet3WavTranscriber
