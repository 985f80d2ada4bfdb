"""Batch WAV transcription on one device: PCM -> MFCC -> i-vector ->
nnet3 forward -> Viterbi decode -> word assembly -> fuzzy match; lattices,
confidence and lattice rescoring beside it.

Counterpart of ``rhasspy_speech_tpu/pipeline/transcribe.py``
(``Nnet3WavTranscriber``). On a CUDA device the frontend is the MFCC kernel
(``ops/mfcc_cuda.py``) and the dense 1-best decoder the Viterbi kernel
(``ops/viterbi_cuda.py``); on the CPU the same calls run their plain twins.
The other decoders and the forward-backward pass of the lattice calls are
plain PyTorch on either device, as they are plain JAX in the JAX package.
``device="cuda"`` is the default and raises where CUDA is absent.

``select_decoder`` picks the decoder per call from the backpointer bytes
against ``decode_memory_budget``, as the JAX package does: ``"dense"``
(1-best or k-best, in sub-batches), ``"checkpointed"`` (1-best,
``ops.viterbi_cuda.viterbi_decode_checkpointed``) or ``"frontier"``
(``ops.frontier.viterbi_topk`` with K from ``max_active`` and the budget,
``beam`` and ``min_active``). On a card both 1-best modes run the Viterbi
kernel at any graph size: its replicated body holds up to ~29,000 states,
its halo body about C x 29,000 less the halos, its global body the rest
(``ops.viterbi_cuda.select_plan``); the checkpointed mode launches it once
per segment forward and once per segment back. The kernel raises when it
fails to build or launch; nothing falls back to a plain twin on the card.

With ``silence_weight`` set (and an i-vector extractor present), a
first-pass 1-best decode marks the silence frames, their weight in the
i-vector statistics drops to ``silence_weight``, and the batch is scored
again (the JAX package's OnlineSilenceWeighting equivalent).

A Kaldi GMM model dir (``final.mdl`` holding an AmDiagGmm) runs MFCC ->
deltas + delta-deltas -> per-pdf diagonal-GMM log-likelihoods
(``models/gmm.py``) -> the same decoders, with no i-vector and no frame
subsampling.

A model whose ``conf/online.conf`` says ``--add-pitch=true`` gets Kaldi's
3 pitch columns after its MFCCs (``ops/pitch.py``; ``conf/pitch.conf``
when present): the pitch-lag Viterbi kernel (``ops/pitch_viterbi_cuda.py``)
runs once a batch call on a card. Pitch runs over the zero-padded batch as
the JAX package pads it. The i-vector taps the base MFCCs; a GMM takes
deltas over ``[MFCC | pitch]``.

A recurrent (TDNN-LSTM) nnet3 model decodes the same way: its plan steps
one recurrence stride at a time over the bucket's window from zero state
(``models/nnet3.py``). ``compute_dtype="bfloat16"`` (or ``"bf16"``, or
``RSTPU_COMPUTE_DTYPE``) runs each bucket's AM forward in bf16 -- features
and i-vector cast in, log-probs cast back to f32 -- and keeps the decode
costs in f32.

With ``dither > 0`` in the frontend config (Kaldi's ``--dither``), each
batch call draws standard normal noise of the frames' shape ``[B, T,
frame_length]`` from a generator seeded with 42 and the call's count, and
the MFCC kernel (or its twin on the CPU) adds ``dither`` times it to each
frame before DC removal, as the JAX package's batch route does. The stream,
scheduler and Coqui routes run undithered, as the JAX package's do.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import wave
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..fst.core import SymbolTable
from ..grammar.fst import decode_meta
from ..io.gmm_am import is_gmm_model, read_am_diag_gmm
from ..io.ivector import DiagGmm, IvectorExtractor, OnlineIvectorConfig, parse_conf
from ..io.kaldi_io import read_kaldi_object
from ..io.lattice_io import compact_lattice_from_decode, determinize_lattice_phone_pruned
from ..io.nnet3_file import read_am_nnet3
from ..models.gmm import GmmAm, GmmChunkModel
from ..models.nnet3 import CompiledNnet3, compile_nnet3
from ..ops.cmvn import online_cmvn
from ..ops.deltas import add_deltas
from ..ops.decoder import (
    _COMPACT_BP_MAX_ARC,
    DecodeGraph,
    kbest_traces_to_nbest,
    traces_to_words_batch,
    viterbi_kbest_decode,
)
from ..ops.frontier import FrontierGraph, topk_backtrace_nbest, viterbi_topk_cached
from ..ops.frontend import (
    FrontendConfig,
    frontend_from_mfcc_conf,
    make_frontend_params,
    num_frames,
)
from ..ops.ivector import extract_ivectors, make_ivector_params
from ..ops.lattice import Lattice, build_lattice, forward_backward
from ..ops.mfcc_cuda import mfcc_batch
from ..ops.pitch import PitchConfig, pitch_batch, pitch_config_from_conf
from ..ops.viterbi_cuda import (
    kernel_scratch_bytes,
    libraries as viterbi_libraries,
    viterbi_decode,
    viterbi_decode_checkpointed,
)
from ..utils.warmup import Manifest, base_config, load_kernels
from .artifacts import LangArtifacts
from .endpoint import silence_pdfs_from_model
from .fuzzy import get_fuzzy_text, rescore_nbest
from .rescore import rescore_lattice, rescore_tail

_LOGGER = logging.getLogger(__name__)

_BUCKET = 16  # output frames are padded to a multiple of this
_BF16 = ("bfloat16", "bf16")
_DITHER_SEED = 42


def read_wav(path: Union[str, Path]) -> np.ndarray:
    """WAV -> 16 kHz mono float32 samples (Kaldi int16 range). Other rates
    and channel counts go through the native runtime's resampler."""
    with wave.open(str(path), "rb") as w:
        if w.getsampwidth() != 2:
            raise ValueError(f"{path}: expected 16-bit PCM, got {w.getsampwidth() * 8}-bit")
        if w.getframerate() == 16000 and w.getnchannels() == 1:
            return np.frombuffer(w.readframes(w.getnframes()), dtype=np.int16).astype(np.float32)
    from ..native import load_wav

    return load_wav(str(path), target_rate=16000)


class AcousticModel:
    """A loaded nnet3 or diagonal-GMM acoustic model, its MFCC frontend and
    i-vector extractor, on one device.

    model_dir layout: model/final.mdl, optional model/frontend.json or
    model/conf/mfcc*.conf, model/frame_subsampling_factor, and extractor/
    (final.ie, final.dubm, final.mat, optional global_cmvn.stats). A
    ``final.mdl`` that carries an AmDiagGmm after its TransitionModel
    (``ModelType.gmm``) loads into ``gmm`` (``spec`` is None): subsampling
    1, no i-vector."""

    def __init__(
        self,
        model_dir: Union[str, Path],
        frontend: Optional[FrontendConfig] = None,
        subsampling: Optional[int] = None,
        compute_dtype: Optional[str] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        self.device = resolve_device(device)
        # the AM forward's precision: f32 (the default) or bf16, also from
        # RSTPU_COMPUTE_DTYPE as in the JAX package
        self.compute_dtype = compute_dtype or os.environ.get("RSTPU_COMPUTE_DTYPE")
        if self.compute_dtype not in (None, "float32", "f32", *_BF16):
            raise ValueError(
                f"compute_dtype must be float32 or bfloat16, got {self.compute_dtype!r}"
            )
        self.bf16 = self.compute_dtype in _BF16
        # dither: a fresh draw per call, from a seed folded with the call's count
        self._dither_calls = 0
        self._dither_gen = torch.Generator(device=self.device)
        model_dir = Path(model_dir)
        self.model_dir = model_dir
        mdl_path = model_dir / "model" / "final.mdl"
        if not mdl_path.exists() and (model_dir / "model" / "model" / "final.mdl").exists():
            model_dir = model_dir / "model"
            mdl_path = model_dir / "model" / "final.mdl"
        self._resolved_model_dir = model_dir
        self.gmm: Optional[GmmAm] = None
        self.spec = None
        if is_gmm_model(str(mdl_path)):
            self.transition_model, gmms = read_am_diag_gmm(str(mdl_path))
            self.gmm = GmmAm.from_diag_gmms(gmms, self.device)
            if subsampling is None:
                subsampling = 1
        else:
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

        # Kaldi pitch features appended to the MFCCs, enabled the way
        # prepare_online_decoding.sh does: --add-pitch=true in online.conf
        # (online2/online-nnet2-feature-pipeline.cc:90-140)
        self.pitch_config: Optional[PitchConfig] = None
        online_conf = model_dir / "model" / "conf" / "online.conf"
        if online_conf.exists() and "--add-pitch=true" in online_conf.read_text(
            encoding="utf-8"
        ).replace(" ", ""):
            pitch_conf = model_dir / "model" / "conf" / "pitch.conf"
            if pitch_conf.exists():
                self.pitch_config = pitch_config_from_conf(
                    pitch_conf, samp_freq=frontend.samp_freq
                )
            else:
                self.pitch_config = PitchConfig(
                    samp_freq=frontend.samp_freq,
                    frame_shift_ms=frontend.frame_shift_ms,
                    frame_length_ms=frontend.frame_length_ms,
                )

        self._buckets: Dict[int, CompiledNnet3] = {}
        self._has_ivector = self.spec is not None and any(
            n.kind == "input" and n.name == "ivector" for n in self.spec.nodes
        )
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
        if self.spec is not None and self.spec.priors is not None and self.spec.priors.shape[0]:
            self._log_priors = torch.log(
                torch.as_tensor(np.asarray(self.spec.priors), dtype=torch.float32, device=self.device)
            )

    @property
    def num_pdfs(self) -> int:
        return self.transition_model.num_pdfs

    def compiled(self, num_out_frames: int) -> CompiledNnet3:
        """The bucket's AM plan for ``num_out_frames`` outputs, cast to bf16
        when the model computes in bf16 (its forward still takes and returns
        f32)."""
        if self.spec is None:
            raise ValueError(
                "a GMM acoustic model has no nnet3 plan: batch decoding runs through "
                "log_probs, streaming through chunk_model"
            )
        model = self._buckets.get(num_out_frames)
        if model is None:
            model = compile_nnet3(
                self.spec, num_out_frames, subsampling=self.subsampling, device=self.device
            )
            if self.bf16:
                model = model.cast(torch.bfloat16)
            self._buckets[num_out_frames] = model
        return model

    def chunk_model(self, chunk_out: int):
        """The streaming chunk model for ``chunk_out`` output frames, in f32:
        a ``GmmChunkModel`` for a GMM, else the ``compile_nnet3`` plan
        (recurrent or not)."""
        if self.gmm is not None:
            return GmmChunkModel(self.gmm, chunk_out)
        return compile_nnet3(self.spec, chunk_out, subsampling=self.subsampling, device=self.device)

    def features(self, pcm: torch.Tensor) -> torch.Tensor:
        """[B, samples] f32 on this model's device -> [B, T, D]: the MFCCs,
        with a pitch model's 3 pitch columns appended. With dither each call
        draws new noise (``dither_noise``)."""
        mfcc = mfcc_batch(self.frontend_params, pcm, self.dither_noise(pcm))
        if self.pitch_config is not None:
            mfcc = self._append_pitch(mfcc, pcm)
        return mfcc

    def dither_noise(self, pcm: torch.Tensor) -> Optional[torch.Tensor]:
        """None without dither; else this call's standard normal draw of the
        frames' shape [B, T, frame_length] on the model's device, from the
        generator seeded with 42 and the call's count (the JAX package folds
        the count into ``PRNGKey(42)``): call k's noise depends on k and the
        shape alone, so two fresh models draw alike call for call."""
        cfg = self.frontend_config
        if cfg.dither == 0.0:
            return None
        self._dither_calls += 1
        self._dither_gen.manual_seed((_DITHER_SEED << 32) + self._dither_calls)
        shape = (pcm.shape[0], num_frames(cfg, pcm.shape[1]), cfg.frame_length)
        return torch.randn(shape, generator=self._dither_gen, dtype=torch.float32,
                           device=self.device)

    def _append_pitch(self, mfcc: torch.Tensor, pcm: torch.Tensor) -> torch.Tensor:
        """Append the 3-dim Kaldi pitch features, aligned to the MFCC frame
        count (the online pipeline repeats the last pitch frame when the
        4 kHz pitch stream yields fewer frames)."""
        pf = pitch_batch(self.pitch_config, pcm)
        T, Tp = mfcc.shape[1], pf.shape[1]
        if Tp >= T:
            pf = pf[:, :T]
        else:
            pf = torch.cat([pf, pf[:, -1:].expand(-1, T - Tp, -1)], dim=1)
        return torch.cat([mfcc, pf], dim=-1)

    @torch.no_grad()
    def log_probs(
        self,
        feats: torch.Tensor,
        num_out_frames: int,
        ivector_frame_weights: Optional[torch.Tensor] = None,
        feat_lengths: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """[B, T, D] features -> [B, N, num_pdfs] pdf log-likelihood terms.
        Edge frames are replicated for context; ``ivector_frame_weights``
        [B, T] scales each frame's weight in the i-vector stats (silence
        weighting); ``feat_lengths`` [B] masks each stream's padding out of
        the i-vector stats; log-priors are subtracted when the model
        carries them. A GMM scores deltas + delta-deltas of every frame."""
        T = feats.shape[1]
        if self.gmm is not None:
            full = add_deltas(feats, order=2)
            idx = torch.as_tensor(np.clip(np.arange(num_out_frames), 0, max(T - 1, 0)),
                                  device=feats.device)
            return self.gmm.log_likes(full[:, idx])
        model = self.compiled(num_out_frames)
        lo, hi = model.ranges["input"]
        idx = torch.as_tensor(np.clip(np.arange(lo, hi), 0, max(T - 1, 0)), device=feats.device)
        ivec = None
        if self._has_ivector:
            if self.ivector_params is not None:
                # the i-vector branch taps the base MFCC: pitch columns go
                # to the nnet input only (online-nnet2-feature-pipeline.cc)
                iv_feats = feats[..., : self.frontend_config.num_ceps]
                if self.ivector_cmvn_stats is not None:
                    iv_feats = online_cmvn(iv_feats, self.ivector_cmvn_stats)
                ivec = extract_ivectors(
                    iv_feats, self.ivector_params, lengths=feat_lengths,
                    frame_weights=ivector_frame_weights,
                )
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
    kernel_scratch: int = 0,
) -> Tuple[str, int]:
    """Pick the decoder from the backpointer footprint (bytes), as the JAX
    package does: ("dense", sub_batch), ("checkpointed", sub_batch) or
    ("frontier", K). ``kernel_scratch`` is the device memory a stream of
    the 1-best kernel holds besides its backpointers
    (``ops.viterbi_cuda.kernel_scratch_bytes``: the global body's alpha
    scratch); it counts toward the budget of both 1-best modes."""
    min_sub = max(1, min(min_sub_batch, batch))
    bp_bytes = 2 if k == 1 and num_arcs is not None and num_arcs <= _COMPACT_BP_MAX_ARC else 4
    per_stream_dense = frames * num_states * k * bp_bytes
    if k > 1 and num_arcs is not None:
        per_stream_dense += num_arcs * k * 4
    if k == 1:
        per_stream_dense += kernel_scratch
    if per_stream_dense * min_sub <= budget:
        return "dense", max(min_sub, min(batch, budget // per_stream_dense))
    n_seg = -(-frames // segment)
    per_stream_ckpt = (n_seg + segment) * num_states * 4 + kernel_scratch
    if k == 1 and per_stream_ckpt * min_sub <= budget:
        return "checkpointed", max(min_sub, min(batch, budget // per_stream_ckpt))
    k_mem = budget // max(1, frames * batch * 3 * 4)
    if out_degree:
        k_mem = min(k_mem, budget // max(1, batch * out_degree * 4))
    return "frontier", max(1, min(max_active, num_states, k_mem))


class Nnet3WavTranscriber:
    """Reference-compatible WAV transcriber on one device.

    ``max_active``, ``beam`` and ``min_active`` only matter to the frontier
    decoder; the dense and checkpointed decoders are exact.
    ``lattice_beam`` prunes the lattices of ``get_lattice``, ``confidence``
    and ``transcribe_rescore``. ``last_decode_plan`` is the (mode, argument)
    ``select_decoder`` gave the latest decode.

    ``warmup(batch, seconds, nbest)`` builds and loads the kernels the
    model's routes use and decodes one zero batch of that shape, so the
    first real call pays no build, library load, plan or table
    (``utils/warmup.py``). ``save_aot(pcm_batch, nbest)`` warms at the
    batch's shape and records it in ``<aot_dir>/warmup.json`` (default
    ``<graph_dir>/aot``); a transcriber constructed with a manifest of its
    own configuration warms the recorded shapes before it returns."""

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
        aot_dir: Optional[Union[str, Path]] = None,
        device: Union[str, torch.device] = "cuda",
    ):
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
        self._silence_pdfs: Optional[frozenset] = None
        self._frontier_graph: Optional[FrontierGraph] = None
        self._out_degree: Optional[int] = None
        # the Viterbi kernel's scratch a stream on this card, for select_decoder
        self._kernel_scratch = kernel_scratch_bytes(self.device_graph)
        self.last_decode_plan: Optional[Tuple[str, int]] = None
        self._aot = Manifest(aot_dir if aot_dir is not None else self.graph_dir / "aot")
        for batch, samples, nbest in self._aot.shapes("batch", self._warm_config, self._kernels()):
            self._warm(batch, samples, nbest)

    # -- warm start (utils/warmup.py) -------------------------------------------

    def _kernels(self) -> List[str]:
        """The kernels this model's batch routes launch on a card."""
        return (["mfcc"] + viterbi_libraries(self.device_graph.num_states)
                + (["pitch_viterbi"] if self.am.pitch_config is not None else []))

    def _warm_config(self) -> Dict:
        cfg = base_config(self.am, self.graph_dir, self.device)
        cfg.update(
            acoustic_scale=self.acoustic_scale, max_active=self.max_active, beam=self.beam,
            min_active=self.min_active, silence_weight=self.silence_weight,
            decode_memory_budget=self.decode_memory_budget,
        )
        return cfg

    def _warm(self, batch: int, samples: int, nbest: int) -> None:
        """Build and load the kernels, then decode one zero batch of
        [batch, samples] (a dithering model's draws are left where they
        were)."""
        load_kernels(self._kernels(), self.device)
        calls = self.am._dither_calls
        self._decode_batch([np.zeros(samples, dtype=np.float32)] * batch, nbest)
        self.am._dither_calls = calls
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup(self, batch: int = 8, seconds: float = 3.0, nbest: int = 1) -> None:
        """Pay the first call's one-time costs for ``batch`` utterances of
        ``seconds``, decoded ``nbest`` (the constructor does it for the
        shapes a manifest records)."""
        self._warm(batch, int(round(seconds * self.am.frontend_config.samp_freq)), nbest)

    def save_aot(self, pcm_batch: List[np.ndarray], nbest: int = 1) -> Path:
        """Warm at this batch's shape (its size and longest utterance) and
        record it in the manifest; returns the manifest's directory. Run
        once at deploy time with a batch shaped like production traffic."""
        samples = max(p.shape[0] for p in pcm_batch)
        self._warm(len(pcm_batch), samples, nbest)
        return self._aot.add("batch", self._warm_config(), self._kernels(),
                             (len(pcm_batch), samples, nbest))

    def _get_silence_pdfs(self) -> frozenset:
        """The model's silence pdfs, from ``model/phones.txt`` (empty
        without one, and then silence weighting does nothing)."""
        if self._silence_pdfs is None:
            pdfs = frozenset()
            phones_path = self.am._resolved_model_dir / "model" / "phones.txt"
            if phones_path.exists():
                with open(phones_path, "r", encoding="utf-8") as f:
                    model_phones = SymbolTable.read_text(f)
                pdfs = frozenset(silence_pdfs_from_model(self.am.transition_model, model_phones))
            self._silence_pdfs = pdfs
        return self._silence_pdfs

    def _silence_frame_weights(
        self, log_probs: torch.Tensor, lengths: torch.Tensor, num_in_frames: int
    ) -> Optional[torch.Tensor]:
        """First-pass 1-best alignment -> [B, T_in] i-vector frame weights
        (silence frames get ``silence_weight``, speech frames 1.0)."""
        sil_pdfs = self._get_silence_pdfs()
        if not sil_pdfs:
            return None
        # a dense decode of the whole batch whatever the budget, as in the
        # JAX package
        graph = self.artifacts.graph
        plan = select_decoder(
            graph.num_states, log_probs.shape[0], log_probs.shape[1], 1, self.max_active,
            budget=1 << 62, num_arcs=graph.num_arcs, kernel_scratch=self._kernel_scratch,
        )
        trace, _final, _cost = self._decode_traces(log_probs, lengths, plan)
        # trace [B, T_out]: arc id, STAY, or -1
        B, T_out = trace.shape
        # forward-fill self-loop (STAY) frames with the last real arc
        filled = trace.copy()
        for t in range(1, T_out):
            m = filled[:, t] < 0
            filled[m, t] = filled[m, t - 1]
        pdf = np.where(filled >= 0, graph.arc_pdf[np.maximum(filled, 0)], -1)
        is_sil = np.isin(pdf, np.fromiter(sil_pdfs, dtype=np.int64))
        w_out = np.where(is_sil, float(self.silence_weight), 1.0)
        # upsample output-frame weights to the input frame rate
        idx = np.minimum(np.arange(num_in_frames) // self.am.subsampling, T_out - 1)
        return torch.as_tensor(w_out[:, idx].astype(np.float32), device=self.device)

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
        """PCM list -> (log_probs [B, N, P], output lengths [B] int32).
        With silence weighting on, the log-probs are those of the second,
        silence-weighted pass."""
        pcm, feat_lengths, lengths, bucket_out = self._pad_batch(pcm_batch)
        feats = self.am.features(pcm)
        log_probs = self.am.log_probs(feats, bucket_out, feat_lengths=feat_lengths)
        if (
            self.silence_weight is not None
            and self.silence_weight != 1.0
            and self.am.ivector_params is not None
        ):
            w = self._silence_frame_weights(log_probs, lengths, feats.shape[1])
            if w is not None:
                log_probs = self.am.log_probs(
                    feats, bucket_out, ivector_frame_weights=w, feat_lengths=feat_lengths
                )
        return log_probs, lengths

    def _graph_out_degree(self) -> int:
        """Max out-degree of the decode graph (frontier expansion width)."""
        if self._out_degree is None:
            g = self.artifacts.graph
            self._out_degree = (
                int(np.bincount(g.arc_src, minlength=g.num_states).max()) if g.num_arcs else 1
            )
        return self._out_degree

    def _plan(self, batch: int, frames: int, k: int) -> Tuple[str, int]:
        """``select_decoder`` for this graph and budget (no mesh in the
        port, so ``min_sub_batch`` stays 1)."""
        graph = self.artifacts.graph
        plan = select_decoder(
            graph.num_states, batch, frames, k, self.max_active, self.decode_memory_budget,
            out_degree=self._graph_out_degree(), num_arcs=graph.num_arcs,
            kernel_scratch=self._kernel_scratch,
        )
        self.last_decode_plan = plan
        return plan

    def _decode_traces(
        self,
        log_probs: torch.Tensor,
        lengths: torch.Tensor,
        plan: Optional[Tuple[str, int]] = None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Exact 1-best decode in sub-batches sized to the budget, by the
        decoder the plan names ("dense": ``ops.viterbi_cuda.viterbi_decode``;
        "checkpointed": ``ops.viterbi_cuda.viterbi_decode_checkpointed``;
        both the Viterbi kernel on a card): (arc_trace [B, N], final_state
        [B], total_cost [B]) on the host."""
        B, N = log_probs.shape[0], log_probs.shape[1]
        mode, sub = plan or self._plan(B, N, 1)
        if mode == "frontier":
            raise ValueError("the frontier decoder keeps no arc traces; see _decode_frontier")
        decode = {"dense": viterbi_decode, "checkpointed": viterbi_decode_checkpointed}[mode]
        parts = []
        for start in range(0, B, sub):
            res = decode(
                self.device_graph, log_probs[start : start + sub],
                acoustic_scale=self.acoustic_scale, lengths=lengths[start : start + sub],
            )
            parts.append([r.cpu().numpy() if isinstance(r, torch.Tensor) else r for r in res])
        return tuple(np.concatenate(p) for p in zip(*parts))

    def _decode_nbest(
        self,
        log_probs: torch.Tensor,
        lengths: torch.Tensor,
        k: int,
        plan: Optional[Tuple[str, int]] = None,
    ) -> List[List[Tuple[List[int], float]]]:
        """Dense k-best decode in sub-batches sized to the backpointer
        budget ([T, sub, S, k] int32 plus the [sub, A, k] candidates):
        per-utterance n-best [(word ids, cost)], at most k each."""
        graph = self.artifacts.graph
        B, N = log_probs.shape[0], log_probs.shape[1]
        mode, sub = plan or self._plan(B, N, k)
        if mode != "dense":
            return self._decode_frontier(log_probs, lengths, k, sub)
        out: List[List[Tuple[List[int], float]]] = []
        for start in range(0, B, sub):
            res = viterbi_kbest_decode(
                self.device_graph,
                log_probs[start : start + sub],
                k,
                acoustic_scale=self.acoustic_scale,
                lengths=lengths[start : start + sub],
            )
            traces, seed_states, seed_costs = (r.cpu().numpy() for r in res)
            out.extend(
                kbest_traces_to_nbest(graph, traces, seed_states, seed_costs, i, n=k)
                for i in range(traces.shape[0])
            )
        return out

    def _decode_frontier(
        self, log_probs: torch.Tensor, lengths: torch.Tensor, n: int, max_states: int
    ) -> List[List[Tuple[List[int], float]]]:
        """Sparse-frontier decode of the whole batch, keeping ``max_states``
        states a stream a frame: per-utterance n-best [(word ids, cost)]
        from the final frontier's slots (1-best is n = 1)."""
        graph = self.artifacts.graph
        if self._frontier_graph is None:
            self._frontier_graph = FrontierGraph.from_dense(
                graph, self.device, base=self.device_graph
            )
        res = viterbi_topk_cached(
            self._frontier_graph,
            log_probs,
            max_states,
            acoustic_scale=self.acoustic_scale,
            lengths=lengths,
            scratch_bytes=self.decode_memory_budget,
            beam=self.beam,
            min_active=self.min_active,
        )
        states_t, alphas_t, arcs_t = (r.cpu().numpy() for r in res)
        return [
            topk_backtrace_nbest(graph, states_t, alphas_t, arcs_t, i, n=n)
            for i in range(log_probs.shape[0])
        ]

    def _decode_batch(
        self, pcm_batch: List[np.ndarray], nbest: int
    ) -> List[List[Tuple[List[int], float]]]:
        """PCM list -> per-utterance n-best [(word ids, cost)] (empty when
        no complete path), by the decoder ``select_decoder`` picks."""
        log_probs, lengths = self._acoustic_batch(pcm_batch)
        k = max(nbest, 1)
        plan = self._plan(log_probs.shape[0], log_probs.shape[1], k)
        if plan[0] == "frontier":
            return self._decode_frontier(log_probs, lengths, k, plan[1])
        if k > 1:
            return self._decode_nbest(log_probs, lengths, k, plan)
        trace, final_state, cost = self._decode_traces(log_probs, lengths, plan)
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

    def _utterance_log_probs(self, pcm: np.ndarray) -> torch.Tensor:
        """One utterance's [1, N, P] log-probs over its own frames (no
        bucket padding), as the lattice calls score it."""
        pcm_t, _feat_lengths, _lengths, _bucket = self._pad_batch([pcm])
        T = num_frames(self.am.frontend_config, pcm.shape[0])
        n_out = max(1, -(-T // self.am.subsampling))
        return self.am.log_probs(self.am.features(pcm_t), n_out)

    def get_lattice_pcm(
        self, pcm: np.ndarray, lattice_beam: Optional[float] = None
    ) -> Optional[Lattice]:
        """Pruned word lattice for one utterance's samples: tropical
        forward-backward over the dense graph on this transcriber's device,
        then every (frame, arc) within ``lattice_beam`` of the best path
        kept in a host DAG (None when no path completes)."""
        log_probs = self._utterance_log_probs(pcm)
        alphas, betas = forward_backward(self.device_graph, log_probs, self.acoustic_scale)
        return build_lattice(
            self.artifacts.graph,
            alphas.cpu().numpy(),
            betas.cpu().numpy(),
            log_probs.cpu().numpy(),
            0,
            lattice_beam=lattice_beam if lattice_beam is not None else self.lattice_beam,
            acoustic_scale=self.acoustic_scale,
        )

    def get_lattice(
        self, wav_path: Union[str, Path], lattice_beam: Optional[float] = None
    ) -> Optional[Lattice]:
        """Pruned word lattice for one WAV file (``get_lattice_pcm``)."""
        return self.get_lattice_pcm(read_wav(wav_path), lattice_beam=lattice_beam)

    def get_compact_lattice(
        self,
        wav_path: Union[str, Path],
        lattice_beam: Optional[float] = None,
        determinize: bool = True,
    ):
        """Word-level Kaldi CompactLattice for one utterance, writable with
        the host's lattice writers. ``determinize`` (the default) gives the
        canonical form Kaldi tools expect: epsilon-free, one path per word
        sequence at its best cost."""
        lat = self.get_lattice(wav_path, lattice_beam=lattice_beam)
        if lat is None:
            return None
        clat = compact_lattice_from_decode(lat, self.artifacts.graph)
        if determinize:
            try:
                clat = determinize_lattice_phone_pruned(clat, self.am.transition_model)
            except ValueError as exc:
                # as Kaldi's DeterminizeLatticePhonePrunedWrapper, degrade to
                # the input lattice rather than fail the utterance
                _LOGGER.warning(
                    "lattice determinization gave up (%s); exporting the "
                    "undeterminized lattice",
                    exc,
                )
        return clat

    def confidence_pcm(self, pcm: np.ndarray, n: int = 8) -> float:
        """Posterior of the 1-best transcript over the lattice's n best
        distinct word sequences, in [0, 1]: exp(-c1) / sum_i exp(-ci)."""
        lat = self.get_lattice_pcm(pcm)
        if lat is None:
            return 0.0
        hyps = lat.nbest(self.artifacts.graph, n, dedup=True)
        if not hyps:
            return 0.0
        costs = np.asarray([c for _, c in hyps], dtype=np.float64)
        w = np.exp(-(costs - costs.min()))
        return float(w[0] / w.sum())

    def confidence(self, wav_path: Union[str, Path], n: int = 8) -> float:
        return self.confidence_pcm(read_wav(wav_path), n=n)

    def transcribe_rescore(
        self,
        wav_path: Union[str, Path],
        old_lang_dir: Union[str, Path],
        new_lang_dir: Union[str, Path],
        nbest: int = 5,
        max_fuzzy_cost: Optional[float] = None,
        require_fuzzy: bool = False,
    ) -> List[str]:
        """Dual-graph rescore: decode with this transcriber's graph, remap
        the pruned decode lattice through the new lang dir's lexicon and LM,
        then run the fuzzy tail against ``old_lang_dir``'s G.fuzzy. Falls
        back to an n-best-list LM swap, which cannot recover hypotheses
        outside the first pass, only when the artifacts lack lattice
        metadata."""
        old_lang = self._lang(old_lang_dir)
        new_lang = self._lang(new_lang_dir)
        if new_lang.g_fst is None:
            raise ValueError(f"no G.fst in {new_lang_dir}")
        graph = self.artifacts.graph
        if graph.has_phone_info and new_lang.ldet is not None:
            lat = self.get_lattice(wav_path)
            hyp_list = (
                rescore_lattice(lat, graph, self.artifacts.phones, new_lang, nbest=nbest)
                if lat is not None
                else []
            )
        else:
            _LOGGER.warning(
                "Artifacts lack lattice rescore metadata (phone tags or "
                "ldet.fst) — falling back to an n-best LM swap, which cannot "
                "recover hypotheses outside the first pass. Retrain to fix."
            )
            if old_lang.g_fst is None:
                raise ValueError(f"no G.fst in {old_lang_dir}")
            hyp_list = rescore_nbest(
                self._decode_batch([read_wav(wav_path)], nbest)[0],
                old_lang.g_fst,
                new_lang.g_fst,
                self.artifacts.words,
            )
        return rescore_tail(hyp_list, old_lang, new_lang, max_fuzzy_cost, require_fuzzy)

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

    async def async_transcribe_rescore(
        self,
        wav_path: Union[str, Path],
        old_lang_dir: Union[str, Path],
        new_lang_dir: Union[str, Path],
        nbest: int = 5,
        max_fuzzy_cost: Optional[float] = None,
        require_fuzzy: bool = False,
    ) -> List[str]:
        return await asyncio.to_thread(
            self.transcribe_rescore,
            wav_path, old_lang_dir, new_lang_dir, nbest, max_fuzzy_cost, require_fuzzy,
        )


# Reference-compatible alias (rhasspy_speech.KaldiNnet3WavTranscriber)
KaldiNnet3WavTranscriber = Nnet3WavTranscriber
