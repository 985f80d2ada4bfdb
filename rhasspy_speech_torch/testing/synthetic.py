"""Synthetic acoustic profiles for hermetic end-to-end testing and benching.

Each base phone gets a distinct two-tone spectral signature. From those
signatures we derive:

- an audio synthesizer (``synthesize_sentence``): word -> phones ->
  concatenated signature waveforms at 16 kHz;
- a matching acoustic model: MFCC centroid c_p per phone; an affine layer
  with row 2*c_p/tau and bias -|c_p|^2/tau followed by LogSoftmax is exactly
  a unit-variance Gaussian classifier (log p ~ -|x - c_p|^2 / tau), written
  as a real Kaldi-format final.mdl (one pdf per phone id, 1-state HMM
  topology) so the full parser/compiler path is exercised.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..const import SIL, SPN, UNK
from ..fst.core import SymbolTable
from ..io.nnet3_file import ComponentSpec, NodeSpec, Nnet3Spec, parse_descriptor, write_nnet3
from ..io.transition_model import (
    K_NO_PDF,
    KaldiHmmTopology,
    KaldiTransitionModel,
    TopologyState,
)
from ..lang.lexicon_fst import prepare_lang
from ..ops.frontend import FrontendConfig, mfcc_numpy

SAMPLE_RATE = 16000
FRAME_SHIFT = 160


def _base_phone(name: str) -> str:
    for suffix in ("_B", "_E", "_I", "_S"):
        if name.endswith(suffix):
            return name[: -len(suffix)]
    return name


def _phone_freqs(base_phones: Sequence[str]) -> Dict[str, Tuple[float, float]]:
    """Assign each base phone a distinct two-tone signature in 300-6000 Hz."""
    freqs: Dict[str, Tuple[float, float]] = {}
    n = len(base_phones)
    for i, p in enumerate(sorted(base_phones)):
        f1 = 300.0 + 250.0 * i
        f2 = 500.0 + 173.0 * ((i * 7) % max(n, 1)) + 37.0 * i
        freqs[p] = (f1, f2)
    return freqs


def _phone_wave(
    freqs: Tuple[float, float], n_samples: int, rng: np.random.RandomState
) -> np.ndarray:
    t = np.arange(n_samples) / SAMPLE_RATE
    wave = 6000.0 * np.sin(2 * np.pi * freqs[0] * t) + 3000.0 * np.sin(
        2 * np.pi * freqs[1] * t + 0.7
    )
    wave += 50.0 * rng.randn(n_samples)
    return wave.astype(np.float32)


def _silence_wave(n_samples: int, rng: np.random.RandomState) -> np.ndarray:
    return (20.0 * rng.randn(n_samples)).astype(np.float32)


@dataclass
class SyntheticProfile:
    """A complete on-disk model profile + synthesis tables."""

    model_dir: Path
    frontend: FrontendConfig
    lexicon: Dict[str, List[str]]  # word -> base phones
    phone_freqs: Dict[str, Tuple[float, float]]
    sil_phone: str = SIL
    spn_phone: str = SPN


def synthesize_sentence(
    profile: SyntheticProfile,
    text: str,
    frames_per_phone: int = 9,
    sil_frames: int = 12,
    seed: int = 0,
) -> np.ndarray:
    """Synthesize 16 kHz PCM for a sentence of in-lexicon words."""
    rng = np.random.RandomState(seed)
    chunks = [_silence_wave(sil_frames * FRAME_SHIFT, rng)]
    for word in text.split():
        phones = profile.lexicon.get(word)
        if phones is None:
            raise KeyError(f"word {word!r} not in synthetic lexicon")
        for phone in phones:
            chunks.append(
                _phone_wave(
                    profile.phone_freqs[phone],
                    frames_per_phone * FRAME_SHIFT,
                    rng,
                )
            )
    chunks.append(_silence_wave(sil_frames * FRAME_SHIFT, rng))
    return np.concatenate(chunks)


def build_synthetic_profile(
    model_dir: Union[str, Path],
    lexicon: Dict[str, List[str]],
    frontend: Optional[FrontendConfig] = None,
    tau: float = 50.0,
    seed: int = 1234,
    recurrent_delay: Optional[int] = None,
    with_ivector: bool = False,
    with_pitch: bool = False,
    with_ivector_cmvn: bool = False,
    with_context: bool = False,
) -> SyntheticProfile:
    """Write a model dir (config.json, model/final.mdl, model/phones.txt,
    model/frontend.json) whose AM recognizes audio from synthesize_sentence.

    With ``recurrent_delay`` set, the nnet3 graph additionally carries a
    real LSTM-style back-edge at that delay whose output contribution is
    exactly zero (zero-weight projection into the Sum) — transcripts stay
    deterministic while every recurrent code path (stepwise scan, ring
    carry, streaming state) is exercised end to end.

    With ``with_ivector`` the model dir additionally ships a synthetic
    extractor/ (final.dubm, final.ie, final.mat) and the AM consumes
    Append(input, ReplaceIndex(ivector, t, 0)) with ZERO weights on the
    i-vector columns — the full i-vector pipeline (splice, LDA, gselect,
    stats, solve) runs on every decode without perturbing transcripts.

    ``with_pitch`` writes conf/online.conf with --add-pitch=true and widens
    the AM input by the 3 pitch dims (zero weights), so the pitch pipeline
    runs end to end with transcripts unchanged.

    ``with_ivector_cmvn`` additionally writes extractor/global_cmvn.stats
    (the standard prepare_online_decoding export), exercising the online
    CMVN applied to the i-vector branch's base-MFCC tap."""
    model_dir = Path(model_dir)
    (model_dir / "model").mkdir(parents=True, exist_ok=True)
    if frontend is None:
        frontend = FrontendConfig(num_mel_bins=20, num_ceps=20)

    base_phones = sorted({p for phones in lexicon.values() for p in phones})
    phone_freqs = _phone_freqs(base_phones)
    rng = np.random.RandomState(seed)

    # The model's phone inventory must match what prepare_lang produces at
    # train time: run prepare_lang on the same lexicon (plus unk) to get the
    # canonical position-dependent phones.txt.
    entries = [(w, list(p)) for w, p in sorted(lexicon.items())]
    entries.append((UNK, [SPN]))
    lang = prepare_lang(entries, silence_phones=[SIL, SPN], optional_silence=SIL)
    phones: SymbolTable = lang.phones

    # MFCC centroid per base phone (1 second of signature audio)
    centroids: Dict[str, np.ndarray] = {}
    for p in base_phones:
        wave = _phone_wave(phone_freqs[p], SAMPLE_RATE, rng)
        feats = mfcc_numpy(frontend, wave)
        centroids[p] = feats.mean(axis=0)
    centroids[SIL] = mfcc_numpy(
        frontend, _silence_wave(SAMPLE_RATE, rng)
    ).mean(axis=0)
    centroids[SPN] = mfcc_numpy(
        frontend, (500.0 * rng.randn(SAMPLE_RATE)).astype(np.float32)
    ).mean(axis=0)

    # One pdf per emitting phone id; 1-state HMM topology (is_hmm)
    emitting: List[Tuple[str, int]] = []  # (name, phone id)
    for name, pid in sorted(phones, key=lambda kv: kv[1]):
        if pid == 0 or name.startswith("#"):
            continue
        emitting.append((name, pid))

    phone_ids = [pid for _, pid in emitting]
    max_phone = max(phone_ids)
    phone2idx = np.full(max_phone + 1, -1, dtype=np.int64)
    for pid in phone_ids:
        phone2idx[pid] = 0
    topo = KaldiHmmTopology(
        phones=np.asarray(sorted(phone_ids), dtype=np.int64),
        phone2idx=phone2idx,
        entries=[
            [
                TopologyState(0, 0, [(0, 0.5), (1, 0.5)]),
                TopologyState(K_NO_PDF, K_NO_PDF, []),
            ]
        ],
    )
    tuples = np.zeros((len(emitting), 4), dtype=np.int64)
    rows = np.zeros((len(emitting), frontend.num_ceps), dtype=np.float32)
    bias = np.zeros(len(emitting), dtype=np.float32)
    for pdf, (name, pid) in enumerate(emitting):
        tuples[pdf] = (pid, 0, pdf, pdf)
        c = centroids.get(_base_phone(name))
        assert c is not None, name
        rows[pdf] = (2.0 * c / tau).astype(np.float32)
        bias[pdf] = float(-np.dot(c, c) / tau)
    num_tids = 2 * len(emitting)
    log_probs = np.full(num_tids + 1, math.log(0.5), dtype=np.float32)
    log_probs[0] = 0.0
    ktm = KaldiTransitionModel(topology=topo, tuples=tuples, log_probs=log_probs)

    IVEC_DIM = 8
    input_dim = frontend.num_ceps + (3 if with_pitch else 0)
    aff_rows = rows
    if with_pitch:
        aff_rows = np.concatenate(
            [aff_rows, np.zeros((rows.shape[0], 3), dtype=np.float32)], axis=1
        )
    if with_context:
        # genuine ±5-frame temporal context (zero weights on the offset
        # copies, so transcripts are unchanged) — gives the AM a nnet
        # input range wide enough to cover the i-vector splice window
        # (chunk_in + splice_right frames), exercising streaming paths
        # that slice it from the AM window
        zeros_ctx = np.zeros_like(aff_rows)
        aff_rows = np.concatenate([zeros_ctx, aff_rows, zeros_ctx], axis=1)
        ctx_input = "Append(Offset(input, -5), input, Offset(input, 5))"
    else:
        ctx_input = "input"
    if with_ivector:
        aff_rows = np.concatenate(
            [aff_rows, np.zeros((rows.shape[0], IVEC_DIM), dtype=np.float32)],
            axis=1,
        )
        aff_input = f"Append({ctx_input}, ReplaceIndex(ivector, t, 0))"
    else:
        aff_input = ctx_input
    nodes = [
        NodeSpec(kind="input", name="input", dim=input_dim),
    ]
    if with_ivector:
        nodes.append(NodeSpec(kind="input", name="ivector", dim=IVEC_DIM))
    nodes += [
        NodeSpec(
            kind="component",
            name="gauss.affine",
            component="gauss.affine",
            input=parse_descriptor(aff_input),
        ),
        NodeSpec(
            kind="component",
            name="gauss.logsoftmax",
            component="gauss.logsoftmax",
            input=parse_descriptor("gauss.affine"),
        ),
    ]
    components = {
        "gauss.affine": ComponentSpec(
            "gauss.affine",
            "FixedAffineComponent",
            {"LinearParams": aff_rows, "BiasParams": bias},
        ),
        "gauss.logsoftmax": ComponentSpec(
            "gauss.logsoftmax",
            "LogSoftmaxComponent",
            {
                "Dim": len(emitting),
                "ValueAvg": np.zeros(0, dtype=np.float32),
                "DerivAvg": np.zeros(0, dtype=np.float32),
                "Count": 0.0,
            },
        ),
    }
    if recurrent_delay is None:
        nodes.append(
            NodeSpec(
                kind="output",
                name="output",
                input=parse_descriptor("gauss.logsoftmax"),
            )
        )
    else:
        # Zero-contribution recurrence: rec.a references rec.b (defined
        # later) at -recurrent_delay — a genuine back-edge driving the
        # stepwise scan + ring carry — but rec.zero's weights are all zero,
        # so output == gauss.logsoftmax exactly.
        H = 4
        nodes += [
            NodeSpec(
                kind="component",
                name="rec.a",
                component="rec.a",
                input=parse_descriptor(
                    f"Append(input, IfDefined(Offset(rec.b, {-recurrent_delay})))"
                ),
            ),
            NodeSpec(
                kind="component",
                name="rec.t",
                component="rec.t",
                input=parse_descriptor("rec.a"),
            ),
            NodeSpec(
                kind="component",
                name="rec.b",
                component="rec.b",
                input=parse_descriptor("rec.t"),
            ),
            NodeSpec(
                kind="component",
                name="rec.zero",
                component="rec.zero",
                input=parse_descriptor("rec.b"),
            ),
            NodeSpec(
                kind="output",
                name="output",
                input=parse_descriptor("Sum(gauss.logsoftmax, rec.zero)"),
            ),
        ]
        components.update(
            {
                "rec.a": ComponentSpec(
                    "rec.a",
                    "FixedAffineComponent",
                    {
                        "LinearParams": (
                            0.1 * rng.randn(H, frontend.num_ceps + H)
                        ).astype(np.float32),
                        "BiasParams": np.zeros(H, dtype=np.float32),
                    },
                ),
                "rec.t": ComponentSpec(
                    "rec.t",
                    "TanhComponent",
                    {
                        "Dim": H,
                        "ValueAvg": np.zeros(0, dtype=np.float32),
                        "DerivAvg": np.zeros(0, dtype=np.float32),
                        "Count": 0.0,
                    },
                ),
                "rec.b": ComponentSpec(
                    "rec.b",
                    "FixedAffineComponent",
                    {
                        "LinearParams": (0.5 * rng.randn(H, H)).astype(
                            np.float32
                        ),
                        "BiasParams": np.zeros(H, dtype=np.float32),
                    },
                ),
                "rec.zero": ComponentSpec(
                    "rec.zero",
                    "FixedAffineComponent",
                    {
                        "LinearParams": np.zeros(
                            (len(emitting), H), dtype=np.float32
                        ),
                        "BiasParams": np.zeros(
                            len(emitting), dtype=np.float32
                        ),
                    },
                ),
            }
        )
    spec = Nnet3Spec(
        nodes=nodes,
        components=components,
        left_context=0,
        right_context=0,
    )

    with open(model_dir / "model" / "final.mdl", "wb") as f:
        write_nnet3(f, spec, transition_model=ktm)
    if recurrent_delay is not None:
        # pin subsampling 1 so any positive delay is a valid multiple
        with open(
            model_dir / "model" / "frame_subsampling_factor",
            "w",
            encoding="utf-8",
        ) as f:
            f.write("1\n")
    if with_pitch:
        conf_dir = model_dir / "model" / "conf"
        conf_dir.mkdir(exist_ok=True)
        with open(conf_dir / "online.conf", "w", encoding="utf-8") as f:
            f.write("--add-pitch=true\n")
    if with_ivector:
        from ..io.ivector import DiagGmm, IvectorExtractor
        from ..io.kaldi_io import KaldiWriter

        num_gauss, lda_out, splice = 16, 12, 3
        spliced_dim = frontend.num_ceps * (2 * splice + 1)
        means = rng.randn(num_gauss, lda_out) * 2.0
        variances = 0.5 + rng.rand(num_gauss, lda_out)
        gmm_weights = rng.dirichlet(np.ones(num_gauss))
        dubm = DiagGmm.from_means_vars(gmm_weights, means, variances)
        M = (rng.randn(num_gauss, lda_out, IVEC_DIM) * 0.3).astype(np.float64)
        sigma_inv = np.zeros((num_gauss, lda_out, lda_out))
        for i in range(num_gauss):
            a = rng.randn(lda_out, lda_out) * 0.1
            sigma_inv[i] = np.eye(lda_out) + a @ a.T
        extractor = IvectorExtractor(
            w=np.zeros((0, 0), dtype=np.float32),
            w_vec=gmm_weights.astype(np.float32),
            M=M.astype(np.float32),
            sigma_inv=sigma_inv.astype(np.float32),
            prior_offset=4.0,
        )
        lda = (rng.randn(lda_out, spliced_dim + 1) * 0.2).astype(np.float32)
        ext_dir = model_dir / "extractor"
        ext_dir.mkdir(exist_ok=True)
        with open(ext_dir / "final.dubm", "wb") as f:
            dubm.write(KaldiWriter(f))
        with open(ext_dir / "final.ie", "wb") as f:
            extractor.write(KaldiWriter(f))
        with open(ext_dir / "final.mat", "wb") as f:
            KaldiWriter(f).write_matrix(lda)
        if with_ivector_cmvn:
            from ..ops.cmvn import matrix_from_stats

            # stats over the BASE MFCC dim only — pitch dims never reach
            # the i-vector branch (online-nnet2-feature-pipeline.cc:90-140)
            stats = matrix_from_stats(
                np.full(frontend.num_ceps, 500.0),
                np.full(frontend.num_ceps, 2600.0),
                100.0,
            )
            with open(ext_dir / "global_cmvn.stats", "wb") as f:
                KaldiWriter(f).write_matrix(stats.astype(np.float64))
    with open(model_dir / "model" / "phones.txt", "w", encoding="utf-8") as f:
        phones.write_text(f)
    with open(model_dir / "model" / "frontend.json", "w", encoding="utf-8") as f:
        json.dump(
            {
                "num_mel_bins": frontend.num_mel_bins,
                "num_ceps": frontend.num_ceps,
                "low_freq": frontend.low_freq,
                "high_freq": frontend.high_freq,
                "dither": frontend.dither,
            },
            f,
        )
    # lexicon.db in the reference schema (g2p.py:23-110: word_phonemes)
    import sqlite3

    db_path = model_dir / "lexicon.db"
    if db_path.exists():
        db_path.unlink()
    conn = sqlite3.Connection(str(db_path))
    conn.execute(
        "CREATE TABLE word_phonemes "
        "(word TEXT, phonemes TEXT, pron_order INTEGER)"
    )
    conn.execute("CREATE TABLE g2p_alignments (word TEXT, alignment TEXT)")
    for word, phone_seq in sorted(lexicon.items()):
        conn.execute(
            "INSERT INTO word_phonemes VALUES (?, ?, 0)",
            (word, " ".join(phone_seq)),
        )
    conn.commit()
    conn.close()

    with open(model_dir / "config.json", "w", encoding="utf-8") as f:
        json.dump(
            {
                "type": "kaldi",
                "lexicon": {"casing": "lower"},
                "sil_phone": SIL,
                "spn_phone": SPN,
            },
            f,
        )

    return SyntheticProfile(
        model_dir=model_dir,
        frontend=frontend,
        lexicon={w: list(p) for w, p in lexicon.items()},
        phone_freqs=phone_freqs,
    )


def build_synthetic_gmm_profile(
    model_dir: Union[str, Path],
    lexicon: Dict[str, List[str]],
    frontend: Optional[FrontendConfig] = None,
    tau: float = 50.0,
    seed: int = 1234,
) -> SyntheticProfile:
    """Write a ModelType.gmm model dir: AmDiagGmm final.mdl whose per-pdf
    single-Gaussian centroids match synthesize_sentence's phone signatures
    over MFCC + delta-delta features (delta dims carry near-zero inverse
    variances, so they contribute ~uniformly — classification matches the
    nnet3 synthetic profile's Gaussian classifier).
    """
    from ..io.gmm_am import write_am_diag_gmm
    from ..io.ivector import DiagGmm

    model_dir = Path(model_dir)
    (model_dir / "model").mkdir(parents=True, exist_ok=True)
    if frontend is None:
        frontend = FrontendConfig(num_mel_bins=20, num_ceps=20)

    base_phones = sorted({p for phones in lexicon.values() for p in phones})
    phone_freqs = _phone_freqs(base_phones)
    rng = np.random.RandomState(seed)

    entries = [(w, list(p)) for w, p in sorted(lexicon.items())]
    entries.append((UNK, [SPN]))
    lang = prepare_lang(entries, silence_phones=[SIL, SPN], optional_silence=SIL)
    phones: SymbolTable = lang.phones

    centroids: Dict[str, np.ndarray] = {}
    for p in base_phones:
        wave = _phone_wave(phone_freqs[p], SAMPLE_RATE, rng)
        centroids[p] = mfcc_numpy(frontend, wave).mean(axis=0)
    centroids[SIL] = mfcc_numpy(
        frontend, _silence_wave(SAMPLE_RATE, rng)
    ).mean(axis=0)
    centroids[SPN] = mfcc_numpy(
        frontend, (500.0 * rng.randn(SAMPLE_RATE)).astype(np.float32)
    ).mean(axis=0)

    emitting: List[Tuple[str, int]] = []
    for name, pid in sorted(phones, key=lambda kv: kv[1]):
        if pid == 0 or name.startswith("#"):
            continue
        emitting.append((name, pid))

    phone_ids = [pid for _, pid in emitting]
    max_phone = max(phone_ids)
    phone2idx = np.full(max_phone + 1, -1, dtype=np.int64)
    for pid in phone_ids:
        phone2idx[pid] = 0
    topo = KaldiHmmTopology(
        phones=np.asarray(sorted(phone_ids), dtype=np.int64),
        phone2idx=phone2idx,
        entries=[
            [
                TopologyState(0, 0, [(0, 0.5), (1, 0.5)]),
                TopologyState(K_NO_PDF, K_NO_PDF, []),
            ]
        ],
    )
    tuples = np.zeros((len(emitting), 4), dtype=np.int64)
    for pdf, (_name, pid) in enumerate(emitting):
        tuples[pdf] = (pid, 0, pdf, pdf)
    num_tids = 2 * len(emitting)
    log_probs = np.full(num_tids + 1, math.log(0.5), dtype=np.float32)
    log_probs[0] = 0.0
    ktm = KaldiTransitionModel(topology=topo, tuples=tuples, log_probs=log_probs)

    # one single-component diagonal Gaussian per pdf over [mfcc, d, dd]:
    # inv_var 2/tau on the static dims (log-like ~ -|x-c|^2/tau like the
    # nnet3 profile), tiny on delta dims (uniform contribution)
    D = frontend.num_ceps
    gmms = []
    for _pdf, (name, _pid) in enumerate(emitting):
        c = centroids[_base_phone(name)]
        mean = np.concatenate([c, np.zeros(2 * D)])
        var = np.concatenate(
            [np.full(D, tau / 2.0), np.full(2 * D, 1.0e6)]
        )
        gmms.append(
            DiagGmm.from_means_vars(
                np.ones(1), mean[None, :], var[None, :]
            )
        )

    write_am_diag_gmm(str(model_dir / "model" / "final.mdl"), ktm, gmms)
    with open(model_dir / "model" / "phones.txt", "w", encoding="utf-8") as f:
        phones.write_text(f)
    with open(model_dir / "model" / "frontend.json", "w", encoding="utf-8") as f:
        json.dump(
            {
                "num_mel_bins": frontend.num_mel_bins,
                "num_ceps": frontend.num_ceps,
                "low_freq": frontend.low_freq,
                "high_freq": frontend.high_freq,
                "dither": frontend.dither,
            },
            f,
        )

    import sqlite3

    db_path = model_dir / "lexicon.db"
    if db_path.exists():
        db_path.unlink()
    conn = sqlite3.Connection(str(db_path))
    conn.execute(
        "CREATE TABLE word_phonemes "
        "(word TEXT, phonemes TEXT, pron_order INTEGER)"
    )
    conn.execute("CREATE TABLE g2p_alignments (word TEXT, alignment TEXT)")
    for word, phone_seq in sorted(lexicon.items()):
        conn.execute(
            "INSERT INTO word_phonemes VALUES (?, ?, 0)",
            (word, " ".join(phone_seq)),
        )
    conn.commit()
    conn.close()

    with open(model_dir / "config.json", "w", encoding="utf-8") as f:
        json.dump(
            {
                "type": "gmm",
                "lexicon": {"casing": "lower"},
                "sil_phone": SIL,
                "spn_phone": SPN,
            },
            f,
        )

    return SyntheticProfile(
        model_dir=model_dir,
        frontend=frontend,
        lexicon={w: list(p) for w, p in lexicon.items()},
        phone_freqs=phone_freqs,
    )


# ---------------------------------------------------------------------------
# Synthetic CTC (Coqui-style) profiles
# ---------------------------------------------------------------------------


@dataclass
class SyntheticCtcProfile:
    model_dir: Path
    frontend: "FrontendConfig"
    chars: List[str]  # alphabet order (ids 1..N; blank appended after)
    char_freqs: Dict[str, Tuple[float, float]]


def build_synthetic_ctc_profile(
    model_dir: Union[str, Path],
    chars: Sequence[str],
    frontend: Optional[FrontendConfig] = None,
    tau: float = 50.0,
    seed: int = 99,
) -> SyntheticCtcProfile:
    """Coqui-style model dir: alphabet.txt + model.npz (Gaussian char
    classifier over MFCC centroids, with blank = silence) + frontend.json."""
    from ..models.ctc import CtcModel

    model_dir = Path(model_dir)
    model_dir.mkdir(parents=True, exist_ok=True)
    if frontend is None:
        frontend = FrontendConfig(num_mel_bins=20, num_ceps=20)
    rng = np.random.RandomState(seed)

    ordered = [" "] + sorted(c for c in chars if c != " ")
    char_freqs = _phone_freqs([c for c in ordered])

    centroids = []
    for c in ordered:
        wave = _phone_wave(char_freqs[c], SAMPLE_RATE, rng)
        centroids.append(mfcc_numpy(frontend, wave).mean(axis=0))
    # blank = silence
    centroids.append(mfcc_numpy(frontend, _silence_wave(SAMPLE_RATE, rng)).mean(axis=0))
    C = np.stack(centroids)  # [L, D]

    out_w = (2.0 * C / tau).T.astype(np.float32)  # [D, L]
    out_b = (-np.sum(C * C, axis=1) / tau).astype(np.float32)
    model = CtcModel(
        params={"out_w": out_w, "out_b": out_b},
        num_labels=C.shape[0],
        context=0,
        has_lstm=False,
    )
    model.save(str(model_dir / "model.npz"))

    with open(model_dir / "alphabet.txt", "w", encoding="utf-8") as f:
        for c in ordered:
            f.write(("" if c == " " else c) + "\n")
    with open(model_dir / "frontend.json", "w", encoding="utf-8") as f:
        json.dump(
            {"num_mel_bins": frontend.num_mel_bins,
             "num_ceps": frontend.num_ceps,
             "dither": frontend.dither},
            f,
        )
    return SyntheticCtcProfile(
        model_dir=model_dir,
        frontend=frontend,
        chars=ordered,
        char_freqs=char_freqs,
    )


def synthesize_ctc_text(
    profile: SyntheticCtcProfile,
    text: str,
    frames_per_char: int = 8,
    blank_frames: int = 4,
    seed: int = 0,
) -> np.ndarray:
    """Synthesize audio spelling out ``text`` char by char (space included),
    with silence (= blank) between chars and at the edges."""
    rng = np.random.RandomState(seed)
    chunks = [_silence_wave(blank_frames * FRAME_SHIFT * 2, rng)]
    for ch in text:
        chunks.append(
            _phone_wave(profile.char_freqs[ch], frames_per_char * FRAME_SHIFT, rng)
        )
        chunks.append(_silence_wave(blank_frames * FRAME_SHIFT, rng))
    chunks.append(_silence_wave(blank_frames * FRAME_SHIFT, rng))
    return np.concatenate(chunks)
