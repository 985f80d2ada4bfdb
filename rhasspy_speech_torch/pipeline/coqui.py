"""Coqui STT (CTC) backend on one device: trainer + transcriber.

Counterpart of ``rhasspy_speech_tpu/pipeline/coqui.py``: the reference's
behaviour (rhasspy_speech/coqui_stt.py) with the subprocess FST pipelines
replaced by the host WFST library and the TFLite prob server replaced by
the CTC model (``models/ctc.py``). The trainer and the decode are host
code, the JAX package's line for line. On a CUDA device the features are
the MFCC kernel (``ops/mfcc_cuda.py``: one launch a batch call, one a
stream push that completes a frame) and the net runs through cuBLAS; the
LSTM carry of a stream stays on the device between windows. On the CPU the
same calls run the plain twins. ``device="cuda"`` is the default and
raises where CUDA is absent.

- CoquiSttTrainer (coqui_stt.py:213-471): loads alphabet.txt, builds the
  decode cascade — token2char (blank/repeat collapsing, :277-312),
  char2word (spelling transducer, :338-372), word2sen (the intent grammar,
  :374-378) — and composes token2sen = push(rmeps(token2word . word2sen))
  with the reference's minimize-fallback (:440-471).
- CoquiSttTranscriber.decode_probs (coqui_stt.py:122-210): frame-by-frame
  logits acceptor (+ forced trailing space frame at p=0.99), pushed, pruned
  (--weight=10), composed with token2sen, shortest path -> output words ->
  decode_meta.
"""

from __future__ import annotations

import logging
import math
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..device import resolve_device
from ..fst.core import EPS_ID, INF, Fst, SymbolTable
from ..fst.determinize import DeterminizeError, determinize, minimize
from ..fst.ops import compose, prune, push, rmepsilon, shortest_path
from ..grammar.compile import IntentsToFstContext
from ..grammar.fst import decode_meta
from ..lang.graphs import compile_text_fst
from ..models.ctc import CtcModel
from ..ops.frontend import FrontendConfig, make_frontend_params
from ..ops.mfcc_cuda import mfcc_batch

_LOGGER = logging.getLogger(__name__)

BLANK = "<blank>"
EPSILON = "<eps>"
SPACE = "<space>"


def load_alphabet(path: Union[str, Path]) -> Dict[int, str]:
    """alphabet.txt -> {index: char} with the reference's conventions
    (coqui_stt.py:224-249: ids start at 1, blank last, ' '->SPACE)."""
    idx2char: Dict[int, str] = {}
    a_idx = 1
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip("\n")
            stripped = line.strip()
            if stripped.startswith("#") and stripped != "\\#":
                continue
            if not stripped:
                stripped = " "
            elif stripped == "\\#":
                stripped = "#"
            c = stripped[0]
            if c == " ":
                c = SPACE
            idx2char[a_idx] = c
            a_idx += 1
    idx2char[a_idx] = BLANK
    return idx2char


class CoquiSttTrainer:
    """Builds the CTC decode cascade from an intent grammar."""

    def __init__(self, model_dir: Union[str, Path], tools=None):
        self.model_dir = Path(model_dir)
        self.idx2char = load_alphabet(self.model_dir / "alphabet.txt")
        self.char2idx = {c: i for i, c in self.idx2char.items()}
        self.blank_id = self.char2idx[BLANK]

    def _tokens_tables(self) -> (SymbolTable, SymbolTable):
        with_blank = SymbolTable()
        without_blank = SymbolTable()
        for i, c in self.idx2char.items():
            if c == BLANK:
                continue
            with_blank.add(c, i)
            without_blank.add(c, i)
        with_blank.add(BLANK, self.blank_id)
        return with_blank, without_blank

    def _token2char(self, tokens_in: SymbolTable, tokens_out: SymbolTable) -> Fst:
        """CTC collapsing transducer (coqui_stt.py:277-312)."""
        fst = Fst(isymbols=tokens_in, osymbols=tokens_out)
        start = fst.add_state()
        fst.start = start
        fst.set_final(start, 0.0)
        blank = self.blank_id
        fst.add_arc(start, blank, EPS_ID, 0.0, start)

        char_state = {}
        for c, cid in self.char2idx.items():
            if c == BLANK:
                continue
            char_state[c] = fst.add_state()
        for c, state in char_state.items():
            cid = self.char2idx[c]
            fst.add_arc(start, cid, cid, 0.0, state)  # first token emits
            fst.add_arc(state, cid, EPS_ID, 0.0, state)  # repeats collapse
            fst.add_arc(state, blank, EPS_ID, 0.0, start)  # blank resets
            for c2, state2 in char_state.items():
                if c2 == c:
                    continue
                cid2 = self.char2idx[c2]
                fst.add_arc(state, cid2, cid2, 0.0, state2)
            fst.add_arc(state, EPS_ID, EPS_ID, 0.0, start)  # critical return
            fst.set_final(state, 0.0)
        return fst

    def _char2word(self, tokens: SymbolTable, words: SymbolTable,
                   vocab: Sequence[str]) -> Fst:
        """Spelling transducer (coqui_stt.py:338-372)."""
        fst = Fst(isymbols=tokens, osymbols=words)
        start = fst.add_state()
        fst.start = start
        fst.set_final(start, 0.0)
        space_id = tokens.find(SPACE)
        warned = set()
        for word in vocab:
            if word == EPSILON:
                continue
            word_id = words.find(word)
            current = start
            first = True
            for c in word:
                cid = tokens.find(c)
                if cid is None:
                    if c not in warned:
                        _LOGGER.warning("Skipping %r in %r", c, word)
                        warned.add(c)
                    continue
                nxt = fst.add_state()
                fst.add_arc(current, cid, word_id if first else EPS_ID, 0.0, nxt)
                first = False
                current = nxt
            nxt = fst.add_state()
            fst.add_arc(current, space_id, EPS_ID, 0.0, nxt)
            fst.add_arc(nxt, EPS_ID, EPS_ID, 0.0, start)
        return fst

    def _min_det_push(self, fst: Fst, sort_type: str = "ilabel") -> Fst:
        """determinize|minimize|push with the reference's fallback
        (coqui_stt.py:440-471)."""
        try:
            out = minimize(determinize(fst))
        except (DeterminizeError, ValueError):
            _LOGGER.debug("determinize failed; keeping raw transducer")
            out = fst.copy()
        out = push(out)
        return out.arcsort(sort_type)

    def train(self, ctx: IntentsToFstContext, train_dir: Union[str, Path]) -> None:
        train_dir = Path(train_dir)
        train_dir.mkdir(parents=True, exist_ok=True)

        tokens_in, tokens_out = self._tokens_tables()

        # Symbol tables: words (spoken) and output (spoken + meta labels)
        words = SymbolTable()
        for word in sorted(ctx.vocab):
            if word != EPSILON:
                words.add(word)
        output = SymbolTable()
        for word in sorted(ctx.vocab):
            if word != EPSILON:
                output.add(word)
        for word in sorted(ctx.meta_labels):
            output.add(word)

        token2char = self._min_det_push(self._token2char(tokens_in, tokens_out))
        char2word = self._min_det_push(
            self._char2word(tokens_out, words, sorted(ctx.vocab))
        )
        ctx.fst_file.seek(0)
        word2sen = compile_text_fst(ctx.fst_file, output)
        word2sen = self._min_det_push(word2sen)

        token2word = self._min_det_push(compose(token2char, char2word))
        token2sen = compose(token2word, word2sen)
        token2sen = rmepsilon(token2sen)
        token2sen = push(token2sen).arcsort("ilabel")
        token2sen.isymbols = tokens_in
        token2sen.osymbols = output

        # Persist artifacts (text FST + symbol tables; in-process consumers)
        with open(train_dir / "tokens_with_blank.txt", "w", encoding="utf-8") as f:
            tokens_in.write_text(f)
        with open(train_dir / "output.txt", "w", encoding="utf-8") as f:
            output.write_text(f)
        with open(train_dir / "token2sen.fst", "w", encoding="utf-8") as f:
            token2sen.write_text(f)


class CoquiSttTranscriber:
    """CTC decode: the acoustic model on ``device`` + FST cascade."""

    def __init__(
        self,
        model_dir: Union[str, Path],
        train_dir: Union[str, Path],
        tools=None,
        device: Union[str, torch.device] = "cuda",
    ):
        self.device = resolve_device(device)
        self.model_dir = Path(model_dir)
        self.train_dir = Path(train_dir)
        self.idx2char = load_alphabet(self.model_dir / "alphabet.txt")
        self.blank_id = max(self.idx2char)

        # Acoustic model: CTC weights (model.npz); a real Coqui
        # model.tflite is converted in place on first load (weights pulled
        # straight from the flatbuffer, io/tflite.py) and cached as
        # model.npz. Runtime contract either way: per-frame char
        # probabilities, same as stt_onlyprobs' stdout.
        self.model: Optional[CtcModel] = None
        npz = self.model_dir / "model.npz"
        tfl = self.model_dir / "model.tflite"
        if npz.exists():
            self.model = CtcModel.load(str(npz), self.device)
        elif tfl.exists():
            from ..io.tflite import convert_coqui_tflite

            try:
                self.model = convert_coqui_tflite(str(tfl), npz_path=str(npz), device=self.device)
            except OSError:  # read-only dir
                self.model = convert_coqui_tflite(str(tfl), device=self.device)

        frontend = FrontendConfig()
        fj = self.model_dir / "frontend.json"
        if fj.exists():
            import json

            with open(fj, "r", encoding="utf-8") as f:
                frontend = FrontendConfig(**json.load(f))
        self.frontend_config = frontend
        self.frontend_params = make_frontend_params(frontend, self.device)

        with open(self.train_dir / "tokens_with_blank.txt", encoding="utf-8") as f:
            self.tokens = SymbolTable.read_text(f)
        with open(self.train_dir / "output.txt", encoding="utf-8") as f:
            self.output = SymbolTable.read_text(f)
        with open(self.train_dir / "token2sen.fst", encoding="utf-8") as f:
            self.token2sen = Fst.from_text(f)
        self.token2sen.isymbols = self.tokens
        self.token2sen.osymbols = self.output
        self.token2sen.arcsort("ilabel")

    # -- acoustic -------------------------------------------------------------

    def compute_probs(self, pcm: np.ndarray) -> np.ndarray:
        """[samples] -> [T, num_labels] char probabilities."""
        assert self.model is not None, "no model.npz in the model dir"
        feats = mfcc_batch(self.frontend_params, self._upload(pcm[None]))
        return self.model.forward(feats)[0].cpu().numpy()

    def _upload(self, pcm: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(pcm, dtype=np.float32), device=self.device)

    # -- decode ----------------------------------------------------------------

    def decode_probs(self, probs: np.ndarray, prune_threshold: float = 10.0) -> str:
        """Per-frame probs -> text (coqui_stt.py:122-210)."""
        probs = np.asarray(probs)
        T, L = probs.shape
        num_chars = len(self.idx2char)
        assert L == num_chars, (L, num_chars)

        # Trailing forced-space frame (coqui_stt.py:158-162)
        space_prob = 0.99
        nonspace = (1.0 - space_prob) / (num_chars - 1) + 1e-9
        space_row = np.full(num_chars, nonspace)
        space_idx = None
        for i, c in self.idx2char.items():
            if c == SPACE:
                space_idx = i
        if space_idx is not None:
            space_row[space_idx - 1] = space_prob
        rows = np.concatenate([probs, space_row[None]], axis=0)

        logits = Fst(isymbols=self.tokens, osymbols=self.tokens)
        logits.add_states(rows.shape[0] + 1)
        logits.start = 0
        logits.set_final(rows.shape[0], 0.0)
        for t in range(rows.shape[0]):
            for i in range(num_chars):
                cost = -math.log(rows[t, i] + 1e-9)
                logits.add_arc(t, i + 1, i + 1, cost, t + 1)

        lattice = push(logits)
        lattice = prune(lattice, prune_threshold)
        lattice.arcsort("olabel")
        composed = compose(lattice, self.token2sen)
        best = shortest_path(composed, nshortest=1)
        words: List[str] = []
        state = best.start
        if state < 0:
            return ""
        guard = 0
        while best.finals[state] == INF:
            arcs = best.arcs[state]
            if not arcs:
                break
            _il, ol, _w, state = arcs[0]
            if ol != EPS_ID:
                sym = self.output.find_id(ol)
                if sym:
                    words.append(sym)
            guard += 1
            if guard > 1000000:  # pragma: no cover
                break
        return decode_meta(" ".join(words))

    def transcribe_pcm(self, pcm: np.ndarray, prune_threshold: float = 10.0) -> str:
        return self.decode_probs(self.compute_probs(pcm), prune_threshold)

    # -- streaming (reference parity: coqui_stt.py:70-113 StreamingState) -----

    # Fixed acoustic window per streaming call, like DeepSpeech's n_steps:
    # one shape regardless of chunk arrival sizes.
    STREAM_WINDOW = 16

    def start_stream(self) -> "CoquiStreamState":
        """Open an incremental decode; feed with process_chunk, read the
        transcript from finish_stream. Probs match compute_probs: exact
        MFCC via a sample-tail carry, splice windows built from true
        neighbors (frames wait for their right context; the batch path's
        edge clamping applies at the stream edges), LSTM carry across
        windows, on the device."""
        assert self.model is not None, "no model.npz in the model dir"
        if not self.frontend_config.snip_edges:
            # the tail-carry framing below assumes snip_edges=true; the
            # centered mode reflects at utterance edges and would
            # silently produce different rows per chunk boundary
            raise NotImplementedError(
                "streaming requires snip_edges=true framing (use "
                "transcribe_pcm for snip_edges=false frontends)"
            )
        return CoquiStreamState(
            sample_tail=np.zeros(0, np.float32),
            feats=np.zeros((0, self.frontend_config.num_ceps), np.float32),
            lstm_state=self.model.init_state(1),
        )

    def process_chunk(self, state: "CoquiStreamState", pcm: np.ndarray) -> None:
        """Append PCM; run the acoustic model over every full window of
        frames whose splice context has arrived."""
        buf = np.concatenate(
            [state.sample_tail, np.asarray(pcm, dtype=np.float32)]
        )
        fl = self.frontend_config.frame_length
        fs = self.frontend_config.frame_shift
        if buf.shape[0] >= fl:
            n = 1 + (buf.shape[0] - fl) // fs
            rows = mfcc_batch(self.frontend_params, self._upload(buf[None]))[0, :n].cpu().numpy()
            state.feats = np.concatenate([state.feats, rows], axis=0)
            state.sample_tail = buf[n * fs :]
        else:
            state.sample_tail = buf
        self._advance(state, final=False)

    def finish_stream(
        self, state: "CoquiStreamState", prune_threshold: float = 10.0
    ) -> str:
        """Flush the frame tail (right context clamps to the last frame,
        like the batch splice) and decode all accumulated probs."""
        self._advance(state, final=True)
        if not state.probs:
            return ""
        return self.decode_probs(
            np.concatenate(state.probs, axis=0), prune_threshold
        )

    def _advance(self, state: "CoquiStreamState", final: bool) -> None:
        model = self.model
        ctx = model.context
        T_abs = state.feat_base + state.feats.shape[0]
        # a frame is emittable once its full right context exists
        # (mid-stream), or unconditionally at flush (clamped, as batch)
        limit = T_abs if final else max(0, T_abs - ctx)
        W = self.STREAM_WINDOW
        while state.emitted < limit:
            take = min(W, limit - state.emitted)
            if take < W and not final:
                break  # wait for a full window: one compiled shape
            base = np.arange(state.emitted, state.emitted + take)
            idx = (
                np.clip(
                    base[:, None] + np.arange(-ctx, ctx + 1)[None, :],
                    0,
                    T_abs - 1,
                )
                - state.feat_base
            )
            spliced = state.feats[idx].reshape(take, -1)
            if take < W:  # final partial window: pad, discard pad probs
                spliced = np.pad(spliced, ((0, W - take), (0, 0)))
            probs, new_state = model.forward_stream(
                self._upload(spliced[None]), state.lstm_state
            )
            state.probs.append(probs[0, :take].cpu().numpy())
            # a padded final window's carry is never used again
            state.lstm_state = new_state
            state.emitted += take
        # feature memory stays O(window): rows older than the emitted
        # frontier's left context are never read again
        drop = state.emitted - ctx - state.feat_base
        if drop > 0:
            state.feats = state.feats[drop:]
            state.feat_base += drop


    # -- reference-signature async wrappers (coqui_stt.py:32-120) -------------
    # The reference drives ONE implicit stream per transcriber through an
    # stt_onlyprobs subprocess: 16-bit PCM chunks in, per-frame prob rows
    # out of finish_stream. Same contract here over the in-process model;
    # the explicit-state sync triple above is the multi-stream form.

    async def async_start_stream(self) -> None:
        if getattr(self, "_cur_stream", None) is not None:
            raise StreamAlreadyStartedError
        self._cur_stream = self.start_stream()

    async def async_process_chunk(self, chunk) -> None:
        if getattr(self, "_cur_stream", None) is None:
            raise StreamNotStartedError
        if chunk is None or not len(chunk):
            raise CoquiSttError("empty chunk")
        if isinstance(chunk, (bytes, bytearray)):
            if len(chunk) % 2:
                raise CoquiSttError(
                    "chunk must be whole 16-bit samples "
                    f"(got {len(chunk)} bytes)"
                )
            pcm = np.frombuffer(chunk, dtype=np.int16).astype(np.float32)
        else:
            pcm = np.asarray(chunk, dtype=np.float32)
        self.process_chunk(self._cur_stream, pcm)

    async def async_finish_stream(self) -> List[List[float]]:
        """Flush and return the per-frame prob rows (the reference's
        stt_onlyprobs stdout contract); decode with decode_probs."""
        if getattr(self, "_cur_stream", None) is None:
            raise StreamNotStartedError
        state, self._cur_stream = self._cur_stream, None
        self._advance(state, final=True)
        if not state.probs:
            return []
        return np.concatenate(state.probs, axis=0).tolist()

    async def stop(self) -> None:
        """Reference parity: tears down the prob subprocess there; the
        in-process model just drops any open stream."""
        self._cur_stream = None


class CoquiSttError(Exception):
    """Coqui transcriber error (reference coqui_stt.py:32)."""


class StreamAlreadyStartedError(CoquiSttError):
    """async_start_stream with a stream already open."""


class StreamNotStartedError(CoquiSttError):
    """async_process_chunk / async_finish_stream without a stream."""


class CoquiStreamState:
    """Incremental CoquiSttTranscriber decode state (one stream): host
    features and probs, the LSTM carry on the transcriber's device."""

    __slots__ = (
        "sample_tail", "feats", "feat_base", "emitted", "lstm_state",
        "probs",
    )

    def __init__(self, sample_tail, feats, lstm_state):
        self.sample_tail = sample_tail
        self.feats = feats
        self.feat_base = 0  # absolute frame index of feats[0]
        self.emitted = 0
        self.lstm_state = lstm_state
        self.probs: List[np.ndarray] = []
