"""Best paths through the decode graph in float64, and the judging of a path
that the program reports.

The graph is read from the graph directory's ``graph.npz`` and
``words.txt``, the files the program reads too: a flat table of emitting
arcs (source, destination, pdf, graph cost, the id of the word sequence it
emits) with initial, final and word-sequence tables. A frame moves every
live state along each of its arcs at the arc's graph cost plus
``-acoustic_scale`` times the frame's log-likelihood of the arc's pdf, and
each destination keeps its cheapest arrival (Viterbi in the tropical
semiring). A path's cost is its initial cost, the sum over its frames, and
the final cost of its last state; a cost of 1e29 or more is no path.
"""

from __future__ import annotations

import base64
import json
import re
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

NO_PATH = 1.0e29


class Graph:
    def __init__(self, graph_dir):
        d = np.load(Path(graph_dir) / "graph.npz")
        self.num_states = int(d["num_states"])
        self.arc_src = d["arc_src"].astype(np.int64)
        self.arc_dst = d["arc_dst"].astype(np.int64)
        self.arc_pdf = d["arc_pdf"].astype(np.int64)
        self.arc_wseq = d["arc_wseq"].astype(np.int64)
        self.arc_weight = d["arc_weight"].astype(np.float64)
        self.final_weight = d["final_weight"].astype(np.float64)
        self.final_wseq = d["final_wseq"].astype(np.int64)
        self.init_weight = d["init_weight"].astype(np.float64)
        self.init_wseq = d["init_wseq"].astype(np.int64)
        lens, flat = d["word_seq_len"], d["word_seq_flat"]
        starts = np.concatenate([[0], np.cumsum(lens)])
        self.word_seqs = [tuple(int(w) for w in flat[starts[i]:starts[i + 1]])
                          for i in range(len(lens))]
        self.words: Dict[int, str] = {}
        with open(Path(graph_dir) / "words.txt", "r", encoding="utf-8") as f:
            for line in f:
                parts = line.split()
                if len(parts) == 2:
                    self.words[int(parts[1])] = parts[0]
        self._dev: Dict = {}

    @property
    def num_arcs(self) -> int:
        return int(self.arc_src.shape[0])

    def on(self, device) -> Dict[str, torch.Tensor]:
        key = str(device)
        if key not in self._dev:
            t = {k: torch.as_tensor(getattr(self, k), device=device) for k in (
                "arc_src", "arc_dst", "arc_pdf", "arc_weight", "final_weight", "init_weight")}
            for k in ("init_weight", "final_weight"):
                t[k] = torch.where(t[k] >= NO_PATH, torch.inf, t[k])
            self._dev[key] = t
        return self._dev[key]


def best_costs(g: Graph, log_probs: torch.Tensor, lengths: torch.Tensor,
               acoustic_scale: float = 1.0) -> torch.Tensor:
    """[B, N, P] float64 log-likelihoods, each stream's first ``lengths[b]``
    frames -> the cheapest complete path's cost a stream [B] (inf for
    none)."""
    t = g.on(log_probs.device)
    B, N, _ = log_probs.shape
    alpha = t["init_weight"][None, :].expand(B, -1).clone()
    dst = t["arc_dst"][None, :].expand(B, -1)
    for n in range(N):
        cost = (alpha[:, t["arc_src"]] + t["arc_weight"]
                - acoustic_scale * log_probs[:, n, t["arc_pdf"]])
        new = torch.full_like(alpha, torch.inf).scatter_reduce(1, dst, cost, "amin")
        alpha = torch.where((n < lengths)[:, None], new, alpha)
    return (alpha + t["final_weight"][None, :]).min(dim=1).values


def judge_path(g: Graph, arcs: np.ndarray, final_state: int, log_probs: np.ndarray,
               acoustic_scale: float = 1.0) -> Tuple[Optional[float], Optional[List[int]]]:
    """A reported path -- one arc id a frame and the final state -- scored
    under ``log_probs`` [n, P]: (its cost, its word ids), or (None, None)
    when it is no path of the graph (a missing or unknown arc, an arc that
    does not leave the state the previous one entered, a start with no
    initial cost, or an end that is not the final state or not final)."""
    n = arcs.shape[0]
    if n == 0 or n != log_probs.shape[0] or arcs.min() < 0 or arcs.max() >= g.num_arcs:
        return None, None
    if (g.arc_src[arcs[1:]] != g.arc_dst[arcs[:-1]]).any():
        return None, None
    first, last = int(g.arc_src[arcs[0]]), int(g.arc_dst[arcs[-1]])
    if last != final_state or g.init_weight[first] >= NO_PATH or g.final_weight[last] >= NO_PATH:
        return None, None
    cost = (g.init_weight[first] + g.arc_weight[arcs].sum()
            - acoustic_scale * log_probs[np.arange(n), g.arc_pdf[arcs]].sum()
            + g.final_weight[last])
    words = list(g.word_seqs[int(g.init_wseq[first])])
    for w in g.arc_wseq[arcs]:
        if w:
            words.extend(g.word_seqs[int(w)])
    words.extend(g.word_seqs[int(g.final_wseq[last])])
    return float(cost), words


# -- the transcript a word sequence reads as ----------------------------------

_SKIP = ("<eps>", "#0", "<s>", "</s>")
_OUTPUT = "__output:"
_SENTENCE = "__sentence_output:"
_B32 = r"([0-9A-Z=]+)"


def _b32(text: str) -> str:
    return base64.b32decode(text.encode("utf-8")).strip().decode("utf-8")


def transcript(g: Graph, words: List[int]) -> str:
    """The text a user receives for ``words``: the symbols joined by spaces
    (epsilon, disambiguation and sentence markers left out), each slot
    label replaced by the slot value it records, and a sentence label's
    template filled from those values (the grammar compiler's metadata
    labels)."""
    text = " ".join(s for s in (g.words.get(w) for w in words) if s and s not in _SKIP)
    slots: Dict[str, str] = {}

    def slot(match) -> str:
        data = json.loads(_b32(match.group(1)))
        if data.get("list"):
            slots[data["list"]] = data["text"]
        return data["text"]

    text = re.sub(re.escape(_OUTPUT) + _B32, slot, text)
    sentence = re.search(re.escape(_SENTENCE) + _B32, text)
    return text if sentence is None else _b32(sentence.group(1)).format(**slots)
