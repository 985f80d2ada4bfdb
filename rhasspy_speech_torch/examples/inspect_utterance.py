"""Inspect one utterance: transcript, confidence, n-best rivals, lattice ark
(the port's ``examples/inspect_utterance.py``).

Builds a synthetic profile (no model download), decodes one utterance and
prints what a service would log a request: the transcript (K1, the AM, K2),
the decoder's confidence (``confidence_pcm``), the lattice's distinct
n-best rivals (``get_lattice(...).nbest``; K2 and its second pass), and
writes the compact lattice to a Kaldi ark (``io/lattice_io.py``).

Usage::

    python -m rhasspy_speech_torch.examples.inspect_utterance [--nbest 5] [--ark PATH] [--device cuda|cpu]

``main`` returns the transcript, the confidence, the rivals as (word
sequence, cost) and the ark's path and lattice size. Without ``--ark`` the
ark is written to a temporary directory removed at the end.
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path
from typing import Dict, Optional, Sequence

from ..device import resolve_device
from ..io.lattice_io import write_lattice_ark
from ..pipeline import Nnet3WavTranscriber
from ..testing import build_synthetic_profile, synthesize_sentence
from ._common import device_info, parser, train_sentences, write_wav

LEXICON = {
    "turn": ["t", "er", "n"],
    "on": ["aa", "n"],
    "off": ["ao", "f"],
    "light": ["l", "ay", "t"],
}
SENTENCES = ["turn (on|off) light"]
TEXT, SEED = "turn off light", 3


def build(root: Path):
    """(profile, grammar lang dir, PCM) of the example."""
    profile = build_synthetic_profile(root / "model", LEXICON)
    (lang,) = train_sentences(profile.model_dir, root / "train", SENTENCES)
    return profile, lang, synthesize_sentence(profile, TEXT, seed=SEED)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    p = parser(__doc__)
    p.add_argument("--nbest", type=int, default=5)
    p.add_argument("--ark", default=None, help="where to write the lattice ark")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    dev = resolve_device(args.device)
    with tempfile.TemporaryDirectory(prefix="rss_inspect_") as tmp:
        root = Path(tmp)
        profile, lang, pcm = build(root)
        t = Nnet3WavTranscriber(profile.model_dir, lang, device=dev)
        text = t.transcribe_pcm_batch([pcm])[0]
        conf = t.confidence_pcm(pcm)
        print(f"transcript : {text[0]!r}")
        print(f"confidence : {conf:.4f}")

        wav = write_wav(root / "utt.wav", pcm)
        lat = t.get_lattice(wav)
        words = t.artifacts.words
        rivals = []
        print("n-best     :")
        for ids, cost in lat.nbest(t.artifacts.graph, args.nbest):
            seq = [words.find_id(w) for w in ids if words.find_id(w) != "<eps>"]
            rivals.append((seq, float(cost)))
            print(f"  {cost:8.3f}  {' '.join(seq)}")

        clat = t.get_compact_lattice(wav)
        ark = Path(args.ark) if args.ark else root / "lat.ark"
        write_lattice_ark(ark, [("utt-0", clat)])
        size = (clat.num_states, clat.num_arcs())
        print(f"lattice ark: {ark} ({size[0]} states, {size[1]} arcs)")
    return {"transcript": text, "confidence": conf, "nbest": rivals, "ark": str(ark),
            "lattice_states": size[0], "lattice_arcs": size[1], **device_info(dev)}


if __name__ == "__main__":
    main()
