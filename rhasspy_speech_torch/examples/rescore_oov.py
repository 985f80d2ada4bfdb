"""Dual-graph OOV flow: decode with one lang dir, rescore with another (the
port's ``examples/rescore_oov.py``).

A rigid grammar graph pairs with an ARPA graph so that out-of-vocabulary
audio can be rejected, and a rescore against a higher-order (or
different-lexicon) lang dir can recover hypotheses the first pass never
ranked. Here the first-pass graph does not even contain the spoken word
("read"), yet the lattice rescore recovers it through the new lexicon,
because the rescore remaps the decode lattice at the phone level
(``pipeline/rescore.py``) instead of re-weighting an n-best list. The run
raises if the rescore does not recover it. On a card K1 computes the
features; the n-best first pass and the lattice are plain PyTorch, as they
are plain JAX in the JAX package.

Usage::

    python -m rhasspy_speech_torch.examples.rescore_oov [--nbest 5] [--device cuda|cpu]

``main`` returns the first pass's n-best and the rescored transcripts.
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path
from typing import Dict, Optional, Sequence

from ..const import LangSuffix
from ..device import resolve_device
from ..pipeline import Nnet3WavTranscriber
from ..testing import build_synthetic_profile, synthesize_sentence
from ._common import device_info, parser, train_sentences, write_wav

LEXICON = {
    "turn": ["t", "er", "n"],
    "red": ["r", "eh", "d"],
    "read": ["r", "eh", "d"],  # homophone
    "page": ["p", "ey", "jh"],
}
SPOKEN, SEED = "turn red", 7
RECOVERED = "turn read"


def build(root: Path):
    """(profile, first-pass grammar lang dir, rescore lang dir, PCM): the
    first pass knows only "turn red"; the rescore lang is an ARPA LM over
    "turn read [page]", another vocabulary."""
    profile = build_synthetic_profile(root / "model", LEXICON)
    (old,) = train_sentences(profile.model_dir, root / "train_old", ["turn red"])
    _arpa, new = train_sentences(profile.model_dir, root / "train_new", ["turn read [page]"],
                                 (LangSuffix.ARPA, LangSuffix.ARPA_RESCORE))
    return profile, old, new, synthesize_sentence(profile, SPOKEN, seed=SEED)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    p = parser(__doc__)
    p.add_argument("--nbest", type=int, default=5)
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    dev = resolve_device(args.device)
    with tempfile.TemporaryDirectory(prefix="rss_rescore_") as tmp:
        root = Path(tmp)
        profile, old, new, pcm = build(root)
        t = Nnet3WavTranscriber(profile.model_dir, old, device=dev)
        first = t.transcribe_pcm_batch([pcm], nbest=args.nbest)[0]
        print(f"first pass (grammar graph): {first}")
        rescored = t.transcribe_rescore(write_wav(root / "utt.wav", pcm), old_lang_dir=old,
                                        new_lang_dir=new, nbest=args.nbest)
    print(f"lattice rescore (new lexicon + LM): {rescored}")
    if not rescored or rescored[0] != RECOVERED:
        raise RuntimeError(f"the rescore did not recover {RECOVERED!r}: {rescored}")
    print("the rescore recovered a word the decode graph does not contain")
    return {"first_pass": first, "rescored": rescored, **device_info(dev)}


if __name__ == "__main__":
    main()
