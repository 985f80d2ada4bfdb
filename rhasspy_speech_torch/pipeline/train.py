"""train_model: sentence templates -> per-user decode artifacts.

Reference behavior (rhasspy_speech/train.py:20-88 + kaldi.py:74-452) kept,
subprocess graph tools replaced by the host WFST/ngram/graph layers:

1. read model config.json (casing, sil/spn phones),
2. merge user "words" pronunciations via get_sounds_like,
3. compile intent templates to the word FST + vocab + meta labels,
4. build the lexicon (lexicon.db lookups; unknown words -> silence phone
   like the reference's no-pronunciation fallback, kaldi.py:211-217),
5. prepare_lang (L/L_disambig/words/phones),
6. per LangSuffix: G.fst (grammar/ARPA witten-bell), fuzzy FST
   (grammar: plain copy, arpa: +deletion loops — kaldi.py:131-136,343-407),
   HCLG -> dense decode graph with the acoustic model's pdf ids,
7. save artifacts under train_dir/lang_<suffix>/.
"""

from __future__ import annotations

import asyncio
import io
import json
import logging
import os
from pathlib import Path
from typing import Any, Collection, Dict, List, Optional, Union

from ..const import SIL, SPN, UNK, LangSuffix, WordCasing
from ..grammar import Intents, compile_intents
from ..graph.dense import dense_from_hclg
from ..graph.from_kaldi import transition_model_from_kaldi
from ..graph.hclg import make_hclg
from ..graph.topology import Topology, TransitionModel
from ..io.kaldi_io import KaldiReader
from ..io.transition_model import KaldiTransitionModel
from ..lang.graphs import compile_text_fst, make_fuzzy_g, make_grammar_g, make_lg
from ..lang.lexicon_fst import prepare_lang
from ..lang.ngram import arpa_to_fst, make_arpa_from_fst
from ..lexicon.g2p import LexiconDatabase, get_sounds_like
from ..fst.core import SymbolTable
from .artifacts import LangArtifacts, lang_dir_name

_LOGGER = logging.getLogger(__name__)


def _load_intents(intents: Union[Intents, Dict, str, Path]) -> Intents:
    if isinstance(intents, Intents):
        return intents
    if isinstance(intents, dict):
        return Intents.from_dict(intents)
    # YAML text or path
    import yaml

    text = intents
    if isinstance(intents, (str, Path)) and os.path.exists(str(intents)):
        with open(intents, "r", encoding="utf-8") as f:
            text = f.read()
    raw = yaml.safe_load(text)
    if "intents" in raw:
        return Intents.from_dict(raw)
    # bare sentences file (tests/test_en.yaml style)
    return Intents.from_dict(
        {
            "language": raw.get("language", "en"),
            "intents": {"Sentences": {"data": [{"sentences": raw["sentences"]}]}},
            "lists": raw.get("lists", {}),
            "expansion_rules": raw.get("expansion_rules", {}),
        }
    )


def _load_model_transition_model(model_dir: Path):
    """Parse final.mdl + phones.txt from the model dir, if present."""
    mdl_path = model_dir / "model" / "final.mdl"
    phones_path = model_dir / "model" / "phones.txt"
    if not (mdl_path.exists() and phones_path.exists()):
        return None, None
    with open(mdl_path, "rb") as f:
        ktm = KaldiTransitionModel.read(KaldiReader(f))
    with open(phones_path, "r", encoding="utf-8") as f:
        model_phones = SymbolTable.read_text(f)
    return ktm, model_phones


def train_model_sync(
    language: str,
    intents: Union[Intents, Dict, str, Path],
    train_dir: Union[str, Path],
    model_dir: Union[str, Path],
    tools: Any = None,  # accepted for reference API compatibility; unused
    words: Optional[Dict[str, Union[str, List[str]]]] = None,
    lang_suffixes: Optional[Collection[LangSuffix]] = None,
    rescore_order: int = 5,
    smoothing: str = "witten_bell",
) -> None:
    train_dir = Path(train_dir)
    model_dir = Path(model_dir)
    if lang_suffixes is None:
        lang_suffixes = (LangSuffix.GRAMMAR, LangSuffix.ARPA)

    # Model config (train.py:31-38)
    model_config: Dict[str, Any] = {}
    config_path = model_dir / "config.json"
    if config_path.exists():
        with open(config_path, "r", encoding="utf-8") as f:
            model_config = json.load(f)
    word_casing = WordCasing(
        model_config.get("lexicon", {}).get("casing", "lower")
    )
    model_type = model_config.get("type", "kaldi")
    sil_phone = model_config.get("sil_phone", SIL)
    spn_phone = model_config.get("spn_phone", SPN)

    # ModelType.gmm trains through the same graph flow as nnet3: the HCLG
    # build only consumes the transition model, which reads identically
    # from an AmDiagGmm final.mdl (io/gmm_am.py). The reference invokes
    # the same mkgraph.sh --self-loop-scale 1.0 for every model type
    # (kaldi.py:409-425); decode-side GMM support lives in AcousticModel.
    if model_type == "coqui":
        # CTC backend (train.py:85-88): compile the grammar and build the
        # token->sentence decode cascade; no lexicon/lang step.
        from ..lexicon.g2p import LexiconDatabase as _LexDb
        from .coqui import CoquiSttTrainer

        intents_obj = _load_intents(intents)
        ctx = compile_intents(
            intents_obj,
            io.StringIO(),
            _LexDb(),
            number_language=language,
            word_casing=word_casing,
        )
        CoquiSttTrainer(model_dir).train(ctx, train_dir)
        return

    # Lexicon + user words (train.py:41-50)
    lexicon_db = model_dir / "lexicon.db"
    lexicon = LexiconDatabase(str(lexicon_db) if lexicon_db.exists() else None)
    if words:
        for word, word_prons in words.items():
            if isinstance(word_prons, str):
                word_prons = [word_prons]
            for word_pron in word_prons:
                lexicon.add(word, get_sounds_like(word_pron.split(), lexicon))

    # Template grammar (train.py:55-62)
    intents_obj = _load_intents(intents)
    ctx = compile_intents(
        intents_obj,
        io.StringIO(),
        lexicon,
        number_language=language,
        word_casing=word_casing,
    )

    # Lexicon entries (kaldi.py:151-236)
    entries: List = []
    missing: List[str] = []
    for word in sorted(ctx.vocab):
        if word == UNK:
            continue
        prons = lexicon.lookup(word)
        if prons:
            for pron in prons:
                entries.append((word, list(pron)))
        else:
            missing.append(word)
    if missing:
        # Guess with the profile's G2P model (kaldi.py:196-230); words it
        # can't phoneticize map to the silence phone like the reference's
        # no-pronunciation fallback (kaldi.py:211-217).
        guessed = {}
        g2p_path = model_dir / "g2p.fst"
        if g2p_path.exists():
            from ..lexicon.g2p_decoder import G2PModel, guess_pronunciations

            model = G2PModel.load(str(g2p_path))
            guessed = guess_pronunciations(missing, model)
        for word in missing:
            prons = guessed.get(word)
            if prons:
                _LOGGER.warning("Guessed pronunciation for %r: %s", word, prons[0])
                for pron in prons:
                    entries.append((word, list(pron)))
            else:
                _LOGGER.warning(
                    "No pronunciation for %r; mapping to %s", word, sil_phone
                )
                entries.append((word, [sil_phone]))
    entries.append((UNK, [spn_phone]))
    for meta in sorted(ctx.meta_labels):
        entries.append((meta, [sil_phone]))

    lang = prepare_lang(
        entries,
        silence_phones=[sil_phone, spn_phone],
        optional_silence=sil_phone,
    )

    # Acoustic model pdf mapping. A decision tree (context-dependent
    # models) takes precedence over the monophone tuple mapping.
    ktm, model_phones = _load_model_transition_model(model_dir)
    tree = None
    tree_path = model_dir / "model" / "tree"
    if ktm is not None and tree_path.exists():
        from ..io.tree import ContextDependencyTree

        tree = ContextDependencyTree.load(str(tree_path))
        tm = None
    elif ktm is not None:
        tm = transition_model_from_kaldi(ktm, model_phones, lang.phones)
    else:
        _LOGGER.warning(
            "No final.mdl in %s; building a standalone monophone transition "
            "model (decode graphs will only match a matching synthetic AM)",
            model_dir,
        )
        phone_ids = sorted(
            pid for (p, pid) in lang.phones if pid != 0 and not p.startswith("#")
        )
        tm = TransitionModel.monophone(Topology.chain(phone_ids))

    train_dir.mkdir(parents=True, exist_ok=True)

    # Grammar G (kaldi.py:311-341) — built for grammar/arpa alike (the
    # ARPA counts come from it). The fuzzy FST for the grammar lang copies
    # the UNPROJECTED template transducer (kaldi.py:343-360 reads G.fst.txt,
    # written before fstproject) so meta output labels survive into fuzzy
    # matches and decode_meta can rebuild slot outputs.
    ctx.fst_file.seek(0)
    g_text_transducer = compile_text_fst(ctx.fst_file, lang.words)
    ctx.fst_file.seek(0)
    g_grammar = make_grammar_g(ctx.fst_file, lang.words)

    # Deterministic phones→words map for lattice-level rescoring
    # (transcribe_wav.py:131-142 builds this as Ldet.fst on the fly)
    from ..lang.graphs import make_ldet

    ldet = make_ldet(lang)

    for suffix in lang_suffixes:
        if suffix == LangSuffix.GRAMMAR:
            g = g_grammar
            fuzzy = make_fuzzy_g(
                g_text_transducer, ctx.vocab, lang.words, self_loops=False
            )
        elif suffix == LangSuffix.ARPA:
            arpa = make_arpa_from_fst(
                g_grammar, order=3, symbols=lang.words, method=smoothing
            )
            g = arpa_to_fst(arpa, lang.words)
            # The reference's ARPA fuzzy also copies the raw template
            # transducer (kaldi.py:343-349 finds G.arpa.fst.txt, written
            # from fst_context at :259-261), with deletion self-loops —
            # so fuzzy matches carry meta output labels here too.
            fuzzy = make_fuzzy_g(
                g_text_transducer, ctx.vocab, lang.words, self_loops=True
            )
        elif suffix == LangSuffix.ARPA_RESCORE:
            arpa = make_arpa_from_fst(
                g_grammar, order=rescore_order, symbols=lang.words,
                method=smoothing,
            )
            g = arpa_to_fst(arpa, lang.words)
            fuzzy = None
        else:  # pragma: no cover
            raise ValueError(suffix)

        graph = None
        if suffix != LangSuffix.ARPA_RESCORE:
            from ..graph.transitions import TransitionTable

            transitions = TransitionTable()
            lg = make_lg(lang, g)
            if tree is not None:
                from ..graph.context import make_hclg_from_tree

                hclg, num_pdfs = make_hclg_from_tree(
                    lang, lg, tree, ktm, model_phones, transitions=transitions
                )
            else:
                hclg = make_hclg(lang, lg, tm, transitions=transitions)
                num_pdfs = tm.num_pdfs
            graph = dense_from_hclg(hclg, num_pdfs, transitions=transitions)

        artifacts = LangArtifacts(
            words=lang.words,
            g_fst=g,
            g_fuzzy=fuzzy,
            graph=graph,
            ldet=ldet,
            phones=lang.phones,
        )
        artifacts.save(train_dir / lang_dir_name(suffix))
        _LOGGER.info(
            "Built %s: %s states / %s arcs",
            lang_dir_name(suffix),
            graph.num_states if graph else "-",
            graph.num_arcs if graph else "-",
        )


async def train_model(
    language: str,
    intents: Union[Intents, Dict, str, Path],
    train_dir: Union[str, Path],
    model_dir: Union[str, Path],
    tools: Any = None,
    words: Optional[Dict[str, Union[str, List[str]]]] = None,
    lang_suffixes: Optional[Collection[LangSuffix]] = None,
    rescore_order: int = 5,
) -> None:
    """Async wrapper with the reference's signature (train.py:20-28)."""
    await asyncio.to_thread(
        lambda: train_model_sync(
            language,
            intents,
            train_dir,
            model_dir,
            tools=tools,
            words=words,
            lang_suffixes=lang_suffixes,
            rescore_order=rescore_order,
        ),
    )
