"""Language/lexicon compilation layer (prepare_lang + LM + G graphs)."""

from .graphs import (
    compile_text_fst,
    make_fuzzy_g,
    make_grammar_g,
    make_lg,
    push_special,
)
from .lexicon_fst import (
    Lang,
    LexiconEntry,
    add_lex_disambig,
    apply_position_markers,
    make_lexicon_fst,
    prepare_lang,
)
from .ngram import (
    ArpaModel,
    arpa_to_fst,
    count_ngrams,
    make_arpa_from_fst,
    witten_bell,
)

__all__ = [
    "ArpaModel",
    "Lang",
    "LexiconEntry",
    "add_lex_disambig",
    "apply_position_markers",
    "arpa_to_fst",
    "compile_text_fst",
    "count_ngrams",
    "make_arpa_from_fst",
    "make_fuzzy_g",
    "make_grammar_g",
    "make_lg",
    "prepare_lang",
    "push_special",
    "witten_bell",
]
