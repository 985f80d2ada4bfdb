"""Number → words engine.

Stand-in for the external ``unicode_rbnf`` RBNF engine the reference uses for
range slot lists and digit splitting (hassil_fst.py:604-616, g2p.py:140-148).
Covers the 8 languages the reference test fixtures exercise (en, de, fr, es,
it, nl, ru, cs). Callers replace "-" with " " before use, so only the word
tokens matter, not hyphenation.

``format_number`` returns a FormatResult with ``text`` (default ruleset) and
``text_by_ruleset`` (all grammatical variants, e.g. Russian gender forms) —
the same surface the reference consumes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Union

__all__ = ["FormatResult", "NumberEngine", "RbnfEngine"]


@dataclass
class FormatResult:
    text: str
    text_by_ruleset: Dict[str, str] = field(default_factory=dict)


class NumberEngine:
    """Spell out cardinal numbers for a language."""

    def __init__(self, language: str) -> None:
        self.language = language
        self._rules = _LANGUAGE_RULES[language]

    @staticmethod
    def for_language(language: str) -> "NumberEngine":
        lang = language.replace("-", "_").split("_")[0].lower()
        if lang not in _LANGUAGE_RULES:
            raise ValueError(f"Unsupported number language: {language}")
        return NumberEngine(lang)

    def format_number(self, number: Union[int, float, str]) -> FormatResult:
        if isinstance(number, str):
            number = number.strip()
            value: Union[int, float] = float(number) if "." in number else int(number)
        else:
            value = number

        if isinstance(value, float) and value.is_integer():
            value = int(value)

        by_ruleset: Dict[str, str] = {}
        if isinstance(value, int):
            for ruleset_name, rule_fn in self._rules.items():
                by_ruleset[ruleset_name] = _spell_int(value, rule_fn, self.language)
        else:
            int_part = int(value)
            frac_digits = _fraction_digits(value)
            point = _DECIMAL_POINT[self.language]
            for ruleset_name, rule_fn in self._rules.items():
                int_words = _spell_int(int_part, rule_fn, self.language)
                digit_words = " ".join(rule_fn(int(d)) for d in frac_digits)
                by_ruleset[ruleset_name] = f"{int_words} {point} {digit_words}"

        default_name = next(iter(self._rules))
        return FormatResult(text=by_ruleset[default_name], text_by_ruleset=by_ruleset)


# Alias matching the external engine's class name so call sites read the same.
RbnfEngine = NumberEngine


def _fraction_digits(value: float) -> str:
    text = repr(value)
    return text.split(".", 1)[1] if "." in text else "0"


def _spell_int(value: int, rule_fn: Callable[[int], str], language: str) -> str:
    if value < 0:
        return f"{_MINUS[language]} {rule_fn(-value)}"
    return rule_fn(value)


# ---------------------------------------------------------------------------
# English
# ---------------------------------------------------------------------------

_EN_ONES = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_EN_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
            "eighty", "ninety"]
_EN_SCALE = [(10 ** 9, "billion"), (10 ** 6, "million"), (10 ** 3, "thousand")]


def _en(n: int) -> str:
    if n < 20:
        return _EN_ONES[n]
    if n < 100:
        tens, ones = divmod(n, 10)
        word = _EN_TENS[tens]
        return f"{word}-{_EN_ONES[ones]}" if ones else word
    if n < 1000:
        hundreds, rest = divmod(n, 100)
        word = f"{_EN_ONES[hundreds]} hundred"
        return f"{word} {_en(rest)}" if rest else word
    for scale, scale_word in _EN_SCALE:
        if n >= scale:
            major, rest = divmod(n, scale)
            word = f"{_en(major)} {scale_word}"
            return f"{word} {_en(rest)}" if rest else word
    raise ValueError(f"Number out of range: {n}")


# ---------------------------------------------------------------------------
# German
# ---------------------------------------------------------------------------

_DE_ONES = [
    "null", "eins", "zwei", "drei", "vier", "fünf", "sechs", "sieben", "acht",
    "neun", "zehn", "elf", "zwölf", "dreizehn", "vierzehn", "fünfzehn",
    "sechzehn", "siebzehn", "achtzehn", "neunzehn",
]
_DE_ONE_COMBINING = ["", "ein", "zwei", "drei", "vier", "fünf", "sechs",
                     "sieben", "acht", "neun"]
_DE_TENS = ["", "", "zwanzig", "dreißig", "vierzig", "fünfzig", "sechzig",
            "siebzig", "achtzig", "neunzig"]


def _de_below_100(n: int) -> str:
    if n < 20:
        return _DE_ONES[n]
    tens, ones = divmod(n, 10)
    if ones:
        return f"{_DE_ONE_COMBINING[ones]}und{_DE_TENS[tens]}"
    return _DE_TENS[tens]


def _de(n: int) -> str:
    if n < 100:
        return _DE_ONES[n] if n < 20 else _de_below_100(n)
    if n < 1000:
        hundreds, rest = divmod(n, 100)
        word = f"{_DE_ONE_COMBINING[hundreds]}hundert"
        return f"{word}{_de_below_100(rest) if rest < 100 else _de(rest)}" if rest else word
    if n < 10 ** 6:
        thousands, rest = divmod(n, 1000)
        prefix = _DE_ONE_COMBINING[thousands] if thousands < 10 else _de(thousands)
        word = f"{prefix}tausend"
        return f"{word}{_de(rest)}" if rest else word
    if n < 10 ** 9:
        millions, rest = divmod(n, 10 ** 6)
        major = "eine Million" if millions == 1 else f"{_de(millions)} Millionen"
        return f"{major} {_de(rest)}" if rest else major
    raise ValueError(f"Number out of range: {n}")


# ---------------------------------------------------------------------------
# French
# ---------------------------------------------------------------------------

_FR_ONES = [
    "zéro", "un", "deux", "trois", "quatre", "cinq", "six", "sept", "huit",
    "neuf", "dix", "onze", "douze", "treize", "quatorze", "quinze", "seize",
    "dix-sept", "dix-huit", "dix-neuf",
]
_FR_TENS = ["", "", "vingt", "trente", "quarante", "cinquante", "soixante"]


def _fr_below_100(n: int) -> str:
    if n < 20:
        return _FR_ONES[n]
    if n < 70:
        tens, ones = divmod(n, 10)
        if ones == 1:
            return f"{_FR_TENS[tens]}-et-un"
        if ones:
            return f"{_FR_TENS[tens]}-{_FR_ONES[ones]}"
        return _FR_TENS[tens]
    if n < 80:
        # 70-79: soixante-dix .. soixante-dix-neuf
        if n == 71:
            return "soixante-et-onze"
        return f"soixante-{_FR_ONES[n - 60]}"
    if n == 80:
        return "quatre-vingts"
    # 81-99: quatre-vingt-un .. quatre-vingt-dix-neuf
    return f"quatre-vingt-{_FR_ONES[n - 80]}"


def _fr(n: int) -> str:
    if n < 100:
        return _fr_below_100(n)
    if n < 1000:
        hundreds, rest = divmod(n, 100)
        if hundreds == 1:
            word = "cent"
        elif rest == 0:
            word = f"{_FR_ONES[hundreds]} cents"
        else:
            word = f"{_FR_ONES[hundreds]} cent"
        return f"{word} {_fr_below_100(rest)}" if rest else word
    if n < 10 ** 6:
        thousands, rest = divmod(n, 1000)
        word = "mille" if thousands == 1 else f"{_fr(thousands)} mille"
        return f"{word} {_fr(rest)}" if rest else word
    if n < 10 ** 9:
        millions, rest = divmod(n, 10 ** 6)
        major = "un million" if millions == 1 else f"{_fr(millions)} millions"
        return f"{major} {_fr(rest)}" if rest else major
    raise ValueError(f"Number out of range: {n}")


# ---------------------------------------------------------------------------
# Spanish
# ---------------------------------------------------------------------------

_ES_ONES = [
    "cero", "uno", "dos", "tres", "cuatro", "cinco", "seis", "siete", "ocho",
    "nueve", "diez", "once", "doce", "trece", "catorce", "quince",
    "dieciséis", "diecisiete", "dieciocho", "diecinueve",
]
_ES_TWENTIES = ["veinte", "veintiuno", "veintidós", "veintitrés",
                "veinticuatro", "veinticinco", "veintiséis", "veintisiete",
                "veintiocho", "veintinueve"]
_ES_TENS = ["", "", "", "treinta", "cuarenta", "cincuenta", "sesenta",
            "setenta", "ochenta", "noventa"]
_ES_HUNDREDS = ["", "ciento", "doscientos", "trescientos", "cuatrocientos",
                "quinientos", "seiscientos", "setecientos", "ochocientos",
                "novecientos"]


def _es_below_100(n: int) -> str:
    if n < 20:
        return _ES_ONES[n]
    if n < 30:
        return _ES_TWENTIES[n - 20]
    tens, ones = divmod(n, 10)
    if ones:
        return f"{_ES_TENS[tens]} y {_ES_ONES[ones]}"
    return _ES_TENS[tens]


def _es(n: int) -> str:
    if n < 100:
        return _es_below_100(n)
    if n == 100:
        return "cien"
    if n < 1000:
        hundreds, rest = divmod(n, 100)
        word = _ES_HUNDREDS[hundreds]
        return f"{word} {_es_below_100(rest)}" if rest else word
    if n < 10 ** 6:
        thousands, rest = divmod(n, 1000)
        word = "mil" if thousands == 1 else f"{_es(thousands)} mil"
        return f"{word} {_es(rest)}" if rest else word
    if n < 10 ** 9:
        millions, rest = divmod(n, 10 ** 6)
        major = "un millón" if millions == 1 else f"{_es(millions)} millones"
        return f"{major} {_es(rest)}" if rest else major
    raise ValueError(f"Number out of range: {n}")


# ---------------------------------------------------------------------------
# Italian
# ---------------------------------------------------------------------------

_IT_ONES = [
    "zero", "uno", "due", "tre", "quattro", "cinque", "sei", "sette", "otto",
    "nove", "dieci", "undici", "dodici", "tredici", "quattordici", "quindici",
    "sedici", "diciassette", "diciotto", "diciannove",
]
_IT_TENS = ["", "", "venti", "trenta", "quaranta", "cinquanta", "sessanta",
            "settanta", "ottanta", "novanta"]


def _it_below_100(n: int) -> str:
    if n < 20:
        return _IT_ONES[n]
    tens, ones = divmod(n, 10)
    tens_word = _IT_TENS[tens]
    if ones == 0:
        return tens_word
    if ones in (1, 8):
        # Elision: venti + uno -> ventuno, venti + otto -> ventotto
        tens_word = tens_word[:-1]
    ones_word = "tré" if ones == 3 else _IT_ONES[ones]
    return f"{tens_word}{ones_word}"


def _it(n: int) -> str:
    if n < 100:
        return _it_below_100(n)
    if n < 1000:
        hundreds, rest = divmod(n, 100)
        word = "cento" if hundreds == 1 else f"{_IT_ONES[hundreds]}cento"
        if rest:
            rest_word = _it_below_100(rest)
            if 80 <= rest <= 89:
                word = word[:-1]  # cento + ottanta -> centottanta
            return f"{word}{rest_word}"
        return word
    if n < 10 ** 6:
        thousands, rest = divmod(n, 1000)
        word = "mille" if thousands == 1 else f"{_it(thousands)}mila"
        return f"{word}{_it(rest)}" if rest else word
    if n < 10 ** 9:
        millions, rest = divmod(n, 10 ** 6)
        major = "un milione" if millions == 1 else f"{_it(millions)} milioni"
        return f"{major} {_it(rest)}" if rest else major
    raise ValueError(f"Number out of range: {n}")


# ---------------------------------------------------------------------------
# Dutch
# ---------------------------------------------------------------------------

_NL_ONES = [
    "nul", "een", "twee", "drie", "vier", "vijf", "zes", "zeven", "acht",
    "negen", "tien", "elf", "twaalf", "dertien", "veertien", "vijftien",
    "zestien", "zeventien", "achttien", "negentien",
]
_NL_TENS = ["", "", "twintig", "dertig", "veertig", "vijftig", "zestig",
            "zeventig", "tachtig", "negentig"]


def _nl_below_100(n: int) -> str:
    if n < 20:
        return _NL_ONES[n]
    tens, ones = divmod(n, 10)
    if ones == 0:
        return _NL_TENS[tens]
    ones_word = _NL_ONES[ones]
    joiner = "ën" if ones_word.endswith("e") else "en"
    return f"{ones_word}{joiner}{_NL_TENS[tens]}"


def _nl(n: int) -> str:
    if n < 100:
        return _nl_below_100(n)
    if n < 1000:
        hundreds, rest = divmod(n, 100)
        word = "honderd" if hundreds == 1 else f"{_NL_ONES[hundreds]}honderd"
        return f"{word}{_nl(rest)}" if rest else word
    if n < 10 ** 6:
        thousands, rest = divmod(n, 1000)
        word = "duizend" if thousands == 1 else f"{_nl(thousands)}duizend"
        return f"{word} {_nl(rest)}" if rest else word
    if n < 10 ** 9:
        millions, rest = divmod(n, 10 ** 6)
        major = "een miljoen" if millions == 1 else f"{_nl(millions)} miljoen"
        return f"{major} {_nl(rest)}" if rest else major
    raise ValueError(f"Number out of range: {n}")


# ---------------------------------------------------------------------------
# Russian (masculine / feminine / neuter cardinal forms)
# ---------------------------------------------------------------------------

_RU_ONES = [
    "ноль", "один", "два", "три", "четыре", "пять", "шесть", "семь",
    "восемь", "девять", "десять", "одиннадцать", "двенадцать", "тринадцать",
    "четырнадцать", "пятнадцать", "шестнадцать", "семнадцать",
    "восемнадцать", "девятнадцать",
]
_RU_TENS = ["", "", "двадцать", "тридцать", "сорок", "пятьдесят",
            "шестьдесят", "семьдесят", "восемьдесят", "девяносто"]
_RU_HUNDREDS = ["", "сто", "двести", "триста", "четыреста", "пятьсот",
                "шестьсот", "семьсот", "восемьсот", "девятьсот"]
_RU_GENDER_FORMS = {
    "masculine": {1: "один", 2: "два"},
    "feminine": {1: "одна", 2: "две"},
    "neuter": {1: "одно", 2: "два"},
}


def _ru_gender(n: int, gender: str) -> str:
    forms = _RU_GENDER_FORMS[gender]

    def below_1000(m: int) -> List[str]:
        words: List[str] = []
        hundreds, rest = divmod(m, 100)
        if hundreds:
            words.append(_RU_HUNDREDS[hundreds])
        if rest >= 20:
            tens, ones = divmod(rest, 10)
            words.append(_RU_TENS[tens])
            if ones:
                words.append(forms.get(ones, _RU_ONES[ones]))
        elif rest:
            words.append(forms.get(rest, _RU_ONES[rest]))
        return words

    if n == 0:
        return _RU_ONES[0]
    if n >= 10 ** 9:
        raise ValueError(f"Number out of range: {n}")

    words: List[str] = []
    millions, rest = divmod(n, 10 ** 6)
    if millions:
        words.extend(below_1000(millions))
        words.append(_ru_plural(millions, "миллион", "миллиона", "миллионов"))
    thousands, rest = divmod(rest, 1000)
    if thousands:
        # Thousands agree in feminine gender
        fem = _ru_gender_below_1000_fem(thousands)
        words.extend(fem)
        words.append(_ru_plural(thousands, "тысяча", "тысячи", "тысяч"))
    if rest:
        words.extend(below_1000(rest))
    return " ".join(words)


def _ru_gender_below_1000_fem(m: int) -> List[str]:
    forms = _RU_GENDER_FORMS["feminine"]
    words: List[str] = []
    hundreds, rest = divmod(m, 100)
    if hundreds:
        words.append(_RU_HUNDREDS[hundreds])
    if rest >= 20:
        tens, ones = divmod(rest, 10)
        words.append(_RU_TENS[tens])
        if ones:
            words.append(forms.get(ones, _RU_ONES[ones]))
    elif rest:
        words.append(forms.get(rest, _RU_ONES[rest]))
    return words


def _ru_plural(n: int, one: str, few: str, many: str) -> str:
    if (n % 100) in range(11, 15):
        return many
    last = n % 10
    if last == 1:
        return one
    if last in (2, 3, 4):
        return few
    return many


# ---------------------------------------------------------------------------
# Czech (feminine is the default counting form; masculine/neuter variants)
# ---------------------------------------------------------------------------

_CS_ONES = [
    "nula", "jedna", "dva", "tři", "čtyři", "pět", "šest", "sedm", "osm",
    "devět", "deset", "jedenáct", "dvanáct", "třináct", "čtrnáct", "patnáct",
    "šestnáct", "sedmnáct", "osmnáct", "devatenáct",
]
_CS_TENS = ["", "", "dvacet", "třicet", "čtyřicet", "padesát", "šedesát",
            "sedmdesát", "osmdesát", "devadesát"]
_CS_HUNDREDS = ["", "sto", "dvě stě", "tři sta", "čtyři sta", "pět set",
                "šest set", "sedm set", "osm set", "devět set"]
_CS_GENDER_FORMS = {
    "feminine": {1: "jedna", 2: "dvě"},
    "masculine": {1: "jeden", 2: "dva"},
    "neuter": {1: "jedno", 2: "dvě"},
}


def _cs_gender(n: int, gender: str) -> str:
    forms = _CS_GENDER_FORMS[gender]

    def below_1000(m: int) -> List[str]:
        words: List[str] = []
        hundreds, rest = divmod(m, 100)
        if hundreds:
            words.append(_CS_HUNDREDS[hundreds])
        if rest >= 20:
            tens, ones = divmod(rest, 10)
            words.append(_CS_TENS[tens])
            if ones:
                words.append(forms.get(ones, _CS_ONES[ones]))
        elif rest:
            words.append(forms.get(rest, _CS_ONES[rest]))
        return words

    if n == 0:
        return _CS_ONES[0]
    if n >= 10 ** 6:
        thousands_limit = 10 ** 9
        if n >= thousands_limit:
            raise ValueError(f"Number out of range: {n}")

    words: List[str] = []
    millions, rest = divmod(n, 10 ** 6)
    if millions:
        words.extend(below_1000(millions))
        words.append(_cs_plural(millions, "milion", "miliony", "milionů"))
    thousands, rest = divmod(rest, 1000)
    if thousands:
        if thousands == 1:
            words.append("tisíc")
        else:
            words.extend(below_1000(thousands))
            words.append(_cs_plural(thousands, "tisíc", "tisíce", "tisíc"))
    if rest:
        words.extend(below_1000(rest))
    return " ".join(words)


def _cs_plural(n: int, one: str, few: str, many: str) -> str:
    if n == 1:
        return one
    if n in (2, 3, 4):
        return few
    return many


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_DECIMAL_POINT = {
    "en": "point", "de": "Komma", "fr": "virgule", "es": "coma",
    "it": "virgola", "nl": "komma", "ru": "запятая", "cs": "celá",
}
_MINUS = {
    "en": "minus", "de": "minus", "fr": "moins", "es": "menos",
    "it": "meno", "nl": "min", "ru": "минус", "cs": "minus",
}

_LANGUAGE_RULES: Dict[str, Dict[str, Callable[[int], str]]] = {
    "en": {"spellout-cardinal": _en},
    "de": {"spellout-cardinal": _de},
    "fr": {"spellout-cardinal": _fr},
    "es": {"spellout-cardinal": _es},
    "it": {"spellout-cardinal": _it},
    "nl": {"spellout-cardinal": _nl},
    "ru": {
        "spellout-cardinal-masculine": lambda n: _ru_gender(n, "masculine"),
        "spellout-cardinal-feminine": lambda n: _ru_gender(n, "feminine"),
        "spellout-cardinal-neuter": lambda n: _ru_gender(n, "neuter"),
    },
    "cs": {
        "spellout-cardinal-feminine": lambda n: _cs_gender(n, "feminine"),
        "spellout-cardinal-masculine": lambda n: _cs_gender(n, "masculine"),
        "spellout-cardinal-neuter": lambda n: _cs_gender(n, "neuter"),
    },
}
