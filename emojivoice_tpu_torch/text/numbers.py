"""English number → words expansion.

The reference vendors an inflect-based ``numbers.py`` but never wires it
into its cleaners (SURVEY.md §2.3); here the expansion is implemented in
pure Python (no inflect in the image) and *is* wired: add
``"expand_numbers_en"`` to a cleaner list, or rely on
``english_cleaners2``'s currency tables for money amounts.

Covers: integers (scale names to decillions), ordinals (1st/2nd/...),
years (1985 → nineteen eighty five), decimals via 'point', commas in
groups.
"""

from __future__ import annotations

import re

_UNITS = ["zero", "one", "two", "three", "four", "five", "six", "seven", "eight", "nine",
          "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen", "sixteen",
          "seventeen", "eighteen", "nineteen"]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy", "eighty", "ninety"]
_SCALES = ["", " thousand", " million", " billion", " trillion", " quadrillion",
           " quintillion", " sextillion", " septillion", " octillion", " nonillion",
           " decillion"]

_ORDINAL_UNITS = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}

_comma_number_re = re.compile(r"(\d[\d,]*\d)")
_decimal_re = re.compile(r"(\d+)\.(\d+)")
_ordinal_re = re.compile(r"(\d+)(st|nd|rd|th)\b")
_year_re = re.compile(r"\b(1[5-9]\d\d|20\d\d)\b")
_number_re = re.compile(r"\d+")
# version/id runs (2.1.3, 192.168.0.1): ≥2 separators — read each component
# as a cardinal joined by the locale decimal word, so no separator survives
# glued between verbalized words as a spurious sentence-internal pause
_version_re = re.compile(r"\d+(?:[.,]\d+){2,}")


def _three_digits(n: int) -> str:
    assert 0 <= n < 1000
    if n < 20:
        return _UNITS[n]
    if n < 100:
        t, u = divmod(n, 10)
        return _TENS[t] + (f" {_UNITS[u]}" if u else "")
    h, rest = divmod(n, 100)
    out = f"{_UNITS[h]} hundred"
    if rest:
        out += f" {_three_digits(rest)}"
    return out


def number_to_words(n: int) -> str:
    """Spell an integer in English words.

    >>> number_to_words(0)
    'zero'
    >>> number_to_words(21)
    'twenty one'
    >>> number_to_words(-105)
    'minus one hundred five'
    >>> number_to_words(2023)
    'two thousand twenty three'
    """
    if n < 0:
        return "minus " + number_to_words(-n)
    if n == 0:
        return "zero"
    groups = []
    scale = 0
    while n > 0 and scale < len(_SCALES):
        n, g = divmod(n, 1000)
        if g:
            groups.append(_three_digits(g) + _SCALES[scale])
        scale += 1
    if n > 0:  # beyond decillions: read digit by digit
        groups.append(" ".join(_UNITS[int(d)] for d in str(n)))
    return " ".join(reversed(groups))


def ordinal_to_words(n: int) -> str:
    """Spell an ordinal: 1 → 'first', 22 → 'twenty second'.

    >>> ordinal_to_words(3)
    'third'
    >>> ordinal_to_words(20)
    'twentieth'
    >>> ordinal_to_words(101)
    'one hundred first'
    """
    words = number_to_words(n)
    parts = words.rsplit(" ", 1)
    last = parts[-1]
    if last in _ORDINAL_UNITS:
        parts[-1] = _ORDINAL_UNITS[last]
    elif last.endswith("y"):
        parts[-1] = last[:-1] + "ieth"
    else:
        parts[-1] = last + "th"
    return " ".join(parts)


def year_to_words(n: int) -> str:
    """Read a year the spoken way: pairs of digits, 'oh' for a 0x tail.

    >>> year_to_words(1999)
    'nineteen ninety nine'
    >>> year_to_words(1905)
    'nineteen oh five'
    >>> year_to_words(2000)
    'two thousand'
    """
    if n % 1000 == 0:
        return number_to_words(n)
    if n % 100 == 0:
        return f"{number_to_words(n // 100)} hundred"
    hi, lo = divmod(n, 100)
    if lo < 10:
        return f"{number_to_words(hi)} oh {_UNITS[lo]}"
    return f"{number_to_words(hi)} {_three_digits(lo)}"


def expand_numbers_en(text: str) -> str:
    text = _comma_number_re.sub(lambda m: m.group(1).replace(",", ""), text)
    text = _version_re.sub(
        lambda m: " point ".join(number_to_words(int(p))
                                 for p in re.split(r"[.,]", m.group(0))),
        text,
    )
    text = _ordinal_re.sub(lambda m: ordinal_to_words(int(m.group(1))), text)
    text = _year_re.sub(lambda m: year_to_words(int(m.group(1))), text)
    text = _decimal_re.sub(
        lambda m: f"{number_to_words(int(m.group(1)))} point "
        + " ".join(_UNITS[int(d)] for d in m.group(2)),
        text,
    )
    text = _number_re.sub(lambda m: number_to_words(int(m.group(0))), text)
    return text


# -- multilingual cardinals (grapheme-fallback path) --------------------------
#
# With espeak present the reference pipeline never verbalizes digits itself —
# espeak speaks them in-language.  The dependency-free grapheme fallback
# (text/cleaners.py:_grapheme_fallback) has no such backstop: any digit would
# be silently stripped by the symbol-table filter.  These cardinal/decimal
# verbalizers close that hole for every shipped language.  Scope matches what
# espeak does for plain digit runs: cardinals + decimals (read digit by digit
# after the separator); locale ordinal suffixes (1er/1./1º) stay out of scope.
# Accented outputs (fr/es) are written correctly here; the fallback's accent
# transliteration maps them onto the symbol table afterwards.

_FR_UNITS = ["zéro", "un", "deux", "trois", "quatre", "cinq", "six", "sept",
             "huit", "neuf", "dix", "onze", "douze", "treize", "quatorze",
             "quinze", "seize", "dix-sept", "dix-huit", "dix-neuf"]
_FR_TENS = {20: "vingt", 30: "trente", 40: "quarante", 50: "cinquante", 60: "soixante"}


def _fr_under_100(n: int) -> str:
    if n < 20:
        return _FR_UNITS[n]
    if n < 70:
        t, u = (n // 10) * 10, n % 10
        if u == 0:
            return _FR_TENS[t]
        if u == 1:
            return f"{_FR_TENS[t]} et un"
        return f"{_FR_TENS[t]}-{_FR_UNITS[u]}"
    if n < 80:  # soixante-dix .. soixante-dix-neuf, 71 = soixante et onze
        if n == 71:
            return "soixante et onze"
        return f"soixante-{_FR_UNITS[n - 60]}"
    if n == 80:
        return "quatre-vingts"
    if n < 100:
        return f"quatre-vingt-{_FR_UNITS[n - 80]}"
    raise ValueError(n)


def _fr_under_1000(n: int) -> str:
    if n < 100:
        return _fr_under_100(n)
    h, rest = divmod(n, 100)
    if h == 1:
        head = "cent"
    elif rest == 0:
        return f"{_FR_UNITS[h]} cents"  # deux cents, but deux cent un
    else:
        head = f"{_FR_UNITS[h]} cent"
    return head if rest == 0 else f"{head} {_fr_under_1000(rest)}"


def number_to_words_fr(n: int) -> str:
    if n < 0:
        return "moins " + number_to_words_fr(-n)
    if n == 0:
        return "zéro"
    parts = []
    for scale, (sing, plur) in ((10 ** 9, ("milliard", "milliards")),
                                (10 ** 6, ("million", "millions"))):
        if n >= scale:
            q, n = divmod(n, scale)
            parts.append(f"{number_to_words_fr(q)} {plur if q > 1 else sing}")
    if n >= 1000:
        q, n = divmod(n, 1000)
        # mille is invariable and 1000 is plain "mille"
        parts.append("mille" if q == 1 else f"{_fr_under_1000(q)} mille")
    if n:
        parts.append(_fr_under_1000(n))
    return " ".join(parts)


_DE_UNITS = ["null", "eins", "zwei", "drei", "vier", "fünf", "sechs", "sieben",
             "acht", "neun", "zehn", "elf", "zwölf", "dreizehn", "vierzehn",
             "fünfzehn", "sechzehn", "siebzehn", "achtzehn", "neunzehn"]
_DE_TENS = {20: "zwanzig", 30: "dreißig", 40: "vierzig", 50: "fünfzig",
            60: "sechzig", 70: "siebzig", 80: "achtzig", 90: "neunzig"}


def _de_under_1000(n: int, final: bool) -> str:
    """German composes one word per 3-digit group; ``final`` picks eins/ein."""
    if n >= 100:
        h, rest = divmod(n, 100)
        head = ("ein" if h == 1 else _DE_UNITS[h]) + "hundert"
        return head + (_de_under_1000(rest, final) if rest else "")
    if n < 20:
        if n == 1:
            return "eins" if final else "ein"
        return _DE_UNITS[n]
    t, u = (n // 10) * 10, n % 10
    if u == 0:
        return _DE_TENS[t]
    return ("ein" if u == 1 else _DE_UNITS[u]) + "und" + _DE_TENS[t]


def number_to_words_de(n: int) -> str:
    if n < 0:
        return "minus " + number_to_words_de(-n)
    if n == 0:
        return "null"
    parts = []
    for scale, (sing, plur) in ((10 ** 9, ("eine Milliarde", "Milliarden")),
                                (10 ** 6, ("eine Million", "Millionen"))):
        if n >= scale:
            q, n = divmod(n, scale)
            parts.append(sing if q == 1 else f"{number_to_words_de(q)} {plur}")
    if n >= 1000:
        q, n = divmod(n, 1000)
        parts.append(_de_under_1000(q, final=False) + "tausend")
    if n:
        word = _de_under_1000(n, final=True)
        # glue the tail onto ...tausend the way German writes it
        if parts and parts[-1].endswith("tausend"):
            parts[-1] += word
        else:
            parts.append(word)
    return " ".join(parts).lower()


_ES_UNITS = ["cero", "uno", "dos", "tres", "cuatro", "cinco", "seis", "siete",
             "ocho", "nueve", "diez", "once", "doce", "trece", "catorce",
             "quince", "dieciséis", "diecisiete", "dieciocho", "diecinueve",
             "veinte", "veintiuno", "veintidós", "veintitrés", "veinticuatro",
             "veinticinco", "veintiséis", "veintisiete", "veintiocho",
             "veintinueve"]
_ES_TENS = {30: "treinta", 40: "cuarenta", 50: "cincuenta", 60: "sesenta",
            70: "setenta", 80: "ochenta", 90: "noventa"}
_ES_HUNDREDS = {1: "ciento", 2: "doscientos", 3: "trescientos", 4: "cuatrocientos",
                5: "quinientos", 6: "seiscientos", 7: "setecientos",
                8: "ochocientos", 9: "novecientos"}


def _es_under_1000(n: int) -> str:
    if n < 30:
        return _ES_UNITS[n]
    if n < 100:
        t, u = (n // 10) * 10, n % 10
        return _ES_TENS[t] + (f" y {_ES_UNITS[u]}" if u else "")
    if n == 100:
        return "cien"
    h, rest = divmod(n, 100)
    return _ES_HUNDREDS[h] + (f" {_es_under_1000(rest)}" if rest else "")


def _es_apocope(words: str) -> str:
    """Apocope before a masculine noun (mil/millones): veintiuno → veintiún,
    trailing uno → un.  Order matters — veintiuno contains uno."""
    return words.replace("veintiuno", "veintiún").replace("uno", "un")


def number_to_words_es(n: int) -> str:
    if n < 0:
        return "menos " + number_to_words_es(-n)
    if n == 0:
        return "cero"
    parts = []
    if n >= 10 ** 6:
        q, n = divmod(n, 10 ** 6)
        # 21 000 000 = "veintiún millones" — the apocope applies before
        # millones exactly as before mil
        parts.append("un millón" if q == 1
                     else f"{_es_apocope(number_to_words_es(q))} millones")
    if n >= 1000:
        q, n = divmod(n, 1000)
        # "mil", "dos mil"; 21000 = "veintiún mil" (apocope before mil)
        q_words = "" if q == 1 else _es_apocope(_es_under_1000(q)) + " "
        parts.append(f"{q_words}mil")
    if n:
        parts.append(_es_under_1000(n))
    return " ".join(parts)


_JA_DIGITS = ["zero", "ichi", "ni", "san", "yon", "go", "roku", "nana", "hachi", "kyuu"]
_JA_HUNDRED = {1: "hyaku", 2: "nihyaku", 3: "sanbyaku", 4: "yonhyaku", 5: "gohyaku",
               6: "roppyaku", 7: "nanahyaku", 8: "happyaku", 9: "kyuuhyaku"}
_JA_THOUSAND = {1: "sen", 2: "nisen", 3: "sanzen", 4: "yonsen", 5: "gosen",
                6: "rokusen", 7: "nanasen", 8: "hassen", 9: "kyuusen"}


def _ja_under_10000(n: int) -> str:
    parts = []
    th, n = divmod(n, 1000)
    if th:
        parts.append(_JA_THOUSAND[th])
    h, n = divmod(n, 100)
    if h:
        parts.append(_JA_HUNDRED[h])
    t, u = divmod(n, 10)
    if t:
        parts.append("juu" if t == 1 else _JA_DIGITS[t] + "juu")
    if u:
        parts.append(_JA_DIGITS[u])
    return " ".join(parts)


def number_to_words_ja(n: int) -> str:
    """Romaji readings — the grapheme fallback transliterates kana to romaji,
    so digits verbalize straight into the same alphabet."""
    if n < 0:
        return "mainasu " + number_to_words_ja(-n)
    if n == 0:
        return "zero"
    if n >= 10 ** 20:  # beyond kei myriads: read digit by digit (the same
        # backstop the English expander uses past its scale table — a run
        # this long is an id/serial, not a quantity)
        return " ".join(_JA_DIGITS[int(d)] for d in str(n))
    parts = []
    for scale, name in ((10 ** 16, "kei"), (10 ** 12, "chou"),
                        (10 ** 8, "oku"), (10 ** 4, "man")):
        if n >= scale:
            q, n = divmod(n, scale)
            parts.append(f"{_ja_under_10000(q)} {name}")
    if n:
        parts.append(_ja_under_10000(n))
    return " ".join(parts)


_CARDINALS = {"en": number_to_words, "fr": number_to_words_fr,
              "de": number_to_words_de, "es": number_to_words_es,
              "ja": number_to_words_ja}
_DECIMAL_WORD = {"en": "point", "fr": "virgule", "de": "Komma",
                 "es": "coma", "ja": "ten"}
_DIGIT_WORDS = {
    "en": _UNITS[:10],
    "fr": _FR_UNITS[:10],
    "de": _DE_UNITS[:10],
    "es": _ES_UNITS[:10],
    "ja": _JA_DIGITS,
}
# non-en locales write decimals with a comma; inputs use either separator
_any_decimal_re = re.compile(r"(\d+)[.,](\d+)")
# locale digit grouping — collapsed BEFORE decimal handling so German
# "1.000 Euro" speaks eintausend, not "eins Komma null null null" (espeak,
# whose bare-digit behavior this path mirrors, reads grouped thousands as
# one number).  de/es/fr group with '.'; ja groups Western-style with ','.
# The dot pattern refuses a following [.,]digit so version/id runs
# (192.168.0.1) fall through to _version_re instead, while a trailing
# decimal part ("1.000,5") stays attached.
_dot_group_re = re.compile(r"(?<![\d.,])(\d{1,3}(?:\.\d{3})+)(?!\.?\d)")
_comma_group_re = re.compile(r"(?<![\d.,])(\d{1,3}(?:,\d{3})+)(?!,?\d)")
# English-style comma grouping with ≥2 groups is unambiguous in any locale
# (a decimal has exactly one separator) — collapse it everywhere
_multi_comma_group_re = re.compile(r"(?<![\d.,])(\d{1,3}(?:,\d{3}){2,})(?!,?\d)")
_GROUPING_RES = {"de": _dot_group_re, "es": _dot_group_re, "fr": _dot_group_re,
                 "ja": _comma_group_re}


def verbalize_numbers(text: str, language: str) -> str:
    """Language-dispatched digit verbalization for the grapheme fallback.

    English rides the full expander (ordinals/years/comma groups); the other
    languages collapse locale digit grouping, then expand cardinals and
    decimals — both '.' and ',' separate a decimal part (read digit by digit),
    matching how espeak reads bare digit runs.  Version/id runs with ≥2
    separators read component-by-component ("2.1.3" → "deux virgule un
    virgule trois").  Unknown languages fall back to English."""
    lang = language if language in _CARDINALS else "en"
    if lang == "en":
        return expand_numbers_en(text)
    words, digits, sep = _CARDINALS[lang], _DIGIT_WORDS[lang], _DECIMAL_WORD[lang]
    group_re = _GROUPING_RES[lang]
    text = group_re.sub(lambda m: m.group(1).replace(".", "").replace(",", ""), text)
    if group_re is not _comma_group_re:
        text = _multi_comma_group_re.sub(lambda m: m.group(1).replace(",", ""), text)
    text = _version_re.sub(
        lambda m: f" {sep} ".join(words(int(p))
                                  for p in re.split(r"[.,]", m.group(0))),
        text,
    )
    text = _any_decimal_re.sub(
        lambda m: f"{words(int(m.group(1)))} {sep} "
        + " ".join(digits[int(d)] for d in m.group(2)), text)
    return _number_re.sub(lambda m: words(int(m.group(0))), text)
