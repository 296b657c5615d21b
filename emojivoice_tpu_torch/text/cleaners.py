"""Text cleaners / phonemization pipelines (en/fr/de/es/ja).

Behavioral re-implementation of the reference's multilingual front end
(reference: Matcha-TTS/matcha/text/cleaners.py).  The phonemizer→espeak-ng
path is a host-side process/library boundary and stays outside the compiled
graph; it is gated on availability:

* if the ``phonemizer`` package (espeak-ng bindings) is importable, the
  espeak pipelines behave like the reference (preserve punctuation, with
  stress, language-switch flags removed);
* otherwise ``grapheme`` mode is used: the cleaned lowercase text itself
  (every char of which is in the 178-symbol table) feeds the model.  This
  keeps the full stack runnable/trainable in hermetic environments; models
  trained on graphemes vs phonemes are not interchangeable, which is why the
  active mode is recorded in ``phonemizer_backend()``.

Japanese uses misaki's JAG2P when importable, else grapheme mode.
"""

from __future__ import annotations

import logging
import re
from functools import lru_cache

log = logging.getLogger(__name__)

_whitespace_re = re.compile(r"\s+")

# -- abbreviation tables (same expansion behavior as the reference) ----------

_abbreviations_en = [
    (re.compile(rf"\b{abbr}\.", re.IGNORECASE), full)
    for abbr, full in [
        ("mrs", "misess"), ("ms", "miss"), ("mr", "mister"), ("dr", "doctor"),
        ("st", "saint"), ("co", "company"), ("jr", "junior"), ("maj", "major"),
        ("gen", "general"), ("drs", "doctors"), ("rev", "reverend"),
        ("lt", "lieutenant"), ("hon", "honorable"), ("sgt", "sergeant"),
        ("capt", "captain"), ("esq", "esquire"), ("ltd", "limited"),
        ("col", "colonel"), ("ft", "fort"),
    ]
]

_abbreviations_fr = [
    (re.compile(rf"\b{abbr}\.", re.IGNORECASE), full)
    for abbr, full in [("m.", "monsieur"), ("dr", "docteur"), ("st", "saint")]
]

_abbreviations_de = [
    (re.compile(rf"\b{abbr}\.", re.IGNORECASE), full)
    for abbr, full in [
        ("hr", "herr"), ("fr", "frau"), ("dr", "doktor"), ("prof", "professor"),
        ("bsp", "beispiel"), ("usw", "und so weiter"), ("z", "zu"),
        ("z.b", "zum beispiel"), ("ca", "zirka"), ("bzw", "beziehungsweise"),
        ("d.h", "das heißt"), ("u.a", "unter anderem"), ("u.u", "unter umständen"),
        ("u.v.m", "und vieles mehr"), ("vgl", "vergleiche"),
    ]
]

_ABBREVIATIONS = {"en": _abbreviations_en, "fr": _abbreviations_fr, "de": _abbreviations_de}

# -- symbol/currency replacement tables --------------------------------------

_replacements_en = [
    (re.compile(r"\.\.\."), "ELLIPSIS_MARKER"),
    (re.compile(r"\$(\d+)\.(\d+)"), r"\1 dollars and \2 cents"),
    (re.compile(r"€(\d+)\.(\d+)"), r"\1 euros and \2 cents"),
    (re.compile(r"¥(\d+)\.(\d+)"), r"\1 yen and \2 cents"),
    (re.compile(r"(?<=\D)\.(?=\D)(?!\s)", re.IGNORECASE), " dot "),
    (re.compile(r"(?<=\d)\.(?=\d)(?!\s)"), " point "),
    (re.compile(r"\$(\d+)"), r"\1 dollars"),
    (re.compile(r"€(\d+)"), r"\1 euros"),
    (re.compile(r"¥(\d+)"), r"\1 yen"),
    (re.compile(r"ELLIPSIS_MARKER"), "..."),
]

_replacements_fr = [
    (re.compile(r"\.\.\."), "ELLIPSIS_MARKER"),
    (re.compile(r"\("), ""),
    (re.compile(r"\)"), ""),
    (re.compile(r"(\d+)\.(\d+)\$"), r"\1 dollars et \2 centimes"),
    (re.compile(r"(\d+)\.(\d+)€"), r"\1 euros et \2 centimes"),
    (re.compile(r"(\d+)\.(\d+)¥"), r"\1 yen et \2 centimes"),
    (re.compile(r"(?<=\D)\.(?=\D)(?!\s)", re.IGNORECASE), " point "),
    (re.compile(r"(?<=\d)\,(?=\d)(?!\s)"), " virgule "),
    (re.compile(r"€"), " euros"),
    (re.compile(r"¥"), " yen"),
    (re.compile(r"Mme"), "madame"),
    (re.compile(r"Mlle"), "mademoiselle"),
    (re.compile(r"="), " égales "),
    (re.compile(r"/"), " slash "),
    (re.compile(r"-(?=\d)(?!\s)"), "négatif "),
    (re.compile(r"ELLIPSIS_MARKER"), "..."),
]

_replacements_de = [
    (re.compile(r"\.\.\."), "ELLIPSIS_MARKER"),
    (re.compile(r"\("), ""),
    (re.compile(r"\)"), ""),
    (re.compile(r"(\d+)\.(\d+)\$"), r"\1 Dollar und \2 Cent"),
    (re.compile(r"(\d+)\.(\d+)€"), r"\1 Euro und \2 Cent"),
    (re.compile(r"(\d+)\.(\d+)¥"), r"\1 Yen und \2 Sen"),
    (re.compile(r"(?<=\D)\.(?=\D)(?!\s)", re.IGNORECASE), " Punkt "),
    (re.compile(r"(?<=\d)\,(?=\d)(?!\s)"), " Komma "),
    (re.compile(r"€"), " Euro"),
    (re.compile(r"¥"), " Yen"),
    (re.compile(r"Mme"), "Frau"),
    (re.compile(r"Mlle"), "Fräulein"),
    (re.compile(r"="), " gleich "),
    (re.compile(r"/"), " Schrägstrich "),
    (re.compile(r"-(?=\d)(?!\s)"), "minus "),
    (re.compile(r"ELLIPSIS_MARKER"), "..."),
]

_replacements_ja = [
    (re.compile(r"(?<!\s)\.(?!\s)"), " てん"),
    (re.compile(r"-(?=\d)"), " マイナス"),
    (re.compile(r"%"), " パーセント"),
    (re.compile(r"@"), " アットマーク"),
    (re.compile(r"\\\\"), " バックスラッシュ"),
    (re.compile(r"/"), " スラッシュ"),
    (re.compile(r"\$"), " ドル"),
    (re.compile(r"€"), " ユーロ"),
    (re.compile(r"¥"), " えん"),
    (re.compile(r"\+"), " プラス"),
    (re.compile(r"="), " イコール"),
]

_REPLACEMENTS = {
    "en": _replacements_en,
    "fr": _replacements_fr,
    "de": _replacements_de,
    "ja": _replacements_ja,
}


def apply_replacements(text: str, language: str) -> str:
    for regex, replacement in _REPLACEMENTS.get(language, []):
        text = regex.sub(replacement, text)
    return text


def expand_abbreviations(text: str, language: str) -> str:
    for regex, replacement in _ABBREVIATIONS.get(language, []):
        text = regex.sub(replacement, text)
    return text


def lowercase(text: str) -> str:
    return text.lower()


def collapse_whitespace(text: str) -> str:
    return _whitespace_re.sub(" ", text)


# -- phonemizer backends (gated host-side dependencies) ----------------------

_ESPEAK_LANGS = {"en": "en-us", "fr": "fr-fr", "es": "es", "de": "de"}


@lru_cache(maxsize=None)
def _espeak_backend(language: str):
    """Lazily build an espeak backend; None when phonemizer/espeak is absent."""
    try:
        import phonemizer  # type: ignore

        critical_logger = logging.getLogger("phonemizer")
        critical_logger.setLevel(logging.CRITICAL)
        return phonemizer.backend.EspeakBackend(
            language=language,
            preserve_punctuation=True,
            with_stress=True,
            language_switch="remove-flags",
            logger=critical_logger,
        )
    except Exception:  # noqa: BLE001 — any failure → grapheme fallback
        return None


@lru_cache(maxsize=1)
def _japanese_g2p():
    try:
        from misaki import ja  # type: ignore

        return ja.JAG2P()
    except Exception:  # noqa: BLE001
        return None


def phonemizer_backend(language: str = "en") -> str:
    """Which G2P backend is active for a language: 'espeak', 'misaki', or 'grapheme'."""
    if language == "ja":
        return "misaki" if _japanese_g2p() is not None else "grapheme"
    backend = _espeak_backend(_ESPEAK_LANGS.get(language, "en-us"))
    return "espeak" if backend is not None else "grapheme"


_UNKNOWN_CHAR_RE = None

# Letters NFD decomposition can't reduce to ASCII; spelled out the way the
# languages read them aloud.
_TRANSLITERATIONS = {"ß": "ss", "ẞ": "ss", "œ": "oe", "æ": "ae", "ø": "o",
                     "Œ": "oe", "Æ": "ae", "Ø": "o", "ð": "d", "Ð": "d",
                     "þ": "th", "Þ": "th", "ł": "l", "Ł": "l"}


def _strip_accents(text: str) -> str:
    """é→e, ü→u, ñ→n, ß→ss: accented Latin letters transliterate to their
    base letter instead of being dropped by the symbol-table filter."""
    import unicodedata

    out = []
    for ch in text:
        if ch in _TRANSLITERATIONS:
            out.append(_TRANSLITERATIONS[ch])
            continue
        decomposed = unicodedata.normalize("NFD", ch)
        out.append("".join(c for c in decomposed
                           if unicodedata.category(c) != "Mn"))
    return "".join(out)


def _grapheme_fallback(text: str, language: str = "en") -> str:
    """Map text onto the symbol table without a phonemizer: digits
    verbalize in-language (espeak does this itself on the phonemizer path;
    without it the symbol filter would silently drop every number), kana
    transliterate to romaji, accented Latin letters to their base letters,
    anything still outside the table (e.g. kanji) is stripped."""
    from emojivoice_tpu_torch.text.kana import kana_to_romaji
    from emojivoice_tpu_torch.text.numbers import verbalize_numbers
    from emojivoice_tpu_torch.text.symbols import symbols

    text = verbalize_numbers(text, language)
    text = _strip_accents(kana_to_romaji(text)).lower()
    # hyphen sits only in the untrained id range (symbols.py N_VOCAB note);
    # keep the word boundary it marks instead of letting the id filter
    # glue the words together
    text = text.replace("-", " ")
    table = set(symbols)
    return collapse_whitespace("".join(ch for ch in text if ch in table))


def _phonemize(text: str, language: str) -> str:
    backend = _espeak_backend(_ESPEAK_LANGS.get(language, "en-us"))
    if backend is None:
        return _grapheme_fallback(text, language)
    return backend.phonemize([text], strip=True, njobs=1)[0]


# -- public cleaner pipelines (names match the reference) --------------------

def basic_cleaners(text: str) -> str:
    """Lowercase + collapse whitespace, no G2P."""
    return collapse_whitespace(lowercase(text))


def expand_numbers_en(text: str) -> str:
    """Number→words expansion (the reference vendors an unwired inflect
    version; this one is wired — usable standalone in a cleaner list)."""
    from emojivoice_tpu_torch.text.numbers import expand_numbers_en as _expand

    return _expand(text)


def english_cleaners2(text: str) -> str:
    text = lowercase(text)
    text = expand_abbreviations(text, "en")
    text = apply_replacements(text, "en")
    return collapse_whitespace(_phonemize(text, "en"))


def french_cleaners(text: str) -> str:
    text = lowercase(text)
    text = expand_abbreviations(text, "fr")
    text = apply_replacements(text, "fr")
    return collapse_whitespace(_phonemize(text, "fr"))


def german_cleaners(text: str) -> str:
    text = lowercase(text)
    text = expand_abbreviations(text, "de")
    text = apply_replacements(text, "de")
    return collapse_whitespace(_phonemize(text, "de"))


def spanish_cleaners(text: str) -> str:
    text = lowercase(text)
    text = expand_abbreviations(text, "es")
    text = apply_replacements(text, "es")
    return collapse_whitespace(_phonemize(text, "es"))


def japanese_cleaners(text: str) -> str:
    text = apply_replacements(text, "ja")
    g2p = _japanese_g2p()
    if g2p is None:
        return collapse_whitespace(_grapheme_fallback(text, "ja"))
    return collapse_whitespace(g2p(text)[0])


# Language → cleaner dispatch.  The reference duplicates this map at every
# call site (cli.py:39-45, feel_me.py:135-141, ...); here it is the single
# source of truth.
LANGUAGE_CLEANERS = {
    "en": english_cleaners2,
    "fr": french_cleaners,
    "de": german_cleaners,
    "es": spanish_cleaners,
    "ja": japanese_cleaners,
}


def get_cleaner(name: str):
    fn = globals().get(name)
    if fn is None or not callable(fn):
        raise KeyError(f"Unknown cleaner: {name}")
    return fn
