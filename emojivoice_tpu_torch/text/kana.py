"""Kana → romaji transliteration for the Japanese grapheme fallback.

The reference pipeline requires misaki for Japanese G2P (it has no fallback
at all); when misaki is absent this module keeps `japanese_cleaners` useful
by transliterating kana to Hepburn-style romaji, which maps onto the ASCII
rows of the 198-entry symbol table.  Kanji have no dictionary-free reading
and are dropped by the symbol-table filter downstream (documented
limitation of the fallback — install misaki for real Japanese G2P).

Pure data + a linear scan: no dependencies, deterministic.
"""

from __future__ import annotations

_HIRAGANA = {
    "あ": "a", "い": "i", "う": "u", "え": "e", "お": "o",
    "か": "ka", "き": "ki", "く": "ku", "け": "ke", "こ": "ko",
    "が": "ga", "ぎ": "gi", "ぐ": "gu", "げ": "ge", "ご": "go",
    "さ": "sa", "し": "shi", "す": "su", "せ": "se", "そ": "so",
    "ざ": "za", "じ": "ji", "ず": "zu", "ぜ": "ze", "ぞ": "zo",
    "た": "ta", "ち": "chi", "つ": "tsu", "て": "te", "と": "to",
    "だ": "da", "ぢ": "ji", "づ": "zu", "で": "de", "ど": "do",
    "な": "na", "に": "ni", "ぬ": "nu", "ね": "ne", "の": "no",
    "は": "ha", "ひ": "hi", "ふ": "fu", "へ": "he", "ほ": "ho",
    "ば": "ba", "び": "bi", "ぶ": "bu", "べ": "be", "ぼ": "bo",
    "ぱ": "pa", "ぴ": "pi", "ぷ": "pu", "ぺ": "pe", "ぽ": "po",
    "ま": "ma", "み": "mi", "む": "mu", "め": "me", "も": "mo",
    "や": "ya", "ゆ": "yu", "よ": "yo",
    "ら": "ra", "り": "ri", "る": "ru", "れ": "re", "ろ": "ro",
    "わ": "wa", "ゐ": "i", "ゑ": "e", "を": "o", "ん": "n",
    "ぁ": "a", "ぃ": "i", "ぅ": "u", "ぇ": "e", "ぉ": "o",
    "ゔ": "vu", "ゎ": "wa",
}

_SMALL_Y = {"ゃ": "ya", "ゅ": "yu", "ょ": "yo"}
_SMALL_V = {"ぁ": "a", "ぃ": "i", "ぅ": "u", "ぇ": "e", "ぉ": "o"}

_JA_PUNCT = {
    "、": ", ", "。": ". ", "・": " ", "ー": "",  # ー handled separately
    "「": '"', "」": '"', "『": '"', "』": '"',
    "？": "?", "！": "!", "　": " ", "〜": " ", "～": " ",
}

_VOWELS = "aeiou"


def _fold_katakana(ch: str) -> str:
    o = ord(ch)
    if 0x30A1 <= o <= 0x30F6:  # katakana block → hiragana twin
        return chr(o - 0x60)
    return ch


def kana_to_romaji(text: str) -> str:
    """Hepburn-ish transliteration: digraphs (きゃ→kya, しゃ→sha), sokuon
    gemination (って→tte, っち→tchi), long-vowel mark (カー→kaa).  Characters
    outside kana/JA-punctuation pass through unchanged."""
    chars = [_fold_katakana(c) for c in text]
    out: list[str] = []
    geminate = False
    i = 0
    while i < len(chars):
        ch = chars[i]
        if ch == "っ":
            geminate = True
            i += 1
            continue
        if ch == "ー":
            for prev in reversed("".join(out)):
                if prev in _VOWELS:
                    out.append(prev)
                    break
            i += 1
            continue
        rom = None
        if ch in _HIRAGANA and i + 1 < len(chars):
            base, nxt = _HIRAGANA[ch], chars[i + 1]
            if nxt in _SMALL_Y and base.endswith("i") and len(base) > 1:
                head, y = base[:-1], _SMALL_Y[nxt]
                # sh/ch/j absorb the y: しゃ→sha, ちゃ→cha, じゃ→ja
                rom = head + (y[1:] if head in ("sh", "ch", "j") else y)
                i += 1  # consumed the small-y char
            elif nxt in _SMALL_V and len(base) > 1 and base[-1] in _VOWELS:
                # foreign-sound digraphs: ヴァ→va, ファ→fa, ティ→ti, チェ→che
                rom = base[:-1] + _SMALL_V[nxt]
                i += 1
        if rom is None:
            rom = _HIRAGANA.get(ch)
        if rom is None:
            out.append(_JA_PUNCT.get(ch, ch))
            geminate = False
            i += 1
            continue
        if geminate:
            out.append("t" if rom.startswith("ch") else rom[0])
            geminate = False
        out.append(rom)
        i += 1
    return "".join(out)
