"""Emoji → speaker-voice conditioning (the port's own copy of the JAX
package's ``apps/emoji.py``; ``tests/test_torch_import.py`` holds the two
mappings equal).

The emojivoice convention (reference: /feel_me.py:84-111): each of 11
emojis is one fine-tuned speaker id in the multi-speaker (n_spks=109)
checkpoint; the LLM is instructed to end each reply with exactly one of
them, and the *first mapped* emoji in the reply selects the voice
(feel_me.py:299-308), default speaker 0 otherwise.  Emojis and brackets
are stripped before synthesis (feel_me.py:309-312).

Emoji detection is implemented over Unicode ranges (the reference uses the
``emoji`` package; same behavior for the plane-1 symbol blocks LLMs emit).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

# Female voices (Paige checkpoint) — reference feel_me.py:84-96
EMOJI_MAPPING: Dict[str, int] = {
    "😍": 107,
    "😡": 58,
    "😎": 79,
    "😭": 103,
    "🙄": 66,
    "😁": 18,
    "🙂": 12,
    "🤣": 15,
    "😮": 54,
    "😅": 22,
    "🤔": 17,
}

# Male voices (Zach checkpoint) — reference feel_me.py:98-111 (commented
# alternative) and case_studies/case3_game/main.py:111-123
EMOJI_MAPPING_MALE: Dict[str, int] = {
    "😍": 4,
    "😡": 5,
    "😎": 6,
    "😭": 13,
    "🙄": 16,
    "😁": 26,
    "🙂": 30,
    "🤣": 38,
    "😮": 60,
    "😅": 82,
    "🤔": 97,
}

EMOJI_NAMES = {
    "😍": "love", "😡": "anger", "😎": "confident", "😭": "sadness",
    "🙄": "sarcastic", "😁": "excited", "🙂": "neutral", "🤣": "laughing",
    "😮": "surprised", "😅": "awkward", "🤔": "thinking",
}

_EMOJI_RANGES = (
    (0x1F300, 0x1FAFF),  # symbols & pictographs, incl. emoticons, suppl.
    (0x2600, 0x27BF),    # misc symbols + dingbats
    (0x2190, 0x21FF),    # arrows (occasionally emitted)
    (0x2B00, 0x2BFF),
    (0xFE00, 0xFE0F),    # variation selectors
    (0x1F1E6, 0x1F1FF),  # regional indicators
    (0x200D, 0x200D),    # zero-width joiner
)


def is_emoji(ch: str) -> bool:
    cp = ord(ch)
    return any(lo <= cp <= hi for lo, hi in _EMOJI_RANGES)


def strip_emoji(text: str, replace: str = "") -> str:
    """Drop (or replace) every emoji codepoint.

    >>> strip_emoji("so cool 😎!")
    'so cool !'
    """
    return "".join(replace if is_emoji(c) else c for c in text)


def parse_emoji_response(
    response: str,
    mapping: Optional[Dict[str, int]] = None,
    default_spk: int = 0,
) -> Tuple[int, str]:
    """LLM reply → (speaker id, cleaned text).

    First mapped emoji wins (reference: feel_me.py:299-308); emojis and
    round brackets are stripped (feel_me.py:309-312); empty text falls back
    to "nice" at the caller (feel_me.py:315-317).

    >>> parse_emoji_response("That's great! 😎")
    (79, "That's great!")
    >>> parse_emoji_response("no emoji here")
    (0, 'no emoji here')
    """
    mapping = mapping if mapping is not None else EMOJI_MAPPING
    spk = default_spk
    for ch in response:
        if is_emoji(ch) and ch in mapping:
            spk = mapping[ch]
            break
    text = strip_emoji(response)
    text = text.replace(")", "").replace("(", "").strip()
    return spk, text


def segment_by_emoji(text: str, mapping: Optional[Dict[str, int]] = None,
                     default_spk: int = 0):
    """Split a multi-emoji text into (spk, segment) pairs — each segment is
    voiced by the emoji that terminates it (used by the storytelling demos,
    reference: hri-demo/storytelling/demo_story_script.py:162-193 processes
    one line per emoji; this generalizes to inline switching).

    >>> segment_by_emoji("Once upon a time 🙂 a dragon roared 😡 the end")
    [(12, 'Once upon a time'), (58, 'a dragon roared'), (0, 'the end')]
    """
    mapping = mapping if mapping is not None else EMOJI_MAPPING
    segments = []
    buf = []
    for ch in text:
        if is_emoji(ch):
            if ch in mapping and "".join(buf).strip():
                segments.append((mapping[ch], "".join(buf).strip()))
                buf = []
        else:
            buf.append(ch)
    if "".join(buf).strip():
        segments.append((default_spk, "".join(buf).strip()))
    return segments
