"""Long-form synthesis: sentence-split → per-segment synthesis (PyTorch port
of ``emojivoice_tpu_torch.inference.longform``).

The acoustic model is utterance-scale (quadratic attention, bucketed
shapes); long texts are split at sentence punctuation into segments that
fit the largest text bucket, synthesized segment-by-segment (at shapes the
pipeline has already warmed), and concatenated with a short silence gap.
Per-segment emoji cues switch the voice inline.
"""

from __future__ import annotations

import re
from typing import Iterator, List, Optional

import numpy as np

_SENTENCE_RE = re.compile(r"(?<=[.!?…])\s+")


def split_text(text: str, max_chars: int = 200) -> List[str]:
    """Split into sentences, then re-pack greedily up to max_chars (so short
    sentences share one synthesis call)."""
    sentences = [s.strip() for s in _SENTENCE_RE.split(text.strip()) if s.strip()]
    # hard-split any sentence that alone exceeds max_chars (commas, then spaces)
    pieces: List[str] = []
    for s in sentences:
        while len(s) > max_chars:
            cut = s.rfind(",", 0, max_chars)
            if cut < max_chars // 2:
                cut = s.rfind(" ", 0, max_chars)
            if cut <= 0:
                cut = max_chars
            pieces.append(s[:cut].strip())
            s = s[cut:].lstrip(", ")
        if s:
            pieces.append(s)
    # greedy re-pack
    out: List[str] = []
    buf = ""
    for p in pieces:
        if buf and len(buf) + 1 + len(p) <= max_chars:
            buf = f"{buf} {p}"
        else:
            if buf:
                out.append(buf)
            buf = p
    if buf:
        out.append(buf)
    return out


def synthesise_longform(
    pipeline,
    text: str,
    spk: int = 0,
    emoji_voices: bool = False,
    gap_seconds: float = 0.15,
    language: Optional[str] = None,
    max_chars: int = 200,
    **synth_kw,
) -> np.ndarray:
    """Full long text → one concatenated waveform."""
    chunks = list(stream_longform(pipeline, text, spk, emoji_voices, gap_seconds,
                                  language, max_chars, **synth_kw))
    return np.concatenate(chunks) if chunks else np.zeros(0, np.float32)


def _prepare_segments(text: str, spk: int, emoji_voices: bool, max_chars: int):
    from emojivoice_tpu_torch.apps.emoji import parse_emoji_response

    out = []
    for seg in split_text(text, max_chars):
        seg_spk = spk
        if emoji_voices:
            seg_spk, seg = parse_emoji_response(seg, default_spk=spk)
            if not seg:
                continue
        out.append((seg_spk, seg))
    return out


def stream_longform(
    pipeline,
    text: str,
    spk: int = 0,
    emoji_voices: bool = False,
    gap_seconds: float = 0.15,
    language: Optional[str] = None,
    max_chars: int = 200,
    **synth_kw,
) -> Iterator[np.ndarray]:
    """Yield waveform per segment (streaming long-form playback).

    Dispatch-ahead pipelining: segment i+1 is ENQUEUED (synthesise_async)
    before segment i's outputs are fetched, so the device computes the next
    segment while the host consumes, or plays, the current one.  The
    consumer's time-to-first-audio is one SHORT-segment synthesis, not the
    full text's."""
    sr = 22050
    gap = np.zeros(int(gap_seconds * sr), np.float32)
    segments = _prepare_segments(text, spk, emoji_voices, max_chars)
    pending = None
    for i, (seg_spk, seg) in enumerate(segments):
        nxt = pipeline.synthesise_async([seg], spks=[seg_spk], language=language,
                                        **synth_kw)
        if pending is not None:
            res = pipeline.finalize(pending)[0]
            yield np.concatenate([res.wav, gap])
        pending = nxt
    if pending is not None:
        res = pipeline.finalize(pending)[0]
        yield res.wav


def play_longform(
    pipeline,
    text: str,
    sink,
    spk: int = 0,
    emoji_voices: bool = False,
    gap_seconds: float = 0.15,
    language: Optional[str] = None,
    max_chars: int = 200,
    on_first_audio=None,
    **synth_kw,
) -> int:
    """Speak segment i while segment i+1 synthesizes.

    The conversational-latency primitive: sink.play
    blocks for the audio's real duration, which is far longer than a short
    segment's synthesis (RTF « 1), so after the first segment the device
    is always ahead of the speaker and the audible stream has no gaps.
    First audio starts after ONE short-segment synthesis instead of the
    whole reply's.  Returns the number of segments spoken;
    ``on_first_audio()`` fires just before the first play (time-to-first-audio probes).
    """
    n = 0
    for chunk in stream_longform(pipeline, text, spk, emoji_voices, gap_seconds,
                                 language, max_chars, **synth_kw):
        if n == 0 and on_first_audio is not None:
            on_first_audio()
        sink.play(chunk, 22050)
        n += 1
    return n
