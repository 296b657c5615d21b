"""A synthetic *alignable* wav corpus for training runs and tests (the
dataset part of the JAX package's ``training/scratch_proof.py``).

Every character is rendered as a tone whose pitch is keyed by the character
and whose length is keyed by its class, so the audio has a TRUE monotonic
text↔mel alignment with near-uniform per-token durations — the structure
MAS must discover.  Speakers differ by timbre and tempo.  numpy and
``scipy.io.wavfile`` only; everything is made from seeds.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

# lowercase ascii only: basic_cleaners lowercases + collapses whitespace, so
# the rendered audio and the cleaned token stream stay 1:1
ALIGN_TEXTS = [
    "the robot tells a story",
    "a brave little voice sings",
    "hello from the green island",
    "we walk down to the harbor",
    "rain falls on the tin roof",
    "the kettle sings so softly",
    "count the seven silver stars",
    "an old door creaks open",
    "waves brush over the sand",
    "morning light arrives early",
]

_VOWELS = set("aeiou")

_CONNECTORS = (" and ", " then ", " while ", " until ", " because ")


def make_texts(n: int, seed: int = 0):
    """n deterministic texts with a WIDE length spread: 1–4 base phrases
    joined by connectors.  Lengths span ~25 to ~120 chars, which at the
    renderer's ~0.11 s/char covers ~2.5–13 s of audio → mel lengths across
    four buckets (256/512/768/1024), so the corpus exercises MAS at several
    T_text×T_mel shapes instead of one."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = 1 + (i % 4)  # 1..4 phrases, uniformly cycled
        parts = [ALIGN_TEXTS[int(rng.integers(len(ALIGN_TEXTS)))] for _ in range(k)]
        text = parts[0]
        for ptxt in parts[1:]:
            text += _CONNECTORS[int(rng.integers(len(_CONNECTORS)))] + ptxt
        out.append(text)
    return out


def _char_f0(c: str) -> float:
    """Deterministic character→pitch map over two octaves — a wide spread
    keeps adjacent characters' spectra far apart, so the Gaussian log-prior
    discriminates tokens sharply and MAS has an unambiguous best path."""
    return 110.0 * 2.0 ** ((ord(c) * 7) % 24 / 12.0)


def _char_dur(c: str) -> float:
    if c == " ":
        return 0.06
    return 0.16 if c in _VOWELS else 0.10


def render_utterance(text: str, spk: int, sample_rate: int = 22050,
                     seed: int = 0) -> np.ndarray:
    """Melodic spelling: each character becomes a tone segment with an
    attack/decay envelope; speakers differ by harmonic timbre and speaking
    rate.  The true alignment is monotonic with per-character durations
    known by construction — exactly the structure MAS must discover."""
    rng = np.random.default_rng(seed * 1000 + spk)
    rate = 1.0 + 0.12 * ((spk % 5) - 2) / 2.0  # speaker-consistent tempo
    # speaker timbre: harmonic amplitude rolloff
    rolloff = 1.2 + (spk % 7) / 6.0
    segs = []
    for c in text:
        dur = _char_dur(c) * rate * (1.0 + 0.03 * rng.normal())
        n = max(8, int(dur * sample_rate))
        t = np.arange(n) / sample_rate
        if c == " ":
            segs.append(0.003 * rng.normal(size=n).astype(np.float32))
            continue
        f0 = _char_f0(c)
        tone = sum((0.5 / h ** rolloff) * np.sin(2 * np.pi * f0 * h * t)
                   for h in (1, 2, 3))
        # attack/decay so segment boundaries are visible in the mel
        env = np.minimum(1.0, np.minimum(t / 0.012, (t[-1] - t + 1e-6) / 0.03))
        segs.append((tone * env).astype(np.float32))
    wav = np.concatenate(segs)
    wav = 0.7 * wav / max(1e-6, np.abs(wav).max())
    return (wav + 0.004 * rng.normal(size=wav.shape)).astype(np.float32)


def make_alignable_dataset(root: Path, speakers, n_utts: int = 20,
                           sample_rate: int = 22050, seed: int = 0,
                           long_texts: bool = False):
    """``long_texts=True`` draws from make_texts (1–4 joined phrases, wide
    length spread over several mel buckets); False keeps the short
    single-phrase corpus (CPU-test scale)."""
    from scipy.io import wavfile

    wav_dir = root / "wavs"
    wav_dir.mkdir(parents=True, exist_ok=True)
    texts = make_texts(n_utts, seed) if long_texts else None
    rows = []
    stats = {"chars": [], "seconds": []}
    for i in range(n_utts):
        spk = speakers[i % len(speakers)]
        text = texts[i] if long_texts else ALIGN_TEXTS[i % len(ALIGN_TEXTS)]
        wav = render_utterance(text, spk, sample_rate, seed=seed + i)
        path = wav_dir / f"u{i}.wav"
        wavfile.write(path, sample_rate, wav)
        rows.append(f"{path}|{spk}|{text}")
        stats["chars"].append(len(text))
        stats["seconds"].append(len(wav) / sample_rate)
    train = root / "train.txt"
    train.write_text("\n".join(rows) + "\n")
    val = root / "val.txt"
    val.write_text("\n".join(rows[:2]) + "\n")
    corpus_stats = {
        "n_utts": n_utts, "n_speakers": len(set(speakers)),
        "chars_min": int(np.min(stats["chars"])),
        "chars_max": int(np.max(stats["chars"])),
        "chars_mean": round(float(np.mean(stats["chars"])), 1),
        "audio_s_total": round(float(np.sum(stats["seconds"])), 1),
        "audio_s_min": round(float(np.min(stats["seconds"])), 2),
        "audio_s_max": round(float(np.max(stats["seconds"])), 2),
    }
    return train, val, corpus_stats
