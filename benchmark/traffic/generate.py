"""The one traffic generator: a mix's data file and a seed → the inputs of a
run.

Every seed gets the same sizes, gaps and voices in the same order: the
lengths, inter-arrival gaps, speakers and recording lengths are drawn from
the mix's ``base_seed``; the words of each text and the samples of each
recording come from the run's seed.  So two seeds offer the same work with
other content (the model's weights, drawn from the seed too, differ).

Kinds of mix (``"kind"`` in the file):

* ``replies``: LLM-style replies with a trailing emoji cue, for a TTS service
  (``sentences``, ``chars``, the emoji speakers' Zipf skew; ``arrivals``:
  Poisson at ``rate_per_s``, as many requests as the window needs).
* ``story``: a long story cut into segments by ``split_text`` (``chars``,
  ``max_chars``), dealt into batches of ``batch`` segments.
* ``sessions``: an agent's conversations: ``turns`` per session, a recorded
  utterance of ``audio_s`` seconds per turn at ``sample_rate``.

Texts use lower-case words from ``WORDS`` (no digits, no abbreviations, no
marks but ``, . ! ?``), so the served front end and the reference's read
them alike.
"""

from __future__ import annotations

import hashlib
import json
import math
import random
import re
from pathlib import Path
from typing import Dict, List

import numpy as np

TRAFFIC_DIR = Path(__file__).resolve().parent

# the 11 emoji voices of the emojivoice agent (its EMOJI_MAPPING), most frequent first for the Zipf skew
EMOJI_SPEAKERS: Dict[str, int] = {
    "🙂": 12, "😁": 18, "🤔": 17, "😮": 54, "😍": 107, "🤣": 15, "😅": 22, "😎": 79, "🙄": 66, "😭": 103, "😡": 58,
}

WORDS = """the a robot story sea ship wind cloud river forest mountain light night morning friend
little big old new happy quiet brave bright dark gentle curious silly tired hungry strange lucky
walk run jump sing dance laugh listen look find build carry follow remember wonder dream play
we you they she he it i my your our their this that there here now then again always never
and but so because when while after before until if or with without under over near far away
castle garden kitchen window door bridge road village market tower island cave desert meadow
dragon cat dog bird fish horse rabbit fox owl bear turtle mouse wolf whale frog lion
red blue green golden silver purple yellow orange white black warm cold soft loud slow fast
said asked told whispered shouted smiled waited opened closed found lost made saw heard felt
one two three many some every each all none both most few several other another same
apple bread cake soup tea honey berry cookie pie cheese milk water juice candy pepper
today tomorrow yesterday soon later early late once twice often sometimes rarely
time day year moment minute hour week season summer winter spring autumn
song game book map key box lamp boat kite ball drum bell hat coat shoe ring
think know believe hope wish try want need like love hate help keep give take
very really quite almost just only even still also too enough rather perhaps maybe
is are was were be been being have has had do does did can could will would shall should
of to in on at by for from into onto about around through across along behind beside
""".split()

SENTENCE_ENDS = ".!?"
_SENTENCE_RE = re.compile(r"(?<=[.!?…])\s+")


def sub_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed that depends on the run's seed and the purpose."""
    digest = hashlib.blake2b(f"{int(seed)}:{purpose}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") & (2**63 - 1)


def load(name: str, directory: Path = TRAFFIC_DIR) -> dict:
    return json.loads((Path(directory) / f"{name}.json").read_text())


def split_text(text: str, max_chars: int = 200) -> List[str]:
    """Sentences re-packed greedily up to max_chars (a copy of the program's
    ``inference/longform.py::split_text``)."""
    sentences = [s.strip() for s in _SENTENCE_RE.split(text.strip()) if s.strip()]
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


def _sentence(rng: random.Random, n_chars: int) -> str:
    """A sentence of about `n_chars` characters, its end mark included."""
    words: List[str] = []
    length = 0
    while True:
        w = rng.choice(WORDS)
        if words and length + 1 + len(w) + 1 > n_chars:
            break
        words.append(w)
        length += len(w) + (1 if len(words) > 1 else 0)
        if len(words) >= 3 and rng.random() < 0.08 and length + 2 < n_chars:
            words[-1] += ","
            length += 1
    words[0] = words[0].capitalize()
    words[-1] = words[-1].rstrip(",")
    return " ".join(words) + rng.choice(SENTENCE_ENDS)


def reply_text(rng: random.Random, n_chars: int, n_sentences: int) -> str:
    """Sentences summing to about `n_chars` characters."""
    per = max(8, n_chars // n_sentences)
    return " ".join(_sentence(rng, per) for _ in range(n_sentences))


def _zipf(rng: random.Random, n_items: int, count: int, s: float) -> List[int]:
    weights = [1.0 / (k + 1) ** s for k in range(n_items)]
    return rng.choices(range(n_items), weights=weights, k=count)


def replies(mix: dict, seed: int, seconds: float) -> dict:
    """Requests: (due seconds, text, speaker id, noise seed), due within
    ``seconds``; and ``warm`` requests for the settle pass before the window."""
    base = random.Random(mix["base_seed"])
    rate = float(mix["arrivals"]["rate_per_s"])
    n = int(math.ceil(rate * seconds * 1.6)) + 64
    gaps = [base.expovariate(rate) for _ in range(n)]
    lens = [base.randint(*mix["chars"]) for _ in range(n)]
    sents = [base.randint(*mix["sentences"]) for _ in range(n)]
    emojis = list(EMOJI_SPEAKERS)
    spk = _zipf(base, len(emojis), n, mix["speakers"]["zipf_s"])
    words = random.Random(sub_seed(seed, "words"))
    noise = sub_seed(seed, "noise") % (2**31)
    out, t = [], 0.0
    for i in range(n):
        t += gaps[i]
        e = emojis[spk[i]]
        text = reply_text(words, lens[i] - 2, min(sents[i], max(1, lens[i] // 12)))
        out.append(dict(due=t, text=f"{text} {e}", spk=EMOJI_SPEAKERS[e], seed=(noise + i) % (2**31),
                        chars=lens[i]))
    window = [r for r in out if r["due"] < seconds]
    warm = out[len(window):len(window) + int(mix.get("warm_requests", 16))]
    return dict(requests=window, warm=warm, rate_per_s=rate)


def story(mix: dict, seed: int, seconds: float) -> dict:
    """Batches of story segments: (texts, speaker ids, noise seeds)."""
    base = random.Random(mix["base_seed"])
    n_batches = int(mix["batches"])
    b = int(mix["batch"])
    lo, hi = mix["sentence_chars"]
    sent_lens = [base.randint(lo, hi) for _ in range(n_batches * b * 4)]
    emojis = list(EMOJI_SPEAKERS)
    spk = _zipf(base, len(emojis), n_batches * b, mix["speakers"]["zipf_s"])
    words = random.Random(sub_seed(seed, "words"))
    text = " ".join(_sentence(words, n) for n in sent_lens)
    segs = [s for s in split_text(text, mix["max_chars"]) if len(s) >= mix["min_chars"]]
    noise = sub_seed(seed, "noise") % (2**31)
    batches = []
    for k in range(n_batches):
        rows = segs[k * b:(k + 1) * b]
        if len(rows) < b:
            break
        batches.append(dict(texts=rows, spks=[EMOJI_SPEAKERS[emojis[s]] for s in spk[k * b:(k + 1) * b]],
                            seeds=[(noise + k * b + i) % (2**31) for i in range(b)]))
    return dict(batches=batches[1:], warm=batches[:1])


def sessions(mix: dict, seed: int, seconds: float) -> dict:
    """Sessions of turns, each a recording (float32 samples at
    ``sample_rate``): a few tones under noise, as loud as speech."""
    base = random.Random(mix["base_seed"])
    n_sessions, turns = int(mix["sessions"]), int(mix["turns"])
    lo, hi = mix["audio_s"]
    durs = [base.uniform(lo, hi) for _ in range(n_sessions * turns)]
    rng = np.random.default_rng(sub_seed(seed, "audio"))
    sr = int(mix["sample_rate"])
    out = []
    for s in range(n_sessions + 1):  # the first session warms up
        rows = []
        for k in range(turns):
            d = durs[(s * turns + k) % len(durs)]
            n = int(d * sr)
            t = np.arange(n) / sr
            freqs = rng.uniform(100, 900, size=3)
            wav = sum(np.sin(2 * np.pi * f * t + rng.uniform(0, 6.28)) for f in freqs) / 3
            wav = 0.3 * wav * (0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(1, 4) * t)) + 0.02 * rng.standard_normal(n)
            rows.append(wav.astype(np.float32))
        out.append(rows)
    return dict(sessions=out[1:], warm=out[0], sample_rate=sr,
                greedy_every=int(mix.get("greedy_every", 2)))


KINDS = {"replies": replies, "story": story, "sessions": sessions}


def make(name: str, seed: int, seconds: float, directory: Path = TRAFFIC_DIR) -> dict:
    mix = load(name, directory)
    return dict(KINDS[mix["kind"]](mix, seed, seconds), mix=mix)
