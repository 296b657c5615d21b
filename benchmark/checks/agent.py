"""The comparison that decides ``correct`` for the agent's turns: the tokens
Whisper and the chat LM served, held against the plain references'
(``reference/whisper.py``, ``reference/gptj.py``) logits over the same
inputs and the same served tokens; and the reply's speech as the sink got
it, held against the synthesis reference (``reference/matcha.py``).

For each judged turn the reference runs once over the recording's features
and the start token with Whisper's served tokens, and once over the prompt
the chat LM was given with its served reply.  At every step it reads the
gap by which the served token's logit lies below the best the rules allow:
the best of all where the token was chosen greedily (Whisper always; the
chat LM in the greedy sessions), the ``top_k``-th best where it was sampled
(it must lie in the kept set).  Whisper's step rules are the configuration's
(its begin-suppressed tokens at the first step).  The features are
transformers' ``WhisperFeatureExtractor`` of the recording, as the adapter
makes them.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from benchmark.checks.tts import TIE, fix_len, noise
from benchmark.configs.agent_whisper_gptj6b import StubTokenizer
from benchmark.reference import gptj as ref_gptj
from benchmark.reference import matcha as ref_tts
from benchmark.reference import whisper as ref_whisper
from benchmark.reference.precision import tf32
from benchmark.traffic.generate import EMOJI_SPEAKERS, split_text


def _features(wav: np.ndarray, sample_rate: int, n_mels: int) -> np.ndarray:
    import os

    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_TF", "0")
    from transformers import WhisperFeatureExtractor

    fe = WhisperFeatureExtractor(feature_size=n_mels)
    return fe(wav, sampling_rate=sample_rate, return_tensors="np").input_features[0]


def _gap(logits, tokens, kth: int = 1):
    """Per step, how far the token's logit lies below the `kth` best (0 at or above it)."""
    bar = logits.topk(kth, dim=-1).values[:, -1]
    got = logits[torch.arange(len(tokens)), torch.as_tensor(tokens, device=logits.device)]
    return torch.clamp_min(bar - got, 0.0)


def asr_gap(cfg: dict, sd: dict, turns: list, control: bool = False) -> tuple:
    """(the widest gap of Whisper's served tokens, and with `control` the
    widest gap of the tokens the reference in TF32 puts first at the same
    positions)."""
    w, gen = cfg["whisper"], cfg["whisper_generation"]
    eos = gen["eos_token_id"]
    worst = low = 0.0
    for t in turns:
        seq = t["asr_ids"]
        served = []
        for tok in seq[1:]:
            served.append(tok)
            if tok == eos:
                break
        feats = _features(t["wav"], cfg["asr"]["sample_rate"], w["num_mel_bins"])

        def logits():
            x = ref_whisper.logits(sd, w, feats, [seq[0]] + served[:-1])
            x[0, gen["begin_suppress_tokens"]] = -torch.inf
            return x
        x = logits()
        worst = max(worst, float(_gap(x, served).max()))
        if control:
            with tf32(True):
                first = logits().argmax(-1)
            low = max(low, float(_gap(x, first.tolist()).max()))
    return worst, low


def llm_gap(cfg: dict, sd: dict, turns: list, control: bool = False) -> tuple:
    """(the widest gap of the chat LM's served tokens: below the best where
    greedy, below the ``top_k``-th where sampled; and with `control` the
    same reading of the tokens the reference in TF32 puts first, at the
    same positions: those of the served replies)."""
    k = cfg["llm_generation"]["top_k"]
    worst = low = 0.0
    for t in turns:
        prompt, reply = t["prompt_ids"], t["reply_ids"]
        if not reply:
            continue
        ids, first, kth = prompt + reply[:-1], len(prompt) - 1, 1 if t["greedy"] else k
        x = ref_gptj.logits(sd, cfg["llm"], ids, first=first)
        worst = max(worst, float(_gap(x, reply, kth).max()))
        if control:
            with tf32(True):
                top = ref_gptj.logits(sd, cfg["llm"], ids, first=first).argmax(-1)
            low = max(low, float(_gap(x, top.tolist(), kth).max()))
    return worst, low


GAP_SAMPLES = int(0.15 * 22050)  # the silence the pipelined playback puts between segments


def _spoken(reply_ids: list, word, mapping: dict) -> tuple:
    """(speaker, text) the agent speaks for a reply: the stub's words, the
    first emoji of the voice mapping picks the voice (else 0), emojis and
    round brackets stripped, "nice" for an empty reply."""
    words = [word(i) for i in reply_ids if 2 < i < 50256]
    response = " ".join(words).strip()
    spk = next((mapping[c] for c in response if c in mapping), 0)
    text = "".join(c for c in response if c not in mapping).replace(")", "").replace("(", "").strip()
    return spk, text or "nice"


def speech_err(cfg: dict, weights: tuple, turns: list, device, control: bool = False) -> dict:
    """The largest difference between the speech the sink got and the
    reference's, over `turns`: each segment of the spoken reply (split at
    ``segment_chars``) synthesised at batch 1 with the noise seed the
    pipeline drew for it from numpy's generator, seeded before the turn;
    the segments joined by the playback's silence.  At the speaking rate's
    scale a segment's frame count is the integer part of a float32 sum of
    multiples of it, which two summation orders can put on either side of
    a whole number: such a segment takes either count, and the counts whose
    audio has the served length are tried.  A length no count gives reads 1;
    a turn with a duration on a whole frame is skipped."""
    tts, a = cfg["tts"], cfg["agent"]
    model, voc, s = tts["model"], tts["vocoder"], tts["synthesis"]
    sd, vsd = weights
    hop = int(np.prod(voc["upsample_rates"]))
    bias = ref_tts.bias_spectrum(vsd, voc, model["n_feats"])
    ls = a["speaking_rate"]

    def segment(enc, y_len, seed):
        mu, _, wc, _, spk_e = enc
        m = next(b for b in s["mel_buckets"] if b >= fix_len(y_len))
        z = noise(seed, m, model["n_feats"], a["temperature"], device)
        wav = ref_tts.vocode(vsd, voc, ref_tts.decode(sd, model, mu, wc, y_len, m, z, a["steps"], spk_e))
        return ref_tts.denoise(wav, bias, a["denoiser_strength"])[: y_len * hop].cpu().numpy()

    def speak(encs, lens, seeds):
        parts = []
        for k, (enc, y_len, seed) in enumerate(zip(encs, lens, seeds)):
            parts.append(segment(enc, y_len, seed))
            if k < len(encs) - 1:
                parts.append(np.zeros(GAP_SAMPLES, np.float32))
        return np.concatenate(parts)

    out = dict(speech_err=0.0, speech_judged=0, speech_ties=0)
    if control:
        out["control_speech_err"] = 0.0
    for t in turns:
        spk, text = _spoken(t["reply_ids"], StubTokenizer().word, EMOJI_SPEAKERS)
        segments = split_text(text, a["segment_chars"])
        rs = np.random.RandomState(t["turn_seed"])
        seeds = [int(rs.randint(0, 2**31)) for _ in segments]
        encs = [ref_tts.encode(sd, model, ref_tts.text_ids(seg), spk, ls) for seg in segments]
        if any(bool((torch.abs(e[1] - torch.round(e[1])) < TIE).any()) for e in encs):
            out["speech_ties"] += 1
            continue
        options = []
        for e in encs:
            total = float(e[2].double().sum())
            n = round(total)
            options.append(sorted({e[3], n, n - 1}) if abs(total - n) < 1e-3 else [e[3]])
        got = np.asarray(t["speech"], np.float32)
        fits = [lens for lens in itertools.product(*options)
                if hop * sum(lens) + GAP_SAMPLES * (len(lens) - 1) == len(got)]
        out["speech_judged"] += 1
        if not fits:
            out["speech_err"] = 1.0
            continue
        errs = {lens: float(np.abs(speak(encs, lens, seeds) - got).max()) for lens in fits}
        lens = min(errs, key=errs.get)
        out["speech_err"] = max(out["speech_err"], errs[lens])
        if control:
            want = speak(encs, lens, seeds)
            with tf32(True):
                low_encs = [ref_tts.encode(sd, model, ref_tts.text_ids(seg), spk, ls) for seg in segments]
                same = [le[3] == e[3] for le, e in zip(low_encs, encs)]
                low = speak(low_encs, lens, seeds) if all(same) else None
            out["control_speech_err"] = max(out["control_speech_err"],
                                            1.0 if low is None else float(np.abs(low - want).max()))
    return out
