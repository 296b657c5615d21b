"""The comparison that decides ``correct`` for served synthesis: each sampled
request's audio, as the program delivered it, against the plain reference
(``reference/matcha.py``) on the same text, voice, noise seed and speaking
rate, at the timed sizes.

The reference draws the request's noise as the pipeline's contract fixes it
(a generator on the card seeded with the request's seed, one normal per
frame and mel channel, times the temperature) and decodes at the mel
capacity the request was served at.  That capacity is the batch's, which the
engine chose: the reference takes each capacity from the row's own up to
the largest and keeps the closest answer (a row's audio at another capacity
differs by orders of magnitude more than the limit, since padded frames
enter the decoder's attention with a bias of -1).  A row whose predicted
durations lie within ``TIE`` of a whole frame is left out and another drawn
in its place: there the ceiling of two correct float32 answers can differ.
"""

from __future__ import annotations

import math
import random

import numpy as np
import torch

from benchmark.reference import matcha as ref
from benchmark.reference.precision import tf32

TIE = 2e-5  # frames: a duration this close to a whole number is a tie between two correct ceilings
LENGTH_ROWS = 400  # served rows whose length is checked (the reference's encoder alone, ~4 ms a row)


def fix_len(n: int, factor: int = 4) -> int:
    return -(-n // factor) * factor


def noise(seed: int, m_bucket: int, n_feats: int, temperature: float, device) -> torch.Tensor:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return torch.randn((m_bucket, n_feats), generator=g, device=device, dtype=torch.float32) * temperature


def order(rows: list, seed: int, key=lambda r: len(r["text"])) -> list:
    """The rows' indices in an order drawn from the seed, the longest row
    first: a check judges the first of them that are not ties."""
    order = list(range(len(rows)))
    random.Random(seed).shuffle(order)
    longest = max(range(len(rows)), key=lambda i: key(rows[i]))
    order.remove(longest)
    return [longest] + order


def check(cfg: dict, weights: tuple, rows: list, indices: list, n: int, device, exact_bucket=None,
          control: bool = False) -> dict:
    """Judge `rows` in the order of `indices`.  A row: ``text``, ``spk``, ``seed``,
    ``length_scale``, ``samples`` (the served audio's length) and, for rows
    kept whole, ``wav`` (the served float audio).

    * ``wrong_length``: of the first ``LENGTH_ROWS`` rows, those whose served
      length is not the reference's predicted mel length times the hop.
    * ``wav_share_2lsb``: of the first `n` rows with audio, the largest share
      of samples at which the served int16 audio and the reference's differ
      by two steps or more (float32 rounding moves a sample by one step at
      most; ``wav_diff_share``, the share that differs at all, and
      ``wav_err``, the largest difference, beside it).
      `exact_bucket(row, y_len)` gives the capacity where the caller knows
      it; otherwise each capacity from the row's own up is tried and the
      closest answer kept.

    A row whose predicted durations lie within ``TIE`` of a whole frame is
    skipped (``ties``).  With `control`, the reference is run again in TF32
    and read against itself in float32 on the same rows (``control_*``)."""
    model, voc, s = cfg["model"], cfg["vocoder"], cfg["synthesis"]
    sd, vsd = weights
    hop = math.prod(voc["upsample_rates"])
    bias = ref.bias_spectrum(vsd, voc, model["n_feats"])

    def synthesise(r, m):
        mu, w, wc, y_len, spk_e = ref.encode(sd, model, ref.text_ids(r["text"]), r["spk"], r["length_scale"])
        z = noise(r["seed"], m, model["n_feats"], s["temperature"], device)
        wav = ref.vocode(vsd, voc, ref.decode(sd, model, mu, wc, y_len, m, z, s["n_timesteps"], spk_e))
        if s["denoiser_strength"] > 0:
            wav = ref.denoise(wav, bias, s["denoiser_strength"])
        return (ref.pcm16(wav) if s["pcm16"] else wav)[: y_len * hop].cpu().numpy(), y_len

    if any(r["length_scale"] != 1.0 for r in rows):
        raise ValueError("the served-synthesis check takes length_scale 1 (whole frames sum exactly)")

    def lengths(r):
        _, w, _, y_len, _ = ref.encode(sd, model, ref.text_ids(r["text"]), r["spk"], r["length_scale"])
        return y_len, bool((torch.abs(w - torch.round(w)) < TIE).any())

    step = 1.0 / 32767.0 if s["pcm16"] else 0.0

    def shares(a, b):
        d = np.abs(a - b)
        return float(np.mean(d > 0)), float(np.mean(d > 1.5 * step)), float(d.max())

    out = dict(wav_share_2lsb=0.0, wrong_length=0.0, wav_diff_share=0.0, wav_err=0.0, judged=0, ties=0, decodes=0,
               lengths=0)
    if control:
        out.update(control_wav_share_2lsb=0.0, control_wrong_length=0.0, control_wav_diff_share=0.0,
                   control_wav_err=0.0)
    for i in indices:
        r = rows[i]
        if r["samples"] is None:  # never came: counted as failed, not judged
            continue
        wanted_len, wanted_wav = out["lengths"] < LENGTH_ROWS, out["judged"] < n and r.get("wav") is not None
        if not (wanted_len or wanted_wav):
            continue
        y_len, tie = lengths(r)
        if tie:
            out["ties"] += 1
            continue
        ok = r["samples"] == y_len * hop
        if wanted_len:
            out["lengths"] += 1
            out["wrong_length"] += 0 if ok else 1
            if control:
                with tf32(True):
                    out["control_wrong_length"] += 0 if lengths(r)[0] == y_len else 1
        if not (wanted_wav and ok):
            continue
        out["judged"] += 1
        served = np.asarray(r["wav"], np.float32)
        buckets = [exact_bucket(r, y_len)] if exact_bucket is not None else \
            [m for m in s["mel_buckets"] if m >= fix_len(y_len)]
        best, best_m, best_wav = None, None, None
        for m in buckets:
            out["decodes"] += 1
            wav, _ = synthesise(r, m)
            err = float(np.abs(wav - served).max())
            if best is None or err < best:
                best, best_m, best_wav = err, m, wav
        for key, v in zip(("wav_diff_share", "wav_share_2lsb", "wav_err"), shares(best_wav, served)):
            out[key] = max(out[key], v)
        if control:
            with tf32(True):
                low, _ = synthesise(r, best_m)
            if len(low) == len(best_wav):
                for key, v in zip(("wav_diff_share", "wav_share_2lsb", "wav_err"), shares(low, best_wav)):
                    out[f"control_{key}"] = max(out[f"control_{key}"], v)
    return out
