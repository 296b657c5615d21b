"""Multilingual long-form synthesis on the card (twin of ``tools/multilingual_proof.py``).

    python -m emojivoice_tpu_torch.bench.multilingual [--out chiprun_out/multilingual] [--steps 10]

Runs the opening lines of the case-study story, in English and translated
into French, German, Spanish and Japanese (the twin's texts), through the
port's long-form path (language cleaner → sentence split and re-pack →
``synthesise_longform``, one synthesis call per segment, dispatched ahead)
on emoji_multi + HiFi-GAN v1 with random weights (seed 0), speaker 3.  Where
no espeak is installed the fr / de / ja cleaners take their documented
grapheme fallback, as on the JAX side.  Each language is warmed once, then
timed: chars, segments, audio seconds, wall seconds, RTF, and the waveform's
largest magnitude, RMS and finiteness, with K1's ``mrf_stage`` calls (four a
segment on HiFi-GAN v1).  The proof is the path and its speed on the card,
not audio quality (the weights are random).

Writes ``proof.json`` (one entry per language) under ``--out``, which
defaults to ``chiprun_out/multilingual/`` (never ``docs/artifacts/``), and
prints the report as one JSON line with the card's name, count and power
limit.  ``--out ''`` writes nothing.
"""

from __future__ import annotations

import argparse
import datetime as dt
import json
import os
import time

import numpy as np

from emojivoice_tpu_torch.bench import util

TEXTS = {
    "en": "Once upon a time, in a quiet village, a small robot woke up. "
          "It looked at the sky and wondered what the day would bring! "
          "The villagers had never seen anything like it before.",
    "fr": "Il était une fois, dans un village tranquille, un petit robot qui "
          "se réveilla. Il regarda le ciel et se demanda ce que la journée "
          "allait apporter ! Les villageois n'avaient jamais rien vu de tel.",
    "de": "Es war einmal ein kleiner Roboter, der in einem ruhigen Dorf "
          "erwachte. Er blickte zum Himmel und fragte sich, was der Tag wohl "
          "bringen würde! So etwas hatten die Dorfbewohner noch nie gesehen.",
    "es": "Érase una vez, en un pueblo tranquilo, un pequeño robot que "
          "despertó. Miró al cielo y se preguntó qué le depararía el día. "
          "Los aldeanos nunca habían visto nada igual.",
    "ja": "むかしむかし、静かな村で小さなロボットが目を覚ましました。"
          "空を見上げて、今日は何が起こるだろうと考えました。"
          "村人たちはそんなものを見たことがありませんでした。",
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    util.add_device_args(ap)
    ap.add_argument("--out", default="chiprun_out/multilingual")
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args(argv)
    device = util.resolve_device(args.cpu, "bench.multilingual")
    m, info = util.Measure(device), util.device_info(device)

    from emojivoice_tpu_torch import config
    from emojivoice_tpu_torch.inference.longform import split_text, synthesise_longform
    from emojivoice_tpu_torch.inference.pipeline import SAMPLE_RATE, SynthesisPipeline

    pipe = SynthesisPipeline.from_random(config.get_preset(args.preset), seed=0, device=device)
    spk = min(3, pipe.model_cfg.n_spks - 1)
    report = {"backend": device.type, "steps": args.steps, "model": f"{args.preset} random-init (seed 0)",
              "languages": {}}
    for lang, text in TEXTS.items():
        # warm the shapes of every segment, so that the RTF is the steady state's
        synthesise_longform(pipe, text, spk=spk, language=lang, n_timesteps=args.steps, seed=0)
        before = util.k1_calls()
        t0 = time.perf_counter()
        wav = synthesise_longform(pipe, text, spk=spk, language=lang, n_timesteps=args.steps, seed=0)
        wall = time.perf_counter() - t0
        audio_s = len(wav) / SAMPLE_RATE
        report["languages"][lang] = {
            "chars": len(text), "segments": len(split_text(text)), "audio_seconds": round(audio_s, 3),
            "wall_seconds": m(wall), "rtf": m(wall / audio_s), "wav_abs_max": round(float(np.abs(wav).max()), 4),
            "wav_rms": round(float(np.sqrt(np.mean(np.square(wav)))), 5), "finite": bool(np.isfinite(wav).all()),
            "k1_launches": util.k1_calls() - before,
        }
    report["generated"] = dt.datetime.now().isoformat(timespec="seconds")
    report.update(info)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "proof.json"), "w") as f:
            json.dump(report, f, indent=2, ensure_ascii=False)
    util.emit(report)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
