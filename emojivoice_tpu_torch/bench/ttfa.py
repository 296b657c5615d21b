"""Conversational time to first audio on the card (twin of ``tools/bench_ttfa.py``).

    python -m emojivoice_tpu_torch.bench.ttfa [--reps 5] [--segment_chars 120]

Per utterance length (the twin's three texts), text in → first audible
sample out, under four strategies on emoji_multi + HiFi-GAN v1 (random
weights, 10 Euler steps):

  full       synthesise the whole reply, then play;
  stream     the full text's CFM decode, then the chunked streaming vocoder:
             first audio after one vocoder chunk;
  pipelined  ``inference/longform.py::stream_longform``: segment i+1 is
             enqueued before segment i is yielded (the reference's order;
             F6 measures it slower to first audio than one call on this
             card, ROADMAP 4d; this tool measures it and changes nothing);
  auto       ``inference/streaming.py::auto_stream``'s own choice.

Each strategy is warmed first, then the median of ``--reps`` runs of
(ttfa_ms, total_ms, audio_s) is kept.  Prints one JSON line with the
twin's keys (``backend`` "cuda", ``device_kind`` the card's name), K1's
``mrf_stage`` calls per run of each strategy, the card's count and power
limit.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from emojivoice_tpu_torch.bench import util

TEXTS = {
    "short_reply_1s": "That sounds like a wonderful plan!",
    "reply_2sent_4s": ("That sounds like a wonderful plan! We could pack a basket "
                       "and walk down to the old harbor together."),
    "story_turn_10s": ("Once upon a time a little robot lived by the sea. Every "
                       "morning it counted the silver waves and hummed a tiny tune. "
                       "One day a storm arrived, and the robot decided to build a "
                       "lighthouse from driftwood and bottle glass. All the gulls "
                       "came to watch it glow."),
}


def measure(fn, reps: int, m: util.Measure) -> dict:
    """Median (ttfa_ms, total_ms, audio_s) over reps; fn() must return an
    iterator of waveform chunks, TTFA is the time to the first one."""
    rows = []
    for _ in range(reps):
        before = util.k1_calls()
        t0 = time.perf_counter()
        it = fn()
        first = next(it)
        t_first = time.perf_counter() - t0
        n = len(np.atleast_1d(first))
        for c in it:
            n += len(np.atleast_1d(c))
        rows.append((t_first * 1e3, (time.perf_counter() - t0) * 1e3, n / 22050.0, util.k1_calls() - before))
    med = np.median(np.asarray(rows), axis=0)
    return {"ttfa_ms": m(float(med[0])), "total_ms": m(float(med[1])), "audio_s": round(float(med[2]), 3),
            "ttfa_ms_min": m(min(r[0] for r in rows)), "k1_launches": int(rows[-1][3])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    util.add_device_args(ap)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--segment_chars", type=int, default=120)
    args = ap.parse_args(argv)
    device = util.resolve_device(args.cpu, "bench.ttfa")
    m, info = util.Measure(device), util.device_info(device)

    from emojivoice_tpu_torch import config
    from emojivoice_tpu_torch.inference.longform import stream_longform
    from emojivoice_tpu_torch.inference.pipeline import SynthesisPipeline
    from emojivoice_tpu_torch.inference.streaming import auto_stream, stream_synthesise

    root = config.get_preset(args.preset)
    pipe = SynthesisPipeline.from_random(root, seed=0, device=device, cleaners=("basic_cleaners",))
    spk = min(args.spk, root.model.n_spks - 1)
    kw = dict(n_timesteps=args.steps, seed=0)
    report = {"preset": args.preset, "steps": args.steps, "backend": device.type, "device_kind": info["device"],
              "segment_chars": args.segment_chars, "reps": args.reps, "lengths": {}}
    for name, text in TEXTS.items():
        strategies = {
            "full": lambda: iter([pipe.synthesise([text], spks=[spk], **kw)[0].wav]),
            "stream": lambda: stream_synthesise(pipe, text, spk=spk, **kw),
            "pipelined": lambda: stream_longform(pipe, text, spk=spk, max_chars=args.segment_chars, **kw),
            "auto": lambda: auto_stream(pipe, text, spk=spk, segment_chars=args.segment_chars, **kw),
        }
        entry = {}
        for strat, fn in strategies.items():
            for _ in fn():  # warm every shape this strategy needs
                pass
            entry[strat] = measure(fn, args.reps, m)
        report["lengths"][name] = entry
        print(f"[ttfa] {name}: " + "  ".join(f"{s}={e['ttfa_ms']}ms/{e['audio_s']}s" for s, e in entry.items()),
              file=sys.stderr, flush=True)
    report.update(info)
    util.emit(report)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
