"""Where the serving wall clock goes on the card (twin of ``tools/bench_breakdown.py``).

    python -m emojivoice_tpu_torch.bench.breakdown [--repeats 10] [--profiled 3]

Splits ``bench.synthesis``'s operating point (batch 1, fused at the headline
text's mel bucket, 10 Euler steps, pcm16, the denoiser at 0.00025, speaker
79) into:

  compute   — the summed device activity (kernels and copies) of one call
              under ``torch.profiler``, the median over ``--profiled`` calls;
  e2e       — the wall of one call as a user sees it, enqueue to the pcm16
              audio copied to the host, the median over ``--repeats`` calls;
  overhead  — e2e − compute: on the card, the host's launches (and the
              device's gaps between them), not a tunnel's round trip.

The e2e walls are taken before any profiled call, and again right after
the first (``e2e_ms_after_profiler``): on the card a process's first
``torch.profiler`` session slowed its later calls.

Prints one JSON line with the twin's keys (``compute_ms``, ``e2e_ms``,
``overhead_ms``, ``wav_payload_kb``, ``rtf_compute_only``, ``rtf_e2e``; the
audio length is this run's, where the twin wrote 5.68 s), the busy share
(compute over the profiled calls' own wall), the device activities, K1's
device ms and its ``mrf_stage`` calls in one call, the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import statistics
import time

import torch

from emojivoice_tpu_torch.bench import util
from emojivoice_tpu_torch.bench.synthesis import STEPS, STRENGTH


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    util.add_device_args(ap)
    ap.add_argument("--repeats", type=int, default=10)
    ap.add_argument("--profiled", type=int, default=3)
    ap.add_argument("--steps", type=int, default=STEPS)
    args = ap.parse_args(argv)
    device = util.resolve_device(args.cpu, "bench.breakdown")
    m, info = util.Measure(device), util.device_info(device)

    from emojivoice_tpu_torch import config
    from emojivoice_tpu_torch.inference.pipeline import SynthesisPipeline
    from emojivoice_tpu_torch.utils.buckets import pick_bucket

    pipe = SynthesisPipeline.from_random(config.get_preset(args.preset), seed=0, device=device,
                                         cleaners=("basic_cleaners",))
    kw = dict(spks=[args.spk], n_timesteps=args.steps, denoiser_strength=STRENGTH, keep_mel=False, pcm16=True)
    first = pipe.synthesise([util.HEADLINE], seed=0, **kw)[0]
    m_bucket = pick_bucket(first.mel_length, pipe.mel_buckets)

    def call(seed=0):
        return pipe.synthesise([util.HEADLINE], seed=seed, fused=True, fused_mel_bucket=m_bucket, **kw)[0]

    res = call()  # warm
    audio_s = len(res.wav) / res.sample_rate

    def walls():
        out = []
        for i in range(args.repeats):
            t = time.perf_counter()
            call(i)
            out.append((time.perf_counter() - t) * 1e3)
        return out

    before = util.k1_calls()
    call()
    k1_launches = util.k1_calls() - before
    e2e_walls = walls()
    profs = [util.profile_call(call, device)]
    after = walls()  # the same calls after the process's first profiler session
    profs += [util.profile_call(call, device) for _ in range(args.profiled - 1)]
    compute = statistics.median(p["device_ms"] for p in profs)
    e2e = statistics.median(e2e_walls)
    report = {
        "metric": "serving_breakdown", "compute_ms": m(compute), "e2e_ms": m(e2e), "overhead_ms": m(e2e - compute),
        "wav_payload_kb": round(len(res.wav) * 2 / 1024, 1),  # int16 on the wire
        "rtf_compute_only": m(compute / 1e3 / audio_s), "rtf_e2e": m(e2e / 1e3 / audio_s),
        "e2e_ms_min": m(min(e2e_walls)), "e2e_ms_after_profiler": m(statistics.median(after)),
        "busy": m(statistics.median(p["busy"] or 0.0 for p in profs)),
        "device_activities": m(profs[0]["device_activities"]),
        "k1_device_ms": m(statistics.median(p["k1_device_ms"] for p in profs)), "k1_launches": k1_launches,
        "audio_s": round(audio_s, 3), "mel_bucket": m_bucket, "n_timesteps": args.steps, "batch": 1,
        "backend": device.type, "torch": torch.__version__, **info,
    }
    util.emit(report)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
