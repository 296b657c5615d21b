"""Steady-state serving through the BatchingEngine on the card (twin of ``tools/bench_serving.py``).

    python -m emojivoice_tpu_torch.bench.serving [--clients 1,8,32] [--window_s 32] [--rates 2,4,8]
        [--bundle] [--vocoder_bf16]

Two measurements over ``BatchingEngine(max_batch=8, max_wait_ms=15)`` on
emoji_multi + HiFi-GAN v1 (random weights, 10 Euler steps, pcm16):

1. **Capacity** (closed loop), at each client count of ``--clients``: every
   client keeps 4 requests outstanding (the twin's) until ``--window_s``
   has passed; utterances/s, audio seconds per wall second, the batches and
   the percentiles of a request's latency from submit to result.
2. **Latency against offered load** (open loop): requests arrive at fixed
   rates (Poisson, seeded) for ``--window_s`` each (by default 25/50/75/90 %
   of the last capacity point).  A request's latency runs from when it was
   **due**, so a stall of the submitter or the engine counts against the
   requests behind it, and how late the submitter ran is reported
   (``late_ms_p50`` / ``late_ms_max``).  The achieved rate divides the
   requests by the **submit window**; the drain after it (the time the last
   results took to arrive) is reported on its own (``drain_s``): the twin
   divided by a wall that included the drain (F3, ``tools/bench_serving.py:140``).

``--bundle`` serves an exported bundle (``inference/export.py``, text bucket
128 × mel bucket 512, batches 1 and ``--max_batch``, written to a temporary
folder) through ``BundleSynthesisPipeline`` instead of the live pipeline.
Prints one JSON line with the twin's keys (``device_kind`` is the card's
name), the card's count and power limit.
"""

from __future__ import annotations

import argparse
import datetime as dt
import random
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

from emojivoice_tpu_torch.bench import util

TEXTS = [
    "The quick brown fox jumped over the lazy dog tonight.",
    "Everyone at the party cheered loudly for the brave robot.",
    "A long time ago, in a kitchen far away, soup was made.",
    "Please remember to water the plants before you leave.",
]
WAIT_S = 600  # no request of a run may take longer


def _pct(xs, q):
    import numpy as np

    return float(np.percentile(np.asarray(xs), q)) if xs else float("nan")


def _delta(eng, before: dict) -> dict:
    after = eng.stats()
    return {k: after[k] - before[k] for k in ("requests", "batches", "batched_rows", "wait_s_sum")}


def measure_capacity(eng, window_s: float, clients: int, inflight: int = 4, steps: int = 10) -> dict:
    """Closed loop: each client keeps `inflight` requests outstanding until
    the window elapses.  Latency here is queueing-dominated by design;
    throughput is the number."""
    stop = time.monotonic() + window_s
    counts, audio, latency = [0] * clients, [0.0] * clients, [[] for _ in range(clients)]
    before = eng.stats()
    t0 = time.monotonic()

    def client(k):
        i = 0
        while time.monotonic() < stop:
            t = time.monotonic()
            futs = [eng.submit(TEXTS[(k + i + j) % 4], spk=70 + (k * 3 + j) % 8, n_timesteps=steps)
                    for j in range(inflight)]
            for f in futs:
                r = f.result(timeout=WAIT_S)
                latency[k].append((time.monotonic() - t) * 1e3)
                counts[k] += 1
                audio[k] += len(r.wav) / r.sample_rate
            i += 1

    with ThreadPoolExecutor(clients) as ex:
        list(ex.map(client, range(clients)))
    wall = time.monotonic() - t0
    d = _delta(eng, before)
    lat = [x for xs in latency for x in xs]
    return {
        "mode": "capacity_closed_loop", "clients": clients, "inflight": inflight, "window_s": wall,
        "requests": sum(counts), "utterances_per_s": sum(counts) / wall, "audio_s_per_wall_s": sum(audio) / wall,
        "batches": d["batches"], "mean_batch": d["batched_rows"] / max(d["batches"], 1),
        "mean_wait_ms": 1e3 * d["wait_s_sum"] / max(d["requests"], 1),
        "p50_ms": _pct(lat, 50), "p95_ms": _pct(lat, 95), "p99_ms": _pct(lat, 99),
    }


def measure_open_loop(eng, rate: float, window_s: float, seed: int = 0, steps: int = 10) -> dict:
    """Open loop at `rate` requests/s (Poisson arrivals, seeded): every
    request is due at a time fixed in advance and its latency runs from that
    time to its result; the achieved rate is over the submit window, the
    drain after it is reported apart."""
    rng = random.Random(seed)
    due, t = [], rng.expovariate(rate)
    while t < window_s:
        due.append(t)
        t += rng.expovariate(rate)
    latency_ms, late_ms, done_at = [], [], []
    lock = threading.Lock()
    all_done = threading.Event()
    before = eng.stats()
    t_start = time.monotonic()
    for i, d in enumerate(due):
        while (rem := t_start + d - time.monotonic()) > 0:
            time.sleep(min(rem, 0.05))
        late_ms.append((time.monotonic() - t_start - d) * 1e3)
        fut = eng.submit(TEXTS[i % 4], spk=70 + i % 8, n_timesteps=steps)

        def on_done(f, d=d):
            t_done = time.monotonic() - t_start
            with lock:  # no reference to the future is kept: its audio can go once its latency is read
                latency_ms.append((t_done - d) * 1e3)
                done_at.append(t_done)
                if len(latency_ms) == len(due):
                    all_done.set()

        fut.add_done_callback(on_done)
    submitted_s = time.monotonic() - t_start
    if due and not all_done.wait(timeout=WAIT_S):
        raise RuntimeError(f"open loop at {rate}/s: {len(latency_ms)} of {len(due)} requests resolved")
    d = _delta(eng, before)
    return {
        "mode": "open_loop", "offered_rate_per_s": rate, "window_s": window_s, "requests": len(latency_ms),
        "achieved_rate_per_s": len(latency_ms) / window_s,
        "drain_s": max(max(done_at, default=0.0) - window_s, 0.0), "submit_s": submitted_s,
        "p50_ms": _pct(latency_ms, 50), "p95_ms": _pct(latency_ms, 95), "p99_ms": _pct(latency_ms, 99),
        "max_ms": max(latency_ms) if latency_ms else float("nan"),
        "late_ms_p50": _pct(late_ms, 50), "late_ms_max": max(late_ms) if late_ms else float("nan"),
        "batches": d["batches"], "mean_batch": d["batched_rows"] / max(d["batches"], 1),
        "mean_wait_ms": 1e3 * d["wait_s_sum"] / max(d["requests"], 1),
    }


# the point's numbers that are counts, not times
COUNTS = {"mode", "clients", "inflight", "requests", "batches", "mean_batch", "offered_rate_per_s"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    util.add_device_args(ap)
    ap.add_argument("--max_batch", type=int, default=8, help="largest coalesced dispatch (batch bucket)")
    ap.add_argument("--clients", default="1,8,32", help="closed-loop client counts, comma-separated")
    ap.add_argument("--window_s", type=float, default=32.0, help="measurement window per point")
    ap.add_argument("--rates", default="", help="open-loop offered rates per second, comma-separated; "
                                                "default: 25/50/75/90%% of the last capacity point")
    ap.add_argument("--bundle", action="store_true", help="serve an exported bundle instead of the live pipeline")
    ap.add_argument("--vocoder_bf16", action="store_true", help="K1's bf16 mode for the vocoder (vocoder_dtype)")
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args(argv)
    device = util.resolve_device(args.cpu, "bench.serving")
    m, info = util.Measure(device), util.device_info(device)

    import torch

    from emojivoice_tpu_torch import config
    from emojivoice_tpu_torch.inference.pipeline import SynthesisPipeline
    from emojivoice_tpu_torch.inference.serving import BatchingEngine

    pipe = SynthesisPipeline.from_random(config.get_preset(args.preset), seed=0, device=device,
                                         cleaners=("basic_cleaners",),
                                         vocoder_dtype=torch.bfloat16 if args.vocoder_bf16 else torch.float32)
    b = args.max_batch
    with tempfile.TemporaryDirectory(prefix="emojivoice_serving_bundle_") as tmp:
        backend = pipe
        if args.bundle:
            from emojivoice_tpu_torch.inference.export import BundleSynthesisPipeline, export_bundle

            t0 = dt.datetime.now()
            export_bundle(pipe, tmp, text_buckets=[128], mel_buckets=[512], batches=(1, b), n_timesteps=args.steps,
                          pcm16=True)
            print(f"[serving] bundle export {(dt.datetime.now() - t0).total_seconds():.1f}s", file=sys.stderr)
            backend = BundleSynthesisPipeline(tmp, device=device)
        points = []
        with BatchingEngine(backend, max_batch=b, max_wait_ms=15, batch_buckets=(1, b)) as eng:
            eng.warmup(n_timesteps=args.steps)
            for attempt in range(10):  # settle: every (text, mel) bucket these texts reach, once
                t0 = time.monotonic()
                futs = [eng.submit(TEXTS[(attempt + i) % 4], spk=70 + i % 8, n_timesteps=args.steps)
                        for i in range(2 * b)]
                for f in futs:
                    f.result(timeout=WAIT_S)
                if time.monotonic() - t0 < 3.0:
                    break
            before = util.k1_calls()
            for clients in (int(c) for c in args.clients.split(",") if c):
                cap = measure_capacity(eng, args.window_s, clients, steps=args.steps)
                print(f"[serving] capacity at {clients} clients: {cap['utterances_per_s']:.2f} utt/s "
                      f"({cap['batches']} batches over {cap['window_s']:.1f}s)", file=sys.stderr, flush=True)
                points.append(cap)
            rates = [float(r) for r in args.rates.split(",") if r] if args.rates else \
                [round(points[-1]["utterances_per_s"] * f, 1) for f in (0.25, 0.5, 0.75, 0.9)]
            for i, rate in enumerate(rates):
                pt = measure_open_loop(eng, rate, args.window_s, seed=i, steps=args.steps)
                print(f"[serving] open-loop {rate}/s: p50 {pt['p50_ms']:.1f}ms p95 {pt['p95_ms']:.1f}ms "
                      f"p99 {pt['p99_ms']:.1f}ms, late by up to {pt['late_ms_max']:.1f}ms, drain {pt['drain_s']:.2f}s "
                      f"({pt['requests']} reqs, {pt['batches']} batches)", file=sys.stderr, flush=True)
                points.append(pt)
            stats = eng.stats()
            k1_launches = util.k1_calls() - before
    report = {
        "metric": "serving_latency_throughput", "mode": "bundle" if args.bundle else "live",
        "device_kind": info["device"], "max_batch": b, "max_wait_ms": 15, "vocoder_bf16": bool(args.vocoder_bf16),
        "steps": args.steps, "points": [{k: (v if k in COUNTS else m(v)) for k, v in p.items()} for p in points],
        "errors": stats["errors"], "k1_mode": "bf16" if args.vocoder_bf16 and not args.bundle else "f32",
        # mrf_stage calls that launched K1 over the measured points (a bundle's programs launch it through the
        # registered op, counted alike), and the batches they vocoded
        "k1_launches": k1_launches, "batches": sum(p["batches"] for p in points), **info,
    }
    util.emit(report)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
