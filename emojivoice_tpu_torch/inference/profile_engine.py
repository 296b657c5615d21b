"""What the batching engine's two threads buy, measured on the card.

    python -m emojivoice_tpu_torch.inference.profile_engine [--out chiprun_out/profile_engine.json]

``BatchingEngine`` dispatches on one thread and resolves results on another.
The engine it was ported from does both on one thread, in the order
"dispatch batch N+1, then fetch batch N".  This script serves the same burst
of requests (32 seeded texts of 20-200 characters from 8 client threads,
emoji_multi at full width with random weights, 10 Euler steps, pcm16)
through both, in turns two-thread, one-thread, one-thread, two-thread on one
card, and prints for each run the utterances per second over the window and
the percentiles of a request's latency from ``submit`` to its resolved
future.  There is no CPU path: without a CUDA device it exits.
"""

from __future__ import annotations

import argparse
import json
import queue
import random
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from emojivoice_tpu_torch.inference.serving import BatchingEngine

WORDS = ("the quick brown fox jumped over lazy dog and everyone at party cheered loudly for brave little "
         "robot").split()
WAIT_S = 120


def serving_requests(n: int, spks: list, seed: int = 0) -> list:
    """n seeded requests: (text of 20-200 characters, a speaker of `spks`, a noise seed)."""
    rng = random.Random(seed)
    out = []
    for i in range(n):
        target, text = rng.randint(20, 200), ""
        while len(text) < target:
            text += rng.choice(WORDS) + " "
        out.append((text[:target].strip() + ".", spks[i % len(spks)], 1000 + i))
    return out


class OneThreadEngine(BatchingEngine):
    """The reference engine's worker: dispatch batch N+1, then fetch batch N,
    both on the worker thread (the results thread only waits for the end)."""

    def _run(self):
        in_flight = None
        while True:
            if in_flight is None:
                req = self._queue.get()
            else:
                try:
                    req = self._queue.get_nowait()
                except queue.Empty:
                    self._finalize(in_flight)  # no follow-up work: drain the in-flight batch now
                    in_flight = None
                    continue
            if req is None:
                if in_flight is not None:
                    self._finalize(in_flight)
                    in_flight = None
                if self._closed and self._queue.empty():
                    self._in_flight.put(None)
                    self._finalizer.join()
                    return
                self._queue.put(None)
                continue
            batch, holdback = self._collect(req)
            for h in holdback:
                self._queue.put(h)
            rec = self._dispatch_async(batch)
            if in_flight is not None:
                self._finalize(in_flight)
            in_flight = rec


def burst(eng: BatchingEngine, requests: list, clients: int = 8) -> dict:
    """Serve `requests` from `clients` threads, each submitting its share at
    once and waiting for it; results come back in the order of `requests`."""
    latency = [None] * len(requests)

    def client(k):
        futs = []
        for i in range(k, len(requests), clients):
            text, spk, seed = requests[i]
            t = time.perf_counter()
            fut = eng.submit(text, spk=spk, seed=seed)
            fut.add_done_callback(lambda _f, i=i, t=t: latency.__setitem__(i, (time.perf_counter() - t) * 1e3))
            futs.append(fut)
        return [f.result(timeout=WAIT_S) for f in futs]

    t = time.perf_counter()
    with ThreadPoolExecutor(clients) as pool:
        per_client = list(pool.map(client, range(clients), timeout=WAIT_S))
    window_s = time.perf_counter() - t
    results = [None] * len(requests)
    for k, rs in enumerate(per_client):
        results[k::clients] = rs
    ordered = sorted(latency)
    return dict(results=results, window_s=window_s, utt_per_s=len(requests) / window_s,
                latency_ms_p50=ordered[len(ordered) // 2], latency_ms_p95=ordered[int(len(ordered) * 0.95)],
                latency_ms_max=ordered[-1])


def measure(pipe, requests: list, engine_cls, **engine_kw) -> dict:
    """One burst through a fresh engine of `engine_cls`; its numbers and the engine's counters."""
    with engine_cls(pipe, **engine_kw) as eng:
        out = burst(eng, requests)
        stats = eng.stats()
    out.pop("results")
    out.update(engine=engine_cls.__name__, batches=stats["batches"], mean_batch=stats["mean_batch"],
               wait_ms_p50=stats["wait_ms_p50"], wait_ms_p95=stats["wait_ms_p95"],
               mean_dispatch_ms=stats["mean_dispatch_ms"])
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default="chiprun_out/profile_engine.json")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_engine: no CUDA device; this script measures on the card only")

    from emojivoice_tpu_torch import config
    from emojivoice_tpu_torch.apps.emoji import EMOJI_MAPPING
    from emojivoice_tpu_torch.inference.pipeline import SynthesisPipeline

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    pipe = SynthesisPipeline.from_random(config.get_preset("emoji_multi"), seed=0, cleaners=("basic_cleaners",))
    requests = serving_requests(32, list(EMOJI_MAPPING.values()))
    kw = dict(max_batch=8, max_wait_ms=10)
    with BatchingEngine(pipe, **kw) as eng:  # the build, the allocator and the requests' own buckets
        eng.warmup()
        burst(eng, requests)
    runs = [measure(pipe, requests, cls, **kw)
            for cls in (BatchingEngine, OneThreadEngine, OneThreadEngine, BatchingEngine) for _ in range(2)]
    for r in runs:
        print("[engine] " + json.dumps(r))
    summary = {"device": smi}
    for name in ("BatchingEngine", "OneThreadEngine"):
        mine = [r for r in runs if r["engine"] == name]
        summary[name] = {k: statistics.median(r[k] for r in mine)
                         for k in ("utt_per_s", "latency_ms_p50", "latency_ms_p95", "latency_ms_max", "mean_dispatch_ms")}
    print("[engine] median of 4 runs each " + json.dumps(summary))
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"summary": summary, "runs": runs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
