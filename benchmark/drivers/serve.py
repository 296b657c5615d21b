"""Open-loop serving through the port's ``BatchingEngine``: requests are due
at the times the traffic fixed and are submitted then, whatever the engine is
doing; a request's latency runs from when it was due to its audio on the
host.  The engine's settings are the cell's (``engine``).

Set-up warms every graph key the traffic can reach: the (text bucket, mel
bucket) of each request at batch 1, and every pair of the text buckets and
mel buckets the requests reach at each larger batch bucket; then a settle
pass of the mix's warm requests through the engine.
"""

from __future__ import annotations

import threading
import time

from benchmark.checks import tts as tts_check
from benchmark.harness import Record, Slice, Spans
from benchmark.traffic.generate import sub_seed

WAIT_S = 60.0  # a request may come this long after the window closes; later it counts as failed


class Driver:
    def __init__(self, cell: dict, system, traffic: dict, device, seed: int):
        self.cell, self.sys, self.traffic, self.device = cell, system, traffic, device
        self.check_seed = sub_seed(seed, "check")
        self.engine = None

    def _engine(self):
        from emojivoice_tpu_torch.inference.serving import BatchingEngine

        e = self.cell["engine"]
        return BatchingEngine(self.sys.pipe, max_batch=e["max_batch"], max_wait_ms=e["max_wait_ms"],
                              batch_buckets=tuple(e["batch_buckets"]), pcm16=self.sys.synth["pcm16"])

    def warm(self) -> None:
        reqs = self.traffic["requests"] + self.traffic["warm"]
        ls = self.sys.synth["length_scale"]
        keys = self.sys.lengths([r["text"] for r in reqs], [r["spk"] for r in reqs], ls)
        from emojivoice_tpu_torch.utils.buckets import pick_bucket

        mel = self.sys.synth["mel_buckets"]
        pairs = {(t, pick_bucket(tts_check.fix_len(m), mel)) for t, m in keys}
        self.sys.warm(pairs, 1, pcm16=self.sys.synth["pcm16"])
        t_set, m_set = {t for t, _ in pairs}, {m for _, m in pairs}
        for b in self.cell["engine"]["batch_buckets"]:
            if b > 1:
                self.sys.warm({(t, m) for t in t_set for m in m_set}, b, pcm16=self.sys.synth["pcm16"])
        self.engine = self._engine()
        futs = [self.engine.submit(r["text"], spk=r["spk"], seed=r["seed"], **self._kw()) for r in self.traffic["warm"]]
        for f in futs:
            f.result(timeout=WAIT_S)

    def _kw(self) -> dict:
        s = self.sys.synth
        return dict(n_timesteps=s["n_timesteps"], temperature=s["temperature"], length_scale=s["length_scale"],
                    denoiser_strength=s["denoiser_strength"])

    def window(self, seconds: float, trace: bool) -> Record:
        reqs = self.traffic["requests"]
        pipe = self.sys.pipe
        spans = Spans()
        keep = set(tts_check.order(reqs, self.check_seed)[: self.cell["check_rows"] * 2])
        lock = threading.Lock()
        done = threading.Event()
        left = [len(reqs)]
        sl = Slice() if trace else None
        t_slice = seconds * self.cell["trace_at"]
        before = dict(engine=self.engine.stats(), graphs=pipe.graphs.stats())
        t_start = time.perf_counter()
        for i, r in enumerate(reqs):
            due = t_start + r["due"]
            while (rem := due - time.perf_counter()) > 0:
                time.sleep(min(rem, 0.002))
            if sl is not None and sl.prof is None and r["due"] >= t_slice:
                sl.start()
            if sl is not None and sl.active and r["due"] >= t_slice + self.cell["trace_s"]:
                sl.stop()
            r["late_s"] = time.perf_counter() - due
            fut = self.engine.submit(r["text"], spk=r["spk"], seed=r["seed"], **self._kw())

            def on_done(f, r=r, i=i, due=due):
                t = time.perf_counter()
                res = err = None
                try:
                    res = f.result()
                except Exception as e:  # noqa: BLE001 — a failed request is counted, not raised here
                    err = repr(e)
                with lock:
                    r["done_s"] = t - t_start
                    r["latency_s"] = t - due
                    r["error"] = err
                    if res is not None:
                        r["samples"] = len(res.wav)
                        r["audio_s"] = len(res.wav) / res.sample_rate
                        r["stage_ms"] = res.stage_ms
                        if i in keep:
                            r["wav"] = res.wav
                    spans.add("request", due, t)
                    left[0] -= 1
                    if left[0] == 0:
                        done.set()
            fut.add_done_callback(on_done)
        if sl is not None and sl.active:
            sl.stop()
        t_close = time.perf_counter()
        done.wait(timeout=WAIT_S)
        after = dict(engine=self.engine.stats(), graphs=pipe.graphs.stats())
        window_s = t_close - t_start
        record = Record(cell=self.cell["name"], window_s=window_s, setup_s=0.0, items=reqs, spans=spans,
                        counters=dict(before=before, after=after))
        if sl is not None:
            def label(t):
                busy = any(s.t0 <= t <= s.t1 for s in spans.items)
                return "engine: requests outstanding" if busy else "no request outstanding"
            record.trace = sl.reduce(label)
        return record

    def close(self) -> None:
        if self.engine is not None:
            self.engine.close()
            self.engine = None

    def check(self, record: Record, weights_fn, control: bool = False) -> dict:
        weights = weights_fn("tts")
        reqs = record.items
        rows = [dict(text=r["text"], spk=r["spk"], seed=r["seed"], length_scale=self.sys.synth["length_scale"],
                     samples=r.get("samples"), wav=r.get("wav")) for r in reqs]
        order = tts_check.order(reqs, self.check_seed)
        return tts_check.check(self.sys.cfg, weights, rows, order, self.cell["check_rows"], self.device,
                               control=control)


def outcome(record) -> tuple:
    """(requests due in the window, those that failed or never came)."""
    return len(record.items), sum(1 for r in record.items if r.get("latency_s") is None or r.get("error"))
