"""Closed-loop batch synthesis: ``SynthesisPipeline.synthesise`` on the
traffic's batches, one after the other, each row with its own noise seed.
The window runs whole batches: the last one that starts before the window's
end is finished, and the rate is over all the audio and all the time.

Set-up warms the (text bucket, mel bucket) of every batch of the traffic.
The audio of one row of each batch, drawn from the seed, is kept for the
check; the reference decodes it at its batch's mel capacity, which it works
out from its own predicted lengths of the batch's rows.
"""

from __future__ import annotations

import random
import time

from benchmark.checks import tts as tts_check
from benchmark.harness import Record, Slice, Spans
from benchmark.reference import matcha as ref
from benchmark.traffic.generate import sub_seed
from benchmark.work import synthesis


class Driver:
    def __init__(self, cell: dict, system, traffic: dict, device, seed: int):
        self.cell, self.sys, self.traffic, self.device = cell, system, traffic, device
        self.check_seed = sub_seed(seed, "check")

    def _key(self, batch: dict) -> tuple:
        lens = self.sys.lengths(batch["texts"], batch["spks"], self.sys.synth["length_scale"])
        m = max(n for _, n in lens)
        return max(t for t, _ in lens), next(b for b in self.sys.synth["mel_buckets"] if b >= tts_check.fix_len(m))

    def warm(self) -> None:
        batches = self.traffic["batches"]
        for b in batches:
            b["key"] = self._key(b)
        self.sys.warm({b["key"] for b in batches}, len(batches[0]["texts"]))
        for b in self.traffic["warm"]:
            self._call(b)

    def _call(self, b: dict):
        return self.sys.pipe.synthesise(b["texts"], spks=b["spks"], seed=b["seeds"], **self.sys.call_kw())

    def window(self, seconds: float, trace: bool) -> Record:
        batches = self.traffic["batches"]
        pick = random.Random(self.check_seed)
        spans = Spans()
        sl = Slice() if trace else None
        at, n_traced = self.cell["trace_at_batch"], self.cell["trace_batches"]
        done = []
        t_start = time.perf_counter()
        while time.perf_counter() - t_start < seconds:
            k = len(done)
            if k >= len(batches):
                raise RuntimeError(f"offline: the traffic's {len(batches)} batches end before the window")
            b = batches[k]
            if sl is not None and k == at:
                sl.start()
            t0 = time.perf_counter()
            res = self._call(b)
            t1 = time.perf_counter()
            spans.add("synthesise", t0, t1)
            j = pick.randrange(len(res))
            b.update(t0=t0 - t_start, t1=t1 - t_start, audio_s=sum(len(r.wav) / r.sample_rate for r in res),
                     stage_ms=res[0].stage_ms, kept=(j, res[j].wav), samples=[len(r.wav) for r in res])
            if sl is not None and sl.active:
                t, m = b["key"]
                sl.work.append(dict(batch=len(b["texts"]), t_bucket=t, m_bucket=m))
                if k == at + n_traced - 1:
                    sl.stop()
            done.append(b)
        record = Record(cell=self.cell["name"], window_s=time.perf_counter() - t_start, setup_s=0.0, items=done,
                        spans=spans, counters={})
        if sl is not None:
            record.trace = sl.reduce(lambda t: "host between batches")
        return record

    def close(self) -> None:
        pass

    def check(self, record: Record, weights_fn, control: bool = False) -> dict:
        weights = weights_fn("tts")
        s, model = self.sys.synth, self.sys.cfg["model"]
        rows = []
        for b in record.items:
            kept, wav = b["kept"]
            rows += [dict(text=t, spk=spk, seed=sd_, length_scale=s["length_scale"], samples=n, batch=b,
                          wav=wav if j == kept else None)
                     for j, (t, spk, sd_, n) in enumerate(zip(b["texts"], b["spks"], b["seeds"], b["samples"]))]

        def bucket(row, y_len):
            b = row["batch"]
            lens = [ref.encode(weights[0], model, ref.text_ids(t), spk, s["length_scale"])[3]
                    for t, spk in zip(b["texts"], b["spks"])]
            return next(m for m in s["mel_buckets"] if m >= tts_check.fix_len(max(lens)))

        kept = [i for i, r in enumerate(rows) if r["wav"] is not None]
        rest = [i for i, r in enumerate(rows) if r["wav"] is None]
        random.Random(self.check_seed).shuffle(rest)
        order = [kept[i] for i in tts_check.order([rows[k] for k in kept], self.check_seed)] + rest
        return tts_check.check(self.sys.cfg, weights, rows, order, self.cell["check_rows"], self.device,
                               exact_bucket=bucket, control=control)


def work_of(cfg: dict, item: dict):
    """The algorithm's work of one traced batch."""
    s = cfg["synthesis"]
    return synthesis(cfg["model"], cfg["vocoder"], item["batch"], item["t_bucket"], item["m_bucket"],
                     s["n_timesteps"], denoise=s["denoiser_strength"] > 0)


def outcome(record) -> tuple:
    """(rows synthesised in the window, none failed: a failure raises)."""
    return sum(len(b["texts"]) for b in record.items), 0
