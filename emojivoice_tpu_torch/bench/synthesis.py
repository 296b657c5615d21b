"""End-to-end synthesis RTF at 10 Euler steps on the card (twin of ``bench.py``).

    python -m emojivoice_tpu_torch.bench.synthesis [--skip_sweep] [--compute_dtype bf16] [--vocoder_dtype bf16]
        [--eager]

Builds ``SynthesisPipeline.from_random(<preset>, seed=0)`` (emoji_multi +
HiFi-GAN v1 at full width, random weights), sizes the headline text's mel
bucket from one two-stage call, and times ``--repeats`` batch-1 fused calls
at that bucket (10 steps, pcm16, the denoiser at 0.00025, speaker 79).  RTF
is the reference's formula, wall seconds · 22050 / samples, from enqueue to
the host copy of the audio (``SynthesisResult.rtf_w``).  Every timed call
comes before every profiled one: after its first ``torch.profiler`` session
a process's calls ran slower on the card (PERF.md).  Prints ONE JSON line:

    {"metric": "rtf_e2e_10steps", "value": <median RTF>, "unit": "rtf",
     "vs_baseline": <0.02 / value>, "provenance": {...}, "device": ..., "count": ..., "power_limit_w": ...}

``vs_baseline`` > 1 is faster than BASELINE.md's target RTF 0.02.  Beside
the twin's keys: the min and median wall ms and RTF, and from one call under
``torch.profiler`` its device ms and busy share, and the ``mrf_stage`` calls
that launched K1 in one call.  The sweep (on unless ``--skip_sweep``) runs mel
buckets 256 / 512 / 1024 × batch 1 / 8 / 32, fused, each bucket with a text
sized by ``text_for_bucket`` on the pipeline's own stage A, plus the 11 emoji
voices in one call (``emoji11_one_call``); every row carries the same
columns.  ``headline_vs_m<bucket>_b1`` holds the headline beside its
same-shape sweep row, and ``differ`` is true when their medians are further
apart than the larger of their interquartile ranges (F4: the JAX repo's
``BENCH_r05.json`` read 0.0117 against 0.00894 and nothing flagged it).

Keys mapped from the twin's provenance: ``jax`` → ``torch`` and ``cuda``;
``vocoder_backend`` ("pallas" / "xla") → ``k1_mode`` ("f32" / "bf16": the
card's vocoder always runs K1); ``vocoder_dtype`` is new (the precision
switches, ``--compute_dtype`` / ``--vocoder_dtype``).  Not ported:
``_wait_for_backend`` (a tunnel's), the compilation cache, the
``EMOJIVOICE_BENCH_SWEEP`` variable (the sweep is a flag).  The pipeline
serves through captured CUDA graphs (its default on the card) unless
``--eager``; ``graphs`` and ``graph_store`` (captures, capture ms per key,
the pool's bytes) say which.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time

import numpy as np
import torch

from emojivoice_tpu_torch.bench import util

STEPS, STRENGTH = 10, 0.00025
TEXT11 = "Hey there! I am an emoji voice."


def text_for_bucket(pipe, bucket: int, lo: int, spk: int, base: str):
    """A text whose PREDICTED mel length lands in (lo, bucket], probed
    through stage A only (``encode_texts`` and the encoder with its duration
    head, no decode): the word count of `base` repeated is scaled toward the
    bucket's midpoint until the prediction fits (``bench.py::_text_for_bucket``)."""
    from emojivoice_tpu_torch.inference.pipeline import upload
    from emojivoice_tpu_torch.utils.masks import fix_len_compatibility

    words = base.split()

    @torch.no_grad()
    def predict(text):
        x, xl, _, _ = pipe.encode_texts([text])
        enc = pipe.model.encode_text(upload(torch.from_numpy(x), pipe.device),
                                     upload(torch.from_numpy(xl), pipe.device), pipe._speakers([spk], 1), 1.0)
        return int(fix_len_compatibility(int(enc[2].max())))

    n = max(3, int(len(words) * bucket / 512))
    mid = (lo + bucket) // 2
    for _ in range(24):
        text = " ".join((words * ((n // len(words)) + 1))[:n])
        ml = predict(text)
        if lo < ml <= bucket:
            return text, ml
        n_new = max(3, round(n * mid / max(ml, 1)))
        n = n_new if n_new != n else n + (1 if ml <= lo else -1)
    raise RuntimeError(f"could not size a text for mel bucket {bucket}")


def iqr(xs) -> float:
    q1, _, q3 = statistics.quantiles(xs, n=4, method="inclusive") if len(xs) > 1 else (xs[0], 0, xs[0])
    return q3 - q1


def headline_vs_row(headline_rtfs, row_rtfs) -> dict:
    """The headline's RTFs beside its same-shape sweep row's: their medians,
    the spread (the larger interquartile range) and whether the medians are
    further apart than it."""
    h, r = statistics.median(headline_rtfs), statistics.median(row_rtfs)
    spread = max(iqr(headline_rtfs), iqr(row_rtfs))
    return {"headline_rtf": h, "row_rtf": r, "spread": spread, "differ": abs(h - r) > spread, "ratio": h / r}


def timed_calls(pipe, texts, spks, repeats: int, **kw) -> dict:
    """`repeats` calls after one warm call: RTFs, walls (ms), audio seconds,
    K1's ``mrf_stage`` calls in one call, and the call to profile later
    (``profile``: after every timed call of the run, since a process that
    has had a ``torch.profiler`` session can run slower for a while)."""
    def call(seed):
        return pipe.synthesise(texts, spks=spks, seed=seed, **kw)

    call(0)  # warm: allocations, plans
    rtfs, walls = [], []
    for i in range(repeats):
        t = time.perf_counter()
        rs = call(100 + i)
        walls.append((time.perf_counter() - t) * 1e3)
        rtfs.append(rs[0].rtf_w)
    audio = float(np.mean([len(r.wav) for r in rs])) / rs[0].sample_rate
    before = util.k1_calls()
    call(999)
    return dict(rtfs=rtfs, walls=walls, audio_s=audio, k1_launches=util.k1_calls() - before,
                mel_length=rs[0].mel_length, profile=lambda: util.profile_call(lambda: call(999), pipe.device))


def profile_rows(m: util.Measure, rows: list, timed: list) -> None:
    """Fill each row's device ms, activities and busy share from one profiled call."""
    for r, t in zip(rows, timed):
        prof = t["profile"]()
        r.update(device_ms=m(prof["device_ms"]), device_activities=m(prof["device_activities"]), busy=m(prof["busy"]))


def row(m: util.Measure, case: str, t: dict, batch: int, **extra) -> dict:
    wall = statistics.median(t["walls"])
    return {"case": case, **extra, "batch": batch,
            "rtf_w_per_utt": m(statistics.median(t["rtfs"])), "rtf_w_min": m(min(t["rtfs"])),
            "utt_per_s": m(batch / wall * 1e3), "audio_s_per_utt": round(t["audio_s"], 3),
            "wall_ms": m(wall), "wall_ms_min": m(min(t["walls"])), "k1_launches": t["k1_launches"]}


def run_sweep(pipe, m: util.Measure, spk: int, buckets, batches, repeats: int, base: str, kw: dict):
    """Rows over mel buckets × batches, fused, and the 11 emoji voices in one
    call; the raw RTFs by (bucket, batch) for the F4 check; each timed row's
    timings (to profile later)."""
    from emojivoice_tpu_torch.apps.emoji import EMOJI_MAPPING

    rows, raw, timed = [], {}, []
    for bucket in buckets:
        try:
            text, ml_pred = text_for_bucket(pipe, bucket, bucket // 2, spk, base)
        except RuntimeError as e:  # a sizing failure drops the bucket's rows, not the bench
            rows.append({"case": f"m{bucket}", "error": f"{type(e).__name__}: {e}"})
            continue
        for batch in batches:
            case = f"m{bucket}_b{batch}"
            try:
                t = timed_calls(pipe, [text] * batch, [spk] * batch, repeats, fused=True, fused_mel_bucket=bucket,
                                **kw)
            except torch.cuda.OutOfMemoryError as e:
                rows.append({"case": case, "error": f"{type(e).__name__}: {e}"[:300]})
                continue
            raw[(bucket, batch)] = t["rtfs"]
            rows.append(row(m, case, t, batch, mel_bucket=bucket, pred_mel_len=ml_pred))
            timed.append((rows[-1], t))
            print(f"[bench] sweep {rows[-1]}", file=sys.stderr, flush=True)
    spks = list(EMOJI_MAPPING.values())
    t = timed_calls(pipe, [TEXT11] * len(spks), spks, repeats, **kw)
    rows.append(row(m, "emoji11_one_call", t, len(spks)))
    timed.append((rows[-1], t))
    print(f"[bench] sweep {rows[-1]}", file=sys.stderr, flush=True)
    return rows, raw, timed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    util.add_device_args(ap)
    ap.add_argument("--repeats", type=int, default=10, help="timed headline calls (the median is the value)")
    ap.add_argument("--sweep_repeats", type=int, default=5, help="timed calls per sweep row")
    ap.add_argument("--skip_sweep", action="store_true")
    ap.add_argument("--buckets", default="256,512,1024", help="the sweep's mel buckets")
    ap.add_argument("--batches", default="1,8,32", help="the sweep's batch sizes")
    ap.add_argument("--compute_dtype", choices=sorted(util.DTYPES), default="f32")
    ap.add_argument("--vocoder_dtype", choices=sorted(util.DTYPES), default="f32")
    ap.add_argument("--steps", type=int, default=STEPS)
    util.add_eager_arg(ap)
    args = ap.parse_args(argv)
    device = util.resolve_device(args.cpu, "bench.synthesis")
    m, info = util.Measure(device), util.device_info(device)

    from emojivoice_tpu_torch import config
    from emojivoice_tpu_torch.inference.pipeline import SynthesisPipeline
    from emojivoice_tpu_torch.utils.buckets import pick_bucket

    pipe = SynthesisPipeline.from_random(config.get_preset(args.preset), seed=0, device=device,
                                         cleaners=("basic_cleaners",), compute_dtype=util.DTYPES[args.compute_dtype],
                                         vocoder_dtype=util.DTYPES[args.vocoder_dtype],
                                         graphs=False if args.eager else None)
    kw = dict(n_timesteps=args.steps, denoiser_strength=STRENGTH, keep_mel=False, pcm16=True)
    t0 = time.perf_counter()
    first = pipe.synthesise([util.HEADLINE], spks=[args.spk], seed=0, **kw)[0]
    m_bucket = pick_bucket(first.mel_length, pipe.mel_buckets)
    print(f"[bench] {device} two-stage first run {time.perf_counter() - t0:.1f} s, mel_len={first.mel_length} "
          f"bucket={m_bucket}", file=sys.stderr, flush=True)
    head = timed_calls(pipe, [util.HEADLINE], [args.spk], args.repeats, fused=True, fused_mel_bucket=m_bucket, **kw)
    value = statistics.median(head["rtfs"])
    print(f"[bench] audio {head['audio_s']:.2f} s/utt, RTFs={['%.4f' % r for r in head['rtfs']]}", file=sys.stderr)
    provenance = {
        "device_kind": info["device"], "backend": device.type, "torch": torch.__version__,
        "cuda": torch.version.cuda, "path": "fused_single_dispatch", "k1_mode": util.k1_mode(pipe),
        "compute_dtype": args.compute_dtype, "vocoder_dtype": args.vocoder_dtype, "pcm16": True, "denoiser": True,
        "n_timesteps": args.steps, "mel_bucket": m_bucket, "batch": 1, "audio_s_per_utt": round(head["audio_s"], 3),
        **{k: v for k, v in row(m, "headline", head, 1).items() if k not in ("case", "batch", "audio_s_per_utt")},
    }
    timed = [(provenance, head)]
    report = {"metric": "rtf_e2e_10steps", "value": m(value), "unit": "rtf", "vs_baseline": m.ratio(0.02, value),
              "provenance": provenance}
    if not args.skip_sweep:
        t0 = time.perf_counter()
        rows, raw, timed_rows = run_sweep(pipe, m, args.spk, [int(b) for b in args.buckets.split(",")],
                                          [int(b) for b in args.batches.split(",")], args.sweep_repeats,
                                          util.HEADLINE, kw)
        provenance["sweep"] = rows
        timed += timed_rows
        print(f"[bench] sweep took {time.perf_counter() - t0:.0f} s", file=sys.stderr)
        if (m_bucket, 1) in raw:
            check = headline_vs_row(head["rtfs"], raw[(m_bucket, 1)])
            report[f"headline_vs_m{m_bucket}_b1"] = {k: m(v) for k, v in check.items()}
            if check["differ"] and m.on_card:
                print(f"[bench] the headline ({check['headline_rtf']:.5f}) and its same-shape row m{m_bucket}_b1 "
                      f"({check['row_rtf']:.5f}) differ by more than their spread ({check['spread']:.5f})",
                      file=sys.stderr)
    profile_rows(m, *zip(*timed))  # after every timed call
    report.update(util.graphs_info(pipe))
    report.update(info)
    util.emit(report)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
