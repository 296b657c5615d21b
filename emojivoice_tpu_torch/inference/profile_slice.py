"""Where the time of a synthesis call goes, at emoji_multi + HiFi-GAN v1 width.

    python -m emojivoice_tpu_torch.inference.profile_slice [--out FILE] [--compute_dtype bf16] [--vocoder_dtype bf16]

Builds ``SynthesisPipeline.from_random(emoji_multi, seed=0)`` on the card
with TF32 off and sends ``bench.py``'s headline text (speaker 79, 10 Euler
steps, denoiser 0.00025, pcm16) as four requests: batch 1 two-stage, then
batch 1, 8 and 32 fused at the batch-1 mel bucket, in the pipeline's
precision (``--compute_dtype`` and ``--vocoder_dtype``, f32 by default; K1's
kernels in either mode are counted as K1).  For each request:

* three warm calls, then seven timed calls: the median wall ms, rtf_w
  and per-stage ms (the pipeline's CUDA events);
* one more call under ``torch.profiler``: the number of device activities
  (kernels, copies), their summed time, K1's share of it, and the wall time
  of that same call.  The device busy share is the one over the other, both
  from that one profiled call (the profiler slows the host, so it is a lower
  bound on the unprofiled busy share).

Prints one line per request and writes the rows as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from pathlib import Path

import torch

HEADLINE = ("The quick brown fox jumped over the lazy dog, and everyone at the "
            "party cheered loudly for the brave little robot.")  # bench.py's headline text
K1_KERNELS = ("conv_taps_kernel", "k1_bf16_unit_kernel")  # csrc/mrf.cu, csrc/mrf_bf16.cu
REPEATS = 7


def time_request(pipe, texts, spks, repeats: int, **kw) -> dict:
    """Median wall ms, rtf_w and per-stage ms of `repeats` calls."""
    walls, rtfs, stages = [], [], []
    for _ in range(repeats):
        t = time.perf_counter()
        res = pipe.synthesise(texts, spks=spks, seed=0, **kw)
        walls.append((time.perf_counter() - t) * 1e3)
        rtfs.append(res[0].rtf_w)
        stages.append(res[0].stage_ms)
    return dict(mel_length=res[0].mel_length, wall_ms=statistics.median(walls), wall_ms_all=walls,
                rtf_w=statistics.median(rtfs),
                stage_ms={k: statistics.median(s[k] for s in stages) for k in stages[0]})


def profile_request(pipe, texts, spks, **kw) -> dict:
    """Device activity of one call under torch.profiler, against that call's
    own wall time.  Without a CUDA device there is no device activity and
    the busy share is None (not measured)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if pipe.device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        pipe.synthesise(texts, spks=spks, seed=0, **kw)
        wall_ms = (time.perf_counter() - t) * 1e3
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.time_range.elapsed_us() for e in device) / 1e3
    k1_ms = sum(e.time_range.elapsed_us() for e in device if any(name in e.name for name in K1_KERNELS)) / 1e3
    return dict(profiled_wall_ms=wall_ms, device_activities=len(device), device_ms=device_ms,
                k1_device_ms=k1_ms, busy=device_ms / wall_ms if device else None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="chiprun_out/profile_slice.json")
    ap.add_argument("--compute_dtype", choices=("f32", "bf16"), default="f32")
    ap.add_argument("--vocoder_dtype", choices=("f32", "bf16"), default="f32")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from emojivoice_tpu_torch import config
    from emojivoice_tpu_torch.inference.pipeline import SynthesisPipeline
    from emojivoice_tpu_torch.utils.buckets import pick_bucket

    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    pipe = SynthesisPipeline.from_random(config.get_preset("emoji_multi"), seed=0, device="cuda",
                                         cleaners=("basic_cleaners",), compute_dtype=dtypes[args.compute_dtype],
                                         vocoder_dtype=dtypes[args.vocoder_dtype])
    kw = dict(n_timesteps=10, denoiser_strength=0.00025, keep_mel=False, pcm16=True)
    mel_length = pipe.synthesise([HEADLINE], spks=[79], seed=0, **kw)[0].mel_length
    bucket = pick_bucket(mel_length, pipe.mel_buckets)
    requests = [("batch 1, two-stage", 1, {}), ("batch 1, fused", 1, dict(fused=True, fused_mel_bucket=bucket)),
                ("batch 8, fused", 8, dict(fused=True, fused_mel_bucket=bucket)),
                ("batch 32, fused", 32, dict(fused=True, fused_mel_bucket=bucket))]
    rows = []
    for name, b, extra in requests:
        texts, spks = [HEADLINE] * b, [79] * b
        for _ in range(3):
            pipe.synthesise(texts, spks=spks, seed=0, **kw, **extra)
        row = dict(request=name, batch=b, mel_bucket=bucket, compute_dtype=args.compute_dtype,
                   vocoder_dtype=args.vocoder_dtype, **time_request(pipe, texts, spks, REPEATS, **kw, **extra))
        row.update(profile_request(pipe, texts, spks, **kw, **extra))
        rows.append(row)
        print(f"[profile] {name} (compute {args.compute_dtype}, vocoder {args.vocoder_dtype}): mel {row['mel_length']} @ {bucket}  wall {row['wall_ms']:.3f} ms  "
              f"rtf_w {row['rtf_w']:.5f}  stage ms "
              + " ".join(f"{k}={v:.3f}" for k, v in row["stage_ms"].items())
              + f"  | profiled call: {row['device_activities']} device activities, {row['device_ms']:.3f} ms "
              f"(K1 {row['k1_device_ms']:.3f}) in {row['profiled_wall_ms']:.3f} ms wall, busy {row['busy']:.3f}")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(device=torch.cuda.get_device_name(0), torch=torch.__version__, rows=rows),
                              indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
