"""Where the time of one vocoder GAN step goes, at HiFi-GAN v1 width.

    python -m emojivoice_tpu_torch.training.profile_vocoder_step [--out FILE]

Builds ``create_vocoder_state(HiFiGANConfig())`` (weight-norm generator, MPD,
MSD, two Adams) on the card with TF32 off, takes batches of 16 × 32 frames
(8,192 samples) from the synthetic corpus of ``training/proof.py`` through
``make_segment_sampler``, and after three warm steps:

* times seven steps, each ended by a synchronise: the median step ms;
* runs one more step under ``torch.profiler``: the number of device
  activities (kernels, copies), their summed time against that step's own wall
  time (the device busy share; the profiler slows the host, so it is a lower
  bound on the unprofiled share), and the device time by kernel name, largest
  first.

Prints the readings and writes them as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import collections
import json
import statistics
import tempfile
import time
from pathlib import Path

import torch

BATCH, SEGMENT_FRAMES, REPEATS, TOP = 16, 32, 7, 12


def gan_step(cfg, device: torch.device, batch: int, segment_frames: int):
    """A timed GAN step: ``create_vocoder_state(cfg)`` (weight-norm
    generator, MPD, MSD, two Adams; seed 0) on `device` and a sampler of
    `batch` × `segment_frames`-frame segments of the synthetic corpus of
    ``training/proof.py`` → step(), which runs one ``vocoder_train_step`` on
    a fresh batch and returns its ms (ended by a synchronise on the card)."""
    from emojivoice_tpu_torch.training.proof import make_dataset
    from emojivoice_tpu_torch.training.vocoder_proof import load_pairs, make_segment_sampler
    from emojivoice_tpu_torch.training.vocoder_train import create_vocoder_state, vocoder_train_step

    with tempfile.TemporaryDirectory(prefix="emojivoice_profile_") as tmp:
        filelist, _ = make_dataset(Path(tmp), tuple(range(12)), n_utts=8, seconds=2.0, seed=0)
        paths = [row.split("|")[0] for row in filelist.read_text().splitlines()]
        pairs = load_pairs(paths, cfg, cfg.total_upsample, 1024, 1024, None)
    sample = make_segment_sampler(pairs, segment_frames, cfg.total_upsample, batch, seed=0)
    state = create_vocoder_state(cfg, seed=0, device=device)

    def step():
        data = {k: torch.from_numpy(v).to(device) for k, v in sample().items()}
        t = time.perf_counter()
        vocoder_train_step(state, data)
        if device.type == "cuda":
            torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3
    return step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="chiprun_out/profile_vocoder_step.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_vocoder_step needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from emojivoice_tpu_torch.config import HiFiGANConfig

    cfg = HiFiGANConfig()
    step = gan_step(cfg, torch.device("cuda"), BATCH, SEGMENT_FRAMES)

    for _ in range(3):
        step()
    step_ms = [step() for _ in range(REPEATS)]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        wall_ms = step()
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.time_range.elapsed_us() for e in device) / 1e3
    by_name = collections.Counter()
    counts = collections.Counter()
    for e in device:
        by_name[e.name] += e.time_range.elapsed_us() / 1e3
        counts[e.name] += 1
    top = [dict(kernel=name[:120], ms=ms, launches=counts[name]) for name, ms in by_name.most_common(TOP)]
    row = dict(device=torch.cuda.get_device_name(0), torch=torch.__version__, batch=BATCH,
               segment_samples=SEGMENT_FRAMES * cfg.total_upsample, step_ms=statistics.median(step_ms),
               step_ms_all=step_ms, profiled_wall_ms=wall_ms, device_activities=len(device), device_ms=device_ms,
               busy=device_ms / wall_ms if device else None, top_kernels=top)
    print(f"[profile] GAN step, batch {BATCH} x {row['segment_samples']} samples: {row['step_ms']:.3f} ms a step "
          f"(median of {REPEATS}) | profiled step: {row['device_activities']} device activities, "
          f"{device_ms:.3f} ms in {wall_ms:.3f} ms wall, busy {row['busy']}")
    for k in top:
        print(f"[profile]   {k['ms']:9.3f} ms  {k['launches']:5d} x  {k['kernel']}")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(row, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
