"""The vocoder's time on the card: K1 against plain convs, B = 1 and 8, and
the CFM's share (twin of ``tools/bench_vocoder.py``).

    python -m emojivoice_tpu_torch.bench.vocoder [--frames 512]

1. HiFi-GAN v1 (random weights, seed 0) on a random mel of ``--frames``
   frames at B = 1 and 8: the plain PyTorch convs (``forward_train`` under
   no_grad; TF32 off) against the serving forward with K1 on every MRF stage,
   in turns (plain, K1, K1, plain), and K1's bf16 mode; device ms by CUDA
   events, the median of ten.  At B = 1 the bf16 waveform's largest
   difference from the f32 plain one.
2. The CFM's per-step cost inside the fused synthesis call (batch 1, the
   headline text, its mel bucket, pcm16): (device ms at 10 steps − at 2
   steps) / 8, each the summed device activity of one profiled call (the
   median of three); what is left at 2 steps beside it.

Key names mapped from the twin: ``xla_b{B}_ms`` → ``plain_b{B}_ms``,
``pallas_b{B}_ms`` → ``k1_b{B}_ms``, ``pallas_bf16_b{B}_ms`` →
``k1_bf16_b{B}_ms``; ``fused_steps{2,10}_ms``, ``cfm_per_step_ms`` and
``non_cfm_ms`` are device ms here (the twin's were amortized loop slopes).
Prints one JSON line with the card's name, count and power limit.
"""

from __future__ import annotations

import argparse
import statistics

import numpy as np
import torch

from emojivoice_tpu_torch.bench import util


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    util.add_device_args(ap)
    ap.add_argument("--frames", type=int, default=512, help="mel frames (bench.synthesis's utterance bucket)")
    ap.add_argument("--iters", type=int, default=5, help="timed runs per turn (four turns)")
    args = ap.parse_args(argv)
    device = util.resolve_device(args.cpu, "bench.vocoder")
    m, info = util.Measure(device), util.device_info(device)

    from emojivoice_tpu_torch import config
    from emojivoice_tpu_torch.inference.pipeline import SynthesisPipeline
    from emojivoice_tpu_torch.utils.buckets import pick_bucket
    from emojivoice_tpu_torch.vocoder.hifigan import HiFiGANGenerator

    root = config.get_preset(args.preset)
    cfg = root.vocoder
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        voc = HiFiGANGenerator(cfg).to(device).eval()
    rng = np.random.default_rng(0)
    out = {"backend": device.type, "mel_frames": args.frames}
    for b in (1, 8):
        mel = torch.from_numpy(rng.normal(size=(b, args.frames, cfg.num_mels)).astype(np.float32)).to(device)

        @torch.no_grad()
        def plain():
            return voc.forward_train(mel)

        def k1():
            return voc(mel)

        def k1_bf16():
            return voc(mel, compute_dtype=torch.bfloat16)

        if device.type == "cuda":
            plain_ms, k1_ms = util.abba_ms(plain, k1)
        else:
            plain_ms, k1_ms = util.event_ms(plain, device, 1), util.event_ms(k1, device, 1)
        out[f"plain_b{b}_ms"] = m(plain_ms)
        out[f"k1_b{b}_ms"] = m(k1_ms)
        out[f"k1_bf16_b{b}_ms"] = m(util.event_ms(k1_bf16, device, 2 * args.iters))
        before = util.k1_calls()
        got = k1()
        out[f"k1_b{b}_launches"] = util.k1_calls() - before
        out[f"k1_b{b}_max_abs_err"] = float((got - plain()).abs().max())
        if b == 1:
            out["bf16_wav_max_abs_err"] = float((k1_bf16() - plain()).abs().max())

    pipe = SynthesisPipeline.from_random(root, seed=0, device=device, cleaners=("basic_cleaners",))
    kw = dict(spks=[args.spk], denoiser_strength=0.00025, keep_mel=False, pcm16=True)
    first = pipe.synthesise([util.HEADLINE], n_timesteps=10, seed=0, **kw)[0]
    m_bucket = pick_bucket(first.mel_length, pipe.mel_buckets)
    per_steps = {}
    for steps in (2, 10):
        def call(steps=steps):
            return pipe.synthesise([util.HEADLINE], n_timesteps=steps, seed=0, fused=True,
                                   fused_mel_bucket=m_bucket, **kw)

        call()
        profs = [util.profile_call(call, device) for _ in range(3)]
        per_steps[steps] = statistics.median(p["device_ms"] for p in profs)
        out[f"fused_steps{steps}_wall_ms"] = m(statistics.median(p["profiled_wall_ms"] for p in profs))
    per_step = (per_steps[10] - per_steps[2]) / 8.0
    out.update({"fused_steps2_ms": m(per_steps[2]), "fused_steps10_ms": m(per_steps[10]),
                "cfm_per_step_ms": m(per_step), "non_cfm_ms": m(per_steps[2] - 2 * per_step), "mel_bucket": m_bucket,
                **info})
    util.emit(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
