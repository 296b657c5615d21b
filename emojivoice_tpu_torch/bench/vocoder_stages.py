"""Each piece of the HiFi-GAN generator timed on its own on the card (twin
of ``tools/bench_vocoder_stages.py``).

    python -m emojivoice_tpu_torch.bench.vocoder_stages [--batch 8] [--frames 512]

HiFi-GAN v1 (random weights, seed 0) at the serving batch: ``conv_pre``,
each transposed-conv upsample (with its leaky ReLU), each MRF stage through
K1 (``ops/mrf.py::mrf_stage`` on the generator's packed weights, f32 and
K1's bf16 mode) and through its plain twin (``mrf_stage_reference``, cuDNN
f32 convs, TF32 off), and ``conv_post`` with its tanh, each on a seeded
random input of its shape; device ms by CUDA events, the median of
``--reps``.  Beside every MRF stage its FLOPs from the twin's docstring,
252·B·T·C² (three res-blocks of six convs, k in {3, 7, 11}), and from
``bench/mfu.py``'s count of the config (``mrf{i}_gflop``; the two must
agree), and each path's TFLOP/s of f32 work.

Key names mapped from the twin: ``mrf{i}_xla_ms`` → ``mrf{i}_plain_ms``,
``mrf{i}_pallas_ms`` → ``mrf{i}_k1_ms``; ``mrf{i}_k1_bf16_ms`` is new.  Prints
one JSON line with the card's name, count and power limit.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from emojivoice_tpu_torch.bench import util
from emojivoice_tpu_torch.bench.mfu import conv_products, mrf_stage_flops


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    util.add_device_args(ap)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--frames", type=int, default=512)
    ap.add_argument("--reps", type=int, default=8)
    args = ap.parse_args(argv)
    device = util.resolve_device(args.cpu, "bench.vocoder_stages")
    m, info = util.Measure(device), util.device_info(device)

    from emojivoice_tpu_torch import config
    from emojivoice_tpu_torch.ops.mrf import mrf_stage, mrf_stage_reference
    from emojivoice_tpu_torch.vocoder.hifigan import LRELU_SLOPE, HiFiGANGenerator

    cfg = config.get_preset(args.preset).vocoder
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        voc = HiFiGANGenerator(cfg).to(device).eval()
    rng = np.random.default_rng(0)
    b, t, c = args.batch, args.frames, cfg.upsample_initial_channel
    dils = tuple(tuple(d) for d in cfg.resblock_dilation_sizes)
    n_rb = len(cfg.resblock_kernel_sizes)
    out = {"backend": device.type, "batch": b, "frames": t}

    def rand(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(device)

    def timed(name, fn, gflop=None):
        with torch.no_grad():
            ms = util.event_ms(fn, device, args.reps, 2)
        out[f"{name}_ms"] = m(ms)
        if gflop is not None:
            out[f"{name}_tflops"] = m(gflop / ms)

    mel = rand(b, cfg.num_mels, t)
    timed("conv_pre", lambda: voc.conv_pre(mel))
    out["conv_pre_gflop"] = conv_products(b, t, cfg.num_mels, c, 7) / 1e9
    before = util.k1_calls()
    for i, (up, u) in enumerate(zip(voc.ups, cfg.upsample_rates)):
        x_up = rand(b, c, t)
        timed(f"ups{i}", lambda up=up, x=x_up: up(F.leaky_relu(x, LRELU_SLOPE)))
        t, c = t * u, c // 2
        x = rand(b, t, c)  # channels-last, as the serving forward hands a stage to mrf_stage
        stacked = [rb.stacked_weights() for rb in voc.resblocks[i * n_rb:(i + 1) * n_rb]]
        gflop = mrf_stage_flops(cfg, c, b, t) / 1e9
        out[f"mrf{i}_gflop"] = gflop
        out[f"mrf{i}_gflop_252btc2"] = 252 * b * t * c * c / 1e9 if cfg.resblock_kernel_sizes == (3, 7, 11) else None
        timed(f"mrf{i}_plain", lambda x=x, w=stacked: mrf_stage_reference(x, w, cfg.resblock_kernel_sizes, dils),
              gflop)
        timed(f"mrf{i}_k1", lambda x=x, i=i: mrf_stage(x, voc.stage_weights(i), cfg.resblock_kernel_sizes, dils),
              gflop)
        timed(f"mrf{i}_k1_bf16", lambda x=x, i=i: mrf_stage(x, voc.stage_weights(i, torch.bfloat16),
                                                           cfg.resblock_kernel_sizes, dils), gflop)
        with torch.no_grad():
            err = (mrf_stage(x, voc.stage_weights(i), cfg.resblock_kernel_sizes, dils)
                   - mrf_stage_reference(x, stacked, cfg.resblock_kernel_sizes, dils)).abs().max()
        out[f"mrf{i}_max_abs_err"] = float(err)
    out["k1_launches"] = util.k1_calls() - before
    x_post = rand(b, c, t)
    timed("conv_post", lambda: torch.tanh(voc.conv_post(F.leaky_relu(x_post, 0.01))))
    out.update(info)
    util.emit(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
