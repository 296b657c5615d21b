"""Where K1's time goes inside a block, without a profiler; and K1's bf16 mode
against an earlier design of it, in turns on one card.

    python -m emojivoice_tpu_torch.kernels.probe_k1 [--old_source PATH] [--out FILE]

f32 mode: builds ``csrc/mrf.cu`` with ``-DK1_PHASE_CLOCKS`` (one consumer
thread of block 0 sums ``clock64()`` cycles per phase and prints them),
launches one convolution at the shapes of the HiFi-GAN v1 stages of a
512-frame utterance, and prints each launch's time beside its bound (three
TF32 products per f32 product at 495 TFLOP/s).

bf16 mode: builds ``csrc/mrf_bf16.cu`` the same way and prints its build's
registers, spills and ptxas notes, and the phases of one block of its
one-conv kernel and of its fused dilation unit at those shapes.  With
``--old_source``, a ``mrf.cu`` of the earlier design whose bf16 mode is
``mrf_conv_bf16`` / ``mrf_resblock_bf16`` on weights tiled (n_d, ⌈C/32⌉, k,
4, C, 8) (the port before its bf16 mode had a source of its own), it prints
that design's phases at the same shapes and both designs' one-conv error
against float64 beside cuDNN f32's, then times whole stages in turns (old,
new, ..., new, old: CUDA events, median of 10 each) at the four stage shapes,
at B = 8, C = 128, at the four stage shapes of one 80-frame streaming window
and at three batched shapes with wide channels: the new design by its shape
rules, and builds of it that force a route (``-DK1_BF16_ROUTE``: every unit
fused, or every unit as two one-conv launches) and the one-conv blocks' N
chunks (``-DK1_BF16_CHUNKS``), with the kernel launches of one stage read
from a CUDA graph capture (``kernels/launches.py``).  Those times set the shape rules in ``csrc/mrf_bf16.cu``.
``--out`` takes the readings as JSON.

The stamps cost a few per cent; compare phases with each other, and take
times from the unstamped builds.  Needs an NVIDIA GPU and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from emojivoice_tpu_torch.kernels import build
from emojivoice_tpu_torch.kernels.launches import kernel_launches
from emojivoice_tpu_torch.ops import mrf

SHAPES = [  # B, C, T, k, dilation
    (1, 256, 4096, 11, 1), (1, 128, 32768, 7, 3), (8, 128, 32768, 7, 3), (1, 64, 65536, 7, 1),
    (1, 32, 131072, 3, 1), (1, 32, 131072, 11, 5)]
TF32_FLOPS, BF16_FLOPS = 495e12, 989e12
KERNELS, DILATIONS = (3, 7, 11), ((1, 3, 5), (1, 3, 5), (1, 3, 5))
MEL, WINDOW = 512, 80
STAGES = [(1, 256, 8 * MEL), (1, 128, 64 * MEL), (1, 64, 128 * MEL), (1, 32, 256 * MEL), (8, 128, 64 * MEL)]
# where many tiles meet wide channels
BATCHED = [(2, 256, 8 * MEL), (4, 256, 8 * MEL), (8, 256, 8 * MEL), (16, 256, 8 * MEL), (32, 256, 8 * MEL),
           (2, 128, 64 * MEL), (4, 128, 64 * MEL), (32, 128, 64 * MEL)]
WINDOWS = [(1, 256, 8 * WINDOW), (1, 128, 64 * WINDOW), (1, 64, 128 * WINDOW), (1, 32, 256 * WINDOW)]
# builds of csrc/mrf_bf16.cu timed beside the shipped one: a forced route and, for two one-conv launches, a forced
# number of N chunks a block
VARIANTS = {"fused": ("K1_BF16_ROUTE=1",), "two_convs": ("K1_BF16_ROUTE=2", "K1_BF16_CHUNKS=1"),
            "two_convs_2chunks": ("K1_BF16_ROUTE=2", "K1_BF16_CHUNKS=2"),
            "two_convs_4chunks": ("K1_BF16_ROUTE=2", "K1_BF16_CHUNKS=4")}
CLOCKS = ("K1_PHASE_CLOCKS", "K1_BF16_ROUTE=1")  # the stamped build: its res-block entry fuses every unit


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _ms(fn, iters: int = 5) -> list:
    fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def old_tile_bf16(w: torch.Tensor) -> torch.Tensor:
    """The earlier design's bf16 tiling: contract weights (n_d, k, c_in, c_out)
    → (n_d, ⌈c_in/32⌉, k, 4, c_out, 8)."""
    w = w.transpose(-1, -2).contiguous()
    n_d, k, c_out, c_in = w.shape
    w = F.pad(w, (0, -c_in % 32)).reshape(n_d, k, c_out, -1, 4, 8)
    return w.permute(0, 3, 1, 4, 2, 5).contiguous()


def probe_f32() -> None:
    defines = ("K1_PHASE_CLOCKS",)
    lib = build.load_mrf(defines)
    for line in build.build_log("mrf", defines).splitlines():
        if "ptxas info" in line and ("C7512" in line or "C7520" in line or "spill" in line and "0 bytes spill" not in line):
            print(f"[build] {line.strip()[:200]}")
    g = torch.Generator().manual_seed(0)
    for b, c, t, k, d in SHAPES:
        x = torch.randn((b, t, c), generator=g).cuda()
        w = mrf.tile_k_major(*mrf.pack_k_major((torch.randn((1, k, c, c), generator=g) * 0.01).cuda()))
        bias, out = torch.zeros(c, device="cuda"), torch.empty_like(x)

        def launch():
            _check(lib.mrf_conv_f32(x.data_ptr(), w.data_ptr(), bias.data_ptr(), None, out.data_ptr(),
                                    b, t, c, k, d, 0, 1.0, _stream()), "mrf_conv_f32")
        launch()
        torch.cuda.synchronize()
        ms = _ms(launch, 1)[0]
        print(f"[probe] f32 conv B={b} C={c} T={t} k={k} d={d}: {ms * 1e3:.1f} us with the stamps, "
              f"bound {3 * 2 * k * c * c * t * b / TF32_FLOPS * 1e6:.1f} us", flush=True)


def _print_build(name: str, defines: tuple) -> None:
    """ptxas's report per kernel: registers, spills, and the wgmma serialization notes (C75xx) it gave."""
    entry, notes = "", {}
    for line in build.build(name, defines).with_suffix(".log").read_text().splitlines():
        kernel = re.search(r"unit_kernelI(\w+?)EEv", line)
        code = re.search(r"\((C75\d\d)\)", line)
        if code and kernel:
            notes.setdefault(kernel.group(1), set()).add(code.group(1))
        if "Compiling entry function" in line and kernel:
            entry = kernel.group(1)
        elif "spill" in line or ("ptxas info" in line and "registers" in line):
            print(f"[build] {name} {' '.join(defines)} {entry}: {line.strip()}  {sorted(notes.get(entry, ()))}")


def probe_bf16_phases(old_lib) -> None:
    """One block's phases: the new one-conv kernel and fused unit, and the old design's conv, at the probe's
    shapes."""
    lib = build.load_mrf_bf16(CLOCKS)
    g = torch.Generator().manual_seed(1)
    for b, c, t, k, d in SHAPES:
        x = torch.randn((b, t, c), generator=g).cuda()
        w = (torch.randn((1, k, c, c), generator=g) * 0.01).to(torch.bfloat16).cuda()
        bias = torch.zeros((1, c), device="cuda")
        out, cur, h = torch.empty_like(x), torch.empty_like(x), torch.empty_like(x)
        new_w = mrf.pack_conv(w)
        dils = (ctypes.c_int * 1)(d)
        runs = {
            "new one conv": lambda: lib.mrf_conv_bf16(x.data_ptr(), new_w.data_ptr(), bias.data_ptr(), None,
                                                      out.data_ptr(), b, t, c, k, d, 0, 1.0, _stream()),
            "new fused unit": lambda: lib.mrf_resblock_bf16(x.data_ptr(), out.data_ptr(), cur.data_ptr(), h.data_ptr(),
                                                            new_w.data_ptr(), bias.data_ptr(), new_w.data_ptr(),
                                                            bias.data_ptr(), b, t, c, k, 1, dils, 0, 1.0, _stream()),
        }
        if old_lib is not None:
            old_w = old_tile_bf16(w)
            runs["old conv"] = lambda: old_lib.mrf_conv_bf16(x.data_ptr(), old_w.data_ptr(), bias.data_ptr(), None,
                                                             out.data_ptr(), b, t, c, k, d, 0, 1.0, _stream())
        for name, run in runs.items():
            _check(run(), name)
            torch.cuda.synchronize()
            print(f"[probe] bf16 {name} B={b} C={c} T={t} k={k} d={d} (stamped build)", flush=True)


def _stage_runner(lib, packed, x):
    """One MRF stage in bf16 mode through `lib`'s mrf_resblock_bf16, as ops/mrf.py::_launch_k1 calls it."""
    b, t, c = x.shape
    out, cur, h = torch.empty_like(x), torch.empty_like(x), torch.empty_like(x)
    arrays = [(ctypes.c_int * len(d))(*d) for d in DILATIONS]

    def run():
        for r, (rb, k, d) in enumerate(zip(packed, KERNELS, DILATIONS)):
            _check(lib.mrf_resblock_bf16(x.data_ptr(), out.data_ptr(), cur.data_ptr(), h.data_ptr(),
                                         rb[0].data_ptr(), rb[1].data_ptr(), rb[2].data_ptr(), rb[3].data_ptr(),
                                         b, t, c, k, len(d), arrays[r], int(r > 0), 1.0 / len(KERNELS), _stream()),
                   "mrf_resblock_bf16")
        return out
    return run


def compare(old_lib) -> list:
    """Whole stages, old and new designs in turns, at the stage, batch-8 and window shapes."""
    new = build.load_mrf_bf16()
    variants = {name: build.load_mrf_bf16(defines) for name, defines in VARIANTS.items()}
    rows = []
    for i, (b, c, t) in enumerate(STAGES + WINDOWS + BATCHED):
        g = torch.Generator().manual_seed(200 + i)
        x = torch.randn((b, t, c), generator=g).cuda()
        w = [tuple(torch.randn(shape, generator=g) * 0.01 for shape in ((3, k, c, c), (3, c), (3, k, c, c), (3, c)))
             for k in KERNELS]
        w16 = [(w1.to(torch.bfloat16).cuda(), b1.cuda(), w2.to(torch.bfloat16).cuda(), b2.cuda()) for w1, b1, w2, b2 in w]
        new_packed = mrf.pack_weights(w16)
        old_packed = [(old_tile_bf16(w1), b1, old_tile_bf16(w2), b2) for w1, b1, w2, b2 in w16]
        runs = {"old": _stage_runner(old_lib, old_packed, x), "new": _stage_runner(new, new_packed, x)}
        runs.update({name: _stage_runner(lib, new_packed, x) for name, lib in variants.items()})
        got = {name: run().clone() for name, run in runs.items()}
        torch.cuda.synchronize()
        times = {name: [] for name in runs}
        order = list(runs)
        for name in order + order[::-1]:
            times[name] += _ms(runs[name])
        ms = {name: statistics.median(v) for name, v in times.items()}
        gflop = 2 * sum(2 * len(d) * k for k, d in zip(KERNELS, DILATIONS)) * c * c * t * b / 1e9
        bound = gflop * 1e9 / BF16_FLOPS * 1e3
        launches = kernel_launches(runs["new"], ("k1_bf16_unit_kernel",))
        row = dict(B=b, C=c, T=t, ms=ms, bound_ms=bound, launches_per_stage=launches,
                   max_abs_new_vs_old=float((got["new"] - got["old"]).abs().max()),
                   max_abs_vs_new={n: float((v - got["new"]).abs().max()) for n, v in got.items()},
                   max_abs_routes=float((got["fused"] - got["two_convs"]).abs().max()))
        rows.append(row)
        print(f"[probe] bf16 stage B={b} C={c:3d} T={t:6d}: " + "  ".join(f"{n} {v:.4f} ms" for n, v in ms.items())
              + f"  bound {bound:.4f} ms (new {100 * bound / ms['new']:.1f} %, old {100 * bound / ms['old']:.1f} %)  "
              f"launches a stage (graph capture) {launches}  max |new − old| {row['max_abs_new_vs_old']:.3e}  "
              f"max |fused − two convs| {row['max_abs_routes']:.3e}  max |· − new| "
              + " ".join(f"{n} {v:.2e}" for n, v in row["max_abs_vs_new"].items()), flush=True)
    return rows


def precision(old_lib) -> dict:
    """One conv at (C, k, d) = (256, 11, 1) on signed x against float64 of the same rounded operands: the mean
    error and its sign toward zero, for the old design, the new one, and cuDNN's f32 conv."""
    g = torch.Generator().manual_seed(7)
    b, t, c, k, d = 1, 4096, 256, 11, 1
    x = torch.randn((b, t, c), generator=g).cuda()
    w = (torch.randn((1, k, c, c), generator=g) * 0.1).to(torch.bfloat16).cuda()
    bias = (torch.randn((c,), generator=g) * 0.1).cuda()
    a = F.leaky_relu(x, mrf.LRELU_SLOPE).to(torch.bfloat16)
    ref = F.conv1d(a.double().transpose(1, 2), w[0].double().permute(2, 1, 0), bias.double(), padding=k // 2,
                   dilation=d).transpose(1, 2)
    outs = {"cudnn_f32": F.conv1d(a.float().transpose(1, 2), w[0].float().permute(2, 1, 0), bias, padding=k // 2,
                                  dilation=d).transpose(1, 2)}
    libs = {"old": (old_lib, old_tile_bf16(w)), "new": (build.load_mrf_bf16(), mrf.pack_conv(w))}
    for name, (lib, tiled) in libs.items():
        out = torch.empty_like(x)
        _check(lib.mrf_conv_bf16(x.data_ptr(), tiled.data_ptr(), bias.data_ptr(), None, out.data_ptr(),
                                 b, t, c, k, d, 0, 1.0, _stream()), name)
        outs[name] = out
    torch.cuda.synchronize()
    res = {}
    for name, out in outs.items():
        e = out.double() - ref
        res[name] = dict(mean_abs=float(e.abs().mean()),
                         toward_zero=float((e * ref.sign()).mean() / e.abs().mean().clamp_min(1e-300)))
    print("[probe] bf16 one conv (256, 11, 1) against float64: " + "  ".join(
        f"{n} mean {v['mean_abs']:.3e} ({v['mean_abs'] / res['cudnn_f32']['mean_abs']:.2f}x cuDNN, signed toward "
        f"zero {v['toward_zero']:+.3f})" for n, v in res.items()), flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old_source", type=Path, default=None,
                    help="a csrc/mrf.cu of the earlier design, to time its bf16 mode beside the new one")
    ap.add_argument("--out", type=Path, default=None, help="write the stage readings here as JSON")
    ap.add_argument("--skip_f32", action="store_true", help="only the bf16 mode")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_k1 needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False  # cuDNN's f32 conv in f32, the error yardstick
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    # every build at once, one nvcc each
    build.build_many([("mrf_bf16", ()), ("mrf_bf16", CLOCKS), *(("mrf_bf16", d) for d in VARIANTS.values()),
                      *([("mrf", ("K1_PHASE_CLOCKS",))] if not args.skip_f32 else []),
                      *([("mrf_earlier", (), args.old_source), ("mrf_earlier", ("K1_PHASE_CLOCKS",), args.old_source)]
                        if args.old_source is not None else [])])
    old_lib = None
    if args.old_source is not None:
        old_lib = build._bind_k1(ctypes.CDLL(str(build.build("mrf_earlier", (), args.old_source))), "bf16")
        old_clocks = build._bind_k1(ctypes.CDLL(str(build.build("mrf_earlier", ("K1_PHASE_CLOCKS",),
                                                                args.old_source))), "bf16")
    for defines in ((), *VARIANTS.values()):
        _print_build("mrf_bf16", defines)
    if not args.skip_f32:
        probe_f32()
    probe_bf16_phases(old_clocks if old_lib is not None else None)
    if old_lib is not None:
        errors = precision(old_lib)
        rows = compare(old_lib)
        if args.out is not None:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            args.out.write_text(json.dumps({"device": smi, "one_conv_error": errors, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
