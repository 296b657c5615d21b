"""Where K1's time goes inside a block, without a profiler.

    python -m emojivoice_tpu_torch.kernels.probe_k1

Builds ``csrc/mrf.cu`` with ``-DK1_PHASE_CLOCKS`` (one consumer thread of
block 0 sums ``clock64()`` cycles per phase and prints them), launches one
convolution of K1 at the shapes of the HiFi-GAN v1 stages of a 512-frame
utterance, and prints each launch's time beside its bound (three TF32 products
per f32 product at 495 TFLOP/s).  The stamps cost a few per cent; compare
phases with each other, and take times from ``chip_smoke.py``.  Needs an
NVIDIA GPU and nvcc.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from emojivoice_tpu_torch.kernels.build import build_log, load_mrf
from emojivoice_tpu_torch.ops import mrf

SHAPES = [  # B, C, T, k, dilation
    (1, 256, 4096, 11, 1), (1, 128, 32768, 7, 3), (8, 128, 32768, 7, 3), (1, 64, 65536, 7, 1),
    (1, 32, 131072, 3, 1), (1, 32, 131072, 11, 5)]
TF32_FLOPS = 495e12


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("probe_k1 needs a CUDA device")
    defines = ("K1_PHASE_CLOCKS",)
    lib = load_mrf(defines)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    for line in build_log("mrf", defines).splitlines():
        if "ptxas info" in line and ("C7512" in line or "C7520" in line or "spill" in line and "0 bytes spill" not in line):
            print(f"[build] {line.strip()[:200]}")
    g = torch.Generator().manual_seed(0)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    for b, c, t, k, d in SHAPES:
        x = torch.randn((b, t, c), generator=g).cuda()
        w = mrf.tile_k_major(*mrf.pack_k_major((torch.randn((1, k, c, c), generator=g) * 0.01).cuda()))
        bias, out = torch.zeros(c, device="cuda"), torch.empty_like(x)

        def launch():
            err = lib.mrf_conv_f32(x.data_ptr(), w.data_ptr(), bias.data_ptr(), None, out.data_ptr(),
                                   b, t, c, k, d, 0, 1.0, stream)
            if err != 0:
                raise RuntimeError(f"mrf_conv_f32: CUDA error {err}")
        launch()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        launch()
        end.record()
        torch.cuda.synchronize()
        print(f"[probe] conv B={b} C={c} T={t} k={k} d={d}: {start.elapsed_time(end) * 1e3:.1f} us with the stamps, "
              f"bound {3 * 2 * k * c * c * t * b / TF32_FLOPS * 1e6:.1f} us", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
