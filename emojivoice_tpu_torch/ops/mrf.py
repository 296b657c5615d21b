"""HiFi-GAN MRF stage: the K1 CUDA kernel and its plain PyTorch twin.

``mrf_stage(x, weights, kernel_sizes, dilation_sizes)`` has the contract of
``emojivoice_tpu.ops.pallas_mrf.mrf_stage_pallas``: x (B, T, C) f32, and per
res-block a tuple (w1 (n_d, k, C, C), b1 (n_d, C), w2 (n_d, k, C, C),
b2 (n_d, C)) in channels-last layout ([dilation][tap][c_in][c_out]); it
returns the mean over res-blocks of ResBlock1(x), (B, T, C).

On a CUDA tensor it launches K1 (``csrc/mrf.cu``, built at first use) and
raises if the build or a launch fails; it never falls back.  On a CPU tensor
it runs ``mrf_stage_reference``, the same function written with
``F.conv1d`` from ``mrf_stage_unfused``.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

LRELU_SLOPE = 0.1

# K1 launches by channel width: one per ``mrf_stage`` call on a CUDA tensor
launches: collections.Counter = collections.Counter()


def mrf_stage_reference(x: torch.Tensor, weights, kernel_sizes: Sequence[int],
                        dilation_sizes: Sequence[Sequence[int]]) -> torch.Tensor:
    """Plain PyTorch MRF stage: per res-block, per dilation,
    ``x += conv_{k,1}(lrelu(conv_{k,d}(lrelu(x))))``, then the mean."""
    xc = x.transpose(1, 2)
    out = None
    for (w1, b1, w2, b2), k, dils in zip(weights, kernel_sizes, dilation_sizes):
        cur = xc
        for di, d in enumerate(dils):
            t = F.leaky_relu(cur, LRELU_SLOPE)
            t = F.conv1d(t, w1[di].permute(2, 1, 0), b1[di], padding=(k * d - d) // 2, dilation=d)
            t = F.leaky_relu(t, LRELU_SLOPE)
            t = F.conv1d(t, w2[di].permute(2, 1, 0), b2[di], padding=(k - 1) // 2)
            cur = cur + t
        out = cur if out is None else out + cur
    return (out / len(kernel_sizes)).transpose(1, 2)


def _check(x: torch.Tensor, weights, kernel_sizes, dilation_sizes) -> None:
    if x.dtype != torch.float32 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"mrf_stage: x must be a contiguous (B, T, C) float32 tensor, got "
                         f"{tuple(x.shape)} {x.dtype} contiguous={x.is_contiguous()}")
    if not (len(weights) == len(kernel_sizes) == len(dilation_sizes)):
        raise ValueError("mrf_stage: one weight tuple, kernel size and dilation list per res-block")
    c = x.shape[2]
    for (w1, b1, w2, b2), k, dils in zip(weights, kernel_sizes, dilation_sizes):
        if k % 2 == 0:
            raise ValueError(f"mrf_stage: kernel size {k} must be odd for a 'same' conv")
        n_d = len(dils)
        for w in (w1, w2):
            if tuple(w.shape) != (n_d, k, c, c):
                raise ValueError(f"mrf_stage: weight shape {tuple(w.shape)} != {(n_d, k, c, c)}")
        for b in (b1, b2):
            if tuple(b.shape) != (n_d, c):
                raise ValueError(f"mrf_stage: bias shape {tuple(b.shape)} != {(n_d, c)}")
        for t in (w1, b1, w2, b2):
            if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
                raise ValueError("mrf_stage: weights must be contiguous float32 on x's device")


def mrf_stage(x: torch.Tensor, weights, kernel_sizes: Tuple[int, ...],
              dilation_sizes: Tuple[Tuple[int, ...], ...]) -> torch.Tensor:
    """Fused MRF stage (B, T, C) → (B, T, C); see the module docstring."""
    if x.device.type == "cpu":
        return mrf_stage_reference(x, weights, kernel_sizes, dilation_sizes)
    if x.device.type != "cuda":
        raise ValueError(f"mrf_stage: no kernel for device {x.device}")
    _check(x, weights, kernel_sizes, dilation_sizes)
    from emojivoice_tpu_torch.kernels.build import load_mrf

    lib = load_mrf()
    b, t, c = x.shape
    out = torch.empty_like(x)
    cur = torch.empty_like(x)
    h = torch.empty_like(x)
    n = len(weights)
    with torch.cuda.device(x.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        for r, ((w1, b1, w2, b2), k, dils) in enumerate(zip(weights, kernel_sizes, dilation_sizes)):
            dil_arr = (ctypes.c_int * len(dils))(*dils)
            err = lib.mrf_resblock_f32(
                x.data_ptr(), out.data_ptr(), cur.data_ptr(), h.data_ptr(),
                w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                b, t, c, k, len(dils), dil_arr, int(r > 0), 1.0 / n, stream)
            if err != 0:
                raise RuntimeError(f"K1 mrf_resblock_f32 launch failed: CUDA error {err} "
                                   f"({lib.mrf_error_string(err).decode()}) at B={b} T={t} C={c} k={k}")
    launches[c] += 1
    return out
