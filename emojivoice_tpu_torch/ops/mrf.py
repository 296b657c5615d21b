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

K1 multiplies on the tensor cores in TF32 and keeps f32 accuracy by splitting
each operand in two TF32 numbers (``split_tf32``) and summing three products.
Its weight operands are the contract's weights transposed to
[dilation][tap][c_out][c_in], split (``pack_k_major``) and tiled in the order
the kernel copies them (``tile_k_major``; ``pack_weights`` does both).  ``mrf_stage``
takes either form on a CUDA tensor: a model packs once and hands over
``PackedResblock``s; contract tuples are packed on the fly, to the same bits.
"""

from __future__ import annotations

import collections
import ctypes
import threading
from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

LRELU_SLOPE = 0.1
KC = 32  # input channels per slice of K1's tiled weights (csrc/mrf.cu)

# K1 launches by channel width: one per ``mrf_stage`` call on a CUDA tensor
launches: collections.Counter = collections.Counter()
# Serving threads (HTTP handlers, the batching engine's worker) vocode at the same time, and ctypes
# releases the GIL during a call.  K1's host code sets a kernel's dynamic shared-memory size and then
# launches it; a second thread setting a smaller size in between would make that launch fail, and an
# unguarded ``+=`` can lose a count.  So one thread at a time enqueues a stage (the kernels themselves
# still run asynchronously, interleaved on the stream).
_launch_lock = threading.Lock()


class PackedResblock(NamedTuple):
    """One res-block's weights as K1's operands: per conv the tiled TF32
    parts (``tile_k_major``), (n_d, ⌈C/32⌉, k, 2, 8, C, 4); biases (n_d, C)."""
    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor


def _round_tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 → the nearest TF32 number (10 mantissa bits, the low 13 bits zero),
    ties away from zero like ``cvt.rna.tf32.f32``: bit arithmetic on the
    sign-magnitude pattern.  A value that would round past the largest finite
    number is truncated instead."""
    bits = t.contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    truncated = (bits & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(rounded), rounded, truncated)


def split_tf32(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``hi = tf32(t)``, ``lo = tf32(t − hi)``: two TF32 numbers whose sum is
    within 2⁻²¹ relative of the f32 input."""
    hi = _round_tf32(t)
    return hi, _round_tf32(t - hi)


def pack_k_major(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Contract weights (..., k, c_in, c_out) → (w_hi, w_lo), each
    (..., k, c_out, c_in): c_in made the fastest axis (the tensor cores take
    B K-major), then split in two TF32 parts."""
    return split_tf32(w.transpose(-1, -2).contiguous())


def tile_k_major(w_hi: torch.Tensor, w_lo: torch.Tensor) -> torch.Tensor:
    """K-major parts (n_d, k, c_out, c_in) → (n_d, ⌈c_in/32⌉, k, 2, 8, c_out, 4),
    the order K1 consumes them in: per 32-channel slice of c_in and tap, hi then
    lo, each as 8 groups of 4 input channels × c_out rows of 16 bytes, which
    is the layout the tensor core reads from shared memory, so a slice is
    copied as it lies.  c_in is zero-padded to whole slices."""
    n_d, k, c_out, c_in = w_hi.shape
    parts = torch.stack((w_hi, w_lo), dim=2)  # (n_d, k, 2, c_out, c_in)
    parts = F.pad(parts, (0, -c_in % KC))
    parts = parts.reshape(n_d, k, 2, c_out, -1, KC // 4, 4)  # c_in → (slice, group, 4)
    return parts.permute(0, 4, 1, 2, 5, 3, 6).contiguous()


def pack_weights(weights) -> list:
    """Contract weights (w1, b1, w2, b2) per res-block → ``PackedResblock``s."""
    return [PackedResblock(tile_k_major(*pack_k_major(w1)), b1.contiguous(),
                           tile_k_major(*pack_k_major(w2)), b2.contiguous())
            for w1, b1, w2, b2 in weights]


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


def _check(x: torch.Tensor, packed, kernel_sizes, dilation_sizes) -> None:
    if x.dtype != torch.float32 or x.dim() != 3 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"mrf_stage: x must be a contiguous, 16-byte aligned (B, T, C) float32 tensor, got "
                         f"{tuple(x.shape)} {x.dtype} contiguous={x.is_contiguous()}")
    if not (len(packed) == len(kernel_sizes) == len(dilation_sizes)):
        raise ValueError("mrf_stage: one weight tuple, kernel size and dilation list per res-block")
    c = x.shape[2]
    for rb, k, dils in zip(packed, kernel_sizes, dilation_sizes):
        if k % 2 == 0:
            raise ValueError(f"mrf_stage: kernel size {k} must be odd for a 'same' conv")
        n_d = len(dils)
        tiled = (n_d, -(-c // KC), k, 2, KC // 4, c, 4)
        for w in (rb.w1, rb.w2):
            if tuple(w.shape) != tiled:
                raise ValueError(f"mrf_stage: weight shape {tuple(w.shape)} != {tiled}, the tiling of {(n_d, k, c, c)}")
        for b in (rb.b1, rb.b2):
            if tuple(b.shape) != (n_d, c):
                raise ValueError(f"mrf_stage: bias shape {tuple(b.shape)} != {(n_d, c)}")
        for t in rb:
            if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError("mrf_stage: weights must be contiguous, 16-byte aligned float32 on x's device")


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"K1 {what} launch failed: CUDA error {err} ({lib.mrf_error_string(err).decode()})")


def mrf_stage(x: torch.Tensor, weights, kernel_sizes: Tuple[int, ...],
              dilation_sizes: Tuple[Tuple[int, ...], ...]) -> torch.Tensor:
    """Fused MRF stage (B, T, C) → (B, T, C); see the module docstring.
    `weights`: contract tuples, or on a CUDA tensor ``PackedResblock``s."""
    if x.device.type == "cpu":
        return mrf_stage_reference(x, weights, kernel_sizes, dilation_sizes)
    if x.device.type != "cuda":
        raise ValueError(f"mrf_stage: no kernel for device {x.device}")
    packed = weights if all(isinstance(rb, PackedResblock) for rb in weights) else pack_weights(weights)
    _check(x, packed, kernel_sizes, dilation_sizes)
    from emojivoice_tpu_torch.kernels.build import load_mrf

    lib = load_mrf()
    b, t, c = x.shape
    out = torch.empty_like(x)
    cur = torch.empty_like(x)
    h = torch.empty_like(x)
    n = len(packed)
    with torch.cuda.device(x.device), _launch_lock:
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        for r, (rb, k, dils) in enumerate(zip(packed, kernel_sizes, dilation_sizes)):
            dil_arr = (ctypes.c_int * len(dils))(*dils)
            err = lib.mrf_resblock_f32(
                x.data_ptr(), out.data_ptr(), cur.data_ptr(), h.data_ptr(),
                rb.w1.data_ptr(), rb.b1.data_ptr(), rb.w2.data_ptr(), rb.b2.data_ptr(),
                b, t, c, k, len(dils), dil_arr, int(r > 0), 1.0 / n, stream)
            _raise_on(lib, err, f"mrf_resblock_f32 at B={b} T={t} C={c} k={k}")
        launches[c] += 1
    return out


def conv_taps(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, dilation: int = 1) -> torch.Tensor:
    """One of K1's convolutions alone, ``conv_{k,d}(lrelu(x)) + bias`` with
    'same' zero padding: x (B, T, C) f32 on the card, w (k, C, C) as
    [tap][c_in][c_out], bias (C,).  For holding the tensor-core product
    against a reference; it is no part of ``mrf_stage``'s count."""
    if x.device.type != "cuda" or x.dtype != torch.float32 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError("conv_taps: x must be a contiguous (B, T, C) float32 CUDA tensor")
    b, t, c = x.shape
    k = w.shape[0]
    if tuple(w.shape) != (k, c, c) or tuple(bias.shape) != (c,) or k % 2 == 0:
        raise ValueError(f"conv_taps: w {tuple(w.shape)} and bias {tuple(bias.shape)} do not fit C={c}, odd k")
    from emojivoice_tpu_torch.kernels.build import load_mrf

    lib = load_mrf()
    tiled = tile_k_major(*pack_k_major(w.float()[None]))
    bias = bias.float().contiguous()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device), _launch_lock:
        err = lib.mrf_conv_f32(x.data_ptr(), tiled.data_ptr(), bias.data_ptr(), None, out.data_ptr(),
                               b, t, c, k, dilation, 0, 1.0, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    _raise_on(lib, err, f"mrf_conv_f32 at B={b} T={t} C={c} k={k} d={dilation}")
    return out
