"""HiFi-GAN MRF stage: the K1 CUDA kernel and its plain PyTorch twin.

``mrf_stage(x, weights, kernel_sizes, dilation_sizes)`` has the contract of
``emojivoice_tpu.ops.pallas_mrf.mrf_stage_pallas``: x (B, T, C) f32, and per
res-block a tuple (w1 (n_d, k, C, C), b1 (n_d, C), w2 (n_d, k, C, C),
b2 (n_d, C)) in channels-last layout ([dilation][tap][c_in][c_out]); it
returns the mean over res-blocks of ResBlock1(x), (B, T, C).

On a CUDA tensor it launches K1 (``csrc/mrf.cu``, or ``csrc/mrf_bf16.cu`` in
bf16 mode, built at first use) and raises if the build or a launch fails; it
never falls back.  On a CPU tensor
it runs ``mrf_stage_reference``, the same function written with
``F.conv1d`` from ``mrf_stage_unfused``.

Both go through one registered PyTorch op, ``emojivoice_tpu_torch::mrf_stage``
(``torch.library.custom_op``; its fake implementation gives ``empty_like(x)``),
so ``torch.export`` traces a vocoder through K1 as one node and an exported
program launches K1 on the card as the live vocoder does
(``inference/export.py``).  K1 has no backward, here as in the JAX package:
the op registers no autograd formula.

K1 has two numeric modes, picked by the weights' dtype as the Pallas kernel's
``_conv_same`` picks its MXU precision (``pallas_mrf.py:70-73``):

* f32 weights: K1 multiplies on the tensor cores in TF32 and keeps f32
  accuracy by splitting each operand in two TF32 numbers (``split_tf32``) and
  summing three products (``mrf_resblock_f32``).
* bf16 weights (the JAX package's ``mrf_stage_pallas(compute_dtype=bf16)``):
  each conv's input, the leaky-ReLU'd activation (zero outside the sequence),
  is rounded to bf16 at the tap product and multiplied once, bf16 × bf16 →
  f32 (``mrf_resblock_bf16``, a kernel of its own: the activation rounded
  once per tile into shared memory, each tap's products summed from zero and
  added in f32, one launch per dilation unit with the intermediate kept on
  chip where the shape rule fuses it).  x, the output, the biases, the intermediate, the residual adds
  and the mean over res-blocks stay f32.

Its weight operands are the contract's weights transposed to
[dilation][tap][c_out][c_in] (c_in fastest: the tensor cores take B K-major),
in f32 mode split (``pack_k_major``), and tiled in the order the kernel copies
them (``tile_k_major``, ``tile_k_major_bf16``; ``pack_weights`` does it all).
``mrf_stage`` takes either form on a CUDA tensor: a model packs once and hands
over ``PackedResblock``s; contract tuples are packed on the fly, to the same
bits.
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
BF16_BM = 128  # frames of one conv pass of a block of K1's bf16 mode (csrc/mrf_bf16.cu)

# K1 launches by (channel width, mode "f32" or "bf16"): one per ``mrf_stage`` call on a CUDA tensor
launches: collections.Counter = collections.Counter()
# Serving threads (HTTP handlers, the batching engine's worker) vocode at the same time, and ctypes
# releases the GIL during a call.  K1's host code sets a kernel's dynamic shared-memory size and then
# launches it; a second thread setting a smaller size in between would make that launch fail, and an
# unguarded ``+=`` can lose a count.  So one thread at a time enqueues a stage (the kernels themselves
# still run asynchronously, interleaved on the stream).
_launch_lock = threading.Lock()


class PackedResblock(NamedTuple):
    """One res-block's weights as K1's operands: per conv the tiled TF32
    parts (``tile_k_major``), (n_d, ⌈C/32⌉, k, 2, 8, C, 4) f32, or in bf16 mode
    the tiled bf16 weights (``tile_k_major_bf16``), (n_d, ⌈C/n⌉, k, ⌈C/n⌉,
    n/8, n, 8) with n = ``bf16_tile(C)``; biases (n_d, C) f32."""
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


def bf16_tile(c: int) -> int:
    """The n of K1's bf16 mode at C = c (``tile_n`` in csrc/mrf_bf16.cu):
    output channels of a block's pass and input channels of a weight stage."""
    return 32 if c <= 32 else 64


def tile_k_major_bf16(w: torch.Tensor) -> torch.Tensor:
    """K-major bf16 weights (n_d, k, c_out, c_in) → (n_d, ⌈c_out/n⌉, k,
    ⌈c_in/n⌉, n/8, n, 8) with n = ``bf16_tile(c_in)``: the order K1's bf16
    mode copies them in, one stage per (N chunk of n output channels, tap,
    K slice of n input channels), each stage n/8 groups of 8 input channels
    × n rows of 16 bytes, the no-swizzle K-major core-matrix layout the tensor
    cores read B in, so a stage is one contiguous bulk copy.  Both channel
    axes are zero-padded to whole chunks."""
    n_d, k, c_out, c_in = w.shape
    n = bf16_tile(c_in)
    w = F.pad(w, (0, -c_in % n, 0, -c_out % n))
    w = w.reshape(n_d, k, -(-c_out // n), n, -1, n // 8, 8)  # c_out → (chunk, row), c_in → (slice, group, 8)
    return w.permute(0, 2, 1, 4, 5, 3, 6).contiguous()


def pack_conv(w: torch.Tensor) -> torch.Tensor:
    """Contract weights (..., k, c_in, c_out) of one conv per dilation → K1's
    tiled operand: f32 split in two TF32 parts, or bf16 as it is."""
    if w.dtype == torch.bfloat16:
        return tile_k_major_bf16(w.transpose(-1, -2).contiguous())
    return tile_k_major(*pack_k_major(w))


def pack_weights(weights) -> list:
    """Contract weights (w1, b1, w2, b2) per res-block → ``PackedResblock``s,
    in the mode of the weights' dtype (f32 or bf16)."""
    return [PackedResblock(pack_conv(w1), b1.contiguous(), pack_conv(w2), b2.contiguous())
            for w1, b1, w2, b2 in weights]


def mrf_stage_reference(x: torch.Tensor, weights, kernel_sizes: Sequence[int],
                        dilation_sizes: Sequence[Sequence[int]]) -> torch.Tensor:
    """Plain PyTorch MRF stage: per res-block, per dilation,
    ``x += conv_{k,1}(lrelu(conv_{k,d}(lrelu(x))))``, then the mean.

    With bf16 weights (contract tuples whose w1, w2 are bf16) it is K1's bf16
    mode: each conv's input, the lrelu'd activation, is rounded to bf16 and
    both operands are convolved in f32.  A product of two bf16 numbers is exact
    in f32, so this differs from the kernel only in the order of the sums (on
    the card that needs cuDNN's TF32 off, or it rounds the operands again).

    It computes in x's dtype: a float64 x gives the same function with the
    same rounding points summed in float64, the witness of what the f32 sum
    order alone moves."""
    xc = x.transpose(1, 2)
    dt = x.dtype
    out = None
    for (w1, b1, w2, b2), k, dils in zip(weights, kernel_sizes, dilation_sizes):
        bf16 = w1.dtype == torch.bfloat16

        def act(t):
            t = F.leaky_relu(t, LRELU_SLOPE)
            return t.to(torch.bfloat16).to(dt) if bf16 else t

        cur = xc
        for di, d in enumerate(dils):
            t = F.conv1d(act(cur), w1[di].to(dt).permute(2, 1, 0), b1[di].to(dt), padding=(k * d - d) // 2,
                         dilation=d)
            t = F.conv1d(act(t), w2[di].to(dt).permute(2, 1, 0), b2[di].to(dt), padding=(k - 1) // 2)
            cur = cur + t
        out = cur if out is None else out + cur
    return (out / len(kernel_sizes)).transpose(1, 2)


def _check(x: torch.Tensor, packed, kernel_sizes, dilation_sizes) -> bool:
    """Raise on what K1 does not take; return the mode, True for bf16."""
    if x.dtype != torch.float32 or x.dim() != 3 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"mrf_stage: x must be a contiguous, 16-byte aligned (B, T, C) float32 tensor, got "
                         f"{tuple(x.shape)} {x.dtype} contiguous={x.is_contiguous()}")
    if not (len(packed) == len(kernel_sizes) == len(dilation_sizes)):
        raise ValueError("mrf_stage: one weight tuple, kernel size and dilation list per res-block")
    c = x.shape[2]
    bf16 = packed[0].w1.dtype == torch.bfloat16 if packed else False
    w_dtype = torch.bfloat16 if bf16 else torch.float32
    for rb, k, dils in zip(packed, kernel_sizes, dilation_sizes):
        if k % 2 == 0:
            raise ValueError(f"mrf_stage: kernel size {k} must be odd for a 'same' conv")
        for t, want in zip(rb, (w_dtype, torch.float32, w_dtype, torch.float32)):
            if t.device != x.device or t.dtype != want or not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError("mrf_stage: weights must be contiguous, 16-byte aligned on x's device, all float32 "
                                 "or w1 and w2 of every res-block bfloat16 (bf16 mode) with float32 biases")
        n_d = len(dils)
        n = bf16_tile(c)
        tiled = (n_d, -(-c // n), k, -(-c // n), n // 8, n, 8) if bf16 else (n_d, -(-c // KC), k, 2, KC // 4, c, 4)
        for w in (rb.w1, rb.w2):
            if tuple(w.shape) != tiled:
                raise ValueError(f"mrf_stage: weight shape {tuple(w.shape)} != {tiled}, the tiling of {(n_d, k, c, c)}")
        for b in (rb.b1, rb.b2):
            if tuple(b.shape) != (n_d, c):
                raise ValueError(f"mrf_stage: bias shape {tuple(b.shape)} != {(n_d, c)}")
    return bf16


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"K1 {what} launch failed: CUDA error {err} ({lib.mrf_error_string(err).decode()})")


@torch.library.custom_op("emojivoice_tpu_torch::mrf_stage", mutates_args=(),
                         schema="(Tensor x, Tensor[] operands, int[] kernel_sizes, int[] dilations, "
                                "int[] n_dilations) -> Tensor")
def _mrf_stage_op(x, operands, kernel_sizes, dilations, n_dilations):
    """The registered op behind ``mrf_stage``: `operands` is the res-blocks'
    (w1, b1, w2, b2) flattened, `dilations` the res-blocks' dilation lists
    concatenated, `n_dilations` their lengths."""
    weights = [tuple(operands[4 * r:4 * r + 4]) for r in range(len(kernel_sizes))]
    ends = [sum(n_dilations[:r + 1]) for r in range(len(n_dilations))]
    dils = [tuple(dilations[end - n:end]) for end, n in zip(ends, n_dilations)]
    if x.device.type == "cpu":
        # contiguous, as the kernel's output and the fake implementation are
        return mrf_stage_reference(x, weights, kernel_sizes, dils).contiguous()
    if x.device.type != "cuda":
        raise ValueError(f"mrf_stage: no kernel for device {x.device}")
    return _launch_k1(x, weights, kernel_sizes, dils)


@_mrf_stage_op.register_fake
def _mrf_stage_fake(x, operands, kernel_sizes, dilations, n_dilations):
    return torch.empty_like(x)


def _library(mode: str):
    """The built kernel library of a mode: ``csrc/mrf.cu`` (f32) or ``csrc/mrf_bf16.cu`` (bf16)."""
    from emojivoice_tpu_torch.kernels import build

    return build.load_mrf() if mode == "f32" else build.load_mrf_bf16()


def _launch_k1(x: torch.Tensor, weights, kernel_sizes, dilation_sizes) -> torch.Tensor:
    """K1 on a CUDA tensor: one ``mrf_resblock_f32`` (or, on bf16 weights,
    ``mrf_resblock_bf16``) call per res-block (each launches its convs or
    dilation units), raising on a failed build or launch."""
    packed = pack_weights(weights) if all(rb[0].dim() == 4 for rb in weights) else weights
    packed = [PackedResblock(*rb) for rb in packed]
    mode = "bf16" if _check(x, packed, kernel_sizes, dilation_sizes) else "f32"
    lib = _library(mode)
    resblock = getattr(lib, f"mrf_resblock_{mode}")
    b, t, c = x.shape
    out = torch.empty_like(x)
    cur = torch.empty_like(x)
    h = torch.empty_like(x)
    n = len(packed)
    with torch.cuda.device(x.device), _launch_lock:
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        for r, (rb, k, dils) in enumerate(zip(packed, kernel_sizes, dilation_sizes)):
            dil_arr = (ctypes.c_int * len(dils))(*dils)
            err = resblock(
                x.data_ptr(), out.data_ptr(), cur.data_ptr(), h.data_ptr(),
                rb.w1.data_ptr(), rb.b1.data_ptr(), rb.w2.data_ptr(), rb.b2.data_ptr(),
                b, t, c, k, len(dils), dil_arr, int(r > 0), 1.0 / n, stream)
            _raise_on(lib, err, f"mrf_resblock_{mode} at B={b} T={t} C={c} k={k}")
        launches[(c, mode)] += 1
    return out


def mrf_stage(x: torch.Tensor, weights, kernel_sizes: Tuple[int, ...],
              dilation_sizes: Tuple[Tuple[int, ...], ...]) -> torch.Tensor:
    """Fused MRF stage (B, T, C) → (B, T, C); see the module docstring.
    `weights`: contract tuples, or on a CUDA tensor ``PackedResblock``s; bf16
    w1/w2 select K1's bf16 mode."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"mrf_stage: no kernel for device {x.device}")
    return torch.ops.emojivoice_tpu_torch.mrf_stage(
        x, [t for rb in weights for t in rb], [int(k) for k in kernel_sizes],
        [int(d) for dils in dilation_sizes for d in dils], [len(dils) for dils in dilation_sizes])


def conv_taps(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, dilation: int = 1) -> torch.Tensor:
    """One of K1's convolutions alone, ``conv_{k,d}(lrelu(x)) + bias`` with
    'same' zero padding: x (B, T, C) f32 on the card, w (k, C, C) as
    [tap][c_in][c_out], f32 (3xTF32 mode) or bf16 (bf16 mode's one-conv
    kernel: lrelu(x) rounded to bf16, one product per tap), bias (C,).  For
    holding the tensor-core product against a reference; it is no part of
    ``mrf_stage``'s count."""
    if x.device.type != "cuda" or x.dtype != torch.float32 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError("conv_taps: x must be a contiguous (B, T, C) float32 CUDA tensor")
    b, t, c = x.shape
    k = w.shape[0]
    if tuple(w.shape) != (k, c, c) or tuple(bias.shape) != (c,) or k % 2 == 0:
        raise ValueError(f"conv_taps: w {tuple(w.shape)} and bias {tuple(bias.shape)} do not fit C={c}, odd k")
    mode = "bf16" if w.dtype == torch.bfloat16 else "f32"
    lib = _library(mode)
    tiled = pack_conv(w[None] if mode == "bf16" else w.float()[None])
    bias = bias.float().contiguous()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device), _launch_lock:
        err = getattr(lib, f"mrf_conv_{mode}")(x.data_ptr(), tiled.data_ptr(), bias.data_ptr(), None, out.data_ptr(),
                                               b, t, c, k, dilation, 0, 1.0,
                                               ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    _raise_on(lib, err, f"mrf_conv_{mode} at B={b} T={t} C={c} k={k} d={dilation}")
    return out

