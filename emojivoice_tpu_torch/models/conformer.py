"""Conformer block, the decoder's other block type (PyTorch port of
``emojivoice_tpu.models.conformer``; the reference's ``ConformerWrapper``,
lucidrains ``conformer==0.3.2``, selected by ``down/mid/up_block_type=
"conformer"``).  On (B, T, C):

  x += ½·FFN₁(x)       LN → Linear(mult·dim) → SiLU → dropout → Linear → dropout
  x += Attn(x)         LN → Shaw relative-position attention, fused kv
                       projection, distances clamped to ±max_pos_emb (512)
  x += Conv(x)         LN → 1×1 (×2 expansion) → GLU → depthwise k = 31 with
                       calc_same_padding → BatchNorm → SiLU → 1×1 → dropout
  x += ½·FFN₂(x)
  x = LN(x)

Quirks of the reference kept on purpose, as the JAX package keeps them:

* the conv module ignores the sequence mask: padded frames reach the conv
  halo and the BatchNorm statistics, which are taken over all B × T frames;
* attention masks query and key with ``-finfo(dtype).max``, so a fully
  masked query row softmaxes to uniform attention;
* BatchNorm normalises with the biased variance and folds the unbiased one
  into its running average, momentum 0.1.  The running statistics are
  buffers: a training forward updates them in place, an eval forward uses
  them and leaves them alone.

The relative positions are gathered from the (b, h, t, 2M+1) table q·Eᵀ, as
the JAX module does, never from a (t, t, head_dim) embedding: at 1,536 mel
frames that tensor would be 604 MB a block in f32, kept for the backward.

Parameter and buffer names are the reference checkpoint's (``ff1.fn.norm``,
``ff1.fn.fn.net.{0,3}``, ``attn.norm``, ``attn.fn.{to_q,to_kv,to_out,
rel_pos_emb}``, ``conv.net.{0,2,4.conv,5,7}``, ``post_norm``), so a
reference-format state dict loads with ``strict=True``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from emojivoice_tpu_torch.parallel.mesh import sum_over


class BatchNorm(nn.BatchNorm1d):
    """``nn.BatchNorm1d``'s names, buffers and loading (a state dict without
    ``num_batches_tracked`` loads), with the JAX package's arithmetic written
    out on (B, C, T): statistics over (B, T), each step in the input's dtype,
    as ``TorchBatchNorm`` computes it under bf16; the running statistics are
    read, and updated, in that dtype too and stored back in their own.

    Over a data-parallel group (``sync_group``, set by ``training/state.py``)
    the statistics are the global batch's, as under JAX's sharded batch: the
    sums are all-reduced, differentiably, so that output and running
    statistics equal the one-device ones on every rank."""

    sync_group = None

    def forward(self, x):
        if self.training:
            n = x.numel() / x.shape[1]
            if self.sync_group is None:
                mean = x.mean(dim=(0, 2))
                var = torch.square(x - mean[:, None]).mean(dim=(0, 2))
            else:
                n = n * dist.get_world_size(self.sync_group)
                mean = sum_over(x.sum(dim=(0, 2)), self.sync_group) / n
                var = sum_over(torch.square(x - mean[:, None]).sum(dim=(0, 2)), self.sync_group) / n
            with torch.no_grad():
                unbiased = var.detach() * (n / max(n - 1.0, 1.0))
                m = self.momentum
                self.running_mean.copy_((1.0 - m) * self.running_mean.to(x.dtype) + m * mean.detach())
                self.running_var.copy_((1.0 - m) * self.running_var.to(x.dtype) + m * unbiased)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean.to(x.dtype), self.running_var.to(x.dtype)
        inv = torch.rsqrt(var + self.eps)
        return (x - mean[:, None]) * inv[:, None] * self.weight[:, None] + self.bias[:, None]


class _FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int, dropout: float):
        super().__init__()
        self.net = nn.Sequential(nn.Linear(dim, dim * mult), nn.SiLU(), nn.Dropout(dropout),
                                 nn.Linear(dim * mult, dim), nn.Dropout(dropout))

    def forward(self, x):
        return self.net(x)


class _PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.fn = fn

    def forward(self, x, *args):
        return self.fn(self.norm(x), *args)


class _Scale(nn.Module):
    def __init__(self, scale: float, fn: nn.Module):
        super().__init__()
        self.scale, self.fn = scale, fn

    def forward(self, x):
        return self.fn(x) * self.scale


def _dtype_scale(head_dim: int) -> dict:
    """head_dim^-½ rounded as each compute dtype rounds it (the JAX module
    raises a scalar of the input's dtype to −½)."""
    return {dt: float(torch.tensor(float(head_dim), dtype=dt) ** -0.5) for dt in (torch.float32, torch.bfloat16)}


class RelPosAttention(nn.Module):
    """Shaw relative-position attention: bias-free q and fused kv, a
    (2·max_pos_emb + 1, head_dim) distance table, dropout after ``to_out``."""

    def __init__(self, dim: int, heads: int, head_dim: int, dropout: float = 0.0, max_pos_emb: int = 512):
        super().__init__()
        inner = heads * head_dim
        self.heads, self.head_dim, self.max_pos_emb = heads, head_dim, max_pos_emb
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(dim, inner * 2, bias=False)
        self.to_out = nn.Linear(inner, dim)
        self.rel_pos_emb = nn.Embedding(2 * max_pos_emb + 1, head_dim)
        self.dropout = nn.Dropout(dropout)
        self._scale = _dtype_scale(head_dim)

    def forward(self, x, mask_bt=None):
        b, t, _ = x.shape

        def split(z):
            return z.view(b, t, self.heads, self.head_dim).transpose(1, 2)

        k, v = self.to_kv(x).chunk(2, dim=-1)
        q, k, v = split(self.to_q(x)), split(k), split(v)
        scale = self._scale[x.dtype]
        dots = torch.matmul(q, k.transpose(-2, -1)) * scale
        qe = torch.matmul(q, self.rel_pos_emb.weight.to(x.dtype).t()) * scale  # (b, h, t, 2M + 1)
        seq = torch.arange(t, device=x.device)
        dist = torch.clamp(seq[:, None] - seq[None, :], -self.max_pos_emb, self.max_pos_emb) + self.max_pos_emb
        dots = dots + torch.gather(qe, -1, dist.expand(b, self.heads, t, t))
        if mask_bt is not None:
            keep = mask_bt > 0
            pair = keep[:, None, :, None] & keep[:, None, None, :]
            dots = dots.masked_fill(~pair, -torch.finfo(dots.dtype).max)
        out = torch.matmul(torch.softmax(dots, dim=-1), v).transpose(1, 2).reshape(b, t, -1)
        return self.dropout(self.to_out(out))


class _DepthWiseConv1d(nn.Module):
    def __init__(self, channels: int, kernel_size: int, padding: tuple):
        super().__init__()
        self.padding = padding
        self.conv = nn.Conv1d(channels, channels, kernel_size, groups=channels)

    def forward(self, x):
        return self.conv(F.pad(x, self.padding))


class ConvModule(nn.Module):
    """LN → 1×1 → GLU → depthwise conv → BatchNorm → SiLU → 1×1 → dropout on
    (B, T, C), unmasked.  ``net`` holds the reference's nine slots; the
    channels-first turn of slot 1 is done in ``forward``."""

    def __init__(self, dim: int, expansion: int = 2, kernel_size: int = 31, dropout: float = 0.0):
        super().__init__()
        inner = dim * expansion
        pad = (kernel_size // 2, kernel_size // 2 - (kernel_size + 1) % 2)  # calc_same_padding
        self.net = nn.Sequential(nn.LayerNorm(dim, eps=1e-5), nn.Identity(), nn.Conv1d(dim, inner * 2, 1),
                                 nn.GLU(dim=1), _DepthWiseConv1d(inner, kernel_size, pad), BatchNorm(inner),
                                 nn.SiLU(), nn.Conv1d(inner, dim, 1), nn.Dropout(dropout))

    def forward(self, x):
        h = self.net[0](x).transpose(1, 2)
        for layer in list(self.net)[2:8]:  # a slice of the Sequential would build a new module each call
            h = layer(h)
        return self.net[8](h.transpose(1, 2))


class ConformerBlock(nn.Module):
    """Called as ``BasicTransformerBlock`` is inside the U-Net:
    ``forward(x (B, T, C), mask (B, T))``; defaults as the reference
    instantiates its wrapper (ff_mult 1, expansion 2, k = 31)."""

    def __init__(self, dim: int, heads: int = 4, head_dim: int = 64, dropout: float = 0.0, ff_mult: int = 1,
                 conv_expansion_factor: int = 2, conv_kernel_size: int = 31, max_pos_emb: int = 512):
        super().__init__()
        self.ff1 = _Scale(0.5, _PreNorm(dim, _FeedForward(dim, ff_mult, dropout)))
        self.attn = _PreNorm(dim, RelPosAttention(dim, heads, head_dim, dropout, max_pos_emb))
        self.conv = ConvModule(dim, conv_expansion_factor, conv_kernel_size, dropout)
        self.ff2 = _Scale(0.5, _PreNorm(dim, _FeedForward(dim, ff_mult, dropout)))
        self.post_norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x, mask_bt=None):
        x = x + self.ff1(x)
        x = x + self.attn(x, mask_bt)
        x = x + self.conv(x)
        x = x + self.ff2(x)
        return self.post_norm(x)
