"""Rotary positional embeddings on the first ``rope_dim`` dims of each head
(PyTorch port of ``emojivoice_tpu.ops.rope``, neg-half convention)."""

from __future__ import annotations

import numpy as np
import torch


def rope_tables(seq_len: int, d: int, base: float = 10_000.0):
    """cos/sin tables of shape (seq_len, d), computed in f64 then cast to f32."""
    theta = 1.0 / (base ** (np.arange(0, d, 2, dtype=np.float64) / d))
    idx_theta = np.arange(seq_len, dtype=np.float64)[:, None] * theta[None, :]
    idx_theta2 = np.concatenate([idx_theta, idx_theta], axis=1)
    return np.cos(idx_theta2).astype(np.float32), np.sin(idx_theta2).astype(np.float32)


def apply_rope(x: torch.Tensor, rope_dim: int, base: float = 10_000.0) -> torch.Tensor:
    """Rotate the first `rope_dim` feature dims of x (B, H, T, D); pass the rest.

    rotated = x·cos + [-x[d/2:], x[:d/2]]·sin.
    """
    d = rope_dim
    if d == 0:
        return x
    cos, sin = rope_tables(x.shape[-2], d, base)
    cos = torch.from_numpy(cos).to(device=x.device, dtype=x.dtype)
    sin = torch.from_numpy(sin).to(device=x.device, dtype=x.dtype)
    x_rope, x_pass = x[..., :d], x[..., d:]
    neg_half = torch.cat([-x_rope[..., d // 2:], x_rope[..., : d // 2]], dim=-1)
    return torch.cat([x_rope * cos + neg_half * sin, x_pass], dim=-1)
