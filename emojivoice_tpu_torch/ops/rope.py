"""Rotary positional embeddings on the first ``rope_dim`` dims of each head
(PyTorch port of ``emojivoice_tpu.ops.rope``, neg-half convention).

The cos/sin tables are made in numpy (f64, cast to f32) and copied to the
device once per (length, dim, base, device, dtype), then kept: a copy from
pageable host memory on every call would wait for the device's queue to drain
in the middle of an otherwise asynchronous dispatch.  ``torch.export`` reads
the kept tables, which become constants on the device of the program (an
exporter runs the model once first); a trace never adds to them.
"""

from __future__ import annotations

import numpy as np
import torch

# (seq_len, d, base, device, dtype) → (cos, sin) on that device
_TABLES: dict = {}


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
    key = (x.shape[-2], d, base, x.device, x.dtype)
    tables = _TABLES.get(key)
    if tables is None:
        with torch.inference_mode(False):  # a kept table must serve autograd later too
            tables = tuple(torch.from_numpy(t).to(device=x.device, dtype=x.dtype)
                           for t in rope_tables(x.shape[-2], d, base))
        if not torch.compiler.is_compiling():
            tables = _TABLES.setdefault(key, tables)
    cos, sin = tables
    x_rope, x_pass = x[..., :d], x[..., d:]
    neg_half = torch.cat([-x_rope[..., d // 2:], x_rope[..., : d // 2]], dim=-1)
    return torch.cat([x_rope * cos + neg_half * sin, x_pass], dim=-1)
