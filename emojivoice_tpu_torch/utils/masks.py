"""Mask / alignment-path helpers (PyTorch port of ``emojivoice_tpu.utils.masks``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def sequence_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """Boolean mask ``(B, max_length)``; True where position < length."""
    pos = torch.arange(max_length, device=lengths.device, dtype=lengths.dtype)
    return pos[None, :] < lengths[:, None]


def fix_len_compatibility(length: int, num_downsamplings_in_unet: int = 2) -> int:
    """Round length up to a multiple of 2**num_downsamplings."""
    factor = 2 ** num_downsamplings_in_unet
    return int(-(-length // factor) * factor)


def generate_path(duration: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Durations ``(B, T_text)`` → binary monotone alignment ``(B, T_text, T_mel)``:
    row x is set for mel frames ``[cum(x-1), cum(x))``, then masked."""
    t_y = mask.shape[2]
    cum = torch.cumsum(duration, dim=1)
    pos = torch.arange(t_y, device=duration.device, dtype=duration.dtype)
    path_cum = (pos[None, None, :] < cum[:, :, None]).to(mask.dtype)
    path = path_cum - F.pad(path_cum, (0, 0, 1, 0))[:, :-1]
    return path * mask


def intersperse(seq, item=0):
    """Insert `item` between and around every element (host-side list)."""
    out = [item] * (len(seq) * 2 + 1)
    out[1::2] = list(seq)
    return out
