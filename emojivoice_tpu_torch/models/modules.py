"""Shared building blocks (PyTorch port of ``emojivoice_tpu.models.modules``).

The JAX package's ``Conv1d``/``ConvTranspose1d`` become ``nn.Conv1d`` and
``nn.ConvTranspose1d`` inside the port's modules, which run channels-first
``(B, C, T)`` internally so that parameter names and layouts are the
reference checkpoint's.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class ChannelLayerNorm(nn.Module):
    """glow-tts LayerNorm over the channel axis of a (B, C, T) tensor, eps 1e-4."""

    def __init__(self, channels: int, eps: float = 1e-4):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        mean = x.mean(1, keepdim=True)
        var = ((x - mean) ** 2).mean(1, keepdim=True)
        x = (x - mean) * torch.rsqrt(var + self.eps)
        return x * self.gamma[None, :, None] + self.beta[None, :, None]


def mish(x):
    return x * torch.tanh(F.softplus(x))


def snake_beta(x, alpha_log: torch.Tensor, beta_log: torch.Tensor, eps: float = 1e-9):
    """SnakeBeta: x + 1/β · sin²(αx), with log-scale α and β."""
    alpha = torch.exp(alpha_log)
    beta = torch.exp(beta_log)
    s = torch.sin(x * alpha)
    return x + (1.0 / (beta + eps)) * s * s


def masked_fill(scores: torch.Tensor, mask: torch.Tensor, value: float = -1e4) -> torch.Tensor:
    """Reference-parity mask fill with −1e4, not −inf."""
    return scores.masked_fill(mask == 0, value)
