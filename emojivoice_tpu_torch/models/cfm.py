"""Conditional flow matching sampler (PyTorch port of
``emojivoice_tpu.models.cfm``, inference only): fixed-step Euler over
t ∈ [0, 1] on the U-Net estimator."""

from __future__ import annotations

import torch
import torch.nn as nn

from emojivoice_tpu_torch.config import CFMConfig, DecoderConfig
from emojivoice_tpu_torch.models.decoder import Decoder


class CFM(nn.Module):
    def __init__(self, cfg: CFMConfig, decoder: DecoderConfig, n_feats: int, n_spks: int = 1,
                 spk_emb_dim: int = 64):
        super().__init__()
        self.cfg = cfg
        in_channels = 2 * n_feats + (spk_emb_dim if n_spks > 1 else 0)
        self.estimator = Decoder(decoder, in_channels, n_feats)

    def forward(self, mu, mask, n_timesteps: int, z: torch.Tensor, spks=None):
        """Sample a mel given the prior `mu` (B, T, n_feats) and the initial
        noise `z` (B, T, n_feats), already scaled by the temperature."""
        return self.solve_euler(z.to(mu.dtype) * mask, mu, mask, n_timesteps, spks)

    def solve_euler(self, x, mu, mask, n_timesteps: int, spks=None):
        dt = 1.0 / n_timesteps
        for step in range(n_timesteps):
            t = torch.full((x.shape[0],), step * dt, dtype=x.dtype, device=x.device)
            x = x + dt * self.estimator(x, mask, mu, t, spks)
        return x
