"""Optimal-transport conditional flow matching (PyTorch port of
``emojivoice_tpu.models.cfm``): the fixed-step Euler sampler over t ∈ [0, 1]
on the U-Net estimator, and the training loss."""

from __future__ import annotations

import torch
import torch.nn as nn

from emojivoice_tpu_torch.config import CFMConfig, DecoderConfig
from emojivoice_tpu_torch.models.decoder import Decoder


class CFM(nn.Module):
    def __init__(self, cfg: CFMConfig, decoder: DecoderConfig, n_feats: int, n_spks: int = 1,
                 spk_emb_dim: int = 64, strict_mask: bool = False):
        super().__init__()
        self.cfg = cfg
        in_channels = 2 * n_feats + (spk_emb_dim if n_spks > 1 else 0)
        self.estimator = Decoder(decoder, in_channels, n_feats, strict_mask=strict_mask)

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

    def compute_loss(self, x1, mask, mu, spks=None, *, t: torch.Tensor, z: torch.Tensor, row_mask=None):
        """CFM training loss → (loss, y) with y the noisy interpolant.

        x1: target mel (B, T, n_feats); mask (B, T, 1); t (B, 1, 1) uniform
        draws and z (B, T, n_feats) normal draws, made by the caller in f32
        (``utils/prng.py``) or injected by a test, then cast to x1's dtype
        (bf16 under mixed precision) as the JAX package casts its f32 draws.
        row_mask (B,) weights whole rows (0 = a padding row that adds nothing
        to value or gradient); None is the reference behaviour.

        Reference quirk kept: the squared error is summed over all positions.
        The estimator's output is masked but the target u is not, so padded
        frames add a parameter-independent term to the value (zero gradient).
        The loss math is in f32.
        """
        sigma_min = self.cfg.sigma_min
        t, z = t.to(x1.dtype), z.to(x1.dtype)
        y = (1 - (1 - sigma_min) * t) * z + t * x1
        u = x1 - (1 - sigma_min) * z
        pred = self.estimator(y, mask, mu, t[:, 0, 0], spks)
        sq = torch.square(pred.float() - u.float())
        mask32 = mask.float()
        if row_mask is None:
            loss = sq.sum() / (mask32.sum() * u.shape[-1])
        else:
            w = row_mask.float()[:, None, None]
            loss = (sq * w).sum() / ((mask32 * w).sum() * u.shape[-1])
        return loss, y
