"""MatchaTTS acoustic model, text → mel (PyTorch port of
``emojivoice_tpu.models.matcha``, inference only).

Public tensors are channels-last like the JAX model's.  Parameter names are
the reference checkpoint's (``export_matcha_state_dict`` naming, with the
``mel_mean``/``mel_std`` buffers), so a released ``.ckpt`` can load through
the same names.

Fork quirk kept: ``w_ceil = ceil(exp(logw)) * length_scale`` (scale after the
ceil) and ``y_lengths = int(max(sum(w_ceil), 1))``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from emojivoice_tpu_torch.config import ModelConfig
from emojivoice_tpu_torch.models.cfm import CFM
from emojivoice_tpu_torch.models.text_encoder import TextEncoder
from emojivoice_tpu_torch.utils.masks import generate_path, sequence_mask


class MatchaTTS(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        if cfg.n_spks > 1:
            self.spk_emb = nn.Embedding(cfg.n_spks, cfg.spk_emb_dim)
        self.encoder = TextEncoder(cfg.encoder, cfg.duration_predictor, cfg.n_vocab, cfg.n_spks, cfg.spk_emb_dim)
        self.decoder = CFM(cfg.cfm, cfg.decoder, cfg.n_feats, cfg.n_spks, cfg.spk_emb_dim)
        stats = cfg.data_statistics
        self.register_buffer("mel_mean", torch.tensor(stats.mel_mean, dtype=torch.float32))
        self.register_buffer("mel_std", torch.tensor(stats.mel_std, dtype=torch.float32))

    def _embed_spks(self, spks: Optional[torch.Tensor]):
        if self.cfg.n_spks > 1:
            return self.spk_emb(spks.long())
        return None

    @torch.no_grad()
    def encode_text(self, x, x_lengths, spks=None, length_scale: float = 1.0):
        """Stage A: encoder + durations → (mu_x, w_ceil, y_lengths, x_mask, spk_e).
        The caller reads y_lengths on the host to pick a mel bucket."""
        spk_e = self._embed_spks(spks)
        x_mask = sequence_mask(x_lengths, x.shape[1]).float()[..., None]
        mu_x, logw = self.encoder(x, x_mask, spk_e)
        w = torch.exp(logw.float()) * x_mask
        w_ceil = torch.ceil(w) * length_scale
        y_lengths = torch.clamp_min(torch.sum(w_ceil, dim=(1, 2)), 1.0).to(torch.int32)
        return mu_x, w_ceil, y_lengths, x_mask, spk_e

    @torch.no_grad()
    def decode_mel(self, mu_x, w_ceil, y_lengths, x_mask, spk_e, y_max_length: int, n_timesteps: int,
                   z: torch.Tensor):
        """Stage B: alignment expansion + Euler CFM at mel capacity
        `y_max_length`, with the initial noise `z` (B, y_max_length, n_feats)
        already scaled by the temperature."""
        y_lengths = torch.clamp_max(y_lengths, y_max_length)
        y_mask = sequence_mask(y_lengths, y_max_length).float()[..., None]
        attn_mask = x_mask * y_mask.transpose(1, 2)  # (B, T_x, T_y)
        attn = generate_path(w_ceil[..., 0], attn_mask)
        mu_y = torch.einsum("bxy,bxc->byc", attn, mu_x)
        dec = self.decoder(mu_y, y_mask, n_timesteps, z, spk_e) * y_mask
        mel = dec * self.mel_std + self.mel_mean
        return {"encoder_outputs": mu_y, "decoder_outputs": dec, "attn": attn, "mel": mel,
                "mel_lengths": y_lengths}

    @torch.no_grad()
    def synthesise(self, x, x_lengths, y_max_length: int, n_timesteps: int, z: torch.Tensor, spks=None,
                   length_scale: float = 1.0):
        """Text ids → mel at static capacity `y_max_length`; frames past the
        predicted length are zero."""
        mu_x, w_ceil, y_lengths, x_mask, spk_e = self.encode_text(x, x_lengths, spks, length_scale)
        return self.decode_mel(mu_x, w_ceil, y_lengths, x_mask, spk_e, y_max_length, n_timesteps, z)
