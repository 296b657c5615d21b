"""Text encoder: phoneme ids → mel prior ``mu_x`` + log-durations
(PyTorch port of ``emojivoice_tpu.models.text_encoder``).

Scaled embedding, 3-layer conv prenet with residual projection, speaker
embedding concatenated over time, post-norm RoPE transformer with channel
LayerNorm, 1×1 mel-mean head and the duration head.  Dropout sits where the
JAX package has it (prenet 0.5, encoder ``p_dropout`` on the attention
weights, after attention and FFN and inside the FFN, duration predictor after
each norm) as ``nn.Dropout``: active under ``train()``, off under ``eval()``.
Internals are
channels-first with reference parameter names; ``TextEncoder.forward`` keeps
the JAX package's channels-last interface.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from emojivoice_tpu_torch.config import DurationPredictorConfig, EncoderConfig
from emojivoice_tpu_torch.models.modules import ChannelLayerNorm, masked_fill
from emojivoice_tpu_torch.ops.rope import apply_rope


class ConvReluNorm(nn.Module):
    def __init__(self, channels: int, kernel_size: int = 5, n_layers: int = 3, p_dropout: float = 0.5):
        super().__init__()
        self.drop = nn.Dropout(p_dropout)
        self.conv_layers = nn.ModuleList(
            [nn.Conv1d(channels, channels, kernel_size, padding=kernel_size // 2) for _ in range(n_layers)])
        self.norm_layers = nn.ModuleList([ChannelLayerNorm(channels) for _ in range(n_layers)])
        self.proj = nn.Conv1d(channels, channels, 1)
        nn.init.zeros_(self.proj.weight)  # the residual branch starts closed, as in the reference
        nn.init.zeros_(self.proj.bias)

    def forward(self, x, x_mask):
        x_org = x
        for conv, norm in zip(self.conv_layers, self.norm_layers):
            x = self.drop(torch.relu(norm(conv(x * x_mask))))
        return (x_org + self.proj(x)) * x_mask


class DurationPredictor(nn.Module):
    def __init__(self, in_channels: int, filter_channels: int, kernel_size: int, p_dropout: float = 0.0):
        super().__init__()
        self.drop = nn.Dropout(p_dropout)
        self.conv_1 = nn.Conv1d(in_channels, filter_channels, kernel_size, padding=kernel_size // 2)
        self.norm_1 = ChannelLayerNorm(filter_channels)
        self.conv_2 = nn.Conv1d(filter_channels, filter_channels, kernel_size, padding=kernel_size // 2)
        self.norm_2 = ChannelLayerNorm(filter_channels)
        self.proj = nn.Conv1d(filter_channels, 1, 1)

    def forward(self, x, x_mask):
        x = self.drop(self.norm_1(torch.relu(self.conv_1(x * x_mask))))
        x = self.drop(self.norm_2(torch.relu(self.conv_2(x * x_mask))))
        return self.proj(x * x_mask) * x_mask


class MultiHeadAttention(nn.Module):
    """Softmax attention with RoPE on int(head_dim·0.5) dims, scale
    1/√head_dim, mask fill −1e4."""

    def __init__(self, channels: int, n_heads: int, p_dropout: float = 0.0):
        super().__init__()
        self.drop = nn.Dropout(p_dropout)
        self.n_heads = n_heads
        self.k_channels = channels // n_heads
        self.rope_dim = int(self.k_channels * 0.5)
        if self.rope_dim % 2:
            raise ValueError(
                f"attention head dim {self.k_channels} gives odd RoPE dim {self.rope_dim}; "
                "the per-head dim must be divisible by 4")
        self.conv_q = nn.Conv1d(channels, channels, 1)
        self.conv_k = nn.Conv1d(channels, channels, 1)
        self.conv_v = nn.Conv1d(channels, channels, 1)
        self.conv_o = nn.Conv1d(channels, channels, 1)

    def forward(self, x, attn_mask):
        b, c, t = x.shape
        h, kc = self.n_heads, self.k_channels

        def split(z):  # (B, C, T) → (B, H, T, kc)
            return z.view(b, h, kc, t).transpose(2, 3)

        q, k, v = split(self.conv_q(x)), split(self.conv_k(x)), split(self.conv_v(x))
        q, k = apply_rope(q, self.rope_dim), apply_rope(k, self.rope_dim)
        scores = torch.matmul(q, k.transpose(-2, -1)) / math.sqrt(kc)
        p_attn = self.drop(torch.softmax(masked_fill(scores, attn_mask), dim=-1))
        out = torch.matmul(p_attn, v).transpose(2, 3).reshape(b, c, t)
        return self.conv_o(out)


class FFN(nn.Module):
    def __init__(self, channels: int, filter_channels: int, kernel_size: int, p_dropout: float = 0.0):
        super().__init__()
        self.drop = nn.Dropout(p_dropout)
        self.conv_1 = nn.Conv1d(channels, filter_channels, kernel_size, padding=kernel_size // 2)
        self.conv_2 = nn.Conv1d(filter_channels, channels, kernel_size, padding=kernel_size // 2)

    def forward(self, x, x_mask):
        return self.conv_2(self.drop(torch.relu(self.conv_1(x * x_mask))) * x_mask) * x_mask


class Encoder(nn.Module):
    """Post-norm transformer stack."""

    def __init__(self, channels: int, filter_channels: int, n_heads: int, n_layers: int, kernel_size: int,
                 p_dropout: float = 0.0):
        super().__init__()
        self.drop = nn.Dropout(p_dropout)
        self.attn_layers = nn.ModuleList(
            [MultiHeadAttention(channels, n_heads, p_dropout) for _ in range(n_layers)])
        self.norm_layers_1 = nn.ModuleList([ChannelLayerNorm(channels) for _ in range(n_layers)])
        self.ffn_layers = nn.ModuleList(
            [FFN(channels, filter_channels, kernel_size, p_dropout) for _ in range(n_layers)])
        self.norm_layers_2 = nn.ModuleList([ChannelLayerNorm(channels) for _ in range(n_layers)])

    def forward(self, x, x_mask):
        attn_mask = x_mask.unsqueeze(2) * x_mask.unsqueeze(-1)  # (B, 1, T, T)
        for attn, norm1, ffn, norm2 in zip(self.attn_layers, self.norm_layers_1, self.ffn_layers,
                                           self.norm_layers_2):
            x = x * x_mask
            x = norm1(x + self.drop(attn(x, attn_mask)))
            x = norm2(x + self.drop(ffn(x, x_mask)))
        return x * x_mask


class TextEncoder(nn.Module):
    """ids (B, T), x_mask (B, T, 1), spks (B, spk_emb_dim) or None →
    mu (B, T, n_feats), logw (B, T, 1), both masked."""

    def __init__(self, encoder: EncoderConfig, duration_predictor: DurationPredictorConfig, n_vocab: int,
                 n_spks: int = 1, spk_emb_dim: int = 64):
        super().__init__()
        ch = encoder.n_channels
        self.n_channels = ch
        self.prenet_enabled = encoder.prenet
        self.emb = nn.Embedding(n_vocab, ch)
        nn.init.normal_(self.emb.weight, 0.0, ch ** -0.5)
        if encoder.prenet:
            self.prenet = ConvReluNorm(ch)
        hidden = ch + (spk_emb_dim if n_spks > 1 else 0)
        self.encoder = Encoder(hidden, encoder.filter_channels, encoder.n_heads, encoder.n_layers,
                               encoder.kernel_size, encoder.p_dropout)
        self.proj_m = nn.Conv1d(hidden, encoder.n_feats, 1)
        self.proj_w = DurationPredictor(hidden, duration_predictor.filter_channels_dp,
                                        duration_predictor.kernel_size, duration_predictor.p_dropout)

    def forward(self, x, x_mask, spks: Optional[torch.Tensor] = None):
        h = (self.emb(x) * math.sqrt(self.n_channels)).transpose(1, 2)
        m = x_mask.to(h.dtype).transpose(1, 2)  # (B, 1, T), in the compute dtype (the embedding's: f32 or bf16)
        if self.prenet_enabled:
            h = self.prenet(h, m)
        if spks is not None:
            h = torch.cat([h, spks.unsqueeze(-1).expand(-1, -1, h.shape[-1])], dim=1)
        h = self.encoder(h, m)
        mu = self.proj_m(h) * m
        logw = self.proj_w(h.detach(), m)  # the duration head sees detached features, as in the reference
        return mu.transpose(1, 2), logw.transpose(1, 2)
