"""CFM estimator: 1-D U-Net over mel time (PyTorch port of
``emojivoice_tpu.models.decoder``).

Structure for ``channels=(256, 256)``: down₀ resnet → transformer → stride-2
conv; down₁ resnet → transformer → k3 conv; mid blocks; up blocks with skip
concat and a k4 s2 p1 transposed upsample; final Block1D → 1×1 proj → mask.
The time embedding has dimension ``in_channels``; attention adds the 0/1
float mask to the scores (the diffusers float-mask quirk), so padded frames
get a −1 bias, not −inf; ``strict_mask=True`` gives them −1e9 instead (for
training from scratch).  Where a level's block type is ``"conformer"`` its
blocks are ``models/conformer.py``'s, whose attention masks with
``-finfo.max`` whatever ``strict_mask`` says.  ``cfg.dropout`` acts after the attention's output
projection and inside the feed-forward (after SnakeBeta), as ``nn.Dropout``
in the slots ``to_out.1`` and ``ff.net.1`` of the reference.  Internals are channels-first with reference
parameter names; ``Decoder.forward`` keeps the JAX package's channels-last
interface.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from emojivoice_tpu_torch.config import DecoderConfig
from emojivoice_tpu_torch.models.conformer import ConformerBlock
from emojivoice_tpu_torch.models.modules import mish, snake_beta


# log(10000) as an f32 torch computes it, read once here: ``.item()`` inside the forward stops ``torch.export``
_LOG_BASE = torch.log(torch.tensor(10000.0, dtype=torch.float32)).item()


def sinusoidal_pos_emb(t: torch.Tensor, dim: int, scale: float = 1000.0) -> torch.Tensor:
    """(B,) → (B, dim), in f32."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device) * (-_LOG_BASE / (half - 1)))
    ang = scale * t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class Block1D(nn.Module):
    """conv3 → GroupNorm(8) → Mish, masked."""

    def __init__(self, dim_in: int, dim_out: int, groups: int = 8):
        super().__init__()
        self.block = nn.Sequential(nn.Conv1d(dim_in, dim_out, 3, padding=1), nn.GroupNorm(groups, dim_out))

    def forward(self, x, mask):
        return mish(self.block(x * mask)) * mask


class ResnetBlock1D(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, time_dim: int):
        super().__init__()
        self.mlp = nn.Sequential(nn.Mish(), nn.Linear(time_dim, dim_out))
        self.block1 = Block1D(dim_in, dim_out)
        self.block2 = Block1D(dim_out, dim_out)
        self.res_conv = nn.Conv1d(dim_in, dim_out, 1)

    def forward(self, x, mask, time_emb):
        h = self.block1(x, mask) + self.mlp(time_emb).unsqueeze(-1)
        h = self.block2(h, mask)
        return h + self.res_conv(x * mask)


class SnakeBeta(nn.Module):
    """Linear projection followed by SnakeBeta (``ff.net.0`` in the reference)."""

    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner)
        self.alpha = nn.Parameter(torch.zeros(inner))
        self.beta = nn.Parameter(torch.zeros(inner))

    def forward(self, x):
        return snake_beta(self.proj(x), self.alpha, self.beta)


class FeedForward(nn.Module):
    def __init__(self, dim: int, inner: int, dropout: float = 0.0):
        super().__init__()
        self.net = nn.ModuleList([SnakeBeta(dim, inner), nn.Dropout(dropout), nn.Linear(inner, dim)])

    def forward(self, x):
        return self.net[2](self.net[1](self.net[0](x)))


class Attention(nn.Module):
    """diffusers Attention numerics: bias-free q/k/v, biased out proj, scale
    head_dim^-0.5, float mask added to the scores (or, with `strict_mask`,
    −1e9 on the masked keys)."""

    def __init__(self, dim: int, heads: int, head_dim: int, dropout: float = 0.0, strict_mask: bool = False):
        super().__init__()
        inner = heads * head_dim
        self.heads, self.head_dim, self.strict_mask = heads, head_dim, strict_mask
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(dim, inner, bias=False)
        self.to_v = nn.Linear(dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, dim), nn.Dropout(dropout)])

    def forward(self, x, mask_bt):
        b, t, _ = x.shape

        def split(z):
            return z.view(b, t, self.heads, self.head_dim).transpose(1, 2)

        q, k, v = split(self.to_q(x)), split(self.to_k(x)), split(self.to_v(x))
        scores = torch.matmul(q, k.transpose(-2, -1)) / math.sqrt(self.head_dim)
        if self.strict_mask:
            scores = scores.masked_fill(mask_bt[:, None, None, :] <= 0, -1e9)
        else:
            scores = scores + mask_bt[:, None, None, :]
        out = torch.matmul(torch.softmax(scores, dim=-1), v)
        return self.to_out[1](self.to_out[0](out.transpose(1, 2).reshape(b, t, -1)))


class BasicTransformerBlock(nn.Module):
    """Pre-norm self-attention + SnakeBeta FFN, on (B, T, C)."""

    def __init__(self, dim: int, heads: int, head_dim: int, dropout: float = 0.0, ff_mult: int = 4,
                 strict_mask: bool = False):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, heads, head_dim, dropout, strict_mask)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim, dim * ff_mult, dropout)

    def forward(self, x, mask_bt):
        x = x + self.attn1(self.norm1(x), mask_bt)
        return x + self.ff(self.norm3(x))


class Downsample1D(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.Conv1d(dim, dim, 3, 2, 1)

    def forward(self, x):
        return self.conv(x)


class Upsample1D(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.ConvTranspose1d(dim, dim, 4, 2, 1)

    def forward(self, x):
        return self.conv(x)


class TimestepEmbedding(nn.Module):
    def __init__(self, in_channels: int, time_embed_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_channels, time_embed_dim)
        self.linear_2 = nn.Linear(time_embed_dim, time_embed_dim)

    def forward(self, sample):
        """In the sample's dtype (f32) whatever the weights' dtype: the JAX
        package's f32 input promotes bf16 weights to f32 there.  The
        pipeline's bf16 copy holds these weights as f32 (their bf16 values),
        so there ``.to`` is a no-op; only ``bf16-mixed`` training, which hands
        every parameter over in bf16, casts here."""
        def linear(layer, t):
            return F.linear(t, layer.weight.to(t.dtype), layer.bias.to(t.dtype))
        return linear(self.linear_2, F.silu(linear(self.linear_1, sample)))


class Decoder(nn.Module):
    """forward(x, mask, mu, t, spks): x, mu (B, T, n_feats), mask (B, T, 1),
    t (B,), spks (B, spk_emb_dim) or None → (B, T, out_channels)."""

    def __init__(self, cfg: DecoderConfig, in_channels: int, out_channels: int, strict_mask: bool = False):
        super().__init__()
        chans = tuple(cfg.channels)
        tdim = chans[0] * 4
        self.in_channels = in_channels
        self.time_mlp = TimestepEmbedding(in_channels, tdim)

        def tblocks(ch, kind):
            if kind == "conformer":
                return nn.ModuleList([ConformerBlock(ch, cfg.num_heads, cfg.attention_head_dim, cfg.dropout)
                                      for _ in range(cfg.n_blocks)])
            if kind == "transformer":
                return nn.ModuleList([BasicTransformerBlock(ch, cfg.num_heads, cfg.attention_head_dim, cfg.dropout,
                                                            strict_mask=strict_mask) for _ in range(cfg.n_blocks)])
            raise ValueError(f"Unknown block type {kind!r}")

        self.down_blocks = nn.ModuleList()
        prev = in_channels
        for i, ch in enumerate(chans):
            is_last = i == len(chans) - 1
            down = nn.Conv1d(ch, ch, 3, padding=1) if is_last else Downsample1D(ch)
            self.down_blocks.append(nn.ModuleList([ResnetBlock1D(prev, ch, tdim), tblocks(ch, cfg.down_block_type), down]))
            prev = ch
        self.mid_blocks = nn.ModuleList(
            [nn.ModuleList([ResnetBlock1D(chans[-1], chans[-1], tdim), tblocks(chans[-1], cfg.mid_block_type)])
             for _ in range(cfg.num_mid_blocks)])
        up_chans = chans[::-1] + (chans[0],)
        self.up_blocks = nn.ModuleList()
        for i in range(len(up_chans) - 1):
            ch = up_chans[i + 1]
            is_last = i == len(up_chans) - 2
            up = nn.Conv1d(ch, ch, 3, padding=1) if is_last else Upsample1D(ch)
            self.up_blocks.append(nn.ModuleList([ResnetBlock1D(2 * up_chans[i], ch, tdim), tblocks(ch, cfg.up_block_type), up]))
        self.final_block = Block1D(up_chans[-1], up_chans[-1])
        self.final_proj = nn.Conv1d(up_chans[-1], out_channels, 1)

    def forward(self, x, mask, mu, t, spks=None):
        # the time embedding in f32 for its phase, then in the compute dtype (bf16 runs stay bf16)
        temb = self.time_mlp(sinusoidal_pos_emb(t, self.in_channels)).to(x.dtype)
        h = torch.cat([x, mu], dim=-1)
        if spks is not None:
            h = torch.cat([h, spks[:, None, :].expand(-1, h.shape[1], -1)], dim=-1)
        h = h.transpose(1, 2)
        mask = mask.transpose(1, 2)  # (B, 1, T)

        def run_transformers(h, blocks, m):
            hb = h.transpose(1, 2)
            for blk in blocks:
                hb = blk(hb, m[:, 0, :])
            return hb.transpose(1, 2)

        hiddens, masks = [], [mask]
        for resnet, blocks, down in self.down_blocks:
            m = masks[-1]
            h = run_transformers(resnet(h, m, temb), blocks, m)
            hiddens.append(h)
            h = down(h * m)
            masks.append(m[:, :, ::2])
        masks = masks[:-1]
        m_mid = masks[-1]
        for resnet, blocks in self.mid_blocks:
            h = run_transformers(resnet(h, m_mid, temb), blocks, m_mid)
        for resnet, blocks, up in self.up_blocks:
            m = masks.pop()
            h = resnet(torch.cat([h, hiddens.pop()], dim=1), m, temb)
            h = up(run_transformers(h, blocks, m) * m)
        h = self.final_block(h, m)
        return (self.final_proj(h * m) * mask).transpose(1, 2)
