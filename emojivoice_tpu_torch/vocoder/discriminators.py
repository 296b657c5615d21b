"""HiFi-GAN discriminators and GAN losses (PyTorch port of
``emojivoice_tpu.vocoder.discriminators``), for vocoder fine-tuning.

The multi-period discriminator folds the waveform into (T/p, p) images and
runs (5, 1) convs over the time axis; the multi-scale discriminator runs
grouped 41-tap 1-D convs on the waveform and two average-pooled copies.
Waveforms are (B, T); layouts inside are torch's channels-first, and each
discriminator returns its flattened score and the list of feature maps in
the reference's order (every activation, then ``conv_post``).  Parameter
names are the reference's (``discriminators.{i}.convs.{j}``, ``conv_post``)
with plain ``weight``s, as the JAX package trains them.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

LRELU_SLOPE = 0.1

# (out channels, kernel, stride, groups) of DiscriminatorS's convs
SCALE_SPECS = ((128, 15, 1, 1), (128, 41, 2, 4), (256, 41, 2, 16), (512, 41, 4, 16), (1024, 41, 4, 16),
               (1024, 41, 1, 16), (1024, 5, 1, 1))


class DiscriminatorP(nn.Module):
    """Period discriminator: reflect-pad to a multiple of the period, fold to
    (B, 1, T/p, p), four strided (5, 1) convs, one unstrided, a (3, 1) head."""

    def __init__(self, period: int):
        super().__init__()
        self.period = period
        widths = (1, 32, 128, 512, 1024)
        self.convs = nn.ModuleList(
            [nn.Conv2d(a, b, (5, 1), (3, 1), padding=(2, 0)) for a, b in zip(widths, widths[1:])]
            + [nn.Conv2d(1024, 1024, (5, 1), 1, padding=(2, 0))])
        self.conv_post = nn.Conv2d(1024, 1, (3, 1), 1, padding=(1, 0))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        b, t = x.shape
        p = self.period
        h = x[:, None, :]
        if t % p != 0:
            h = F.pad(h, (0, p - t % p), mode="reflect")
        h = h.reshape(b, 1, -1, p)
        fmap = []
        for conv in self.convs:
            h = F.leaky_relu(conv(h), LRELU_SLOPE)
            fmap.append(h)
        h = self.conv_post(h)
        fmap.append(h)
        return h.reshape(b, -1), fmap


class DiscriminatorS(nn.Module):
    """Scale discriminator: seven convs (``SCALE_SPECS``) and a 3-tap head."""

    def __init__(self):
        super().__init__()
        convs, c_in = [], 1
        for ch, k, s, g in SCALE_SPECS:
            convs.append(nn.Conv1d(c_in, ch, k, s, padding=k // 2, groups=g))
            c_in = ch
        self.convs = nn.ModuleList(convs)
        self.conv_post = nn.Conv1d(c_in, 1, 3, 1, padding=1)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        h = x[:, None, :]
        fmap = []
        for conv in self.convs:
            h = F.leaky_relu(conv(h), LRELU_SLOPE)
            fmap.append(h)
        h = self.conv_post(h)
        fmap.append(h)
        return h.reshape(x.shape[0], -1), fmap


class _MultiDiscriminator(nn.Module):
    """Runs every sub-discriminator on the real and the generated waveform →
    (real scores, generated scores, real feature maps, generated feature maps)."""

    discriminators: nn.ModuleList

    def inputs(self, i: int, y, y_hat):
        return y, y_hat

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        y_d_rs, y_d_gs, fmap_rs, fmap_gs = [], [], [], []
        for i, d in enumerate(self.discriminators):
            y, y_hat = self.inputs(i, y, y_hat)
            r_out, r_fmap = d(y)
            g_out, g_fmap = d(y_hat)
            y_d_rs.append(r_out)
            y_d_gs.append(g_out)
            fmap_rs.append(r_fmap)
            fmap_gs.append(g_fmap)
        return y_d_rs, y_d_gs, fmap_rs, fmap_gs


class MultiPeriodDiscriminator(_MultiDiscriminator):
    def __init__(self, periods=(2, 3, 5, 7, 11)):
        super().__init__()
        self.discriminators = nn.ModuleList([DiscriminatorP(p) for p in periods])


class MultiScaleDiscriminator(_MultiDiscriminator):
    """Three scales; before the second and the third both waveforms are
    average-pooled (window 4, stride 2, two zeros of padding a side that count
    in the mean)."""

    def __init__(self):
        super().__init__()
        self.discriminators = nn.ModuleList([DiscriminatorS() for _ in range(3)])

    def inputs(self, i: int, y, y_hat):
        if i == 0:
            return y, y_hat
        return tuple(F.avg_pool1d(w[:, None, :], 4, 2, padding=2, count_include_pad=True)[:, 0, :]
                     for w in (y, y_hat))


def feature_loss(fmap_r, fmap_g) -> torch.Tensor:
    """L1 feature matching over every map of every sub-discriminator, × 2."""
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(rl - gl))
    return loss * 2


def discriminator_loss(disc_real, disc_gen):
    """LSGAN discriminator loss → (sum, per-discriminator real parts, generated parts)."""
    loss = 0.0
    r_losses, g_losses = [], []
    for dr, dg in zip(disc_real, disc_gen):
        r_loss = torch.mean(torch.square(1 - dr))
        g_loss = torch.mean(torch.square(dg))
        loss = loss + r_loss + g_loss
        r_losses.append(r_loss)
        g_losses.append(g_loss)
    return loss, r_losses, g_losses


def generator_loss(disc_outputs):
    """LSGAN generator loss → (sum, per-discriminator parts)."""
    loss = 0.0
    gen_losses = []
    for dg in disc_outputs:
        part = torch.mean(torch.square(1 - dg))
        gen_losses.append(part)
        loss = loss + part
    return loss, gen_losses
