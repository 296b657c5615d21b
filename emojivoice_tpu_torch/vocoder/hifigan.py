"""HiFi-GAN v1 generator, mel → waveform (PyTorch port of
``emojivoice_tpu.vocoder.hifigan``, ResBlock1, weight norm folded).

7-tap pre-conv, transposed-conv upsample stages each followed by a
multi-receptive-field fusion (the mean of parallel dilated res-blocks),
LeakyReLU with the torch default slope 0.01, 7-tap post-conv, tanh.  Every
MRF stage goes through ``ops.mrf.mrf_stage``: the K1 kernel on a CUDA
tensor, its plain twin on a CPU tensor.  Parameter names are the reference
generator's after ``remove_weight_norm``.
"""

from __future__ import annotations

import threading

import torch
import torch.nn as nn
import torch.nn.functional as F

from emojivoice_tpu_torch.config import HiFiGANConfig
from emojivoice_tpu_torch.ops.mrf import LRELU_SLOPE, mrf_stage, pack_weights


# serving threads share one generator: its stacked MRF weights are made by one of them, once
# (a module-level lock: a lock held by the module would stop ``copy.deepcopy`` of a generator)
_STACK_LOCK = threading.Lock()


def get_padding(kernel_size: int, dilation: int = 1) -> int:
    return (kernel_size * dilation - dilation) // 2


class ResBlock1(nn.Module):
    """Holds one MRF res-block's convs; the math runs in ``mrf_stage``."""

    def __init__(self, channels: int, kernel_size: int = 3, dilation=(1, 3, 5)):
        super().__init__()
        self.convs1 = nn.ModuleList([
            nn.Conv1d(channels, channels, kernel_size, padding=get_padding(kernel_size, d), dilation=d)
            for d in dilation])
        self.convs2 = nn.ModuleList([
            nn.Conv1d(channels, channels, kernel_size, padding=get_padding(kernel_size, 1))
            for _ in dilation])

    def stacked_weights(self):
        """(w1 (n_d, k, C, C), b1 (n_d, C), w2, b2) in mrf_stage's channels-last layout."""
        def stack(convs):
            return (torch.stack([c.weight.permute(2, 1, 0) for c in convs]).contiguous(),
                    torch.stack([c.bias for c in convs]).contiguous())

        w1, b1 = stack(self.convs1)
        w2, b2 = stack(self.convs2)
        return w1, b1, w2, b2


class HiFiGANGenerator(nn.Module):
    """mel (B, T, num_mels) → waveform (B, T·prod(upsample_rates)) in [-1, 1]."""

    def __init__(self, cfg: HiFiGANConfig):
        super().__init__()
        if cfg.resblock != "1":
            raise NotImplementedError("only ResBlock1 (HiFi-GAN v1) is ported")
        self.cfg = cfg
        self.num_kernels = len(cfg.resblock_kernel_sizes)
        self.conv_pre = nn.Conv1d(cfg.num_mels, cfg.upsample_initial_channel, 7, padding=3)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
            ch_in = cfg.upsample_initial_channel // (2 ** i)
            ch = ch_in // 2
            self.ups.append(nn.ConvTranspose1d(ch_in, ch, k, u, padding=(k - u) // 2))
            for rk, rd in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
                self.resblocks.append(ResBlock1(ch, rk, tuple(rd)))
        self.conv_post = nn.Conv1d(cfg.upsample_initial_channel // (2 ** len(cfg.upsample_rates)), 1, 7,
                                   padding=3)
        self._stacked, self._stacked_key = None, None

    def stage_weights(self, stage: int):
        """The MRF weights of `stage` as ``mrf_stage`` takes them: the contract's
        stacked tuples on the CPU, K1's packed operands (c_in fastest, split in
        two TF32 parts) on the card.  They are made once and again only after a
        res-block parameter moves (``.to``) or is written in place
        (``load_state_dict``), not on every call."""
        key = tuple((p.data_ptr(), p._version) for p in self.resblocks.parameters())
        with _STACK_LOCK:
            if key != self._stacked_key:
                n = self.num_kernels
                stacked = [[rb.stacked_weights() for rb in self.resblocks[s * n:(s + 1) * n]]
                           for s in range(len(self.ups))]
                on_card = self.conv_pre.weight.device.type == "cuda"
                self._stacked = [pack_weights(stage) for stage in stacked] if on_card else stacked
                self._stacked_key = key
            return self._stacked[stage]

    @torch.no_grad()
    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        dils = tuple(tuple(d) for d in cfg.resblock_dilation_sizes)
        x = self.conv_pre(mel.transpose(1, 2))
        for i, up in enumerate(self.ups):
            x = up(F.leaky_relu(x, LRELU_SLOPE))
            x = mrf_stage(x.transpose(1, 2).contiguous(), self.stage_weights(i), cfg.resblock_kernel_sizes,
                          dils).transpose(1, 2)
        x = self.conv_post(F.leaky_relu(x, 0.01))
        return torch.tanh(x)[:, 0, :]
