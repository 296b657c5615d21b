"""HiFi-GAN generator, mel → waveform (PyTorch port of
``emojivoice_tpu.vocoder.hifigan`` and the conv blocks of
``emojivoice_tpu.models.modules``).

7-tap pre-conv, transposed-conv upsample stages each followed by a
multi-receptive-field fusion (the mean of parallel dilated res-blocks),
LeakyReLU with the torch default slope 0.01, 7-tap post-conv, tanh.

Two forwards, chosen by the caller:

* ``forward`` is the serving path, under ``torch.no_grad()``.  With ResBlock1
  (HiFi-GAN v1) every MRF stage goes through ``ops.mrf.mrf_stage``: the K1
  kernel on a CUDA tensor, its plain twin on a CPU tensor.  ResBlock2 has no
  fused kernel (nor has it in the JAX package) and runs plain convs.  It
  needs plain weights: on a weight-norm generator it raises.
* ``forward_train`` is the same function on plain ``F.conv1d`` /
  ``F.conv_transpose1d`` for either parameterization, differentiable; the
  GAN step trains through it.

Two parameterizations: plain weights (the reference generator's names after
``remove_weight_norm``), or ``weight_norm=True``, the reference's training
form with its names ``weight_g`` / ``weight_v``: ``w = g · v / ‖v‖`` with the
norm over every axis but the first, which is one magnitude per *output*
channel of a ``Conv1d`` (out, in, k) and per *input* channel of a
``ConvTranspose1d`` (in, out, k), no epsilon.  ``fold_weight_norm()`` gives
the plain generator to serve.
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


def _norm_except_first(v: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(v, dim=tuple(range(1, v.dim())), keepdim=True)


class _WeightNorm(nn.Module):
    """A conv held as ``weight_g`` (C, 1, 1) and ``weight_v`` (the weight's
    shape); ``weight`` is computed from them on every read.  It starts where
    ``torch.nn.utils.weight_norm`` starts: v the conv's own init, g = ‖v‖."""

    def __init__(self, conv: nn.Module):
        super().__init__()
        v = conv.weight.detach().clone()
        self.weight_g = nn.Parameter(_norm_except_first(v))
        self.weight_v = nn.Parameter(v)
        self.bias = nn.Parameter(conv.bias.detach().clone())
        self.stride, self.padding, self.dilation = conv.stride, conv.padding, conv.dilation

    @property
    def weight(self) -> torch.Tensor:
        return self.weight_g * self.weight_v / _norm_except_first(self.weight_v)


class WeightNormConv1d(_WeightNorm):
    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, self.stride, self.padding, self.dilation)


class WeightNormConvTranspose1d(_WeightNorm):
    def forward(self, x):
        return F.conv_transpose1d(x, self.weight, self.bias, self.stride, self.padding)


def _conv1d(weight_norm: bool, *args, **kw) -> nn.Module:
    conv = nn.Conv1d(*args, **kw)
    return WeightNormConv1d(conv) if weight_norm else conv


class ResBlock1(nn.Module):
    """One MRF res-block: per dilation ``x += conv_{k,1}(lrelu(conv_{k,d}(lrelu(x))))``.
    Serving runs the math in ``mrf_stage`` on ``stacked_weights``; ``forward``
    is the plain, differentiable version."""

    def __init__(self, channels: int, kernel_size: int = 3, dilation=(1, 3, 5), weight_norm: bool = False):
        super().__init__()
        self.convs1 = nn.ModuleList([
            _conv1d(weight_norm, channels, channels, kernel_size, padding=get_padding(kernel_size, d), dilation=d)
            for d in dilation])
        self.convs2 = nn.ModuleList([
            _conv1d(weight_norm, channels, channels, kernel_size, padding=get_padding(kernel_size, 1))
            for _ in dilation])

    def stacked_weights(self):
        """(w1 (n_d, k, C, C), b1 (n_d, C), w2, b2) in mrf_stage's channels-last layout."""
        def stack(convs):
            return (torch.stack([c.weight.permute(2, 1, 0) for c in convs]).contiguous(),
                    torch.stack([c.bias for c in convs]).contiguous())

        w1, b1 = stack(self.convs1)
        w2, b2 = stack(self.convs2)
        return w1, b1, w2, b2

    def forward(self, x):
        for c1, c2 in zip(self.convs1, self.convs2):
            x = x + c2(F.leaky_relu(c1(F.leaky_relu(x, LRELU_SLOPE)), LRELU_SLOPE))
        return x


class ResBlock2(nn.Module):
    """The two-conv variant: per dilation ``x += conv_{k,d}(lrelu(x))``."""

    def __init__(self, channels: int, kernel_size: int = 3, dilation=(1, 3), weight_norm: bool = False):
        super().__init__()
        self.convs = nn.ModuleList([
            _conv1d(weight_norm, channels, channels, kernel_size, padding=get_padding(kernel_size, d), dilation=d)
            for d in dilation])

    def forward(self, x):
        for c in self.convs:
            x = x + c(F.leaky_relu(x, LRELU_SLOPE))
        return x


class HiFiGANGenerator(nn.Module):
    """mel (B, T, num_mels) → waveform (B, T·prod(upsample_rates)) in [-1, 1]."""

    def __init__(self, cfg: HiFiGANConfig, weight_norm: bool = False):
        super().__init__()
        self.cfg = cfg
        self.weight_norm = weight_norm
        self.num_kernels = len(cfg.resblock_kernel_sizes)
        res_cls = ResBlock1 if cfg.resblock == "1" else ResBlock2
        self.conv_pre = _conv1d(weight_norm, cfg.num_mels, cfg.upsample_initial_channel, 7, padding=3)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
            ch_in = cfg.upsample_initial_channel // (2 ** i)
            ch = ch_in // 2
            up = nn.ConvTranspose1d(ch_in, ch, k, u, padding=(k - u) // 2)
            self.ups.append(WeightNormConvTranspose1d(up) if weight_norm else up)
            for rk, rd in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
                self.resblocks.append(res_cls(ch, rk, tuple(rd), weight_norm))
        self.conv_post = _conv1d(weight_norm, cfg.upsample_initial_channel // (2 ** len(cfg.upsample_rates)), 1, 7,
                                 padding=3)
        self._stacked, self._stacked_key = None, None

    def stage_weights(self, stage: int):
        """The MRF weights of `stage` as ``mrf_stage`` takes them: the contract's
        stacked tuples on the CPU, K1's packed operands (c_in fastest, split in
        two TF32 parts) on the card.  They are made once and again only after a
        res-block parameter moves (``.to``) or is written in place
        (``load_state_dict``), not on every call.  Plain ResBlock1 weights
        only: a weight-norm generator is folded first."""
        if self.weight_norm or self.cfg.resblock != "1":
            raise RuntimeError("stage_weights: the fused MRF stage takes plain ResBlock1 weights; call "
                               "fold_weight_norm() on a weight-norm generator and serve the result")
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
        if self.weight_norm:
            raise RuntimeError("HiFiGANGenerator.forward serves plain weights: call fold_weight_norm() and serve "
                               "the generator it returns (forward_train runs either parameterization)")
        if cfg.resblock != "1":
            return self.forward_train(mel)
        dils = tuple(tuple(d) for d in cfg.resblock_dilation_sizes)
        x = self.conv_pre(mel.transpose(1, 2))
        for i, up in enumerate(self.ups):
            x = up(F.leaky_relu(x, LRELU_SLOPE))
            x = mrf_stage(x.transpose(1, 2).contiguous(), self.stage_weights(i), cfg.resblock_kernel_sizes,
                          dils).transpose(1, 2)
        x = self.conv_post(F.leaky_relu(x, 0.01))
        return torch.tanh(x)[:, 0, :]

    def forward_train(self, mel: torch.Tensor) -> torch.Tensor:
        """The same function on plain PyTorch convs, differentiable, for
        either parameterization and either res-block; no kernel of the port's
        own runs here."""
        n = self.num_kernels
        x = self.conv_pre(mel.transpose(1, 2))
        for i, up in enumerate(self.ups):
            x = up(F.leaky_relu(x, LRELU_SLOPE))
            xs = None
            for block in self.resblocks[i * n:(i + 1) * n]:
                xs = block(x) if xs is None else xs + block(x)
            x = xs / n
        x = self.conv_post(F.leaky_relu(x, 0.01))
        return torch.tanh(x)[:, 0, :]

    def fold_weight_norm(self) -> "HiFiGANGenerator":
        """A plain generator on the same device with every ``weight_g`` /
        ``weight_v`` pair folded (in float64) into ``weight``: what
        ``forward`` and ``SynthesisPipeline`` serve.  The result shares no
        storage with this generator; on a plain generator it is a copy."""
        from emojivoice_tpu_torch.io.torch_ckpt import fold_hifigan_state_dict

        plain = HiFiGANGenerator(self.cfg)
        plain.load_state_dict(fold_hifigan_state_dict(self.state_dict()), strict=True)
        return plain.to(self.conv_pre.bias.device).eval()
