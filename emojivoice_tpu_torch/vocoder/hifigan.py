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
  ``for_export()`` gives the same forward as ``torch.export`` traces it
  (``PackedGenerator``: the stages' operands made beforehand, as buffers).
* ``forward_train`` is the same function on plain ``F.conv1d`` /
  ``F.conv_transpose1d`` for either parameterization, differentiable; the
  GAN step trains through it.

**bf16 mode** (``forward(mel, compute_dtype=torch.bfloat16)``, what the
pipeline's ``compute_dtype`` and ``vocoder_dtype`` switch on) is the JAX
package's ``hifigan_apply_pallas(cfg, params, mel, compute_dtype=bf16,
stages="all")``: only the MRF stages' tap products are bf16 (K1's bf16 mode on
the card, its plain twin on the CPU); ``conv_pre``, the transposed upsample
convs and ``conv_post`` stay f32, as do the input and the waveform.  That is a
choice: the JAX pipeline's own ``vocoder_dtype=bf16`` runs every conv through
XLA in bf16 (``emojivoice_tpu/inference/pipeline.py:172-180``), which has no
kernel behind it.  The kernel-based function is the one reduced-precision
vocoder the JAX package defines through its TPU kernel, so it is what K1's bf16
mode ports; the MRF stages are 304 of the 317.7 GFLOP of HiFi-GAN v1 at 512
frames, so the f32 convs around them cost little.  The port is held to the
kernel-based function within 2e-4 and to the JAX pipeline's all-bf16 waveform
within the JAX package's own 2e-2 (``tests/test_torch_precision*.py``).

Two parameterizations: plain weights (the reference generator's names after
``remove_weight_norm``), or ``weight_norm=True``, the reference's training
form with its names ``weight_g`` / ``weight_v``: ``w = g · v / ‖v‖`` with the
norm over every axis but the first, which is one magnitude per *output*
channel of a ``Conv1d`` (out, in, k) and per *input* channel of a
``ConvTranspose1d`` (in, out, k), no epsilon.  ``fold_weight_norm()`` gives
the plain generator to serve.

Under tensor parallelism (``parallel/tp.py::shard_params`` on a plain
generator) each res-block's ``convs1`` hold a slice of their output channels
and ``convs2`` of their input channels, as the JAX package lays them out.
K1 fuses each column → row pair with the residual adds between them, so a
split pair would need an all-reduce inside the kernel: ``stage_weights``
gathers each stage's slices once, when it packs them, and every rank runs K1
on whole weights (the JAX package serves a sharded generator through XLA
convs instead).  ``forward_train`` runs the pairs column → row parallel.
"""

from __future__ import annotations

import threading

import torch
import torch.nn as nn
import torch.nn.functional as F

from emojivoice_tpu_torch.config import HiFiGANConfig
from emojivoice_tpu_torch.ops.mrf import LRELU_SLOPE, mrf_stage, pack_weights
from emojivoice_tpu_torch.parallel.tp import gathered


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
        """(w1 (n_d, k, C, C), b1 (n_d, C), w2, b2) in mrf_stage's channels-last
        layout, whole: a tensor-parallel block gathers its slices here."""
        def stack(convs):
            wb = [gathered(c) for c in convs]
            return (torch.stack([w.permute(2, 1, 0) for w, _ in wb]).contiguous(),
                    torch.stack([b for _, b in wb]).contiguous())

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
        self._stacked, self._stacked_key = {}, None

    def stage_weights(self, stage: int, dtype: torch.dtype = torch.float32):
        """The MRF weights of `stage` as ``mrf_stage`` takes them, in K1's
        mode `dtype` (f32, or bf16 with w1/w2 rounded to nearest even): the
        contract's stacked tuples on the CPU, K1's packed operands (c_in
        fastest; in f32 mode split in two TF32 parts) on the card.  They are
        made once per mode and again only after a res-block parameter moves
        (``.to``) or is written in place (``load_state_dict``), not on every
        call.  Plain ResBlock1 weights only: a weight-norm generator is folded
        first."""
        if self.weight_norm or self.cfg.resblock != "1":
            raise RuntimeError("stage_weights: the fused MRF stage takes plain ResBlock1 weights; call "
                               "fold_weight_norm() on a weight-norm generator and serve the result")
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"stage_weights: K1 has an f32 and a bf16 mode, not {dtype}")
        key = tuple((p.data_ptr(), p._version) for p in self.resblocks.parameters())
        with _STACK_LOCK:
            if key != self._stacked_key:
                self._stacked, self._stacked_key = {}, key
            if dtype not in self._stacked:
                n = self.num_kernels
                stacked = [[rb.stacked_weights() for rb in self.resblocks[s * n:(s + 1) * n]]
                           for s in range(len(self.ups))]
                if dtype != torch.float32:
                    stacked = [[(w1.detach().to(dtype), b1, w2.detach().to(dtype), b2) for w1, b1, w2, b2 in st]
                               for st in stacked]
                on_card = self.conv_pre.weight.device.type == "cuda"
                self._stacked[dtype] = [pack_weights(st) for st in stacked] if on_card else stacked
            return self._stacked[dtype][stage]

    @torch.no_grad()
    def forward(self, mel: torch.Tensor, compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """mel (B, T, num_mels) f32 → waveform f32; `compute_dtype` bf16 runs
        the MRF stages in K1's bf16 mode (the module docstring)."""
        cfg = self.cfg
        if self.weight_norm:
            raise RuntimeError("HiFiGANGenerator.forward serves plain weights: call fold_weight_norm() and serve "
                               "the generator it returns (forward_train runs either parameterization)")
        if cfg.resblock != "1":
            if compute_dtype != torch.float32:
                raise ValueError("HiFiGANGenerator.forward: the bf16 mode is K1's, which runs ResBlock1 stages; "
                                 "ResBlock2 serves in f32")
            return self.forward_train(mel)
        return _serve(self, mel, [self.stage_weights(i, compute_dtype) for i in range(len(self.ups))])

    def for_export(self) -> nn.Module:
        """The serving forward as ``torch.export`` can trace it: a ResBlock1
        generator becomes a ``PackedGenerator``; a ResBlock2 one, which runs
        plain convs, is returned as it is."""
        return PackedGenerator(self) if self.cfg.resblock == "1" and not self.weight_norm else self

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


def _serve(gen, mel: torch.Tensor, stages) -> torch.Tensor:
    """The serving forward of a ResBlock1 generator, every MRF stage through
    ``mrf_stage`` on `stages` (``stage_weights`` of each stage)."""
    cfg = gen.cfg
    dils = tuple(tuple(d) for d in cfg.resblock_dilation_sizes)
    x = gen.conv_pre(mel.transpose(1, 2))
    for up, weights in zip(gen.ups, stages):
        x = up(F.leaky_relu(x, LRELU_SLOPE))
        x = mrf_stage(x.transpose(1, 2).contiguous(), weights, cfg.resblock_kernel_sizes, dils).transpose(1, 2)
    x = gen.conv_post(F.leaky_relu(x, 0.01))
    return torch.tanh(x)[:, 0, :]


class PackedGenerator(nn.Module):
    """A ResBlock1 generator's serving forward with the MRF stages' operands
    (``stage_weights``: K1's packed operands on the card, the contract's
    stacked weights on the CPU), made once here, held as buffers in place of
    the res-block convs: under ``torch.export`` the parameters have no storage
    to pack from, and an exported program then carries each weight once.
    Shares the other convs with the generator it was made from.  f32 only, as
    the JAX package's export, which ignores the pipeline's precision."""

    def __init__(self, gen: HiFiGANGenerator):
        super().__init__()
        self.cfg = gen.cfg
        self.conv_pre, self.ups, self.conv_post = gen.conv_pre, gen.ups, gen.conv_post
        for i in range(len(gen.ups)):
            for r, rb in enumerate(gen.stage_weights(i)):
                for j, t in enumerate(rb):
                    self.register_buffer(f"mrf_{i}_{r}_{j}", t)

    def stages(self) -> list:
        n_rb = len(self.cfg.resblock_kernel_sizes)
        return [[tuple(getattr(self, f"mrf_{i}_{r}_{j}") for j in range(4)) for r in range(n_rb)]
                for i in range(len(self.ups))]

    @torch.no_grad()
    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        return _serve(self, mel, self.stages())
