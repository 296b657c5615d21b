"""The yardstick's count of operations and bytes, worked out from shapes.

Operations are products, two per multiply-add, of the algorithm at the
shapes a call runs (its text bucket, mel bucket and batch rows, pad rows
included: the work the card is given), whatever kernel computes them.
Elementwise work is not counted.  Bytes count each input, weight and output
of a counted piece once.  Counts follow ``emojivoice_tpu_torch/bench/mfu.py``
(HiFi-GAN's MRF stage 252·B·T·C² for v1, the denoiser's FFTs at
5·N·log2 N / 2 per real frame), which they were copied from, and add the
acoustic model's pieces from its configuration, not from hooks on the
program's modules.

The peaks are fixed data-sheet rates of one H100 SXM (NVIDIA's data sheet,
dense): a float32 product is held to the TF32 tensor-core rate, the fastest
that any implementation of float32 work on the card reaches, so that a
share of it cannot pass 100 % whichever route a kernel takes.
"""

from __future__ import annotations

import math

TF32_FLOPS = 495e12  # the bound for float32 work (TF32 dense)
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


class Work:
    """Operations and bytes, added up."""

    def __init__(self, flops: float = 0.0, nbytes: float = 0.0):
        self.flops, self.bytes = float(flops), float(nbytes)

    def __add__(self, other: "Work") -> "Work":
        return Work(self.flops + other.flops, self.bytes + other.bytes)

    def __mul__(self, k: float) -> "Work":
        return Work(self.flops * k, self.bytes * k)

    def bound_s(self, flops_per_s: float = TF32_FLOPS) -> float:
        """The least time on the card: the larger of operations over the
        peak and bytes over the memory rate."""
        return max(self.flops / flops_per_s, self.bytes / HBM_BYTES_PER_S)


def conv(b: int, t_out: int, c_in: int, c_out: int, k: int) -> float:
    return 2.0 * b * t_out * c_in * c_out * k


# --------------------------------------------------------------------- HiFi-GAN and K1

def mrf_stage(cfg: dict, c: int, b: int, t: int) -> Work:
    """One MRF stage (K1's call) at C channels over T samples: per res-block
    and dilation two convs of k taps; bytes: the stage's input and output
    once and its weights."""
    flops = sum(2 * len(d) * conv(b, t, c, c, k)
                for k, d in zip(cfg["resblock_kernel_sizes"], cfg["resblock_dilation_sizes"]))
    n_w = sum(2 * len(d) * (c * c * k + c) for k, d in zip(cfg["resblock_kernel_sizes"], cfg["resblock_dilation_sizes"]))
    return Work(flops, 4.0 * (2 * b * t * c + n_w))


def k1_calls(cfg: dict, b: int, frames: int) -> list:
    """The MRF stages of one vocoder call at (B, frames) mel frames."""
    out, t, c = [], frames, cfg["upsample_initial_channel"]
    for u in cfg["upsample_rates"]:
        t, c = t * u, c // 2
        out.append(mrf_stage(cfg, c, b, t))
    return out


def hifigan(cfg: dict, b: int, frames: int) -> Work:
    """The generator's products (conv_pre, the upsampling convs, the MRF
    stages, conv_post); bytes: mel, weights and waveform once."""
    flops = conv(b, frames, cfg["num_mels"], cfg["upsample_initial_channel"], 7)
    t, c = frames, cfg["upsample_initial_channel"]
    n_params = cfg["num_mels"] * c * 7 + c
    for u, k in zip(cfg["upsample_rates"], cfg["upsample_kernel_sizes"]):
        flops += 2.0 * b * t * c * (c // 2) * k
        n_params += c * (c // 2) * k + c // 2
        t, c = t * u, c // 2
        flops += mrf_stage(cfg, c, b, t).flops
        n_params += sum(2 * len(d) * (c * c * rk + c)
                        for rk, d in zip(cfg["resblock_kernel_sizes"], cfg["resblock_dilation_sizes"]))
    flops += conv(b, t, c, 1, 7)
    n_params += c * 7 + 1
    return Work(flops, 4.0 * (b * frames * cfg["num_mels"] + n_params + b * t))


def denoiser(b: int, samples: int, n_fft: int = 1024, hop: int = 256) -> Work:
    frames = samples // hop + 1
    bins = n_fft // 2 + 1
    fft = 2 * 5 * n_fft * math.log2(n_fft) / 2
    return Work(b * frames * (fft + 8 * bins), 4.0 * b * (2 * samples + frames * bins * 2 * 3))


# --------------------------------------------------------------------- Matcha-TTS

def _attention(b: int, t: int, inner: int) -> float:
    """Scores and the weighted sum over `inner` = heads · head_dim."""
    return 4.0 * b * inner * t * t


def encoder(cfg: dict, b: int, t: int) -> Work:
    """Text encoder and duration head at (B, T) ids."""
    enc, dp = cfg["encoder"], cfg["duration_predictor"]
    ch = enc["n_channels"]
    hid = ch + cfg["spk_emb_dim"]
    f = 3 * conv(b, t, ch, ch, 5) + conv(b, t, ch, ch, 1)
    per = 4 * conv(b, t, hid, hid, 1) + _attention(b, t, hid) + \
        conv(b, t, hid, enc["filter_channels"], enc["kernel_size"]) * 2
    f += enc["n_layers"] * per
    f += conv(b, t, hid, cfg["n_feats"], 1)
    fd = dp["filter_channels_dp"]
    f += conv(b, t, hid, fd, dp["kernel_size"]) + conv(b, t, fd, fd, dp["kernel_size"]) + conv(b, t, fd, 1, 1)
    n_w = 3 * (ch * ch * 5) + ch * ch + enc["n_layers"] * (4 * hid * hid + 2 * hid * enc["filter_channels"] *
                                                          enc["kernel_size"]) + hid * cfg["n_feats"]
    return Work(f, 4.0 * (n_w + b * t * (hid + cfg["n_feats"] + 1)))


def estimator(cfg: dict, b: int, t: int) -> Work:
    """One call of the CFM's U-Net at (B, T) mel frames."""
    dec = cfg["decoder"]
    chans = list(dec["channels"])
    c_in = 2 * cfg["n_feats"] + cfg["spk_emb_dim"]
    tdim = chans[0] * 4
    inner = dec["num_heads"] * dec["attention_head_dim"]
    f = 2.0 * b * (c_in * tdim + tdim * tdim)

    def resnet(d_in, d_out, tt):
        return 2.0 * b * tdim * d_out + conv(b, tt, d_in, d_out, 3) + conv(b, tt, d_out, d_out, 3) + \
            conv(b, tt, d_in, d_out, 1)

    def block(d, tt):
        return dec["n_blocks"] * (3 * 2.0 * b * tt * d * inner + _attention(b, tt, inner) + 2.0 * b * tt * inner * d +
                                  2 * 2.0 * b * tt * d * 4 * d)

    prev, tt, lengths = c_in, t, []
    for i, c in enumerate(chans):
        f += resnet(prev, c, tt) + block(c, tt)
        lengths.append(tt)
        if i == len(chans) - 1:
            f += conv(b, tt, c, c, 3)
        else:
            tt = (tt + 1) // 2
            f += conv(b, tt, c, c, 3)
        prev = c
    f += dec["num_mid_blocks"] * (resnet(chans[-1], chans[-1], tt) + block(chans[-1], tt))
    up = chans[::-1] + [chans[0]]
    for i in range(len(up) - 1):
        c = up[i + 1]
        tt = lengths.pop()
        f += resnet(2 * up[i], c, tt) + block(c, tt)
        if i == len(up) - 2:
            f += conv(b, tt, c, c, 3)
        else:
            f += 2.0 * b * tt * c * c * 4  # the transposed conv, k 4 stride 2, on the tt-long input
    f += conv(b, t, up[-1], up[-1], 3) + conv(b, t, up[-1], cfg["n_feats"], 1)
    return Work(f, 4.0 * b * t * (2 * c_in + cfg["n_feats"]))


def synthesis(model: dict, vocoder: dict, b: int, t_text: int, m_bucket: int, steps: int,
              vocode: bool = True, denoise: bool = True) -> Work:
    """One synthesis call at (B, text bucket, mel bucket): encoder, the
    alignment expansion, `steps` U-Net calls, and HiFi-GAN and the denoiser
    where they run."""
    w = encoder(model, b, t_text)
    w = w + Work(2.0 * b * t_text * m_bucket * model["n_feats"], 0.0)
    w = w + estimator(model, b, m_bucket) * steps
    if vocode:
        w = w + hifigan(vocoder, b, m_bucket)
    if denoise:
        w = w + denoiser(b, m_bucket * math.prod(vocoder["upsample_rates"]))
    return w


def train_step(model: dict, b: int, t_text: int, t_mel: int, out_size: int | None = None) -> Work:
    """The acoustic training step: the encoder, the log-prior for MAS, one
    U-Net call on the (cropped) target; three times the forward for forward
    and backward."""
    t = out_size or t_mel
    f = encoder(model, b, t_text) + Work(3 * 2.0 * b * t_text * t_mel * model["n_feats"], 0.0) + \
        estimator(model, b, t)
    return f * 3


def mas(b: int, t_text: int, t_mel: int) -> Work:
    """K2, the monotonic alignment search: a max and an add per cell of the
    (B, T_text, T_mel) value grid; it reads the grid and the mask and writes
    the path once."""
    cells = b * t_text * t_mel
    return Work(2.0 * cells, 4.0 * 3 * cells)


# --------------------------------------------------------------------- GPT-J

def gptj_weight_bytes(cfg: dict, itemsize: int = 4) -> float:
    """Bytes of GPT-J's weights that one decode step reads: every block, the
    final norm and the head (the embedding reads one row)."""
    d, v = cfg["n_embd"], cfg["vocab_size"]
    inner = cfg.get("n_inner") or 4 * d
    per_block = 4 * d * d + 2 * d * inner + inner + d + 2 * d
    return float(itemsize * (cfg["n_layer"] * per_block + 2 * d + v * d + v))
