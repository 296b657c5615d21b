"""Plain reference of the synthesis path: Matcha-TTS (text encoder, duration
head, alignment, Euler CFM over the 1-D U-Net), HiFi-GAN v1 and the spectral
denoiser, one utterance at a time, in plain ``torch.nn.functional`` calls on
a state dict with the Matcha-TTS and HiFi-GAN checkpoint names.

It follows the published Matcha-TTS code (``matcha/models``) and HiFi-GAN
(``matcha/hifigan/models.py``) with the fork quirks the served model keeps:
``w_ceil = ceil(exp(logw)) * length_scale``; padded mel frames enter the
decoder's attention with a bias of -1, not -inf (diffusers' float mask), so a
row's mel depends on the mel capacity it is decoded at; the vocoder and the
denoiser run over the whole capacity and the audio is cut afterwards.  The
denoiser's inverse STFT is ``torch.istft``.  Nothing here imports the
program.  The text front end covers what the benchmark's traffic sends:
letters, spaces and ``,.!?`` (no digits, abbreviations or other marks), which
the served front end maps through its grapheme path (no phonemizer on the
card) to one symbol each.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

# the Matcha-TTS symbol table (matcha/text/symbols.py), first occurrence wins; 178 trained rows
_PAD = "_"
_PUNCTUATION = ';:,.!?¡¿—…"«»“” '
_LETTERS = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
N_VOCAB = 178
SYMBOL_ID: Dict[str, int] = {}
for _i, _s in enumerate([_PAD] + list(_PUNCTUATION) + list(_LETTERS)):
    SYMBOL_ID.setdefault(_s, _i)
TEXT_ALPHABET = set("abcdefghijklmnopqrstuvwxyz ,.!?")
_WS = re.compile(r"\s+")


def text_ids(text: str) -> List[int]:
    """Symbol ids with a blank (0) between and around them."""
    cleaned = _WS.sub(" ", "".join(c for c in text.lower() if c in SYMBOL_ID))
    ids = [SYMBOL_ID[c] for c in cleaned if SYMBOL_ID[c] < N_VOCAB]
    out = [0] * (2 * len(ids) + 1)
    out[1::2] = ids
    return out


# ---------------------------------------------------------------------- #
# weight specs (names, shapes, seeded init)
# ---------------------------------------------------------------------- #

def _layer(spec, name, w_shape, fan_in, std=None, bias=True):
    std = std if std is not None else 1.0 / math.sqrt(3.0 * fan_in)
    spec.append((f"{name}.weight", tuple(w_shape), ("normal", std)))
    if bias:
        spec.append((f"{name}.bias", (w_shape[0],), ("normal", 1.0 / math.sqrt(3.0 * fan_in))))


def _conv(spec, name, c_out, c_in, k, bias=True):
    _layer(spec, name, (c_out, c_in, k), c_in * k, bias=bias)


def _linear(spec, name, d_out, d_in, bias=True):
    _layer(spec, name, (d_out, d_in), d_in, bias=bias)


def _norm(spec, name, c, g="weight", b="bias"):
    spec.append((f"{name}.{g}", (c,), ("const", 1.0)))
    spec.append((f"{name}.{b}", (c,), ("const", 0.0)))


def matcha_spec(cfg: dict, spk_std: float) -> list:
    """Matcha-TTS's parameters at `cfg` (the configuration's ``model``),
    PyTorch's default initialisation scales (uniform ±1/√fan_in, here as a
    normal of that variance; the text embedding as Matcha-TTS draws it),
    but the speaker embedding at N(0, `spk_std`): at PyTorch's N(0, 1) the
    random voices' speaking rates differ by up to 4.5 times, so that the
    seed, which draws the voices, would change the work."""
    m, enc, dp, dec = cfg, cfg["encoder"], cfg["duration_predictor"], cfg["decoder"]
    ch, spk = enc["n_channels"], m["spk_emb_dim"]
    hid = ch + spk
    s = [("spk_emb.weight", (m["n_spks"], spk), ("normal", spk_std)),
         ("encoder.emb.weight", (m["n_vocab"], ch), ("normal", ch ** -0.5))]
    for i in range(3):
        _conv(s, f"encoder.prenet.conv_layers.{i}", ch, ch, 5)
        _norm(s, f"encoder.prenet.norm_layers.{i}", ch, "gamma", "beta")
    _conv(s, "encoder.prenet.proj", ch, ch, 1)
    for i in range(enc["n_layers"]):
        p = f"encoder.encoder.attn_layers.{i}"
        for q in ("q", "k", "v", "o"):
            _conv(s, f"{p}.conv_{q}", hid, hid, 1)
        _norm(s, f"encoder.encoder.norm_layers_1.{i}", hid, "gamma", "beta")
        _conv(s, f"encoder.encoder.ffn_layers.{i}.conv_1", enc["filter_channels"], hid, enc["kernel_size"])
        _conv(s, f"encoder.encoder.ffn_layers.{i}.conv_2", hid, enc["filter_channels"], enc["kernel_size"])
        _norm(s, f"encoder.encoder.norm_layers_2.{i}", hid, "gamma", "beta")
    _conv(s, "encoder.proj_m", m["n_feats"], hid, 1)
    f_dp = dp["filter_channels_dp"]
    _conv(s, "encoder.proj_w.conv_1", f_dp, hid, dp["kernel_size"])
    _norm(s, "encoder.proj_w.norm_1", f_dp, "gamma", "beta")
    _conv(s, "encoder.proj_w.conv_2", f_dp, f_dp, dp["kernel_size"])
    _norm(s, "encoder.proj_w.norm_2", f_dp, "gamma", "beta")
    _conv(s, "encoder.proj_w.proj", 1, f_dp, 1)

    e = "decoder.estimator"
    c_in = 2 * m["n_feats"] + spk
    chans = list(dec["channels"])
    tdim = chans[0] * 4
    _linear(s, f"{e}.time_mlp.linear_1", tdim, c_in)
    _linear(s, f"{e}.time_mlp.linear_2", tdim, tdim)

    def resnet(p, d_in, d_out):
        _linear(s, f"{p}.mlp.1", d_out, tdim)
        _conv(s, f"{p}.block1.block.0", d_out, d_in, 3)
        _norm(s, f"{p}.block1.block.1", d_out)
        _conv(s, f"{p}.block2.block.0", d_out, d_out, 3)
        _norm(s, f"{p}.block2.block.1", d_out)
        _conv(s, f"{p}.res_conv", d_out, d_in, 1)

    def transformer(p, d):
        inner = dec["num_heads"] * dec["attention_head_dim"]
        _norm(s, f"{p}.norm1", d)
        for q in ("q", "k", "v"):
            _linear(s, f"{p}.attn1.to_{q}", inner, d, bias=False)
        _linear(s, f"{p}.attn1.to_out.0", d, inner)
        _norm(s, f"{p}.norm3", d)
        s.append((f"{p}.ff.net.0.alpha", (4 * d,), ("const", 0.0)))
        s.append((f"{p}.ff.net.0.beta", (4 * d,), ("const", 0.0)))
        _linear(s, f"{p}.ff.net.0.proj", 4 * d, d)
        _linear(s, f"{p}.ff.net.2", d, 4 * d)

    prev = c_in
    for i, c in enumerate(chans):
        resnet(f"{e}.down_blocks.{i}.0", prev, c)
        for j in range(dec["n_blocks"]):
            transformer(f"{e}.down_blocks.{i}.1.{j}", c)
        _conv(s, f"{e}.down_blocks.{i}.2" + ("" if i == len(chans) - 1 else ".conv"), c, c, 3)
        prev = c
    for i in range(dec["num_mid_blocks"]):
        resnet(f"{e}.mid_blocks.{i}.0", chans[-1], chans[-1])
        for j in range(dec["n_blocks"]):
            transformer(f"{e}.mid_blocks.{i}.1.{j}", chans[-1])
    up = chans[::-1] + [chans[0]]
    for i in range(len(up) - 1):
        c = up[i + 1]
        last = i == len(up) - 2
        resnet(f"{e}.up_blocks.{i}.0", 2 * up[i], c)
        for j in range(dec["n_blocks"]):
            transformer(f"{e}.up_blocks.{i}.1.{j}", c)
        if last:
            _conv(s, f"{e}.up_blocks.{i}.2", c, c, 3)
        else:  # ConvTranspose1d(c, c, 4, 2, 1): weight (in, out, k), fan_in as PyTorch reads it (out · k)
            s.append((f"{e}.up_blocks.{i}.2.conv.weight", (c, c, 4), ("normal", 1.0 / math.sqrt(3.0 * c * 4))))
            s.append((f"{e}.up_blocks.{i}.2.conv.bias", (c,), ("normal", 1.0 / math.sqrt(3.0 * c * 4))))
    _conv(s, f"{e}.final_block.block.0", up[-1], up[-1], 3)
    _norm(s, f"{e}.final_block.block.1", up[-1])
    _conv(s, f"{e}.final_proj", m["n_feats"], up[-1], 1)
    return s


def hifigan_spec(cfg: dict) -> list:
    """HiFi-GAN's generator at `cfg` (the configuration's ``vocoder``), at
    PyTorch's default initialisation scales as the served generator is made
    (HiFi-GAN's own N(0, 0.01) is a weight-norm direction: as plain weights
    it leaves the output all but constant)."""
    s = []
    c = cfg["upsample_initial_channel"]

    def w(name, shape, fan_in):
        s.append((f"{name}.weight", tuple(shape), ("normal", 1.0 / math.sqrt(3.0 * fan_in))))
        s.append((f"{name}.bias", (shape[1] if name.startswith("ups.") else shape[0],),
                  ("normal", 1.0 / math.sqrt(3.0 * fan_in))))

    w("conv_pre", (c, cfg["num_mels"], 7), cfg["num_mels"] * 7)
    n = 0
    for i, (u, k) in enumerate(zip(cfg["upsample_rates"], cfg["upsample_kernel_sizes"])):
        w(f"ups.{i}", (c, c // 2, k), (c // 2) * k)
        c //= 2
        for rk, rd in zip(cfg["resblock_kernel_sizes"], cfg["resblock_dilation_sizes"]):
            for conv in ("convs1", "convs2"):
                for j in range(len(rd)):
                    w(f"resblocks.{n}.{conv}.{j}", (c, c, rk), c * rk)
            n += 1
    w("conv_post", (1, c, 7), c * 7)
    return s


def calibrate_durations(sd, cfg, texts: List[str], speakers: List[int], weights: List[float], chars_per_s: float,
                        frame_rate: float) -> float:
    """Shift the duration head's bias so that `texts`, spoken by each of
    `speakers` in the proportions `weights`, are predicted to last as long
    as speech at `chars_per_s` characters a second: an untrained model's
    durations are a property of its random weights, and would change the
    work from seed to seed.  The shift is found by bisection on the
    predicted frames (before the speaking rate) and added to the bias in
    place → the shift."""
    logws = [(wt, torch.log(encode(sd, cfg, text_ids(t), spk, 1.0)[1]))
             for spk, wt in zip(speakers, weights) for t in texts]
    target = sum(weights) * sum(len(t) for t in texts) / chars_per_s * frame_rate
    lo, hi = -8.0, 8.0
    for _ in range(60):
        mid = (lo + hi) / 2
        frames = sum(wt * float(torch.ceil(torch.exp(lw + mid)).sum()) for wt, lw in logws)
        lo, hi = (mid, hi) if frames < target else (lo, mid)
    shift = (lo + hi) / 2
    sd["encoder.proj_w.proj.bias"].add_(shift)
    return shift


# ---------------------------------------------------------------------- #
# the forward
# ---------------------------------------------------------------------- #

def _chan_ln(x, g, b, eps=1e-4):
    mean = x.mean(1, keepdim=True)
    var = ((x - mean) ** 2).mean(1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * g[None, :, None] + b[None, :, None]


def _conv1d(sd, name, x, padding=0, dilation=1, stride=1):
    return F.conv1d(x, sd[f"{name}.weight"], sd[f"{name}.bias"], stride, padding, dilation)


def _rope(x, d, base=10_000.0):
    """Rotate the first d dims of x (1, H, T, D), the neg-half convention;
    tables in float64, cast to x's dtype."""
    t = x.shape[-2]
    theta = 1.0 / (base ** (np.arange(0, d, 2, dtype=np.float64) / d))
    ang = np.arange(t, dtype=np.float64)[:, None] * theta[None, :]
    ang = np.concatenate([ang, ang], axis=1)
    cos = torch.from_numpy(np.cos(ang).astype(np.float32)).to(x.device, x.dtype)
    sin = torch.from_numpy(np.sin(ang).astype(np.float32)).to(x.device, x.dtype)
    xr, xp = x[..., :d], x[..., d:]
    neg = torch.cat([-xr[..., d // 2:], xr[..., :d // 2]], dim=-1)
    return torch.cat([xr * cos + neg * sin, xp], dim=-1)


def encode(sd, cfg, ids: List[int], spk: int, length_scale: float, dtype=torch.float32):
    """One utterance's ids → (mu_x (L, n_feats), w (L,) before the ceil,
    w_ceil (L,), y_len)."""
    enc, dp = cfg["encoder"], cfg["duration_predictor"]
    dev = sd["encoder.emb.weight"].device
    x = torch.tensor(ids, device=dev)
    ch = enc["n_channels"]
    h = (sd["encoder.emb.weight"][x] * math.sqrt(ch)).T[None].to(dtype)  # (1, C, L)
    x_org = h
    p = "encoder.prenet"
    for i in range(3):
        h = _conv1d(sd, f"{p}.conv_layers.{i}", h, padding=2)
        h = F.relu(_chan_ln(h, sd[f"{p}.norm_layers.{i}.gamma"], sd[f"{p}.norm_layers.{i}.beta"]))
    h = x_org + _conv1d(sd, "encoder.prenet.proj", h)
    spk_e = sd["spk_emb.weight"][spk].to(dtype)
    h = torch.cat([h, spk_e[None, :, None].expand(1, -1, h.shape[-1])], dim=1)
    heads = enc["n_heads"]
    kc = h.shape[1] // heads
    for i in range(enc["n_layers"]):
        p = f"encoder.encoder.attn_layers.{i}"
        q, k, v = (_conv1d(sd, f"{p}.conv_{n}", h).view(1, heads, kc, -1).transpose(2, 3) for n in "qkv")
        rd = int(kc * 0.5)
        q, k = _rope(q, rd), _rope(k, rd)
        a = torch.softmax(q @ k.transpose(-2, -1) / math.sqrt(kc), dim=-1) @ v
        a = _conv1d(sd, f"{p}.conv_o", a.transpose(2, 3).reshape(1, -1, h.shape[-1]))
        n1 = f"encoder.encoder.norm_layers_1.{i}"
        h = _chan_ln(h + a, sd[f"{n1}.gamma"], sd[f"{n1}.beta"])
        f = f"encoder.encoder.ffn_layers.{i}"
        pad = enc["kernel_size"] // 2
        y = _conv1d(sd, f"{f}.conv_2", F.relu(_conv1d(sd, f"{f}.conv_1", h, padding=pad)), padding=pad)
        n2 = f"encoder.encoder.norm_layers_2.{i}"
        h = _chan_ln(h + y, sd[f"{n2}.gamma"], sd[f"{n2}.beta"])
    mu = _conv1d(sd, "encoder.proj_m", h)
    pad = dp["kernel_size"] // 2
    d = _chan_ln(F.relu(_conv1d(sd, "encoder.proj_w.conv_1", h, padding=pad)),
                 sd["encoder.proj_w.norm_1.gamma"], sd["encoder.proj_w.norm_1.beta"])
    d = _chan_ln(F.relu(_conv1d(sd, "encoder.proj_w.conv_2", d, padding=pad)),
                 sd["encoder.proj_w.norm_2.gamma"], sd["encoder.proj_w.norm_2.beta"])
    logw = _conv1d(sd, "encoder.proj_w.proj", d)[0, 0]
    w = torch.exp(logw.float())
    w_ceil = torch.ceil(w) * length_scale
    y_len = int(torch.clamp_min(w_ceil.sum(), 1.0).to(torch.int32))
    return mu[0].T, w, w_ceil, y_len, spk_e


def _mish(x):
    return x * torch.tanh(F.softplus(x))


def _block1d(sd, p, x, mask):
    y = F.conv1d(x * mask, sd[f"{p}.block.0.weight"], sd[f"{p}.block.0.bias"], padding=1)
    y = F.group_norm(y, 8, sd[f"{p}.block.1.weight"], sd[f"{p}.block.1.bias"], eps=1e-5)
    return _mish(y) * mask


def _resnet(sd, p, x, mask, temb):
    h = _block1d(sd, f"{p}.block1", x, mask) + F.linear(_mish(temb), sd[f"{p}.mlp.1.weight"],
                                                        sd[f"{p}.mlp.1.bias"])[:, :, None]
    h = _block1d(sd, f"{p}.block2", h, mask)
    return h + _conv1d(sd, f"{p}.res_conv", x * mask)


def _transformer(sd, p, h, mask, heads, head_dim):
    """(1, C, T) → (1, C, T), pre-norm attention (float mask added) + SnakeBeta FFN."""
    x = h.transpose(1, 2)
    c = x.shape[-1]
    t = x.shape[1]
    y = F.layer_norm(x, (c,), sd[f"{p}.norm1.weight"], sd[f"{p}.norm1.bias"], 1e-5)
    q, k, v = (F.linear(y, sd[f"{p}.attn1.to_{n}.weight"]).view(1, t, heads, head_dim).transpose(1, 2)
               for n in "qkv")
    scores = q @ k.transpose(-2, -1) / math.sqrt(head_dim) + mask[:, None, :, :]
    a = (torch.softmax(scores, dim=-1) @ v).transpose(1, 2).reshape(1, t, -1)
    x = x + F.linear(a, sd[f"{p}.attn1.to_out.0.weight"], sd[f"{p}.attn1.to_out.0.bias"])
    y = F.layer_norm(x, (c,), sd[f"{p}.norm3.weight"], sd[f"{p}.norm3.bias"], 1e-5)
    y = F.linear(y, sd[f"{p}.ff.net.0.proj.weight"], sd[f"{p}.ff.net.0.proj.bias"])
    s = torch.sin(y * torch.exp(sd[f"{p}.ff.net.0.alpha"]))
    y = y + (1.0 / (torch.exp(sd[f"{p}.ff.net.0.beta"]) + 1e-9)) * s * s
    x = x + F.linear(y, sd[f"{p}.ff.net.2.weight"], sd[f"{p}.ff.net.2.bias"])
    return x.transpose(1, 2)


def estimator(sd, cfg, x, mask, mu, t: float, spk_e):
    """The U-Net's velocity at time t: x, mu (1, n_feats, T), mask (1, 1, T)."""
    dec = cfg["decoder"]
    e = "decoder.estimator"
    chans = list(dec["channels"])
    c_in = 2 * cfg["n_feats"] + cfg["spk_emb_dim"]
    half = c_in // 2
    log_base = float(torch.log(torch.tensor(10000.0, dtype=torch.float32)))
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=x.device) * (-log_base / (half - 1)))
    ang = 1000.0 * torch.full((1, 1), t, dtype=torch.float32, device=x.device) * freqs[None, :]
    temb = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    temb = F.linear(F.silu(F.linear(temb, sd[f"{e}.time_mlp.linear_1.weight"], sd[f"{e}.time_mlp.linear_1.bias"])),
                    sd[f"{e}.time_mlp.linear_2.weight"], sd[f"{e}.time_mlp.linear_2.bias"]).to(x.dtype)
    h = torch.cat([x, mu, spk_e[None, :, None].expand(1, -1, x.shape[-1])], dim=1)
    hd, nh = dec["attention_head_dim"], dec["num_heads"]
    hiddens, masks = [], [mask]
    for i in range(len(chans)):
        m = masks[-1]
        h = _resnet(sd, f"{e}.down_blocks.{i}.0", h, m, temb)
        for j in range(dec["n_blocks"]):
            h = _transformer(sd, f"{e}.down_blocks.{i}.1.{j}", h, m, nh, hd)
        hiddens.append(h)
        if i == len(chans) - 1:
            h = _conv1d(sd, f"{e}.down_blocks.{i}.2", h * m, padding=1)
        else:
            h = _conv1d(sd, f"{e}.down_blocks.{i}.2.conv", h * m, padding=1, stride=2)
        masks.append(m[:, :, ::2])
    masks = masks[:-1]
    m = masks[-1]
    for i in range(dec["num_mid_blocks"]):
        h = _resnet(sd, f"{e}.mid_blocks.{i}.0", h, m, temb)
        for j in range(dec["n_blocks"]):
            h = _transformer(sd, f"{e}.mid_blocks.{i}.1.{j}", h, m, nh, hd)
    for i in range(len(chans)):
        m = masks.pop()
        h = _resnet(sd, f"{e}.up_blocks.{i}.0", torch.cat([h, hiddens.pop()], dim=1), m, temb)
        for j in range(dec["n_blocks"]):
            h = _transformer(sd, f"{e}.up_blocks.{i}.1.{j}", h, m, nh, hd)
        if i == len(chans) - 1:
            h = _conv1d(sd, f"{e}.up_blocks.{i}.2", h * m, padding=1)
        else:
            h = F.conv_transpose1d(h * m, sd[f"{e}.up_blocks.{i}.2.conv.weight"],
                                   sd[f"{e}.up_blocks.{i}.2.conv.bias"], stride=2, padding=1)
    h = _block1d(sd, f"{e}.final_block", h, m)
    return _conv1d(sd, f"{e}.final_proj", h * m) * mask


def decode(sd, cfg, mu_x, w_ceil, y_len: int, m_bucket: int, z, steps: int, spk_e):
    """The mel at capacity `m_bucket` (the whole capacity, (m_bucket, n_feats))
    from the encoder's outputs and the initial noise z (m_bucket, n_feats),
    already scaled by the temperature."""
    dev, dtype = mu_x.device, mu_x.dtype
    y_len = min(y_len, m_bucket)
    ymask = (torch.arange(m_bucket, device=dev) < y_len).to(dtype)[None, None, :]  # (1, 1, T)
    cum = torch.cumsum(w_ceil.float(), 0)
    pos = torch.arange(m_bucket, device=dev, dtype=torch.float32)
    path = (pos[None, :] < cum[:, None]).float()
    path = (path - F.pad(path, (0, 0, 1, 0))[:-1]) * ymask[0].float()  # (L, T)
    mu_y = (path.to(dtype).T @ mu_x).T[None]  # (1, n_feats, T)
    x = z.to(dtype).T[None] * ymask
    dt = 1.0 / steps
    for step in range(steps):
        x = x + dt * estimator(sd, cfg, x, ymask, mu_y, step * dt, spk_e)
    stats = cfg["data_statistics"]
    mel = (x * ymask) * stats["mel_std"] + stats["mel_mean"]
    return mel[0].T.float()


def vocode(sd, cfg, mel, dtype=torch.float32):
    """HiFi-GAN v1 on plain convolutions: mel (T, n_mels) → wav (T · 256,)."""
    n = len(cfg["resblock_kernel_sizes"])
    x = _conv1d(sd, "conv_pre", mel.T[None].to(dtype), padding=3)
    rb = 0
    for i, (u, k) in enumerate(zip(cfg["upsample_rates"], cfg["upsample_kernel_sizes"])):
        x = F.conv_transpose1d(F.leaky_relu(x, 0.1), sd[f"ups.{i}.weight"], sd[f"ups.{i}.bias"], stride=u,
                               padding=(k - u) // 2)
        xs = None
        for rk, rd in zip(cfg["resblock_kernel_sizes"], cfg["resblock_dilation_sizes"]):
            y = x
            for j, d in enumerate(rd):
                t = _conv1d(sd, f"resblocks.{rb}.convs1.{j}", F.leaky_relu(y, 0.1), padding=(rk * d - d) // 2,
                            dilation=d)
                y = y + _conv1d(sd, f"resblocks.{rb}.convs2.{j}", F.leaky_relu(t, 0.1), padding=(rk - 1) // 2)
            xs = y if xs is None else xs + y
            rb += 1
        x = xs / n
    x = _conv1d(sd, "conv_post", F.leaky_relu(x, 0.01), padding=3)
    return torch.tanh(x)[0, 0].float()


N_FFT, HOP = 1024, 256


def _stft(y):
    return torch.stft(y, N_FFT, HOP, N_FFT, window=torch.hann_window(N_FFT, device=y.device), center=True,
                      pad_mode="reflect", return_complex=True)  # (F, frames)


def bias_spectrum(sd_voc, cfg_voc, num_mels: int):
    """The denoiser's bias: the magnitude of frame 0 of the vocoder's answer
    to an all-zero mel of 88 frames."""
    dev = sd_voc["conv_pre.weight"].device
    wav = vocode(sd_voc, cfg_voc, torch.zeros((88, num_mels), device=dev))
    return _stft(wav).abs()[:, 0:1]


def denoise(wav, bias, strength: float):
    spec = _stft(wav)
    mag = spec.abs()
    mag_d = torch.clamp_min(mag - bias * strength, 0.0)
    return torch.istft(spec * (mag_d / torch.clamp_min(mag, 1e-12)), N_FFT, HOP, N_FFT,
                       window=torch.hann_window(N_FFT, device=wav.device), center=True, length=wav.shape[0])


def pcm16(wav):
    """The served int16 audio, read back as float: clip, scale, truncate."""
    return (torch.clamp(wav, -1.0, 1.0) * 32767.0).to(torch.int16).float() / 32767.0
