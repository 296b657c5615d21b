"""MatchaTTS acoustic model, text → mel (PyTorch port of
``emojivoice_tpu.models.matcha``): the inference stages, the training
forward with monotonic alignment search, and the convergence probe.

Public tensors are channels-last like the JAX model's.  Parameter names are
the reference checkpoint's (``export_matcha_state_dict`` naming, with the
``mel_mean``/``mel_std`` buffers), so a released ``.ckpt`` can load through
the same names.

Fork quirk kept: ``w_ceil = ceil(exp(logw)) * length_scale`` (scale after the
ceil) and ``y_lengths = int(max(sum(w_ceil), 1))``.

Reduced precision follows the JAX package's casts: the compute dtype is the
parameters' (a bf16 copy of the model, or bf16 batch floats under
``bf16-mixed``); masks follow it, while durations, the alignment path's
construction and the losses stay f32.

Training: ``forward`` returns ``(dur_loss, prior_loss, diff_loss, attn)``.
MAS runs under ``torch.no_grad()`` on the detached log-prior (K2 on the
card); the CFM draws ``t``/``z`` and the crop offsets come from the caller
(``utils/prng.py`` or a test), so the model itself holds no random state
apart from dropout.

Over a data-parallel group (``data_group``, set by ``training/state.py``)
the three losses are ratios over the global batch: each rank holds a share
of every sum, the denominators are summed over the group and each ratio is
scaled by the group's size (``parallel/mesh.py::global_ratio``), so that
DDP's mean of the ranks' gradients is the global loss's gradient; the mean
of the ranks' values is the global loss.  Without a group the losses are
the one-device ones.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from emojivoice_tpu_torch.config import ModelConfig
from emojivoice_tpu_torch.models.cfm import CFM
from emojivoice_tpu_torch.models.text_encoder import TextEncoder
from emojivoice_tpu_torch.ops.mas import maximum_path
from emojivoice_tpu_torch.parallel.mesh import global_ratio
from emojivoice_tpu_torch.utils.masks import generate_path, sequence_mask


class MatchaTTS(nn.Module):
    data_group = None  # the data-parallel process group the losses are taken over (module docstring)

    def __init__(self, cfg: ModelConfig, strict_mask: bool = False):
        """`strict_mask`: −1e9, not the reference's −1 bias, on padded keys in
        the decoder's transformer blocks (``models/decoder.py``)."""
        super().__init__()
        self.cfg = cfg
        if cfg.n_spks > 1:
            self.spk_emb = nn.Embedding(cfg.n_spks, cfg.spk_emb_dim)
        self.encoder = TextEncoder(cfg.encoder, cfg.duration_predictor, cfg.n_vocab, cfg.n_spks, cfg.spk_emb_dim)
        self.decoder = CFM(cfg.cfm, cfg.decoder, cfg.n_feats, cfg.n_spks, cfg.spk_emb_dim, strict_mask)
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
        already scaled by the temperature.  Computes in mu_x's dtype (f32 or
        bf16, the model's); the duration → path math stays f32."""
        dtype = mu_x.dtype
        y_lengths = torch.clamp_max(y_lengths, y_max_length)
        y_mask = sequence_mask(y_lengths, y_max_length).float()[..., None]
        attn_mask = x_mask.float() * y_mask.transpose(1, 2)  # (B, T_x, T_y)
        attn = generate_path(w_ceil[..., 0].float(), attn_mask).to(dtype)
        y_mask = y_mask.to(dtype)
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

    # ------------------------------------------------------------------ #
    # Training
    # ------------------------------------------------------------------ #

    def forward(self, x, x_lengths, y, y_lengths, spks=None, durations=None, *, t: torch.Tensor,
                z: torch.Tensor, out_size: Optional[int] = None, crop_offsets: Optional[torch.Tensor] = None,
                row_mask=None):
        """Training forward → (dur_loss, prior_loss, diff_loss, attn).

        x (B, T_x) ids; y (B, T_y, n_feats) normalized mel.  t (B, 1, 1) and z
        (B, T, n_feats) are the CFM draws, with T = out_size where the crop
        applies and T_y otherwise; crop_offsets (B,) are the crop's start
        frames (required with it).  row_mask (B,) zero-weights whole rows (the
        padded tail of an uneven batch); None gives the reference losses.
        Dropout follows ``self.training``.
        """
        cfg = self.cfg
        spk_e = self._embed_spks(spks)
        x_mask, y_mask, _, mu_x, logw, attn = self._encode_align(x, x_lengths, y, y_lengths, spk_e, durations)

        # loss math in f32: bf16 duration counts round above 256
        logw_ = torch.log(1e-8 + attn.float().sum(-1))[..., None] * x_mask
        dur_se = torch.square(logw.float() - logw_)
        group = self.data_group
        if row_mask is None:
            dur_loss = global_ratio(dur_se.sum(), x_lengths.sum(), group)
        else:
            rw = row_mask.float()
            dur_loss = global_ratio((dur_se * rw[:, None, None]).sum(), (rw * x_lengths).sum(), group)

        if out_size is not None and out_size < y.shape[1]:
            if crop_offsets is None:
                raise ValueError("out_size below the mel length needs crop_offsets")
            y, attn, y_mask = self._segment_crop(y, attn, y_lengths, out_size, crop_offsets)

        dtype = y.dtype  # the decoder computes in the batch's dtype (bf16 under mixed precision)
        mu_y = torch.einsum("bxy,bxc->byc", attn.to(dtype), mu_x.to(dtype))
        diff_loss, _ = self.decoder.compute_loss(y, y_mask.to(dtype), mu_y, spk_e, t=t, z=z, row_mask=row_mask,
                                                 data_group=group)

        if cfg.prior_loss:
            y, mu_y, y_mask = y.float(), mu_y.float(), y_mask.float()
            prior_se = 0.5 * (torch.square(y - mu_y) + math.log(2 * math.pi)) * y_mask
            if row_mask is None:
                prior_loss = global_ratio(prior_se.sum(), y_mask.sum() * cfg.n_feats, group)
            else:
                rw3 = row_mask.float()[:, None, None]
                prior_loss = global_ratio((prior_se * rw3).sum(), (y_mask * rw3).sum() * cfg.n_feats, group)
        else:
            prior_loss = torch.zeros((), device=y.device)
        return dur_loss, prior_loss, diff_loss, attn

    @torch.no_grad()
    def align(self, x, x_lengths, y, y_lengths, spks=None):
        """The training forward's alignment alone, without the losses: the MAS
        path ``attn`` (B, T_x, T_y) of the normalized mel `y` against the
        encoder's means (K2 on the card), with what a teacher-forced decode
        needs beside it → (attn, mu_x, x_mask, spk_e).  To be called under
        ``eval()``."""
        spk_e = self._embed_spks(spks)
        x_mask, _, _, mu_x, _, attn = self._encode_align(x, x_lengths, y, y_lengths, spk_e)
        return attn, mu_x, x_mask, spk_e

    def _encode_align(self, x, x_lengths, y, y_lengths, spk_e, durations=None):
        """The training forward's front half, shared with the probe: masks,
        encoder, and the MAS alignment over the Gaussian log-prior
        −½‖y − μ‖² + const (three products, no (B, T_x, T_y, C) tensor)."""
        cfg = self.cfg
        x_mask = sequence_mask(x_lengths, x.shape[1]).float()[..., None]
        y_mask = sequence_mask(y_lengths, y.shape[1]).float()[..., None]
        attn_mask = x_mask * y_mask.transpose(1, 2)  # (B, T_x, T_y)
        mu_x, logw = self.encoder(x, x_mask, spk_e)
        if cfg.use_precomputed_durations and durations is not None:
            attn = generate_path(durations, attn_mask)
        else:
            with torch.no_grad():  # MAS has no gradient: cut before the search
                mu = mu_x.detach()
                const = -0.5 * math.log(2 * math.pi) * cfg.n_feats
                y_sq = -0.5 * torch.square(y).sum(-1)  # (B, T_y)
                cross = torch.einsum("bxc,byc->bxy", mu, y)
                mu_sq = -0.5 * torch.square(mu).sum(-1)  # (B, T_x)
                log_prior = y_sq[:, None, :] + cross + mu_sq[:, :, None] + const
                attn = maximum_path(log_prior.contiguous(), attn_mask.contiguous())
        return x_mask, y_mask, attn_mask, mu_x, logw, attn

    @staticmethod
    def crop_offsets_from_uniform(u: torch.Tensor, y_lengths: torch.Tensor, out_size: int) -> torch.Tensor:
        """Uniform draws u (B,) in [0, 1) → crop start frames, uniform over
        [0, max(y_length − out_size, 0) − 1] (0 where the item is shorter)."""
        max_offset = torch.clamp_min(y_lengths - out_size, 0)
        return torch.floor(u * max_offset.to(u.dtype)).long()

    @staticmethod
    def _segment_crop(y, attn, y_lengths, out_size: int, offsets: torch.Tensor):
        """The "Grad-TTS hack": an out_size-frame crop per item starting at
        `offsets` (B,).  Needs y.shape[1] ≥ out_size (the collate sees to it).
        Returns (y_cut, attn_cut, y_cut_mask) with frames past the item's cut
        length zeroed."""
        idx = offsets.long()[:, None] + torch.arange(out_size, device=y.device)[None, :]  # (B, out_size)
        y_cut = torch.gather(y, 1, idx[:, :, None].expand(-1, -1, y.shape[2]))
        attn_cut = torch.gather(attn, 2, idx[:, None, :].expand(-1, attn.shape[1], -1))
        y_cut_lengths = torch.clamp_max(y_lengths, out_size)
        y_cut_mask = sequence_mask(y_cut_lengths, out_size).float()[..., None]
        # each operand masked in its own dtype (y may be bf16)
        return (y_cut * y_cut_mask.to(y_cut.dtype), attn_cut * y_cut_mask.transpose(1, 2).to(attn_cut.dtype),
                y_cut_mask)

    @torch.no_grad()
    def training_probe(self, x, x_lengths, y, y_lengths, spks=None, n_timesteps: int = 10, *,
                       z: torch.Tensor):
        """Convergence diagnostics on a fixed batch, to be called under
        ``eval()`` (no dropout), without the crop; z (B, T_y, n_feats) is the
        solver's initial noise, already scaled by the temperature.

        Returns ``mas_durations`` (B, T_x) and the scalars ``diagonality``
        (1 − mean |aligned text index − straight diagonal| / T_text),
        ``dur_mse_log`` and ``dur_mae_frames`` (predicted against MAS
        durations), ``prior_mel_l1`` (aligned encoder mean against the
        target) and ``tf_mel_l1`` (a teacher-forced Euler solve against it).
        """
        spk_e = self._embed_spks(spks)
        x_mask, y_mask, _, mu_x, logw, attn = self._encode_align(x, x_lengths, y, y_lengths, spk_e)
        xm = x_mask[..., 0]
        mas_dur = attn.sum(-1)  # (B, T_x)
        n_tokens = x_lengths.sum().float()
        logw32 = logw.float()[..., 0]
        dur_mse_log = (torch.square(logw32 - torch.log(1e-8 + mas_dur)) * xm).sum() / n_tokens
        dur_mae_frames = (torch.abs(torch.exp(logw32) * xm - mas_dur) * xm).sum() / n_tokens

        xs = torch.arange(attn.shape[1], dtype=torch.float32, device=attn.device)
        idx = torch.einsum("bxy,x->by", attn, xs)  # aligned text index per mel frame
        ts = torch.arange(attn.shape[2], dtype=torch.float32, device=attn.device)[None, :]
        xl, yl = x_lengths.float()[:, None], y_lengths.float()[:, None]
        ideal = ts * (xl - 1.0) / torch.clamp_min(yl - 1.0, 1.0)
        dev = torch.abs(idx - ideal) * y_mask[..., 0] / torch.clamp_min(xl, 1.0)
        diagonality = 1.0 - dev.sum() / y_lengths.sum().float()

        mu_y = torch.einsum("bxy,bxc->byc", attn, mu_x.float())
        denom = y_mask.sum() * self.cfg.n_feats
        prior_mel_l1 = (torch.abs(mu_y - y) * y_mask).sum() / denom
        dec = self.decoder(mu_y, y_mask, n_timesteps, z, spk_e)
        tf_mel_l1 = (torch.abs(dec * y_mask - y) * y_mask).sum() / denom
        return {"mas_durations": mas_dur, "diagonality": diagonality, "dur_mse_log": dur_mse_log,
                "dur_mae_frames": dur_mae_frames, "prior_mel_l1": prior_mel_l1, "tf_mel_l1": tf_mel_l1}
