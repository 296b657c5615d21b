"""Load reference-format PyTorch checkpoints (the load side of
``emojivoice_tpu.io.torch_ckpt``).

The reference's voices are Lightning checkpoints of MatchaTTS
(``{"state_dict": ..., "hyper_parameters": ...}``); its vocoders are
``{"generator": state_dict}`` dumps of HiFi-GAN with weight norm.  The port's
modules carry the reference's parameter names and layouts already, so nothing
is transposed here.  This module:

* reads a file with ``torch.load(..., weights_only=True)``, or, where that
  refuses the file, through the restricted unpickler of ``io/torch_pickle.py``
  (tensors and plain containers resolved, every other class an inert
  stand-in), and unwraps it to a flat ``{name: float32 tensor}``;
* recovers the ``ModelConfig`` from tensor shapes plus the checkpoint's own
  ``hyper_parameters``, plain dicts or pickled omegaconf objects (the
  reference's released voices), with a cross-check for every dimension both
  determine; a decoder level's block type (transformer or conformer) comes
  from its key names, and a conformer block's BatchNorm statistics load into
  its buffers (``conv.net.5.running_*``; a file without
  ``num_batches_tracked``, as the JAX package writes it, loads with 0);
* folds HiFi-GAN weight norm (``weight_g``/``weight_v``) into plain weights,
  as the reference's ``remove_weight_norm`` does at load, or keeps it for
  training (``load_hifigan(path, fold=False)``);
* reads the discriminators of an upstream ``do_*`` training checkpoint
  (weight norm and spectral norm made plain).
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, Optional, Tuple

import torch

from emojivoice_tpu_torch import config as cfglib
from emojivoice_tpu_torch.io import torch_pickle


def fold_weight_norm_torch(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """weight_norm dim=0 fold: w = g · v / ‖v‖ over dims ≥ 1, in float64."""
    axes = tuple(range(1, v.dim()))
    v64 = v.double()
    norm = v64.pow(2).sum(dim=axes, keepdim=True).sqrt()
    return (g.double() * v64 / norm).float()


# ---------------------------------------------------------------------------
# generic loading
# ---------------------------------------------------------------------------

def load_torch_file(path: str) -> Any:
    """The unpickled checkpoint object, tensors on the CPU.  A file that
    ``weights_only=True`` refuses (a Lightning checkpoint's pickled omegaconf
    ``hyper_parameters``) is read by ``torch_pickle``'s restricted unpickler,
    which runs none of the file's code: its other objects come back as inert
    stand-ins."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        return torch.load(path, map_location="cpu", weights_only=False, pickle_module=torch_pickle)


def _flatten(obj: Any, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    if isinstance(obj, dict):
        for k, v in obj.items():
            _flatten(v, f"{prefix}.{k}" if prefix else str(k), out)
    elif isinstance(obj, torch.Tensor):
        out[prefix] = obj.detach().to(torch.float32)


def state_dict_arrays(obj: Any) -> Dict[str, torch.Tensor]:
    """Flat {name: float32 tensor} view of a loaded checkpoint object.
    Lightning checkpoints are unwrapped to their 'state_dict', HiFi-GAN dumps
    to 'generator'; bare (possibly nested) state dicts pass through."""
    if isinstance(obj, dict):
        if "state_dict" in obj:
            obj = obj["state_dict"]
        elif "generator" in obj:
            obj = obj["generator"]
    flat: Dict[str, torch.Tensor] = {}
    _flatten(obj, "", flat)
    return flat


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Flat {name: float32 tensor} from a checkpoint file."""
    return state_dict_arrays(load_torch_file(path))


def extract_hyper_parameters(ckpt_obj: Any) -> Optional[dict]:
    """The checkpoint's embedded hyper-parameters as plain python (omegaconf
    and Lightning stand-ins walked by ``torch_pickle.plain_hparams``), or
    None when it carries none (raw state-dict dumps)."""
    if not isinstance(ckpt_obj, dict):
        return None
    hp = ckpt_obj.get("hyper_parameters", ckpt_obj.get("hparams"))
    if hp is None:
        return None
    plain = torch_pickle.plain_hparams(hp)
    return plain if isinstance(plain, dict) and plain else None


# ---------------------------------------------------------------------------
# MatchaTTS
# ---------------------------------------------------------------------------

def infer_model_config_from_state_dict(sd: Dict[str, torch.Tensor],
                                       hparams: Optional[dict] = None) -> cfglib.ModelConfig:
    """Re-derive the architecture from tensor shapes, refined by the
    checkpoint's own hyper_parameters when available.

    Shapes are authoritative for every dimension they determine; hparams fill
    in what shapes cannot see (the encoder head count, the decoder's
    heads × head_dim split, dropout rates, sigma_min, out_size, prior_loss)
    and are cross-checked against the shapes for the dimensions both
    determine (ValueError on conflict: a wrong split would silently scramble
    attention)."""
    n_vocab, n_channels = sd["encoder.emb.weight"].shape
    n_spks, spk_emb_dim = sd["spk_emb.weight"].shape if "spk_emb.weight" in sd else (1, 64)
    n_feats = sd["encoder.proj_m.weight"].shape[0]
    filter_channels, _, enc_kernel = sd["encoder.encoder.ffn_layers.0.conv_1.weight"].shape
    filter_channels_dp, _, dp_kernel = sd["encoder.proj_w.conv_1.weight"].shape

    def count(prefix: str, field: int) -> int:
        return 1 + max(int(k.split(".")[field]) for k in sd if k.startswith(prefix))

    n_layers = count("encoder.encoder.attn_layers.", 3)
    prenet = any(k.startswith("encoder.prenet.conv_layers") for k in sd)
    est = "decoder.estimator"
    n_down = count(f"{est}.down_blocks.", 3)
    channels = tuple(sd[f"{est}.down_blocks.{i}.0.block1.block.0.weight"].shape[0] for i in range(n_down))
    num_mid = count(f"{est}.mid_blocks.", 3)
    n_blocks = count(f"{est}.down_blocks.0.1.", 5)

    def block_type(prefix: str) -> str:
        """transformer (attn1.to_q) or conformer (attn.fn.to_q), from the key names."""
        if f"{prefix}.attn1.to_q.weight" in sd:
            return "transformer"
        if f"{prefix}.attn.fn.to_q.weight" in sd:
            return "conformer"
        raise KeyError(f"cannot identify block type at {prefix}")

    down_bt = block_type(f"{est}.down_blocks.0.1.0")
    mid_bt = block_type(f"{est}.mid_blocks.0.1.0")
    up_bt = block_type(f"{est}.up_blocks.0.1.0")
    q_name = "attn1.to_q" if down_bt == "transformer" else "attn.fn.to_q"
    head_dim_times_heads = sd[f"{est}.down_blocks.0.1.0.{q_name}.weight"].shape[0]
    # conformer attention stores a (2·max_pos+1, head_dim) distance table: the split is in the shapes
    conf_head_dim = next((int(sd[k].shape[1]) for k in sd
                          if k.startswith(est) and k.endswith(".attn.fn.rel_pos_emb.weight")), None)

    hp = hparams or {}
    enc_hp = (hp.get("encoder") or {}).get("encoder_params") or {}
    dp_hp = (hp.get("encoder") or {}).get("duration_predictor_params") or {}
    dec_hp = hp.get("decoder") or {}
    cfm_hp = hp.get("cfm") or {}

    def _hp(d: dict, key: str, default):
        """hparams value with a None-check: `or` would override a stored 0 / 0.0."""
        v = d.get(key)
        return default if v is None else v

    n_heads = int(_hp(enc_hp, "n_heads", 2))
    if n_channels % n_heads != 0:
        raise ValueError(f"hyper_parameters say n_heads={n_heads} but encoder channels {n_channels} do not divide")

    # decoder heads × head_dim: hparams are the ground truth, the to_q row count the cross-check; a missing
    # half of the pair is derived from the row count, not defaulted
    hp_head_dim, hp_num_heads = dec_hp.get("attention_head_dim"), dec_hp.get("num_heads")
    if hp_head_dim is not None or hp_num_heads is not None:
        if hp_head_dim is None:
            num_heads = int(hp_num_heads)
            attention_head_dim = head_dim_times_heads // num_heads
        elif hp_num_heads is None:
            attention_head_dim = int(hp_head_dim)
            num_heads = head_dim_times_heads // attention_head_dim
        else:
            attention_head_dim, num_heads = int(hp_head_dim), int(hp_num_heads)
        if num_heads * attention_head_dim != head_dim_times_heads:
            raise ValueError(f"hyper_parameters say {num_heads} heads × {attention_head_dim} dims but "
                             f"attn1.to_q has {head_dim_times_heads} rows")
    elif conf_head_dim is not None:
        attention_head_dim = conf_head_dim
        num_heads = head_dim_times_heads // attention_head_dim
    else:
        # reference default: head_dim 64
        attention_head_dim = 64 if head_dim_times_heads % 64 == 0 else head_dim_times_heads
        num_heads = head_dim_times_heads // attention_head_dim
    if conf_head_dim is not None and conf_head_dim != attention_head_dim:
        raise ValueError(f"conformer rel_pos_emb says head_dim={conf_head_dim} but the head split "
                         f"resolved to {attention_head_dim}")

    for name, shape_val in (("n_spks", n_spks), ("n_feats", n_feats)):
        # n_vocab is not cross-checked: the reference's symbol table has more rows than its n_vocab, and
        # the embedding's row count is what the checkpoint contains
        if hp.get(name) is not None and int(hp[name]) != shape_val:
            raise ValueError(f"hyper_parameters {name}={hp[name]} vs checkpoint shape {shape_val}")

    if "mel_mean" in sd:
        stats = cfglib.DataStatistics(mel_mean=float(sd["mel_mean"]), mel_std=float(sd["mel_std"]))
    else:
        ds = hp.get("data_statistics")
        ds = ds if isinstance(ds, dict) and ds.get("mel_mean") is not None else {"mel_mean": 0.0, "mel_std": 1.0}
        stats = cfglib.DataStatistics(mel_mean=float(ds["mel_mean"]), mel_std=float(ds["mel_std"]))
    out_size = hp.get("out_size")
    enc_dropout = float(_hp(enc_hp, "p_dropout", 0.1))
    return cfglib.ModelConfig(
        n_vocab=n_vocab,
        n_spks=n_spks,
        spk_emb_dim=spk_emb_dim,
        n_feats=n_feats,
        encoder=cfglib.EncoderConfig(
            n_feats=n_feats, n_channels=n_channels, filter_channels=filter_channels, n_heads=n_heads,
            n_layers=n_layers, kernel_size=enc_kernel, p_dropout=enc_dropout, prenet=prenet),
        duration_predictor=cfglib.DurationPredictorConfig(
            filter_channels_dp=filter_channels_dp, kernel_size=dp_kernel,
            # the reference shares the encoder's p_dropout when the block records none
            p_dropout=float(_hp(dp_hp, "p_dropout", enc_dropout))),
        decoder=cfglib.DecoderConfig(
            channels=channels, dropout=float(_hp(dec_hp, "dropout", 0.05)), attention_head_dim=attention_head_dim,
            n_blocks=n_blocks, num_mid_blocks=num_mid, num_heads=num_heads, down_block_type=down_bt,
            mid_block_type=mid_bt, up_block_type=up_bt),
        cfm=cfglib.CFMConfig(sigma_min=float(_hp(cfm_hp, "sigma_min", 1e-4))),
        data_statistics=stats,
        out_size=int(out_size) if out_size is not None else None,
        prior_loss=bool(hp.get("prior_loss", True)),
        use_precomputed_durations=bool(hp.get("use_precomputed_durations", False)),
    )


def load_matcha(path: str) -> Tuple[Dict[str, torch.Tensor], cfglib.ModelConfig]:
    """(state dict, inferred ModelConfig) of a MatchaTTS checkpoint file."""
    obj = load_torch_file(path)
    sd = state_dict_arrays(obj)
    return sd, infer_model_config_from_state_dict(sd, hparams=extract_hyper_parameters(obj))


def matcha_hyper_parameters(cfg: cfglib.ModelConfig) -> dict:
    """The reference-structured ``hyper_parameters`` block of `cfg`, as plain
    dicts: what the reference embeds in its checkpoints, so that an exported
    file documents its own architecture and ``load_matcha`` recovers `cfg`
    from it."""
    return {
        "n_vocab": cfg.n_vocab,
        "n_spks": cfg.n_spks,
        "spk_emb_dim": cfg.spk_emb_dim,
        "n_feats": cfg.n_feats,
        "encoder": {
            "encoder_type": "RoPE Encoder",
            "encoder_params": {
                "n_feats": cfg.n_feats,
                "n_channels": cfg.encoder.n_channels,
                "filter_channels": cfg.encoder.filter_channels,
                "filter_channels_dp": cfg.duration_predictor.filter_channels_dp,
                "n_heads": cfg.encoder.n_heads,
                "n_layers": cfg.encoder.n_layers,
                "kernel_size": cfg.encoder.kernel_size,
                "p_dropout": cfg.encoder.p_dropout,
                "spk_emb_dim": cfg.spk_emb_dim,
                "n_spks": cfg.n_spks,
                "prenet": cfg.encoder.prenet,
            },
            "duration_predictor_params": {
                "filter_channels_dp": cfg.duration_predictor.filter_channels_dp,
                "kernel_size": cfg.duration_predictor.kernel_size,
                "p_dropout": cfg.duration_predictor.p_dropout,
            },
        },
        "decoder": {
            "channels": list(cfg.decoder.channels),
            "dropout": cfg.decoder.dropout,
            "attention_head_dim": cfg.decoder.attention_head_dim,
            "n_blocks": cfg.decoder.n_blocks,
            "num_mid_blocks": cfg.decoder.num_mid_blocks,
            "num_heads": cfg.decoder.num_heads,
            "act_fn": cfg.decoder.act_fn,
            "down_block_type": cfg.decoder.down_block_type,
            "mid_block_type": cfg.decoder.mid_block_type,
            "up_block_type": cfg.decoder.up_block_type,
        },
        "cfm": {"name": "CFM", "solver": cfg.cfm.solver, "sigma_min": cfg.cfm.sigma_min},
        "data_statistics": {
            "mel_mean": cfg.data_statistics.mel_mean,
            "mel_std": cfg.data_statistics.mel_std,
        },
        "out_size": cfg.out_size,
        "prior_loss": cfg.prior_loss,
        "use_precomputed_durations": cfg.use_precomputed_durations,
    }


# ---------------------------------------------------------------------------
# HiFi-GAN
# ---------------------------------------------------------------------------

def fold_hifigan_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Replace every ``<name>.weight_g``/``<name>.weight_v`` pair by the folded
    ``<name>.weight``; already folded entries pass through."""
    out = {}
    for k, v in sd.items():
        if k.endswith(".weight_g"):
            name = k[: -len(".weight_g")]
            out[f"{name}.weight"] = fold_weight_norm_torch(v, sd[f"{name}.weight_v"])
        elif not k.endswith(".weight_v"):
            out[k] = v
    return out


def split_hifigan_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The training form of a generator state dict: ``weight_g``/``weight_v``
    pairs pass through, and a plain ``<name>.weight`` (a dump that was folded
    already) becomes ``v = w``, ``g = ‖w‖`` over every axis but the first."""
    out = {}
    for k, v in sd.items():
        if k.endswith(".weight"):
            name = k[: -len(".weight")]
            norm = v.double().pow(2).sum(dim=tuple(range(1, v.dim())), keepdim=True).sqrt()
            out[f"{name}.weight_g"], out[f"{name}.weight_v"] = norm.float(), v
        else:
            out[k] = v
    return out


def load_hifigan(path: str, fold: bool = True) -> Dict[str, torch.Tensor]:
    """Generator state dict of a HiFi-GAN dump.  fold=True (serving): weight
    norm folded into plain weights, for ``HiFiGANGenerator(cfg)``.
    fold=False (training): the ``weight_g``/``weight_v`` parameterization as
    stored, for ``HiFiGANGenerator(cfg, weight_norm=True)``, so that a
    fine-tune runs in the upstream optimizer geometry."""
    sd = load_torch_state_dict(path)
    return fold_hifigan_state_dict(sd) if fold else split_hifigan_state_dict(sd)


def _effective_weight(sd: Dict[str, torch.Tensor], name: str) -> torch.Tensor:
    """The plain weight of a conv that may be parameterized, in the three
    forms the reference discriminators use: plain ``weight``; weight norm
    (``weight_g``/``weight_v``, folded); spectral norm (``weight_orig`` with
    the power-iteration vector ``weight_u`` and, in some versions,
    ``weight_v``), as eval mode computes it: ``weight_orig / sigma`` with
    ``sigma = u · (W v)`` from the stored vectors, W the weight as a
    (out, rest) matrix, and v recomputed as ``normalize(Wᵀ u)`` where the file
    has none."""
    if f"{name}.weight_orig" in sd:
        w = sd[f"{name}.weight_orig"]
        u = sd[f"{name}.weight_u"].reshape(-1)
        w_mat = w.reshape(w.shape[0], -1)
        if f"{name}.weight_v" in sd:
            v = sd[f"{name}.weight_v"].reshape(-1)
        else:
            v = w_mat.T @ u
            v = v / max(float(torch.linalg.vector_norm(v)), 1e-12)
        return w / float(u @ (w_mat @ v))
    if f"{name}.weight_g" in sd:
        return fold_weight_norm_torch(sd[f"{name}.weight_g"], sd[f"{name}.weight_v"])
    return sd[f"{name}.weight"]


def plain_discriminator_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """An MPD or MSD state dict with every conv's weight made plain
    (``_effective_weight``) under the name ``<conv>.weight``; biases pass
    through.  The names are the reference's, which the port's discriminators
    carry, so nothing else moves."""
    out = {}
    for k, v in sd.items():
        if k.endswith(".bias"):
            name = k[: -len(".bias")]
            out[k] = v
            out[f"{name}.weight"] = _effective_weight(sd, name)
    return out


def load_hifigan_discriminators(path: str) -> Dict[str, Dict[str, torch.Tensor]]:
    """An upstream HiFi-GAN ``do_*`` training checkpoint (``{"mpd": ...,
    "msd": ..., "optim_g": ..., ...}``) → ``{"mpd": state dict, "msd": state
    dict}`` of plain weights for ``MultiPeriodDiscriminator`` and
    ``MultiScaleDiscriminator``: the ``disc_state`` of
    ``create_vocoder_state``, so a fine-tune starts from trained
    discriminators (the generator's side is ``load_hifigan(path, fold=False)``)."""
    obj = load_torch_file(path)
    if not isinstance(obj, dict) or "mpd" not in obj or "msd" not in obj:
        raise ValueError(f"{path}: not a HiFi-GAN do_* checkpoint (missing mpd/msd)")
    return {k: plain_discriminator_state_dict(state_dict_arrays(obj[k])) for k in ("mpd", "msd")}
