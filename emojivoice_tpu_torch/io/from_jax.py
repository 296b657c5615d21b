"""Weights, gradients and optimizer state carried from the JAX package's
param trees to the port's modules.

The ``*_state_dict_from_flax`` functions take a flax variables tree (``{"params": ...}``) as numpy
arrays and return a reference-named state dict of numpy arrays that the
port's modules load with strict names:

* ``matcha_state_dict_from_flax`` follows the naming of
  ``emojivoice_tpu.io.torch_ckpt.export_matcha_state_dict`` (transformer or
  conformer decoder blocks), including the ``mel_mean``/``mel_std`` buffers
  and, for conformer blocks, the BatchNorm statistics of the tree's
  ``batch_stats`` collection with ``num_batches_tracked`` 0 (the JAX package
  counts no batches);
* ``hifigan_state_dict_from_flax`` is the inverse of
  ``convert_hifigan_state_dict``, folded or in the weight-norm training form;
* ``mpd_state_dict_from_flax`` / ``msd_state_dict_from_flax`` carry the
  HiFi-GAN discriminators.

Layouts: flax conv kernels are (k, in, out) → torch Conv1d (out, in, k);
flax ConvTranspose1d kernels are (k, in, out) → torch (in, out, k); flax
Dense kernels (in, out) → torch Linear (out, in), or a 1×1 Conv1d
(out, in, 1) where the reference uses one.  numpy only.

Any tree that mirrors the parameter tree goes through the same mapping: a
``jax.grad`` tree gives reference-named gradients to hold ``.grad`` against,
and the ``mu``/``nu`` trees of an ``optax.adam`` state give
``torch.optim.Adam``'s ``exp_avg``/``exp_avg_sq`` (``buffers=False`` leaves
out the ``mel_mean``/``mel_std`` buffers and the BatchNorm statistics, which
are no parameters).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from emojivoice_tpu_torch.config import HiFiGANConfig, ModelConfig


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _conv(w) -> np.ndarray:
    return np.ascontiguousarray(_np(w).transpose(2, 1, 0))


def _convt(w) -> np.ndarray:
    return np.ascontiguousarray(_np(w).transpose(1, 2, 0))


def _dense(w, as_conv1x1: bool = False) -> np.ndarray:
    out = np.ascontiguousarray(_np(w).T)
    return out[..., None] if as_conv1x1 else out


def matcha_state_dict_from_flax(params: dict, cfg: ModelConfig, buffers: bool = True) -> Dict[str, np.ndarray]:
    p = params["params"]
    dec = cfg.decoder
    stats = (params.get("batch_stats") or {}).get("decoder", {}).get("estimator", {})
    sd: Dict[str, np.ndarray] = {}

    def put_conv(name, node, conv1x1=False):
        sd[f"{name}.weight"] = _dense(node["kernel"], True) if conv1x1 else _conv(node["kernel"])
        sd[f"{name}.bias"] = _np(node["bias"])

    def put_linear(name, node):
        sd[f"{name}.weight"] = _dense(node["kernel"])
        if "bias" in node:
            sd[f"{name}.bias"] = _np(node["bias"])

    def put_norm(name, node):  # ChannelLayerNorm
        sd[f"{name}.gamma"] = _np(node["gamma"])
        sd[f"{name}.beta"] = _np(node["beta"])

    def put_affine(name, node):  # nn.LayerNorm / nn.GroupNorm
        sd[f"{name}.weight"] = _np(node["scale"])
        sd[f"{name}.bias"] = _np(node["bias"])

    if cfg.n_spks > 1:
        sd["spk_emb.weight"] = _np(p["spk_emb"]["embedding"])
    enc = p["encoder"]
    sd["encoder.emb.weight"] = _np(enc["emb"]["embedding"])
    if cfg.encoder.prenet:
        pre = enc["prenet"]
        for i in range(3):
            put_conv(f"encoder.prenet.conv_layers.{i}", pre[f"conv_{i}"])
            put_norm(f"encoder.prenet.norm_layers.{i}", pre[f"norm_{i}"])
        put_conv("encoder.prenet.proj", pre["proj"], conv1x1=True)
    lay = enc["encoder"]
    for i in range(cfg.encoder.n_layers):
        for proj in ("conv_q", "conv_k", "conv_v", "conv_o"):
            put_conv(f"encoder.encoder.attn_layers.{i}.{proj}", lay[f"attn_{i}"][proj], conv1x1=True)
        put_norm(f"encoder.encoder.norm_layers_1.{i}", lay[f"norm1_{i}"])
        put_norm(f"encoder.encoder.norm_layers_2.{i}", lay[f"norm2_{i}"])
        for c in ("conv_1", "conv_2"):
            put_conv(f"encoder.encoder.ffn_layers.{i}.{c}", lay[f"ffn_{i}"][c])
    put_conv("encoder.proj_m", enc["proj_m"], conv1x1=True)
    pw = enc["proj_w"]
    for c in ("conv_1", "conv_2"):
        put_conv(f"encoder.proj_w.{c}", pw[c])
    for n in ("norm_1", "norm_2"):
        put_norm(f"encoder.proj_w.{n}", pw[n])
    put_conv("encoder.proj_w.proj", pw["proj"], conv1x1=True)

    est = p["decoder"]["estimator"]
    pre_est = "decoder.estimator"
    for lin in ("linear_1", "linear_2"):
        put_linear(f"{pre_est}.time_mlp.{lin}", est["time_mlp"][lin])

    def resnet(ours, name):
        put_linear(f"{name}.mlp.1", ours["mlp"])
        for blk in ("block1", "block2"):
            put_conv(f"{name}.{blk}.block.0", ours[blk]["conv"])
            put_affine(f"{name}.{blk}.block.1", ours[blk]["norm"])
        put_conv(f"{name}.res_conv", ours["res_conv"], conv1x1=True)

    def tblock(ours, name):
        for norm in ("norm1", "norm3"):
            put_affine(f"{name}.{norm}", ours[norm])
        for proj in ("to_q", "to_k", "to_v"):
            put_linear(f"{name}.attn1.{proj}", ours["attn1"][proj])
        put_linear(f"{name}.attn1.to_out.0", ours["attn1"]["to_out"])
        put_linear(f"{name}.ff.net.0.proj", ours["ff"]["proj_in"])
        sd[f"{name}.ff.net.0.alpha"] = _np(ours["ff"]["alpha"])
        sd[f"{name}.ff.net.0.beta"] = _np(ours["ff"]["beta"])
        put_linear(f"{name}.ff.net.2", ours["ff"]["proj_out"])

    n_down = len(dec.channels)
    kinds = {"down": dec.down_block_type, "mid": dec.mid_block_type, "up": dec.up_block_type}
    for region, count in (("down", n_down), ("mid", dec.num_mid_blocks), ("up", n_down)):
        for i in range(count):
            name = f"{pre_est}.{region}_blocks.{i}"
            resnet(est[f"{region}_{i}_resnet"], f"{name}.0")
            for j in range(dec.n_blocks):
                key = f"{region}_{i}_tblock_{j}"
                if kinds[region] == "conformer":
                    sd.update(conformer_block_state_dict_from_flax(
                        {"params": est[key], "batch_stats": stats.get(key, {})}, f"{name}.1.{j}.", buffers))
                else:
                    tblock(est[key], f"{name}.1.{j}")
            if region == "mid":
                continue
            node = est[f"{region}_{i}_{'downsample' if region == 'down' else 'upsample'}"]
            if i == n_down - 1:  # a plain k3 conv on the last level
                put_conv(f"{name}.2", node)
            elif region == "down":
                put_conv(f"{name}.2.conv", node)
            else:
                sd[f"{name}.2.conv.weight"] = _convt(node["kernel"])
                sd[f"{name}.2.conv.bias"] = _np(node["bias"])

    put_conv(f"{pre_est}.final_block.block.0", est["final_block"]["conv"])
    put_affine(f"{pre_est}.final_block.block.1", est["final_block"]["norm"])
    put_conv(f"{pre_est}.final_proj", est["final_proj"], conv1x1=True)

    if buffers:
        sd["mel_mean"] = np.asarray(cfg.data_statistics.mel_mean, np.float32)
        sd["mel_std"] = np.asarray(cfg.data_statistics.mel_std, np.float32)
    return sd


def conformer_block_state_dict_from_flax(variables: dict, prefix: str = "", buffers: bool = True
                                         ) -> Dict[str, np.ndarray]:
    """One ``ConformerBlock``'s flax variables (``params`` and, for the
    BatchNorm statistics, ``batch_stats``) → the reference's ConformerWrapper
    names under `prefix`.  Without statistics the buffers are torch's initial
    ones (mean 0, variance 1); ``num_batches_tracked`` is 0."""
    p, bn = variables["params"], (variables.get("batch_stats") or {}).get("conv", {}).get("bn", {})
    sd: Dict[str, np.ndarray] = {}

    def linear(name, node):
        sd[f"{prefix}{name}.weight"] = _dense(node["kernel"])
        if "bias" in node:
            sd[f"{prefix}{name}.bias"] = _np(node["bias"])

    def affine(name, node):
        sd[f"{prefix}{name}.weight"] = _np(node["scale"])
        sd[f"{prefix}{name}.bias"] = _np(node["bias"])

    for ff in ("ff1", "ff2"):
        affine(f"{ff}.fn.norm", p[ff]["norm"])
        linear(f"{ff}.fn.fn.net.0", p[ff]["in_proj"])
        linear(f"{ff}.fn.fn.net.3", p[ff]["out_proj"])
    affine("attn.norm", p["attn"]["norm"])
    for proj in ("to_q", "to_kv", "to_out"):
        linear(f"attn.fn.{proj}", p["attn"][proj])
    sd[f"{prefix}attn.fn.rel_pos_emb.weight"] = _np(p["attn"]["rel_pos_emb"])
    cv = p["conv"]
    affine("conv.net.0", cv["norm"])
    sd[f"{prefix}conv.net.2.weight"] = _dense(cv["pointwise_in"]["kernel"], as_conv1x1=True)
    sd[f"{prefix}conv.net.2.bias"] = _np(cv["pointwise_in"]["bias"])
    sd[f"{prefix}conv.net.4.conv.weight"] = _conv(cv["depthwise_kernel"])
    sd[f"{prefix}conv.net.4.conv.bias"] = _np(cv["depthwise_bias"])
    affine("conv.net.5", cv["bn"])
    if buffers:
        width = _np(cv["bn"]["scale"]).shape
        sd[f"{prefix}conv.net.5.running_mean"] = _np(bn["mean"]) if "mean" in bn else np.zeros(width, np.float32)
        sd[f"{prefix}conv.net.5.running_var"] = _np(bn["var"]) if "var" in bn else np.ones(width, np.float32)
        sd[f"{prefix}conv.net.5.num_batches_tracked"] = np.zeros((), np.int64)
    sd[f"{prefix}conv.net.7.weight"] = _dense(cv["pointwise_out"]["kernel"], as_conv1x1=True)
    sd[f"{prefix}conv.net.7.bias"] = _np(cv["pointwise_out"]["bias"])
    affine("post_norm", p["post_norm"])
    return sd


def load_adam_state_from_optax(optimizer, model, mu: dict, nu: dict, count: int, cfg: ModelConfig) -> None:
    """Start ``torch.optim.Adam``/``AdamW`` from an ``optax.adam`` state:
    `mu` and `nu` are the first- and second-moment trees (they mirror the
    parameter tree, without the ``"params"`` level) and `count` the number of
    updates taken.  `optimizer` must hold ``model.parameters()`` in order."""
    _load_adam(optimizer, model.named_parameters(), matcha_state_dict_from_flax({"params": mu}, cfg, buffers=False),
               matcha_state_dict_from_flax({"params": nu}, cfg, buffers=False), count)


def _load_adam(optimizer, named_parameters, first: dict, second: dict, count: int) -> None:
    """`first`/`second`: reference-named moments for `named_parameters`, which
    `optimizer` must hold in the same order."""
    import torch

    state = {}
    for i, (name, param) in enumerate(named_parameters):
        state[i] = {"step": torch.tensor(float(count)),
                    "exp_avg": torch.tensor(first[name], device=param.device),
                    "exp_avg_sq": torch.tensor(second[name], device=param.device)}
    optimizer.load_state_dict({"state": state, "param_groups": optimizer.state_dict()["param_groups"]})


def hifigan_state_dict_from_flax(params: dict, cfg: HiFiGANConfig) -> Dict[str, np.ndarray]:
    """Flax HiFi-GAN params → reference generator names, ResBlock1
    (``convs1``/``convs2``) or ResBlock2 (``convs``).  A folded tree
    (``kernel``) gives ``weight``; a weight-norm tree (``v``, ``g``) gives
    ``weight_v`` in the weight's layout and ``weight_g`` as torch's (C, 1, 1)."""
    p = params["params"]
    sd: Dict[str, np.ndarray] = {}

    def put(name, node, layout):
        if "kernel" in node:
            sd[f"{name}.weight"] = layout(node["kernel"])
        else:
            sd[f"{name}.weight_v"] = layout(node["v"])
            sd[f"{name}.weight_g"] = _np(node["g"]).reshape(-1, 1, 1)
        sd[f"{name}.bias"] = _np(node["bias"])

    put("conv_pre", p["conv_pre"], _conv)
    n_up = len(cfg.upsample_rates)
    for i in range(n_up):
        put(f"ups.{i}", p[f"ups_{i}"], _convt)
    for n in range(n_up * len(cfg.resblock_kernel_sizes)):
        rb = p[f"resblocks_{n}"]
        for group in ("convs1", "convs2", "convs"):
            j = 0
            while f"{group}_{j}" in rb:
                put(f"resblocks.{n}.{group}.{j}", rb[f"{group}_{j}"], _conv)
                j += 1
    put("conv_post", p["conv_post"], _conv)
    return sd


def _discriminator_state_dict(params: dict, layout) -> Dict[str, np.ndarray]:
    sd: Dict[str, np.ndarray] = {}
    for d_name, d in params["params"].items():  # discriminators_{i}
        i = d_name.rsplit("_", 1)[1]
        for c_name, node in d.items():  # convs_{j} | conv_post
            name = "conv_post" if c_name == "conv_post" else f"convs.{c_name.rsplit('_', 1)[1]}"
            sd[f"discriminators.{i}.{name}.weight"] = layout(node["kernel"])
            sd[f"discriminators.{i}.{name}.bias"] = _np(node["bias"])
    return sd


def mpd_state_dict_from_flax(params: dict) -> Dict[str, np.ndarray]:
    """Flax MultiPeriodDiscriminator params → reference names; Conv2d kernels
    (kh, kw, in, out) → torch (out, in, kh, kw)."""
    return _discriminator_state_dict(params, lambda w: np.ascontiguousarray(_np(w).transpose(3, 2, 0, 1)))


def msd_state_dict_from_flax(params: dict) -> Dict[str, np.ndarray]:
    """Flax MultiScaleDiscriminator params → reference names; grouped 1-D
    kernels (k, in/groups, out) → torch (out, in/groups, k)."""
    return _discriminator_state_dict(params, _conv)


def load_vocoder_adam_states_from_optax(state, gen_mu: dict, gen_nu: dict, gen_count: int, disc_mu: dict,
                                        disc_nu: dict, disc_count: int) -> None:
    """Start the two ``torch.optim.Adam``s of a ``VocoderTrainState`` from the
    two ``optax.adam`` states of the JAX package's: the generator's moment
    trees mirror ``gen_params["params"]``, the discriminators' mirror
    ``{"mpd": variables, "msd": variables}``."""
    cfg = state.cfg
    _load_adam(state.gen_opt, state.gen.named_parameters(),
               hifigan_state_dict_from_flax({"params": gen_mu}, cfg),
               hifigan_state_dict_from_flax({"params": gen_nu}, cfg), gen_count)

    def disc_sd(tree):
        return {**{f"mpd.{k}": v for k, v in mpd_state_dict_from_flax(tree["mpd"]).items()},
                **{f"msd.{k}": v for k, v in msd_state_dict_from_flax(tree["msd"]).items()}}

    named = [(f"{prefix}.{n}", p) for prefix, m in (("mpd", state.mpd), ("msd", state.msd))
             for n, p in m.named_parameters()]
    _load_adam(state.disc_opt, named, disc_sd(disc_mu), disc_sd(disc_nu), disc_count)
