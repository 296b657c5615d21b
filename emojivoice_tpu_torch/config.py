"""Configuration tree of the port: frozen dataclasses, presets and JSON
round-trip.

The port's own copy of the JAX package's ``config.py`` (dataclasses, presets,
``get_preset``, ``to_dict``/``from_dict``, ``save_json``/``load_json`` and the
dotted-path ``_override``), without the XLA compilation-cache switch.  The
port imports nothing of the JAX package, so the copy is held to the original
field by field by ``tests/test_torch_import.py``.

Presets replicate the reference's shipped experiment configs (ljspeech /
vctk / emoji_multi) so released PyTorch checkpoints can be re-instantiated
structurally.  Configs are pure data, consumed by modules at construction.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence


def _frozen(cls):
    return dataclass(frozen=True)(cls)


@_frozen
class EncoderConfig:
    """Text-encoder hyperparams (reference: configs/model/encoder/default.yaml)."""

    n_feats: int = 80
    n_channels: int = 192
    filter_channels: int = 768
    n_heads: int = 2
    n_layers: int = 6
    kernel_size: int = 3
    p_dropout: float = 0.1
    prenet: bool = True


@_frozen
class DurationPredictorConfig:
    """Duration-predictor head (reference: configs/model/encoder/default.yaml)."""

    filter_channels_dp: int = 256
    kernel_size: int = 3
    p_dropout: float = 0.1


@_frozen
class DecoderConfig:
    """CFM U-Net estimator (reference: configs/model/decoder/default.yaml;
    block types per level like decoder.py:212-214)."""

    channels: tuple = (256, 256)
    dropout: float = 0.05
    attention_head_dim: int = 64
    n_blocks: int = 1
    num_mid_blocks: int = 2
    num_heads: int = 2
    act_fn: str = "snakebeta"
    down_block_type: str = "transformer"  # "transformer" | "conformer"
    mid_block_type: str = "transformer"
    up_block_type: str = "transformer"


@_frozen
class CFMConfig:
    """Flow-matching solver params (reference: configs/model/cfm/default.yaml)."""

    solver: str = "euler"
    sigma_min: float = 1e-4


@_frozen
class DataStatistics:
    """Dataset mel normalization stats — stored in checkpoints as buffers
    (reference: matcha/models/baselightningmodule.py:20-28)."""

    mel_mean: float = 0.0
    mel_std: float = 1.0


@_frozen
class ModelConfig:
    """Top-level MatchaTTS-equivalent model config
    (reference: configs/model/matcha.yaml)."""

    n_vocab: int = 178
    n_spks: int = 1
    spk_emb_dim: int = 64
    n_feats: int = 80
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    duration_predictor: DurationPredictorConfig = field(default_factory=DurationPredictorConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    cfm: CFMConfig = field(default_factory=CFMConfig)
    data_statistics: DataStatistics = field(default_factory=DataStatistics)
    out_size: Optional[int] = None  # must be divisible by 4 when set
    prior_loss: bool = True
    use_precomputed_durations: bool = False

    @property
    def encoder_hidden(self) -> int:
        """Transformer width after speaker-embedding concat
        (reference: matcha/models/components/text_encoder.py:361-368)."""
        return self.n_channels_with_spk

    @property
    def n_channels_with_spk(self) -> int:
        return self.encoder.n_channels + (self.spk_emb_dim if self.n_spks > 1 else 0)

    @property
    def decoder_in_channels(self) -> int:
        """CFM estimator input channels: [x, mu] (+ spks)
        (reference: matcha/models/components/flow_matching.py:122-132)."""
        return 2 * self.n_feats + (self.spk_emb_dim if self.n_spks > 1 else 0)


@_frozen
class AudioConfig:
    """Mel/DSP front-end params (reference: configs/data/ljspeech.yaml:11-17)."""

    sample_rate: int = 22050
    n_fft: int = 1024
    n_mels: int = 80
    hop_length: int = 256
    win_length: int = 1024
    f_min: float = 0.0
    f_max: float = 8000.0


@_frozen
class DataConfig:
    """Dataset/pipeline config (reference: configs/data/*.yaml)."""

    name: str = "ljspeech"
    train_filelist_path: str = "data/train.txt"
    valid_filelist_path: str = "data/val.txt"
    batch_size: int = 32
    num_workers: int = 4
    cleaners: tuple = ("english_cleaners2",)
    add_blank: bool = True
    n_spks: int = 1
    audio: AudioConfig = field(default_factory=AudioConfig)
    data_statistics: DataStatistics = field(default_factory=DataStatistics)
    seed: int = 1234
    load_durations: bool = False


@_frozen
class OptimizerConfig:
    """Adam, lr 1e-4 (reference: configs/model/optimizer/adam.yaml).

    LR schedules (reference capability: baselightningmodule.configure_optimizers
    :30-54 accepts any partial-instantiated torch scheduler; the shipped
    experiments use constant lr).  Here a schedule is a function of the
    optimizer step count, so resume is position-correct once the step is
    restored.
    """

    name: str = "adam"
    lr: float = 1e-4
    weight_decay: float = 0.0
    b1: float = 0.9
    b2: float = 0.999
    grad_clip: float = 5.0  # reference: configs/trainer/default.yaml gradient_clip_val
    scheduler: Optional[str] = None  # None/"constant" | "exponential" | "cosine"
    warmup_steps: int = 0  # linear 0→lr warmup prepended when > 0
    decay_steps: int = 100_000  # horizon for cosine / transition for exponential
    scheduler_gamma: float = 0.1  # exponential: lr * gamma^(step/decay_steps)
    lr_end: float = 0.0  # cosine floor (alpha = lr_end/lr)


@_frozen
class TrainerConfig:
    """Training-loop config (reference: configs/trainer/default.yaml +
    callbacks/model_checkpoint.yaml)."""

    max_epochs: int = -1
    max_steps: int = -1
    check_val_every_n_epoch: int = 1
    seed: int = 1234
    # "f32" | "bf16-mixed" (the reference trainer's 16-mixed analog); the port
    # trains in f32 only so far
    precision: str = "f32"
    ckpt_every_n_epochs: int = 100
    save_top_k: int = 10
    save_last: bool = True
    out_dir: str = "logs/train"
    data_axis: str = "data"  # mesh axis name for data parallelism
    num_devices: int = 0  # 0 = all visible devices
    log_every_n_steps: int = 10


@_frozen
class HiFiGANConfig:
    """HiFi-GAN v1 generator hyperparams (reference: matcha/hifigan/config.py:1-28).

    The released emojivoice vocoders (hifigan_T2_v1 / hifigan_univ_v1) are both
    this v1 architecture; the dist_config of the reference is vestigial and
    deliberately dropped here.
    """

    resblock: str = "1"
    upsample_rates: tuple = (8, 8, 2, 2)
    upsample_kernel_sizes: tuple = (16, 16, 4, 4)
    upsample_initial_channel: int = 512
    resblock_kernel_sizes: tuple = (3, 7, 11)
    resblock_dilation_sizes: tuple = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    num_mels: int = 80
    sampling_rate: int = 22050

    @property
    def total_upsample(self) -> int:
        n = 1
        for r in self.upsample_rates:
            n *= r
        return n


@_frozen
class RootConfig:
    """Bundle of everything needed for one train/infer run
    (reference analog: composed Hydra tree from configs/train.yaml)."""

    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    trainer: TrainerConfig = field(default_factory=TrainerConfig)
    vocoder: HiFiGANConfig = field(default_factory=HiFiGANConfig)


# ---------------------------------------------------------------------------
# Presets — replicate the reference's experiment configs
# ---------------------------------------------------------------------------

def ljspeech(**overrides: Any) -> RootConfig:
    """Single-speaker LJSpeech (reference: configs/data/ljspeech.yaml)."""
    data = DataConfig(
        name="ljspeech",
        n_spks=1,
        data_statistics=DataStatistics(mel_mean=-5.536622, mel_std=2.116101),
    )
    model = ModelConfig(n_spks=1, data_statistics=data.data_statistics)
    return _override(RootConfig(model=model, data=data), overrides)


def vctk(**overrides: Any) -> RootConfig:
    """Multi-speaker VCTK, n_spks=109 (reference: configs/data/vctk.yaml)."""
    data = DataConfig(
        name="vctk",
        n_spks=109,
        data_statistics=DataStatistics(mel_mean=-6.630575, mel_std=2.482914),
    )
    model = ModelConfig(n_spks=109, data_statistics=data.data_statistics)
    return _override(RootConfig(model=model, data=data), overrides)


def emoji_multi(**overrides: Any) -> RootConfig:
    """Emoji fine-tuning preset: VCTK-base 109-speaker checkpoint where 11
    speaker ids are the emoji voices (reference: configs/data/emoji_multi.yaml,
    configs/experiment/emoji_multi.yaml)."""
    data = DataConfig(
        name="expressive-multi",
        n_spks=109,
        data_statistics=DataStatistics(mel_mean=-6.856600761413574, mel_std=2.609809160232544),
    )
    model = ModelConfig(n_spks=109, data_statistics=data.data_statistics)
    return _override(RootConfig(model=model, data=data), overrides)


def tiny(**overrides: Any) -> RootConfig:
    """Small model for smoke tests / fast_dev_run-style debugging
    (analog of the reference's configs/debug/fdr.yaml workflow)."""
    model = ModelConfig(
        n_spks=4,
        spk_emb_dim=8,
        n_feats=80,
        encoder=EncoderConfig(n_channels=16, filter_channels=32, n_heads=2, n_layers=2),
        duration_predictor=DurationPredictorConfig(filter_channels_dp=16),
        decoder=DecoderConfig(channels=(16, 16), attention_head_dim=8, num_heads=2, num_mid_blocks=1),
        data_statistics=DataStatistics(mel_mean=-5.5, mel_std=2.0),
    )
    data = DataConfig(name="tiny", n_spks=4, batch_size=2, cleaners=("basic_cleaners",),
                      data_statistics=model.data_statistics)
    return _override(RootConfig(model=model, data=data), overrides)


PRESETS = {
    "ljspeech": ljspeech,
    "vctk": vctk,
    "emoji_multi": emoji_multi,
    "tiny": tiny,
}


def get_preset(name: str, **overrides: Any) -> RootConfig:
    try:
        return PRESETS[name](**overrides)
    except KeyError:
        raise KeyError(f"Unknown preset {name!r}; available: {sorted(PRESETS)}") from None


# ---------------------------------------------------------------------------
# Dict/JSON round-trip (replaces Hydra's OmegaConf serialization)
# ---------------------------------------------------------------------------

def to_dict(cfg: Any) -> Any:
    if dataclasses.is_dataclass(cfg):
        return {f.name: to_dict(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}
    if isinstance(cfg, (list, tuple)):
        return [to_dict(v) for v in cfg]
    return cfg


def from_dict(cls: type, d: dict) -> Any:
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        if dataclasses.is_dataclass(f.type) if isinstance(f.type, type) else False:
            v = from_dict(f.type, v)
        elif isinstance(v, dict):
            ftype = _resolve_type(cls, f.name)
            if ftype is not None:
                v = from_dict(ftype, v)
        elif isinstance(v, list):
            v = tuple(tuple(x) if isinstance(x, list) else x for x in v)
        kwargs[f.name] = v
    return cls(**kwargs)


_NESTED = {
    "encoder": EncoderConfig,
    "duration_predictor": DurationPredictorConfig,
    "decoder": DecoderConfig,
    "cfm": CFMConfig,
    "data_statistics": DataStatistics,
    "audio": AudioConfig,
    "model": ModelConfig,
    "data": DataConfig,
    "optimizer": OptimizerConfig,
    "trainer": TrainerConfig,
    "vocoder": HiFiGANConfig,
}


def _resolve_type(cls: type, name: str):
    return _NESTED.get(name)


def save_json(cfg: Any, path: str) -> None:
    with open(path, "w") as f:
        json.dump(to_dict(cfg), f, indent=2)


def load_json(cls: type, path: str) -> Any:
    with open(path) as f:
        return from_dict(cls, json.load(f))


def _override(cfg: RootConfig, overrides: dict) -> RootConfig:
    """Apply dotted-path overrides, e.g. ``_override(cfg, {"model.out_size": 172})``
    or top-level field replacement (``model=ModelConfig(...)``)."""
    for key, value in overrides.items():
        parts = key.split(".")
        cfg = _replace_path(cfg, parts, value)
    return cfg


def _replace_path(obj: Any, parts: Sequence[str], value: Any) -> Any:
    if len(parts) == 1:
        return dataclasses.replace(obj, **{parts[0]: value})
    child = getattr(obj, parts[0])
    return dataclasses.replace(obj, **{parts[0]: _replace_path(child, parts[1:], value)})
