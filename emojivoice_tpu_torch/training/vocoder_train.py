"""HiFi-GAN vocoder (fine-)tuning (PyTorch port of
``emojivoice_tpu.training.vocoder_train``), f32, on one device or data
parallel over ranks.

The alternating GAN step of the upstream HiFi-GAN recipe: the discriminators
(MPD + MSD, LSGAN) take their update on the generated waveform with the
gradient cut, then the generator takes its own against the *updated*
discriminators, with loss = adversarial + feature matching × 2 + mel-L1 × 45.
Two Adams (lr 2e-4, betas 0.8 / 0.99), no clipping, no schedule.

Typical use: adapt a pretrained generator to the recordings of a new voice
(``io.torch_ckpt.load_hifigan(path, fold=False)`` → ``gen_state``), on
(mel, wav) segment pairs; ``training/vocoder_proof.py`` drives it end to end.

The generator trains through ``HiFiGANGenerator.forward_train`` (plain
differentiable convs); the fused MRF kernel is the serving path's and has no
backward, here as in the JAX package.

Data parallel (``create_vocoder_state(mesh=)``, the JAX ``mesh=`` branch:
parameters replicated, the batch split over the data axis; every rank builds
the same state from the same seed and passes its rows of the batch): the
generator and each discriminator are wrapped in ``DistributedDataParallel``
over the data axis.  DDP's reducer takes one backward per forward, and the
alternating step runs the discriminators twice, so the generator phase calls
the discriminators themselves, outside their wrappers, with their
parameters frozen (their gradients there are discarded, as on one device).
Every loss is a mean over equal rows, so the mean of the ranks' gradients is
the global batch's, and the metrics are the data group's means.

Through captured CUDA graphs (``vocoder_train_step(graphs=)``, the default
on the card without a mesh; the counterpart of the JAX package's jitted
step): the whole step, both updates included, is one graph per batch shape
(``training/vocoder_graphs.py``).  On the card without a mesh both Adams are
``capturable`` for that reason, in the eager step too, so that the two
compute the same update; the rate stays a constant.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional

import torch

from emojivoice_tpu_torch.config import HiFiGANConfig
from emojivoice_tpu_torch.ops.mel import mel_spectrogram
from emojivoice_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, mean_over
from emojivoice_tpu_torch.training.state import _as_made
from emojivoice_tpu_torch.vocoder.discriminators import (
    MultiPeriodDiscriminator,
    MultiScaleDiscriminator,
    discriminator_loss,
    feature_loss,
    generator_loss,
)
from emojivoice_tpu_torch.vocoder.hifigan import HiFiGANGenerator

if TYPE_CHECKING:
    from emojivoice_tpu_torch.training.vocoder_graphs import VocoderGraphs

MEL_LOSS_WEIGHT = 45.0  # upstream HiFi-GAN recipe
FM_LOSS_WEIGHT = 2.0


@dataclasses.dataclass
class VocoderTrainState:
    cfg: HiFiGANConfig
    gen: HiFiGANGenerator
    mpd: MultiPeriodDiscriminator
    msd: MultiScaleDiscriminator
    gen_opt: torch.optim.Optimizer
    disc_opt: torch.optim.Optimizer  # over mpd's parameters, then msd's
    step: int = 0
    mesh: Optional[Mesh] = None
    ddp: Optional[dict] = None  # "gen" (its forward_train), "mpd", "msd" under DDP over the data axis
    graphs: Optional["VocoderGraphs"] = None  # the captured steps, made at the first step through graphs

    @property
    def device(self) -> torch.device:
        return next(self.gen.parameters()).device

    def disc_parameters(self) -> list:
        return list(self.mpd.parameters()) + list(self.msd.parameters())


def create_vocoder_state(cfg: HiFiGANConfig, lr: float = 2e-4, b1: float = 0.8, b2: float = 0.99, seed: int = 0,
                         gen_state: Optional[dict] = None, weight_norm: bool = True,
                         disc_state: Optional[dict] = None, device="cuda",
                         mesh: Optional[Mesh] = None) -> VocoderTrainState:
    """Generator, discriminators and their two Adams at step 0, on `device`
    (the card unless the caller asks for ``device="cpu"``).

    weight_norm=True (default) trains the generator in the upstream
    parameterization (one magnitude per channel and a direction tensor);
    `gen_state` is then a state dict with ``weight_g``/``weight_v`` names
    (``load_hifigan(path, fold=False)``).  weight_norm=False trains plain
    folded weights: another optimizer geometry than upstream HiFi-GAN's, fine
    for a quick adaptation.  `disc_state` (``{"mpd": state dict, "msd": state
    dict}``, e.g. from ``load_hifigan_discriminators``) warm-starts the
    discriminators, which go on training as plain weights.  What is not given
    is initialised under a forked RNG seeded with `seed`.  `mesh` trains data
    parallel (the module docstring).  On the card without a mesh both Adams
    are ``capturable`` (the rate a 0-d device tensor that stays constant), so
    that the step can run through a captured graph; on the CPU, or over a
    mesh, they are plain.  A ``load_state_dict`` keeps each as it was made."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError('create_vocoder_state: no CUDA device is available (pass device="cpu" to train on the '
                           'CPU)')
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        gen = HiFiGANGenerator(cfg, weight_norm=weight_norm)
        mpd, msd = MultiPeriodDiscriminator(), MultiScaleDiscriminator()
    if gen_state is not None:
        gen.load_state_dict(gen_state, strict=True)
    if disc_state is not None:
        mpd.load_state_dict(disc_state["mpd"], strict=True)
        msd.load_state_dict(disc_state["msd"], strict=True)
    gen, mpd, msd = gen.to(device).train(), mpd.to(device).train(), msd.to(device).train()
    capturable = torch.device(device).type == "cuda" and mesh is None
    ddp = None
    if mesh is not None:
        from torch.nn.parallel import DistributedDataParallel

        dev = next(gen.parameters()).device
        kw = dict(process_group=mesh.group(DATA_AXIS), device_ids=[dev] if dev.type == "cuda" else None)
        ddp = {"gen": DistributedDataParallel(_TrainForward(gen), **kw), "mpd": DistributedDataParallel(mpd, **kw),
               "msd": DistributedDataParallel(msd, **kw)}

    def adam(params):
        params = list(params)
        rate = torch.tensor(float(lr), device=params[0].device) if capturable else lr
        opt = torch.optim.Adam(params, lr=rate, betas=(b1, b2), eps=1e-8, capturable=capturable)
        opt.register_load_state_dict_post_hook(lambda optimizer: _as_made(optimizer, capturable))
        return opt

    return VocoderTrainState(cfg=cfg, gen=gen, mpd=mpd, msd=msd, gen_opt=adam(gen.parameters()),
                             disc_opt=adam(list(mpd.parameters()) + list(msd.parameters())), mesh=mesh, ddp=ddp)


class _TrainForward(torch.nn.Module):
    """The generator's differentiable forward as a module's ``forward``, for DDP."""

    def __init__(self, gen: HiFiGANGenerator):
        super().__init__()
        self.gen = gen

    def forward(self, mel):
        return self.gen.forward_train(mel)


def loss_mel_spectrogram(wav: torch.Tensor, cfg: HiFiGANConfig) -> torch.Tensor:
    """The mel of the loss: full band (fmax = sr / 2), unlike the 8 kHz
    conditioning mels, so the loss sees the top of the spectrum that the
    conditioning never shows (upstream's ``fmax_loss: null``)."""
    return mel_spectrogram(wav, 1024, cfg.num_mels, cfg.sampling_rate, 256, 1024, 0.0, cfg.sampling_rate / 2.0)


def generator_losses(state: VocoderTrainState, wav: torch.Tensor, y_g: torch.Tensor):
    """(total, mel × 45, feature matching, adversarial) of the generated
    waveform `y_g` against the state's discriminators.  ``feature_loss``
    already doubles, so feature matching enters as ``(fm_p + fm_s) · 2 / 2``,
    the JAX package's weighting."""
    with torch.no_grad():
        mel_target = loss_mel_spectrogram(wav, state.cfg)
    loss_mel = torch.mean(torch.abs(loss_mel_spectrogram(y_g, state.cfg) - mel_target)) * MEL_LOSS_WEIGHT
    _, g_p, f_rp, f_gp = state.mpd(wav, y_g)
    _, g_s, f_rs, f_gs = state.msd(wav, y_g)
    loss_fm = (feature_loss(f_rp, f_gp) + feature_loss(f_rs, f_gs)) * FM_LOSS_WEIGHT / 2.0
    loss_adv = generator_loss(g_p)[0] + generator_loss(g_s)[0]
    return loss_mel + loss_fm + loss_adv, loss_mel, loss_fm, loss_adv


def discriminator_losses(state: VocoderTrainState, wav: torch.Tensor, y_hat: torch.Tensor) -> torch.Tensor:
    mpd, msd = (state.ddp["mpd"], state.ddp["msd"]) if state.ddp else (state.mpd, state.msd)
    r_p, g_p, _, _ = mpd(wav, y_hat)
    r_s, g_s, _, _ = msd(wav, y_hat)
    return discriminator_loss(r_p, g_p)[0] + discriminator_loss(r_s, g_s)[0]


def step_body(state: VocoderTrainState, batch: dict, clock=None) -> dict:
    """One alternating step on `batch` without the step count or the mean
    over ranks → this device's metrics: the eager step's body, and what a
    captured step records (``training/vocoder_graphs.py``)."""
    mel, wav = batch["mel"], batch["wav"]

    def mark(name):
        if clock is not None:
            clock.mark(name)

    y_hat = state.ddp["gen"](mel) if state.ddp else state.gen.forward_train(mel)
    mark("gen_forward")

    d_loss = discriminator_losses(state, wav, y_hat.detach())
    state.disc_opt.zero_grad(set_to_none=True)
    d_loss.backward()
    state.disc_opt.step()
    mark("disc_update")

    disc_params = state.disc_parameters()
    for p in disc_params:
        p.requires_grad_(False)
    try:
        g_loss, loss_mel, loss_fm, loss_adv = generator_losses(state, wav, y_hat)
        mark("gen_loss_forward")
        state.gen_opt.zero_grad(set_to_none=True)
        g_loss.backward()
        mark("gen_backward")
    finally:
        for p in disc_params:
            p.requires_grad_(True)
    state.gen_opt.step()
    mark("gen_update")
    return {"d_loss": d_loss.detach(), "g_loss": g_loss.detach(), "mel_l1": loss_mel.detach() / MEL_LOSS_WEIGHT,
            "fm_loss": loss_fm.detach(), "adv_loss": loss_adv.detach()}


def vocoder_train_step(state: VocoderTrainState, batch: dict, clock=None, graphs: Optional[bool] = None) -> dict:
    """One alternating step on ``batch{"mel" (B, T, num_mels), "wav" (B, T·hop)}``
    (tensors on the state's device) → metrics as 0-d tensors, which the caller
    reads when it chooses, so the step itself does not wait for the device.

    The generated waveform is computed once, from the generator as it stands
    before the step; the discriminators update on it with the gradient cut;
    the generator loss is then taken against the updated discriminators,
    whose parameters are frozen for that pass so that no gradient reaches
    them.  `clock`, where given, has ``mark(name)`` called after each stage.
    Data parallel, `batch` is this rank's rows and the metrics are the global
    batch's.

    `graphs`: through one captured CUDA graph per batch shape
    (``training/vocoder_graphs.py``, the counterpart of the JAX package's
    jitted step), the default on the card without a mesh; ``graphs=False``
    runs the step eagerly, the CPU's default.  A mesh or a `clock` with
    ``graphs=True`` raises: collectives are not captured, and a graph has no
    stages to mark."""
    if graphs is None:
        graphs = state.device.type == "cuda" and state.mesh is None
    if graphs:
        if state.mesh is not None:
            raise ValueError("vocoder_train_step: graphs=True with a mesh: training over a mesh runs eagerly (its "
                             "collectives are not captured); pass graphs=False or no mesh")
        if clock is not None:
            raise ValueError("vocoder_train_step: clock= with graphs=True: a captured step has no stages to mark; "
                             "pass graphs=False to time the step by stage")
        if state.graphs is None:
            from emojivoice_tpu_torch.training.vocoder_graphs import VocoderGraphs

            state.graphs = VocoderGraphs(state)
        return state.graphs.step(batch)
    metrics = step_body(state, batch, clock)
    state.step += 1
    return mean_over(metrics, state.mesh.group(DATA_AXIS) if state.mesh is not None else None)
