"""Train state and the train/eval steps (PyTorch port of
``emojivoice_tpu.training.state``), one device, f32 or bf16-mixed.

Adam (lr 1e-4) with global-norm clipping at 5.0, loss = dur + prior + diff,
the gradient norm before clipping as a metric every step.  The learning rate
is a function of the optimizer step count, so restoring the step restores the
schedule's position.

The update is held to the JAX package's optax chain: ``torch.optim.Adam`` and
``optax.adam`` compute the same step (eps 1e-8 outside the root, bias
correction on both moments), ``AdamW`` the same as ``optax.adamw``; the clip
is written by hand to optax's formula, ``g · max_norm / max(norm, max_norm)``,
because ``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6``.

``precision="bf16-mixed"`` follows the JAX step (``_build_step_fn``): inside
the loss every float parameter and every float batch entry is cast to bf16
(``torch.func.functional_call`` on the cast parameters; the cast is
differentiable, so the gradients land on the f32 parameters), while the loss
terms, gradients, norm, clip and Adam stay f32, with no loss scaling.  Not
``torch.autocast``: that keeps norms and softmax in f32 and computes something
other than the JAX step.

Conformer blocks carry BatchNorm running statistics as buffers.  A training
forward updates them in place and an eval forward (``eval_step``, the probe,
a render) reads them only.  Under ``bf16-mixed`` only the parameters are cast:
the buffers stay the module's own f32 tensors, so the update lands on them
(a cast copy would take it and be thrown away).  The update itself is
computed in bf16 from the statistics rounded to bf16 and stored back in f32,
as the JAX step casts its ``batch_stats`` with the parameters and keeps the
updated ones in f32.  Checkpoints hold the buffers with the weights.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from emojivoice_tpu_torch.config import ModelConfig, OptimizerConfig
from emojivoice_tpu_torch.models.matcha import MatchaTTS
from emojivoice_tpu_torch.utils.prng import step_seed, training_draws


def _dtype_for(precision: Optional[str]) -> torch.dtype:
    """The compute dtype of a precision name, as the JAX trainer reads it."""
    if precision in ("bf16-mixed", "bf16", "16-mixed"):
        return torch.bfloat16
    if precision in ("f32", "fp32", "32", "32-true", None):
        return torch.float32
    raise ValueError(f"Unknown precision: {precision!r}")


def make_schedule(cfg: OptimizerConfig) -> Callable[[int], float]:
    """Learning rate as a function of the optimizer step count (0 for the
    first update): constant, exponential (``lr · gamma^(step / decay_steps)``)
    or cosine (to ``lr_end`` over ``decay_steps``), each after an optional
    linear warm-up from 0 over ``warmup_steps`` during which the main
    schedule's clock stands still."""
    name = (cfg.scheduler or "constant").lower()
    if name == "constant":
        def main(step):
            return cfg.lr
    elif name == "exponential":
        def main(step):
            return cfg.lr * cfg.scheduler_gamma ** (step / cfg.decay_steps)
    elif name == "cosine":
        alpha = cfg.lr_end / cfg.lr if cfg.lr else 0.0

        def main(step):
            frac = min(step, cfg.decay_steps) / cfg.decay_steps
            return cfg.lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * frac)) + alpha)
    else:
        raise ValueError(f"Unknown scheduler: {cfg.scheduler!r}")
    warmup = cfg.warmup_steps
    if warmup <= 0:
        return main
    return lambda step: cfg.lr * step / warmup if step < warmup else main(step - warmup)


def make_optimizer(params, cfg: OptimizerConfig) -> torch.optim.Optimizer:
    """Adam, or AdamW where the config has a weight decay; the step sets the
    learning rate from the schedule before every update."""
    kwargs = dict(lr=cfg.lr, betas=(cfg.b1, cfg.b2), eps=1e-8)
    if cfg.weight_decay:
        return torch.optim.AdamW(params, weight_decay=cfg.weight_decay, **kwargs)
    return torch.optim.Adam(params, **kwargs)


@torch.no_grad()
def clip_by_global_norm_(params, max_norm: float) -> torch.Tensor:
    """Scale the gradients in place by ``max_norm / max(norm, max_norm)`` and
    return the global norm from before the clip."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    torch._foreach_mul_(grads, max_norm / torch.clamp_min(norm, max_norm))
    return norm


@dataclasses.dataclass
class TrainState:
    model: MatchaTTS
    optimizer: torch.optim.Optimizer
    opt_cfg: OptimizerConfig
    schedule: Callable[[int], float]
    step: int = 0

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(), "step": self.step}

    def load_state_dict(self, saved: dict) -> None:
        self.model.load_state_dict(saved["model"], strict=True)
        self.optimizer.load_state_dict(saved["optimizer"])
        self.step = int(saved["step"])


def create_train_state(model_cfg: ModelConfig, opt_cfg: OptimizerConfig, seed: int = 1234, device="cuda",
                       model: Optional[MatchaTTS] = None) -> TrainState:
    """A model (built on the CPU under a forked RNG seeded with `seed` unless
    one is given), moved to `device` (the card unless the caller asks for
    ``device="cpu"``), with its optimizer at step 0."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError('create_train_state: no CUDA device is available (pass device="cpu" to train on the '
                           'CPU)')
    if model is None:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = MatchaTTS(model_cfg)
    model = model.to(device)
    return TrainState(model=model, optimizer=make_optimizer(model.parameters(), opt_cfg), opt_cfg=opt_cfg,
                      schedule=make_schedule(opt_cfg))


def batch_to_device(batch: dict, device) -> dict:
    """A collated numpy batch → tensors on `device` (ids and lengths as
    int64, mels as f32)."""
    out = {}
    for key, value in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(value))
        out[key] = (t.float() if t.is_floating_point() else t.long()).to(device, non_blocking=True)
    return out


def _losses(model: MatchaTTS, batch: dict, draws: dict, out_size: Optional[int], precision: Optional[str] = "f32"):
    dtype = _dtype_for(precision)
    offsets = None
    if "crop_u" in draws:
        offsets = model.crop_offsets_from_uniform(draws["crop_u"], batch["y_lengths"], out_size)
    forward = model
    if dtype != torch.float32:
        params = {name: p.to(dtype) if p.is_floating_point() else p for name, p in model.named_parameters()}
        batch = {k: v.to(dtype) if v.is_floating_point() else v for k, v in batch.items()}

        def forward(*args, **kwargs):
            return torch.func.functional_call(model, params, args, kwargs)
    dur, prior, diff, _ = forward(batch["x"], batch["x_lengths"], batch["y"], batch["y_lengths"], batch.get("spks"),
                                batch.get("durations"), t=draws["t"], z=draws["z"], out_size=out_size,
                                crop_offsets=offsets, row_mask=batch.get("row_mask"))
    return dur, prior, diff


def apply_gradients(state: TrainState):
    """Clip the gradients that a backward pass left on the model, set the
    schedule's learning rate and take the optimizer step → (the gradient norm
    from before the clip, the learning rate used)."""
    params = [p for p in state.model.parameters() if p.requires_grad]
    grad_norm = clip_by_global_norm_(params, state.opt_cfg.grad_clip)
    lr = state.schedule(state.step)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    state.optimizer.step()
    state.step += 1
    return grad_norm, lr


def train_step(state: TrainState, batch: dict, seed: int, clock=None, precision: Optional[str] = "f32") -> dict:
    """One optimizer step on a device batch → metrics as 0-d tensors (the
    caller decides when to read them, so the step itself does not wait for
    the device).  The CFM draws, the crop offsets and dropout are seeded from
    ``(seed, state.step)``.  `clock`, where given, has ``mark(name)`` called
    after the forward, the backward and the update.  `precision`: "f32" or
    "bf16-mixed" (the module docstring; the JAX names of each are taken)."""
    model, dev = state.model, state.device
    model.train()
    out_size = model.cfg.out_size
    b, frames, n_feats = batch["y"].shape
    crop = out_size is not None and out_size < frames
    draws = training_draws(seed, state.step, b, out_size if crop else frames, n_feats, dev, crop=crop)
    # nn.Dropout draws from the global generator: give it this step's seed
    # inside a fork, so the caller's random state is left alone
    with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []):
        torch.manual_seed(step_seed(seed, state.step, "dropout"))
        dur, prior, diff = _losses(model, batch, draws, out_size, precision)
    total = dur + prior + diff
    if clock is not None:
        clock.mark("forward")
    state.optimizer.zero_grad(set_to_none=True)
    total.backward()
    if clock is not None:
        clock.mark("backward")
    grad_norm, lr = apply_gradients(state)
    if clock is not None:
        clock.mark("optimizer")
    return {"loss": total.detach(), "dur_loss": dur.detach(), "prior_loss": prior.detach(),
            "diff_loss": diff.detach(), "grad_norm": grad_norm, "lr": torch.tensor(lr)}


@torch.no_grad()
def eval_step(model: MatchaTTS, batch: dict, seed: int = 0, precision: Optional[str] = "f32") -> dict:
    """Validation losses: no dropout, no crop, and the same CFM draws on
    every call (seeded from `seed` alone), so the result depends only on the
    weights and the batch; `precision` casts as ``train_step`` does."""
    was_training = model.training
    model.eval()
    try:
        b, frames, n_feats = batch["y"].shape
        draws = training_draws(seed, 0, b, frames, n_feats, batch["y"].device)
        dur, prior, diff = _losses(model, batch, draws, None, precision)
    finally:
        model.train(was_training)
    return {"dur_loss": dur, "prior_loss": prior, "diff_loss": diff, "loss": dur + prior + diff}
