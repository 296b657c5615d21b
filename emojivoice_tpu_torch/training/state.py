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

**Parallelism** (``create_train_state(mesh=)``, a ``parallel/mesh.py`` mesh
over ranks that each run this code on the same arguments): on the model axis
the parameters, and with them Adam's moments, are this rank's slices by
``parallel/tp.py``'s rules; over the data axis the model is wrapped in
``DistributedDataParallel`` (every rank builds the same model and the same
Adam from the same seed) and each rank takes its rows of the global batch.
The losses and the conformer's BatchNorm statistics are the global batch's
(``models/matcha.py``, ``models/conformer.py``), the gradient norm sums the
squares of the sharded slices over the model group and counts the replicated
parameters once, the CFM draws are made for the global batch from the same
``(seed, step)`` generators and sliced, so they equal the one-device draws,
and dropout is seeded from ``(seed, step, data rank)``, so the ranks of one
model group draw one mask on a replicated activation.  ``train_step`` and
``eval_step`` report the global batch's losses.  Checkpoints of a parallel
state go through ``torch.distributed.checkpoint`` (``sharded_state_dict``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import TYPE_CHECKING, Callable, Optional

import numpy as np
import torch

from emojivoice_tpu_torch.config import ModelConfig, OptimizerConfig
from emojivoice_tpu_torch.models.matcha import MatchaTTS
from emojivoice_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, collectives, mean_over
from emojivoice_tpu_torch.parallel.tp import MODEL_AXIS, is_sharded, shard_params, tp_shardings
from emojivoice_tpu_torch.utils.prng import step_seed, training_draws

if TYPE_CHECKING:
    from emojivoice_tpu_torch.training.graphs import TrainGraphs


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


def make_optimizer(params, cfg: OptimizerConfig, capturable: bool = False) -> torch.optim.Optimizer:
    """Adam, or AdamW where the config has a weight decay; the step sets the
    learning rate from the schedule before every update (``set_lr_``).

    `capturable` (``create_train_state`` asks for it on the card): the step
    counts live on the parameters' device, the bias corrections are
    computed there, and the learning rate is a 0-d f32 device tensor filled
    in place before each update, so that a captured step
    (``training/graphs.py``) reads this step's values and not the ones of
    its capture.  The eager step of such a state takes the same optimizer,
    so the two compute the same update, and so does a step over a mesh,
    which runs eagerly: a one-rank mesh trains as one card does (within
    rounding; with a plain Adam there it would part by Adam's bias
    corrections).
    The CPU's Adam refuses ``capturable``.  A load keeps the optimizer as it
    was made (``_as_made``), whatever kind of optimizer wrote the
    checkpoint."""
    params = list(params)
    kwargs = dict(lr=cfg.lr, betas=(cfg.b1, cfg.b2), eps=1e-8)
    if capturable:
        kwargs.update(lr=torch.tensor(float(cfg.lr), device=params[0].device), capturable=True)
    if cfg.weight_decay:
        opt = torch.optim.AdamW(params, weight_decay=cfg.weight_decay, **kwargs)
    else:
        opt = torch.optim.Adam(params, **kwargs)
    opt.register_load_state_dict_post_hook(lambda optimizer: _as_made(optimizer, capturable))
    return opt


def _as_made(optimizer: torch.optim.Optimizer, capturable: bool) -> None:
    """A loaded optimizer in the form ``make_optimizer`` gave it.
    ``load_state_dict`` takes every hyperparameter from the file,
    ``capturable`` included, and leaves the step counts where that flag put
    them; a checkpoint written on the other kind of device, or by a plain
    optimizer, holds the other form.  So the flag is set back, the
    step counts go to the parameter's device as f32 (capturable) or to the
    CPU, and the rate becomes a new 0-d f32 device tensor or a float."""
    for group in optimizer.param_groups:
        group["capturable"] = capturable
        lr = float(group["lr"])
        group["lr"] = torch.tensor(lr, dtype=torch.float32, device=group["params"][0].device) if capturable else lr
        for p in group["params"]:
            st = optimizer.state.get(p)
            if st and torch.is_tensor(st.get("step")):
                st["step"] = st["step"].to(device=p.device, dtype=torch.float32) if capturable \
                    else st["step"].to("cpu")


def set_lr_(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Set every group's learning rate: a device tensor is filled in place
    (a kernel argument, no copy from the host), a float replaced."""
    for group in optimizer.param_groups:
        if torch.is_tensor(group["lr"]):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


@torch.no_grad()
def clip_by_global_norm_(params, max_norm: float, model_group=None) -> torch.Tensor:
    """Scale the gradients in place by ``max_norm / max(norm, max_norm)`` and
    return the global norm from before the clip.  With a tensor-parallel
    `model_group` the squares of the sharded slices are summed over the group
    and each replicated gradient counts once."""
    grads = [p.grad for p in params if p.grad is not None]
    if model_group is None:
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    else:
        squares = torch.stack(torch._foreach_norm(grads)).square()
        split = torch.tensor([is_sharded(p) for p in params if p.grad is not None], device=squares.device)
        sharded = squares[split].sum()
        collectives["all_reduce"] += 1
        torch.distributed.all_reduce(sharded, group=model_group)
        norm = torch.sqrt(sharded + squares[~split].sum())
    torch._foreach_mul_(grads, max_norm / torch.clamp_min(norm, max_norm))
    return norm


@dataclasses.dataclass
class TrainState:
    model: MatchaTTS
    optimizer: torch.optim.Optimizer
    opt_cfg: OptimizerConfig
    schedule: Callable[[int], float]
    step: int = 0
    mesh: Optional[Mesh] = None
    ddp: Optional[torch.nn.Module] = None  # the model under DistributedDataParallel, over the data axis
    graphs: Optional["TrainGraphs"] = None  # the captured steps (training/graphs.py), made at the first graphed step

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(), "step": self.step}

    def load_state_dict(self, saved: dict) -> None:
        """Restore a ``state_dict``.  The optimizer's load replaces its state
        tensors, so the captured steps are dropped (``TrainGraphs`` does so on
        every optimizer load, this one included)."""
        self.model.load_state_dict(saved["model"], strict=True)
        self.optimizer.load_state_dict(saved["optimizer"])
        self.step = int(saved["step"])

    def sharded_state_dict(self) -> dict:
        """The state for ``torch.distributed.checkpoint``: every tensor this
        rank holds, a tensor-parallel slice as a DTensor with its placements
        on the mesh (Adam's moments as their parameter), aliasing the live
        tensors, so that a load in place restores the state onto the mesh."""
        from torch.distributed.tensor import DTensor

        placements = tp_shardings(dict(self.model.named_parameters()), self.mesh)
        dm = self.mesh.device_mesh

        def wrap(name, t):
            return DTensor.from_local(t, dm, placements[name], run_check=False) if name in placements \
                and any(not p.is_replicate() for p in placements[name]) else t

        model = {k: wrap(k, v) for k, v in self.model.state_dict(keep_vars=False).items()}
        moments = {}
        capturable = self.optimizer.defaults.get("capturable", False)
        for name, p in self.model.named_parameters():
            st = self.optimizer.state[p]
            if not st:  # Adam's own lazy initial state, so that a fresh optimizer can be loaded into
                step = torch.zeros((), dtype=torch.float32, device=p.device) if capturable else torch.tensor(0.0)
                st.update(step=step, exp_avg=torch.zeros_like(p), exp_avg_sq=torch.zeros_like(p))
            moments[name] = {"step": st["step"], "exp_avg": wrap(name, st["exp_avg"]),
                             "exp_avg_sq": wrap(name, st["exp_avg_sq"])}
        return {"model": model, "optimizer": moments, "step": torch.tensor(self.step)}

    def load_sharded_state_dict(self, sd: dict) -> None:
        """Take the state from a ``sharded_state_dict`` that a checkpoint
        was loaded into (in place; the captured steps and forwards are
        dropped all the same)."""
        from emojivoice_tpu_torch.training.eval_graphs import existing

        for graphs in (self.graphs, existing(self.model)):
            if graphs is not None:
                graphs.drop()

        def local(t):
            return t.to_local() if hasattr(t, "to_local") else t

        with torch.no_grad():
            for k, v in self.model.state_dict(keep_vars=True).items():
                v.copy_(local(sd["model"][k]))
            for name, p in self.model.named_parameters():
                for k, v in self.optimizer.state[p].items():
                    v.copy_(local(sd["optimizer"][name][k]))
        self.step = int(sd["step"])


def create_train_state(model_cfg: ModelConfig, opt_cfg: OptimizerConfig, seed: int = 1234, device="cuda",
                       model: Optional[MatchaTTS] = None, mesh: Optional[Mesh] = None) -> TrainState:
    """A model (built on the CPU under a forked RNG seeded with `seed` unless
    one is given), moved to `device` (the card unless the caller asks for
    ``device="cpu"``), with its optimizer at step 0; over a `mesh`, laid out
    and wrapped as the module docstring says."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError('create_train_state: no CUDA device is available (pass device="cpu" to train on the '
                           'CPU)')
    if model is None:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = MatchaTTS(model_cfg)
    model = model.to(device)
    ddp = None
    if mesh is not None:
        ddp = distribute(model, mesh)
    optimizer = make_optimizer(model.parameters(), opt_cfg, capturable=torch.device(device).type == "cuda")
    return TrainState(model=model, optimizer=optimizer, opt_cfg=opt_cfg, schedule=make_schedule(opt_cfg), mesh=mesh,
                      ddp=ddp)


def distribute(model: MatchaTTS, mesh: Mesh) -> torch.nn.Module:
    """Lay `model` out on `mesh` in place (tensor-parallel slices, the
    losses and BatchNorm statistics over the data group) → the model under
    ``DistributedDataParallel`` over the data axis."""
    from torch.nn.parallel import DistributedDataParallel

    from emojivoice_tpu_torch.models.conformer import BatchNorm

    shard_params(model, mesh)
    group = mesh.group(DATA_AXIS)
    model.data_group = group
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.sync_group = group
    dev = next(model.parameters()).device
    return DistributedDataParallel(model, process_group=group, device_ids=[dev] if dev.type == "cuda" else None)


def batch_to_device(batch: dict, device) -> dict:
    """A collated numpy batch → tensors on `device` (ids and lengths as
    int64, mels as f32)."""
    out = {}
    for key, value in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(value))
        out[key] = (t.float() if t.is_floating_point() else t.long()).to(device, non_blocking=True)
    return out


def _losses(model: torch.nn.Module, batch: dict, draws: dict, out_size: Optional[int],
            precision: Optional[str] = "f32"):
    """The three losses of `model` (a MatchaTTS, or one under DDP) on `batch`."""
    dtype = _dtype_for(precision)
    offsets = None
    if "crop_u" in draws:
        offsets = MatchaTTS.crop_offsets_from_uniform(draws["crop_u"], batch["y_lengths"], out_size)
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


@torch.no_grad()
def average_replicated_grads_(params, model_group) -> None:
    """Average the gradients of the replicated parameters over the model
    group, in one all-reduce.  Every rank of the group computes them alike,
    but the card's backward adds atomically (embedding, gather and some conv
    gradients), so they can differ in their last bits from rank to rank, and
    the replicas would drift apart step by step; averaged, every rank takes
    the same update."""
    grads = [p.grad for p in params if p.grad is not None and not is_sharded(p)]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    collectives["all_reduce"] += 1
    torch.distributed.all_reduce(flat, group=model_group)
    flat /= torch.distributed.get_world_size(model_group)
    torch._foreach_copy_(grads, [part.view_as(g) for part, g in zip(flat.split([g.numel() for g in grads]), grads)])


def _update(state: TrainState) -> torch.Tensor:
    """Clip the gradients that a backward pass left on the model and take the
    optimizer step at the rate already set → the gradient norm from before
    the clip.  Under tensor parallelism the replicated parameters' gradients
    are first averaged over the model group (``average_replicated_grads_``)."""
    params = [p for p in state.model.parameters() if p.requires_grad]
    model_group = state.mesh.group(MODEL_AXIS) if state.mesh is not None and state.mesh.size(MODEL_AXIS) > 1 else None
    if model_group is not None:
        average_replicated_grads_(params, model_group)
    grad_norm = clip_by_global_norm_(params, state.opt_cfg.grad_clip, model_group)
    state.optimizer.step()
    return grad_norm


def apply_gradients(state: TrainState):
    """Set the schedule's learning rate, clip the gradients that a backward
    pass left on the model and take the optimizer step → (the gradient norm
    from before the clip, the learning rate used)."""
    lr = state.schedule(state.step)
    set_lr_(state.optimizer, lr)
    grad_norm = _update(state)
    state.step += 1
    return grad_norm, lr


def step_body(state: TrainState, batch: dict, draws: dict, precision: Optional[str], clock=None) -> dict:
    """Forward, backward, clip and optimizer step on device tensors alone →
    the step's metrics as 0-d tensors (the learning rate aside).  No host
    value is read, no random generator seeded and no host state moved, so a
    CUDA graph can capture it (``training/graphs.py``); the caller sets the
    rate, seeds dropout, makes the draws and counts the step."""
    model = state.model
    dur, prior, diff = _losses(state.ddp or model, batch, draws, model.cfg.out_size, precision)
    total = dur + prior + diff
    if clock is not None:
        clock.mark("forward")
    state.optimizer.zero_grad(set_to_none=True)
    total.backward()
    if clock is not None:
        clock.mark("backward")
    grad_norm = _update(state)
    if clock is not None:
        clock.mark("optimizer")
    losses = mean_over({"loss": total, "dur_loss": dur, "prior_loss": prior, "diff_loss": diff},
                       model.data_group)
    return {**{k: v.detach() for k, v in losses.items()}, "grad_norm": grad_norm}


def step_draws(state: TrainState, batch: dict, seed: int, out: Optional[dict] = None) -> dict:
    """The CFM draws and crop uniforms of this step from ``(seed,
    state.step)``, for the global batch and sliced to this data rank's rows;
    written into `out`'s tensors where given (one device, no slicing)."""
    mesh = state.mesh
    b, frames, n_feats = batch["y"].shape
    out_size = state.model.cfg.out_size
    crop = out_size is not None and out_size < frames
    n_data, data_rank = (mesh.size(DATA_AXIS), mesh.rank(DATA_AXIS)) if mesh is not None else (1, 0)
    draws = training_draws(seed, state.step, b * n_data, out_size if crop else frames, n_feats, state.device,
                           crop=crop, out=out)
    return draws if n_data == 1 else {k: v[data_rank * b:(data_rank + 1) * b] for k, v in draws.items()}


def dropout_seed(state: TrainState, seed: int) -> int:
    """The seed of this step's dropout masks: ``(seed, state.step)`` and the
    data rank, so the ranks of one model group draw one mask."""
    data_rank = state.mesh.rank(DATA_AXIS) if state.mesh is not None else 0
    return step_seed(seed, state.step, "dropout" if data_rank == 0 else f"dropout/{data_rank}")


def train_step(state: TrainState, batch: dict, seed: int, clock=None, precision: Optional[str] = "f32",
               graphs: Optional[bool] = None) -> dict:
    """One optimizer step on a device batch → metrics as 0-d tensors (the
    caller decides when to read them, so the step itself does not wait for
    the device).  The CFM draws, the crop offsets and dropout are seeded from
    ``(seed, state.step)``.  `clock`, where given, has ``mark(name)`` called
    after the forward, the backward and the update.  `precision`: "f32" or
    "bf16-mixed" (the module docstring; the JAX names of each are taken).
    Over a mesh `batch` is this data rank's rows of the global batch
    (``parallel/mesh.py::shard_batch``), and the metrics are the global
    batch's.

    `graphs`: through one captured CUDA graph per bucket key
    (``training/graphs.py``, the counterpart of the JAX trainer's jitted
    step), the default on the card without a mesh; ``graphs=False`` runs the
    step eagerly, the CPU's default.  A mesh or a `clock` with
    ``graphs=True`` raises: collectives are not captured, and a graph has no
    stages to mark."""
    dev = state.device
    if graphs is None:
        graphs = dev.type == "cuda" and state.mesh is None
    if graphs:
        if state.mesh is not None:
            raise ValueError("train_step: graphs=True with a mesh: training over a mesh runs eagerly (its "
                             "collectives are not captured); pass graphs=False or no mesh")
        if clock is not None:
            raise ValueError("train_step: clock= with graphs=True: a captured step has no stages to mark; pass "
                             "graphs=False to time the step by stage")
        if state.graphs is None:
            from emojivoice_tpu_torch.training.graphs import TrainGraphs

            state.graphs = TrainGraphs(state)
        return state.graphs.step(batch, seed, precision)
    state.model.train()
    draws = step_draws(state, batch, seed)
    lr = state.schedule(state.step)
    set_lr_(state.optimizer, lr)
    # nn.Dropout draws from the global generator: give it this step's seed
    # inside a fork, so the caller's random state is left alone
    with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []):
        torch.manual_seed(dropout_seed(state, seed))
        metrics = step_body(state, batch, draws, precision, clock)
    state.step += 1
    return {**metrics, "lr": torch.tensor(lr)}


@torch.no_grad()
def eval_step(model: MatchaTTS, batch: dict, seed: int = 0, precision: Optional[str] = "f32",
              graphs: Optional[bool] = None) -> dict:
    """Validation losses: no dropout, no crop, and the same CFM draws on
    every call (seeded from `seed` alone), so the result depends only on the
    weights and the batch; `precision` casts as ``train_step`` does.  On a
    model laid out over a mesh (``distribute``), `batch` is this data rank's
    rows and the losses are the global batch's.

    `graphs`: through one captured CUDA graph per key
    (``training/eval_graphs.py``, the model's own ``EvalGraphs``; the
    counterpart of the JAX package's jitted eval step), the default on the
    card for a model not laid out over a mesh; ``graphs=False`` runs the
    forward eagerly, the CPU's default.  ``graphs=True`` over a mesh raises."""
    if graphs is None:
        graphs = batch["y"].device.type == "cuda" and model.data_group is None
    if graphs:
        if model.data_group is not None:
            raise ValueError("eval_step: graphs=True with a mesh: a model over a mesh runs its eval step eagerly "
                             "(its collectives are not captured); pass graphs=False")
        from emojivoice_tpu_torch.training.eval_graphs import graphs_for

        return graphs_for(model).eval_step(batch, seed, precision)
    was_training = model.training
    model.eval()
    try:
        b, frames, n_feats = batch["y"].shape
        group = model.data_group
        n, r = (1, 0) if group is None else (torch.distributed.get_world_size(group),
                                              torch.distributed.get_rank(group))
        draws = training_draws(seed, 0, b * n, frames, n_feats, batch["y"].device)
        draws = {k: v[r * b:(r + 1) * b] for k, v in draws.items()}
        dur, prior, diff = _losses(model, batch, draws, None, precision)
    finally:
        model.train(was_training)
    return mean_over({"dur_loss": dur, "prior_loss": prior, "diff_loss": diff, "loss": dur + prior + diff}, group)
