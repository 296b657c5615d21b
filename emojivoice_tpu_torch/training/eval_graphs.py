"""Captured CUDA graphs for the acoustic model's forwards outside the train
step: the port's counterparts of the JAX package's jitted eval step
(``emojivoice_tpu/training/state.py:316,327``), the trainer's probe
(``emojivoice_tpu/training/train.py:390``) and ``get_durations``' forward
(``emojivoice_tpu/training/get_durations.py:130``), each compiled there
once per batch shape.

``EvalGraphs(model)`` holds one graph per key for three bodies, each run with
the model in eval mode (no dropout; the conformer's BatchNorm reads its
running statistics) and each with K2 inside:

* ``eval_step(batch, seed, precision)`` → ``state.py::eval_step``'s losses.
  Key: the batch's (B, T_text, T_mel), the precision, which of ``spks``,
  ``durations`` and ``row_mask`` it carries, and the seed.  The eval draws
  (``training_draws(seed, 0, ...)``) depend on the seed and the shape alone,
  so they are made once per key into static buffers.
* ``probe(batch, z, n_timesteps)`` → ``MatchaTTS.training_probe``'s
  outputs on the trainer's fixed batch and fixed noise ``z``.
* ``align(batch, z, n_timesteps)`` → ``get_durations``' loop body: the
  alignment (``MatchaTTS.align``, K2) summed to per-token durations, and with
  ``z`` (``--gen_mels``) the teacher-forced ``decode_mel`` on them.

The pattern is ``training/graphs.py::TrainGraphs``' on
``utils/cuda_graphs.py::GraphCache``, without an optimizer: on the card the
first call at a key is the real forward, run eagerly on the side stream as
the warm run, after which the key is captured without being run; a later
call copies its inputs into the key's static buffers, replays, and copies
the outputs out at once.  On the CPU nothing is captured: the same keys and
buffers, with the body run on them every call.  A failed capture raises.

**Weights.** A graph reads the parameters and buffers where they live, so a
train step's update in place (eager, or a train graph's replay) is seen by
the next replay.  A parameter or buffer replaced by another object (looked
for after any module registration in the process), another storage under
one (``.data =``), ``load_sharded_state_dict`` and, where the graphs
``follow`` an optimizer, every load of its state drop every graph, as they
drop ``TrainGraphs``'; a drop takes a new pool.

**K2's launch counter**: counted when the wrapper runs (the first call at a
key, and the capture, whose count is taken back out), and on every replay
the capture's count is added, so a call counts one launch whether it ran
eagerly or from a graph.

``graphs_for(model)`` gives the model's own cache, made at its first use and
held only while the model lives: ``state.py::eval_step`` takes it by default
on the card for a model that is not laid out over a mesh.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Callable, Optional

import torch
import torch.nn as nn

from emojivoice_tpu_torch.ops import mas
from emojivoice_tpu_torch.utils.cuda_graphs import GraphCache, copy_in, registrations, signature, static_buffer
from emojivoice_tpu_torch.utils.prng import training_draws

# the batch entries the eval step reads; the last three are optional and part of the key
INPUTS = ("x", "x_lengths", "y", "y_lengths", "spks", "durations", "row_mask")
OPTIONAL = INPUTS[4:]


@dataclasses.dataclass
class _Forward:
    graph: Any  # torch.cuda.CUDAGraph; None on the CPU
    inputs: dict  # static inputs
    fixed: dict  # static tensors made once per key (the eval draws)
    out: dict  # the capture's outputs (empty on the CPU)
    k2: int  # K2 launches the capture recorded: what one replay launches
    capture_ms: float
    replays: int = 0


class EvalGraphs(GraphCache):
    """(body, key) → captured forward with its static buffers, for one
    ``MatchaTTS`` on one device (the module docstring).  It holds the model
    by a weak reference."""

    def __init__(self, model: nn.Module):
        if getattr(model, "data_group", None) is not None:
            raise ValueError("EvalGraphs: a model laid out over a mesh runs its forwards eagerly (their collectives "
                             "are not captured)")
        super().__init__(next(model.parameters()).device)
        self._model = weakref.ref(model)
        self._seen_registrations = registrations()
        self._weights = self._collect()
        self._stamp = self._pointers()

    @property
    def model(self) -> nn.Module:
        return self._model()

    def _collect(self) -> list:
        return list(self.model.parameters()) + list(self.model.buffers())

    def _pointers(self) -> tuple:
        return tuple(t.data_ptr() for t in self._weights)

    def follow(self, optimizer: torch.optim.Optimizer) -> "EvalGraphs":
        """Drop every graph on each load of `optimizer`'s state, as the train
        step's graphs do."""
        ref = weakref.ref(self)

        def dropped(opt) -> None:
            if ref() is not None:
                ref().drop()
        optimizer.register_load_state_dict_post_hook(dropped)
        return self

    def drop(self) -> None:
        super().drop()
        self._weights = self._collect()
        self._stamp = self._pointers()

    def _check_weights(self) -> None:
        """Drop the graphs if a weight was replaced by another object or its
        storage by another."""
        if registrations() != self._seen_registrations:
            self._seen_registrations = registrations()
            weights = self._collect()
            if len(weights) != len(self._weights) or any(a is not b for a, b in zip(weights, self._weights)):
                self.drop()
        if self._pointers() != self._stamp:
            self.drop()

    def _run(self, name: str, key: tuple, inputs: dict, body: Callable[[dict, dict], dict],
             make_fixed: Optional[Callable[[dict], dict]] = None) -> dict:
        """body(static inputs, fixed) → its outputs, through the graph of
        (name, key, the inputs' shapes and dtypes), with the model in eval
        mode; the outputs are the caller's own tensors."""
        model = self.model
        with self.lock, torch.no_grad():
            self._check_weights()
            names = [k for k, v in inputs.items() if v is not None]
            full = ((name, *key), tuple((k, signature(inputs[k])) for k in names))
            was_training = model.training
            model.eval()
            try:
                g = self._graphs.get(full)
                if g is None:
                    g, out = self._build(inputs, names, body, make_fixed)
                    self._graphs[full] = g
                    return out
                copy_in([g.inputs[k] for k in names], [inputs[k] for k in names])
                if g.graph is None:
                    out = body(g.inputs, g.fixed)
                else:
                    g.graph.replay()
                    out = {k: v.clone() for k, v in g.out.items()}
                    mas.add_launches(g.k2)
                g.replays += 1
                return out
            finally:
                model.train(was_training)

    def _build(self, inputs: dict, names: list, body, make_fixed) -> tuple:
        """The key's static buffers and its first call; on the card the real
        forward as the warm run, then the capture → (the entry, its outputs)."""
        static = {k: static_buffer(inputs[k], self.device) for k in names}
        copy_in([static[k] for k in names], [inputs[k] for k in names])
        fixed = make_fixed(static) if make_fixed is not None else {}
        if not self.capture:
            return _Forward(None, static, fixed, {}, 0, 0.0), body(static, fixed)

        def first():
            out = body(static, fixed)
            counted[0] = 0  # the first call's launch was a call's; what the capture records is the graph's build
            return out

        with mas.tally() as counted:
            try:
                graph, out, static_out, _, capture_ms = self.capture_graph(first, lambda: body(static, fixed))
            finally:
                mas.add_launches(-counted[0])
        return _Forward(graph, static, fixed, static_out, counted[0], capture_ms), out

    # -- the three bodies ------------------------------------------------------

    def eval_step(self, batch: dict, seed: int = 0, precision: Optional[str] = "f32") -> dict:
        """``state.py::eval_step``'s losses of `batch` (device tensors) as 0-d
        tensors the caller owns."""
        from emojivoice_tpu_torch.training.state import _losses

        b, t_text = batch["x"].shape
        t_mel = batch["y"].shape[1]
        n_feats = batch["y"].shape[2]
        key = (b, t_text, t_mel, precision, tuple(k for k in OPTIONAL if k in batch), int(seed))
        model = self.model

        def draws(static):
            return training_draws(seed, 0, b, t_mel, n_feats, self.device)

        def body(static, fixed):
            dur, prior, diff = _losses(model, static, fixed, None, precision)
            return {"dur_loss": dur, "prior_loss": prior, "diff_loss": diff, "loss": dur + prior + diff}

        return self._run("eval", key, {k: batch[k] for k in INPUTS if k in batch}, body, draws)

    def probe(self, batch: dict, z: torch.Tensor, n_timesteps: int = 10) -> dict:
        """``MatchaTTS.training_probe`` on `batch` with the solver's noise `z`."""
        model = self.model

        def body(static, fixed):
            return model.training_probe(static["x"], static["x_lengths"], static["y"], static["y_lengths"],
                                        static.get("spks"), n_timesteps, z=static["z"])

        inputs = {k: batch.get(k) for k in ("x", "x_lengths", "y", "y_lengths", "spks")}
        return self._run("probe", (int(n_timesteps),), dict(inputs, z=z), body)

    def align(self, batch: dict, z: Optional[torch.Tensor] = None, n_timesteps: int = 10) -> dict:
        """``get_durations``' forward on `batch`: ``durations`` (B, T_text),
        the alignment summed over mel frames, and with `z` (B, T_mel,
        n_feats), the noise scaled by the temperature, ``mel``: the
        teacher-forced decode on those durations at the batch's mel length."""
        model = self.model
        frames = batch["y"].shape[1]

        def body(static, fixed):
            attn, mu_x, x_mask, spk_e = model.align(static["x"], static["x_lengths"], static["y"],
                                                    static["y_lengths"], static.get("spks"))
            durs = attn.sum(-1)
            out = {"durations": durs}
            if "z" in static:
                out["mel"] = model.decode_mel(mu_x, durs[..., None], static["y_lengths"], x_mask, spk_e, frames,
                                              n_timesteps, static["z"])["mel"]
            return out

        inputs = {k: batch.get(k) for k in ("x", "x_lengths", "y", "y_lengths", "spks")}
        return self._run("align", (z is not None, int(n_timesteps)), dict(inputs, z=z), body)


_BY_MODEL: "weakref.WeakKeyDictionary[nn.Module, EvalGraphs]" = weakref.WeakKeyDictionary()


def graphs_for(model: nn.Module) -> EvalGraphs:
    """`model`'s ``EvalGraphs``, made at the first call and kept while the
    model lives."""
    graphs = _BY_MODEL.get(model)
    if graphs is None:
        graphs = _BY_MODEL[model] = EvalGraphs(model)
    return graphs


def existing(model: nn.Module) -> Optional[EvalGraphs]:
    """`model`'s ``EvalGraphs`` where one was made, else None."""
    return _BY_MODEL.get(model)
