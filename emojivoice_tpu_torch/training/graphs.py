"""Captured CUDA graphs for the acoustic model's training step, one per
bucket key: the port's counterpart of ``make_train_step``'s
``jax.jit(step_fn)`` (``emojivoice_tpu/training/state.py``), which the JAX
trainer compiles once per batch shape.

``TrainGraphs(state).step(batch, seed, precision)`` takes one optimizer step
and returns its metrics, as ``training/state.py::train_step`` does (which
calls it by default on the card):

* **On the card**, through one ``torch.cuda.CUDAGraph`` per key: the batch's
  (B, T_text, T_mel), the precision, whether the segment crop applies and
  which of ``spks``, ``durations`` and ``row_mask`` the batch carries.  A
  graph holds the whole ``state.step_body``: the forward with K2 inside, the
  backward, the global-norm clip and Adam.  The first step at a key is the
  real step, run eagerly as the warm run before the capture
  (``utils/cuda_graphs.py::GraphCache.capture_graph``); it also makes what a capture
  cannot (Adam's state, K2's build, the RoPE tables, first allocations).
  Then the key is captured without being run, its gradients set to None
  first so that the graph owns its own.  A later step at the key copies the
  batch into the key's static buffers, draws ``t``, ``z`` and the crop
  uniforms from their ``(seed, step)`` generators straight into static
  buffers, fills the optimizer's learning-rate tensor, seeds the default
  CUDA generator with the step's dropout seed (a replay reads that
  generator's seed and offset, so its masks are the eager step's) and
  replays.  A failed capture raises; no step carries on eagerly.
* **On the CPU**, where there is nothing to capture: the same keys, static
  buffers and invalidation, with the body run on the buffers every step, so
  that the CPU tests exercise the staging.

**Outputs** are copied out of the graph's memory right after its replay:
the trainer reads a step's metrics one step late, after the next replay has
run.  Gradients stay in the graph's memory and nothing outside the graph
reads them; the gradient norm comes out as a metric.

**Memory.** All keys of a state share one pool (a new one after a drop).
A graph's static inputs, draws and outputs, and everything the step keeps (parameters, Adam's state,
the rate), are allocated outside the pool or held for the graph's life, so
a later capture never places its tensors there.  What one key keeps only
within its step (activations, gradients) may lie where another key does the
same, which is safe because the graphs replay one at a time and the outputs
are copied out at once.

**Invalidation.** A graph reads the parameters', Adam's and the rate's
tensors as they were at its capture.  ``optimizer.load_state_dict`` replaces
Adam's state and the rate (``TrainState.load_state_dict``, a resume,
``io/from_jax.py``'s Adam), so every optimizer load drops the graphs (a hook
on the optimizer), and so do ``load_sharded_state_dict`` and a parameter or
buffer of the model replaced by another object
(``load_state_dict(assign=True)``; looked for after any registration in the
process).  A replay writes the parameters and the conformer's BatchNorm
buffers without moving their autograd version, so every replay
bumps it: a cache stamped on (data pointer, version), as the serving
graphs' ``weights_stamp`` of a render pipeline on the live model, sees the
new weights.

**K2's launch counter** (``ops.mas.launches``): the wrapper counts when it
runs, in the first step and while the graph is captured, never when it
replays.  The capture's count is taken back out (it is the graph's build,
like a compile) and added on every replay, so a step counts one launch
whether it ran eagerly or from a graph.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from emojivoice_tpu_torch.ops import mas
from emojivoice_tpu_torch.training.state import TrainState, dropout_seed, set_lr_, step_body, step_draws
from emojivoice_tpu_torch.utils.cuda_graphs import StepGraphs, copy_in, signature, static_buffer

# the batch entries the step reads; the last three are optional and part of the key
INPUTS = ("x", "x_lengths", "y", "y_lengths", "spks", "durations", "row_mask")
OPTIONAL = INPUTS[4:]


@dataclasses.dataclass
class _Step:
    graph: Any  # torch.cuda.CUDAGraph; None on the CPU
    batch: dict  # static inputs
    draws: dict  # static draws
    out: dict  # the capture's outputs (empty on the CPU)
    k2: int  # K2 launches the capture recorded: what one replay launches
    first_ms: float  # the key's first step, eager, host ms to its end on the device
    capture_ms: float
    replays: int = 0


class TrainGraphs(StepGraphs):
    """Bucket key → captured train step with its static buffers (the module
    docstring; the pool, the keys, the capture, the weak reference to the
    state and the drops are ``utils/cuda_graphs.py::StepGraphs``'), for one
    ``TrainState`` on one device without a mesh."""

    def __init__(self, state: TrainState):
        if state.mesh is not None:
            raise ValueError("TrainGraphs: a state over a mesh trains eagerly (its collectives are not captured)")
        if state.device.type == "cuda" and not all(g.get("capturable") for g in state.optimizer.param_groups):
            raise ValueError("TrainGraphs: the optimizer is not capturable (create_train_state makes it so on the "
                             "card without a mesh)")
        super().__init__(state, (state.optimizer,))
        self._rng_devices = [self.device] if self.capture else []  # the generators a step forks

    def _weights(self) -> list:
        return list(self.state.model.parameters()) + list(self.state.model.buffers())

    def key(self, batch: dict, precision: Optional[str]) -> tuple:
        """(B, T_text, T_mel, precision, crop, the optional entries present)."""
        b, t_text = batch["x"].shape
        t_mel = batch["y"].shape[1]
        out_size = self.state.model.cfg.out_size
        return (b, t_text, t_mel, precision, out_size is not None and out_size < t_mel,
                tuple(k for k in OPTIONAL if k in batch))

    def step(self, batch: dict, seed: int, precision: Optional[str] = "f32") -> dict:
        """One optimizer step of the state on `batch` → metrics as 0-d
        tensors the caller owns (``train_step``'s)."""
        state = self.state
        self.drop_replaced()
        names = [k for k in INPUTS if k in batch]
        full = (self.key(batch, precision), tuple((k, signature(batch[k])) for k in names))
        lr = state.schedule(state.step)
        state.model.train()
        g = self._graphs.get(full)
        if g is None:
            g, out = self._build(batch, names, seed, precision, lr)
            self._graphs[full] = g
        else:
            copy_in([g.batch[k] for k in names], [batch[k] for k in names])
            step_draws(state, g.batch, seed, out=g.draws)
            set_lr_(state.optimizer, lr)
            with torch.random.fork_rng(devices=self._rng_devices):
                torch.manual_seed(dropout_seed(state, seed))
                if g.graph is None:
                    out = step_body(state, g.batch, g.draws, precision)
                else:
                    g.graph.replay()
                    out = {k: v.clone() for k, v in g.out.items()}
            if g.graph is not None:
                mas.add_launches(g.k2)
                self.replayed()
            g.replays += 1
        state.step += 1
        return {**out, "lr": torch.tensor(lr)}

    def _build(self, batch: dict, names: list, seed: int, precision: Optional[str], lr: float):
        """The key's static buffers and its first step; on the card the real
        step as the warm run, then the capture → (the step, its metrics)."""
        state = self.state
        static = {k: static_buffer(batch[k], self.device) for k in names}
        copy_in([static[k] for k in names], [batch[k] for k in names])
        draws = step_draws(state, static, seed)
        set_lr_(state.optimizer, lr)

        def first():
            with torch.random.fork_rng(devices=self._rng_devices):
                torch.manual_seed(dropout_seed(state, seed))
                out = step_body(state, static, draws, precision)
            if self.capture:
                torch.cuda.synchronize(self.device)  # first_ms: to the step's end on the device
                counted[0] = 0  # the first step's launch was a step's; what the capture records is the graph's build
                state.optimizer.zero_grad(set_to_none=True)  # so that the graph owns its gradients
            return out

        if not self.capture:
            return _Step(None, static, draws, {}, 0, 0.0, 0.0), first()
        with mas.tally() as counted:
            try:
                graph, out, static_out, first_ms, capture_ms = self.capture_graph(
                    first, lambda: step_body(state, static, draws, precision))
            finally:
                mas.add_launches(-counted[0])
        return _Step(graph, static, draws, static_out, counted[0], first_ms, capture_ms), out
