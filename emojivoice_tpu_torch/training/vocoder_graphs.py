"""Captured CUDA graphs for the vocoder's GAN step, one per batch shape: the
port's counterpart of the JAX package's ``jax.jit`` of its vocoder step
(``emojivoice_tpu/training/vocoder_train.py``), which compiles once per
batch shape.

``VocoderGraphs(state).step(batch)`` takes one alternating step and returns
its five metrics, as ``training/vocoder_train.py::vocoder_train_step`` does
(which calls it by default on the card):

* **On the card**, through one ``torch.cuda.CUDAGraph`` per key, the batch's
  (B, T_mel, T_wav) and the inputs' signature.  A graph holds the whole
  ``vocoder_train.step_body``: the generator's forward, the discriminator
  loss, its backward and the discriminators' Adam, the generator loss
  against the updated discriminators (their parameters frozen while it is
  recorded, as in the eager step), its backward and the generator's Adam.
  The step draws nothing at random (the crops are the sampler's, on the
  host).  The first step at a key is the real step, run eagerly as the warm
  run before the capture (``utils/cuda_graphs.py::GraphCache.capture_graph``);
  it also makes what a capture cannot: both Adams' state, the loss mel's
  filterbank on the device (``ops/mel.py``), the cuFFT plans and cuDNN's
  choices.  Then the key is captured without being run; the step sets each
  optimizer's gradients to None before its backward, so that inside the
  capture the graph makes its own gradients.  A later
  step at the key copies ``mel`` and ``wav`` into the key's static buffers,
  replays, and copies the five metrics out.  A failed capture raises; no
  step carries on eagerly.
* **On the CPU**, where there is nothing to capture: the same keys, static
  buffers and invalidation, with the body run on the buffers every step, so
  that the CPU tests exercise the staging.

Both Adams are ``capturable`` on the card (``create_vocoder_state``): their
step counts and bias corrections live on the device, so a replay computes
this step's update and not the one of its capture.  The weight-norm
generator's ``g · v / ‖v‖`` is recomputed inside the graph on every replay
from the parameters' memory, which the graph's own Adam writes.

**Memory.** All keys of a state share one pool (a new one after a drop).
The static inputs, the outputs and what the step keeps (parameters, both
Adams' state) lie outside the pool or are held for the graph's life; what a
key keeps only within its step (activations, gradients) may lie where
another key does the same, which is safe because the graphs replay one at a
time and the outputs are copied out at once.

**Invalidation**, as ``training/graphs.py::TrainGraphs``: a
``load_state_dict`` of either optimizer drops the graphs (a hook on each),
and so does a parameter of ``gen``, ``mpd`` or ``msd`` replaced by another
object (looked for after any module registration in the process).  A
replay writes the parameters without moving their autograd version, so
every replay bumps it: ``fold_weight_norm`` and any cache stamped on (data
pointer, version) see the new weights.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from emojivoice_tpu_torch.training.vocoder_train import VocoderTrainState, step_body
from emojivoice_tpu_torch.utils.cuda_graphs import StepGraphs, copy_in, signature, static_buffer

INPUTS = ("mel", "wav")


@dataclasses.dataclass
class _Step:
    graph: Any  # torch.cuda.CUDAGraph; None on the CPU
    batch: dict  # static inputs
    out: dict  # the capture's outputs (empty on the CPU)
    first_ms: float  # the key's first step, eager, host ms to its end on the device
    capture_ms: float
    replays: int = 0


class VocoderGraphs(StepGraphs):
    """Batch shape → captured GAN step with its static buffers (the module
    docstring; the pool, the keys, the capture, the weak reference to the
    state and the drops are ``utils/cuda_graphs.py::StepGraphs``'), for one
    ``VocoderTrainState`` on one device without a mesh."""

    def __init__(self, state: VocoderTrainState):
        if state.mesh is not None:
            raise ValueError("VocoderGraphs: a state over a mesh trains eagerly (its collectives are not captured)")
        optimizers = (state.gen_opt, state.disc_opt)
        if state.device.type == "cuda" and not all(g.get("capturable") for opt in optimizers
                                                   for g in opt.param_groups):
            raise ValueError("VocoderGraphs: the Adams are not capturable (create_vocoder_state makes them so on the "
                             "card without a mesh)")
        super().__init__(state, optimizers)

    def _weights(self) -> list:
        state = self.state
        return [p for m in (state.gen, state.mpd, state.msd) for p in m.parameters()]

    @staticmethod
    def key(batch: dict) -> tuple:
        """(B, T_mel, T_wav)."""
        b, t_mel = batch["mel"].shape[:2]
        return b, t_mel, batch["wav"].shape[1]

    def step(self, batch: dict) -> dict:
        """One GAN step of the state on `batch` → the five metrics as 0-d
        tensors the caller owns (``vocoder_train_step``'s)."""
        state = self.state
        self.drop_replaced()
        full = (self.key(batch), tuple(signature(batch[k]) for k in INPUTS))
        g = self._graphs.get(full)
        if g is None:
            g, out = self._build(batch)
            self._graphs[full] = g
        else:
            copy_in([g.batch[k] for k in INPUTS], [batch[k] for k in INPUTS])
            if g.graph is None:
                out = step_body(state, g.batch)
            else:
                g.graph.replay()
                out = {k: v.clone() for k, v in g.out.items()}
                self.replayed()
            g.replays += 1
        state.step += 1
        return out

    def _build(self, batch: dict):
        """The key's static buffers and its first step; on the card the real
        step as the warm run, then the capture → (the step, its metrics)."""
        state = self.state
        static = {k: static_buffer(batch[k], self.device) for k in INPUTS}
        copy_in([static[k] for k in INPUTS], [batch[k] for k in INPUTS])

        def first():
            out = step_body(state, static)
            if self.capture:
                torch.cuda.synchronize(self.device)  # first_ms: to the step's end on the device
            return out

        if not self.capture:
            return _Step(None, static, {}, 0.0, 0.0), first()
        graph, out, static_out, first_ms, capture_ms = self.capture_graph(first, lambda: step_body(state, static))
        return _Step(graph, static, static_out, first_ms, capture_ms), out
