"""Captured CUDA graphs for serving, one per stage and bucket key: the
port's counterpart of the JAX pipeline's ``_get_stage_a``, ``_get_stage_b``
and ``_get_fused`` (``emojivoice_tpu/inference/pipeline.py``), which compile
one program per key.

``GraphStore.run(key, fn, inputs, weights)`` computes the stage
``fn(*inputs)`` → a tuple of tensors (or None):

* **On the card**, through one ``torch.cuda.CUDAGraph`` per key and input
  signature (the inputs' shapes and dtypes), captured at the key's first use,
  as the reference compiles at first use, and replayed from static buffers
  after that: a stage of a few hundred to a few thousand kernels becomes one
  graph launch.  Before the capture, one warm eager run on a side stream
  (one per device for the process, ``side_stream``) does what a capture
  cannot: allocations, cuFFT plans, the istft envelope and the RoPE tables
  (``ops/``), K1's build (``kernels/build.py``) and its packed weights
  (``HiFiGANGenerator.stage_weights``).  A failed capture raises; no
  call carries on eagerly.
* **On the CPU**, where there is nothing to capture: the same keys, static
  buffers and invalidation, with ``fn`` run on the buffers each call, so that
  the CPU tests exercise the staging code.  The mode comes from the device
  the store was made for and from nothing else.

An input is a tensor (copied into the key's static buffer), a Python float
(a 0-d f32 buffer filled with it: a runtime value such as ``length_scale`` or
``denoiser_strength``, never a constant baked into the graph) or None.  The
outputs are copied out of the graph's memory right after its replay: the
caller owns them, and no later replay of any graph can overwrite them.

**Memory.** All graphs of a store share one pool (``graph_pool_handle``;
a new one after ``drop``; the pool, keys, capture and registration watch are
``utils/cuda_graphs.py``'s, shared with the training graphs).
Each graph keeps its static inputs (allocated outside the pool) and its
static outputs for its lifetime, so a later capture never places its
tensors in memory that an earlier graph writes.  A later capture's outputs
may lie where an earlier graph keeps intermediates; copying each graph's
outputs out before any other graph replays is what makes that safe.

**Weights.** A graph reads its weights' memory as it was at capture, and
``stage_weights`` repacks K1's weights into new tensors when a parameter
changes.  So each run compares the stamp (data pointer, version) of the
stage's weight tensors with the one taken at capture; on a change every graph
of the store is dropped and the key is captured anew: loading a checkpoint
into a live pipeline serves the new weights.  (In the reference, parameters
are arguments of the compiled function, and the case does not arise.)

**K1's launch counter** (``ops.mrf.launches``): the wrapper counts when it
runs, i.e. in the warm run and while the graph is captured, never when the
graph replays.  The store takes what the warm run and the capture counted
back out of ``launches`` (the graph's build, like a compile; the warm run's
real launches are kept in ``build_launches``) and adds the capture's count
to ``launches`` on every replay, so a call counts one launch per
``mrf_stage`` whether it ran eagerly or from a graph.

**Threads.** One lock per store serializes copy in, replay and copy out (the
pipeline holds it across a whole call, whose stages pass outputs on), and one
lock per process serializes captures: CUDA takes one capture at a time.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Callable, Hashable, Iterable, Sequence

import torch

from emojivoice_tpu_torch.ops import mrf
from emojivoice_tpu_torch.utils.cuda_graphs import (GraphCache, copy_in, registrations, signature, static_buffer,
                                                    weight_tensors, weights_stamp)


def _as_tuple(out) -> tuple:
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


@dataclasses.dataclass
class _Graph:
    graph: Any  # torch.cuda.CUDAGraph; None on the CPU
    static_in: list
    static_out: tuple
    stamp: tuple
    k1: collections.Counter  # K1 launches the capture recorded: what one replay launches
    capture_ms: float
    replays: int = 0


class GraphStore(GraphCache):
    """Key → captured graph with its static inputs and outputs (the module
    docstring; the pool, the keys and the capture are
    ``utils/cuda_graphs.py::GraphCache``'s).  `keep_graphs` keeps each
    graph's ``cudaGraph_t`` after its instantiation so that its nodes can be
    read (``kernels/launches.py::graph_kernel_nodes``)."""

    def __init__(self, device, keep_graphs: bool = False):
        super().__init__(device)
        self.keep_graphs = keep_graphs
        self._weights: dict = {}  # ids of the items → (the items, registrations then, their tensors)
        self.build_launches: collections.Counter = collections.Counter()

    def _stamp(self, weights: tuple) -> tuple:
        """``weights_stamp`` of `weights`' tensors, listed once and again only
        after a registration: walking a model's modules costs about a
        millisecond a call on a host CPU, reading the stamp a tenth of it."""
        ident = tuple(map(id, weights))  # the cache holds the objects: no id is reused while it is a key
        cached = self._weights.get(ident)
        seen = registrations()
        if cached is None or cached[1] != seen:
            cached = (weights, seen, weight_tensors(weights))
            self._weights[ident] = cached
        return weights_stamp(cached[2])

    def run(self, key: Hashable, fn: Callable, inputs: Sequence, weights: Iterable = ()) -> tuple:
        """``fn(*inputs)`` through the graph of (`key`, the inputs' signature),
        captured first if it is new or if `weights` changed since its
        capture; → fn's outputs as a tuple (copies the caller owns)."""
        full = (key, tuple(signature(a) for a in inputs))
        with self.lock:
            stamp = self._stamp(tuple(weights))
            g = self._graphs.get(full)
            if g is not None and g.stamp != stamp:
                self.drop()  # new weights: every graph may read them (stage_weights' packs among them)
                g = None
            if g is None:
                g = self._build(fn, inputs, stamp)
                self._graphs[full] = g
            copy_in(g.static_in, inputs)
            if g.graph is None:
                with torch.no_grad():
                    out = _as_tuple(fn(*g.static_in))
            else:
                g.graph.replay()
                mrf.add_launches(g.k1)
                out = tuple(None if o is None else o.clone() for o in g.static_out)
            g.replays += 1
            return out

    def _build(self, fn, inputs, stamp) -> _Graph:
        static_in = [static_buffer(a, self.device) for a in inputs]
        copy_in(static_in, inputs)
        if not self.capture:
            return _Graph(None, static_in, (), stamp, collections.Counter(), 0.0)

        def warm():
            with torch.no_grad():
                fn(*static_in)
            return collections.Counter(counted)  # the warm run's launches

        def body():
            with torch.no_grad():
                return _as_tuple(fn(*static_in))

        with mrf.tally() as counted:
            try:
                graph, warm_only, static_out, warm_ms, capture_ms = self.capture_graph(warm, body, self.keep_graphs)
            finally:
                # what the warm run launched and the capture recorded is the graph's build, no call's launches
                mrf.add_launches(counted, -1)
        self.build_launches.update(warm_only)
        return _Graph(graph, static_in, static_out, stamp, counted - warm_only, warm_ms + capture_ms)
