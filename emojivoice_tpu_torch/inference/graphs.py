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
  graph launch.  Before the capture, one warm eager run on a side stream does
  what a capture cannot: allocations, cuFFT plans, the istft envelope and the
  RoPE tables (``ops/``), K1's build (``kernels/build.py``) and its packed
  weights (``HiFiGANGenerator.stage_weights``).  A failed capture raises; no
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

**Memory.** All graphs of a store share one pool (``graph_pool_handle``).
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
import threading
import time
from typing import Any, Callable, Hashable, Iterable, Optional, Sequence

import torch
import torch.nn as nn

from emojivoice_tpu_torch.ops import mrf

_CAPTURE_LOCK = threading.Lock()
# modules' parameter, buffer and submodule registrations so far, in any module of the process: a module's cached
# list of weight tensors is collected anew after one (a parameter replaced by another object, as
# ``load_state_dict(assign=True)`` does); a write into a tensor moves its stamp instead
_registrations = 0
_HOOKS: list = []


def _registered(*_) -> None:
    global _registrations
    _registrations += 1


def _watch_registrations() -> None:
    if not _HOOKS:
        _HOOKS.extend(hook(_registered) for hook in (
            nn.modules.module.register_module_parameter_registration_hook,
            nn.modules.module.register_module_buffer_registration_hook,
            nn.modules.module.register_module_module_registration_hook))


def weight_tensors(items: Iterable) -> list:
    """The tensors a stage reads as weights: each module's parameters and
    buffers, and each tensor as it is."""
    out = []
    for item in items:
        if isinstance(item, nn.Module):
            out.extend(item.parameters())
            out.extend(item.buffers())
        elif item is not None:
            out.append(item)
    return out


def weights_stamp(tensors: Iterable[torch.Tensor]) -> tuple:
    """(data pointer, version) of every tensor: moves when its storage is
    replaced (``.data =``, ``.to``) or written in place (``load_state_dict``,
    ``copy_``)."""
    return tuple((t.data_ptr(), t._version) for t in tensors)


def _signature(a) -> Hashable:
    if a is None:
        return None
    if isinstance(a, float):
        return "float"
    return tuple(a.shape), a.dtype


def _static_buffer(a, device: torch.device):
    if a is None:
        return None
    if isinstance(a, float):
        return torch.zeros((), dtype=torch.float32, device=device)
    return torch.empty(a.shape, dtype=a.dtype, device=device)


def _copy_in(static: Sequence, inputs: Sequence) -> None:
    for dst, src in zip(static, inputs):
        if dst is None:
            continue
        if isinstance(src, float):
            dst.fill_(src)  # a kernel argument: no host-to-device copy
        else:
            dst.copy_(src, non_blocking=True)


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


class GraphStore:
    """Key → captured graph with its static inputs and outputs (the module
    docstring).  `keep_graphs` keeps each graph's ``cudaGraph_t`` after its
    instantiation so that its nodes can be read
    (``kernels/launches.py::graph_kernel_nodes``)."""

    def __init__(self, device, keep_graphs: bool = False):
        self.device = torch.device(device)
        self.capture = self.device.type == "cuda"
        self.keep_graphs = keep_graphs
        self.lock = threading.RLock()
        self.pool = torch.cuda.graph_pool_handle() if self.capture else None
        self._graphs: dict = {}
        self._weights: dict = {}  # ids of the items → (the items, registrations then, their tensors)
        _watch_registrations()
        self.build_launches: collections.Counter = collections.Counter()
        self.captures = 0
        self.drops = 0

    def keys(self) -> list:
        """The stage keys held, without their input signatures."""
        return [key for key, _ in self._graphs]

    def entries(self) -> dict:
        """(key, input signature) → the held graph and its buffers."""
        return dict(self._graphs)

    def drop(self) -> None:
        """Forget every graph (their memory goes back to the pool)."""
        with self.lock:
            if self._graphs:
                self.drops += 1
            self._graphs.clear()

    def stats(self) -> dict:
        with self.lock:
            return dict(graphs=len(self._graphs), captures=self.captures, drops=self.drops,
                        replays=sum(g.replays for g in self._graphs.values()),
                        capture_ms={repr(k): g.capture_ms for (k, _), g in self._graphs.items()})

    def pool_bytes(self) -> Optional[int]:
        """Bytes of the device segments that the store's pool holds (None on
        the CPU, or where the allocator's snapshot does not name pools)."""
        if not self.capture:
            return None
        segments = torch.cuda.memory_snapshot()
        if any("segment_pool_id" not in seg for seg in segments):
            return None
        return sum(seg["total_size"] for seg in segments if tuple(seg["segment_pool_id"]) == tuple(self.pool))

    def _stamp(self, weights: tuple) -> tuple:
        """``weights_stamp`` of `weights`' tensors, listed once and again only
        after a registration: walking a model's modules costs about a
        millisecond a call on a host CPU, reading the stamp a tenth of it."""
        ident = tuple(map(id, weights))  # the cache holds the objects: no id is reused while it is a key
        cached = self._weights.get(ident)
        if cached is None or cached[1] != _registrations:
            cached = (weights, _registrations, weight_tensors(weights))
            self._weights[ident] = cached
        return weights_stamp(cached[2])

    def run(self, key: Hashable, fn: Callable, inputs: Sequence, weights: Iterable = ()) -> tuple:
        """``fn(*inputs)`` through the graph of (`key`, the inputs' signature),
        captured first if it is new or if `weights` changed since its
        capture; → fn's outputs as a tuple (copies the caller owns)."""
        full = (key, tuple(_signature(a) for a in inputs))
        with self.lock:
            stamp = self._stamp(tuple(weights))
            g = self._graphs.get(full)
            if g is not None and g.stamp != stamp:
                self.drop()  # new weights: every graph may read them (stage_weights' packs among them)
                g = None
            if g is None:
                g = self._build(full, fn, inputs, stamp)
                self._graphs[full] = g
            _copy_in(g.static_in, inputs)
            if g.graph is None:
                with torch.no_grad():
                    out = _as_tuple(fn(*g.static_in))
            else:
                g.graph.replay()
                mrf.add_launches(g.k1)
                out = tuple(None if o is None else o.clone() for o in g.static_out)
            g.replays += 1
            return out

    def _build(self, full, fn, inputs, stamp) -> _Graph:
        static_in = [_static_buffer(a, self.device) for a in inputs]
        _copy_in(static_in, inputs)
        if not self.capture:
            return _Graph(None, static_in, (), stamp, collections.Counter(), 0.0)
        t = time.perf_counter()
        with _CAPTURE_LOCK, mrf.tally() as warm, mrf.tally() as k1:
            try:
                here = torch.cuda.current_stream(self.device)
                side = torch.cuda.Stream(self.device)
                side.wait_stream(here)
                with torch.cuda.stream(side), torch.no_grad():
                    fn(*static_in)
                here.wait_stream(side)
                warm_only = collections.Counter(warm)
                k1.clear()
                graph = torch.cuda.CUDAGraph(keep_graph=self.keep_graphs)
                with torch.cuda.graph(graph, pool=self.pool), torch.no_grad():
                    static_out = _as_tuple(fn(*static_in))
                if self.keep_graphs:
                    graph.instantiate()
            finally:
                # what the warm run launched and the capture recorded is the graph's build, no call's launches
                mrf.add_launches(warm, -1)
            self.build_launches.update(warm_only)
        self.captures += 1
        return _Graph(graph, static_in, static_out, stamp, collections.Counter(k1),
                      (time.perf_counter() - t) * 1e3)
