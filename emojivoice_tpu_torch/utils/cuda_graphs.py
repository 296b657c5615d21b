"""Captured CUDA graphs held by key: what the serving graphs
(``inference/graphs.py::GraphStore``, one graph per stage and bucket key)
and the training graphs (``training/graphs.py::TrainGraphs``, one per bucket
key of the train step) share.

``GraphCache`` holds (key, input signature) → an entry with its ``graph``
(None on the CPU), ``capture_ms`` and ``replays``, and one memory pool for
all of them (a new one after ``drop``: the allocator refuses a new capture
into a pool whose graphs are all gone).  ``GraphCache.capture_graph(warm,
body)`` runs ``warm()`` eagerly on the device's side stream, which does what a
capture cannot (allocations, kernel builds, cached tables, first optimizer
state), then captures ``body()`` into a new graph without running it, in
the ``"thread_local"`` error mode with the cycle collector off (the method
says why).  A failed capture raises.  The owner copies the inputs into
static buffers (``static_buffer``, ``copy_in``), replays, copies the
outputs out at once, and takes what its kernels' launch counters counted
while capturing back out: a counter counts when its wrapper runs, never when
a graph replays.

A graph reads its weights' memory as it was at its capture.  A write moves a
tensor's stamp (``weights_stamp``); a parameter or buffer replaced by
another object shows as a module registration anywhere in the process
(``registrations``), after which the owner lists its weight tensors anew.

``StepGraphs`` is the part the training steps' caches share
(``training/graphs.py::TrainGraphs``, ``training/vocoder_graphs.py::
VocoderGraphs``): the state held by a weak reference, a drop on every load
of its optimizers and on a weight replaced by another object, and the
autograd versions of the weights a replay wrote moved after it.
"""

from __future__ import annotations

import gc
import threading
import time
import weakref
from typing import Any, Callable, Hashable, Iterable, Optional, Sequence

import torch
import torch.nn as nn

# CUDA takes one capture at a time in a process
CAPTURE_LOCK = threading.Lock()
_SIDE_STREAMS: dict = {}  # CUDA device → the stream of every warm run before a capture there (under CAPTURE_LOCK)
_registrations = 0
_HOOKS: list = []


def _registered(*_) -> None:
    global _registrations
    _registrations += 1


def registrations() -> int:
    """Modules' parameter, buffer and submodule registrations so far, in any
    module of the process, counted from this function's first call: a cached
    list of a module's weight tensors is collected anew after one (a
    parameter replaced by another object, as ``load_state_dict(assign=True)``
    does); a write into a tensor moves its stamp instead."""
    if not _HOOKS:
        _HOOKS.extend(hook(_registered) for hook in (
            nn.modules.module.register_module_parameter_registration_hook,
            nn.modules.module.register_module_buffer_registration_hook,
            nn.modules.module.register_module_module_registration_hook))
    return _registrations


def weight_tensors(items: Iterable) -> list:
    """The tensors a graph reads as weights: each module's parameters and
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


def side_stream(device: torch.device):
    """The stream that the warm run before a capture takes: one per CUDA
    device for the process.  cuBLAS keeps a workspace for every stream it
    runs on (32 MiB under ``CUBLAS_WORKSPACE_CONFIG=:4096:8``) and never
    frees it, so a new stream for every capture would leave one behind each
    time.  Used under ``CAPTURE_LOCK`` only."""
    if device.type != "cuda":
        return torch.cuda.Stream(device)
    if device not in _SIDE_STREAMS:
        _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return _SIDE_STREAMS[device]


def pool_bytes(pool) -> Optional[int]:
    """Bytes of the device segments that a graph memory pool holds (None
    where the allocator's snapshot does not name pools)."""
    segments = torch.cuda.memory_snapshot()
    if any("segment_pool_id" not in seg for seg in segments):
        return None
    return sum(seg["total_size"] for seg in segments if tuple(seg["segment_pool_id"]) == tuple(pool))


def signature(a) -> Hashable:
    """An input's part of a graph's key: shape and dtype of a tensor."""
    if a is None:
        return None
    if isinstance(a, float):
        return "float"
    return tuple(a.shape), a.dtype


def static_buffer(a, device: torch.device):
    """A graph's static input for `a`: a tensor of its shape and dtype, or
    a 0-d f32 tensor for a Python float."""
    if a is None:
        return None
    if isinstance(a, float):
        return torch.zeros((), dtype=torch.float32, device=device)
    return torch.empty(a.shape, dtype=a.dtype, device=device)


def copy_in(static: Sequence, inputs: Sequence) -> None:
    """Copy `inputs` into their static buffers."""
    for dst, src in zip(static, inputs):
        if dst is None:
            continue
        if isinstance(src, float):
            dst.fill_(src)  # a kernel argument: no host-to-device copy
        else:
            dst.copy_(src, non_blocking=True)


class GraphCache:
    """(key, input signature) → an entry holding ``graph``, ``capture_ms``
    and ``replays``, with one memory pool for all of them (the module
    docstring).  On the CPU nothing is captured, and the owner runs its
    function on the entry's static buffers instead of replaying."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.capture = self.device.type == "cuda"
        self.lock = threading.RLock()
        self.pool = torch.cuda.graph_pool_handle() if self.capture else None
        self._graphs: dict = {}
        self.captures = 0
        self.drops = 0
        registrations()

    def keys(self) -> list:
        """The keys held, without their input signatures."""
        return [key for key, _ in self._graphs]

    def entries(self) -> dict:
        """(key, input signature) → the held entry and its buffers."""
        return dict(self._graphs)

    def drop(self) -> None:
        """Forget every graph, and their pool: the next capture takes a new
        one."""
        with self.lock:
            if self._graphs:
                self.drops += 1
            self._graphs.clear()
            self.pool = torch.cuda.graph_pool_handle() if self.capture else None

    def stats(self) -> dict:
        """Graphs, captures, drops, replays, and the capture ms of each key."""
        with self.lock:
            return dict(graphs=len(self._graphs), captures=self.captures, drops=self.drops,
                        replays=sum(g.replays for g in self._graphs.values()),
                        capture_ms={repr(k): g.capture_ms for (k, _), g in self._graphs.items()})

    def pool_bytes(self) -> Optional[int]:
        """Bytes of the device segments that the pool holds (None on the CPU,
        or where the allocator's snapshot does not name pools)."""
        return pool_bytes(self.pool) if self.capture else None

    def capture_graph(self, warm: Callable[[], Any], body: Callable[[], Any], keep_graph: bool = False) -> tuple:
        """`warm()` run eagerly on the device's side stream, then `body()`
        captured into a new graph in the pool without being run → (the graph,
        warm's result, body's result: the graph's static outputs, warm's host
        ms, the capture's host ms).  `keep_graph` keeps the ``cudaGraph_t``
        after instantiation so that its nodes can be read.

        Two things end a capture in progress, and it then raises at its end.
        One is a call made by another thread in the default ``"global"``
        error mode: an event's ``synchronize``, ``query`` or
        ``elapsed_time``, a pinned or a device allocation.  The serving
        engine's results thread makes such calls on one batch while its
        worker captures the next batch's key.  So the capture takes the
        ``"thread_local"`` mode, which allows them in other threads (not
        ``torch.cuda.synchronize``, which ends the capture in either mode).
        The other is a graph freed in the capturing thread during the
        capture, as the cycle collector does when it runs there and finds a
        dead object cycle that holds a graph.  So the collector is off
        during the capture."""
        with CAPTURE_LOCK:
            t = time.perf_counter()
            here = torch.cuda.current_stream(self.device)
            side = side_stream(self.device)
            side.wait_stream(here)
            with torch.cuda.stream(side):
                warmed = warm()
            here.wait_stream(side)
            warm_ms = (time.perf_counter() - t) * 1e3
            t = time.perf_counter()
            graph = torch.cuda.CUDAGraph(keep_graph=keep_graph)
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(graph, pool=self.pool, capture_error_mode="thread_local"):
                    static_out = body()
            finally:
                if collecting:
                    gc.enable()
            if keep_graph:
                graph.instantiate()
            capture_ms = (time.perf_counter() - t) * 1e3
        self.captures += 1
        return graph, warmed, static_out, warm_ms, capture_ms


class StepGraphs(GraphCache):
    """A ``GraphCache`` of captured optimizer steps for one training state,
    which it holds by a weak reference (the state holds the cache, and a
    cycle would keep a dropped state's graphs and their pool until the
    cycle collector ran).  A replay writes the weights (``_weights()``, the
    owner's list) and its optimizers' state in place: every load of
    `optimizers` drops the graphs, so does a weight replaced by another
    object (``drop_replaced``, called before each step), and ``replayed``
    bumps the weights' autograd versions after a replay, which the replay
    itself does not, so that a cache stamped on (data pointer, version)
    sees the new weights."""

    def __init__(self, state, optimizers: Sequence):
        super().__init__(state.device)
        self._state = weakref.ref(state)
        self._seen_registrations = registrations()
        self._written = self._weights()
        for opt in optimizers:
            opt.register_load_state_dict_post_hook(lambda optimizer: self.drop())

    @property
    def state(self):
        return self._state()

    def _weights(self) -> list:
        raise NotImplementedError

    def drop(self) -> None:
        super().drop()
        self._written = self._weights()

    def drop_replaced(self) -> None:
        """Drop the graphs if a weight was replaced by another object since
        they were listed (looked for after any registration in the process)."""
        if registrations() != self._seen_registrations:
            self._seen_registrations = registrations()
            weights = self._weights()
            if len(weights) != len(self._written) or any(a is not b for a, b in zip(weights, self._written)):
                self.drop()

    def replayed(self) -> None:
        torch.autograd.graph.increment_version(self._written)

    def stats(self) -> dict:
        """``GraphCache.stats`` and per key the first step's host ms."""
        return dict(super().stats(), first_step_ms={repr(k): g.first_ms for (k, _), g in self._graphs.items()})
