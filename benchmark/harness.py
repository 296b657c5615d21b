"""The harness's shared pieces: the run record the metric readers read, the
benchmark's own spans, the traced slice and its reduction, and the loading
of a cell's files by name.

A run's record holds what the cell's traffic loop saw on the host clock (requests,
turns or batches with their times), the spans it took around its calls into
each layer, the program's counters read before and after the window, the
work of what ran inside the traced slice, and the slice's reduction: the
union of the device's activity intervals (busy), the kernels' time by name
and the idle gaps by what the host was doing.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def load_module(path: Path, name: str):
    """A module of the benchmark by file path (metric files carry dots in
    their names, which ``import`` cannot take)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


@dataclasses.dataclass
class Span:
    name: str
    t0: float
    t1: float


class Spans:
    """The benchmark's own spans, on the host clock (``time.perf_counter``)."""

    def __init__(self):
        self.items: List[Span] = []

    def add(self, name: str, t0: float, t1: float) -> None:
        self.items.append(Span(name, t0, t1))

    def timed(self, name: str, fn: Callable, *a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            self.add(name, t0, time.perf_counter())

    def named(self, name: str) -> List[Span]:
        return [s for s in self.items if s.name == name]


@dataclasses.dataclass
class Trace:
    """The reduction of a traced slice."""

    window_s: float
    busy_s: float
    kernels: Dict[str, float]  # device seconds by operation name
    gaps: List[tuple]  # (label, seconds), longest first
    work: list  # the calls made inside the slice, as records of the cell's drivers/<name>.py

    def kernel_s(self, *patterns: str) -> float:
        return sum(s for n, s in self.kernels.items() if any(p in n for p in patterns))

    def breakdown(self) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:120], s] for n, s in ops], "idle_gaps": [[l, s] for l, s in self.gaps[:10]]}


class Slice:
    """``torch.profiler`` over a slice of the window: ``start()``,
    ``stop()``, then ``reduce(label)`` once the window has closed, where
    ``label(t)`` names what the host was doing at host time t."""

    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = None
        self.work: list = []

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        with torch.profiler.record_function("bench.slice_start"):
            pass

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        with torch.profiler.record_function("bench.slice_stop"):
            pass
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)

    @property
    def active(self) -> bool:
        return self.prof is not None and self.t1 is None

    def reduce(self, label: Callable[[float], str]) -> Trace:
        import torch

        events = self.prof.events()
        marks = {e.name: e.time_range.start for e in events if e.name in ("bench.slice_start", "bench.slice_stop")}
        # the trace's clock (µs) against the host's: the two markers were taken right after t0 and before t1
        lo, hi = marks["bench.slice_start"], marks["bench.slice_stop"]
        scale = (self.t1 - self.t0) / max(hi - lo, 1e-9) if hi > lo else 1e-6

        def host(us):
            return self.t0 + (us - lo) * scale

        spans, kernels = [], {}
        for e in events:
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            a, b = max(e.time_range.start, lo), min(e.time_range.end, hi)
            if b <= a:
                continue
            spans.append((a, b))
            kernels[e.name] = kernels.get(e.name, 0.0) + (b - a) * 1e-6
        spans.sort()
        busy, gaps, cur_a, cur_b = 0.0, [], None, None
        for a, b in spans:
            if cur_a is None:
                if a > lo:
                    gaps.append((lo, a))
                cur_a, cur_b = a, b
            elif a > cur_b:
                busy += cur_b - cur_a
                gaps.append((cur_b, a))
                cur_a, cur_b = a, b
            else:
                cur_b = max(cur_b, b)
        if cur_a is None:
            gaps.append((lo, hi))
        else:
            busy += cur_b - cur_a
            if cur_b < hi:
                gaps.append((cur_b, hi))
        by_label: Dict[str, float] = {}
        for a, b in gaps:
            lab = label(host((a + b) / 2))
            by_label[lab] = by_label.get(lab, 0.0) + (b - a) * 1e-6
        window = (hi - lo) * 1e-6
        return Trace(window_s=window, busy_s=busy * 1e-6, kernels=kernels,
                     gaps=sorted(by_label.items(), key=lambda kv: -kv[1]), work=list(self.work))


def span_label(spans: Spans, default: str) -> Callable[[float], str]:
    """The innermost (latest-starting) benchmark span covering host time t."""
    items = sorted(spans.items, key=lambda s: s.t0)

    def label(t: float) -> str:
        best = None
        for s in items:
            if s.t0 > t:
                break
            if s.t1 >= t:
                best = s
        return best.name if best is not None else default
    return label


@dataclasses.dataclass
class Record:
    """What a run measured; the metric readers take it."""

    cell: str
    window_s: float
    setup_s: float
    items: list  # requests / turns / batches, dicts shaped by drivers/<name>.py
    spans: Spans
    counters: dict
    trace: Optional[Trace] = None
    extra: dict = dataclasses.field(default_factory=dict)


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` that a run may not load: JAX, its
    packages and the JAX package of this repository (whole names compared,
    so the port's ``emojivoice_tpu_torch`` is not one)."""
    bad = {"jax", "jaxlib", "flax", "emojivoice_tpu"}
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & bad)
