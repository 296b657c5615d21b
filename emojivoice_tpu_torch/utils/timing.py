"""Stage timing for the pipeline and the trainer."""

from __future__ import annotations

import time

import torch


class StageClock:
    """Marks the end of each stage: CUDA events on the card, the host clock on
    the CPU (where every op has finished when it returns)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []
        self.mark("start")

    def mark(self, name: str):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append((name, ev))
        else:
            self.marks.append((name, time.perf_counter()))

    def elapsed_ms(self) -> dict:
        out = {}
        for (_, a), (name, b) in zip(self.marks, self.marks[1:]):
            out[name] = a.elapsed_time(b) if self.cuda else (b - a) * 1e3
        return out
