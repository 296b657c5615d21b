"""Seeded random weights, drawn on the device in a few large calls.

A weight spec is plain data: a list of ``(name, shape, init)`` where init is
``("normal", std)`` or ``("const", value)``.  ``draw`` turns a spec and a seed
into tensors: one ``torch.Generator`` on the device, the normal entries drawn
as a handful of flat chunks of at most ``CHUNK`` values, each cut into the
entries in spec order and scaled.  The same spec, seed and device give the same
bits, so the reference can draw again what the system under test was given
after the system has been freed.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

CHUNK = 1 << 28  # values per draw: 1 GiB of float32

Spec = List[Tuple[str, Tuple[int, ...], Tuple[str, float]]]


def numel(shape: Sequence[int]) -> int:
    return int(math.prod(shape))


def draw(spec: Spec, seed: int, device, out: Optional[Dict[str, torch.Tensor]] = None,
         dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """The spec's tensors from `seed` on `device`.  With `out` (name →
    tensor of the spec's shape), the values are written into those tensors
    in place and `out` comes back; otherwise new tensors are made."""
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    result = {} if out is None else out
    with torch.no_grad():
        for name, shape, (kind, value) in spec:
            if name not in result:
                result[name] = torch.empty(tuple(shape), dtype=dtype, device=device)
            if kind == "const":
                result[name].fill_(value)
        pending, size = [], 0
        for name, shape, (kind, value) in spec + [("", (CHUNK + 1,), ("flush", 0.0))]:
            n = numel(shape)
            if kind == "flush" or (pending and size + n > CHUNK):
                if pending:
                    flat = torch.randn(size, generator=g, device=device, dtype=torch.float32)
                    at = 0
                    for p_name, p_n, std in pending:
                        dst = result[p_name]
                        dst.view(-1).copy_(flat[at:at + p_n].mul_(std))
                        at += p_n
                    del flat
                pending, size = [], 0
            if kind == "normal":
                pending.append((name, n, float(value)))
                size += n
    return result
