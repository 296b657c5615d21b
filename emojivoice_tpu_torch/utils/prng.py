"""Seeded synthesis noise from explicit ``torch.Generator``s.

The JAX pipeline draws threefry noise from PRNG keys; those bits cannot be
reproduced in PyTorch, so parity tests inject the noise instead.  The port
keeps the JAX pipeline's contract (``inference/pipeline.py::_row_noise``):
noise is drawn in f32 and scaled by the temperature, a single int seed drives
one generator for the whole batch, and per-row seeds give each row its own
generator, so a row inside a batch draws the same noise as a batch-1 call
with that seed at the same mel bucket.
"""

from __future__ import annotations

import numbers
from typing import Sequence, Union

import torch


def _generator(seed: int, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def synthesis_noise(seed: Union[int, Sequence[int]], batch: int, m_bucket: int, n_feats: int,
                    temperature: float, device) -> torch.Tensor:
    """(batch, m_bucket, n_feats) f32 noise × temperature."""
    device = torch.device(device)
    if isinstance(seed, numbers.Integral):
        z = torch.randn((batch, m_bucket, n_feats), generator=_generator(seed, device),
                        device=device, dtype=torch.float32)
    else:
        rows = [int(s) for s in seed]
        if len(rows) != batch:
            raise ValueError(f"got {len(rows)} seeds for {batch} texts")
        z = torch.stack([
            torch.randn((m_bucket, n_feats), generator=_generator(s, device),
                        device=device, dtype=torch.float32)
            for s in rows
        ])
    return z * temperature
