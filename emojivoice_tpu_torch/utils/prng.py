"""Seeded noise from explicit ``torch.Generator``s: synthesis and training.

The JAX pipeline draws threefry noise from PRNG keys; those bits cannot be
reproduced in PyTorch, so parity tests inject the noise instead.  The port
keeps the JAX pipeline's contract (``inference/pipeline.py::_row_noise``):
noise is drawn in f32 and scaled by the temperature, a single int seed drives
one generator for the whole batch, and per-row seeds give each row its own
generator, so a row inside a batch draws the same noise as a batch-1 call
with that seed at the same mel bucket.

Training draws come from one generator per purpose (the CFM time ``t``, the
CFM noise ``z``, the crop offsets, dropout), each seeded from
``(seed, step, purpose)``.  A run resumed at step N therefore draws what an
unbroken run draws at step N, as the JAX trainer's ``fold_in(rng, step)``
does.  All noise is drawn in f32.
"""

from __future__ import annotations

import hashlib
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


def step_seed(seed: int, step: int, purpose: str) -> int:
    """A 63-bit seed that depends on the run's seed, the step and the purpose."""
    digest = hashlib.blake2b(f"{int(seed)}:{int(step)}:{purpose}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") & (2**63 - 1)


def step_generator(seed: int, step: int, purpose: str, device) -> torch.Generator:
    return _generator(step_seed(seed, step, purpose), torch.device(device))


def training_draws(seed: int, step: int, batch: int, frames: int, n_feats: int, device,
                   crop: bool = False) -> dict:
    """The random inputs of one training forward: ``t`` (B, 1, 1) uniform,
    ``z`` (B, frames, n_feats) normal and, with `crop`, ``crop_u`` (B,)
    uniform for the segment crop's offsets."""
    device = torch.device(device)
    out = {
        "t": torch.rand((batch, 1, 1), generator=step_generator(seed, step, "cfm_t", device),
                        device=device, dtype=torch.float32),
        "z": torch.randn((batch, frames, n_feats), generator=step_generator(seed, step, "cfm_z", device),
                         device=device, dtype=torch.float32),
    }
    if crop:
        out["crop_u"] = torch.rand((batch,), generator=step_generator(seed, step, "crop", device),
                                   device=device, dtype=torch.float32)
    return out
