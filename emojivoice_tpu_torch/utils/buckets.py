"""Static shape buckets (same buckets as ``emojivoice_tpu.utils.buckets``).

PyTorch runs eagerly, so buckets do not bound compilations here; they keep
the port's padded shapes, mel lengths and noise shapes equal to the JAX
pipeline's for the same request, and they are the keys a later per-bucket
CUDA-graph cache will use.
"""

from __future__ import annotations

from typing import Sequence


def default_text_buckets() -> tuple:
    return (64, 128, 192, 256, 384, 512)


def default_mel_buckets() -> tuple:
    return (128, 256, 384, 512, 768, 1024, 1536, 2048)


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket ≥ n; raises if n exceeds the largest bucket."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"Length {n} exceeds largest bucket {buckets[-1]}")
