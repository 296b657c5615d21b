"""The precision the reference computes in: float32 with TF32 off; TF32 on
only for the control, the nearest precision below the configurations'."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def tf32(on: bool):
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
