"""Monotonic alignment search: the K2 CUDA kernel and its plain PyTorch version.

``maximum_path(value, mask)`` has the contract of
``emojivoice_tpu.ops.mas.maximum_path``: value (B, T_x, T_y) is a log-prior
(higher = more likely), mask (B, T_x, T_y) the attention mask from which the
lengths are read (``t_x = Σ mask[:, :, 0]``, ``t_y = Σ mask[:, 0, :]``); it
returns the most likely monotone path as a 0/1 tensor of value's shape and
dtype.  As in the JAX package, value may be of any float dtype (bf16 under
mixed-precision training): it is cast to f32 and the search runs in f32.
The recurrence, with its boundary rules::

    V[x, y] = value[x, y]·mask[x, y] + max(v_cur, v_prev)
      v_cur  = V[x, y−1]     (−1e9 where x == y)
      v_prev = V[x−1, y−1]   (x == 0: 0 at y == 0, else −1e9)
    V[x, y] = −1e9 where x > y
    walk back from (t_x − 1, t_y − 1):  x −= (x == y or V[x, y−1] < V[x−1, y−1]) and x ≠ 0

On a CUDA tensor it launches K2 (``csrc/mas.cu``, built at first use) on the
current stream and raises if the build or the launch fails; it never gives
way to the plain version.  On a CPU tensor it runs
``maximum_path_reference``, which repeats the kernel's arithmetic column by
column.  Any other device raises.  MAS has no gradient (the model cuts it
before the search), so both run under ``torch.no_grad()``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

MAX_NEG = -1e9

# K2 launches: one per ``maximum_path`` call on a CUDA tensor
launches = 0


@torch.no_grad()
def maximum_path_reference(value: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch MAS: a loop over mel frames with tensor operations over
    (B, T_x) — forward DP that keeps the decision bits, then the walk back."""
    b, t_x, t_y = value.shape
    dev = value.device
    mask32 = mask.float()
    logp = value.float() * mask32
    t_xs = mask32[:, :, 0].sum(-1).long()
    t_ys = mask32[:, 0, :].sum(-1).long()
    x_idx = torch.arange(t_x, device=dev)[None, :]
    neg = torch.tensor(MAX_NEG, dtype=torch.float32, device=dev)
    zero = torch.tensor(0.0, dtype=torch.float32, device=dev)
    not_first = x_idx != 0

    prev = torch.full((b, t_x), MAX_NEG, dtype=torch.float32, device=dev)
    dec = torch.empty((t_y, b, t_x), dtype=torch.bool, device=dev)
    for y in range(t_y):
        shifted = torch.roll(prev, 1, 1)  # prev[x−1] at x; x == 0 is overridden below
        on_diag = x_idx == y
        dec[y] = (on_diag | (prev < shifted)) & not_first
        v_cur = torch.where(on_diag, neg, prev)
        v_prev = torch.where(not_first, shifted, zero if y == 0 else neg)
        new = logp[:, :, y] + torch.maximum(v_cur, v_prev)
        prev = torch.where(x_idx > y, neg, new)

    rows = torch.arange(b, device=dev)
    index = t_xs - 1  # −1 for an empty item: it never becomes active
    path = torch.zeros((b, t_x, t_y), dtype=torch.float32, device=dev)
    for y in range(t_y - 1, -1, -1):
        active = (y < t_ys) & (index >= 0)
        at = index.clamp_min(0)
        path[rows, at, y] = active.float()
        index = index - (dec[y][rows, at] & active).long()
    return (path * mask32).to(value.dtype)


def maximum_path_numpy(value: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Brute-force O(T_x·T_y) numpy oracle for the tests: an explicit DP table
    in float64 with −inf borders, then the walk back."""
    out = np.zeros_like(value)
    for i in range(value.shape[0]):
        t_x = int(mask[i, :, 0].sum())
        t_y = int(mask[i, 0, :].sum())
        v = value[i, :t_x, :t_y].astype(np.float64)
        dp = np.full((t_x, t_y), -np.inf)
        dp[0, 0] = v[0, 0]
        for y in range(1, t_y):
            for x in range(min(t_x, y + 1)):
                best = dp[x, y - 1] if x != y else -np.inf
                if x > 0:
                    best = max(best, dp[x - 1, y - 1])
                dp[x, y] = v[x, y] + best
        x = t_x - 1
        for y in range(t_y - 1, -1, -1):
            out[i, x, y] = 1.0
            if x != 0 and (x == y or dp[x, y - 1] < dp[x - 1, y - 1]):
                x -= 1
    return out


def path_faults(path: torch.Tensor, mask: torch.Tensor) -> list:
    """What is wrong with `path` as an alignment under `mask`, as a list of
    strings (empty = a valid path): exactly one 1 in every mel frame
    ``y < t_y`` and none beyond, inside ``x < t_x``, text index non-decreasing
    in steps of at most one, and, where ``t_x ≤ t_y``, from 0 to ``t_x − 1``."""
    faults = []
    path, mask = path.detach().cpu(), mask.detach().cpu()
    for i in range(path.shape[0]):
        t_x, t_y = int(mask[i, :, 0].sum()), int(mask[i, 0, :].sum())
        p = path[i]
        if not bool(((p == 0) | (p == 1)).all()):
            faults.append(f"item {i}: entries other than 0 and 1")
        if float(p[t_x:].sum()) or float(p[:, t_y:].sum()):
            faults.append(f"item {i}: ones outside t_x={t_x}, t_y={t_y}")
        if t_x == 0 or t_y == 0:
            continue
        if not torch.equal(p[:, :t_y].sum(0), torch.ones(t_y)):
            faults.append(f"item {i}: not exactly one text position per mel frame")
            continue
        tok = p[:, :t_y].argmax(0)
        step = tok[1:] - tok[:-1]
        if bool((step < 0).any()) or bool((step > 1).any()):
            faults.append(f"item {i}: text index not monotone in steps of at most one")
        if t_x <= t_y and (int(tok[0]) != 0 or int(tok[-1]) != t_x - 1):
            faults.append(f"item {i}: runs {int(tok[0])}..{int(tok[-1])}, expected 0..{t_x - 1}")
    return faults


def _check(value: torch.Tensor, mask: torch.Tensor) -> None:
    if value.dim() != 3 or value.dtype != torch.float32 or not value.is_contiguous():
        raise ValueError(f"maximum_path: value must be a contiguous (B, T_x, T_y) float32 tensor, got "
                         f"{tuple(value.shape)} {value.dtype} contiguous={value.is_contiguous()}")
    if mask.shape != value.shape or mask.dtype != torch.float32 or not mask.is_contiguous() \
            or mask.device != value.device:
        raise ValueError(f"maximum_path: mask must be a contiguous float32 tensor of value's shape "
                         f"{tuple(value.shape)} on its device, got {tuple(mask.shape)} {mask.dtype} "
                         f"on {mask.device}")
    if 0 in value.shape:
        raise ValueError(f"maximum_path: empty shape {tuple(value.shape)}")


@torch.no_grad()
def maximum_path(value: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Batched MAS (B, T_x, T_y) → binary path; see the module docstring."""
    global launches
    if value.device.type == "cpu":
        return maximum_path_reference(value, mask)
    if value.device.type != "cuda":
        raise ValueError(f"maximum_path: no kernel for device {value.device}")
    if value.is_floating_point() and value.dtype != torch.float32:  # searched in f32, returned in value's dtype
        return maximum_path(value.float().contiguous(), mask).to(value.dtype)
    _check(value, mask)
    from emojivoice_tpu_torch.kernels.build import load_mas

    lib = load_mas()
    b, t_x, t_y = value.shape
    words = lib.mas_scratch_words(b, t_x, t_y)
    if words < 0:
        raise ValueError(f"maximum_path: T_x={t_x}, T_y={t_y} exceed the kernel (T_x up to 2048, held in one "
                         f"warp's registers; the tile ring and T_y frame indices in shared memory)")
    path = torch.empty_like(value)
    scratch = torch.empty((words,), dtype=torch.int32, device=value.device) if words else None
    with torch.cuda.device(value.device):
        err = lib.mas_path_f32(value.data_ptr(), mask.data_ptr(), path.data_ptr(),
                               scratch.data_ptr() if words else None, b, t_x, t_y,
                               ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError(f"K2 mas_path_f32 launch failed: CUDA error {err} "
                           f"({lib.mas_error_string(err).decode()}) at B={b} T_x={t_x} T_y={t_y}")
    launches += 1
    return path
