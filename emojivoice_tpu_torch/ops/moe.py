"""Routed experts of a mixture-of-experts layer: the K3 CUDA kernel and its
plain PyTorch version.

``experts(x, ids, weights, w13, w2)`` computes, for each row t of x (T, H)
and its k routed experts (ids (T, k) int32, weights (T, k) f32)::

    out[t] = Σ_j weights[t, j] · W2[e] (silu(W1[e] x[t]) ⊙ W3[e] x[t]),  e = ids[t, j]

over the experts' weights stacked one tensor per layer: w13 (E, 2I, H), the
gate rows W1 then the up rows W3 of each expert (transformers 5's
``gate_up_proj``), and w2 (E, H, I) (its ``down_proj``).  An id equal to E
routes nowhere: such a pair adds nothing (a prefill's pad rows, whose output
no real token reads).  The j are summed in their order, each expert's share
weighted after its down product.

On a CUDA tensor it launches K3 (``csrc/moe.cu``, built at first use) on the
current stream and raises if the build or a launch fails; it never gives way
to the plain version.  Every decision is taken on the device, so a call can
be captured in a CUDA graph and replayed with other routing:

* few pairs (T·k ≤ ``GEMV_PAIRS``, a decode step): ``k3_gateup_gemv`` reads
  only the routed experts' gate and up rows, one warp a row pair, and writes
  the activated intermediate of each pair; ``k3_down_gemv`` reads the routed
  experts' down rows and sums each row's k products in order.  Nothing is
  sorted.
* many pairs (a prefill): the pairs are sorted by expert on the device
  (``group``: the histogram of the ids, a stable argsort, the offsets and the
  tiles of each expert), then ``k3_gateup_grouped`` and ``k3_down_grouped``
  run a grouped GEMM over a static worst-case schedule of ⌈T·k / 64⌉ + E row
  tiles (a block past the routing's last tile returns at once), and
  ``k3_combine`` adds each pair back to its row, weighted, in j order.

On a CPU tensor it runs ``experts_reference``: every expert on every row in
plain ``torch`` products, the routed ones gathered and summed in j order,
with no decision on the host either.  It is the CPU path and K3's yardstick.

``group(ids, E)`` gives the histogram (E + 1,) whose last bin counts the
pairs routed nowhere; a caller that keeps routing statistics passes it back
in (``experts(..., counts=)``) so that it is computed once.

``launches`` counts the calls that launched K3.  The wrapper counts when it
runs, so inside a captured graph it counts at the capture and never at a
replay.
"""

from __future__ import annotations

import ctypes
import threading

import torch
import torch.nn.functional as F

GEMV_PAIRS = 64  # up to this many token-expert pairs a call reads each routed expert through the GEMV kernels
TILE_M = 64  # the grouped GEMM's rows per tile (csrc/moe.cu kBM)

launches = 0
_launch_lock = threading.Lock()


def count_launch() -> None:
    global launches
    with _launch_lock:
        launches += 1


def group(ids: torch.Tensor, n_experts: int) -> torch.Tensor:
    """The routing's histogram: (E + 1,) int32, the pairs of each expert and,
    last, those routed nowhere (id E)."""
    flat = ids.reshape(-1).long()
    counts = torch.zeros(n_experts + 1, dtype=torch.int32, device=ids.device)
    return counts.scatter_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))


def _ffn(x: torch.Tensor, w13: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """One expert's gated MLP on rows x: W2 (silu(W1 x) ⊙ W3 x)."""
    gate, up = F.linear(x, w13).chunk(2, dim=-1)
    return F.linear(F.silu(gate) * up, w2)


@torch.no_grad()
def experts_reference(x: torch.Tensor, ids: torch.Tensor, weights: torch.Tensor, w13: torch.Tensor,
                      w2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch routed experts: each expert's MLP on every row, then per
    row its routed experts' outputs weighted and summed in j order (the
    module docstring).  Reads every expert: the CPU path and the yardstick,
    not a fast path."""
    n_experts = w13.shape[0]
    every = torch.stack([_ffn(x, w13[e], w2[e]) for e in range(n_experts)], dim=1)  # (T, E, H)
    live = ids < n_experts
    picked = every.gather(1, ids.long().clamp(max=n_experts - 1)[..., None].expand(-1, -1, x.shape[-1]))
    out = torch.zeros_like(x)
    for j in range(ids.shape[1]):
        out = out + torch.where(live[:, j, None], weights[:, j, None] * picked[:, j], 0.0)
    return out


def _check(x, ids, weights, w13, w2) -> None:
    t, h = x.shape
    e, two_i, h2 = w13.shape
    if x.dtype != torch.float32 or w13.dtype != torch.float32 or w2.dtype != torch.float32 \
            or weights.dtype != torch.float32:
        raise ValueError("experts: K3 takes float32 rows, weights and routing weights")
    if ids.dtype != torch.int32 or ids.shape != weights.shape or ids.shape[0] != t:
        raise ValueError(f"experts: ids must be int32 (T, k) beside weights, got {ids.dtype} {tuple(ids.shape)} "
                         f"and {tuple(weights.shape)} for {t} rows")
    if h2 != h or two_i % 2 or w2.shape != (e, h, two_i // 2):
        raise ValueError(f"experts: w13 (E, 2I, H) {tuple(w13.shape)} and w2 (E, H, I) {tuple(w2.shape)} do not "
                         f"fit rows of {h}")
    if h % 4 or (two_i // 2) % 4:
        raise ValueError(f"experts: K3 reads 16-byte vectors along H and I; H={h}, I={two_i // 2} must be "
                         "multiples of 4")
    for name, tensor in (("x", x), ("ids", ids), ("weights", weights), ("w13", w13), ("w2", w2)):
        if not tensor.is_contiguous() or tensor.device != x.device or tensor.data_ptr() % 16:
            raise ValueError(f"experts: {name} must be contiguous, 16-byte aligned and on {x.device}")


@torch.no_grad()
def experts(x: torch.Tensor, ids: torch.Tensor, weights: torch.Tensor, w13: torch.Tensor, w2: torch.Tensor,
            counts: torch.Tensor | None = None) -> torch.Tensor:
    """x (T, H) f32 routed through ids / weights (T, k) to the experts w13
    (E, 2I, H), w2 (E, H, I) → (T, H); see the module docstring.  `counts`:
    ``group(ids, E)`` where the caller made it already."""
    if x.device.type == "cpu":
        return experts_reference(x, ids, weights, w13, w2)
    if x.device.type != "cuda":
        raise ValueError(f"experts: no kernel for device {x.device}")
    _check(x, ids, weights, w13, w2)
    from emojivoice_tpu_torch.kernels.build import load_moe

    lib = load_moe()
    t, h = x.shape
    k = ids.shape[1]
    n_experts, inter = w13.shape[0], w13.shape[1] // 2
    out = torch.empty_like(x)
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
    with torch.cuda.device(x.device):
        if t * k <= GEMV_PAIRS:
            act = torch.empty((t * k, inter), dtype=torch.float32, device=x.device)
            err = lib.k3_gemv(x.data_ptr(), ids.data_ptr(), weights.data_ptr(), w13.data_ptr(), w2.data_ptr(),
                              act.data_ptr(), out.data_ptr(), t, k, h, inter, n_experts, stream)
        else:
            counts = group(ids, n_experts) if counts is None else counts
            order = torch.sort(ids.reshape(-1), stable=True).indices.to(torch.int32)  # the pairs by expert
            offsets = F.pad(counts.cumsum(0, dtype=torch.int32), (1, 0))  # (E + 2,): expert e's sorted pairs
            tiles = F.pad(((counts[:n_experts] + TILE_M - 1) // TILE_M).cumsum(0, dtype=torch.int32), (1, 0))
            slot = torch.empty_like(order).scatter_(0, order.long(), torch.arange(t * k, dtype=torch.int32,
                                                                                  device=x.device))
            act = torch.empty((t * k, inter), dtype=torch.float32, device=x.device)
            part = torch.empty((t * k, h), dtype=torch.float32, device=x.device)
            err = lib.k3_grouped(x.data_ptr(), ids.data_ptr(), weights.data_ptr(), w13.data_ptr(), w2.data_ptr(),
                                 order.data_ptr(), slot.data_ptr(), offsets.data_ptr(), tiles.data_ptr(),
                                 act.data_ptr(), part.data_ptr(), out.data_ptr(), t, k, h, inter, n_experts, stream)
    if err != 0:
        raise RuntimeError(f"K3 launch failed: CUDA error {err} ({lib.k3_error_string(err).decode()}) at "
                           f"T={t} k={k} H={h} I={inter} E={n_experts}")
    count_launch()
    return out
