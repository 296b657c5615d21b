"""The yardstick's count of K3's operations and bytes: the routed experts of
a mixture-of-experts layer (``emojivoice_tpu_torch/ops/moe.py``), worked out
from the configuration and the routing's counts, not from the program.

One call routes `tokens` rows as `pairs` token-expert pairs to `hits`
distinct experts.  Operations: the algorithm's products, 2 · 3 · H · I a
pair (gate, up and down; the activation and the weighted sum are not
counted).  Bytes, the least any implementation moves: each hit expert's
weights once (3 · H · I floats), each row in and out once (2 · H floats),
and the routing (an int32 id and an f32 weight a pair).  A decode step of
one row is a call per MoE layer of k pairs to k experts.  A prefill's calls
are counted from the sums over its layers (the program's counters), which
bounds the prefill's time by max(Σ operations / peak, Σ bytes / rate): no
more than the sum of the layers' own bounds, so a share of it cannot pass
100 % where the per-layer one would not.  The peaks are ``work.py``'s.
"""

from __future__ import annotations

from benchmark.reference.deepseek_v2 import moe_layer
from benchmark.work import Work


def widths(cfg: dict) -> tuple:
    """(H, I, E, k) of the chat LM's config."""
    return cfg["hidden_size"], cfg["moe_intermediate_size"], cfg["n_routed_experts"], cfg["num_experts_per_tok"]


def moe_layers(cfg: dict) -> int:
    """The layers with routed experts (the published rule)."""
    return sum(moe_layer(cfg, i) for i in range(cfg["num_hidden_layers"]))


def call(cfg: dict, tokens: float, pairs: float, hits: float) -> Work:
    h, i, _, _ = widths(cfg)
    return Work(6.0 * h * i * pairs, 4.0 * (hits * 3 * h * i + 2 * tokens * h) + 8.0 * pairs)


def decode_step(cfg: dict, rows: int = 1) -> Work:
    """A step's K3 calls, one per MoE layer, for `rows` rows."""
    _, _, e, k = widths(cfg)
    return call(cfg, rows, rows * k, min(e, rows * k)) * moe_layers(cfg)


def bound_s(cfg: dict, counts: dict) -> float:
    """The least time of the K3 calls that `counts` describes: prefills
    routing ``pairs`` pairs to ``hits`` experts, both summed over their
    layers (the decoder's device counters), and ``steps`` decode steps of
    one row."""
    _, _, _, k = widths(cfg)
    prefill = call(cfg, counts["pairs"] / k, counts["pairs"], counts["hits"])
    return (prefill.bound_s() if counts["pairs"] else 0.0) + counts["steps"] * decode_step(cfg).bound_s()
