"""Plain reference of DeepSeek-V2 (DeepSeek's published ``modeling_deepseek.py``
of deepseek-ai/DeepSeek-V2-Lite): the full forward of one sequence, no
cache, no kernel, in plain ``torch`` calls on a state dict with
transformers' names, in float32 (TF32 is off unless the caller's
``precision.tf32`` turns it on).  Nothing here imports the program.

Per layer, with h the RMSNormed input:

* attention: q = W_q h (or W_qb RMSNorm(W_qa h)), per head q_nope
  (``qk_nope_head_dim``) and q_pe (``qk_rope_head_dim``); [c_kv | k_pe] =
  W_kva h, c = RMSNorm(c_kv); [k_nope | v] = W_kvb c per head, k_pe one
  head shared by all; q_pe and k_pe rotated by the yarn tables (beta_fast,
  beta_slow, factor, the original positions; cos and sin times
  mscale(factor, mscale) / mscale(factor, mscale_all_dim)); scores
  (q_nope · k_nope + q_pe · k_pe) · s with s = m² / √(nope + rope), m =
  0.1 · mscale_all_dim · ln(factor) + 1; causal; the heads' softmax · v
  through W_o.
* the MLP: a SiLU-gated MLP in the first ``first_k_dense_replace`` layers
  (and where ``moe_layer_freq`` skips a layer); else p = softmax(W_g h) over
  the routed experts, their top ``num_experts_per_tok`` (normalised where
  ``norm_topk_prob``, times ``routed_scaling_factor``), each expert run on
  the tokens routed to it, y = Σ_j p_j · expert_j(h) + the shared experts'
  MLP.

Departures from ``modeling_deepseek.py``, none of which changes the
mathematics:

* the rotary pairs are rotated in place, (x_2i, x_2i+1) as one complex
  number: the published code first moves the even features to the first
  half and the odd ones to the second (``view(d/2, 2).transpose``), then
  rotates halves; it reorders q_pe and k_pe alike, so every q_pe · k_pe is
  the same;
* the tables are computed for the sequence's positions, not cached for
  ``max_position_embeddings``;
* the top-k takes the lower expert id among equal scores (the published
  ``torch.topk(sorted=False)`` leaves the choice open) and orders the k by
  score, and each token's k expert outputs are summed in that order (the
  published sum runs over ``topk``'s unspecified order);
* no auxiliary loss, dropout or cache.

transformers' ``DeepseekV2Attention`` (4.57 and 5.5) scales the scores by
1 / √(nope + rope) alone; this reference keeps the published m².
"""

from __future__ import annotations

import importlib.metadata
import math

import torch
import torch.nn.functional as F


def fused_experts() -> bool:
    """Whether the installed transformers keeps each layer's routed experts
    as two stacked parameters (``experts.gate_up_proj``, ``experts.down_proj``:
    version 5) rather than one module per expert (version 4)."""
    return int(importlib.metadata.version("transformers").split(".")[0]) >= 5


def moe_layer(cfg: dict, i: int) -> bool:
    """The published rule: routed experts from ``first_k_dense_replace`` on,
    every ``moe_layer_freq``-th layer."""
    return cfg.get("n_routed_experts") is not None and i >= cfg.get("first_k_dense_replace", 0) \
        and i % (cfg.get("moe_layer_freq") or 1) == 0


def spec(cfg: dict, std: float = 0.02, fused: bool | None = None) -> list:
    """transformers' DeepSeek-V2 parameter names and shapes for the installed
    expert layout (`fused`: None reads it from the installed version):
    matrices, embeddings and biases N(0, std) (the config's
    ``initializer_range``), RMSNorms at one."""
    fused = fused_experts() if fused is None else fused
    d, v, heads = cfg["hidden_size"], cfg["vocab_size"], cfg["num_attention_heads"]
    nope, rope, v_dim, rank = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"]
    q_rank, bias = cfg.get("q_lora_rank"), bool(cfg.get("attention_bias"))
    n = ("normal", std)
    one = ("const", 1.0)
    s = [("model.embed_tokens.weight", (v, d), n)]
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}"
        a = f"{p}.self_attn"
        if q_rank is None:
            s.append((f"{a}.q_proj.weight", (heads * (nope + rope), d), n))
        else:
            s += [(f"{a}.q_a_proj.weight", (q_rank, d), n)] + ([(f"{a}.q_a_proj.bias", (q_rank,), n)] if bias else [])
            s += [(f"{a}.q_a_layernorm.weight", (q_rank,), one),
                  (f"{a}.q_b_proj.weight", (heads * (nope + rope), q_rank), n)]
        s.append((f"{a}.kv_a_proj_with_mqa.weight", (rank + rope, d), n))
        s += [(f"{a}.kv_a_proj_with_mqa.bias", (rank + rope,), n)] if bias else []
        s += [(f"{a}.kv_a_layernorm.weight", (rank,), one),
              (f"{a}.kv_b_proj.weight", (heads * (nope + v_dim), rank), n),
              (f"{a}.o_proj.weight", (d, heads * v_dim), n)]
        s += [(f"{a}.o_proj.bias", (d,), n)] if bias else []
        m = f"{p}.mlp"
        if moe_layer(cfg, i):
            e, inter = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
            s.append((f"{m}.gate.weight", (e, d), n))
            if fused:
                s += [(f"{m}.experts.gate_up_proj", (e, 2 * inter, d), n), (f"{m}.experts.down_proj", (e, d, inter), n)]
            else:
                for j in range(e):
                    s += [(f"{m}.experts.{j}.gate_proj.weight", (inter, d), n),
                          (f"{m}.experts.{j}.up_proj.weight", (inter, d), n),
                          (f"{m}.experts.{j}.down_proj.weight", (d, inter), n)]
            shared = inter * cfg["n_shared_experts"]
            s += [(f"{m}.shared_experts.gate_proj.weight", (shared, d), n),
                  (f"{m}.shared_experts.up_proj.weight", (shared, d), n),
                  (f"{m}.shared_experts.down_proj.weight", (d, shared), n)]
        else:
            inter = cfg["intermediate_size"]
            s += [(f"{m}.gate_proj.weight", (inter, d), n), (f"{m}.up_proj.weight", (inter, d), n),
                  (f"{m}.down_proj.weight", (d, inter), n)]
        s += [(f"{p}.input_layernorm.weight", (d,), one), (f"{p}.post_attention_layernorm.weight", (d,), one)]
    s += [("model.norm.weight", (d,), one), ("lm_head.weight", (v, d), n)]
    return s


def _mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def softmax_scale(cfg: dict) -> float:
    """The published ``softmax_scale``: 1 / √(nope + rope), times m² where
    the rope scaling has ``mscale_all_dim``."""
    scale = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5
    rs = cfg.get("rope_scaling") or {}
    if rs.get("mscale_all_dim"):
        m = _mscale(float(rs["factor"]), rs["mscale_all_dim"])
        scale *= m * m
    return scale


def rotary(cfg: dict, positions: int) -> tuple:
    """(angles (T, rope / 2), the factor on cos and sin): the published
    ``DeepseekV2YarnRotaryEmbedding`` where the rope scaling is yarn, plain
    rotary frequencies otherwise."""
    dim, base = cfg["qk_rope_head_dim"], float(cfg.get("rope_theta", 10000.0))
    pos_freqs = base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim)
    extra = 1.0 / pos_freqs
    rs = cfg.get("rope_scaling") or {}
    kind = rs.get("type", rs.get("rope_type"))
    factor = 1.0
    if kind == "yarn":
        factor = float(rs["factor"])
        original = rs["original_max_position_embeddings"]

        def correction_dim(rotations):
            return (dim * math.log(original / (rotations * 2 * math.pi))) / (2 * math.log(base))
        low = max(math.floor(correction_dim(rs.get("beta_fast", 32))), 0)
        high = min(math.ceil(correction_dim(rs.get("beta_slow", 1))), dim - 1)
        ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low) / ((high - low) or 0.001), 0, 1)
        keep = 1.0 - ramp  # the share of the unscaled frequency
        inv_freq = 1.0 / (factor * pos_freqs) * (1 - keep) + extra * keep
        attn = _mscale(factor, rs.get("mscale", 1.0)) / _mscale(factor, rs.get("mscale_all_dim", 0.0))
    elif kind in (None, "default"):
        inv_freq, attn = extra, 1.0
    else:
        raise ValueError(f"reference: rope scaling {kind!r} is not implemented")
    return torch.outer(torch.arange(positions, dtype=torch.float32), inv_freq), attn


def _rope(x, cos, sin):
    """x (..., T, rope): each pair (x_2i, x_2i+1) rotated by its angle."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack((x1 * cos - x2 * sin, x1 * sin + x2 * cos), dim=-1).flatten(-2)


def _rms(x, w, eps):
    return w * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def _linear(w, p, x):
    return F.linear(x, w[f"{p}.weight"], w.get(f"{p}.bias"))


def _gated(x, gate, up, down):
    return F.linear(F.silu(F.linear(x, gate)) * F.linear(x, up), down)


def _expert(w: dict, m: str, j: int, inter: int):
    """Expert j's (gate, up, down) in either layout."""
    if f"{m}.experts.gate_up_proj" in w:
        gu = w[f"{m}.experts.gate_up_proj"][j]
        return gu[:inter], gu[inter:], w[f"{m}.experts.down_proj"][j]
    return tuple(w[f"{m}.experts.{j}.{n}_proj.weight"] for n in ("gate", "up", "down"))


def routing(h: torch.Tensor, gate: torch.Tensor, cfg: dict) -> tuple:
    """(weights, ids), (T, k): the softmax over the experts, the k best
    (the lower id first among equal scores), normalised where
    ``norm_topk_prob``, times ``routed_scaling_factor``; and the sorted
    scores (T, E) for the callers that look at near-ties."""
    scores = torch.softmax(F.linear(h.float(), gate.float()), dim=-1)
    ranked, order = torch.sort(scores, dim=-1, descending=True, stable=True)
    k = cfg["num_experts_per_tok"]
    weights, ids = ranked[:, :k], order[:, :k]
    if cfg.get("norm_topk_prob") and k > 1:
        weights = weights / (weights.sum(-1, keepdim=True) + 1e-20)
    return weights * float(cfg.get("routed_scaling_factor") or 1.0), ids, ranked


@torch.no_grad()
def logits(sd: dict, cfg: dict, ids, dtype=torch.float32, first: int = 0,
           gate_scores: list | None = None) -> torch.Tensor:
    """Logits (T − first, vocab) in f32 of the sequence `ids` (positions from
    0), at the positions from `first` on; computed in `dtype`.  With
    `gate_scores`, each MoE layer's sorted router scores (T, E) are
    appended to it."""
    dev = sd["model.embed_tokens.weight"].device
    ids = torch.as_tensor(ids, device=dev)
    t = ids.shape[0]
    heads, eps = cfg["num_attention_heads"], cfg.get("rms_norm_eps", 1e-6)
    nope, rope, v_dim, rank = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"]
    w = {k: v.to(dtype) for k, v in sd.items()} if dtype != torch.float32 else sd
    angles, attn_factor = rotary(cfg, t)
    cos, sin = ((f(angles) * attn_factor).to(device=dev, dtype=dtype) for f in (torch.cos, torch.sin))
    scale = softmax_scale(cfg)
    causal = torch.ones(t, t, dtype=torch.bool, device=dev).tril()
    x = F.embedding(ids, w["model.embed_tokens.weight"])
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}"
        a = f"{p}.self_attn"
        h = _rms(x, w[f"{p}.input_layernorm.weight"], eps)
        if cfg.get("q_lora_rank") is None:
            q = _linear(w, f"{a}.q_proj", h)
        else:
            q = _linear(w, f"{a}.q_b_proj", _rms(_linear(w, f"{a}.q_a_proj", h), w[f"{a}.q_a_layernorm.weight"], eps))
        q = q.view(t, heads, nope + rope).transpose(0, 1)  # (H, T, nope + rope)
        q_nope, q_pe = q[..., :nope], _rope(q[..., nope:], cos, sin)
        ckv = _linear(w, f"{a}.kv_a_proj_with_mqa", h)
        c = _rms(ckv[:, :rank], w[f"{a}.kv_a_layernorm.weight"], eps)
        k_pe = _rope(ckv[:, rank:], cos, sin)  # (T, rope), every head's
        kv = F.linear(c, w[f"{a}.kv_b_proj.weight"]).view(t, heads, nope + v_dim).transpose(0, 1)
        k_nope, v = kv[..., :nope], kv[..., nope:]
        scores = (q_nope.float() @ k_nope.float().transpose(-1, -2) + q_pe.float() @ k_pe.float().T) * scale
        scores = scores.masked_fill(~causal, torch.finfo(torch.float32).min)
        out = (torch.softmax(scores, -1).to(v.dtype) @ v).transpose(0, 1).reshape(t, heads * v_dim)
        x = x + _linear(w, f"{a}.o_proj", out)
        h = _rms(x, w[f"{p}.post_attention_layernorm.weight"], eps)
        m = f"{p}.mlp"
        if moe_layer(cfg, i):
            weights, chosen, ranked = routing(h, w[f"{m}.gate.weight"], cfg)
            if gate_scores is not None:
                gate_scores.append(ranked)
            inter = cfg["moe_intermediate_size"]
            parts = torch.zeros((t, chosen.shape[1], x.shape[-1]), dtype=x.dtype, device=dev)
            for j in range(cfg["n_routed_experts"]):
                rows, slots = torch.nonzero(chosen == j, as_tuple=True)
                if rows.numel():
                    y = _gated(h[rows], *_expert(w, m, j, inter))
                    parts[rows, slots] = y * weights[rows, slots, None].to(dtype)
            f = parts[:, 0]
            for j in range(1, parts.shape[1]):
                f = f + parts[:, j]
            f = f + _gated(h, *(w[f"{m}.shared_experts.{n}_proj.weight"] for n in ("gate", "up", "down")))
        else:
            f = _gated(h, *(w[f"{m}.{n}_proj.weight"] for n in ("gate", "up", "down")))
        x = x + f
    x = _rms(x[first:], w["model.norm.weight"], eps)
    return F.linear(x, w["lm_head.weight"]).float()
