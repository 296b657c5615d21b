"""Plain reference of GPT-J (EleutherAI's ``mesh-transformer-jax`` model as
transformers' ``GPTJForCausalLM`` defines it): the full forward of one
sequence, no cache, in plain ``torch.nn.functional`` calls on a state dict
with transformers' names.

Per block one LayerNorm feeds attention and the MLP in parallel; rotary
position embedding on the first ``rotary_dim`` dims of each head in
interleaved pairs (sin/cos of ``pos / 10000^(2i/rotary_dim)``); scores in
f32 over √head_dim with a causal mask; ``gelu_new``; an untied head with a
bias.  Nothing here imports the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def spec(cfg: dict, std: float = 0.02) -> list:
    """transformers' GPT-J parameter names and shapes: matrices and
    embeddings N(0, std) (GPT-J's ``initializer_range``), biases N(0, std),
    LayerNorms at one and zero."""
    d, v, n = cfg["n_embd"], cfg["vocab_size"], cfg["n_layer"]
    inner = cfg.get("n_inner") or 4 * d
    s = [("transformer.wte.weight", (v, d), ("normal", std))]
    for i in range(n):
        p = f"transformer.h.{i}"
        s += [(f"{p}.ln_1.weight", (d,), ("const", 1.0)), (f"{p}.ln_1.bias", (d,), ("const", 0.0))]
        for name in ("k_proj", "v_proj", "q_proj", "out_proj"):
            s.append((f"{p}.attn.{name}.weight", (d, d), ("normal", std)))
        s += [(f"{p}.mlp.fc_in.weight", (inner, d), ("normal", std)), (f"{p}.mlp.fc_in.bias", (inner,), ("normal", std)),
              (f"{p}.mlp.fc_out.weight", (d, inner), ("normal", std)), (f"{p}.mlp.fc_out.bias", (d,), ("normal", std))]
    s += [("transformer.ln_f.weight", (d,), ("const", 1.0)), ("transformer.ln_f.bias", (d,), ("const", 0.0)),
          ("lm_head.weight", (v, d), ("normal", std)), ("lm_head.bias", (v,), ("normal", std))]
    return s


def _gelu_new(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * torch.pow(x, 3.0))))


def _rotary(x, pos, rot: int):
    """x (T, H, D): rotate the first `rot` dims in interleaved pairs."""
    inv = 1.0 / (10000 ** (torch.arange(0, rot, 2, dtype=torch.int64).float() / rot))
    ang = torch.einsum("i,j->ij", pos.float().cpu(), inv).to(x.device)  # (T, rot/2)
    sin = torch.sin(ang).repeat_interleave(2, -1)[:, None, :].to(x.dtype)
    cos = torch.cos(ang).repeat_interleave(2, -1)[:, None, :].to(x.dtype)
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., ::2], xr[..., 1::2]
    rotated = torch.stack((-x2, x1), dim=-1).flatten(-2)
    return torch.cat([xr * cos + rotated * sin, xp], dim=-1)


@torch.no_grad()
def logits(sd: dict, cfg: dict, ids, dtype=torch.float32, first: int = 0) -> torch.Tensor:
    """Logits (T − first, vocab) in f32 of the sequence `ids` (positions from
    0), at the positions from `first` on; computed in `dtype`."""
    dev = sd["transformer.wte.weight"].device
    ids = torch.as_tensor(ids, device=dev)
    t = ids.shape[0]
    d, heads, rot = cfg["n_embd"], cfg["n_head"], cfg["rotary_dim"]
    hd = d // heads
    eps = cfg.get("layer_norm_epsilon", 1e-5)
    pos = torch.arange(t, device=dev)
    causal = torch.ones(t, t, dtype=torch.bool, device=dev).tril()
    w = {k: v.to(dtype) for k, v in sd.items()} if dtype != torch.float32 else sd
    x = F.embedding(ids, w["transformer.wte.weight"])
    for i in range(cfg["n_layer"]):
        p = f"transformer.h.{i}"
        h = F.layer_norm(x, (d,), w[f"{p}.ln_1.weight"], w[f"{p}.ln_1.bias"], eps)
        q, k, v = (F.linear(h, w[f"{p}.attn.{n}.weight"]).view(t, heads, hd) for n in ("q_proj", "k_proj", "v_proj"))
        q, k = _rotary(q, pos, rot), _rotary(k, pos, rot)
        scores = torch.einsum("thd,shd->hts", q.float(), k.float()) / math.sqrt(hd)
        scores = scores.masked_fill(~causal, torch.finfo(torch.float32).min)
        a = torch.einsum("hts,shd->thd", torch.softmax(scores, -1).to(v.dtype), v).reshape(t, d)
        a = F.linear(a, w[f"{p}.attn.out_proj.weight"])
        f = F.linear(_gelu_new(F.linear(h, w[f"{p}.mlp.fc_in.weight"], w[f"{p}.mlp.fc_in.bias"])),
                     w[f"{p}.mlp.fc_out.weight"], w[f"{p}.mlp.fc_out.bias"])
        x = a + f + x
    x = F.layer_norm(x[first:], (d,), w["transformer.ln_f.weight"], w["transformer.ln_f.bias"], eps)
    return F.linear(x, w["lm_head.weight"], w["lm_head.bias"]).float()
