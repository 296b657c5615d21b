"""Plain reference of Whisper (OpenAI's ``whisper/model.py`` as transformers'
``WhisperForConditionalGeneration`` names it): the encoder over log-mel
features and the decoder's full forward over a token sequence, no cache, in
plain ``torch.nn.functional`` calls on a state dict with transformers' names.

Pre-LayerNorm blocks; the encoder's two convolutions with GELU and its
position table added; attention scaled by head_dim^-0.5 on the queries, keys
without a bias; the decoder's causal self-attention, then cross-attention on
the encoder's output; logits on the token embedding (tied).  Nothing here
imports the program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def spec(cfg: dict, std: float = 0.02) -> list:
    """transformers' Whisper parameter names and shapes: matrices and tables
    N(0, std) (``init_std``), biases N(0, std), LayerNorms at one and zero."""
    d, v, m = cfg["d_model"], cfg["vocab_size"], cfg["num_mel_bins"]
    s = []

    def lin(name, d_out, d_in, bias=True):
        s.append((f"{name}.weight", (d_out, d_in), ("normal", std)))
        if bias:
            s.append((f"{name}.bias", (d_out,), ("normal", std)))

    def ln(name):
        s.extend([(f"{name}.weight", (d,), ("const", 1.0)), (f"{name}.bias", (d,), ("const", 0.0))])

    def attn(p):
        lin(f"{p}.k_proj", d, d, bias=False)
        lin(f"{p}.v_proj", d, d)
        lin(f"{p}.q_proj", d, d)
        lin(f"{p}.out_proj", d, d)

    s += [("model.encoder.conv1.weight", (d, m, 3), ("normal", std)), ("model.encoder.conv1.bias", (d,), ("normal", std)),
          ("model.encoder.conv2.weight", (d, d, 3), ("normal", std)), ("model.encoder.conv2.bias", (d,), ("normal", std)),
          ("model.encoder.embed_positions.weight", (cfg["max_source_positions"], d), ("normal", std))]
    for i in range(cfg["encoder_layers"]):
        p = f"model.encoder.layers.{i}"
        attn(f"{p}.self_attn")
        ln(f"{p}.self_attn_layer_norm")
        lin(f"{p}.fc1", cfg["encoder_ffn_dim"], d)
        lin(f"{p}.fc2", d, cfg["encoder_ffn_dim"])
        ln(f"{p}.final_layer_norm")
    ln("model.encoder.layer_norm")
    s += [("model.decoder.embed_tokens.weight", (v, d), ("normal", std)),
          ("model.decoder.embed_positions.weight", (cfg["max_target_positions"], d), ("normal", std))]
    for i in range(cfg["decoder_layers"]):
        p = f"model.decoder.layers.{i}"
        attn(f"{p}.self_attn")
        ln(f"{p}.self_attn_layer_norm")
        attn(f"{p}.encoder_attn")
        ln(f"{p}.encoder_attn_layer_norm")
        lin(f"{p}.fc1", cfg["decoder_ffn_dim"], d)
        lin(f"{p}.fc2", d, cfg["decoder_ffn_dim"])
        ln(f"{p}.final_layer_norm")
    ln("model.decoder.layer_norm")
    return s


def _attend(w, p, x, kv, heads, causal):
    t, d = x.shape
    hd = d // heads
    q = F.linear(x, w[f"{p}.q_proj.weight"], w[f"{p}.q_proj.bias"]) * hd ** -0.5
    k = F.linear(kv, w[f"{p}.k_proj.weight"])
    v = F.linear(kv, w[f"{p}.v_proj.weight"], w[f"{p}.v_proj.bias"])
    q, k, v = (z.view(z.shape[0], heads, hd).transpose(0, 1) for z in (q, k, v))
    scores = (q @ k.transpose(-2, -1)).float()
    if causal:
        mask = torch.ones(t, k.shape[1], dtype=torch.bool, device=x.device).tril()
        scores = scores.masked_fill(~mask, torch.finfo(torch.float32).min)
    a = (torch.softmax(scores, -1).to(v.dtype) @ v).transpose(0, 1).reshape(t, d)
    return F.linear(a, w[f"{p}.out_proj.weight"], w[f"{p}.out_proj.bias"])


def _ln(w, name, x):
    return F.layer_norm(x, (x.shape[-1],), w[f"{name}.weight"], w[f"{name}.bias"], 1e-5)


@torch.no_grad()
def logits(sd: dict, cfg: dict, feats, tokens, dtype=torch.float32) -> torch.Tensor:
    """Logits (T, vocab) in f32 after each token of `tokens` (the start token
    first), from the log-mel features `feats` (n_mels, 3000)."""
    w = {k: v.to(dtype) for k, v in sd.items()} if dtype != torch.float32 else sd
    dev = w["model.encoder.conv1.weight"].device
    x = torch.as_tensor(feats, device=dev, dtype=dtype)[None]
    x = F.gelu(F.conv1d(x, w["model.encoder.conv1.weight"], w["model.encoder.conv1.bias"], padding=1))
    x = F.gelu(F.conv1d(x, w["model.encoder.conv2.weight"], w["model.encoder.conv2.bias"], stride=2, padding=1))
    x = x[0].T
    x = x + w["model.encoder.embed_positions.weight"][: x.shape[0]]
    h_enc, d = cfg["encoder_attention_heads"], cfg["d_model"]
    for i in range(cfg["encoder_layers"]):
        p = f"model.encoder.layers.{i}"
        x = x + _attend(w, f"{p}.self_attn", _ln(w, f"{p}.self_attn_layer_norm", x),
                        _ln(w, f"{p}.self_attn_layer_norm", x), h_enc, False)
        y = _ln(w, f"{p}.final_layer_norm", x)
        x = x + F.linear(F.gelu(F.linear(y, w[f"{p}.fc1.weight"], w[f"{p}.fc1.bias"])), w[f"{p}.fc2.weight"],
                         w[f"{p}.fc2.bias"])
    enc = _ln(w, "model.encoder.layer_norm", x)
    tok = torch.as_tensor(tokens, device=dev)
    emb = w["model.decoder.embed_tokens.weight"]
    y = F.embedding(tok, emb) + w["model.decoder.embed_positions.weight"][: tok.shape[0]]
    h_dec = cfg["decoder_attention_heads"]
    for i in range(cfg["decoder_layers"]):
        p = f"model.decoder.layers.{i}"
        z = _ln(w, f"{p}.self_attn_layer_norm", y)
        y = y + _attend(w, f"{p}.self_attn", z, z, h_dec, True)
        y = y + _attend(w, f"{p}.encoder_attn", _ln(w, f"{p}.encoder_attn_layer_norm", y), enc, h_dec, False)
        z = _ln(w, f"{p}.final_layer_norm", y)
        y = y + F.linear(F.gelu(F.linear(z, w[f"{p}.fc1.weight"], w[f"{p}.fc1.bias"])), w[f"{p}.fc2.weight"],
                         w[f"{p}.fc2.bias"])
    y = _ln(w, "model.decoder.layer_norm", y)
    return F.linear(y, emb).float()
