"""The chat LM's and Whisper's decode steps over a static key/value cache,
and the CUDA graphs that replay them: the port's counterparts of the decode
loops inside transformers' Flax ``generate`` (``FlaxGPT2LMHeadModel`` over
its ``init_cache``; ``FlaxWhisperForConditionalGeneration``'s ``encode``,
then ``decode`` over ``init_cache``), which
``emojivoice_tpu/apps/flax_adapters.py`` compiles as one program for Whisper
(``FlaxWhisperASR._generate``) and one per (prompt bucket, sampling) for the
chat LM (``FlaxChatLM._program``).

``GPT2Decoder`` and ``WhisperDecoder`` compute on a transformers PyTorch
model's own parameter tensors (shared, not copied) and read and write only
tensors made at construction: a ``StaticKV`` cache, the input buffers, the
last token, the step's logits and the step counters, all on the model's
device.  No step takes a decision on the host, so each can be captured:

* GPT-2.  ``prefill(bucket, sample)`` runs a left-padded prompt bucket,
  writes its keys and values into the cache's first ``bucket`` slots, marks
  the real tokens' slots valid and chooses the first new token;
  ``step(sample)`` feeds the last token at the next slot and chooses the
  next.  One cache of ``max(buckets) + max_new_tokens`` slots serves every
  bucket: the valid-slot mask hides what a longer prompt left behind.
  Positions count the real tokens from 0, as the Flax GPT-2 does.  A pad
  query attends to itself alone, so that its row, and the keys and values
  it caches, stay finite (the masks select, they add nothing: a NaN under
  an additive mask would poison every later softmax).
* Whisper.  ``encode()`` runs the encoder on the (1, n_mels, 3000)
  features, makes each decoder layer's cross-attention keys and values once
  and resets the cache; ``step()`` feeds the last token and applies the
  generation config's ``suppress_tokens``, ``begin_suppress_tokens`` (at the
  first free step) and ``forced_decoder_ids`` from tables indexed by the
  device step, in the Flax processors' order, then takes the argmax.

Sampling (``sample_top_k``): the logits over the temperature, the 50 most
likely tokens kept (ties at the 50th too, as transformers' top-k warper
keeps them), then the token drawn by inverse CDF from one uniform, the
turn's uniforms all drawn before the turn from its own generator.

Each builder refuses, by name, a configuration whose forward it does not
implement.

``DecodeGraphs`` holds one captured graph per key (``utils/cuda_graphs.py``'s
pool, capture lock, side stream and ``"thread_local"`` capture with the
cycle collector off).  A key's first call on the card is its real step, run
eagerly as the warm run, after which the key is captured without being run;
later calls replay.  On the CPU the same keys run the step itself, so the
CPU tests exercise the staging.  ``read`` brings a token to the host through
one small pinned buffer.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Hashable, Iterable, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from emojivoice_tpu_torch.utils.cuda_graphs import GraphCache, weights_stamp

# transformers' GenerationConfig default top_k, which the Flax generate's sampling applies
TOP_K = 50
NEG_INF = float("-inf")


def sample_top_k(logits: torch.Tensor, temperature: torch.Tensor, u: torch.Tensor, k: int = TOP_K) -> torch.Tensor:
    """Logits (..., V) f32, a temperature tensor and one uniform in [0, 1)
    per row (shape ``logits.shape[:-1]``) → the drawn tokens (..., 1).

    The inverse CDF of the softmax over the `k` most likely tokens (ties at
    the k-th kept): the first token whose running sum passes u · the total.
    Only a token of non-zero probability is drawn; where rounding leaves
    none past u · total (u within a rounding of 1), the most likely one is."""
    scaled = logits / temperature
    kth = torch.topk(scaled, min(k, scaled.shape[-1]), dim=-1).values[..., -1:]
    probs = torch.softmax(scaled.masked_fill(scaled < kth, NEG_INF), dim=-1)
    cdf = probs.cumsum(-1)
    hit = (cdf > u.unsqueeze(-1) * cdf[..., -1:]) & (probs > 0)
    return torch.where(hit.any(-1, keepdim=True), hit.int().argmax(-1, keepdim=True),
                       scaled.argmax(-1, keepdim=True))


def _refuse(who: str, config, checks: dict) -> None:
    """Raise for the first config flag whose value is not the implemented one."""
    for name, ok in checks.items():
        value = getattr(config, name, None)
        if not ok(value):
            raise ValueError(f"{who}: config.{name}={value!r} is not implemented by the port's decode steps "
                             "(graphs=False decodes through transformers' own forward)")


def _dense(module: nn.Module) -> Callable[[torch.Tensor], torch.Tensor]:
    """x @ W + b on `module`'s own tensors: an ``nn.Linear`` (W stored (out,
    in)) or transformers' ``Conv1D`` (W stored (in, out))."""
    if isinstance(module, nn.Linear):
        return lambda x: F.linear(x, module.weight, module.bias)
    if type(module).__name__ == "Conv1D" and module.weight.dim() == 2:
        w, b = module.weight, module.bias
        return lambda x: torch.addmm(b, x.reshape(-1, w.shape[0]), w).view(*x.shape[:-1], w.shape[1])
    raise ValueError(f"{type(module).__name__}: neither nn.Linear nor Conv1D")


def _norm(module: nn.LayerNorm) -> Callable[[torch.Tensor], torch.Tensor]:
    return lambda x: F.layer_norm(x, module.normalized_shape, module.weight, module.bias, module.eps)


def _heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(1, T, D) → (1, H, T, D / H)."""
    return x.view(x.shape[0], x.shape[1], n_heads, -1).transpose(1, 2)


def _merge(x: torch.Tensor) -> torch.Tensor:
    """(1, H, T, d) → (1, T, H · d)."""
    return x.transpose(1, 2).reshape(x.shape[0], x.shape[2], -1)


def _attend(q, k, v, allowed=None) -> torch.Tensor:
    """Softmax attention scaled by 1/√d; `allowed` (bool, broadcast to the
    scores) selects the keys a query sees.  A row with none would be NaN,
    and so would every output that weighs its value by 0, so every row keeps
    at least one."""
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if allowed is not None:
        scores = scores.masked_fill(~allowed, NEG_INF)
    return torch.softmax(scores, dim=-1) @ v


class StaticKV:
    """Per layer, key and value buffers (1, H, length, d) of a fixed
    length; the valid-slot mask (1, length); the device counter of the slot
    the next token is written to."""

    def __init__(self, layers: int, heads: int, length: int, head_dim: int, dtype, device):
        shape = (1, heads, length, head_dim)
        self.k = [torch.zeros(shape, dtype=dtype, device=device) for _ in range(layers)]
        self.v = [torch.zeros(shape, dtype=dtype, device=device) for _ in range(layers)]
        self.valid = torch.zeros((1, length), dtype=torch.bool, device=device)
        self.slot = torch.zeros((), dtype=torch.long, device=device)
        self.length = length

    def open_slot(self) -> torch.Tensor:
        """Mark the counter's slot valid (a token attends to itself) → its
        index as a (1,) tensor."""
        at = self.slot.view(1)
        self.valid.index_fill_(1, at, True)
        return at

    def write(self, layer: int, at: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
        """One token's (1, H, 1, d) key and value into the slot `at`."""
        self.k[layer].index_copy_(2, at, k)
        self.v[layer].index_copy_(2, at, v)

    def attend(self, layer: int, q: torch.Tensor) -> torch.Tensor:
        return _attend(q, self.k[layer], self.v[layer], self.valid[:, None, None, :])


class GPT2Decoder:
    """A ``GPT2LMHeadModel``'s prefill and one-token decode step over a
    ``StaticKV`` (the module docstring)."""

    def __init__(self, model: nn.Module, buckets: Sequence[int], max_new_tokens: int):
        cfg = model.config
        _refuse("GPT2Decoder", cfg, {
            "model_type": lambda v: v == "gpt2",
            "add_cross_attention": lambda v: not v,
            "scale_attn_weights": lambda v: v is True,
            "scale_attn_by_inverse_layer_idx": lambda v: not v,
            "reorder_and_upcast_attn": lambda v: not v,
            "activation_function": lambda v: v in ("gelu_new", "gelu_pytorch_tanh"),
        })
        body = model.transformer
        self.wte, self.wpe = body.wte.weight, body.wpe.weight
        self.heads = cfg.n_head
        self.blocks = [dict(ln_1=_norm(b.ln_1), c_attn=_dense(b.attn.c_attn), c_proj=_dense(b.attn.c_proj),
                            ln_2=_norm(b.ln_2), c_fc=_dense(b.mlp.c_fc), m_proj=_dense(b.mlp.c_proj))
                       for b in body.h]
        self.ln_f = _norm(body.ln_f)
        self.head = _dense(model.lm_head)
        d, dtype, device = self.wte.shape[1], self.wte.dtype, self.wte.device
        self.max_new_tokens = int(max_new_tokens)
        length = max(buckets) + self.max_new_tokens
        if length > self.wpe.shape[0]:
            raise ValueError(f"GPT2Decoder: {max(buckets)} + {max_new_tokens} slots pass the position table's "
                             f"{self.wpe.shape[0]}")
        self.kv = StaticKV(len(self.blocks), self.heads, length, d // self.heads, dtype, device)
        self.ids: Dict[int, torch.Tensor] = {}  # bucket → (1, bucket) token ids
        self.mask: Dict[int, torch.Tensor] = {}  # bucket → (1, bucket) True at a real token
        self.tok = torch.zeros((1, 1), dtype=torch.long, device=device)
        self.logits = torch.zeros((1, self.wte.shape[0]), dtype=torch.float32, device=device)
        self.pos = torch.zeros((), dtype=torch.long, device=device)  # the next token's position
        self.n = torch.zeros((), dtype=torch.long, device=device)  # new tokens chosen this turn
        self.u = torch.zeros((self.max_new_tokens,), dtype=torch.float32, device=device)
        self.temperature = torch.ones((), dtype=torch.float32, device=device)

    def inputs(self, bucket: int) -> tuple:
        """The bucket's static (ids, mask), made at its first use."""
        if bucket + self.max_new_tokens > self.kv.length:
            raise ValueError(f"GPT2Decoder: bucket {bucket} passes the cache's {self.kv.length} slots")
        if bucket not in self.ids:
            self.ids[bucket] = torch.zeros((1, bucket), dtype=torch.long, device=self.tok.device)
            self.mask[bucket] = torch.zeros((1, bucket), dtype=torch.bool, device=self.tok.device)
        return self.ids[bucket], self.mask[bucket]

    def _mlp(self, blk: dict, x: torch.Tensor) -> torch.Tensor:
        return x + blk["m_proj"](F.gelu(blk["c_fc"](blk["ln_2"](x)), approximate="tanh"))

    def _qkv(self, blk: dict, x: torch.Tensor) -> tuple:
        q, k, v = blk["c_attn"](blk["ln_1"](x)).split(x.shape[-1], dim=-1)
        return _heads(q, self.heads), _heads(k, self.heads), _heads(v, self.heads)

    def _finish(self, x: torch.Tensor, sample: bool) -> None:
        """The last position's logits, then the token: the argmax, or drawn
        with the uniform of this new token."""
        self.logits.copy_(self.head(self.ln_f(x[:, -1])))
        if sample:
            u = self.u.index_select(0, self.n.clamp(max=self.max_new_tokens - 1).view(1))
            tok = sample_top_k(self.logits, self.temperature, u)
        else:
            tok = self.logits.argmax(-1, keepdim=True)
        self.tok.copy_(tok)
        self.n.add_(1)

    def prefill(self, bucket: int, sample: bool) -> None:
        ids, mask = self.inputs(bucket)
        kv = self.kv
        x = F.embedding(ids, self.wte) + F.embedding((mask.long().cumsum(-1) - 1).clamp(min=0), self.wpe)
        eye = torch.eye(bucket, dtype=torch.bool, device=ids.device)
        allowed = (eye | mask[:, None, :]) & torch.ones_like(eye).tril()  # a pad query sees itself alone
        for i, blk in enumerate(self.blocks):
            q, k, v = self._qkv(blk, x)
            kv.k[i][:, :, :bucket].copy_(k)
            kv.v[i][:, :, :bucket].copy_(v)
            x = x + blk["c_proj"](_merge(_attend(q, k, v, allowed[:, None])))
            x = self._mlp(blk, x)
        kv.valid.zero_()
        kv.valid[:, :bucket].copy_(mask)
        kv.slot.fill_(bucket)
        self.pos.copy_(mask.sum())
        self.n.zero_()
        self._finish(x, sample)

    def step(self, sample: bool) -> None:
        kv = self.kv
        x = F.embedding(self.tok, self.wte) + F.embedding(self.pos.view(1, 1), self.wpe)
        at = kv.open_slot()
        for i, blk in enumerate(self.blocks):
            q, k, v = self._qkv(blk, x)
            kv.write(i, at, k, v)
            x = x + blk["c_proj"](_merge(kv.attend(i, q)))
            x = self._mlp(blk, x)
        kv.slot.add_(1)
        self.pos.add_(1)
        self._finish(x, sample)


class WhisperDecoder:
    """A ``WhisperForConditionalGeneration``'s encoder with the cross-
    attention keys and values, and its greedy one-token decode step with the
    generation config's rules (the module docstring)."""

    def __init__(self, model: nn.Module, max_length: int, start: int, suppress: Iterable[int] = (),
                 begin_suppress: Iterable[int] = (), begin_index: int = 1, forced: Dict[int, int] = None):
        cfg = model.config
        _refuse("WhisperDecoder", cfg, {
            "model_type": lambda v: v == "whisper",
            "activation_function": lambda v: v == "gelu",
            "scale_embedding": lambda v: not v,
        })
        enc, dec = model.model.encoder, model.model.decoder
        self.convs = [enc.conv1, enc.conv2]
        self.enc_pos = enc.embed_positions.weight
        self.enc_layers = [self._layer(layer) for layer in enc.layers]
        self.enc_norm = _norm(enc.layer_norm)
        self.embed, self.dec_pos = dec.embed_tokens.weight, dec.embed_positions.weight
        self.dec_layers = [dict(self._layer(layer), cross_ln=_norm(layer.encoder_attn_layer_norm),
                                cross_q=_dense(layer.encoder_attn.q_proj), cross_k=_dense(layer.encoder_attn.k_proj),
                                cross_v=_dense(layer.encoder_attn.v_proj), cross_o=_dense(layer.encoder_attn.out_proj))
                           for layer in dec.layers]
        self.dec_norm = _norm(dec.layer_norm)
        self.head = _dense(model.proj_out)
        self.enc_heads, self.heads = cfg.encoder_attention_heads, cfg.decoder_attention_heads
        if max_length > self.dec_pos.shape[0]:
            raise ValueError(f"WhisperDecoder: max_length {max_length} passes the {self.dec_pos.shape[0]} positions")
        vocab, d = self.embed.shape
        dtype, device = self.embed.dtype, self.embed.device
        frames = enc.config.max_source_positions
        self.feats = torch.zeros((1, cfg.num_mel_bins, 2 * frames), dtype=dtype, device=device)
        self.cross_k = [torch.zeros((1, self.heads, frames, d // self.heads), dtype=dtype, device=device)
                        for _ in self.dec_layers]
        self.cross_v = [torch.zeros_like(t) for t in self.cross_k]
        self.kv = StaticKV(len(self.dec_layers), self.heads, max_length, d // self.heads, dtype, device)
        self.start = int(start)
        self.tok = torch.zeros((1, 1), dtype=torch.long, device=device)
        self.logits = torch.zeros((1, vocab), dtype=torch.float32, device=device)
        # the rules' tables: indexed by the step, the index in the sequence of the token chosen
        self.suppress = torch.zeros(vocab, dtype=torch.bool, device=device)
        self.suppress[list(suppress)] = True
        self.begin_suppress = torch.zeros(vocab, dtype=torch.bool, device=device)
        self.begin_suppress[list(begin_suppress)] = True
        self.begin_index = int(begin_index)
        self.forced = torch.full((max_length,), -1, dtype=torch.long, device=device)
        for i, t in (forced or {}).items():
            if i < max_length:
                self.forced[i] = t
        self.vocab = torch.arange(vocab, device=device)

    @staticmethod
    def _layer(layer) -> dict:
        attn = layer.self_attn
        return dict(ln=_norm(layer.self_attn_layer_norm), q=_dense(attn.q_proj), k=_dense(attn.k_proj),
                    v=_dense(attn.v_proj), o=_dense(attn.out_proj), mlp_ln=_norm(layer.final_layer_norm),
                    fc1=_dense(layer.fc1), fc2=_dense(layer.fc2))

    @staticmethod
    def _mlp(lay: dict, x: torch.Tensor) -> torch.Tensor:
        return x + lay["fc2"](F.gelu(lay["fc1"](lay["mlp_ln"](x))))

    def encode(self) -> None:
        x = self.feats
        for conv in self.convs:
            x = F.gelu(F.conv1d(x, conv.weight, conv.bias, conv.stride, conv.padding, conv.dilation, conv.groups))
        frames = x.shape[-1]
        x = x.transpose(1, 2) + self.enc_pos[:frames]
        for lay in self.enc_layers:
            h = lay["ln"](x)
            q, k, v = (_heads(lay[n](h), self.enc_heads) for n in ("q", "k", "v"))
            x = x + lay["o"](_merge(_attend(q, k, v)))
            x = self._mlp(lay, x)
        x = self.enc_norm(x)
        for lay, ck, cv in zip(self.dec_layers, self.cross_k, self.cross_v):
            ck.copy_(_heads(lay["cross_k"](x), self.heads))
            cv.copy_(_heads(lay["cross_v"](x), self.heads))
        self.kv.valid.zero_()
        self.kv.slot.zero_()
        self.tok.fill_(self.start)

    def _rules(self, logits: torch.Tensor, step: torch.Tensor) -> torch.Tensor:
        """Suppress, suppress at the first free step, force: the Flax
        processors' order."""
        logits = logits.masked_fill(self.suppress, NEG_INF)
        logits = logits.masked_fill(self.begin_suppress & (step == self.begin_index), NEG_INF)
        forced = self.forced.index_select(0, step.view(1))
        return torch.where(forced >= 0, torch.where(self.vocab == forced, 0.0, NEG_INF), logits)

    def step(self) -> None:
        kv = self.kv
        x = F.embedding(self.tok, self.embed) + F.embedding(kv.slot.view(1, 1), self.dec_pos)
        at = kv.open_slot()
        for i, (lay, ck, cv) in enumerate(zip(self.dec_layers, self.cross_k, self.cross_v)):
            h = lay["ln"](x)
            q, k, v = (_heads(lay[n](h), self.heads) for n in ("q", "k", "v"))
            kv.write(i, at, k, v)
            x = x + lay["o"](_merge(kv.attend(i, q)))
            x = x + lay["cross_o"](_merge(_attend(_heads(lay["cross_q"](lay["cross_ln"](x)), self.heads), ck, cv)))
            x = self._mlp(lay, x)
        kv.slot.add_(1)
        self.logits.copy_(self._rules(self.head(self.dec_norm(x))[:, -1].float(), kv.slot))
        self.tok.copy_(self.logits.argmax(-1, keepdim=True))


@dataclasses.dataclass
class _Entry:
    graph: Any  # torch.cuda.CUDAGraph; None on the CPU
    capture_ms: float
    replays: int = 0


class DecodeGraphs(GraphCache):
    """Key → the captured step of an adapter's decoder (the module
    docstring).  A turn holds ``lock`` from its copy in to its last read."""

    def __init__(self, device):
        super().__init__(device)
        self._host = torch.zeros(1, dtype=torch.long, pin_memory=self.capture)
        self._stamp = None

    def watch(self, model: nn.Module) -> bool:
        """Whether `model`'s parameters moved (another tensor, or a write)
        since the last call; if so every graph is dropped, and the caller
        builds its decoder anew on the new tensors."""
        stamp = weights_stamp(list(model.parameters()) + list(model.buffers()))
        moved = self._stamp is not None and stamp != self._stamp
        if moved:
            self.drop()
        self._stamp = stamp
        return moved

    def run(self, key: Hashable, fn: Callable[[], None]) -> None:
        """fn() through the graph of `key`: on the card the first call is the
        real step as the warm run, then the capture; a later one replays."""
        entry = self._graphs.get((key, ()))
        if entry is None:
            if self.capture:
                graph, _, _, _, capture_ms = self.capture_graph(fn, fn)
            else:
                graph, capture_ms = None, 0.0
                fn()
            self._graphs[(key, ())] = _Entry(graph, capture_ms)
            return
        if entry.graph is None:
            fn()
        else:
            entry.graph.replay()
        entry.replays += 1

    def read(self, t: torch.Tensor) -> int:
        """A one-element tensor's value on the host: on the card through the
        pinned buffer, waiting on the current stream only."""
        if not self.capture:
            return int(t)
        self._host.copy_(t.view(1), non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return int(self._host[0])

