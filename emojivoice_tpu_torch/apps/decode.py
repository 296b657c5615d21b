"""The chat LM's and Whisper's decode steps over a static key/value cache,
and the CUDA graphs that replay them: the port's counterparts of the decode
loops inside transformers' Flax ``generate`` (``FlaxGPT2LMHeadModel`` over
its ``init_cache``; ``FlaxWhisperForConditionalGeneration``'s ``encode``,
then ``decode`` over ``init_cache``), which
``emojivoice_tpu/apps/flax_adapters.py`` compiles as one program for Whisper
(``FlaxWhisperASR._generate``) and one per (prompt bucket, sampling) for the
chat LM (``FlaxChatLM._program``).

``GPT2Decoder``, ``LlamaDecoder`` and ``WhisperDecoder`` compute on a
transformers PyTorch model's own parameter tensors (shared, not copied) and
read and write only
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
* The Llama family (llama, mistral, gemma): the same contract and cache,
  which holds the key/value heads (fewer than the query heads under grouped
  attention; each group of query heads reads its own).  RMSNorm (Gemma's
  scales by 1 + w in f32), rotary positions from cos/sin tables made once
  for the cache's slots from the model's own rotary module (its
  ``inv_freq`` and ``attention_scaling``, so every static rope type the
  module implements: default, linear, llama3, yarn), the gated MLP (SiLU;
  Gemma's tanh GELU), Gemma's embedding scaled by √hidden.  Positions and
  pad queries as GPT-2's.
* GPT-Neo, OPT, XGLM, BLOOM, GPT-J and BART (``GPTNeoDecoder``,
  ``OPTDecoder``, ``XGLMDecoder``, ``BloomDecoder``, ``GPTJDecoder``,
  ``BartDecoder``): the same contract and cache, through ``_StepDecoder``'s
  prefill and step.  GPT-Neo: learned positions, no 1/√d scaling, a local
  layer's keys within ``window_size`` slots of the query (inside a turn the
  slot distance is the position distance).  OPT: learned positions offset
  by 2, pre- or post-LayerNorm layers, ``project_in`` / ``project_out``
  around the layers, q scaled before the product.  XGLM: sinusoidal
  positions offset by 2 from a table made once for the cache's slots (the
  model's own ``embed_positions`` adds to its input in place and may grow
  its table, so a step never calls it), the embedding scaled by √d.  BLOOM:
  ALiBi, the bias of a key its head's slope times the key's real-token
  position, which the cache keeps per slot.  GPT-J: rotary positions on the
  first ``rotary_dim`` of each head in interleaved pairs, from the model's
  own sin/cos table, attention and MLP in parallel off one LayerNorm.  BART
  (``BartForCausalLM``): learned positions offset by 2, the embedding
  scaled by √d where ``scale_embedding`` and then its LayerNorm, OPT's
  post-LN layer, no final LayerNorm, no cross-attention.
* DeepSeek-V2 (``DeepseekV2Decoder``): the same contract through
  ``_StepDecoder``'s skeleton over another cache, ``LatentKV`` (per slot
  the RMSNormed latent and the rotated key part every head shares):
  multi-head latent attention, decompressed in the prefill and absorbed in
  a step; the routed experts through ``ops/moe.py`` (K3 on the card), the
  pad rows of a prefill routed nowhere; the published softmax scale
  (``mla_softmax_scale``).
* Whisper.  ``encode()`` runs the encoder on the (1, n_mels, 3000)
  features, makes each decoder layer's cross-attention keys and values once
  and resets the cache; ``step()`` feeds the last token, applies the
  generation config's rules (``ChatRules`` after a one-token prompt, the
  start token) and takes the argmax.

How a chat decoder chooses its tokens (``ChatSearch``, from the generation
config as the Flax ``generate`` reads it for ``FlaxChatLM``'s call):

* the logits processors (``ChatRules``, in Flax's order): ``min_length``,
  ``forced_bos_token_id``, ``forced_eos_token_id``, ``suppress_tokens``,
  ``begin_suppress_tokens`` and ``forced_decoder_ids``, from tables made at
  construction, indexed by the new token's device counter and by the
  bucket, a device scalar that the prefill sets, so that one decode graph
  serves every bucket;
* greedy: the argmax;
* sampling (``sample_top_k``): ``warp``'s temperature, top-k (the
  generation config's ``top_k``; exactly k kept, ties going to the lower
  token id as in ``lax.top_k``) and top-p, then the token drawn by inverse
  CDF from one uniform, the turn's uniforms all drawn before the turn from
  its own generator;
* where ``num_beams`` > 1, greedy only, a beam search (``beam_step``: Flax's
  ``_beam_search``): the cache and the last tokens hold one row per beam,
  the prefill runs once on the prompt and its keys and values fill every
  row, each step keeps 2 · beams candidates, tracks the running and the
  finished beams with ``length_penalty``, reorders the cache by the chosen
  beams in place and computes Flax's stop condition (``early_stopping``
  True, False or ``"never"``) into a device flag that the host reads once a
  step.

What ``FlaxChatLM`` cannot run, ``no_repeat_ngram_size`` and beam
sampling, is refused by name.  Each decoder refuses, by name, a
configuration whose forward it does not implement.

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
from typing import Any, Callable, Dict, Hashable, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from emojivoice_tpu_torch.ops import moe
from emojivoice_tpu_torch.utils.cuda_graphs import GraphCache, weights_stamp

NEG_INF = float("-inf")
NEG_BIG = -1.0e7  # Flax's beam search: the score of an empty or closed beam


def _top(x: torch.Tensor, k: int) -> tuple:
    """The k largest of x's last axis, largest first, and their indices;
    among equal values the lower index first, as ``lax.top_k`` orders them
    (a stable sort: ``torch.topk`` leaves the order of ties open)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def warp(logits: torch.Tensor, temperature, top_k=None, top_p=None) -> torch.Tensor:
    """The Flax ``generate``'s sampling warpers in its order (its
    ``_get_logits_warper``): the logits over the temperature, then top-k
    (exactly k kept; among logits tied at the k-th the lower token ids, as
    ``lax.top_k`` keeps them), then top-p (``FlaxTopPLogitsWarper``: of the
    tokens sorted by probability, those whose cumulative probability is
    under `top_p`, the one that crosses it, and at least one); the dropped
    tokens -inf.  `top_k` None or 0 and `top_p` None keep every token."""
    scaled = logits / temperature
    if not top_k and top_p is None:
        return scaled
    values, order = torch.sort(scaled, dim=-1, descending=True, stable=True)
    keep = torch.ones_like(values, dtype=torch.bool)
    if top_k:
        keep[..., top_k:] = False
        values = values.masked_fill(~keep, NEG_INF)
    if top_p is not None:
        below = torch.softmax(values, dim=-1).cumsum(-1) < top_p
        keep = keep & torch.cat((torch.ones_like(below[..., :1]), below[..., :-1]), dim=-1)
    return scaled.masked_fill(~torch.zeros_like(keep).scatter(-1, order, keep), NEG_INF)


def sample_top_k(logits: torch.Tensor, temperature: torch.Tensor, u: torch.Tensor, k, top_p) -> torch.Tensor:
    """Logits (..., V) f32, a temperature tensor and one uniform in [0, 1)
    per row (shape ``logits.shape[:-1]``) → the drawn tokens (..., 1).

    The inverse CDF of the softmax over the tokens ``warp`` keeps (`k`: its
    top_k, `top_p`): the first token whose running sum passes u · the total.
    Only a token of non-zero probability is drawn; where rounding leaves
    none past u · total (u within a rounding of 1), the most likely one is."""
    scaled = warp(logits, temperature, k, top_p)
    probs = torch.softmax(scaled, dim=-1)
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


def _attend(q, k, v, allowed=None, scale=None, bias=None) -> torch.Tensor:
    """Softmax attention of q (1, H, T, d) over k, v (1, G, L, d), H = G · r:
    query head h reads key/value head h // r (grouped attention; r = 1 for
    GPT-2 and Whisper) without copying the keys and values out per query
    head.  Scores are scaled by `scale` (1/√d where None), `bias` (1, H, T |
    1, L; H = G) is added (ALiBi) and the softmax is taken in f32;
    `allowed` (bool, (1, 1, T | 1, L)) selects the keys a query sees.  A row with none would be NaN, and so would every output that
    weighs its value by 0, so every row keeps at least one."""
    b, h, t, d = q.shape
    g = k.shape[1]
    if g != h:
        q = q.reshape(b, g, (h // g) * t, d)
    scores = q @ k.transpose(-1, -2)
    scores = scores / math.sqrt(d) if scale is None else scores * scale
    if bias is not None:
        scores = scores + bias
    scores = scores.view(b, g, h // g, t, -1)
    if allowed is not None:
        scores = scores.masked_fill(~allowed.unsqueeze(2), NEG_INF)
    weights = torch.softmax(scores.float(), dim=-1).to(v.dtype)
    return (weights.view(b, g, (h // g) * t, -1) @ v).view(b, h, t, d)


def _rms_norm(module: nn.Module, offset: bool) -> Callable[[torch.Tensor], torch.Tensor]:
    """RMSNorm on `module`'s own weight and epsilon: w · x̂ in the input's
    dtype (Llama, Mistral), or (1 + w) · x̂ in f32 and then cast (`offset`:
    Gemma), x̂ normalised in f32."""
    w = module.weight
    eps = getattr(module, "variance_epsilon", None)
    eps = module.eps if eps is None else eps

    def norm(x):
        h = x.float()
        h = h * torch.rsqrt(h.pow(2).mean(-1, keepdim=True) + eps)
        return (h * (1.0 + w.float())).type_as(x) if offset else w * h.to(x.dtype)
    return norm


def _rope_type(rotary: nn.Module, config) -> str:
    """The rotary type: the module's own, else the config's (``rope_scaling``
    in transformers 4, ``rope_parameters`` in 5), else ``"default"``."""
    found = getattr(rotary, "rope_type", None)
    for name in ("rope_parameters", "rope_scaling"):
        params = getattr(config, name, None)
        if found is None and isinstance(params, dict):
            found = params.get("rope_type", params.get("type"))
    return found or "default"


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotary positions: x · cos + rotate_half(x) · sin, the halves split
    as transformers' Llama splits them."""
    x1, x2 = x.chunk(2, dim=-1)
    return x * cos + torch.cat((-x2, x1), dim=-1) * sin


class StaticKV:
    """Per layer, key and value buffers (batch, G, length, d) of a fixed
    length, one row of G per key/value head and one batch row per beam (1
    without beams); the valid-slot mask (1, length), which the beams share;
    the device counter of the slot the next token is written to."""

    def __init__(self, layers: int, heads: int, length: int, head_dim: int, dtype, device, batch: int = 1):
        shape = (batch, heads, length, head_dim)
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
        """One token's (batch, H, 1, d) key and value into the slot `at`."""
        self.k[layer].index_copy_(2, at, k)
        self.v[layer].index_copy_(2, at, v)

    def attend(self, layer: int, q: torch.Tensor, scale=None) -> torch.Tensor:
        return _attend(q, self.k[layer], self.v[layer], self.valid[:, None, None, :], scale)

    def reorder(self, beams: torch.Tensor) -> None:
        """Each batch row takes the keys and values of the row `beams` names,
        in place (a beam search's chosen beams)."""
        for t in self.k + self.v:
            t.copy_(t.index_select(0, beams))


class LatentKV:
    """Multi-head latent attention's cache (DeepSeek-V2): per layer the
    RMSNormed latent c of every slot, (batch, length, rank), and its rotated
    key part, one head shared by all, (batch, length, rope); 576 values a
    slot at DeepSeek-V2-Lite's widths against ``StaticKV``'s heads · (key +
    value).  The valid-slot mask, the slot counter and the beams' reorder are
    ``StaticKV``'s."""

    def __init__(self, layers: int, rank: int, rope: int, length: int, dtype, device, batch: int = 1):
        self.c = [torch.zeros((batch, length, rank), dtype=dtype, device=device) for _ in range(layers)]
        self.pe = [torch.zeros((batch, length, rope), dtype=dtype, device=device) for _ in range(layers)]
        self.valid = torch.zeros((1, length), dtype=torch.bool, device=device)
        self.slot = torch.zeros((), dtype=torch.long, device=device)
        self.length = length

    open_slot = StaticKV.open_slot

    def write(self, layer: int, at: torch.Tensor, c: torch.Tensor, pe: torch.Tensor) -> None:
        """One token's (batch, 1, rank) latent and (batch, 1, rope) key part into the slot `at`."""
        self.c[layer].index_copy_(1, at, c)
        self.pe[layer].index_copy_(1, at, pe)

    def reorder(self, beams: torch.Tensor) -> None:
        for t in self.c + self.pe:
            t.copy_(t.index_select(0, beams))


def token_list(ids) -> list:
    return [] if ids is None else [int(i) for i in ([ids] if isinstance(ids, int) else ids)]


def _when(cond, then: torch.Tensor, other: torch.Tensor) -> torch.Tensor:
    """`then` where `cond` (a Python bool, or a 0-d tensor on their device
    inside a step) holds, else `other`."""
    if isinstance(cond, bool):
        return then if cond else other
    return torch.where(cond, then, other)


class ChatRules:
    """The generation config's logits processors that the Flax ``generate``
    applies (its ``_get_logits_processor``), in its order, each from tables
    made at construction; shared by the chat LM's decoders, its eager loop
    and Whisper's.  Flax indexes them by ``cur_len``, the index in the
    sequence of the token being chosen, which is the prompt's length (the
    bucket; Whisper's start token: 1) plus the new token's index n:

    * ``min_length``: eos -inf while ``cur_len <= min_length``;
    * ``forced_bos_token_id`` where ``cur_len`` is 1 (the first new token of
      a one-token prompt);
    * ``forced_eos_token_id`` at the last of ``max_new_tokens``;
    * ``suppress_tokens`` -inf at every step;
    * ``begin_suppress_tokens`` -inf at ``cur_len`` = the prompt's length,
      plus one where it is 1 and a bos is forced, plus the last
      ``forced_decoder_ids`` index;
    * ``forced_decoder_ids``: index i forces its token at ``cur_len`` =
      prompt + i - 1, i.e. at new token n = i - 1.

    A forced token: every other logit -inf, its own 0.  ``__call__`` takes n
    and the prompt's length as Python ints (eager) or 0-d device tensors (a
    step: one decode graph serves every bucket)."""

    def __init__(self, gen, vocab: int, max_new_tokens: int, device):
        field = lambda name: getattr(gen, name, None)  # noqa: E731
        self.last = int(max_new_tokens) - 1
        self.vocab = torch.arange(vocab, device=device)
        eos = token_list(field("eos_token_id"))
        min_length = field("min_length")
        # cur_len is at least 1: a min_length under 1 never bites
        self.min_length = int(min_length) if min_length is not None and min_length >= 1 and eos else None
        self.eos_mask = self._mask(eos, vocab, device)
        self.bos, self.eos = (None if field(name) is None else self._row(field(name), vocab, device)
                              for name in ("forced_bos_token_id", "forced_eos_token_id"))
        self.suppress = None if field("suppress_tokens") is None else self._mask(field("suppress_tokens"), vocab,
                                                                                   device)
        self.begin = None if field("begin_suppress_tokens") is None else self._mask(
            field("begin_suppress_tokens"), vocab, device)
        forced = [(int(i), t) for i, t in (field("forced_decoder_ids") or [])]
        self.begin_offset = forced[-1][0] if forced else 0
        self.forced = None
        if forced:
            self.forced = torch.full((max(i for i, _ in forced) + 1,), -1, dtype=torch.long, device=device)
            for i, t in forced:
                if t is not None:
                    self.forced[i] = int(t)

    @staticmethod
    def _mask(tokens, vocab: int, device) -> torch.Tensor:
        """True at `tokens` (those past the vocabulary can never be chosen)."""
        mask = torch.zeros(vocab, dtype=torch.bool, device=device)
        mask[[t for t in token_list(tokens) if 0 <= t < vocab]] = True
        return mask

    @staticmethod
    def _row(token, vocab: int, device) -> torch.Tensor:
        row = torch.full((1, vocab), NEG_INF, dtype=torch.float32, device=device)
        row[0, int(token)] = 0.0
        return row

    def __call__(self, logits: torch.Tensor, n, prompt) -> torch.Tensor:
        """(batch, V) f32 scores of new token `n` after a prompt of `prompt`
        tokens → after the rules."""
        cur = prompt + n
        if self.min_length is not None:
            logits = _when(cur <= self.min_length, logits.masked_fill(self.eos_mask, NEG_INF), logits)
        if self.bos is not None:
            logits = _when(cur == 1, self.bos, logits)
        if self.eos is not None:
            logits = _when(n == self.last, self.eos, logits)
        if self.suppress is not None:
            logits = logits.masked_fill(self.suppress, NEG_INF)
        if self.begin is not None:
            begin = prompt + self.begin_offset + ((prompt == 1) * 1 if self.bos is not None else 0)
            logits = _when(cur == begin, logits.masked_fill(self.begin, NEG_INF), logits)
        if self.forced is not None:
            i = n + 1  # the forced_decoder_ids index of this token
            tok = self.forced.index_select(0, torch.as_tensor(i, device=logits.device).clamp(max=len(self.forced) - 1)
                                           .view(1))
            hit = (tok >= 0) & torch.as_tensor(i < len(self.forced), device=logits.device)
            logits = torch.where(hit, torch.where(self.vocab == tok, 0.0, NEG_INF), logits)
        return logits


# generation-config fields the Flax generate honours for FlaxChatLM's call and cannot run, so neither does the port:
# name → (the values that change nothing, what FlaxChatLM does with another)
UNSUPPORTED_RULES = {
    "no_repeat_ngram_size": (lambda v: not v, "its generate raises NotImplementedError (bcoo_gather: mode=CLIP)"),
}
# with sampling (temperature > 0): FlaxChatLM's generate runs no beam search
UNSUPPORTED_SAMPLING = {
    "num_beams": (lambda v: v in (None, 1), "its generate raises NotImplementedError (beam sampling)"),
}


def _refuse_rules(who: str, gen, checks: dict) -> None:
    """Raise for the first generation-config field whose value the Flax
    ``generate`` cannot run for ``FlaxChatLM``, and so neither can the port's
    chat decoding, graphed or eager."""
    for name, (ok, flax) in checks.items():
        value = getattr(gen, name, None)
        if not ok(value):
            raise ValueError(f"{who}: generation_config.{name}={value!r} is not implemented by the port's chat "
                             f"decoding, graphed or eager, nor by FlaxChatLM ({flax})")


class ChatSearch:
    """How the chat LM chooses its tokens, from the generation config as the
    Flax ``generate`` reads it for ``FlaxChatLM``'s call: the logits
    processors (``rules``), the sampling warpers' ``top_k`` (None or 0: none)
    and ``top_p`` (None where ≥ 1), and, for greedy decoding with
    ``num_beams`` > 1, the beam search's ``beams``, ``length_penalty`` and
    ``early_stopping`` (True, False or ``"never"``), its ``eos`` ids and the
    ``fill`` of a sequence past its end.  Refuses by name what Flax cannot
    run (``UNSUPPORTED_RULES``; with `sample`, ``UNSUPPORTED_SAMPLING``)."""

    def __init__(self, gen, vocab: int, max_new_tokens: int, device, sample: bool = False):
        _refuse_rules("TorchChatLM", gen, {**UNSUPPORTED_RULES, **(UNSUPPORTED_SAMPLING if sample else {})})

        def field(name, default=None):  # an unset field (None) reads as Flax's default
            value = getattr(gen, name, None)
            return default if value is None else value

        self.rules = ChatRules(gen, vocab, max_new_tokens, device)
        self.top_k = int(field("top_k", 50)) or None  # only an explicit 0 turns top-k off
        self.top_p = float(field("top_p")) if field("top_p", 1.0) < 1.0 else None
        self.beams = int(field("num_beams", 1))
        self.length_penalty = float(field("length_penalty", 1.0))
        self.early_stopping = field("early_stopping", False)
        self.eos = tuple(token_list(field("eos_token_id")))
        self.fill = int(field("pad_token_id", self.eos[0] if self.eos else 0))
        self.max_new_tokens = int(max_new_tokens)


def beam_state(search: ChatSearch, device) -> dict:
    """The device tensors of one beam search (Flax's ``BeamSearchState``
    without the prompt, which every beam shares): the running and finished
    beams' new tokens (beams, max_new_tokens) and scores, the finished
    flags, the running beams' last tokens (beams, 1) and the stop flag."""
    k, n = search.beams, search.max_new_tokens
    state = dict(running=torch.zeros((k, n), dtype=torch.long, device=device),
                 running_scores=torch.zeros(k, dtype=torch.float32, device=device),
                 seqs=torch.zeros((k, n), dtype=torch.long, device=device),
                 scores=torch.zeros(k, dtype=torch.float32, device=device),
                 finished=torch.zeros(k, dtype=torch.bool, device=device),
                 tok=torch.zeros((k, 1), dtype=torch.long, device=device),
                 done=torch.zeros((), dtype=torch.bool, device=device),
                 first_scores=torch.full((k,), NEG_BIG, dtype=torch.float32, device=device),
                 eos=torch.tensor(search.eos or [-1], dtype=torch.long, device=device))
    state["first_scores"][0] = 0.0  # beam 0 alone is open at the start: the others would repeat it
    return state


def beam_reset(state: dict, search: ChatSearch) -> None:
    """A new search's start, in place: every sequence the fill, beam 0's
    running score 0 and every other score -1e7, nothing finished."""
    state["running"].fill_(search.fill)
    state["running_scores"].copy_(state["first_scores"])
    state["seqs"].fill_(search.fill)
    state["scores"].fill_(NEG_BIG)
    state["finished"].zero_()
    state["done"].zero_()


def beam_step(state: dict, search: ChatSearch, scores: torch.Tensor, n) -> torch.Tensor:
    """One step of the Flax ``generate``'s ``_beam_search`` for one prompt,
    on device tensors and in place: `scores` (beams, V) are the running
    beams' log-probabilities of new token `n` after the rules (a Python int,
    or a 0-d device tensor inside a step).  The 2·beams best continuations
    over all beams; those ending in eos enter the finished beams (their
    score over (n + 1) ** length_penalty, merged with the finished ones by
    score), the others the running beams (the best `beams`); then Flax's
    ``beam_search_cond_fn`` for the next step into ``state["done"]``.
    Returns, for each new running beam, the beam it continues: the rows of
    its key/value cache."""
    k, steps, device = search.beams, search.max_new_tokens, scores.device
    vocab = scores.shape[-1]
    top, index = _top((scores + state["running_scores"][:, None]).reshape(-1), 2 * k)
    beam, tok = index // vocab, index % vocab
    at = torch.as_tensor(n, device=device).view(1)
    seqs = state["running"].index_select(0, beam).index_copy(1, at, tok[:, None])
    ended = (tok[:, None] == state["eos"][None, :]).any(-1)
    running = torch.where(ended, top + NEG_BIG, top)
    nxt = _top(running, k)[1]
    state["running"].copy_(seqs.index_select(0, nxt))
    state["running_scores"].copy_(running.index_select(0, nxt))
    state["tok"].copy_(tok.index_select(0, nxt)[:, None])

    length = torch.as_tensor(n + 1, dtype=torch.float32, device=device)  # the new tokens so far
    penalised = top / length ** search.length_penalty
    full = state["finished"].all() & (search.early_stopping is True)
    penalised = torch.where(~ended | full, penalised + NEG_BIG, penalised)
    merged = torch.cat((state["scores"], penalised))
    best = _top(merged, k)[1]
    state["seqs"].copy_(torch.cat((state["seqs"], seqs)).index_select(0, best))
    state["scores"].copy_(merged.index_select(0, best))
    state["finished"].copy_(torch.cat((state["finished"], ended)).index_select(0, best))

    # beam_search_cond_fn at cur_len + 1: below max_length, a beam still open, an improvement still possible
    if search.early_stopping == "never" and search.length_penalty > 0.0:
        length = torch.as_tensor(float(steps), device=device)
    best_running = state["running_scores"][0] / length ** search.length_penalty
    worst = torch.where(state["finished"], state["scores"].min(), NEG_BIG)
    go = (best_running > worst).any() & ~(state["finished"].all() & (search.early_stopping is True))
    state["done"].copy_(~(go & torch.as_tensor(n + 1 < steps, device=device)))
    return beam.index_select(0, nxt)


def beam_result(state: dict) -> torch.Tensor:
    """The search's best sequence of new tokens, (max_new_tokens,): the best
    finished one, or the best running one where none finished (Flax's
    ``sequences[:, 0]``)."""
    return torch.where(state["finished"].any(), state["seqs"][0], state["running"][0])


class _ChatDecoder:
    """What the chat LM's decoders share: the static inputs of each prompt
    bucket, the last token(s), the step's scores, the counters and the
    turn's uniforms, all made at construction (``_buffers``), and the choice
    of the next token after the generation config's rules (``_finish``):
    the argmax, a draw through the sampling warpers, or, where the search
    has ``beams`` > 1, a step of the beam search over a batch of that many
    rows (``beam_step``; its state in ``beam``), the cache reordered by
    the chosen beams.  A subclass sets ``kv``, ``ln_f`` and ``head``, and
    calls ``_search_for`` with the adapter's ``ChatSearch`` (its
    ``max_new_tokens`` and ``beams``) before it makes its cache (of
    ``batch`` rows)."""

    max_new_tokens: int
    kv: StaticKV
    batch: int = 1

    def _search_for(self, search: ChatSearch) -> None:
        self.search, self.max_new_tokens, self.batch = search, search.max_new_tokens, search.beams

    def _buffers(self, buckets: Sequence[int], vocab: int, device) -> None:
        self.ids: Dict[int, torch.Tensor] = {}  # bucket → (1, bucket) token ids
        self.mask: Dict[int, torch.Tensor] = {}  # bucket → (1, bucket) True at a real token
        self.tok = torch.zeros((self.batch, 1), dtype=torch.long, device=device)
        self.logits = torch.zeros((self.batch, vocab), dtype=torch.float32, device=device)
        self.pos = torch.zeros((), dtype=torch.long, device=device)  # the next token's position
        self.n = torch.zeros((), dtype=torch.long, device=device)  # new tokens chosen this turn
        self.prompt = torch.zeros((), dtype=torch.long, device=device)  # the bucket: the rules' prompt length
        self.u = torch.zeros((self.max_new_tokens,), dtype=torch.float32, device=device)
        self.temperature = torch.ones((), dtype=torch.float32, device=device)
        self.beam = beam_state(self.search, device) if self.batch > 1 else {}

    def inputs(self, bucket: int) -> tuple:
        """The bucket's static (ids, mask), made at its first use."""
        if bucket + self.max_new_tokens > self.kv.length:
            raise ValueError(f"{type(self).__name__}: bucket {bucket} passes the cache's {self.kv.length} slots")
        if bucket not in self.ids:
            self.ids[bucket] = torch.zeros((1, bucket), dtype=torch.long, device=self.tok.device)
            self.mask[bucket] = torch.zeros((1, bucket), dtype=torch.bool, device=self.tok.device)
        return self.ids[bucket], self.mask[bucket]

    def _prefilled(self, bucket: int, mask: torch.Tensor) -> None:
        """After a prefill: the real tokens' slots valid, the next slot and
        position, the bucket, no new token yet (a new beam search)."""
        kv = self.kv
        kv.valid.zero_()
        kv.valid[:, :bucket].copy_(mask)
        kv.slot.fill_(bucket)
        self.pos.copy_(mask.sum())
        self.prompt.fill_(bucket)
        self.n.zero_()
        if self.beam:
            beam_reset(self.beam, self.search)

    def _finish(self, x: torch.Tensor, sample: bool) -> None:
        """The last position's logits after the rules, then the token(s):
        the argmax, drawn with the uniform of this new token, or a beam
        step (a prefill's one row serves every beam)."""
        search = self.search
        logits = self.head(self.ln_f(x[:, -1])).float()
        if self.beam:
            scores = search.rules(torch.log_softmax(logits, dim=-1).expand(self.batch, -1), self.n, self.prompt)
            self.logits.copy_(scores)
            self.kv.reorder(beam_step(self.beam, search, scores, self.n))
            self.tok.copy_(self.beam["tok"])
        else:
            self.logits.copy_(search.rules(logits, self.n, self.prompt))
            if sample:
                u = self.u.index_select(0, self.n.clamp(max=self.max_new_tokens - 1).view(1))
                tok = sample_top_k(self.logits, self.temperature, u, search.top_k, search.top_p)
            else:
                tok = self.logits.argmax(-1, keepdim=True)
            self.tok.copy_(tok)
        self.n.add_(1)


class GPT2Decoder(_ChatDecoder):
    """A ``GPT2LMHeadModel``'s prefill and one-token decode step over a
    ``StaticKV`` (the module docstring)."""

    def __init__(self, model: nn.Module, buckets: Sequence[int], search: ChatSearch):
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
        self._search_for(search)
        length = max(buckets) + self.max_new_tokens
        if length > self.wpe.shape[0]:
            raise ValueError(f"GPT2Decoder: {max(buckets)} + {self.max_new_tokens} slots pass the position table's "
                             f"{self.wpe.shape[0]}")
        self.kv = StaticKV(len(self.blocks), self.heads, length, d // self.heads, dtype, device, self.batch)
        self._buffers(buckets, self.wte.shape[0], device)

    def _mlp(self, blk: dict, x: torch.Tensor) -> torch.Tensor:
        return x + blk["m_proj"](F.gelu(blk["c_fc"](blk["ln_2"](x)), approximate="tanh"))

    def _qkv(self, blk: dict, x: torch.Tensor) -> tuple:
        q, k, v = blk["c_attn"](blk["ln_1"](x)).split(x.shape[-1], dim=-1)
        return _heads(q, self.heads), _heads(k, self.heads), _heads(v, self.heads)

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
        self._prefilled(bucket, mask)
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


# the Llama family's model types; the MLP activations its steps implement
LLAMA_FAMILY = ("llama", "mistral", "gemma")
ACTIVATIONS = {"silu": F.silu, "gelu_pytorch_tanh": lambda x: F.gelu(x, approximate="tanh")}
# rotary types whose frequencies change with the sequence's length: a table made once cannot hold them
DYNAMIC_ROPE = ("dynamic", "longrope")


class LlamaDecoder(_ChatDecoder):
    """A ``LlamaForCausalLM``'s, ``MistralForCausalLM``'s or
    ``GemmaForCausalLM``'s prefill and one-token decode step over a
    ``StaticKV`` of its key/value heads, with ``GPT2Decoder``'s contract:
    ``inputs(bucket)``, ``prefill(bucket, sample)``, ``step(sample)`` (the
    module docstring).  ``pretraining_tp`` is not refused: transformers'
    PyTorch forward of these models (4.57) does not read it."""

    def __init__(self, model: nn.Module, buckets: Sequence[int], search: ChatSearch):
        cfg = model.config
        body = model.model
        rotary = body.rotary_emb
        length = max(buckets) + search.max_new_tokens
        act = getattr(cfg, "hidden_act", None)
        _refuse("LlamaDecoder", cfg, {
            "model_type": lambda v: v in LLAMA_FAMILY,
            "hidden_act": lambda v: v in ACTIVATIONS,
            "hidden_activation": lambda v: v is None or v == act,  # Gemma's second name for it
            "sliding_window": lambda v: v is None or v >= length,  # Mistral's: a shorter window masks more
        })
        self.rope_type = _rope_type(rotary, cfg)
        _refuse("LlamaDecoder", self, {"rope_type": lambda v: v not in DYNAMIC_ROPE})
        layers = body.layers
        attn = layers[0].self_attn
        head_dim = getattr(attn, "head_dim", None) or getattr(cfg, "head_dim", None) or \
            cfg.hidden_size // cfg.num_attention_heads
        if rotary.inv_freq.numel() * 2 != head_dim:
            raise ValueError(f"LlamaDecoder: {rotary.inv_freq.numel()} rotary frequencies for head_dim {head_dim} "
                             "(a partial rotary is not implemented by the port's decode steps)")
        self.head_dim = head_dim
        self.heads = attn.q_proj.out_features // head_dim
        self.kv_heads = attn.k_proj.out_features // head_dim
        self.scale = head_dim ** -0.5
        gemma = cfg.model_type == "gemma"
        self.act = ACTIVATIONS[act]
        self.blocks = [dict(ln_1=_rms_norm(layer.input_layernorm, gemma), q=_dense(layer.self_attn.q_proj),
                            k=_dense(layer.self_attn.k_proj), v=_dense(layer.self_attn.v_proj),
                            o=_dense(layer.self_attn.o_proj), ln_2=_rms_norm(layer.post_attention_layernorm, gemma),
                            gate=_dense(layer.mlp.gate_proj), up=_dense(layer.mlp.up_proj),
                            down=_dense(layer.mlp.down_proj))
                       for layer in layers]
        self.ln_f = _rms_norm(body.norm, gemma)
        self.head = _dense(model.lm_head)
        self.embed = body.embed_tokens.weight
        vocab, hidden = self.embed.shape
        dtype, device = self.embed.dtype, self.embed.device
        # Gemma scales its embedding by √hidden, rounded to the model's dtype
        self.embed_scale = torch.tensor(hidden ** 0.5, dtype=dtype, device=device) if gemma else None
        # the rotary tables of every slot: the model's own frequencies and scaling, in its dtype
        self.inv_freq = rotary.inv_freq.detach().float().clone()
        freqs = torch.arange(length, dtype=torch.float32, device=device)[:, None] * self.inv_freq.to(device)[None, :]
        emb = torch.cat((freqs, freqs), dim=-1)
        self.cos = (emb.cos() * rotary.attention_scaling).to(dtype)
        self.sin = (emb.sin() * rotary.attention_scaling).to(dtype)
        self._search_for(search)
        self.kv = StaticKV(len(self.blocks), self.kv_heads, length, head_dim, dtype, device, self.batch)
        self._buffers(buckets, vocab, device)

    def _embed(self, ids: torch.Tensor) -> torch.Tensor:
        x = F.embedding(ids, self.embed)
        return x if self.embed_scale is None else x * self.embed_scale

    def _rotary(self, pos: torch.Tensor) -> tuple:
        """The (1, 1, T, head_dim) cos and sin rows of positions `pos` (1, T)."""
        return F.embedding(pos, self.cos)[:, None], F.embedding(pos, self.sin)[:, None]

    def _layer(self, blk: dict, x: torch.Tensor, cos, sin, i: int, allowed=None, at=None) -> torch.Tensor:
        """One decoder layer on x (1, T, hidden) with its rotary rows: the
        keys and values go to the cache's first T slots (prefill, with
        `allowed` over them) or to the slot `at` (a step, over the valid
        slots)."""
        h = blk["ln_1"](x)
        q = _rotate(_heads(blk["q"](h), self.heads), cos, sin)
        k = _rotate(_heads(blk["k"](h), self.kv_heads), cos, sin)
        v = _heads(blk["v"](h), self.kv_heads)
        kv = self.kv
        if at is None:
            t = x.shape[1]
            kv.k[i][:, :, :t].copy_(k)
            kv.v[i][:, :, :t].copy_(v)
            out = _attend(q, k, v, allowed, self.scale)
        else:
            kv.write(i, at, k, v)
            out = kv.attend(i, q, self.scale)
        x = x + blk["o"](_merge(out))
        h = blk["ln_2"](x)
        return x + blk["down"](self.act(blk["gate"](h)) * blk["up"](h))

    def prefill(self, bucket: int, sample: bool) -> None:
        ids, mask = self.inputs(bucket)
        pos = (mask.long().cumsum(-1) - 1).clamp(min=0)  # the real tokens counted from 0
        eye = torch.eye(bucket, dtype=torch.bool, device=ids.device)
        allowed = ((eye | mask[:, None, :]) & torch.ones_like(eye).tril())[:, None]  # a pad query sees itself alone
        x, (cos, sin) = self._embed(ids), self._rotary(pos)
        for i, blk in enumerate(self.blocks):
            x = self._layer(blk, x, cos, sin, i, allowed=allowed)
        self._prefilled(bucket, mask)
        self._finish(x, sample)

    def step(self, sample: bool) -> None:
        kv = self.kv
        x, (cos, sin) = self._embed(self.tok), self._rotary(self.pos.view(1, 1))
        at = kv.open_slot()
        for i, blk in enumerate(self.blocks):
            x = self._layer(blk, x, cos, sin, i, at=at)
        kv.slot.add_(1)
        self.pos.add_(1)
        self._finish(x, sample)


def _bloom_gelu(x: torch.Tensor) -> torch.Tensor:
    """BLOOM's tanh GELU with its own constant (``bloom_gelu_forward``)."""
    return x * 0.5 * (1.0 + torch.tanh(0.79788456 * x * (1 + 0.044715 * x * x)))


# the MLP activations of ``config.activation_function`` the steps implement (transformers' ACT2FN names)
STEP_ACTIVATIONS = {"gelu_new": lambda x: F.gelu(x, approximate="tanh"), "gelu": F.gelu, "relu": F.relu}


def _rotate_pairs(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """GPT-J's rotary positions on x's first ``cos.shape[-1]`` features, in
    interleaved pairs (``rotate_every_two``: (x0, x1) → (-x1, x0)); the rest
    pass through."""
    r = cos.shape[-1]
    rot, rest = x[..., :r], x[..., r:]
    turned = torch.stack((-rot[..., 1::2], rot[..., ::2]), dim=-1).flatten(-2)
    return torch.cat((rot * cos + turned * sin, rest), dim=-1)


class _StepDecoder(_ChatDecoder):
    """The prefill and step of the GPT-Neo, OPT, XGLM, BLOOM and GPT-J
    decoders, with ``GPT2Decoder``'s contract (the module docstring).  A
    subclass sets ``blocks`` (one dict of callables per layer), ``scale``
    (None: 1/√d), ``window`` and ``local`` (GPT-Neo's local layers; else
    None), and gives ``_embed(ids, pos)``, ``_layer(blk, x, attend, ctx)``,
    where ``attend(q, k, v)`` caches k and v and attends over the cache, and
    the hooks ``_context(pos)`` (per-call data of the positions, such as
    rotary rows) and ``_bias(pos, at)`` (ALiBi); ``_prefill_attend`` and
    ``_step_attend`` make each layer's ``attend`` (a decoder whose cache
    holds other state, such as DeepSeek-V2's latents, gives its own)."""

    scale = None
    window = None
    local = None

    def _setup(self, buckets: Sequence[int], search: ChatSearch, layers: int, heads: int, head_dim: int,
               vocab: int, ref: torch.Tensor) -> int:
        """The search (its ``max_new_tokens`` and ``beams``), the cache of
        ``max(buckets) + max_new_tokens`` slots and the buffers on `ref`'s dtype and device → the slot count."""
        self._search_for(search)
        length = max(buckets) + self.max_new_tokens
        self.heads = heads
        self.kv = StaticKV(layers, heads, length, head_dim, ref.dtype, ref.device, self.batch)
        self.slots = torch.arange(length, device=ref.device)
        self._buffers(buckets, vocab, ref.device)
        return length

    def _context(self, pos: torch.Tensor):
        return None

    def _bias(self, pos: torch.Tensor, at=None):
        return None

    def _band(self, i: int, allowed: torch.Tensor, band: torch.Tensor) -> torch.Tensor:
        return allowed & band if self.local is not None and self.local[i] else allowed

    def prefill(self, bucket: int, sample: bool) -> None:
        ids, mask = self.inputs(bucket)
        kv = self.kv
        pos = (mask.long().cumsum(-1) - 1).clamp(min=0)  # the real tokens counted from 0
        eye = torch.eye(bucket, dtype=torch.bool, device=ids.device)
        allowed = ((eye | mask[:, None, :]) & torch.ones_like(eye).tril())[:, None]  # a pad query sees itself alone
        # a local layer's query sees the keys fewer than `window` slots back (itself always)
        band = None if self.window is None else ~torch.ones_like(eye).tril(-self.window)
        bias, ctx, x = self._bias(pos), self._context(pos), self._embed(ids, pos)
        for i, blk in enumerate(self.blocks):
            x = self._layer(blk, x, self._prefill_attend(i, bucket, self._band(i, allowed, band), bias), ctx)
        self._prefilled(bucket, mask)
        self._finish(x, sample)

    def step(self, sample: bool) -> None:
        kv = self.kv
        pos = self.pos.view(1, 1)
        band = None if self.window is None else self.slots > kv.slot - self.window
        at = kv.open_slot()
        valid = kv.valid[:, None, None, :]
        bias, ctx, x = self._bias(pos, at), self._context(pos), self._embed(self.tok, pos)
        for i, blk in enumerate(self.blocks):
            x = self._layer(blk, x, self._step_attend(i, at, self._band(i, valid, band), bias), ctx)
        kv.slot.add_(1)
        self.pos.add_(1)
        self._finish(x, sample)

    def _prefill_attend(self, i: int, bucket: int, allowed: torch.Tensor, bias) -> Callable:
        """Layer i's attention in a prefill, ``attend(q, k, v)``: the keys and
        values into the cache's first `bucket` slots, then attention over
        them as `allowed`."""
        kv = self.kv

        def attend(q, k, v):
            kv.k[i][:, :, :bucket].copy_(k)
            kv.v[i][:, :, :bucket].copy_(v)
            return _attend(q, k, v, allowed, self.scale, bias)
        return attend

    def _step_attend(self, i: int, at: torch.Tensor, allowed: torch.Tensor, bias) -> Callable:
        """Layer i's attention in a step: the token's key and value into the
        slot `at`, then attention over the cache as `allowed`."""
        kv = self.kv

        def attend(q, k, v):
            kv.write(i, at, k, v)
            return _attend(q, kv.k[i], kv.v[i], allowed, self.scale, bias)
        return attend


class GPTNeoDecoder(_StepDecoder):
    """A ``GPTNeoForCausalLM``'s prefill and step (the module docstring):
    the global and local layers of ``config.attention_layers``, scores
    unscaled, learned positions, a tied head."""

    scale = 1.0

    def __init__(self, model: nn.Module, buckets: Sequence[int], search: ChatSearch):
        cfg = model.config
        _refuse("GPTNeoDecoder", cfg, {
            "model_type": lambda v: v == "gpt_neo",
            "attention_layers": lambda v: bool(v) and set(v) <= {"global", "local"},
            "activation_function": lambda v: v in STEP_ACTIVATIONS,
        })
        body = model.transformer
        self.wte, self.wpe = body.wte.weight, body.wpe.weight
        self.blocks = [dict(ln_1=_norm(b.ln_1), q=_dense(b.attn.attention.q_proj), k=_dense(b.attn.attention.k_proj),
                            v=_dense(b.attn.attention.v_proj), o=_dense(b.attn.attention.out_proj),
                            ln_2=_norm(b.ln_2), fc_in=_dense(b.mlp.c_fc), fc_out=_dense(b.mlp.c_proj))
                       for b in body.h]
        self.ln_f = _norm(body.ln_f)
        self.head = _dense(model.lm_head)
        self.act = STEP_ACTIVATIONS[cfg.activation_function]
        self.local = [t == "local" for t in cfg.attention_layers]
        self.window = int(cfg.window_size)
        vocab, d = self.wte.shape
        length = self._setup(buckets, search, len(self.blocks), cfg.num_heads, d // cfg.num_heads,
                             vocab, self.wte)
        if length > self.wpe.shape[0]:
            raise ValueError(f"GPTNeoDecoder: {length} slots pass the position table's {self.wpe.shape[0]}")

    def _embed(self, ids, pos):
        return F.embedding(ids, self.wte) + F.embedding(pos, self.wpe)

    def _layer(self, blk, x, attend, ctx):
        h = blk["ln_1"](x)
        x = x + blk["o"](_merge(attend(*(_heads(blk[n](h), self.heads) for n in ("q", "k", "v")))))
        return x + blk["fc_out"](self.act(blk["fc_in"](blk["ln_2"](x))))


class OPTDecoder(_StepDecoder):
    """An ``OPTForCausalLM``'s prefill and step (the module docstring):
    learned positions offset by 2, ``project_in`` after the embedding and
    ``project_out`` before the tied head where ``word_embed_proj_dim`` is
    not the hidden width, pre-LN layers with a final LayerNorm or post-LN
    layers without (``do_layer_norm_before``), q scaled before the
    product."""

    scale = 1.0
    OFFSET = 2

    def __init__(self, model: nn.Module, buckets: Sequence[int], search: ChatSearch):
        cfg = model.config
        _refuse("OPTDecoder", cfg, {
            "model_type": lambda v: v == "opt",
            "activation_function": lambda v: v in STEP_ACTIVATIONS,
            "enable_bias": lambda v: v is None or v is True,
            "layer_norm_elementwise_affine": lambda v: v is None or v is True,
        })
        dec = model.model.decoder
        self.embed, self.wpe = dec.embed_tokens.weight, dec.embed_positions.weight
        self.project_in = None if dec.project_in is None else _dense(dec.project_in)
        project_out = None if dec.project_out is None else _dense(dec.project_out)
        final = None if dec.final_layer_norm is None else _norm(dec.final_layer_norm)
        self.pre = bool(cfg.do_layer_norm_before)
        self.blocks = self._blocks(dec.layers)
        self.q_scale = (cfg.hidden_size // cfg.num_attention_heads) ** -0.5
        self.act = STEP_ACTIVATIONS[cfg.activation_function]

        def ln_f(x):
            x = x if final is None else final(x)
            return x if project_out is None else project_out(x)
        self.ln_f = ln_f
        self.head = _dense(model.lm_head)
        length = self._setup(buckets, search, len(self.blocks), cfg.num_attention_heads,
                             cfg.hidden_size // cfg.num_attention_heads, self.embed.shape[0], self.embed)
        if length + self.OFFSET > self.wpe.shape[0]:
            raise ValueError(f"OPTDecoder: {length} slots pass the position table's {self.wpe.shape[0] - self.OFFSET}")

    def _embed(self, ids, pos):
        x = F.embedding(ids, self.embed)
        x = x if self.project_in is None else self.project_in(x)
        return x + F.embedding(pos + self.OFFSET, self.wpe)

    @staticmethod
    def _blocks(layers) -> list:
        """The layers' tensors (OPT's and XGLM's layers name them alike)."""
        return [dict(ln_1=_norm(layer.self_attn_layer_norm), q=_dense(layer.self_attn.q_proj),
                     k=_dense(layer.self_attn.k_proj), v=_dense(layer.self_attn.v_proj),
                     o=_dense(layer.self_attn.out_proj), ln_2=_norm(layer.final_layer_norm), fc1=_dense(layer.fc1),
                     fc2=_dense(layer.fc2))
                for layer in layers]

    def _layer(self, blk, x, attend, ctx):
        h = blk["ln_1"](x) if self.pre else x
        q = _heads(blk["q"](h) * self.q_scale, self.heads)
        x = x + blk["o"](_merge(attend(q, _heads(blk["k"](h), self.heads), _heads(blk["v"](h), self.heads))))
        x = x if self.pre else blk["ln_1"](x)
        h = blk["ln_2"](x) if self.pre else x
        x = x + blk["fc2"](self.act(blk["fc1"](h)))
        return x if self.pre else blk["ln_2"](x)


def xglm_positions(rows: int, dim: int, padding_idx) -> torch.Tensor:
    """XGLM's sinusoidal table (``XGLMSinusoidalPositionalEmbedding.get_embedding``):
    the sines then the cosines of each row, the `padding_idx` row zeroed."""
    half = dim // 2
    freq = torch.exp(torch.arange(half, dtype=torch.int64).float() * -(math.log(10000) / (half - 1)))
    emb = torch.arange(rows, dtype=torch.int64).float().unsqueeze(1) * freq.unsqueeze(0)
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=1).view(rows, -1)
    if dim % 2 == 1:
        emb = torch.cat([emb, torch.zeros(rows, 1)], dim=1)
    if padding_idx is not None:
        emb[padding_idx, :] = 0
    return emb


class XGLMDecoder(OPTDecoder):
    """An ``XGLMForCausalLM``'s prefill and step (the module docstring): the
    embedding scaled by √d where ``scale_embedding``, sinusoidal positions
    offset by 2 from a table made here for the cache's slots, OPT's pre-LN
    layer (q scaled before the product), a final LayerNorm and the tied
    head."""

    pre = True

    def __init__(self, model: nn.Module, buckets: Sequence[int], search: ChatSearch):
        cfg = model.config
        _refuse("XGLMDecoder", cfg, {
            "model_type": lambda v: v == "xglm",
            "activation_function": lambda v: v in STEP_ACTIVATIONS,
        })
        body = model.model
        self.embed = body.embed_tokens.weight
        self.embed_scale = math.sqrt(cfg.d_model) if cfg.scale_embedding else 1.0
        self.blocks = self._blocks(body.layers)
        self.ln_f = _norm(body.layer_norm)
        self.head = _dense(model.lm_head)
        self.act = STEP_ACTIVATIONS[cfg.activation_function]
        self.q_scale = (cfg.d_model // cfg.attention_heads) ** -0.5
        length = self._setup(buckets, search, len(self.blocks), cfg.attention_heads,
                             cfg.d_model // cfg.attention_heads, self.embed.shape[0], self.embed)
        if length > cfg.max_position_embeddings:
            raise ValueError(f"XGLMDecoder: {length} slots pass the {cfg.max_position_embeddings} positions")
        self.positions = xglm_positions(length + self.OFFSET, cfg.d_model, cfg.pad_token_id).to(
            dtype=self.embed.dtype, device=self.embed.device)

    def _embed(self, ids, pos):
        return F.embedding(ids, self.embed) * self.embed_scale + F.embedding(pos + self.OFFSET, self.positions)


class BartDecoder(OPTDecoder):
    """A ``BartForCausalLM``'s prefill and step (the module docstring): the
    embedding scaled by √d_model where ``scale_embedding``, learned positions
    offset by 2 (the real tokens counted from 0, as the Flax BART's and the
    eager loop's are), the embedding's LayerNorm, OPT's post-LN layer with
    the scores scaled after the product (as transformers' BART attention
    scales them), no final LayerNorm, the tied head.  A causal LM has no
    encoder states, so the layers' cross-attention never runs."""

    pre = False
    q_scale = 1.0

    def __init__(self, model: nn.Module, buckets: Sequence[int], search: ChatSearch):
        cfg = model.config
        _refuse("BartDecoder", cfg, {
            "model_type": lambda v: v == "bart",
            "activation_function": lambda v: v in STEP_ACTIVATIONS,
        })
        dec = model.model.decoder
        self.embed, self.wpe = dec.embed_tokens.weight, dec.embed_positions.weight
        self.embed_scale = math.sqrt(cfg.d_model) if cfg.scale_embedding else 1.0
        self.embed_ln = _norm(dec.layernorm_embedding)
        self.blocks = self._blocks(dec.layers)
        self.ln_f = lambda x: x
        self.head = _dense(model.lm_head)
        self.act = STEP_ACTIVATIONS[cfg.activation_function]
        heads = cfg.decoder_attention_heads
        self.scale = (cfg.d_model // heads) ** -0.5
        length = self._setup(buckets, search, len(self.blocks), heads, cfg.d_model // heads,
                             self.embed.shape[0], self.embed)
        if length + self.OFFSET > self.wpe.shape[0]:
            raise ValueError(f"BartDecoder: {length} slots pass the position table's {self.wpe.shape[0] - self.OFFSET}")

    def _embed(self, ids, pos):
        return self.embed_ln(F.embedding(ids, self.embed) * self.embed_scale + F.embedding(pos + self.OFFSET, self.wpe))


def alibi_slopes(heads: int) -> torch.Tensor:
    """BLOOM's ALiBi slopes (``build_alibi_tensor``): a geometric series over
    the largest power of two of heads, then every other slope of the next
    power's series for the heads past it."""
    closest = 2 ** math.floor(math.log2(heads))
    base = torch.tensor(2 ** (-(2 ** -(math.log2(closest) - 3))), dtype=torch.float32)
    slopes = torch.pow(base, torch.arange(1, 1 + closest, dtype=torch.int32))
    if closest != heads:
        extra = torch.tensor(2 ** (-(2 ** -(math.log2(2 * closest) - 3))), dtype=torch.float32)
        n = min(closest, heads - closest)
        slopes = torch.cat([slopes, torch.pow(extra, torch.arange(1, 1 + 2 * n, 2, dtype=torch.int32))], dim=0)
    return slopes


class BloomDecoder(_StepDecoder):
    """A ``BloomForCausalLM``'s prefill and step (the module docstring): the
    embedding's LayerNorm, the fused ``query_key_value`` laid out (heads, 3,
    head_dim), ALiBi over each slot's real-token position (kept beside the
    cache), the residual taken after the LayerNorm where
    ``apply_residual_connection_post_layernorm``, BLOOM's tanh GELU and the
    tied head.  Without a position table, no bucket is too long."""

    def __init__(self, model: nn.Module, buckets: Sequence[int], search: ChatSearch):
        cfg = model.config
        _refuse("BloomDecoder", cfg, {"model_type": lambda v: v == "bloom"})
        body = model.transformer
        self.embed = body.word_embeddings.weight
        self.embed_ln = _norm(body.word_embeddings_layernorm)
        self.blocks = [dict(ln_1=_norm(b.input_layernorm), qkv=_dense(b.self_attention.query_key_value),
                            o=_dense(b.self_attention.dense), ln_2=_norm(b.post_attention_layernorm),
                            fc_in=_dense(b.mlp.dense_h_to_4h), fc_out=_dense(b.mlp.dense_4h_to_h))
                       for b in body.h]
        self.ln_f = _norm(body.ln_f)
        self.head = _dense(model.lm_head)
        self.post = bool(cfg.apply_residual_connection_post_layernorm)
        heads = cfg.n_head
        head_dim = cfg.hidden_size // heads
        self.scale = 1.0 / math.sqrt(head_dim)
        length = self._setup(buckets, search, len(self.blocks), heads, head_dim,
                             self.embed.shape[0], self.embed)
        self.slopes = alibi_slopes(heads).to(self.embed.device)[None, :, None, None]  # (1, H, 1, 1)
        self.key_pos = torch.zeros((1, length), dtype=torch.float32, device=self.embed.device)

    def _bias(self, pos, at=None):
        """Each slot's position into ``key_pos`` (the prefill's bucket, or the
        step's slot `at`) → the (1, H, 1, T | L) bias of the keys."""
        if at is None:
            t = pos.shape[1]
            self.key_pos[:, :t].copy_(pos)
            return (self.slopes * self.key_pos[:, None, None, :t]).to(self.embed.dtype)
        self.key_pos.index_copy_(1, at, pos.float())
        return (self.slopes * self.key_pos[:, None, None, :]).to(self.embed.dtype)

    def _embed(self, ids, pos):
        return self.embed_ln(F.embedding(ids, self.embed))

    def _layer(self, blk, x, attend, ctx):
        h = blk["ln_1"](x)
        qkv = blk["qkv"](h).view(x.shape[0], x.shape[1], self.heads, 3, -1)
        q, k, v = (qkv[..., j, :].transpose(1, 2) for j in range(3))
        x = blk["o"](_merge(attend(q, k, v))) + (h if self.post else x)
        h = blk["ln_2"](x)
        return blk["fc_out"](_bloom_gelu(blk["fc_in"](h))) + (h if self.post else x)


class GPTJDecoder(_StepDecoder):
    """A ``GPTJForCausalLM``'s prefill and step (the module docstring):
    rotary positions on the first ``rotary_dim`` of each head in interleaved
    pairs, from the attention's own sin/cos table; one LayerNorm feeding the
    attention and the MLP in parallel; an untied head with a bias."""

    def __init__(self, model: nn.Module, buckets: Sequence[int], search: ChatSearch):
        cfg = model.config
        _refuse("GPTJDecoder", cfg, {
            "model_type": lambda v: v == "gptj",
            "rotary_dim": lambda v: v is not None,
            "activation_function": lambda v: v in STEP_ACTIVATIONS,
        })
        body = model.transformer
        self.embed = body.wte.weight
        self.blocks = [dict(ln_1=_norm(b.ln_1), q=_dense(b.attn.q_proj), k=_dense(b.attn.k_proj),
                            v=_dense(b.attn.v_proj), o=_dense(b.attn.out_proj), fc_in=_dense(b.mlp.fc_in),
                            fc_out=_dense(b.mlp.fc_out))
                       for b in body.h]
        self.ln_f = _norm(body.ln_f)
        self.head = _dense(model.lm_head)
        self.act = STEP_ACTIVATIONS[cfg.activation_function]
        heads = cfg.n_head
        head_dim = cfg.n_embd // heads
        length = self._setup(buckets, search, len(self.blocks), heads, head_dim,
                             self.embed.shape[0], self.embed)
        table = body.h[0].attn.embed_positions  # (positions, rotary_dim): the sines, then the cosines
        if length > table.shape[0]:
            raise ValueError(f"GPTJDecoder: {length} slots pass the rotary table's {table.shape[0]}")
        sin, cos = table[:length].to(self.embed.device).split(table.shape[-1] // 2, dim=-1)
        self.sin = sin.repeat_interleave(2, -1).to(self.embed.dtype)
        self.cos = cos.repeat_interleave(2, -1).to(self.embed.dtype)

    def _context(self, pos):
        """The (1, 1, T, rotary_dim) cos and sin rows of positions `pos`."""
        return F.embedding(pos, self.cos)[:, None], F.embedding(pos, self.sin)[:, None]

    def _embed(self, ids, pos):
        return F.embedding(ids, self.embed)

    def _layer(self, blk, x, attend, ctx):
        cos, sin = ctx
        h = blk["ln_1"](x)
        q = _rotate_pairs(_heads(blk["q"](h), self.heads), cos, sin)
        k = _rotate_pairs(_heads(blk["k"](h), self.heads), cos, sin)
        out = blk["o"](_merge(attend(q, k, _heads(blk["v"](h), self.heads))))
        return out + blk["fc_out"](self.act(blk["fc_in"](h))) + x  # the model's order of the three


def _rope_params(config) -> dict:
    """The rotary parameters: ``rope_scaling`` (transformers 4) or
    ``rope_parameters`` (5), {} where neither is set."""
    for name in ("rope_scaling", "rope_parameters"):
        params = getattr(config, name, None)
        if isinstance(params, dict):
            return params
    return {}


def mla_softmax_scale(config) -> float:
    """DeepSeek's published softmax scale (``modeling_deepseek.py``): 1 /
    √(qk_nope_head_dim + qk_rope_head_dim), times m² where the rotary
    scaling gives ``mscale_all_dim`` and a factor above 1, m = 0.1 ·
    mscale_all_dim · ln(factor) + 1.  Read from the config, not from the
    attention's ``scaling``: transformers 4.57 and 5.5 leave m² out."""
    scale = (config.qk_nope_head_dim + config.qk_rope_head_dim) ** -0.5
    params = _rope_params(config)
    m_all, factor = params.get("mscale_all_dim") or 0.0, float(params.get("factor") or 1.0)
    if m_all and factor > 1.0:
        m = 0.1 * m_all * math.log(factor) + 1.0
        scale *= m * m
    return scale


def expert_stack(experts: nn.Module) -> tuple:
    """A MoE layer's routed experts as one tensor each, (w13 (E, 2I, H): each
    expert's gate rows then its up rows; w2 (E, H, I)): transformers 5's
    fused ``gate_up_proj`` and ``down_proj`` as they are; transformers 4's
    ``ModuleList`` moved once, expert by expert, into a stack, each expert's
    parameters then pointed at its slice, so that the model's weights are
    never held twice (a second call finds the slices and returns the
    stack)."""
    if hasattr(experts, "gate_up_proj"):
        return experts.gate_up_proj, experts.down_proj
    mods = list(experts)
    inter, hidden = mods[0].gate_proj.weight.shape
    stack = getattr(experts, "port_stack", None)
    if stack is not None and all(
            m.gate_proj.weight.data_ptr() == stack[0][e, :inter].data_ptr()
            and m.up_proj.weight.data_ptr() == stack[0][e, inter:].data_ptr()
            and m.down_proj.weight.data_ptr() == stack[1][e].data_ptr() for e, m in enumerate(mods)):
        return stack
    ref = mods[0].gate_proj.weight
    w13 = torch.empty((len(mods), 2 * inter, hidden), dtype=ref.dtype, device=ref.device)
    w2 = torch.empty((len(mods), hidden, inter), dtype=ref.dtype, device=ref.device)
    with torch.no_grad():
        for e, m in enumerate(mods):
            for src, dst in ((m.gate_proj, w13[e, :inter]), (m.up_proj, w13[e, inter:]), (m.down_proj, w2[e])):
                dst.copy_(src.weight)
                src.weight.data = dst
    experts.port_stack = (w13, w2)
    return w13, w2


class DeepseekV2Decoder(_StepDecoder):
    """A ``DeepseekV2ForCausalLM``'s prefill and step over a ``LatentKV``,
    through ``_StepDecoder``'s skeleton (positions, masks, pad queries, the
    search) with its own attention and MLPs:

    * multi-head latent attention.  q = W_q h (or W_qb RMSNorm(W_qa h)), per
      head q_nope and q_pe; [c_kv | k_pe] = W_kva h, c = RMSNorm(c_kv);
      q_pe and k_pe (one head shared by all) rotated in interleaved pairs
      (GPT-J's ``_rotate_pairs``) by tables made from the model's rotary
      module (its yarn ``inv_freq`` and ``attention_scaling``); scores
      (q_nope · k_nope + q_pe · k_pe) · ``mla_softmax_scale``.  The prefill
      decompresses, [k_nope | v] = W_kvb c per head, and writes c and the
      rotated k_pe into the cache; a step attends in the absorbed form over
      the cache: q̃ = W_UKᵀ q_nope scored against c, o = W_UV (Σ p · c).
    * the MLPs: the first ``first_k_dense_replace`` layers a SiLU-gated MLP;
      the others the routed experts through ``ops/moe.py::experts`` (K3 on
      the card) over the layer's ``expert_stack``, routed by softmax over
      the experts and the top ``num_experts_per_tok`` (ties to the lower
      id, as ``_top`` orders them; normalised where ``norm_topk_prob``, then
      times ``routed_scaling_factor``), plus the shared experts' MLP.  A
      prefill routes its pad rows nowhere (no real token reads them).

    ``counters`` (device, int64): the pairs routed in prefills, the pairs
    of the busiest expert summed over each prefill's layers, and the experts
    hit in them, added from the histogram the grouping makes
    (``moe.group``); a step adds nothing on the device: it routes
    ``step_hits`` pairs to that many experts a step for one row.
    Refused by name: another ``topk_method`` than greedy, another
    ``scoring_func`` than softmax, a dynamic rotary type, biases on the
    experts, and MoE layers other than every one after the dense ones."""

    def __init__(self, model: nn.Module, buckets: Sequence[int], search: ChatSearch):
        cfg = model.config
        heads = cfg.num_attention_heads
        _refuse("DeepseekV2Decoder", cfg, {
            "model_type": lambda v: v == "deepseek_v2",
            "hidden_act": lambda v: v == "silu",
            "topk_method": lambda v: v in (None, "greedy"),
            "scoring_func": lambda v: v in (None, "softmax"),
            "mlp_bias": lambda v: not v,
            "moe_layer_freq": lambda v: v in (None, 1),
            "num_key_value_heads": lambda v: v in (None, heads),
        })
        body = model.model
        self.rope_type = _rope_type(body.rotary_emb, cfg)
        _refuse("DeepseekV2Decoder", self, {"rope_type": lambda v: v not in DYNAMIC_ROPE})
        self.heads, self.rank = heads, cfg.kv_lora_rank
        self.nope, self.rope, self.v_dim = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        self.scale = mla_softmax_scale(cfg)
        self.top_k = cfg.num_experts_per_tok
        self.norm_topk = bool(cfg.norm_topk_prob) and self.top_k > 1
        self.routed_scale = float(cfg.routed_scaling_factor or 1.0)
        self.embed = body.embed_tokens.weight
        dtype, device = self.embed.dtype, self.embed.device
        self.blocks = [self._block(layer) for layer in body.layers]
        self.ln_f = _rms_norm(body.norm, False)
        self.head = _dense(model.lm_head)
        self.n_experts = next((b["w13"].shape[0] for b in self.blocks if "w13" in b), 0)
        if self.n_experts and device.type == "cuda":
            from emojivoice_tpu_torch.kernels.build import load_moe

            load_moe()  # K3's build, at set-up and not inside a capture
        self._search_for(search)
        length = max(buckets) + self.max_new_tokens
        self.kv = LatentKV(len(self.blocks), self.rank, self.rope, length, dtype, device, self.batch)
        self._buffers(buckets, self.embed.shape[0], device)
        rotary = body.rotary_emb
        freqs = torch.arange(length, dtype=torch.float32, device=device)[:, None] * \
            rotary.inv_freq.detach().float().to(device)[None, :]
        self.cos = (freqs.cos() * rotary.attention_scaling).repeat_interleave(2, -1).to(dtype)
        self.sin = (freqs.sin() * rotary.attention_scaling).repeat_interleave(2, -1).to(dtype)
        self.counters = torch.zeros(3, dtype=torch.long, device=device)
        self.step_hits = sum("w13" in b for b in self.blocks) * min(self.n_experts, self.batch * self.top_k)
        self._rows = None  # in a prefill: (bucket, 1) True at a real token

    def _block(self, layer) -> dict:
        attn, mlp = layer.self_attn, layer.mlp
        if getattr(attn, "q_lora_rank", None) is None and hasattr(attn, "q_proj"):
            q = _dense(attn.q_proj)
        else:
            q_a, q_ln, q_b = _dense(attn.q_a_proj), _rms_norm(attn.q_a_layernorm, False), _dense(attn.q_b_proj)
            q = lambda h: q_b(q_ln(q_a(h)))  # noqa: E731
        w_kvb = attn.kv_b_proj.weight.view(self.heads, self.nope + self.v_dim, self.rank)
        blk = dict(ln_1=_rms_norm(layer.input_layernorm, False), q=q, kv_a=_dense(attn.kv_a_proj_with_mqa),
                   kv_ln=_rms_norm(attn.kv_a_layernorm, False), kv_b=_dense(attn.kv_b_proj),
                   w_uk=w_kvb[:, :self.nope], w_uv=w_kvb[:, self.nope:], o=_dense(attn.o_proj),
                   ln_2=_rms_norm(layer.post_attention_layernorm, False))
        if hasattr(mlp, "experts"):
            blk["w13"], blk["w2"] = expert_stack(mlp.experts)
            blk["gate"] = mlp.gate.weight
            blk["shared"] = self._gated(mlp.shared_experts)
        else:
            blk["mlp"] = self._gated(mlp)
        return blk

    @staticmethod
    def _gated(mlp) -> Callable:
        gate, up, down = _dense(mlp.gate_proj), _dense(mlp.up_proj), _dense(mlp.down_proj)
        return lambda h: down(F.silu(gate(h)) * up(h))

    def _context(self, pos):
        """The (1, 1, T, rope) cos and sin rows of positions `pos`."""
        return F.embedding(pos, self.cos)[:, None], F.embedding(pos, self.sin)[:, None]

    def _embed(self, ids, pos):
        return F.embedding(ids, self.embed)

    def prefill(self, bucket: int, sample: bool) -> None:
        self._rows = self.inputs(bucket)[1].view(-1, 1)
        try:
            super().prefill(bucket, sample)
        finally:
            self._rows = None

    def _routed(self, blk: dict, h: torch.Tensor) -> torch.Tensor:
        """The routed experts' sum for the rows h (T, hidden)."""
        probs = torch.softmax(F.linear(h.float(), blk["gate"].float()), dim=-1)
        weights, ids = _top(probs, self.top_k)
        if self.norm_topk:
            weights = weights / (weights.sum(-1, keepdim=True) + 1e-20)
        weights = (weights * self.routed_scale).contiguous()
        ids = ids.to(torch.int32)
        counts = None
        if self._rows is not None:  # a prefill: pad rows route nowhere; the routing's counts kept
            ids = ids.masked_fill(~self._rows, self.n_experts)
            counts = moe.group(ids, self.n_experts)
            live = counts[:self.n_experts].long()
            self.counters.add_(torch.stack((live.sum(), live.max(), (live > 0).sum())))
        return moe.experts(h.contiguous(), ids, weights, blk["w13"], blk["w2"], counts=counts)

    def _mlp(self, blk: dict, h: torch.Tensor) -> torch.Tensor:
        if "mlp" in blk:
            return blk["mlp"](h)
        rows = h.reshape(-1, h.shape[-1])
        return self._routed(blk, rows).view(h.shape) + blk["shared"](h)

    def _layer(self, blk, x, attend, ctx):
        cos, sin = ctx
        b, t = x.shape[:2]
        h = blk["ln_1"](x)
        q = blk["q"](h).view(b, t, self.heads, -1).transpose(1, 2)
        q_nope, q_pe = q.split([self.nope, self.rope], dim=-1)
        ckv = blk["kv_a"](h)
        c = blk["kv_ln"](ckv[..., :self.rank])
        k_pe = _rotate_pairs(ckv[..., self.rank:][:, None], cos, sin)
        x = x + blk["o"](_merge(attend(q_nope, _rotate_pairs(q_pe, cos, sin), c, k_pe, blk)))
        return x + self._mlp(blk, blk["ln_2"](x))

    def _softmax_v(self, scores, v, allowed) -> torch.Tensor:
        weights = torch.softmax((scores * self.scale).masked_fill(~allowed, NEG_INF).float(), dim=-1)
        return weights.to(v.dtype) @ v

    def _prefill_attend(self, i, bucket, allowed, bias):
        """The decompressed form: [k_nope | v] = W_kvb c per head, the
        latents and rotated key parts into the cache's first slots."""
        kv = self.kv

        def attend(q_nope, q_pe, c, k_pe, blk):
            kv.c[i][:, :bucket].copy_(c)
            kv.pe[i][:, :bucket].copy_(k_pe[:, 0])
            k_nope, v = _heads(blk["kv_b"](c), self.heads).split([self.nope, self.v_dim], dim=-1)
            scores = q_nope @ k_nope.transpose(-1, -2) + q_pe @ k_pe.transpose(-1, -2)
            return self._softmax_v(scores, v, allowed)
        return attend

    def _step_attend(self, i, at, allowed, bias):
        """The absorbed form over the cached latents: q̃ = W_UKᵀ q_nope
        against c, then o = W_UV (Σ p · c)."""
        kv = self.kv

        def attend(q_nope, q_pe, c, k_pe, blk):
            kv.write(i, at, c, k_pe[:, 0])
            latents = kv.c[i][:, None]  # (batch, 1, slots, rank): every head reads the one latent
            q_lat = torch.einsum("bhtd,hdc->bhtc", q_nope, blk["w_uk"])
            scores = q_lat @ latents.transpose(-1, -2) + q_pe @ kv.pe[i][:, None].transpose(-1, -2)
            return torch.einsum("bhtc,hdc->bhtd", self._softmax_v(scores, latents, allowed), blk["w_uv"])
        return attend

    def moe_stats(self, steps: int) -> dict:
        """The counters on the host (a device read): pairs, the busiest
        expert's pairs and the experts hit, over the prefills, with `steps`
        decode steps' hits added (``step_hits`` each)."""
        pairs, max_load, hits = (int(v) for v in self.counters.tolist())
        return dict(moe_pairs_sum=pairs, moe_max_load_sum=max_load, moe_experts_hit_sum=hits + steps * self.step_hits)


class WhisperDecoder:
    """A ``WhisperForConditionalGeneration``'s encoder with the cross-
    attention keys and values, and its greedy one-token decode step with the
    generation config's rules (the module docstring)."""

    def __init__(self, model: nn.Module, max_length: int, start: int, rules: ChatRules):
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
        # the generation config's rules after the start token, a prompt of one token
        self.rules = rules

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
        logits = self.head(self.dec_norm(x))[:, -1].float()
        self.logits.copy_(self.rules(logits, kv.slot, 1))  # slot n's token chooses new token n
        kv.slot.add_(1)
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

