"""DeepSeek-V2 through the port's decode steps (``apps/decode.py::
DeepseekV2Decoder``: latent attention over a ``LatentKV``, the routed
experts through ``ops/moe.py``), on the CPU at tiny widths: hidden 64, 4
heads, ``kv_lora_rank`` 32, rope 8, nope 16, v 16, 4 layers of which the
first is dense, 8 experts top-2 and 2 shared, vocabulary 512, yarn rotary at
DeepSeek-V2-Lite's scaling.  Weights are drawn N(0, 0.02) from the
benchmark's spec (``benchmark/reference/deepseek_v2.py``), the RMSNorms at
one.

* the plain reference against transformers' own ``DeepseekV2ForCausalLM``
  forward on the same weights, each attention's ``scaling`` set to the
  published m² / √192 (transformers 4.57 leaves m² out): the yarn tables,
  the interleaved rotary, the latent attention and the routing;
* the decoder's prefill and steps, greedy and sampled, in every bucket,
  against the reference's full forward, every step's logits; with
  ``q_lora_rank`` set and with ``norm_topk_prob``;
* the staged path against transformers' forward (``graphs=False``), greedy,
  sampled and with two beams, under the stub graph of
  ``tests/test_torch_decode_graphs.py`` (each key captured once, then
  replayed);
* the published softmax scale; the refusals, each by name; the MoE
  counters against a count made on the host from the routing K3 was given;
  the expert stack sharing the model's storage.

Tolerances: LOGIT_RTOL of each row's largest logit.  Both sides compute in
f32 on the CPU and differ only in the order of sums (the absorbed attention
against the decompressed one, the experts gathered against run on their own
rows): the errors seen are ~3e-7 of the row.
"""

import numpy as np
import pytest
import torch

from benchmark.reference import deepseek_v2 as ref
from benchmark.weights import draw
from emojivoice_tpu_torch.apps import decode
from emojivoice_tpu_torch.apps.torch_adapters import TorchChatLM, import_transformers
from emojivoice_tpu_torch.ops import moe
from emojivoice_tpu_torch.utils.prng import step_generator
from tests.test_torch_decode_graphs import stub_card  # noqa: F401  (a fixture)

tf = import_transformers()
torch.set_num_threads(2)

LOGIT_RTOL = 3e-6
BUCKETS = (16, 32, 64)
TINY = dict(vocab_size=512, hidden_size=64, intermediate_size=96, num_hidden_layers=4, num_attention_heads=4,
            num_key_value_heads=4, kv_lora_rank=32, q_lora_rank=None, qk_nope_head_dim=16, qk_rope_head_dim=8,
            v_head_dim=16, first_k_dense_replace=1, moe_layer_freq=1, n_routed_experts=8, n_shared_experts=2,
            num_experts_per_tok=2, moe_intermediate_size=24, topk_method="greedy", scoring_func="softmax",
            norm_topk_prob=False, routed_scaling_factor=1.0, n_group=1, topk_group=1, rms_norm_eps=1e-6,
            rope_theta=10000.0, max_position_embeddings=163840, attention_bias=False, hidden_act="silu",
            tie_word_embeddings=False, bos_token_id=500, eos_token_id=501, pad_token_id=0,
            rope_scaling={"beta_fast": 32.0, "beta_slow": 1.0, "factor": 40.0, "mscale": 0.707, "mscale_all_dim": 0.707,
                          "original_max_position_embeddings": 4096, "type": "yarn"})


class Tok:
    pad_token_id, eos_token_id, chat_template = 0, 501, None

    def __call__(self, text):
        return {"input_ids": [3 + sum(map(ord, w)) % 490 for w in text.split()]}

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(f"w{i}" for i in ids if i < 500 or not skip_special_tokens)


def make(seed=0, **kw):
    """A tiny DeepSeek-V2 with the spec's weights drawn from `seed`, and its
    config as a dict."""
    cfg = {**TINY, **kw}
    model = tf.DeepseekV2ForCausalLM(tf.DeepseekV2Config(**cfg)).float().eval()
    params = dict(model.named_parameters())
    spec = ref.spec(cfg)
    assert {n for n, _, _ in spec} == set(params)
    draw(spec, seed, "cpu", out=params)
    return model, cfg


def state(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def published_scaling(model, cfg) -> None:
    for layer in model.model.layers:
        layer.self_attn.scaling = ref.softmax_scale(cfg)


def left_padded(n_real, bucket, seed):
    ids = np.zeros((1, bucket), np.int64)
    ids[0, bucket - n_real:] = np.random.default_rng(seed).integers(3, 500, n_real)
    return ids, (ids != 0).astype(np.int64)


def row_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(((got - want).abs().amax(-1) / want.abs().amax(-1)).max())


@pytest.fixture(scope="module")
def tiny():
    return make()


def test_reference_matches_transformers_forward(tiny):
    model, cfg = tiny
    sd = state(model)
    ids = torch.from_numpy(np.random.default_rng(1).integers(3, 500, 40))
    want = ref.logits(sd, cfg, ids.tolist())
    assert ref.softmax_scale(cfg) != model.model.layers[0].self_attn.scaling  # transformers leaves m² out
    saved = [layer.self_attn.scaling for layer in model.model.layers]
    published_scaling(model, cfg)
    try:
        with torch.no_grad():
            got = model(input_ids=ids[None]).logits[0]
    finally:
        for layer, s in zip(model.model.layers, saved):
            layer.self_attn.scaling = s
    assert row_err(got, want) <= LOGIT_RTOL


def test_softmax_scale_is_the_published_rule():
    """s = m² / √(nope + rope), m = 0.1 · mscale_all_dim · ln(factor) + 1:
    0.1147 at DeepSeek-V2-Lite's widths and scaling; 1 / √192 without a
    rotary scaling, and without ``mscale_all_dim``."""
    lite = tf.DeepseekV2Config(**{**TINY, "qk_nope_head_dim": 128, "qk_rope_head_dim": 64})
    m = 0.1 * 0.707 * np.log(40) + 1
    assert decode.mla_softmax_scale(lite) == pytest.approx(m * m / np.sqrt(192), rel=1e-12)
    assert decode.mla_softmax_scale(lite) == pytest.approx(0.11472, abs=1e-5)
    assert ref.softmax_scale({**TINY, "qk_nope_head_dim": 128, "qk_rope_head_dim": 64}) == \
        pytest.approx(decode.mla_softmax_scale(lite), rel=1e-12)
    plain = tf.DeepseekV2Config(**{**TINY, "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "rope_scaling": None})
    assert decode.mla_softmax_scale(plain) == pytest.approx(192 ** -0.5, rel=1e-12)
    no_m = {**TINY["rope_scaling"], "mscale_all_dim": 0.0}
    assert ref.softmax_scale({**TINY, "rope_scaling": no_m}) == pytest.approx(24 ** -0.5, rel=1e-12)


def steps_against_reference(model, cfg, sample: bool, seed: int = 0):
    """A turn in each bucket, a longer one first (stale slots past the
    bucket in the cache): every step's scores against the reference's full
    forward over the prompt and the served tokens."""
    sd = state(model)
    lm = TorchChatLM(model=model, tokenizer=Tok(), temperature=0.7 if sample else 0.0, max_new_tokens=6,
                     prompt_buckets=BUCKETS, device="cpu")
    assert lm.decode == "graphs"
    worst = 0.0
    for turn, (n_real, bucket) in enumerate(((50, 64), (9, 16), (20, 32), (64, 64))):
        ids, mask = left_padded(n_real, bucket, seed=seed + turn)
        out = []
        gen = step_generator(3, turn, "chat", "cpu") if sample else None
        seq = lm._generate(ids.astype(np.int32), mask.astype(np.int32), gen, logits_out=out)
        new = [int(t) for t in seq[0, bucket:]][: len(out)]
        prompt = ids[0, bucket - n_real:].tolist()
        want = ref.logits(sd, cfg, prompt + new[:-1], first=n_real - 1)
        worst = max(worst, row_err(torch.cat(out), want))
    return worst


@pytest.mark.parametrize("sample", [False, True])
def test_decoder_matches_the_reference_in_every_bucket(tiny, sample):
    assert steps_against_reference(*tiny, sample) <= LOGIT_RTOL


@pytest.mark.parametrize("kw", [dict(q_lora_rank=24), dict(norm_topk_prob=True, routed_scaling_factor=2.5)])
def test_decoder_variants_match_the_reference(kw):
    """``q_lora_rank`` set (q_a_proj, its RMSNorm, q_b_proj); the top-k
    weights normalised and scaled (transformers 4.57's gate ignores
    ``norm_topk_prob``: only the reference, as published, holds it)."""
    model, cfg = make(seed=2, **kw)
    assert steps_against_reference(model, cfg, sample=False, seed=5) <= LOGIT_RTOL


@pytest.mark.parametrize("mode", ["greedy", "sampled", "beams"])
def test_staged_path_matches_transformers_forward(stub_card, mode):  # noqa: F811
    """Under the stub graph (each key captured once, then replayed) against
    ``graphs=False``, the published scale in both: the same tokens, turn
    after turn across buckets."""
    model, cfg = make(seed=4)
    published_scaling(model, cfg)
    if mode == "beams":
        model.generation_config.num_beams = 2
    temperature = 0.7 if mode == "sampled" else 0.0
    staged, eager = (TorchChatLM(model=model, tokenizer=Tok(), temperature=temperature, max_new_tokens=6,
                                 prompt_buckets=BUCKETS, device="cpu", graphs=g) for g in (True, False))
    staged = stub_card(staged)
    for turn, (n_real, bucket) in enumerate(((12, 16), (40, 64), (30, 32), (10, 16))):
        ids, mask = left_padded(n_real, bucket, seed=turn)
        gens = [step_generator(7, turn, "chat", "cpu") if temperature else None for _ in range(2)]
        got, want = ([], [])
        a = staged._generate(ids.astype(np.int32), mask.astype(np.int32), gens[0], logits_out=got)
        b = eager._generate(ids.astype(np.int32), mask.astype(np.int32), gens[1], logits_out=want)
        np.testing.assert_array_equal(a, b)
        assert row_err(torch.cat(got), torch.cat(want)) <= LOGIT_RTOL
    entries = {k: e for (k, _), e in staged.graphs.entries().items()}
    assert staged.graphs.captures == len(entries) == 4  # three prefill buckets and the decode step
    assert entries[("beam_prefill", 16) if mode == "beams" else ("prefill", 16, mode == "sampled")].replays == 1


@pytest.mark.parametrize("flag, value", [("topk_method", "group_limited_greedy"), ("scoring_func", "sigmoid"),
                                         ("mlp_bias", True), ("moe_layer_freq", 2)])
def test_unimplemented_config_is_refused_by_name(flag, value):
    model = tf.DeepseekV2ForCausalLM(tf.DeepseekV2Config(**{**TINY, "num_hidden_layers": 2})).eval()
    setattr(model.config, flag, value)
    with pytest.raises(ValueError, match=flag):
        decode.DeepseekV2Decoder(model, BUCKETS, decode.ChatSearch(model.generation_config, 512, 6, "cpu"))


def test_dynamic_rope_is_refused_by_name():
    model = tf.DeepseekV2ForCausalLM(tf.DeepseekV2Config(**{**TINY, "num_hidden_layers": 2})).eval()
    model.model.rotary_emb.rope_type = "dynamic"
    with pytest.raises(ValueError, match="rope_type"):
        decode.DeepseekV2Decoder(model, BUCKETS, decode.ChatSearch(model.generation_config, 512, 6, "cpu"))


def test_moe_counters_equal_a_host_count(tiny, monkeypatch):
    """The routing each ``moe.experts`` call was given, counted on the host:
    a prefill's pairs (its pad rows routed nowhere), the busiest expert's
    pairs and the experts hit, summed over its MoE layers; a step adds its
    layers' k experts to the hits and nothing on the device."""
    model, cfg = tiny
    seen = []
    real = moe.experts

    def experts(x, ids, weights, w13, w2, counts=None):
        seen.append(ids.clone())
        return real(x, ids, weights, w13, w2, counts=counts)
    monkeypatch.setattr(moe, "experts", experts)
    lm = TorchChatLM(model=model, tokenizer=Tok(), temperature=0.0, max_new_tokens=6, prompt_buckets=BUCKETS,
                     device="cpu")
    ids, mask = left_padded(23, 32, seed=3)
    lm._generate(ids.astype(np.int32), mask.astype(np.int32))
    layers, e, k = 3, cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    prefill = seen[:layers]
    pairs = sum(int((s < e).sum()) for s in prefill)
    busiest = sum(int(np.bincount(s[s < e].numpy(), minlength=e).max()) for s in prefill)
    hit = sum(len(set(s[s < e].tolist())) for s in prefill)
    stats = lm.stats()
    assert pairs == 23 * k * layers and all(bool((s[:32 - 23] == e).all()) for s in prefill)
    assert stats["moe_pairs_sum"] == pairs and stats["moe_max_load_sum"] == busiest
    assert stats["steps"] == len(seen) // layers - 1
    assert stats["moe_experts_hit_sum"] == hit + stats["steps"] * layers * k


def test_expert_stack_shares_the_models_storage():
    """transformers 4.57 keeps one module per expert: the decoder moves them
    once into a stack a layer, and every expert's parameters are then views
    of it; a second decoder finds the stack; the model's own forward is
    unchanged."""
    model, cfg = make(seed=6)
    ids = torch.arange(3, 30)[None]
    with torch.no_grad():
        before = model(input_ids=ids).logits
    first = TorchChatLM(model=model, tokenizer=Tok(), temperature=0.0, max_new_tokens=4, prompt_buckets=BUCKETS,
                        device="cpu")
    second = TorchChatLM(model=model, tokenizer=Tok(), temperature=0.7, max_new_tokens=4, prompt_buckets=BUCKETS,
                         device="cpu")
    inter = cfg["moe_intermediate_size"]
    for blk_a, blk_b, layer in zip(first._dec.blocks[1:], second._dec.blocks[1:], model.model.layers[1:]):
        w13, w2 = blk_a["w13"], blk_a["w2"]
        assert blk_b["w13"] is w13 and blk_b["w2"] is w2
        for j, expert in enumerate(layer.mlp.experts):
            assert expert.gate_proj.weight.data_ptr() == w13[j, :inter].data_ptr()
            assert expert.up_proj.weight.data_ptr() == w13[j, inter:].data_ptr()
            assert expert.down_proj.weight.data_ptr() == w2[j].data_ptr()
            assert expert.gate_proj.weight.untyped_storage().data_ptr() == w13.untyped_storage().data_ptr()
    with torch.no_grad():
        assert torch.equal(model(input_ids=ids).logits, before)
