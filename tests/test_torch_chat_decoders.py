"""The chat LM's GPT-Neo, OPT, XGLM, BLOOM and GPT-J through the port's
decode steps (``apps/decode.py``: ``GPTNeoDecoder``, ``OPTDecoder``,
``XGLMDecoder``, ``BloomDecoder``, ``GPTJDecoder``), on the CPU at tiny
widths.

Each model is made by transformers' Flax class from seed 0 at a weight scale
of 0.2, XGLM's at 0.5 (so that a wrong mask, bias or position moves the logits
far past the bound, and greedy replies vary) and carried over to its PyTorch class by
``io/from_jax.py::hf_flax_params_to_torch``:

* the bridge takes every Flax leaf, and a leftover leaf raises;
* the steps against the PyTorch model's own forward, teacher-forced: every
  step's logits within LOGIT_ATOL, with 0 and 3 left pads, after a longer
  bucket has filled more of the cache; OPT post-LN with ``project_in`` /
  ``project_out`` (and pre-LN without), BLOOM with the residual after the
  LayerNorm and with 6 and 3 heads (slopes past the power of two; the
  Flax BLOOM of transformers 4.57 fails on such a head count: its
  ``build_alibi_tensor`` calls ``jnp.cat``, which JAX does not have),
  GPT-Neo's window of 8 shorter than the prompt, GPT-J's ``rotary_dim`` 4
  of head_dim 8;
* XGLM's table against the model's own buffer, which the steps leave as it
  is; BLOOM's slopes against transformers' ``build_alibi_tensor``;
* the staged path against ``graphs=False``, greedy and sampled, over turns
  that switch buckets; each key captured once under the stub graph, then
  replayed;
* the refusals, each naming its flag.

The Flax ``generate`` parity is ``tests/test_torch_chat_flax.py``'s.  About
35 s on this CPU.
"""

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from flax.traverse_util import flatten_dict  # noqa: E402

from emojivoice_tpu_torch.apps import decode  # noqa: E402
from emojivoice_tpu_torch.apps.torch_adapters import CHAT_DECODERS, TorchChatLM  # noqa: E402
from emojivoice_tpu_torch.io.from_jax import hf_flax_params_to_torch  # noqa: E402
from emojivoice_tpu_torch.utils import observability as obs  # noqa: E402
from emojivoice_tpu_torch.utils.prng import step_generator  # noqa: E402
from tests.test_torch_adapters import StubTokenizer, bridged  # noqa: E402
from tests.test_torch_decode_graphs import chat_search, left_padded, stub_card  # noqa: E402,F401  (stub_card is a fixture)

torch.set_num_threads(2)

LOGIT_ATOL = 1e-5  # f32: the port's steps against the model's own forward, every step (GPT-2's bound)
BUCKETS = (16, 32, 64)
SCALE = 0.2  # the init's standard deviation: logits of order 1-10 at these widths
TOKENS = dict(vocab_size=96, bos_token_id=1, eos_token_id=2)
# family → (config class, Flax class, PyTorch class, the tiny config, the decoder)
FAMILIES = {
    "gpt_neo": ("GPTNeoConfig", "FlaxGPTNeoForCausalLM", "GPTNeoForCausalLM",
                dict(hidden_size=32, num_layers=2, num_heads=4, attention_types=[[["global", "local"], 1]],
                     window_size=8, max_position_embeddings=256, initializer_range=SCALE), decode.GPTNeoDecoder),
    "opt": ("OPTConfig", "FlaxOPTForCausalLM", "OPTForCausalLM",
            dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4, ffn_dim=64, word_embed_proj_dim=16,
                 do_layer_norm_before=False, max_position_embeddings=256, pad_token_id=0, init_std=SCALE),
            decode.OPTDecoder),
    "xglm": ("XGLMConfig", "FlaxXGLMForCausalLM", "XGLMForCausalLM",
             dict(d_model=32, num_layers=2, attention_heads=4, ffn_dim=64, max_position_embeddings=256,
                  pad_token_id=1, bos_token_id=0, init_std=0.5), decode.XGLMDecoder),  # at 0.2 one token repeats
    "bloom": ("BloomConfig", "FlaxBloomForCausalLM", "BloomForCausalLM",
              dict(hidden_size=48, n_layer=2, n_head=4, initializer_range=SCALE), decode.BloomDecoder),
    "gptj": ("GPTJConfig", "FlaxGPTJForCausalLM", "GPTJForCausalLM",
             dict(n_embd=32, n_layer=2, n_head=4, rotary_dim=4, n_positions=256, initializer_range=SCALE),
             decode.GPTJDecoder),
}


def config(family, **kw):
    cls, _, _, own, _ = FAMILIES[family]
    return getattr(transformers, cls)(**{**TOKENS, **own, **kw})


def torch_model(family, seed=0, **kw):
    torch.manual_seed(seed)
    return getattr(transformers, FAMILIES[family][2])(config(family, **kw)).eval()


def flax_pair(family, **kw):
    """(the Flax model made from seed 0, the PyTorch model on its weights)."""
    _, flax_cls, torch_cls, _, _ = FAMILIES[family]
    flax_model = getattr(transformers, flax_cls)(config(family, **kw), seed=0)
    return flax_model, bridged(flax_model, getattr(transformers, torch_cls))


@pytest.fixture(scope="module")
def pairs():
    return {family: flax_pair(family) for family in FAMILIES}


# ---------------------------------------------------------------- the bridge

@pytest.mark.parametrize("family", list(FAMILIES))
def test_bridge_takes_every_flax_leaf(pairs, family):
    """Every Flax leaf lands on a PyTorch tensor of the same values (a Dense
    kernel transposed); a leftover leaf raises."""
    flax_model, model = pairs[family]
    flat = flatten_dict(flax_model.params, sep="/")
    sd = hf_flax_params_to_torch(flat, model)
    assert set(sd) == set(model.state_dict()) - {k for k, _ in model.named_buffers()}
    for k, v in flat.items():
        name = k.rsplit("/", 1)[0].replace("/", ".") + ".weight" if k.endswith(("/kernel", "/scale", "/embedding")) \
            else k.replace("/", ".")
        want = np.asarray(v).T if k.endswith("/kernel") else np.asarray(v)
        assert np.array_equal(sd[name].numpy(), want), k
    with pytest.raises(ValueError, match="extra/kernel"):
        hf_flax_params_to_torch(dict(flat, **{"extra/kernel": np.ones((2, 2), np.float32)}), model)


# ---------------------------------------------------------------- the steps against transformers' forward

def teacher_forced(dec, model, bucket, n_pad, n_forced=6, seed=1):
    """Prefill a left-padded bucket, then `n_forced` forced tokens → the
    largest difference between each step's logits and the model's forward
    over the whole sequence (positions given where the forward takes them)."""
    ids, mask = left_padded(bucket - n_pad, bucket, seed=n_pad)
    forced = np.random.default_rng(seed).integers(3, 96, n_forced)
    full = np.concatenate([ids, forced[None]], axis=1)
    full_mask = np.concatenate([mask, np.ones((1, n_forced), np.int64)], axis=1)
    kw = {} if model.config.model_type == "bloom" else {
        "position_ids": torch.from_numpy(np.clip(full_mask.cumsum(-1) - 1, 0, None))}
    with torch.no_grad():
        ref = model(input_ids=torch.from_numpy(full), attention_mask=torch.from_numpy(full_mask), **kw).logits[0]
        static_ids, static_mask = dec.inputs(bucket)
        static_ids.copy_(torch.from_numpy(ids))
        static_mask.copy_(torch.from_numpy(mask))
        dec.prefill(bucket, False)
        got = [dec.logits[0].clone()]
        assert all(torch.isfinite(k[:, :, :bucket]).all() for k in dec.kv.k + dec.kv.v)
        for tok in forced:
            dec.tok.fill_(int(tok))
            dec.step(False)
            got.append(dec.logits[0].clone())
    assert int(dec.kv.valid.sum()) == bucket - n_pad + n_forced
    assert float(ref[bucket - 1:].abs().max()) > 1.0  # the bound is far under the logits' scale
    return max(float((g - ref[bucket - 1 + j]).abs().max()) for j, g in enumerate(got))


def stale_then_forced(model, n_pad, bucket=16):
    """A longer bucket's turn runs first, so stale slots past the bucket are
    in the cache; then prefill and six teacher-forced steps."""
    dec = CHAT_DECODERS[model.config.model_type](model, BUCKETS, chat_search(model))
    with torch.no_grad():
        ids, mask = left_padded(40, 64, seed=9)
        dec.inputs(64)[0].copy_(torch.from_numpy(ids))
        dec.inputs(64)[1].copy_(torch.from_numpy(mask))
        dec.prefill(64, False)
        for _ in range(4):
            dec.step(False)
    return dec, teacher_forced(dec, model, bucket, n_pad)


@pytest.mark.parametrize("n_pad", [0, 3])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_steps_match_the_models_logits(pairs, family, n_pad):
    """Every step's logits against the model's forward; the pad rows' cached
    keys and values stay finite."""
    model = pairs[family][1]
    dec, err = stale_then_forced(model, n_pad)
    assert type(dec) is FAMILIES[family][4]
    assert err <= LOGIT_ATOL, err


@pytest.mark.parametrize("family, kw", [
    ("opt", dict(do_layer_norm_before=True, word_embed_proj_dim=32)),  # pre-LN, a final LayerNorm, no projections
    ("bloom", dict(apply_residual_connection_post_layernorm=True)),
    ("bloom", dict(n_head=6)),  # 6 heads: two slopes past the power of two
    ("bloom", dict(n_head=3)),  # 3 heads: one
    ("gpt_neo", dict(attention_types=[[["local"], 2]], window_size=3)),  # local only, a window of 3
    ("gptj", dict(rotary_dim=8)),  # the whole head rotated
])
def test_variants_match_the_models_logits(family, kw):
    model = torch_model(family, seed=3, **kw)
    assert stale_then_forced(model, 3, bucket=32)[1] <= LOGIT_ATOL


def test_decoders_read_the_models_layout(pairs):
    """What the steps take from the model: OPT's projections and post-LN (no
    final LayerNorm), GPT-Neo's layer types and window, GPT-J's partial
    rotary table, BLOOM's slopes, XGLM's table (the model's own buffer,
    which the steps leave as it is)."""
    dec = {family: CHAT_DECODERS[family](pairs[family][1], BUCKETS, chat_search(pairs[family][1])) for family in FAMILIES}
    assert dec["opt"].project_in is not None and not dec["opt"].pre
    assert (dec["gpt_neo"].local, dec["gpt_neo"].window) == ([False, True], 8)
    assert dec["gptj"].cos.shape == (64 + 8, 4)
    for heads in (6, 16, 12, 3):
        alibi = transformers.models.bloom.modeling_bloom.build_alibi_tensor(torch.ones(1, 2), heads, torch.float32)
        assert torch.equal(decode.alibi_slopes(heads), alibi.view(heads, 2)[:, 1])
    model = pairs["xglm"][1]
    table = model.model.embed_positions.weights
    before = table.clone()
    assert torch.equal(dec["xglm"].positions, table[:64 + 8 + 2])
    teacher_forced(dec["xglm"], model, 16, 3)
    assert torch.equal(model.model.embed_positions.weights, before)


# ---------------------------------------------------------------- staged against graphs=False

PROMPTS = ((10, 16), (50, 64), (12, 16), (20, 32))  # (real tokens, bucket): away from 16 and back


def chat_pair(model, temperature, **kw):
    kw = dict(model=model, tokenizer=StubTokenizer(), temperature=temperature, max_new_tokens=8,
              prompt_buckets=BUCKETS, device="cpu", **kw)
    return TorchChatLM(**kw), TorchChatLM(graphs=False, **kw)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_staged_ids_equal_eager_across_buckets(pairs, family, temperature):
    staged, eager = chat_pair(pairs[family][1], temperature)
    assert (staged.decode, eager.decode) == ("graphs", "eager") and type(staged._dec) is FAMILIES[family][4]
    for turn, (n_real, bucket) in enumerate(PROMPTS):
        ids, mask = left_padded(n_real, bucket, seed=turn)
        gens = [step_generator(7, turn, "chat", "cpu") if temperature else None for _ in range(2)]
        np.testing.assert_array_equal(staged._generate(ids, mask, gens[0]), eager._generate(ids, mask, gens[1]))
    assert sorted(k for k in staged.graphs.keys() if k[0] == "prefill") == [
        ("prefill", b, temperature > 0) for b in BUCKETS]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_stub_graphs_capture_each_key_once_and_replay(stub_card, pairs, family):  # noqa: F811
    """Under the stub graph a capture records the step without running it
    (the decoder's buffers, BLOOM's key positions among them, are restored
    after it) and a replay runs it: the ids equal the eager loop's, three
    prefill buckets and the decode step are captured once each, and every
    later call replays."""
    staged, eager = chat_pair(pairs[family][1], 0.8)
    staged = stub_card(staged)
    decode_calls = 0
    for turn, (n_real, bucket) in enumerate(PROMPTS):
        ids, mask = left_padded(n_real, bucket, seed=turn)
        gens = [step_generator(7, turn, "chat", "cpu") for _ in range(2)]
        got = staged._generate(ids, mask, gens[0])
        np.testing.assert_array_equal(got, eager._generate(ids, mask, gens[1]))
        new = list(got[0, bucket:])
        decode_calls += next((i + 1 for i, t in enumerate(new) if t == 2), len(new)) - 1
    stats = staged.graphs.stats()
    assert staged.graphs.captures == stats["graphs"] == 4
    entries = {k: e for (k, _), e in staged.graphs.entries().items()}
    assert entries[("decode", True)].replays == decode_calls - 1
    assert entries[("prefill", 16, True)].replays == 1 and entries[("prefill", 32, True)].replays == 0


# ---------------------------------------------------------------- spans

@pytest.mark.parametrize("mode", ["graphs", "eager"])
@pytest.mark.parametrize("temperature", [0.0, 0.8], ids=["greedy", "sampled"])
def test_a_turn_records_its_prefill_and_a_step_a_token(stub_card, mode, temperature):  # noqa: F811
    """The recorder on, GPT-J's chat turns reply as with it off and record,
    each span with the turn's number and in this order: ``llm.prompt``,
    ``llm.prefill`` (the first new token), one ``llm.step`` a further new
    token with one ``llm.replay`` and then one ``llm.read`` inside it, and
    ``llm.detokenize``."""
    model = torch_model("gptj")

    def lm():
        adapter = TorchChatLM(model=model, tokenizer=StubTokenizer(), temperature=temperature, max_new_tokens=8,
                              prompt_buckets=BUCKETS, device="cpu", graphs=mode == "graphs")
        return stub_card(adapter) if mode == "graphs" else adapter

    plain, traced = lm(), lm()
    seqs, real = [], traced._generate
    traced._generate = lambda *a: seqs.append(real(*a)) or seqs[-1]
    messages = ("hello", "tell me more " * 6)
    want = [plain.chat("sys", [], m) for m in messages]
    obs.enable()
    try:
        got = [traced.chat("sys", [], m) for m in messages]
    finally:
        obs.disable()
    spans = obs.drain()
    assert got == want and len(seqs) == 2
    for turn, seq in enumerate(seqs):
        new = list(seq[0, -8:])
        n_new = next((i + 1 for i, t in enumerate(new) if t == 2), len(new))
        mine = sorted((s for s in spans if s.get("turn") == turn), key=lambda s: s["t0"])
        assert [s["name"] for s in mine] == ["llm.prompt", "llm.prefill"] + \
            ["llm.step", "llm.replay", "llm.read"] * (n_new - 1) + ["llm.detokenize"]
        steps = {s["id"] for s in mine if s["name"] == "llm.step"}
        assert all((s["parent"] in steps) == (s["name"] in ("llm.replay", "llm.read")) for s in mine)
        assert all(a["t1"] <= b["t0"] for a, b in zip(mine, mine[1:]) if b["parent"] is None)
    assert len(spans) == sum(1 for s in spans if s.get("turn") in (0, 1))


# ---------------------------------------------------------------- refusals

@pytest.mark.parametrize("family, flag, value", [
    ("gpt_neo", "attention_layers", ["global", "sparse"]),
    ("gpt_neo", "activation_function", "silu"),
    ("opt", "enable_bias", False),
    ("opt", "layer_norm_elementwise_affine", False),
    ("xglm", "activation_function", "swish"),
    ("gptj", "rotary_dim", None),
])
def test_decoders_refuse_what_they_do_not_implement(family, flag, value):
    """Each refusal names its flag; ``graphs=False`` takes the same model.
    The flag is set on the built model's config where the PyTorch class
    itself would not build with it."""
    model = torch_model(family)
    setattr(model.config, flag, value)
    with pytest.raises(ValueError, match=f"config.{flag}="):
        TorchChatLM(model=model, tokenizer=StubTokenizer(), prompt_buckets=BUCKETS, max_new_tokens=8, device="cpu")
    assert TorchChatLM(model=model, tokenizer=StubTokenizer(), prompt_buckets=BUCKETS, device="cpu",
                       graphs=False).graphs is None
