"""The chat LM's Llama family (llama, mistral, gemma) through the port's
decode steps (``apps/decode.py::LlamaDecoder``), on the CPU at tiny widths.

Each model is made by transformers' Flax class from a seed and carried over
to its PyTorch class by ``io/from_jax.py::hf_flax_params_to_torch`` (which
takes the Flax RMSNorms' ``weight`` leaves as they are):

* the steps against the PyTorch model's own forward, teacher-forced: every
  step's logits within LOGIT_ATOL, with 0 and 3 left pads, after a longer
  bucket has filled more of the cache;
* ``TorchChatLM`` (its default: the decoder's graphs, uncaptured on the
  CPU) against the JAX package's ``FlaxChatLM``: the same prompt ids, mask
  and bucket, the same greedy ids and ``chat()`` strings, in two buckets and
  with an overlong prompt;
* the staged path against ``graphs=False`` (transformers' forward), greedy
  and sampled, over turns that switch buckets;
* a stub ``torch.cuda.CUDAGraph`` (``tests/test_torch_decode_graphs.py``'s):
  each key captured once, then replayed;
* F12: transformers' Flax Llama fixes the rotary base at 10000 whatever the
  config says; at ``rope_theta`` 500000 the Flax logits part from the
  PyTorch model's, and the port's steps follow the PyTorch model;
* the refusals, each naming its flag; ``feel_me --llm device`` on a saved
  tiny llama and gpt_neo (graphs) and BART decoder (the eager loop, said on
  one line).

About 50 s on this CPU (the Flax inits and the Flax ``generate`` compiles
take most of it).
"""

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from flax.traverse_util import flatten_dict  # noqa: E402

from emojivoice_tpu.apps.flax_adapters import FlaxChatLM  # noqa: E402
from emojivoice_tpu_torch.apps import adapters as ad  # noqa: E402
from emojivoice_tpu_torch.apps.decode import LlamaDecoder  # noqa: E402
from emojivoice_tpu_torch.apps.torch_adapters import TorchChatLM  # noqa: E402
from emojivoice_tpu_torch.io.from_jax import hf_flax_params_to_torch  # noqa: E402
from emojivoice_tpu_torch.utils.prng import step_generator  # noqa: E402
from tests.test_torch_adapters import StubTokenizer, bridged  # noqa: E402
from tests.test_torch_decode_graphs import chat_search, left_padded, stub_card  # noqa: E402,F401  (stub_card is a fixture)

torch.set_num_threads(2)

LOGIT_ATOL = 1e-5  # f32: the port's steps against the model's own forward, every step (GPT-2's bound)
BUCKETS = (16, 32, 64)
BASE = dict(vocab_size=96, hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=256, bos_token_id=1, eos_token_id=2, pad_token_id=0)
# (config class, Flax class, PyTorch class, the family's own settings): GQA 4 / 2 in each; Gemma with a
# head_dim other than hidden / heads and its tied head
FAMILIES = {
    "llama": ("LlamaConfig", "FlaxLlamaForCausalLM", "LlamaForCausalLM", {}),
    "mistral": ("MistralConfig", "FlaxMistralForCausalLM", "MistralForCausalLM", {"sliding_window": 128}),
    "gemma": ("GemmaConfig", "FlaxGemmaForCausalLM", "GemmaForCausalLM", {"head_dim": 16}),
}


def config(family, **kw):
    cls, _, _, own = FAMILIES[family]
    return getattr(transformers, cls)(**{**BASE, **own, **kw})


def torch_model(family, seed=0, **kw):
    torch.manual_seed(seed)
    return getattr(transformers, FAMILIES[family][2])(config(family, **kw)).eval()


@pytest.fixture(scope="module")
def pairs():
    """family → (the Flax model made from seed 0, the PyTorch model on its weights)."""
    out = {}
    for family, (_, flax_cls, torch_cls, _) in FAMILIES.items():
        flax_model = getattr(transformers, flax_cls)(config(family), seed=0)
        out[family] = (flax_model, bridged(flax_model, getattr(transformers, torch_cls)))
    return out


# ---------------------------------------------------------------- the bridge

@pytest.mark.parametrize("family", list(FAMILIES))
def test_bridge_loads_the_rmsnorm_weights_and_refuses_a_leftover_leaf(pairs, family):
    """The Flax RMSNorms' ``weight`` leaves land on the PyTorch norms as they
    are (no transpose); a leftover leaf and a missing weight still raise."""
    flax_model, model = pairs[family]
    flat = flatten_dict(flax_model.params, sep="/")
    norms = [k for k in flat if k.endswith("layernorm/weight") or k == "model/norm/weight"]
    assert len(norms) == 2 * BASE["num_hidden_layers"] + 1
    sd = model.state_dict()
    for k in norms:
        assert np.array_equal(sd[k.replace("/", ".")].numpy(), np.asarray(flat[k]))
    with pytest.raises(ValueError, match="model/extra/weight"):
        hf_flax_params_to_torch(dict(flat, **{"model/extra/weight": np.ones(4, np.float32)}), model)
    short = {k: v for k, v in flat.items() if k != norms[0]}
    with pytest.raises(ValueError, match=norms[0].replace("/", r"\.")):
        hf_flax_params_to_torch(short, model)


# ---------------------------------------------------------------- the steps against transformers' forward

def teacher_forced(dec, model, bucket, n_pad, n_forced=6, seed=1):
    """Prefill a left-padded bucket, then `n_forced` forced tokens → the
    largest difference between each step's logits and the model's forward
    over the whole sequence."""
    ids, mask = left_padded(bucket - n_pad, bucket, seed=n_pad)
    forced = np.random.default_rng(seed).integers(3, 96, n_forced)
    full = np.concatenate([ids, forced[None]], axis=1)
    full_mask = np.concatenate([mask, np.ones((1, n_forced), np.int64)], axis=1)
    pos = np.clip(full_mask.cumsum(-1) - 1, 0, None)
    with torch.no_grad():
        ref = model(input_ids=torch.from_numpy(full), attention_mask=torch.from_numpy(full_mask),
                    position_ids=torch.from_numpy(pos)).logits[0]
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
    return max(float((g - ref[bucket - 1 + j]).abs().max()) for j, g in enumerate(got))


@pytest.mark.parametrize("n_pad", [0, 3])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_llama_steps_match_the_models_logits(pairs, family, n_pad):
    """A longer bucket's turn runs first, so stale slots past the bucket are
    in the cache; then prefill and six teacher-forced steps, each step's
    logits against the model's forward; the pad rows' cached keys and
    values stay finite."""
    model = pairs[family][1]
    dec = LlamaDecoder(model, BUCKETS, chat_search(model))
    assert (dec.heads, dec.kv_heads, dec.head_dim) == (4, 2, 16 if family == "gemma" else 8)
    with torch.no_grad():
        ids, mask = left_padded(40, 64, seed=9)
        dec.inputs(64)[0].copy_(torch.from_numpy(ids))
        dec.inputs(64)[1].copy_(torch.from_numpy(mask))
        dec.prefill(64, False)
        for _ in range(4):
            dec.step(False)
    err = teacher_forced(dec, model, 16, n_pad)
    assert err <= LOGIT_ATOL, err


def test_published_rope_scaling_and_tied_head_follow_the_model():
    """Llama-3.2's rotary form (``rope_theta`` 500000, ``llama3`` scaling) and
    a tied head, with a bias on the attention: the decoder's tables are the
    rotary module's own frequencies, and its steps follow the forward."""
    model = torch_model("llama", rope_theta=500000.0, tie_word_embeddings=True, attention_bias=True,
                        rope_scaling=dict(rope_type="llama3", factor=32.0, low_freq_factor=1.0, high_freq_factor=4.0,
                                          original_max_position_embeddings=64))
    dec = LlamaDecoder(model, BUCKETS, chat_search(model))
    assert dec.rope_type == "llama3" and torch.equal(dec.inv_freq, model.model.rotary_emb.inv_freq.float())
    assert model.lm_head.weight is model.model.embed_tokens.weight
    err = teacher_forced(dec, model, 32, 3)
    assert err <= LOGIT_ATOL, err


def test_f12_flax_llama_ignores_rope_theta(pairs):
    """F12 (the JAX package's, not repaired there): transformers' Flax Llama
    computes its rotary frequencies with the base 10000 and never reads
    ``rope_theta``.  At 500000 the Flax logits part from the PyTorch model's
    on the same weights (by over ten times the steps' bound at the last
    prompt position, with weights at their init scale), while the port's
    steps follow the PyTorch model; at 10000 all three agree."""
    flax_model, _ = pairs["llama"]
    params = flatten_dict(flax_model.params, sep="/")
    ids, mask = left_padded(12, 16, seed=4)
    pos = np.clip(mask.cumsum(-1) - 1, 0, None)
    errs = {}
    for theta in (10000.0, 500000.0):
        flax_theta = transformers.FlaxLlamaForCausalLM(config("llama", rope_theta=theta), seed=0, _do_init=False)
        ref = np.asarray(flax_theta(ids, attention_mask=mask, position_ids=pos, params=flax_model.params).logits)
        model = transformers.LlamaForCausalLM(config("llama", rope_theta=theta)).eval()
        model.load_state_dict(hf_flax_params_to_torch(params, model))
        with torch.no_grad():
            want = model(input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask),
                         position_ids=torch.from_numpy(pos)).logits[0, -1].numpy()
        dec = LlamaDecoder(model, (16,), chat_search(model, 1))
        dec.inputs(16)[0].copy_(torch.from_numpy(ids))
        dec.inputs(16)[1].copy_(torch.from_numpy(mask))
        with torch.no_grad():
            dec.prefill(16, False)
        errs[theta] = (float(np.abs(ref[0, -1] - want).max()), float(np.abs(dec.logits[0].numpy() - want).max()))
    assert errs[10000.0][0] <= LOGIT_ATOL and errs[10000.0][1] <= LOGIT_ATOL, errs
    assert errs[500000.0][1] <= LOGIT_ATOL and errs[500000.0][0] > 10 * LOGIT_ATOL, errs


# ---------------------------------------------------------------- against the JAX package's FlaxChatLM

@pytest.mark.parametrize("family", list(FAMILIES))
def test_chat_prompt_and_greedy_ids_equal_flax(pairs, family):
    """The same prompt gives the same ids, mask and bucket, and the default
    ``TorchChatLM`` (the Llama steps' graphs, uncaptured here) the same
    greedy sequence and reply as ``FlaxChatLM``, in two buckets and with an
    overlong prompt."""
    flax_model, model = pairs[family]
    kw = dict(tokenizer=StubTokenizer(), temperature=0.0, max_new_tokens=10, prompt_buckets=(16, 32))
    fl = FlaxChatLM(model=flax_model, **kw)
    pt = TorchChatLM(model=model, device="cpu", **kw)
    assert pt.decode == "graphs" and isinstance(pt._dec, LlamaDecoder)
    hist = [{"role": "user", "content": "x y z " * 4}, {"role": "assistant", "content": "fine then"}]
    buckets = []
    for history, user in (([], "hello there"), (hist, "and then what"), ([], "word " * 60)):
        msgs = ad.build_messages("be brief", history, user)
        ids, mask, bucket = pt._encode(msgs)
        ids_j, mask_j, bucket_j = fl._encode(msgs)
        assert bucket == bucket_j and np.array_equal(ids, ids_j) and np.array_equal(mask, mask_j)
        ref = np.asarray(fl._program(bucket, False)(ids_j, mask_j, fl._params, fl._base_key))
        np.testing.assert_array_equal(pt._generate(ids, mask), ref)
        assert pt.chat("be brief", history, user) == fl.chat("be brief", history, user)
        buckets.append(bucket)
    assert buckets == [16, 32, 32] and ("prefill", 16, False) in pt.graphs.keys()


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
    assert (staged.decode, eager.decode) == ("graphs", "eager") and eager.graphs is None
    for turn, (n_real, bucket) in enumerate(PROMPTS):
        ids, mask = left_padded(n_real, bucket, seed=turn)
        gens = [step_generator(7, turn, "chat", "cpu") if temperature else None for _ in range(2)]
        np.testing.assert_array_equal(staged._generate(ids, mask, gens[0]), eager._generate(ids, mask, gens[1]))
    assert sorted(k for k in staged.graphs.keys() if k[0] == "prefill") == [
        ("prefill", b, temperature > 0) for b in BUCKETS]


@pytest.mark.parametrize("family", ["llama", "gemma"])
def test_stub_graphs_capture_each_key_once_and_replay(stub_card, pairs, family):  # noqa: F811
    """Under the stub graph a capture records the step without running it
    (the decoder's buffers are restored after it) and a replay runs it: the
    ids equal the eager loop's, three prefill buckets and the decode step
    are captured once each, and every later call replays."""
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


# ---------------------------------------------------------------- refusals

@pytest.mark.parametrize("family, flag, value", [
    ("llama", "hidden_act", "relu"),
    ("gemma", "hidden_activation", "gelu"),
    ("mistral", "sliding_window", 32),
    ("llama", "rope_type", "dynamic"),
    ("llama", "rope_type", "longrope"),
])
def test_llama_decoder_refuses_what_it_does_not_implement(family, flag, value):
    """Each refusal names its flag; ``graphs=False`` takes the same model.  A
    Mistral window shorter than the cache (64 + 8 slots) would mask more
    than the steps do; at or beyond it the window changes nothing."""
    kw = {flag: value}
    if flag == "rope_type":
        kw = {"rope_scaling": {"rope_type": value, "factor": 2.0,
                               **({"short_factor": [1.0] * 4, "long_factor": [1.0] * 4,
                                   "original_max_position_embeddings": 128} if value == "longrope" else {})}}
    model = torch_model(family, **kw)
    with pytest.raises(ValueError, match=f"config.{flag}="):
        TorchChatLM(model=model, tokenizer=StubTokenizer(), prompt_buckets=BUCKETS, max_new_tokens=8, device="cpu")
    assert TorchChatLM(model=model, tokenizer=StubTokenizer(), prompt_buckets=BUCKETS, device="cpu",
                       graphs=False).graphs is None
    if flag == "sliding_window":
        lm = TorchChatLM(model=torch_model(family, sliding_window=72), tokenizer=StubTokenizer(),
                         prompt_buckets=BUCKETS, max_new_tokens=8, device="cpu")
        assert lm.decode == "graphs"


# ---------------------------------------------------------------- feel_me --llm device

def gpt_neo():
    torch.manual_seed(0)
    cfg = transformers.GPTNeoConfig(vocab_size=96, hidden_size=32, num_layers=2, num_heads=2,
                                    attention_types=[[["global", "local"], 1]], window_size=8,
                                    max_position_embeddings=256, bos_token_id=1, eos_token_id=2)
    return transformers.GPTNeoForCausalLM(cfg).eval()


def bart():
    """A BART decoder (``BartForCausalLM``: decode steps of its own, ``decode.BartDecoder``)."""
    torch.manual_seed(0)
    cfg = transformers.BartConfig(vocab_size=96, d_model=32, decoder_layers=2, encoder_layers=2,
                                  decoder_attention_heads=2, encoder_attention_heads=2, decoder_ffn_dim=64,
                                  encoder_ffn_dim=64, max_position_embeddings=256)
    return transformers.BartForCausalLM(cfg).eval()


def gpt_neox():
    """A GPT-NeoX, a causal LM type without decode steps in the port."""
    torch.manual_seed(0)
    cfg = transformers.GPTNeoXConfig(vocab_size=96, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                                     intermediate_size=64, max_position_embeddings=256, bos_token_id=1,
                                     eos_token_id=2)
    return transformers.GPTNeoXForCausalLM(cfg).eval()


@pytest.mark.parametrize("family, decode", [("llama", "graphs"), ("gpt_neo", "graphs"), ("bart", "graphs"),
                                            ("gpt_neox", "eager")])
def test_feel_me_llm_device_constructs_for_the_family(family, decode, tmp_path, monkeypatch, capsys):
    """``feel_me --llm device --llm_model <dir>`` on a model saved with
    ``save_pretrained`` (the stub tokenizer in place of the tokenizer files):
    a tiny llama, gpt_neo and BART decoder decode through their graphs, a
    tiny GPT-NeoX (a type without decode steps) through the eager loop and
    says so on one line; either way its ids equal ``graphs=False``'s."""
    from emojivoice_tpu_torch.apps import feel_me
    from emojivoice_tpu_torch.apps.feel_me import FeelMe
    from emojivoice_tpu_torch.inference.pipeline import SynthesisPipeline

    model = {"llama": lambda: torch_model("llama"), "gpt_neo": gpt_neo, "bart": bart, "gpt_neox": gpt_neox}[family]()
    model.save_pretrained(tmp_path / family)
    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained", lambda name, **kw: StubTokenizer())
    monkeypatch.setattr(SynthesisPipeline, "from_random", classmethod(lambda cls, **kw: object()))
    monkeypatch.setattr(FeelMe, "__init__", lambda self, pipe, asr=None, llm=None, **kw: setattr(self, "llm", llm))
    built = []
    monkeypatch.setattr(FeelMe, "run", lambda self: built.append(self.llm))
    capsys.readouterr()
    argv = ["--cpu", "--random_init", "--asr", "console", "--llm", "device", "--llm_model", str(tmp_path / family)]
    assert feel_me.main(argv) == 0
    lm, = built
    said = [line for line in capsys.readouterr().out.splitlines() if line.startswith("[TorchChatLM]")]
    assert lm.decode == decode and lm.device.type == "cpu"
    assert said == ([] if decode == "graphs" else [f"[TorchChatLM] model_type {family!r} has no decode steps in the "
                                                   "port: it decodes through transformers' forward on cpu, one "
                                                   "token at a time"])
    eager = TorchChatLM(model=lm._model, tokenizer=StubTokenizer(), temperature=0.0, device="cpu", graphs=False)
    lm.temperature = 0.0
    ids, mask, _ = lm._encode(ad.build_messages("be brief", [], "hello there"))
    np.testing.assert_array_equal(lm._generate(ids, mask), eager._generate(ids, mask))
