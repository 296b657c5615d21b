"""The chat LM against the JAX package's ``FlaxChatLM`` for GPT-Neo, OPT,
XGLM, BLOOM and GPT-J (the port's decode steps, uncaptured on the CPU) and
for a BART decoder (transformers' forward), with the repairs of F13 and F14
and the generation config's rules (``apps/decode.py::ChatRules``).

* For each family of ``tests/test_torch_chat_decoders.py`` (the same tiny
  Flax models, bridged): the same prompt ids, mask and bucket, and the
  default ``TorchChatLM``'s greedy sequence and ``chat()`` string equal to
  the Flax ``generate``'s, in two buckets and with an overlong prompt.
* F13: XGLM's eager loop (``graphs=False``) gives the Flax ids with 5 left
  pads over 12 new tokens (transformers 4.57's XGLM adds its position
  offset to the ``position_ids`` it is given, in place).
* F14: a BART decoder (``BartForCausalLM``, whose forward takes no
  ``position_ids``) chats like ``FlaxBartForCausalLM`` under left pads,
  with the generation config's ``forced_eos_token_id`` at the last new
  token; it decodes eagerly and says so.
* The rules on a family with steps: a forced eos and a forced bos (a
  one-token bucket) give the Flax ids, graphed and eager; a field that the
  port does not implement is refused by name, in both modes.

About 60 s on this CPU (the Flax ``generate`` compiles take most of it).
"""

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from emojivoice_tpu.apps.flax_adapters import FlaxChatLM  # noqa: E402
from emojivoice_tpu_torch.apps import adapters as ad  # noqa: E402
from emojivoice_tpu_torch.apps.torch_adapters import TorchChatLM  # noqa: E402
from tests.test_torch_adapters import StubTokenizer, bridged  # noqa: E402
from tests.test_torch_chat_decoders import FAMILIES, flax_pair, pairs  # noqa: E402,F401  (pairs is a fixture)
from tests.test_torch_decode_graphs import left_padded  # noqa: E402

torch.set_num_threads(2)


def flax_ids(fl, ids, mask):
    bucket = ids.shape[1]
    return np.asarray(fl._program(bucket, False)(ids.astype(np.int32), mask.astype(np.int32), fl._params,
                                                 fl._base_key))


# ---------------------------------------------------------------- the five families against FlaxChatLM

@pytest.mark.parametrize("family", list(FAMILIES))
def test_chat_prompt_and_greedy_ids_equal_flax(pairs, family):  # noqa: F811
    """The same prompt gives the same ids, mask and bucket, and the default
    ``TorchChatLM`` (the family's steps, uncaptured here) the same greedy
    sequence and reply as ``FlaxChatLM``, in two buckets and with an
    overlong prompt."""
    flax_model, model = pairs[family]
    kw = dict(tokenizer=StubTokenizer(), temperature=0.0, max_new_tokens=10, prompt_buckets=(16, 32))
    fl = FlaxChatLM(model=flax_model, **kw)
    pt = TorchChatLM(model=model, device="cpu", **kw)
    assert pt.decode == "graphs" and type(pt._dec) is FAMILIES[family][4]
    hist = [{"role": "user", "content": "x y z " * 4}, {"role": "assistant", "content": "fine then"}]
    buckets, new = [], set()
    for history, user in (([], "hello there"), (hist, "and then what"), ([], "word " * 60)):
        msgs = ad.build_messages("be brief", history, user)
        ids, mask, bucket = pt._encode(msgs)
        ids_j, mask_j, bucket_j = fl._encode(msgs)
        assert bucket == bucket_j and np.array_equal(ids, ids_j) and np.array_equal(mask, mask_j)
        got = pt._generate(ids, mask)
        np.testing.assert_array_equal(got, flax_ids(fl, ids_j, mask_j))
        new |= set(got[0, bucket:].tolist())
        assert pt.chat("be brief", history, user) == fl.chat("be brief", history, user)
        buckets.append(bucket)
    assert buckets == [16, 32, 32] and ("prefill", 16, False) in pt.graphs.keys()
    assert len(new) > 1  # the replies are not one token over and over


# ---------------------------------------------------------------- F13 and F14

def test_f13_xglm_eager_positions_match_flax():
    """5 left pads, 12 new tokens: the eager loop gives each forward a
    position tensor of its own, so XGLM's in-place offset cannot drift the
    positions of later calls; the ids and the reply equal ``FlaxChatLM``'s.
    At a weight scale of 1 the greedy reply varies, and a drift of the
    positions parts it from Flax's (at the 11th new token on the parent of
    the repair)."""
    flax_model, model = flax_pair("xglm", init_std=1.0)
    kw = dict(tokenizer=StubTokenizer(), temperature=0.0, max_new_tokens=12, prompt_buckets=(16,))
    fl = FlaxChatLM(model=flax_model, **kw)
    eager = TorchChatLM(model=model, device="cpu", graphs=False, **kw)
    ids, mask = left_padded(11, 16, seed=5)
    got = eager._generate(ids, mask)
    np.testing.assert_array_equal(got, flax_ids(fl, ids, mask))
    assert len(set(got[0, 16:])) > 1
    assert eager.chat("be brief", [], "hi there") == fl.chat("be brief", [], "hi there")


# as many encoder layers as decoder layers: transformers 4.57 sizes BartForCausalLM's cache by the former
BART = dict(vocab_size=96, d_model=32, decoder_layers=2, encoder_layers=2, decoder_attention_heads=4,
            encoder_attention_heads=4, decoder_ffn_dim=64, encoder_ffn_dim=64, max_position_embeddings=256,
            init_std=0.2)


def tiny_bart():
    """A BART decoder from seed 0, the Flax model and the PyTorch one on its
    weights; its generation config forces eos (2) at the last new token."""
    flax_model = transformers.FlaxBartForCausalLM(transformers.BartConfig(**BART), seed=0)
    return flax_model, bridged(flax_model, transformers.BartForCausalLM)


def test_f14_bart_decoder_chats_like_flax(capsys):
    """BART's forward takes no ``position_ids``: fed the prompt's real tokens
    alone, its own positions count them from 0, as Flax's do; the forced eos
    ends a reply that reaches ``max_new_tokens``.  Ids (with 5 left pads and
    none) and ``chat()`` equal ``FlaxChatLM``'s, through the default
    adapter (``BartDecoder``'s steps, uncaptured here) and through the eager
    loop (``graphs=False``); neither prints a line."""
    flax_model, model = tiny_bart()
    assert model.generation_config.forced_eos_token_id == 2
    kw = dict(tokenizer=StubTokenizer(), temperature=0.0, max_new_tokens=12, prompt_buckets=(16, 32))
    fl = FlaxChatLM(model=flax_model, **kw)
    capsys.readouterr()
    lm, eager = TorchChatLM(model=model, device="cpu", **kw), TorchChatLM(model=model, device="cpu", graphs=False, **kw)
    assert (lm.decode, eager.decode, eager.graphs) == ("graphs", "eager", None)
    assert not capsys.readouterr().out
    for n_real in (11, 16):
        ids, mask = left_padded(n_real, 16, seed=n_real)
        want = flax_ids(fl, ids, mask)
        for adapter in (lm, eager):
            got = adapter._generate(ids, mask)
            np.testing.assert_array_equal(got, want)
            assert got[0, -1] == 2 and len(set(got[0, 16:])) > 2
    for user in ("hi there", "tell me more about the sea"):
        assert lm.chat("be brief", [], user) == eager.chat("be brief", [], user) == fl.chat("be brief", [], user)


# ---------------------------------------------------------------- the generation config's rules

@pytest.mark.parametrize("rule, bucket", [("forced_eos_token_id", 16), ("forced_bos_token_id", 1)])
def test_forced_tokens_follow_flax(rule, bucket):
    """A forced eos at the last of 6 new tokens (bucket 16), a forced bos at
    the first new token of a one-token bucket: the steps (graphs) and the
    eager loop give ``FlaxChatLM``'s ids."""
    flax_model, model = flax_pair("opt")
    for m in (flax_model, model):
        setattr(m.generation_config, rule, 7)
    kw = dict(tokenizer=StubTokenizer(), temperature=0.0, max_new_tokens=6, prompt_buckets=(bucket,))
    fl = FlaxChatLM(model=flax_model, **kw)
    ids, mask = left_padded(min(bucket, 12), bucket, seed=2)
    ref = flax_ids(fl, ids, mask)
    assert ref[0, bucket + (5 if rule == "forced_eos_token_id" else 0)] == 7
    for graphs in (True, False):
        np.testing.assert_array_equal(TorchChatLM(model=model, device="cpu", graphs=graphs, **kw)._generate(ids, mask),
                                      ref)


# the flags the port once refused, each at a value that changes the ids (min_length and suppress_tokens from
# tests/test_torch_chat_rules.py::rule_values: picked from the ids without them), and the temperature
FLAGS = {"num_beams": (3, 0.0), "min_length": (None, 0.0), "suppress_tokens": (None, 0.0), "top_p": (0.5, 0.6),
         "top_k": (3, 0.6)}


@pytest.mark.parametrize("flag", list(FLAGS))
def test_generation_flags_follow_flax(flag):
    """Flags the port once refused, now implemented: the greedy ones
    (a beam search over 3 beams, eos masked until ``cur_len`` passes
    ``min_length``, suppressed tokens) change ``FlaxChatLM``'s ids, and the
    port gives them through its steps and eagerly; top-p and top-k change
    the sampled ids, which are equal between the modes, and the first step
    keeps the Flax warpers' set."""
    from emojivoice_tpu_torch.apps.decode import warp
    from emojivoice_tpu_torch.utils.prng import step_generator
    from tests.test_torch_chat_rules import BUCKET, flax_kept, flax_pair_of, rule_values

    value, temperature = FLAGS[flag]
    fields = rule_values(flag, "gpt2") if value is None else {flag: value}
    plain = flax_pair_of("gpt2")
    flax_model, model = flax_pair_of("gpt2", **fields)
    kw = dict(tokenizer=StubTokenizer(), temperature=temperature, max_new_tokens=8, prompt_buckets=(BUCKET,))
    ids, mask = left_padded(BUCKET, BUCKET, seed=7)
    flagged = [TorchChatLM(model=model, device="cpu", graphs=graphs, **kw) for graphs in (True, False)]
    if temperature:
        logits = []
        got = [lm._generate(ids, mask, step_generator(3, 0, "chat", "cpu"), logits if lm.graphs else None)
               for lm in flagged]
        np.testing.assert_array_equal(got[0], got[1])
        kept = torch.isfinite(warp(logits[0], torch.tensor(temperature), flagged[0]._search.top_k,
                                   flagged[0]._search.top_p))
        assert torch.equal(kept, flax_kept(logits[0], flax_model, temperature))
        unflagged = TorchChatLM(model=plain[1], device="cpu", **kw)
        assert not np.array_equal(got[0], unflagged._generate(ids, mask, step_generator(3, 0, "chat", "cpu")))
        return
    want = flax_ids(FlaxChatLM(model=flax_model, **kw), ids, mask)
    for lm in flagged:
        np.testing.assert_array_equal(lm._generate(ids, mask), want)
    assert not np.array_equal(flax_ids(FlaxChatLM(model=plain[0], **kw), ids, mask), want)


@pytest.mark.parametrize("flag, value, temperature", [
    ("no_repeat_ngram_size", 3, 0.0),
    ("num_beams", 4, 0.6),
])
def test_generation_flags_the_port_does_not_implement_are_refused(flag, value, temperature):
    """What ``FlaxChatLM`` cannot run, the port refuses by name, graphed and
    eager alike: ``no_repeat_ngram_size`` and a beam search while sampling
    (``test_torch_chat_beams.py`` and ``test_torch_chat_rules.py`` hold
    Flax's own failures on both)."""
    from tests.test_torch_chat_decoders import torch_model

    model = torch_model("gptj")
    setattr(model.generation_config, flag, value)
    kw = dict(model=model, tokenizer=StubTokenizer(), prompt_buckets=(16, 32), max_new_tokens=8, device="cpu")
    for graphs in (True, False):
        with pytest.raises(ValueError, match=f"generation_config.{flag}="):
            TorchChatLM(temperature=temperature, graphs=graphs, **kw)
    if temperature:
        assert TorchChatLM(temperature=0.0, **kw).decode == "graphs"
