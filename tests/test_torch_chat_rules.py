"""The generation config's rules and sampling warpers of the chat LM
(``apps/decode.py``: ``ChatRules``, ``warp``, ``ChatSearch``) against the
JAX package's ``FlaxChatLM`` and transformers' Flax processors, on the CPU
at tiny widths.

* The rules against the Flax ``generate``'s own processors
  (``_get_logits_processor``) on the same scores at every ``cur_len`` of a
  turn: the same scores, -inf where Flax has -inf (a bucket of 16, and of 1
  with a forced bos, which moves the begin index).
* Each rule by itself and all together (``min_length``,
  ``suppress_tokens``, ``begin_suppress_tokens``, ``forced_decoder_ids``,
  with the forced bos / eos tokens) on GPT-2, Llama and BART: the greedy ids
  of ``FlaxChatLM``, through the default ``TorchChatLM`` (the decoder's
  steps, uncaptured here) and ``graphs=False``, with 5 left pads and none;
  each value is picked from the ids without the rule, so that it changes
  them.  A one-token bucket with a forced bos moves the begin index by one.
* The warpers: ``warp``'s kept set equals transformers'
  ``FlaxTopKLogitsWarper`` / ``FlaxTopPLogitsWarper`` (after the
  temperature) on the same logits, ties at the k-th included; a sampled
  turn with top-k and top-p gives the same ids through the steps and
  eagerly, and its first step keeps Flax's set.
* The generation config's ``max_new_tokens`` sets the turn's length, as the
  Flax ``generate`` takes it over ``FlaxChatLM``'s ``max_length``, and the
  buckets are fitted to the position table with it; its eos ends the
  sequence where the model config's differs.
* An unset ``top_k`` reads as the reference's 50 under any transformers.
* ``no_repeat_ngram_size``: ``FlaxChatLM`` fails on it (witness) and the
  port refuses it by name.

About 50 s on this CPU (the Flax ``generate`` compiles take most of it).
"""

import copy
import functools

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

import jax.numpy as jnp  # noqa: E402
from transformers.generation import flax_logits_process as flax_lp  # noqa: E402

from emojivoice_tpu.apps.flax_adapters import FlaxChatLM  # noqa: E402
from emojivoice_tpu_torch.apps.decode import ChatRules, ChatSearch, warp  # noqa: E402
from emojivoice_tpu_torch.apps.torch_adapters import TorchChatLM  # noqa: E402
from emojivoice_tpu_torch.utils.prng import step_generator  # noqa: E402
from tests import test_torch_llama_decode as llama_tests  # noqa: E402
from tests.test_torch_adapters import StubTokenizer, bridged  # noqa: E402
from tests.test_torch_chat_flax import flax_ids, tiny_bart  # noqa: E402
from tests.test_torch_decode_graphs import left_padded  # noqa: E402

torch.set_num_threads(2)

GPT2 = dict(vocab_size=96, n_positions=256, n_embd=32, n_layer=2, n_head=2, bos_token_id=1, eos_token_id=2,
            pad_token_id=0)
FAMILIES = ("gpt2", "llama", "bart")
BUCKET, NEW = 16, 8


@functools.lru_cache(maxsize=None)
def _made(family):
    if family == "gpt2":
        flax_model = transformers.FlaxGPT2LMHeadModel(transformers.GPT2Config(**GPT2), seed=0)
        return flax_model, bridged(flax_model, transformers.GPT2LMHeadModel)
    if family == "llama":
        flax_model = transformers.FlaxLlamaForCausalLM(llama_tests.config("llama"), seed=0)
        return flax_model, bridged(flax_model, transformers.LlamaForCausalLM)
    return tiny_bart()


def flax_pair_of(family, **gen):
    """(the Flax model from seed 0, the PyTorch model on its weights) of
    `family`, made once; each call returns shallow copies with their own
    config and generation config, `gen`'s fields set on the latter
    (``eos_token_id`` on both, as a checkpoint sets it)."""
    out = []
    for model in _made(family):
        model = copy.copy(model)
        if isinstance(model, torch.nn.Module):
            model.config = copy.deepcopy(model.config)
        else:  # a Flax model's config is a property over _config
            model._config = copy.deepcopy(model.config)
        model.generation_config = copy.deepcopy(model.generation_config)
        for name, value in gen.items():
            setattr(model.generation_config, name, value)
            if name == "eos_token_id":
                model.config.eos_token_id = value
        out.append(model)
    return tuple(out)


def flax_kept(logits: torch.Tensor, flax_model, temperature: float) -> torch.Tensor:
    """The tokens the Flax ``generate``'s warpers (``_get_logits_warper`` of
    `flax_model`'s generation config at `temperature`) keep of `logits` (1, V)."""
    gen = copy.deepcopy(flax_model.generation_config)
    gen.temperature = temperature
    out = flax_model._get_logits_warper(generation_config=gen)(None, jnp.asarray(logits.cpu().numpy()), 0)
    return torch.from_numpy(np.isfinite(np.asarray(out)))


@functools.lru_cache(maxsize=None)
def plain_greedy(family, n_pad=0) -> list:
    """``FlaxChatLM``'s greedy new ids without any rule: where the rules'
    values come from."""
    flax_model, _ = flax_pair_of(family)
    fl = FlaxChatLM(model=flax_model, tokenizer=StubTokenizer(), temperature=0.0, max_new_tokens=NEW,
                    prompt_buckets=(BUCKET,))
    ids, mask = left_padded(BUCKET - n_pad, BUCKET, seed=7)
    return flax_ids(fl, ids, mask)[0, BUCKET:].tolist()


def rule_values(rule: str, family: str) -> dict:
    """Generation-config fields for `rule` that change the greedy ids."""
    g = plain_greedy(family)
    other = lambda t, d: 3 + (t + d) % 90  # noqa: E731  (a token other than t)
    fields = {
        # eos where the plain reply has it early, masked until cur_len passes the bucket + 4
        "min_length": dict(eos_token_id=g[2], min_length=BUCKET + 4),
        "suppress_tokens": dict(suppress_tokens=[g[0], g[1]]),
        "begin_suppress_tokens": dict(begin_suppress_tokens=[g[0]]),
        "forced_decoder_ids": dict(forced_decoder_ids=[[1, other(g[0], 7)], [3, other(g[2], 11)]]),
    }
    if rule == "combined":
        return dict(eos_token_id=g[3], min_length=BUCKET + 5, suppress_tokens=[g[1]], begin_suppress_tokens=[g[0]],
                    forced_decoder_ids=[[2, other(g[1], 5)]], forced_eos_token_id=other(g[4], 3))
    return fields[rule]


# ---------------------------------------------------------------- the rules against Flax's processors

@pytest.mark.parametrize("bucket", [16, 1])
def test_rules_equal_the_flax_processors(bucket):
    """Every rule set, on the same random scores at every ``cur_len`` of an
    8-token turn: ``ChatRules`` (with n and the bucket as Python ints and as
    0-d tensors) gives Flax's scores.  At bucket 1 the forced bos falls on
    the first new token and moves the begin index by one."""
    flax_model, _ = flax_pair_of("gpt2", min_length=bucket + 3, suppress_tokens=[5, 11], forced_bos_token_id=9,
                                 begin_suppress_tokens=[7, 2], forced_decoder_ids=[[1, 13], [3, 17], [4, None]],
                                 forced_eos_token_id=4)
    gen = copy.deepcopy(flax_model.generation_config)
    gen.max_length = bucket + NEW
    processors = flax_model._get_logits_processor(generation_config=gen, input_ids_seq_length=bucket,
                                                  logits_processor=flax_lp.FlaxLogitsProcessorList())
    assert len(processors) == 6
    rules = ChatRules(gen, 96, NEW, "cpu")
    scores = np.random.default_rng(bucket).normal(size=(NEW, 1, 96)).astype(np.float32)
    for n in range(NEW):
        want = np.asarray(processors(None, jnp.asarray(scores[n]), jnp.asarray(bucket + n)))
        for args in ((n, bucket), (torch.tensor(n), torch.tensor(bucket))):
            got = rules(torch.from_numpy(scores[n]), *args).numpy()
            np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- each rule through FlaxChatLM

RULES = ("min_length", "suppress_tokens", "begin_suppress_tokens", "forced_decoder_ids", "combined")


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("family", FAMILIES)
def test_rules_give_flax_greedy_ids(family, rule):
    """The rule's values change ``FlaxChatLM``'s greedy ids; the port gives
    the same ids through its steps and eagerly, with 5 left pads and none."""
    values = rule_values(rule, family)
    flax_model, model = flax_pair_of(family, **values)
    kw = dict(tokenizer=StubTokenizer(), temperature=0.0, max_new_tokens=NEW, prompt_buckets=(BUCKET,))
    fl = FlaxChatLM(model=flax_model, **kw)
    adapters = [TorchChatLM(model=model, device="cpu", graphs=graphs, **kw) for graphs in (True, False)]
    assert adapters[0].decode == "graphs"
    for n_pad in (0, 5):
        ids, mask = left_padded(BUCKET - n_pad, BUCKET, seed=7)
        want = flax_ids(fl, ids, mask)
        if n_pad == 0:
            assert want[0, BUCKET:].tolist() != plain_greedy(family)
        for lm in adapters:
            np.testing.assert_array_equal(lm._generate(ids, mask), want)


def test_begin_index_after_a_forced_bos_in_a_one_token_bucket():
    """A one-token prompt with a forced bos: Flax suppresses the begin
    tokens at the second new token (begin index 1 + 1), not the first."""
    kw = dict(tokenizer=StubTokenizer(), temperature=0.0, max_new_tokens=6, prompt_buckets=(1,))
    ids, mask = np.array([[5]]), np.array([[1]])
    flax_model, _ = flax_pair_of("gpt2", forced_bos_token_id=9)
    second = flax_ids(FlaxChatLM(model=flax_model, **kw), ids, mask)[0, 2]
    flax_model, model = flax_pair_of("gpt2", forced_bos_token_id=9, begin_suppress_tokens=[int(second)])
    want = flax_ids(FlaxChatLM(model=flax_model, **kw), ids, mask)
    assert want[0, 1] == 9 and want[0, 2] != second
    for graphs in (True, False):
        np.testing.assert_array_equal(TorchChatLM(model=model, device="cpu", graphs=graphs, **kw)._generate(ids, mask),
                                      want)


# ---------------------------------------------------------------- the sampling warpers

def tied_logits(rows=6, vocab=96, seed=0) -> np.ndarray:
    """Random logits with ties: in each row the 3rd to 6th largest share a value."""
    x = np.random.default_rng(seed).normal(size=(rows, vocab)).astype(np.float32) * 2
    for row in x:
        order = np.argsort(-row)
        row[order[3:6]] = row[order[2]] - 0.1
    return x


@pytest.mark.parametrize("top_k, top_p", [(1, None), (4, None), (5, None), (50, None), (None, 0.05), (None, 0.5),
                                          (None, 0.9), (5, 0.5), (50, 0.9)])
def test_warp_keeps_the_flax_warpers_set(top_k, top_p):
    """Temperature, then top-k (exactly k: ties at the k-th broken towards
    the lower token id, as ``lax.top_k`` breaks them), then top-p: the kept
    tokens equal transformers' Flax warpers' on the same logits, row by
    row."""
    temperature = 0.6
    warpers = flax_lp.FlaxLogitsProcessorList([flax_lp.FlaxTemperatureLogitsWarper(temperature)])
    if top_k:
        warpers.append(flax_lp.FlaxTopKLogitsWarper(top_k=top_k))
    if top_p is not None:
        warpers.append(flax_lp.FlaxTopPLogitsWarper(top_p=top_p))
    for row in tied_logits():
        want = np.isfinite(np.asarray(warpers(None, jnp.asarray(row[None]), 0)))
        got = warp(torch.from_numpy(row[None]), torch.tensor(temperature), top_k, top_p)
        np.testing.assert_array_equal(torch.isfinite(got).numpy(), want)
        kept = got[torch.isfinite(got)]
        assert torch.equal(kept, (torch.from_numpy(row[None]) / temperature)[torch.isfinite(got)])
    if top_k and top_p is None:
        assert int(torch.isfinite(got).sum()) == top_k


@pytest.mark.parametrize("family", FAMILIES)
def test_sampled_top_k_top_p_equal_between_modes_and_keep_flax_set(family):
    """top_k 5 and top_p 0.8 at temperature 0.6 over three turns: the steps
    and the eager loop draw the same ids from the same uniforms, and the
    first step's kept set is the Flax warpers'."""
    flax_model, model = flax_pair_of(family, top_k=5, top_p=0.8)
    kw = dict(model=model, tokenizer=StubTokenizer(), temperature=0.6, max_new_tokens=NEW, prompt_buckets=(BUCKET,),
              device="cpu")
    staged, eager = TorchChatLM(**kw), TorchChatLM(graphs=False, **kw)
    assert (staged._search.top_k, staged._search.top_p) == (5, 0.8)
    for turn in range(3):
        ids, mask = left_padded(BUCKET - 2 * turn, BUCKET, seed=turn)
        logits = []
        got = staged._generate(ids, mask, step_generator(1, turn, "chat", "cpu"), logits)
        np.testing.assert_array_equal(got, eager._generate(ids, mask, step_generator(1, turn, "chat", "cpu")))
        kept = torch.isfinite(warp(logits[0], torch.tensor(0.6), 5, 0.8))
        assert torch.equal(kept, flax_kept(logits[0], flax_model, 0.6)) and 1 <= int(kept.sum()) <= 5


def test_search_reads_unset_fields_as_flax_does():
    """An unset field (None, as transformers 5's ``GenerationConfig()``
    leaves every one) reads as the reference's default, whatever
    transformers is installed: top_k 50 (transformers 4.57's, which
    ``FlaxChatLM`` reads), top_p none, one beam, length_penalty 1.0,
    early_stopping False.  Only an explicit top_k 0 (and top_p 1) turns a
    warper off."""
    assert ChatSearch(transformers.GenerationConfig(), 96, NEW, "cpu").top_k == 50
    gen = transformers.GenerationConfig()
    for name in ("top_k", "top_p", "num_beams", "length_penalty", "early_stopping", "min_length"):
        setattr(gen, name, None)
    search = ChatSearch(gen, 96, NEW, "cpu")
    assert (search.top_k, search.top_p, search.beams, search.length_penalty, search.early_stopping) == \
        (50, None, 1, 1.0, False)
    gen.top_k, gen.top_p = 0, 1.0
    assert (ChatSearch(gen, 96, NEW, "cpu").top_k, ChatSearch(gen, 96, NEW, "cpu").top_p) == (None, None)


# ---------------------------------------------------------------- the turn's length

def test_generation_config_max_new_tokens_sets_the_turn_length():
    """The Flax ``generate`` takes the generation config's ``max_new_tokens``
    over ``FlaxChatLM``'s ``max_length``: 5 new tokens where the adapter asks
    for 8, in both modes."""
    flax_model, model = flax_pair_of("gpt2", max_new_tokens=5)
    kw = dict(tokenizer=StubTokenizer(), temperature=0.0, max_new_tokens=NEW, prompt_buckets=(BUCKET,))
    ids, mask = left_padded(12, BUCKET, seed=3)
    want = flax_ids(FlaxChatLM(model=flax_model, **kw), ids, mask)
    assert want.shape == (1, BUCKET + 5)
    for graphs in (True, False):
        lm = TorchChatLM(model=model, device="cpu", graphs=graphs, **kw)
        assert lm.max_new_tokens == 5
        np.testing.assert_array_equal(lm._generate(ids, mask), want)


def test_generation_config_max_new_tokens_fits_the_buckets():
    """The buckets are fitted to the position table with the generation
    config's ``max_new_tokens``, not the adapter's: 20 new tokens push the
    bucket of 240 out of GPT-2's 256 positions (8 would keep it), and a
    prompt of the bucket of 16 gives ``FlaxChatLM``'s 20 ids in both modes;
    with no bucket left, the one made fits the 20 too."""
    flax_model, model = flax_pair_of("gpt2", max_new_tokens=20)
    kw = dict(tokenizer=StubTokenizer(), temperature=0.0, max_new_tokens=NEW)
    ids, mask = left_padded(12, BUCKET, seed=3)
    want = flax_ids(FlaxChatLM(model=flax_model, prompt_buckets=(BUCKET,), **kw), ids, mask)
    assert want.shape == (1, BUCKET + 20)
    for graphs in (True, False):
        lm = TorchChatLM(model=model, device="cpu", graphs=graphs, prompt_buckets=(BUCKET, 240), **kw)
        assert lm.prompt_buckets == (BUCKET,)
        np.testing.assert_array_equal(lm._generate(ids, mask), want)
    lm = TorchChatLM(model=model, device="cpu", prompt_buckets=(250,), **kw)
    assert lm.prompt_buckets == (236,) and max(lm.prompt_buckets) + lm.max_new_tokens <= 256


def test_the_generation_configs_eos_ends_the_sequence():
    """Where the generation config's eos is not the model config's, the Flax
    ``generate``'s loop ends at the former (the fill after it): so do the
    port's, in both modes."""
    g = plain_greedy("gpt2")
    flax_model, model = flax_pair_of("gpt2", eos_token_id=g[2])
    flax_model.config.eos_token_id = model.config.eos_token_id = 2
    kw = dict(tokenizer=StubTokenizer(), temperature=0.0, max_new_tokens=NEW, prompt_buckets=(BUCKET,))
    ids, mask = left_padded(BUCKET, BUCKET, seed=7)
    want = flax_ids(FlaxChatLM(model=flax_model, **kw), ids, mask)
    end = BUCKET + g.index(g[2])
    assert (want[0, end + 1:] == 0).all() and want[0, end] == g[2]
    for graphs in (True, False):
        np.testing.assert_array_equal(TorchChatLM(model=model, device="cpu", graphs=graphs, **kw)._generate(ids, mask),
                                      want)


# ---------------------------------------------------------------- what Flax cannot run

def test_no_repeat_ngram_size_fails_in_flax_and_is_refused():
    """Witness: ``FlaxChatLM`` fails on ``no_repeat_ngram_size`` (transformers
    4.57's Flax n-gram processor gathers with a mode JAX's sparse arrays do
    not take); the port refuses it by name in both modes."""
    flax_model, model = flax_pair_of("gpt2", no_repeat_ngram_size=2)
    kw = dict(tokenizer=StubTokenizer(), temperature=0.0, max_new_tokens=NEW, prompt_buckets=(BUCKET,))
    with pytest.raises(NotImplementedError, match="bcoo_gather"):
        FlaxChatLM(model=flax_model, **kw).chat("be brief", [], "hello there")
    for graphs in (True, False):
        with pytest.raises(ValueError, match="generation_config.no_repeat_ngram_size=2"):
            TorchChatLM(model=model, device="cpu", graphs=graphs, **kw)
