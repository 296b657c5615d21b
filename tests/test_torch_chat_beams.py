"""The chat LM's greedy beam search (``apps/decode.py``: ``beam_state``,
``beam_step``, ``beam_result`` over a ``StaticKV`` of one row per beam) and
BART's decode steps (``BartDecoder``), on the CPU at tiny widths, against
transformers' PyTorch BART and the JAX package's ``FlaxChatLM``.

* BART's steps against ``BartForCausalLM``'s forward, teacher-forced: every
  step's logits within LOGIT_ATOL with 0 and 3 left pads (the forward is
  fed the real tokens alone: its positions count the slots it is fed),
  after a longer bucket has filled more of the cache; the default adapter
  takes ``BartDecoder``.
* The beam search against ``FlaxChatLM``'s (transformers 4.57's Flax
  ``_beam_search``): the same ids for ``num_beams`` 2 and 3 and each
  ``early_stopping`` (True, False, ``"never"``) on GPT-2, Llama and BART,
  through the steps (uncaptured here) and eagerly (``graphs=False``: the
  same search over transformers' cache, reordered by the chosen beams),
  with eos set to a token the replies reach (so beams finish and the stop
  condition matters); ``length_penalty`` 0.5 and 2 on BART; GPT-Neo, OPT,
  XGLM, BLOOM and GPT-J at 3 beams (Flax's beam search runs on every family
  at these sizes).
* A stub ``torch.cuda.CUDAGraph`` (``tests/test_torch_decode_graphs.py``'s):
  the beam prefill per bucket and the beam decode step captured once each,
  then replayed, the ids those of the eager search; the cache holds one
  row per beam.
* Beam sampling: ``FlaxChatLM`` raises ``NotImplementedError`` (witness);
  the port refuses it by name when it is made, and a greedy beam adapter
  refuses a sampled turn.

About 60 s on this CPU (the Flax beam-search compiles take most of it).
"""

import functools

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from emojivoice_tpu.apps.flax_adapters import FlaxChatLM  # noqa: E402
from emojivoice_tpu_torch.apps import adapters as ad  # noqa: E402
from emojivoice_tpu_torch.apps.decode import BartDecoder  # noqa: E402
from emojivoice_tpu_torch.apps.torch_adapters import TorchChatLM  # noqa: E402
from emojivoice_tpu_torch.utils.prng import step_generator  # noqa: E402
from tests.test_torch_adapters import StubTokenizer  # noqa: E402
from tests.test_torch_chat_decoders import flax_pair  # noqa: E402
from tests.test_torch_chat_flax import flax_ids  # noqa: E402
from tests.test_torch_chat_rules import flax_pair_of  # noqa: E402
from tests.test_torch_decode_graphs import chat_search, left_padded, stub_card  # noqa: E402,F401  (stub_card is a fixture)

torch.set_num_threads(2)

LOGIT_ATOL = 1e-5  # f32: the port's steps against the model's own forward, every step (GPT-2's bound)
BUCKET, NEW = 16, 10


# ---------------------------------------------------------------- BART's steps

@pytest.mark.parametrize("n_pad", [0, 3])
def test_bart_steps_match_the_models_logits(n_pad):
    """A longer bucket's turn first (stale slots past the bucket), then a
    prefill and six teacher-forced steps: each step's logits against
    ``BartForCausalLM``'s forward over the real tokens so far."""
    _, model = flax_pair_of("bart")
    dec = BartDecoder(model, (16, 32, 64), chat_search(model))
    ids, mask = left_padded(16 - n_pad, 16, seed=n_pad)
    forced = np.random.default_rng(1).integers(3, 96, 6)
    with torch.no_grad():
        stale, stale_mask = left_padded(40, 64, seed=9)
        dec.inputs(64)[0].copy_(torch.from_numpy(stale))
        dec.inputs(64)[1].copy_(torch.from_numpy(stale_mask))
        dec.prefill(64, False)
        for _ in range(4):
            dec.step(False)
        real = np.concatenate([ids[0, n_pad:], forced])[None]
        ref = model(input_ids=torch.from_numpy(real)).logits[0]
        static_ids, static_mask = dec.inputs(16)
        static_ids.copy_(torch.from_numpy(ids))
        static_mask.copy_(torch.from_numpy(mask))
        dec.prefill(16, False)
        got = [dec.logits[0].clone()]
        assert all(torch.isfinite(k[:, :, :16]).all() for k in dec.kv.k + dec.kv.v)
        for tok in forced:
            dec.tok.fill_(int(tok))
            dec.step(False)
            got.append(dec.logits[0].clone())
    assert float(ref.abs().max()) > 1.0  # the bound is far under the logits' scale
    err = max(float((g - ref[15 - n_pad + j]).abs().max()) for j, g in enumerate(got))
    assert err <= LOGIT_ATOL, err
    assert int(dec.kv.valid.sum()) == 16 - n_pad + 6


@pytest.mark.parametrize("flag, value", [("activation_function", "silu"), ("model_type", "mbart")])
def test_bart_decoder_refuses_what_it_does_not_implement(flag, value):
    _, model = flax_pair_of("bart")
    setattr(model.config, flag, value)
    with pytest.raises(ValueError, match=f"config.{flag}="):
        BartDecoder(model, (16,), chat_search(model))


# ---------------------------------------------------------------- beam search against FlaxChatLM

@functools.lru_cache(maxsize=None)
def beam_eos(family) -> int:
    """A token the family's greedy reply reaches (its 4th), made eos for the
    beam tests: beams then finish at several lengths."""
    flax_model, _ = flax_pair_of(family)
    fl = FlaxChatLM(model=flax_model, tokenizer=StubTokenizer(), temperature=0.0, max_new_tokens=NEW,
                    prompt_buckets=(BUCKET,))
    ids, mask = left_padded(11, BUCKET, seed=1)
    return int(flax_ids(fl, ids, mask)[0, BUCKET + 3])


def beam_ids_equal_flax(flax_model, model, n_pad=5) -> np.ndarray:
    """``FlaxChatLM``'s beam-search sequence, and the port's equal to it
    through the steps and eagerly (a chat turn too); returns Flax's."""
    kw = dict(tokenizer=StubTokenizer(), temperature=0.0, max_new_tokens=NEW, prompt_buckets=(BUCKET,))
    fl = FlaxChatLM(model=flax_model, **kw)
    ids, mask = left_padded(BUCKET - n_pad, BUCKET, seed=1)
    want = flax_ids(fl, ids, mask)
    adapters = [TorchChatLM(model=model, device="cpu", graphs=graphs, **kw) for graphs in (True, False)]
    assert adapters[0].decode == "graphs" and adapters[0]._dec.kv.k[0].shape[0] == model.generation_config.num_beams
    for lm in adapters:
        np.testing.assert_array_equal(lm._generate(ids, mask), want)
    assert adapters[0].chat("be brief", [], "hello there") == fl.chat("be brief", [], "hello there")
    return want


@pytest.mark.parametrize("early_stopping", [True, False, "never"])
@pytest.mark.parametrize("beams", [2, 3])
@pytest.mark.parametrize("family", ["gpt2", "llama", "bart"])
def test_beam_search_equals_flax(family, beams, early_stopping):
    eos = beam_eos(family)
    flax_model, model = flax_pair_of(family, num_beams=beams, early_stopping=early_stopping, eos_token_id=eos)
    beam_ids_equal_flax(flax_model, model, n_pad=5 if beams == 3 else 0)


def test_early_stopping_and_beams_change_bart_replies():
    """On BART the settings part the results: 3 beams against greedy, and
    early stopping True against False (the stop condition decides)."""
    eos = beam_eos("bart")
    got = {}
    for beams, early in ((1, False), (3, True), (3, False)):
        flax_model, model = flax_pair_of("bart", num_beams=beams, early_stopping=early, eos_token_id=eos)
        got[beams, early] = beam_ids_equal_flax(flax_model, model)[0].tolist()
    assert got[3, True] != got[1, False] and got[3, True] != got[3, False]


@pytest.mark.parametrize("length_penalty", [0.5, 2.0])
def test_length_penalty_follows_flax(length_penalty):
    eos = beam_eos("bart")
    flax_model, model = flax_pair_of("bart", num_beams=3, early_stopping=False, eos_token_id=eos,
                                     length_penalty=length_penalty)
    beam_ids_equal_flax(flax_model, model)


@pytest.mark.parametrize("family", ["gpt_neo", "opt", "xglm", "bloom", "gptj"])
def test_other_families_beam_search_equals_flax(family):
    """3 beams, early stopping, eos the greedy reply's 4th token."""
    flax_model, model = flax_pair(family)
    kw = dict(tokenizer=StubTokenizer(), temperature=0.0, max_new_tokens=NEW, prompt_buckets=(BUCKET,))
    ids, mask = left_padded(11, BUCKET, seed=1)
    eos = int(flax_ids(FlaxChatLM(model=flax_model, **kw), ids, mask)[0, BUCKET + 3])
    for m in (flax_model, model):
        m.generation_config.num_beams, m.generation_config.early_stopping = 3, True
        m.generation_config.eos_token_id = m.config.eos_token_id = eos
    beam_ids_equal_flax(flax_model, model)


# ---------------------------------------------------------------- the staging under a stub graph

def test_stub_graphs_capture_the_beam_keys_once(stub_card):
    """Turns that switch buckets: one beam prefill graph per bucket and one
    beam decode graph, each captured once and then replayed; the ids are the
    eager search's."""
    eos = beam_eos("gpt2")
    _, model = flax_pair_of("gpt2", num_beams=3, early_stopping=True, eos_token_id=eos)
    kw = dict(model=model, tokenizer=StubTokenizer(), temperature=0.0, max_new_tokens=NEW,
              prompt_buckets=(16, 32), device="cpu")
    staged, eager = stub_card(TorchChatLM(**kw)), TorchChatLM(graphs=False, **kw)
    for turn, (n_real, bucket) in enumerate(((11, 16), (20, 32), (14, 16))):
        ids, mask = left_padded(n_real, bucket, seed=turn)
        np.testing.assert_array_equal(staged._generate(ids, mask), eager._generate(ids, mask))
    entries = {k: e for (k, _), e in staged.graphs.entries().items()}
    assert sorted(entries, key=str) == [("beam_decode",), ("beam_prefill", 16), ("beam_prefill", 32)]
    assert staged.graphs.captures == 3 and entries[("beam_prefill", 16)].replays == 1
    assert entries[("beam_decode",)].replays > 0


# ---------------------------------------------------------------- beam sampling

def test_beam_sampling_fails_in_flax_and_is_refused():
    """Witness: ``FlaxChatLM`` sampling (temperature 0.6) with 3 beams raises
    ``NotImplementedError`` in the Flax ``generate``; the port refuses it by
    name in both modes, and a greedy beam adapter refuses a sampled turn."""
    flax_model, model = flax_pair_of("gpt2", num_beams=3)
    kw = dict(tokenizer=StubTokenizer(), max_new_tokens=NEW, prompt_buckets=(BUCKET,))
    with pytest.raises(NotImplementedError, match="Beam sampling"):
        FlaxChatLM(model=flax_model, temperature=0.6, **kw).chat("be brief", [], "hello there")
    for graphs in (True, False):
        with pytest.raises(ValueError, match="generation_config.num_beams=3"):
            TorchChatLM(model=model, temperature=0.6, device="cpu", graphs=graphs, **kw)
        greedy = TorchChatLM(model=model, temperature=0.0, device="cpu", graphs=graphs, **kw)
        ids, mask, _ = greedy._encode(ad.build_messages("be brief", [], "hello there"))
        with pytest.raises(ValueError, match="num_beams=3"):
            greedy._generate(ids, mask, step_generator(0, 0, "chat", "cpu"))
