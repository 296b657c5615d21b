"""The adapters' decode steps and their staging (``apps/decode.py``), on the
CPU at tiny widths.

* The port's steps against transformers' PyTorch models, teacher-forced:
  every step's logits within LOGIT_ATOL of the model's own forward over the
  whole sequence (Whisper; GPT-2 with and without left pads, after a longer
  bucket has filled more of the cache).
* The staged path (``graphs=True``, the default; on the CPU the same keys
  and buffers without capture) against ``graphs=False`` (transformers'
  forward over its growing cache): the same ids, greedy and sampled, over
  turns that switch prompt buckets and come back.
* Sampling: it replays from its seed, and ``sample_top_k`` draws the top-50
  distribution (a frequency test beside ``torch.multinomial``; exactly 50
  kept where two tie at the 50th, as the Flax top-k warper keeps them).
* The decoders refuse, by name, a configuration they do not implement; a
  model type without decode steps decodes eagerly and says so.
* A stub ``torch.cuda.CUDAGraph`` stands in for the card: the capture runs
  the step and then restores the decoder's buffers (a capture does not run
  what it records), a replay runs the captured step.  The keys, captures and
  replays, and the ids, show the bookkeeping; a failed capture raises.

The Flax parity of the default path is ``tests/test_torch_adapters.py``'s
(``test_whisper_greedy_ids_equal_flax``, ``test_chat_prompt_and_greedy_ids_equal_flax``).
"""

import contextlib
import copy

import numpy as np
import pytest
import torch

from emojivoice_tpu_torch.apps.decode import (ChatRules, ChatSearch, DecodeGraphs, GPT2Decoder, WhisperDecoder,
                                              sample_top_k)
from emojivoice_tpu_torch.apps.torch_adapters import TorchChatLM, TorchWhisperASR, import_transformers
from emojivoice_tpu_torch.utils.prng import step_generator
from tests.test_torch_adapters import StubTokenizer, seeded_features, whisper_config

tf = import_transformers()
torch.set_num_threads(2)

LOGIT_ATOL = 1e-5  # f32: the port's steps against the model's own forward, every step
GPT2 = dict(vocab_size=96, n_positions=256, n_embd=32, n_layer=2, n_head=2, bos_token_id=1, eos_token_id=2,
            pad_token_id=0)
BUCKETS = (16, 32, 64)
PROCESSORS = {"suppress_tokens": [5, 11], "begin_suppress_tokens": [7, 2], "forced_decoder_ids": [[1, 9], [2, 13]]}


def gpt2(seed=0, **kw):
    torch.manual_seed(seed)
    return tf.GPT2LMHeadModel(tf.GPT2Config(**{**GPT2, **kw})).eval()


def whisper(seed=0, processors=None, **kw):
    torch.manual_seed(seed)
    model = tf.WhisperForConditionalGeneration(whisper_config(**kw)).eval()
    for name, value in (processors or {}).items():
        setattr(model.generation_config, name, value)
    return model


@pytest.fixture(scope="module")
def tiny_gpt2():
    return gpt2()


def chat_search(model, max_new_tokens=8):
    """The ``ChatSearch`` that ``TorchChatLM`` hands its decoder: `model`'s
    generation config over its vocabulary, greedy, on the CPU."""
    return ChatSearch(model.generation_config, model.get_output_embeddings().weight.shape[0], max_new_tokens, "cpu")


def left_padded(n_real, bucket, seed):
    ids = np.zeros((1, bucket), np.int64)
    ids[0, bucket - n_real:] = np.random.default_rng(seed).integers(3, 96, n_real)
    return ids, (ids != 0).astype(np.int64)


# ---------------------------------------------------------------- the steps against transformers' forward

@pytest.mark.parametrize("n_pad", [0, 5])
def test_gpt2_steps_match_the_models_logits(tiny_gpt2, n_pad):
    """Prefill, then six teacher-forced steps: each step's logits against the
    model's forward over the whole left-padded sequence.  A longer bucket's
    turn runs first, so stale slots past the bucket are in the cache; the
    pad rows' cached keys and values stay finite."""
    dec = GPT2Decoder(tiny_gpt2, BUCKETS, chat_search(tiny_gpt2))
    with torch.no_grad():
        ids, mask = left_padded(40, 64, seed=9)
        dec.inputs(64)[0].copy_(torch.from_numpy(ids))
        dec.inputs(64)[1].copy_(torch.from_numpy(mask))
        dec.prefill(64, False)
        for _ in range(4):
            dec.step(False)

        bucket = 16
        ids, mask = left_padded(bucket - n_pad, bucket, seed=n_pad)
        forced = np.random.default_rng(1).integers(3, 96, 6)
        full = np.concatenate([ids, forced[None]], axis=1)
        full_mask = np.concatenate([mask, np.ones((1, 6), np.int64)], axis=1)
        pos = np.clip(full_mask.cumsum(-1) - 1, 0, None)
        ref = tiny_gpt2(input_ids=torch.from_numpy(full), attention_mask=torch.from_numpy(full_mask),
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
    err = max(float((g - ref[bucket - 1 + j]).abs().max()) for j, g in enumerate(got))
    assert err <= LOGIT_ATOL, err
    assert int(dec.kv.valid.sum()) == bucket - n_pad + 6


def test_whisper_steps_match_the_models_logits():
    """The encoder with the cross-attention keys and values, then eight
    teacher-forced steps: each step's logits against the model's forward
    over the whole decoder sequence."""
    model = whisper(seed=2)
    dec = WhisperDecoder(model, max_length=16, start=1,
                         rules=ChatRules(model.generation_config, model.config.vocab_size, 15, "cpu"))
    feats = torch.from_numpy(seeded_features(4))
    forced = [1] + list(np.random.default_rng(3).integers(3, 64, 8))
    with torch.no_grad():
        ref = model(input_features=feats, decoder_input_ids=torch.tensor([forced])).logits[0]
        dec.feats.copy_(feats)
        dec.encode()
        got = []
        for tok in forced:
            dec.tok.fill_(int(tok))
            dec.step()
            got.append(dec.logits[0].clone())
    err = max(float((g - ref[j]).abs().max()) for j, g in enumerate(got))
    assert err <= LOGIT_ATOL, err


# ---------------------------------------------------------------- staged against graphs=False

def chat_pair(model, temperature, **kw):
    kw = dict(model=model, tokenizer=StubTokenizer(), temperature=temperature, max_new_tokens=8,
              prompt_buckets=BUCKETS, device="cpu", **kw)
    return TorchChatLM(**kw), TorchChatLM(graphs=False, **kw)


PROMPTS = ((10, 16), (50, 64), (12, 16), (20, 32), (50, 64))  # (real tokens, bucket): away from 16 and back


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_staged_ids_equal_eager_across_buckets(tiny_gpt2, temperature):
    staged, eager = chat_pair(tiny_gpt2, temperature)
    for turn, (n_real, bucket) in enumerate(PROMPTS):
        ids, mask = left_padded(n_real, bucket, seed=turn)
        gens = [step_generator(7, turn, "chat", "cpu") if temperature else None for _ in range(2)]
        got, want = staged._generate(ids, mask, gens[0]), eager._generate(ids, mask, gens[1])
        np.testing.assert_array_equal(got, want)
    assert sorted(k for k in staged.graphs.keys() if k[0] == "prefill") == [
        ("prefill", b, temperature > 0) for b in (16, 32, 64)]


def test_whisper_staged_ids_equal_eager():
    model = whisper(seed=3, processors=PROCESSORS)
    kw = dict(model=model, tokenizer=StubTokenizer(), max_length=16, device="cpu")
    staged, eager = TorchWhisperASR(**kw), TorchWhisperASR(graphs=False, **kw)
    for seed in range(3):
        got, want = staged._generate(seeded_features(seed)), eager._generate(seeded_features(seed))
        np.testing.assert_array_equal(got, want)
        assert list(got[0, 1:3]) == [9, 13] and not set(got[0, 3:]) & {5, 11}
    assert staged.graphs.keys() == [("encode",), ("decode", 16)]


def test_new_weights_rebuild_the_steps(tiny_gpt2):
    """Parameters replaced by other tensors drop the graphs and rebuild the
    steps on the new ones."""
    model = copy.deepcopy(tiny_gpt2)
    staged, eager = chat_pair(model, 0.0)
    ids, mask = left_padded(10, 16, seed=0)
    np.testing.assert_array_equal(staged._generate(ids, mask), eager._generate(ids, mask))
    model.load_state_dict(gpt2(seed=5).state_dict(), assign=True)
    np.testing.assert_array_equal(staged._generate(ids, mask), eager._generate(ids, mask))
    assert staged.graphs.drops == 1


# ---------------------------------------------------------------- sampling

def test_sampling_replays_from_its_seed(tiny_gpt2):
    def replies(seed):
        lm = TorchChatLM(model=tiny_gpt2, tokenizer=StubTokenizer(), temperature=0.8, max_new_tokens=8,
                         seed=seed, prompt_buckets=BUCKETS, device="cpu")
        return [lm.chat("sys", [], m) for m in ("hello", "tell me more", "hello")]

    a, b, c = replies(3), replies(3), replies(4)
    assert a == b and a != c and a[0] != a[2]


def test_sample_top_k_draws_the_top_k_distribution():
    """40,000 draws on fixed logits (80 tokens, a tie at the 50th): each
    token's frequency within 5 standard errors of its probability, beside
    ``torch.multinomial``'s; tokens under the 50th are never drawn, and of
    the two tokens tied at the 50th exactly one is kept, the lower token id,
    as the Flax top-k warper (``lax.top_k``) keeps exactly k."""
    n, temperature = 40_000, torch.tensor(0.7)
    logits = torch.from_numpy(np.random.default_rng(0).normal(size=80).astype(np.float32)) * 0.5
    order = logits.argsort(descending=True)
    logits[order[50]] = logits[order[49]]  # a tie at the 50th
    scaled = logits / temperature
    kept = torch.zeros(80, dtype=torch.bool)
    kept[order[:49]] = True
    low, high = sorted((int(order[49]), int(order[50])))
    kept[low] = True
    probs = torch.softmax(scaled.masked_fill(~kept, float("-inf")), -1)
    gen = torch.Generator().manual_seed(1)
    u = torch.rand(n, generator=gen)
    drawn = sample_top_k(logits.expand(n, -1), temperature, u, 50, None)[:, 0]
    ref = torch.multinomial(probs, n, replacement=True, generator=gen)
    se = (probs * (1 - probs) / n).sqrt()
    for draws in (drawn, ref):
        freq = torch.bincount(draws, minlength=80).double() / n
        assert float(((freq - probs).abs() - 5 * se - 1e-9).max()) <= 0
    assert int((probs > 0).sum()) == 50 and set(drawn.tolist()) <= set(torch.nonzero(probs).flatten().tolist())
    assert low in set(drawn.tolist()) and high not in set(drawn.tolist())


# ---------------------------------------------------------------- refusals

@pytest.mark.parametrize("flag, value", [("scale_attn_by_inverse_layer_idx", True),
                                         ("reorder_and_upcast_attn", True), ("activation_function", "relu"),
                                         ("scale_attn_weights", False), ("add_cross_attention", True)])
def test_gpt2_decoder_refuses_what_it_does_not_implement(flag, value):
    model = gpt2(**{flag: value})
    with pytest.raises(ValueError, match=f"config.{flag}="):
        TorchChatLM(model=model, tokenizer=StubTokenizer(), prompt_buckets=BUCKETS, device="cpu")
    assert TorchChatLM(model=model, tokenizer=StubTokenizer(), prompt_buckets=BUCKETS, device="cpu",
                       graphs=False).graphs is None


@pytest.mark.parametrize("flag, value", [("activation_function", "relu"), ("scale_embedding", True)])
def test_whisper_decoder_refuses_what_it_does_not_implement(flag, value):
    with pytest.raises(ValueError, match=f"config.{flag}="):
        TorchWhisperASR(model=whisper(**{flag: value}), tokenizer=StubTokenizer(), device="cpu")


def gpt_neox(seed=0):
    """A tiny GPT-NeoX, a causal LM type without decode steps in the port."""
    torch.manual_seed(seed)
    return tf.GPTNeoXForCausalLM(tf.GPTNeoXConfig(vocab_size=96, hidden_size=32, num_hidden_layers=2,
                                                  num_attention_heads=2, intermediate_size=64,
                                                  max_position_embeddings=256, bos_token_id=1,
                                                  eos_token_id=2)).eval()


def test_another_causal_lm_is_refused_by_type(capsys):
    """A causal LM whose type has no decode steps in the port (here a tiny
    GPT-NeoX; BART's decoder has steps of its own since they were written)
    is not refused: the default ``TorchChatLM`` decodes it through
    transformers' forward on its device, says so on one line, and gives the
    ids of ``graphs=False``, greedy and sampled."""
    model = gpt_neox()
    capsys.readouterr()
    for temperature in (0.0, 0.8):
        lm, eager = chat_pair(model, temperature)
        assert (lm.decode, lm.graphs, lm._dec) == ("eager", None, None) and eager.decode == "eager"
        ids, mask = left_padded(12, 16, seed=3)
        gens = [step_generator(7, 0, "chat", "cpu") if temperature else None for _ in range(2)]
        np.testing.assert_array_equal(lm._generate(ids, mask, gens[0]), eager._generate(ids, mask, gens[1]))
    said = [line for line in capsys.readouterr().out.splitlines() if line.startswith("[TorchChatLM]")]
    assert said == ["[TorchChatLM] model_type 'gpt_neox' has no decode steps in the port: it decodes through "
                    "transformers' forward on cpu, one token at a time"] * 2  # one line for each adapter made


# ---------------------------------------------------------------- the staging under a stub graph

class _StubGraph:
    """Stands in for ``torch.cuda.CUDAGraph`` on the CPU; a replay runs the
    captured step (``on_replay``)."""

    def __init__(self, keep_graph=False):
        self.on_replay = None

    def replay(self):
        self.on_replay()


class _StubStream:
    def wait_stream(self, other):
        pass

    def synchronize(self):
        pass


def _buffers(dec) -> list:
    """Every tensor a decoder's steps write: its own and its cache's (not the
    model's parameters)."""
    out = []
    for obj in (dec, dec.kv):
        for value in vars(obj).values():
            values = value.values() if isinstance(value, dict) else value if isinstance(value, list) else [value]
            out.extend(v for v in values if isinstance(v, torch.Tensor) and not isinstance(v, torch.nn.Parameter))
    return out


@pytest.fixture
def stub_card(monkeypatch):
    """The card's graph calls stubbed: a capture runs the body and restores
    the decoders' buffers after it, as a capture records without running."""
    decoders = []

    @contextlib.contextmanager
    def graph(graph, pool=None, capture_error_mode="global"):
        assert capture_error_mode == "thread_local"
        saved = [(t, t.clone()) for dec in decoders for t in _buffers(dec)]
        yield
        for t, before in saved:
            t.copy_(before)

    real = DecodeGraphs.capture_graph

    def capture_graph(self, warm, body, keep_graph=False):
        out = real(self, warm, body, keep_graph)
        out[0].on_replay = body
        return out

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StubGraph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: _StubStream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _StubStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(DecodeGraphs, "capture_graph", capture_graph)

    def card(adapter):
        adapter.graphs.capture = True  # what a CUDA device gives, with the stubs above for the card
        decoders.append(adapter._dec)
        return adapter
    return card


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_stub_graphs_capture_each_key_once_and_replay(stub_card, tiny_gpt2, temperature):
    staged, eager = chat_pair(tiny_gpt2, temperature)
    staged = stub_card(staged)
    new_tokens = []
    for turn, (n_real, bucket) in enumerate(PROMPTS):
        ids, mask = left_padded(n_real, bucket, seed=turn)
        gens = [step_generator(7, turn, "chat", "cpu") if temperature else None for _ in range(2)]
        got, want = staged._generate(ids, mask, gens[0]), eager._generate(ids, mask, gens[1])
        np.testing.assert_array_equal(got, want)
        new = list(got[0, bucket:])
        new_tokens.append(next((i + 1 for i, t in enumerate(new) if t == 2), len(new)))
    sample = temperature > 0
    stats = staged.graphs.stats()
    assert staged.graphs.captures == stats["graphs"] == 4  # three prefill buckets and the decode step
    decode_calls = sum(n - 1 for n in new_tokens)
    assert stats["replays"] == (len(PROMPTS) - 3) + (decode_calls - 1)
    entries = {k: e for (k, _), e in staged.graphs.entries().items()}
    assert entries[("decode", sample)].replays == decode_calls - 1
    assert entries[("prefill", 16, sample)].replays == 1 and entries[("prefill", 64, sample)].replays == 1


def test_stub_graphs_whisper(stub_card):
    model = whisper(seed=3, processors=PROCESSORS)
    kw = dict(model=model, tokenizer=StubTokenizer(), max_length=16, device="cpu")
    staged, eager = stub_card(TorchWhisperASR(**kw)), TorchWhisperASR(graphs=False, **kw)
    for seed in range(2):
        np.testing.assert_array_equal(staged._generate(seeded_features(seed)), eager._generate(seeded_features(seed)))
    entries = {k: e for (k, _), e in staged.graphs.entries().items()}
    assert staged.graphs.captures == 2 and entries[("encode",)].replays == 1


def test_a_failed_capture_raises(stub_card, tiny_gpt2, monkeypatch):
    """No turn carries on eagerly after a failed capture."""
    staged = stub_card(chat_pair(tiny_gpt2, 0.0)[0])

    def refuse(graph, pool=None, capture_error_mode="global"):
        raise RuntimeError("operation not permitted when stream is capturing")
    monkeypatch.setattr(torch.cuda, "graph", refuse)
    with pytest.raises(RuntimeError, match="capturing"):
        staged.chat("sys", [], "hello")

