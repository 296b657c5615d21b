"""The port's ASR and LLM adapters (``emojivoice_tpu_torch/apps/torch_adapters.py``)
against the JAX package's Flax adapters, hermetically.

``tests/test_flax_adapters.py``'s cases run on the port with the same tiny
random-init configs and stub tokenizers, on the CPU.  Beside them, the two
adapters on one set of weights (the Flax init carried over by
``io/from_jax.py::hf_flax_params_to_torch``): first-step logits within 1e-4,
greedy token ids equal, the same prompt ids, mask and bucket, and the
Whisper decode's generation-config processors (suppressed and forced tokens)
applied at the same steps.  Sampling replays from a seed and differs between
turns and seeds.
"""

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

import jax.numpy as jnp  # noqa: E402
from flax.traverse_util import flatten_dict  # noqa: E402

from emojivoice_tpu.apps.adapters import build_messages as jax_build_messages  # noqa: E402
from emojivoice_tpu.apps.flax_adapters import FlaxChatLM, FlaxWhisperASR  # noqa: E402
from emojivoice_tpu_torch.apps import adapters as ad  # noqa: E402
from emojivoice_tpu_torch.apps.torch_adapters import TorchChatLM, TorchWhisperASR  # noqa: E402
from emojivoice_tpu_torch.io.from_jax import hf_flax_params_to_torch  # noqa: E402
from emojivoice_tpu_torch.utils import observability as obs  # noqa: E402

torch.set_num_threads(2)
LOGIT_TOL = 1e-4


class StubTokenizer:
    """Minimal decode/encode surface: id <-> 'w<id>' words (the JAX tests')."""

    pad_token_id = 0
    eos_token_id = 2
    chat_template = None

    def __call__(self, text):
        ids = [3 + (sum(ord(c) for c in tok) % 60) for tok in text.split()]
        return {"input_ids": ids}

    def decode(self, ids, skip_special_tokens=True):
        if skip_special_tokens:
            ids = [i for i in ids if i > 2]
        return " ".join(f"w{i}" for i in ids)


def whisper_config(**kw):
    return transformers.WhisperConfig(
        vocab_size=64, num_mel_bins=80, d_model=32,
        encoder_layers=1, decoder_layers=1,
        encoder_attention_heads=2, decoder_attention_heads=2,
        encoder_ffn_dim=64, decoder_ffn_dim=64,
        max_source_positions=1500, max_target_positions=48,
        decoder_start_token_id=1, eos_token_id=2, pad_token_id=0, bos_token_id=1,
        **{"begin_suppress_tokens": None, "suppress_tokens": None, "forced_decoder_ids": None, **kw},
    )


def bridged(flax_model, torch_cls):
    """The torch class on the Flax model's weights."""
    model = torch_cls(flax_model.config)
    model.load_state_dict(hf_flax_params_to_torch(flatten_dict(flax_model.params, sep="/"), model))
    return model.eval()


@pytest.fixture(scope="module")
def whisper_pair():
    flax_model = transformers.FlaxWhisperForConditionalGeneration(whisper_config(), seed=0)
    return flax_model, bridged(flax_model, transformers.WhisperForConditionalGeneration)


@pytest.fixture(scope="module")
def gpt2_pair():
    cfg = transformers.GPT2Config(vocab_size=96, n_positions=256, n_embd=32, n_layer=2, n_head=2,
                                  bos_token_id=1, eos_token_id=2, pad_token_id=0)
    flax_model = transformers.FlaxGPT2LMHeadModel(cfg, seed=0)
    return flax_model, bridged(flax_model, transformers.GPT2LMHeadModel)


@pytest.fixture(scope="module")
def tiny_gpt2(gpt2_pair):
    return gpt2_pair[1]


def sine(n=22050, sr=22050, f=440.0):
    t = np.arange(n) / sr
    return (0.3 * np.sin(2 * np.pi * f * t)).astype(np.float32)


def seeded_features(seed=0):
    return np.random.default_rng(seed).normal(size=(1, 80, 3000)).astype(np.float32)


# ---------------------------------------------------------------- the JAX tests' cases, on the port

def test_torch_whisper_transcribe_deterministic(whisper_pair, tmp_path):
    asr = TorchWhisperASR(model=whisper_pair[1], tokenizer=StubTokenizer(), max_length=12, device="cpu")
    wav = sine()
    a = asr.transcribe_array(wav, 22050)  # exercises the 22.05k→16k resample
    b = asr.transcribe_array(wav, 22050)
    assert isinstance(a, str) and a == b

    from scipy.io import wavfile

    path = tmp_path / "utt.wav"
    wavfile.write(path, 22050, (wav * 32767).astype(np.int16))
    assert isinstance(asr.transcribe(str(path)), str)


def test_torch_whisper_single_feature_shape(whisper_pair):
    """Any input length maps to the fixed (1, 80, 3000) feature shape."""
    asr = TorchWhisperASR(model=whisper_pair[1], tokenizer=StubTokenizer(), max_length=12, device="cpu")
    shapes = set()
    orig = asr._generate

    def spy(feats):
        shapes.add(feats.shape)
        return orig(feats)

    asr._generate = spy
    for n in (8000, 16000, 60000):
        asr.transcribe_array(np.zeros(n, np.float32), 16000)
    assert shapes == {(1, 80, 3000)}


def test_torch_chat_lm_greedy_and_buckets(tiny_gpt2):
    kw = dict(model=tiny_gpt2, tokenizer=StubTokenizer(), temperature=0.0, max_new_tokens=8,
              prompt_buckets=(16, 32, 64), device="cpu")
    llm = TorchChatLM(**kw)
    assert llm.chat("be brief", [], "hello there") == TorchChatLM(**kw).chat("be brief", [], "hello there")
    buckets = []
    orig = llm._encode
    llm._encode = lambda msgs: buckets.append(orig(msgs)[2]) or orig(msgs)
    hist = [{"role": "user", "content": "x " * 20}, {"role": "assistant", "content": "y " * 20}]
    assert isinstance(llm.chat("be brief", hist, "hello again"), str)
    assert isinstance(llm.chat("be brief", [], "hello there"), str)
    assert buckets == [64, 16]  # short and long prompts land in different buckets


def test_torch_chat_lm_sampling_replays_from_its_seed(tiny_gpt2):
    def lm(seed):
        return TorchChatLM(model=tiny_gpt2, tokenizer=StubTokenizer(), temperature=0.8, max_new_tokens=8,
                           seed=seed, prompt_buckets=(16, 32), device="cpu")

    a, b, c = lm(7), lm(7), lm(8)
    msgs = ["hello", "tell me more", "hello"]
    seq_a = [a.chat("sys", [], m) for m in msgs]
    seq_b = [b.chat("sys", [], m) for m in msgs]
    seq_c = [c.chat("sys", [], m) for m in msgs]
    assert seq_a == seq_b  # same seed → the same turn-keyed draws
    assert seq_a != seq_c  # another seed → other draws
    assert seq_a[0] != seq_a[2]  # the same prompt on another turn draws anew


def test_torch_chat_lm_truncates_overlong_prompt(tiny_gpt2):
    llm = TorchChatLM(model=tiny_gpt2, tokenizer=StubTokenizer(), temperature=0.0, max_new_tokens=4,
                      prompt_buckets=(16,), device="cpu")
    ids, mask, bucket = llm._encode(ad.build_messages("sys", [], "word " * 100))
    assert bucket == 16 and ids.shape == (1, 16) and mask.all()
    assert isinstance(llm.chat("sys", [], "word " * 100), str)


def test_feel_me_turn_with_torch_llm(tiny_gpt2):
    """The full agent turn drives the port's LLM end to end: the reply is
    parsed for an emoji voice and synthesised through the port's pipeline."""
    from emojivoice_tpu_torch.apps.feel_me import FeelMe
    from tests.test_torch_apps import tiny_port_pipe

    class EmojiStubTokenizer(StubTokenizer):
        def decode(self, ids, skip_special_tokens=True):
            return "what a day 🙂"

    llm = TorchChatLM(model=tiny_gpt2, tokenizer=EmojiStubTokenizer(), temperature=0.0, max_new_tokens=4,
                      prompt_buckets=(16, 32, 64, 128, 256), device="cpu")

    class SpySink:
        def __init__(self):
            self.played = []

        def play(self, wav, sample_rate):
            self.played.append((np.asarray(wav).shape, sample_rate))

    sink = SpySink()
    app = FeelMe(tiny_port_pipe(), asr=ad.ConsoleASR(), llm=llm, sink=sink, steps=2, language=None)
    response, spk, spoken = app.turn("hi robot")
    assert response.endswith("🙂") and spoken == "what a day" and spk == 12
    assert len(sink.played) == 1


@pytest.mark.parametrize("graphs", [True, False], ids=["graphs", "eager"])
def test_whisper_records_its_features_encoder_and_a_step_a_token(whisper_pair, tmp_path, graphs):
    """The recorder on: ``transcribe`` records ``asr.features`` (the wav's
    load included), then ``asr.encode``, then one ``asr.step`` a decoded
    token, and transcribes as with it off."""
    from scipy.io import wavfile

    asr = TorchWhisperASR(model=whisper_pair[1], tokenizer=StubTokenizer(), max_length=12, device="cpu",
                          graphs=graphs)
    path = tmp_path / "utt.wav"
    wavfile.write(path, 22050, (sine() * 32767).astype(np.int16))
    want = asr.transcribe(str(path))
    seqs, real = [], asr._generate
    asr._generate = lambda feats: seqs.append(real(feats)) or seqs[-1]
    obs.enable()
    try:
        got = asr.transcribe(str(path))
    finally:
        obs.disable()
    spans = sorted(obs.drain(), key=lambda s: s["t0"])
    assert got == want
    tokens = list(seqs[0][0, 1:])
    n = next((i + 1 for i, t in enumerate(tokens) if t == 2), len(tokens))
    assert [s["name"] for s in spans] == ["asr.features", "asr.encode"] + ["asr.step"] * n
    assert all(s["parent"] is None for s in spans) and all(a["t1"] <= b["t0"] for a, b in zip(spans, spans[1:]))


@pytest.mark.parametrize("reply", ["what a day 🙂", "One short line. Then another line here. And a last one 🙂"],
                         ids=["full", "pipelined"])
def test_feel_me_records_its_reply_and_each_segment(tiny_gpt2, reply):
    """A turn records ``feel_me.respond`` around the chat LM's spans and one
    ``feel_me.segment`` a chunk handed to the sink, each ended before the
    chunk reaches the sink: the first one's end is the turn's first audio."""
    import time

    from emojivoice_tpu_torch.apps.feel_me import FeelMe
    from tests.test_torch_apps import tiny_port_pipe

    class ReplyTokenizer(StubTokenizer):
        def decode(self, ids, skip_special_tokens=True):
            return reply

    class TimedSink:
        def __init__(self):
            self.played = []

        def play(self, wav, sample_rate):
            self.played.append(time.perf_counter())

    llm = TorchChatLM(model=tiny_gpt2, tokenizer=ReplyTokenizer(), temperature=0.0, max_new_tokens=4,
                      prompt_buckets=(16, 32, 64, 128, 256), device="cpu")
    sink = TimedSink()
    app = FeelMe(tiny_port_pipe(), asr=ad.ConsoleASR(), llm=llm, sink=sink, steps=2, language=None, segment_chars=24)
    obs.enable()
    try:
        app.turn("hi robot")
    finally:
        obs.disable()
    spans = obs.drain()
    (respond,) = [s for s in spans if s["name"] == "feel_me.respond"]
    assert {s["name"] for s in spans if s["parent"] == respond["id"]} == {"llm.prompt", "llm.prefill", "llm.step",
                                                                          "llm.detokenize"}
    segments = [s for s in spans if s["name"] == "feel_me.segment"]
    assert [s["segment"] for s in segments] == list(range(len(sink.played)))
    assert len(segments) == (1 if reply.startswith("what") else 3)
    assert all(s["t1"] <= t for s, t in zip(segments, sink.played)) and respond["t1"] <= segments[0]["t0"]
    by_id = {s["id"]: s for s in spans}
    stages = [s for s in spans if s["name"].startswith("pipeline.")]
    assert stages and all(by_id[s["parent"]]["name"] == "feel_me.segment" for s in stages)


def test_fit_messages_preserves_system_prompt(tiny_gpt2):
    class WordTokenizer(StubTokenizer):
        def __call__(self, text):
            return {"input_ids": [3 + (sum(ord(c) for c in t) % 89) for t in text.split()]}

    tok = WordTokenizer()
    llm = TorchChatLM(model=tiny_gpt2, tokenizer=tok, temperature=0.0, max_new_tokens=4,
                      prompt_buckets=(32,), device="cpu")
    system = "always end with emoji"
    hist = []
    for i in range(12):
        hist.append({"role": "user", "content": f"u{i} filler words here"})
        hist.append({"role": "assistant", "content": f"a{i} more filler words"})
    ids = llm._fit_messages(ad.build_messages(system, hist, "latest question"))
    assert len(ids) <= 32
    sys_ids = tok("system: " + system)["input_ids"]
    assert ids[: len(sys_ids)] == sys_ids  # system head intact
    assert all(t in ids[-8:] for t in tok("latest question")["input_ids"])  # current turn survives


def test_chat_template_tokenizes_once(tiny_gpt2):
    class TemplatedTokenizer(StubTokenizer):
        chat_template = "{{messages}}"

        def apply_chat_template(self, messages, tokenize, add_generation_prompt):
            assert tokenize and add_generation_prompt
            return [7] * (3 * len(messages))

        def __call__(self, text):  # noqa: ARG002
            raise AssertionError("rendered template must not be re-tokenized")

    llm = TorchChatLM(model=tiny_gpt2, tokenizer=TemplatedTokenizer(), temperature=0.0, max_new_tokens=4,
                      prompt_buckets=(16, 32), device="cpu")
    assert isinstance(llm.chat("sys", [], "hi"), str)


@pytest.mark.parametrize("cls", ["TorchWhisperASR", "TorchChatLM"])
def test_adapters_without_a_card_raise_and_name_the_cpu(cls, monkeypatch, whisper_pair, tiny_gpt2):
    from emojivoice_tpu_torch.apps import torch_adapters

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = whisper_pair[1] if cls == "TorchWhisperASR" else tiny_gpt2
    with pytest.raises(RuntimeError, match='device="cpu"'):
        getattr(torch_adapters, cls)(model=model, tokenizer=StubTokenizer())


def test_default_asr_tries_the_ports_whisper_first(monkeypatch):
    """``default_asr`` builds the port's Whisper on the caller's device from
    files on disk where it builds, else transformers' pipeline, else the
    console."""
    from emojivoice_tpu_torch.apps import torch_adapters

    made = []

    class Fake:
        def __init__(self, model_name, device, local_files_only):
            made.append((model_name, device, local_files_only))

    monkeypatch.setattr(ad, "on_disk", lambda name: True)
    monkeypatch.setattr(torch_adapters, "TorchWhisperASR", Fake)
    assert isinstance(ad.default_asr("some/whisper", device="cpu"), Fake)
    assert made == [("some/whisper", "cpu", True)]

    def refuse(*a, **kw):
        raise OSError("no weights on disk")

    monkeypatch.setattr(torch_adapters, "TorchWhisperASR", refuse)
    monkeypatch.setattr(ad, "WhisperASR", refuse)
    assert isinstance(ad.default_asr(device="cpu"), ad.ConsoleASR)


def test_default_asr_never_reaches_for_the_network(monkeypatch, tmp_path):
    """Whisper's files are not on disk here: the console answers, and no
    socket is opened or name looked up on the way."""
    import socket

    tried = []

    def refuse(*a, **kw):
        tried.append(a)
        raise OSError("no network in this test")

    monkeypatch.setattr(socket, "getaddrinfo", refuse)
    monkeypatch.setattr(socket.socket, "connect", refuse)
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path))
    assert not ad.on_disk("openai/whisper-tiny.en")
    assert isinstance(ad.default_asr(), ad.ConsoleASR)
    assert tried == []


# ---------------------------------------------------------------- the port against the Flax adapters

def test_bridge_rejects_a_tree_that_does_not_fit(gpt2_pair):
    flax_model, torch_model = gpt2_pair
    flat = flatten_dict(flax_model.params, sep="/")
    extra = dict(flat, **{"transformer/extra/kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="transformer/extra/kernel"):
        hf_flax_params_to_torch(extra, torch_model)
    short = {k: v for k, v in flat.items() if k != "transformer/ln_f/scale"}
    with pytest.raises(ValueError, match="transformer.ln_f.weight"):
        hf_flax_params_to_torch(short, torch_model)


def test_whisper_first_step_logits_match_flax(whisper_pair):
    flax_model, torch_model = whisper_pair
    feats = seeded_features(1)
    start = np.array([[1, 5, 9]], np.int32)
    ref = np.asarray(flax_model(jnp.asarray(feats), decoder_input_ids=jnp.asarray(start)).logits)
    with torch.no_grad():
        got = torch_model(input_features=torch.from_numpy(feats),
                          decoder_input_ids=torch.from_numpy(start).long()).logits.numpy()
    assert got.shape == ref.shape == (1, 3, 64)
    np.testing.assert_allclose(got, ref, atol=LOGIT_TOL)


@pytest.mark.parametrize("processors", [
    {},
    {"suppress_tokens": [5, 11], "begin_suppress_tokens": [7, 2], "forced_decoder_ids": [[1, 9], [2, 13]]},
])
def test_whisper_greedy_ids_equal_flax(processors):
    """The port's greedy Whisper decode gives the Flax adapter's sequence,
    with and without the generation config's suppressed and forced tokens."""
    flax_model = transformers.FlaxWhisperForConditionalGeneration(whisper_config(), seed=3)
    torch_model = bridged(flax_model, transformers.WhisperForConditionalGeneration)
    for model in (flax_model, torch_model):
        for name, value in processors.items():
            setattr(model.generation_config, name, value)
    fl = FlaxWhisperASR(model=flax_model, tokenizer=StubTokenizer(), max_length=16)
    pt = TorchWhisperASR(model=torch_model, tokenizer=StubTokenizer(), max_length=16, device="cpu")
    for seed in (0, 1):
        feats = seeded_features(seed)
        ref = np.asarray(fl._generate(jnp.asarray(feats), fl._params))
        got = pt._generate(feats)
        np.testing.assert_array_equal(got, ref)
        if processors:
            assert list(got[0, 1:3]) == [9, 13] and not set(got[0, 3:]) & {5, 11}
    wav = sine(16000, 16000)
    assert pt.transcribe_array(wav, 16000) == fl.transcribe_array(wav, 16000)


def test_gpt2_first_step_logits_match_flax(gpt2_pair):
    """Left-padded prompts: the same positions (the real tokens' count) and
    mask give the Flax model's logits at every real token."""
    flax_model, torch_model = gpt2_pair
    ids = np.array([[0, 0, 0, 5, 17, 33, 8]], np.int32)
    mask = (ids != 0).astype(np.int32)
    pos = mask.cumsum(-1) - 1
    ref = np.asarray(flax_model(jnp.asarray(ids), attention_mask=jnp.asarray(mask),
                                position_ids=jnp.asarray(pos)).logits)
    with torch.no_grad():
        got = torch_model(input_ids=torch.from_numpy(ids).long(), attention_mask=torch.from_numpy(mask).long(),
                          position_ids=torch.from_numpy(pos).long().clamp(min=0)).logits.numpy()
    np.testing.assert_allclose(got[:, 3:], ref[:, 3:], atol=LOGIT_TOL)


def test_chat_prompt_and_greedy_ids_equal_flax(gpt2_pair):
    """The same prompt gives the same ids, mask and bucket, and greedy decode
    the same sequence, in two buckets and with an overlong prompt."""
    flax_model, torch_model = gpt2_pair
    kw = dict(tokenizer=StubTokenizer(), temperature=0.0, max_new_tokens=10, prompt_buckets=(16, 32, 64))
    fl = FlaxChatLM(model=flax_model, **kw)
    pt = TorchChatLM(model=torch_model, device="cpu", **kw)
    hist = [{"role": "user", "content": "x y z " * 6}, {"role": "assistant", "content": "fine then"}]
    for history, user in (([], "hello there"), (hist, "and then what"), ([], "word " * 90)):
        msgs = ad.build_messages("be brief", history, user)
        assert msgs == jax_build_messages("be brief", history, user)
        ids, mask, bucket = pt._encode(msgs)
        ids_j, mask_j, bucket_j = fl._encode(msgs)
        assert bucket == bucket_j and np.array_equal(ids, ids_j) and np.array_equal(mask, mask_j)
        ref = np.asarray(fl._program(bucket, False)(ids_j, mask_j, fl._params, fl._base_key))
        np.testing.assert_array_equal(pt._generate(ids, mask), ref)
        assert pt.chat("be brief", history, user) == fl.chat("be brief", history, user)
