"""agent_whisper_gptj6b: the agent of ``apps/feel_me.py`` on the card —
the port's ``TorchWhisperASR`` (whisper-tiny.en's published config),
``TorchChatLM`` over GPT-J-6B's published config through its decode graphs,
and matcha_emoji_v1's synthesis pipeline — with weights drawn on the card
from the run's seed and the benchmark's stub tokenizer.

The synthesis is named by the configuration's ``tts`` (a configuration of
``configs/``), and read from that file: the agent speaks as that cell's
service does.

Two chat adapters share GPT-J's weights: one samples at the configuration's
temperature, one decodes greedily (the agent's sessions alternate, so that
the check has greedy tokens to hold against the reference's best).
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import sys
from pathlib import Path

import torch

from benchmark.configs import matcha_emoji_v1
from benchmark.harness import load_json
from benchmark.reference import gptj as ref_gptj
from benchmark.reference import whisper as ref_whisper
from benchmark.traffic.generate import EMOJI_SPEAKERS, WORDS, sub_seed
from benchmark.weights import draw

SPECIAL = 50256  # ids from here on are special in both vocabularies (eos, Whisper's task tokens)


class StubTokenizer:
    """Ids ↔ words without tokenizer files: an id decodes to a word of the
    benchmark's list (every 11th with a full stop, every 89th an emoji of
    the agent's voices); a word encodes to its index, any other to a hash.
    It keeps the ids of every encode and decode call, which the check reads:
    the ids the program was given and the tokens it served."""

    pad_token_id = 0
    eos_token_id = SPECIAL
    chat_template = None

    def __init__(self):
        self.index = {w: 3 + i for i, w in enumerate(WORDS)}
        self.emojis = list(EMOJI_SPEAKERS)
        self.encoded, self.decoded = [], []

    def _id(self, word: str) -> int:
        if word in self.index:
            return self.index[word]
        h = int.from_bytes(hashlib.blake2b(word.encode(), digest_size=4).digest(), "little")
        return 3 + len(WORDS) + h % (SPECIAL - 3 - len(WORDS))

    def word(self, i: int) -> str:
        if i % 89 == 0:
            return self.emojis[(i // 89) % len(self.emojis)]
        return WORDS[i % len(WORDS)] + ("." if i % 11 == 0 else "")

    def __call__(self, text):
        ids = [self._id(w) for w in text.split()]
        self.encoded.append(ids)
        return {"input_ids": ids}

    def decode(self, ids, skip_special_tokens=True):
        ids = [int(i) for i in ids]
        self.decoded.append(ids)
        keep = [i for i in ids if not skip_special_tokens or 2 < i < SPECIAL]
        return " ".join(self.word(i) for i in keep)


@dataclasses.dataclass
class Agent:
    cfg: dict
    asr: object
    chat: dict  # "sampled" / "greedy" → TorchChatLM
    synth: matcha_emoji_v1.Synthesis
    asr_tok: StubTokenizer
    llm_tok: StubTokenizer

    def free(self) -> None:
        self.asr = self.chat = None
        self.synth.free()


def tts_config(cfg: dict) -> dict:
    """The synthesis configuration `cfg` names (a configuration given whole
    stands for itself)."""
    t = cfg["tts"]
    return t if isinstance(t, dict) else load_json(Path(__file__).resolve().parent / f"{t}.json")


def _no_init():
    """transformers' context that skips its random initialisation (``draw``
    then fills every parameter once): in ``transformers.initialization``
    from version 5, in ``modeling_utils`` before.  Where the installed
    version has neither, the models are initialised twice and the run says
    so."""
    import importlib

    for where in ("transformers.initialization", "transformers.modeling_utils"):
        try:
            return getattr(importlib.import_module(where), "no_init_weights")()
        except (ImportError, AttributeError):
            continue
    print("benchmark: transformers has no no_init_weights: its initialisation runs", file=sys.stderr)
    return contextlib.nullcontext()


def _model(tf, cls_name: str, cfg_cls: str, cfg: dict, spec: list, seed: int, device):
    with torch.device(device), _no_init():
        model = getattr(tf, cls_name)(getattr(tf, cfg_cls)(**cfg)).float().eval()
    model.tie_weights()  # part of the initialisation skipped above
    params = dict(model.named_parameters())
    diff = set(n for n, _, _ in spec) ^ set(params)
    if diff:
        raise RuntimeError(f"{cls_name}: the weight spec and the model's parameters differ: {sorted(diff)[:8]}")
    draw(spec, seed, device, out=params)
    return model


def reference_weights(cfg: dict, seed: int, device, which: str):
    if which == "tts":
        return matcha_emoji_v1.reference_weights(tts_config(cfg), seed, device)
    if which == "whisper":
        return draw(ref_whisper.spec(cfg["whisper"]), sub_seed(seed, "whisper"), device)
    return draw(ref_gptj.spec(cfg["llm"]), sub_seed(seed, "gptj"), device)


def build(cfg: dict, seed: int, device) -> Agent:
    from emojivoice_tpu_torch.apps.torch_adapters import TorchChatLM, TorchWhisperASR, import_transformers

    tf = import_transformers()
    cfg = dict(cfg, tts=tts_config(cfg))
    whisper = _model(tf, "WhisperForConditionalGeneration", "WhisperConfig", cfg["whisper"],
                     ref_whisper.spec(cfg["whisper"]), sub_seed(seed, "whisper"), device)
    for k, v in cfg["whisper_generation"].items():
        setattr(whisper.generation_config, k, v)
    gptj = _model(tf, "GPTJForCausalLM", "GPTJConfig", cfg["llm"], ref_gptj.spec(cfg["llm"]),
                  sub_seed(seed, "gptj"), device)
    gen = cfg["llm_generation"]
    gptj.generation_config.top_k = gen["top_k"]
    gptj.generation_config.top_p = gen["top_p"]
    asr_tok, llm_tok = StubTokenizer(), StubTokenizer()
    asr = TorchWhisperASR(model=whisper, tokenizer=asr_tok, max_length=cfg["asr"]["max_length"], device=device)
    chat = {mode: TorchChatLM(model=gptj, tokenizer=llm_tok, temperature=t, max_new_tokens=gen["max_new_tokens"],
                              seed=sub_seed(seed, "chat"), prompt_buckets=tuple(gen["prompt_buckets"]),
                              device=device)
            for mode, t in (("sampled", gen["temperature"]), ("greedy", 0.0))}
    synth = matcha_emoji_v1.build(cfg["tts"], seed, device)
    return Agent(cfg=cfg, asr=asr, chat=chat, synth=synth, asr_tok=asr_tok, llm_tok=llm_tok)
