"""agent_whisper_dsv2lite: the agent of ``apps/feel_me.py`` on the card with
DeepSeek-V2-Lite as its chat LM — the port's ``TorchWhisperASR``
(whisper-tiny.en), ``TorchChatLM`` over DeepSeek-V2-Lite's published config
through its decode graphs (``decode.DeepseekV2Decoder``: latent attention
over a latent cache, the routed experts through K3), and matcha_emoji_v1's
synthesis — with weights drawn on the card from the run's seed and the
benchmark's stub tokenizer, its special boundary at the config's
``bos_token_id``.

The configuration file holds the chat LM's published config at its top
level (every key that is not one of the agent's, ``AGENT_KEYS``); Whisper,
the generation settings, the agent and the synthesis are
agent_whisper_gptj6b's.  As there, two chat adapters share the weights, one
sampling at the configuration's temperature and one greedy.

The build raises where ``TorchChatLM`` would decode DeepSeek-V2 through
transformers' eager forward (a program without its decode steps): such a
run would measure something else, 63 GB of weights a token.
"""

from __future__ import annotations

import hashlib

from benchmark.configs import agent_whisper_gptj6b as base
from benchmark.configs import matcha_emoji_v1
from benchmark.reference import deepseek_v2 as ref_dsv2
from benchmark.reference import whisper as ref_whisper
from benchmark.traffic.generate import WORDS, sub_seed
from benchmark.weights import draw

# the configuration's keys that are the agent's; every other key is the chat LM's config
AGENT_KEYS = ("name", "source", "whisper", "whisper_generation", "asr", "llm_generation", "agent", "tts", "weights",
              "precision", "assumed")


def llm_config(cfg: dict) -> dict:
    """The chat LM's config: the configuration's keys that are not the agent's
    (the builder, the check and the metrics all read it so)."""
    return {k: v for k, v in cfg.items() if k not in AGENT_KEYS}


class StubTokenizer(base.StubTokenizer):
    """agent_whisper_gptj6b's stub with the special ids from the config's
    ``bos_token_id`` (100000) on, so that an id under it, sampled or
    encoded, is a word; eos is the config's."""

    def __init__(self, special: int, eos: int):
        super().__init__()
        self.special, self.eos_token_id = special, eos

    def _id(self, word: str) -> int:
        if word in self.index:
            return self.index[word]
        h = int.from_bytes(hashlib.blake2b(word.encode(), digest_size=4).digest(), "little")
        return 3 + len(WORDS) + h % (self.special - 3 - len(WORDS))

    def decode(self, ids, skip_special_tokens=True):
        ids = [int(i) for i in ids]
        self.decoded.append(ids)
        keep = [i for i in ids if not skip_special_tokens or 2 < i < self.special]
        return " ".join(self.word(i) for i in keep)


def typed(tf, llm: dict) -> dict:
    """The chat LM's config as transformers' ``DeepseekV2Config`` takes it:
    a whole number where the class keeps a float (``routed_scaling_factor``
    1 → 1.0; transformers 5 validates the types), and the rotary scaling's
    numbers as floats but for its count of positions (5 warns otherwise).
    The values are the file's."""
    default = tf.DeepseekV2Config()
    out = {k: float(v) if type(v) is int and isinstance(getattr(default, k, None), float) else v
           for k, v in llm.items()}
    if isinstance(out.get("rope_scaling"), dict):
        out["rope_scaling"] = {k: float(v) if type(v) is int and k != "original_max_position_embeddings" else v
                               for k, v in out["rope_scaling"].items()}
    return out


def reference_weights(cfg: dict, seed: int, device, which: str):
    if which == "tts":
        return matcha_emoji_v1.reference_weights(base.tts_config(cfg), seed, device)
    if which == "whisper":
        return draw(ref_whisper.spec(cfg["whisper"]), sub_seed(seed, "whisper"), device)
    return draw(ref_dsv2.spec(llm_config(cfg)), sub_seed(seed, "dsv2"), device)


def build(cfg: dict, seed: int, device) -> base.Agent:
    from emojivoice_tpu_torch.apps.torch_adapters import (CHAT_DECODERS, TorchChatLM, TorchWhisperASR,
                                                          import_transformers)

    llm = llm_config(cfg)
    if llm["model_type"] not in CHAT_DECODERS:
        raise RuntimeError(f"agent_whisper_dsv2lite: the program has no decode steps for {llm['model_type']!r}: "
                           "TorchChatLM would decode it through transformers' eager forward, which this cell does "
                           "not measure")
    tf = import_transformers()
    cfg = dict(cfg, tts=base.tts_config(cfg))
    whisper = base._model(tf, "WhisperForConditionalGeneration", "WhisperConfig", cfg["whisper"],
                          ref_whisper.spec(cfg["whisper"]), sub_seed(seed, "whisper"), device)
    for k, v in cfg["whisper_generation"].items():
        setattr(whisper.generation_config, k, v)
    model = base._model(tf, "DeepseekV2ForCausalLM", "DeepseekV2Config", typed(tf, llm), ref_dsv2.spec(llm),
                        sub_seed(seed, "dsv2"), device)
    gen = cfg["llm_generation"]
    model.generation_config.top_k = gen["top_k"]
    model.generation_config.top_p = gen["top_p"]
    asr_tok, llm_tok = base.StubTokenizer(), StubTokenizer(llm["bos_token_id"], llm["eos_token_id"])
    asr = TorchWhisperASR(model=whisper, tokenizer=asr_tok, max_length=cfg["asr"]["max_length"], device=device)
    chat = {mode: TorchChatLM(model=model, tokenizer=llm_tok, temperature=t, max_new_tokens=gen["max_new_tokens"],
                              seed=sub_seed(seed, "chat"), prompt_buckets=tuple(gen["prompt_buckets"]),
                              device=device)
            for mode, t in (("sampled", gen["temperature"]), ("greedy", 0.0))}
    eager = [mode for mode, c in chat.items() if c.decode != "graphs"]
    if eager:
        raise RuntimeError(f"agent_whisper_dsv2lite: TorchChatLM decodes {llm['model_type']!r} eagerly ({eager}): "
                           "this cell measures the decode graphs")
    synth = matcha_emoji_v1.build(cfg["tts"], seed, device)
    return base.Agent(cfg=cfg, asr=asr, chat=chat, synth=synth, asr_tok=asr_tok, llm_tok=llm_tok)
