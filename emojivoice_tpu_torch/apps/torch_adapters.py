"""The conversational stack's ASR and LLM on the card: the port's
counterparts of the JAX package's ``apps/flax_adapters.py``.

The reference's feel_me agent chains torch Whisper (feel_me.py:29,268) and an
Ollama server (feel_me.py:115-119) around the TTS.  Here both run on the same
device as synthesis, on transformers' PyTorch model classes:

  TorchWhisperASR — Whisper's encoder once, then a greedy decode loop over
                    the decoder's key/value cache; the features are fixed at
                    (1, 80, 3000), as the JAX adapter has them.
  TorchChatLM     — causal-LM chat (``CHAT_DECODERS`` and any other causal LM) with the JAX adapter's
                    prompt handling (bucketed, left-padded prompts that never
                    lose the system message); sampling draws from a
                    ``torch.Generator`` on the model's device seeded from
                    (seed, turn), so a conversation replays from its seed.

By default (``graphs=True``) both decode through the port's own steps over a
static key/value cache (``apps/decode.py``), one captured CUDA graph per
key on the card, as the JAX adapters compile one program per ``generate``:
Whisper's encoder with the cross-attention keys and values, and its decode
step; the chat LM's prefill per prompt bucket and its decode step.  A turn
copies its inputs into static buffers, replays the prefill (or the encoder)
once and the decode step once a token, and reads each token through one
pinned copy for the end-of-sequence check.  On the CPU the same keys run
the steps without capture.  ``graphs=False`` keeps transformers' own
forward over its growing cache, a token at a time, as the yardstick.

Both decode loops apply what the Flax ``generate`` applied: greedy decoding
gives the Flax adapters' token ids on the same weights
(``io/from_jax.py::hf_flax_params_to_torch``), and sampling draws from the
same distribution (temperature, then the generation config's top-k and
top-p) by inverse CDF from the turn's uniforms, drawn at once before its
first token (``decode.sample_top_k``), in both modes alike.

With the recorder of ``utils/observability.py`` enabled, both record spans
on the calling thread.  Whisper: ``asr.features`` (from ``transcribe``'s
call: the wav's load and resample and the log-mel on the host),
``asr.encode`` (the features' copy in and the encoder) and one ``asr.step``
a token (the decode step and the token's read).  The chat LM, each span
with the adapter's ``turn``: ``llm.prompt`` (the messages, the fit to a
bucket and the tokenizer), ``llm.prefill`` (the prefill through the first
token's read), one ``llm.step`` a further token with, inside it,
``llm.replay`` (the step's graph launch on the host, or its eager forward)
and ``llm.read`` (the token's copy to the host and the wait for it), and
``llm.detokenize``.

Both take either a pretrained name or an injected (model, tokenizer); tests
drive them with tiny random-init configs and stub tokenizers.  Each runs on
the card unless ``device="cpu"`` is given.

The chat LM's decode steps exist for the model types of ``CHAT_DECODERS``
(GPT-2, the Llama family: llama, mistral, gemma, and gpt_neo, opt, xglm,
bloom, gptj, bart, and deepseek_v2: latent attention and routed experts).
Another causal LM that transformers' ``AutoModelForCausalLM`` builds
decodes through transformers' forward on the same device, as
``graphs=False`` does; the adapter says so on one line
when it is made, and ``TorchChatLM.decode`` reads ``"graphs"`` or
``"eager"``.  Either way the generation config's rules that the Flax
``generate`` applies for ``FlaxChatLM``'s call (``decode.ChatSearch``: the
logits processors, the top-k and top-p warpers, a greedy beam search where
``num_beams`` > 1, the config's ``max_new_tokens``) are applied, and what
``FlaxChatLM`` cannot run (``no_repeat_ngram_size``, beam sampling) is
refused by name.
"""

from __future__ import annotations

import inspect
import os
import sys
from typing import List, Optional, Sequence

import numpy as np
import torch

from emojivoice_tpu_torch.apps.decode import (BartDecoder, BloomDecoder, ChatRules, ChatSearch, DecodeGraphs,
                                              DeepseekV2Decoder, GPT2Decoder, GPTJDecoder, GPTNeoDecoder, LlamaDecoder,
                                              OPTDecoder, WhisperDecoder, XGLMDecoder, beam_reset, beam_result,
                                              beam_state, beam_step, sample_top_k, token_list)
from emojivoice_tpu_torch.utils import observability as obs
from emojivoice_tpu_torch.utils.prng import step_generator

WHISPER_SAMPLE_RATE = 16_000
# the chat LM's model types with decode steps of the port's own (apps/decode.py); another type decodes eagerly
CHAT_DECODERS = {"gpt2": GPT2Decoder, "llama": LlamaDecoder, "mistral": LlamaDecoder, "gemma": LlamaDecoder,
                 "gpt_neo": GPTNeoDecoder, "opt": OPTDecoder, "xglm": XGLMDecoder, "bloom": BloomDecoder,
                 "gptj": GPTJDecoder, "bart": BartDecoder, "deepseek_v2": DeepseekV2Decoder}


def import_transformers():
    """transformers with its PyTorch backend alone.

    transformers 4.x looks for TensorFlow and Flax when it is first imported
    and imports them where they are installed (and TensorFlow imports JAX);
    ``USE_TORCH=1`` and ``USE_FLAX=0`` switch both searches off for that first
    import.  The environment is restored after it.  Where transformers is
    already imported, it is returned as it is."""
    if "transformers" not in sys.modules:
        saved = {k: os.environ.get(k) for k in ("USE_TORCH", "USE_FLAX")}
        os.environ.update(USE_TORCH="1", USE_FLAX="0")
        try:
            import transformers  # noqa: F401,PLC0415
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    return sys.modules["transformers"]


def _device(device, who: str) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f'{who}: no CUDA device is available (pass device="cpu" to run on the CPU)')
    return device


def _load_wav_16k(wav_path: str) -> np.ndarray:
    """Read a wav file → mono float32 at Whisper's 16 kHz."""
    from emojivoice_tpu_torch.data.audio_np import load_wav, resample_poly_np

    data, sr = load_wav(wav_path)
    if data.ndim > 1:  # (T, C) → mono
        data = data.mean(axis=-1)
    if sr != WHISPER_SAMPLE_RATE:
        data = resample_poly_np(data, sr, WHISPER_SAMPLE_RATE)
    return np.asarray(data, dtype=np.float32)


class TorchWhisperASR:
    """Whisper speech-to-text on the card.

    The log-mel frontend runs on the host (a fixed 30 s window, so the
    features are always (1, 80, 3000)); the encoder runs once and the decoder
    greedily, one token a step over its cache, applying the generation
    config's ``suppress_tokens``, ``begin_suppress_tokens`` and
    ``forced_decoder_ids`` as the Flax ``generate`` does: through
    ``decode.WhisperDecoder``'s graphs by default, transformers' forward with
    ``graphs=False``.
    """

    needs_audio = True  # reads a recorded wav — the loop must supply one

    def __init__(
        self,
        model=None,
        feature_extractor=None,
        tokenizer=None,
        model_name: str = "openai/whisper-tiny.en",
        max_length: Optional[int] = None,
        device="cuda",
        local_files_only: bool = False,
        graphs: bool = True,
    ):
        self.device = _device(device, "TorchWhisperASR")
        transformers = import_transformers()
        if model is None:
            model = transformers.WhisperForConditionalGeneration.from_pretrained(
                model_name, local_files_only=local_files_only)
            processor = transformers.WhisperProcessor.from_pretrained(model_name, local_files_only=local_files_only)
            feature_extractor = feature_extractor or processor.feature_extractor
            tokenizer = tokenizer or processor.tokenizer
        if feature_extractor is None:
            feature_extractor = transformers.WhisperFeatureExtractor(feature_size=model.config.num_mel_bins)
        if tokenizer is None:
            raise ValueError("tokenizer required when injecting a model")
        self._model = model.to(self.device).eval()
        self._fe = feature_extractor
        self._tok = tokenizer
        self._max_length = int(max_length or min(model.config.max_target_positions, 128))
        gen = model.generation_config
        self._start = int(gen.decoder_start_token_id)
        self._eos = set(token_list(gen.eos_token_id))
        self._pad = token_list(gen.pad_token_id if gen.pad_token_id is not None else gen.eos_token_id)[0]
        # the generation config's rules after the start token, a prompt of one token (decode.ChatRules)
        self._rules = ChatRules(gen, model.get_output_embeddings().weight.shape[0], self._max_length - 1,
                                self.device)
        self.graphs = DecodeGraphs(self.device) if graphs else None
        self._dec = self._decoder() if graphs else None

    def _decoder(self) -> WhisperDecoder:
        return WhisperDecoder(self._model, self._max_length, self._start, self._rules)

    @torch.inference_mode()
    def _generate(self, feats: np.ndarray, logits_out: Optional[list] = None) -> np.ndarray:
        """Features (1, n_mels, 3000) → the (1, max_length) sequence: the start
        token, the greedy tokens up to and with eos, then pad (the Flax
        ``generate``'s ``sequences``).  With `logits_out`, each step's logits
        after the rules, (1, V) f32 on the device, are appended to it."""
        seq = np.full((1, self._max_length), self._pad, dtype=np.int64)
        seq[0, 0] = self._start
        feats = torch.from_numpy(np.asarray(feats, np.float32))
        if self.graphs is None:
            return self._generate_eager(feats.to(self.device), seq, logits_out)
        with self.graphs.lock:
            if self.graphs.watch(self._model):
                self._dec = self._decoder()
            dec = self._dec
            with obs.span("asr.encode"):
                dec.feats.copy_(feats)
                self.graphs.run(("encode",), dec.encode)
            for cur in range(1, self._max_length):
                with obs.span("asr.step"):
                    self.graphs.run(("decode", self._max_length), dec.step)
                    tok = self.graphs.read(dec.tok)
                if logits_out is not None:
                    logits_out.append(dec.logits.clone())
                seq[0, cur] = tok
                if tok in self._eos:
                    break
        return seq

    def _generate_eager(self, feats: torch.Tensor, seq: np.ndarray, logits_out: Optional[list]) -> np.ndarray:
        with obs.span("asr.encode"):
            enc = self._model.get_encoder()(feats)
        ids = torch.tensor([[self._start]], device=self.device)
        past = None
        for cur in range(1, self._max_length):
            with obs.span("asr.step"):
                out = self._model(encoder_outputs=enc, decoder_input_ids=ids, past_key_values=past, use_cache=True)
                logits = self._rules(out.logits[:, -1].float(), cur - 1, 1)
                tok = int(logits.argmax(-1))
            if logits_out is not None:
                logits_out.append(logits.clone())
            seq[0, cur] = tok
            if tok in self._eos:
                break
            ids, past = torch.tensor([[tok]], device=self.device), out.past_key_values
        return seq

    def _features(self, wav: np.ndarray, sample_rate: int) -> np.ndarray:
        """Audio → the log-mel features (1, n_mels, 3000), on the host."""
        from emojivoice_tpu_torch.data.audio_np import resample_poly_np

        wav = np.asarray(wav, dtype=np.float32)
        if wav.ndim > 1:
            wav = wav.mean(axis=-1)
        if sample_rate != WHISPER_SAMPLE_RATE:
            wav = resample_poly_np(wav, sample_rate, WHISPER_SAMPLE_RATE)
        return self._fe(wav, sampling_rate=WHISPER_SAMPLE_RATE, return_tensors="np").input_features

    def _text(self, feats: np.ndarray) -> str:
        seq = self._generate(feats)[0]
        return self._tok.decode(seq.tolist(), skip_special_tokens=True).strip()

    def transcribe_array(self, wav: np.ndarray, sample_rate: int) -> str:
        with obs.span("asr.features"):
            feats = self._features(wav, sample_rate)
        return self._text(feats)

    def transcribe(self, wav_path: str) -> str:
        with obs.span("asr.features"):
            feats = self._features(_load_wav_16k(wav_path), WHISPER_SAMPLE_RATE)
        return self._text(feats)


class TorchChatLM:
    """Causal-LM chat on the card: bucketed prompts, seeded sampling.

    Prompt tokens are left-padded to the smallest bucket that fits, as the
    JAX adapter does; each turn's sampling generator is seeded from the
    constructor's seed and the turn counter, so a conversation replays
    draw for draw from the same seed.  A model type of ``CHAT_DECODERS``
    decodes through its decoder's graphs by default (``decode="graphs"``):
    one prefill graph per prompt bucket and one decode graph over a cache of
    the largest bucket plus ``max_new_tokens`` slots.  Another type, and
    every model under ``graphs=False``, decodes through transformers'
    forward (``decode="eager"``).

    Both modes apply the generation config as ``FlaxChatLM``'s ``generate``
    does: ``min_length``, the forced bos / eos tokens, ``suppress_tokens``,
    ``begin_suppress_tokens`` and ``forced_decoder_ids`` at every step;
    ``top_k`` and ``top_p`` when sampling; a greedy beam search where
    ``num_beams`` > 1 (with ``length_penalty`` and ``early_stopping``; the
    graphs' keys ``("beam_prefill", bucket)`` and ``("beam_decode",)``, a
    cache of one row per beam); its ``max_new_tokens`` over the adapter's.
    ``no_repeat_ngram_size`` and ``num_beams`` > 1 with sampling, which
    ``FlaxChatLM`` cannot run, are refused by name when the adapter is made.
    """

    def __init__(
        self,
        model=None,
        tokenizer=None,
        model_name: str = "gpt2",
        temperature: float = 0.6,
        max_new_tokens: int = 64,
        seed: int = 0,
        prompt_buckets: Sequence[int] = (64, 128, 256, 512),
        device="cuda",
        graphs: bool = True,
    ):
        self.device = _device(device, "TorchChatLM")
        transformers = import_transformers()
        if model is None:
            model = transformers.AutoModelForCausalLM.from_pretrained(model_name)
            tokenizer = tokenizer or transformers.AutoTokenizer.from_pretrained(model_name)
        if tokenizer is None:
            raise ValueError("tokenizer required when injecting a model")
        self._model = model.to(self.device).eval()
        self._tok = tokenizer
        self.temperature = float(temperature)
        self.max_new_tokens = int(max_new_tokens)
        self.seed = int(seed)
        gen = model.generation_config
        # the Flax generate takes the generation config's max_new_tokens over the adapter's max_length
        if getattr(gen, "max_new_tokens", None) is not None:
            self.max_new_tokens = int(gen.max_new_tokens)
        # a bucket + its new tokens must fit the model's position table
        n_pos = getattr(model.config, "max_position_embeddings", None) or getattr(
            model.config, "n_positions", None
        )
        buckets = sorted(b for b in prompt_buckets
                         if n_pos is None or b + self.max_new_tokens <= n_pos)
        if not buckets:
            buckets = [int(n_pos) - self.max_new_tokens]
        self.prompt_buckets = tuple(buckets)
        self._turn = 0
        pad = getattr(tokenizer, "pad_token_id", None)
        if pad is None:
            pad = getattr(tokenizer, "eos_token_id", None)
        if pad is None:
            pad = int(model.config.pad_token_id or model.config.eos_token_id or 0)
        self._pad_id = int(pad)
        self._eos = set(token_list(model.config.eos_token_id))
        # the generation config's rules, warpers and beam search; what FlaxChatLM cannot run is refused here
        self._search = ChatSearch(gen, model.get_output_embeddings().weight.shape[0], self.max_new_tokens,
                                  self.device, sample=self.temperature > 0)
        self._rules = self._search.rules
        # a sequence ends at the generation config's eos, as the Flax generate's loop ends it (else the model's)
        self._stop = set(self._search.eos) or self._eos
        # what follows eos in a sequence (the Flax generate fills with the generation config's pad)
        self._fill = self._search.fill
        # a forward without position_ids (bart's decoder) counts the slots it is fed: it is fed no pads
        self._takes_positions = "position_ids" in inspect.signature(model.forward).parameters
        model_type = model.config.model_type
        self.decode = "graphs" if graphs and model_type in CHAT_DECODERS else "eager"
        if graphs and self.decode == "eager":
            print(f"[TorchChatLM] model_type {model_type!r} has no decode steps in the port: it decodes through "
                  f"transformers' forward on {self.device}, one token at a time", flush=True)
        self.graphs = DecodeGraphs(self.device) if self.decode == "graphs" else None
        self._dec = self._decoder() if self.graphs is not None else None
        self.steps = 0  # decode steps after a prefill, counted on the host

    def _decoder(self):
        return CHAT_DECODERS[self._model.config.model_type](self._model, self.prompt_buckets, self._search)

    def counters(self) -> tuple:
        """(the decoder's device counters, or None where it keeps none; the
        decode steps so far): no host read, so a caller may take a device
        copy between turns.  A mixture-of-experts decoder counts the pairs
        routed in prefills, the busiest expert's pairs and the experts hit
        (``decode.DeepseekV2Decoder``)."""
        return getattr(self._dec, "counters", None), self.steps

    def stats(self) -> dict:
        """The counters on the host, read on demand (a device read: never on
        a reply's path): the decode mode, the decode steps and, for a
        mixture-of-experts decoder, ``moe_pairs_sum``, ``moe_max_load_sum``
        and ``moe_experts_hit_sum``."""
        out = dict(decode=self.decode, steps=self.steps)
        if hasattr(self._dec, "moe_stats"):
            out.update(self._dec.moe_stats(self.steps))
        return out

    def last_logits(self) -> torch.Tensor:
        """The scores after the rules that the last token was chosen from,
        (rows, V) f32 on the device: the decoder's own buffer, which the next
        prefill or step overwrites (copy it to keep it).  The graphs mode
        only."""
        if self._dec is None:
            raise RuntimeError("TorchChatLM.last_logits: the eager mode keeps no scores")
        return self._dec.logits

    # -- prompt construction (the JAX adapter's, unchanged) -------------------

    def _prompt_ids(self, messages: List[dict]) -> List[int]:
        tmpl = getattr(self._tok, "chat_template", None)
        if tmpl:
            # templated tokenizers: let the template emit its own specials —
            # re-tokenizing the rendered string would duplicate BOS etc.
            return list(
                self._tok.apply_chat_template(messages, tokenize=True,
                                              add_generation_prompt=True)
            )
        text = "\n".join(f"{m['role']}: {m['content']}" for m in messages) + "\nassistant:"
        return list(self._tok(text)["input_ids"])

    def _fit_messages(self, messages: List[dict]) -> List[int]:
        """Token ids that fit the largest bucket, dropping the OLDEST history
        message first and never the system message — tail-truncation would
        silently cut the system instructions (the emoji rules in feel_me)
        exactly when the conversation gets long."""
        max_bucket = self.prompt_buckets[-1]
        messages = list(messages)
        ids = self._prompt_ids(messages)
        while len(ids) > max_bucket and len(messages) > 2:
            del messages[1]  # oldest non-system message
            ids = self._prompt_ids(messages)
        if len(ids) > max_bucket:
            # system + current turn alone overflow: keep the instruction head
            # and the current-user tail
            head = max_bucket // 2
            ids = ids[:head] + ids[-(max_bucket - head):]
        return ids

    def _encode(self, messages: List[dict]):
        ids = self._fit_messages(messages)
        bucket = next(b for b in self.prompt_buckets if b >= len(ids))
        n_pad = bucket - len(ids)
        padded = np.full((1, bucket), self._pad_id, dtype=np.int32)
        mask = np.zeros((1, bucket), dtype=np.int32)
        padded[0, n_pad:] = ids
        mask[0, n_pad:] = 1
        return padded, mask, bucket

    # -- generation ---------------------------------------------------------

    def _next_token(self, logits: torch.Tensor, u: Optional[torch.Tensor] = None,
                    temperature: Optional[torch.Tensor] = None) -> torch.Tensor:
        if u is None:
            return logits.argmax(-1, keepdim=True)
        return sample_top_k(logits, temperature, u, self._search.top_k, self._search.top_p)

    @torch.inference_mode()
    def _generate(self, ids: np.ndarray, mask: np.ndarray, generator: Optional[torch.Generator] = None,
                  logits_out: Optional[list] = None) -> np.ndarray:
        """Left-padded prompt (1, bucket) → the (1, bucket + max_new_tokens)
        sequence: the prompt, the new tokens up to and with eos, then the fill
        (the Flax ``generate``'s ``sequences``).  Greedy without a generator;
        with one, the turn's ``max_new_tokens`` uniforms are drawn from it at
        once, one a new token.  Where the generation config asks for beams
        (greedy only), Flax's beam search over that many rows, stopped where
        its condition stops it: the best sequence.  Positions count the
        prompt's real tokens from 0, as the Flax GPT-2 does; a pad's own
        position is never attended to.  With `logits_out`, each step's scores
        after the rules, (1, V) f32 (with beams (beams, V) log-probabilities)
        on the device, are appended to it.  Its spans carry the turn ``chat``
        counted for it (the prompt's copy in, before ``llm.prefill``, is in
        none of them)."""
        bucket, turn = ids.shape[1], self._turn - 1
        seq = np.full((1, bucket + self.max_new_tokens), self._fill, dtype=np.int64)
        seq[0, :bucket] = ids[0]
        sample, beams = generator is not None, self._search.beams > 1
        if sample and beams:
            raise ValueError(f"TorchChatLM: generation_config.num_beams={self._search.beams} is a greedy beam search; "
                             "beam sampling is not implemented (nor by FlaxChatLM)")
        ids_t, mask_t = torch.from_numpy(np.asarray(ids, np.int64)), torch.from_numpy(np.asarray(mask, np.int64))
        if self.graphs is None:
            return self._generate_eager(ids_t.to(self.device), mask_t.to(self.device), generator, seq, logits_out,
                                        turn)
        with self.graphs.lock:
            if self.graphs.watch(self._model):
                self._dec = self._decoder()
            dec = self._dec
            static_ids, static_mask = dec.inputs(bucket)
            static_ids.copy_(ids_t)
            static_mask.copy_(mask_t)
            if sample:
                torch.rand(self.max_new_tokens, generator=generator, device=self.device, out=dec.u)
                dec.temperature.fill_(self.temperature)
            for cur in range(bucket, seq.shape[1]):
                prefill = cur == bucket
                with obs.span("llm.prefill" if prefill else "llm.step", turn=turn):
                    with obs.span(None if prefill else "llm.replay", turn=turn):
                        if prefill:
                            key = ("beam_prefill", bucket) if beams else ("prefill", bucket, sample)
                            self.graphs.run(key, lambda: dec.prefill(bucket, sample))
                        else:
                            self.graphs.run(("beam_decode",) if beams else ("decode", sample), lambda: dec.step(sample))
                    if logits_out is not None:
                        logits_out.append(dec.logits.clone())
                    self.steps += not prefill
                    with obs.span(None if prefill else "llm.read", turn=turn):
                        # whether the beams are done, or the token
                        value = self.graphs.read(dec.beam["done"] if beams else dec.tok)
                if beams:
                    if value:
                        break
                    continue
                seq[0, cur] = value
                if seq[0, cur] in self._stop:
                    break
            if beams:
                seq[0, bucket:] = beam_result(dec.beam).cpu().numpy()
        return seq

    def _generate_eager(self, inp: torch.Tensor, attn: torch.Tensor, generator: Optional[torch.Generator],
                        seq: np.ndarray, logits_out: Optional[list], turn: Optional[int] = None) -> np.ndarray:
        """Transformers' forward over its growing cache, a token at a time.
        A forward that takes ``position_ids`` gets, at every call, a tensor
        of its own: the mask's count of real tokens from 0, for the tokens
        it is fed (XGLM's positional embedding adds its offset to that
        tensor in place).  A forward without them (BART's decoder) counts
        its positions from the first slot it is fed, pads included; under
        left pads that would shift every real token's position, so it is
        fed the prompt's real tokens alone, whose positions then count from
        0 as the Flax ``generate``'s do.  A beam search feeds the prompt as
        that many identical rows (Flax's expanded prompt) and reorders the
        cache by the chosen beams after each step."""
        bucket = inp.shape[1]
        search = self._search
        u = temperature = state = None
        if generator is not None:
            u = torch.rand(self.max_new_tokens, generator=generator, device=self.device)
            temperature = torch.full((), self.temperature, dtype=torch.float32, device=self.device)
        if not self._takes_positions:
            real = attn[0].bool()
            inp, attn = inp[:, real], attn[:, real]
        if search.beams > 1:
            inp, attn = inp.expand(search.beams, -1), attn.expand(search.beams, -1)
            state = beam_state(search, self.device)
            beam_reset(state, search)
        past = None
        for cur in range(bucket, seq.shape[1]):
            n = cur - bucket
            with obs.span("llm.prefill" if n == 0 else "llm.step", turn=turn):
                with obs.span(None if n == 0 else "llm.replay", turn=turn):
                    kw = {}
                    if self._takes_positions:
                        kw["position_ids"] = (attn.cumsum(-1) - 1).clamp(min=0)[:, -inp.shape[1]:]
                    out = self._model(input_ids=inp, attention_mask=attn, past_key_values=past, use_cache=True,
                                      **kw)
                    logits = out.logits[:, -1].float()
                    if state is None:
                        logits = self._rules(logits, n, bucket)
                        tok = self._next_token(logits, None if u is None else u[n: n + 1], temperature)
                    else:
                        logits = self._rules(torch.log_softmax(logits, dim=-1), n, bucket)
                        chosen = beam_step(state, search, logits, n)
                        tok = state["tok"].clone()
                with obs.span(None if n == 0 else "llm.read", turn=turn):
                    if state is None:
                        seq[0, cur] = int(tok)
                        done = seq[0, cur] in self._stop
                    else:
                        done = bool(state["done"])
            if logits_out is not None:
                logits_out.append(logits.clone())
            if done:
                break
            inp, past = tok, out.past_key_values
            if state is not None:
                past.reorder_cache(chosen)  # each row continues the beam it chose
            attn = torch.cat([attn, torch.ones_like(tok)], dim=1)
        if state is not None:
            seq[0, bucket:] = beam_result(state).cpu().numpy()
        return seq

    def chat(self, system_prompt: str, history: List[dict], user_msg: str) -> str:
        from emojivoice_tpu_torch.apps.adapters import build_messages

        turn = self._turn
        with obs.span("llm.prompt", turn=turn):
            ids, mask, bucket = self._encode(build_messages(system_prompt, history, user_msg))
            generator = step_generator(self.seed, turn, "chat", self.device) if self.temperature > 0 else None
        self._turn += 1
        new_ids = self._generate(ids, mask, generator)[0, bucket:].tolist()
        with obs.span("llm.detokenize", turn=turn):
            new_ids = new_ids[: next((i for i, t in enumerate(new_ids) if t in self._eos), len(new_ids))]
            return self._tok.decode(new_ids, skip_special_tokens=True).strip()
