"""The conversational stack's ASR and LLM on the card: the port's
counterparts of the JAX package's ``apps/flax_adapters.py``.

The reference's feel_me agent chains torch Whisper (feel_me.py:29,268) and an
Ollama server (feel_me.py:115-119) around the TTS.  Here both run on the same
device as synthesis, on transformers' PyTorch model classes:

  TorchWhisperASR — Whisper's encoder once, then a greedy decode loop over
                    the decoder's key/value cache; the features are fixed at
                    (1, 80, 3000), as the JAX adapter has them.
  TorchChatLM     — causal-LM chat (the GPT-2 family) with the JAX adapter's
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
same distribution (temperature, then the 50 most likely tokens) by inverse
CDF from the turn's uniforms, drawn at once before its first token
(``decode.sample_top_k``), in both modes alike.

Both take either a pretrained name or an injected (model, tokenizer); tests
drive them with tiny random-init configs and stub tokenizers.  Each runs on
the card unless ``device="cpu"`` is given.
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional, Sequence

import numpy as np
import torch

from emojivoice_tpu_torch.apps.decode import DecodeGraphs, GPT2Decoder, WhisperDecoder, sample_top_k
from emojivoice_tpu_torch.utils.prng import step_generator

WHISPER_SAMPLE_RATE = 16_000


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


def _token_list(ids) -> list:
    return [] if ids is None else [int(i) for i in ([ids] if isinstance(ids, int) else ids)]


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
        self._eos = set(_token_list(gen.eos_token_id))
        self._pad = _token_list(gen.pad_token_id if gen.pad_token_id is not None else gen.eos_token_id)[0]
        self._suppress = _token_list(getattr(gen, "suppress_tokens", None))
        self._begin_suppress = _token_list(getattr(gen, "begin_suppress_tokens", None))
        forced = getattr(gen, "forced_decoder_ids", None) or []
        self._forced = {int(i): int(t) for i, t in forced}
        # the first free step: after the start token and the last forced one
        self._begin_index = 1 + (int(forced[-1][0]) if forced else 0)
        self.graphs = DecodeGraphs(self.device) if graphs else None
        self._dec = self._decoder() if graphs else None

    def _decoder(self) -> WhisperDecoder:
        return WhisperDecoder(self._model, self._max_length, self._start, self._suppress, self._begin_suppress,
                              self._begin_index, self._forced)

    def _logits(self, logits: torch.Tensor, cur: int) -> torch.Tensor:
        """The Flax processors' order: suppress, suppress at begin, force."""
        if self._suppress:
            logits[:, self._suppress] = -float("inf")
        if self._begin_suppress and cur == self._begin_index:
            logits[:, self._begin_suppress] = -float("inf")
        if cur in self._forced:
            logits.fill_(-float("inf"))
            logits[:, self._forced[cur]] = 0.0
        return logits

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
            dec.feats.copy_(feats)
            self.graphs.run(("encode",), dec.encode)
            for cur in range(1, self._max_length):
                self.graphs.run(("decode", self._max_length), dec.step)
                tok = self.graphs.read(dec.tok)
                if logits_out is not None:
                    logits_out.append(dec.logits.clone())
                seq[0, cur] = tok
                if tok in self._eos:
                    break
        return seq

    def _generate_eager(self, feats: torch.Tensor, seq: np.ndarray, logits_out: Optional[list]) -> np.ndarray:
        enc = self._model.get_encoder()(feats)
        ids = torch.tensor([[self._start]], device=self.device)
        past = None
        for cur in range(1, self._max_length):
            out = self._model(encoder_outputs=enc, decoder_input_ids=ids, past_key_values=past, use_cache=True)
            logits = self._logits(out.logits[:, -1].float(), cur)
            if logits_out is not None:
                logits_out.append(logits.clone())
            tok = int(logits.argmax(-1))
            seq[0, cur] = tok
            if tok in self._eos:
                break
            ids, past = torch.tensor([[tok]], device=self.device), out.past_key_values
        return seq

    def transcribe_array(self, wav: np.ndarray, sample_rate: int) -> str:
        from emojivoice_tpu_torch.data.audio_np import resample_poly_np

        wav = np.asarray(wav, dtype=np.float32)
        if wav.ndim > 1:
            wav = wav.mean(axis=-1)
        if sample_rate != WHISPER_SAMPLE_RATE:
            wav = resample_poly_np(wav, sample_rate, WHISPER_SAMPLE_RATE)
        feats = self._fe(wav, sampling_rate=WHISPER_SAMPLE_RATE, return_tensors="np").input_features
        seq = self._generate(feats)[0]
        return self._tok.decode(seq.tolist(), skip_special_tokens=True).strip()

    def transcribe(self, wav_path: str) -> str:
        return self.transcribe_array(_load_wav_16k(wav_path), WHISPER_SAMPLE_RATE)


class TorchChatLM:
    """Causal-LM chat on the card: bucketed prompts, seeded sampling.

    Prompt tokens are left-padded to the smallest bucket that fits, as the
    JAX adapter does; each turn's sampling generator is seeded from the
    constructor's seed and the turn counter, so a conversation replays
    draw for draw from the same seed.  GPT-2 models decode through
    ``decode.GPT2Decoder``'s graphs by default: one prefill graph per prompt
    bucket and one decode graph over a cache of the largest bucket plus
    ``max_new_tokens`` slots; another causal LM needs ``graphs=False``.
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
        gen = model.generation_config
        self._eos = set(_token_list(model.config.eos_token_id))
        # what follows eos in a sequence (the Flax generate fills with the generation config's pad)
        self._fill = _token_list(gen.pad_token_id if gen.pad_token_id is not None else gen.eos_token_id)[0]
        self.graphs = DecodeGraphs(self.device) if graphs else None
        self._dec = self._decoder() if graphs else None

    def _decoder(self) -> GPT2Decoder:
        return GPT2Decoder(self._model, self.prompt_buckets, self.max_new_tokens)

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
        return sample_top_k(logits, temperature, u)

    @torch.inference_mode()
    def _generate(self, ids: np.ndarray, mask: np.ndarray, generator: Optional[torch.Generator] = None,
                  logits_out: Optional[list] = None) -> np.ndarray:
        """Left-padded prompt (1, bucket) → the (1, bucket + max_new_tokens)
        sequence: the prompt, the new tokens up to and with eos, then the fill
        (the Flax ``generate``'s ``sequences``).  Greedy without a generator;
        with one, the turn's ``max_new_tokens`` uniforms are drawn from it at
        once, one a new token.  Positions count the prompt's real tokens from
        0, as the Flax GPT-2 does; a pad's own position is never attended to.
        With `logits_out`, each step's logits, (1, V) f32 on the device, are
        appended to it."""
        bucket = ids.shape[1]
        seq = np.full((1, bucket + self.max_new_tokens), self._fill, dtype=np.int64)
        seq[0, :bucket] = ids[0]
        ids_t, mask_t = torch.from_numpy(np.asarray(ids, np.int64)), torch.from_numpy(np.asarray(mask, np.int64))
        if self.graphs is None:
            return self._generate_eager(ids_t.to(self.device), mask_t.to(self.device), generator, seq, logits_out)
        sample = generator is not None
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
                if cur == bucket:
                    self.graphs.run(("prefill", bucket, sample), lambda: dec.prefill(bucket, sample))
                else:
                    self.graphs.run(("decode", sample), lambda: dec.step(sample))
                seq[0, cur] = self.graphs.read(dec.tok)
                if logits_out is not None:
                    logits_out.append(dec.logits.clone())
                if seq[0, cur] in self._eos:
                    break
        return seq

    def _generate_eager(self, inp: torch.Tensor, attn: torch.Tensor, generator: Optional[torch.Generator],
                        seq: np.ndarray, logits_out: Optional[list]) -> np.ndarray:
        bucket = inp.shape[1]
        u = temperature = None
        if generator is not None:
            u = torch.rand(self.max_new_tokens, generator=generator, device=self.device)
            temperature = torch.full((), self.temperature, dtype=torch.float32, device=self.device)
        pos = (attn.cumsum(-1) - 1).clamp(min=0)
        past = None
        for cur in range(bucket, seq.shape[1]):
            out = self._model(input_ids=inp, attention_mask=attn, position_ids=pos, past_key_values=past,
                              use_cache=True)
            logits = out.logits[:, -1].float()
            if logits_out is not None:
                logits_out.append(logits.clone())
            tok = self._next_token(logits, None if u is None else u[cur - bucket: cur - bucket + 1], temperature)
            seq[0, cur] = int(tok)
            if seq[0, cur] in self._eos:
                break
            inp, past = tok, out.past_key_values
            attn = torch.cat([attn, torch.ones_like(tok)], dim=1)
            pos = pos[:, -1:] + 1
        return seq

    def chat(self, system_prompt: str, history: List[dict], user_msg: str) -> str:
        from emojivoice_tpu_torch.apps.adapters import build_messages

        ids, mask, bucket = self._encode(build_messages(system_prompt, history, user_msg))
        generator = step_generator(self.seed, self._turn, "chat", self.device) if self.temperature > 0 else None
        self._turn += 1
        new_ids = self._generate(ids, mask, generator)[0, bucket:].tolist()
        new_ids = new_ids[: next((i for i, t in enumerate(new_ids) if t in self._eos), len(new_ids))]
        return self._tok.decode(new_ids, skip_special_tokens=True).strip()
