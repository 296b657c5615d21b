"""Pluggable host-side adapters for the conversational stack (the port's
own copy of the JAX package's ``apps/adapters.py``; ``default_asr`` tries
the port's ``TorchWhisperASR`` on the card first).

The reference hard-wires Whisper (in-process), Ollama over HTTP (separate
server), and sounddevice audio I/O (reference: /feel_me.py:213-268).  These
are process/OS boundaries that must stay outside the compiled graph, so
they are adapters here, each with a hermetic fallback:

  ASR:   TorchWhisperASR (apps/torch_adapters.py, on the card) |
         WhisperASR (transformers pipeline, gated) | ConsoleASR (type instead)
  LLM:   OllamaLLM (HTTP, gated) | TransformersLLM (gated) | ScriptedLLM
  Audio: SounddeviceSink/Recorder (gated) | FileSink / file playback
"""

from __future__ import annotations

import json
import urllib.request
from pathlib import Path
from typing import List, Optional, Protocol, Sequence


class ASRAdapter(Protocol):
    def transcribe(self, wav_path: str) -> str: ...


class LLMAdapter(Protocol):
    def chat(self, system_prompt: str, history: List[dict], user_msg: str) -> str: ...


class AudioSink(Protocol):
    def play(self, wav, sample_rate: int) -> None: ...


class AudioRecorder(Protocol):
    def record(self, wav_path: str) -> bool: ...


def build_messages(system_prompt: str, history: List[dict], user_msg: str) -> List[dict]:
    """The chat-message shape every LLM backend consumes (reference:
    feel_me.py get_chat_prompt_template + RunnableWithMessageHistory)."""
    return [{"role": "system", "content": system_prompt}] + list(history) + [
        {"role": "user", "content": user_msg}
    ]


# ---------------------------------------------------------------------- ASR

class WhisperASR:
    """OpenAI Whisper via transformers (reference uses openai-whisper
    'tiny.en', feel_me.py:268).  Needs model weights locally;
    ``local_files_only`` keeps every load off the network."""

    needs_audio = True  # reads a recorded wav — the loop must supply one

    def __init__(self, model_name: str = "openai/whisper-tiny.en", local_files_only: bool = False):
        from emojivoice_tpu_torch.apps.torch_adapters import import_transformers  # noqa: PLC0415

        transformers = import_transformers()
        processor = transformers.WhisperProcessor.from_pretrained(model_name, local_files_only=local_files_only)
        model = transformers.WhisperForConditionalGeneration.from_pretrained(
            model_name, local_files_only=local_files_only)
        self._pipe = transformers.pipeline("automatic-speech-recognition", model=model,
                                           tokenizer=processor.tokenizer,
                                           feature_extractor=processor.feature_extractor)

    def transcribe(self, wav_path: str) -> str:
        return self._pipe(wav_path)["text"].strip()


class ConsoleASR:
    """Hermetic fallback: prompt on stdin instead of the microphone."""

    needs_audio = False

    def transcribe(self, wav_path: str = "") -> str:  # noqa: ARG002
        return input("you> ").strip()


# ---------------------------------------------------------------------- LLM

class OllamaLLM:
    """Ollama /api/chat over HTTP (reference: ChatOllama 'llama3.2:1b',
    temp 0.6, feel_me.py:115-119) — process boundary, kept out of graph."""

    def __init__(self, model: str = "llama3.2:1b", temperature: float = 0.6,
                 host: str = "http://localhost:11434", timeout: float = 60.0):
        self.model = model
        self.temperature = temperature
        self.host = host
        self.timeout = timeout

    def chat(self, system_prompt: str, history: List[dict], user_msg: str) -> str:
        messages = build_messages(system_prompt, history, user_msg)
        req = urllib.request.Request(
            f"{self.host}/api/chat",
            data=json.dumps({
                "model": self.model,
                "messages": messages,
                "stream": False,
                "options": {"temperature": self.temperature},
            }).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            return json.loads(resp.read())["message"]["content"]


class TransformersLLM:
    """Local HF causal LM chat (needs weights on disk)."""

    def __init__(self, model_name: str, temperature: float = 0.6, max_new_tokens: int = 64):
        from emojivoice_tpu_torch.apps.torch_adapters import import_transformers  # noqa: PLC0415

        hf_pipeline = import_transformers().pipeline

        self._pipe = hf_pipeline("text-generation", model=model_name)
        self.temperature = temperature
        self.max_new_tokens = max_new_tokens

    def chat(self, system_prompt: str, history: List[dict], user_msg: str) -> str:
        messages = build_messages(system_prompt, history, user_msg)
        out = self._pipe(messages, max_new_tokens=self.max_new_tokens,
                         do_sample=self.temperature > 0, temperature=self.temperature)
        return out[0]["generated_text"][-1]["content"]


class ScriptedLLM:
    """Hermetic fallback: cycles canned emoji-tagged replies (tests/demos)."""

    def __init__(self, replies: Optional[Sequence[str]] = None):
        self.replies = list(replies or [
            "Once upon a time a little robot woke up. 🙂",
            "It rolled outside and saw the sun for the first time! 😮",
            "The warmth made all its circuits tingle with joy. 😍",
            "Then it tripped over a pebble and landed in the mud. 🤣",
        ])
        self._i = 0

    def chat(self, system_prompt: str, history: List[dict], user_msg: str) -> str:  # noqa: ARG002
        reply = self.replies[self._i % len(self.replies)]
        self._i += 1
        return reply


# -------------------------------------------------------------------- audio

class SounddeviceSink:
    def __init__(self):
        import sounddevice  # noqa: PLC0415,F401

        self._sd = sounddevice

    def play(self, wav, sample_rate: int) -> None:
        self._sd.play(wav, sample_rate)
        self._sd.wait()


class FileSink:
    """Write each utterance to a wav file (the hri-demo Pepper variants do
    exactly this, reference: hri-demo/storybuilding/feel_me_demo.py:217-240)."""

    def __init__(self, out_dir: str = ".", pattern: str = "output{i}.wav", clip: bool = True):
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.pattern = pattern
        self.clip = clip
        self.count = 0
        self.last_path: Optional[Path] = None

    def play(self, wav, sample_rate: int) -> None:
        import numpy as np
        from scipy.io import wavfile

        path = self.out_dir / self.pattern.format(i=self.count)
        data = np.clip(np.asarray(wav), -1.0, 1.0).astype(np.float32)
        wavfile.write(path, sample_rate, data)
        self.last_path = path
        self.count += 1


class SounddeviceRecorder:
    """Push-to-talk microphone capture (reference Recorder,
    feel_me.py:213-251): stream frames until the user presses Enter, write
    an int16 wav.  The reference stops on a pynput key press; stdin Enter
    avoids that extra dependency with the same interaction."""

    def __init__(self, sample_rate: int = 44100):
        import sounddevice  # noqa: PLC0415,F401

        self._sd = sounddevice
        self.sample_rate = sample_rate

    def record(self, wav_path: str) -> bool:
        import numpy as np
        from scipy.io import wavfile

        frames = []

        def _cb(indata, n_frames, t, status):  # noqa: ARG001
            frames.append(indata.copy())

        stream = self._sd.InputStream(callback=_cb, channels=1, samplerate=self.sample_rate)
        stream.start()
        input("Recording... press Enter to stop.")
        stream.stop()
        stream.close()
        if not frames:
            return False
        audio = np.concatenate(frames, axis=0)
        audio = np.clip(audio * 32767, -32768, 32767).astype(np.int16)
        wavfile.write(wav_path, self.sample_rate, audio)
        return True


def default_recorder() -> Optional[AudioRecorder]:
    try:
        return SounddeviceRecorder()
    except Exception:  # noqa: BLE001 — no sound device in this environment
        return None


def default_audio_sink(out_dir: str = ".") -> AudioSink:
    try:
        return SounddeviceSink()
    except Exception:  # noqa: BLE001
        return FileSink(out_dir)


def on_disk(model_name: str) -> bool:
    """A local folder, or a hub name whose config is in the local cache
    (looked up without the network)."""
    if Path(model_name).is_dir():
        return True
    try:
        from huggingface_hub import try_to_load_from_cache  # noqa: PLC0415
    except ImportError:
        return False
    return isinstance(try_to_load_from_cache(model_name, "config.json"), str)


def default_asr(model_name: str = "openai/whisper-tiny.en", device="cuda") -> ASRAdapter:
    """The first adapter that builds from files on disk: the port's Whisper
    on `device` (same device as synthesis), then transformers' pipeline, then
    the console.  Nothing is fetched: every load is ``local_files_only``.
    (The JAX package sets ``HF_HUB_OFFLINE`` here, which huggingface_hub
    reads only when it is first imported: in a process that imported it
    before, that version asks the hub, with retries.)"""
    if on_disk(model_name):
        from emojivoice_tpu_torch.apps.torch_adapters import TorchWhisperASR  # noqa: PLC0415

        for make in (lambda: TorchWhisperASR(model_name=model_name, device=device, local_files_only=True),
                     lambda: WhisperASR(model_name=model_name, local_files_only=True)):
            try:
                return make()
            except Exception:  # noqa: BLE001 — weights, packages or the device missing
                pass
    return ConsoleASR()


def default_llm(model: str = "llama3.2:1b") -> LLMAdapter:
    try:
        llm = OllamaLLM(model=model)
        llm.chat("ping", [], "ping")  # reachability probe
        return llm
    except Exception:  # noqa: BLE001
        return ScriptedLLM()
