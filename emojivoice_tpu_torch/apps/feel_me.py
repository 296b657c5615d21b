"""`emojivoice-feel-me-torch` — the conversational agent loop on the
PyTorch port (the JAX package's ``apps/feel_me.py``, over the port's
pipeline, streaming and adapters).

Behavioral equivalent of the reference's /feel_me.py: push-to-talk ASR →
LLM with the emoji prompt → first-mapped-emoji voice selection → TTS →
audio out, with in-memory chat history.  Synthesis goes through the port's
SynthesisPipeline on the card (a per-utterance speaker switch is just a
different spk id into the same call); Whisper and the chat LM can run on the
same card (``--asr device``, ``--llm device``: apps/torch_adapters.py); every
external service is a pluggable adapter with a hermetic fallback, so the
loop runs end to end without a microphone, a model server or weights on
disk (console input + file audio sink + scripted LLM).  ``--cpu`` runs
synthesis and the device adapters on the CPU.

Defaults mirror the reference operating point: 10 ODE steps, temperature
0.667, speaking rate 0.8, denoiser 2.5e-4 (feel_me.py:71-77,185).

With the recorder of ``utils/observability.py`` enabled, a turn records
``feel_me.respond`` (the chat LM's reply, whose ``llm.*`` spans are its
children, then the emoji parse and the voice's choice) and one
``feel_me.segment`` a chunk handed to the sink (a spoken segment on the
pipelined path), with its index: the making of the chunk up to its hand
over, so the first one's end is the turn's first audio.  Take the spans
out and the module is the JAX package's, statement for statement
(``tests/test_torch_import.py``).
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from emojivoice_tpu_torch.apps import adapters as ad
from emojivoice_tpu_torch.apps.emoji import EMOJI_MAPPING, EMOJI_MAPPING_MALE, parse_emoji_response
from emojivoice_tpu_torch.utils import observability as obs

# Reference system prompt (feel_me.py:38-62) — instructs exactly one
# trailing emoji from the 11-voice set.
PROMPT = """
You are a robot designed to help humans

Interaction Guidelines:
- You are a robot who is playing a build a story game with a human. You will go back and forth each saying one sentence to build a story.
- Provide expressive responses with only the following emotions : 😎🤔😍🤣🙂😮🙄😅😭😡😁.
- Use short and simple responses to build the story.
- Answers should be limited to one sentence.

Emotions and Emojis:
- At the end of each response add one of these emojis: 😎🤔😍🤣🙂😮🙄😅😭😡😁 that reflects the emotion of the the entire response.
- Add only one emoji per response, at the end of the response.
- If the phrase is neutral do not include an emoji
- all other phrases must be chosen to reflect one of these emojis: 😎🤔😍🤣🙂😮🙄😅😭😡😁.
- Do not use any emojis other than these: 😎🤔😍🤣🙂😮🙄😅😭😡😁

Error Handling:
- Avoid giving medical, legal, political, or financial advice. Recommend the user consult a professional instead. You can still talk about historic figures.

Do not include in the response:
- do not add robot sounds
- do not use symbols such as () * % & - _
- do not use new lines
- do not add emojis other than: 😎🤔😍🤣🙂😮🙄😅😭😡😁
"""


class FeelMe:
    def __init__(
        self,
        pipeline,
        asr: Optional[ad.ASRAdapter] = None,
        llm: Optional[ad.LLMAdapter] = None,
        sink: Optional[ad.AudioSink] = None,
        recorder: Optional[ad.AudioRecorder] = None,
        record_path: str = "output.wav",
        voice: str = "female",
        steps: int = 10,
        temperature: float = 0.667,
        speaking_rate: float = 0.8,
        denoiser_strength: float = 0.00025,
        language: str = "en",
        prompt: str = PROMPT,
        pipelined: bool = True,
        segment_chars: int = 120,
    ):
        self.pipeline = pipeline
        self.asr = asr or ad.default_asr()
        self.llm = llm or ad.default_llm()
        self.sink = sink or ad.default_audio_sink()
        # a file-reading ASR (whisper flavors) needs a recorder in front of
        # it (reference records push-to-talk into output.wav, feel_me.py:280)
        self.recorder = recorder
        if recorder is None and getattr(self.asr, "needs_audio", False):
            self.recorder = ad.default_recorder()
            if self.recorder is None:
                raise RuntimeError(
                    "the chosen ASR transcribes recorded audio but no microphone "
                    "recorder is available (sounddevice absent); use a console ASR "
                    "or pass a recorder adapter"
                )
        self.record_path = record_path
        self.mapping = EMOJI_MAPPING if voice == "female" else EMOJI_MAPPING_MALE
        self.steps = steps
        self.temperature = temperature
        self.speaking_rate = speaking_rate
        self.denoiser_strength = denoiser_strength
        self.language = language
        self.prompt = prompt
        # sentence-level dispatch-ahead playback (see speak()); segment_chars
        # bounds a spoken segment — smaller = earlier first audio
        self.pipelined = pipelined
        self.segment_chars = segment_chars
        self.history: List[dict] = []

    def speak(self, text: str, spk: int):
        """Speak ``text`` as speaker ``spk``; blocks until playback is done.

        Returns the ``SynthesisResult`` when the reply was synthesized as a
        single call.  On the pipelined multi-sentence path the per-segment
        waveforms are played as they stream and never materialize as one
        result — that path deliberately returns ``None`` (callers that need
        the full waveform should use ``pipeline.synthesise`` directly or
        construct FeelMe with ``pipelined=False``).
        """
        kw = dict(
            n_timesteps=self.steps,
            temperature=self.temperature,
            length_scale=self.speaking_rate,
            denoiser_strength=self.denoiser_strength,
        )
        # TTFA-optimal conversational playback: multi-sentence replies go
        # pipelined (speak sentence i while sentence i+1 synthesizes), long
        # single sentences go chunked-vocoder, and short replies stay one
        # fused dispatch — never a strategy that measurably loses to `full`
        # at the reply's predicted length (inference/streaming.py
        # choose_strategy, docs/artifacts/ttfa.json).  The reference always
        # synthesizes the full reply before any sound (feel_me.py:189-203).
        if self.pipelined:
            from emojivoice_tpu_torch.inference.streaming import (
                auto_stream,
                choose_strategy,
            )

            chosen, _ = choose_strategy(text, self.segment_chars,
                                        self.speaking_rate)
            if chosen != "full":
                for chunk in obs.spanned(auto_stream(self.pipeline, text, spk=spk,
                                                     segment_chars=self.segment_chars,
                                                     language=self.language, **kw), "feel_me.segment"):
                    self.sink.play(chunk, 22050)
                return None
        with obs.span("feel_me.segment", segment=0):
            res = self.pipeline.synthesise(
                [text], spks=[spk], language=self.language, **kw)[0]
        self.sink.play(res.wav, res.sample_rate)
        return res

    def respond(self, user_text: str) -> tuple[str, int, str]:
        """LLM half of a turn: user text → (llm reply, speaker id, spoken
        text), no audio.  Lets UIs display the reply before/while speaking
        (the reference game types the text, then plays, main.py:324-368)."""
        with obs.span("feel_me.respond"):
            response = self.llm.chat(self.prompt, self.history, user_text)
            self.history.append({"role": "user", "content": user_text})
            self.history.append({"role": "assistant", "content": response})
            spk, text = parse_emoji_response(response, self.mapping)
            spoken = text if text else "nice"  # reference: feel_me.py:315-317
        return response, spk, spoken

    def turn(self, user_text: str) -> tuple[str, int, str]:
        """One dialogue turn: user text → (llm reply, speaker id, spoken text)."""
        response, spk, spoken = self.respond(user_text)
        self.speak(spoken, spk)
        return response, spk, spoken

    def run(self):
        print("feel-me loop — say/type 'end session' to stop")
        while True:
            if self.recorder is not None:
                input("Press Enter when you're ready to record 🎙️ ")
                if not self.recorder.record(self.record_path):
                    print("I didn't hear anything, try again...")
                    continue
            user_text = self.asr.transcribe(self.record_path)
            if not user_text:
                print("I didn't hear anything, try again...")
                continue
            print(f"speaker said: {user_text}")
            if "end session" in user_text.lower():
                return
            response, spk, spoken = self.turn(user_text)
            print(f"[{spk}] {response}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="emojivoice-feel-me-torch")
    p.add_argument("--checkpoint_path", default=None)
    p.add_argument("--vocoder", default=None)
    p.add_argument("--random_init", action="store_true")
    p.add_argument("--voice", choices=["female", "male"], default="female")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--speaking_rate", type=float, default=0.8)
    p.add_argument("--language", default="en")
    p.add_argument("--out_dir", default="feel_me_out", help="audio sink dir when no sound device")
    p.add_argument("--asr", choices=["auto", "device", "torch", "console"], default="auto",
                   help="device = the port's Whisper on the card (the CPU with --cpu); torch = HF pipeline")
    p.add_argument("--asr_model", default="openai/whisper-tiny.en")
    p.add_argument("--llm", choices=["auto", "ollama", "device", "transformers", "scripted"],
                   default="auto", help="device = the port's causal LM on the card (the CPU with --cpu)")
    p.add_argument("--llm_model", default=None,
                   help="model name for the chosen --llm backend (default: backend-specific)")
    p.add_argument("--no_pipelined", action="store_true",
                   help="disable sentence-level dispatch-ahead playback "
                        "(speak sentence i while i+1 synthesizes; on by "
                        "default — first audio after ONE sentence's synthesis)")
    p.add_argument("--segment_chars", type=int, default=120,
                   help="max characters per spoken segment under pipelining")
    p.add_argument("--cpu", action="store_true",
                   help="run synthesis and the device adapters on the CPU instead of the CUDA device")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from emojivoice_tpu_torch.inference.pipeline import SynthesisPipeline
    from emojivoice_tpu_torch.text.cleaners import LANGUAGE_CLEANERS

    device = "cpu" if args.cpu else "cuda"
    cleaners = (LANGUAGE_CLEANERS[args.language].__name__,)
    if args.random_init or not args.checkpoint_path:
        pipe = SynthesisPipeline.from_random(cleaners=cleaners, device=device)
    else:
        pipe = SynthesisPipeline.from_torch_checkpoints(args.checkpoint_path, args.vocoder,
                                                        cleaners=cleaners, device=device)
    asr = None
    if args.asr == "device":
        from emojivoice_tpu_torch.apps.torch_adapters import TorchWhisperASR
        asr = TorchWhisperASR(model_name=args.asr_model, device=device)
    elif args.asr == "torch":
        asr = ad.WhisperASR(model_name=args.asr_model)
    elif args.asr == "console":
        asr = ad.ConsoleASR()
    else:
        # auto: whichever backend resolves, the port's Whisper on this device first
        asr = ad.default_asr(model_name=args.asr_model, device=device)
    llm = None
    if args.llm == "ollama":
        llm = ad.OllamaLLM(model=args.llm_model or "llama3.2:1b")
    elif args.llm == "device":
        from emojivoice_tpu_torch.apps.torch_adapters import TorchChatLM
        llm = TorchChatLM(model_name=args.llm_model or "gpt2", device=device)
    elif args.llm == "transformers":
        llm = ad.TransformersLLM(model_name=args.llm_model or "gpt2")
    elif args.llm == "scripted":
        llm = ad.ScriptedLLM()
    elif args.llm_model:  # auto — still honor --llm_model in the Ollama probe
        llm = ad.default_llm(model=args.llm_model)
    app = FeelMe(pipe, asr=asr, llm=llm, voice=args.voice, steps=args.steps,
                 speaking_rate=args.speaking_rate, language=args.language,
                 sink=ad.default_audio_sink(args.out_dir),
                 pipelined=not args.no_pipelined, segment_chars=args.segment_chars)
    app.run()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
