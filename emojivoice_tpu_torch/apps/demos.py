"""Case-study demos: scripted playback, storytelling renderer, story game
(the JAX package's ``apps/demos.py`` on the PyTorch port: synthesis runs on
the card unless ``--cpu`` is given).

Equivalents of the reference's three case studies
(reference: case_studies/ — SURVEY.md §2.6):

* ``scripted``  — case_1: play pre-rendered wavs one per Enter press
  (demo_scripted.py:12-32); plus a ``render`` mode that generates those
  wavs from a script (the reference ships them pre-rendered only).
* ``story``     — case_2 / hri storytelling: per line, first mapped emoji
  picks the voice (default speaker 12), emoji/brackets stripped, synthesis
  to ``to_play-<i>.wav`` or direct playback
  (demo_story.ipynb; hri-demo/storytelling/demo_story_script.py:162-193).
* ``game``      — case3 story-building game: ASR→LLM→TTS loop with the male
  emoji mapping, rendered in the pygame window shell (typewriter reply bar,
  apps/game_ui.py) when pygame is importable, console fallback otherwise.
  The reference UI's `process_text` call is fork-broken
  (case3_game/main.py:203); the intended behavior is implemented.
"""

from __future__ import annotations

import argparse
import re
from pathlib import Path

from emojivoice_tpu_torch.apps import adapters as ad
from emojivoice_tpu_torch.apps.emoji import EMOJI_MAPPING, EMOJI_MAPPING_MALE, parse_emoji_response

STORY_DEFAULT_SPK = 12  # reference: demo_story_script.py default speaker

GAME_PROMPT = """
You are a robot playing a collaborative story building game.
- You and the human take turns, each adding exactly one sentence to the story.
- Keep sentences short, vivid and family friendly.
- End each sentence with exactly one of these emojis reflecting its emotion: 😎🤔😍🤣🙂😮🙄😅😭😡😁
- Never use any other emoji or symbols.
"""


def play_scripted(folder: str, n_files: int = 22):
    """case_1 playback: Enter → next wav (reference demo_scripted.py:20-32)."""
    sink = ad.default_audio_sink(".")
    from emojivoice_tpu_torch.data.audio_np import load_wav

    for i in range(1, n_files + 1):
        path = Path(folder) / f"{i}.wav"
        if not path.exists():
            print(f"missing {path}, stopping")
            break
        input(f"Press Enter to play: {path.name}")
        wav, sr = load_wav(str(path))
        sink.play(wav, sr)


def render_script(pipeline, script_path: str, out_dir: str, voice: str = "female",
                  steps: int = 10, speaking_rate: float = 0.8, language: str = "en"):
    """Render a dialog script: lines with emoji cues become emoji voices
    ("Byte:" lines in case_1's script.txt carry the cue)."""
    mapping = EMOJI_MAPPING if voice == "female" else EMOJI_MAPPING_MALE
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    lines = [l.strip() for l in Path(script_path).read_text().splitlines() if l.strip()]
    from emojivoice_tpu_torch.inference.cli import save_wav

    for i, line in enumerate(lines, start=1):
        line = re.sub(r"^\w+:\s*", "", line)  # strip speaker prefixes like "Byte:"
        spk, text = parse_emoji_response(line, mapping, default_spk=STORY_DEFAULT_SPK)
        text = text.strip('"')
        if not text:
            continue
        res = pipeline.synthesise([text], spks=[spk], n_timesteps=steps,
                                  length_scale=speaking_rate, language=language)[0]
        save_wav(str(out / f"{i}.wav"), res.wav)
        print(f"[{i}] spk={spk}  {text[:60]}")


def run_story(pipeline, script_path: str, out_dir: str = None, play: bool = True,
              voice: str = "female", steps: int = 10, speaking_rate: float = 0.8,
              language: str = "en"):
    """case_2 storytelling: one wav (to_play-<i>.wav) or playback per line."""
    mapping = EMOJI_MAPPING if voice == "female" else EMOJI_MAPPING_MALE
    sink = ad.default_audio_sink(out_dir or ".")
    from emojivoice_tpu_torch.inference.cli import save_wav

    lines = [l.strip() for l in Path(script_path).read_text().splitlines() if l.strip()]
    for i, line in enumerate(lines):
        spk, text = parse_emoji_response(line, mapping, default_spk=STORY_DEFAULT_SPK)
        text = text.replace("[", "").replace("]", "")
        if not text:
            continue
        res = pipeline.synthesise([text], spks=[spk], n_timesteps=steps,
                                  length_scale=speaking_rate, language=language)[0]
        if out_dir is not None:
            save_wav(str(Path(out_dir) / f"to_play-{i}.wav"), res.wav)
        if play:
            sink.play(res.wav, res.sample_rate)
        print(f"[{i}] spk={spk}  {text[:60]}")


def run_game(pipeline, turns: int = 0, voice: str = "male", steps: int = 10,
             speaking_rate: float = 0.8, language: str = "en", llm=None, asr=None, sink=None,
             ui=None, window: bool = True):
    """case3 story-building game loop.

    UI is the reference's pygame window (typewriter reply rendering,
    case3_game/main.py:271-401) when pygame is importable, else an
    interface-compatible console fallback — see apps/game_ui.py.
    """
    from emojivoice_tpu_torch.apps.feel_me import FeelMe
    from emojivoice_tpu_torch.apps.game_ui import make_ui

    app = FeelMe(
        pipeline,
        asr=asr or ad.ConsoleASR(),
        llm=llm or ad.default_llm(),
        sink=sink or ad.default_audio_sink("game_out"),
        voice=voice,
        steps=steps,
        speaking_rate=speaking_rate,
        language=language,
        prompt=GAME_PROMPT,
    )
    ui = ui or make_ui(window=window)
    print("Story building game — alternate sentences with the robot. 'end session' quits.")
    count = 0
    empty_streak = 0
    try:
        while (turns <= 0 or count < turns) and ui.pump():
            user_text = app.asr.transcribe("")
            if user_text and "end session" in user_text.lower():
                break
            if not user_text:
                # reference main.py:378-389: empty transcription → notice, retry
                ui.notice("I didn't hear anything, try recording again...")
                empty_streak += 1
                if empty_streak >= 3:
                    break  # dead input source — don't loop forever
                continue
            empty_streak = 0
            # reference sequencing (main.py:324-368): type the reply first,
            # then play the audio with the text still on screen; the bar
            # clears only after playback, before the next recording
            response, spk, spoken = app.respond(user_text)
            ui.typewriter(response)
            if not getattr(ui, "echoes_text", False):
                print(f"robot [{spk}]: {response}")
            app.speak(spoken, spk)
            count += 1
            ui.clear_text()
    finally:
        ui.close()
    return count


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="emojivoice-demos-torch")
    p.add_argument("mode", choices=["scripted", "render", "story", "game"])
    p.add_argument("--script", default=None)
    p.add_argument("--folder", default=None, help="pre-rendered audio folder (scripted mode)")
    p.add_argument("--out_dir", default="demo_out")
    p.add_argument("--voice", choices=["female", "male"], default="female")
    p.add_argument("--checkpoint_path", default=None)
    p.add_argument("--vocoder", default=None)
    p.add_argument("--random_init", action="store_true")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--speaking_rate", type=float, default=0.8)
    p.add_argument("--language", default="en")
    p.add_argument("--no_play", action="store_true")
    p.add_argument("--no_window", action="store_true",
                   help="game mode: skip the pygame window even if available")
    p.add_argument("--cpu", action="store_true", help="synthesise on the CPU instead of the CUDA device")
    args = p.parse_args(argv)

    if args.mode == "scripted":
        play_scripted(args.folder or "scripted_audio/emoji_fine_tuned")
        return 0

    from emojivoice_tpu_torch.inference.pipeline import SynthesisPipeline
    from emojivoice_tpu_torch.text.cleaners import LANGUAGE_CLEANERS

    device = "cpu" if args.cpu else "cuda"
    cleaners = (LANGUAGE_CLEANERS[args.language].__name__,)
    if args.random_init or not args.checkpoint_path:
        pipe = SynthesisPipeline.from_random(cleaners=cleaners, device=device)
    else:
        pipe = SynthesisPipeline.from_torch_checkpoints(args.checkpoint_path, args.vocoder,
                                                        cleaners=cleaners, device=device)
    if args.mode == "render":
        render_script(pipe, args.script, args.out_dir, args.voice, args.steps,
                      args.speaking_rate, args.language)
    elif args.mode == "story":
        run_story(pipe, args.script, args.out_dir, play=not args.no_play, voice=args.voice,
                  steps=args.steps, speaking_rate=args.speaking_rate, language=args.language)
    elif args.mode == "game":
        run_game(pipe, voice=args.voice, steps=args.steps,
                 speaking_rate=args.speaking_rate, language=args.language,
                 window=not args.no_window)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
