"""`emojivoice-tts-torch`: CLI synthesis on the PyTorch port, with the flags
of `emojivoice-tts` (``emojivoice_tpu.inference.cli``), themselves
flag-compatible with the reference's `matcha-tts` console script.

Runs on the card unless ``--cpu`` is given; without a CUDA device and
without ``--cpu`` it fails.

Modes:
  --text "..."            synthesize one utterance → wav/png/npy + RTF
  --file script.txt       one utterance per line; lines may be "text|spk"
  --batched               padded-batch synthesis (one call per batch)
  --play                  play audio after synthesis (needs sounddevice;
                          skipped with a warning where it is missing)
interactive mode (no --text/--file): prompt loop with per-line speaker
prompt, like the reference's play_only_synthesis.

The mel image (png) needs matplotlib and is skipped with a warning where
it is missing; the wav and the npy are always written.
"""

from __future__ import annotations

import argparse
import datetime as dt
import os
import sys
import warnings
from pathlib import Path

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="emojivoice-tts-torch",
        description="Emoji-conditioned Matcha-TTS synthesis (PyTorch/CUDA port); writes <name>.wav and "
                    "<name>.npy, and <name>.png where matplotlib is installed")
    p.add_argument("--checkpoint_path", type=str, default=None,
                   help="PyTorch .ckpt (reference format) or a checkpoint dir of emojivoice-train-torch "
                        "(<out_dir>/ckpts)")
    p.add_argument("--random_init", action="store_true",
                   help="run with random weights (smoke/demo without checkpoints)")
    p.add_argument("--vocoder", type=str, default=None, help="HiFi-GAN checkpoint path")
    p.add_argument("--text", type=str, default=None)
    p.add_argument("--file", type=str, default=None)
    p.add_argument("--language", type=str, default="en", choices=["en", "fr", "de", "es", "ja"])
    p.add_argument("--spk", type=int, default=None)
    p.add_argument("--temperature", type=float, default=0.667)
    p.add_argument("--speaking_rate", type=float, default=1.0)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--denoiser_strength", type=float, default=0.00025)
    p.add_argument("--output_folder", type=str, default=os.getcwd())
    p.add_argument("--batched", action="store_true")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--play", action="store_true",
                   help="play each utterance (needs sounddevice; skipped with a warning without it)")
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the CUDA device")
    p.add_argument("--seed", type=int, default=None)
    return p


def _load_pipeline(args):
    from emojivoice_tpu_torch.inference.pipeline import SynthesisPipeline
    from emojivoice_tpu_torch.text.cleaners import LANGUAGE_CLEANERS

    device = "cpu" if args.cpu else "cuda"
    cleaners = (LANGUAGE_CLEANERS[args.language].__name__,)
    if args.random_init or args.checkpoint_path is None:
        if not args.random_init:
            print("No --checkpoint_path given; using --random_init weights", file=sys.stderr)
        return SynthesisPipeline.from_random(cleaners=cleaners, device=device)
    # bare released-asset names resolve via the user cache dir (EMOJIVOICE_HOME)
    from emojivoice_tpu_torch.utils.assets import resolve_model

    ckpt = resolve_model(args.checkpoint_path, "checkpoint")
    vocoder = resolve_model(args.vocoder, "vocoder")
    if os.path.isdir(ckpt):  # checkpoint dir from emojivoice-train-torch
        return SynthesisPipeline.from_checkpoint(ckpt, vocoder, cleaners=cleaners, device=device)
    return SynthesisPipeline.from_torch_checkpoints(ckpt, vocoder, cleaners=cleaners, device=device)


def save_wav(path: str, wav: np.ndarray, sr: int = 22050):
    from scipy.io import wavfile

    wavfile.write(path, sr, np.clip(wav, -1.0, 1.0).astype(np.float32))


def save_png(path: str, mel: np.ndarray):
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as e:  # the image is optional, like audio out
        warnings.warn(f"matplotlib unavailable ({e}); skipping {path}")
        return

    fig, ax = plt.subplots(figsize=(12, 3))
    ax.imshow(mel.T, aspect="auto", origin="lower", interpolation="none")
    plt.colorbar(ax.images[0], ax=ax)
    plt.tight_layout()
    fig.savefig(path)
    plt.close(fig)


def _play(wav: np.ndarray, sr: int = 22050):
    try:
        import sounddevice as sd

        sd.play(wav, sr)
        sd.wait()
    except Exception as e:  # noqa: BLE001 — audio out is optional
        warnings.warn(f"audio playback unavailable ({e}); skipping --play")


def _save_result(res, out_dir: Path, name: str, play: bool):
    out_dir.mkdir(parents=True, exist_ok=True)
    save_wav(str(out_dir / f"{name}.wav"), res.wav)
    np.save(out_dir / f"{name}.npy", res.mel)
    save_png(str(out_dir / f"{name}.png"), res.mel)
    print(f"[emojivoice-tts-torch] {name}: {len(res.wav) / res.sample_rate:.2f}s  "
          f"RTF {res.rtf:.4f}  RTF+voc {res.rtf_w:.4f}  → {out_dir / name}.wav")
    if play:
        _play(res.wav, res.sample_rate)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    pipe = _load_pipeline(args)
    out_dir = Path(args.output_folder)
    spk = args.spk if args.spk is not None else 0
    kw = dict(
        n_timesteps=args.steps,
        temperature=args.temperature,
        length_scale=args.speaking_rate,
        denoiser_strength=args.denoiser_strength,
        language=args.language,
        seed=args.seed,
    )

    if args.text is not None:
        res = pipe.synthesise([args.text], spks=[spk], **kw)[0]
        _save_result(res, out_dir, f"utterance_{dt.datetime.now():%Y%m%d_%H%M%S}", args.play)
        return 0

    if args.file is not None:
        lines = [l.strip() for l in Path(args.file).read_text().splitlines() if l.strip()]
        texts, spks = [], []
        for line in lines:
            if "|" in line:
                t, s = line.rsplit("|", 1)
                texts.append(t)
                spks.append(int(s))
            else:
                texts.append(line)
                spks.append(spk)
        if args.batched:
            for i in range(0, len(texts), args.batch_size):
                chunk = slice(i, i + args.batch_size)
                for j, res in enumerate(pipe.synthesise(texts[chunk], spks=spks[chunk], **kw)):
                    _save_result(res, out_dir, f"utterance_{i + j:03d}", args.play)
        else:
            for i, (t, s) in enumerate(zip(texts, spks)):
                res = pipe.synthesise([t], spks=[s], **kw)[0]
                _save_result(res, out_dir, f"utterance_{i:03d}", args.play)
        return 0

    # interactive loop
    print("Interactive synthesis — empty line to exit")
    i = 0
    while True:
        try:
            text = input("text> ").strip()
        except EOFError:
            break
        if not text:
            break
        s = input(f"spk [{spk}]> ").strip()
        cur_spk = int(s) if s else spk
        res = pipe.synthesise([text], spks=[cur_spk], **kw)[0]
        _save_result(res, out_dir, f"interactive_{i:03d}", args.play)
        i += 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
