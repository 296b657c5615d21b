"""`emojivoice-record-audio-torch` — fine-tune data recorder (the port's own
copy of the JAX package's ``apps/record_audio.py``).

Behavioral equivalent of the reference recorder
(reference: Matcha-TTS/record_audio.py:9-97): map the 11 emotion names to
emojis, prompt for speaker/emotion/start line, read
``script-<emotion>.txt``, record each sentence push-to-talk into
``recordings/<emotion>/<speaker>-<emotion>-<i>.wav`` (44.1 kHz int16).

Additions the reference leaves manual (README:156 requires 22.05 kHz for
fine-tuning): ``--resample`` converts a recordings tree to 22 050 Hz, and
``--make-filelist`` emits the ``path|spk|text`` filelist for
emojivoice-train.  Recording needs a sound device; the conversion tools are
hermetic.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

# reference: record_audio.py:9-21
EMOTION_EMOJIS = {
    "love": "😍",
    "anger": "😡",
    "confident": "😎",
    "sadness": "😭",
    "sarcastic": "🙄",
    "excited": "😁",
    "neutral": "🙂",
    "laughing": "🤣",
    "surprised": "😮",
    "awkward": "😅",
    "thinking": "🤔",
}

RECORD_SR = 44100


def record_session(speaker: str, emotion: str, start_line: int, script_dir: Path, out_dir: Path):
    import sounddevice as sd
    from scipy.io import wavfile

    script = (script_dir / f"script-{emotion}.txt").read_text().splitlines()
    script = [l.strip() for l in script if l.strip()]
    emo_dir = out_dir / emotion
    emo_dir.mkdir(parents=True, exist_ok=True)

    for i, line in enumerate(script[start_line:], start=start_line):
        print(f"\n[{i}] {EMOTION_EMOJIS.get(emotion, '')} {line}")
        input("Press Enter to START recording...")
        frames = []
        stream = sd.InputStream(samplerate=RECORD_SR, channels=1, dtype="int16",
                                callback=lambda d, f, t, s: frames.append(d.copy()))
        with stream:
            input("Recording — press Enter to STOP...")
        data = np.concatenate(frames)[:, 0]
        path = emo_dir / f"{speaker}-{emotion}-{i}.wav"
        wavfile.write(path, RECORD_SR, data)
        print(f"saved {path} ({len(data) / RECORD_SR:.1f}s)")


def resample_tree(root: Path, target_sr: int = 22050):
    from scipy.io import wavfile

    from emojivoice_tpu_torch.data.audio_np import load_wav, resample_poly_np

    converted = 0
    for wav in sorted(root.rglob("*.wav")):
        data, sr = load_wav(str(wav))
        if sr == target_sr:
            continue
        out = resample_poly_np(data, sr, target_sr)
        wavfile.write(wav, target_sr, np.clip(out, -1, 1).astype(np.float32))
        converted += 1
    print(f"resampled {converted} files to {target_sr} Hz")


def make_filelist(root: Path, script_dir: Path, speaker_map: dict, out_path: Path):
    """Emit `path|spk|text` rows pairing recordings with their script lines.

    speaker_map: emotion name → speaker id (e.g. the emoji voice ids).
    """
    rows = []
    for emotion, spk in speaker_map.items():
        script = (script_dir / f"script-{emotion}.txt").read_text().splitlines()
        script = [l.strip() for l in script if l.strip()]
        for wav in sorted((root / emotion).glob("*.wav")):
            idx = int(wav.stem.rsplit("-", 1)[1])
            if idx < len(script):
                rows.append(f"{wav.resolve()}|{spk}|{script[idx]}")
    out_path.write_text("\n".join(rows) + "\n")
    print(f"wrote {len(rows)} entries to {out_path}")
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="emojivoice-record-audio-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    rec = sub.add_parser("record")
    rec.add_argument("--speaker", required=True)
    rec.add_argument("--emotion", required=True, choices=sorted(EMOTION_EMOJIS))
    rec.add_argument("--start_line", type=int, default=0)
    rec.add_argument("--script_dir", default="scripts")
    rec.add_argument("--out_dir", default="recordings")

    rs = sub.add_parser("resample")
    rs.add_argument("--dir", required=True)
    rs.add_argument("--sr", type=int, default=22050)

    fl = sub.add_parser("make-filelist")
    fl.add_argument("--dir", required=True)
    fl.add_argument("--script_dir", default="scripts")
    fl.add_argument("--output", default="train.txt")
    fl.add_argument("--voice", choices=["female", "male"], default="female")

    du = sub.add_parser("durations", help="total recorded audio per emotion "
                        "(the reference's get_duration.ipynb check; ~2 min/emoji target)")
    du.add_argument("--dir", required=True)

    args = p.parse_args(argv)
    if args.cmd == "durations":
        from emojivoice_tpu_torch.data.audio_np import load_wav

        root = Path(args.dir)
        for emo_dir in sorted(d for d in root.iterdir() if d.is_dir()):
            total = 0.0
            for wav in emo_dir.glob("*.wav"):
                data, sr = load_wav(str(wav))
                total += len(data) / sr
            flag = "✓" if total >= 120 else "⚠ below 2 min"
            print(f"{emo_dir.name:12s} {total:7.1f}s  {flag}")
        return 0
    if args.cmd == "record":
        record_session(args.speaker, args.emotion, args.start_line,
                       Path(args.script_dir), Path(args.out_dir))
    elif args.cmd == "resample":
        resample_tree(Path(args.dir), args.sr)
    elif args.cmd == "make-filelist":
        from emojivoice_tpu_torch.apps.emoji import EMOJI_MAPPING, EMOJI_MAPPING_MALE

        mapping = EMOJI_MAPPING if args.voice == "female" else EMOJI_MAPPING_MALE
        speaker_map = {name: mapping[emo] for name, emo in EMOTION_EMOJIS.items()}
        make_filelist(Path(args.dir), Path(args.script_dir), speaker_map, Path(args.output))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
