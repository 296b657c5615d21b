"""`python -m emojivoice_tpu_torch.training.proof`: a train-to-audio proof run
(PyTorch port of ``emojivoice_tpu.training.proof``).

Evidence that the fine-tune story works beyond a one-step smoke (fine-tune a
released multi-speaker checkpoint on about two minutes per emoji voice, then
synthesise with the new voices):

1. build a model at the requested preset and export it through
   ``io/export_torch.py``: a surrogate for a released PyTorch checkpoint,
   which goes through the same ``--from_torch_ckpt`` load path;
2. generate a synthetic 22.05 kHz fine-tune corpus (distinct harmonic
   signatures per speaker id, the 11 emoji voices by default);
3. run the real training CLI for N steps;
4. assert that the train loss went down (first-window against last-window
   means), not just that steps ran;
5. reload the trained checkpoint through the serving path
   (``SynthesisPipeline.from_checkpoint``) and synthesise audio with an emoji
   voice.

It runs on the card unless ``--device cpu`` is given, and fails if the card is
missing.  ``--render_val_samples`` is the trainer's (default 0 here, as in
the JAX tool).  ``--num_devices N`` trains over N local ranks (the
trainer's flag; 0, the default, is one device without a process group).
Not ported: the JAX tool's ``--steps_per_dispatch`` and ``--wire_f16``
(remote-TPU workarounds) and its compilation-cache switch.
"""

from __future__ import annotations

import argparse
import datetime as dt
import json
import shutil
import warnings
from pathlib import Path

import numpy as np

EMOJI_SPEAKERS = (107, 58, 79, 103, 66, 18, 12, 15, 54, 22, 17)  # apps/emoji.py's eleven voices


def make_dataset(root: Path, n_spks_pool, n_utts: int = 22, seconds: float = 2.0,
                 sample_rate: int = 22050, seed: int = 0):
    """Synthetic fine-tune corpus: per-speaker harmonic stacks + breath noise."""
    from scipy.io import wavfile

    rng = np.random.default_rng(seed)
    wav_dir = root / "wavs"
    wav_dir.mkdir(parents=True, exist_ok=True)
    texts = [
        "the robot tells a story", "a brave little voice", "hello from the island",
        "we walk to the harbor", "rain falls on the roof", "the kettle sings softly",
        "count the silver stars", "a door creaks open", "waves brush the sand",
        "morning light arrives", "the garden smells green", "night settles gently",
    ]
    t = np.arange(int(seconds * sample_rate)) / sample_rate
    rows = []
    for i in range(n_utts):
        spk = n_spks_pool[i % len(n_spks_pool)]
        f0 = 110.0 * (1 + (spk % 13) / 6.0) * (1 + 0.05 * rng.normal())
        wav = sum((0.35 / h) * np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 6.28))
                  for h in (1, 2, 3, 4))
        wav = (wav * (0.6 + 0.4 * np.sin(2 * np.pi * 1.3 * t)) +
               0.01 * rng.normal(size=t.shape)).astype(np.float32)
        path = wav_dir / f"u{i}.wav"
        wavfile.write(path, sample_rate, wav)
        rows.append(f"{path}|{spk}|{texts[i % len(texts)]}")
    train = root / "train.txt"
    train.write_text("\n".join(rows) + "\n")
    val = root / "val.txt"
    val.write_text("\n".join(rows[:2]) + "\n")
    return train, val


def run_proof(preset: str, out_dir: str, steps: int = 40, batch_size: int = 4, out_size: int = 172, seed: int = 0,
              window: int = 5, utts: int = 22, val_every_steps: int = 0, ckpt_every_steps: int = 0,
              render_val_samples: int = 0, log_every: int = 1, device="cuda", num_devices: int = 0) -> dict:
    import torch

    from emojivoice_tpu_torch import config as cfglib
    from emojivoice_tpu_torch.inference.cli import save_png, save_wav
    from emojivoice_tpu_torch.inference.pipeline import SynthesisPipeline
    from emojivoice_tpu_torch.io.checkpoint import CheckpointManager
    from emojivoice_tpu_torch.io.export_torch import export
    from emojivoice_tpu_torch.training.state import create_train_state
    from emojivoice_tpu_torch.training.train import main as train_main

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)

    # 1. torch-format surrogate of a released checkpoint
    root_cfg = cfglib.get_preset(preset)
    state = create_train_state(root_cfg.model, root_cfg.optimizer, seed=seed, device=device)
    surrogate_dir = out / "surrogate_ckpts"
    CheckpointManager(str(surrogate_dir)).save(0, state.state_dict(), cfg=root_cfg)
    del state
    torch_ckpt = export(str(surrogate_dir), str(out / "surrogate.ckpt"))

    # 2. synthetic 22.05 kHz fine-tune data over the emoji speaker ids
    pool = EMOJI_SPEAKERS if root_cfg.model.n_spks > max(EMOJI_SPEAKERS) else \
        tuple(range(root_cfg.model.n_spks))
    train_fl, val_fl = make_dataset(out / "data", pool, n_utts=utts, seed=seed)

    # 3. the real training CLI, fine-tuning from the torch surrogate
    run_dir = out / "run"
    rc = train_main([
        "--preset", preset,
        "--device", str(device),
        "--train_filelist", str(train_fl),
        "--valid_filelist", str(val_fl),
        "--out_dir", str(run_dir),
        "--batch_size", str(batch_size),
        "--max_steps", str(steps),
        "--from_torch_ckpt", str(torch_ckpt),
        "--out_size", str(out_size),
        "--val_every_steps", str(val_every_steps),
        "--ckpt_every_steps", str(ckpt_every_steps),
        # log_every 1 gives a per-step loss curve but reads the device's metrics every step
        "--log_every", str(log_every),
        "--render_val_samples", str(render_val_samples),
        "--seed", str(seed),
        "--num_devices", str(num_devices),
        # proof data is always fine-tune scale (tens of utterances): keep decoded mels so that
        # epochs >= 2 don't pay host-side mel extraction
        "--cache_data",
    ])
    assert rc == 0, "training CLI failed"

    # 4. losses decreased: windowed means, not a smoke check
    metrics = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    train_recs = [m for m in metrics if m["tag"] == "train"]
    train_losses = [m["loss"] for m in train_recs]
    # with log_every > 1 only every Nth step is a record
    expected_recs = max(1, steps // log_every)
    assert len(train_losses) >= expected_recs, \
        f"expected >={expected_recs} train records for {steps} steps (log_every={log_every}), saw {len(train_losses)}"
    first = float(np.mean(train_losses[:window]))
    last = float(np.mean(train_losses[-window:]))
    assert last < first, f"loss did not decrease: first={first:.4f} last={last:.4f}"

    # 5. audio through the trained weights via the serving path (a seeded random vocoder: the proof is
    # about the acoustic fine-tune loop)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        pipe = SynthesisPipeline.from_checkpoint(str(run_dir / "ckpts"), device=device, cleaners=("basic_cleaners",))
    res = pipe.synthesise(["the robot tells a story"], spks=[pool[2]], n_timesteps=10, seed=0)[0]
    wav = np.asarray(res.wav)
    assert np.isfinite(wav).all() and float(np.abs(wav).max()) > 1e-4
    save_wav(str(out / "proof.wav"), wav)
    save_png(str(out / "proof_mel.png"), np.asarray(res.mel))

    # steps/s from the records' timestamps; the step-number delta, not the record count
    t_first = dt.datetime.fromisoformat(train_recs[0]["time"])
    t_last = dt.datetime.fromisoformat(train_recs[-1]["time"])
    span = (t_last - t_first).total_seconds()
    step_span = train_recs[-1]["step"] - train_recs[0]["step"]
    steps_per_sec = step_span / span if span > 0 else float("nan")
    val_losses = [m["loss"] for m in metrics if m["tag"] == "val"]

    on_card = torch.device(device).type == "cuda"
    summary = {
        "preset": preset, "steps": int(train_recs[-1]["step"]), "batch_size": batch_size, "out_size": out_size,
        "devices": max(1, num_devices),
        "loss_first5_mean": round(first, 4), "loss_last5_mean": round(last, 4),
        "loss_drop": round(first - last, 4),
        # the last TRAIN record: with val cadences on, the file's last line may be a val average
        "dur_loss_last": round(train_recs[-1].get("dur_loss", float("nan")), 4),
        "diff_loss_last": round(train_recs[-1].get("diff_loss", float("nan")), 4),
        "prior_loss_last": round(train_recs[-1].get("prior_loss", float("nan")), 4),
        "steps_per_sec": round(steps_per_sec, 3),
        "val_losses": [round(v, 4) for v in val_losses],
        "val_trend_ok": bool(val_losses[-1] < val_losses[0]) if len(val_losses) >= 2 else None,
        "audio_seconds": round(len(wav) / res.sample_rate, 2),
        "backend": torch.cuda.get_device_name(torch.device(device)) if on_card else "cpu",
    }
    (out / "summary.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    return summary


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="emojivoice-train-proof-torch")
    p.add_argument("--preset", default="emoji_multi")
    p.add_argument("--out_dir", default="proof_out")
    p.add_argument("--device", default="cuda", help="cuda (default; fails without a card) | cuda:N | cpu")
    p.add_argument("--steps", type=int, default=40)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--out_size", type=int, default=172)
    p.add_argument("--utts", type=int, default=22)
    p.add_argument("--val_every_steps", type=int, default=0)
    p.add_argument("--ckpt_every_steps", type=int, default=0)
    p.add_argument("--render_val_samples", type=int, default=0)
    p.add_argument("--artifact_dir", default=None, help="copy metrics.jsonl + summary.json here")
    p.add_argument("--num_devices", type=int, default=0, help="local ranks (the trainer's flag; 0 = one device)")
    p.add_argument("--log_every", type=int, default=1,
                   help="metric cadence; 1 = per-step loss curve (reads the device each step)")
    args = p.parse_args(argv)
    run_proof(args.preset, args.out_dir, steps=args.steps, batch_size=args.batch_size, out_size=args.out_size,
              utts=args.utts, val_every_steps=args.val_every_steps, ckpt_every_steps=args.ckpt_every_steps,
              render_val_samples=args.render_val_samples, log_every=args.log_every, device=args.device,
              num_devices=args.num_devices)
    if args.artifact_dir:
        art = Path(args.artifact_dir)
        art.mkdir(parents=True, exist_ok=True)
        shutil.copy(Path(args.out_dir) / "run" / "metrics.jsonl", art / "metrics.jsonl")
        shutil.copy(Path(args.out_dir) / "summary.json", art / "summary.json")
        for extra in ("proof.wav", "proof_mel.png"):
            src = Path(args.out_dir) / extra
            if src.exists():
                shutil.copy(src, art / extra)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
