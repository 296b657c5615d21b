"""`emojivoice-scratch-proof-torch` — the from-scratch convergence proof
(PyTorch port of ``emojivoice_tpu.training.scratch_proof``).

1. write the synthetic *alignable* corpus of ``training/synthetic.py`` (every
   character a tone keyed by the character, its length keyed by its class:
   a true monotonic text↔mel alignment exists by construction);
2. run the port's training CLI from random init (no ``--from_torch_ckpt``)
   with ``--probe_every``, which logs ``MatchaTTS.training_probe`` on a
   fixed batch: MAS diagonality, MAS-duration drift between probes,
   predicted-against-MAS duration MSE and teacher-forced mel L1;
3. assert that the alignment emerges, not only that the loss falls:
   (a) diagonality rises from its random-init value, (b) the MAS path stops
   moving (the drift shrinks), (c) the predicted durations converge onto the
   MAS ones, (d) the teacher-forced mel L1 shrinks;
4. synthesise a training sentence freely through the serving path
   (``SynthesisPipeline.from_checkpoint``, K1 on the card; a seeded random
   vocoder, since only the mel is compared) and hold it to its ground-truth
   mel: total length within a stated budget of the true one, and mel L1 over
   the overlapping frames under the random-init teacher-forced baseline.

    python -m emojivoice_tpu_torch.training.scratch_proof --preset emoji_multi --steps 4000 \\
        --batch_size 8 --lr 5e-4 --scheduler cosine --lr_end 5e-5 --probe_every 200 \\
        --out_dir scratch_out --artifact_dir docs/artifacts/scratch_proof_torch

It runs on the card unless ``--device cpu`` is given.  ``summary.json`` has
the JAX tool's keys; ``"backend"`` holds the card's name (``"cpu"`` on the
CPU).  ``--num_devices N`` trains over N local ranks (the trainer's flag;
0, the default, is one device without a process group; ``"devices"`` in
the summary counts them).  Not ported: the compilation-cache and
``--wire_f16`` switches, which served the TPU alone.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime as dt
import json
import math
import shutil
import warnings
from pathlib import Path

import numpy as np


def run_scratch_proof(preset: str, out_dir: str, steps: int = 600, batch_size: int = 4, probe_every: int = 50,
                      seed: int = 0, utts: int = 20, n_speakers: int = 3, out_size: int | None = None,
                      lr: float = 1e-3, log_every: int = 10, scheduler: str | None = None, warmup_steps: int = 0,
                      lr_end: float = 0.0, length_budget: float = 0.35, assert_emergence: bool = True,
                      assert_free_synth: bool = True, long_texts: bool = False, device="cuda",
                      num_devices: int = 0) -> dict:
    """Train from random init on the alignable corpus and check emergence.

    length_budget: |predicted − true| / true total-duration tolerance of the
    final free synthesis of a training sentence.  assert_free_synth gates the
    length and mel budgets apart from the rest: short runs align long before
    the duration predictor is usable.
    """
    import torch

    from emojivoice_tpu_torch import config as cfglib
    from emojivoice_tpu_torch.data.dataset import TextMelDataset
    from emojivoice_tpu_torch.inference.pipeline import SynthesisPipeline
    from emojivoice_tpu_torch.training.synthetic import make_alignable_dataset
    from emojivoice_tpu_torch.training.train import main as train_main

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError('run_scratch_proof: no CUDA device is available (pass device="cpu" to run on the CPU)')
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)

    root_cfg = cfglib.get_preset(preset)
    speakers = tuple(range(min(n_speakers, root_cfg.model.n_spks)))
    train_fl, val_fl, corpus_stats = make_alignable_dataset(out / "data", speakers, n_utts=utts, seed=seed,
                                                            long_texts=long_texts)

    run_dir = out / "run"
    rc = train_main([
        "--preset", preset,
        "--device", str(device),
        "--train_filelist", str(train_fl),
        "--valid_filelist", str(val_fl),
        "--out_dir", str(run_dir),
        "--batch_size", str(batch_size),
        "--max_steps", str(steps),
        # no --from_torch_ckpt: random init is the point
        "--probe_every", str(probe_every),
        "--log_every", str(log_every),
        "--lr", str(lr),
        "--val_every_steps", "0",
        "--ckpt_every_steps", "0",
        "--render_val_samples", "0",
        "--seed", str(seed),
        "--num_devices", str(num_devices),
        "--cache_data",
    ] + (["--out_size", str(out_size)] if out_size else [])
      + (["--scheduler", scheduler, "--decay_steps", str(max(1, steps - warmup_steps)),
          "--warmup_steps", str(warmup_steps), "--lr_end", str(lr_end)] if scheduler else []))
    assert rc == 0, "training CLI failed"

    metrics = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    probes = [m for m in metrics if m["tag"] == "probe"]
    assert len(probes) >= 3, f"need >=3 probes, got {len(probes)}"
    first, last = probes[0], probes[-1]
    drifts = [p["mas_drift_l1"] for p in probes
              if p["mas_drift_l1"] is not None and math.isfinite(p["mas_drift_l1"])]

    trains = [m for m in metrics if m["tag"] == "train"]
    loss_first = float(np.mean([m["loss"] for m in trains[:5]]))
    loss_last = float(np.mean([m["loss"] for m in trains[-5:]]))

    # every distinct (B, T_text, T_mel) the trainer ran, with the step that first ran it, and the step rate of
    # each half of the run from the train records' clock
    shapes_rec = next((m for m in metrics if m["tag"] == "shapes"), None)
    census = None
    if shapes_rec is not None:
        census = {"distinct_shapes": shapes_rec["distinct_shapes"],
                  "last_new_shape_step": max(s["first_step"] for s in shapes_rec["shapes"]),
                  "shapes": shapes_rec["shapes"]}
    rate = None
    if len(trains) >= 8:
        ts = [dt.datetime.fromisoformat(m["time"]) for m in trains]
        steps_arr = [m["step"] for m in trains]
        mid = len(trains) // 2

        def _rate(lo, hi):
            span = (ts[hi] - ts[lo]).total_seconds()
            return (steps_arr[hi] - steps_arr[lo]) / span if span > 0 else float("nan")

        rate = {"first_half_steps_per_s": round(_rate(0, mid), 2),
                "second_half_steps_per_s": round(_rate(mid, len(trains) - 1), 2)}

    # free synthesis of a training sentence against its ground truth
    data_cfg = dataclasses.replace(root_cfg.data, train_filelist_path=str(train_fl),
                                   valid_filelist_path=str(val_fl), seed=seed)
    ds = TextMelDataset(str(train_fl), data_cfg)
    gt_mel = np.asarray(ds[0]["y"])  # normalized (T, n_feats)
    _, spk, text = ds.items[0]
    with warnings.catch_warnings():  # the run trained no vocoder: a seeded random one, said once here
        warnings.simplefilter("ignore", UserWarning)
        pipe = SynthesisPipeline.from_checkpoint(str(run_dir / "ckpts"), device=device, cleaners=data_cfg.cleaners)
    served = pipe.model_cfg
    res = pipe.synthesise([text], spks=[spk] if served.n_spks > 1 else None, n_timesteps=10, seed=0)[0]
    del pipe
    stats = served.data_statistics
    pred_mel = (np.asarray(res.mel) - stats.mel_mean) / stats.mel_std
    t_pred, t_gt = pred_mel.shape[0], gt_mel.shape[0]
    length_err = abs(t_pred - t_gt) / t_gt
    n = min(t_pred, t_gt)
    mel_l1 = float(np.mean(np.abs(pred_mel[:n] - gt_mel[:n])))

    dev = torch.device(device)
    summary = {
        "preset": preset, "steps": steps, "batch_size": batch_size,
        "devices": max(1, num_devices), "lr": lr, "seed": seed, "utts": utts,
        "speakers": list(speakers), "from_scratch": True,
        "long_texts": long_texts,
        "corpus": corpus_stats,
        "shape_census": census,
        "step_rate": rate,
        "loss_first5_mean": round(loss_first, 4),
        "loss_last5_mean": round(loss_last, 4),
        "probe_steps": [p["step"] for p in probes],
        "diagonality": [round(p["diagonality"], 4) for p in probes],
        "mas_drift_l1": [round(d, 4) for d in drifts],
        "dur_mse_log": [round(p["dur_mse_log"], 4) for p in probes],
        "dur_mae_frames": [round(p["dur_mae_frames"], 4) for p in probes],
        "prior_mel_l1": [round(p["prior_mel_l1"], 4) for p in probes],
        "tf_mel_l1": [round(p["tf_mel_l1"], 4) for p in probes],
        "mas_dur_row0_first": first.get("mas_dur_row0"),
        "mas_dur_row0_last": last.get("mas_dur_row0"),
        "free_synth": {
            "text": text, "speaker": spk,
            "frames_pred": t_pred, "frames_gt": t_gt,
            "length_err": round(length_err, 4),
            "length_budget": length_budget,
            "mel_l1_overlap": round(mel_l1, 4),
            "mel_l1_budget_random_init_tf": round(first["tf_mel_l1"], 4),
        },
        "backend": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
    }
    (out / "summary.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))

    if assert_emergence:
        assert last["diagonality"] > first["diagonality"], \
            f"diagonality did not rise: {first['diagonality']:.4f} → {last['diagonality']:.4f}"
        assert drifts[-1] < drifts[0], f"MAS drift did not shrink: {drifts[0]:.4f} → {drifts[-1]:.4f}"
        assert last["dur_mse_log"] < first["dur_mse_log"], \
            f"dur_mse_log did not fall: {first['dur_mse_log']:.4f} → {last['dur_mse_log']:.4f}"
        assert last["tf_mel_l1"] < first["tf_mel_l1"], \
            f"tf_mel_l1 did not fall: {first['tf_mel_l1']:.4f} → {last['tf_mel_l1']:.4f}"
        assert loss_last < loss_first, f"loss did not decrease: {loss_first:.4f} → {loss_last:.4f}"
        if census is not None and steps >= 1000:
            # every batch shape appears in the first half of a long run
            assert census["last_new_shape_step"] <= steps // 2, \
                f"new batch shape appeared at step {census['last_new_shape_step']}"
        if rate is not None and steps >= 1000:
            # the sustained rate holds: the second half at least 0.8 of the first
            assert rate["second_half_steps_per_s"] >= 0.8 * rate["first_half_steps_per_s"], \
                f"step rate decayed: {rate}"
    if assert_emergence and assert_free_synth:
        assert length_err <= length_budget, f"predicted length off by {length_err:.2%} (> {length_budget:.0%})"
        assert mel_l1 < first["tf_mel_l1"], \
            f"free-synth mel L1 {mel_l1:.4f} not under random-init TF baseline {first['tf_mel_l1']:.4f}"
    return summary


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="emojivoice-scratch-proof-torch")
    p.add_argument("--preset", default="emoji_multi")
    p.add_argument("--out_dir", default="scratch_proof_out")
    p.add_argument("--device", default="cuda", help="cuda (default; fails without a card) | cuda:N | cpu")
    p.add_argument("--steps", type=int, default=600)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--probe_every", type=int, default=50)
    p.add_argument("--utts", type=int, default=20)
    p.add_argument("--n_speakers", type=int, default=3)
    p.add_argument("--out_size", type=int, default=None)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--scheduler", default=None, choices=[None, "constant", "exponential", "cosine"])
    p.add_argument("--warmup_steps", type=int, default=0)
    p.add_argument("--lr_end", type=float, default=0.0)
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num_devices", type=int, default=0, help="local ranks (the trainer's flag; 0 = one device)")
    p.add_argument("--length_budget", type=float, default=0.35)
    p.add_argument("--long_texts", action="store_true",
                   help="wide-length corpus (1-4 joined phrases, several mel buckets)")
    p.add_argument("--no_assert", action="store_true", help="report metrics without the emergence asserts")
    p.add_argument("--artifact_dir", default=None, help="copy metrics.jsonl + summary.json here")
    args = p.parse_args(argv)
    try:
        run_scratch_proof(
            args.preset, args.out_dir, steps=args.steps, batch_size=args.batch_size, probe_every=args.probe_every,
            seed=args.seed, utts=args.utts, n_speakers=args.n_speakers, out_size=args.out_size, lr=args.lr,
            log_every=args.log_every, scheduler=args.scheduler, warmup_steps=args.warmup_steps, lr_end=args.lr_end,
            length_budget=args.length_budget, long_texts=args.long_texts, assert_emergence=not args.no_assert,
            device=args.device, num_devices=args.num_devices)
    finally:  # a run that misses a budget keeps its evidence too
        if args.artifact_dir:
            art = Path(args.artifact_dir)
            art.mkdir(parents=True, exist_ok=True)
            for src in (Path(args.out_dir) / "run" / "metrics.jsonl", Path(args.out_dir) / "summary.json"):
                if src.exists():
                    shutil.copy(src, art / src.name)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
