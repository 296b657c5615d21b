"""Training / fine-tuning loop of the acoustic model (PyTorch port of
``emojivoice_tpu.training.train``), one device, f32.

    python -m emojivoice_tpu_torch.training.train --preset emoji_multi \\
        --train_filelist data/train.txt --valid_filelist data/val.txt --out_dir logs/run

Preset → model + Adam state → bucketed batches from a filelist → train step
(forward with MAS, loss, backward, clip, Adam) → validation pass → probe →
checkpoint → resume.  It runs on the card unless ``--device cpu`` is given,
and fails if the card is missing.  ``metrics.jsonl`` in the output folder
holds one record per logged step (tags ``train``, ``val``, ``probe``,
``shapes``, ``test``); beside each checkpoint a ``data_state_<step>.json``
records where in the (seed, epoch)-deterministic shuffle the run was, so
``--resume`` continues on unseen batches, and every random draw is seeded
from (seed, step), so a resumed run repeats an unbroken one exactly.

``--precision bf16-mixed`` computes the forward and backward in bf16 with f32
parameters, losses, gradients and Adam (``training/state.py``); the default is
the preset's ``trainer.precision``.

``--from_torch_ckpt`` fine-tunes from a reference-format ``.ckpt`` (a
released voice, or what ``io/export_torch.py`` wrote): the model takes the
checkpoint's own architecture, and a checkpoint that does not fit the
preset's data (mel width, speaker count) is refused by name.

``--loggers`` (default ``tensorboard``) picks the metric writers of
``utils/observability.py`` under ``<out_dir>/tb``: tensorboard event files
where the ``tensorboard`` package imports and the ``scalars.jsonl`` sidecar
always, ``csv``, ``wandb`` (skipped with a warning without the package); they
get the ``train/``, ``val/``, ``probe/`` and ``test/`` scalars and are closed
however the run ends.  ``--render_val_samples N`` (default 2) synthesises the
first N validation texts after each validation pass and logs their mels as
images (``val/mel_<i>``): through one mel-only ``SynthesisPipeline`` for the
run, built on the live model (no copy of the weights), in eval mode and
without gradients, train mode restored after, so a render moves no BatchNorm
statistic of a conformer decoder.

Flags keep the JAX trainer's names.  Not ported yet: ``--tp``,
``--num_devices`` and ``--dcn_*`` (parallelism).
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime as dt
import itertools
import json
import os
import sys
import traceback
from pathlib import Path

import numpy as np
import torch


def build_parser():
    p = argparse.ArgumentParser(prog="emojivoice-train-torch")
    p.add_argument("--preset", default="ljspeech", help="ljspeech | vctk | emoji_multi | tiny")
    p.add_argument("--train_filelist", required=True)
    p.add_argument("--valid_filelist", required=True)
    p.add_argument("--test_filelist", default=None, help="held-out split for a post-fit evaluation pass")
    p.add_argument("--out_dir", default="logs/run")
    p.add_argument("--device", default="cuda", help="cuda (default; fails without a card) | cuda:N | cpu")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--max_steps", type=int, default=-1)
    p.add_argument("--max_epochs", type=int, default=-1)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--scheduler", default=None, choices=[None, "constant", "exponential", "cosine"],
                   help="LR schedule keyed on the optimizer step (resume-correct)")
    p.add_argument("--warmup_steps", type=int, default=0)
    p.add_argument("--decay_steps", type=int, default=100_000)
    p.add_argument("--scheduler_gamma", type=float, default=0.1)
    p.add_argument("--lr_end", type=float, default=0.0)
    p.add_argument("--precision", default=None, choices=[None, "f32", "bf16-mixed"],
                   help="bf16-mixed: bf16 compute, f32 parameters, losses and optimizer; default: the preset's "
                        "trainer.precision")
    p.add_argument("--out_size", type=int, default=None, help="Grad-TTS segment crop (multiple of 4)")
    p.add_argument("--from_torch_ckpt", default=None, help="fine-tune from a reference-format .ckpt")
    p.add_argument("--resume", action="store_true", help="resume from the latest checkpoint in out_dir")
    p.add_argument("--ckpt_every_steps", type=int, default=1000)
    p.add_argument("--val_every_steps", type=int, default=500)
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--mel_stats", default=None, help='JSON {"mel_mean": m, "mel_std": s} override (text or path)')
    p.add_argument("--fast_dev_run", action="store_true", help="1 train step + 1 val pass, no checkpoints")
    p.add_argument("--overfit_batches", type=int, default=0, help="train repeatedly on the first N batches")
    p.add_argument("--limit_train_batches", type=int, default=0, help="cap batches per epoch")
    p.add_argument("--detect_anomaly", action="store_true", help="fail fast on NaN/Inf")
    p.add_argument("--probe_every", type=int, default=0,
                   help="every N steps run MatchaTTS.training_probe on a fixed train batch and log "
                        "alignment-emergence diagnostics under tag 'probe'; 0 disables")
    p.add_argument("--cache_data", action="store_true",
                   help="keep decoded items (text ids + mels) in memory after epoch 1")
    p.add_argument("--render_val_samples", type=int, default=2,
                   help="synthesise N validation texts after each validation pass and log their mels as images; "
                        "0 disables")
    p.add_argument("--loggers", default="tensorboard",
                   help="comma list of metric writers: tensorboard | csv | wandb (wandb is skipped with a warning "
                        "without the package); metrics.jsonl is always written")
    return p


def main(argv=None) -> int:
    """Run the loop; on any failure write the traceback to
    out_dir/exception.log and re-raise."""
    from emojivoice_tpu_torch.utils.observability import make_logger

    args = build_parser().parse_args(argv)
    tb = None
    try:
        tb = make_logger(args.loggers, str(Path(args.out_dir) / "tb"))
        return _run(args, tb)
    except Exception:
        out = Path(args.out_dir)
        out.mkdir(parents=True, exist_ok=True)
        (out / "exception.log").write_text(traceback.format_exc())
        print(f"[train] FAILED — traceback written to {out / 'exception.log'}", file=sys.stderr, flush=True)
        raise
    finally:
        if tb is not None:
            tb.close()  # the metric writers are closed however the run ends


def _run(args, tb) -> int:
    from emojivoice_tpu_torch import config as cfglib
    from emojivoice_tpu_torch.data.dataset import BucketBatcher, Prefetcher, TextMelDataset
    from emojivoice_tpu_torch.io.checkpoint import CheckpointManager
    from emojivoice_tpu_torch.training.state import (_dtype_for, batch_to_device, create_train_state, eval_step,
                                                     train_step)
    from emojivoice_tpu_torch.utils.observability import enable_nan_checks
    from emojivoice_tpu_torch.utils.prng import step_generator

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available (pass --device cpu to train on the CPU)")
    if args.detect_anomaly:
        enable_nan_checks(True)
    if args.fast_dev_run:
        args.max_steps = 1
        args.val_every_steps = 1
        args.ckpt_every_steps = 0
        args.render_val_samples = 0

    root = cfglib.get_preset(args.preset)
    if args.mel_stats:
        stats = json.loads(Path(args.mel_stats).read_text()) if os.path.exists(args.mel_stats) \
            else json.loads(args.mel_stats)
        ds_stats = cfglib.DataStatistics(stats["mel_mean"], stats["mel_std"])
        root = dataclasses.replace(
            root,
            model=dataclasses.replace(root.model, data_statistics=ds_stats),
            data=dataclasses.replace(root.data, data_statistics=ds_stats),
        )
    # the flag overrides the preset's trainer.precision (the reference trainer's `precision: 16-mixed`)
    precision = args.precision or root.trainer.precision
    _dtype_for(precision)  # an unknown name fails here, before any work
    model_cfg = dataclasses.replace(root.model, out_size=args.out_size)
    opt_cfg = dataclasses.replace(
        root.optimizer, lr=args.lr, scheduler=args.scheduler, warmup_steps=args.warmup_steps,
        decay_steps=args.decay_steps, scheduler_gamma=args.scheduler_gamma, lr_end=args.lr_end,
    )
    data_cfg = dataclasses.replace(
        root.data,
        train_filelist_path=args.train_filelist,
        valid_filelist_path=args.valid_filelist,
        batch_size=args.batch_size,
        seed=args.seed,
    )

    loaded_sd = None
    if args.from_torch_ckpt:
        from emojivoice_tpu_torch.io.torch_ckpt import load_matcha

        loaded_sd, loaded_cfg = load_matcha(args.from_torch_ckpt)
        for field, have, want in (("n_feats", loaded_cfg.n_feats, root.data.audio.n_mels),
                                  ("n_spks", loaded_cfg.n_spks, root.data.n_spks)):
            if have != want:
                raise ValueError(f"--from_torch_ckpt {args.from_torch_ckpt}: the checkpoint's {field}={have} does "
                                 f"not fit preset {args.preset!r}, whose data gives {want}")
        model_cfg = dataclasses.replace(loaded_cfg, out_size=args.out_size)
        print(f"[train] fine-tuning from {args.from_torch_ckpt} (n_spks={model_cfg.n_spks})", flush=True)

    state = create_train_state(model_cfg, opt_cfg, seed=args.seed, device=device)
    model = state.model
    if loaded_sd is not None:
        model.load_state_dict(loaded_sd, strict=True)

    def count(module):
        return sum(p.numel() for p in module.parameters())

    print(f"[train] device={device} preset={args.preset} params total={count(model) / 1e6:.2f}M "
          f"encoder={count(model.encoder) / 1e6:.2f}M decoder={count(model.decoder) / 1e6:.2f}M  "
          f"lr={opt_cfg.lr} out_size={args.out_size} precision={precision}", flush=True)
    ckpt_dir = Path(args.out_dir) / "ckpts"
    mgr = CheckpointManager(str(ckpt_dir), max_to_keep=root.trainer.save_top_k)
    resumed_data_state = None
    if args.resume and mgr.latest_step() is not None:
        state.load_state_dict(mgr.restore(map_location=device))
        # the shuffle position is only meaningful under the settings that
        # produced it: on any mismatch fall back to an epoch-0 restart
        ds_path = ckpt_dir / f"data_state_{state.step}.json"
        if ds_path.exists():
            try:
                cand = json.loads(ds_path.read_text())
            except (json.JSONDecodeError, OSError):
                cand = None  # truncated or corrupt sidecar: resume the weights anyway
            fp = {"batch_size": args.batch_size, "seed": args.seed}
            if cand is not None and all(cand.get(k, v) == v for k, v in fp.items()):
                resumed_data_state = cand
            elif cand is not None:
                print(f"[train] data_state ignored (saved {cand} vs current {fp})", flush=True)
        print(f"[train] resumed at step {state.step}"
              + (f" (data epoch {resumed_data_state['epoch']}, batch {resumed_data_state['batch']})"
                 if resumed_data_state else ""), flush=True)

    train_ds = TextMelDataset(args.train_filelist, data_cfg, cache_items=args.cache_data)
    valid_ds = TextMelDataset(args.valid_filelist, data_cfg, cache_items=args.cache_data)
    min_mel = args.out_size if args.out_size else None
    batcher = BucketBatcher(train_ds, args.batch_size, min_mel_bucket=min_mel, seed=args.seed)
    if resumed_data_state is not None and args.overfit_batches == 0:
        batcher.epoch = int(resumed_data_state["epoch"])
        batcher.skip_next = int(resumed_data_state["batch"])
    val_batcher = BucketBatcher(valid_ds, args.batch_size, min_mel_bucket=min_mel, shuffle=False, seed=args.seed)

    metrics_path = Path(args.out_dir) / "metrics.jsonl"
    metrics_path.parent.mkdir(parents=True, exist_ok=True)
    render_cache: dict = {}

    def render_val_samples(step):
        """The first N validation texts synthesised by the live model, their
        mels logged as images."""
        if args.render_val_samples <= 0 or len(valid_ds) == 0:
            return
        from emojivoice_tpu_torch.inference.pipeline import SynthesisPipeline

        pipe = render_cache.get("pipe")
        try:
            if pipe is None:  # one mel-only pipeline for the run, on the live model
                pipe = render_cache["pipe"] = SynthesisPipeline(model_cfg, model, device=device,
                                                                cleaners=data_cfg.cleaners)
            model.eval()
            for i in range(min(args.render_val_samples, len(valid_ds))):
                _, spk, text = valid_ds.items[i]
                res = pipe.synthesise([text], spks=[spk], n_timesteps=10, seed=0, vocode=False)[0]
                tb.image(f"val/mel_{i}", res.mel, step)
        finally:
            model.train()
        tb.flush()

    def log_metrics(tag, step, m, extra=None):
        rec = {"tag": tag, "step": int(step), "time": dt.datetime.now().isoformat(),
               **{k: (None if v is None else float(v)) for k, v in m.items()}}
        if extra:
            rec.update(extra)
        with open(metrics_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        for k, v in m.items():  # the JAX trainer's rule: a probe metric only where it is finite
            if v is not None and (tag != "probe" or np.isfinite(float(v))):
                tb.scalar(f"{tag}/{k}", float(v), step)
        if tag == "train":
            print(f"[train] step {int(step)}  " + "  ".join(f"{k}={float(v):.4f}" for k, v in m.items()),
                  flush=True)

    def write_data_state(step):
        if args.overfit_batches:
            return
        tmp = ckpt_dir / f".data_state_{step}.tmp"
        tmp.write_text(json.dumps({"epoch": data_epoch, "batch": data_batch,
                                   "batch_size": args.batch_size, "seed": args.seed}))
        os.replace(tmp, ckpt_dir / f"data_state_{step}.json")
        kept = set(mgr.all_steps())  # prune sidecars whose checkpoint is gone
        for p in ckpt_dir.glob("data_state_*.json"):
            try:
                s = int(p.stem.rsplit("_", 1)[1])
            except ValueError:
                continue
            if s not in kept and s != step:
                p.unlink(missing_ok=True)

    def save(step):
        mgr.save(step, state.state_dict(), cfg=dataclasses.replace(root, model=model_cfg))
        write_data_state(step)

    # --- convergence probe: a fixed train batch measured at a fixed cadence
    probe_batch = None
    probe_state: dict = {}
    if args.probe_every > 0:
        probe_batcher = BucketBatcher(train_ds, min(args.batch_size, max(1, len(train_ds))),
                                      min_mel_bucket=min_mel, shuffle=False, seed=args.seed)
        probe_np = next(iter(probe_batcher), None)
        if probe_np is not None:
            probe_batch = batch_to_device(probe_np, device)
            probe_z = torch.randn(probe_batch["y"].shape, generator=step_generator(0, 0, "probe", device),
                                  device=device, dtype=torch.float32) * 0.667

    def run_probe(step):
        if probe_batch is None:
            return
        model.eval()
        out = model.training_probe(probe_batch["x"], probe_batch["x_lengths"], probe_batch["y"],
                                   probe_batch["y_lengths"], probe_batch.get("spks"), z=probe_z)
        model.train()
        mas = out.pop("mas_durations").double().cpu().numpy()
        prev = probe_state.get("prev_mas")
        m = {k: float(v) for k, v in out.items()}
        # L1 drift of the MAS path between consecutive probes; the first has
        # no predecessor: null, not NaN (strict JSON parsers reject NaN)
        m["mas_drift_l1"] = float(np.mean(np.abs(mas - prev))) if prev is not None else None
        probe_state["prev_mas"] = mas
        row0 = mas[0, : int(probe_batch["x_lengths"][0])].astype(int).tolist()
        log_metrics("probe", step, m, extra={"mas_dur_row0": row0})
        print(f"[train] probe step {step}  "
              + "  ".join(f"{k}={v:.4f}" for k, v in m.items() if v is not None), flush=True)

    def run_eval(tag, eval_batcher, step):
        ms = [eval_step(model, batch_to_device(vb, device), precision=precision) for vb in eval_batcher]
        if not ms:
            return None
        avg = {k: float(np.mean([float(m[k]) for m in ms])) for k in ms[0]}  # one wait, after the sweep
        log_metrics(tag, step, avg)
        if tag == "val":
            render_val_samples(step)
        return avg

    overfit_set = None
    if args.overfit_batches > 0:
        # the first N batches, captured once: re-slicing per epoch would pick
        # N other batches from each reshuffle
        overfit_set = list(itertools.islice(iter(batcher), args.overfit_batches))

    # the host tracks the step; metrics are read one step late, so the read
    # overlaps the next step's device work instead of stalling the one queued
    pending_log = None  # (step, device metrics)

    def flush_log():
        nonlocal pending_log
        if pending_log is None:
            return
        step, m = pending_log
        pending_log = None
        if args.detect_anomaly or step % args.log_every == 0:
            host = {k: float(v) for k, v in m.items()}
            if args.detect_anomaly and not all(np.isfinite(v) for v in host.values()):
                raise FloatingPointError(f"non-finite metric at step {step}: {host}")
            if step % args.log_every == 0:
                log_metrics("train", step, host)

    epoch = batcher.epoch  # 0 fresh; the restored shuffle epoch on resume
    t_start = dt.datetime.now()
    done = False
    # where the NEXT batch comes from in the deterministic shuffle
    data_epoch, data_batch = batcher.epoch, batcher.skip_next
    seen_shapes: dict = {}  # (B, T_text, T_mel) -> first step that ran it

    def one_step(batch_np):
        nonlocal pending_log, done
        base = state.step
        shape_key = (int(batch_np["x"].shape[0]), int(batch_np["x"].shape[1]), int(batch_np["y"].shape[1]))
        seen_shapes.setdefault(shape_key, base)
        m = train_step(state, batch_to_device(batch_np, device), args.seed, precision=precision)
        flush_log()  # the previous step's metrics
        pending_log = (state.step, m)
        step = state.step
        if args.val_every_steps > 0 and step % args.val_every_steps == 0:
            flush_log()  # keep metrics.jsonl ordered around the val record
            run_eval("val", val_batcher, step)
        if args.probe_every > 0 and step % args.probe_every == 0:
            flush_log()
            run_probe(step)
        if args.ckpt_every_steps > 0 and step % args.ckpt_every_steps == 0:
            save(step)
        if 0 < args.max_steps <= step:
            done = True

    if args.probe_every > 0 and state.step == 0:
        run_probe(0)  # the random-init baseline
    if 0 < args.max_steps <= state.step:
        done = True
    while not done:
        epoch += 1
        if args.max_epochs > 0 and epoch > args.max_epochs:
            break
        shuffle_epoch, epoch_base = batcher.epoch, batcher.skip_next
        epoch_batches = Prefetcher(batcher) if overfit_set is None else overfit_set
        for bi, batch_np in enumerate(epoch_batches):
            # the cap counts batches of the SHUFFLE epoch, so a resumed run
            # (bi restarts at 0 mid-epoch) honours the same cap
            if 0 < args.limit_train_batches <= epoch_base + bi:
                data_epoch, data_batch = shuffle_epoch + 1, 0
                break
            data_epoch, data_batch = shuffle_epoch, epoch_base + bi + 1
            one_step(batch_np)
            if done:
                break
        else:
            data_epoch, data_batch = batcher.epoch, 0  # next: batch 0 of the next shuffle epoch
    flush_log()

    if seen_shapes:
        log_metrics("shapes", state.step, {}, extra={
            "distinct_shapes": len(seen_shapes),
            "shapes": [{"batch": b, "t_text": tx, "t_mel": ty, "first_step": s}
                       for (b, tx, ty), s in sorted(seen_shapes.items())],
        })
    # final save, unless the loop just wrote this step; fast_dev_run writes none
    if not args.fast_dev_run and mgr.latest_step() != state.step:
        save(state.step)
    if args.test_filelist:
        test_ds = TextMelDataset(args.test_filelist, data_cfg)
        avg = run_eval("test", BucketBatcher(test_ds, args.batch_size, min_mel_bucket=min_mel, shuffle=False,
                                             seed=args.seed), state.step)
        if avg:
            print("[train] test  " + "  ".join(f"{k}={v:.4f}" for k, v in avg.items()), flush=True)
    print(f"[train] finished at step {state.step} ({(dt.datetime.now() - t_start).total_seconds():.0f}s)",
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
