"""`emojivoice-get-durations-torch`: per-phoneme durations, and teacher-forced
mels, from a trained acoustic model (PyTorch port of
``emojivoice_tpu.training.get_durations``).

    python -m emojivoice_tpu_torch.training.get_durations --checkpoint_path logs/run/ckpts \\
        --filelist data/train.txt --output_dir data/aligned --gen_mels

Runs the training forward's alignment (monotonic alignment search: the K2
kernel on the card) over a filelist, sums each path over mel frames to
per-token durations, and saves ``durations/<stem>.npy`` plus a JSON of
per-phoneme frame spans in which each interleaved blank is merged into the
phoneme that follows it.  The ``.npy`` files feed ``load_durations: True``
training (``data/dataset.py``).

``--gen_mels`` also saves ``gen_mels/<stem>.npy``, the model's teacher-forced
mel of each utterance: the CFM decode conditioned on the ground-truth
alignment, so the generated frames line up one to one with the real
waveform.  They are the conditioning inputs of a HiFi-GAN fine-tune on
model-generated mels (``training/vocoder_proof.py --gen_mels_dir``).  Files
are channels-last (T_mel, n_feats) f32 in the vocoder's log-mel domain.

``--checkpoint_path`` is a reference-format ``.ckpt`` or the ``ckpts/``
directory of ``emojivoice_tpu_torch.training.train``.  It runs on the card
unless ``--device cpu`` is given, and fails if the card is missing.  The
solver's noise is drawn from a generator seeded by (``--seed``, batch index);
``--temperature 0`` decodes without noise.

Each batch's forward (the alignment with K2, and under ``--gen_mels`` the
teacher-forced decode) runs through one captured CUDA graph per batch shape
(``training/eval_graphs.py::EvalGraphs.align``), as the JAX tool jits it;
the noise is drawn into the graph's static buffer.  On the CPU the same
keys run uncaptured.  ``--eager`` runs the forward op by op instead.
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path


def get_phoneme_durations(durations, phones):
    """Merge interleaved blank durations into the following phoneme and
    return cumulative (start, end) spans keyed ``<phone>_<index>`` (blank id 0
    alternates with phones; a trailing blank goes to the last phone)."""
    prev = durations[0]
    merged = []
    # durations at odd indices are real phones, even are blanks
    for i in range(1, len(durations)):
        if i % 2 == 1:  # phone takes its own + preceding blank
            merged.append(int(prev) + int(durations[i]))
            prev = 0
        else:
            prev = durations[i]
    if prev:
        merged[-1] += int(prev)

    out = {}
    start = 0
    for j, (dur, ph) in enumerate(zip(merged, phones)):
        key = f"{ph}_{j}"
        out[key] = {"starttime": start, "endtime": start + dur, "duration": dur}
        start += dur
    return out


def load_acoustic_model(checkpoint_path: str):
    """(state dict, ModelConfig) of a reference ``.ckpt`` file or of the
    latest step in a trainer's ``ckpts/`` directory."""
    if os.path.isdir(checkpoint_path):
        from emojivoice_tpu_torch.io.checkpoint import CheckpointManager

        mgr = CheckpointManager(checkpoint_path)
        restored = mgr.restore()
        return (restored["model"] if "model" in restored else restored), mgr.load_config().model
    from emojivoice_tpu_torch.io.torch_ckpt import load_matcha

    return load_matcha(checkpoint_path)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="emojivoice-get-durations-torch")
    p.add_argument("--checkpoint_path", required=True, help="reference .ckpt, or the trainer's ckpts/ directory")
    p.add_argument("--filelist", required=True)
    p.add_argument("--preset", default="emoji_multi")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--device", default="cuda", help="cuda (default; fails without a card) | cuda:N | cpu")
    p.add_argument("--gen_mels", action="store_true",
                   help="also save gen_mels/<stem>.npy: teacher-forced CFM mels aligned to the ground-truth "
                        "waveform, for HiFi-GAN fine-tuning")
    p.add_argument("--n_timesteps", type=int, default=10, help="CFM Euler steps for --gen_mels")
    p.add_argument("--temperature", type=float, default=0.667, help="CFM noise temperature for --gen_mels")
    p.add_argument("--seed", type=int, default=0, help="noise stream for --gen_mels (one generator per batch)")
    p.add_argument("--eager", action="store_true",
                   help="run each batch's forward op by op instead of through its captured CUDA graph")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from emojivoice_tpu_torch.config import get_preset
    from emojivoice_tpu_torch.data.dataset import BucketBatcher, TextMelDataset
    from emojivoice_tpu_torch.models.matcha import MatchaTTS
    from emojivoice_tpu_torch.text import sequence_to_text
    from emojivoice_tpu_torch.training.eval_graphs import EvalGraphs
    from emojivoice_tpu_torch.training.state import batch_to_device
    from emojivoice_tpu_torch.utils.prng import step_seed, synthesis_noise

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available (pass --device cpu to run on the CPU)")
    sd, model_cfg = load_acoustic_model(args.checkpoint_path)
    model = MatchaTTS(model_cfg)
    model.load_state_dict(sd, strict=True)
    model = model.to(device).eval()
    data_cfg = get_preset(args.preset).data

    ds = TextMelDataset(args.filelist, data_cfg)
    # outputs are named by basename stem: two files with one stem in different folders would overwrite each
    # other, and a consumer of gen_mels/ would then load the wrong conditioning mel
    seen: dict = {}
    for p_, _, _ in ds.items:
        stem = Path(p_).stem
        if stem in seen and seen[stem] != p_:
            raise SystemExit(
                f"duplicate basename stem {stem!r} in {args.filelist}: "
                f"{seen[stem]} and {p_} would overwrite each other under "
                f"durations/ and gen_mels/ — rename the files or split the filelist")
        seen[stem] = p_
    batcher = BucketBatcher(ds, args.batch_size, shuffle=False)
    out_dir = Path(args.output_dir)
    (out_dir / "durations").mkdir(parents=True, exist_ok=True)
    if args.gen_mels:
        (out_dir / "gen_mels").mkdir(parents=True, exist_ok=True)

    graphs = None if args.eager else EvalGraphs(model)
    idx = 0
    for bi, batch in enumerate(batcher):
        dev = batch_to_device(batch, device)
        z = None
        if args.gen_mels:
            # teacher forcing: the decode runs on mu expanded by the ground-truth durations, so it covers
            # exactly y_lengths frames, one to one with the real waveform
            z = synthesis_noise(step_seed(args.seed, bi, "gen_mels"), dev["x"].shape[0], dev["y"].shape[1],
                                model_cfg.n_feats, args.temperature, device)
        if graphs is not None:
            out = graphs.align(dev, z, args.n_timesteps)
        else:
            attn, mu_x, x_mask, spk_e = model.align(dev["x"], dev["x_lengths"], dev["y"], dev["y_lengths"],
                                                    dev.get("spks"))
            out = {"durations": attn.sum(-1)}  # (B, T_x)
            if z is not None:
                out["mel"] = model.decode_mel(mu_x, out["durations"][..., None], dev["y_lengths"], x_mask, spk_e,
                                              dev["y"].shape[1], args.n_timesteps, z)["mel"]
        gen_mel = out["mel"].cpu().numpy() if "mel" in out else None
        durs = out["durations"].cpu().numpy()
        for i in range(batch["x"].shape[0]):
            item_path, _, _ = ds.items[idx]
            stem = Path(item_path).stem
            lx = int(batch["x_lengths"][i])
            d = durs[i, :lx].astype(np.float32)
            np.save(out_dir / "durations" / f"{stem}.npy", d)
            phones = [sequence_to_text([t]) for t in batch["x"][i, 1:lx:2]]
            spans = get_phoneme_durations(d.tolist(), phones)
            with open(out_dir / "durations" / f"{stem}.json", "w") as f:
                json.dump(spans, f, ensure_ascii=False, indent=1)
            if gen_mel is not None:
                ly = int(batch["y_lengths"][i])
                np.save(out_dir / "gen_mels" / f"{stem}.npy", gen_mel[i, :ly].astype(np.float32))
            idx += 1
        print(f"[get-durations] {idx}/{len(ds)}", flush=True)
    if graphs is not None:
        stats = graphs.stats()
        print(f"[get-durations] forward through {'captured CUDA graphs' if graphs.capture else 'staged keys'}: "
              f"{stats['graphs']} keys, {stats['captures']} captures, {stats['replays']} replays", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
