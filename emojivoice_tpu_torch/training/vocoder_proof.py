"""HiFi-GAN GAN-training proof: drive the alternating vocoder step for real
(PyTorch port of ``emojivoice_tpu.training.vocoder_proof``).

    python -m emojivoice_tpu_torch.training.vocoder_proof --out_dir vocoder_proof_out

``training/vocoder_train.py`` holds the upstream recipe (alternating MPD+MSD
LSGAN update, then generator adv + 2x feature matching + 45x mel-L1 on
8,192-sample segments); this tool runs that loop end to end and writes what
can be checked afterwards, as ``training/proof.py`` does for the acoustic
model:

  - metrics.jsonl      one record per logged optimizer step (all five losses)
  - summary.json       windowed first/last means, wall step rate, device
  - before.wav/after.wav  a held-out utterance's mel rendered by the
                          generator at step 0 and after training
  - g_<steps>          the trained generator, an upstream-format dump
  - mel_l1 trend assert   the windowed mean must drop (not a smoke check)

With no ``--gen_ckpt`` the weights start random; the mel-L1 term dominates
early, so the drop shows within about 100 steps.  Training runs in the
upstream weight-norm parameterization.  The two renders fold the weight norm
and go through the serving forward (the fused MRF kernel on the card), which
is how a fine-tuned generator is served.  ``--gen_mels_dir`` is fine-tuning
mode: condition on the acoustic model's teacher-forced mels
(``training/get_durations.py --gen_mels``) instead of ground-truth mels.

It runs on the card unless ``--device cpu`` is given, and fails if the card is
missing.  On the card each step runs through its captured CUDA graph
(``training/vocoder_graphs.py``); ``--eager`` (``graphs=False``) runs it op
by op.  Not ported: the JAX tool's compilation-cache switch.
"""

from __future__ import annotations

import argparse
import datetime as dt
import json
from pathlib import Path
from typing import Optional

import numpy as np


def make_segment_sampler(wavs, seg_frames: int, hop: int, batch_size: int, seed: int):
    """Random aligned (mel, wav) segments from a list of (mel, wav) pairs.

    Upstream HiFi-GAN trains on random fixed-size crops; a fixed segment
    shape keeps one set of shapes on the device.
    """
    rng = np.random.default_rng(seed)
    n = len(wavs)
    shortest = min(mel.shape[0] for mel, _ in wavs)
    if shortest < seg_frames:
        raise ValueError(
            f"segment_frames={seg_frames} exceeds the shortest utterance "
            f"({shortest} mel frames) — lower --segment_frames or use longer audio")

    def sample():
        mels, segs = [], []
        for _ in range(batch_size):
            mel, wav = wavs[int(rng.integers(n))]
            max_off = mel.shape[0] - seg_frames
            off = int(rng.integers(max_off + 1)) if max_off > 0 else 0
            mels.append(mel[off : off + seg_frames])
            segs.append(wav[off * hop : (off + seg_frames) * hop])
        return {
            "mel": np.stack(mels).astype(np.float32),
            "wav": np.stack(segs).astype(np.float32),
        }

    return sample


def load_pairs(wav_paths, cfg, hop: int, n_fft: int, win_size: int, mel_dir: Optional[Path]) -> list:
    """(conditioning mel, wav) per path, cut to whole frames: the mel from
    ``<mel_dir>/<stem>.npy`` where a directory is given, else the 8 kHz
    log-mel of the wav."""
    from emojivoice_tpu_torch.data.audio_np import load_wav, mel_spectrogram_np

    pairs = []
    for path in wav_paths:
        wav, sr = load_wav(path)
        if sr != cfg.sampling_rate:
            raise ValueError(f"{path}: sample rate {sr} != {cfg.sampling_rate}")
        if mel_dir is not None:
            mel = np.load(mel_dir / f"{Path(path).stem}.npy").astype(np.float32)
            if mel.ndim != 2 or mel.shape[1] != cfg.num_mels:
                raise ValueError(
                    f"{path}: gen mel {mel.shape} is not (T, {cfg.num_mels}) "
                    f"channels-last (emojivoice-get-durations --gen_mels layout)")
            # a mel produced under another hop or preset (or cut at the get-durations mel bucket) would
            # pair time-misaligned conditioning with the real audio after the min() crop below: reject
            # it when the frame count is far from the wav's
            expect = len(wav) // hop
            if abs(mel.shape[0] - expect) > max(4, expect // 20):
                raise ValueError(
                    f"{mel_dir / (Path(path).stem + '.npy')}: {mel.shape[0]} frames vs "
                    f"~{expect} expected from {path} at hop {hop} — generated with a "
                    f"different hop/preset, or truncated at the get-durations mel bucket?")
        else:
            mel = mel_spectrogram_np(wav, n_fft, cfg.num_mels, sr, hop, win_size, 0.0, 8000.0)
        n = min(mel.shape[0], len(wav) // hop)
        pairs.append((mel[:n], wav[: n * hop]))
    return pairs


def run_vocoder_proof(out_dir: str, steps: int = 150, batch_size: int = 16, segment_frames: int = 32,
                      utts: int = 24, seed: int = 0, window: int = 10, lr: float = 2e-4, cfg=None,
                      n_fft: int = 1024, win_size: int = 1024, gen_ckpt: Optional[str] = None,
                      disc_ckpt: Optional[str] = None, log_every: int = 1, filelist: Optional[str] = None,
                      gen_mels_dir: Optional[str] = None, device="cuda", graphs: Optional[bool] = None) -> dict:
    import torch

    from emojivoice_tpu_torch.config import HiFiGANConfig
    from emojivoice_tpu_torch.data.audio_np import mel_spectrogram_np
    from emojivoice_tpu_torch.inference.cli import save_wav
    from emojivoice_tpu_torch.training.proof import make_dataset
    from emojivoice_tpu_torch.training.vocoder_train import create_vocoder_state, vocoder_train_step

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError('run_vocoder_proof: no CUDA device is available (pass device="cpu" to run on the CPU)')
    if cfg is None:
        cfg = HiFiGANConfig()  # flagship v1: 80 mels, x256 upsample, ~13.9M params
    hop = cfg.total_upsample  # conditioning-mel hop == generator upsampling
    window = max(1, min(window, steps // 2 if steps > 1 else 1))
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)

    # 1. corpus: --filelist trains on real recordings (wav-path-first rows, the training filelist
    # format); the default is the synthetic 22.05 kHz harmonic-stack corpus of the acoustic proof.
    # The last utterance is held out for the renders either way.
    if filelist:
        wav_paths = [row.split("|")[0] for row in Path(filelist).read_text().splitlines() if row.strip()]
        if len(wav_paths) < 2:
            raise ValueError(f"{filelist}: need >=2 utterances (one is held out)")
    else:
        train_fl, _ = make_dataset(out / "data", tuple(range(12)), n_utts=utts, seconds=2.0, seed=seed)
        wav_paths = [row.split("|")[0] for row in train_fl.read_text().splitlines()]
    # --gen_mels_dir: the generator learns to invert its own acoustic front end's output.  The mel-L1
    # target is unaffected: the train step recomputes it from the real wav at full band.
    mel_dir = Path(gen_mels_dir) if gen_mels_dir else None
    pairs = load_pairs(wav_paths, cfg, hop, n_fft, win_size, mel_dir)
    held_out = pairs.pop()
    sample = make_segment_sampler(pairs, segment_frames, hop, batch_size, seed)

    # 2. state (weight-norm parameterization).  gen_ckpt / disc_ckpt warm-start from upstream torch
    # checkpoints (g_* generator and do_* discriminator files): the real fine-tune; None trains from
    # scratch (the proof).
    gen_state = disc_state = None
    if gen_ckpt:
        from emojivoice_tpu_torch.io.torch_ckpt import load_hifigan

        gen_state = load_hifigan(gen_ckpt, fold=False)
    if disc_ckpt:
        from emojivoice_tpu_torch.io.torch_ckpt import load_hifigan_discriminators

        disc_state = load_hifigan_discriminators(disc_ckpt)
    state = create_vocoder_state(cfg, lr=lr, seed=seed, weight_norm=True, gen_state=gen_state,
                                 disc_state=disc_state, device=device)

    # held-out render at a bounded frame count, through the folded generator's serving forward
    render_frames = min(held_out[0].shape[0], 160)
    render_mel = torch.from_numpy(held_out[0][None, :render_frames]).to(device)

    def render():
        return state.gen.fold_weight_norm()(render_mel)[0].cpu().numpy()

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    before = render()
    save_wav(str(out / "before.wav"), before, sr=cfg.sampling_rate)

    # 3. the loop
    metrics_path = out / "metrics.jsonl"
    records = []
    t0 = None
    with metrics_path.open("w") as fh:
        for i in range(steps):
            batch = {k: torch.from_numpy(v).to(device, non_blocking=True) for k, v in sample().items()}
            m = vocoder_train_step(state, batch, graphs=graphs)
            # the metrics are read only at the log cadence: a read makes the host wait for the device
            if (i + 1) % log_every == 0 or i == steps - 1:
                m = {k: float(v) for k, v in m.items()}
                m["step"] = i + 1
                m["time"] = dt.datetime.now().isoformat()
                fh.write(json.dumps(m) + "\n")
                records.append(m)
            if i == 0:
                sync()
                t0 = dt.datetime.now()  # the first step (autotuning, allocator warm-up) is left out of the rate

    sync()
    span = (dt.datetime.now() - t0).total_seconds() if steps > 1 else float("nan")

    after = render()
    save_wav(str(out / "after.wav"), after, sr=cfg.sampling_rate)
    assert np.isfinite(after).all()
    # the trained generator as an upstream-format dump (weight norm kept), which ``load_hifigan`` folds for
    # serving (``SynthesisPipeline.from_checkpoint(..., vocoder_ckpt=...)``) or keeps for more training
    gen_file = out / f"g_{steps:08d}"
    torch.save({"generator": {k: v.detach().cpu() for k, v in state.gen.state_dict().items()}}, gen_file)

    # 4. windowed trend asserts: mel-L1 must drop; losses stay finite.  The window is in RECORDS, not
    # steps: with log_every > 1 there are only steps // log_every records, so it is clamped again here,
    # or the first and last windows could overlap fully and the assert would compare a slice to itself.
    mel_l1 = [r["mel_l1"] for r in records]
    window = max(1, min(window, len(mel_l1) // 2 if len(mel_l1) > 1 else 1))
    first = float(np.mean(mel_l1[:window]))
    last = float(np.mean(mel_l1[-window:]))
    assert last < first, f"mel L1 did not decrease: first={first:.4f} last={last:.4f}"
    for k in ("d_loss", "g_loss", "fm_loss", "adv_loss"):
        assert all(np.isfinite(r[k]) for r in records), k

    # held-out mel-L1 of the render, before and after.  The target is the real wav's mel (the
    # conditioning mel itself in the default mode; under --gen_mels_dir the conditioning is the acoustic
    # model's output and the real wav stays the thing to match).
    target_mel = mel_spectrogram_np(held_out[1], n_fft, cfg.num_mels, cfg.sampling_rate, hop, win_size, 0.0, 8000.0)

    def render_mel_l1(wav):
        m = mel_spectrogram_np(wav.astype(np.float32), n_fft, cfg.num_mels, cfg.sampling_rate, hop, win_size, 0.0,
                               8000.0)
        n = min(m.shape[0], render_frames, target_mel.shape[0])
        return float(np.mean(np.abs(m[:n] - target_mel[:n])))

    summary = {
        "steps": steps, "batch_size": batch_size,
        "segment_samples": segment_frames * hop,
        "mel_l1_first_mean": round(first, 4), "mel_l1_last_mean": round(last, 4),
        "d_loss_last": round(records[-1]["d_loss"], 4),
        "g_loss_last": round(records[-1]["g_loss"], 4),
        "fm_loss_last": round(records[-1]["fm_loss"], 4),
        "adv_loss_last": round(records[-1]["adv_loss"], 4),
        "heldout_mel_l1_before": round(render_mel_l1(before), 4),
        "heldout_mel_l1_after": round(render_mel_l1(after), 4),
        "steps_per_sec_after_first": round((steps - 1) / span, 3) if steps > 1 else None,
        "backend": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "weight_norm": True,
        "data": "filelist" if filelist else "synthetic",
        "fine_tuning": mel_dir is not None,
        "generator_ckpt": gen_file.name,
    }
    (out / "summary.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    return summary


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="emojivoice-vocoder-proof-torch")
    p.add_argument("--out_dir", default="vocoder_proof_out")
    p.add_argument("--device", default="cuda", help="cuda (default; fails without a card) | cuda:N | cpu")
    p.add_argument("--steps", type=int, default=150)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--segment_frames", type=int, default=32)
    p.add_argument("--utts", type=int, default=24)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--gen_ckpt", default=None, help="warm-start generator from an upstream g_* torch ckpt")
    p.add_argument("--disc_ckpt", default=None, help="warm-start MPD+MSD from an upstream do_* torch ckpt")
    p.add_argument("--log_every", type=int, default=1,
                   help="metric cadence; >1 lets the host run ahead of the device (a read of the metrics "
                        "waits for the step)")
    p.add_argument("--filelist", default=None,
                   help="train on real recordings (wav-path-first '|' rows, the training filelist format) "
                        "instead of the synthetic corpus; the last utterance is held out")
    p.add_argument("--gen_mels_dir", default=None,
                   help="HiFi-GAN fine-tuning: condition on the acoustic model's teacher-forced mels "
                        "(<stem>.npy from get_durations --gen_mels) instead of ground-truth mels")
    p.add_argument("--eager", action="store_true",
                   help="run each GAN step op by op (vocoder_train_step(graphs=False)) instead of through its "
                        "captured CUDA graph, the card's default")
    a = p.parse_args(argv)
    run_vocoder_proof(a.out_dir, steps=a.steps, batch_size=a.batch_size, segment_frames=a.segment_frames,
                      utts=a.utts, seed=a.seed, lr=a.lr, gen_ckpt=a.gen_ckpt, disc_ckpt=a.disc_ckpt,
                      log_every=a.log_every, filelist=a.filelist, gen_mels_dir=a.gen_mels_dir, device=a.device,
                      graphs=False if a.eager else None)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
