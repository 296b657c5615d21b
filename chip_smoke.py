"""Drive the PyTorch port's two paths once on one NVIDIA GPU: synthesis
(text → pcm16) and acoustic-model training.

    python3 chip_smoke.py

Phases (each one failing fails the run, exit code ≠ 0):
  1. build  — compile K1 (csrc/mrf.cu) and K2 (csrc/mas.cu) with nvcc for
     sm_90a from this checkout, both at once;
  2. kernel, K1 — first one convolution of K1 alone (``ops.mrf.conv_taps``:
     the hand-written wgmma TF32 product with the 3xTF32 split) on one
     64-frame tile against ``torch.matmul`` in float64; then the stage against
     its plain twin ``mrf_stage_reference`` at the four HiFi-GAN v1 stage
     shapes of a 512-frame utterance (C = 256, 128, 64, 32 at T = 8, 64, 128,
     256 × 512) at B = 1, one B = 8 case, and two ragged shapes (B = 3, C = 40
     and 20, T no multiple of 64), within atol = rtol = 2e-4 with TF32 off for
     the twin; times both with CUDA events, in turns plain, K1, K1, plain
     (median of 10 runs each), K1 on weights packed outside the timed region
     as the vocoder packs them once per model;
  3. synthesis — ``SynthesisPipeline.from_random(emoji_multi, seed=0)`` on the
     card answers three requests with 10 Euler steps, the denoiser at 0.00025
     and pcm16: (a) the bench headline text, speaker 79, two-stage; (b) the
     same text fused at its mel bucket; (c) the 11 emoji voices in one padded
     two-stage call, once to warm and once counted.  Every wav must be
     finite, in [-1, 1] and mel_length·256 long, and every request must
     launch K1 on all four stages.  A short request is also held against the
     same weights and noise on the CPU;
  4. kernel, K2 — ``maximum_path`` against ``maximum_path_reference`` on the
     same tensors, equal to the bit, on seeded random log-priors with ragged
     lengths at (B, T_x, T_y) = (16, 256, 768), (32, 128, 512), (1, 64, 128),
     (8, 100, 333) with rows of t_x = 1, t_x = t_y and t_y far below T_y,
     (4, 512, 2048), (2, 1000, 1100), (3, 33, 120), and (2, 1500, 1600) whose
     decision bits go through the global scratch buffer; every path is
     checked for its properties; both timed like K1;
  5. training — a synthetic alignable corpus (the 11 emoji speakers, long
     texts, 32 utterances) is written to a temporary folder and
     ``emojivoice_tpu_torch.training.train.main`` is called as a user would,
     at emoji_multi width and batch 16: 20 steps on one overfit batch with a
     validation pass, a probe and a checkpoint every 10, then 4 more after
     ``--resume``.  Losses and gradient norms must be finite, K2 must launch
     once per train step, validation batch and probe and no more, the
     resumed run must go from step 20 to 24, and the eval step's
     ``dur_loss + prior_loss`` on the overfit batch must be lower after the
     20 steps than before.  K2 is held against its plain version on the
     batch's own log-prior, one step is timed by stage, and a four-row train
     step on the card (K2) is held against the CPU (plain MAS on the same
     log-prior).

The last line is ``{"ok": true, "device": {...}}``; the line before it is
``nvidia-smi``'s card name and power limit, and the one before that the
kernel record, whose ``bound_ms`` is the larger of bytes over 3.35 TB/s and
operations over the peak of the unit that does them, for the inputs of this
run: K1's three TF32 products per f32 product at 495 TFLOP/s (the earlier
SIMT design's bound at 67 TFLOP/s and a one-product TF32 kernel's stay beside
it), K2's two f32 operations per cell at 67 TFLOP/s.  There is no CPU path:
without a CUDA device it exits 1.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

DEVICE, PRESET = "cuda", "emoji_multi"
TOL = 2e-4  # the bound tests/test_pallas_mrf.py holds the Pallas kernel to
KERNELS = (3, 7, 11)
DILATIONS = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
MEL = 512
STAGE_SHAPES = [(1, 256, 8 * MEL), (1, 128, 64 * MEL), (1, 64, 128 * MEL), (1, 32, 256 * MEL)]
BATCH_SHAPE = (8, 128, 64 * MEL)
RAGGED_SHAPES = [(3, 40, 333), (3, 20, 1001)]  # C no multiple of 8 or 32, T no multiple of 64
HEADLINE = ("The quick brown fox jumped over the lazy dog, and everyone at the "
            "party cheered loudly for the brave little robot.")  # bench.py's headline text
TEXT11 = "Hey there! I am an emoji voice."
STEPS, STRENGTH = 10, 0.00025
# H100 SXM: device memory rate, f32 peak outside the tensor cores, and the TF32 tensor-core peak K1 multiplies at
HBM_BYTES_PER_S, F32_FLOPS, TF32_FLOPS = 3.35e12, 67e12, 495e12
MAS_SHAPES = [(16, 256, 768), (32, 128, 512), (1, 64, 128), (8, 100, 333), (4, 512, 2048), (2, 1000, 1100),
              (3, 33, 120), (2, 1500, 1600)]
TRAIN_BATCH, TRAIN_STEPS, RESUME_STEPS, EVERY = 16, 20, 24, 10


def cuda_ms(fn, iters: int = 5, warmup: int = 1) -> list:
    """Device milliseconds of `iters` runs of fn(), by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def abba_ms(plain, kernel):
    """Median ms of each, timed in turns plain, kernel, kernel, plain."""
    p, k = cuda_ms(plain), cuda_ms(kernel)
    k += cuda_ms(kernel)
    p += cuda_ms(plain)
    return statistics.median(p), statistics.median(k)


def random_stage(b: int, c: int, t: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, t, c), generator=g)
    # HiFi-GAN's init_weights draws conv weights from N(0, 0.01)
    weights = [tuple(torch.randn(shape, generator=g) * 0.01
                     for shape in ((3, k, c, c), (3, c), (3, k, c, c), (3, c)))
               for k in KERNELS]
    return x.cuda(), [tuple(w.cuda() for w in rb) for rb in weights]


def tile_check(mrf) -> float:
    """K1's tensor-core product alone: one convolution with k = 1 on one
    64-frame tile (positive x, so the lrelu is the identity) is x @ w + bias;
    held against float64 at the accuracy of an f32 sum, which one TF32
    product (~1e-3 relative per operand) would miss by two orders."""
    worst = 0.0
    for c in (64, 256):
        g = torch.Generator().manual_seed(c)
        x = (torch.rand((1, 64, c), generator=g) + 0.1).cuda()
        w = (torch.randn((1, c, c), generator=g) * 0.1).cuda()
        bias = torch.randn((c,), generator=g).cuda()
        got = mrf.conv_taps(x, w, bias)
        torch.cuda.synchronize()
        ref = torch.matmul(x[0].double(), w[0].double()) + bias.double()
        rel = float((got[0].double() - ref).abs().max() / ref.abs().max())
        print(f"[kernel] K1 one tile, 64 x {c} x {c}, 3xTF32 wgmma against float64 matmul: max error "
              f"{rel:.3e} of the largest output")
        if not rel < 1e-5:
            raise RuntimeError(f"K1's tensor-core product is off by {rel:.3e} at C={c}")
        worst = max(worst, rel)
    return worst


def phase_kernel(mrf) -> list:
    rows = []
    for i, (b, c, t) in enumerate(STAGE_SHAPES + [BATCH_SHAPE] + RAGGED_SHAPES):
        x, w = random_stage(b, c, t, seed=i)
        got = mrf.mrf_stage(x, w, KERNELS, DILATIONS)  # contract weights: packed on the fly
        ref = mrf.mrf_stage_reference(x, w, KERNELS, DILATIONS)
        packed = mrf.pack_weights(w)  # once, outside the timed region, as HiFiGANGenerator.stage_weights does
        same_bits = torch.equal(got, mrf.mrf_stage(x, packed, KERNELS, DILATIONS))
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        ok = bool(torch.isfinite(got).all()) and torch.allclose(got, ref, atol=TOL, rtol=TOL) and same_bits
        plain_ms, k1_ms = abba_ms(lambda: mrf.mrf_stage_reference(x, w, KERNELS, DILATIONS),
                                  lambda: mrf.mrf_stage(x, packed, KERNELS, DILATIONS))
        gflop = 2 * sum(2 * len(d) * k for k, d in zip(KERNELS, DILATIONS)) * c * c * t * b / 1e9
        # least time for the stage: x read and out written once, the 36 conv weights and biases read once
        nbytes = 4 * (2 * x.numel() + sum(p.numel() for rb in w for p in rb))
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        split_ms = 3 * gflop * 1e9 / TF32_FLOPS * 1e3  # three TF32 products per f32 product
        rows.append(dict(B=b, C=c, T=t, max_abs_err=err, ok=ok, ms=k1_ms, plain_ms=plain_ms,
                         gflop=gflop, k1_tflops=gflop / k1_ms, plain_tflops=gflop / plain_ms,
                         bound_ms=max(split_ms, bytes_ms), bound_by="operations" if split_ms >= bytes_ms else "bytes",
                         bytes_ms=bytes_ms, bound_simt_ms=max(gflop * 1e9 / F32_FLOPS * 1e3, bytes_ms),
                         bound_tf32_ms=max(gflop * 1e9 / TF32_FLOPS * 1e3, bytes_ms)))
        print(f"[kernel] B={b} C={c:3d} T={t:6d}  max_abs_err={err:.3e}  K1 {k1_ms:9.3f} ms "
              f"({gflop / k1_ms:6.2f} TFLOP/s of f32 work)  plain {plain_ms:9.3f} ms ({gflop / plain_ms:6.2f} TFLOP/s)  "
              f"bound {rows[-1]['bound_ms']:.3f} ms by {rows[-1]['bound_by']} (3 TF32 products at 495 TFLOP/s; bytes "
              f"alone {bytes_ms:.4f} ms; the SIMT design's {rows[-1]['bound_simt_ms']:.3f} ms; one TF32 product "
              f"{rows[-1]['bound_tf32_ms']:.3f} ms)  packed = contract bits: {same_bits}  {'ok' if ok else 'MISMATCH'}")
        del x, w, got, ref, packed
    return rows


def check_wavs(results, name: str) -> None:
    for i, r in enumerate(results):
        if r.wav.shape != (r.mel_length * 256,):
            raise RuntimeError(f"{name} row {i}: wav shape {r.wav.shape} != ({r.mel_length} * 256,)")
        if not (r.wav.size and torch.isfinite(torch.from_numpy(r.wav)).all()):
            raise RuntimeError(f"{name} row {i}: empty or non-finite wav")
        if float(abs(r.wav).max()) > 1.0:
            raise RuntimeError(f"{name} row {i}: wav outside [-1, 1]")


def cpu_reference_check(pipe) -> dict:
    """A short request on the card (K1) against the same weights and noise
    on the CPU (plain twin): mel lengths equal, mel MAE and wav max error small."""
    from emojivoice_tpu_torch.utils.buckets import pick_bucket
    from emojivoice_tpu_torch.utils.masks import fix_len_compatibility
    from emojivoice_tpu_torch.vocoder.denoiser import Denoiser

    x, xl, _, _ = pipe.encode_texts(["Hello there, robot."])
    spk = torch.tensor([79])
    model_cpu, vocoder_cpu = copy.deepcopy(pipe.model).cpu(), copy.deepcopy(pipe.vocoder).cpu()
    denoiser_cpu = Denoiser(vocoder_cpu, num_mels=pipe.model_cfg.n_feats)
    enc = model_cpu.encode_text(torch.from_numpy(x), torch.from_numpy(xl), spk)
    m_bucket = pick_bucket(fix_len_compatibility(int(enc[2].max())), pipe.mel_buckets)
    z = torch.randn((1, m_bucket, pipe.model_cfg.n_feats), generator=torch.Generator().manual_seed(5)) * 0.667
    ref = model_cpu.decode_mel(*enc, m_bucket, STEPS, z)
    ref_wav = denoiser_cpu(vocoder_cpu(ref["mel"]), STRENGTH)

    dev = pipe.model.synthesise(torch.from_numpy(x).cuda(), torch.from_numpy(xl).cuda(), m_bucket, STEPS,
                                z.cuda(), spk.cuda())
    wav = pipe.denoiser(pipe.vocoder(dev["mel"]), STRENGTH).cpu()
    ml = int(ref["mel_lengths"][0])
    out = dict(mel_length=ml, same_lengths=bool(torch.equal(dev["mel_lengths"].cpu(), ref["mel_lengths"])),
               mel_mae=float((dev["mel"].cpu()[0, :ml] - ref["mel"][0, :ml]).abs().mean()),
               wav_max_abs_err=float((wav - ref_wav).abs().max()))
    print(f"[synth] card vs CPU on the same weights and noise: {out}")
    if not (out["same_lengths"] and out["mel_mae"] < 1e-3 and out["wav_max_abs_err"] < 1e-3):
        raise RuntimeError(f"card and CPU disagree: {out}")
    return out


def phase_synthesis(mrf) -> int:
    from emojivoice_tpu_torch import config
    from emojivoice_tpu_torch.apps.emoji import EMOJI_MAPPING
    from emojivoice_tpu_torch.inference.pipeline import SynthesisPipeline
    from emojivoice_tpu_torch.utils.buckets import pick_bucket

    t = time.perf_counter()
    pipe = SynthesisPipeline.from_random(config.get_preset("emoji_multi"), seed=0, device="cuda",
                                         cleaners=("basic_cleaners",))
    print(f"[synth] emoji_multi + HiFi-GAN v1, random weights (seed 0), built in "
          f"{time.perf_counter() - t:.2f} s")
    cpu_reference_check(pipe)

    kw = dict(n_timesteps=STEPS, denoiser_strength=STRENGTH, keep_mel=False, pcm16=True)
    emoji_spks = list(EMOJI_MAPPING.values())

    def request(tag, name, texts, spks, seed, **extra):
        before = dict(mrf.launches)
        t = time.perf_counter()
        results = pipe.synthesise(texts, spks=spks, seed=seed, **kw, **extra)
        wall_ms = (time.perf_counter() - t) * 1e3
        delta = {c: mrf.launches[c] - before.get(c, 0) for c in (256, 128, 64, 32)}
        if any(n != 1 for n in delta.values()) or sum(mrf.launches.values()) - sum(before.values()) != 4:
            raise RuntimeError(f"{name}: K1 launches per stage width {delta}, expected one on each of four")
        check_wavs(results, name)
        print(f"[{tag}] {name}: batch {len(results)}  mel_lengths {[r.mel_length for r in results]}  "
              f"wall {wall_ms:.3f} ms  rtf_w {results[0].rtf_w:.5f}  stage ms "
              + " ".join(f"{k}={v:.3f}" for k, v in results[0].stage_ms.items()) + f"  K1 launches {delta}")
        return results

    def serve(tag):
        first = request(tag, "(a) headline two-stage", [HEADLINE], [79], 0)[0]
        request(tag, "(b) headline fused", [HEADLINE], [79], 0, fused=True,
                fused_mel_bucket=pick_bucket(first.mel_length, pipe.mel_buckets))
        request(tag, "(c) 11 emoji voices two-stage", [TEXT11] * len(emoji_spks), emoji_spks,
                list(range(len(emoji_spks))))

    serve("warm")  # first-call allocations and cuDNN/cuFFT plans for these shapes
    # the main path's run: counts start at zero here and only these requests move them
    mrf.launches.clear()
    serve("synth")
    return sum(mrf.launches.values())


def ragged_mas_problem(b: int, t_x: int, t_y: int, seed: int):
    """Seeded random log-prior with ragged lengths (t_x ≤ t_y); one item fills
    the bucket and, from four items on, rows have t_x = 1, t_x = t_y and
    t_y far below T_y."""
    g = torch.Generator().manual_seed(seed)
    value = torch.randn((b, t_x, t_y), generator=g) * 3.0
    t_ys = torch.randint(max(1, t_y // 2), t_y + 1, (b,), generator=g)
    t_xs = torch.minimum(torch.randint(max(1, t_x // 3), t_x + 1, (b,), generator=g), t_ys)
    t_ys[0], t_xs[0] = t_y, min(t_x, t_y)
    if b >= 4:
        t_xs[1] = 1
        t_xs[2] = t_ys[2] = min(t_x, t_y) // 2
        t_ys[3], t_xs[3] = max(2, t_y // 20), 2
    mask = ((torch.arange(t_x)[None, :, None] < t_xs[:, None, None])
            & (torch.arange(t_y)[None, None, :] < t_ys[:, None, None])).float()
    return value.to(DEVICE), mask.to(DEVICE)


def mas_row(mas, value, mask, tag: str) -> dict:
    """K2 against its plain version on (value, mask): equality, the path's
    properties, both times, and the least time the card could take."""
    got = mas.maximum_path(value, mask)
    ref = mas.maximum_path_reference(value, mask)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    faults = mas.path_faults(got, mask)
    ok = torch.equal(got, ref) and not faults
    plain_ms, k2_ms = abba_ms(lambda: mas.maximum_path_reference(value, mask),
                              lambda: mas.maximum_path(value, mask))
    b, t_x, t_y = value.shape
    # value and mask read once, path written once; one add and one max per cell
    bytes_ms = 3 * value.numel() * 4 / HBM_BYTES_PER_S * 1e3
    flops_ms = 2 * value.numel() / F32_FLOPS * 1e3
    steps = int(mask[:, 0, :].sum(-1).max())  # the longest item's dependent chain, each way
    row = dict(B=b, T_x=t_x, T_y=t_y, max_abs_err=err, exact=ok, ms=k2_ms, plain_ms=plain_ms,
               bound_ms=max(bytes_ms, flops_ms), bound_by="bytes" if bytes_ms >= flops_ms else "operations",
               chain_steps=steps, us_per_step=k2_ms * 1e3 / (2 * steps))
    print(f"[{tag}] B={b:2d} T_x={t_x:4d} T_y={t_y:4d}  max_abs_err={err:.1f}  K2 {k2_ms:8.4f} ms  "
          f"plain {plain_ms:9.3f} ms  bound {row['bound_ms']:.4f} ms by {row['bound_by']}  "
          f"chain {steps} steps each way, {row['us_per_step']:.4f} us/step  "
          f"{'equal' if ok else 'MISMATCH ' + '; '.join(faults[:3])}")
    return row


def phase_kernel_mas(mas) -> list:
    rows = [mas_row(mas, *ragged_mas_problem(b, t_x, t_y, seed=i), tag="kernel") for i, (b, t_x, t_y)
            in enumerate(MAS_SHAPES)]
    if not all(r["exact"] for r in rows):
        raise RuntimeError("K2 disagrees with its plain version")
    return rows


def read_metrics(out_dir: Path, tag: str) -> list:
    lines = (out_dir / "metrics.jsonl").read_text().splitlines()
    return [r for r in map(json.loads, lines) if r["tag"] == tag]


def phase_training(mas) -> dict:
    from emojivoice_tpu_torch import config
    from emojivoice_tpu_torch.apps.emoji import EMOJI_MAPPING
    from emojivoice_tpu_torch.data.dataset import BucketBatcher, TextMelDataset
    from emojivoice_tpu_torch.io.checkpoint import CheckpointManager
    from emojivoice_tpu_torch.models import matcha
    from emojivoice_tpu_torch.training import train
    from emojivoice_tpu_torch.training.state import batch_to_device, create_train_state, eval_step, train_step
    from emojivoice_tpu_torch.training.synthetic import make_alignable_dataset
    from emojivoice_tpu_torch.utils.timing import StageClock

    seed = 1234
    with tempfile.TemporaryDirectory(prefix="emojivoice_smoke_") as tmp:
        tmp = Path(tmp)
        t = time.perf_counter()
        train_list, val_list, stats = make_alignable_dataset(tmp / "corpus", list(EMOJI_MAPPING.values()),
                                                             n_utts=2 * TRAIN_BATCH, seed=0, long_texts=True)
        print(f"[train] synthetic corpus in {time.perf_counter() - t:.2f} s: {stats}")
        out = tmp / "run"
        args = ["--preset", PRESET, "--device", DEVICE, "--train_filelist", str(train_list),
                "--valid_filelist", str(val_list), "--out_dir", str(out), "--batch_size", str(TRAIN_BATCH),
                "--overfit_batches", "1", "--val_every_steps", str(EVERY), "--probe_every", str(EVERY),
                "--ckpt_every_steps", str(EVERY), "--log_every", "1", "--seed", str(seed)]

        # the overfit batch and the step-0 weights, as the trainer makes them from the seed
        root = config.get_preset(PRESET)
        data_cfg = dataclasses.replace(root.data, train_filelist_path=str(train_list),
                                       valid_filelist_path=str(val_list), batch_size=TRAIN_BATCH, seed=seed)
        batch_np = next(iter(BucketBatcher(TextMelDataset(str(train_list), data_cfg), TRAIN_BATCH, seed=seed)))
        batch = batch_to_device(batch_np, DEVICE)
        state = create_train_state(root.model, root.optimizer, seed=seed, device=DEVICE)
        before = {k: float(v) for k, v in eval_step(state.model, batch).items()}

        # the main path's run: K2's count starts at zero here and only the trainer moves it
        mas.launches = 0
        t = time.perf_counter()
        if train.main(args + ["--max_steps", str(TRAIN_STEPS)]) != 0:
            raise RuntimeError("training run failed")
        first_s = time.perf_counter() - t
        first_launches = mas.launches
        if train.main(args + ["--max_steps", str(RESUME_STEPS), "--resume"]) != 0:
            raise RuntimeError("resumed training run failed")
        launches = mas.launches

        steps = read_metrics(out, "train")
        vals, probes = read_metrics(out, "val"), read_metrics(out, "probe")
        if [r["step"] for r in steps] != list(range(1, RESUME_STEPS + 1)):
            raise RuntimeError(f"logged steps {[r['step'] for r in steps]}: the resumed run must go from "
                               f"{TRAIN_STEPS} to {RESUME_STEPS}")
        for r in steps:
            bad = [k for k in ("loss", "dur_loss", "prior_loss", "diff_loss", "grad_norm") if not
                   (r[k] == r[k] and abs(r[k]) != float("inf"))]
            if bad or not r["grad_norm"] > 0:
                raise RuntimeError(f"step {r['step']}: non-finite {bad} or grad_norm {r['grad_norm']} not above 0")
        # one val batch per pass (the val list has two utterances), one probe per record
        expect_first = TRAIN_STEPS + TRAIN_STEPS // EVERY + (1 + TRAIN_STEPS // EVERY)
        expect = expect_first + (RESUME_STEPS - TRAIN_STEPS)
        if (first_launches, launches) != (expect_first, expect) or len(vals) != TRAIN_STEPS // EVERY \
                or len(probes) != 1 + TRAIN_STEPS // EVERY:
            raise RuntimeError(f"K2 launches {first_launches} then {launches}, expected {expect_first} then "
                               f"{expect} (steps + {len(vals)} val batches + {len(probes)} probes)")
        mgr = CheckpointManager(str(out / "ckpts"))
        if mgr.all_steps() != [EVERY, TRAIN_STEPS, RESUME_STEPS]:
            raise RuntimeError(f"checkpoints at {mgr.all_steps()}")
        state.load_state_dict(mgr.restore(TRAIN_STEPS, map_location=DEVICE))
        after = {k: float(v) for k, v in eval_step(state.model, batch).items()}

        def aligned(m):
            return m["dur_loss"] + m["prior_loss"]

        print(f"[train] {PRESET} batch {TRAIN_BATCH} x {tuple(batch['x'].shape[1:])} text x "
              f"{tuple(batch['y'].shape[1:])} mel: {TRAIN_STEPS} steps in {first_s:.2f} s with data, 2 val passes, "
              f"3 probes and 2 checkpoints; loss {steps[0]['loss']:.4f} -> {steps[TRAIN_STEPS - 1]['loss']:.4f}; "
              f"eval on the overfit batch before {before} after {after}; probe diagonality "
              f"{[round(p['diagonality'], 4) for p in probes]}; K2 launches {launches}")
        if not aligned(after) < aligned(before):
            raise RuntimeError(f"dur_loss + prior_loss on the overfit batch did not fall: {aligned(before)} -> "
                               f"{aligned(after)}")

        # K2 on the main path's own log-prior, against its plain version
        captured = {}
        real = matcha.maximum_path

        def capture(value, mask):
            captured["value"], captured["mask"] = value, mask
            return real(value, mask)
        matcha.maximum_path = capture
        try:
            eval_step(state.model, batch)
        finally:
            matcha.maximum_path = real
        path_row = mas_row(mas, captured["value"], captured["mask"], tag="train")
        if not path_row["exact"]:
            raise RuntimeError("K2 disagrees with its plain version on the training batch's log-prior")

        # one step by stage (CUDA events), MAS timed inside the forward; then steps per second
        mas_events = []

        def timed(value, mask):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            path = real(value, mask)
            end.record()
            mas_events.append((start, end))
            return path
        state.load_state_dict(mgr.restore(RESUME_STEPS, map_location=DEVICE))
        stage_ms = []
        matcha.maximum_path = timed
        try:
            for _ in range(2 + 5):  # two to warm
                clock = StageClock(torch.device(DEVICE))
                train_step(state, batch, seed, clock=clock)
                torch.cuda.synchronize()
                stage_ms.append(clock.elapsed_ms())
        finally:
            matcha.maximum_path = real
        med = {k: statistics.median(m[k] for m in stage_ms[2:]) for k in stage_ms[0]}
        med["mas"] = statistics.median(a.elapsed_time(b) for a, b in mas_events[2:])
        n = 10
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            train_step(state, batch, seed)
        torch.cuda.synchronize()
        steps_per_s = n / (time.perf_counter() - t)
        print("[train] step " + json.dumps({"steps_per_s": steps_per_s, "forward_ms": med["forward"],
                                             "mas_ms": med["mas"], "backward_ms": med["backward"],
                                             "optimizer_ms": med["optimizer"], "batch": TRAIN_BATCH,
                                             "t_text": batch["x"].shape[1], "t_mel": batch["y"].shape[1],
                                             "peak_gb": torch.cuda.max_memory_allocated() / 1e9}))

        card_vs_cpu(matcha, state, batch, mas)
    return dict(launches=launches, row=path_row)


def card_vs_cpu(matcha, state, batch, mas) -> None:
    """One train step (forward, loss, backward) on four rows of the batch from
    the same weights, t and z, dropout off: the card (K2) against the CPU
    (plain MAS).

    The two devices round the log-prior differently (about 1e-5 on values
    near −100), and over a thousand mel frames some decisions of the search
    are nearer than that, so the CPU's own path may differ from the card's in
    a few frames.  The check therefore gives the CPU's plain MAS the card's
    log-prior: its path must equal K2's to the bit, and with that path the
    CPU's losses must agree within rtol 1e-4 and the gradient norm within
    1e-3 (f32 summation order).  How far the CPU's own log-prior and path
    lie from the card's is printed beside it."""
    rows = {k: v[:4] for k, v in batch.items()}
    g = torch.Generator().manual_seed(11)
    t = torch.rand((4, 1, 1), generator=g)
    z = torch.randn(rows["y"].shape, generator=g)
    model_cpu = copy.deepcopy(state.model).cpu().eval()
    state.model.eval()
    seen = {}
    real = matcha.maximum_path

    def on_card(value, mask):
        seen["value"], seen["path"] = value.cpu(), real(value, mask)
        return seen["path"]

    def on_cpu(value, mask):
        path = mas.maximum_path_reference(seen["value"], mask)
        own = mas.maximum_path_reference(value, mask)
        seen["plain_equal"] = torch.equal(path, seen["path"].cpu())
        seen["logp_err"] = float((value - seen["value"]).abs().max())
        seen["own_frames_differ"] = int((own != path).any(1).sum())
        seen["frames"] = int(mask[:, 0, :].sum())
        return path

    def step(model, dev, search):
        b = {k: v.to(dev) for k, v in rows.items()}
        model.zero_grad(set_to_none=True)
        matcha.maximum_path = search
        try:
            dur, prior, diff, _ = model(b["x"], b["x_lengths"], b["y"], b["y_lengths"], b["spks"],
                                        t=t.to(dev), z=z.to(dev))
        finally:
            matcha.maximum_path = real
        (dur + prior + diff).backward()
        sq = sum(float(p.grad.double().pow(2).sum()) for p in model.parameters() if p.grad is not None)
        return [float(v.detach()) for v in (dur, prior, diff)], sq ** 0.5
    before = mas.launches
    card, card_norm = step(state.model, DEVICE, on_card)
    if mas.launches != before + 1:
        raise RuntimeError("the card's train step did not launch K2")
    cpu, cpu_norm = step(model_cpu, "cpu", on_cpu)
    state.model.train()
    rel = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    print(f"[train] card vs CPU, 4 rows, same weights and draws: plain MAS on the CPU equals K2 on the card's "
          f"log-prior: {seen['plain_equal']}; losses card {card} cpu {cpu} (max rel {rel:.2e}); grad norm card "
          f"{card_norm:.6f} cpu {cpu_norm:.6f}; the CPU's own log-prior differs by at most {seen['logp_err']:.2e} "
          f"and its own path in {seen['own_frames_differ']} of {seen['frames']} frames")
    if not (seen["plain_equal"] and rel < 1e-4 and abs(card_norm - cpu_norm) / cpu_norm < 1e-3):
        raise RuntimeError("card and CPU train steps disagree")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[env] python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}  "
          f"device {torch.cuda.get_device_name(0)} ({smi})  cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32} cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    from emojivoice_tpu_torch.kernels.build import build_log, build_many, load_mas, load_mrf
    from emojivoice_tpu_torch.ops import mas, mrf

    t = time.perf_counter()
    build_many(("mrf", "mas"))
    load_mrf()
    load_mas()
    print(f"[build] K1 and K2 built (one nvcc each, together) and loaded in {time.perf_counter() - t:.2f} s")
    for name in ("mrf", "mas"):
        for line in build_log(name).splitlines():
            if "ptxas info" in line and ("registers" in line or "Compiling" in line):
                print(f"[build] {name}.cu: {line.strip()}")

    tile_err = tile_check(mrf)
    rows = phase_kernel(mrf)
    if not all(r["ok"] for r in rows):
        raise RuntimeError("K1 disagrees with its plain twin")
    launches = phase_synthesis(mrf)
    mas_rows = phase_kernel_mas(mas)
    training = phase_training(mas)

    stage_rows = rows[:len(STAGE_SHAPES)]
    k2, k2_sized = training["row"], mas_rows[0]
    print(json.dumps({"kernels": [{
        "name": "K1 mrf_resblock_f32 (HiFi-GAN MRF stage, wgmma 3xTF32)",
        "route": "cuda",
        "source": "emojivoice_tpu_torch/csrc/mrf.cu",
        "replaces": "emojivoice_tpu/ops/pallas_mrf.py:105",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": sum(r["ms"] for r in stage_rows),
        "plain_ms": sum(r["plain_ms"] for r in stage_rows),
        "bound_ms": sum(r["bound_ms"] for r in stage_rows),
        "bound_by": "operations" if all(r["bound_by"] == "operations" for r in stage_rows) else "bytes",
        "bound_ms_simt": sum(r["bound_simt_ms"] for r in stage_rows),  # the earlier f32 FMA design's bound
        "bound_ms_tf32": sum(r["bound_tf32_ms"] for r in stage_rows),  # what one TF32 product per tap could reach
        "library_ms": None,  # no single PyTorch call computes an MRF stage
        "shape": "the four stages of a 512-frame utterance, B = 1",
        "weights": "packed (K-major, split in two TF32 parts) once, outside the timed region",
        "tile_rel_err_vs_float64": tile_err,
    }, {
        "name": "K2 mas_path_f32 (monotonic alignment search)",
        "route": "cuda",
        "source": "emojivoice_tpu_torch/csrc/mas.cu",
        "replaces": "emojivoice_tpu/ops/mas_pallas.py:51",
        "launches": training["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in mas_rows + [k2]),
        "exact": all(r["exact"] for r in mas_rows + [k2]),
        "ms": k2["ms"],
        "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"],
        "library_ms": None,  # no PyTorch call computes MAS
        "shape": f"the training batch's log-prior, ({k2['B']}, {k2['T_x']}, {k2['T_y']})",
        "ms_16x256x768": k2_sized["ms"],
        "plain_ms_16x256x768": k2_sized["plain_ms"],
        "bound_ms_16x256x768": k2_sized["bound_ms"],
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
