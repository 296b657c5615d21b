"""Drive the PyTorch port's synthesis path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each one failing fails the run, exit code ≠ 0):
  1. build  — compile K1 (csrc/mrf.cu) with nvcc for sm_90a from this checkout;
  2. kernel — K1 against its plain twin ``mrf_stage_reference`` at the four
     HiFi-GAN v1 stage shapes of a 512-frame utterance (C = 256, 128, 64, 32
     at T = 8, 64, 128, 256 × 512) at B = 1, plus one B = 8 case, within
     atol = rtol = 2e-4 with TF32 off; times both with CUDA events, in turns
     plain, K1, K1, plain (median of 10 runs each);
  3. synthesis — ``SynthesisPipeline.from_random(emoji_multi, seed=0)`` on the
     card answers three requests with 10 Euler steps, the denoiser at 0.00025
     and pcm16: (a) the bench headline text, speaker 79, two-stage; (b) the
     same text fused at its mel bucket; (c) the 11 emoji voices in one padded
     two-stage call, once to warm and once counted.  Every wav must be
     finite, in [-1, 1] and mel_length·256 long, and every request must
     launch K1 on all four stages.  A short request is also held against the
     same weights and noise on the CPU.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
``nvidia-smi``'s card name and power limit, and the one before that the
kernel record.  There is no CPU path: without a CUDA device it exits 1.
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import time

import torch

TOL = 2e-4  # the bound tests/test_pallas_mrf.py holds the Pallas kernel to
KERNELS = (3, 7, 11)
DILATIONS = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
MEL = 512
STAGE_SHAPES = [(1, 256, 8 * MEL), (1, 128, 64 * MEL), (1, 64, 128 * MEL), (1, 32, 256 * MEL)]
BATCH_SHAPE = (8, 128, 64 * MEL)
HEADLINE = ("The quick brown fox jumped over the lazy dog, and everyone at the "
            "party cheered loudly for the brave little robot.")  # bench.py's headline text
TEXT11 = "Hey there! I am an emoji voice."
STEPS, STRENGTH = 10, 0.00025


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


def phase_kernel(mrf) -> list:
    rows = []
    for i, (b, c, t) in enumerate(STAGE_SHAPES + [BATCH_SHAPE]):
        x, w = random_stage(b, c, t, seed=i)
        got = mrf.mrf_stage(x, w, KERNELS, DILATIONS)
        ref = mrf.mrf_stage_reference(x, w, KERNELS, DILATIONS)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        ok = bool(torch.isfinite(got).all()) and torch.allclose(got, ref, atol=TOL, rtol=TOL)
        plain_ms, k1_ms = abba_ms(lambda: mrf.mrf_stage_reference(x, w, KERNELS, DILATIONS),
                                  lambda: mrf.mrf_stage(x, w, KERNELS, DILATIONS))
        gflop = 2 * sum(2 * len(d) * k for k, d in zip(KERNELS, DILATIONS)) * c * c * t * b / 1e9
        rows.append(dict(B=b, C=c, T=t, max_abs_err=err, ok=ok, ms=k1_ms, plain_ms=plain_ms,
                         gflop=gflop, k1_tflops=gflop / k1_ms, plain_tflops=gflop / plain_ms))
        print(f"[kernel] B={b} C={c:3d} T={t:6d}  max_abs_err={err:.3e}  K1 {k1_ms:9.3f} ms "
              f"({gflop / k1_ms:6.2f} TFLOP/s)  plain {plain_ms:9.3f} ms ({gflop / plain_ms:6.2f} TFLOP/s)  "
              f"{'ok' if ok else 'MISMATCH'}")
        del x, w, got, ref
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

    from emojivoice_tpu_torch.kernels.build import build_log, load_mrf
    from emojivoice_tpu_torch.ops import mrf

    t = time.perf_counter()
    load_mrf()
    print(f"[build] K1 built and loaded in {time.perf_counter() - t:.2f} s")
    for line in build_log("mrf").splitlines():
        if "ptxas info" in line and ("registers" in line or "Compiling" in line):
            print(f"[build] {line.strip()}")

    rows = phase_kernel(mrf)
    if not all(r["ok"] for r in rows):
        raise RuntimeError("K1 disagrees with its plain twin")
    launches = phase_synthesis(mrf)

    stage_rows = rows[:len(STAGE_SHAPES)]
    print(json.dumps({"kernels": [{
        "name": "K1 mrf_resblock_f32 (HiFi-GAN MRF stage)",
        "route": "cuda",
        "source": "emojivoice_tpu_torch/csrc/mrf.cu",
        "replaces": "emojivoice_tpu/ops/pallas_mrf.py:105",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": sum(r["ms"] for r in stage_rows),
        "plain_ms": sum(r["plain_ms"] for r in stage_rows),
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
