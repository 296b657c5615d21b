"""Drive the PyTorch port's paths once on one NVIDIA GPU: synthesis
(text → pcm16), acoustic-model training, the vocoder's fine-tune on the
acoustic model's own mels, and the serving front ends (batching engine,
streaming vocoder, long-form, CLI, webapp, and trained checkpoints served).

    python3 chip_smoke.py

Phases (each one failing fails the run, exit code ≠ 0):
  1. build  — compile K1 (csrc/mrf.cu) and K2 (csrc/mas.cu) with nvcc for
     sm_90a from this checkout, both at once;
  2. kernel, K1 — first one convolution of K1 alone (``ops.mrf.conv_taps``:
     the hand-written wgmma TF32 product with the 3xTF32 split) on one
     64-frame tile against ``torch.matmul`` in float64; then the stage against
     its plain twin ``mrf_stage_reference`` at the four HiFi-GAN v1 stage
     shapes of a 512-frame utterance (C = 256, 128, 64, 32 at T = 8, 64, 128,
     256 × 512) at B = 1, one B = 8 case, two ragged shapes (B = 3, C = 40
     and 20, T no multiple of 64), and the four stage shapes of one streaming
     window (80 mel frames: chunk 64 plus 8 of context a side), within atol = rtol = 2e-4 with TF32 off for
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
     log-prior).  Before the run's folder is removed,
     ``SynthesisPipeline.from_checkpoint`` serves the checkpoint directory the
     trainer wrote: one utterance on the card, K1 on all four stages;
  6. vocoder training — still inside the training run's folder: (a)
     ``get_durations.main`` on the run's ``ckpts/`` and filelist with
     ``--gen_mels``: K2 launches once per batch, every teacher-forced mel has
     as many frames as its durations sum to, and the first batch's path
     equals the plain search on the same log-prior to the bit; (b)
     ``run_vocoder_proof`` at HiFi-GAN v1 width with the full MPD + MSD,
     batch 16 × 32 frames (8,192 samples), conditioned on (a)'s mels, 60
     steps logged every 5: the harness's own assert wants the windowed
     mel-L1 lower at the end, and its two renders go through K1; (c) one GAN
     step of 4 rows on the card against the same step on the CPU from the
     same state (the generator that (b) trained, seeded discriminators) and
     batch, the five metrics within rtol 1e-3 (cuDNN against the CPU's convs,
     f32 both); (d) the step by stage with CUDA events,
     steps per second and peak memory at batch 16; (e) the generator that (b)
     wrote, folded, served beside the run's acoustic checkpoint: finite
     pcm16, K1 on all four stages, and K1's waveform within 2e-4 of the
     weight-norm generator's differentiable forward on the same mel;
  7. serving — on the emoji_multi pipeline of phase 3 (HiFi-GAN v1, 10 Euler
     steps, pcm16), every wait with a timeout: (a) ``BatchingEngine(pipe,
     max_batch=8, max_wait_ms=10)``, warmed, answers 32 requests from 8
     client threads (texts of 20-200 characters, the 11 emoji speakers,
     explicit seeds): all resolve, fewer batches than requests, four
     ``mrf_stage`` calls per vocoded batch and not one more; a text beyond
     the largest text bucket fails alone while its neighbours resolve; a
     seeded request inside a merged batch is held against the direct batch-1
     call, two same-seed rows of one batch are equal to the bit; the same 32
     requests are also served one by one; (b) of two back-to-back batches the
     first's results must arrive while the second still computes; (c) for a
     short reply, the headline text and a story, chunked streaming (chunk 64)
     at overlap 8 and at the vocoder's receptive field against the
     pipeline's own monolithic vocoding of the same mel, ms per chunk, and
     time to first audio of the full, stream and pipelined strategies; (d)
     ``cli.main`` writes a readable wav and npy, and ``webapp.serve`` with
     batching answers 8 concurrent ``POST /api/synthesise``, a ``POST
     /api/stream`` whose body is a WAV of the expected length, 400 for bad
     JSON and an unknown language, and ``/health`` with the engine's stats.

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
import math
import random
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
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
WINDOW = 80  # mel frames of one streaming window: chunk 64 + overlap 8 a side
WINDOW_SHAPES = [(1, 256, 8 * WINDOW), (1, 128, 64 * WINDOW), (1, 64, 128 * WINDOW), (1, 32, 256 * WINDOW)]
HEADLINE = ("The quick brown fox jumped over the lazy dog, and everyone at the "
            "party cheered loudly for the brave little robot.")  # bench.py's headline text
TEXT11 = "Hey there! I am an emoji voice."
STEPS, STRENGTH = 10, 0.00025
# H100 SXM: device memory rate, f32 peak outside the tensor cores, and the TF32 tensor-core peak K1 multiplies at
HBM_BYTES_PER_S, F32_FLOPS, TF32_FLOPS = 3.35e12, 67e12, 495e12
MAS_SHAPES = [(16, 256, 768), (32, 128, 512), (1, 64, 128), (8, 100, 333), (4, 512, 2048), (2, 1000, 1100),
              (3, 33, 120), (2, 1500, 1600)]
TRAIN_BATCH, TRAIN_STEPS, RESUME_STEPS, EVERY = 16, 20, 24, 10
DURATION_BATCH = 8  # get_durations' batch: 32 utterances, 4 batches, 4 K2 launches
VOC_BATCH, VOC_SEGMENT, VOC_STEPS, VOC_LOG_EVERY = 16, 32, 60, 5
VOC_TOL = 1e-3  # one GAN step, card against CPU: relative bound on the five metrics
SHORT_REPLY = "Sure, I can do that today."
STORY = ("Once upon a time a little robot lived by the sea. Every morning it counted the waves and sang to the "
         "gulls. One day a storm took its voice away. So the gulls sang for the robot until spring came back.")
WAIT_S = 120  # no wait of the serving phase is longer: a hung worker fails the run
# bounds of the serving phase, both the JAX package's contracts: a seeded row inside a merged batch against the
# direct batch-1 call (4.5e-08 measured on an H100), and streamed against monolithic audio at an overlap that
# covers the receptive field (0 to 3.2e-08 measured; PERF.md)
MERGED_TOL, STREAM_TOL = 1e-5, 1e-6


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
    for i, (b, c, t) in enumerate(STAGE_SHAPES + [BATCH_SHAPE] + RAGGED_SHAPES + WINDOW_SHAPES):
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


def phase_synthesis(mrf):
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
    return pipe, sum(mrf.launches.values())


def receptive_field_frames(cfg) -> int:
    """Mel frames of context a side that one output sample of the HiFi-GAN
    generator depends on (an upper bound): each layer's reach in samples over
    the samples per mel frame at its rate, summed: conv_pre and conv_post 7
    taps, a transposed conv k/(2u) input samples, an MRF stage its widest
    res-block, (k−1)/2 · (Σd + n_d)."""
    reach, rate = 3.0, 1
    for u, k in zip(cfg.upsample_rates, cfg.upsample_kernel_sizes):
        reach += k / (2 * u) / rate
        rate *= u
        reach += max((rk - 1) // 2 * (sum(d) + len(d)) for rk, d in
                     zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes)) / rate
    return math.ceil(reach + 3.0 / rate)


def serving_engine(pipe, mrf, requests) -> dict:
    """Phase (a): the batching engine under 8 client threads, its failure
    isolation and its per-row noise, and the same requests one by one."""
    from emojivoice_tpu_torch.inference.profile_engine import burst
    from emojivoice_tpu_torch.inference.serving import BatchingEngine

    pending = []  # every batch the engine dispatched, for the gaps between batches
    real_async = pipe.synthesise_async

    def spy(*a, **kw):
        p = real_async(*a, **kw)
        pending.append(p)
        return p

    t = time.perf_counter()
    with BatchingEngine(pipe, max_batch=8, max_wait_ms=10) as eng:
        eng.warmup()
        warm_s = time.perf_counter() - t
        burst(eng, requests)  # the requests' own text and mel buckets, once, before the counted window
    pipe.synthesise_async = spy
    try:
        with BatchingEngine(pipe, max_batch=8, max_wait_ms=10) as eng:
            mrf.launches.clear()  # the main path's run of this phase
            served = burst(eng, requests)  # 8 client threads, each submitting its 4 requests and waiting
            results, window_s = served["results"], served["window_s"]
            stats = eng.stats()
            launches = sum(mrf.launches.values())
    finally:
        del pipe.synthesise_async
    check_wavs(results, "(a) engine")
    if not (len(results) == 32 and stats["batched_rows"] == 32 and stats["batches"] < 32 and stats["errors"] == 0):
        raise RuntimeError(f"(a) engine: {len(results)} results, stats {stats}")
    if launches != 4 * stats["batches"] or len(pending) != stats["batches"]:
        raise RuntimeError(f"(a) engine: {launches} mrf_stage calls for {stats['batches']} vocoded batches "
                           f"({len(pending)} dispatched), expected 4 each")
    # the device between batches: from the end of batch N's copies to the start of batch N+1
    gaps = [a.done.elapsed_time(b.clock.marks[0][1]) for a, b in zip(pending, pending[1:])]
    spans = [p.clock.marks[0][1].elapsed_time(p.done) for p in pending]
    audio_s = sum(len(r.wav) for r in results) / 22050
    out = dict(utt_per_s=32 / window_s, window_s=window_s, audio_s=audio_s, batches=stats["batches"],
               mean_batch=stats["mean_batch"], batch_hist=stats["batch_hist"], pad_rows=stats["pad_rows"],
               wait_ms_p50=stats["wait_ms_p50"], wait_ms_p95=stats["wait_ms_p95"],
               latency_ms_p50=served["latency_ms_p50"], latency_ms_p95=served["latency_ms_p95"],
               mean_dispatch_ms=stats["mean_dispatch_ms"], batch_span_ms=spans, gap_ms=gaps,
               gap_share=sum(gaps) / (sum(gaps) + sum(spans)), warmup_s=warm_s, k1_launches=launches)

    # the same 32 requests one by one, without the engine (once to warm the batch-1 shapes, once timed)
    kw = dict(n_timesteps=STEPS, denoiser_strength=STRENGTH, keep_mel=False, pcm16=True)
    for timed in (False, True):
        t = time.perf_counter()
        singles = [pipe.synthesise([text], spks=[spk], seed=seed, **kw)[0] for text, spk, seed in requests]
        single_s = time.perf_counter() - t
    check_wavs(singles, "(a) one by one")
    out.update(one_by_one_utt_per_s=32 / single_s, one_by_one_s=single_s)
    if [r.mel_length for r in singles] != [r.mel_length for r in results]:
        raise RuntimeError(f"(a) engine and one-by-one mel lengths differ: {[r.mel_length for r in results]} "
                           f"against {[r.mel_length for r in singles]}")
    print("[serve] (a) engine " + json.dumps(out))

    # a text beyond the largest text bucket fails alone; its co-batched neighbours resolve
    with BatchingEngine(pipe, max_batch=8, max_wait_ms=500) as eng:
        good1 = eng.submit(SHORT_REPLY, spk=79, seed=1)
        bad = eng.submit("word " * 120, spk=79, seed=2)  # 1,201 ids against a largest bucket of 512
        good2 = eng.submit(TEXT11, spk=86, seed=3)
        check_wavs([good1.result(timeout=WAIT_S), good2.result(timeout=WAIT_S)], "(a) poison neighbours")
        error = bad.exception(timeout=WAIT_S)
        stats = eng.stats()
    if not (isinstance(error, ValueError) and stats["failed_batches"] >= 1 and stats["errors"] == 1
            and stats["batched_rows"] == 2):
        raise RuntimeError(f"(a) poison row: error {error!r}, stats {stats}")
    print(f"[serve] (a) poison row failed alone ({error}); failed_batches {stats['failed_batches']} errors "
          f"{stats['errors']} batched_rows {stats['batched_rows']}")

    # per-row noise: a seeded request inside a merged batch against the direct batch-1 call
    with BatchingEngine(pipe, max_batch=4, max_wait_ms=500, pcm16=False) as eng:
        futs = [eng.submit(HEADLINE, spk=79, seed=seed) for seed in (11, 12, 11)]
        merged = [f.result(timeout=WAIT_S) for f in futs]
        stats = eng.stats()
    direct = pipe.synthesise([HEADLINE], spks=[79], n_timesteps=STEPS, denoiser_strength=STRENGTH, seed=11,
                             keep_mel=False)[0]
    err = float(abs(merged[0].wav - direct.wav).max()) if merged[0].wav.shape == direct.wav.shape else float("inf")
    same_bits = bool((merged[0].wav == merged[2].wav).all())
    other = float(abs(merged[0].wav - merged[1].wav).max())
    print(f"[serve] (a) seed 11 inside a merged batch of {stats['batch_hist']} against the direct batch-1 call: "
          f"max-abs {err:.3e} (peak {float(abs(direct.wav).max()):.3f}; bound {MERGED_TOL}); two seed-11 rows "
          f"equal to the bit: {same_bits}; seed 12 differs by {other:.3e}")
    if not (stats["batches"] == 1 and err <= MERGED_TOL and same_bits and other > 1e-3):
        raise RuntimeError("(a) per-row seeds: a merged row does not reproduce the direct call")
    out.update(merged_vs_direct_max_abs=err)
    return out


def serving_overlap(pipe) -> dict:
    """Phase (b): batch N's results must reach the caller while batch N+1 is
    still computing.

    First on the pipeline alone: N (batch 8) and then N+1 (batch 32, enough
    device work to outlast its own dispatch) are enqueued back to back;
    ``finalize(N)`` must return while N+1 runs, which it does only if it
    waits for N's own copies and not for the stream.  Then through the engine:
    two batches of 8 from one burst; when N's futures resolve, N+1 must not
    have finished."""
    from emojivoice_tpu_torch.inference.serving import BatchingEngine

    def batch(n, first_seed, strength):
        return dict(texts=[HEADLINE] * n, spks=[79] * n, seed=list(range(first_seed, first_seed + n)),
                    n_timesteps=STEPS, denoiser_strength=strength, keep_mel=False, pcm16=True)

    out = {}
    # With the denoiser on, ``torch.istft`` checks its window envelope on the host: a dispatch then returns
    # only when its batch is all but done, and nothing is left to overlap.  Shown, not required.  With the
    # denoiser off, batch 32's vocoder (milliseconds to enqueue, ~0.1 s to run) outlasts its dispatch:
    # finalize(N) must return while it runs.
    for name, strength in (("denoiser_on", STRENGTH), ("denoiser_off", 0.0)):
        for n in (8, 32):  # warm both shapes
            pipe.synthesise(**batch(n, 0, strength))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first = pipe.synthesise_async(**batch(8, 0, strength))
        t1 = time.perf_counter()
        second = pipe.synthesise_async(**batch(32, 8, strength))
        t2 = time.perf_counter()
        results = pipe.finalize(first)
        t3 = time.perf_counter()
        second_running = not second.done.query()
        second.done.synchronize()
        t4 = time.perf_counter()
        check_wavs(results, "(b) batch N")
        check_wavs(pipe.finalize(second), "(b) batch N+1")
        out[name] = dict(dispatch_n_ms=(t1 - t0) * 1e3, dispatch_n1_ms=(t2 - t1) * 1e3, finalize_n_ms=(t3 - t2) * 1e3,
                         n_results_at_ms=(t3 - t0) * 1e3, n1_done_at_ms=(t4 - t0) * 1e3,
                         n1_running_when_n_returned=second_running,
                         n_copies_done_before_n1s_ms=first.done.elapsed_time(second.done),
                         idle_gap_ms=first.done.elapsed_time(second.clock.marks[0][1]))
        print(f"[serve] (b) pipeline, batch 8 then batch 32 back to back, {name} " + json.dumps(out[name]))
    if not out["denoiser_off"]["n1_running_when_n_returned"]:
        raise RuntimeError("(b) finalize(N) returned only after batch N+1 had finished")

    pending, resolved = [], []
    real_async = pipe.synthesise_async

    def spy(*a, **kws):
        p = real_async(*a, **kws)
        pending.append(p)
        return p

    def on_done(index, t_start):
        def callback(_future):
            # runs in the engine's results thread, at the moment the future resolves
            nxt = pending[index // 8 + 1] if len(pending) > index // 8 + 1 else None
            resolved.append((index, (time.perf_counter() - t_start) * 1e3, nxt is None or not nxt.done.query()))
        return callback

    pipe.synthesise_async = spy
    try:
        with BatchingEngine(pipe, max_batch=8, max_wait_ms=10) as eng:
            t_start = time.perf_counter()
            futs = []
            for i in range(16):
                fut = eng.submit(HEADLINE, spk=79, seed=i)
                fut.add_done_callback(on_done(i, t_start))
                futs.append(fut)
            check_wavs([f.result(timeout=WAIT_S) for f in futs], "(b) engine")
            stats = eng.stats()
    finally:
        del pipe.synthesise_async
    by_index = {i: (ms, running) for i, ms, running in resolved}
    first_batch = [by_index[i] for i in range(8)]
    engine = dict(batch_hist=stats["batch_hist"], n_resolved_at_ms=max(ms for ms, _ in first_batch),
                  n1_resolved_at_ms=max(by_index[i][0] for i in range(8, 16)),
                  n1_running_when_n_resolved=all(running for _, running in first_batch),
                  n_copies_done_before_n1s_ms=pending[0].done.elapsed_time(pending[1].done))
    print("[serve] (b) engine, two batches of 8 from one burst " + json.dumps(engine))
    if stats["batch_hist"] != {8: 2} or not engine["n1_running_when_n_resolved"]:
        raise RuntimeError("(b) engine: batch N's futures resolved only after batch N+1 had finished")
    out["engine"] = engine
    return out


def first_audio_ms(make_chunks) -> tuple:
    """(ms to the first chunk, ms to the last, chunks, samples) of a generator of audio chunks."""
    t = time.perf_counter()
    first, n, samples = None, 0, 0
    for chunk in make_chunks():
        if first is None:
            first = (time.perf_counter() - t) * 1e3
        n += 1
        samples += len(chunk)
    return first, (time.perf_counter() - t) * 1e3, n, samples


def serving_streaming(pipe, mrf) -> list:
    """Phase (c): chunked streaming against the pipeline's monolithic vocoding
    of the same mel, and time to first audio by strategy."""
    import numpy as np

    from emojivoice_tpu_torch.inference.streaming import StreamingVocoder, auto_stream, choose_strategy

    rf = receptive_field_frames(pipe.vocoder_cfg)
    if rf <= 8:
        raise RuntimeError(f"receptive field {rf}: HiFi-GAN v1's is expected above the default overlap of 8")
    rows = []
    for name, text in (("short reply", SHORT_REPLY), ("headline", HEADLINE), ("story", STORY)):
        res = pipe.synthesise([text], spks=[79], n_timesteps=STEPS, seed=7, vocode=False)[0]
        ml = res.mel_length
        mel = torch.from_numpy(res.mel).cuda()
        mel = torch.nn.functional.pad(mel, (0, 0, 0, -ml % 64))  # whole chunks, as the streamer pads
        mono = pipe._vocode(mel[None])[0, : ml * 256].cpu().numpy()
        row = dict(text=name, chars=len(text), mel_length=ml, audio_s=ml * 256 / 22050, receptive_field=rf,
                   peak=float(abs(mono).max()), auto=choose_strategy(text)[0])
        for ov in (8, rf):
            sv = StreamingVocoder(pipe.vocoder, 64, ov, vocode_fn=pipe._vocode)
            list(sv.stream(mel, ml))  # warm the window shapes
            torch.cuda.synchronize()
            mrf.launches.clear()
            t = time.perf_counter()
            chunks = list(sv.stream(mel, ml))
            total_ms = (time.perf_counter() - t) * 1e3
            calls = sum(mrf.launches.values())
            streamed = np.concatenate(chunks)
            if streamed.shape != mono.shape or calls != 4 * len(chunks):
                raise RuntimeError(f"(c) {name} overlap {ov}: {streamed.shape} samples against {mono.shape}, "
                                   f"{calls} mrf_stage calls for {len(chunks)} chunks")
            row[f"ov{ov}"] = dict(max_abs=float(abs(streamed - mono).max()), bit_equal=bool((streamed == mono).all()),
                                  chunks=len(chunks), ms_per_chunk=total_ms / len(chunks), mrf_stage_calls=calls)
        if row[f"ov{rf}"]["max_abs"] > STREAM_TOL:
            raise RuntimeError(f"(c) {name}: streamed audio at overlap {rf} is {row[f'ov{rf}']['max_abs']:.3e} off the "
                               f"monolithic call (bound {STREAM_TOL})")
        # time to first audio by strategy (one warm call, then the median of three)
        kw = dict(spk=79, n_timesteps=STEPS, seed=7)
        for strategy in ("full", "stream") + (("pipelined",) if row["auto"] == "pipelined" else ()):
            def run(strategy=strategy):
                return first_audio_ms(lambda: auto_stream(pipe, text, strategy=strategy, **kw))
            run()
            runs = [run() for _ in range(3)]
            row[f"ttfa_{strategy}_ms"] = statistics.median(r[0] for r in runs)
            row[f"total_{strategy}_ms"] = statistics.median(r[1] for r in runs)
            if min(r[3] for r in runs) <= 0:
                raise RuntimeError(f"(c) {name}: strategy {strategy} gave no audio")
        print("[serve] (c) streaming " + json.dumps(row))
        rows.append(row)
    return rows


def serving_cli_webapp(pipe, mrf) -> int:
    """Phase (d): the CLI and the webapp as a user runs them.  Returns the
    ``mrf_stage`` calls of the webapp's requests."""
    import numpy as np
    from scipy.io import wavfile

    from emojivoice_tpu_torch.apps import webapp
    from emojivoice_tpu_torch.inference import cli

    with tempfile.TemporaryDirectory(prefix="emojivoice_cli_") as tmp:
        t = time.perf_counter()
        if cli.main(["--random_init", "--text", TEXT11, "--spk", "79", "--seed", "0", "--output_folder", tmp]) != 0:
            raise RuntimeError("(d) cli.main failed")
        (wav_path,) = Path(tmp).glob("utterance_*.wav")
        sr, audio = wavfile.read(wav_path)
        mel = np.load(wav_path.with_suffix(".npy"))
        if not (sr == 22050 and audio.shape == (mel.shape[0] * 256,) and mel.shape[1] == 80
                and np.isfinite(audio).all() and np.isfinite(mel).all()):
            raise RuntimeError(f"(d) cli.main wrote sr {sr}, audio {audio.shape}, mel {mel.shape}")
        print(f"[serve] (d) cli.main --random_init --text ... on the card: {wav_path.name} {audio.shape[0]} samples, "
              f"mel {mel.shape}, png {'written' if wav_path.with_suffix('.png').exists() else 'skipped'}, "
              f"{time.perf_counter() - t:.2f} s with the pipeline's build")

    server = webapp.serve(pipe, port=0, batching=True, max_batch=8, max_wait_ms=10)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"

    def post(path, body, ctype="application/json"):
        data = json.dumps(body).encode() if isinstance(body, dict) else body
        req = urllib.request.Request(url + path, data=data, headers={"Content-Type": ctype})
        try:
            with urllib.request.urlopen(req, timeout=WAIT_S) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    direct = pipe.synthesise([TEXT11], spks=[79], n_timesteps=STEPS, seed=5)[0]  # what /api/stream must carry
    mrf.launches.clear()
    try:
        t = time.perf_counter()
        with ThreadPoolExecutor(8) as pool:
            answers = list(pool.map(lambda i: post("/api/synthesise", {"text": f"{TEXT11} Request {i}.", "spk": 79,
                                                                       "seed": i}), range(8), timeout=WAIT_S))
        burst_ms = (time.perf_counter() - t) * 1e3
        bodies = [json.loads(body) for status, body in answers if status == 200]
        if len(bodies) != 8 or any(b["num_samples"] <= 0 or b["sample_rate"] != 22050 for b in bodies):
            raise RuntimeError(f"(d) /api/synthesise: {[status for status, _ in answers]}")
        status, raw = post("/api/stream", {"text": TEXT11, "spk": 79, "seed": 5})
        pcm = np.frombuffer(raw[44:], dtype="<i2")
        if not (status == 200 and raw[:4] == b"RIFF" and raw[8:12] == b"WAVE"
                and struct.unpack("<I", raw[24:28])[0] == 22050 and len(pcm) == len(direct.wav)):
            raise RuntimeError(f"(d) /api/stream: status {status}, {len(pcm)} samples against {len(direct.wav)}")
        stream_err = float(np.abs(pcm.astype(np.float32) / 32767.0 - np.clip(direct.wav, -1, 1)).max())
        codes = dict(bad_json=post("/api/synthesise", b"{bad json")[0],
                     bad_json_stream=post("/api/stream", b"{bad json")[0],
                     unknown_language=post("/api/synthesise", {"text": "hi", "language": "zz"})[0],
                     unknown_language_stream=post("/api/stream", {"text": "hi", "language": "zz"})[0],
                     too_long=post("/api/synthesise", {"text": "word " * 120})[0])
        with urllib.request.urlopen(url + "/health", timeout=WAIT_S) as r:
            health = json.loads(r.read())
        serving = health.get("serving", {})
        if set(codes.values()) != {400} or not health.get("ok") or serving.get("batched_rows") != 8 \
                or serving.get("batches", 99) >= 8:
            raise RuntimeError(f"(d) webapp: statuses {codes}, health {health}")
        print(f"[serve] (d) webapp: 8 concurrent POST /api/synthesise in {burst_ms:.1f} ms as {serving['batches']} "
              f"batches {serving['batch_hist']}; /api/stream {len(pcm)} samples, {stream_err:.2e} off the direct call "
              f"(one pcm16 step is 3.05e-05); statuses {codes}; /health serving requests {serving['requests']} "
              f"errors {serving['errors']}")
        if stream_err > 1.01 / 32767 + MERGED_TOL:
            raise RuntimeError("(d) /api/stream does not carry the direct call's samples")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(WAIT_S)
        server.engine.close()
    if thread.is_alive() or server.engine._worker.is_alive():
        raise RuntimeError("(d) the webapp's server thread or engine worker did not stop")
    return sum(mrf.launches.values())


def phase_serving(pipe, mrf) -> dict:
    from emojivoice_tpu_torch.apps.emoji import EMOJI_MAPPING
    from emojivoice_tpu_torch.inference.profile_engine import serving_requests

    requests = serving_requests(32, list(EMOJI_MAPPING.values()))
    engine = serving_engine(pipe, mrf, requests)
    overlap = serving_overlap(pipe)
    mrf.launches.clear()
    streaming = serving_streaming(pipe, mrf)
    web_launches = serving_cli_webapp(pipe, mrf)
    if web_launches < 4 * 2:
        raise RuntimeError(f"(d) the webapp's requests made {web_launches} mrf_stage calls")
    return dict(engine=engine, overlap=overlap, streaming=streaming,
                k1_launches=engine["k1_launches"] + web_launches)


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


def serve_trained(mrf, ckpt_dir: Path) -> int:
    """Phase (e): the checkpoint directory the trainer just wrote, served on
    the card.  The run trained no vocoder, so the pipeline takes a seeded
    random HiFi-GAN v1 (and warns); K1 must launch on all four stages."""
    import warnings

    from emojivoice_tpu_torch.inference.pipeline import SynthesisPipeline

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        pipe = SynthesisPipeline.from_checkpoint(str(ckpt_dir), cleaners=("basic_cleaners",))
    if pipe.device.type != "cuda":
        raise RuntimeError("from_checkpoint did not build the pipeline on the card")
    kw = dict(spks=[79], n_timesteps=STEPS, denoiser_strength=STRENGTH, seed=0, pcm16=True)
    pipe.synthesise([TEXT11], **kw)  # first-call allocations
    mrf.launches.clear()
    t = time.perf_counter()
    res = pipe.synthesise([TEXT11], **kw)
    wall_ms = (time.perf_counter() - t) * 1e3
    launches = sum(mrf.launches.values())
    check_wavs(res, "(e) trained checkpoint")
    if launches != 4:
        raise RuntimeError(f"(e) serving the trained checkpoint made {launches} mrf_stage calls, expected 4")
    print(f"[serve] (e) from_checkpoint({ckpt_dir.name}/, step {RESUME_STEPS}) on the card: mel_length "
          f"{res[0].mel_length}  wall {wall_ms:.3f} ms  rtf_w {res[0].rtf_w:.5f}  K1 launches {launches}")
    return launches


def phase_training(mas, mrf) -> dict:
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
        served = serve_trained(mrf, out / "ckpts")
        vocoder = phase_vocoder_training(mas, mrf, matcha, tmp, train_list, out / "ckpts")
    return dict(launches=launches + vocoder["k2_launches"], row=path_row,
                k1_launches=served + vocoder["k1_launches"], vocoder=vocoder)


def phase_vocoder_training(mas, mrf, matcha, tmp: Path, filelist: Path, ckpt_dir: Path) -> dict:
    """Phase 6: durations and teacher-forced mels through K2, the GAN
    fine-tune on them, one step against the CPU, the step by stage, and the
    fine-tuned generator folded and served through K1."""
    import numpy as np

    from emojivoice_tpu_torch.config import HiFiGANConfig
    from emojivoice_tpu_torch.inference.pipeline import SynthesisPipeline
    from emojivoice_tpu_torch.io.torch_ckpt import load_hifigan
    from emojivoice_tpu_torch.training import get_durations
    from emojivoice_tpu_torch.training.vocoder_proof import load_pairs, make_segment_sampler, run_vocoder_proof
    from emojivoice_tpu_torch.training.vocoder_train import create_vocoder_state, vocoder_train_step
    from emojivoice_tpu_torch.utils.timing import StageClock
    from emojivoice_tpu_torch.vocoder.hifigan import HiFiGANGenerator

    cfg = HiFiGANConfig()
    rows = [r.split("|") for r in filelist.read_text().splitlines() if r.strip()]
    n_batches = -(-len(rows) // DURATION_BATCH)

    # (a) get_durations --gen_mels, as a user calls it; the first batch's log-prior is kept for the plain search
    aligned = tmp / "aligned"
    seen = []
    real = matcha.maximum_path

    def capture(value, mask):
        path = real(value, mask)
        if not seen:
            seen.append((value, mask, path))
        return path
    matcha.maximum_path = capture
    mas.launches = 0  # the main path's run of K2's second caller
    t = time.perf_counter()
    try:
        if get_durations.main(["--checkpoint_path", str(ckpt_dir), "--filelist", str(filelist), "--preset", PRESET,
                               "--output_dir", str(aligned), "--batch_size", str(DURATION_BATCH), "--gen_mels",
                               "--n_timesteps", str(STEPS)]) != 0:
            raise RuntimeError("(a) get_durations failed")
    finally:
        matcha.maximum_path = real
    torch.cuda.synchronize()
    durations_s = time.perf_counter() - t
    k2_launches = mas.launches
    if k2_launches != n_batches:
        raise RuntimeError(f"(a) get_durations launched K2 {k2_launches} times for {n_batches} batches")
    frames = {}
    for wav_path, _, _ in rows:
        stem = Path(wav_path).stem
        durs, gen_mel = np.load(aligned / "durations" / f"{stem}.npy"), np.load(aligned / "gen_mels" / f"{stem}.npy")
        if gen_mel.shape != (int(round(durs.sum())), 80) or gen_mel.dtype != np.float32 or not np.isfinite(gen_mel).all():
            raise RuntimeError(f"(a) gen_mels/{stem}.npy is {gen_mel.shape} {gen_mel.dtype} for {durs.sum()} frames "
                               f"of durations")
        frames[stem] = gen_mel.shape[0]
    value, mask, path = seen[0]
    plain = mas.maximum_path_reference(value, mask)
    if not torch.equal(path, plain) or mas.path_faults(path, mask):
        raise RuntimeError("(a) K2's path differs from the plain search on get_durations' first log-prior")
    print(f"[vocoder] (a) get_durations --gen_mels on {ckpt_dir.name}/: {len(rows)} utterances in {n_batches} batches, "
          f"{durations_s:.2f} s ({len(rows) / durations_s:.2f} utterances/s with {STEPS} Euler steps and the files), "
          f"K2 launches {k2_launches}, frames {min(frames.values())}..{max(frames.values())}, first batch "
          f"{tuple(value.shape)} equal to the plain search")

    # (b) the GAN fine-tune on those mels, through the harness a user calls
    mrf.launches.clear()
    t = time.perf_counter()
    summary = run_vocoder_proof(str(tmp / "voc"), steps=VOC_STEPS, batch_size=VOC_BATCH, segment_frames=VOC_SEGMENT,
                                window=3, cfg=cfg, log_every=VOC_LOG_EVERY, filelist=str(filelist),
                                gen_mels_dir=str(aligned / "gen_mels"))
    proof_s = time.perf_counter() - t
    render_launches = sum(mrf.launches.values())
    n_stages = len(cfg.upsample_rates)  # one mrf_stage call each per vocoded batch
    if render_launches != 2 * n_stages or not summary["fine_tuning"] or summary["backend"] != torch.cuda.get_device_name(0):
        raise RuntimeError(f"(b) run_vocoder_proof: {render_launches} mrf_stage calls for two renders, summary {summary}")
    print(f"[vocoder] (b) run_vocoder_proof, HiFi-GAN v1 + MPD + MSD, batch {VOC_BATCH} x {VOC_SEGMENT * 256} samples, "
          f"{VOC_STEPS} steps in {proof_s:.2f} s with corpus and renders: " + json.dumps(summary))

    # (c) one step on the card against the CPU, from the same state and batch (4 rows)
    pairs = load_pairs([r[0] for r in rows[:-1]], cfg, 256, 1024, 1024, aligned / "gen_mels")
    sample = make_segment_sampler(pairs, VOC_SEGMENT, 256, VOC_BATCH, seed=3)
    batch_np = sample()
    # from the generator that (b) trained (a random one's waveform is near zero, and every loss then rounds
    # to the same f32 on both devices) and seeded discriminators
    gen_file = tmp / "voc" / summary["generator_ckpt"]
    card = create_vocoder_state(cfg, seed=1, gen_state=load_hifigan(str(gen_file), fold=False))
    if card.device.type != DEVICE:
        raise RuntimeError("create_vocoder_state did not build the state on the card")
    cpu = create_vocoder_state(cfg, seed=1, gen_state=load_hifigan(str(gen_file), fold=False), device="cpu")
    for a, b in ((card.mpd, cpu.mpd), (card.msd, cpu.msd)):
        if not all(torch.equal(p.cpu(), q) for p, q in zip(a.parameters(), b.parameters())):
            raise RuntimeError("(c) the same seed gave the card and the CPU different discriminators")
    four = {k: torch.from_numpy(v[:4]) for k, v in batch_np.items()}
    t = time.perf_counter()
    m_cpu = {k: float(v) for k, v in vocoder_train_step(cpu, four).items()}
    cpu_s = time.perf_counter() - t
    m_card = {k: float(v) for k, v in vocoder_train_step(card, {k: v.cuda() for k, v in four.items()}).items()}
    rel = {k: abs(m_card[k] - m_cpu[k]) / abs(m_cpu[k]) for k in m_cpu}
    moved = max(float((a.detach().cpu() - b.detach()).abs().max()) for a, b in zip(card.gen.parameters(),
                                                                                   cpu.gen.parameters()))
    print(f"[vocoder] (c) one GAN step, 4 rows, card {m_card} cpu {m_cpu} (CPU step {cpu_s:.2f} s); relative "
          f"differences {rel}; generator parameters after the step differ by at most {moved:.2e}")
    if max(rel.values()) > VOC_TOL:
        raise RuntimeError(f"(c) card and CPU GAN steps disagree beyond {VOC_TOL}: {rel}")
    del cpu

    # (d) the step by stage at batch 16, then steps per second
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch_np.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stage_ms = []
    for _ in range(2 + 5):  # two to warm
        clock = StageClock(torch.device(DEVICE))
        vocoder_train_step(card, batch, clock=clock)
        torch.cuda.synchronize()
        stage_ms.append(clock.elapsed_ms())
    med = {k: statistics.median(m[k] for m in stage_ms[2:]) for k in stage_ms[0]}
    n = 10
    t = time.perf_counter()
    for _ in range(n):
        vocoder_train_step(card, batch)
    enqueue_ms = (time.perf_counter() - t) * 1e3 / n  # the host's share: the step itself waits for nothing
    torch.cuda.synchronize()
    steps_per_s = n / (time.perf_counter() - t)
    step = dict(steps_per_s=steps_per_s, host_enqueue_ms=enqueue_ms, **{f"{k}_ms": v for k, v in med.items()},
                sum_ms=sum(med.values()),
                batch=VOC_BATCH, segment_samples=VOC_SEGMENT * 256, peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                harness_steps_per_s=summary["steps_per_sec_after_first"])
    print("[vocoder] (d) step " + json.dumps(step))
    del card

    # (e) the fine-tuned generator, folded, served beside the run's acoustic checkpoint
    pipe = SynthesisPipeline.from_checkpoint(str(ckpt_dir), str(gen_file), cleaners=("basic_cleaners",))
    kw = dict(spks=[79], n_timesteps=STEPS, denoiser_strength=STRENGTH, seed=0, pcm16=True)
    pipe.synthesise([TEXT11], **kw)  # first-call allocations
    mrf.launches.clear()
    t = time.perf_counter()
    res = pipe.synthesise([TEXT11], **kw)
    wall_ms = (time.perf_counter() - t) * 1e3
    served_launches = sum(mrf.launches.values())
    check_wavs(res, "(e) fine-tuned generator")
    if served_launches != n_stages:
        raise RuntimeError(f"(e) serving the fine-tuned generator made {served_launches} mrf_stage calls, expected "
                           f"{n_stages}")
    trained = HiFiGANGenerator(cfg, weight_norm=True)
    trained.load_state_dict(load_hifigan(str(gen_file), fold=False), strict=True)
    trained = trained.cuda().eval()
    stem = Path(rows[-1][0]).stem
    mel = torch.from_numpy(np.load(aligned / "gen_mels" / f"{stem}.npy")[None, :160]).cuda()
    with torch.no_grad():
        plain_wav = trained.forward_train(mel)
    k1_wav = pipe.vocoder(mel)  # a comparison: made after the count was read
    err = float((k1_wav - plain_wav).abs().max())
    print(f"[vocoder] (e) g_{VOC_STEPS:08d} folded and served with {ckpt_dir.name}/: mel_length {res[0].mel_length}  "
          f"wall {wall_ms:.3f} ms  K1 launches {served_launches}; K1 on the folded weights against the weight-norm "
          f"generator's plain forward on {mel.shape[1]} frames of {stem}: max-abs {err:.3e} (bound {TOL})")
    if not err <= TOL:
        raise RuntimeError(f"(e) the folded generator through K1 is {err:.3e} off the weight-norm generator")
    return dict(k2_launches=k2_launches, k1_launches=render_launches + served_launches, step=step, summary=summary,
                durations_utt_per_s=len(rows) / durations_s, card_vs_cpu_rel=rel, folded_vs_plain=err)


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
    pipe, launches = phase_synthesis(mrf)
    mas_rows = phase_kernel_mas(mas)
    training = phase_training(mas, mrf)
    serving = phase_serving(pipe, mrf)
    # K1 on the main paths: the synthesis requests, the engine's and the webapp's batches, the trained checkpoint,
    # the vocoder proof's two renders and the fine-tuned generator served; K2: the trainer's steps and get_durations
    launches += serving["k1_launches"] + training["k1_launches"]

    stage_rows = rows[:len(STAGE_SHAPES)]
    window_rows = rows[-len(WINDOW_SHAPES):]
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
        "ms_stream_window": sum(r["ms"] for r in window_rows),  # the four stages of one 80-frame streaming window
        "plain_ms_stream_window": sum(r["plain_ms"] for r in window_rows),
        "bound_ms_stream_window": sum(r["bound_ms"] for r in window_rows),
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
