"""Drive the PyTorch port's paths once on one NVIDIA GPU: synthesis
(text → pcm16), acoustic-model training, the vocoder's fine-tune on the
acoustic model's own mels, the serving front ends (batching engine,
streaming vocoder, long-form, CLI, webapp, and trained checkpoints served),
the export artifact, the reduced-precision paths (bf16 serving through
K1's bf16 mode, bf16-mixed training), the conformer configuration (served,
trained, served again and exported), a from-scratch proof and a sweep.

    python3 chip_smoke.py

Phases (each one failing fails the run, exit code ≠ 0):
  1. build  — compile K1 (csrc/mrf.cu), K1's bf16 mode (csrc/mrf_bf16.cu)
     and K2 (csrc/mas.cu) with nvcc for sm_90a from this checkout, one nvcc
     each, all at once;
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
     log-prior).  Then ``[precision]``: the same step in ``bf16-mixed`` from
     the same weights, its loss within rtol 0.05 of the f32 step's, K2 on its
     bf16 log-prior equal to the plain search, the step by stage (two warm,
     median of 5), steps per second beside f32's and peak memory.  Before the
     run's folder is removed,
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
     JSON and an unknown language, and ``/health`` with the engine's stats;
  8. export — on the same pipeline's weights: (a) ``export_bundle`` on the
     card over batches (1, 8) x text bucket 256 x mel buckets (512, 1024),
     f32 wav (export wall and each program's .pt2 bytes printed), loaded with
     ``LoadedBundle``; the headline at batch 1 (speaker 79, the duration
     program picks the bucket) and 8 texts at batch 8 with per-row seeds, each
     held against the live fused call with the same seeds at the same mel
     bucket within 1e-5, and each program run must launch K1 on all four
     stages (``mrf_stage`` is a registered op inside the program); (b) a
     pinned mel bucket of 512 at a speaking rate that overflows it escalates
     through the duration program to 1024; (c) ``BatchingEngine`` over
     ``BundleSynthesisPipeline``, 16 requests from 8 threads, a merged seeded
     row against its direct bundle call; (d) ``webapp.serve`` on the bundle:
     8 concurrent ``POST /api/synthesise`` answer 200, a wrong step count
     400, ``/api/stream`` 200 for ``auto`` and 400 for a forced ``stream``;
     (e) bundle against live at batch 1 and 8, alternated, host wall and
     device span; (f) one denoised fused dispatch of the live pipeline and
     one of the bundle under ``torch.cuda.set_sync_debug_mode("error")``;
  9. precision — K1's bf16 mode (``mrf_resblock_bf16``, csrc/mrf_bf16.cu: the
     activation rounded once per tile, a promoted f32 sum per tap, one launch
     per dilation unit where the shape rule fuses it): one 64-frame tile
     against float64 on the same bf16 operands (relative 1e-5), the one-conv
     mean error at (256, 11, 1) beside cuDNN f32's, then the stage against its
     plain twin's bf16 branch at the four stage shapes, at B = 8, C = 128, at
     the two ragged shapes and at the four window shapes (99 % of the outputs
     within 2e-4, all within 2e-3: two sum orders can round an intermediate to
     neighbouring bf16 numbers), with the flip share against the float64 twin
     beside cuDNN f32's, timed against the twin, against cuDNN's bf16 convs
     (a yardstick of another function: they round each conv's output to bf16)
     and, alternately in the same call, against K1's f32 mode; the
     pipeline (emoji_multi + v1, random weights, 10 steps, denoiser on, f32
     wav) in three settings, f32, ``vocoder_dtype=bf16`` and
     ``compute_dtype=bf16``, at batch 1 two-stage and 8 and 32 fused: wall,
     rtf_w, stage ms, 4 K1 launches a request in the setting's mode, the wav
     within 2e-2 of f32's (``vocoder_dtype``, the mel unchanged within 1e-5)
     and the mel within MAE 0.1 and 2 frames of f32's (``compute_dtype``); one
     streamed utterance in bf16 mode, ms per chunk and max-abs against its
     monolithic call;
 10. conformer — emoji_multi with all three decoder block types
     ``"conformer"`` and HiFi-GAN v1, random weights (seed 0): (a) batch 1
     two-stage and batch 8 fused through K1 (four launches each), a short
     request against the CPU on the same weights and noise (lengths equal, mel
     MAE and wav max error under 1e-3), one request with ``strict_mask=True``
     (equal to the default's to the bit: conformer attention masks whatever
     it says) and one with ``vocoder_dtype=bf16`` (K1's bf16 mode, wav within
     2e-2 of f32's); (b) ``training.train.main`` fine-tuning those weights from
     a reference-format file, batch 16, 20 steps on one overfit batch with
     ``--loggers csv,tensorboard --render_val_samples 1 --val_every_steps
     10``: K2 once per step and validation batch, the BatchNorm statistics
     moved and finite, each render in eval mode leaving them equal; one step
     card against CPU (BatchNorm in train mode, its statistics held too); the
     step by stage beside the transformer model's; (c) the run's ``ckpts/``
     served through ``from_checkpoint`` (K1 on four stages) and exported to one
     bundle key, the bundle within 1e-5 of the live fused call;
 11. scratch — ``run_scratch_proof("emoji_multi")`` from random init, 800
     steps at batch 8 (cosine 5e-4 → 5e-5), its emergence asserts on and its
     free-synthesis budget off; diagonality and MAS drift must improve from
     the first probe to the last, K2 once per step and probe;
 12. sweep — ``emojivoice-sweep-torch``'s ``main`` in process: three trials of
     10 steps at emoji_multi over ``out_size`` 128, 256 and 31 (no multiple of
     4, so that trial fails in its first forward after its model is built):
     the ranking and each record's ``objective_from``, and
     ``torch.cuda.memory_allocated()`` back within 64 MB of its value before
     the first trial (garbage collected) after every trial.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
``nvidia-smi``'s card name and power limit, and the one before that the
kernel record, whose ``bound_ms`` is the larger of bytes over 3.35 TB/s and
operations over the peak of the unit that does them, for the inputs of this
run: K1's three TF32 products per f32 product at 495 TFLOP/s (the earlier
SIMT design's bound at 67 TFLOP/s and a one-product TF32 kernel's stay beside
it), K1's bf16 mode one bf16 product at 989 TFLOP/s (with its launches per
stage and the window shapes' time and bound), K2's two f32 operations
per cell at 67 TFLOP/s.  There is no CPU path:
without a CUDA device it exits 1.
"""

from __future__ import annotations

import copy
import dataclasses
import gc
import importlib.util
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
# K1's bf16 mode against its twin: within TOL on at least BF16_WITHIN of the outputs, and BF16_FLIP_TOL on all.
# The two sum in other orders, and an intermediate that close to a bf16 rounding boundary rounds to neighbouring
# bf16 numbers in the two: one bf16 step of it, |w|·step on each output that reads it (tests/test_torch_mrf_cuda.py;
# the float64 twin with the same rounding points is the witness).  Where the stage rounds: on one dilation unit
# (conv, lrelu, round, conv), where flips stay sparse, the median error against the twin must stay under
# BF16_GAP_SHARE of the median bf16-against-f32 gap; over a whole stage flips cascade through nine units, so there
# the bound is BF16_STAGE_SHARE.  A kernel that never rounded the activation sits ~0.7 of the gap away in both
# (the twin on the bf16 weights in f32 activations, printed beside it)
BF16_WITHIN, BF16_FLIP_TOL, BF16_GAP_SHARE, BF16_STAGE_SHARE = 0.99, 2e-3, 0.1, 0.35
BF16_TILE_TOL = 1e-5  # one bf16 convolution against float64 on the same rounded operands, of the largest output
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
# H100 SXM: device memory rate, f32 peak outside the tensor cores, and the TF32 and bf16 tensor-core peaks K1
# multiplies at (dense)
HBM_BYTES_PER_S, F32_FLOPS, TF32_FLOPS, BF16_FLOPS = 3.35e12, 67e12, 495e12, 989e12
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
# the export phase: a bundle over batches x one text bucket x mel buckets, held against the live fused call
EXPORT_BATCHES, EXPORT_TEXT_BUCKET, EXPORT_MEL_BUCKETS = (1, 8), 256, (512, 1024)
EXPORT_TOL = 1e-5  # bundle row against the live fused row with the same seed at the same mel bucket
EXPORT_TIMED_RUNS = 5  # pairs of (live, bundle, bundle, live) per batch size
# the precision phase: K1's bf16 mode at the four stage shapes, at batch 8, at the stage shapes of batch 8 and 32
# that take another route or block shape (the C = 256 stage's one-conv blocks of several N chunks at batch 8, its
# fused units at batch 32), ragged and at the window shapes; the pipeline in three settings
BF16_BATCHED_SHAPES = [(8, 256, 8 * MEL), (32, 256, 8 * MEL), (8, 64, 128 * MEL), (8, 32, 256 * MEL)]
BF16_SHAPES = STAGE_SHAPES + [BATCH_SHAPE] + BF16_BATCHED_SHAPES + RAGGED_SHAPES + WINDOW_SHAPES
PRECISION_BATCHES = (1, 8, 32)  # batch 1 two-stage, 8 and 32 fused
PRECISION_TIMED = 3  # timed calls per request, after one warm call; the median is kept
VOCODER_TOL = 2e-2  # bf16 vocoder against f32 (tests/test_pipeline.py::test_vocoder_bf16_close_to_f32)
MEL_MAE_TOL, MEL_LENGTH_TOL = 0.1, 2  # compute_dtype=bf16 against f32 (tests/test_export_and_obs.py)
TRAIN_RTOL = 0.05  # bf16-mixed step loss against f32 (tests/test_training.py::test_bf16_mixed_precision_step)
SCRATCH_STEPS = 800  # the [scratch] phase's from-scratch run, 65-100 s at batch 8 on an H100 (8-13 steps/s)


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


def cpu_reference_check(pipe, tag: str = "synth") -> dict:
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
    print(f"[{tag}] card vs CPU on the same weights and noise: {out}")
    if not (out["same_lengths"] and out["mel_mae"] < 1e-3 and out["wav_max_abs_err"] < 1e-3):
        raise RuntimeError(f"[{tag}] card and CPU disagree: {out}")
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
        delta = {c: mrf.launches[(c, "f32")] - before.get((c, "f32"), 0) for c in (256, 128, 64, 32)}
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
    # Batch 32's vocoder and denoiser (milliseconds to enqueue, ~0.1 s to run) outlast its dispatch: finalize(N)
    # must return while they run, with the denoiser on (its inverse STFT waits for nothing on the host) and off.
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
    if not all(row["n1_running_when_n_returned"] for row in out.values()):
        raise RuntimeError(f"(b) finalize(N) returned only after batch N+1 had finished: {out}")

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


def export_timing(pipe, bundle, texts, spks, seeds, m_bucket) -> dict:
    """Bundle against live wall at one batch: alternated runs (live, bundle,
    bundle, live), the same fused work at the same mel bucket (no duration
    program, no mel copy), host wall and device span by CUDA events."""
    kw = dict(n_timesteps=STEPS, denoiser_strength=STRENGTH, keep_mel=False)

    def run(fn):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        start.record()
        fn()
        end.record()
        end.synchronize()
        return (time.perf_counter() - t) * 1e3, start.elapsed_time(end)

    def live():
        pipe.synthesise(texts, spks=spks, seed=list(seeds), fused=True, fused_mel_bucket=m_bucket, **kw)

    def exported():
        bundle.synthesise(texts, spks=spks, seed=list(seeds), mel_bucket=m_bucket)

    live(), exported()  # warm
    wall = {"live": [], "bundle": []}
    device = {"live": [], "bundle": []}
    for _ in range(EXPORT_TIMED_RUNS):
        for name, fn in (("live", live), ("bundle", exported), ("bundle", exported), ("live", live)):
            w, d = run(fn)
            wall[name].append(w)
            device[name].append(d)
    out = {"batch": len(texts), "mel_bucket": m_bucket, "runs_each": 2 * EXPORT_TIMED_RUNS}
    for name in ("live", "bundle"):
        out[f"{name}_wall_ms_median"] = statistics.median(wall[name])
        out[f"{name}_wall_ms_min"] = min(wall[name])
        out[f"{name}_device_ms_median"] = statistics.median(device[name])
        out[f"{name}_device_ms_min"] = min(device[name])
    return out


def phase_export(pipe, mrf) -> dict:
    """Phase 8: the export artifact on the card.  A bundle of the live
    pipeline's weights (emoji_multi, HiFi-GAN v1, 10 Euler steps, denoiser
    0.00025, f32 wav) over EXPORT_BATCHES x EXPORT_TEXT_BUCKET x
    EXPORT_MEL_BUCKETS, loaded with ``LoadedBundle`` and held against the live
    fused call row by row, K1 counted inside each program run; the duration
    program and a pinned bucket's escalation; the engine and ``webapp
    --bundle`` over it; bundle against live wall; and a dispatch of each with
    no host sync.  Each checked run reads ``mrf.launches`` from 0: ``k1_launches``
    counts K1 inside the bundle's program runs, ``k1_launches_live`` in the live
    pipeline's dispatch of (f)."""
    import numpy as np

    from emojivoice_tpu_torch.apps import webapp
    from emojivoice_tpu_torch.apps.emoji import EMOJI_MAPPING
    from emojivoice_tpu_torch.inference.export import BundleSynthesisPipeline, LoadedBundle, export_bundle
    from emojivoice_tpu_torch.inference.serving import BatchingEngine
    from emojivoice_tpu_torch.utils.masks import fix_len_compatibility

    n_stages = len(pipe.vocoder_cfg.upsample_rates)
    emoji_spks = list(EMOJI_MAPPING.values())
    launches = 0

    def counted(what, n_programs, fn):
        """fn()'s result; it must launch K1 on every stage of each synthesis program it runs, and no more."""
        nonlocal launches
        mrf.launches.clear()
        out = fn()
        grew = sum(mrf.launches.values())
        if grew != n_stages * n_programs:
            raise RuntimeError(f"[export] {what}: {grew} mrf_stage calls, expected {n_stages} x {n_programs}")
        launches += grew
        return out

    def hold(what, got, want) -> dict:
        """Bundle results against live results, row by row."""
        rows = []
        for r, w in zip(got, want):
            if r["mel_length"] != w.mel_length or r["wav"].shape != w.wav.shape:
                raise RuntimeError(f"[export] {what}: mel_length {r['mel_length']} / {r['wav'].shape} against the "
                                   f"live {w.mel_length} / {w.wav.shape}")
            rows.append(float(np.abs(r["wav"].astype(np.float32) - w.wav).max()))
            check_wavs([w], what)
        out = dict(max_abs=max(rows), bit_equal=all(x == 0.0 for x in rows), rows=len(rows))
        if not out["max_abs"] <= EXPORT_TOL:
            raise RuntimeError(f"[export] {what}: bundle against live max-abs {out['max_abs']:.3e} > {EXPORT_TOL}")
        return out

    def live(texts, spks, seeds, m_bucket, **extra):
        return pipe.synthesise(texts, spks=spks, seed=list(seeds), n_timesteps=STEPS, denoiser_strength=STRENGTH,
                               fused=True, fused_mel_bucket=m_bucket, keep_mel=False, **extra)

    out = {}
    with tempfile.TemporaryDirectory(prefix="emojivoice_bundle_") as tmp:
        t = time.perf_counter()
        export_bundle(pipe, tmp, text_buckets=[EXPORT_TEXT_BUCKET], mel_buckets=list(EXPORT_MEL_BUCKETS),
                      batches=EXPORT_BATCHES, n_timesteps=STEPS, denoiser_strength=STRENGTH)
        export_s = time.perf_counter() - t
        sizes = {f.stem: f.stat().st_size for f in sorted(Path(tmp).glob("*.pt2"))}
        out.update(export_s=export_s, programs=len(sizes), pt2_bytes=sizes)
        print(f"[export] export_bundle on the card: {len(sizes)} programs (batches {EXPORT_BATCHES} x text "
              f"{EXPORT_TEXT_BUCKET} x mel {EXPORT_MEL_BUCKETS}, {STEPS} steps, denoiser {STRENGTH}, f32 wav) in "
              f"{export_s:.2f} s; .pt2 bytes {json.dumps(sizes)}")

        t = time.perf_counter()
        bundle = LoadedBundle(tmp, device=DEVICE)
        if bundle.device.type != DEVICE:
            raise RuntimeError("[export] LoadedBundle did not run on the card")
        for name in sizes:
            bundle._load(name)
        out["load_s"] = time.perf_counter() - t
        print(f"[export] LoadedBundle loaded the {len(sizes)} programs in {out['load_s']:.2f} s")

        # (a) the headline at batch 1 (the duration program picks the mel bucket), then 8 texts at batch 8
        x, xl, _, _ = pipe.encode_texts([HEADLINE])
        with torch.no_grad():
            y_len = int(pipe.model.encode_text(torch.from_numpy(x).to(DEVICE), torch.from_numpy(xl).to(DEVICE),
                                               torch.tensor([79], device=DEVICE))[2].max())
        res1, t1 = counted("(a) headline, batch 1", 1, lambda: bundle.synthesise([HEADLINE], spks=[79], seed=[0]))
        if t1["mel_bucket"] != min(b for b in EXPORT_MEL_BUCKETS if b >= fix_len_compatibility(y_len)):
            raise RuntimeError(f"[export] (a) the duration program picked mel bucket {t1['mel_bucket']} for {y_len} frames")
        out["batch1"] = dict(hold("(a) headline, batch 1", res1, live([HEADLINE], [79], [0], t1["mel_bucket"])),
                             mel_bucket=t1["mel_bucket"], mel_length=res1[0]["mel_length"], wall_ms=t1["wall_s"] * 1e3)
        texts8 = [f"{TEXT11} Request number {i}." for i in range(8)]
        spks8, seeds8 = emoji_spks[:8], list(range(100, 108))
        res8, t8 = counted("(a) 8 texts, batch 8", 1, lambda: bundle.synthesise(texts8, spks=spks8, seed=seeds8))
        out["batch8"] = dict(hold("(a) 8 texts, batch 8", res8, live(texts8, spks8, seeds8, t8["mel_bucket"])),
                             mel_bucket=t8["mel_bucket"], wall_ms=t8["wall_s"] * 1e3)
        print(f"[export] (a) bundle against the live fused call, same seeds and mel bucket: batch 1 "
              f"{json.dumps(out['batch1'])}; batch 8 {json.dumps(out['batch8'])}")

        # (b) the two-program path and a pinned bucket's escalation: a speaking rate that overflows the smallest
        small, large = min(EXPORT_MEL_BUCKETS), max(EXPORT_MEL_BUCKETS)
        rate = (small + large) / 2 / y_len
        loads = []
        real_load = bundle._load
        bundle._load = lambda name: (loads.append(name), real_load(name))[1]
        try:
            esc, t_esc = counted("(b) pinned and escalated", 2, lambda: bundle.synthesise(
                [HEADLINE], spks=[79], seed=[0], length_scale=rate, mel_bucket=small))
            pick, t_pick = counted("(b) duration program's pick", 1, lambda: bundle.synthesise(
                [HEADLINE], spks=[79], seed=[0], length_scale=rate))
        finally:
            del bundle._load
        dur, synth = f"dur_b1_t{EXPORT_TEXT_BUCKET}", f"synth_b1_t{EXPORT_TEXT_BUCKET}_m"
        if not (t_esc["mel_bucket"] == t_pick["mel_bucket"] == large
                and loads == [f"{synth}{small}", dur, f"{synth}{large}", dur, f"{synth}{large}"]):
            raise RuntimeError(f"[export] (b) pinned {small} at rate {rate:.3f}: served at {t_esc['mel_bucket']}, "
                               f"programs {loads}")
        if not np.array_equal(esc[0]["wav"], pick[0]["wav"]):
            raise RuntimeError("[export] (b) the escalated call differs from the duration program's pick")
        out["escalation"] = dict(rate=rate, pinned=small, served=t_esc["mel_bucket"], mel_length=esc[0]["mel_length"],
                                 programs=loads, wall_ms=t_esc["wall_s"] * 1e3,
                                 **hold("(b) escalated", esc, live([HEADLINE], [79], [0], large, length_scale=rate)))
        print(f"[export] (b) pinned mel bucket {small} at speaking rate {rate:.3f} escalated: "
              f"{json.dumps(out['escalation'])}")

        # (c) the batching engine over the bundle: 16 requests from 8 client threads
        bp = BundleSynthesisPipeline(bundle)
        requests = [(f"{TEXT11} Request {i}.", emoji_spks[i % len(emoji_spks)], 200 + i) for i in range(16)]
        from emojivoice_tpu_torch.inference.profile_engine import burst

        with BatchingEngine(bp, max_batch=max(bp.batch_buckets), max_wait_ms=10, batch_buckets=bp.batch_buckets) as eng:
            burst(eng, requests)  # warm
            warm_batches = eng.stats()["batches"]
            mrf.launches.clear()
            served = burst(eng, requests)
            grew = sum(mrf.launches.values())
            stats = eng.stats()
        launches += grew
        batches = stats["batches"] - warm_batches
        check_wavs(served["results"], "(c) engine over the bundle")
        if not (stats["errors"] == 0 and stats["batched_rows"] == 32 and grew == n_stages * batches < n_stages * 16):
            raise RuntimeError(f"[export] (c) engine: stats {stats}, {grew} mrf_stage calls for {batches} batches")
        text, spk, seed = requests[5]
        direct = bp.synthesise([text], spks=[spk], seed=[seed])[0]
        merged_err = float(np.abs(served["results"][5].wav - direct.wav).max())
        out["engine"] = dict(utt_per_s=served["utt_per_s"], latency_ms_p50=served["latency_ms_p50"],
                             latency_ms_p95=served["latency_ms_p95"], batch_hist=stats["batch_hist"],
                             batches=batches, merged_vs_direct_max_abs=merged_err, k1_launches=grew)
        print(f"[export] (c) BatchingEngine over BundleSynthesisPipeline, 16 requests from 8 threads "
              f"(after one warm burst): {json.dumps(out['engine'])}")
        if not merged_err <= EXPORT_TOL:
            raise RuntimeError(f"[export] (c) a seeded row inside a merged batch is {merged_err:.3e} off its direct call")

        # (d) webapp --bundle: the server main() builds, on a port
        server = webapp.serve(bp, port=0, batching=True, max_batch=8, max_wait_ms=10)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{server.server_address[1]}"

        def post(path, body):
            req = urllib.request.Request(url + path, data=json.dumps(body).encode(),
                                         headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=WAIT_S) as r:
                    return r.status, r.read()
            except urllib.error.HTTPError as e:
                return e.code, e.read()

        try:
            with ThreadPoolExecutor(8) as pool:
                answers = list(pool.map(lambda i: post("/api/synthesise", {"text": f"{TEXT11} Web {i}.", "spk": 79,
                                                                           "seed": i}), range(8), timeout=WAIT_S))
            stream_auto = post("/api/stream", {"text": TEXT11, "spk": 79, "seed": 5})
            codes = dict(synthesise=[status for status, _ in answers],
                         wrong_steps=post("/api/synthesise", {"text": "hi", "steps": 7})[0],
                         stream_auto=stream_auto[0],
                         stream_forced=post("/api/stream", {"text": TEXT11, "strategy": "stream"})[0])
            health = server.engine.stats()
        finally:
            server.shutdown()
            server.server_close()
            thread.join(WAIT_S)
            server.engine.close()
        if codes != dict(synthesise=[200] * 8, wrong_steps=400, stream_auto=200, stream_forced=400) \
                or stream_auto[1][:4] != b"RIFF" or thread.is_alive():
            raise RuntimeError(f"[export] (d) webapp --bundle: statuses {codes}")
        print(f"[export] (d) webapp --bundle: statuses {json.dumps(codes)}; engine batches {health['batch_hist']}")

        # (e) bundle against live, batch 1 and batch 8, at the mel bucket of (a)
        out["timing"] = [export_timing(pipe, bundle, [HEADLINE], [79], [0], t1["mel_bucket"]),
                         export_timing(pipe, bundle, texts8, spks8, seeds8, t8["mel_bucket"])]
        for row in out["timing"]:
            print("[export] (e) bundle against live " + json.dumps(row))

        # (f) a denoised dispatch of each with no host sync: fused live, and the bundle at a pinned bucket
        def unsynced(dispatch):
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                return dispatch()
            finally:
                torch.cuda.set_sync_debug_mode(0)

        mrf.launches.clear()
        check_wavs(pipe.finalize(unsynced(lambda: pipe.synthesise_async(
            [HEADLINE], spks=[79], seed=[0], n_timesteps=STEPS, denoiser_strength=STRENGTH, fused=True,
            fused_mel_bucket=t1["mel_bucket"], keep_mel=False))), "(f) live under sync debug")
        out["k1_launches_live"] = sum(mrf.launches.values())
        if out["k1_launches_live"] != n_stages:
            raise RuntimeError(f"[export] (f) live dispatch: {out['k1_launches_live']} mrf_stage calls")
        got, _ = counted("(f) bundle under sync debug", 1, lambda: bundle.fetch(unsynced(
            lambda: bundle.dispatch([HEADLINE], spks=[79], seed=[0], mel_bucket=t1["mel_bucket"]))))
        if not np.array_equal(got[0]["wav"], res1[0]["wav"]):
            raise RuntimeError("[export] (f) the bundle's dispatch under sync debug differs from (a)")
        print('[export] (f) one denoised fused dispatch of the live pipeline and one of the bundle under '
              'torch.cuda.set_sync_debug_mode("error"): no host sync')
    out["k1_launches"] = launches
    print(f"[export] K1 launches counted inside the bundle's program runs: {launches}; in the live dispatch of (f): "
          f"{out['k1_launches_live']}")
    return out


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
    from emojivoice_tpu_torch.training.state import batch_to_device, create_train_state, eval_step
    from emojivoice_tpu_torch.training.synthetic import make_alignable_dataset

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

        state.load_state_dict(mgr.restore(RESUME_STEPS, map_location=DEVICE))
        step = step_by_stage(matcha, state, batch, seed)
        print("[train] step " + json.dumps(step))
        precision = precision_training(matcha, mas, state, batch, seed, step["steps_per_s"])

        card_vs_cpu(matcha, state, batch, mas)
        served = serve_trained(mrf, out / "ckpts")
        vocoder = phase_vocoder_training(mas, mrf, matcha, tmp, train_list, out / "ckpts")
    return dict(launches=launches + vocoder["k2_launches"] + precision["k2_launches"], row=path_row,
                k1_launches=served + vocoder["k1_launches"], vocoder=vocoder, precision=precision, step=step)


def step_by_stage(matcha, state, batch, seed: int) -> dict:
    """One train step by stage (CUDA events; two to warm, the median of five),
    MAS timed inside the forward, then steps per second over ten steps on the
    host clock, and the peak memory of these steps."""
    from emojivoice_tpu_torch.training.state import train_step
    from emojivoice_tpu_torch.utils.timing import StageClock

    mas_events = []
    real = matcha.maximum_path

    def timed(value, mask):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        path = real(value, mask)
        end.record()
        mas_events.append((start, end))
        return path
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
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
    n = 10
    t = time.perf_counter()
    for _ in range(n):
        train_step(state, batch, seed)
    torch.cuda.synchronize()
    return {"steps_per_s": n / (time.perf_counter() - t), "forward_ms": med["forward"],
            "mas_ms": statistics.median(a.elapsed_time(b) for a, b in mas_events[2:]), "backward_ms": med["backward"],
            "optimizer_ms": med["optimizer"], "batch": batch["y"].shape[0], "t_text": batch["x"].shape[1],
            "t_mel": batch["y"].shape[1], "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


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


def card_vs_cpu(matcha, state, batch, mas, tag: str = "train") -> None:
    """One train step (forward, loss, backward) on four rows of the batch from
    the same weights, t and z, dropout off: the card (K2) against the CPU
    (plain MAS).  The model is in train mode but for its dropout, so that a
    conformer decoder's BatchNorm normalises with the batch's statistics and
    updates its running ones: those are held against the CPU's too.

    The two devices round the log-prior differently (about 1e-5 on values
    near −100), and over a thousand mel frames some decisions of the search
    are nearer than that, so the CPU's own path may differ from the card's in
    a few frames.  The check therefore gives the CPU's plain MAS the card's
    log-prior: its path must equal K2's to the bit, and with that path the
    CPU's losses must agree within rtol 1e-4 and the gradient norm within
    1e-3 (f32 summation order), and BatchNorm's updated statistics within
    rtol 1e-4.  How far the CPU's own log-prior and path lie from the card's
    is printed beside it."""
    rows = {k: v[:4] for k, v in batch.items()}
    g = torch.Generator().manual_seed(11)
    t = torch.rand((4, 1, 1), generator=g)
    z = torch.randn(rows["y"].shape, generator=g)
    model_cpu = copy.deepcopy(state.model).cpu()
    for m in (model_cpu, state.model):
        m.train()
        for d in m.modules():
            if isinstance(d, torch.nn.Dropout):
                d.eval()
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
    stats = {k: v for k, v in model_cpu.state_dict().items() if "running_" in k}
    card_stats = state.model.state_dict()
    bn_rel = max((float((card_stats[k].cpu() - v).abs().max() / v.abs().max()) for k, v in stats.items()), default=0.0)
    print(f"[{tag}] card vs CPU, 4 rows, same weights and draws: plain MAS on the CPU equals K2 on the card's "
          f"log-prior: {seen['plain_equal']}; losses card {card} cpu {cpu} (max rel {rel:.2e}); grad norm card "
          f"{card_norm:.6f} cpu {cpu_norm:.6f}; the CPU's own log-prior differs by at most {seen['logp_err']:.2e} "
          f"and its own path in {seen['own_frames_differ']} of {seen['frames']} frames; BatchNorm statistics of "
          f"{len(stats)} buffers within rel {bn_rel:.2e}")
    if not (seen["plain_equal"] and rel < 1e-4 and abs(card_norm - cpu_norm) / cpu_norm < 1e-3 and bn_rel < 1e-4):
        raise RuntimeError(f"[{tag}] card and CPU train steps disagree")


def bf16_weights(w) -> list:
    """Contract weights with w1, w2 rounded to bf16: K1's bf16 mode."""
    return [(w1.to(torch.bfloat16), b1, w2.to(torch.bfloat16), b2) for w1, b1, w2, b2 in w]


def quantile(v: torch.Tensor, q: float) -> float:
    """The q-quantile of v's elements (``torch.quantile`` stops at 2^24)."""
    v = v.flatten()
    return float(v.kthvalue(max(1, min(v.numel(), round(q * v.numel())))).values)


def bf16_tile_check(mrf) -> float:
    """K1's bf16 product alone: one convolution on one 64-frame tile against
    float64 on the same operands.  x is signed and not bf16-exact, so where
    the activation is rounded shows: the kernel must match
    ``round_bf16(lrelu(x)) ∗ w + bias`` (a bf16 product is exact in f32; only
    the f32 sum's error remains) within BF16_TILE_TOL of the largest output,
    and ``lrelu(round_bf16(x)) ∗ w`` (rounding before the lrelu) and
    ``lrelu(x) ∗ w`` (no rounding) must both miss that bound."""
    import torch.nn.functional as F

    worst = 0.0
    for c, k, d in ((64, 1, 1), (256, 1, 1), (40, 11, 5), (256, 11, 1)):
        g = torch.Generator().manual_seed(c + k)
        x = torch.randn((1, 64, c), generator=g).cuda()
        w = (torch.randn((k, c, c), generator=g) * 0.1).to(torch.bfloat16).cuda()
        bias = (torch.randn((c,), generator=g) * 0.1).cuda()
        got = mrf.conv_taps(x, w, bias, d).double()
        torch.cuda.synchronize()

        def conv(a):
            return F.conv1d(a.double().transpose(1, 2), w.double().permute(2, 1, 0), bias.double(),
                            padding=(k // 2) * d, dilation=d).transpose(1, 2)

        def lrelu(a):
            return F.leaky_relu(a, mrf.LRELU_SLOPE)

        refs = {"after": conv(lrelu(x).to(torch.bfloat16)), "before": conv(lrelu(x.to(torch.bfloat16).float())),
                "none": conv(lrelu(x))}
        scale = float(refs["after"].abs().max())
        rel = {name: float((got - ref).abs().max()) / scale for name, ref in refs.items()}
        # how the f32 sums round: the mean error toward zero over its mean size (-1: every sum truncated toward
        # zero; ~0: rounded to nearest), the kernel's tensor-core sums beside cuDNN's f32 conv on the same operands
        plain = F.conv1d(lrelu(x).to(torch.bfloat16).float().transpose(1, 2), w.float().permute(2, 1, 0), bias,
                         padding=(k // 2) * d, dilation=d).transpose(1, 2).double()

        def toward_zero(e):
            return float((e * refs["after"].sign()).mean() / e.abs().mean().clamp_min(1e-300))

        e_k, e_p = got - refs["after"], plain - refs["after"]
        print(f"[precision] K1 bf16 one conv, 64 x {c} x {c}, k={k} d={d}, signed x: wgmma bf16 against float64 of "
              f"the activation rounded after the lrelu {rel['after']:.3e}, before it {rel['before']:.3e}, "
              f"not rounded {rel['none']:.3e} (of the largest output; bound {BF16_TILE_TOL}); the f32 sums' error: "
              f"kernel mean {float(e_k.abs().mean()):.3e}, signed toward zero {toward_zero(e_k):+.3f}; cuDNN f32 mean "
              f"{float(e_p.abs().mean()):.3e}, {toward_zero(e_p):+.3f}")
        if not (rel["after"] <= BF16_TILE_TOL < min(rel["before"], rel["none"])):
            raise RuntimeError(f"K1's bf16 product does not round where _conv_same does at C={c}: {rel}")
        worst = max(worst, rel["after"])
    return worst


def unrounded_gap_share(mrf, x, w16, ref, gap, kernels, dilations) -> float:
    """Median distance from the bf16 twin, over the median bf16-against-f32
    gap, of what a kernel that never rounded the activation would give: the
    twin on the bf16 weights with f32 activations."""
    unrounded = mrf.mrf_stage_reference(x, [(w1.float(), b1, w2.float(), b2) for w1, b1, w2, b2 in w16],
                                        kernels, dilations)
    return quantile((unrounded - ref).abs(), 0.5) / quantile(gap, 0.5)


def unit_check(mrf, x, w) -> dict:
    """K1's bf16 mode on one dilation unit, the k = 11, d = 1 unit of the
    third res-block: x + conv(round(lrelu(conv(round(lrelu(x)))))).  A flip
    there moves only the outputs that read the flipped activation, so the
    bulk of the error is the f32 sum order's, and rounding the intermediate
    anywhere but after its lrelu moves the median by a share of the gap."""
    w32 = [tuple(t[:1].contiguous() for t in w[KERNELS.index(11)])]
    one = bf16_weights(w32)
    got = mrf.mrf_stage(x, one, (11,), ((1,),))
    ref = mrf.mrf_stage_reference(x, one, (11,), ((1,),))
    gap = (ref - mrf.mrf_stage_reference(x, w32, (11,), ((1,),))).abs()
    diff = (got - ref).abs()
    out = dict(gap_share=quantile(diff, 0.5) / quantile(gap, 0.5), max_abs_err=float(diff.max()),
               within=float((diff <= TOL + TOL * ref.abs()).float().mean()),
               unrounded_share=unrounded_gap_share(mrf, x, one, ref, gap, (11,), ((1,),)))
    out["ok"] = out["gap_share"] <= BF16_GAP_SHARE < out["unrounded_share"]
    return out


def cudnn_bf16_stage(x, w16):
    """The yardstick ``cudnn_bf16_ms`` times: the stage's 18 convs as lrelu +
    ``F.conv1d`` on bf16 tensors (cuDNN's bf16 kernels).  It rounds every
    conv's output, the intermediate and the running value to bf16, so it is
    another function than K1's bf16 mode; the port never calls it.  Returns
    the function to time (weights laid out for ``F.conv1d`` beforehand)."""
    import torch.nn.functional as F

    bf16 = torch.bfloat16
    convs = [(w1.permute(0, 3, 2, 1).contiguous(), b1.to(bf16), w2.permute(0, 3, 2, 1).contiguous(), b2.to(bf16))
             for w1, b1, w2, b2 in w16]

    def stage():
        xc = x.transpose(1, 2).to(bf16)
        out = None
        for (w1, b1, w2, b2), k, dils in zip(convs, KERNELS, DILATIONS):
            cur = xc
            for di, d in enumerate(dils):
                t = F.conv1d(F.leaky_relu(cur, 0.1), w1[di], b1[di], padding=(k * d - d) // 2, dilation=d)
                cur = cur + F.conv1d(F.leaky_relu(t, 0.1), w2[di], b2[di], padding=(k - 1) // 2)
            out = cur if out is None else out + cur
        return out / len(KERNELS)
    return stage


def promoted_sum_check(mrf) -> dict:
    """One bf16 convolution at (C, k, d) = (256, 11, 1), 4,096 frames, against
    float64 on the same rounded operands, beside cuDNN's f32 conv on them:
    each mean error and its share signed toward zero.  The kernel sums each
    tap's chain from zero and adds the taps in f32; it must stay within 3×
    cuDNN's mean error (a single truncating chain per output read ~6×)."""
    import torch.nn.functional as F

    g = torch.Generator().manual_seed(11)
    c, k = 256, 11
    x = torch.randn((1, 4096, c), generator=g).cuda()
    w = (torch.randn((k, c, c), generator=g) * 0.1).to(torch.bfloat16).cuda()
    bias = (torch.randn((c,), generator=g) * 0.1).cuda()
    a = F.leaky_relu(x, mrf.LRELU_SLOPE).to(torch.bfloat16)
    ref = F.conv1d(a.double().transpose(1, 2), w.double().permute(2, 1, 0), bias.double(),
                   padding=k // 2).transpose(1, 2)
    cudnn = F.conv1d(a.float().transpose(1, 2), w.float().permute(2, 1, 0), bias, padding=k // 2).transpose(1, 2)
    got = mrf.conv_taps(x, w, bias, 1)
    torch.cuda.synchronize()
    out = {}
    for name, v in (("kernel", got), ("cudnn_f32", cudnn)):
        e = v.double() - ref
        out[name] = dict(mean_abs=float(e.abs().mean()), toward_zero=float((e * ref.sign()).mean() / e.abs().mean()))
    out["ratio"] = out["kernel"]["mean_abs"] / out["cudnn_f32"]["mean_abs"]
    print(f"[precision] K1 bf16 one conv (256, 11, 1), 4096 frames, against float64: kernel mean "
          f"{out['kernel']['mean_abs']:.3e} (signed toward zero {out['kernel']['toward_zero']:+.3f}), cuDNN f32 mean "
          f"{out['cudnn_f32']['mean_abs']:.3e} ({out['cudnn_f32']['toward_zero']:+.3f}): {out['ratio']:.2f}x cuDNN "
          f"(bound 3x)")
    if not out["ratio"] <= 3:
        raise RuntimeError(f"K1's bf16 sums err {out['ratio']:.2f}x cuDNN f32's")
    return out


def precision_kernel(mrf) -> list:
    """K1's bf16 mode against its plain twin at the four stage shapes of a
    512-frame utterance, at batch 8 and 32, ragged and at the window shapes;
    its time beside the plain twin's, cuDNN's bf16 convs' (the yardstick) and,
    timed alternately in the same call, K1's f32 mode's; its kernel launches
    in one stage, read from a CUDA graph capture of one call.

    Beside the error against the twin it prints the stage's bf16-against-f32
    gap (the twin on bf16 weights against the twin on the f32 weights) and
    the witness of the rounding flips: the twin summed in float64 with the
    same rounding points, against the f32 twin and against the kernel."""
    from emojivoice_tpu_torch.kernels.launches import kernel_launches

    rows = []
    for i, (b, c, t) in enumerate(BF16_SHAPES):
        x, w = random_stage(b, c, t, seed=100 + i)
        w16 = bf16_weights(w)
        got = mrf.mrf_stage(x, w16, KERNELS, DILATIONS)
        ref = mrf.mrf_stage_reference(x, w16, KERNELS, DILATIONS)
        packed16, packed32 = mrf.pack_weights(w16), mrf.pack_weights(w)
        same_bits = torch.equal(got, mrf.mrf_stage(x, packed16, KERNELS, DILATIONS))
        torch.cuda.synchronize()
        diff = (got - ref).abs()
        err = float(diff.max())
        within = float((diff <= TOL + TOL * ref.abs()).float().mean())
        gap = (ref - mrf.mrf_stage_reference(x, w, KERNELS, DILATIONS)).abs()
        gap_share = quantile(diff, 0.5) / quantile(gap, 0.5)
        unrounded_share = unrounded_gap_share(mrf, x, w16, ref, gap, KERNELS, DILATIONS)
        unit = unit_check(mrf, x, w)
        ref64 = mrf.mrf_stage_reference(x.double(), w16, KERNELS, DILATIONS)
        twin_vs_64, kernel_vs_64 = (ref.double() - ref64).abs(), (got.double() - ref64).abs()
        tol64 = TOL + TOL * ref64.abs()
        witness = dict(twin_within=float((twin_vs_64 <= tol64).double().mean()), twin_max=float(twin_vs_64.max()),
                       kernel_within=float((kernel_vs_64 <= tol64).double().mean()),
                       kernel_max=float(kernel_vs_64.max()))
        del ref64, twin_vs_64, kernel_vs_64, tol64
        ok = bool(torch.isfinite(got).all()) and within >= BF16_WITHIN and err <= BF16_FLIP_TOL and same_bits \
            and gap_share <= BF16_STAGE_SHARE < unrounded_share and unit["ok"]
        plain_ms, bf16_ms = abba_ms(lambda: mrf.mrf_stage_reference(x, w16, KERNELS, DILATIONS),
                                    lambda: mrf.mrf_stage(x, packed16, KERNELS, DILATIONS))
        f32_ms, bf16_ms_again = abba_ms(lambda: mrf.mrf_stage(x, packed32, KERNELS, DILATIONS),
                                        lambda: mrf.mrf_stage(x, packed16, KERNELS, DILATIONS))
        cudnn_bf16_ms = statistics.median(cuda_ms(cudnn_bf16_stage(x, w16), iters=5))
        gflop = 2 * sum(2 * len(d) * k for k, d in zip(KERNELS, DILATIONS)) * c * c * t * b / 1e9
        # x read and out written once (f32), the 36 bf16 conv weights and the f32 biases read once
        nbytes = 4 * 2 * x.numel() + sum(w1.numel() + w2.numel() for w1, _, w2, _ in w16) * 2 \
            + 4 * sum(b1.numel() + b2.numel() for _, b1, _, b2 in w16)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = gflop * 1e9 / BF16_FLOPS * 1e3
        rows.append(dict(B=b, C=c, T=t, max_abs_err=err, within_tol=within, ok=ok, ms=bf16_ms, plain_ms=plain_ms,
                         f32_ms=f32_ms, ms_beside_f32=bf16_ms_again, gflop=gflop, tflops=gflop / bf16_ms,
                         bound_ms=max(ops_ms, bytes_ms), bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                         bytes_ms=bytes_ms, err_median=quantile(diff, 0.5), err_p99=quantile(diff, 0.99),
                         gap_median=quantile(gap, 0.5), gap_p99=quantile(gap, 0.99), gap_max=float(gap.max()),
                         gap_share=gap_share, unrounded_share=unrounded_share, witness=witness, unit=unit,
                         cudnn_bf16_ms=cudnn_bf16_ms, share_of_bound=max(ops_ms, bytes_ms) / bf16_ms,
                         launches_per_stage=kernel_launches(lambda: mrf.mrf_stage(x, packed16, KERNELS, DILATIONS),
                                                            ("k1_bf16_unit_kernel",))))
        print(f"[precision] K1 bf16 B={b} C={c:3d} T={t:6d}  max_abs_err={err:.3e} against the twin, "
              f"{100 * within:.3f} % within {TOL}  "
              f"bf16 {bf16_ms:9.3f} ms ({gflop / bf16_ms:6.2f} TFLOP/s)  plain {plain_ms:9.3f} ms  "
              f"f32 (3xTF32) {f32_ms:9.3f} ms against bf16 {bf16_ms_again:9.3f} ms, alternated  "
              f"bound {rows[-1]['bound_ms']:.4f} ms by {rows[-1]['bound_by']} (bf16 at 989 TFLOP/s; bytes alone "
              f"{bytes_ms:.4f} ms), {100 * rows[-1]['share_of_bound']:.1f} % of it  "
              f"{rows[-1]['launches_per_stage']} kernel launches a stage (graph capture)  cuDNN bf16 convs (yardstick, another function) "
              f"{cudnn_bf16_ms:9.3f} ms  packed = contract bits: {same_bits}  {'ok' if ok else 'MISMATCH'}")
        print(f"[precision]   error against the twin: median {rows[-1]['err_median']:.3e} p99 "
              f"{rows[-1]['err_p99']:.3e}; the bf16-against-f32 gap of the stage: median {rows[-1]['gap_median']:.3e} "
              f"p99 {rows[-1]['gap_p99']:.3e} max {rows[-1]['gap_max']:.3e}; median error / median gap "
              f"{gap_share:.4f} (bound {BF16_STAGE_SHARE}; unrounded activations would give "
              f"{unrounded_share:.4f}); one dilation unit (k=11, d=1): median error / median gap "
              f"{unit['gap_share']:.4f} (bound {BF16_GAP_SHARE}; unrounded {unit['unrounded_share']:.4f}), "
              f"{100 * unit['within']:.3f} % within {TOL}; flip witness, against the twin summed in float64 with the "
              f"same rounding points: the f32 twin (cuDNN) {100 * witness['twin_within']:.4f} % within {TOL}, max "
              f"{witness['twin_max']:.3e}; the kernel {100 * witness['kernel_within']:.4f} %, max "
              f"{witness['kernel_max']:.3e}: flip share kernel {100 * (1 - witness['kernel_within']):.4f} %, cuDNN "
              f"{100 * (1 - witness['twin_within']):.4f} % (on an H100 the earlier single-chain design flipped 0.31 % "
              f"at C = 256, cuDNN 0.035 %)")
        del x, w, w16, got, ref, packed16, packed32, diff, gap
    if not all(r["ok"] for r in rows):
        raise RuntimeError("K1's bf16 mode disagrees with its plain twin")
    return rows


def precision_pipeline(mrf, pipe) -> dict:
    """The pipeline in three settings (f32, ``vocoder_dtype=bf16``,
    ``compute_dtype=bf16``) at batch 1 two-stage and batch 8 and 32 fused:
    wall, rtf_w and stage ms, the wav against f32 (``vocoder_dtype``) and the
    mel against f32 (``compute_dtype``), and the K1 launches by mode of each
    counted request; then one streaming chunk in bf16 mode.  Returns the K1
    bf16 launches of the counted runs."""
    import numpy as np

    from emojivoice_tpu_torch import config
    from emojivoice_tpu_torch.inference.pipeline import SynthesisPipeline
    from emojivoice_tpu_torch.inference.streaming import StreamingVocoder
    from emojivoice_tpu_torch.utils.buckets import pick_bucket

    bf16 = torch.bfloat16
    pipes = {"f32": pipe}
    for name, kw in (("vocoder_dtype", dict(vocoder_dtype=bf16)), ("compute_dtype", dict(compute_dtype=bf16))):
        pipes[name] = SynthesisPipeline.from_random(config.get_preset(PRESET), seed=0, device=DEVICE,
                                                    cleaners=("basic_cleaners",), **kw)
    first = pipe.synthesise([HEADLINE], spks=[79], n_timesteps=STEPS, seed=0, vocode=False)[0]
    bucket = pick_bucket(first.mel_length, pipe.mel_buckets)
    kw = dict(n_timesteps=STEPS, denoiser_strength=STRENGTH)
    bf16_launches, out = 0, {}
    for b in PRECISION_BATCHES:
        req = dict(texts=[HEADLINE] * b, spks=[79] * b, seed=list(range(b)), **kw)
        if b > 1:
            req.update(fused=True, fused_mel_bucket=bucket)
        results = {}
        for name, p in pipes.items():
            p.synthesise(**req)  # warm
            walls = []
            for _ in range(PRECISION_TIMED):
                mrf.launches.clear()  # the counted run: the last timed call
                t = time.perf_counter()
                res = p.synthesise(**req)
                walls.append((time.perf_counter() - t) * 1e3)
            by_mode = {m: sum(n for (c, mode), n in mrf.launches.items() if mode == m) for m in ("f32", "bf16")}
            want = "f32" if name == "f32" else "bf16"
            if by_mode[want] != 4 or sum(by_mode.values()) != 4:
                raise RuntimeError(f"[precision] {name} batch {b}: K1 launches by mode {by_mode}, expected 4 {want}")
            if name != "f32":
                bf16_launches += by_mode["bf16"]
            check_wavs(res, f"[precision] {name} batch {b}")
            results[name] = res
            row = dict(setting=name, batch=b, fused=b > 1, wall_ms=statistics.median(walls), wall_ms_all=walls,
                       rtf_w=res[0].rtf_w, stage_ms=res[0].stage_ms, k1_launches=by_mode,
                       mel_lengths=sorted({r.mel_length for r in res}))
            ref = results["f32"]
            if name == "vocoder_dtype":
                row["wav_max_abs_vs_f32"] = max(float(np.abs(r.wav - f.wav).max()) for r, f in zip(res, ref))
                row["mel_max_abs_vs_f32"] = max(float(np.abs(r.mel - f.mel).max()) for r, f in zip(res, ref))
                if not (0 < row["wav_max_abs_vs_f32"] < VOCODER_TOL and row["mel_max_abs_vs_f32"] <= 1e-5):
                    raise RuntimeError(f"[precision] vocoder_dtype batch {b}: {row}")
            if name == "compute_dtype":
                lengths = [abs(r.mel_length - f.mel_length) for r, f in zip(res, ref)]
                maes = [float(np.abs(r.mel[:n] - f.mel[:n]).mean()) for r, f, n in
                        zip(res, ref, (min(r.mel_length, f.mel_length) for r, f in zip(res, ref)))]
                row.update(mel_mae_vs_f32=max(maes), mel_length_diff=max(lengths))
                if not (max(lengths) <= MEL_LENGTH_TOL and 0 < max(maes) < MEL_MAE_TOL):
                    raise RuntimeError(f"[precision] compute_dtype batch {b}: {row}")
            print("[precision] pipeline " + json.dumps(row))
            out[f"{name}_b{b}"] = row
    # one streaming chunk in bf16 mode: the chunks go through the pipeline's _vocode, K1's bf16 mode
    pv = pipes["vocoder_dtype"]
    res = pv.synthesise([HEADLINE], spks=[79], n_timesteps=STEPS, seed=7, vocode=False)[0]
    ml = res.mel_length
    mel = torch.nn.functional.pad(torch.from_numpy(res.mel).cuda(), (0, 0, 0, -ml % 64))
    mono = pv._vocode(mel[None])[0, : ml * 256].cpu().numpy()
    sv = StreamingVocoder(pv.vocoder, 64, 8, vocode_fn=pv._vocode)
    list(sv.stream(mel, ml))  # warm the window shapes
    torch.cuda.synchronize()
    mrf.launches.clear()
    t = time.perf_counter()
    chunks = list(sv.stream(mel, ml))
    total_ms = (time.perf_counter() - t) * 1e3
    calls = mrf.launches.copy()
    streamed = np.concatenate(chunks)
    stream = dict(chunks=len(chunks), ms_per_chunk=total_ms / len(chunks), k1_bf16_launches=sum(calls.values()),
                  max_abs_vs_monolithic=float(np.abs(streamed - mono).max()), peak=float(np.abs(mono).max()))
    print("[precision] streaming, vocoder_dtype=bf16, chunk 64, overlap 8 " + json.dumps(stream))
    if streamed.shape != mono.shape or set(m for _, m in calls) != {"bf16"} or stream["k1_bf16_launches"] != 4 * len(chunks) \
            or not stream["max_abs_vs_monolithic"] < VOCODER_TOL:
        raise RuntimeError(f"[precision] streaming in bf16 mode: {stream}, launches {dict(calls)}")
    out["stream"] = stream
    out["k1_bf16_launches"] = bf16_launches + stream["k1_bf16_launches"]
    del pipes
    return out


def precision_training(matcha, mas, state, batch, seed: int, f32_steps_per_s: float) -> dict:
    """The acoustic train step in ``bf16-mixed`` at the ``[train] step`` shape:
    its loss against the f32 step's from the same weights and step, K2 on the
    step's bf16 log-prior against the plain search, the step by stage and
    steps per second, peak memory."""
    from emojivoice_tpu_torch.training.state import create_train_state, train_step
    from emojivoice_tpu_torch.utils.timing import StageClock

    def fresh():
        st = create_train_state(state.model.cfg, state.opt_cfg, model=copy.deepcopy(state.model), device=DEVICE)
        st.step = state.step
        return st

    losses = {}
    seen = {}
    real = matcha.maximum_path

    def capture(value, mask):
        path = real(value, mask)
        seen.setdefault(value.dtype, (value, mask, path))
        return path
    matcha.maximum_path = capture
    try:
        for precision in ("f32", "bf16-mixed"):
            losses[precision] = {k: float(v) for k, v in train_step(fresh(), batch, seed, precision=precision).items()}
    finally:
        matcha.maximum_path = real
    value, mask, path = seen[torch.bfloat16]
    plain = mas.maximum_path_reference(value, mask)
    k2_exact = torch.equal(path, plain) and path.dtype == torch.bfloat16 and not mas.path_faults(path.float(), mask)
    rel = abs(losses["bf16-mixed"]["loss"] - losses["f32"]["loss"]) / abs(losses["f32"]["loss"])
    print(f"[precision] bf16-mixed train step against f32 from the same weights, step and draws: loss "
          f"{losses['bf16-mixed']['loss']:.6f} against {losses['f32']['loss']:.6f} (rel {rel:.3e}, bound {TRAIN_RTOL}); "
          f"K2 on the step's bf16 log-prior {tuple(value.shape)} equal to the plain search: {k2_exact}")
    if not (rel < TRAIN_RTOL and k2_exact and all(math.isfinite(v) for v in losses["bf16-mixed"].values())):
        raise RuntimeError(f"[precision] bf16-mixed step: losses {losses}, K2 exact {k2_exact}")

    st = fresh()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mas.launches = 0  # the main path's run: K2 in the bf16-mixed steps
    stage_ms = []
    for _ in range(2 + 5):  # two to warm
        clock = StageClock(torch.device(DEVICE))
        train_step(st, batch, seed, clock=clock, precision="bf16-mixed")
        torch.cuda.synchronize()
        stage_ms.append(clock.elapsed_ms())
    med = {k: statistics.median(m[k] for m in stage_ms[2:]) for k in stage_ms[0]}
    n = 10
    t = time.perf_counter()
    for _ in range(n):
        train_step(st, batch, seed, precision="bf16-mixed")
    torch.cuda.synchronize()
    steps_per_s = n / (time.perf_counter() - t)
    out = dict(steps_per_s=steps_per_s, f32_steps_per_s=f32_steps_per_s, ratio=steps_per_s / f32_steps_per_s,
               forward_ms=med["forward"], backward_ms=med["backward"], optimizer_ms=med["optimizer"],
               batch=batch["y"].shape[0], t_text=batch["x"].shape[1], t_mel=batch["y"].shape[1],
               peak_gb=torch.cuda.max_memory_allocated() / 1e9, loss_rel_vs_f32=rel, k2_exact=k2_exact,
               k2_launches=mas.launches)
    print("[precision] bf16-mixed step " + json.dumps(out))
    if mas.launches != 2 + 5 + n:
        raise RuntimeError(f"[precision] {mas.launches} K2 launches in {2 + 5 + n} bf16-mixed steps")
    del st
    return out


def conformer_root():
    """emoji_multi with all three decoder block types conformer, HiFi-GAN v1."""
    from emojivoice_tpu_torch import config

    root = config.get_preset(PRESET)
    dec = dataclasses.replace(root.model.decoder, down_block_type="conformer", mid_block_type="conformer",
                              up_block_type="conformer")
    return dataclasses.replace(root, model=dataclasses.replace(root.model, decoder=dec))


def bn_buffers(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items() if ".conv.net.5.running_" in k}


def conformer_serving(mrf) -> tuple:
    """(a) The conformer model served on the card: batch 1 two-stage and batch
    8 fused through K1, the card against the CPU, one request with
    ``strict_mask=True`` and one with ``vocoder_dtype=bf16``."""
    from emojivoice_tpu_torch.apps.emoji import EMOJI_MAPPING
    from emojivoice_tpu_torch.inference.pipeline import SynthesisPipeline
    from emojivoice_tpu_torch.models.matcha import MatchaTTS
    from emojivoice_tpu_torch.utils.buckets import pick_bucket

    root = conformer_root()
    t = time.perf_counter()
    pipe = SynthesisPipeline.from_random(root, seed=0, device=DEVICE, cleaners=("basic_cleaners",))
    print(f"[conformer] {PRESET} with conformer down/mid/up blocks + HiFi-GAN v1, random weights (seed 0), "
          f"{sum(p.numel() for p in pipe.model.parameters()) / 1e6:.2f} M parameters, built in "
          f"{time.perf_counter() - t:.2f} s")
    cpu_reference_check(pipe, tag="conformer")
    kw = dict(n_timesteps=STEPS, denoiser_strength=STRENGTH, keep_mel=True, pcm16=True)
    emoji8 = list(EMOJI_MAPPING.values())[:8]
    texts8 = [f"{TEXT11} Request number {i}." for i in range(8)]

    def request(p, name, texts, spks, seed, mode="f32", **extra):
        before = dict(mrf.launches)
        t = time.perf_counter()
        res = p.synthesise(texts, spks=spks, seed=seed, **{**kw, **extra})
        wall_ms = (time.perf_counter() - t) * 1e3
        delta = {c: mrf.launches[(c, mode)] - before.get((c, mode), 0) for c in (256, 128, 64, 32)}
        if any(n != 1 for n in delta.values()) or sum(mrf.launches.values()) - sum(before.values()) != 4:
            raise RuntimeError(f"[conformer] {name}: K1 launches per stage width {delta} in mode {mode}, expected "
                               f"one on each of four")
        check_wavs(res, name)
        print(f"[conformer] (a) {name}: batch {len(res)}  mel_lengths {[r.mel_length for r in res]}  wall "
              f"{wall_ms:.3f} ms  rtf_w {res[0].rtf_w:.5f}  stage ms "
              + " ".join(f"{k}={v:.3f}" for k, v in res[0].stage_ms.items()) + f"  K1 launches ({mode}) {delta}")
        return res

    def serve():
        first = request(pipe, "batch 1 two-stage, the headline", [HEADLINE], [79], 0)[0]
        request(pipe, "batch 8 fused", texts8, emoji8, list(range(8)), fused=True,
                fused_mel_bucket=pick_bucket(first.mel_length, pipe.mel_buckets))
        return first

    serve()  # first-call allocations and plans for these shapes
    mrf.launches.clear()  # the main path's run: only these requests move the counts
    first = serve()
    launches = sum(mrf.launches.values())

    strict = MatchaTTS(root.model, strict_mask=True)
    strict.load_state_dict(pipe.model.state_dict(), strict=True)
    strict_pipe = SynthesisPipeline(root.model, strict, root.vocoder, pipe.vocoder, device=DEVICE,
                                    cleaners=("basic_cleaners",))
    mrf.launches.clear()
    got = request(strict_pipe, "strict_mask=True, batch 1", [HEADLINE], [79], 0)[0]
    launches += sum(mrf.launches.values())
    strict_equal = got.mel_length == first.mel_length and bool((got.mel == first.mel).all())
    print(f"[conformer] (a) strict_mask=True: every decoder block is a conformer, whose attention masks with "
          f"-finfo.max whatever strict_mask says, so the mel equals the default's to the bit: {strict_equal}")
    if not strict_equal:
        raise RuntimeError("[conformer] strict_mask changed a conformer U-Net's output")

    bf16_pipe = SynthesisPipeline(root.model, pipe.model, root.vocoder, pipe.vocoder, device=DEVICE,
                                  cleaners=("basic_cleaners",), vocoder_dtype=torch.bfloat16)
    request(bf16_pipe, "vocoder_dtype=bf16, batch 1 (warm)", [HEADLINE], [79], 0, mode="bf16")
    mrf.launches.clear()
    got = request(bf16_pipe, "vocoder_dtype=bf16, batch 1", [HEADLINE], [79], 0, mode="bf16", pcm16=False)[0]
    bf16_launches = sum(mrf.launches.values())
    f32 = pipe.synthesise([HEADLINE], spks=[79], seed=0, n_timesteps=STEPS, denoiser_strength=STRENGTH)[0]
    wav_err = float(abs(got.wav - f32.wav).max()) if got.wav.shape == f32.wav.shape else float("inf")
    mel_err = float(abs(got.mel - f32.mel).max()) if got.mel.shape == f32.mel.shape else float("inf")
    print(f"[conformer] (a) vocoder_dtype=bf16 against f32 on the same mel: wav max-abs {wav_err:.3e} (bound "
          f"{VOCODER_TOL}), mel max-abs {mel_err:.3e}")
    if not (wav_err < VOCODER_TOL and mel_err < 1e-5):
        raise RuntimeError(f"[conformer] bf16 vocoder off f32: wav {wav_err}, mel {mel_err}")
    return pipe, launches, bf16_launches


def conformer_training(mas, mrf, matcha, pipe, transformer_step: dict) -> dict:
    """(b) 20 steps of the trainer on the conformer model, fine-tuned from a
    reference-format file of (a)'s weights, with the loggers and a validation
    render; K2 every step, the BatchNorm statistics moving, finite, and left
    alone by each render; one step card against CPU; the step by stage beside
    the transformer model's.  (c) The run's ``ckpts/`` served through
    ``from_checkpoint`` and exported to one bundle key, held against the live
    pipeline."""
    import warnings

    import numpy as np

    from emojivoice_tpu_torch.apps.emoji import EMOJI_MAPPING
    from emojivoice_tpu_torch.data.dataset import BucketBatcher, TextMelDataset
    from emojivoice_tpu_torch.inference.export import LoadedBundle, export_bundle
    from emojivoice_tpu_torch.inference.pipeline import SynthesisPipeline
    from emojivoice_tpu_torch.io.checkpoint import CheckpointManager
    from emojivoice_tpu_torch.io.export_torch import export
    from emojivoice_tpu_torch.training import train
    from emojivoice_tpu_torch.training.state import batch_to_device, create_train_state
    from emojivoice_tpu_torch.training.synthetic import make_alignable_dataset

    seed, root = 1234, conformer_root()
    out = {}
    with tempfile.TemporaryDirectory(prefix="emojivoice_conformer_") as tmp:
        tmp = Path(tmp)
        train_list, val_list, _ = make_alignable_dataset(tmp / "corpus", list(EMOJI_MAPPING.values()),
                                                         n_utts=2 * TRAIN_BATCH, seed=0, long_texts=True)
        CheckpointManager(str(tmp / "start")).save(0, {"model": pipe.model.state_dict(), "step": 0}, cfg=root)
        ckpt = export(str(tmp / "start"), str(tmp / "conformer.ckpt"))
        start_bn = bn_buffers(pipe.model)

        renders = []
        real_synth = SynthesisPipeline.synthesise

        def watched(self, texts, **kw):
            before = bn_buffers(self.model)
            res = real_synth(self, texts, **kw)
            after = bn_buffers(self.model)
            renders.append(all(torch.equal(v, before[k]) for k, v in after.items()) and not self.model.training)
            return res

        run = tmp / "run"
        args = ["--preset", PRESET, "--device", DEVICE, "--train_filelist", str(train_list), "--valid_filelist",
                str(val_list), "--out_dir", str(run), "--batch_size", str(TRAIN_BATCH), "--overfit_batches", "1",
                "--from_torch_ckpt", str(ckpt), "--max_steps", str(TRAIN_STEPS), "--val_every_steps", str(EVERY),
                "--ckpt_every_steps", str(TRAIN_STEPS), "--log_every", "1", "--seed", str(seed),
                "--loggers", "csv,tensorboard", "--render_val_samples", "1"]
        SynthesisPipeline.synthesise = watched
        mas.launches = 0  # the main path's run: only the trainer moves K2's count
        try:
            t = time.perf_counter()
            if train.main(args) != 0:
                raise RuntimeError("[conformer] training run failed")
            train_s = time.perf_counter() - t
        finally:
            SynthesisPipeline.synthesise = real_synth
        out["k2_launches"] = mas.launches
        steps, vals = read_metrics(run, "train"), read_metrics(run, "val")
        expect = TRAIN_STEPS + len(vals)  # one val batch a pass
        if mas.launches != expect or len(vals) != TRAIN_STEPS // EVERY:
            raise RuntimeError(f"[conformer] K2 launches {mas.launches}, expected {expect} ({TRAIN_STEPS} steps + "
                               f"{len(vals)} val batches)")
        bad = [r["step"] for r in steps if not all(math.isfinite(r[k]) for k in ("loss", "grad_norm"))]
        restored = CheckpointManager(str(run / "ckpts")).restore(TRAIN_STEPS)["model"]
        trained_bn = {k: v for k, v in restored.items() if k in start_bn}
        bn_moved = min(float((v.cpu() - start_bn[k].cpu()).abs().max()) for k, v in trained_bn.items())
        bn_finite = all(bool(torch.isfinite(v).all()) for v in trained_bn.values())
        tb = run / "tb"
        # a render's image goes to a PNG where matplotlib imports and into the event file where tensorboard does
        logged = dict(csv=(tb / "metrics.csv").exists(), jsonl=(tb / "scalars.jsonl").exists(),
                      events=len(list(tb.glob("events.out.tfevents.*"))), images=len(list(tb.glob("val_mel_0_*.png"))),
                      matplotlib=importlib.util.find_spec("matplotlib") is not None)
        print(f"[conformer] (b) train.main --from_torch_ckpt <conformer .ckpt>, batch {TRAIN_BATCH}, "
              f"{TRAIN_STEPS} steps in {train_s:.2f} s with data, 2 val passes and renders: loss "
              f"{steps[0]['loss']:.4f} -> {steps[-1]['loss']:.4f}; K2 launches {mas.launches}; BatchNorm statistics "
              f"({len(trained_bn)} buffers) moved by at least {bn_moved:.3e}, finite {bn_finite}; renders "
              f"{len(renders)}, each in eval mode and leaving the statistics equal: {all(renders)}; loggers "
              f"{json.dumps(logged)}")
        images_ok = logged["images"] == len(renders) if logged["matplotlib"] else logged["events"] == 1
        if bad or not (bn_finite and bn_moved > 0 and len(renders) == TRAIN_STEPS // EVERY and all(renders)
                       and logged["csv"] and logged["jsonl"] and images_ok):
            raise RuntimeError(f"[conformer] training run: non-finite steps {bad}, statistics moved {bn_moved} "
                               f"finite {bn_finite}, renders {renders}, loggers {logged}")

        data_cfg = dataclasses.replace(root.data, train_filelist_path=str(train_list),
                                       valid_filelist_path=str(val_list), batch_size=TRAIN_BATCH, seed=seed)
        batch = batch_to_device(next(iter(BucketBatcher(TextMelDataset(str(train_list), data_cfg), TRAIN_BATCH,
                                                        seed=seed))), DEVICE)
        state = create_train_state(root.model, root.optimizer, device=DEVICE,
                                   model=copy.deepcopy(pipe.model).train())
        state.model.load_state_dict(restored)
        card_vs_cpu(matcha, state, batch, mas, tag="conformer")
        step = step_by_stage(matcha, state, batch, seed)
        out["step"] = step
        print("[conformer] (b) step " + json.dumps(step))
        print("[conformer] (b) transformer model's step, same batch size and bucket " + json.dumps(transformer_step))
        del state

        # (c) the trained checkpoint served through K1, and exported to one bundle key
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            served = SynthesisPipeline.from_checkpoint(str(run / "ckpts"), device=DEVICE, cleaners=("basic_cleaners",))
        served.synthesise([TEXT11], spks=[79], seed=0, n_timesteps=STEPS, denoiser_strength=STRENGTH)
        mrf.launches.clear()
        res = served.synthesise([TEXT11], spks=[79], seed=0, n_timesteps=STEPS, denoiser_strength=STRENGTH,
                                pcm16=True)
        out["k1_launches"] = sum(mrf.launches.values())
        check_wavs(res, "(c) trained conformer checkpoint")
        if out["k1_launches"] != 4:
            raise RuntimeError(f"[conformer] serving the trained checkpoint made {out['k1_launches']} mrf_stage calls")
        m_bucket = min(EXPORT_MEL_BUCKETS)
        bundle_dir = tmp / "bundle"
        t = time.perf_counter()
        export_bundle(served, str(bundle_dir), text_buckets=[EXPORT_TEXT_BUCKET], mel_buckets=[m_bucket],
                      batches=(1,), n_timesteps=STEPS, denoiser_strength=STRENGTH)
        export_s = time.perf_counter() - t
        bundle = LoadedBundle(str(bundle_dir), device=DEVICE)
        mrf.launches.clear()
        got, _ = bundle.synthesise([HEADLINE], spks=[79], seed=[0])
        out["k1_launches"] += sum(mrf.launches.values())
        want = served.synthesise([HEADLINE], spks=[79], seed=[0], n_timesteps=STEPS, denoiser_strength=STRENGTH,
                                 fused=True, fused_mel_bucket=m_bucket, keep_mel=False)[0]
        same = got[0]["mel_length"] == want.mel_length and got[0]["wav"].shape == want.wav.shape
        err = float(np.abs(got[0]["wav"].astype(np.float32) - want.wav).max()) if same else float("inf")
        print(f"[conformer] (c) from_checkpoint(ckpts/, step {TRAIN_STEPS}): mel_length {res[0].mel_length}, K1 "
              f"launches 4; exported at batch 1 x text {EXPORT_TEXT_BUCKET} x mel {m_bucket} in {export_s:.2f} s "
              f"(BatchNorm in eval mode, the gather's index static at the bucket): the headline's mel_length "
              f"{got[0]['mel_length']} against the live {want.mel_length}, wav max-abs {err:.3e} (bound {EXPORT_TOL})")
        if not err <= EXPORT_TOL:
            raise RuntimeError(f"[conformer] bundle against the live pipeline: {err}")
    return out


def phase_conformer(mas, mrf, matcha, transformer_step: dict) -> dict:
    """Phase 10: the conformer configuration on the card (serving, training,
    serving what was trained)."""
    t = time.perf_counter()
    pipe, k1, k1_bf16 = conformer_serving(mrf)
    trained = conformer_training(mas, mrf, matcha, pipe, transformer_step)
    print(f"[conformer] phase in {time.perf_counter() - t:.1f} s")
    return dict(k1_launches=k1 + trained["k1_launches"], k1_bf16_launches=k1_bf16, k2_launches=trained["k2_launches"],
                step=trained["step"])


def phase_scratch(mas) -> dict:
    """Phase 11: ``run_scratch_proof`` at emoji_multi from random init on the
    card, the emergence asserts on (the free-synthesis budget off): the
    diagonality and the MAS drift must improve from the first probe to the
    last."""
    from emojivoice_tpu_torch.training.scratch_proof import run_scratch_proof

    with tempfile.TemporaryDirectory(prefix="emojivoice_scratch_") as tmp:
        mas.launches = 0  # the main path's run
        t = time.perf_counter()
        s = run_scratch_proof(PRESET, tmp, steps=SCRATCH_STEPS, batch_size=8, probe_every=SCRATCH_STEPS // 4,
                              lr=5e-4, scheduler="cosine", warmup_steps=50, lr_end=5e-5, log_every=20,
                              assert_free_synth=False, device=DEVICE)
        wall = time.perf_counter() - t
    expect = SCRATCH_STEPS + len(s["probe_steps"])
    first, last = 0, -1
    print(f"[scratch] run_scratch_proof({PRESET}) from random init, {SCRATCH_STEPS} steps at batch 8 in {wall:.1f} s "
          f"({s['step_rate']}): diagonality {s['diagonality'][first]} -> {s['diagonality'][last]}, MAS drift "
          f"{s['mas_drift_l1'][first]} -> {s['mas_drift_l1'][last]}, dur_mse_log {s['dur_mse_log'][first]} -> "
          f"{s['dur_mse_log'][last]}; free synthesis {s['free_synth']['frames_pred']} frames against "
          f"{s['free_synth']['frames_gt']} (length_err {s['free_synth']['length_err']}, not held at this length); "
          f"K2 launches {mas.launches}")
    if not (s["diagonality"][last] > s["diagonality"][first] and s["mas_drift_l1"][last] < s["mas_drift_l1"][first]):
        raise RuntimeError("[scratch] diagonality and MAS drift did not both improve")
    if mas.launches != expect:
        raise RuntimeError(f"[scratch] K2 launches {mas.launches}, expected {expect} (steps + probes)")
    return dict(k2_launches=mas.launches, wall_s=wall)


def phase_sweep(mas) -> dict:
    """Phase 12: ``emojivoice-sweep-torch`` in process, three trials of 10
    steps at emoji_multi, the third with ``--out_size 31`` (no multiple of
    4: its U-Net fails in the first forward, after its model is built).  The
    card's memory must come back after every trial, the failed one included."""
    from emojivoice_tpu_torch.apps.emoji import EMOJI_MAPPING
    from emojivoice_tpu_torch.training import sweep, train
    from emojivoice_tpu_torch.training.synthetic import make_alignable_dataset

    with tempfile.TemporaryDirectory(prefix="emojivoice_sweep_") as tmp:
        tmp = Path(tmp)
        train_list, val_list, _ = make_alignable_dataset(tmp / "corpus", list(EMOJI_MAPPING.values()), n_utts=16,
                                                         seed=0)
        real = train.main
        # the baseline with no garbage of the earlier phases left in it: the sweep collects after every trial
        gc.collect()
        torch.cuda.empty_cache()
        allocated = [torch.cuda.memory_allocated()]

        def trial(argv):  # the memory each trial starts from: the previous trial's release is behind it
            allocated.append(torch.cuda.memory_allocated())
            return real(argv)

        train.main = trial
        mas.launches = 0  # the main path's run
        try:
            t = time.perf_counter()
            rc = sweep.main(["--out_dir", str(tmp / "sweep"), "--grid", "--space", "out_size=choice:128,256,31",
                             "--objective", "val/loss", "--", "--preset", PRESET, "--device", DEVICE,
                             "--train_filelist", str(train_list), "--valid_filelist", str(val_list),
                             "--batch_size", "8", "--max_steps", "10", "--val_every_steps", "10",
                             "--ckpt_every_steps", "0", "--log_every", "5", "--render_val_samples", "0",
                             "--loggers", "csv"])
            wall = time.perf_counter() - t
        finally:
            train.main = real
        allocated.append(torch.cuda.memory_allocated())
        summary = json.loads((tmp / "sweep" / "summary.json").read_text())
        recs = [json.loads(line) for line in (tmp / "sweep" / "trials.jsonl").read_text().splitlines()]
    grew = [(a - allocated[0]) / 2**20 for a in allocated[2:]]  # [0] the baseline, [1] trial 0's start, then after each
    print(f"[sweep] emojivoice-sweep-torch in process, 3 trials x 10 steps at {PRESET} in {wall:.1f} s: ranking "
          f"{json.dumps(summary['ranking'])}; records " + json.dumps(
              [{k: r[k] for k in ("trial", "status", "objective", "objective_from")} for r in recs])
          + f"; memory_allocated after each trial against before the first: {[round(g, 2) for g in grew]} MB; "
          f"K2 launches {mas.launches}")
    if rc != 0 or summary["n_failed"] != 1 or not recs[2]["status"].startswith("error") \
            or [r["trial"] for r in summary["ranking"]] != sorted((0, 1), key=lambda i: recs[i]["objective"]) \
            or any(r["objective_from"] != "val" for r in summary["ranking"]):
        raise RuntimeError(f"[sweep] rc {rc}, summary {summary}")
    if max(abs(g) for g in grew) > 64:
        raise RuntimeError(f"[sweep] the card's memory did not come back after a trial: {grew} MB")
    if mas.launches < 2 * 10:
        raise RuntimeError(f"[sweep] {mas.launches} K2 launches in two trials of 10 steps")
    return dict(k2_launches=mas.launches, wall_s=wall, memory_mb=grew)


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

    from emojivoice_tpu_torch.kernels.build import build_log, build_many, load_mas, load_mrf, load_mrf_bf16
    from emojivoice_tpu_torch.models import matcha
    from emojivoice_tpu_torch.ops import mas, mrf

    t0 = t = time.perf_counter()

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        print(f"[time] {name}: {time.perf_counter() - t:.1f} s (the smoke at {time.perf_counter() - t0:.1f} s)")
        return out

    build_many(("mrf", "mrf_bf16", "mas"))
    load_mrf()
    load_mrf_bf16()
    load_mas()
    print(f"[build] K1 (f32 and bf16) and K2 built (one nvcc each, together) and loaded in "
          f"{time.perf_counter() - t:.2f} s")
    for name in ("mrf", "mrf_bf16", "mas"):
        for line in build_log(name).splitlines():
            if "ptxas info" in line and ("registers" in line or "Compiling" in line):
                print(f"[build] {name}.cu: {line.strip()}")

    tile_err = tile_check(mrf)
    rows = timed("kernel K1", phase_kernel, mrf)
    if not all(r["ok"] for r in rows):
        raise RuntimeError("K1 disagrees with its plain twin")
    pipe, launches = timed("synth", phase_synthesis, mrf)
    mas_rows = timed("kernel K2", phase_kernel_mas, mas)
    training = timed("train + vocoder", phase_training, mas, mrf)
    serving = timed("serve", phase_serving, pipe, mrf)
    exported = timed("export", phase_export, pipe, mrf)
    bf16_tile_err = bf16_tile_check(mrf)
    promoted = promoted_sum_check(mrf)
    bf16_rows = timed("precision kernel", precision_kernel, mrf)
    precision = timed("precision pipeline", precision_pipeline, mrf, pipe)
    conformer = timed("conformer", phase_conformer, mas, mrf, matcha, training["step"])
    scratch = timed("scratch", phase_scratch, mas)
    swept = timed("sweep", phase_sweep, mas)
    # K1 on the main paths: the synthesis requests, the engine's and the webapp's batches, the trained checkpoint,
    # the vocoder proof's two renders, the fine-tuned generator served, the exported bundle's program runs, the
    # live dispatch under sync debug, and the conformer model's requests, its trained checkpoint and bundle; K2:
    # the trainer's steps and get_durations, the conformer's training, the scratch proof and the sweep's trials
    launches += serving["k1_launches"] + training["k1_launches"] + exported["k1_launches"] \
        + exported["k1_launches_live"] + conformer["k1_launches"]
    k2_launches = training["launches"] + conformer["k2_launches"] + scratch["k2_launches"] + swept["k2_launches"]

    stage_rows = rows[:len(STAGE_SHAPES)]
    window_rows = rows[-len(WINDOW_SHAPES):]
    bf16_stage, bf16_window = bf16_rows[:len(STAGE_SHAPES)], bf16_rows[-len(WINDOW_SHAPES):]
    bf16_b8 = bf16_rows[len(STAGE_SHAPES)]
    bf16_batched = bf16_rows[len(STAGE_SHAPES) + 1:][:len(BF16_BATCHED_SHAPES)]
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
        "launches_in_exported_programs": exported["k1_launches"],
    }, {
        "name": "K1 mrf_resblock_bf16 (HiFi-GAN MRF stage, K1's bf16 mode: wgmma bf16 from a rounded tile, "
                "promoted f32 sums, fused dilation units)",
        "route": "cuda",
        "source": "emojivoice_tpu_torch/csrc/mrf_bf16.cu",
        "replaces": "emojivoice_tpu/ops/pallas_mrf.py:192",
        "launches": precision["k1_bf16_launches"] + conformer["k1_bf16_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in bf16_rows),
        "ms": sum(r["ms"] for r in bf16_stage),
        "plain_ms": sum(r["plain_ms"] for r in bf16_stage),
        "bound_ms": sum(r["bound_ms"] for r in bf16_stage),
        "bound_by": "operations" if all(r["bound_by"] == "operations" for r in bf16_stage) else "bytes",
        "library_ms": None,  # no single PyTorch call computes an MRF stage
        # the stage's 18 convs as cuDNN bf16 convs: a yardstick of another function (bf16 conv outputs), not called
        "cudnn_bf16_ms": sum(r["cudnn_bf16_ms"] for r in bf16_stage),
        "shape": "the four stages of a 512-frame utterance, B = 1",
        "weights": "bf16, packed (K-major stages) once, outside the timed region",
        # kernel launches of one stage, read from a CUDA graph capture of one call
        "launches_per_stage": {str(r["C"]): r["launches_per_stage"] for r in bf16_stage},
        "share_of_bound_per_stage": {str(r["C"]): r["share_of_bound"] for r in bf16_stage},
        "f32_mode_ms_alternated": sum(r["f32_ms"] for r in bf16_stage),
        "ms_alternated_with_f32": sum(r["ms_beside_f32"] for r in bf16_stage),
        "ms_b8_c128": bf16_b8["ms"],
        "f32_mode_ms_b8_c128": bf16_b8["f32_ms"],
        "bound_ms_b8_c128": bf16_b8["bound_ms"],
        "batched": {f"B={r['B']} C={r['C']}": {"ms": r["ms"], "bound_ms": r["bound_ms"],
                                               "launches_per_stage": r["launches_per_stage"]} for r in bf16_batched},
        "ms_stream_window": sum(r["ms"] for r in bf16_window),  # the four stages of one 80-frame streaming window
        "bound_ms_stream_window": sum(r["bound_ms"] for r in bf16_window),
        "launches_per_stage_stream_window": {str(r["C"]): r["launches_per_stage"] for r in bf16_window},
        "tile_rel_err_vs_float64": bf16_tile_err,
        "one_conv_mean_err_vs_cudnn_f32": promoted["ratio"],  # at (256, 11, 1) against float64
        "flip_share_c256": 1 - bf16_stage[0]["witness"]["kernel_within"],
        "flip_share_c256_cudnn_f32": 1 - bf16_stage[0]["witness"]["twin_within"],
        "within_tol_min": min(r["within_tol"] for r in bf16_rows),
        "gap_share_stage_max": max(r["gap_share"] for r in bf16_rows),  # median error / median bf16-f32 gap
        "gap_share_unit_max": max(r["unit"]["gap_share"] for r in bf16_rows),
    }, {
        "name": "K2 mas_path_f32 (monotonic alignment search)",
        "route": "cuda",
        "source": "emojivoice_tpu_torch/csrc/mas.cu",
        "replaces": "emojivoice_tpu/ops/mas_pallas.py:51",
        "launches": k2_launches,
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
