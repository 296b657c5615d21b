"""Drive the PyTorch port's paths once on one NVIDIA GPU: synthesis
(text → pcm16), acoustic-model training, the vocoder's fine-tune on the
acoustic model's own mels, the serving front ends (batching engine,
streaming vocoder, long-form, CLI, webapp, and trained checkpoints served),
the apps (the FeelMe agent with Whisper and a chat LM on the card, the case
studies, the Pepper relay and the recording tools),
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
     same weights and noise on the CPU.  Every pipeline of the
     smoke serves through captured CUDA graphs (``inference/graphs.py``, the
     default on the card; a mesh's stays eager), so these counts and every
     later phase's read K1 under replay;
  3b. graphs — fresh emoji_multi + v1 pipelines in f32 and with
     ``compute_dtype=bf16``, each beside an eager one (``graphs=False``) on
     the same weights: two-stage and fused at batch 1, 8 and 32, each call a
     replay held against the eager call with the same inputs (equal to the
     bit, or the f32 wav within 1e-5 and bf16 within the ``[precision]``
     bounds, printed), then again with another length_scale, temperature,
     denoiser strength, seeds and speakers (fused: no new capture), four K1
     launches a call in the setting's mode; the first key replayed after all
     the others; K1's kernel nodes in every vocoder graph (the node walk of
     ``kernels/launches.py``) against its four stages' launches captured
     alone; the story streamed and long-form against the eager path; the
     engine's warmup at ``max_batch`` 8 and 32 (graphs and pool bytes), and
     32 webapp-style calls from threads on its batch-1 key, each equal to its
     own eager call with no capture;
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
     at emoji_multi width and batch 16, each step through its captured CUDA
     graph (``training/graphs.py``, the trainer's default on the card): 20
     steps on one overfit batch with a validation pass, a probe and a
     checkpoint every 10, then 4 more after ``--resume``.  Losses and gradient norms must be finite, K2 must launch
     once per train step, validation batch and probe and no more, the
     resumed run must go from step 20 to 24, and the eval step's
     ``dur_loss + prior_loss`` on the overfit batch must be lower after the
     20 steps than before.  K2 is held against its plain version on the
     batch's own log-prior, one step is timed by stage, and a four-row train
     step on the card (K2) is held against the CPU (plain MAS on the same
     log-prior).  The step by stage is read on the eager step (a graph has
     no stages to mark), steps per second through the graph.  Then
     ``[precision]``: the same step in ``bf16-mixed`` from
     the same weights, its loss within rtol 0.05 of the f32 step's, K2 on its
     bf16 log-prior equal to the plain search, the step by stage (two warm,
     median of 5), steps per second beside f32's and peak memory.  Before the
     run's folder is removed,
     ``SynthesisPipeline.from_checkpoint`` serves the checkpoint directory the
     trainer wrote: one utterance on the card, K1 on all four stages;
  6. vocoder training — still inside the training run's folder: (a)
     ``get_durations.main`` on the run's ``ckpts/`` and filelist with
     ``--gen_mels``, each batch's forward through its captured graph (the
     default): K2 launches once per batch, every teacher-forced mel has
     as many frames as its durations sum to, the first batch's path
     equals the plain search on the same log-prior to the bit, and every
     durations file and mel equals that of the same call with ``--eager``
     to the bit; (b)
     ``run_vocoder_proof`` at HiFi-GAN v1 width with the full MPD + MSD,
     batch 16 × 32 frames (8,192 samples), conditioned on (a)'s mels, 60
     steps logged every 5: the harness's own assert wants the windowed
     mel-L1 lower at the end, and its two renders go through K1; (c) one GAN
     step of 4 rows on the card against the same step on the CPU from the
     same state (the generator that (b) trained, seeded discriminators) and
     batch, the five metrics within rtol 1e-3 (cuDNN against the CPU's convs,
     f32 both); (c') 4 GAN steps through the captured graph against 4 eager
     steps from one seed, under deterministic kernels: metrics and every
     parameter equal to the bit; (d) the eager step by stage with CUDA
     events, steps per second and host enqueue ms through graphs, eagerly
     and eagerly with plain Adams in turns, one replay under sync debug,
     the enqueue ms of replays from an idle card, capture ms, pool bytes and
     peak memory at batch 16; (e) the generator that (b)
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
     bundle key at ``CONFORMER_EXPORT_STEPS`` Euler steps, the bundle within
     1e-5 of the live fused call at the same count;
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

13. apps (run right after 7, on its pipeline) — (a) ``FeelMe`` turns over a
     ``ScriptedLLM`` and a file sink, ``pipelined`` on and off: eleven
     one-sentence replies, one per emoji, and a three-sentence reply that
     ``choose_strategy`` sends down ``pipelined`` (three segments): each turn's
     speaker is the emoji's, the played audio is what its synthesis calls
     made (mel_length·256 samples a call, the segments with their gaps),
     finite, the files written in [-1, 1], K1 on all four stages per call;
     each turn's wall and time to first audio; (b) ``demos.render_script`` of
     a two-line script, ``demos.run_story`` into ``to_play-<i>.wav`` relayed
     by ``pepper.run_storytelling`` over ``LocalTransport``, ``demos.run_game``
     with a two-turn ASR and the console UI, ``record_audio.resample_tree`` and
     ``make_filelist`` over the renders, K1 counted per call; (c) Whisper
     (``WhisperConfig()``, whisper-tiny's widths) and GPT-2 (``GPT2Config()``,
     124 M) from transformers' PyTorch classes, random weights from seed 0,
     the stub tokenizer of ``tests/test_flax_adapters.py``: a wav of (a)
     transcribed, a chat turn greedy and sampled (replayed from its seed), one
     ``FeelMe.run`` turn with all three models on the card, ms per call, and
     each greedy decode held against the CPU (first-step logits within 1e-4,
     ids equal up to the first step whose top-2 margin on the CPU is under
     1e-4); (d) the Llama family at full width: Llama-3.2-1B at its
     published config (``LLAMA32``: 16 layers, 32 / 8 heads, ``llama3``
     rotary at base 500000, tied head), random f32 weights made on the card,
     through ``TorchChatLM``'s default (``LlamaDecoder``'s graphs) against
     ``graphs=False``: its rotary tables against the model's own, 64-token
     replies at bucket 256 greedy and sampled in turns, graphed against eager
     and the card against the CPU (the prefill and three steps) as in (c)
     with ``LLAMA_TOL``, capture ms and pool bytes; a tiny BART decoder
     through ``TorchChatLM()`` on the card takes ``BartDecoder``'s graphs,
     decodes as ``graphs=False`` does and ends in eos; (e) the five other families with decode steps at their
     published widths (``FAMILY_CONFIGS``: gpt-neo-125M, opt-350m,
     xglm-564M, bloom-560m, gpt-j-6B), random f32 weights from seed 0 made
     on the card, each through ``TorchChatLM``'s default (its decoder's
     graphs) against ``graphs=False``: 64-token replies at the prompt's
     bucket graphed against eager (greedy and sampled) and the card
     against the CPU (the prefill and three steps; GPT-J's at 2 of its 28
     layers) with ``LLAMA_TOL``, device ms per token against the weight-read
     bound, capture ms per key and pool bytes; then one agent turn with
     OPT-350m through graphs, spoken through the pipeline (K1 counted);
     (f) the rest of the Flax ``generate``'s chat rules: Llama-3.2-1B with
     the Instruct's published sampling fields (``LLAMA32_INSTRUCT_GEN``:
     top_p 0.9 at temperature 0.6; top_k unset, so the reference's 50),
     64-token sampled replies through graphs against ``graphs=False`` draw
     for draw and in turns, the first step's kept sets after top-k and
     after top-k then top-p against the smoke's own plain warpers on the CPU
     (``plain_kept``); BART-large's decoder
     (``BART_LARGE``, ``no_repeat_ngram_size`` 0: ``FlaxChatLM`` cannot run
     the published 3) through ``BartDecoder``, greedy and with 4 beams
     (``early_stopping`` True), graphed against eager and the card against
     the CPU at 2 of its 12 layers, 64-token replies in turns, capture ms
     and pool bytes; then one agent turn through the beam search (K1
     counted).  After [bench], one greedy 64-token reply of GPT-2 and of Llama-3.2-1B
     profiled each way.

 14. parallel (last) — (a) ``train.main`` with ``--num_devices 1`` (NCCL at
     world size 1, DDP), batch 16, 3 steps, a checkpoint and ``--resume`` for
     one more, its losses and gradient norms within 1e-5 of the same run
     without the flag (two runs without it show the card's own spread: its
     backward adds atomically), K2 once per step; (b) two ranks spawned on the one card over gloo (NCCL
     refuses two ranks on one card), dropout 0 by config override and the
     prenet's fixed 0.5 set to 0: a DDP step (8 rows a rank), a TP-2 step and
     a conformer DDP step, each from the seeded state on one batch of 16,
     against the one-process step on the card (losses and gradient norm rtol
     1e-4, parameters atol 2e-4 and mean 2e-6, the conformer's BatchNorm
     buffers rtol 1e-4 atol 1e-6); (c) on the same ranks the TP-2 pipeline's
     headline (wav 1e-3, mel MAE 1e-3), the DP-2 pipeline's 8 seeded rows at
     batch 8 (wav 1e-4) and the same rows with K1's bf16 mode (2e-2) against
     one process, every rank launching K1 on all four stages of every request
     (each rank's counts are added into the kernel record); (d) the TP-2
     state through ``torch.distributed.checkpoint`` and back into a state
     from another seed, equal to the bit.  Every rank's wait is bounded.
 16. train_graphs (before bench) — the acoustic train step through its
     captured CUDA graphs against the eager step at the [train] step's shape
     (16 × 256 × 1,536) and one of half its length, interleaved, from one
     seeded state, dropout on, under deterministic kernels: (a) f32,
     bf16-mixed and the conformer decoder, metrics, parameters, Adam's
     moments and buffers equal to the bit; (b) a checkpoint written from
     graphs resumed eagerly on a state from another seed, and the reverse,
     equal to the bit, and a plain (not capturable) Adam's checkpoint, as one
     written on the CPU or before the card's was capturable holds it, resumed through graphs and
     eagerly, equal to the bit with the optimizer capturable again; (c) ``train.py``'s validation render (a mel-only
     pipeline made once on the live model) after the graphed steps equal to
     the one after the eager steps and to a pipeline made afresh; (d) K2
     once a step, replays included; (e) steps per second in turns eager /
     graphs / graphs / eager, capture ms per key, pool bytes, and one
     profiled step of each (device ms, busy share); (f) the eval step at the
     same two keys, each call between two graphed train steps, and the
     trainer's probe on a fixed batch and noise, through their captured
     graphs (``training/eval_graphs.py``) against the eager forwards on the
     same weights, under deterministic kernels: losses and probe outputs
     equal to the bit, K2 once a call (replays included), capture ms per key
     and pool bytes, host ms a call of each in turns (run before (e)'s
     profiled steps); (g) the card's capturable Adam against the plain one on
     4 M elements, 5 steps: the largest difference within a hundredth of lr.
 15. bench (last) — the twelve measurement tools of ``emojivoice_tpu_torch/bench/``
     (the twins of ``bench.py`` and ``tools/``) called in process at
     emoji_multi + HiFi-GAN v1 width with short settings (``BENCH_ARGS``):
     each prints one JSON line naming the card with a float power limit,
     every time in it finite and positive; K1 four ``mrf_stage`` calls a
     vocoded request (four a segment, four a served batch), K2 once a train
     step and equal to the plain search; the headline beside its same-shape
     sweep row (F4); the port's HiFi-GAN v1 count at 1 x 512 frames within
     2 % of the JAX tool's (``docs/artifacts/mfu.json``).

The training run of phase 5 that feeds phase 6, ``get_durations`` and the
vocoder proof run under deterministic kernels (``deterministic``; F10: the
proof's mel-L1 trend then repeats from call to call), and the proof's margin
(start, end, end/start) is printed.

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

import contextlib
import copy
import dataclasses
import gc
import importlib.util
import json
import math
import os
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
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from emojivoice_tpu_torch.bench.util import abba_ms, cuda_ms

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
VOC_GRAPH_STEPS = 4  # [vocoder] (c'): steps of the graphed GAN step against the eager one, equal to the bit
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
# the [apps] phase: eleven one-sentence replies (one per emoji, in EMOJI_MAPPING's order) and a three-sentence story
# whose sentences do not pack into one 120-character segment, so choose_strategy sends it down "pipelined"
APP_LINES = ("I love the way the sea sparkles today.", "You broke my favourite toy again.",
             "Watch me park this rover in one go.", "I lost the last piece of the puzzle.",
             "Sure, another lecture about patience.", "We won the science fair!", "The kettle is on.",
             "The cat just sat on the keyboard and sent my essay.", "A whale just jumped out of the water!",
             "I waved back, but they were waving at someone else.", "Maybe the key is under the old oak tree.")
APP_STORY = ("The little robot rolled down to the harbour to watch the boats. A gull landed on its head and started "
             "to sing a very silly song. The robot laughed so hard that its lights blinked all night long. 😮")
PAR_SEED, PAR_STEPS, PAR_ROWS, PAR_WAIT_S = 1234, 3, 8, 300  # [parallel]: a hung rank fails the run at PAR_WAIT_S
# [parallel]'s bounds at emoji_multi width, f32 with TF32 off, two ranks (or one process at world size 1) against
# one process on the same inputs; only the summation order differs (sharded products, all-reduced sums, other
# batch sizes):
PAR_ONE_RTOL = 1e-5  # (a) --num_devices 1 against no flag: the card's backward is not deterministic (atomic adds)
PAR_LOSS_RTOL = 1e-4  # step losses and gradient norm (the CPU tests' bound against JAX)
PAR_PARAM_ATOL, PAR_PARAM_MEAN = 2e-4, 2e-6  # after one Adam step at lr 1e-4: a near-zero gradient summed in another
# order can flip its element's step (2 lr); the mean error over all elements stays far below
PAR_BN_RTOL, PAR_BN_ATOL = 1e-4, 1e-6  # the conformer's BatchNorm buffers after one step
PAR_WAV_TP, PAR_MEL_MAE = 1e-3, 1e-3  # TP-2 headline, 10 Euler steps: the card-against-CPU bounds of [synth]
PAR_WAV_DP = 1e-4  # DP-2 rows (tests/test_tp.py:148); bf16 rows at VOCODER_TOL
ADAPTER_TOL = 1e-4  # Whisper and GPT-2, card against CPU, f32 with TF32 off: first-step logits, top-2 margins
# (the same bound holds the adapters' graphed decode against their eager one, graphs=False, on the card)
APP_ROUNDS = 1  # [apps] (c), (d), (f): rounds of (eager, graphs, graphs, eager) for each timed reading
# [apps] (d): Llama-3.2-1B's published config (meta-llama/Llama-3.2-1B config.json), the agent's default chat model
# (Ollama's llama3.2:1b), random weights; its rotary form is given in whichever form the installed transformers takes
LLAMA32 = dict(vocab_size=128256, hidden_size=2048, intermediate_size=8192, num_hidden_layers=16,
               num_attention_heads=32, num_key_value_heads=8, head_dim=64, max_position_embeddings=131072,
               rms_norm_eps=1e-5, hidden_act="silu", tie_word_embeddings=True, bos_token_id=128000,
               eos_token_id=128001, attention_bias=False, mlp_bias=False)
LLAMA32_ROPE = dict(rope_type="llama3", factor=32.0, low_freq_factor=1.0, high_freq_factor=4.0,
                    original_max_position_embeddings=8192)
LLAMA32_THETA = 500000.0
LLAMA_TOL = 1e-4  # Llama-3.2-1B f32, TF32 off: graphed against eager and card against CPU, first-step logits and
# the top-2 margin below which ids may part (the adapters' bound)
LLAMA_CPU_TOKENS = 4  # card against CPU: the prefill and three steps (the CPU reads 4.9 GB of weights a token)
# [apps] (e): the chat LM's families with decode steps of the port's own at their published configs (the hub's
# config.json of each), random f32 weights; (config class, PyTorch class, config, the decoder the default must take)
FAMILY_CONFIGS = {
    "gpt_neo": ("GPTNeoConfig", "GPTNeoForCausalLM", dict(  # EleutherAI/gpt-neo-125M
        vocab_size=50257, hidden_size=768, num_layers=12, num_heads=12, attention_types=[[["global", "local"], 6]],
        window_size=256, max_position_embeddings=2048, activation_function="gelu_new", bos_token_id=50256,
        eos_token_id=50256), "GPTNeoDecoder"),
    "opt": ("OPTConfig", "OPTForCausalLM", dict(  # facebook/opt-350m
        vocab_size=50272, hidden_size=1024, num_hidden_layers=24, num_attention_heads=16, ffn_dim=4096,
        word_embed_proj_dim=512, do_layer_norm_before=False, max_position_embeddings=2048, activation_function="relu",
        pad_token_id=1, bos_token_id=2, eos_token_id=2), "OPTDecoder"),
    "xglm": ("XGLMConfig", "XGLMForCausalLM", dict(  # facebook/xglm-564M
        vocab_size=256008, d_model=1024, num_layers=24, attention_heads=16, ffn_dim=4096, max_position_embeddings=2048,
        scale_embedding=True, activation_function="gelu", pad_token_id=1, bos_token_id=0, eos_token_id=2),
        "XGLMDecoder"),
    "bloom": ("BloomConfig", "BloomForCausalLM", dict(  # bigscience/bloom-560m
        vocab_size=250880, hidden_size=1024, n_layer=24, n_head=16, layer_norm_epsilon=1e-5,
        apply_residual_connection_post_layernorm=False, pad_token_id=3, bos_token_id=1, eos_token_id=2),
        "BloomDecoder"),
    "gptj": ("GPTJConfig", "GPTJForCausalLM", dict(  # EleutherAI/gpt-j-6B (24.2 GB in f32)
        vocab_size=50400, n_embd=4096, n_layer=28, n_head=16, rotary_dim=64, n_positions=2048,
        activation_function="gelu_new", tie_word_embeddings=False, bos_token_id=50256, eos_token_id=50256),
        "GPTJDecoder"),
}
# [apps] (f1): the sampling fields of meta-llama/Llama-3.2-1B-Instruct's published generation_config.json, set on
# LLAMA32's model (its eos list is not set: the stub tokenizer's replies never reach it either way)
LLAMA32_INSTRUCT_GEN = dict(do_sample=True, temperature=0.6, top_p=0.9)
# [apps] (f2): facebook/bart-large's published config.json, its decoder as BartForCausalLM (as many encoder layers
# as decoder layers: transformers 4.57 sizes the causal LM's cache by the former), random f32 weights; its
# generation fields, with no_repeat_ngram_size 0 where it publishes 3: FlaxChatLM cannot run it (the port refuses it)
BART_LARGE = dict(vocab_size=50265, d_model=1024, decoder_layers=12, encoder_layers=12, decoder_attention_heads=16,
                  encoder_attention_heads=16, decoder_ffn_dim=4096, encoder_ffn_dim=4096, max_position_embeddings=1024,
                  activation_function="gelu", scale_embedding=False, pad_token_id=1, bos_token_id=0, eos_token_id=2,
                  decoder_start_token_id=2, forced_bos_token_id=0, forced_eos_token_id=2)
BART_LARGE_GEN = dict(num_beams=4, early_stopping=True, no_repeat_ngram_size=0, forced_bos_token_id=0,
                      forced_eos_token_id=2, length_penalty=1.0)
BART_CPU_LAYERS = 2  # [apps] (f2): BART-large card against CPU at full width on 2 of its 12 decoder layers
# [conformer] (c): Euler steps of the conformer's bundle, held against the live pipeline at the same count (the export
# unrolls the steps, so its time grows with them; the [export] phase holds the 10-step programs)
CONFORMER_EXPORT_STEPS = 2
GPTJ_CPU_LAYERS = 2  # [apps] (e): GPT-J card against CPU at full width on 2 of its 28 layers (24 GB a token on the CPU)
# [graphs]: each replay against the eager call on the same inputs, equal to the bit; where a library picks another
# algorithm under capture, the f32 wav within GRAPH_WAV_TOL (bf16: the [precision] bounds, VOCODER_TOL and MEL_MAE_TOL)
GRAPH_BATCHES, GRAPH_WAV_TOL, GRAPH_THREADS = (1, 8, 32), 1e-5, 32
K1_KERNEL_NAMES = ("conv_taps_kernel", "k1_bf16_unit_kernel")  # K1's kernels in csrc/mrf.cu and csrc/mrf_bf16.cu


@contextlib.contextmanager
def deterministic(tag: str):
    """Deterministic kernels for the work inside (``warn_only``: an op with
    no deterministic kernel runs as it is and warns); prints the ops that
    warned.  The card's backward adds atomically, so without this two runs of
    the same seeded training differ in their last bits and whatever is
    derived from them drifts (F10: the vocoder proof's mel-L1 trend on the
    acoustic run's mels).  cuBLAS needs ``CUBLAS_WORKSPACE_CONFIG``, which
    ``main`` sets before CUDA starts."""
    seen = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield
        for w in caught:
            text = str(w.message)
            if "does not have a deterministic implementation" not in text:
                warnings.showwarning(w.message, w.category, w.filename, w.lineno)
            elif text.split(" does not")[0] not in seen:
                seen.append(text.split(" does not")[0])
    finally:
        torch.use_deterministic_algorithms(False)
        print(f"[{tag}] deterministic kernels; ops that have none and warned: "
              + (", ".join(seen) if seen else "none"))


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


def graph_check(name: str, got, want, setting: str) -> dict:
    """A call through the graphs against the eager call with the same
    arguments: equal to the bit, or within the bounds (printed)."""
    lengths = [r.mel_length for r in got] == [r.mel_length for r in want]
    same = lengths and all(np.array_equal(g.wav, w.wav) and np.array_equal(g.mel, w.mel) for g, w in zip(got, want))
    wav_err = max(float(abs(g.wav - w.wav).max()) for g, w in zip(got, want)) if lengths else float("inf")
    mel_mae = max(float(abs(g.mel - w.mel).mean()) if g.mel.size else 0.0 for g, w in zip(got, want)) \
        if lengths else float("inf")
    ok = same or (wav_err <= (GRAPH_WAV_TOL if setting == "f32" else VOCODER_TOL)
                  and (setting == "f32" or mel_mae < MEL_MAE_TOL))
    if not same:
        print(f"[graphs] {name}: not equal to the bit; wav max-abs {wav_err:.3e}, mel MAE {mel_mae:.3e}")
    if not ok:
        raise RuntimeError(f"[graphs] {name}: the replay disagrees with the eager call: lengths equal {lengths}, "
                           f"wav max-abs {wav_err:.3e}, mel MAE {mel_mae:.3e}")
    return dict(same_bits=same, wav_max_abs=wav_err, mel_mae=mel_mae)


def capture_beside_threads(gp, ep, voices) -> dict:
    """Captures that nothing outside them may end: every key of one call
    captured anew while a second thread queries, waits on and times events
    and allocates pinned and device memory (as the serving engine's results
    thread does while its worker captures), with the cycle collector's
    threshold at 1, so that it would run inside a capture if it could (a
    graph it frees there ends the capture).  The result against the eager
    path's, and no collection counted inside a capture."""
    stop, calls, errors, inside = threading.Event(), [0], [], []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    end.record()

    def busy():
        try:
            while not stop.is_set():
                end.query()
                end.synchronize()
                start.elapsed_time(end)
                torch.empty(1 << 20, pin_memory=True)
                torch.empty(1 << 20, device=DEVICE)
                calls[0] += 1
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    def watch(phase, info):
        if phase == "start" and torch.cuda.is_current_stream_capturing():
            inside.append(info["generation"])

    kw = dict(spks=[voices[0]], seed=[7], n_timesteps=STEPS, denoiser_strength=STRENGTH)
    gp.graphs.drop()
    captures, threshold = gp.graphs.captures, gc.get_threshold()
    thread = threading.Thread(target=busy, daemon=True)
    gc.callbacks.append(watch)
    gc.set_threshold(1)
    thread.start()
    try:
        got = gp.synthesise([HEADLINE], **kw)
    finally:
        stop.set()
        thread.join()
        gc.set_threshold(*threshold)
        gc.callbacks.remove(watch)
    row = dict(new_captures=gp.graphs.captures - captures, other_thread_rounds=calls[0],
               other_thread_errors=errors, collections_inside_captures=len(inside),
               **graph_check("beside threads", got, ep.synthesise([HEADLINE], **kw), "f32"))
    print("[graphs] keys captured beside a thread that waits on events and allocates, the cycle collector at "
          "threshold 1: " + json.dumps(row))
    if errors or inside or row["new_captures"] != 4 or not calls[0]:
        raise RuntimeError(f"[graphs] captures beside other threads: {row}")
    return row


def graph_k1_nodes(mrf, pipe) -> list:
    """K1's kernel nodes in each vocoder graph of `pipe` (``keep_graphs``),
    against the kernels that its four stages launch alone at the graph's
    shapes, read from a capture of each (``kernels/launches.py``); and the
    store's own count, four ``mrf_stage`` calls a graph."""
    from emojivoice_tpu_torch.kernels.launches import graph_kernel_nodes, kernel_launches

    cfg, rows = pipe.vocoder_cfg, []
    ks, ds = cfg.resblock_kernel_sizes, tuple(tuple(d) for d in cfg.resblock_dilation_sizes)
    for (key, _), g in pipe.graphs.entries().items():
        if key[0] != "vocoder":
            continue
        _, b, frames, dtype = key
        per_stage, t, c = [], frames, cfg.upsample_initial_channel
        with mrf.tally() as counted:  # captures, not launches: taken back below
            for i, u in enumerate(cfg.upsample_rates):
                t, c = t * u, c // 2
                x = torch.randn(b, t, c, device="cuda")
                per_stage.append(kernel_launches(lambda: mrf.mrf_stage(x, pipe.vocoder.stage_weights(i, dtype), ks, ds),
                                                 K1_KERNEL_NAMES))
                del x
        mrf.add_launches(counted, -1)
        nodes = graph_kernel_nodes(g.graph, K1_KERNEL_NAMES)
        row = dict(batch=b, frames=frames, mode="bf16" if dtype == torch.bfloat16 else "f32", k1_nodes=nodes,
                   per_stage=per_stage, mrf_stage_calls=sum(g.k1.values()))
        if nodes != sum(per_stage) or row["mrf_stage_calls"] != len(cfg.upsample_rates):
            raise RuntimeError(f"[graphs] vocoder graph {key}: {row}")
        rows.append(row)
    return rows


def phase_graphs(mrf) -> dict:
    """Phase [graphs]: serving through captured CUDA graphs (the pipeline's
    default on the card), each replay against the eager path
    (``graphs=False``) on the same weights and inputs; every count is read
    from 0 just before the graph call it counts."""
    from emojivoice_tpu_torch import config
    from emojivoice_tpu_torch.apps.emoji import EMOJI_MAPPING
    from emojivoice_tpu_torch.inference.pipeline import SynthesisPipeline
    from emojivoice_tpu_torch.inference.serving import BatchingEngine
    from emojivoice_tpu_torch.inference.streaming import auto_stream, stream_synthesise

    root = config.get_preset("emoji_multi")
    voices = list(EMOJI_MAPPING.values())
    out = dict(cases=[], nodes=[], k1_launches=0, k1_bf16_launches=0)

    def counted(pipe, texts, kw):
        mrf.launches.clear()  # the main path's run: this graph call
        t = time.perf_counter()
        res = pipe.synthesise(texts, **kw)
        wall = (time.perf_counter() - t) * 1e3
        by_mode = {m: sum(n for (_, mode), n in mrf.launches.items() if mode == m) for m in ("f32", "bf16")}
        out["k1_launches"] += by_mode["f32"]
        out["k1_bf16_launches"] += by_mode["bf16"]
        return res, wall, by_mode

    for setting, extra in (("f32", {}), ("compute_bf16", dict(compute_dtype=torch.bfloat16))):
        gp = SynthesisPipeline.from_random(root, seed=0, device=DEVICE, cleaners=("basic_cleaners",), graphs=True,
                                           **extra)
        gp.graphs.keep_graphs = True  # each graph's nodes stay readable: K1's are counted below
        ep = SynthesisPipeline(gp.model_cfg, gp.model, gp.vocoder_cfg, gp.vocoder, cleaners=("basic_cleaners",),
                               device=DEVICE, graphs=False, **extra)
        mode = "bf16" if setting != "f32" else "f32"
        first = None
        for fused in (False, True):
            for b in GRAPH_BATCHES:
                base = dict(n_timesteps=STEPS, fused=fused, fused_mel_bucket=512 if fused else None)
                runs = (dict(spks=[voices[i % len(voices)] for i in range(b)], seed=list(range(b)), length_scale=1.0,
                             temperature=0.667, denoiser_strength=STRENGTH),
                        dict(spks=[voices[(i + 5) % len(voices)] for i in range(b)], seed=list(range(100, 100 + b)),
                             length_scale=0.95, temperature=0.5, denoiser_strength=1e-3))
                for i, run in enumerate(runs):
                    name = f"{setting} {'fused' if fused else 'two-stage'} batch {b} run {i}"
                    kw = {**base, **run}
                    captures = gp.graphs.captures
                    got, wall, by_mode = counted(gp, [HEADLINE] * b, kw)
                    new = gp.graphs.captures - captures
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    want = ep.synthesise([HEADLINE] * b, **kw)
                    eager_wall = (time.perf_counter() - t) * 1e3
                    if by_mode != {"f32": 4 if mode == "f32" else 0, "bf16": 4 if mode == "bf16" else 0}:
                        raise RuntimeError(f"[graphs] {name}: K1 launches by mode {by_mode}, expected 4 {mode}")
                    if i == 1 and fused and new:
                        raise RuntimeError(f"[graphs] {name}: other runtime values captured {new} new graphs")
                    check_wavs(got, name)
                    row = dict(name=name, new_captures=new, graph_wall_ms=wall, eager_wall_ms=eager_wall,
                               mel_length=got[0].mel_length, **graph_check(name, got, want, setting))
                    print("[graphs] " + json.dumps(row))
                    out["cases"].append(row)
                    if first is None:
                        first = (kw, got)
        # a key replayed after the others: its static buffers and K1's TMA maps still point at the right memory
        again, _, _ = counted(gp, [HEADLINE], first[0])
        graph_check(f"{setting} first key again", again, first[1], setting)
        if not all(np.array_equal(a.wav, f.wav) for a, f in zip(again, first[1])):
            raise RuntimeError(f"[graphs] {setting}: the first key replayed after the others differs from its first run")
        out["nodes"] += graph_k1_nodes(mrf, gp)
        out[f"{setting}_capture_ms"] = gp.graphs.stats()["capture_ms"]
        out[f"{setting}_pool_bytes"] = gp.graphs.pool_bytes()
        print(f"[graphs] {setting}: {len(gp.graphs.entries())} graphs, pool {out[f'{setting}_pool_bytes']} bytes, "
              f"capture ms per key {json.dumps(out[f'{setting}_capture_ms'])}")
        if setting != "f32":
            continue

        # streaming: chunked windows and long-form segments through the graphs, against the eager path
        for strat, fn in (("stream", stream_synthesise), ("auto", auto_stream)):
            got = np.concatenate(list(fn(gp, STORY, spk=79, n_timesteps=STEPS, seed=3)))
            want = np.concatenate(list(fn(ep, STORY, spk=79, n_timesteps=STEPS, seed=3)))
            if got.shape != want.shape or not np.array_equal(got, want):
                raise RuntimeError(f"[graphs] {strat} on the story differs from the eager path")
            print(f"[graphs] {strat} on the story: {got.size} samples equal to the eager path's")

        out["beside_threads"] = capture_beside_threads(gp, ep, voices)

        # the engine's warmup, then webapp-style calls from 32 threads on its batch-1 key
        for max_batch in (8, 32):
            gp.graphs.drop()
            torch.cuda.empty_cache()
            with BatchingEngine(gp, max_batch=max_batch, max_wait_ms=10) as eng:
                eng.warmup(n_timesteps=STEPS)
            out[f"pool_bytes_engine_{max_batch}"] = gp.graphs.pool_bytes()
            out[f"graphs_engine_{max_batch}"] = len(gp.graphs.entries())
            print(f"[graphs] engine warmup at max_batch {max_batch}: {out[f'graphs_engine_{max_batch}']} graphs, "
                  f"pool {out[f'pool_bytes_engine_{max_batch}']} bytes")
            if max_batch != 8:
                continue
            captures = gp.graphs.captures
            kws = [dict(spks=[0], seed=i, temperature=0.4 + i / 100, denoiser_strength=STRENGTH * (1 + i % 4),
                        n_timesteps=STEPS, keep_mel=False, pcm16=True) for i in range(GRAPH_THREADS)]
            mrf.launches.clear()
            with ThreadPoolExecutor(GRAPH_THREADS) as pool:
                got = list(pool.map(lambda kw: gp.synthesise(["a " * 10], **kw)[0], kws))
            threaded = sum(mrf.launches.values())
            out["k1_launches"] += threaded
            if gp.graphs.captures != captures or threaded != 4 * GRAPH_THREADS:
                raise RuntimeError(f"[graphs] {GRAPH_THREADS} threads: {gp.graphs.captures - captures} captures, "
                                   f"{threaded} mrf_stage calls")
            for i, (g, kw) in enumerate(zip(got, kws)):
                w = ep.synthesise(["a " * 10], **kw)[0]
                if not np.array_equal(g.wav, w.wav):
                    raise RuntimeError(f"[graphs] thread {i}: its result differs from its own eager call "
                                       f"(max-abs {float(abs(g.wav - w.wav).max()) if g.wav.shape == w.wav.shape else -1})")
            print(f"[graphs] {GRAPH_THREADS} concurrent calls on the engine's batch-1 key: each equal to its own eager "
                  f"call, no capture, {threaded} mrf_stage calls")
        del gp, ep
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[graphs] K1 nodes per vocoder graph against its stages' launches: {json.dumps(out['nodes'])}")
    return out


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


class TimedSink:
    """A ``FileSink`` that also keeps each chunk it is handed and the host
    clock of each ``play``."""

    def __init__(self, out_dir: str):
        from emojivoice_tpu_torch.apps.adapters import FileSink

        self.files = FileSink(out_dir)
        self.marks, self.chunks = [], []

    def play(self, wav, sample_rate: int) -> None:
        self.marks.append(time.perf_counter())
        self.chunks.append(wav)
        self.files.play(wav, sample_rate)


class StubTokenizer:
    """tests/test_flax_adapters.py's stub: words ↔ ids 3-62 (no tokenizer files on the card's machine)."""

    pad_token_id = 0
    eos_token_id = 2
    chat_template = None

    def __call__(self, text):
        return {"input_ids": [3 + (sum(ord(c) for c in tok) % 60) for tok in text.split()]}

    def decode(self, ids, skip_special_tokens=True):
        if skip_special_tokens:
            ids = [i for i in ids if i > 2]
        return " ".join(f"w{i}" for i in ids)


class Synthesised:
    """Counts the pipeline's synthesis calls (``finalize``) inside a window and
    checks K1 against them: one ``mrf_stage`` launch on each of the four
    stage widths per call, and no other."""

    def __init__(self, pipe, mrf, name: str):
        self.pipe, self.mrf, self.name, self.results = pipe, mrf, name, []

    def __enter__(self):
        real = self.pipe.finalize

        def spy(p):
            out = real(p)
            self.results.append(out)
            return out

        self.before = dict(self.mrf.launches)
        self.pipe.finalize = spy
        return self

    def __exit__(self, *exc):
        del self.pipe.finalize
        if exc[0] is not None:
            return False
        n = len(self.results)
        delta = {c: self.mrf.launches[(c, "f32")] - self.before.get((c, "f32"), 0) for c in (256, 128, 64, 32)}
        total = sum(self.mrf.launches.values()) - sum(self.before.values())
        if n == 0 or any(d != n for d in delta.values()) or total != 4 * n:
            raise RuntimeError(f"[apps] {self.name}: K1 launches per stage width {delta} for {n} synthesis calls, "
                               f"expected {n} on each of four")
        return False


def apps_turns(pipe, mrf, tmp: str) -> dict:
    """(a) FeelMe turns, ``pipelined`` on and off: eleven one-sentence replies
    (one per emoji) and a three-sentence one.  Every turn gives the mapping's
    speaker and the played audio its synthesis calls made (each call's
    mel_length·256 samples, the pipelined segments with their gaps), finite;
    the files the sink wrote are in [-1, 1]; K1 on all four stages per call.
    Each turn's wall and its time to first audio (turn start → the first
    ``sink.play``) on the host clock."""
    import numpy as np
    from scipy.io import wavfile

    from emojivoice_tpu_torch.apps import adapters as ad
    from emojivoice_tpu_torch.apps.emoji import EMOJI_MAPPING
    from emojivoice_tpu_torch.apps.feel_me import FeelMe
    from emojivoice_tpu_torch.inference.streaming import choose_strategy

    replies = [f"{line} {emoji}" for line, emoji in zip(APP_LINES, EMOJI_MAPPING)] + [APP_STORY]
    speakers = list(EMOJI_MAPPING.values()) + [EMOJI_MAPPING[APP_STORY[-1]]]
    story_segments = len(choose_strategy(APP_STORY[:-2])[1])
    if choose_strategy(APP_STORY[:-2])[0] != "pipelined" or story_segments < 2:
        raise RuntimeError(f"[apps] (a) the story reply is not pipelined: {choose_strategy(APP_STORY[:-2])}")
    gap = int(0.15 * 22050)
    out = {}
    for counted in (False, True):  # once to warm these texts' buckets, once measured
        if counted:
            mrf.launches.clear()  # the main path's run of (a)
        for pipelined in (True, False):
            sink = TimedSink(f"{tmp}/turns_{pipelined}_{counted}")
            app = FeelMe(pipe, asr=ad.ConsoleASR(), llm=ad.ScriptedLLM(replies), sink=sink, pipelined=pipelined)
            rows = []
            for i, (reply, spk) in enumerate(zip(replies, speakers)):
                played = len(sink.chunks)
                with Synthesised(pipe, mrf, f"(a) turn {i}, pipelined={pipelined}") as calls:
                    t = time.perf_counter()
                    response, got_spk, spoken = app.turn(f"user turn {i}")
                    wall = (time.perf_counter() - t) * 1e3
                chunks = sink.chunks[played:]
                lengths = [r[0].mel_length * 256 for r in calls.results]
                want = [n + gap for n in lengths[:-1]] + lengths[-1:]
                n_calls = story_segments if (pipelined and i == len(replies) - 1) else 1
                if (response, got_spk) != (reply, spk) or len(calls.results) != n_calls \
                        or [len(c) for c in chunks] != want \
                        or not all(np.isfinite(c).all() for c in chunks):
                    raise RuntimeError(f"[apps] (a) turn {i} pipelined={pipelined}: speaker {got_spk} (want {spk}), "
                                       f"{len(calls.results)} calls (want {n_calls}), played {[len(c) for c in chunks]} "
                                       f"(want {want})")
                rows.append(dict(wall_ms=wall, ttfa_ms=(sink.marks[played] - t) * 1e3, calls=n_calls,
                                 peak=max(float(np.abs(c).max()) for c in chunks), chars=len(spoken)))
            for path in sorted(Path(sink.files.out_dir).glob("*.wav")):
                sr, data = wavfile.read(path)
                if sr != 22050 or not (np.isfinite(data).all() and np.abs(data).max() <= 1.0):
                    raise RuntimeError(f"[apps] (a) {path.name}: sr {sr}, peak {np.abs(data).max()}")
            if counted:
                one = rows[:-1]
                row = dict(pipelined=pipelined, turns=len(rows),
                           one_sentence_wall_ms_median=statistics.median(r["wall_ms"] for r in one),
                           one_sentence_ttfa_ms_median=statistics.median(r["ttfa_ms"] for r in one),
                           one_sentence_wall_ms=[r["wall_ms"] for r in one],
                           story_wall_ms=rows[-1]["wall_ms"], story_ttfa_ms=rows[-1]["ttfa_ms"],
                           story_calls=rows[-1]["calls"], story_chars=rows[-1]["chars"],
                           peak_before_the_sink=max(r["peak"] for r in rows))
                print("[apps] (a) FeelMe turns " + json.dumps(row))
                out["pipelined" if pipelined else "full"] = row
                out["wav"] = str(sorted(Path(sink.files.out_dir).glob("*.wav"))[0])
    out["k1_launches"] = sum(mrf.launches.values())
    return out


def apps_case_studies(pipe, mrf, tmp: str) -> dict:
    """(b) The three case studies and the recording tools: ``render_script``
    of a two-line script; ``run_story`` into ``to_play-<i>.wav`` and
    ``pepper.run_storytelling`` relaying those files over ``LocalTransport``;
    ``run_game`` with a two-turn ASR and the console UI; ``resample_tree``
    and ``make_filelist`` over the rendered wavs."""
    import shutil

    import numpy as np
    from scipy.io import wavfile

    from emojivoice_tpu_torch.apps import adapters as ad
    from emojivoice_tpu_torch.apps import demos, game_ui, pepper, record_audio

    out = {}
    script = Path(tmp, "script.txt")
    script.write_text('Byte: 😎 "No worries. I will handle it."\nAlex: The cave is dark and very cold. 😭\n')
    t = time.perf_counter()
    with Synthesised(pipe, mrf, "(b) render_script") as calls:
        demos.render_script(pipe, str(script), f"{tmp}/render", steps=STEPS)
    rendered = sorted(Path(tmp, "render").glob("*.wav"))
    lengths = [wavfile.read(p)[1].shape[0] for p in rendered]
    if len(rendered) != 2 or lengths != [r[0].mel_length * 256 for r in calls.results]:
        raise RuntimeError(f"[apps] (b) render_script wrote {rendered} of {lengths} samples")
    out["render_ms"] = (time.perf_counter() - t) * 1e3

    story = Path(tmp, "story.txt")
    story.write_text(STORY.replace(". ", ".\n"))
    lines = [line for line in story.read_text().splitlines() if line.strip()]
    t = time.perf_counter()
    with Synthesised(pipe, mrf, "(b) run_story") as calls:
        demos.run_story(pipe, str(story), f"{tmp}/story", play=False, steps=STEPS)
    out["story_ms"] = (time.perf_counter() - t) * 1e3
    told = [wavfile.read(Path(tmp, "story", f"to_play-{i}.wav"))[1].shape[0] for i in range(len(lines))]
    if len(calls.results) != len(lines) or told != [r[0].mel_length * 256 for r in calls.results]:
        raise RuntimeError(f"[apps] (b) run_story: {len(calls.results)} calls for {len(lines)} lines, {told}")
    relay = pepper.LocalTransport(f"{tmp}/relayed")
    if pepper.run_storytelling(relay, f"{tmp}/story", str(story), timeout=WAIT_S) != len(lines):
        raise RuntimeError("[apps] (b) run_storytelling did not relay every line")
    relayed = [wavfile.read(Path(tmp, "relayed", f"output{i}.wav"))[1] for i in range(len(lines))]
    if [len(w) for w in relayed] != told or [p[1] for p in relay.played] != [f"to_play-{i}" for i in range(len(lines))] \
            or list(Path(tmp, "story").glob("to_play-*")):
        raise RuntimeError(f"[apps] (b) relay: {[len(w) for w in relayed]} against {told}, {relay.played}")

    class TwoTurns:
        def __init__(self):
            self.lines = iter(["the knight entered the cave", "and found a sleeping dragon", "end session"])

        def transcribe(self, _):
            return next(self.lines)

    t = time.perf_counter()
    with Synthesised(pipe, mrf, "(b) run_game") as calls:
        n = demos.run_game(pipe, steps=STEPS, llm=ad.ScriptedLLM(), asr=TwoTurns(),
                           sink=ad.FileSink(f"{tmp}/game"), ui=game_ui.ConsoleUI())
    out["game_ms"] = (time.perf_counter() - t) * 1e3
    if n != 2 or len(calls.results) != 2 or len(list(Path(tmp, "game").glob("*.wav"))) != 2:
        raise RuntimeError(f"[apps] (b) run_game: {n} turns, {len(calls.results)} calls")

    rec, scripts = Path(tmp, "recordings", "neutral"), Path(tmp, "scripts")
    rec.mkdir(parents=True)
    scripts.mkdir()
    (scripts / "script-neutral.txt").write_text("No worries. I will handle it.\nThe cave is dark and very cold.\n")
    for i, path in enumerate(rendered):
        shutil.copy(path, rec / f"robot-neutral-{i}.wav")
    record_audio.resample_tree(rec.parent, 16000)
    resampled = [wavfile.read(rec / f"robot-neutral-{i}.wav") for i in range(2)]
    rows = record_audio.make_filelist(rec.parent, scripts, {"neutral": 12}, Path(tmp, "train.txt"))
    if [sr for sr, _ in resampled] != [16000, 16000] \
            or [len(d) for _, d in resampled] != [-(-n * 16000 // 22050) for n in lengths] \
            or not all(np.isfinite(d).all() for _, d in resampled) or len(rows) != 2 \
            or not rows[1].endswith("|12|The cave is dark and very cold."):
        raise RuntimeError(f"[apps] (b) recording tools: {[(sr, len(d)) for sr, d in resampled]}, {rows}")
    print(f"[apps] (b) render_script 2 lines, run_story {len(lines)} lines relayed by run_storytelling, run_game 2 "
          f"turns, resample_tree + make_filelist over the renders: " + json.dumps(out))
    return out


def in_turns(fns: dict, rounds: int = APP_ROUNDS, warm: bool = True) -> dict:
    """``fns["graphs"]`` and ``fns["eager"]`` each run once to warm (unless
    the caller has run both), then timed in turns (eager, graphs, graphs,
    eager) `rounds` times, host ms to the end on the device → {mode: median
    ms, mode + "_all": every time}."""
    for fn in fns.values() if warm else ():
        fn()
    times = {mode: [] for mode in fns}
    for _ in range(rounds):
        for mode in ("eager", "graphs", "graphs", "eager"):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fns[mode]()
            torch.cuda.synchronize()
            times[mode].append((time.perf_counter() - t) * 1e3)
    return {**{mode: statistics.median(v) for mode, v in times.items()},
            **{f"{mode}_all": v for mode, v in times.items()}}


def decoded(ids: list, eos: set) -> int:
    """Tokens a decode ran: up to and with the first eos."""
    return next((i + 1 for i, t in enumerate(ids) if t in eos), len(ids))


def decode_against(name: str, got, ref, run, what: str) -> dict:
    """One greedy decode by two adapters on the same weights (``run(adapter,
    logits_out)`` → the new ids; each step's logits land in logits_out): the
    first step's logits within ADAPTER_TOL, and the ids equal up to the
    first step whose top-2 margin in `ref`'s logits is under it."""
    seen = {"got": [], "ref": []}
    ids = {side: run(adapter, seen[side]) for side, adapter in (("got", got), ("ref", ref))}
    first, first_ref = seen["got"][0][0].float().cpu(), seen["ref"][0][0].float().cpu()
    finite = torch.isfinite(first_ref)
    err = float((first[finite] - first_ref[finite]).abs().max())
    margins = [float(v[0] - v[1]) for v in (s[0].float().topk(2).values.cpu() for s in seen["ref"])]
    close = next((k for k, m in enumerate(margins) if m < ADAPTER_TOL), len(margins))
    diff = next((k for k, (a, b) in enumerate(zip(ids["got"], ids["ref"])) if a != b), None)
    row = dict(first_step_max_abs_err=err, steps=len(margins), first_close_step=close, first_differing_step=diff,
               min_margin=min(margins))
    if not (err <= ADAPTER_TOL and (diff is None or diff >= close)):
        raise RuntimeError(f"[apps] {name}: {what} {row}")
    return row


def plain_kept(logits: torch.Tensor, temperature: float, top_k, top_p) -> tuple:
    """The Flax ``generate``'s sampling warpers on one row of logits, written out here apart from the port's
    ``decode.warp``: the logits over the temperature (f32, as on the card), then in f64 on the host the top `top_k`
    (all where None; among ties the lower token id, as ``lax.top_k``), then of those, sorted, the ones whose
    cumulative probability before them is under `top_p` (``FlaxTopPLogitsWarper``: the one that crosses it kept,
    and the first always) → (the kept mask (V,) on the CPU, the cumulative probabilities of the top-k in order)."""
    x = (logits.float().cpu().reshape(-1) / torch.tensor(temperature, dtype=torch.float32)).double().numpy()
    order = np.argsort(-x, kind="stable")[:top_k or None]
    p = np.exp(x[order] - x[order[0]])
    cum = np.cumsum(p / p.sum())
    kept = order if top_p is None else order[np.concatenate(([0.0], cum[:-1])) < top_p]
    mask = np.zeros(x.size, dtype=bool)
    mask[kept] = True
    return torch.from_numpy(mask), cum


def sampled_against(got, ref, run, u: torch.Tensor, temperature: float, name: str = "(c) sampled GPT-2") -> dict:
    """One sampled decode by two adapters on the same weights and uniforms
    `u` (``run`` as in ``decode_against``): the ids equal up to the first step
    whose uniform lies within ADAPTER_TOL of the total of a boundary of the
    drawn token's span of the CDF over the tokens that `ref`'s generation
    config's warpers keep (``plain_kept``: its top-k, then its top-p) in
    `ref`'s logits."""
    search = ref._search
    seen = {"got": [], "ref": []}
    ids = {side: run(adapter, seen[side]) for side, adapter in (("got", got), ("ref", ref))}
    margins = []
    for k, logits in enumerate(seen["ref"]):
        kept = plain_kept(logits[0], temperature, search.top_k, search.top_p)[0]
        probs = torch.softmax((logits[0].double().cpu() / temperature).masked_fill(~kept, -math.inf), -1)
        cdf = probs.cumsum(-1)
        x, tok = float(u[k]) * float(cdf[-1]), ids["ref"][k]
        margins.append(min(x - float(cdf[tok] - probs[tok]), float(cdf[tok]) - x) / float(cdf[-1]))
    close = next((k for k, m in enumerate(margins) if m < ADAPTER_TOL), len(margins))
    diff = next((k for k, (a, b) in enumerate(zip(ids["got"], ids["ref"])) if a != b), None)
    row = dict(steps=len(margins), first_close_step=close, first_differing_step=diff, min_margin=min(margins),
               top_k=search.top_k, top_p=search.top_p)
    if diff is not None and diff < close:
        raise RuntimeError(f"[apps] {name}: graphed against eager {row}")
    return row


def kept_against_cpu(logits: torch.Tensor, search, temperature: float, name: str) -> dict:
    """The tokens the port's sampling warpers (``decode.warp``) keep of one step's (1, V) logits on the card,
    after its top-k alone and after its top-k then its top-p, against ``plain_kept`` on the CPU on the same
    logits: the top-k sets equal; the top-p sets equal, or parted only where the cumulative probability at the
    boundary lies within ADAPTER_TOL of top_p."""
    from emojivoice_tpu_torch.apps.decode import warp

    rows = {}
    for stage, top_p in (("top_k", None), ("top_k_top_p", search.top_p)):
        t = torch.tensor(temperature, device=logits.device)
        card = torch.isfinite(warp(logits, t, search.top_k, top_p))[0].cpu()
        cpu, cum = plain_kept(logits[0], temperature, search.top_k, top_p)
        row = dict(kept=int(card.sum()), kept_cpu=int(cpu.sum()), equal=bool(torch.equal(card, cpu)),
                   vocab=int(cpu.numel()), top_k=search.top_k, top_p=top_p)
        if not row["equal"]:
            lo, hi = sorted((row["kept"], row["kept_cpu"]))  # token i is kept where cum[i - 1] < top_p
            row["boundary_margin"] = float(np.abs(cum[lo - 1:hi - 1] - top_p).min()) \
                if top_p is not None and hi > lo else None
            if row["boundary_margin"] is None or row["boundary_margin"] >= ADAPTER_TOL:
                raise RuntimeError(f"[apps] {name}: the card's warpers keep another set than the plain ones "
                                   f"after {stage} {row}")
        rows[stage] = row
    return rows


def agent_turn(pipe, mrf, asr, llm, wav: str, out_dir: str, counted: bool) -> dict:
    """One whole ``FeelMe.run`` turn (recorder stub → `asr` → `llm` →
    synthesis → sink), the second transcription ending the session: its
    wall and first audio on the host clock, its synthesis calls, with K1
    read from ``mrf.launches`` at 0 where `counted` (the main path's run)."""
    import builtins
    import shutil

    from emojivoice_tpu_torch.apps.feel_me import FeelMe

    class Recorder:
        def record(self, path):
            shutil.copy(wav, path)
            return True

    heard = []
    real = asr.transcribe
    asr.transcribe = lambda path: heard.append(real(path)) or (heard[0] if len(heard) == 1 else "end session")
    sink = TimedSink(out_dir)
    app = FeelMe(pipe, asr=asr, llm=llm, sink=sink, recorder=Recorder(), record_path=f"{out_dir}_in.wav")
    real_input = builtins.input
    builtins.input = lambda *a: ""
    try:
        if counted:
            mrf.launches.clear()  # the main path's run of (c): one agent turn
        with Synthesised(pipe, mrf, "(c) FeelMe.run") as calls:
            t = time.perf_counter()
            app.run()
            wall = (time.perf_counter() - t) * 1e3
        launches = sum(mrf.launches.values())
    finally:
        builtins.input = real_input
        del asr.transcribe
    if len(heard) != 2 or len(app.history) != 2 or not sink.chunks or not all(np.isfinite(c).all() for c in sink.chunks):
        raise RuntimeError(f"[apps] (c) FeelMe.run: heard {heard}, history {app.history}, {len(sink.chunks)} plays")
    return dict(wall_ms=wall, ttfa_ms=(sink.marks[0] - t) * 1e3, calls=len(calls.results), k1_launches=launches,
                transcript_words=len(heard[0].split()), reply_words=len(app.history[1]["content"].split()))


def apps_adapters(pipe, mrf, tmp: str, wav: str) -> dict:
    """(c) Whisper and the chat LM on the card at published widths
    (``WhisperConfig()``: whisper-tiny's, ``GPT2Config()``: GPT-2's 124 M),
    random weights from seed 0, the stub tokenizer.  Each adapter decodes
    through its captured graphs (the default) and, as the yardstick, through
    transformers' forward (``graphs=False``), timed in turns: a wav of (a)
    transcribed, one chat turn of 64 new tokens greedy and sampled.  Graphed
    against eager and the card against the CPU (the CPU decodes through the
    same steps, uncaptured): first-step logits within ADAPTER_TOL and the ids
    equal up to the first close margin, for Whisper and greedy GPT-2; the
    sampled reply equal draw for draw up to the first uniform within
    ADAPTER_TOL of a boundary, and replaying from its seed.  Then whole
    ``FeelMe.run`` turns (recorder stub → ``TorchWhisperASR`` →
    ``TorchChatLM`` → synthesis) with all three models on the card, one to
    warm, then through graphs (the main path's run) and eagerly, in turns."""
    from emojivoice_tpu_torch.apps import adapters as ad
    from emojivoice_tpu_torch.apps.feel_me import PROMPT
    from emojivoice_tpu_torch.apps.torch_adapters import TorchChatLM, TorchWhisperASR, _load_wav_16k, import_transformers
    from emojivoice_tpu_torch.utils.prng import step_generator

    tf = import_transformers()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        whisper = tf.WhisperForConditionalGeneration(tf.WhisperConfig()).eval()
        gpt2 = tf.GPT2LMHeadModel(tf.GPT2Config()).eval()
    whisper_cpu, gpt2_cpu = copy.deepcopy(whisper), copy.deepcopy(gpt2)
    params = {"whisper": sum(p.numel() for p in whisper.parameters()),
              "gpt2": sum(p.numel() for p in gpt2.parameters())}
    asr = TorchWhisperASR(model=whisper, tokenizer=StubTokenizer(), device=DEVICE)
    asr_eager = TorchWhisperASR(model=whisper, tokenizer=StubTokenizer(), device=DEVICE, graphs=False)
    asr_cpu = TorchWhisperASR(model=whisper_cpu, tokenizer=StubTokenizer(), device="cpu")
    chat = dict(tokenizer=StubTokenizer(), max_new_tokens=64)
    greedy = TorchChatLM(model=gpt2, temperature=0.0, device=DEVICE, **chat)
    greedy_eager = TorchChatLM(model=gpt2, temperature=0.0, device=DEVICE, graphs=False, **chat)
    greedy_cpu = TorchChatLM(model=gpt2_cpu, temperature=0.0, device="cpu", **chat)
    out = dict(params=params)

    text = asr.transcribe(wav)
    if not text or text != asr_eager.transcribe(wav):
        raise RuntimeError(f"[apps] (c) Whisper transcribed nothing, or not what the eager decode did: {text!r}")
    feats = asr._fe(_load_wav_16k(wav), sampling_rate=16000, return_tensors="np").input_features
    out["transcribe_ms"] = in_turns({"graphs": lambda: asr.transcribe(wav), "eager": lambda: asr_eager.transcribe(wav)})
    out["whisper_decode_ms"] = in_turns({"graphs": lambda: asr._generate(feats),
                                         "eager": lambda: asr_eager._generate(feats)})

    def run_whisper(adapter, logits):
        return adapter._generate(feats, logits)[0, 1:].tolist()

    out["whisper_graphs_vs_eager"] = decode_against("(c) Whisper", asr, asr_eager, run_whisper, "graphed against eager")
    out["whisper_vs_cpu"] = decode_against("(c) Whisper", asr, asr_cpu, run_whisper, "card against CPU")

    user = "hello robot, tell me a story about the sea"
    ids, mask, bucket = greedy._encode(ad.build_messages(PROMPT, [], user))
    out["chat_bucket"] = bucket
    out["chat_greedy_ms"] = in_turns({"graphs": lambda: greedy.chat(PROMPT, [], user),
                                      "eager": lambda: greedy_eager.chat(PROMPT, [], user)})

    def run_greedy(adapter, logits):
        return adapter._generate(ids, mask, None, logits)[0, bucket:].tolist()

    out["gpt2_graphs_vs_eager"] = decode_against("(c) GPT-2", greedy, greedy_eager, run_greedy, "graphed against eager")
    out["gpt2_vs_cpu"] = decode_against("(c) GPT-2", greedy, greedy_cpu, run_greedy, "card against CPU")

    sampled = [TorchChatLM(model=gpt2, temperature=0.6, seed=0, device=DEVICE, **chat) for _ in range(2)]
    sampled_eager = TorchChatLM(model=gpt2, temperature=0.6, seed=0, device=DEVICE, graphs=False, **chat)
    replies = [[lm.chat(PROMPT, [], user) for _ in range(2)] for lm in sampled]
    if replies[0] != replies[1] or replies[0][0] == replies[0][1] or replies[0][0] == greedy.chat(PROMPT, [], user):
        raise RuntimeError(f"[apps] (c) sampling does not replay from its seed, or does not sample: {replies}")

    def run_sampled(adapter, logits):
        return adapter._generate(ids, mask, step_generator(0, 0, "chat", DEVICE), logits)[0, bucket:].tolist()

    uniforms = torch.rand(64, generator=step_generator(0, 0, "chat", DEVICE), device=DEVICE).cpu()
    out["sampled_graphs_vs_eager"] = sampled_against(sampled[0], sampled_eager, run_sampled, uniforms, 0.6)
    out["chat_sampled_ms"] = in_turns({"graphs": lambda: sampled[0].chat(PROMPT, [], user),
                                       "eager": lambda: sampled_eager.chat(PROMPT, [], user)})
    # the tokens each reading decodes: up to and with eos (random weights rarely reach it)
    out["whisper_tokens"] = decoded(run_whisper(asr, None), asr._eos)
    out["chat_greedy_tokens"] = decoded(run_greedy(greedy, None), greedy._eos)
    out["chat_sampled_tokens"] = decoded(run_sampled(sampled[0], None), greedy._eos)

    # the agent's reply is spoken: the stub spells a token as "w<id>", and English cleaning spells the id out
    # ("wfifty thousand one hundred ..."), so four tokens keep the reply inside the largest text bucket
    agent_kw = dict(model=gpt2, temperature=0.0, device=DEVICE, tokenizer=StubTokenizer(), max_new_tokens=4)
    agent_llm, agent_eager = TorchChatLM(**agent_kw), TorchChatLM(graphs=False, **agent_kw)
    # one turn to warm: the reply's text and mel bucket keys of the pipeline, the prompt's bucket of the LM
    agent_turn(pipe, mrf, asr, agent_llm, wav, f"{tmp}/agent_warm", counted=False)
    replays = asr.graphs.stats()["replays"] + agent_llm.graphs.stats()["replays"]
    turns = {"graphs": [agent_turn(pipe, mrf, asr, agent_llm, wav, f"{tmp}/agent", counted=True)]}
    if asr.graphs.stats()["replays"] + agent_llm.graphs.stats()["replays"] <= replays:
        raise RuntimeError("[apps] (c) FeelMe.run did not decode through the adapters' graphs")
    turns["eager"] = []
    for i, mode in enumerate(("eager", "eager", "graphs")):
        pair = (asr, agent_llm) if mode == "graphs" else (asr_eager, agent_eager)
        turns[mode].append(agent_turn(pipe, mrf, *pair, wav, f"{tmp}/agent_{i}", counted=False))
    main = turns["graphs"][0]
    out.update(agent_turn_ms=main["wall_ms"], agent_ttfa_ms=main["ttfa_ms"], agent_calls=main["calls"],
               k1_launches=main["k1_launches"], transcript_words=main["transcript_words"],
               reply_words=main["reply_words"],
               agent_turns={mode: [dict(wall_ms=r["wall_ms"], ttfa_ms=r["ttfa_ms"]) for r in rows]
                            for mode, rows in turns.items()})
    out["graphs"] = {}
    for name, adapter in (("whisper", asr), ("gpt2_greedy", greedy), ("gpt2_sampled", sampled[0]),
                          ("gpt2_agent", agent_llm)):
        stats = adapter.graphs.stats()
        if not adapter.graphs.capture or stats["captures"] < 2 or stats["graphs"] != stats["captures"]:
            raise RuntimeError(f"[apps] (c) {name} did not decode through captured graphs: {stats}")
        out["graphs"][name] = {**stats, "pool_bytes": adapter.graphs.pool_bytes()}
    print("[apps] (c) adapters on the card " + json.dumps(out))
    out["asr"] = asr  # (e)'s agent turn hears through the same Whisper graphs
    return out


def llama32(tf, device):
    """Llama-3.2-1B at its published config with random weights from seed 0, f32, made on `device` (the card's
    own initialisation: on the CPU a 1.24 B-parameter init takes minutes)."""
    import inspect

    if "rope_parameters" in inspect.signature(tf.LlamaConfig.__init__).parameters:
        cfg = tf.LlamaConfig(**LLAMA32, rope_parameters=dict(LLAMA32_ROPE, rope_theta=LLAMA32_THETA))
    else:
        cfg = tf.LlamaConfig(**LLAMA32, rope_theta=LLAMA32_THETA, rope_scaling=dict(LLAMA32_ROPE))
    with torch.random.fork_rng(devices=[torch.device(device)] if torch.device(device).type == "cuda" else []):
        torch.manual_seed(0)
        with torch.device(device):
            model = tf.LlamaForCausalLM(cfg).float().eval()
    return model


def apps_llama(tmp: str) -> dict:
    """(d) The chat LM's Llama family at full width: Llama-3.2-1B (``LLAMA32``, the agent's default chat
    model) with random weights from seed 0, f32, the stub tokenizer, through ``TorchChatLM``'s default (the
    ``LlamaDecoder`` steps' captured graphs) against ``graphs=False`` (transformers' forward), 64-token replies
    at the prompt's bucket (256), greedy and sampled, in turns; the decoder's rotary tables against the model's
    own rotary module; graphed against eager (first-step logits within LLAMA_TOL, ids equal up to the first
    close margin, the sampled reply draw for draw) and the card against the CPU (the same steps, uncaptured) on
    the prefill and three steps; capture ms per key and pool bytes.  Then a tiny BART decoder through
    ``TorchChatLM()`` on the card: it must take its steps (``BartDecoder``) through captured graphs, decode as
    ``graphs=False`` does and end its reply in eos (the generation config forces it at the last token)."""
    from emojivoice_tpu_torch.apps import adapters as ad
    from emojivoice_tpu_torch.apps.feel_me import PROMPT
    from emojivoice_tpu_torch.apps.torch_adapters import TorchChatLM, import_transformers
    from emojivoice_tpu_torch.utils.prng import step_generator

    tf = import_transformers()
    t = time.perf_counter()
    model = llama32(tf, DEVICE)
    torch.cuda.synchronize()
    out = dict(build_s=time.perf_counter() - t, params=sum(p.numel() for p in model.parameters()),
               weight_bytes=sum(p.numel() * p.element_size() for p in model.parameters()))
    chat = dict(tokenizer=StubTokenizer(), max_new_tokens=64)
    greedy = TorchChatLM(model=model, temperature=0.0, device=DEVICE, **chat)
    greedy_eager = TorchChatLM(model=model, temperature=0.0, device=DEVICE, graphs=False, **chat)
    if greedy.decode != "graphs" or type(greedy._dec).__name__ != "LlamaDecoder":
        raise RuntimeError(f"[apps] (d) Llama-3.2-1B decodes {greedy.decode} through {type(greedy._dec).__name__}")
    dec, rotary = greedy._dec, model.model.rotary_emb
    slots = torch.arange(dec.kv.length, device=DEVICE)[None]
    cos, sin = rotary(dec.cos[None], slots)
    out["rope"] = dict(model_rope_type=getattr(rotary, "rope_type", None), decoder_rope_type=dec.rope_type,
                       inv_freq_equal=bool(torch.equal(dec.inv_freq, rotary.inv_freq.float())),
                       attention_scaling=float(rotary.attention_scaling),
                       cos_max_abs_err=float((cos[0] - dec.cos).abs().max()),
                       sin_max_abs_err=float((sin[0] - dec.sin).abs().max()), slots=dec.kv.length)
    print("[apps] (d) Llama-3.2-1B rotary: " + json.dumps(out["rope"]))
    if not (out["rope"]["decoder_rope_type"] == "llama3" and out["rope"]["inv_freq_equal"]
            and max(out["rope"]["cos_max_abs_err"], out["rope"]["sin_max_abs_err"]) <= 1e-6):
        raise RuntimeError(f"[apps] (d) the decoder's rotary tables are not the model's: {out['rope']}")

    user = "hello robot, tell me a story about the sea"
    ids, mask, bucket = greedy._encode(ad.build_messages(PROMPT, [], user))
    out["bucket"], out["prompt_tokens"] = bucket, int(mask.sum())

    def run_greedy(adapter, logits):
        return adapter._generate(ids, mask, None, logits)[0, bucket:].tolist()

    def run_sampled(adapter, logits):
        return adapter._generate(ids, mask, step_generator(0, 0, "chat", DEVICE), logits)[0, bucket:].tolist()

    out["greedy_ms"] = in_turns({"graphs": lambda: greedy.chat(PROMPT, [], user),
                                 "eager": lambda: greedy_eager.chat(PROMPT, [], user)})
    out["graphs_vs_eager"] = decode_against("(d) Llama-3.2-1B", greedy, greedy_eager, run_greedy, "graphed against eager")
    sampled = TorchChatLM(model=model, temperature=0.6, seed=0, device=DEVICE, **chat)
    sampled_eager = TorchChatLM(model=model, temperature=0.6, seed=0, device=DEVICE, graphs=False, **chat)
    uniforms = torch.rand(64, generator=step_generator(0, 0, "chat", DEVICE), device=DEVICE).cpu()
    out["sampled_graphs_vs_eager"] = sampled_against(sampled, sampled_eager, run_sampled, uniforms, 0.6,
                                                     "(d) sampled Llama-3.2-1B")
    out["sampled_ms"] = in_turns({"graphs": lambda: sampled.chat(PROMPT, [], user),
                                  "eager": lambda: sampled_eager.chat(PROMPT, [], user)})
    out["greedy_tokens"] = decoded(run_greedy(greedy, None), greedy._eos)
    out["sampled_tokens"] = decoded(run_sampled(sampled, None), greedy._eos)
    out["graphs"] = {}
    for name, adapter in (("greedy", greedy), ("sampled", sampled)):
        stats = adapter.graphs.stats()
        if not adapter.graphs.capture or stats["captures"] != 2 or stats["graphs"] != 2:
            raise RuntimeError(f"[apps] (d) Llama {name} did not decode through captured graphs: {stats}")
        out["graphs"][name] = {**stats, "pool_bytes": adapter.graphs.pool_bytes()}
    del greedy_eager, sampled, sampled_eager

    # the card against the CPU: the prefill and three steps, the same steps uncaptured on a copy of the weights
    t = time.perf_counter()
    short = dict(tokenizer=StubTokenizer(), temperature=0.0, max_new_tokens=LLAMA_CPU_TOKENS)
    card = TorchChatLM(model=model, device=DEVICE, **short)
    cpu_model = copy.deepcopy(model).to("cpu")
    cpu = TorchChatLM(model=cpu_model, device="cpu", **short)
    out["vs_cpu"] = decode_against("(d) Llama-3.2-1B", card, cpu, run_greedy, "card against CPU")
    out["vs_cpu"]["seconds"] = time.perf_counter() - t
    del cpu, cpu_model, card
    print("[apps] (d) Llama-3.2-1B on the card " + json.dumps(out))
    del greedy, model
    gc.collect()
    torch.cuda.empty_cache()

    out["bart"] = apps_bart(tf, ids, mask, bucket)
    return out


def apps_bart(tf, ids, mask, bucket: int) -> dict:
    """(d) A tiny BART decoder (its forward takes no position_ids) through ``TorchChatLM()`` on the card: it takes
    its decode steps (``BartDecoder``) through captured graphs, decodes as ``graphs=False`` does and ends its
    64-token reply at the prompt (`ids`, `mask`) in eos (the generation config forces it last)."""
    from emojivoice_tpu_torch.apps.feel_me import PROMPT
    from emojivoice_tpu_torch.apps.torch_adapters import TorchChatLM

    with torch.random.fork_rng(devices=[torch.device(DEVICE)]):
        torch.manual_seed(0)
        bart = tf.BartForCausalLM(tf.BartConfig(vocab_size=96, d_model=64, decoder_layers=2, encoder_layers=2,
                                                decoder_attention_heads=4, encoder_attention_heads=4,
                                                decoder_ffn_dim=128, encoder_ffn_dim=128,
                                                max_position_embeddings=1024)).eval()
    bart.generation_config.forced_eos_token_id = 2
    chat = dict(tokenizer=StubTokenizer(), max_new_tokens=64, temperature=0.0, device=DEVICE)
    lm, lm_eager = TorchChatLM(model=bart, **chat), TorchChatLM(model=bart, graphs=False, **chat)
    reply = lm.chat(PROMPT, [], "hello robot, tell me a story about the sea")
    got = lm._generate(ids, mask)
    stats = lm.graphs.stats() if lm.graphs is not None else {}
    row = dict(decode=lm.decode, decoder=type(lm._dec).__name__, reply_words=len(reply.split()),
               ids_equal_graphs_false=bool(np.array_equal(got, lm_eager._generate(ids, mask))),
               reply_ends_in_eos=bool(2 in got[0, bucket:]), device=str(next(bart.parameters()).device),
               graphs=stats)
    print("[apps] (d) tiny BART decoder through TorchChatLM() " + json.dumps(row))
    if lm.decode != "graphs" or row["decoder"] != "BartDecoder" or not reply or not row["ids_equal_graphs_false"] \
            or lm.device.type != "cuda" or not row["reply_ends_in_eos"] or not lm.graphs.capture \
            or stats["captures"] < 2:  # an early eos, or the forced one last
        raise RuntimeError(f"[apps] (d) BART: {row}")
    return row


def family_model(tf, family: str, device, **kw):
    """A family of ``FAMILY_CONFIGS`` at its published config (fields `kw` overridden) with random weights from
    seed 0, f32, made on `device`."""
    cfg_cls, model_cls, cfg, _ = FAMILY_CONFIGS[family]
    with torch.random.fork_rng(devices=[torch.device(device)] if torch.device(device).type == "cuda" else []):
        torch.manual_seed(0)
        with torch.device(device):
            return getattr(tf, model_cls)(getattr(tf, cfg_cls)(**{**cfg, **kw})).float().eval()


def apps_family(tf, family: str) -> dict:
    """(e) One family at its published width (``family_model``), the stub tokenizer, through ``TorchChatLM``'s
    default (its decoder's captured graphs) against ``graphs=False``: graphed against eager (first-step logits
    within LLAMA_TOL, ids equal up to the first close margin, the sampled reply draw for draw) on 64-token
    replies at the prompt's bucket (256); the host wall and CUDA-event span of a greedy reply
    through graphs per token against the weight-read bound; capture ms per key and pool bytes; the card against
    the CPU (the same steps, uncaptured) on the prefill and three steps (GPT-J's on GPTJ_CPU_LAYERS layers at
    full width)."""
    from emojivoice_tpu_torch.apps import adapters as ad
    from emojivoice_tpu_torch.apps.feel_me import PROMPT
    from emojivoice_tpu_torch.apps.torch_adapters import TorchChatLM
    from emojivoice_tpu_torch.utils.prng import step_generator

    t = time.perf_counter()
    model = family_model(tf, family, DEVICE)
    torch.cuda.synchronize()
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    out = dict(build_s=time.perf_counter() - t, params=sum(p.numel() for p in model.parameters()),
               weight_bytes=weight_bytes)
    chat = dict(tokenizer=StubTokenizer(), max_new_tokens=64)
    greedy = TorchChatLM(model=model, temperature=0.0, device=DEVICE, **chat)
    greedy_eager = TorchChatLM(model=model, temperature=0.0, device=DEVICE, graphs=False, **chat)
    want = FAMILY_CONFIGS[family][3]
    if greedy.decode != "graphs" or type(greedy._dec).__name__ != want or greedy_eager.decode != "eager":
        raise RuntimeError(f"[apps] (e) {family} decodes {greedy.decode} through {type(greedy._dec).__name__}")
    user = "hello robot, tell me a story about the sea"
    ids, mask, bucket = greedy._encode(ad.build_messages(PROMPT, [], user))
    out["bucket"], out["prompt_tokens"] = bucket, int(mask.sum())

    def run_greedy(adapter, logits):
        return adapter._generate(ids, mask, None, logits)[0, bucket:].tolist()

    def run_sampled(adapter, logits):
        return adapter._generate(ids, mask, step_generator(0, 0, "chat", DEVICE), logits)[0, bucket:].tolist()

    name = f"(e) {family}"
    out["graphs_vs_eager"] = decode_against(name, greedy, greedy_eager, run_greedy, "graphed against eager")
    sampled = TorchChatLM(model=model, temperature=0.6, seed=0, device=DEVICE, **chat)
    sampled_eager = TorchChatLM(model=model, temperature=0.6, seed=0, device=DEVICE, graphs=False, **chat)
    uniforms = torch.rand(64, generator=step_generator(0, 0, "chat", DEVICE), device=DEVICE).cpu()
    out["sampled_graphs_vs_eager"] = sampled_against(sampled, sampled_eager, run_sampled, uniforms, 0.6,
                                                     f"{name} sampled")
    # no replies timed in turns here (the checks above run both modes; (c), (d) and (f) time theirs): the wall and
    # device span of one graphed greedy reply below are this family's timed readings
    tokens = decoded(run_greedy(greedy, None), greedy._eos)
    out["greedy_tokens"], out["sampled_tokens"] = tokens, decoded(run_sampled(sampled, None), greedy._eos)
    # the CUDA-event span of one greedy reply through graphs (its prefill, 64 replays and 64 token reads)
    wall, span = wall_and_device_ms(lambda: greedy._generate(ids, mask))
    out["per_token"] = dict(wall_ms=wall, device_span_ms=span, device_span_ms_per_token=span / tokens,
                            bound_ms_per_token=weight_bytes / HBM_BYTES_PER_S * 1e3,
                            bound_by="bytes: the weights read once a token")
    out["graphs"] = {}
    for mode, adapter in (("greedy", greedy), ("sampled", sampled)):
        stats = adapter.graphs.stats()
        if not adapter.graphs.capture or stats["captures"] != 2 or stats["graphs"] != 2:
            raise RuntimeError(f"[apps] (e) {family} {mode} did not decode through captured graphs: {stats}")
        out["graphs"][mode] = {**stats, "pool_bytes": adapter.graphs.pool_bytes()}
    del greedy_eager, sampled, sampled_eager

    # the card against the CPU: the prefill and three steps, the same steps uncaptured on a copy of the weights
    t = time.perf_counter()
    short = dict(tokenizer=StubTokenizer(), temperature=0.0, max_new_tokens=LLAMA_CPU_TOKENS)
    if family == "gptj":
        del greedy, model
        gc.collect()
        torch.cuda.empty_cache()
        model = family_model(tf, family, DEVICE, n_layer=GPTJ_CPU_LAYERS)
        out["vs_cpu_layers"] = GPTJ_CPU_LAYERS
    card = TorchChatLM(model=model, device=DEVICE, **short)
    cpu = TorchChatLM(model=copy.deepcopy(model).to("cpu"), device="cpu", **short)
    out["vs_cpu"] = decode_against(name, card, cpu, run_greedy, "card against CPU")
    out["vs_cpu"]["seconds"] = time.perf_counter() - t
    return out


def apps_families(pipe, mrf, asr, wav: str, tmp: str) -> dict:
    """(e) The chat LM's families with decode steps of the port's own at their published widths, one after
    another (``apps_family``; a family whose class this transformers lacks is named on one line), then one
    agent turn (``agent_turn``: Whisper of (c) → OPT-350m through graphs → synthesis) as the main path's run of
    (e), its K1 launches read from ``mrf.launches`` at 0."""
    from emojivoice_tpu_torch.apps.torch_adapters import TorchChatLM, import_transformers
    from emojivoice_tpu_torch.bench.util import device_info

    tf = import_transformers()
    smi = device_info(torch.device(DEVICE)).get("nvidia_smi")
    out = dict(card=smi, families={}, missing=[])
    for family in FAMILY_CONFIGS:
        t = time.perf_counter()
        if getattr(tf, FAMILY_CONFIGS[family][1], None) is None:
            out["missing"].append(family)
            print(f"[apps] (e) {family}: this transformers ({tf.__version__}) has no {FAMILY_CONFIGS[family][1]}; "
                  "the CPU tests hold it")
            continue
        row = apps_family(tf, family)
        out["families"][family] = row
        print(f"[apps] (e) {family} on the card ({smi}) " + json.dumps(row))
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[time] apps (e) {family}: {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    opt = family_model(tf, "opt", DEVICE)
    agent = TorchChatLM(model=opt, temperature=0.0, device=DEVICE, tokenizer=StubTokenizer(), max_new_tokens=4)
    agent_turn(pipe, mrf, asr, agent, wav, f"{tmp}/agent_opt_warm", counted=False)  # the keys of both sides
    replays = agent.graphs.stats()["replays"]
    turn = agent_turn(pipe, mrf, asr, agent, wav, f"{tmp}/agent_opt", counted=True)
    if agent.graphs.stats()["replays"] <= replays or type(agent._dec).__name__ != "OPTDecoder":
        raise RuntimeError(f"[apps] (e) the OPT-350m agent turn did not decode through its graphs: "
                           f"{agent.graphs.stats()}")
    out["agent_turn"] = dict(turn, graphs=agent.graphs.stats())
    out["k1_launches"] = turn["k1_launches"]
    print("[apps] (e) agent turn with OPT-350m through graphs " + json.dumps(out["agent_turn"]))
    del agent, opt
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[time] apps (e) agent turn: {time.perf_counter() - t:.1f} s")
    return out


def apps_instruct(tf) -> dict:
    """(f1) Llama-3.2-1B (``llama32``) with the Instruct model's published sampling fields
    (``LLAMA32_INSTRUCT_GEN``: top_p 0.9 at temperature 0.6; top_k unset, which reads as the reference's 50) in its
    generation config, the stub tokenizer: 64-token sampled replies through ``TorchChatLM``'s graphs against
    ``graphs=False``, equal draw for draw (``sampled_against``); the first step's kept sets on the card after top-k
    and after top-k then top-p against ``plain_kept`` on the CPU (``kept_against_cpu``); the replies timed in
    turns; the graphs' captures and pool."""
    from emojivoice_tpu_torch.apps import adapters as ad
    from emojivoice_tpu_torch.apps.feel_me import PROMPT
    from emojivoice_tpu_torch.apps.torch_adapters import TorchChatLM
    from emojivoice_tpu_torch.utils.prng import step_generator

    model = llama32(tf, DEVICE)
    for name, value in LLAMA32_INSTRUCT_GEN.items():
        setattr(model.generation_config, name, value)
    temperature = LLAMA32_INSTRUCT_GEN["temperature"]
    chat = dict(tokenizer=StubTokenizer(), max_new_tokens=64, temperature=temperature, seed=0, device=DEVICE)
    sampled, sampled_eager = TorchChatLM(model=model, **chat), TorchChatLM(model=model, graphs=False, **chat)
    search = sampled._search
    # an unset top_k is the reference's 50 (transformers 4.57's default, which FlaxChatLM reads)
    if sampled.decode != "graphs" or (search.top_k, search.top_p) != (50, LLAMA32_INSTRUCT_GEN["top_p"]):
        raise RuntimeError(f"[apps] (f1) the Instruct fields: decode {sampled.decode}, top_k {search.top_k}, "
                           f"top_p {search.top_p}")
    user = "hello robot, tell me a story about the sea"
    ids, mask, bucket = sampled._encode(ad.build_messages(PROMPT, [], user))
    out = dict(bucket=bucket, prompt_tokens=int(mask.sum()), top_k=search.top_k, top_p=search.top_p,
               temperature=temperature)

    def run_sampled(adapter, logits):
        return adapter._generate(ids, mask, step_generator(0, 0, "chat", DEVICE), logits)[0, bucket:].tolist()

    uniforms = torch.rand(64, generator=step_generator(0, 0, "chat", DEVICE), device=DEVICE).cpu()
    out["graphs_vs_eager"] = sampled_against(sampled, sampled_eager, run_sampled, uniforms, temperature,
                                             "(f1) Llama-3.2-1B-Instruct sampling")
    seen = []
    run_sampled(sampled, seen)
    out["first_step_kept"] = kept_against_cpu(seen[0], search, temperature, "(f1) Llama-3.2-1B-Instruct")
    out["sampled_ms"] = in_turns({"graphs": lambda: sampled.chat(PROMPT, [], user),
                                  "eager": lambda: sampled_eager.chat(PROMPT, [], user)}, warm=False)
    out["sampled_tokens"] = decoded(run_sampled(sampled, None), sampled._eos)
    stats = sampled.graphs.stats()
    if not sampled.graphs.capture or stats["captures"] != 2 or stats["graphs"] != 2:
        raise RuntimeError(f"[apps] (f1) the Instruct sampling did not decode through captured graphs: {stats}")
    out["graphs"] = {**stats, "pool_bytes": sampled.graphs.pool_bytes()}
    del sampled, sampled_eager, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def bart_large(tf, device, **kw):
    """BART-large's decoder (``BART_LARGE``, fields `kw` overridden) as ``BartForCausalLM`` with random weights
    from seed 0, f32, made on `device`, its generation config set to ``BART_LARGE_GEN``."""
    with torch.random.fork_rng(devices=[torch.device(device)] if torch.device(device).type == "cuda" else []):
        torch.manual_seed(0)
        with torch.device(device):
            model = tf.BartForCausalLM(tf.BartConfig(**{**BART_LARGE, **kw})).float().eval()
    for name, value in BART_LARGE_GEN.items():
        setattr(model.generation_config, name, value)
    return model


def beams_against(name: str, got, ref, run, what: str) -> dict:
    """One beam-search decode by two adapters on the same weights (``run`` as in ``decode_against``; each step's
    (beams, V) log-probabilities after the rules land in its list): the first step's within ADAPTER_TOL, the best
    sequences equal."""
    seen = {"got": [], "ref": []}
    ids = {side: run(adapter, seen[side]) for side, adapter in (("got", got), ("ref", ref))}
    first, first_ref = seen["got"][0].float().cpu(), seen["ref"][0].float().cpu()
    finite = torch.isfinite(first_ref)
    row = dict(first_step_max_abs_err=float((first[finite] - first_ref[finite]).abs().max()),
               steps=len(seen["ref"]), steps_got=len(seen["got"]), ids_equal=ids["got"] == ids["ref"],
               first_differing_token=next((k for k, (a, b) in enumerate(zip(ids["got"], ids["ref"])) if a != b), None))
    if not (row["first_step_max_abs_err"] <= ADAPTER_TOL and row["ids_equal"] and row["steps"] == row["steps_got"]):
        raise RuntimeError(f"[apps] {name}: {what} {row}")
    return row


def apps_bart_large(tf, pipe, mrf, asr, wav: str, tmp: str) -> dict:
    """(f2) BART-large's decoder (``bart_large``) through ``BartDecoder``'s steps: greedy and beam-search
    (``num_beams`` 4, ``early_stopping`` True) replies through ``TorchChatLM``'s captured graphs against
    ``graphs=False`` (transformers' forward, its cache reordered by the chosen beams): greedy as
    ``decode_against``, beams as ``beams_against``; 64-token replies at the prompt's bucket timed in turns, capture
    ms and pool bytes; the card against the CPU (the same steps, uncaptured) at full width on BART_CPU_LAYERS of the
    12 layers, greedy and beams, LLAMA_CPU_TOKENS new tokens; then one agent turn (``agent_turn``: Whisper of (c)
    → the beam-search BART through graphs → synthesis) as the main path's run of (f), its K1 launches read from
    ``mrf.launches`` at 0."""
    from emojivoice_tpu_torch.apps import adapters as ad
    from emojivoice_tpu_torch.apps.feel_me import PROMPT
    from emojivoice_tpu_torch.apps.torch_adapters import TorchChatLM

    t = time.perf_counter()
    model = bart_large(tf, DEVICE)
    torch.cuda.synchronize()
    out = dict(build_s=time.perf_counter() - t, params=sum(p.numel() for p in model.parameters()),
               no_repeat_ngram_size="0 (published 3: FlaxChatLM cannot run it, the port refuses it)")
    chat = dict(tokenizer=StubTokenizer(), max_new_tokens=64, temperature=0.0, device=DEVICE)

    def adapters(beams: int, model=model, **kw):
        model.generation_config.num_beams = beams
        return TorchChatLM(model=model, **{**chat, **kw}), TorchChatLM(model=model, graphs=False, **{**chat, **kw})

    greedy, greedy_eager = adapters(1)
    beams, beams_eager = adapters(BART_LARGE_GEN["num_beams"])
    if greedy.decode != "graphs" or type(greedy._dec).__name__ != "BartDecoder" or beams._dec.batch != 4 \
            or beams._dec.kv.k[0].shape[0] != 4:
        raise RuntimeError(f"[apps] (f2) BART-large decodes {greedy.decode} through {type(greedy._dec).__name__}, "
                           f"beams {beams._dec.batch}")
    user = "hello robot, tell me a story about the sea"
    ids, mask, bucket = greedy._encode(ad.build_messages(PROMPT, [], user))
    out["bucket"], out["prompt_tokens"] = bucket, int(mask.sum())

    def run(adapter, logits):
        return adapter._generate(ids, mask, None, logits)[0, bucket:].tolist()

    out["greedy_graphs_vs_eager"] = decode_against("(f2) BART-large greedy", greedy, greedy_eager, run,
                                                   "graphed against eager")
    out["beams_graphs_vs_eager"] = beams_against("(f2) BART-large 4 beams", beams, beams_eager, run,
                                                 "graphed against eager")
    out["greedy_ms"] = in_turns({"graphs": lambda: greedy.chat(PROMPT, [], user),
                                 "eager": lambda: greedy_eager.chat(PROMPT, [], user)}, warm=False)
    out["beams_ms"] = in_turns({"graphs": lambda: beams.chat(PROMPT, [], user),
                                "eager": lambda: beams_eager.chat(PROMPT, [], user)}, warm=False)
    greedy_ids, beam_ids = run(greedy, None), run(beams, None)
    out.update(greedy_tokens=decoded(greedy_ids, greedy._eos), beam_tokens=decoded(beam_ids, greedy._eos),
               beams_differ_from_greedy=greedy_ids != beam_ids)
    out["graphs"] = {}
    for mode, adapter in (("greedy", greedy), ("beams", beams)):
        stats = adapter.graphs.stats()
        if not adapter.graphs.capture or stats["captures"] != 2 or stats["graphs"] != 2:
            raise RuntimeError(f"[apps] (f2) BART-large {mode} did not decode through captured graphs: {stats}")
        out["graphs"][mode] = {**stats, "pool_bytes": adapter.graphs.pool_bytes()}
    if ("beam_decode",) not in beams.graphs.keys():
        raise RuntimeError(f"[apps] (f2) BART-large beams: keys {beams.graphs.keys()}")
    del greedy, greedy_eager, beams_eager

    # the card against the CPU at full width on BART_CPU_LAYERS layers: the same steps, uncaptured, on a copy
    t = time.perf_counter()
    small = bart_large(tf, DEVICE, decoder_layers=BART_CPU_LAYERS, encoder_layers=BART_CPU_LAYERS)
    small_cpu = copy.deepcopy(small).to("cpu")
    short = dict(max_new_tokens=LLAMA_CPU_TOKENS)
    out["vs_cpu"] = dict(layers=BART_CPU_LAYERS)
    for n_beams in (1, BART_LARGE_GEN["num_beams"]):
        card = adapters(n_beams, small, **short)[0]
        small_cpu.generation_config.num_beams = n_beams
        cpu = TorchChatLM(model=small_cpu, **{**chat, **short, "device": "cpu"})
        if n_beams == 1:
            out["vs_cpu"]["greedy"] = decode_against("(f2) BART-large", card, cpu, run, "card against CPU")
        else:
            out["vs_cpu"]["beams"] = beams_against("(f2) BART-large", card, cpu, run, "card against CPU")
    out["vs_cpu"]["seconds"] = time.perf_counter() - t
    del small, small_cpu, card, cpu

    # one agent turn with the beam-search BART through graphs: the main path's run of (f)
    t = time.perf_counter()
    model.generation_config.num_beams = BART_LARGE_GEN["num_beams"]
    agent = TorchChatLM(model=model, temperature=0.0, device=DEVICE, tokenizer=StubTokenizer(), max_new_tokens=4)
    agent_turn(pipe, mrf, asr, agent, wav, f"{tmp}/agent_bart_warm", counted=False)  # the keys of both sides
    replays = agent.graphs.stats()["replays"]
    turn = agent_turn(pipe, mrf, asr, agent, wav, f"{tmp}/agent_bart", counted=True)
    if agent.graphs.stats()["replays"] <= replays or agent._dec.batch != 4 or not turn["k1_launches"]:
        raise RuntimeError(f"[apps] (f2) the beam-search BART agent turn did not decode through its graphs, or "
                           f"launched no K1: {agent.graphs.stats()} {turn}")
    out["agent_turn"] = dict(turn, graphs=agent.graphs.stats(), seconds=time.perf_counter() - t)
    out["k1_launches"] = turn["k1_launches"]
    del agent, beams, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def apps_rules(pipe, mrf, asr, wav: str, tmp: str) -> dict:
    """(f) The rest of the Flax ``generate``'s chat rules on the card at published widths: (f1) the Instruct
    sampling fields on Llama-3.2-1B (``apps_instruct``), (f2) BART-large's decoder greedy and with 4 beams, and an
    agent turn through the beam search (``apps_bart_large``)."""
    from emojivoice_tpu_torch.apps.torch_adapters import import_transformers
    from emojivoice_tpu_torch.bench.util import device_info

    tf = import_transformers()
    smi = device_info(torch.device(DEVICE)).get("nvidia_smi")
    t = time.perf_counter()
    instruct = apps_instruct(tf)
    print(f"[apps] (f1) Llama-3.2-1B with the Instruct sampling fields on the card ({smi}) " + json.dumps(instruct))
    print(f"[time] apps (f1) instruct sampling: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    bart = apps_bart_large(tf, pipe, mrf, asr, wav, tmp)
    print(f"[apps] (f2) BART-large decoder through its steps on the card ({smi}), no_repeat_ngram_size 0 (published "
          "3: FlaxChatLM cannot run it) " + json.dumps(bart))
    print(f"[time] apps (f2) BART-large: {time.perf_counter() - t:.1f} s")
    return dict(card=smi, instruct=instruct, bart=bart, k1_launches=bart["k1_launches"])


def apps_profile() -> dict:
    """(c) One greedy 64-token reply of the chat LM under ``torch.profiler``,
    through graphs and eagerly (the weights and prompt of (c)), then one of
    Llama-3.2-1B through graphs: device ms,
    device activities and the busy share against the call's own wall.  Run
    after the smoke's timed phases: a process's calls run slower after its
    first profiler session."""
    from emojivoice_tpu_torch.apps import adapters as ad
    from emojivoice_tpu_torch.apps.feel_me import PROMPT
    from emojivoice_tpu_torch.apps.torch_adapters import TorchChatLM, import_transformers
    from emojivoice_tpu_torch.bench.util import profile_call

    tf = import_transformers()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        gpt2 = tf.GPT2LMHeadModel(tf.GPT2Config()).eval()
    messages = ad.build_messages(PROMPT, [], "hello robot, tell me a story about the sea")
    out = {}
    for mode in ("graphs", "eager"):
        lm = TorchChatLM(model=gpt2, tokenizer=StubTokenizer(), temperature=0.0, max_new_tokens=64, device=DEVICE,
                         graphs=mode == "graphs")
        ids, mask, _ = lm._encode(messages)
        lm._generate(ids, mask)  # warm: the captures, cuBLAS
        row = profile_call(lambda lm=lm, ids=ids, mask=mask: lm._generate(ids, mask), torch.device(DEVICE))
        out[mode] = {k: row[k] for k in ("profiled_wall_ms", "device_ms", "device_activities", "busy")}
    print("[apps] (c) one greedy 64-token reply profiled " + json.dumps(out))
    del gpt2, lm
    llama = llama32(tf, DEVICE)
    out["llama"] = {}
    for mode in ("graphs",):  # the eager Llama reply is timed in (d), not profiled again here
        lm = TorchChatLM(model=llama, tokenizer=StubTokenizer(), temperature=0.0, max_new_tokens=64, device=DEVICE,
                         graphs=mode == "graphs")
        ids, mask, _ = lm._encode(messages)
        lm._generate(ids, mask)  # warm
        row = profile_call(lambda lm=lm, ids=ids, mask=mask: lm._generate(ids, mask), torch.device(DEVICE))
        out["llama"][mode] = {k: row[k] for k in ("profiled_wall_ms", "device_ms", "device_activities", "busy")}
        del lm
    print("[apps] (d) one greedy 64-token Llama-3.2-1B reply profiled " + json.dumps(out["llama"]))
    del llama
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_apps(pipe, mrf) -> dict:
    """Phase 13: the apps on the pipeline of phase 3.  The main path's runs
    are (a)'s measured turns, (b), (c)'s agent turn, (e)'s and (f)'s, each
    read from ``mrf.launches`` at 0."""
    with tempfile.TemporaryDirectory(prefix="emojivoice_apps_") as tmp:
        turns = apps_turns(pipe, mrf, tmp)
        mrf.launches.clear()
        cases = apps_case_studies(pipe, mrf, tmp)
        cases["k1_launches"] = sum(mrf.launches.values())
        adapters = apps_adapters(pipe, mrf, tmp, turns["wav"])
        t = time.perf_counter()
        llama = apps_llama(tmp)
        print(f"[time] apps (d) Llama: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        asr = adapters.pop("asr")
        families = apps_families(pipe, mrf, asr, turns["wav"], tmp)
        print(f"[time] apps (e) families: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        rules = apps_rules(pipe, mrf, asr, turns["wav"], tmp)
        print(f"[time] apps (f) rules: {time.perf_counter() - t:.1f} s")
    return dict(turns=turns, cases=cases, adapters=adapters, llama=llama, families=families, rules=rules,
                k1_launches=turns["k1_launches"] + cases["k1_launches"] + adapters["k1_launches"]
                + families["k1_launches"] + rules["k1_launches"])


def wall_and_device_ms(fn) -> tuple:
    """fn() from an idle card: host ms to its end on the device, and the
    device span by CUDA events."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t = time.perf_counter()
    start.record()
    fn()
    end.record()
    end.synchronize()
    return (time.perf_counter() - t) * 1e3, start.elapsed_time(end)


def export_timing(pipe, bundle, texts, spks, seeds, m_bucket) -> dict:
    """Bundle against live wall at one batch: alternated runs (live, bundle,
    bundle, live), the same fused work at the same mel bucket (no duration
    program, no mel copy), host wall and device span by CUDA events."""
    kw = dict(n_timesteps=STEPS, denoiser_strength=STRENGTH, keep_mel=False)

    def live():
        pipe.synthesise(texts, spks=spks, seed=list(seeds), fused=True, fused_mel_bucket=m_bucket, **kw)

    def exported():
        bundle.synthesise(texts, spks=spks, seed=list(seeds), mel_bucket=m_bucket)

    live(), exported()  # warm
    wall = {"live": [], "bundle": []}
    device = {"live": [], "bundle": []}
    for _ in range(EXPORT_TIMED_RUNS):
        for name, fn in (("live", live), ("bundle", exported), ("bundle", exported), ("live", live)):
            w, d = wall_and_device_ms(fn)
            wall[name].append(w)
            device[name].append(d)
    out = {"batch": len(texts), "mel_bucket": m_bucket, "runs_each": 2 * EXPORT_TIMED_RUNS}
    for name in ("live", "bundle"):
        out[f"{name}_wall_ms_median"] = statistics.median(wall[name])
        out[f"{name}_wall_ms_min"] = min(wall[name])
        out[f"{name}_device_ms_median"] = statistics.median(device[name])
        out[f"{name}_device_ms_min"] = min(device[name])
    return out


def export_graphs_against_eager(mrf, n_stages: int, graphs, eager, texts, spks, seeds, m_bucket) -> dict:
    """[export] (g) at one batch: the bundle through its graphs against the
    same bundle op by op, same texts, seeds and pinned mel bucket, equal to
    the bit; K1's count of one replayed call (one per MRF stage); then wall
    and device ms of each in turns (eager, graphs, graphs, eager)."""
    import numpy as np

    def call(bundle):
        return lambda: bundle.synthesise(texts, spks=spks, seed=list(seeds), mel_bucket=m_bucket)

    got, _ = call(graphs)()
    want, _ = call(eager)()
    for r, w in zip(got, want):
        if r["mel_length"] != w["mel_length"] or not np.array_equal(r["wav"], w["wav"]):
            raise RuntimeError(f"[export] (g) batch {len(texts)}: the graphed bundle differs from the eager one "
                               f"(mel_length {r['mel_length']} / {w['mel_length']}, max-abs "
                               f"{float(np.abs(r['wav'] - w['wav']).max()) if r['wav'].shape == w['wav'].shape else None})")
    mrf.launches.clear()
    call(graphs)()
    k1 = sum(mrf.launches.values())
    if k1 != n_stages:
        raise RuntimeError(f"[export] (g) one replayed batch-{len(texts)} call made {k1} mrf_stage calls, expected "
                           f"{n_stages}")

    wall, device = {"eager": [], "graphs": []}, {"eager": [], "graphs": []}
    for _ in range(EXPORT_TIMED_RUNS):
        for mode in ("eager", "graphs", "graphs", "eager"):
            w, d = wall_and_device_ms(call(graphs if mode == "graphs" else eager))
            wall[mode].append(w)
            device[mode].append(d)
    out = dict(batch=len(texts), mel_bucket=m_bucket, rows=len(got), bit_equal=True, k1_per_replayed_call=k1,
               runs_each=2 * EXPORT_TIMED_RUNS)
    for mode in ("eager", "graphs"):
        out[f"{mode}_wall_ms_median"] = statistics.median(wall[mode])
        out[f"{mode}_wall_ms_min"] = min(wall[mode])
        out[f"{mode}_device_ms_median"] = statistics.median(device[mode])
    return out


def export_profile(pipe, bundle, eager, m_bucket) -> dict:
    """One profiled batch-1 call each, after every timed call of the smoke:
    the bundle through its graph (captured anew first: [export] dropped it),
    the bundle op by op, and the live pipeline's fused call through its
    graphs, at the same mel bucket: device ms, activities, busy share."""
    from emojivoice_tpu_torch.bench.util import profile_call

    kw = dict(spks=[79], seed=[0], mel_bucket=m_bucket)
    fns = {"bundle_graphs": lambda: bundle.synthesise([HEADLINE], **kw),
           "bundle_eager": lambda: eager.synthesise([HEADLINE], **kw),
           "live_graphs": lambda: pipe.synthesise([HEADLINE], spks=[79], seed=[0], n_timesteps=STEPS,
                                                  denoiser_strength=STRENGTH, fused=True, fused_mel_bucket=m_bucket,
                                                  keep_mel=False)}
    out = {}
    for name, fn in fns.items():
        fn()  # warm (the bundle's capture)
        got = profile_call(fn, torch.device(DEVICE))
        out[name] = {k: got[k] for k in ("device_ms", "device_activities", "busy", "profiled_wall_ms", "k1_device_ms")}
    print("[export] profiled batch-1 calls at mel bucket " + f"{m_bucket}: " + json.dumps(out))
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
    from emojivoice_tpu_torch.inference.export import (BundleSynthesisPipeline, ExportedSynthesizer, LoadedBundle,
                                                       export_bundle)
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
            eng.warmup()  # every program of each batch bucket captured off the request path
            warmed = bundle.graphs.stats()
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
        n_programs = len(sizes)
        if warmed["graphs"] != n_programs or bundle.graphs.captures != warmed["captures"]:
            raise RuntimeError(f"[export] (c) after warmup the bundle holds {warmed['graphs']} graphs of {n_programs} "
                               f"programs, and serving the warmed buckets captured "
                               f"{bundle.graphs.captures - warmed['captures']} more")
        text, spk, seed = requests[5]
        direct = bp.synthesise([text], spks=[spk], seed=[seed])[0]
        merged_err = float(np.abs(served["results"][5].wav - direct.wav).max())
        out["engine"] = dict(utt_per_s=served["utt_per_s"], latency_ms_p50=served["latency_ms_p50"],
                             latency_ms_p95=served["latency_ms_p95"], batch_hist=stats["batch_hist"],
                             batches=batches, merged_vs_direct_max_abs=merged_err, k1_launches=grew,
                             graphs_after_warmup=warmed["graphs"], captures_after_warmup=warmed["captures"],
                             captures_while_serving=bundle.graphs.captures - warmed["captures"])
        print(f"[export] (c) BatchingEngine over BundleSynthesisPipeline through graphs, 16 requests from 8 threads "
              f"(after its warmup and one warm burst): {json.dumps(out['engine'])}")
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
        print('[export] (f) one denoised fused dispatch of the live pipeline and one of the bundle through its '
              'captured graph, at a pinned mel bucket, under torch.cuda.set_sync_debug_mode("error"): no host sync')

        # (g) the same bundle run op by op against its graphs (the programs loaded once, above, and shared)
        t = time.perf_counter()
        eager = LoadedBundle(tmp, device=DEVICE, graphs=False)
        eager._cache = bundle._cache
        out["graphs_vs_eager"] = [
            export_graphs_against_eager(mrf, n_stages, bundle, eager, [HEADLINE], [79], [0], t1["mel_bucket"]),
            export_graphs_against_eager(mrf, n_stages, bundle, eager, texts8, spks8, seeds8, t8["mel_bucket"])]
        out["graph_store"] = {**bundle.graphs.stats(), "pool_bytes": bundle.graphs.pool_bytes()}
        for row in out["graphs_vs_eager"]:
            print("[export] (g) bundle through graphs against the bundle op by op " + json.dumps(row))
        print(f"[export] (g) the bundle's graph store: {json.dumps(out['graph_store'])}")
        # ExportedSynthesizer on the batch-1 program of (a), through its own graph by default: (a)'s row to the bit
        name = f"synth_b1_t{EXPORT_TEXT_BUCKET}_m{t1['mel_bucket']}"
        synth = ExportedSynthesizer(str(Path(tmp) / name), device=DEVICE)
        xp = np.zeros((1, EXPORT_TEXT_BUCKET), np.int64)
        xp[:, :x.shape[1]] = x
        mrf.launches.clear()
        wav_s, ml_s = synth(xp, xl, [79], seed=[0])
        k1 = sum(mrf.launches.values())
        ml = int(ml_s[0])
        if synth.graphs is None or synth.graphs.captures != 1 or k1 != n_stages or ml != res1[0]["mel_length"] \
                or not np.array_equal(wav_s[0, :ml * pipe.vocoder_cfg.total_upsample], res1[0]["wav"]):
            raise RuntimeError(f"[export] (g) ExportedSynthesizer: store {synth.graphs and synth.graphs.stats()}, "
                               f"{k1} mrf_stage calls, mel_length {ml} against (a)'s {res1[0]['mel_length']}")
        launches += k1
        out["synthesizer"] = dict(capture_ms=synth.graphs.stats()["capture_ms"], k1_launches=k1, bit_equal=True)
        del synth
        print(f"[export] (g) ExportedSynthesizer({name}) through its captured graph: (a)'s row to the bit, "
              f"{json.dumps(out['synthesizer'])}; (g) {time.perf_counter() - t:.1f} s")
        # kept for the profiled calls at the smoke's end: the batch-1 program, its graph dropped until then
        bundle.graphs.drop()
        bundle._cache = eager._cache = {name: bundle._cache[name]}
        out["profile"] = lambda: export_profile(pipe, bundle, eager, t1["mel_bucket"])
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


def mas_row(mas, value, mask, tag: str, time_plain: bool = True) -> dict:
    """K2 against its plain version on (value, mask): equality, the path's
    properties, both times (the plain one where `time_plain`: a Python loop
    of ~0.05-0.7 s a call), and the least time the card could take."""
    got = mas.maximum_path(value, mask)
    ref = mas.maximum_path_reference(value, mask)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    faults = mas.path_faults(got, mask)
    ok = torch.equal(got, ref) and not faults
    if time_plain:
        plain_ms, k2_ms = abba_ms(lambda: mas.maximum_path_reference(value, mask),
                                  lambda: mas.maximum_path(value, mask))
    else:
        plain_ms, k2_ms = None, statistics.median(cuda_ms(lambda: mas.maximum_path(value, mask)))
    b, t_x, t_y = value.shape
    # value and mask read once, path written once; one add and one max per cell
    bytes_ms = 3 * value.numel() * 4 / HBM_BYTES_PER_S * 1e3
    flops_ms = 2 * value.numel() / F32_FLOPS * 1e3
    steps = int(mask[:, 0, :].sum(-1).max())  # the longest item's dependent chain, each way
    row = dict(B=b, T_x=t_x, T_y=t_y, max_abs_err=err, exact=ok, ms=k2_ms, plain_ms=plain_ms,
               bound_ms=max(bytes_ms, flops_ms), bound_by="bytes" if bytes_ms >= flops_ms else "operations",
               chain_steps=steps, us_per_step=k2_ms * 1e3 / (2 * steps))
    plain = "not timed" if plain_ms is None else f"{plain_ms:9.3f} ms"
    print(f"[{tag}] B={b:2d} T_x={t_x:4d} T_y={t_y:4d}  max_abs_err={err:.1f}  K2 {k2_ms:8.4f} ms  "
          f"plain {plain}  bound {row['bound_ms']:.4f} ms by {row['bound_by']}  "
          f"chain {steps} steps each way, {row['us_per_step']:.4f} us/step  "
          f"{'equal' if ok else 'MISMATCH ' + '; '.join(faults[:3])}")
    return row


def phase_kernel_mas(mas) -> list:
    # the plain loop is timed on the first shape, the one the kernels line reads beside the training batch's
    rows = [mas_row(mas, *ragged_mas_problem(b, t_x, t_y, seed=i), tag="kernel", time_plain=i == 0)
            for i, (b, t_x, t_y) in enumerate(MAS_SHAPES)]
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
        # deterministic: the run's checkpoint feeds the vocoder proof's mels (F10)
        with deterministic("train"):
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
            eval_step(state.model, batch, graphs=False)  # eagerly: a replay runs no Python, so it would capture nothing
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
    MAS timed inside the forward, all on the eager step (a captured step has
    no stages to mark), then steps per second over ten steps on the host
    clock through the step's captured graph (the trainer's default), and the
    peak memory of these steps."""
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
            train_step(state, batch, seed, clock=clock, graphs=False)
            torch.cuda.synchronize()
            stage_ms.append(clock.elapsed_ms())
    finally:
        matcha.maximum_path = real
    med = {k: statistics.median(m[k] for m in stage_ms[2:]) for k in stage_ms[0]}
    n = 10
    train_step(state, batch, seed)  # the capture
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        train_step(state, batch, seed)
    torch.cuda.synchronize()
    return {"steps_per_s": n / (time.perf_counter() - t), "steps_through": "graphs", "stages_from": "eager",
            "forward_ms": med["forward"],
            "mas_ms": statistics.median(a.elapsed_time(b) for a, b in mas_events[2:]), "backward_ms": med["backward"],
            "optimizer_ms": med["optimizer"], "batch": batch["y"].shape[0], "t_text": batch["x"].shape[1],
            "t_mel": batch["y"].shape[1], "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def vocoder_graphed_against_eager(cfg, gen_state: dict, batches: list) -> dict:
    """[vocoder] (c'): two states from one seed and one generator dump, one
    stepping through its captured graph (the first step eager, then the
    capture, then replays) and one eagerly, on the same batches, both under
    ``deterministic``: their five metrics at every step and every parameter
    of gen, mpd and msd after the last, equal to the bit.  (Without
    deterministic kernels the card's backward adds atomically and two eager
    runs already differ in their last bits.)  Both Adams of a card state say
    ``capturable``."""
    from emojivoice_tpu_torch.training.vocoder_train import create_vocoder_state, vocoder_train_step

    states = {mode: create_vocoder_state(cfg, seed=1, gen_state=gen_state) for mode in ("graphs", "eager")}
    plain = [g for st in states.values() for opt in (st.gen_opt, st.disc_opt) for g in opt.param_groups
             if not g["capturable"]]
    if plain:
        raise RuntimeError(f"(c') {len(plain)} Adam parameter groups of a card state are not capturable")
    metrics = {mode: [] for mode in states}
    with deterministic("vocoder"):
        for b in batches:
            batch = {k: torch.from_numpy(v).cuda() for k, v in b.items()}
            for mode, st in states.items():
                metrics[mode].append(vocoder_train_step(st, batch, graphs=mode == "graphs"))
        torch.cuda.synchronize()
    differ = [f"step {i} {k}" for i, (g, e) in enumerate(zip(metrics["graphs"], metrics["eager"])) for k in g
              if not torch.equal(g[k], e[k])]
    a, b = states["graphs"], states["eager"]
    for name in ("gen", "mpd", "msd"):
        differ += [f"{name}.{n}" for (n, p), q in zip(getattr(a, name).named_parameters(),
                                                      getattr(b, name).parameters()) if not torch.equal(p, q)]
    store = a.graphs.stats()
    if differ or store["captures"] != 1 or store["replays"] != len(batches) - 1 or b.graphs is not None:
        raise RuntimeError(f"(c') the graphed GAN step against the eager one: differing {differ[:12]} "
                           f"({len(differ)} in all); store {store}")
    moved = any(not torch.equal(v, gen_state[k].cuda()) for k, v in a.gen.state_dict().items())
    if not moved:
        raise RuntimeError("(c') the graphed steps left the generator where it started")
    return dict(steps=len(batches), bit_equal=True, capture_ms=store["capture_ms"],
                first_step_ms=store["first_step_ms"], pool_bytes=a.graphs.pool_bytes(),
                metrics_last={k: float(v) for k, v in metrics["graphs"][-1].items()})


def plain_adam_twin(state):
    """`state` sharing its modules, with plain (not ``capturable``) Adams of
    the same rate and betas: the eager step as it ran before the card's
    Adams became capturable, the yardstick of (d)."""
    from torch.optim import Adam

    def plain(opt):
        g = opt.param_groups[0]
        return Adam([p for group in opt.param_groups for p in group["params"]], lr=float(g["lr"]), betas=g["betas"],
                    eps=g["eps"])

    return dataclasses.replace(state, gen_opt=plain(state.gen_opt), disc_opt=plain(state.disc_opt), graphs=None)


def vocoder_steps_in_turns(state, batch: dict, n: int = 10) -> dict:
    """[vocoder] (d): the GAN step captured at `batch`'s shape (one step,
    eager, then the capture), then `n` steps each way in turns (eager,
    eager with plain Adams, graphs, graphs, plain, eager): steps per second
    to the end on the device and the host's enqueue ms a step (the step
    itself waits for nothing); the capture's ms and the pool's bytes.  Then
    what the graphed step's enqueue time is made of: one replay under
    ``torch.cuda.set_sync_debug_mode("error")`` (a host sync anywhere on the
    replay path raises), the enqueue ms of single replays from an idle card,
    and the enqueue ms of each step of a run of `n` started from an idle
    card."""
    from emojivoice_tpu_torch.training.vocoder_train import vocoder_train_step

    vocoder_train_step(state, batch)  # the capture
    twin = plain_adam_twin(state)
    vocoder_train_step(twin, batch, graphs=False)  # plain Adams' state
    torch.cuda.synchronize()
    if any(g["capturable"] for opt in (twin.gen_opt, twin.disc_opt) for g in opt.param_groups):
        raise RuntimeError("(d) the plain-Adam twin's optimizers are capturable")
    runs = {"eager": [], "eager_plain_adam": [], "graphs": []}
    for mode in ("eager", "eager_plain_adam", "graphs", "graphs", "eager_plain_adam", "eager"):
        st = twin if mode == "eager_plain_adam" else state
        t = time.perf_counter()
        for _ in range(n):
            vocoder_train_step(st, batch, graphs=mode == "graphs")
        enqueue_ms = (time.perf_counter() - t) * 1e3 / n
        torch.cuda.synchronize()
        runs[mode].append((n / (time.perf_counter() - t), enqueue_ms))
    torch.cuda.set_sync_debug_mode("error")
    try:
        vocoder_train_step(state, batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    idle = []
    for _ in range(5):
        t = time.perf_counter()
        vocoder_train_step(state, batch)
        idle.append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize()
    each = []
    for _ in range(n):
        t = time.perf_counter()
        vocoder_train_step(state, batch)
        each.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    store = state.graphs.stats()
    if store["captures"] != 1:
        raise RuntimeError(f"(d) the GAN step at one batch shape was captured {store['captures']} times")
    out = {f"{mode}_{k}": statistics.mean(r[i] for r in runs[mode]) for mode in runs
           for i, k in enumerate(("steps_per_s", "host_enqueue_ms"))}
    return dict(steps_per_s=out.pop("graphs_steps_per_s"), host_enqueue_ms=out.pop("graphs_host_enqueue_ms"), **out,
                turns=runs, steps_through="graphs", replay_sync_free=True, idle_replay_enqueue_ms=idle,
                run_enqueue_ms_each=each, capture_ms=store["capture_ms"], first_step_ms=store["first_step_ms"],
                captures=store["captures"], pool_bytes=state.graphs.pool_bytes())


def vocoder_profile(cfg, gen_state: dict, batch_np: dict) -> dict:
    """One profiled GAN step through the captured graph and one eager, at
    (d)'s batch, after every timed call of the smoke (a fresh state from the
    (b) generator; each mode warmed first, the capture among it): device ms,
    activities, busy share, and the eager step's device ms over the
    replayed one's (PERF.md §7: the acoustic step's kernels took 1.6-2.3x
    longer eagerly than replayed)."""
    from emojivoice_tpu_torch.bench.util import profile_call
    from emojivoice_tpu_torch.training.vocoder_train import create_vocoder_state, vocoder_train_step

    state = create_vocoder_state(cfg, seed=1, gen_state=gen_state)
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch_np.items()}
    out = {}
    for mode in ("graphs", "eager"):
        for _ in range(2):
            vocoder_train_step(state, batch, graphs=mode == "graphs")
        got = profile_call(lambda: vocoder_train_step(state, batch, graphs=mode == "graphs"), torch.device(DEVICE))
        out[mode] = {k: got[k] for k in ("device_ms", "device_activities", "busy", "profiled_wall_ms")}
    out["eager_over_graphs_device_ms"] = out["eager"]["device_ms"] / out["graphs"]["device_ms"]
    print(f"[vocoder] profiled GAN step, batch {VOC_BATCH} x {VOC_SEGMENT * 256} samples: " + json.dumps(out))
    return out


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
        with deterministic("vocoder"):
            if get_durations.main(["--checkpoint_path", str(ckpt_dir), "--filelist", str(filelist), "--preset",
                                   PRESET, "--output_dir", str(aligned), "--batch_size", str(DURATION_BATCH),
                                   "--gen_mels", "--n_timesteps", str(STEPS)]) != 0:
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
    # the same call with each batch's forward run op by op: every file equal to the bit
    eager_dir = tmp / "aligned_eager"
    t = time.perf_counter()
    with deterministic("vocoder"):
        if get_durations.main(["--checkpoint_path", str(ckpt_dir), "--filelist", str(filelist), "--preset", PRESET,
                               "--output_dir", str(eager_dir), "--batch_size", str(DURATION_BATCH), "--gen_mels",
                               "--n_timesteps", str(STEPS), "--eager"]) != 0:
            raise RuntimeError("(a) get_durations --eager failed")
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t
    files = sorted(p.relative_to(eager_dir) for p in eager_dir.rglob("*.npy"))
    differ = [str(f) for f in files if not np.array_equal(np.load(aligned / f), np.load(eager_dir / f))]
    if len(files) != 2 * len(rows) or differ:
        raise RuntimeError(f"(a) get_durations through graphs against --eager: {len(files)} files, differing {differ}")
    print(f"[vocoder] (a) get_durations --gen_mels on {ckpt_dir.name}/: {len(rows)} utterances in {n_batches} batches, "
          f"{durations_s:.2f} s through graphs ({len(rows) / durations_s:.2f} utterances/s with {STEPS} Euler steps "
          f"and the files; {eager_s:.2f} s with --eager, every file equal to the bit), K2 launches {k2_launches}, "
          f"frames {min(frames.values())}..{max(frames.values())}, first batch {tuple(value.shape)} equal to the "
          f"plain search")

    # (b) the GAN fine-tune on those mels, through the harness a user calls
    mrf.launches.clear()
    t = time.perf_counter()
    with deterministic("vocoder"):  # the harness asserts that the windowed mel-L1 falls: F10
        summary = run_vocoder_proof(str(tmp / "voc"), steps=VOC_STEPS, batch_size=VOC_BATCH,
                                    segment_frames=VOC_SEGMENT, window=3, cfg=cfg, log_every=VOC_LOG_EVERY,
                                    filelist=str(filelist), gen_mels_dir=str(aligned / "gen_mels"))
    proof_s = time.perf_counter() - t
    first, last = summary["mel_l1_first_mean"], summary["mel_l1_last_mean"]
    print(f"[vocoder] (b) the proof's windowed mel-L1 trend (F10): {first} -> {last}, end/start {last / first:.4f} "
          f"(the harness asserts end < start)")
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
    m_card = {k: float(v) for k, v in vocoder_train_step(card, {k: v.cuda() for k, v in four.items()},
                                                         graphs=False).items()}
    rel = {k: abs(m_card[k] - m_cpu[k]) / abs(m_cpu[k]) for k in m_cpu}
    moved = max(float((a.detach().cpu() - b.detach()).abs().max()) for a, b in zip(card.gen.parameters(),
                                                                                   cpu.gen.parameters()))
    print(f"[vocoder] (c) one GAN step, 4 rows, card {m_card} cpu {m_cpu} (CPU step {cpu_s:.2f} s); relative "
          f"differences {rel}; generator parameters after the step differ by at most {moved:.2e}")
    if max(rel.values()) > VOC_TOL:
        raise RuntimeError(f"(c) card and CPU GAN steps disagree beyond {VOC_TOL}: {rel}")
    del cpu

    # (c') the step through its captured graph against the eager step, from the same state, to the bit
    gen_state = load_hifigan(str(gen_file), fold=False)
    t = time.perf_counter()
    graphed = vocoder_graphed_against_eager(cfg, gen_state, [sample() for _ in range(VOC_GRAPH_STEPS)])
    print(f"[vocoder] (c') {VOC_GRAPH_STEPS} GAN steps through the captured graph against {VOC_GRAPH_STEPS} eager "
          f"steps: {json.dumps(graphed)}; {time.perf_counter() - t:.1f} s")

    # (d) the step by stage at batch 16 (eager: a graph has no stages to mark), then steps per second and the
    # host's enqueue time through the graph against eager, in turns
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch_np.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stage_ms = []
    for _ in range(2 + 5):  # two to warm
        clock = StageClock(torch.device(DEVICE))
        vocoder_train_step(card, batch, clock=clock, graphs=False)
        torch.cuda.synchronize()
        stage_ms.append(clock.elapsed_ms())
    med = {k: statistics.median(m[k] for m in stage_ms[2:]) for k in stage_ms[0]}
    step = dict(**vocoder_steps_in_turns(card, batch), stages_from="eager", **{f"{k}_ms": v for k, v in med.items()},
                sum_ms=sum(med.values()), batch=VOC_BATCH, segment_samples=VOC_SEGMENT * 256,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9, harness_steps_per_s=summary["steps_per_sec_after_first"])
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
                durations_utt_per_s=len(rows) / durations_s, card_vs_cpu_rel=rel, folded_vs_plain=err,
                graphed_vs_eager=graphed, profile=lambda: vocoder_profile(cfg, gen_state, batch_np))


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
            losses[precision] = {k: float(v) for k, v in
                                 train_step(fresh(), batch, seed, precision=precision, graphs=False).items()}
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
    for _ in range(2 + 5):  # two to warm; by stage on the eager step
        clock = StageClock(torch.device(DEVICE))
        train_step(st, batch, seed, clock=clock, precision="bf16-mixed", graphs=False)
        torch.cuda.synchronize()
        stage_ms.append(clock.elapsed_ms())
    med = {k: statistics.median(m[k] for m in stage_ms[2:]) for k in stage_ms[0]}
    n = 10
    train_step(st, batch, seed, precision="bf16-mixed")  # the capture: steps per second through the graph
    torch.cuda.synchronize()
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
    if mas.launches != 2 + 5 + 1 + n:
        raise RuntimeError(f"[precision] {mas.launches} K2 launches in {2 + 5 + 1 + n} bf16-mixed steps")
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
                      batches=(1,), n_timesteps=CONFORMER_EXPORT_STEPS, denoiser_strength=STRENGTH)
        export_s = time.perf_counter() - t
        bundle = LoadedBundle(str(bundle_dir), device=DEVICE)
        mrf.launches.clear()
        got, _ = bundle.synthesise([HEADLINE], spks=[79], seed=[0])
        out["k1_launches"] += sum(mrf.launches.values())
        want = served.synthesise([HEADLINE], spks=[79], seed=[0], n_timesteps=CONFORMER_EXPORT_STEPS,
                                 denoiser_strength=STRENGTH, fused=True, fused_mel_bucket=m_bucket, keep_mel=False)[0]
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


def no_dropout(cfg):
    """`cfg` with the config's three dropout rates at 0 (the equality checks of [parallel])."""
    return dataclasses.replace(
        cfg, encoder=dataclasses.replace(cfg.encoder, p_dropout=0.0),
        duration_predictor=dataclasses.replace(cfg.duration_predictor, p_dropout=0.0),
        decoder=dataclasses.replace(cfg.decoder, dropout=0.0))


def parallel_state(cfg, device, mesh, seed: int):
    """The trainer's state from `seed`, every dropout at 0 (the prenet's fixed 0.5 too, which no config holds)."""
    from emojivoice_tpu_torch.config import OptimizerConfig
    from emojivoice_tpu_torch.training.state import create_train_state

    state = create_train_state(cfg, OptimizerConfig(), seed=seed, device=device, mesh=mesh)
    for m in state.model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return state


def parallel_requests(root):
    """[parallel] (c)'s requests: (name, texts, speakers, seeds)."""
    from emojivoice_tpu_torch.apps.emoji import EMOJI_MAPPING

    spks = list(EMOJI_MAPPING.values())[:PAR_ROWS]
    return [("tp_headline", [HEADLINE], [79], 0),
            ("dp_rows", [f"Row {i} of the batch, {APP_LINES[i % len(APP_LINES)]}" for i in range(PAR_ROWS)], spks,
             list(range(100, 100 + PAR_ROWS))),
            ("dp_bf16", [f"Row {i} of the batch, {APP_LINES[i % len(APP_LINES)]}" for i in range(PAR_ROWS)], spks,
             list(range(100, 100 + PAR_ROWS)))]


def count_plain_calls(mas, mrf) -> None:
    """Count K1's and K2's plain twins' calls in the counters the kernels'
    wrappers keep on the card (a CPU rehearsal of [parallel]'s ranks)."""
    from emojivoice_tpu_torch.models import matcha
    from emojivoice_tpu_torch.vocoder import hifigan

    search, stage = matcha.maximum_path, hifigan.mrf_stage

    def counted_search(*a, **k):
        mas.launches += 1
        return search(*a, **k)

    def counted_stage(x, weights, *a, **k):
        mrf.launches[(x.shape[-1], "bf16" if weights[0][0].dtype == torch.bfloat16 else "f32")] += 1
        return stage(x, weights, *a, **k)

    matcha.maximum_path, hifigan.mrf_stage = counted_search, counted_stage


def timed_step(state, batch, device) -> float:
    """Milliseconds of one more ``train_step`` on `batch`, the device's work included."""
    from emojivoice_tpu_torch.training.state import train_step

    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    sync()
    t = time.perf_counter()
    train_step(state, batch, PAR_SEED)
    sync()
    return (time.perf_counter() - t) * 1e3


def parallel_rank(rank: int, world: int, port: int, task_dir: str) -> None:
    """One of [parallel]'s two ranks, both on the one card over gloo: (b) the
    DDP, TP-2 and conformer DDP steps, (d) the TP-2 state through DCP, (c) the
    TP-2 and DP-2 pipelines; K1 counted per request, K2 over the steps."""
    import numpy as np
    import torch.distributed as dist

    from emojivoice_tpu_torch import config
    from emojivoice_tpu_torch.inference.pipeline import SynthesisPipeline
    from emojivoice_tpu_torch.io.checkpoint import CheckpointManager
    from emojivoice_tpu_torch.ops import mas, mrf
    from emojivoice_tpu_torch.parallel.mesh import (collectives, initialize_distributed, make_mesh,
                                                    pad_batch_to_multiple, shard_batch)
    from emojivoice_tpu_torch.parallel.tp import full_state_dict, make_mesh_2d
    from emojivoice_tpu_torch.training.state import batch_to_device, train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    task = Path(task_dir)
    batch_np = dict(np.load(task / "batch.npz"))
    spec = json.loads((task / "task.json").read_text())
    root, conformer = (config.from_dict(config.RootConfig, spec[k]) for k in ("root", "conformer"))
    dev = initialize_distributed(f"localhost:{port}", world, rank, device=spec["device"], backend="gloo")
    if dev.type != "cuda":  # a rehearsal on the CPU: count the plain twins' calls as the card counts launches
        count_plain_calls(mas, mrf)
    out = {}
    try:
        meshes = {"ddp": make_mesh(world, device=dev), "tp": make_mesh_2d(1, world, device=dev)}
        mas.launches = 0  # the steps of (b), two of each state: one K2 launch each, on every rank
        for name, cfg in (("ddp", no_dropout(root.model)), ("tp", no_dropout(root.model)),
                          ("conformer", no_dropout(conformer.model))):
            mesh = meshes["tp" if name == "tp" else "ddp"]
            state = parallel_state(cfg, dev, mesh, PAR_SEED)
            rows = shard_batch(mesh, pad_batch_to_multiple(batch_np, mesh.size("data")))
            local = batch_to_device(rows, dev)
            m = train_step(state, local, PAR_SEED)
            full = full_state_dict(state.model, mesh)
            if rank == 0:
                np.savez(task / f"{name}.npz", **{f"m.{k}": np.float64(float(v)) for k, v in m.items()},
                         **{f"p.{k}": v.float().cpu().numpy() for k, v in full.items()})
            # a second step, timed, with the port's own collectives counted and DDP's gradient buckets beside them
            collectives.clear()
            out[f"{name}.step_ms"] = timed_step(state, local, dev)
            out[f"{name}.collectives"] = dict(collectives)
            out[f"{name}.ddp_buckets"] = str(state.ddp._get_ddp_logging_data().get("bucket_sizes", "?"))
            if name == "tp":  # (d) through DCP and back into a state from another seed
                mgr = CheckpointManager(str(task / "ckpts"), sharded=True)
                mgr.save(state.step, state.sharded_state_dict(), cfg=root)
                other = parallel_state(cfg, dev, mesh, PAR_SEED + 1)
                other.load_sharded_state_dict(mgr.restore(template=other.sharded_state_dict()))
                differ = [] if other.step == state.step else ["step"]
                for (k, a), b in zip(state.model.state_dict().items(), other.model.state_dict().values()):
                    differ += [] if torch.equal(a, b) else [k]
                for (k, pa), pb in zip(state.model.named_parameters(), other.model.parameters()):
                    differ += [f"{k}.{m}" for m in ("step", "exp_avg", "exp_avg_sq")
                               if not torch.equal(state.optimizer.state[pa][m], other.optimizer.state[pb][m])]
                out["dcp_equal"], out["dcp_differ"] = not differ, differ[:8]
                del other
            del state
        out["k2"] = mas.launches

        kw = dict(seed=0, device=dev, cleaners=("basic_cleaners",))
        tp_pipe = SynthesisPipeline.from_random(root, mesh=meshes["tp"], **kw)
        dp_pipe = SynthesisPipeline.from_random(root, mesh=meshes["ddp"], **kw)
        dp16 = SynthesisPipeline(root.model, dp_pipe.model, root.vocoder, dp_pipe.vocoder, device=dev,
                                 cleaners=("basic_cleaners",), vocoder_dtype=torch.bfloat16, mesh=meshes["ddp"])
        pipes = {"tp_headline": tp_pipe, "dp_rows": dp_pipe, "dp_bf16": dp16}
        for name, texts, spks, seed in parallel_requests(root):
            mode = "bf16" if name == "dp_bf16" else "f32"
            mrf.launches.clear()  # this rank's K1 launches of this request
            res = pipes[name].synthesise(texts, spks=spks, seed=seed, n_timesteps=spec["steps"],
                                         denoiser_strength=STRENGTH)
            counts = dict(mrf.launches)
            if dev.type == "cuda" and counts != {(c, mode): 1 for c in (256, 128, 64, 32)}:
                raise RuntimeError(f"[parallel] rank {rank} {name}: K1 launches {counts}, expected one per stage "
                                   f"in {mode}")
            out[f"k1.{name}"] = sum(counts.values())
            if rank == 0:
                np.savez(task / f"{name}.npz", **{f"wav.{i}": r.wav for i, r in enumerate(res)},
                         **{f"mel.{i}": r.mel for i, r in enumerate(res)})
    finally:
        dist.destroy_process_group()
    (task / f"rank{rank}.json").write_text(json.dumps(out))


def parallel_step_errors(ref: dict, got: dict, name: str) -> dict:
    """One step of ranks against one process: the metrics' relative errors, the
    parameters' max and mean abs error (BatchNorm buffers apart)."""
    import numpy as np

    loss = max(abs(float(got[f"m.{k}"]) - ref["m"][k]) / abs(ref["m"][k])
               for k in ("loss", "dur_loss", "prior_loss", "diff_loss", "grad_norm"))
    params = [k for k in ref["p"] if k in ref["params"]]
    errs = [np.abs(got[f"p.{k}"] - ref["p"][k]) for k in params]
    out = dict(loss_rel=loss, param_max=max(float(e.max()) for e in errs),
               param_mean=float(sum(float(e.sum()) for e in errs) / sum(e.size for e in errs)))
    bn = [k for k in ref["p"] if k not in ref["params"] and "running" in k]
    if bn:
        out["bn_buffer_max"] = max(float(np.abs(got[f"p.{k}"] - ref["p"][k]).max()) for k in bn)
        out["bn_buffers_within"] = all(np.allclose(got[f"p.{k}"], ref["p"][k], rtol=PAR_BN_RTOL, atol=PAR_BN_ATOL)
                                       for k in bn)
        out["bn_buffers_moved"] = sum(not np.array_equal(ref["p"][k], ref["p0"][k]) for k in bn)
    ok = loss <= PAR_LOSS_RTOL and out["param_max"] <= PAR_PARAM_ATOL and out["param_mean"] <= PAR_PARAM_MEAN \
        and out.get("bn_buffers_within", True)
    print(f"[parallel] (b) {name} step, two ranks against one process: loss/grad-norm rel err {loss:.3e} (bound "
          f"{PAR_LOSS_RTOL}), params max abs err {out['param_max']:.3e} (bound {PAR_PARAM_ATOL}), mean "
          f"{out['param_mean']:.3e} (bound {PAR_PARAM_MEAN})"
          + (f", BatchNorm buffers max abs err {out['bn_buffer_max']:.3e} (bound rtol {PAR_BN_RTOL} atol "
             f"{PAR_BN_ATOL}), {out['bn_buffers_moved']} moved" if bn else ""))
    if not ok:
        raise RuntimeError(f"[parallel] (b) {name}: the ranks' step disagrees with one process: {out}")
    return out


def phase_parallel(mas, mrf) -> dict:
    """[parallel]: (a) ``train.main(--num_devices 1)`` on NCCL at world size
    1 against the same run without the flag, checkpoint and ``--resume``; (b)
    two ranks on the one card over gloo, dropout 0 by config override (and the
    prenet's fixed 0.5): a DDP step, a TP-2 step and a conformer DDP step
    against one process; (c) on the same ranks the TP-2 pipeline's headline,
    the DP-2 pipeline's eight seeded rows (f32, then K1's bf16 mode) against
    one process, each rank launching K1 on all four stages of every request;
    (d) the TP-2 state through DCP on the card, equal to the bit."""
    import numpy as np

    from emojivoice_tpu_torch import config
    from emojivoice_tpu_torch.apps.emoji import EMOJI_MAPPING
    from emojivoice_tpu_torch.data.dataset import BucketBatcher, TextMelDataset
    from emojivoice_tpu_torch.inference.pipeline import SynthesisPipeline
    from emojivoice_tpu_torch.parallel.mesh import free_port, spawn
    from emojivoice_tpu_torch.training import train
    from emojivoice_tpu_torch.training.state import batch_to_device, train_step
    from emojivoice_tpu_torch.training.synthetic import make_alignable_dataset

    root = config.get_preset(PRESET)
    out = {}
    with tempfile.TemporaryDirectory(prefix="emojivoice_parallel_") as tmp:
        tmp = Path(tmp)
        train_list, val_list, _ = make_alignable_dataset(tmp / "corpus", list(EMOJI_MAPPING.values()),
                                                         n_utts=2 * TRAIN_BATCH, seed=0, long_texts=True)
        # (a) the trainer at world size 1 on NCCL, a checkpoint and --resume, against the run without the flag
        args = ["--preset", PRESET, "--device", DEVICE, "--train_filelist", str(train_list), "--valid_filelist",
                str(val_list), "--batch_size", str(TRAIN_BATCH), "--overfit_batches", "1", "--val_every_steps", "0",
                "--log_every", "1", "--render_val_samples", "0", "--seed", str(PAR_SEED)]
        t = time.perf_counter()
        # the card's backward adds atomically (embedding and gather gradients): deterministic kernels for (a), so
        # that two runs can be held to each other at all; two runs without the flag show what is left
        with deterministic("parallel"):
            for name in ("one", "again"):
                if train.main(args + ["--out_dir", str(tmp / name), "--max_steps", str(PAR_STEPS + 1)]) != 0:
                    raise RuntimeError("[parallel] (a) the run without --num_devices failed")
            mas.launches = 0  # the main path's run of (a)
            if train.main(args + ["--out_dir", str(tmp / "n1"), "--max_steps", str(PAR_STEPS), "--ckpt_every_steps",
                                  str(PAR_STEPS), "--num_devices", "1"]) != 0 or \
                    train.main(args + ["--out_dir", str(tmp / "n1"), "--max_steps", str(PAR_STEPS + 1), "--resume",
                                       "--num_devices", "1"]) != 0:
                raise RuntimeError("[parallel] (a) the --num_devices 1 run failed")
            k2_a = mas.launches
        one, again, n1 = (read_metrics(tmp / name, "train") for name in ("one", "again", "n1"))
        keys = ("loss", "dur_loss", "prior_loss", "diff_loss", "grad_norm")

        def rel(a, b):
            return max(abs(x[k] - y[k]) / abs(y[k]) for x, y in zip(a, b) for k in keys)

        steps = [r["step"] for r in n1] == [r["step"] for r in one] == list(range(1, PAR_STEPS + 2))
        out["a"] = dict(losses=[r["loss"] for r in n1], rel_err=rel(n1, one), spread_without_flag=rel(again, one),
                        equal_to_the_bit=all(x[k] == y[k] for x, y in zip(n1, one) for k in keys), k2_launches=k2_a)
        print(f"[parallel] (a) train.main --num_devices 1 (NCCL, world size 1, DDP), {PAR_STEPS} steps, a checkpoint "
              f"and --resume for one more: losses {[round(r['loss'], 6) for r in n1]}; against the run without the "
              f"flag: max rel err {out['a']['rel_err']:.3e} (bound {PAR_ONE_RTOL}; equal to the bit "
              f"{out['a']['equal_to_the_bit']}), two runs without the flag {out['a']['spread_without_flag']:.3e}; "
              f"K2 launches {k2_a} ({time.perf_counter() - t:.1f} s)")
        if not steps or out["a"]["rel_err"] > PAR_ONE_RTOL or k2_a != PAR_STEPS + 1:
            raise RuntimeError(f"[parallel] (a) {out['a']}: steps {[r['step'] for r in n1]}")

        # one process's numbers on the card: the steps of (b) and the requests of (c)
        data_cfg = dataclasses.replace(root.data, train_filelist_path=str(train_list),
                                       valid_filelist_path=str(val_list), batch_size=TRAIN_BATCH, seed=PAR_SEED)
        batch_np = next(iter(BucketBatcher(TextMelDataset(str(train_list), data_cfg), TRAIN_BATCH, seed=PAR_SEED)))
        np.savez(tmp / "batch.npz", **batch_np)
        (tmp / "task.json").write_text(json.dumps({"device": DEVICE, "steps": STEPS, "root": config.to_dict(root),
                                                   "conformer": config.to_dict(conformer_root())}))
        refs = {}
        for name, cfg in (("transformer", no_dropout(root.model)), ("conformer", no_dropout(conformer_root().model))):
            state = parallel_state(cfg, DEVICE, None, PAR_SEED)
            start = {k: v.float().cpu().numpy().copy() for k, v in state.model.state_dict().items()}
            batch = batch_to_device(batch_np, DEVICE)
            m = train_step(state, batch, PAR_SEED)
            refs[name] = {"m": {k: float(v) for k, v in m.items()}, "p0": start,
                          "p": {k: v.float().cpu().numpy().copy() for k, v in state.model.state_dict().items()},
                          "params": {k for k, _ in state.model.named_parameters()},
                          "step_ms": timed_step(state, batch, DEVICE)}
            del state
        pipe = SynthesisPipeline.from_random(root, seed=0, device=DEVICE, cleaners=("basic_cleaners",))
        pipe16 = SynthesisPipeline(root.model, pipe.model, root.vocoder, pipe.vocoder, device=DEVICE,
                                   cleaners=("basic_cleaners",), vocoder_dtype=torch.bfloat16)
        want = {name: (pipe16 if name == "dp_bf16" else pipe).synthesise(texts, spks=spks, seed=seed,
                                                                         n_timesteps=STEPS, denoiser_strength=STRENGTH)
                for name, texts, spks, seed in parallel_requests(root)}
        del pipe, pipe16
        torch.cuda.empty_cache()

        t = time.perf_counter()
        spawn(parallel_rank, 2, (2, free_port(), str(tmp)), timeout_s=PAR_WAIT_S)
        ranks = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(2)]
        print(f"[parallel] (b)-(d) two ranks on one card over gloo ran in {time.perf_counter() - t:.1f} s")
        out["ddp"] = parallel_step_errors(refs["transformer"], dict(np.load(tmp / "ddp.npz")), "DDP")
        out["tp"] = parallel_step_errors(refs["transformer"], dict(np.load(tmp / "tp.npz")), "TP-2")
        out["conformer"] = parallel_step_errors(refs["conformer"], dict(np.load(tmp / "conformer.npz")),
                                                "conformer DDP")
        n_bn = sum(k.endswith("running_mean") for k in refs["conformer"]["p"])
        if out["conformer"]["bn_buffers_moved"] != 2 * n_bn:
            raise RuntimeError(f"[parallel] (b) conformer: {out['conformer']['bn_buffers_moved']} BatchNorm "
                               f"statistics moved, expected the mean and variance of {n_bn} blocks")
        bounds = {"tp_headline": PAR_WAV_TP, "dp_rows": PAR_WAV_DP, "dp_bf16": VOCODER_TOL}
        for name, ref in want.items():
            got = dict(np.load(tmp / f"{name}.npz"))
            lengths = [r.mel_length for r in ref] == [got[f"mel.{i}"].shape[0] for i in range(len(ref))]
            wav = max(float(np.abs(got[f"wav.{i}"] - r.wav).max()) if got[f"wav.{i}"].shape == r.wav.shape
                      else float("inf") for i, r in enumerate(ref))
            mel = max(float(np.abs(got[f"mel.{i}"] - r.mel).mean()) if got[f"mel.{i}"].shape == r.mel.shape
                      else float("inf") for i, r in enumerate(ref))
            out[name] = dict(rows=len(ref), same_lengths=lengths, wav_max_abs_err=wav, mel_mae=mel,
                             k1_launches=[rk[f"k1.{name}"] for rk in ranks])
            print(f"[parallel] (c) {name}: {len(ref)} row(s) against one process: mel lengths equal {lengths}, wav "
                  f"max abs err {wav:.3e} (bound {bounds[name]}), mel MAE {mel:.3e} (bound {PAR_MEL_MAE}); K1 "
                  f"launches per rank {out[name]['k1_launches']}")
            if not lengths or wav > bounds[name] or mel > PAR_MEL_MAE:
                raise RuntimeError(f"[parallel] (c) {name} disagrees with one process: {out[name]}")
        print(f"[parallel] (d) TP-2 state (parameters, Adam moments, step) through DCP and back, on every rank: "
              f"equal to the bit {[rk['dcp_equal'] for rk in ranks]} (differ: {[rk['dcp_differ'] for rk in ranks]})")
        if not all(rk["dcp_equal"] for rk in ranks):
            raise RuntimeError("[parallel] (d) the restored TP-2 state differs from the saved one")
        k2_ranks = [rk["k2"] for rk in ranks]
        if k2_ranks != [6, 6]:
            raise RuntimeError(f"[parallel] (b) K2 launches per rank {k2_ranks}, expected one per step (six)")
        for name, ref in (("ddp", "transformer"), ("tp", "transformer"), ("conformer", "conformer")):
            out[name].update(step_ms=[rk[f"{name}.step_ms"] for rk in ranks], one_process_ms=refs[ref]["step_ms"],
                             collectives=ranks[0][f"{name}.collectives"], ddp_buckets=ranks[0][f"{name}.ddp_buckets"])
            print(f"[parallel] (b) {name}: a second step {out[name]['step_ms'][0]:.1f} / {out[name]['step_ms'][1]:.1f} "
                  f"ms on ranks 0 / 1 (both on one card over gloo) against {refs[ref]['step_ms']:.1f} ms in one "
                  f"process; the port's collectives a step {out[name]['collectives']}, DDP's gradient buckets (bytes) "
                  f"{out[name]['ddp_buckets']}")
    out.update(k2_launches=k2_a + sum(k2_ranks),
               k1_launches=sum(rk["k1.tp_headline"] + rk["k1.dp_rows"] for rk in ranks),
               k1_bf16_launches=sum(rk["k1.dp_bf16"] for rk in ranks))
    return out


# [train_graphs]: graphed steps against eager ones from the same seeded state, two bucket keys interleaved (the
# [train] step's shape and one of half its length), dropout on, under deterministic kernels: equal to the bit
TG_SEED, TG_KEYS, TG_ORDER = 1234, ((TRAIN_BATCH, 256, 1536), (TRAIN_BATCH, 128, 768)), (0, 1, 0, 1)
TG_TIMED = 5  # steps per turn of the eager / graphs / graphs / eager timing at the first key
ADAM_STEPS = 5  # capturable Adam against the plain one: steps on one tensor, gradients of many scales


def states_differ(a, b) -> list:
    """Names of the tensors where two train states differ: parameters, Adam's moments and step counts, buffers."""
    out = []
    for (name, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        if not torch.equal(p, q):
            out.append(name)
        sa, sb = a.optimizer.state[p], b.optimizer.state[q]
        out += [f"{name}.{k}" for k in ("exp_avg", "exp_avg_sq", "step") if not torch.equal(sa[k], sb[k])]
    return out + [name for (name, x), y in zip(a.model.named_buffers(), b.model.buffers()) if not torch.equal(x, y)]


def metrics_differ(got: list, want: list) -> list:
    return [(i, k) for i, (g, w) in enumerate(zip(got, want)) for k in g if not torch.equal(g[k].cpu(), w[k].cpu())]


def val_render(cfg, model):
    """``train.py``'s ``render_val_samples`` on `model`: one mel-only pipeline on the live model, made once
    (through its own serving graphs), the headline at speaker 79, 10 steps, seed 0, in eval mode."""
    from emojivoice_tpu_torch.inference.pipeline import SynthesisPipeline

    pipe = SynthesisPipeline(cfg, model, device=DEVICE, cleaners=("basic_cleaners",))

    def render():
        model.eval()
        try:
            return pipe.synthesise([TEXT11], spks=[79], n_timesteps=10, seed=0, vocode=False)[0].mel
        finally:
            model.train()
    return pipe, render


def graphed_against_eager(mas, cfg, opt_cfg, precision: str, batches: list, render: bool = False) -> dict:
    """The same steps through graphs and eagerly from one seeded initial state → the two states, their
    metrics, K2's count in each run, and (`render`) the render of each before and after the steps, and after
    them through a pipeline made afresh."""
    from emojivoice_tpu_torch.training.state import create_train_state, train_step

    out = {"states": {}, "metrics": {}, "k2": {}, "renders": {}}
    for mode in ("graphs", "eager"):
        st = create_train_state(cfg, opt_cfg, seed=TG_SEED, device=DEVICE)
        if render:
            pipe, fn = val_render(cfg, st.model)
            before = fn()
        k2 = mas.launches
        out["metrics"][mode] = [train_step(st, b, TG_SEED, precision=precision, graphs=mode == "graphs")
                                for b in batches]
        torch.cuda.synchronize()
        out["k2"][mode] = mas.launches - k2
        if render:
            out["renders"][mode] = dict(before=before, after=fn(), fresh=val_render(cfg, st.model)[1](),
                                        drops=None if pipe.graphs is None else pipe.graphs.stats()["drops"])
        out["states"][mode] = st
    out["metrics_differ"] = metrics_differ(out["metrics"]["graphs"], out["metrics"]["eager"])
    out["tensors_differ"] = states_differ(out["states"]["graphs"], out["states"]["eager"])
    return out


def resumed_across_modes(cfg, opt_cfg, state, graphs_from: bool, batches: list) -> dict:
    """A checkpoint of `state` (written as the trainer writes one) resumed in the other mode on a state made
    from another seed, against `state` itself going on in its own mode: the metrics and every tensor equal."""
    import io

    from emojivoice_tpu_torch.training.state import create_train_state, train_step

    buf = io.BytesIO()
    torch.save(state.state_dict(), buf)
    want = [train_step(state, b, TG_SEED, graphs=graphs_from) for b in batches]
    other = create_train_state(cfg, opt_cfg, seed=TG_SEED + 1, device=DEVICE)
    buf.seek(0)
    other.load_state_dict(torch.load(buf, map_location=DEVICE, weights_only=False))
    got = [train_step(other, b, TG_SEED, graphs=not graphs_from) for b in batches]
    torch.cuda.synchronize()
    out = dict(metrics_differ=metrics_differ(got, want), tensors_differ=states_differ(other, state))
    del other
    return out


def resumed_from_plain_adam(cfg, opt_cfg, first: list, then: list) -> dict:
    """A checkpoint of a plain (not capturable) Adam after the steps `first`, as one written on the CPU or
    before the card's optimizer was capturable holds it, resumed through graphs and eagerly on states
    from another seed over the steps `then`: the two equal to the bit, each optimizer capturable again."""
    import io

    from emojivoice_tpu_torch.training.state import create_train_state, make_optimizer, train_step

    plain = create_train_state(cfg, opt_cfg, seed=TG_SEED, device=DEVICE)
    plain.optimizer = make_optimizer(plain.model.parameters(), opt_cfg)  # capturable=False
    for b in first:
        train_step(plain, b, TG_SEED, graphs=False)
    buf = io.BytesIO()
    torch.save(plain.state_dict(), buf)
    del plain
    states, metrics, capturable = {}, {}, {}
    for mode in ("graphs", "eager"):
        st = create_train_state(cfg, opt_cfg, seed=TG_SEED + 1, device=DEVICE)
        buf.seek(0)
        st.load_state_dict(torch.load(buf, map_location=DEVICE, weights_only=False))
        capturable[mode] = all(g["capturable"] and torch.is_tensor(g["lr"]) for g in st.optimizer.param_groups)
        metrics[mode] = [train_step(st, b, TG_SEED, graphs=mode == "graphs") for b in then]
        states[mode] = st
    torch.cuda.synchronize()
    out = dict(metrics_differ=metrics_differ(metrics["graphs"], metrics["eager"]),
               tensors_differ=states_differ(states["graphs"], states["eager"]), capturable=capturable)
    del states
    return out


def capturable_adam_check() -> dict:
    """The card's capturable Adam (bias corrections from device step counts in f32 tensors, the rate a device
    tensor) against the plain one (bias corrections as Python floats) on the same tensor and gradients, the
    config's betas at lr 1e-4, gradients from 1e-8 to 1 in size: how far the two updates part."""
    from emojivoice_tpu_torch.config import OptimizerConfig

    cfg = OptimizerConfig()
    g = torch.Generator(device=DEVICE).manual_seed(3)
    n = 1 << 22
    start = torch.randn(n, generator=g, device=DEVICE) * 0.05
    a, b = start.clone().requires_grad_(), start.clone().requires_grad_()
    kw = dict(betas=(cfg.b1, cfg.b2), eps=1e-8, foreach=True)
    plain = torch.optim.Adam([a], lr=cfg.lr, **kw)
    cap = torch.optim.Adam([b], lr=torch.tensor(cfg.lr, device=DEVICE), capturable=True, **kw)
    for _ in range(ADAM_STEPS):
        scale = 10.0 ** (-8.0 * torch.rand(n, generator=g, device=DEVICE))
        grad = torch.randn(n, generator=g, device=DEVICE) * scale
        a.grad, b.grad = grad, grad.clone()
        plain.step()
        cap.step()
    diff = (a.detach() - b.detach()).abs()
    moved = (a.detach() - start).abs()
    return dict(elements=n, steps=ADAM_STEPS, lr=cfg.lr, max_abs_diff=float(diff.max()),
                share_differ=float((diff > 0).float().mean()), max_diff_over_lr=float(diff.max()) / cfg.lr,
                mean_move_over_lr=float(moved.mean()) / cfg.lr)


def phase_train_graphs(mas) -> dict:
    """[train_graphs]: the acoustic train step through its captured CUDA graphs against the eager step at the
    [train] step's shape, under deterministic kernels with dropout on: (a) f32, bf16-mixed and a conformer
    decoder, two bucket keys interleaved, metrics, parameters, Adam's moments and buffers equal to the bit;
    (b) a checkpoint of each mode resumed exactly in the other; (c) the validation render after graphed steps
    equal to the one after eager steps (and to a pipeline made afresh); (d) K2 once a step, replays included;
    then, outside the deterministic context: (e) steps per second in turns eager / graphs / graphs / eager, the
    capture ms per key and pool bytes, one profiled step of each (device ms, busy share); (f) the capturable
    Adam against the plain one."""
    from emojivoice_tpu_torch import config
    from emojivoice_tpu_torch.bench import util
    from emojivoice_tpu_torch.bench.train import make_batch
    from emojivoice_tpu_torch.training.state import train_step

    root = config.get_preset(PRESET)
    cfg, opt_cfg = root.model, root.optimizer
    batches = [make_batch(cfg, *TG_KEYS[k], DEVICE, seed=100 + i) for i, k in enumerate(TG_ORDER)]
    more = [make_batch(cfg, *TG_KEYS[k], DEVICE, seed=200 + i) for i, k in enumerate(TG_ORDER[:2])]
    out = {}
    mas.launches = 0  # the main path's run: the train steps of this phase, graphed and eager
    with deterministic("train_graphs"):
        runs = {}
        for name, c, precision in (("f32", cfg, "f32"), ("bf16-mixed", cfg, "bf16-mixed"),
                                   ("conformer f32", conformer_root().model, "f32")):
            t = time.perf_counter()
            run = graphed_against_eager(mas, c, opt_cfg, precision, batches, render=name == "f32")
            g = run["states"]["graphs"].graphs
            out[name] = dict(metrics_differ=run["metrics_differ"], tensors_differ=run["tensors_differ"][:8],
                             n_tensors_differ=len(run["tensors_differ"]), k2=run["k2"], captures=g.captures,
                             replays=g.stats()["replays"], seconds=time.perf_counter() - t)
            print(f"[train_graphs] (a) {name}: {len(TG_ORDER)} steps over keys {TG_KEYS} through graphs against "
                  f"eager " + json.dumps(out[name]))
            if name == "f32":
                runs = run
            else:
                del run
            gc.collect()
        # (b) a checkpoint written from graphs resumed eagerly, and the reverse
        for mode, graphs_from in (("graphs -> eager", True), ("eager -> graphs", False)):
            written_by = runs["states"]["graphs" if graphs_from else "eager"]
            out[f"resume {mode}"] = r = resumed_across_modes(cfg, opt_cfg, written_by, graphs_from, more)
            print(f"[train_graphs] (b) checkpoint {mode}: " + json.dumps(r))
        out["resume plain Adam"] = r = resumed_from_plain_adam(cfg, opt_cfg, batches[:2], more + batches[2:])
        print("[train_graphs] (b) a plain Adam's checkpoint through graphs and eagerly: " + json.dumps(r))
        # (c) the validation render after the graphed steps, against the eager steps' and a fresh pipeline's
        rg, re_ = runs["renders"]["graphs"], runs["renders"]["eager"]
        out["render"] = dict(graphs_equal_eager=bool(np.array_equal(rg["after"], re_["after"])),
                             equal_to_fresh_pipeline=bool(np.array_equal(rg["after"], rg["fresh"])),
                             moved_from_before=not np.array_equal(rg["after"], rg["before"]),
                             pipeline_graph_drops=rg["drops"], mel_shape=list(rg["after"].shape))
        print("[train_graphs] (c) val render " + json.dumps(out["render"]))
    k2 = mas.launches
    # (a): three runs in two modes; (b): two steps on each side of two resumes, and the plain Adam's two steps
    # and the four after its resume in two modes (two of them replays)
    steps = 3 * 2 * len(TG_ORDER) + 4 * len(more) + 2 + 2 * (len(more) + len(TG_ORDER) - 2)
    out["k2_launches"], out["steps"] = k2, steps
    print(f"[train_graphs] (d) K2 launches {k2} in {steps} steps (graphed: one a replay)")
    # (f) before (e): its timings come before this process's first profiled call
    out["eval"] = eval_graphed_against_eager(mas, cfg, opt_cfg, batches)
    out["k2_launches"] += out["eval"]["k2_launches"]
    gc.collect()

    # (e) eager against graphs on the f32 states at the first key, outside the deterministic context
    sg, se = runs["states"]["graphs"], runs["states"]["eager"]
    timing = {"eager": [], "graphs": []}
    for mode in ("eager", "graphs", "graphs", "eager"):
        st = sg if mode == "graphs" else se
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(TG_TIMED):
            train_step(st, batches[0], TG_SEED, graphs=mode == "graphs")
        torch.cuda.synchronize()
        timing[mode].append(TG_TIMED / (time.perf_counter() - t))
    stats = sg.graphs.stats()
    prof = {mode: util.profile_call(lambda st=st, mode=mode: train_step(st, batches[0], TG_SEED,
                                                                        graphs=mode == "graphs"), torch.device(DEVICE))
            for mode, st in (("graphs", sg), ("eager", se))}
    out["timing"] = dict(key=list(TG_KEYS[0]), steps_per_s_eager=timing["eager"], steps_per_s_graphs=timing["graphs"],
                         capture_ms=stats["capture_ms"], first_step_ms=stats["first_step_ms"],
                         pool_bytes=sg.graphs.pool_bytes(),
                         device_ms={m: p["device_ms"] for m, p in prof.items()},
                         busy={m: p["busy"] for m, p in prof.items()},
                         profiled_wall_ms={m: p["profiled_wall_ms"] for m, p in prof.items()})
    print("[train_graphs] (e) " + json.dumps(out["timing"]))
    out["adam"] = capturable_adam_check()
    print("[train_graphs] (g) capturable Adam against the plain one " + json.dumps(out["adam"]))
    del runs, sg, se
    gc.collect()
    torch.cuda.empty_cache()

    bad = [n for n in ("f32", "bf16-mixed", "conformer f32")
           if out[n]["metrics_differ"] or out[n]["n_tensors_differ"] or out[n]["k2"] != {"graphs": len(TG_ORDER),
                                                                                        "eager": len(TG_ORDER)}
           or out[n]["captures"] != len(TG_KEYS) or out[n]["replays"] != len(TG_ORDER) - len(TG_KEYS)]
    bad += [n for n in ("resume graphs -> eager", "resume eager -> graphs", "resume plain Adam")
            if out[n]["metrics_differ"] or out[n]["tensors_differ"]]
    if not all(out["resume plain Adam"]["capturable"].values()):
        bad.append("plain Adam's checkpoint: optimizer not capturable after the load")
    if not all(out["render"][k] for k in ("graphs_equal_eager", "equal_to_fresh_pipeline", "moved_from_before")):
        bad.append("render")
    if k2 != steps:
        bad.append("K2 count")
    if not out["adam"]["max_abs_diff"] <= 1e-2 * out["adam"]["lr"]:
        bad.append("capturable Adam")
    if bad:
        raise RuntimeError(f"[train_graphs] failed: {bad}")
    return out


def eval_graphed_against_eager(mas, cfg, opt_cfg, batches: list) -> dict:
    """[train_graphs] (f): the eval step (``training/eval_graphs.py``) at the two bucket keys, each call
    between two graphed train steps, and the trainer's probe on a fixed batch and noise, each through its
    captured graph against the eager forward on the same weights, under deterministic kernels: the losses and
    every probe output equal to the bit, one K2 launch a call (replays counted by the graphs), capture ms per
    key and the pool's bytes; then host ms a call of each, graphed and eager, in turns.  The main path's run of
    the eval graphs (K2 read from its value at the start)."""
    from emojivoice_tpu_torch.bench.train import make_batch
    from emojivoice_tpu_torch.training.eval_graphs import graphs_for
    from emojivoice_tpu_torch.training.state import create_train_state, eval_step, train_step
    from emojivoice_tpu_torch.utils.prng import step_generator

    evals = [make_batch(cfg, *TG_KEYS[k], DEVICE, seed=300 + i) for i, k in enumerate(TG_ORDER)]
    probe = make_batch(cfg, *TG_KEYS[1], DEVICE, seed=400)
    z = torch.randn(probe["y"].shape, generator=step_generator(0, 0, "probe", DEVICE), device=DEVICE) * 0.667
    out = {"differ": [], "k2_per_graphed_call": []}
    t = time.perf_counter()
    launches = mas.launches
    with deterministic("eval_graphs"):
        st = create_train_state(cfg, opt_cfg, seed=TG_SEED, device=DEVICE)
        graphs = graphs_for(st.model).follow(st.optimizer)
        for i, (b, e) in enumerate(zip(batches, evals)):
            train_step(st, b, TG_SEED, graphs=True)
            for name, fn in (("eval", lambda g: eval_step(st.model, e, graphs=g)),
                             ("probe", lambda g: graphs.probe(probe, z) if g else eager_probe(st.model, probe, z))):
                k2 = mas.launches
                got = fn(True)
                torch.cuda.synchronize()
                out["k2_per_graphed_call"].append(mas.launches - k2)
                want = fn(False)
                out["differ"] += [f"{name} {i} {k}" for k in want if not torch.equal(got[k], want[k])]
        torch.cuda.synchronize()
    # host ms a call at the first key (and the probe), in turns eager / graphs / graphs / eager, TG_TIMED calls a turn
    timed = {"eval": lambda g: eval_step(st.model, evals[0], graphs=g),
             "probe": lambda g: graphs.probe(probe, z) if g else eager_probe(st.model, probe, z)}
    for name, fn in timed.items():
        ms = {"eager": [], "graphs": []}
        for mode in ("eager", "graphs", "graphs", "eager"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(TG_TIMED):
                fn(mode == "graphs")
            torch.cuda.synchronize()
            ms[mode].append((time.perf_counter() - t0) * 1e3 / TG_TIMED)
        out[f"{name}_ms"] = ms
    stats = graphs.stats()
    # a train step, and the eval step and the probe each graphed and eager, between two train steps; the timed calls
    out.update(k2_launches=mas.launches - launches, calls=5 * len(batches) + 2 * 4 * TG_TIMED,
               keys=[repr(k) for k in graphs.keys()],
               captures=stats["captures"], replays=stats["replays"], capture_ms=stats["capture_ms"],
               pool_bytes=graphs.pool_bytes(), seconds=time.perf_counter() - t)
    print("[train_graphs] (f) eval step at two keys between graphed train steps, and the probe, through graphs "
          "against eager " + json.dumps(out))
    bad = out["differ"] + [f"K2 {n} a graphed call" for n in out["k2_per_graphed_call"] if n != 1]
    if out["k2_launches"] != out["calls"] or out["captures"] != len(TG_KEYS) + 1 \
            or out["replays"] != 2 * len(batches) - out["captures"] + 2 * 2 * TG_TIMED:
        bad.append(f"K2 {out['k2_launches']} for {out['calls']} calls, captures {out['captures']}, replays "
                   f"{out['replays']}")
    if bad:
        raise RuntimeError(f"[train_graphs] (f) failed: {bad}")
    del st, graphs
    return out


def eager_probe(model, batch: dict, z: torch.Tensor) -> dict:
    """The trainer's eager probe: ``training_probe`` in eval mode."""
    model.eval()
    try:
        return model.training_probe(batch["x"], batch["x_lengths"], batch["y"], batch["y_lengths"], batch.get("spks"),
                                    z=z)
    finally:
        model.train()


# [bench]: each measurement tool's main in process at full width, with short settings
BENCH_ARGS = {
    "synthesis": ["--repeats", "3", "--sweep_repeats", "2", "--buckets", "512", "--batches", "1"],
    "breakdown": ["--repeats", "3", "--profiled", "1"],
    "serving": ["--clients", "8", "--window_s", "4", "--rates", "8"],
    "ttfa": ["--reps", "2"],
    "exported": ["--repeats", "2", "--steps", "2"],  # a 2-step bundle: the [export] phase holds the 10-step one
    "vocoder": ["--iters", "2"],
    "vocoder_stages": ["--reps", "3"],
    "mas": ["--iters", "2", "--reps", "2"],
    "train": ["--iters", "1", "--gan_iters", "3"],
    "mfu": ["--skip_sweep", "--repeats", "2"],
    "multilingual": ["--out", ""],
}
# the JAX tool's count of HiFi-GAN v1 at 1 x 512 frames (XLA's cost model; FLOPs, not a time), and how far the
# port's count from shapes may be from it (elementwise work, which the port does not count, is ~1 % of it)
MFU_ARTIFACT, MFU_HIFIGAN_TOL = Path("docs/artifacts/mfu.json"), 0.02
NOT_A_TIME = ("audio_s", "drain_s", "late_ms", "submit_s")  # may be zero: not a time a kernel or call takes


def bench_times(obj, path: str = "") -> list:
    """(path, value) of every number in a tool's report that is a time."""
    out = []
    if isinstance(obj, dict):
        unit_ms = obj.get("unit") in ("ms", "rtf")
        for k, v in obj.items():
            p = f"{path}.{k}"
            if isinstance(v, (dict, list)):
                out += bench_times(v, p)
            elif isinstance(v, (int, float)) and not isinstance(v, bool) and not k.startswith(NOT_A_TIME) and \
                    (k.endswith(("_ms", "_s", "_ms_min", "_ms_median", "_ms_per_call")) or k.startswith("rtf")
                     or (k == "value" and unit_ms)):
                out.append((p, v))
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            out += bench_times(v, f"{path}[{i}]")
    return out


def run_tool(name: str, argv: list) -> dict:
    """One tool's main in process → its JSON line (stdout captured, stderr passed on)."""
    import contextlib as cl
    import importlib
    import io

    buf = io.StringIO()
    with cl.redirect_stdout(buf):
        rc = importlib.import_module(f"emojivoice_tpu_torch.bench.{name}").main(argv)
    lines = [line for line in buf.getvalue().splitlines() if line.startswith("{")]
    if rc != 0 or len(lines) != 1:
        raise RuntimeError(f"[bench] {name}: exit {rc}, {len(lines)} JSON lines: {buf.getvalue()[-2000:]}")
    return json.loads(lines[0])


def phase_bench(mas, mrf) -> dict:
    """[bench]: the twelve measurement tools of ``emojivoice_tpu_torch/bench/``
    in process on the card at emoji_multi + HiFi-GAN v1 width, each with
    short settings: one parseable JSON line naming the card, every time
    finite and positive, K1 on four stages of every vocoded request, K2 once
    per train step, the headline held beside its same-shape row, and the
    port's HiFi-GAN count within 2 % of the JAX tool's."""
    name_of_card = torch.cuda.get_device_name(0)
    mrf.launches.clear()
    mas.launches = 0
    reports, seconds = {}, {}
    for name, argv in BENCH_ARGS.items():
        t = time.perf_counter()
        reports[name] = rep = run_tool(name, argv)
        seconds[name] = time.perf_counter() - t
        gc.collect()
        torch.cuda.empty_cache()
        bad = [(p, v) for p, v in bench_times(rep) if not (math.isfinite(v) and v > 0)]
        if rep.get("device") != name_of_card or not isinstance(rep.get("power_limit_w"), float) or bad:
            raise RuntimeError(f"[bench] {name}: device {rep.get('device')!r}, power limit "
                               f"{rep.get('power_limit_w')!r}, times not finite and positive {bad[:8]}")
        print(f"[bench] {name} ({seconds[name]:.1f} s): " + json.dumps(rep)[:1500])
    launches = dict(mrf.launches)
    k2 = mas.launches
    syn, ttfa = reports["synthesis"], reports["ttfa"]["lengths"]
    voc = reports["vocoder"]
    per_request = {"synthesis headline": syn["provenance"]["k1_launches"],
                   **{f"synthesis {r['case']}": r["k1_launches"] for r in syn["provenance"]["sweep"]},
                   "breakdown": reports["breakdown"]["k1_launches"],
                   "exported live": reports["exported"]["live"]["k1_launches"],
                   "exported bundle": reports["exported"]["exported"]["k1_launches"],
                   **{f"ttfa {k} full": v["full"]["k1_launches"] for k, v in ttfa.items()},
                   "vocoder b1": voc["k1_b1_launches"], "vocoder b8": voc["k1_b8_launches"]}
    ml = reports["multilingual"]["languages"]
    serving = reports["serving"]
    head_key = f"headline_vs_m{syn['provenance']['mel_bucket']}_b1"  # F4: the headline and its same-shape row
    checks = {
        "K1 four mrf_stage calls a vocoded request": all(v == 4 for v in per_request.values()),
        "K1 four a segment (multilingual)": all(v["k1_launches"] == 4 * v["segments"] and v["finite"]
                                                for v in ml.values()),
        "K1 four a batch (serving)": serving["k1_launches"] == 4 * serving["batches"] and serving["errors"] == 0,
        "K2 once a train step": all(line["k2_launches"] == line["steps"] for line in reports["train"]["lines"]
                                   if "k2_launches" in line),
        "K2 and plain search equal": all(line.get("exact", True) for line in reports["mas"]["lines"]),
        "headline beside its same-shape row": head_key in syn,
    }
    ours = next(p for p in reports["mfu"]["programs"] if p["program"] == "hifigan_b1_t512")["flops_per_call"]
    theirs = next(p for p in json.loads(MFU_ARTIFACT.read_text())["programs"]
                  if p["program"] == "hifigan_b1_t512")["flops_per_call"]
    checks["mfu HiFi-GAN count within 2 % of the JAX tool's"] = abs(ours / theirs - 1) <= MFU_HIFIGAN_TOL
    print(f"[bench] K1 mrf_stage calls per request {per_request}; HiFi-GAN v1 at 1 x 512 frames: the port's count "
          f"{ours / 1e9:.2f} GFLOP, the JAX tool's (XLA's cost model) {theirs / 1e9:.2f} ({ours / theirs - 1:+.2%}); "
          f"{head_key} {syn.get(head_key)}; launches in the phase: K1 {launches}, K2 {k2}; "
          f"checks {checks}")
    if not all(checks.values()):
        raise RuntimeError(f"[bench] failed: {[k for k, v in checks.items() if not v]}")
    return dict(k1_launches=sum(n for (_, mode), n in launches.items() if mode == "f32"),
                k1_bf16_launches=sum(n for (_, mode), n in launches.items() if mode == "bf16"), k2_launches=k2,
                seconds=seconds, reports=reports)


def main() -> int:
    # before CUDA starts: cuBLAS reads it when it makes its first handle (deterministic(): F10)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    graphs = timed("graphs", phase_graphs, mrf)
    mas_rows = timed("kernel K2", phase_kernel_mas, mas)
    training = timed("train + vocoder", phase_training, mas, mrf)
    serving = timed("serve", phase_serving, pipe, mrf)
    apps = timed("apps", phase_apps, pipe, mrf)
    exported = timed("export", phase_export, pipe, mrf)
    bf16_tile_err = bf16_tile_check(mrf)
    promoted = promoted_sum_check(mrf)
    bf16_rows = timed("precision kernel", precision_kernel, mrf)
    precision = timed("precision pipeline", precision_pipeline, mrf, pipe)
    conformer = timed("conformer", phase_conformer, mas, mrf, matcha, training["step"])
    scratch = timed("scratch", phase_scratch, mas)
    swept = timed("sweep", phase_sweep, mas)
    parallel = timed("parallel", phase_parallel, mas, mrf)
    train_graphs = timed("train graphs", phase_train_graphs, mas)
    bench = timed("bench", phase_bench, mas, mrf)
    timed("apps profiled reply", apps_profile)
    timed("export profiled calls", exported.pop("profile"))
    timed("vocoder profiled steps", training["vocoder"].pop("profile"))
    # K1 on the main paths: the synthesis requests, the engine's and the webapp's batches, the apps' turns, demos
    # and agent turn, the trained checkpoint,
    # the vocoder proof's two renders, the fine-tuned generator served, the exported bundle's program runs, the
    # live dispatch under sync debug, and the conformer model's requests, its trained checkpoint and bundle; K2:
    # the trainer's steps and get_durations, the conformer's training, the scratch proof and the sweep's trials
    # and [parallel]'s requests on every rank, and the measurement tools of [bench]; K2: [parallel]'s steps, in
    # process and on every rank, and [bench]'s train steps and MAS timings
    launches += serving["k1_launches"] + training["k1_launches"] + exported["k1_launches"] \
        + exported["k1_launches_live"] + conformer["k1_launches"] + apps["k1_launches"] + parallel["k1_launches"] \
        + bench["k1_launches"] + graphs["k1_launches"]
    k2_launches = training["launches"] + conformer["k2_launches"] + scratch["k2_launches"] + swept["k2_launches"] \
        + parallel["k2_launches"] + train_graphs["k2_launches"] + bench["k2_launches"]

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
        "launches": precision["k1_bf16_launches"] + conformer["k1_bf16_launches"] + parallel["k1_bf16_launches"]
        + bench["k1_bf16_launches"] + graphs["k1_bf16_launches"],
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
        # one K2 node in every captured train step's graph, counted once a replay ([train_graphs] (d))
        "launches_train_graphs": train_graphs["k2_launches"],
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
