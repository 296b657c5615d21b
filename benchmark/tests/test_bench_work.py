"""The yardstick's counts held to figures worked out by hand from the
published shapes, and the acoustic model's count held to the port's own
hook-based count (``emojivoice_tpu_torch/bench/mfu.py``) at emoji_multi's
widths."""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from benchmark import work

CFG = json.loads((Path(__file__).resolve().parents[1] / "configs" / "matcha_emoji_v1.json").read_text())
GPTJ = json.loads((Path(__file__).resolve().parents[1] / "configs" / "agent_whisper_gptj6b.json").read_text())["llm"]


def test_mrf_stage_is_252_btc2_for_v1():
    # three res-blocks (k 3, 7, 11), three dilations each, two k-tap convs per dilation: 2·3·2·(3+7+11) = 252
    assert work.mrf_stage(CFG["vocoder"], 256, 1, 4096).flops == 252 * 4096 * 256**2
    # bytes: the stage's input and output once (2·T·C floats) and its 18 convs' weights and biases
    n_w = 2 * 3 * (256 * 256 * (3 + 7 + 11) + 3 * 256)
    assert work.mrf_stage(CFG["vocoder"], 256, 1, 4096).bytes == 4 * (2 * 4096 * 256 + n_w)


def test_k1_calls_follow_the_upsampling():
    calls = work.k1_calls(CFG["vocoder"], 2, 512)
    # (C, T) per stage: 256 × 4096, 128 × 32768, 64 × 65536, 32 × 131072
    assert [c.flops for c in calls] == [252 * 2 * t * c * c for c, t in ((256, 4096), (128, 32768), (64, 65536),
                                                                           (32, 131072))]


def test_hifigan_v1_at_512_frames():
    # conv_pre 2·512·80·512·7; ups 2·T·C·C/2·k; the MRF stages; conv_post 2·131072·32·7: 314.4218 GFLOP
    w = work.hifigan(CFG["vocoder"], 1, 512)
    assert w.flops == pytest.approx(314_421_805_056, rel=1e-12)


def test_mas_and_the_decode_step_bytes():
    assert work.mas(16, 256, 1536).flops == 2 * 16 * 256 * 1536
    # GPT-J-6B: 28 blocks of 4·4096² + 2·4096·16384 + 16384 + 4096 + 2·4096, ln_f, the head (50400·4096 + 50400)
    per_block = 4 * 4096**2 + 2 * 4096 * 16384 + 16384 + 4096 + 2 * 4096
    assert work.gptj_weight_bytes(GPTJ) == 4 * (28 * per_block + 2 * 4096 + 50400 * 4096 + 50400)
    assert 23.3e9 < work.gptj_weight_bytes(GPTJ) < 23.4e9


def test_bound_takes_the_larger_of_flops_and_bytes():
    assert work.Work(495e12, 0).bound_s() == pytest.approx(1.0)
    assert work.Work(0, 3.35e12).bound_s() == pytest.approx(1.0)


def test_acoustic_count_matches_the_ports_hook_count():
    from emojivoice_tpu_torch import config as C
    from emojivoice_tpu_torch.bench.mfu import synthesis_count
    from emojivoice_tpu_torch.inference.pipeline import SynthesisPipeline

    root = C.get_preset("emoji_multi")
    pipe = SynthesisPipeline.from_random(root, seed=0, device="cpu", with_vocoder=False)
    x = torch.randint(1, 100, (2, 64))
    xl = torch.tensor([64, 50])
    counts = synthesis_count(pipe, x, xl, torch.tensor([3, 4]), 128, 2, vocoder=False)
    ours = work.synthesis(CFG["model"], CFG["vocoder"], 2, 64, 128, 2, vocode=False, denoise=False)
    assert ours.flops == pytest.approx(counts["encoder"].total + counts["decoder"].total, rel=1e-9)
