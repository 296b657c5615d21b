"""Tiny configurations of the benchmark's two configurations, for runs on the
CPU: the same code paths at widths a test can hold, durations short and few
buckets, so that a run's warm-up captures a handful of keys."""

from __future__ import annotations

import copy
import os
from pathlib import Path

from benchmark.harness import load_json

ROOT = Path(__file__).resolve().parents[2]
os.environ.update(USE_TORCH="1", USE_TF="0", USE_FLAX="0")


def matcha() -> dict:
    cfg = copy.deepcopy(load_json(ROOT / "benchmark" / "configs" / "matcha_emoji_v1.json"))
    m = cfg["model"]
    m.update(spk_emb_dim=8, encoder=dict(m["encoder"], n_channels=16, filter_channels=32, n_layers=2),
             duration_predictor=dict(m["duration_predictor"], filter_channels_dp=16),
             decoder=dict(m["decoder"], channels=[16, 16], attention_head_dim=8, num_mid_blocks=1))
    cfg["vocoder"]["upsample_initial_channel"] = 32
    cfg["synthesis"].update(text_buckets=[128, 512], mel_buckets=[256, 1024, 2048], n_timesteps=2)
    cfg["durations"]["chars_per_s"] = 60.0
    return cfg


def agent() -> dict:
    cfg = copy.deepcopy(load_json(ROOT / "benchmark" / "configs" / "agent_whisper_gptj6b.json"))
    cfg["tts"] = matcha()  # the tiny synthesis given whole, in place of its name
    cfg["agent"]["steps"] = 2
    cfg["whisper"].update(d_model=32, encoder_layers=1, decoder_layers=2, encoder_attention_heads=2,
                          decoder_attention_heads=2, encoder_ffn_dim=64, decoder_ffn_dim=64)
    cfg["llm"].update(n_embd=64, n_layer=2, n_head=4, rotary_dim=8)
    return cfg


def configs() -> dict:
    return {"matcha_emoji_v1": matcha(), "agent_whisper_gptj6b": agent()}
